"""NxFP gradient compression (the reference's ``train/compress.py``): the
packed wire over a mesh's 'pod' group (``make_pod_grad_fn``) and its
numerics on one device (``simulate_compress``).

The paper's codec is a direct cast for "weights, KV cache, or even
gradients": here every gradient leaf of at least ``_MIN_COMPRESS``
values is cast to NxFP8 before it crosses between pods, so only the
bit-packed codes and one uint16 of metadata a block cross (8.5 bits a
value against 32 for f32). Blocks run along each leaf's last axis,
zero-padded to a whole block. On the card the cast is one launch of the
fused quantizer kernel per leaf (``kernels.nxfp_quantize``: encode and
pack; NxFP8 runs its 8-bit instance); on the CPU its plain version, the
reference's arithmetic encoder and pack. The decode is the port's
``kernels/decode_lib.py`` (the reference's XLA ``decode_block_values``),
a chunk of rows at a time, so a 525M-value leaf never has more than a
chunk of decoded values besides its own.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.formats import BlockFormat, get_format
from ..core.pack import unpack_codes
from ..kernels.decode_lib import decode_block_values
from ..kernels.nxfp_quantize import nxfp_quantize_pack
from ..sharding.ctx import activation_sharding
from ..sharding.shard_map import SHARD_MAP_WIRE_BACKENDS, partial_auto_ok
from ..tree import tree_leaves, tree_map

_MIN_COMPRESS = 4096  # tiny leaves (norm scales) ride along as they are

# the wire carries bit-packed codes; False: unpacked uint8 codes (the
# reference's seed wire format, 2x the bytes at 4 bits)
WIRE_PACK = True

# values decoded at once (``_leaf_decode``)
DECODE_CHUNK = 1 << 24


def _leaf_roundtrip(g, fmt: BlockFormat):
    """g (..., n) -> (wire codes uint8, meta (..., nb), n): the wire is
    (..., nb, bytes_per_block) bit-packed, or (..., nb, B) unpacked codes
    when ``WIRE_PACK`` is off."""
    n = g.shape[-1]
    pad = (-n) % fmt.block_size
    x = g.to(torch.float32)
    if pad:
        x = F.pad(x, (0, pad))
    nb = x.shape[-1] // fmt.block_size
    packed, meta = nxfp_quantize_pack(
        x.reshape(-1, fmt.block_size).contiguous(), fmt)
    lead = tuple(x.shape[:-1]) + (nb,)
    wire = packed.reshape(*lead, packed.shape[-1])
    if not WIRE_PACK:
        wire = unpack_codes(wire, fmt.bits, fmt.block_size)
    return wire, meta.reshape(lead), n


def _decode_rows(wire, meta, n: int, fmt: BlockFormat):
    """(rows, nb, bytes) wire codes and (rows, nb) meta -> (rows, n) f32."""
    codes = unpack_codes(wire, fmt.bits, fmt.block_size) if WIRE_PACK \
        else wire
    deq = decode_block_values(codes, meta, fmt)
    return deq.reshape(deq.shape[0], -1)[:, :n]


def _rows(meta, fmt: BlockFormat) -> Tuple[int, int, int]:
    """(rows, blocks a row, rows a decode chunk) of a leaf's meta."""
    nb = meta.shape[-1]
    return (math.prod(meta.shape[:-1]), nb,
            max(1, DECODE_CHUNK // (nb * fmt.block_size)))


def _leaf_decode(wire, meta, n: int, shape, dtype, fmt: BlockFormat,
                 out=None):
    """The wire decoded to a tensor of ``shape`` and ``dtype`` (into
    ``out`` when given, a contiguous tensor of that shape), a chunk of
    rows at a time."""
    rows, nb, step = _rows(meta, fmt)
    wire = wire.reshape(rows, nb, wire.shape[-1])
    meta = meta.reshape(rows, nb)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=wire.device)
    dst = out.view(rows, n)
    for i in range(0, rows, step):
        dst[i:i + step] = _decode_rows(wire[i:i + step], meta[i:i + step],
                                       n, fmt)
    return out


def _decode_mean(wires, metas, n: int, out, fmt: BlockFormat):
    """The mean of the pods' wires decoded, into ``out`` (a contiguous f32
    tensor, the leaf's own storage), a chunk of rows at a time: 0 + the
    pods' values in pod order, then a true division by the pod count, as
    the reference's ``jnp.mean`` over its vmapped decode reduces the
    stack."""
    if out.dtype != torch.float32:
        raise ValueError(f"the wire's mean is taken in f32, not {out.dtype}")
    rows, nb, step = _rows(metas[0], fmt)
    wires = [w.reshape(rows, nb, w.shape[-1]) for w in wires]
    metas = [m.reshape(rows, nb) for m in metas]
    dst = out.view(rows, n)
    for i in range(0, rows, step):
        acc = dst[i:i + step]
        acc.zero_()
        for w, m in zip(wires, metas):
            acc += _decode_rows(w[i:i + step], m[i:i + step], n, fmt)
        acc.div_(len(wires))
    return out


def simulate_compress(grads, fmt_name: str = "nxfp8", inplace: bool = False):
    """Cast -> decode every leaf of at least ``_MIN_COMPRESS`` values (the
    wire's numerics, no collective); smaller leaves pass as they are.
    ``inplace`` decodes each leaf into its own storage (the train step's
    gradients: no second copy of them)."""
    fmt = get_format(fmt_name)

    def leaf(g):
        if g.numel() < _MIN_COMPRESS:
            return g
        wire, meta, n = _leaf_roundtrip(g, fmt)
        return _leaf_decode(wire, meta, n, g.shape, g.dtype, fmt,
                            out=g if inplace else None)

    return tree_map(leaf, grads)


class _Clock:
    """Milliseconds between marks: CUDA events on the card, the host's
    clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        if not self.cuda:
            return (b - a) * 1e3
        b.synchronize()
        return a.elapsed_time(b)


def _all_gather(x, group, n: int):
    """Every pod's ``x`` in pod order (its bytes: any dtype crosses)."""
    import torch.distributed as dist
    raw = x.contiguous().view(torch.uint8)
    outs = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(outs, raw, group=group)
    return [o.view(x.dtype) for o in outs]


def make_pod_grad_fn(grad_fn: Callable, mesh, fmt_name: str = "nxfp8",
                     parts: Optional[dict] = None) -> Tuple[Callable, str]:
    """Wrap ``grad_fn(params, batch) -> (loss, grads)`` with the packed
    NxFP wire over ``mesh``'s 'pod' group. Returns (wrapped_fn, mode):
    ``grad_fn`` itself and "single_pod" when the mesh has no 'pod' axis,
    else the wire and "shard_map" (the reference's names).

    The wrapped function takes the global batch; pod p computes the
    gradients of rows [p B/P, (p + 1) B/P) (the reference's ``P("pod")``
    in-spec) inside ``activation_sharding(("data",), ...)``. Each
    gradient leaf of at least ``_MIN_COMPRESS`` values is cast once
    (``_leaf_roundtrip``: one quantizer launch on the card), its packed
    codes and its meta gathered over the pod group (one ``all_gather``
    each), every pod's wire decoded in pod order and averaged into the
    leaf's own storage; smaller leaves take the f32 mean of their gather,
    and the scalar loss the mean over pods. Every rank ends with the same
    bits. The gradients must be contiguous f32 tensors.

    A mesh whose backend cannot gather (``partial_auto_ok``) raises; there
    is no simulated fallback. On CUDA tensors the gloo backend stages each
    gather through the host. ``parts``, a dict, receives the last call's
    milliseconds: ``fwd_bwd`` (``grad_fn``), ``cast``, ``gather`` and
    ``decode`` (CUDA events on the card)."""
    if "pod" not in mesh.axis_names:
        return grad_fn, "single_pod"
    if not partial_auto_ok(mesh):
        raise NotImplementedError(
            f"the packed wire runs over {SHARD_MAP_WIRE_BACKENDS} process "
            f"groups, not {mesh.backend!r}")
    fmt = get_format(fmt_name)
    group = mesh.group("pod")
    n_pods, pod = mesh.shape["pod"], mesh.coord["pod"]
    clock = _Clock(mesh.device) if parts is not None else None

    def mark():
        return clock.mark() if clock else None

    def wire_mean(g, ms):
        if g.numel() < _MIN_COMPRESS:       # an f32 wire for tiny leaves
            t0 = mark()
            xs = _all_gather(g, group, n_pods)
            t1 = mark()
            g.zero_()
            for x in xs:
                g.add_(x)
            g.div_(n_pods)
            if clock:
                ms["gather"] += clock.ms(t0, t1)
                ms["decode"] += clock.ms(t1, mark())
            return
        t0 = mark()
        wire, meta, n = _leaf_roundtrip(g, fmt)
        t1 = mark()
        wires = _all_gather(wire, group, n_pods)
        metas = _all_gather(meta, group, n_pods)
        del wire, meta
        t2 = mark()
        _decode_mean(wires, metas, n, g, fmt)
        if clock:
            ms["cast"] += clock.ms(t0, t1)
            ms["gather"] += clock.ms(t1, t2)
            ms["decode"] += clock.ms(t2, mark())

    def fn(params, batch):
        rows = {}
        for k, v in batch.items():
            b = v.shape[0]
            if b % n_pods:
                raise ValueError(f"batch {b} does not split over {n_pods} "
                                 "pods")
            rows[k] = v[pod * (b // n_pods):(pod + 1) * (b // n_pods)]
        t0 = mark()
        with activation_sharding(("data",), mesh.shape.get("data", 1)):
            loss, grads = grad_fn(params, rows)
        ms = {"fwd_bwd": clock.ms(t0, mark()) if clock else 0.0,
              "cast": 0.0, "gather": 0.0, "decode": 0.0}
        for g in tree_leaves(grads):
            wire_mean(g, ms)
        losses = _all_gather(loss.reshape(1).to(torch.float32), group,
                             n_pods)
        total = torch.zeros_like(losses[0])
        for x in losses:
            total += x
        if parts is not None:
            parts.update(ms)
        return (total / n_pods)[0], grads

    return fn, "shard_map"
