"""NxFP gradient compression, simulated on one device (the reference's
``train/compress.py`` without a ``pod`` mesh).

Every gradient leaf of at least ``_MIN_COMPRESS`` values is direct-cast
to the wire format and decoded back: the numerics of the reference's
inter-pod wire, without a collective. Blocks run along each leaf's last
axis, zero-padded to a whole block. On the card the cast is one launch of
the fused quantizer kernel per leaf (``kernels.nxfp_quantize``: encode
and pack; NxFP8 runs its 8-bit instance); on the CPU its plain version,
the reference's arithmetic encoder and pack. The decode is the port's
``kernels/decode_lib.py`` in row chunks, so a 525M-value leaf never has
more than a chunk of decoded values besides its own. The packed wire over
``all_gather`` (``make_pod_grad_fn``) waits for the process groups it
needs (the sharded serving engines have no collective).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.formats import BlockFormat, get_format
from ..core.pack import unpack_codes
from ..kernels.decode_lib import decode_block_values
from ..kernels.nxfp_quantize import nxfp_quantize_pack
from ..tree import tree_map

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


def _leaf_decode(wire, meta, n: int, shape, dtype, fmt: BlockFormat,
                 out=None):
    """The wire decoded to a tensor of ``shape`` and ``dtype`` (into
    ``out`` when given, a contiguous tensor of that shape), a chunk of
    rows at a time."""
    nb = meta.shape[-1]
    rows = math.prod(meta.shape[:-1])
    wire = wire.reshape(rows, nb, wire.shape[-1])
    meta = meta.reshape(rows, nb)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=wire.device)
    dst = out.view(rows, n)
    step = max(1, DECODE_CHUNK // (nb * fmt.block_size))
    for i in range(0, rows, step):
        codes = wire[i:i + step]
        if WIRE_PACK:
            codes = unpack_codes(codes, fmt.bits, fmt.block_size)
        deq = decode_block_values(codes, meta[i:i + step], fmt)
        dst[i:i + step] = deq.reshape(deq.shape[0], -1)[:, :n]
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
