"""Flash-decode attention of one query token over a packed NxFP KV cache.

CUDA kernel: ``csrc/nxfp_attention.cu`` (replaces the reference's
``kernels/nxfp_attention.py:nxfp_decode_attention_pallas``), split-S in
one launch: ``attention_split`` plans how many CTAs share each (batch,
KV head)'s 32-row tiles (from the cache length and KV heads, never from
the batch), and the last of them merges their partial
softmax states in split order. Plain
version: ``nxfp_decode_attention_plain`` — dequantize the cache to f32,
f32 scores, the -1e30 mask, ``exp(s - max)`` zeroed where masked, f32
``p @ V`` and the ``max(l, 1e-30)`` divisor: the kernel's arithmetic with
the whole context as one tile.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.formats import BlockFormat
from ..core.pack import unpack_codes
from . import build
from .decode_lib import decode_block_values

__all__ = ["nxfp_decode_attention", "nxfp_decode_attention_plain",
           "dequant_cache", "attention_split", "TILE_ROWS"]

LAUNCHES = 0          # kernel launches since the caller last set it to 0
TILE_ROWS = 32        # cache rows per tile of the kernel (one per lane)
CTAS_PER_SM = 2       # the split grid aims at about two CTAs on every SM
_NEG = -1e30

_scratch: dict = {}   # split buffers per (device, stream), split_scratch


def attention_split(kvh: int, s: int, n_sm: int = 132):
    """Split-S plan: (splits, tiles per split) for a cache of ``s`` rows.

    Split i of each (batch, KV head) takes the 32-row tiles
    [i * tps, min(n_tiles, (i + 1) * tps)), n_tiles = ceil(s / 32): every
    split holds at least one tile and the splits cover them once. The
    grid (kvh, b, splits) aims at ``CTAS_PER_SM`` CTAs per SM for one
    sequence; a batch adds CTAs, never splits. The merge's sums follow
    the splits, so a plan that depended on the batch would make a row's
    output depend on how many rows share the launch (on the H100 3086 of
    row 0's 4096 outputs moved, by up to 9e-8, between B 1 and B 4 at S
    512 when it did), and the continuous engine's slots could not
    reproduce a request served alone. Planned from the cache length,
    never from the sequences' lengths: no device sync.
    """
    n_tiles = max(1, -(-s // TILE_ROWS))
    want = max(1, -(-CTAS_PER_SM * n_sm // max(1, kvh)))
    tps = -(-n_tiles // min(want, n_tiles))
    return -(-n_tiles // tps), tps


def _split_plan(device, b: int, kvh: int, g: int, d: int, s: int):
    """``attention_split`` on ``device`` and, with more than one split, the
    current stream's partials (acc, m, l per split of each (batch, KV
    head)) and per-(batch, KV head) counters (``build.split_scratch``)."""
    splits, tps = attention_split(kvh, s, build.sm_count(device))
    if splits == 1:
        return splits, tps, None, None
    ws, counters = build.split_scratch(
        _scratch, device, b * kvh * splits * (g * d + 2 * g), b * kvh)
    return splits, tps, ws, counters


def dequant_cache(packed, meta, fmt: BlockFormat):
    """(B, S, KVH, NB, bpb) packed -> (B, S, KVH, NB*B) f32."""
    vals = decode_block_values(
        unpack_codes(packed, fmt.bits, fmt.block_size), meta, fmt)
    return vals.reshape(*vals.shape[:-2], -1)


def nxfp_decode_attention_plain(q, k_packed, k_meta, v_packed, v_meta,
                                lengths, fmt: BlockFormat):
    """q (B, KVH, G, D) f32 pre-scaled -> (B, KVH, G, D) f32."""
    k = dequant_cache(k_packed, k_meta, fmt)                 # (B, S, KVH, D)
    v = dequant_cache(v_packed, v_meta, fmt)
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), k)
    s = k.shape[1]
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.reshape(-1, 1))[:, None, None, :]     # (B,1,1,S)
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG))
    m = torch.clamp(scores.amax(dim=-1, keepdim=True), min=_NEG)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v)
    return acc / torch.clamp(l, min=1e-30)


def nxfp_decode_attention(q, k_packed, k_meta, v_packed, v_meta, lengths,
                          fmt: BlockFormat):
    """q (B, KVH, G, D) f32 (scaled by 1/sqrt(head_dim)); K/V packed
    (B, S, KVH, NB, bpb) uint8 + (B, S, KVH, NB) meta (uint16, uint32 for
    an asym format); lengths (B,) int.
    Returns (B, KVH, G, D) f32. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    global LAUNCHES
    tensors = (q, k_packed, k_meta, v_packed, v_meta, lengths)
    if not build.on_cuda(*tensors):
        return nxfp_decode_attention_plain(*tensors, fmt)
    build.require_format(fmt, "decode attention")
    b, kvh, g, d = q.shape
    bb, s, kvh2, nb, bpb = k_packed.shape
    build.require((bb, kvh2) == (b, kvh) and nb * fmt.block_size == d,
                  f"q {tuple(q.shape)} vs cache {tuple(k_packed.shape)}")
    build.require(v_packed.shape == k_packed.shape
                  and k_meta.shape == v_meta.shape == (b, s, kvh, nb),
                  "K/V shapes differ")
    build.require(k_meta.dtype == v_meta.dtype == build.meta_dtype(fmt)
                  and k_packed.dtype == v_packed.dtype == torch.uint8,
                  f"cache dtypes must be uint8 packed + {fmt.meta_dtype} meta")
    build.require(bpb == fmt.bytes_per_block, f"{bpb} bytes per block")
    qc = q.to(torch.float32).contiguous()
    lens = lengths.to(torch.int32).reshape(b).contiguous()
    for t in (k_packed, k_meta, v_packed, v_meta):
        build.require(t.is_contiguous(), "cache must be contiguous")
    build.require(k_packed.data_ptr() % 16 == 0 and v_packed.data_ptr() % 16
                  == 0 and k_meta.data_ptr() % 4 == 0
                  and v_meta.data_ptr() % 4 == 0, "misaligned cache")
    lib = build.library()           # raises first where there is no card
    out = torch.empty((b, kvh, g, d), dtype=torch.float32, device=q.device)
    splits, tps, ws, counters = _split_plan(q.device, b, kvh, g, d, s)
    desc = build.fmt_desc(fmt)
    rc = lib.nxfp_decode_attention_launch(
        qc.data_ptr(), k_packed.data_ptr(), k_meta.data_ptr(),
        v_packed.data_ptr(), v_meta.data_ptr(), lens.data_ptr(),
        out.data_ptr(), b, s, kvh, g, nb, ctypes.addressof(desc), splits,
        tps, 0 if ws is None else ws.data_ptr(),
        0 if counters is None else counters.data_ptr(),
        build.stream_handle(q.device))
    build.check(rc, "nxfp_decode_attention")
    LAUNCHES += 1
    return out
