"""Fused dequant GEMM: y = bf16(x) @ dequant(Wq)^T with f32 accumulation.

CUDA kernel: ``csrc/nxfp_matmul.cu`` (replaces the reference's
``kernels/nxfp_matmul.py:nxfp_matmul_pallas``), one launch per call in
one of two regimes: up to ``decode_geometry().max_m`` rows (16) it
streams the weight with a deterministic split-K
(``csrc/nxfp_matmul_decode.cu``; ``decode_split`` plans the split), above
that it runs wgmma (``csrc/nxfp_matmul_prefill.cu``). Both take 2- to 8-bit
codes at block sizes 8 to 128: 4/5/6/8 bits at bs 16/32 read whole blocks,
every other format a row as one long block in units of 32 codes
(``build.gemm_blocks``; a row of a bs-8 or bs-16 format that is not a
whole number of units is padded with zero blocks, ``build.pad_k``). Plain
version: ``nxfp_matmul_plain``, which dequantizes the whole weight to
bf16 and multiplies in f32 (bf16 x bf16 products are exact in f32), the
function the kernel computes tile by tile.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.formats import BlockFormat
from ..core.pack import unpack_codes
from . import build
from .decode_lib import decode_block_values

__all__ = ["nxfp_matmul", "nxfp_matmul_plain", "dequant_weight_bf16",
           "plain_product", "DecodeGeometry", "decode_geometry",
           "decode_split"]

LAUNCHES = 0          # kernel launches since the caller last set it to 0
CTAS_PER_SM = 4       # the decode grid aims at about four CTAs on every SM
MIN_CHUNK = 8         # the fewest K blocks a split takes when K allows


class DecodeGeometry(NamedTuple):
    """What the decode regime's kernel is built for
    (``csrc/nxfp_matmul_decode.cu``, read by ``decode_geometry``)."""
    max_m: int          # rows up to which it runs
    tile_n: int         # output columns per CTA
    x_slice_bytes: int  # the most bf16 x bytes one CTA stages


_geometry = None
_scratch: dict = {}   # split-K buffers per (device, stream), split_scratch


def decode_geometry() -> DecodeGeometry:
    """The decode kernel's geometry, as the built library reports it."""
    global _geometry
    if _geometry is None:
        vals = [ctypes.c_int() for _ in DecodeGeometry._fields]
        build.check(build.library().nxfp_matmul_decode_geometry(
            *[ctypes.byref(v) for v in vals]), "nxfp_matmul_decode_geometry")
        _geometry = DecodeGeometry(*(v.value for v in vals))
    return _geometry


def decode_split(m: int, n: int, kb: int, block_size: int,
                 geom: DecodeGeometry, n_sm: int = 132):
    """Split-K plan of the decode regime: (n_tiles, splits, chunk).

    Split s takes K blocks [s * chunk, min(kb, (s + 1) * chunk)): chunk is
    a multiple of 4 (a quad of lanes reads 4 consecutive blocks of a
    column per step), every split holds at least one block and the splits
    cover the kb blocks once. The grid (n_tiles, splits) aims at
    ``CTAS_PER_SM`` CTAs per SM, with chunks of at least ``MIN_CHUNK``
    blocks and an x slice (m * chunk * block_size bf16) of at most
    ``geom.x_slice_bytes``.

    The plan is a function of (n, kb, block_size) alone: the x slice is
    capped for ``geom.max_m`` rows whatever ``m`` is, so a row's f32 sums
    run in one order at every m from 1 to 16 (a slot of a 16-slot engine,
    or a row of the speculative verify's 16-row groups, gets the bits of
    the request served alone). ``m`` is checked, never planned with.
    """
    if not 1 <= m <= geom.max_m or n < 1 or kb < 1:
        raise ValueError(f"no decode split for m={m} n={n} kb={kb}")
    n_tiles = -(-n // geom.tile_n)
    max_chunk = max(4, geom.x_slice_bytes // (2 * geom.max_m * block_size)
                    // 4 * 4)
    want = max(1, -(-CTAS_PER_SM * n_sm // n_tiles))
    chunk = -(-kb // want)
    chunk = min(max(-(-chunk // 4) * 4, MIN_CHUNK), max_chunk)
    return n_tiles, -(-kb // chunk), chunk


def _regime(device, m: int, n: int, kb: int, block_size: int):
    """The regime of a GEMM with ``m`` rows on ``device``, as
    ``nxfp_matmul_launch`` takes it: (splits, chunk, ws_ptr, counters_ptr).
    Up to ``decode_geometry().max_m`` rows, ``decode_split``'s plan and the
    current stream's split-K buffers (``build.split_scratch``, kept in
    ``_scratch``); above that all 0, which runs wgmma."""
    if not 0 < m <= decode_geometry().max_m:
        return 0, 0, 0, 0
    n_tiles, splits, chunk = decode_split(m, n, kb, block_size,
                                          decode_geometry(),
                                          build.sm_count(device))
    ws, counters = build.split_scratch(_scratch, device, splits * m * n,
                                       n_tiles)
    return splits, chunk, ws.data_ptr(), counters.data_ptr()


def dequant_weight_bf16(packed, meta, fmt: BlockFormat):
    """(N, KB, bpb) packed + (N, KB) meta -> (N, KB*B) bf16 rows: the
    TPU's ``_decode_tile`` (f32 decode, round to nearest even)."""
    codes = unpack_codes(packed, fmt.bits, fmt.block_size)
    w = decode_block_values(codes, meta, fmt)
    return w.reshape(w.shape[0], -1).to(torch.bfloat16)


def plain_product(x, w):
    """x (M, K) @ w (K, N) in f32. On the CPU one product per row: MKL
    takes another path at M = 1 than at M > 1, whose sums differ in their
    last bits, so one product of all rows would make a row's result (and
    a request's decode stream) depend on how many rows share the step. On
    CUDA, where the plain version is only the kernels' yardstick, one
    product."""
    if x.device.type != "cpu" or x.shape[0] < 2:
        return x @ w
    return torch.cat([x[i:i + 1] @ w for i in range(x.shape[0])])


def nxfp_matmul_plain(x, packed, meta, fmt: BlockFormat):
    """x (M, K) @ dequant(W)^T -> (M, N) f32; W packed (N, KB, bpb)."""
    w = dequant_weight_bf16(packed, meta, fmt)
    return plain_product(x.to(torch.bfloat16).float(), w.float().T)


def nxfp_matmul(x, packed, meta, fmt: BlockFormat):
    """x (M, K) float; packed (N, KB, bpb) uint8; meta (N, KB) uint16
    (uint32 for an asym format).

    K must equal KB * block_size (the caller pads x). Returns (M, N) f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global LAUNCHES
    if not build.on_cuda(x, packed, meta):
        return nxfp_matmul_plain(x, packed, meta, fmt)
    build.require_format(fmt, "dequant GEMM")
    m, k = x.shape
    n, kb, bpb = packed.shape
    build.require(k == kb * fmt.block_size, f"x has K={k}, weight {kb} blocks")
    build.require(bpb == fmt.bytes_per_block, f"{bpb} bytes per block")
    build.require(meta.shape == (n, kb) and meta.dtype == build.meta_dtype(fmt),
                  f"meta {tuple(meta.shape)} {meta.dtype}")
    build.require(packed.dtype == torch.uint8, f"packed {packed.dtype}")
    if not build.native(fmt):
        packed, meta = build.pad_k(packed, meta, fmt.block_size)
    if packed.shape[1] != kb:                   # zero K blocks appended
        x = F.pad(x, (0, (packed.shape[1] - kb) * fmt.block_size))
        kb = packed.shape[1]
    xb = x.to(torch.bfloat16).contiguous()
    build.require(packed.is_contiguous() and meta.is_contiguous(),
                  "packed weight must be contiguous")
    build.require(xb.data_ptr() % 16 == 0 and packed.data_ptr() % 16 == 0
                  and meta.data_ptr() % 4 == 0, "misaligned operands")
    lib = build.library()           # raises first where there is no card
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    desc = build.fmt_desc(fmt)
    rc = lib.nxfp_matmul_launch(
        xb.data_ptr(), packed.data_ptr(), meta.data_ptr(), y.data_ptr(),
        m, n, kb, ctypes.addressof(desc),
        *_regime(x.device, m, n, *build.gemm_blocks(kb, fmt)),
        build.stream_handle(x.device))
    build.check(rc, "nxfp_matmul")
    LAUNCHES += 1
    return y
