"""The dequant GEMM's grouped instance: routed rows through their experts.

``y[r] = bf16(x[r]) @ bf16(dequant(W[expert[r]]))^T`` in f32 for every
row r of an MoE layer's assignments (one row per (token, routed expert)),
zero where ``expert[r]`` is -1 (dropped by capacity, or padding).

CUDA kernel: ``nxfp_matmul_grouped_launch`` in
``csrc/nxfp_matmul_decode.cu``, the decode regime's split-K loop run per
(expert, N tile, split) over that expert's rows in groups of at most 16,
with the 2D decode kernel's split plan for (K, N)
(``nxfp_matmul.decode_split``). It stands where the reference's
``models/moe.py:_expert_mm`` runs XLA (no Pallas kernel there), and is
the reference's ``kernels/nxfp_matmul.py:nxfp_matmul_pallas`` function
applied per expert. A row's bits are those ``ops.qmatmul`` gives it
against its expert's weight at any M <= 16, whichever rows share its
expert, which keeps a continuous slot's stream its solo stream. An expert
with no rows reads none of its weight, so a decode step streams only the
routed experts. Plain version: ``nxfp_matmul_grouped_plain``, per expert
the plain GEMM of its rows.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core.formats import BlockFormat
from . import build
from .nxfp_matmul import (decode_geometry, decode_split, dequant_weight_bf16,
                          plain_product)

__all__ = ["nxfp_matmul_grouped", "nxfp_matmul_grouped_plain"]

LAUNCHES = 0          # kernel launches since the caller last set it to 0

_scratch: dict = {}   # split-K buffers per (device, stream), split_scratch


def nxfp_matmul_grouped_plain(x, expert, packed, meta, fmt: BlockFormat):
    """x (R, K) float; expert (R,) int in [-1, E); packed (E, N, KB, bpb),
    meta (E, N, KB) -> (R, N) f32: for each expert, its weight
    dequantized to bf16 and its rows multiplied in f32 (one product a row
    on the CPU: ``plain_product``); zero rows where ``expert`` is -1.
    Reads the routing on the host."""
    r = x.shape[0]
    n = packed.shape[1]
    xb = x.to(torch.bfloat16).float()
    y = torch.zeros((r, n), dtype=torch.float32, device=x.device)
    for e in torch.unique(expert[expert >= 0]).tolist():
        rows = torch.nonzero(expert == e).flatten()
        w = dequant_weight_bf16(packed[e], meta[e], fmt).float()
        y[rows] = plain_product(xb[rows], w.T)
    return y


def nxfp_matmul_grouped(x, expert, packed, meta, fmt: BlockFormat):
    """x (R, K) float; expert (R,) int32 in [-1, E); packed (E, N, KB,
    bpb) uint8 and meta (E, N, KB) uint16: one expert weight a slice, K
    blocked (an expert stack cast along axis -2). K must equal KB *
    block_size (the caller pads x). Returns (R, N) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    once, reading the routing on the device (nothing syncs with the host,
    so a CUDA graph captures it)."""
    global LAUNCHES
    if not build.on_cuda(x, expert, packed, meta):
        return nxfp_matmul_grouped_plain(x, expert, packed, meta, fmt)
    build.require_format(fmt, "grouped dequant GEMM")
    build.require(not (fmt.asym or fmt.ox),
                  f"{fmt.name}: the grouped GEMM takes weight formats")
    r, k = x.shape
    e, n, kb, bpb = packed.shape
    build.require(k == kb * fmt.block_size, f"x has K={k}, weight {kb} blocks")
    build.require(bpb == fmt.bytes_per_block, f"{bpb} bytes per block")
    build.require(meta.shape == (e, n, kb)
                  and meta.dtype == build.meta_dtype(fmt),
                  f"meta {tuple(meta.shape)} {meta.dtype}")
    build.require(packed.dtype == torch.uint8, f"packed {packed.dtype}")
    build.require(expert.shape == (r,) and expert.dtype == torch.int32,
                  f"expert {tuple(expert.shape)} {expert.dtype}")
    packed, meta = packed.reshape(e * n, kb, bpb), meta.reshape(e * n, kb)
    if not build.native(fmt):
        packed, meta = build.pad_k(packed, meta, fmt.block_size)
    if packed.shape[1] != kb:                   # zero K blocks appended
        x = F.pad(x, (0, (packed.shape[1] - kb) * fmt.block_size))
        kb = packed.shape[1]
    xb = x.to(torch.bfloat16).contiguous()
    expert = expert.contiguous()
    build.require(packed.is_contiguous() and meta.is_contiguous(),
                  "packed weight must be contiguous")
    build.require(xb.data_ptr() % 16 == 0 and packed.data_ptr() % 16 == 0
                  and meta.data_ptr() % 4 == 0, "misaligned operands")
    lib = build.library()           # raises first where there is no card
    geom = decode_geometry()
    n_tiles, splits, chunk = decode_split(
        geom.max_m, n, *build.gemm_blocks(kb, fmt), geom,
        build.sm_count(x.device))
    ws, counters = build.split_scratch(_scratch, x.device, splits * r * n,
                                       e * n_tiles)
    y = torch.empty((r, n), dtype=torch.float32, device=x.device)
    rc = lib.nxfp_matmul_grouped_launch(
        xb.data_ptr(), expert.data_ptr(), packed.data_ptr(), meta.data_ptr(),
        y.data_ptr(), r, n, kb, e, ctypes.addressof(build.fmt_desc(fmt)),
        splits, chunk, ws.data_ptr(), counters.data_ptr(),
        build.stream_handle(x.device))
    build.check(rc, "nxfp_matmul_grouped")
    LAUNCHES += 1
    return y
