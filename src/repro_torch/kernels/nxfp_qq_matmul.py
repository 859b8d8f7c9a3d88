"""Quantized x quantized GEMM: y = dequant(Xq) @ dequant(Wq)^T, f32 out.

CUDA kernel: ``csrc/nxfp_qq_matmul.cu`` (replaces the reference's
``kernels/nxfp_qq_matmul.py:nxfp_qq_matmul_pallas``), one C call per
GEMM: a pass decodes X once into a bf16 buffer, then the dequant GEMM's
regime runs on it (``nxfp_matmul``'s split-K streaming up to
``decode_geometry().max_m`` rows, its wgmma pipeline above), so the
result is ``nxfp_matmul`` of the decoded X bit for bit. Plain version:
``nxfp_qq_matmul_plain``, a port of the reference's ``qq_matmul_ref``:
both operands decoded to f32, rounded to bf16 and multiplied as an f32
matmul of the rounded values (bf16 x bf16 products are exact in f32), the
function the kernel computes tile by tile.

Both operands are packed along the contraction axis in blocks of one
shared size: the activation ``Xq`` (M, KB, bpb_x) with (M, KB) meta
(uint32 for an asym format), the weight ``Wq`` (N, KB, bpb_w) with
(N, KB) meta.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.formats import BlockFormat
from . import build
from .nxfp_matmul import _regime, dequant_weight_bf16

__all__ = ["nxfp_qq_matmul", "nxfp_qq_matmul_plain"]

LAUNCHES = 0          # kernel launches since the caller last set it to 0


def nxfp_qq_matmul_plain(x_packed, x_meta, w_packed, w_meta,
                         x_fmt: BlockFormat, w_fmt: BlockFormat):
    """(M, KB, bpb_x) x (N, KB, bpb_w) packed -> (M, N) f32."""
    xd = dequant_weight_bf16(x_packed, x_meta, x_fmt)           # (M, K)
    wd = dequant_weight_bf16(w_packed, w_meta, w_fmt)           # (N, K)
    return xd.float() @ wd.float().T


def _check(packed, meta, fmt: BlockFormat, what: str, align: int):
    build.require(packed.dim() == 3 and packed.dtype == torch.uint8
                  and packed.shape[-1] == fmt.bytes_per_block,
                  f"{what} packed {tuple(packed.shape)} {packed.dtype}")
    build.require(meta.shape == packed.shape[:2]
                  and meta.dtype == build.meta_dtype(fmt),
                  f"{what} meta {tuple(meta.shape)} {meta.dtype}")
    build.require(packed.is_contiguous() and meta.is_contiguous()
                  and packed.data_ptr() % align == 0
                  and meta.data_ptr() % 4 == 0,
                  f"{what} must be contiguous and {align}-byte aligned")


def nxfp_qq_matmul(x_packed, x_meta, w_packed, w_meta, x_fmt: BlockFormat,
                   w_fmt: BlockFormat):
    """Both operands packed along K in blocks of one size. Returns (M, N)
    f32. CPU tensors take the plain version; CUDA tensors launch the
    kernel (2- to 8-bit codes at block sizes 8 to 128; it raises
    ``NotImplementedError`` for any other)."""
    global LAUNCHES
    build.require(x_fmt.block_size == w_fmt.block_size,
                  f"block sizes differ: {x_fmt.name} {x_fmt.block_size}, "
                  f"{w_fmt.name} {w_fmt.block_size}")
    build.require(x_packed.shape[1:2] == w_packed.shape[1:2],
                  f"K blocks differ: {tuple(x_packed.shape)} vs "
                  f"{tuple(w_packed.shape)}")
    if not build.on_cuda(x_packed, x_meta, w_packed, w_meta):
        return nxfp_qq_matmul_plain(x_packed, x_meta, w_packed, w_meta,
                                    x_fmt, w_fmt)
    for f in (x_fmt, w_fmt):
        build.require_format(f, "qq GEMM")
    _check(x_packed, x_meta, x_fmt, "activation", 4)
    _check(w_packed, w_meta, w_fmt, "weight", 16)
    if not build.native(w_fmt):
        # the generic GEMM reads W's rows in whole 32-code units: both
        # operands take the same zero blocks (X's decode takes any count)
        x_packed, x_meta = build.pad_k(x_packed, x_meta, x_fmt.block_size)
        w_packed, w_meta = build.pad_k(w_packed, w_meta, w_fmt.block_size)
    lib = build.library()           # raises first where there is no card
    m, kb, _ = x_packed.shape
    n = w_packed.shape[0]
    dev = x_packed.device
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    # the decoded X, (M, K) bf16: written and read back by this call alone
    x_bf16 = torch.empty((m, kb * x_fmt.block_size), dtype=torch.bfloat16,
                         device=dev)
    xd, wd = build.fmt_desc(x_fmt), build.fmt_desc(w_fmt)
    rc = lib.nxfp_qq_matmul_launch(
        x_packed.data_ptr(), x_meta.data_ptr(), w_packed.data_ptr(),
        w_meta.data_ptr(), y.data_ptr(), m, n, kb, ctypes.addressof(xd),
        ctypes.addressof(wd), x_bf16.data_ptr(),
        *_regime(dev, m, n, *build.gemm_blocks(kb, w_fmt)),
        build.stream_handle(dev))
    build.check(rc, "nxfp_qq_matmul")
    LAUNCHES += 1
    return y
