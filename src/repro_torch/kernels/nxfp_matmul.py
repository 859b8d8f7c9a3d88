"""Fused dequant GEMM: y = bf16(x) @ dequant(Wq)^T with f32 accumulation.

CUDA kernel: ``csrc/nxfp_matmul.cu`` (replaces the reference's
``kernels/nxfp_matmul.py:nxfp_matmul_pallas``). Plain version:
``nxfp_matmul_plain``, which dequantizes the whole weight to bf16 and
multiplies in f32 (bf16 x bf16 products are exact in f32), the function
the kernel computes tile by tile.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.formats import BlockFormat
from ..core.pack import unpack_codes
from . import build
from .decode_lib import decode_block_values

__all__ = ["nxfp_matmul", "nxfp_matmul_plain", "dequant_weight_bf16"]

LAUNCHES = 0          # kernel launches since the caller last set it to 0
KERNEL_BITS = (4, 5, 6, 8)


def dequant_weight_bf16(packed, meta, fmt: BlockFormat):
    """(N, KB, bpb) packed + (N, KB) meta -> (N, KB*B) bf16 rows: the
    TPU's ``_decode_tile`` (f32 decode, round to nearest even)."""
    codes = unpack_codes(packed, fmt.bits, fmt.block_size)
    w = decode_block_values(codes, meta, fmt)
    return w.reshape(w.shape[0], -1).to(torch.bfloat16)


def nxfp_matmul_plain(x, packed, meta, fmt: BlockFormat):
    """x (M, K) @ dequant(W)^T -> (M, N) f32; W packed (N, KB, bpb)."""
    w = dequant_weight_bf16(packed, meta, fmt)
    return x.to(torch.bfloat16).float() @ w.float().T


def nxfp_matmul(x, packed, meta, fmt: BlockFormat):
    """x (M, K) float; packed (N, KB, bpb) uint8; meta (N, KB) uint16
    (uint32 for an asym format).

    K must equal KB * block_size (the caller pads x). Returns (M, N) f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global LAUNCHES
    if not build.on_cuda(x, packed, meta):
        return nxfp_matmul_plain(x, packed, meta, fmt)
    if fmt.bits not in KERNEL_BITS or fmt.block_size not in (16, 32):
        raise NotImplementedError(
            f"{fmt.name}: the CUDA dequant GEMM takes 4/5/6/8-bit formats "
            "with block size 16/32")
    m, k = x.shape
    n, kb, bpb = packed.shape
    build.require(k == kb * fmt.block_size, f"x has K={k}, weight {kb} blocks")
    build.require(bpb == fmt.bytes_per_block, f"{bpb} bytes per block")
    build.require(meta.shape == (n, kb) and meta.dtype == build.meta_dtype(fmt),
                  f"meta {tuple(meta.shape)} {meta.dtype}")
    build.require(packed.dtype == torch.uint8, f"packed {packed.dtype}")
    xb = x.to(torch.bfloat16).contiguous()
    build.require(packed.is_contiguous() and meta.is_contiguous(),
                  "packed weight must be contiguous")
    build.require(xb.data_ptr() % 16 == 0 and packed.data_ptr() % 4 == 0,
                  "misaligned operands")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    desc = build.fmt_desc(fmt)
    rc = build.library().nxfp_matmul_launch(
        xb.data_ptr(), packed.data_ptr(), meta.data_ptr(), y.data_ptr(),
        m, n, kb, ctypes.addressof(desc), build.stream_handle(x.device))
    build.check(rc, "nxfp_matmul")
    LAUNCHES += 1
    return y
