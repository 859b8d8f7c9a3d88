"""Fused NxFP block quantizer (Algorithm-1 encode + bit-pack).

CUDA kernel: ``csrc/nxfp_quantize.cu`` (replaces the reference's
``kernels/nxfp_quantize.py:nxfp_quantize_pack_pallas``). Plain version:
``nxfp_quantize_pack_plain``, the arithmetic codec of ``core.quantize``
followed by ``core.pack.pack_codes``; the two are bitwise equal. Both
take the symmetric weight/KV formats and the asymmetric (``asym``,
uint32 meta) and outlier-mantissa (``ox``) activation formats.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.formats import BlockFormat
from ..core.pack import bytes_per_block, pack_codes
from ..core.quantize import candidates, quantize_blocks_arith
from . import build

__all__ = ["nxfp_quantize_pack", "nxfp_quantize_pack_plain",
           "kernel_supports"]

LAUNCHES = 0          # kernel launches since the caller last set it to 0
KERNEL_BITS = (4, 5, 6, 8)
_MAX_CANDS = 8


class _Cand(ctypes.Structure):
    _fields_ = [("fmt_bit", ctypes.c_int), ("is_bfp", ctypes.c_int),
                ("mbits", ctypes.c_int), ("bias", ctypes.c_int),
                ("emax", ctypes.c_int), ("nano_mode", ctypes.c_int),
                ("max_pos", ctypes.c_float)]


class _QuantFmt(ctypes.Structure):
    _fields_ = [("cr", ctypes.c_int), ("asym", ctypes.c_int),
                ("ox", ctypes.c_int), ("n_cands", ctypes.c_int),
                ("c", _Cand * _MAX_CANDS)]


def _desc(fmt: BlockFormat) -> _QuantFmt:
    cands = candidates(fmt)
    d = _QuantFmt(int(fmt.cr), int(fmt.asym), int(fmt.ox), len(cands))
    for i, (fmt_bit, table, nano_mode) in enumerate(cands):
        el = table.fmt
        mode = -1 if nano_mode is None else (-2 if nano_mode == "round"
                                             else int(nano_mode))
        d.c[i] = _Cand(fmt_bit, int(el.is_bfp), el.mbits, el.bias, table.emax,
                       mode, float(np.float32(table.max_pos)))
    return d


def kernel_supports(fmt: BlockFormat) -> bool:
    """What the TPU kernel takes: 4/5/6/8-bit, the default recycle value."""
    return (fmt.bits in KERNEL_BITS and fmt.block_size in (16, 32)
            and not (fmt.cr and fmt.recycle != "half_smallest")
            and len(candidates(fmt)) <= _MAX_CANDS)


def nxfp_quantize_pack_plain(xb, fmt: BlockFormat):
    """(T, B) float blocks -> (packed uint8 (T, bpb), meta (T,) of
    ``fmt.meta_dtype``)."""
    codes, meta = quantize_blocks_arith(xb, fmt)
    return pack_codes(codes, fmt.bits), meta


def nxfp_quantize_pack(xb, fmt: BlockFormat):
    """(T, B) f32 blocks -> (packed uint8 (T, bpb), meta (T,) uint16, or
    uint32 for asym formats).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which raises ``NotImplementedError`` for formats it does not take.
    """
    global LAUNCHES
    if not build.on_cuda(xb):
        return nxfp_quantize_pack_plain(xb, fmt)
    if not kernel_supports(fmt):
        raise NotImplementedError(
            f"{fmt.name}: the CUDA quantizer takes 4/5/6/8-bit formats "
            "with the default recycle value and block size 16/32")
    t, b = xb.shape
    build.require(b == fmt.block_size, f"block axis {b} != {fmt.block_size}")
    build.require(xb.dtype == torch.float32, f"expected float32, got {xb.dtype}")
    build.require(xb.is_contiguous() and xb.data_ptr() % 16 == 0,
                  "input must be contiguous and 16-byte aligned")
    packed = torch.empty((t, bytes_per_block(b, fmt.bits)), dtype=torch.uint8,
                         device=xb.device)
    meta = torch.empty((t,), dtype=build.meta_dtype(fmt), device=xb.device)
    desc = _desc(fmt)
    rc = build.library().nxfp_quantize_launch(
        xb.data_ptr(), packed.data_ptr(), meta.data_ptr(), t, fmt.bits, b,
        ctypes.addressof(desc), build.stream_handle(xb.device))
    build.check(rc, "nxfp_quantize")
    LAUNCHES += 1
    return packed, meta
