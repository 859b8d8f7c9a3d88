"""Arithmetic (LUT-free) NxFP field decode, plain PyTorch.

Port of the reference's ``kernels/decode_lib.py`` (``decode_elem``,
``decode_scale``, ``decode_block_values`` and, for the activation formats,
``decode_block_values_ex``). Its device twin is ``csrc/nxfp_decode.cuh``,
which the CUDA kernels share; both build values from exponent bits, so
they are exact and bitwise equal to the table-driven
``core.quantize.dequantize_blocks``.
"""
from __future__ import annotations

import torch

from ..core.formats import ELEMENT_FORMATS, BlockFormat, ElementFormat
from ..core.quantize import meta_int32, ox_substitute, pow2i, recycled_value

__all__ = ["decode_elem", "decode_scale", "decode_block_values",
           "decode_block_values_ex", "elem_desc"]


def elem_desc(elem: ElementFormat, cr: bool, recycle="half_smallest"):
    """(bits, is_bfp, ebits, mbits, bias, cr, cr_val): the ElemDesc of
    csrc/; cr_val is what the recycled code decodes to."""
    cr_val = recycled_value(elem.name, recycle) if cr else 0.0
    return (elem.bits, int(elem.is_bfp), elem.ebits, elem.mbits, elem.bias,
            int(cr), cr_val)


def decode_elem(codes, elem_name: str, cr: bool, recycle="half_smallest"):
    """k-bit element codes -> f32 values in scaled units (Fig. 7 steps 1-3).
    With ``cr`` the -0 code (10...0) decodes to the recycled value:
    -smallest/2 by default, else ``recycle``."""
    fmt = ELEMENT_FORMATS[elem_name]
    bits, ebits, mbits, bias = fmt.bits, fmt.ebits, fmt.mbits, fmt.bias
    c = codes.to(torch.int32)
    sign = (c >> (bits - 1)) & 1
    mag = c & ((1 << (bits - 1)) - 1)
    if fmt.is_bfp:
        val = mag.to(torch.float32)
        smallest = 1.0
    else:
        e = mag >> mbits
        m = (mag & ((1 << mbits) - 1)).to(torch.float32) * (0.5 ** mbits)
        sub = m * (2.0 ** (1 - bias))
        nrm = (1.0 + m) * pow2i(e - bias)
        val = torch.where(e == 0, sub, nrm)
        if ebits == 4 and mbits == 3:  # e4m3 NaN code decodes to 0
            val = torch.where(mag == 127, torch.zeros_like(val), val)
        smallest = 0.5 ** mbits * 2.0 ** (1 - bias)
    val = torch.where(sign == 1, -val, val)
    if cr:
        r = (-0.5 * smallest if recycle == "half_smallest"
             else recycled_value(elem_name, recycle))
        val = torch.where(c == (1 << (bits - 1)), torch.full_like(val, r),
                          val)
    return val


def decode_scale(meta):
    """meta (uint16 semantics) -> (scale f32, fmt_bit int32)."""
    m = meta_int32(meta) & 0xFFFF
    nano = (m >> 8) & 0x3
    scale = (1.0 + nano.to(torch.float32) * 0.25) * pow2i((m & 0xFF) - 128)
    return scale, (m >> 10) & 0x1


def decode_block_values(codes, meta, fmt: BlockFormat):
    """codes (..., nb, B), meta (..., nb) -> f32 values (original units)."""
    if fmt.asym or fmt.ox:
        return decode_block_values_ex(codes, meta, fmt)
    scale, fmt_bit = decode_scale(meta)
    return _elem_values(codes, fmt_bit, fmt) * scale[..., None]


def _elem_values(codes, fmt_bit, fmt: BlockFormat):
    """Element values in scaled units, AM-selected by ``fmt_bit``."""
    vals = None
    for fb, elem in fmt.elem_formats:
        v = decode_elem(codes, elem.name, fmt.cr, fmt.recycle)
        vals = v if vals is None else torch.where(
            (fmt_bit == fb)[..., None], v, vals)
    return vals


def decode_block_values_ex(codes, meta, fmt: BlockFormat):
    """Decode of the activation formats (``asym`` / ``ox``), bitwise equal
    to ``core.quantize.dequantize_blocks``: the sign of the decoded value
    picks the asym scale (meta bits [16:24] E-, [24:26] nano-), and the
    element at meta bits [11:16] takes the outlier value
    ``(1 + m/2^(bits-1)) * 2^(E_sign + emax)`` unless the E byte is 0."""
    m = meta_int32(meta)
    e_p = (m & 0xFF) - 128
    scale_p = (1.0 + ((m >> 8) & 0x3).to(torch.float32) * 0.25) * pow2i(e_p)
    c = codes.to(torch.int32)
    vals = _elem_values(c, (m >> 10) & 0x1, fmt)
    if fmt.asym:
        e_n = ((m >> 16) & 0xFF) - 128
        scale_n = (1.0 + ((m >> 24) & 0x3).to(torch.float32) * 0.25) \
            * pow2i(e_n)
        out = vals * torch.where(vals < 0, scale_n[..., None],
                                 scale_p[..., None])
    else:
        e_n = e_p
        out = vals * scale_p[..., None]
    if fmt.ox:
        out = ox_substitute(out, c, m, e_p, e_n, fmt)
    return out
