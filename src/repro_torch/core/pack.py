"""Sub-byte bit-packing of element codes into per-block byte buffers.

Same layout as the reference: per quantization block, code ``i`` sits at
bit offset ``i*bits``, little-endian, so a block of 32 k-bit codes is
exactly ``4*k`` bytes and a code straddles at most two bytes. Plain
integer shifts on int32 (uint8 shifts in torch promote in surprising ways).
"""
from __future__ import annotations

import torch

__all__ = ["bytes_per_block", "pack_codes", "pack_codes_scatter",
           "unpack_codes"]


def bytes_per_block(block_size: int, bits: int) -> int:
    total = block_size * bits
    if total % 8:
        raise ValueError(f"block of {block_size} x {bits}-bit codes is not "
                         "a whole number of bytes")
    return total // 8


def _layout(block_size: int, bits: int, device):
    """(lo byte, spill byte clamped to the last byte, bit offset) per code."""
    bpb = bytes_per_block(block_size, bits)
    p = torch.arange(block_size, device=device) * bits
    lo = p // 8
    return lo, torch.clamp(lo + 1, max=bpb - 1), (p % 8).to(torch.int32), bpb


def pack_codes(codes, bits: int):
    """(..., nb, B) uint8 codes -> (..., nb, B*bits//8) uint8 bytes."""
    if bits == 8:
        return codes.to(torch.uint8)
    lo, hi, off, bpb = _layout(codes.shape[-1], bits, codes.device)
    shifted = codes.to(torch.int32) << off
    out = torch.zeros(*codes.shape[:-1], bpb, dtype=torch.int32,
                      device=codes.device)
    # the bit-fields are disjoint, so the integer sums are exact ORs; a code
    # with no spill adds 0 to its clamped spill byte
    out.index_add_(-1, lo, shifted & 0xFF)
    out.index_add_(-1, hi, shifted >> 8)
    return out.to(torch.uint8)


def pack_codes_scatter(codes, bits: int):
    """The reference's scatter-add pack (``core/pack.py:
    pack_codes_scatter``), its oracle for the packed layout: each code's
    low-byte and spill contributions added into their bytes by index
    (the spill index clamped to the last byte, where it adds 0)."""
    lo, hi, off, bpb = _layout(codes.shape[-1], bits, codes.device)
    shifted = codes.to(torch.int32) << off
    out = torch.zeros(*codes.shape[:-1], bpb, dtype=torch.int32,
                      device=codes.device)
    idx = lambda i: i.expand(*codes.shape[:-1], -1)  # noqa: E731
    out.scatter_add_(-1, idx(lo), shifted & 0xFF)
    out.scatter_add_(-1, idx(hi), shifted >> 8)
    return out.to(torch.uint8)


def unpack_codes(packed, bits: int, block_size: int):
    """(..., nb, bpb) uint8 bytes -> (..., nb, block_size) uint8 codes."""
    if bits == 8:
        return packed.to(torch.uint8)
    lo, hi, off, bpb = _layout(block_size, bits, packed.device)
    if packed.shape[-1] != bpb:
        raise ValueError(f"packed block is {packed.shape[-1]} bytes, "
                         f"expected {bpb}")
    b = packed.to(torch.int32)
    # the clamped spill byte of a no-spill code only feeds bits the mask drops
    word = b[..., lo] | (b[..., hi] << 8)
    return ((word >> off) & ((1 << bits) - 1)).to(torch.uint8)
