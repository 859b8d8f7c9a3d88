"""Sub-byte bit-packing of element codes into per-block byte buffers.

Same layout as the reference: per quantization block, code ``i`` sits at
bit offset ``i*bits``, little-endian, so a block of 32 k-bit codes is
exactly ``4*k`` bytes and a code straddles at most two bytes. Plain
integer shifts on int32 (uint8 shifts in torch promote in surprising ways).
``pack_layout`` is the one static layout every pack and unpack here reads.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["bytes_per_block", "pack_codes", "pack_codes_scatter",
           "unpack_codes", "pack_tile", "pack_layout", "byte_fold"]


def bytes_per_block(block_size: int, bits: int) -> int:
    total = block_size * bits
    if total % 8:
        raise ValueError(f"block of {block_size} x {bits}-bit codes is not "
                         "a whole number of bytes")
    return total // 8


def pack_tile(bits: int, block_size: int = 32):
    """The kernels' pack-tile granularity, (codes, bytes), as the
    reference's: a block for in-byte widths (4 and 8 bits), two adjacent
    blocks for the byte-straddling ones. A whole block is a whole number of
    bytes, so a two-block tile's bytes are its blocks' bytes in a row: the
    tile is a kernel's choice and never changes the packed layout."""
    blocks = 1 if bits in (4, 8) else 2
    return blocks * block_size, blocks * bytes_per_block(block_size, bits)


@lru_cache(maxsize=None)
def pack_layout(block_size: int, bits: int):
    """The static layout of (block_size, bits), the reference's numpy
    arrays: (off (B,) int32, the bit offset of code i in its low byte;
    lo_route (B, bpb) f32 0/1, code i's low byte; hi_route (B, bpb) f32
    0/1, its spill byte, clamped to the last byte where it has none (its
    spill is 0 there); bpb)."""
    p = np.arange(block_size) * bits
    lo = p // 8
    off = (p % 8).astype(np.int32)
    bpb = bytes_per_block(block_size, bits)
    hi = np.minimum(lo + 1, bpb - 1)
    lo_route = np.zeros((block_size, bpb), np.float32)
    hi_route = np.zeros((block_size, bpb), np.float32)
    lo_route[np.arange(block_size), lo] = 1.0
    hi_route[np.arange(block_size), hi] = 1.0
    return off, lo_route, hi_route, bpb


def _byte_index(block_size: int, bits: int, device):
    """``pack_layout`` as indices on ``device``: (low byte, spill byte, bit
    offset) per code, and bpb."""
    off, lo_route, hi_route, bpb = pack_layout(block_size, bits)

    def idx(a):
        return torch.from_numpy(a).to(device)

    return (idx(lo_route.argmax(1)), idx(hi_route.argmax(1)), idx(off),
            bpb)


def pack_codes(codes, bits: int):
    """(..., nb, B) uint8 codes -> (..., nb, B*bits//8) uint8 bytes."""
    if bits == 8:
        return codes.to(torch.uint8)
    lo, hi, off, bpb = _byte_index(codes.shape[-1], bits, codes.device)
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
    lo, hi, off, bpb = _byte_index(codes.shape[-1], bits, codes.device)
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
    lo, hi, off, bpb = _byte_index(block_size, bits, packed.device)
    if packed.shape[-1] != bpb:
        raise ValueError(f"packed block is {packed.shape[-1]} bytes, "
                         f"expected {bpb}")
    b = packed.to(torch.int32)
    # the clamped spill byte of a no-spill code only feeds bits the mask drops
    word = b[..., lo] | (b[..., hi] << 8)
    return ((word >> off) & ((1 << bits) - 1)).to(torch.uint8)


_M32 = 0xFFFFFFFF


@lru_cache(maxsize=64)
def _byte_weights(n: int, size: int, device: torch.device) -> torch.Tensor:
    """(n * size,) int64: byte k of element j weighs ``(2j + 1) * 256^k
    mod 2^32``. Built on the host once per layout and device."""
    w = ((2 * np.arange(n, dtype=np.int64)[:, None] + 1)
         << (8 * np.arange(size, dtype=np.int64))) & _M32
    return torch.from_numpy(w.reshape(-1)).to(device)


def byte_fold_wide(x, keep_dims: int) -> torch.Tensor:
    """``byte_fold`` before its final ``mod 2^32``: int64, whose low 32
    bits are the fold. Sums of these may be taken before one reduction."""
    lead = tuple(x.shape[:keep_dims])
    rows = x.contiguous().view(torch.uint8).reshape(lead + (-1,))
    size = x.element_size()
    w = _byte_weights(rows.shape[-1] // size, size, rows.device)
    return (rows * w).sum(dim=-1)


def byte_fold(x, keep_dims: int):
    """The reference's position-weighted integrity fold: one uint32 per
    index of the first ``keep_dims`` axes, ``sum_j x[j] * (2j + 1) mod
    2^32`` over the flattened rest, of unsigned ints of the element's
    width (floats by their bits). Folded as bytes: an element is the
    little-endian sum of its bytes, so byte k of element j weighs
    ``(2j + 1) * 256^k`` (``_byte_weights``) and one product and one sum
    make the fold, with no per-dtype widening. Summed in int64, where
    wrap-around keeps the low 32 bits exact; returns torch.uint32."""
    return (byte_fold_wide(x, keep_dims) & _M32).to(torch.uint32)
