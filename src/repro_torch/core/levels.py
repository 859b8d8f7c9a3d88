"""Quantization-level tables for element formats.

Everything here is host-side numpy, computed once per (element format,
code-recycling option) and closed over by the jitted quantize/dequantize
functions. Levels are expressed in *scaled units*: the dequantized value of
code ``c`` is ``level[c] * (1 + nano/4) * 2**E_shared``.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple, Union

import numpy as np

from .formats import ElementFormat, ELEMENT_FORMATS

__all__ = ["LevelTable", "level_table"]


def _element_value(fmt: ElementFormat, code: int) -> float:
    """Decode one binary code of an element format (no CR)."""
    sign = -1.0 if (code >> (fmt.bits - 1)) & 1 else 1.0
    mag = code & ((1 << (fmt.bits - 1)) - 1)
    if fmt.is_bfp:
        return sign * float(mag)
    e_field = mag >> fmt.mbits
    m_field = mag & ((1 << fmt.mbits) - 1)
    if fmt.ebits == 4 and fmt.mbits == 3 and e_field == 15 and m_field == 7:
        return math.nan  # OCP e4m3: S.1111.111 is NaN — excluded from the grid
    if e_field == 0:  # subnormal
        return sign * (m_field / (1 << fmt.mbits)) * 2.0 ** (1 - fmt.bias)
    return sign * (1.0 + m_field / (1 << fmt.mbits)) * 2.0 ** (e_field - fmt.bias)


class LevelTable:
    """Sorted quantization grid + code mapping for one element format.

    Attributes:
      values_sorted: (L,) float32, ascending dequant values (scaled units).
      codes_sorted:  (L,) uint8, binary code of each level.
      boundaries:    (L-1,) float32 midpoints for nearest-level search.
      decode:        (2**bits,) float32, value by binary code (CR applied).
      max_pos:       largest positive level.
      smallest_pos:  smallest strictly-positive level (pre-CR grid).
      emax:          floor(log2(max_pos)) — the shared-exponent offset.
    """

    def __init__(self, fmt: ElementFormat, cr: bool,
                 recycle: Union[str, float] = "half_smallest"):
        self.fmt = fmt
        self.cr = cr
        n = 1 << fmt.bits
        decode = np.array([_element_value(fmt, c) for c in range(n)], np.float64)
        pos = decode[np.isfinite(decode) & (decode > 0)]
        self.smallest_pos = float(pos.min())
        self.max_pos = float(pos.max())
        self.emax = int(math.floor(math.log2(self.max_pos)))

        neg_zero_code = 1 << (fmt.bits - 1)  # 10...0
        if cr:
            if recycle == "half_smallest":
                recycled = -0.5 * self.smallest_pos
            else:
                recycled = float(recycle)
            decode[neg_zero_code] = recycled
        # Build the encode grid: unique finite values; prefer the canonical +0
        # code for 0.0 and drop the un-recycled -0 duplicate / NaN codes.
        entries = []
        seen = set()
        for c in range(n):
            v = decode[c]
            if not np.isfinite(v):
                continue
            if (not cr) and c == neg_zero_code:
                continue  # -0 duplicates +0; wasted code (the paper's point)
            if v in seen:
                continue
            seen.add(v)
            entries.append((v, c))
        entries.sort()
        self.values_sorted = np.array([v for v, _ in entries], np.float32)
        self.codes_sorted = np.array([c for _, c in entries], np.uint8)
        self.boundaries = (
            (self.values_sorted[1:] + self.values_sorted[:-1]) / 2.0
        ).astype(np.float32)
        decode[~np.isfinite(decode)] = 0.0
        if not cr:
            decode[neg_zero_code] = 0.0
        self.decode = decode.astype(np.float32)

    @property
    def num_levels(self) -> int:
        return len(self.values_sorted)


@lru_cache(maxsize=None)
def level_table(elem_name: str, cr: bool,
                recycle: Union[str, float] = "half_smallest") -> LevelTable:
    return LevelTable(ELEMENT_FORMATS[elem_name], cr, recycle)
