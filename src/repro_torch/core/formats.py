"""Format definitions for the Nanoscaling (NxFP) / Microscaling (MxFP) / BFP family.

An *element format* describes how the k bits of a single element are
interpreted (sign-magnitude integer for BFP, or sign/exponent/mantissa
floating-point for MxFP — the exponent bits are the paper's
"microexponents").

A *block format* describes a block of ``block_size`` elements sharing one
scale, plus the three NxFP techniques:

  - ``nm``  NanoMantissa: a 2-bit mantissa on the shared scale,
            scale = (1 + nano/4) * 2**E_shared.
  - ``am``  Adaptive Microexponent: a 1-bit per-block format index choosing
            between the MxFP element format (fmt=1) and the BFP element
            format (fmt=0) by per-block MSE.
  - ``cr``  Code Recycling: the sign-magnitude "-0" code (10...0) is remapped
            to -(smallest positive level)/2 (sweepable).

plus the two activation-side techniques (DESIGN.md §15):

  - ``asym`` Asymmetric microscaling (AMXFP, arxiv 2411.09909): separate
            shared scales for the positive and negative halves of the block
            — activations after GLU/softmax-adjacent nonlinearities are
            heavily sign-skewed, and a per-sign scale absorbs that skew
            without spending element bits on it.
  - ``ox``  Outlier-max mantissa (MX+, arxiv 2510.14557): the block max
            always saturates to the top code, so its code slot carries no
            information — re-use it for ``bits-1`` extra mantissa bits of
            the max element (decoded absolutely off the shared exponent),
            and store the max's 5-bit block index in the free meta bits.

Per-block metadata cost: 8 (shared exponent) + 2*nm + 1*am bits, plus
5 (``ox`` index) and 8 + 2*nm (``asym`` negative-side scale) — asymmetric
formats need a uint32 meta word, everything else still fits uint16.
"""
from __future__ import annotations

import dataclasses
import re
from functools import lru_cache
from typing import Optional, Union

__all__ = [
    "ElementFormat",
    "BlockFormat",
    "get_format",
    "ELEMENT_FORMATS",
]


@dataclasses.dataclass(frozen=True)
class ElementFormat:
    """A k-bit element encoding. ``ebits == 0`` means BFP (integer magnitude)."""

    name: str
    bits: int
    ebits: int
    mbits: int

    def __post_init__(self):
        assert self.bits == 1 + self.ebits + self.mbits, self

    @property
    def is_bfp(self) -> bool:
        return self.ebits == 0

    @property
    def bias(self) -> int:
        return (1 << (self.ebits - 1)) - 1 if self.ebits > 0 else 0


# Element formats used by the paper (OCP MX element formats + BFP + FP3).
ELEMENT_FORMATS = {
    "e2m0": ElementFormat("e2m0", 3, 2, 0),
    "e2m1": ElementFormat("e2m1", 4, 2, 1),   # MXFP4 element
    "e2m2": ElementFormat("e2m2", 5, 2, 2),   # MXFP5-ish element (paper W5)
    "e2m3": ElementFormat("e2m3", 6, 2, 3),   # MXFP6 element (precision variant)
    "e3m2": ElementFormat("e3m2", 6, 3, 2),   # MXFP6 element (range variant)
    "e4m3": ElementFormat("e4m3", 8, 4, 3),   # MXFP8 element
    "e5m2": ElementFormat("e5m2", 8, 5, 2),
    "int2": ElementFormat("int2", 2, 0, 1),
    "int3": ElementFormat("int3", 3, 0, 2),
    "int4": ElementFormat("int4", 4, 0, 3),   # BFP4 element
    "int5": ElementFormat("int5", 5, 0, 4),
    "int6": ElementFormat("int6", 6, 0, 5),
    "int7": ElementFormat("int7", 7, 0, 6),
    "int8": ElementFormat("int8", 8, 0, 7),
}

_MX_ELEM_BY_BITS = {3: "e2m0", 4: "e2m1", 5: "e2m2", 6: "e2m3", 8: "e4m3"}
_BFP_ELEM_BY_BITS = {k: f"int{k}" for k in range(2, 9)}


@dataclasses.dataclass(frozen=True)
class BlockFormat:
    """A block-scaled format in the BFP/MxFP/NxFP family."""

    name: str
    bits: int
    block_size: int = 32
    nm: bool = False
    am: bool = False
    cr: bool = False
    mx_elem: Optional[str] = None     # element-format name, None = not available
    bfp_elem: Optional[str] = None
    nano_search: str = "paper"        # "paper" (Alg. 1: {round, 0}) | "exhaustive"
    recycle: Union[str, float] = "half_smallest"
    asym: bool = False                # per-sign dual scale (AMXFP)
    ox: bool = False                  # block-max code slot -> extra mantissa

    def __post_init__(self):
        if self.am:
            assert self.mx_elem and self.bfp_elem, "AM needs both element formats"
        else:
            assert (self.mx_elem is None) != (self.bfp_elem is None), (
                "non-AM formats use exactly one element format"
            )
        if self.asym:
            # the CR window test runs in scaled units of ONE shared scale;
            # with per-sign scales the remap is ill-defined — disallowed.
            assert not self.cr, "asym formats do not support code recycling"
        if self.ox:
            # 5-bit meta index addresses the block max; the recycled slot's
            # raw code would collide with CR's 10...0 remap, and AM would
            # need a per-format emax select at decode — keep ox orthogonal.
            assert self.block_size <= 32, "ox index is 5 bits (block_size<=32)"
            assert not self.cr, "ox re-uses the -0-adjacent code space; no CR"
            assert not self.am, "ox decode assumes a single element format"

    @property
    def elem_formats(self):
        """Candidate element formats as (fmt_bit, ElementFormat) pairs."""
        out = []
        if self.bfp_elem:
            out.append((0, ELEMENT_FORMATS[self.bfp_elem]))
        if self.mx_elem:
            out.append((1, ELEMENT_FORMATS[self.mx_elem]))
        return out

    @property
    def meta_bits(self) -> int:
        return (8 + (2 if self.nm else 0) + (1 if self.am else 0)
                + (5 if self.ox else 0)
                + ((8 + (2 if self.nm else 0)) if self.asym else 0))

    @property
    def meta_dtype(self) -> str:
        """Storage dtype of the packed per-block meta word.

        The asymmetric layout (E_pos | nano_pos | fmt | ox_idx | E_neg |
        nano_neg = up to 26 bits) needs a uint32; every symmetric format —
        including symmetric+ox, whose index tops out at bit 15 — keeps the
        seed uint16 word.
        """
        return "uint32" if self.asym else "uint16"

    @property
    def bits_per_value(self) -> float:
        return self.bits + self.meta_bits / self.block_size

    @property
    def bytes_per_block(self) -> int:
        total = self.bits * self.block_size
        assert total % 8 == 0
        return total // 8


_FMT_RE = re.compile(
    r"^(?P<family>amxfp|bfp|mxfp|nxfp)(?P<bits>\d)"
    r"(?P<elem>_e\dm\d)?"
    r"(?P<techs>(_nm|_am|_cr|_ox)*)"
    r"(_bs(?P<bs>\d+))?$"
)


@lru_cache(maxsize=None)
def get_format(name: str) -> BlockFormat:
    """Parse a format name into a BlockFormat.

    Examples::

        bfp4            classic block floating point, 4-bit elements
        mxfp4           OCP Microscaling FP4 (E2M1 elements)
        mxfp6_e3m2      MxFP6 with the range-optimized element format
        nxfp4           full Nanoscaling: NM + AM + CR  (the paper's NxFP)
        nxfp4_nm        NxFP ablation: NanoMantissa only
        nxfp4_nm_am     NxFP ablation: NM + Adaptive Microexponent
        mxfp4_cr        MxFP4 + code recycling (Fig. 11 sweep)
        nxfp4_bs16      NxFP4 with block size 16 (Fig. 12 sweep)
        amxfp4          asymmetric MxFP4 (AMXFP activation format)
        amxfp4_ox       AMXFP4 + block-max outlier mantissa (MX+-style)
        mxfp4_ox        symmetric MxFP4 + outlier mantissa
    """
    m = _FMT_RE.match(name)
    if not m:
        raise ValueError(f"unknown format name: {name!r}")
    family = m.group("family")
    bits = int(m.group("bits"))
    bs = int(m.group("bs") or 32)
    techs = m.group("techs") or ""
    elem = (m.group("elem") or "").lstrip("_")

    if family == "bfp":
        assert not elem
        return BlockFormat(
            name=name, bits=bits, block_size=bs,
            nm="_nm" in techs, am=False, cr="_cr" in techs,
            mx_elem=None, bfp_elem=_BFP_ELEM_BY_BITS[bits],
            ox="_ox" in techs,
        )
    if family == "mxfp":
        mx = elem or _MX_ELEM_BY_BITS[bits]
        assert ELEMENT_FORMATS[mx].bits == bits
        return BlockFormat(
            name=name, bits=bits, block_size=bs,
            nm="_nm" in techs, am=False, cr="_cr" in techs,
            mx_elem=mx, bfp_elem=None,
            ox="_ox" in techs,
        )
    if family == "amxfp":
        # asymmetric activation microscaling (AMXFP): per-sign dual scale
        # over MxFP elements; NM / AM / OX compose, CR cannot (see
        # BlockFormat.__post_init__).
        if "_cr" in techs:
            raise ValueError(f"{name!r}: asym formats do not support _cr")
        mx = elem or _MX_ELEM_BY_BITS[bits]
        assert ELEMENT_FORMATS[mx].bits == bits
        am = "_am" in techs
        return BlockFormat(
            name=name, bits=bits, block_size=bs,
            nm="_nm" in techs, am=am, cr=False,
            mx_elem=mx, bfp_elem=_BFP_ELEM_BY_BITS[bits] if am else None,
            asym=True, ox="_ox" in techs,
        )
    # nxfp: default = all three techniques; explicit suffixes select subsets.
    nm = "_nm" in techs or techs == ""
    am = "_am" in techs or techs == ""
    cr = "_cr" in techs or techs == ""
    mx = elem or _MX_ELEM_BY_BITS[bits]
    return BlockFormat(
        name=name, bits=bits, block_size=bs,
        nm=nm, am=am, cr=cr,
        mx_elem=mx, bfp_elem=_BFP_ELEM_BY_BITS[bits] if am else None,
        ox="_ox" in techs,
    )
