"""QTensor (a direct-cast tensor) and direct-cast of nested parameter dicts."""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Tuple

import torch

from ..tree import tree_leaves as _leaves  # a QTensor is one leaf
from .formats import BlockFormat, get_format
from .pack import unpack_codes
from .quantize import dequantize_blocks, from_blocks

__all__ = ["QTensor", "QuantPolicy", "direct_cast_tree", "dense_like",
           "tree_footprint_bytes", "fmt_key", "cast_formats"]


def fmt_key(fmt: BlockFormat):
    """QTensor.fmt_name for a BlockFormat: the registry name when it names
    this format, else the BlockFormat itself (an ad-hoc format, e.g. a
    custom recycle value of the Fig. 11 sweep), as in the reference."""
    try:
        return fmt.name if get_format(fmt.name) == fmt else fmt
    except ValueError:
        return fmt


@dataclasses.dataclass
class QTensor:
    """A direct-cast NxFP/MxFP/BFP tensor, in the reference's layout.

    ``packed``: (..., nb, bytes_per_block) uint8 — block axis moved last.
    ``meta``:   (..., nb) uint16, or uint32 for the asymmetric activation
                formats — shared exponent(s) / nano / fmt / ox bits.
    Aux fields: format name, logical shape, block axis (always negative),
    original length of the blocked axis.
    """

    packed: torch.Tensor
    meta: torch.Tensor
    fmt_name: str
    shape: Tuple[int, ...]
    axis: int
    orig_len: int

    @property
    def fmt(self) -> BlockFormat:
        # a registry name, or the BlockFormat itself for an ad-hoc format
        # (a custom recycle value: fmt_key)
        if isinstance(self.fmt_name, BlockFormat):
            return self.fmt_name
        return get_format(self.fmt_name)

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def dequantize(self, dtype=torch.bfloat16):
        fmt = self.fmt
        codes = unpack_codes(self.packed, fmt.bits, fmt.block_size)
        deq = dequantize_blocks(codes, self.meta, fmt, torch.float32)
        return from_blocks(deq, self.orig_len, self.axis).to(dtype)

    def nbytes(self) -> int:
        return (self.packed.numel() * self.packed.element_size()
                + self.meta.numel() * self.meta.element_size())


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Which parameter leaves get direct-cast, and how (the reference's
    fields and regexes, less the SSM families' ``state_fmt``)."""

    weight_fmt: Optional[str] = "nxfp4"
    kv_fmt: Optional[str] = "nxfp4"
    pattern: str = r"(w|kernel|embed|weight)"
    skip: str = r"(norm|scale|bias|gamma|beta|dt_bias|a_log|conv|tok_embed|pos_embed|router)"
    axis: int = -2
    min_size: int = 1024

    def matches(self, path: str, leaf) -> bool:
        return self.weight_fmt is not None and self.castable(path, leaf)

    def castable(self, path: str, leaf) -> bool:
        """Whether a weight format would cast this leaf."""
        if getattr(leaf, "ndim", 0) < 2:
            return False
        if leaf.numel() < self.min_size:
            return False
        p = path.lower()
        if re.search(self.skip, p):
            return False
        return re.search(self.pattern, p) is not None


def _map_with_path(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def direct_cast_tree(params, policy: QuantPolicy, quantize_fn):
    """Direct-cast a nested parameter dict: matching leaves become QTensor.

    ``quantize_fn(leaf, fmt, axis) -> QTensor`` is the encoder (the serving
    engine passes ``kernels.ops.quantize_qtensor``). Leaves are cast one at
    a time, so only one dense leaf's temporaries are alive at once.
    """
    def cast(path, leaf):
        if policy.matches(path, leaf):
            return quantize_fn(leaf, policy.weight_fmt, policy.axis)
        return leaf

    return _map_with_path(cast, params)


def dense_like(qparams):
    """Every QTensor leaf decoded back to bf16, the rest as it is (the
    reference's paper-style evaluation of a cast tree)."""
    return _map_with_path(
        lambda _, leaf: leaf.dequantize() if isinstance(leaf, QTensor)
        else leaf, qparams)


def cast_formats(params) -> set:
    """The names of the formats a tree's QTensor leaves are cast to (empty
    for an uncast tree)."""
    return {leaf.fmt.name for leaf in _leaves(params)
            if isinstance(leaf, QTensor)}


def tree_footprint_bytes(params) -> int:
    """Stored bytes: packed + meta for QTensor leaves, nbytes for the rest."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes()
        else:
            total += leaf.numel() * leaf.element_size()
    return total
