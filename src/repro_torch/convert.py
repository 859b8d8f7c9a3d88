"""Parameter trees from the JAX reference layout into the port's layout.

The reference stacks layers on a leading ``L`` axis (``params["layers"]``
is a dict of (L, ...) arrays); the port holds a list of per-layer dicts.
The input is a tree of numpy arrays, e.g.
``jax.tree.map(np.asarray, init_params(cfg, PRNGKey(0)))``. Already-cast
QTensor leaves (anything with ``packed``/``meta`` children and the
QTensor aux fields) carry across with their exact bytes, split on ``L``,
so the kernels can be fed the reference's own packed weights: an MoE
expert stack (L, E, D, F) cast along axis -2 becomes one QTensor of
logical shape (E, D, F) a layer, packed (E, F, KB, bpb). Nothing here
imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device
from .core.qtensor import QTensor

__all__ = ["params_from_jax", "tensor_from_numpy"]

# leaves the port stores in bf16 (every use rounds them to bf16)
_BF16_LEAVES = ("tok_embed", "lm_head")


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """numpy -> torch, bit for bit, as a copy."""
    return torch.from_numpy(np.array(a)).to(device)


def _is_qtensor(leaf) -> bool:
    return all(hasattr(leaf, n) for n in
               ("packed", "meta", "fmt_name", "shape", "axis", "orig_len"))


def _qtensor(leaf, device, index=None) -> QTensor:
    if not isinstance(leaf.fmt_name, str):
        raise ValueError("only registry formats carry across "
                         f"(got {leaf.fmt_name!r})")
    packed, meta = np.asarray(leaf.packed), np.asarray(leaf.meta)
    shape = tuple(leaf.shape)
    if index is not None:
        packed, meta, shape = packed[index], meta[index], shape[1:]
    return QTensor(tensor_from_numpy(packed, device),
                   tensor_from_numpy(meta, device), leaf.fmt_name, shape,
                   int(leaf.axis), int(leaf.orig_len))


def _leaf(name: str, leaf, device, index=None):
    if _is_qtensor(leaf):
        return _qtensor(leaf, device, index)
    a = np.asarray(leaf)
    if index is not None:
        a = a[index]
    t = tensor_from_numpy(a, device)
    return t.to(torch.bfloat16) if name in _BF16_LEAVES else t


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Reference parameter tree (numpy leaves) of a dense, moe, ssm or
    hybrid model -> port tree: every stacked layer leaf (attention, MLP,
    the MoE router, experts and shared MLP, and the Mamba block's
    ``ssm_*`` leaves, cast or dense) split on L."""
    dev = resolve_device(device)
    out = {name: _leaf(name, leaf, dev) for name, leaf in tree.items()
           if name != "layers"}
    layers = tree["layers"]
    n_layers = {(leaf.packed if _is_qtensor(leaf) else np.asarray(leaf)
                 ).shape[0] for leaf in layers.values()}
    if len(n_layers) != 1:
        raise ValueError(f"stacked layer leaves disagree on L: {n_layers}")
    out["layers"] = [{name: _leaf(name, leaf, dev, i)
                      for name, leaf in layers.items()}
                     for i in range(n_layers.pop())]
    return out
