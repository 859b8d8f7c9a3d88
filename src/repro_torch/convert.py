"""Parameter trees from the JAX reference layout into the port's layout.

The reference stacks layers on a leading ``L`` axis (``params["layers"]``
is a dict of (L, ...) arrays); the port holds a list of per-layer dicts.
The input is a tree of numpy arrays, e.g.
``jax.tree.map(np.asarray, init_params(cfg, PRNGKey(0)))``. Already-cast
QTensor leaves (anything with ``packed``/``meta`` children and the
QTensor aux fields) carry across with their exact bytes, split on ``L``,
so the kernels can be fed the reference's own packed weights: an MoE
expert stack (L, E, D, F) cast along axis -2 becomes one QTensor of
logical shape (E, D, F) a layer, packed (E, F, KB, bpb). The vision
family's groups (``self_layers``, leaves (G, every - 1, ...), and
``cross_layers``, (G, ...)) become one flat list in execution order
(every - 1 self layers, then the group's cross layer); the audio
family's ``enc_layers`` and ``layers`` are split on L, its
``enc_pos_embed`` and ``enc_scale`` carried as they are. Nothing here
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
        packed, meta = packed[index], meta[index]
        shape = shape[len(index):]
    return QTensor(tensor_from_numpy(packed, device),
                   tensor_from_numpy(meta, device), leaf.fmt_name, shape,
                   int(leaf.axis), int(leaf.orig_len))


def _leaf(name: str, leaf, device, index=None, train: bool = False):
    if _is_qtensor(leaf):
        return _qtensor(leaf, device, index)
    a = np.asarray(leaf)
    if index is not None:
        a = a[index]
    t = tensor_from_numpy(a, device)
    return t.to(torch.bfloat16) if name in _BF16_LEAVES and not train else t


def _split(stack: Dict[str, Any], device, lead: int = 1):
    """A stacked layer dict (leaves with ``lead`` leading stack axes) ->
    the list of its layers, the stack axes flattened in order."""
    dims = {(leaf.packed if _is_qtensor(leaf) else np.asarray(leaf)
             ).shape[:lead] for leaf in stack.values()}
    if len(dims) != 1:
        raise ValueError(f"stacked layer leaves disagree on their stack "
                         f"axes: {dims}")
    return [{name: _leaf(name, leaf, device, idx)
             for name, leaf in stack.items()}
            for idx in np.ndindex(*dims.pop())]


def params_from_jax(tree: Dict[str, Any], device=None,
                    train: bool = False) -> Dict[str, Any]:
    """Reference parameter tree (numpy leaves) -> port tree: every
    stacked layer leaf (attention, MLP, the MoE router, experts and shared
    MLP, the Mamba block's ``ssm_*`` leaves, the cross projections; cast
    or dense) split on its stack axes into the port's list of layers:
    ``layers`` (and the audio family's ``enc_layers``) on L, the vision
    family's ``self_layers`` (G, every - 1) and ``cross_layers`` (G)
    interleaved into one ``layers`` list in execution order. ``train``
    keeps ``tok_embed`` and ``lm_head`` in f32 (``lm.init_params``'s
    training tree), else they are stored in bf16."""
    dev = resolve_device(device)
    stacks = ("layers", "enc_layers", "self_layers", "cross_layers")
    out = {name: _leaf(name, leaf, dev, train=train)
           for name, leaf in tree.items() if name not in stacks}
    if "self_layers" in tree:
        selfs = _split(tree["self_layers"], dev, lead=2)
        cross = _split(tree["cross_layers"], dev)
        per = len(selfs) // len(cross)
        out["layers"] = [layer for g, c in enumerate(cross)
                         for layer in selfs[g * per:(g + 1) * per] + [c]]
    else:
        out["layers"] = _split(tree["layers"], dev)
    if "enc_layers" in tree:
        out["enc_layers"] = _split(tree["enc_layers"], dev)
    return out
