"""Sharding rules: logical parameter axes -> per-dimension mesh axes (the
reference's ``sharding/rules.py``).

Mesh axes: ('data', 'model') single pod, ('pod', 'data', 'model')
multi-pod. 'model' is tensor parallel (column/row parallel projections,
expert parallel on the expert axis, SSM channel parallel, KV-head
parallel); 'data' (+ 'pod') is batch data parallel, optionally FSDP.

A spec (``P``, a tuple, as the reference's ``PartitionSpec``) has one
entry a dimension: a mesh axis name, a tuple of names (one dimension
split over several axes, the first outermost), or None (replicated);
``P()`` replicates every dimension. Every rule passes through
``fit_spec``, which drops a mesh axis that does not divide its
dimension. ``to_shardings`` turns specs into ``torch.distributed.tensor``
placements, one per mesh axis.

The reference stacks layers (``params["layers"]`` leaves (L, ...), the
vision family's self layers (G, every - 1, ...)); the port holds a list
of per-layer dicts. FSDP's size threshold and its "largest replicated
dimension" read the stacked shape (a (126, 16384) norm scale is sharded,
one layer's (16384,) alone would not be), so a per-layer leaf's spec is
the reference's spec of the stacked leaf, its layer axes dropped.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Tuple

from ..core.qtensor import QTensor
from ..tree import tree_map


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``. A
    tuple of one axis name is that name, as in the reference's
    ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# leaf-name regex -> per-dimension logical axes for the LAST dims (leading
# stacked dims are always None); 'tp' and 'ep' are the 'model' axis
_RULES = [
    # the embedding gather table shards d_model, not vocab
    (r"tok_embed$", (None, "tp")),
    (r"lm_head$", (None, "tp")),
    (r"enc_pos_embed$", (None, None)),
    (r"(wq|wk|wv)$", (None, "tp")),          # column parallel
    (r"wo$", ("tp", None)),                  # row parallel
    (r"(mlp_w1|mlp_w3|shared_w1|shared_w3)$", (None, "tp")),
    (r"(mlp_w2|shared_w2)$", ("tp", None)),
    (r"router$", (None, None)),
    (r"experts_w[13]$", ("ep", None, None)),  # expert parallel
    (r"experts_w2$", ("ep", None, None)),
    (r"ssm_in_w$", (None, "tp")),
    (r"ssm_conv_w$", ("tp", None)),
    (r"ssm_conv_b$", ("tp",)),
    (r"ssm_x_w$", ("tp", None)),
    (r"ssm_dt_w$", (None, "tp")),
    (r"ssm_dt_bias$", ("tp",)),
    (r"ssm_a_log$", ("tp", None)),
    (r"ssm_d_skip$", ("tp",)),
    (r"ssm_out_w$", ("tp", None)),
    (r"(scale|bias)$", None),                # norms etc: replicated
]

_AXIS_MAP = {"tp": "model", "ep": "model"}

# the gather table's size (f32 bytes) below which tok_embed is replicated
_REPLICATED_EMBED_BYTES = 3.5e9


def _mesh_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(mesh.shape[n] for n in name)
    return mesh.shape[name]


def _entries(spec: tuple, ndim: int) -> list:
    return list(tuple(spec) + (None,) * (ndim - len(spec)))


def fit_spec(shape, spec: tuple, mesh) -> P:
    """Drop axes that don't divide their dim (graceful replication)."""
    return P(*(ax if ax and d % _mesh_size(mesh, ax) == 0 else None
               for d, ax in zip(shape, _entries(spec, len(shape)))))


def _dense_spec(name: str, ndim: int) -> P:
    for pat, axes in _RULES:
        if re.search(pat, name):
            if axes is None:
                return P()
            mapped = tuple(_AXIS_MAP.get(a, a) if a else None for a in axes)
            return P(*((None,) * (ndim - len(mapped)) + mapped))
    return P()


def _apply_fsdp(shape, spec: P, mesh, min_size: int = 1 << 20) -> P:
    """Shard the largest replicated dim over 'data' (FSDP weight sharding)."""
    if math.prod(shape) < min_size or "data" not in mesh.shape:
        return spec
    entries = _entries(spec, len(shape))
    cands = [i for i, (d, ax) in enumerate(zip(shape, entries))
             if ax is None and d % mesh.shape["data"] == 0 and d > 1]
    if not cands:
        return spec
    entries[max(cands, key=lambda i: shape[i])] = "data"
    return P(*entries)


def _qtensor_specs(qt_shapes, dense_spec: P, axis: int) -> Dict[str, P]:
    """The packed and meta specs of a QTensor from its dense spec: packed
    is the dense layout with the quantized axis moved last and split into
    (blocks, bytes), meta the same without the bytes."""
    _, meta_shape = qt_shapes
    nd = len(meta_shape)                      # == dense ndim (block dim last)
    entries = _entries(dense_spec, nd)
    a = axis % nd
    moved = [e for i, e in enumerate(entries) if i != a] + [entries[a]]
    return {"packed": P(*moved, None), "meta": P(*moved)}


def _layer_stacks(cfg, params) -> list:
    """(stack name, stacked axes) of each of ``params["layers"]``, as the
    reference stacks them: the vision family's self layers (G, every - 1)
    and cross layers (G); every other family's layers (L)."""
    n = len(params["layers"])
    if cfg.family != "vlm":
        return [("layers", (n,))] * n
    every = cfg.cross_attn_every
    groups = n // every
    return [("cross_layers", (groups,)) if i % every == every - 1
            else ("self_layers", (groups, every - 1)) for i in range(n)]


def _leaf_spec(name: str, leaf, lead: Tuple[int, ...], mesh, fsdp: bool):
    """The reference's spec of the leaf stacked on ``lead``, its stacked
    axes dropped."""
    k = len(lead)
    if name.endswith("tok_embed") and not isinstance(leaf, QTensor):
        if math.prod(leaf.shape) * 4 < _REPLICATED_EMBED_BYTES:
            return P()
    if isinstance(leaf, QTensor):
        shape = lead + tuple(leaf.shape)
        spec = fit_spec(shape, _dense_spec(name, len(shape)), mesh)
        if fsdp:
            spec = _apply_fsdp(shape, spec, mesh)
        packed = lead + tuple(leaf.packed.shape)
        meta = lead + tuple(leaf.meta.shape)
        sub = _qtensor_specs((packed, meta), spec, leaf.axis)
        return dataclasses.replace(
            leaf, packed=P(*fit_spec(packed, sub["packed"], mesh)[k:]),
            meta=P(*fit_spec(meta, sub["meta"], mesh)[k:]))
    shape = lead + tuple(leaf.shape)
    spec = fit_spec(shape, _dense_spec(name, len(shape)), mesh)
    if fsdp:
        spec = fit_spec(shape, _apply_fsdp(shape, spec, mesh), mesh)
    return P(*spec[k:])


def params_specs(cfg, params, mesh, fsdp: bool = False):
    """The port's parameter tree with each leaf replaced by its spec (a
    QTensor leaf by a QTensor whose ``packed`` and ``meta`` are specs).
    ``params`` may hold real tensors or tensors on the ``meta`` device
    (``models.init_params(cfg, device="meta")``)."""
    out = {name: _leaf_spec(name, leaf, (), mesh, fsdp)
           for name, leaf in params.items()
           if name not in ("layers", "enc_layers")}
    if "enc_layers" in params:
        n = len(params["enc_layers"])
        out["enc_layers"] = [
            {k: _leaf_spec(f"enc_layers/{k}", v, (n,), mesh, fsdp)
             for k, v in layer.items()} for layer in params["enc_layers"]]
    out["layers"] = [
        {k: _leaf_spec(f"{stack}/{k}", v, lead, mesh, fsdp)
         for k, v in layer.items()}
        for layer, (stack, lead) in zip(params["layers"],
                                        _layer_stacks(cfg, params))]
    return out


_BATCH = ("pod", "data")


def _dp_axes(mesh):
    return tuple(a for a in _BATCH if a in mesh.shape) or None


def batch_specs(mesh, batch_shapes) -> Any:
    """Inputs: batch dim over ('pod', 'data'); everything else
    replicated."""
    dp = _dp_axes(mesh)

    def spec(leaf):
        if leaf.ndim == 0:
            return P()
        b = leaf.shape[0]
        if dp and b % _mesh_size(mesh, dp) == 0:
            return P(dp)
        if dp and b % mesh.shape["data"] == 0:
            return P("data")
        return P(*((None,) * leaf.ndim))

    return tree_map(spec, batch_shapes)


_CACHE_DIMS = {
    # leaf name -> (batch dim, model-sharded dim), offsets from the END, so
    # a stacked and a per-layer leaf give the same entries
    "k": (-4, -2), "v": (-4, -2),                  # (.., B, S, KVH, hd)
    "mem_k": (-4, -2), "mem_v": (-4, -2),
    "k_packed": (-5, -3), "v_packed": (-5, -3),    # (.., B, S, KVH, nb, bpb)
    "k_meta": (-4, -2), "v_meta": (-4, -2),        # (.., B, S, KVH, nb)
    "h": (-3, -2),                                 # (.., B, di, N)
    "conv": (-3, -1),                              # (.., B, cw - 1, di)
}


def cache_specs(mesh, cache_shapes) -> Any:
    """Serving cache: batch over the data-parallel axes; KV-head and
    channel dims over 'model'. Leaves are named by their key (the
    reference's leaf names); the port's per-layer leaves carry the same
    trailing dims as its stacked ones."""
    dp = _dp_axes(mesh)
    has_tp = "model" in mesh.shape   # serving meshes may be data-only
    tp = mesh.shape.get("model", 1)

    def spec(name, leaf):
        if leaf.ndim == 0 or name not in _CACHE_DIMS:
            return P(*((None,) * leaf.ndim))
        bdim, mdim = _CACHE_DIMS[name]
        e: list = [None] * leaf.ndim
        b = leaf.shape[bdim]
        if dp and b % _mesh_size(mesh, dp) == 0:
            e[bdim % leaf.ndim] = dp
        elif dp and b % mesh.shape["data"] == 0:
            e[bdim % leaf.ndim] = "data"
        if has_tp and leaf.shape[mdim] % tp == 0 and leaf.shape[mdim] >= tp:
            e[mdim % leaf.ndim] = "model"
        return P(*e)

    def walk(name, node):
        if isinstance(node, dict):
            return {k: walk(k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(name, v) for v in node)
        return spec(name, node)

    return walk("", cache_shapes)


def slot_cache_specs(cache: Dict[str, Any]) -> Dict[str, Any]:
    """Which axis of each leaf of a slot cache the shards split: the
    cache's structure with an int a leaf. ``pos`` (B,) and every layer
    leaf of the port's layout (a list of per-layer dicts, no stacked
    layer axis) carry the slot axis first, so every entry is 0; a paged
    layer's pool leaves split their page axis (0) the same way, each
    shard holding a pool of its own. The reference's spec prefixes put
    the slot axis after its stacked layer axis (1; 2 for the vision
    family's self-attention stack, which the continuous engines do not
    serve)."""
    return {"pos": 0,
            "layers": [{name: 0 for name in layer}
                       for layer in cache["layers"]]}


def to_shardings(mesh, specs):
    """Spec tree -> placement tree: each spec becomes a tuple of
    ``torch.distributed.tensor`` placements, one per mesh axis in
    ``mesh.axis_names`` order (``Shard(d)`` on the axes that split dim
    ``d``, ``Replicate()`` on the rest), what ``distribute_tensor`` takes
    over the mesh's ``device_mesh``. A QTensor of specs becomes a QTensor
    of placements."""
    from torch.distributed.tensor import Replicate, Shard

    def conv(spec):
        out = [Replicate()] * len(mesh.axis_names)
        for d, ax in enumerate(spec):
            for name in (ax if isinstance(ax, tuple) else (ax,)):
                if name is not None:
                    out[mesh.axis_names.index(name)] = Shard(d)
        return tuple(out)

    def walk(node):
        if isinstance(node, QTensor):
            return dataclasses.replace(node, packed=conv(node.packed),
                                       meta=conv(node.meta))
        if isinstance(node, P):
            return conv(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        items = [walk(v) for v in node]
        return (type(node)(*items) if hasattr(node, "_fields")
                else type(node)(items))

    return walk(specs)


def shard_friendly_config(cfg, tp: int):
    """Math-preserving config transform for a TP degree: replicate each
    GQA KV head ``tp / kvh`` times when ``tp`` is a multiple of the KV
    heads (the attention output is identical), and pad the MoE expert
    tables to a multiple of ``tp`` with dead experts (the router scores
    only the real ones)."""
    changes = {}
    kvh, h = cfg.n_kv_heads, cfg.n_heads
    if 0 < kvh < tp and tp % kvh == 0 and h % tp == 0:
        changes["n_kv_heads"] = tp
    if cfg.n_experts and cfg.n_experts % tp:
        changes["n_experts_padded"] = -(-cfg.n_experts // tp) * tp
    return dataclasses.replace(cfg, **changes) if changes else cfg
