"""Trees of the port: nested dicts, lists and tuples (NamedTuples such as
``TrainState`` included) whose leaves are tensors, QTensors or anything
else that is not a container. What ``jax.tree`` does for the reference's
optimizer and checkpoints, for the port's layouts (a list of per-layer
dicts)."""
from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> List[Any]:
    """The leaves in a fixed order: dict values in insertion order, list
    and tuple items in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if _is_namedtuple(tree) \
            else type(tree)(items)
    return fn(tree, *rest)


def tree_unflatten(template, leaves: List[Any]):
    """``template``'s structure with ``leaves`` in ``tree_leaves``'s
    order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, it) is not it:
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{len(tree_leaves(template))}")
    return out


def tree_structure(tree) -> str:
    """The structure as a string, each leaf a ``*``: two trees with the
    same string take each other's leaves."""
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k!r}:{tree_structure(v)}"
                              for k, v in tree.items()) + "}"
    if isinstance(tree, (list, tuple)):
        name = type(tree).__name__
        return f"{name}(" + ",".join(tree_structure(v) for v in tree) + ")"
    return "*"
