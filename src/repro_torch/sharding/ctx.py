"""Activation-sharding context: the data-parallel layout of the residual
stream (the reference's ``sharding/ctx.py``).

The reference pins (B, ...) activations to batch-data sharding, so that
GSPMD gathers FSDP-sharded weights instead of all-reducing activations.
In the port a plain tensor is a rank's own rows already and passes
through; a ``DTensor`` is redistributed to ``Shard(0)`` over the
data-parallel mesh dimensions. The context is set around the step (the
packed gradient wire's body narrows it to 'data'); model code calls
``constrain_act`` on the residual stream.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

_ACT: contextvars.ContextVar[Optional[Tuple[tuple, int]]] = \
    contextvars.ContextVar("activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(dp_axes: tuple, dp_size: int):
    """dp_axes e.g. ('pod', 'data') or ('data',); dp_size their product."""
    tok = _ACT.set((dp_axes, dp_size))
    try:
        yield
    finally:
        _ACT.reset(tok)


def constrain_act(x):
    """(B, ...) activations batch-sharded over the data-parallel axes when
    the context is set and ``x`` is a DTensor whose B they divide; any
    other ``x`` as it is."""
    ctx = _ACT.get()
    if ctx is None or getattr(x, "ndim", 0) < 2:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dp_axes, dp_size = ctx
    if x.shape[0] % dp_size != 0:
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, [Shard(0) if name in dp_axes else Replicate()
                                 for name in mesh.mesh_dim_names])
