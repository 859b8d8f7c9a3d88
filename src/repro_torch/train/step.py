"""Train / prefill / decode steps (the reference's ``train/step.py``).

train_step: microbatch gradient accumulation in f32, per-layer remat
(``cfg.remat``), the optional NxFP gradient cast, AdamW with its
NaN-skip. On a mesh of processes (``launch.mesh.make_mesh``) the step
takes the global batch, as the reference's jitted step does, and each
rank computes the gradients of its rows: with ``grad_compress`` and a
'pod' axis, pod p's rows go through the packed wire over the pod group
(``compress.make_pod_grad_fn``, "shard_map"), and within a pod the
'data' ranks split the rows and sum their shares over the data group;
without the wire every data-parallel rank ('pod' and 'data') splits the
whole batch so. Either way a rank's share of a microbatch's loss is its
targets over the microbatch's (the mask's counts where there is one), so
the summed gradients are the gradients of the rows' whole loss, as GSPMD
computes them (but the MoE load-balance term, which is not a sum over
rows: each rank's own term, weighted by its share, stands in for it).
Without a mesh (or on a mesh without a
'pod' axis) ``grad_compress`` casts the gradients on the device
(``simulate_compress``, "simulated"). The prefill and decode steps serve
direct-cast weights and KV.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.qtensor import QTensor
from ..models import decode_step as model_decode
from ..models import loss_fn
from ..models import prefill as model_prefill
from ..models.common import ModelConfig
from ..optim.adamw import AdamW
from ..tree import tree_leaves, tree_map, tree_unflatten
from .compress import _Clock, make_pod_grad_fn, simulate_compress
from .state import TrainState

# dtype of the microbatch gradient accumulator
GRAD_ACCUM_DTYPE = torch.float32


def _split_micro(batch: Dict[str, Any], n: int):
    """(B, ...) -> (n, B/n, ...): microbatch i holds rows [i B/n, (i+1)
    B/n)."""
    def r(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             "microbatches")
        return x.reshape(n, b // n, *x.shape[1:])
    return {k: r(v) for k, v in batch.items()}


def _targets(batch) -> float:
    """The targets a batch's loss averages over (its mask's count)."""
    mask = batch.get("mask")
    if mask is None:
        t = batch["tokens"]
        return float(t.shape[0] * (t.shape[1] - 1))
    return float(mask[:, 1:].sum())


def _rank_rows(mb: Dict[str, Any], rank: int, size: int):
    """This data-parallel rank's rows of microbatch ``mb`` and its share of
    the microbatch's loss. The rows split over the ranks where they divide
    (the reference's sharding constraint); else every rank holds them all
    and takes 1/size of the loss."""
    b = mb["tokens"].shape[0]
    if b % size:
        return mb, 1.0 / size
    m = b // size
    mine = {k: v[rank * m:(rank + 1) * m] for k, v in mb.items()}
    return mine, _targets(mine) / max(_targets(mb), 1.0)


def _on_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, optimizer: AdamW,
                    n_microbatches: int = 1, mesh=None,
                    grad_compress: Optional[str] = None,
                    time_parts: bool = False):
    """Returns (train_step(state, batch) -> (state, metrics), info dict).

    ``batch`` holds numpy arrays or tensors (moved to the parameters'
    device); on a ``mesh`` it is the global batch, the same on every
    rank, and every rank ends the step with the same parameters. A mesh
    whose 'model' axis is larger than 1 raises NotImplementedError. The
    step writes the new parameters and moments into ``state``'s tensors
    (``AdamW.update``) and returns them in a new ``TrainState``;
    ``state.params`` stays detached, so the engines serve it as it is.

    ``info`` holds ``compress_mode`` ("off", "simulated", "shard_map")
    and ``grad_fn(params, batch) -> (loss, grads)``, what the step
    updates with (the accumulation, and the wire where there is one).
    ``time_parts`` adds ``ms`` to the metrics: the forward and backward
    (all microbatches), the gradient cast (on the wire: ``cast``,
    ``gather`` and ``decode``) and the optimizer, timed by CUDA events
    on the card."""
    compressed = bool(grad_compress and mesh is not None
                      and "pod" in mesh.axis_names)
    dp = None
    if mesh is not None:
        if mesh.shape.get("model", 1) > 1:
            raise NotImplementedError(
                "a 'model' axis > 1 places the parameters by "
                "sharding.params_specs, which the train step does not do "
                "yet (ROADMAP A6)")
        axes = tuple(a for a in (("data",) if compressed
                                 else ("pod", "data")) if a in mesh.shape)
        size = math.prod(mesh.shape[a] for a in axes)
        if size > 1:
            rank = 0
            for a in axes:
                rank = rank * mesh.shape[a] + mesh.coord[a]
            dp = (rank, size, mesh.group(axes))

    def grad_fn(params, batch, share=None):
        leaves = tree_leaves(params)
        if any(isinstance(p, QTensor) for p in leaves):
            raise ValueError("a direct-cast tree is served, not trained: "
                             "train the f32 weights")
        live = [p.detach().requires_grad_() for p in leaves]
        loss, _ = loss_fn(cfg, tree_unflatten(params, live), batch)
        if share is not None:
            loss = loss * share
        grads = torch.autograd.grad(loss, live)
        return loss.detach(), tree_unflatten(params, list(grads))

    def accumulate(params, batch):
        if n_microbatches == 1 and dp is None:
            return grad_fn(params, batch)
        micro = _split_micro(batch, n_microbatches)
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=GRAD_ACCUM_DTYPE,
                                              device=p.device), params)
        lsum = None
        for i in range(n_microbatches):
            mb = {k: v[i] for k, v in micro.items()}
            share = None
            if dp is not None:
                mb, share = _rank_rows(mb, dp[0], dp[1])
            loss, grads = grad_fn(params, mb, share)
            for a, g in zip(tree_leaves(gacc), tree_leaves(grads)):
                a.add_(g.to(GRAD_ACCUM_DTYPE))
            del grads
            lsum = loss if lsum is None else lsum + loss
        if dp is not None:
            import torch.distributed as dist
            lsum = lsum.reshape(1)
            for a in tree_leaves(gacc) + [lsum]:
                dist.all_reduce(a, group=dp[2])
            lsum = lsum[0]
        inv = 1.0 / n_microbatches
        for a in tree_leaves(gacc):
            a.mul_(inv)
        return lsum * inv, gacc

    parts = {} if time_parts else None
    if compressed:
        acc_fn, mode = make_pod_grad_fn(accumulate, mesh, grad_compress,
                                        parts=parts)
    else:
        acc_fn, mode = accumulate, ("simulated" if grad_compress else "off")
    info = {"compress_mode": mode, "grad_fn": acc_fn}

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        dev = tree_leaves(state.params)[0].device
        clock = _Clock(dev)
        batch = _on_device(batch, dev)
        t0 = clock.mark()
        loss, grads = acc_fn(state.params, batch)
        t1 = clock.mark()
        if mode == "simulated":
            grads = simulate_compress(grads, grad_compress, inplace=True)
        t2 = clock.mark()
        new_params, new_opt, stats = optimizer.update(
            grads, state.opt, state.params)
        del grads
        t3 = clock.mark()
        metrics = {"loss": loss, **stats}
        if time_parts:
            metrics["ms"] = (dict(parts) if compressed else
                             {"fwd_bwd": clock.ms(t0, t1),
                              "cast": clock.ms(t1, t2)})
            metrics["ms"]["opt"] = clock.ms(t2, t3)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step, info


def make_prefill_step(cfg: ModelConfig, max_len: int,
                      kv_fmt: Optional[str]):
    def prefill_step(params, batch):
        return model_prefill(cfg, params, batch, max_len=max_len,
                             kv_fmt=kv_fmt)
    return prefill_step


def make_decode_step(cfg: ModelConfig, kv_fmt: Optional[str]):
    def decode_step(params, tokens, cache):
        return model_decode(cfg, params, tokens, cache, kv_fmt=kv_fmt)
    return decode_step
