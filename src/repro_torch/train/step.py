"""Train / prefill / decode steps on one device (the reference's
``train/step.py`` without a mesh).

train_step: microbatch gradient accumulation in f32, per-layer remat
(``cfg.remat``), the optional NxFP gradient cast (``simulate_compress``,
the reference's ``"simulated"`` mode), AdamW with its NaN-skip. The
prefill and decode steps serve direct-cast weights and KV.
"""
from __future__ import annotations

import time
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
from .compress import simulate_compress
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


def _on_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


class _Clock:
    """Milliseconds between marks: CUDA events on the card, the host's
    clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        if not self.cuda:
            return (b - a) * 1e3
        b.synchronize()
        return a.elapsed_time(b)


def make_train_step(cfg: ModelConfig, optimizer: AdamW,
                    n_microbatches: int = 1,
                    grad_compress: Optional[str] = None,
                    time_parts: bool = False):
    """Returns (train_step(state, batch) -> (state, metrics), info dict).

    ``batch`` holds numpy arrays or tensors (moved to the parameters'
    device). The step writes the new parameters and moments into
    ``state``'s tensors (``AdamW.update``) and returns them in a new
    ``TrainState``; ``state.params`` stays detached, so the engines serve
    it as it is. ``time_parts`` adds ``ms`` to the metrics: the forward
    and backward (all microbatches), the gradient cast and the optimizer,
    each timed by CUDA events on the card."""
    info = {"compress_mode": "simulated" if grad_compress else "off"}

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        if any(isinstance(p, QTensor) for p in leaves):
            raise ValueError("a direct-cast tree is served, not trained: "
                             "train the f32 weights")
        live = [p.detach().requires_grad_() for p in leaves]
        loss, _ = loss_fn(cfg, tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
        return loss.detach(), tree_unflatten(params, list(grads))

    def accumulate(params, batch):
        if n_microbatches == 1:
            return grad_fn(params, batch)
        micro = _split_micro(batch, n_microbatches)
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=GRAD_ACCUM_DTYPE,
                                              device=p.device), params)
        lsum = None
        for i in range(n_microbatches):
            loss, grads = grad_fn(params, {k: v[i] for k, v in micro.items()})
            for a, g in zip(tree_leaves(gacc), tree_leaves(grads)):
                a.add_(g.to(GRAD_ACCUM_DTYPE))
            del grads
            lsum = loss if lsum is None else lsum + loss
        inv = 1.0 / n_microbatches
        for a in tree_leaves(gacc):
            a.mul_(inv)
        return lsum * inv, gacc

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        dev = tree_leaves(state.params)[0].device
        clock = _Clock(dev)
        batch = _on_device(batch, dev)
        t0 = clock.mark()
        loss, grads = accumulate(state.params, batch)
        t1 = clock.mark()
        if grad_compress:
            grads = simulate_compress(grads, grad_compress, inplace=True)
        t2 = clock.mark()
        new_params, new_opt, stats = optimizer.update(
            grads, state.opt, state.params)
        del grads
        t3 = clock.mark()
        metrics = {"loss": loss, **stats}
        if time_parts:
            metrics["ms"] = {"fwd_bwd": clock.ms(t0, t1),
                             "cast": clock.ms(t1, t2),
                             "opt": clock.ms(t2, t3)}
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
