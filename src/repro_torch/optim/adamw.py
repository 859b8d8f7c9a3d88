"""AdamW and a warmup-cosine schedule (the reference's ``optim/adamw.py``).

The update math is the reference's, in f32, leaf by leaf; moments may be
kept in bf16 (``moment_dtype``). Unlike the reference, whose jitted step
donates its state, ``update`` writes the new parameters and moments into
the tensors it is given (in row chunks, so a 525M-value leaf never has
more than a chunk of f32 temporaries) and returns them: the step's
memory is the state's, once. The step counter, the learning rate and the
bias corrections are 0-dim f32 tensors on the host, read by the device
ops as scalars.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from ..tree import tree_leaves, tree_map

# elements of a leaf updated at once
CHUNK = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-dim int32 on the host: updates taken
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.float32

    def init(self, params) -> AdamWState:
        def z(p):
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)
        return AdamWState(torch.zeros((), dtype=torch.int32),
                          tree_map(z, params), tree_map(z, params))

    def update(self, grads, state: AdamWState, params):
        """One step: clip by the global norm, then AdamW with decoupled
        weight decay. A step whose gradient norm is not finite changes
        nothing (the step counter included) and reports ``skipped`` 1.
        Writes ``params`` and the moments in place. Returns (params, new
        state, stats {grad_norm, lr, skipped})."""
        gnorm = global_norm(grads)
        ok = bool(torch.isfinite(gnorm))
        step = state.step + 1
        lr = self.lr(step)
        stats = {"grad_norm": gnorm, "lr": lr,
                 "skipped": torch.tensor(0.0 if ok else 1.0)}
        if not ok:
            return params, state, stats
        f32 = torch.float32
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        t = step.to(f32)
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, dtype=f32), t)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, dtype=f32), t)
        b1, b2 = torch.tensor(self.b1, dtype=f32), torch.tensor(self.b2,
                                                                 dtype=f32)
        one_b1 = torch.tensor(1 - self.b1, dtype=f32)
        one_b2 = torch.tensor(1 - self.b2, dtype=f32)
        eps = torch.tensor(self.eps, dtype=f32)
        wd = torch.tensor(self.weight_decay, dtype=f32)

        def upd(p, g, m, n):
            g = g.to(f32) * scale
            m32 = b1 * m.to(f32) + one_b1 * g
            n32 = b2 * n.to(f32) + one_b2 * g * g
            u = (m32 / c1) / (torch.sqrt(n32 / c2) + eps)
            u = u + wd * p.to(f32)
            p.copy_(p.to(f32) - lr * u)
            m.copy_(m32)
            n.copy_(n32)

        for p, g, m, n in zip(*(tree_leaves(x) for x in
                                (params, grads, state.mu, state.nu))):
            # views: the writes land in the leaves (``view`` raises where
            # a leaf is not contiguous)
            flat = [p.view(-1), g.reshape(-1), m.view(-1), n.view(-1)]
            for i in range(0, flat[0].numel(), CHUNK):
                upd(*(x[i:i + CHUNK] for x in flat))
        return params, AdamWState(step, state.mu, state.nu), stats


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's f32 sum of squares,
    an f32 scalar on the leaves' device."""
    leaves = [torch.sum(torch.square(leaf.to(torch.float32)))
              for leaf in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """lr(step): linear warmup from 0 over ``warmup`` steps, then a cosine
    from ``peak`` down to ``floor_frac * peak`` at ``total``, f32."""
    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac) * 0.5
                      * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return lr
