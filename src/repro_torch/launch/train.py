"""Training launcher: data -> train_step -> checkpoint/restore loop (the
reference's ``launch/train.py``) on one device.

Fault tolerance in the loop itself:
  - resume from the latest complete checkpoint on start;
  - periodic async checkpoints (atomic rename, keep-k);
  - NaN/Inf steps are skipped inside the optimizer (grad-norm guard);
  - straggler watchdog: a step whose wall time lies 4 standard deviations
    above the last 50 is logged;
  - deterministic data: step k's batch is a pure function of (seed, host,
    k), so a restart replays the same batches.

Usage (CUDA by default; ``--device cpu`` runs the plain PyTorch path):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
      --smoke --steps 300 --batch 32 --seq 256 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import SyntheticLM, make_data_iter
from ..models import init_params
from ..optim.adamw import AdamW, cosine_schedule
from ..train.state import init_state
from ..train.step import make_train_step


def train_loop(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
               n_micro: int = 1, ckpt_dir=None, ckpt_every: int = 100,
               seed: int = 0, log_every: int = 10, extras_fn=None,
               eval_fn=None, source=None, grad_compress=None, device=None,
               params=None, history=None, time_parts: bool = False,
               ckpt_keep: int = 3):
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens
    with AdamW under a warmup-cosine schedule. Returns (state, losses of
    the steps this call ran).

    ``params`` starts from given weights (f32 leaves on the device,
    trained in place), else ``init_params(cfg, seed, device,
    train=True)``.
    ``grad_compress`` names the format of the gradient cast (None: off).
    ``history`` (a list) receives each step's figures: loss, gradient
    norm, learning rate, the data draw's and the step's wall ms, tok/s
    and, with ``time_parts``, the step's parts (``make_train_step``).
    With ``ckpt_dir`` the run resumes from its latest checkpoint and
    saves every ``ckpt_every`` steps and at the end, keeping the newest
    ``ckpt_keep``; a run that raises drains its pending saves first, so
    a crash keeps every checkpoint it had started."""
    dev = resolve_device(device)
    optimizer = AdamW(lr=cosine_schedule(lr, max(steps // 20, 10), steps))
    if params is None:
        params = init_params(cfg, seed, device=dev, train=True)
    state = init_state(params, optimizer)
    train_step, _ = make_train_step(cfg, optimizer, n_microbatches=n_micro,
                                    grad_compress=grad_compress,
                                    time_parts=time_parts)

    mgr = CheckpointManager(ckpt_dir, keep=ckpt_keep) if ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        state, start = mgr.restore(state)
        print(f"[train] resumed from step {start}")

    source = source or SyntheticLM(vocab=cfg.vocab, seed=seed)
    it = make_data_iter(source, batch, seq, seed=seed, extras_fn=extras_fn)
    for _ in range(start):
        next(it)  # deterministic replay position

    losses, times = [], []
    try:
        for step in range(start, steps):
            t_data = time.perf_counter()
            b = next(it)
            t0 = time.perf_counter()
            state, metrics = train_step(state, b)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            times.append(dt)
            if history is not None:
                history.append(dict(
                    step=step, loss=loss,
                    grad_norm=float(metrics["grad_norm"]),
                    lr=float(metrics["lr"]), data_ms=(t0 - t_data) * 1e3,
                    step_ms=dt * 1e3, tok_s=b["tokens"].size / dt,
                    **({"ms": metrics["ms"]} if "ms" in metrics else {})))
            if len(times) > 10:
                mu, sd = np.mean(times[-50:]), np.std(times[-50:]) + 1e-9
                if (dt - mu) / sd > 4:
                    print(f"[watchdog] step {step} straggled: {dt:.2f}s "
                          f"(mean {mu:.2f}s)")
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{b['tokens'].size / dt:.0f} tok/s")
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save(state, step + 1)
            if eval_fn is not None and (step + 1) % (log_every * 10) == 0:
                eval_fn(state.params, step + 1)
    finally:
        if mgr:
            mgr.close()  # drain the async queue first
    if mgr and steps not in mgr.steps():
        mgr.save(state, steps, block=True)
    return state, losses


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compress", default=None,
                    help="cast the gradients to this format, e.g. nxfp8")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"[train] {cfg.name}: ~{cfg.param_count() / 1e6:.1f}M params")
    train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               lr=args.lr, n_micro=args.n_micro, ckpt_dir=args.ckpt_dir,
               grad_compress=args.grad_compress, device=args.device)


if __name__ == "__main__":
    main()
