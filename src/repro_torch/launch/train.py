"""Training launcher: data -> train_step -> checkpoint/restore loop (the
reference's ``launch/train.py``), on one device or on a mesh of
processes (one a rank).

Fault tolerance in the loop itself:
  - resume from the latest complete checkpoint on start (elastic: a
    checkpoint holds logical arrays, so the pod and data-parallel degrees
    may differ from the run that wrote it);
  - periodic async checkpoints (atomic rename, keep-k), written by rank 0
    alone on a mesh;
  - NaN/Inf steps are skipped inside the optimizer (grad-norm guard);
  - straggler watchdog: a step whose wall time lies 4 standard deviations
    above the last 50 is logged;
  - deterministic data: step k's batch is a pure function of (seed, host,
    k), so a restart replays the same batches, and every rank of a mesh
    draws the same global batch.

Usage (CUDA by default; ``--device cpu`` runs the plain PyTorch path):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
      --smoke --steps 300 --batch 32 --seq 256 [--device cpu]
On a mesh, one process a rank (here two pods of one card, both ranks on
it, the packed NxFP8 gradient wire between them over gloo):
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --arch llama3_8b \\
      --layers 2 --steps 3 --batch 4 --seq 256 --n-micro 2 \\
      --grad-compress nxfp8 --mesh pod=2,data=1,model=1 --backend gloo
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
from .mesh import make_mesh


def train_loop(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
               n_micro: int = 1, ckpt_dir=None, ckpt_every: int = 100,
               seed: int = 0, log_every: int = 10, extras_fn=None,
               eval_fn=None, source=None, grad_compress=None, device=None,
               params=None, history=None, time_parts: bool = False,
               ckpt_keep: int = 3, mesh=None):
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
    a crash keeps every checkpoint it had started.

    ``mesh`` (``launch.mesh.make_mesh``) trains on a mesh of processes,
    each rank on ``mesh.device`` (``device`` must name no other): every
    rank draws the same global batch and takes its rows of it
    (``make_train_step(mesh=)``). Only rank 0 writes checkpoints, and the
    last one before any rank returns (a barrier); every rank restores."""
    dev = resolve_device(device) if mesh is None else mesh.device
    if mesh is not None and device is not None and (
            resolve_device(device).type != dev.type):
        raise ValueError(f"device {device} on a mesh of {dev}")
    writer = mesh is None or mesh.rank == 0
    optimizer = AdamW(lr=cosine_schedule(lr, max(steps // 20, 10), steps))
    if params is None:
        params = init_params(cfg, seed, device=dev, train=True)
    state = init_state(params, optimizer)
    train_step, _ = make_train_step(cfg, optimizer, n_microbatches=n_micro,
                                    mesh=mesh, grad_compress=grad_compress,
                                    time_parts=time_parts)

    mgr = (CheckpointManager(ckpt_dir, keep=ckpt_keep, async_save=writer)
           if ckpt_dir else None)
    start = 0
    if mgr and mgr.latest_step() is not None:
        state, start = mgr.restore(state)
        if writer:
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
            if writer and (step % log_every == 0 or step == steps - 1):
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{b['tokens'].size / dt:.0f} tok/s")
            if mgr and writer and (step + 1) % ckpt_every == 0:
                mgr.save(state, step + 1)
            if eval_fn is not None and (step + 1) % (log_every * 10) == 0:
                eval_fn(state.params, step + 1)
    finally:
        if mgr:
            mgr.close()  # drain the async queue first
    if mgr and writer and steps not in mgr.steps():
        mgr.save(state, steps, block=True)
    if mgr and mesh is not None:
        mesh.barrier()
    return state, losses


def _mesh_shape(spec: str):
    """'pod=2,data=1,model=1' -> ((2, 1, 1), ('pod', 'data', 'model'))."""
    pairs = [kv.split("=") for kv in spec.split(",")]
    return tuple(int(v) for _, v in pairs), tuple(k for k, _ in pairs)


def _report(path, mesh, state, losses, history):
    """This rank's run in ``path``/rank<r>.json: the losses, each step's
    figures, the kernels' launch counts, peak memory and each final
    parameter leaf's ``tensor_fold`` (two runs with the same weights give
    the same folds)."""
    import torch
    from ..core.pack import tensor_fold
    from ..kernels import launch_counts
    from ..tree import tree_leaves
    rank = 0 if mesh is None else mesh.rank
    dev = tree_leaves(state.params)[0].device
    out = dict(rank=rank, losses=losses, history=history,
               launches=launch_counts(),
               peak=(torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else None),
               folds=[tensor_fold(p) for p in tree_leaves(state.params)])
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers "
                         "(its width kept)")
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
    ap.add_argument("--mesh", default=None,
                    help="train on a mesh of processes, one a rank (under "
                         "torchrun), e.g. pod=2,data=1,model=1")
    ap.add_argument("--backend", default=None,
                    help="the mesh's process-group backend: gloo or nccl")
    ap.add_argument("--report", default=None,
                    help="write each rank's losses, step figures, launch "
                         "counts, peak memory and parameter folds to "
                         "REPORT/rank<r>.json")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mesh = None
    if args.mesh is not None:
        if args.backend is None:
            ap.error("--mesh needs --backend (gloo or nccl)")
        mesh = make_mesh(*_mesh_shape(args.mesh), backend=args.backend,
                         device=args.device)
    if mesh is None or mesh.rank == 0:
        print(f"[train] {cfg.name}: ~{cfg.param_count() / 1e6:.1f}M params")
    history = [] if args.report else None
    state, losses = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        n_micro=args.n_micro, ckpt_dir=args.ckpt_dir,
        grad_compress=args.grad_compress, device=args.device, mesh=mesh,
        history=history, time_parts=bool(args.report))
    if args.report:
        _report(args.report, mesh, state, losses, history)
    if mesh is not None:
        mesh.close()


if __name__ == "__main__":
    main()
