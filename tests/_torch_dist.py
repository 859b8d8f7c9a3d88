"""Multi-process workers of the port's CPU tests of the packed gradient
wire (``tests/test_torch_pod_wire.py``), and the single-process oracle
they are held to.

This module imports no JAX, so the ranks (spawned processes, gloo over a
``FileStore``, one intra-op thread each) start fast. ``Group`` starts
``world`` ranks; each joins the group, runs the given tasks in order and
sends back what each returns (numpy arrays and Python values). A rank
that raises fails the group.
"""
import multiprocessing
import queue
import sys
import time
import traceback

import numpy as np
import torch

from repro_torch.core.formats import get_format
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train import compress
from repro_torch.train.state import init_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

LR = 1e-3


class Group:
    """``world`` ranks joined through the file ``store``, each running
    ``tasks`` (a list of (function name in this module, kwargs)) in order
    on ``device`` (several ranks may share a card: gloo stages CUDA
    tensors through the host). The ranks start at once; ``results`` waits
    for them."""

    def __init__(self, world: int, store: str, tasks, device: str = "cpu"):
        ctx = multiprocessing.get_context("spawn")
        self.q = ctx.Queue()
        self.procs = [ctx.Process(
            target=_rank_main, args=(r, world, store, tasks, self.q, device))
            for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, timeout: float = 240.0):
        """Each rank's list of its tasks' results, by rank. Fails as soon
        as a rank reports an error or exits without a result, or after
        ``timeout`` seconds."""
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < len(self.procs):
                try:
                    rank, err, out = self.q.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if r not in got and p.exitcode is not None]
                    if dead or time.monotonic() > deadline:
                        missing = dead or sorted(
                            set(range(len(self.procs))) - set(got))
                        raise AssertionError(
                            f"ranks {missing} sent no result") from None
                    continue
                if err is not None:
                    raise AssertionError(f"rank {rank} failed:\n{err}")
                got[rank] = out
        finally:
            for p in self.procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        assert all(p.exitcode == 0 for p in self.procs), \
            [p.exitcode for p in self.procs]
        return [got[r] for r in range(len(self.procs))]


def _rank_main(rank, world, store, tasks, q, device):
    torch.set_num_threads(1)
    try:
        from repro_torch.launch.mesh import make_mesh
        ctx = dict(mesh=lambda shape, axes: make_mesh(
            shape, axes, backend="gloo", devices=[device] * world,
            init_method=f"file://{store}", rank=rank, world_size=world))
        out = [globals()[name](ctx, **kw) for name, kw in tasks]
        q.put((rank, None, out))
    except BaseException:
        q.put((rank, traceback.format_exc(), None))
        sys.exit(1)


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy()
                    if isinstance(t, torch.Tensor) else t, tree)


def _tensors(tree):
    return tree_map(lambda a: torch.tensor(a) if isinstance(a, np.ndarray)
                    else a, tree)


# ---------------------------------------------------------------------------
# the wire alone
# ---------------------------------------------------------------------------

def wire_tree(pod: int):
    """Pod ``pod``'s seeded gradient tree: a padded last axis (200 = 6
    blocks + 8), whole blocks with a zero block, a 1-D leaf of exactly
    ``_MIN_COMPRESS`` values, a stacked leaf, and a leaf under 4096
    values with negative zeros."""
    rng = np.random.default_rng(100 + pod)
    tree = {"pad": rng.standard_normal((64, 200)) * 1e-3,
            "whole": rng.standard_normal((40, 256)),
            "vec": rng.standard_normal((4096,)) * 1e-5,
            "stack": rng.standard_normal((3, 50, 96)),
            "small": rng.standard_normal((10, 100))}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    tree["whole"][0, :32] = 0.0
    tree["small"][0, :4] = -0.0
    return tree


def wire(ctx, n_pods):
    """This rank's pod tree through ``make_pod_grad_fn`` over a
    ('pod',) mesh: (mode, the loss, the averaged tree)."""
    mesh = ctx["mesh"]((n_pods,), ("pod",))
    pod = mesh.coord["pod"]
    grads = tree_map(lambda t: t.to(mesh.device), _tensors(wire_tree(pod)))
    fn, mode = compress.make_pod_grad_fn(
        lambda params, batch: (torch.tensor(float(pod + 1)), grads), mesh)
    loss, out = fn(None, {"tokens": torch.zeros((n_pods, 1))})
    assert all(out[k] is grads[k] for k in grads)      # in place
    return mode, float(loss), _np(out)


def ctx(ctx):
    """``constrain_act`` on a 2-rank ('pod', 'data') mesh: a plain tensor
    passes as it is; a replicated DTensor comes back ``Shard(0)`` over
    the context's axes where they divide its batch, else as it was.
    Returns (the plain tensor's identity, the placements, local shapes)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.sharding import activation_sharding, constrain_act
    mesh = ctx["mesh"]((2, 1), ("pod", "data"))
    x = torch.arange(24.0).reshape(4, 6)
    d = distribute_tensor(x, mesh.device_mesh, [Replicate(), Replicate()])
    odd = distribute_tensor(x[:3], mesh.device_mesh,
                            [Replicate(), Replicate()])
    with activation_sharding(("pod", "data"), 2):
        same = constrain_act(x) is x
        got, kept = constrain_act(d), constrain_act(odd)
    outside = constrain_act(d)
    return (same, [str(p) for p in got.placements],
            tuple(got.to_local().shape), got.to_local().numpy().copy(),
            [str(p) for p in kept.placements], outside is d)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def step(ctx, shape, axes, cfg, params, batches, n_micro, grad_compress):
    """The train step on a mesh of ``shape`` over ``axes``: the first
    batch's (loss, gradients) through ``info["grad_fn"]``, then a step a
    batch. Returns (mode, loss, grads, the steps' losses, the final
    parameters)."""
    from repro_torch.convert import params_from_jax
    mesh = ctx["mesh"](shape, axes)
    params = params_from_jax(params, device="cpu", train=True)
    opt = AdamW(lr=cosine_schedule(LR, 1, 10))
    train_step, info = make_train_step(cfg, opt, n_microbatches=n_micro,
                                       mesh=mesh, grad_compress=grad_compress)
    loss, grads = info["grad_fn"](params, _tensors(batches[0]))
    state = init_state(params, opt)
    losses = []
    for b in batches:
        state, m = train_step(state, b)
        losses.append(float(m["loss"]))
    return (info["compress_mode"], float(loss), _np(tree_leaves(grads)),
            losses, _np(tree_leaves(state.params)))


def pod_rows(batch, pod: int, n_pods: int):
    b = batch["tokens"].shape[0] // n_pods
    return {k: v[pod * b:(pod + 1) * b] for k, v in batch.items()}


def pod_mean(pod_grads, fmt_name="nxfp8"):
    """The wire's arithmetic on one process: each pod's leaves cast
    (``_leaf_roundtrip``) and every pod's wire decoded in pod order into
    the mean (``_decode_mean``); leaves under ``_MIN_COMPRESS`` values
    averaged as they are."""
    fmt = get_format(fmt_name)
    out = []
    for leaves in zip(*(tree_leaves(g) for g in pod_grads)):
        acc = torch.empty_like(leaves[0])
        if acc.numel() < compress._MIN_COMPRESS:
            acc.zero_()
            for x in leaves:
                acc += x
            acc /= len(leaves)
        else:
            wires = [compress._leaf_roundtrip(x, fmt) for x in leaves]
            compress._decode_mean([w for w, _, _ in wires],
                                  [m for _, m, _ in wires], wires[0][2], acc,
                                  fmt)
        out.append(acc)
    return out


def oracle_steps(cfg, params, batches, n_pods, n_micro, opt=None,
                 state=None):
    """The pod wire's train steps on one process: each pod's rows in turn
    through the single-device accumulation, the wire's arithmetic
    (``pod_mean``), the mean loss, AdamW. Returns (the first batch's
    (loss, gradients), the steps' losses, the final state)."""
    opt = opt or AdamW(lr=cosine_schedule(LR, 1, 10))
    state = state or init_state(params, opt)
    _, info = make_train_step(cfg, opt, n_microbatches=n_micro)
    first, losses = None, []
    for b in batches:
        b = _tensors(b)
        pods = [info["grad_fn"](state.params, pod_rows(b, p, n_pods))
                for p in range(n_pods)]
        grads = pod_mean([g for _, g in pods])
        total = torch.zeros(())
        for loss, _ in pods:
            total += loss
        loss = total / n_pods
        if first is None:
            first = (float(loss), [g.clone() for g in grads])
        new_params, new_opt, _ = opt.update(
            tree_unflatten(state.params, grads), state.opt, state.params)
        state = type(state)(new_params, new_opt, state.step + 1)
        losses.append(float(loss))
    return first, losses, state


# ---------------------------------------------------------------------------
# train_loop on a mesh, checkpoints, resume
# ---------------------------------------------------------------------------

def loop(ctx, shape, axes, cfg, steps, ckpt_dir, **kw):
    """``train_loop(mesh=)`` with checkpoints in ``ckpt_dir``: (the losses
    of the steps it ran, how many saves this rank made, its final
    parameters)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import train_loop
    mesh = ctx["mesh"](shape, axes)
    saves = []
    real = CheckpointManager.save

    def spy(self, tree, step, block=False):
        saves.append(step)
        return real(self, tree, step, block)

    CheckpointManager.save = spy
    try:
        state, losses = train_loop(cfg, steps=steps, ckpt_dir=ckpt_dir,
                                   mesh=mesh, log_every=100, **kw)
    finally:
        CheckpointManager.save = real
    return losses, saves, _np(tree_leaves(state.params))
