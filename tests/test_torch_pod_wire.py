"""The packed NxFP8 gradient wire in the torch port (``make_pod_grad_fn``
over a mesh's 'pod' group, the train step's ``mesh=``, ``train_loop
(mesh=)``) and the sharding rules, on the CPU, against the reference.

* The rules (``sharding/rules.py``) entry by entry against the
  reference's on fake meshes: ``test_sharding.py``'s cases, and
  ``params_specs`` on every config at full size (f32 and nxfp4-cast,
  two meshes, FSDP off and on; the port's per-layer leaf's spec is the
  reference's stacked leaf's with the layer axes dropped), ``batch_specs``
  and ``cache_specs`` on smoke caches, ``to_shardings``' placements.
* The wire alone at P 2 and P 4: ranks are spawned processes (gloo over
  a ``FileStore``, ``tests/_torch_dist.py``), each with a seeded pod
  tree; every rank's result bitwise the reference's body composed on the
  CPU (``_leaf_roundtrip``, ``_leaf_decode`` per pod, ``jnp.mean`` over
  the stack: its partial-auto ``shard_map`` does not lower on the CPU).
* The step at pod 2 (smoke Llama and Qwen-MoE, 2 steps, 2 microbatches):
  bitwise the port's single-process oracle (``_torch_dist.oracle_steps``),
  the first gradients within ``GRAD_TOL`` of the reference's composition
  and the loss within ``LOSS_TOL``; pod 1 x data 2 with a mask of unequal
  counts within ``DATA_TOL`` of the single-process whole-batch gradients;
  a 'model' axis of 2 refused.
* ``train_loop(mesh=)`` on 2 ranks with checkpoints (only rank 0 writes),
  resumed on a 1-rank mesh, bitwise the oracle from the checkpoint.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.formats import get_format as jget_format
from repro.core.qtensor import QTensor as JQTensor
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.core.qtensor import direct_cast_tree as jdirect_cast_tree
from repro.core.quantize import to_blocks as jto_blocks
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.sharding import batch_specs as jbatch_specs
from repro.sharding import cache_specs as jcache_specs
from repro.sharding import fit_spec as jfit_spec
from repro.sharding import params_specs as jparams_specs
from repro.sharding import shard_friendly_config as jshard_friendly_config
from repro.sharding.rules import _apply_fsdp as j_apply_fsdp
from repro.sharding.rules import _dense_spec as j_dense_spec
from repro.sharding.rules import _qtensor_specs as j_qtensor_specs
from repro.train import compress as jcompress
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QTensor, QuantPolicy
from repro_torch.data import SyntheticLM, make_data_iter
from repro_torch.models import init_cache, init_params
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.sharding import (P, batch_specs, cache_specs, fit_spec,
                                  params_specs, shard_friendly_config,
                                  to_shardings)
from repro_torch.sharding.rules import _apply_fsdp, _dense_spec, _qtensor_specs
from repro_torch.train.state import init_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves

import _torch_dist
import _torch_helpers  # noqa: F401  (one intra-op thread a process)

LOSS_TOL = 5e-4      # tests/test_torch_train.py's
GRAD_TOL = 3e-2      # |g - g_ref| / |g_ref| of a leaf (test_torch_train.py)
DATA_TOL = 1e-2      # |g - g_whole| / |g_whole|: bf16 backward a rank
#                      (measured ~2.3e-3 on the smoke Llama)
STEP_ARCHS = ("llama3_8b", "qwen2_moe_a2_7b")


class FakeMesh:
    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


# ---------------------------------------------------------------------------
# (1) the rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,ndim", [
    ("layers/wq", 3), ("layers/wo", 3), ("layers/experts_w1", 4),
    ("layers/ln1_scale", 2), ("tok_embed", 2), ("layers/router", 3),
    ("lm_head", 2), ("enc_layers/wk", 3), ("layers/ssm_conv_b", 2),
    ("layers/ssm_a_log", 3), ("layers/mlp_w2", 3), ("self_layers/wv", 4),
    ("layers/unknown", 2)])
def test_dense_spec_matches_reference(name, ndim):
    assert _dense_spec(name, ndim) == tuple(j_dense_spec(name, ndim))
    assert isinstance(_dense_spec(name, ndim), P)


@pytest.mark.parametrize("shape,spec,mesh", [
    ((32, 25), (None, "model"), {"data": 16, "model": 16}),
    ((32, 1600), (None, "model"), {"data": 16, "model": 16}),
    ((8,), (("pod", "data"),), {"pod": 2, "data": 16}),
    ((64, 8), (("pod", "data"), "model"), {"pod": 2, "data": 16,
                                           "model": 8}),
    ((4, 4, 4), (), {"data": 2})])
def test_fit_spec_matches_reference(shape, spec, mesh):
    from jax.sharding import PartitionSpec as JP
    got = fit_spec(shape, P(*spec), FakeMesh(**mesh))
    assert got == tuple(jfit_spec(shape, JP(*spec), FakeMesh(**mesh)))


def test_qtensor_spec_derivation_matches_reference():
    from jax.sharding import PartitionSpec as JP
    for shapes, spec, axis in (
            (((4, 128, 8, 16), (4, 128, 8)), (None, "data", "model"), -2),
            (((128, 8, 16), (128, 8)), ("data", "model"), -1),
            (((6, 64, 128, 2, 16), (6, 64, 128, 2)), ("model",), -3)):
        got = _qtensor_specs(shapes, P(*spec), axis)
        want = j_qtensor_specs(shapes, JP(*spec), axis)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


def test_apply_fsdp_matches_reference():
    from jax.sharding import PartitionSpec as JP
    for shape, spec, mesh in (
            ((126, 16384), (None, None), {"data": 16, "model": 16}),
            ((16384,), (None,), {"data": 16, "model": 16}),
            ((4096, 14336), (None, "model"), {"data": 16, "model": 16}),
            ((100, 30), (None, None), {"data": 16}),
            ((2048, 2048), (None, None), {"model": 4}),
            ((25, 1 << 20), (None, "model"), {"data": 5, "model": 2})):
        m = FakeMesh(**mesh)
        assert _apply_fsdp(shape, P(*spec), m) == \
            tuple(j_apply_fsdp(shape, JP(*spec), m))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_friendly_config_matches_reference(arch):
    for tp in (1, 2, 4, 8, 16, 32):
        got = shard_friendly_config(get_config(arch), tp)
        want = jshard_friendly_config(jget_config(arch), tp)
        assert (got.n_kv_heads, got.n_experts, got.n_experts_padded) == \
            (want.n_kv_heads, want.n_experts, want.n_experts_padded)


def _jabstract_qtensor(leaf, fmt, axis):
    """The reference's cast of an abstract leaf, its shapes only: the
    blocked layout of ``to_blocks`` (what ``QTensor.quantize`` packs)."""
    fmt = jget_format(fmt)
    axis = axis if axis < 0 else axis - leaf.ndim
    xb = jax.eval_shape(lambda x: jto_blocks(x, fmt.block_size, axis)[0],
                        leaf)
    lead = xb.shape[:-1]
    return JQTensor(jax.ShapeDtypeStruct(lead + (fmt.bytes_per_block,),
                                         jnp.uint8),
                    jax.ShapeDtypeStruct(lead, jnp.uint16), fmt.name,
                    tuple(leaf.shape), axis, leaf.shape[axis])


def _stacks(cfg, n):
    """(reference group, stacked axes) of each port layer."""
    if cfg.family != "vlm":
        return [("layers", 1)] * n
    every = cfg.cross_attn_every
    return [("cross_layers", 1) if i % every == every - 1
            else ("self_layers", 2) for i in range(n)]


def _same_spec(got, want, k, where):
    if isinstance(want, JQTensor):
        assert isinstance(got, QTensor), where
        assert got.packed == tuple(want.packed)[k:], where
        assert got.meta == tuple(want.meta)[k:], where
    else:
        assert not isinstance(got, QTensor), where
        assert got == tuple(want)[k:], where


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_specs_match_reference(arch):
    """Every leaf at full size, f32 and nxfp4-cast, on both meshes, FSDP
    off and on: the port's leaf spec is the reference's stacked leaf's
    with its layer axes dropped; the same leaves are cast."""
    cfg = get_config(arch)
    jp = jax.eval_shape(lambda: jinit_params(jget_config(arch),
                                             jax.random.PRNGKey(0)))
    trees = {
        "f32": (init_params(cfg, device="meta", train=True), jp),
        "nxfp4": (init_params(cfg, device="meta",
                              policy=QuantPolicy("nxfp4", "nxfp4")),
                  jdirect_cast_tree(jp, JQuantPolicy(),
                                    quantize_fn=_jabstract_qtensor))}
    for kind, (tp, jt) in trees.items():
        for mesh in MESHES:
            m = FakeMesh(**mesh)
            for fsdp in (False, True):
                got = params_specs(cfg, tp, m, fsdp=fsdp)
                want = jparams_specs(jget_config(arch), jt, m, fsdp=fsdp)
                where = (kind, mesh, fsdp)
                for name in got:
                    if name in ("layers", "enc_layers"):
                        continue
                    _same_spec(got[name], want[name], 0, where + (name,))
                if "enc_layers" in got:
                    for i, layer in enumerate(got["enc_layers"]):
                        for k, s in layer.items():
                            _same_spec(s, want["enc_layers"][k], 1,
                                       where + (i, k))
                for i, (layer, (group, k)) in enumerate(zip(
                        got["layers"], _stacks(cfg, len(got["layers"])))):
                    assert set(layer) == set(want[group]), (i, where)
                    for name, s in layer.items():
                        _same_spec(s, want[group][name], k,
                                   where + (i, name))


def test_batch_and_cache_specs_match_reference():
    """``batch_specs`` on a batch with a mask, a scalar and an odd batch;
    ``cache_specs`` on smoke caches (packed and dense KV, SSM state), each
    layer's spec the reference's stacked spec without its layer axis."""
    meshes = ({"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2},
              {"data": 4}, {"pod": 4, "data": 3, "model": 4})
    batch = {"tokens": np.zeros((4, 32), np.int32),
             "mask": np.ones((4, 32), np.float32),
             "step": np.zeros((), np.int32),
             "frames": np.zeros((6, 5, 8), np.float32)}
    for mesh in meshes:
        m = FakeMesh(**mesh)
        got = batch_specs(m, batch)
        want = jbatch_specs(m, batch)
        assert {k: v for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
    for arch in ("llama3_8b", "hymba_1_5b", "falcon_mamba_7b"):
        for kv in ("nxfp4", None):
            cache = init_cache(get_smoke_config(arch), 4, 64, kv,
                               device="cpu")
            jcache = jax.eval_shape(lambda: jinit_cache(
                jget_smoke_config(arch), 4, 64, kv))
            for mesh in meshes:
                m = FakeMesh(**mesh)
                got, want = cache_specs(m, cache), jcache_specs(m, jcache)
                assert got["pos"] == tuple(want["pos"])
                for layer in got["layers"]:
                    assert set(layer) == set(want["layers"])
                    for name, s in layer.items():
                        assert s == tuple(want["layers"][name])[1:], \
                            (arch, kv, mesh, name)


def test_to_shardings_placements():
    """A tuple axis becomes a ``Shard`` on each of its mesh axes; a QTensor
    of specs, a NamedTuple and a list keep their structure."""
    from torch.distributed.tensor import Replicate, Shard
    m = FakeMesh(pod=2, data=4, model=2)
    got = to_shardings(m, {
        "w": P(("pod", "data"), "model"), "b": P(),
        "q": QTensor(P("model", "data", None), P("model", "data"), "nxfp4",
                     (8, 8), -2, 8),
        "l": [P(None, "data")]})
    assert got["w"] == (Shard(0), Shard(0), Shard(1))
    assert got["b"] == (Replicate(), Replicate(), Replicate())
    assert got["q"].packed == (Replicate(), Shard(1), Shard(0))
    assert got["q"].meta == (Replicate(), Shard(1), Shard(0))
    assert got["l"] == [(Replicate(), Shard(1), Replicate())]


# ---------------------------------------------------------------------------
# (2) the wire alone
# ---------------------------------------------------------------------------

@jax.jit
def _jdecoded(tree):
    """A pod's tree as the reference's body makes it cross: each leaf of
    at least ``_MIN_COMPRESS`` values cast (``_leaf_roundtrip``) and
    decoded (``_leaf_decode``), the rest as it is."""
    fmt = jget_format("nxfp8")
    return jax.tree.map(
        lambda x: x if x.size < jcompress._MIN_COMPRESS else
        jcompress._leaf_decode(*jcompress._leaf_roundtrip(x, fmt), x.shape,
                               jnp.float32, fmt), tree)


@jax.jit
def _jmean(stacked):
    return jax.tree.map(lambda s: jnp.mean(s, axis=0), stacked)


def _jwire(pod_trees):
    """The reference's body, composed: every pod's tree through
    ``_jdecoded``, stacked in pod order as its ``all_gather`` stacks them,
    then ``jnp.mean`` over the stack (on an array the reduction cannot
    see through, as on the gather's output)."""
    decoded = [_jdecoded(t) for t in pod_trees]
    return _jmean(jax.tree.map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *decoded))


def _pair_tasks(tmp):
    """The two-rank group's tasks: the wire at P 2, the pod-2 steps,
    ``train_loop`` with a checkpoint a step, pod 1 x data 2, the
    activation context."""
    cases = _step_cases()
    tasks = [("wire", dict(n_pods=2))]
    for arch in STEP_ARCHS:
        cfg, params, batches = cases[arch]
        tasks.append(("step", dict(
            shape=(2, 1, 1), axes=AXES, cfg=cfg, params=params,
            batches=batches, n_micro=2, grad_compress="nxfp8")))
    tasks.append(("loop", dict(LOOP, shape=(2, 1, 1), steps=2)))
    cfg, params, batches = _data_case()
    tasks.append(("step", dict(shape=(1, 2, 1), axes=AXES, cfg=cfg,
                               params=params, batches=batches, n_micro=2,
                               grad_compress=None)))
    tasks.append(("ctx", {}))
    return tasks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-rank run of this file and what it is held to, the
    latter computed here while the ranks run: two ranks (``_pair_tasks``)
    and four (the wire at P 4) at once, then one rank resuming from the
    two ranks' checkpoint. Returns (the ranks' results by group, the
    expected values, the checkpoint's state)."""
    tmp = tmp_path_factory.mktemp("pod_wire")
    LOOP["ckpt_dir"] = str(tmp / "ckpt")
    pair = _torch_dist.Group(2, str(tmp / "store2"), _pair_tasks(tmp))
    quad = _torch_dist.Group(4, str(tmp / "store4"),
                             [("wire", dict(n_pods=4))])
    want = {("wire", n): _jwire([{k: jnp.asarray(v) for k, v in
                                  _torch_dist.wire_tree(p).items()}
                                 for p in range(n)]) for n in (2, 4)}
    for arch, (cfg, jp, batches) in _step_cases().items():
        want[arch] = (_torch_dist.oracle_steps(
            cfg, params_from_jax(jp, device="cpu", train=True), batches, 2,
            2), _jpod_grads(arch, batches[0]))
    cfg, jp, batches = _data_case()
    _, info = make_train_step(cfg, AdamW(lr=cosine_schedule(1e-3, 1, 10)),
                              n_microbatches=2)
    want["data"] = info["grad_fn"](
        params_from_jax(jp, device="cpu", train=True),
        {k: torch.tensor(v) for k, v in batches[0].items()})
    got = {"pair": pair.results(), "quad": quad.results()}
    # the checkpoint of step 2, and the oracle's steps 3 and 4 from it
    cfg = LOOP["cfg"]
    opt = AdamW(lr=cosine_schedule(3e-4, 10, 4))
    template = init_state(init_params(cfg, 0, device="cpu", train=True), opt)
    mgr = CheckpointManager(tmp / "ckpt", async_save=False)
    ckpt = (mgr.steps(),) + mgr.restore(template)
    one = _torch_dist.Group(1, str(tmp / "store1"),
                            [("loop", dict(LOOP, shape=(1, 1, 1), steps=4))])
    it = make_data_iter(SyntheticLM(vocab=cfg.vocab, seed=0), 4, 16, seed=0)
    batches = [next(it) for _ in range(4)][2:]
    state = init_state(init_params(cfg, 0, device="cpu", train=True), opt)
    state, _ = mgr.restore(state)
    want["resume"] = _torch_dist.oracle_steps(cfg, None, batches, 1, 2,
                                              opt=opt, state=state)
    got["resume"] = one.results()
    return got, want, ckpt


AXES = ("pod", "data", "model")
# train_loop on a mesh: the smoke Llama, a checkpoint a step
LOOP = dict(axes=AXES, cfg=get_smoke_config("llama3_8b"), batch=4, seq=16,
            n_micro=2, grad_compress="nxfp8", ckpt_every=1)


def _assert_ranks_equal(ranks, i):
    flat = [tree_leaves(r[i]) for r in ranks]
    for other in flat[1:]:
        assert len(other) == len(flat[0])
        for a, b in zip(flat[0], other):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(
                    a.view(np.uint8), b.view(np.uint8))
            else:
                assert a == b


def _bitwise(a, b):
    """f32 arrays (or tensors) equal bit for bit."""
    a, b = (np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in (a, b))
    return a.dtype == b.dtype and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


@pytest.mark.parametrize("n_pods", [2, 4])
def test_wire_bitwise_reference(runs, n_pods):
    """Every rank bitwise equal and bitwise the reference's body; the loss
    the mean over pods."""
    got, want, _ = runs
    ranks = got["pair" if n_pods == 2 else "quad"]
    _assert_ranks_equal(ranks, 0)
    mode, loss, tree = ranks[0][0]
    assert mode == "shard_map"
    assert loss == sum(range(1, n_pods + 1)) / n_pods
    for k, w in want[("wire", n_pods)].items():
        assert _bitwise(tree[k], w), k
    # the small leaf's negative zeros averaged as jnp.mean does (+0)
    assert not np.signbit(tree["small"][0, :4]).any()


def test_single_pod_and_refused_backends():
    """A mesh without a 'pod' axis returns the gradient function itself; a
    backend outside the wire's list raises (no simulated fallback)."""
    from repro_torch.train.compress import make_pod_grad_fn

    def fn(params, batch):
        return None

    assert make_pod_grad_fn(fn, FakeMesh(data=2)) == (fn, "single_pod")
    mesh = FakeMesh(pod=2, data=1)
    mesh.backend = "mpi"
    with pytest.raises(NotImplementedError, match="gloo"):
        make_pod_grad_fn(fn, mesh)


# ---------------------------------------------------------------------------
# (3) the train step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _step_cases():
    """arch -> (port config, the reference's f32 init as numpy, 2 global
    batches of 4 x 24)."""
    out = {}
    for arch in STEP_ARCHS:
        jcfg = jget_smoke_config(arch)
        jp = jax.tree.map(np.asarray, jinit_params(jcfg,
                                                   jax.random.PRNGKey(0)))
        it = make_data_iter(SyntheticLM(vocab=jcfg.vocab, seed=3), 4, 24,
                            seed=3)
        out[arch] = (get_smoke_config(arch), jp, [next(it), next(it)])
    return out


@functools.lru_cache(maxsize=None)
def _data_case():
    """The smoke Llama and 2 batches of 4 x 24 whose masks keep 23, 5, 17
    and 11 targets of the rows."""
    cfg, jp, batches = _step_cases()["llama3_8b"]
    masks = np.zeros((4, 24), np.float32)
    for row, n in enumerate((24, 6, 18, 12)):
        masks[row, :n] = 1.0
    return cfg, jp, [dict(b, mask=masks) for b in batches]


def _jpod_grads(arch, batch, n_pods=2, n_micro=2):
    """The reference's composition of the first step's wire: each pod's
    rows in microbatches through ``value_and_grad(loss_fn)`` (summed in
    f32, times 1/n), then ``_jwire``; the loss the mean over pods."""
    jcfg = jget_smoke_config(arch)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    vg = jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(jcfg, p, b)[0]))
    pods, losses = [], []
    rows = batch["tokens"].shape[0] // n_pods
    m = rows // n_micro
    for p in range(n_pods):
        gsum, lsum = None, 0.0
        for i in range(n_micro):
            lo = p * rows + i * m
            loss, g = vg(jp, {"tokens": jnp.asarray(
                batch["tokens"][lo:lo + m])})
            gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
            lsum = lsum + loss
        pods.append(jax.tree.map(lambda x: x * (1.0 / n_micro), gsum))
        losses.append(float(lsum) / n_micro)
    return float(np.mean(losses)), jax.tree.map(np.asarray, _jwire(pods))


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_pod_step_matches_oracle_and_reference(runs, arch):
    """Both ranks bitwise equal; each bitwise the single-process oracle
    (the first gradients, both steps' losses, the final weights); the
    first gradients within ``GRAD_TOL`` of the reference's composition
    and the loss within ``LOSS_TOL``."""
    got, want, _ = runs
    i = 1 + STEP_ARCHS.index(arch)
    ranks = got["pair"]
    _assert_ranks_equal(ranks, i)
    mode, loss, grads, losses, final = ranks[0][i]
    assert mode == "shard_map"
    ((oloss, ograds), olosses, ostate), (jloss, jgrads) = want[arch]
    assert loss == oloss and losses == olosses
    assert len(grads) == len(ograds)
    assert all(_bitwise(a, b) for a, b in zip(grads, ograds))
    assert all(_bitwise(a, b)
               for a, b in zip(final, tree_leaves(ostate.params)))
    assert abs(loss - jloss) <= LOSS_TOL, (loss, jloss)
    ref = tree_leaves(params_from_jax(jgrads, device="cpu", train=True))
    assert len(ref) == len(grads)
    for g, w in zip(grads, ref):
        err = float(np.linalg.norm(g - w.numpy())
                    / max(float(w.norm()), 1e-30))
        assert err <= GRAD_TOL, err


def test_data_axis_matches_whole_batch(runs):
    """pod 1 x data 2, no wire, masks of unequal counts: each rank's rows
    weighted by their targets, summed over the data group: the first
    gradients within ``DATA_TOL`` of the single-process whole-batch step's
    and the loss within 1e-6; the ranks bitwise equal after 2 steps."""
    got, want, _ = runs
    ranks = got["pair"]
    i = 2 + len(STEP_ARCHS)
    _assert_ranks_equal(ranks, i)
    mode, loss, grads, _, _ = ranks[0][i]
    assert mode == "off"
    wloss, wgrads = want["data"]
    assert abs(loss - float(wloss)) <= 1e-6
    for g, w in zip(grads, tree_leaves(wgrads)):
        err = float(np.linalg.norm(g - w.numpy())
                    / max(float(w.norm()), 1e-30))
        assert err <= DATA_TOL, err


def test_model_axis_refused():
    cfg = get_smoke_config("llama3_8b")
    opt = AdamW(lr=cosine_schedule(1e-3, 1, 10))
    with pytest.raises(NotImplementedError, match="params_specs"):
        make_train_step(cfg, opt, mesh=FakeMesh(pod=1, data=1, model=2),
                        grad_compress="nxfp8")


# ---------------------------------------------------------------------------
# (4) train_loop on a mesh: checkpoints by rank 0, resumed on one rank
# ---------------------------------------------------------------------------

def test_train_loop_checkpoint_resume(runs):
    """Two ranks run 2 steps with a checkpoint a step: only rank 0 saves,
    both end bitwise equal and the last checkpoint holds their weights. A
    1-rank mesh resumes from it to step 4: its losses and weights bitwise
    the single-process oracle's from the same checkpoint."""
    got, want, (steps, state, step) = runs
    i = 1 + len(STEP_ARCHS)
    ranks = got["pair"]
    _assert_ranks_equal([[r[i][0], r[i][2]] for r in ranks], 0)
    (_, saves0, final0), (_, saves1, _) = ranks[0][i], ranks[1][i]
    assert saves0 == [1, 2] and saves1 == []
    assert steps == [1, 2] and step == 2
    assert all(_bitwise(a, b)
               for a, b in zip(final0, tree_leaves(state.params)))
    (losses, saves, final), = got["resume"][0]
    _, olosses, ostate = want["resume"]
    assert saves == [3, 4] and losses == olosses
    assert all(_bitwise(a, b)
               for a, b in zip(final, tree_leaves(ostate.params)))


# ---------------------------------------------------------------------------
# the activation context
# ---------------------------------------------------------------------------

def test_constrain_act_on_dtensors(runs):
    """Each rank: a plain tensor passes through; a replicated DTensor
    becomes ``Shard(0)`` over the data-parallel axes (the rank's rows of
    it); one whose batch the axes do not divide, or outside the context,
    stays as it was."""
    from torch.distributed.tensor import Replicate, Shard
    got, _, _ = runs
    x = np.arange(24.0, dtype=np.float32).reshape(4, 6)
    for rank, r in enumerate(got["pair"]):
        same, placements, shape, local, kept, outside = r[-1]
        assert same and outside
        assert placements == [str(Shard(0))] * 2      # 'pod' and 'data'
        assert shape == (2, 6)
        assert np.array_equal(local, x[2 * rank:2 * rank + 2])
        assert kept == [str(Replicate())] * 2
