"""Training in the torch port (``forward_train``, ``loss_fn``, AdamW, the
train step with its simulated NxFP8 gradient cast, the data pipeline,
checkpoints and ``train_loop``), on the CPU at smoke size, against the
reference (``src/repro/``).

* ``loss_fn`` and every gradient leaf, one smoke config a family and
  H2O-Danube3 (T 48 over its 32-token window), from the reference's f32
  init (``params_from_jax(train=True)``): the loss within ``LOSS_TOL``,
  each leaf within ``GRAD_TOL`` of its norm (the reference's
  ``test_train_step_shapes_and_finite`` holds only finiteness; here the
  two differ by bf16 activations summed in another order, where one
  bf16 ulp is 2^-8 of a value).
* AdamW's update, ``global_norm`` and ``cosine_schedule`` within f32
  rounding (``OPT_RTOL``: torch's and XLA's ``pow`` and ``cos`` may part
  in the last bit), the NaN-skip exactly.
* ``simulate_compress``, the data batches: bitwise.
* Checkpoints: a round trip, an incomplete one refused, keep-k.
* ``train_loop`` (5 steps, 2 microbatches) against the reference's losses;
  the train step with ``grad_compress="nxfp8"`` against the reference's.
* Bitwise: remat on against off, the forward with grad on against off,
  ``forward_train``'s last row against ``prefill``'s logits, a resumed
  ``train_loop`` against the uninterrupted one.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.formats import get_format as jget_format
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import TextCorpus as JTextCorpus
from repro.data import make_data_iter as jmake_data_iter
from repro.launch.train import train_loop as jtrain_loop
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jcosine_schedule
from repro.optim.adamw import global_norm as jglobal_norm
from repro.train import compress as jcompress
from repro.train.state import init_state as jinit_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.formats import get_format
from repro_torch.core.qtensor import QTensor, QuantPolicy, dense_like
from repro_torch.data import SyntheticLM, TextCorpus, make_data_iter
from repro_torch.launch.train import train_loop
from repro_torch.models import forward_train, init_params, loss_fn, prefill
from repro_torch.optim import AdamW, cosine_schedule, global_norm
from repro_torch.serving import ServeEngine
from repro_torch.serving.engine import load_params
from repro_torch.train import compress, init_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

ARCHS = ("llama3_8b", "qwen2_moe_a2_7b", "falcon_mamba_7b", "hymba_1_5b",
         "llama_3_2_vision_90b", "whisper_tiny", "h2o_danube_3_4b")
LOSS_TOL = 5e-4      # absolute, on losses near ln(256) = 5.5
GRAD_TOL = 3e-2      # |g - g_ref| / |g_ref| of a leaf (norms)
OPT_RTOL = 1e-6
LR = 1e-3            # the peak learning rate of the one-step comparison


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, b=2, t=24, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _grads(cfg, params, batch):
    """(loss, grads in tree_leaves order) of the port's ``loss_fn``."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, _ = loss_fn(cfg, tree_unflatten(params, live), _torch_batch(batch))
    return loss.detach(), torch.autograd.grad(loss, live)


@functools.lru_cache(maxsize=None)
def _reference(arch: str, t: int = 24):
    """The reference's f32 init, a batch, its loss and gradients."""
    jcfg = jget_smoke_config(arch)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg, t=t)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jcfg, p, b), has_aux=True))(jp, jb)
    return _np_tree(jp), batch, float(loss), _np_tree(grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    t = 48 if arch == "h2o_danube_3_4b" else 24
    jp, batch, jloss, jgrads = _reference(arch, t)
    cfg = get_smoke_config(arch)
    params = params_from_jax(jp, device="cpu", train=True)
    assert params["tok_embed"].dtype == torch.float32
    loss, grads = _grads(cfg, params, batch)
    assert abs(float(loss) - jloss) <= LOSS_TOL, (float(loss), jloss)
    want = tree_leaves(params_from_jax(jgrads, device="cpu", train=True))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        err = float((g - w).norm() / w.norm().clamp(min=1e-30))
        assert err <= GRAD_TOL, err


def _smoke_llama():
    cfg = get_smoke_config("llama3_8b")
    jp, batch, _, _ = _reference("llama3_8b")
    return cfg, params_from_jax(jp, device="cpu", train=True), batch


def test_remat_and_grad_mode_bitwise():
    """Remat on and off give the same gradients, bit for bit; the forward's
    values with grad on are those with grad off; ``forward_train``'s last
    row is ``prefill``'s logits (on the CPU every row is its own product,
    so the bits hold across the head's row counts)."""
    for arch in ("llama3_8b", "falcon_mamba_7b"):
        cfg = get_smoke_config(arch)
        params = params_from_jax(_reference(arch)[0], device="cpu",
                                 train=True)
        batch = _reference(arch)[1]
        l_on, g_on = _grads(cfg, params, batch)
        l_off, g_off = _grads(dataclasses.replace(cfg, remat=False), params,
                              batch)
        assert torch.equal(l_on, l_off)
        assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))
        tb = _torch_batch(batch)
        with torch.no_grad():
            lg_nograd, _ = forward_train(cfg, params, tb)
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        lg_grad, _ = forward_train(cfg, live, tb)
        assert torch.equal(lg_grad.detach(), lg_nograd)
        last, _ = prefill(cfg, params, tb, max_len=32, kv_fmt=None)
        assert torch.equal(lg_nograd[:, -1], last)


def test_kv_sim_and_cast_trees_under_loss_fn():
    """``loss_fn`` over a ``kv_sim_fmt`` model runs without grad and raises
    with it; over a cast tree it is ``loss_fn`` over its ``dense_like``
    (on the CPU the plain dequant GEMM multiplies the bf16 decode of each
    row's weights, as the dense product does)."""
    cfg, params, batch = _smoke_llama()
    tb = _torch_batch(batch)
    sim = dataclasses.replace(cfg, kv_sim_fmt="nxfp4")
    with torch.no_grad():
        base = loss_fn(cfg, params, tb)[0]
        got = loss_fn(sim, params, tb)[0]
    assert torch.isfinite(got) and not torch.equal(got, base)
    with pytest.raises(NotImplementedError, match="kv_sim_fmt"):
        _grads(sim, params, batch)
    cast = load_params(params, QuantPolicy("nxfp4", None), "cpu")
    assert any(isinstance(x, QTensor) for x in tree_leaves(cast))
    with torch.no_grad():
        lc = loss_fn(cfg, cast, tb)[0]
        ld = loss_fn(cfg, dense_like(cast), tb)[0]
    assert torch.equal(lc, ld)


def test_training_tree():
    """``init_params(train=True)`` keeps tok_embed and lm_head in f32,
    the same draws the serving tree stores in bf16."""
    cfg = get_smoke_config("llama3_8b")
    serve = init_params(cfg, 3, device="cpu")
    train = init_params(cfg, 3, device="cpu", train=True)
    for name in ("tok_embed", "lm_head"):
        assert train[name].dtype == torch.float32
        assert torch.equal(train[name].to(torch.bfloat16), serve[name])
    for a, b in zip(tree_leaves(serve["layers"]),
                    tree_leaves(train["layers"])):
        assert torch.equal(a, b)


def _opt_trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 24), "b": (24,), "stack": (3, 8, 8)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 10 ** (i - 2)
              for k, s in shapes.items()} for i in range(4)]
    return params, grads


def _close(a, b, rtol=OPT_RTOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


def test_adamw_matches_reference():
    """Four updates (the clip active in the last two) of the same
    gradients; ``global_norm``; the schedule at steps 0-60; the
    NaN-skip leaves params, moments and the step as they were."""
    params, grads = _opt_trees()
    jopt = JAdamW(lr=jcosine_schedule(1e-2, 2, 50))
    opt = AdamW(lr=cosine_schedule(1e-2, 2, 50))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = opt.init(tp)
    for g in grads:
        jp, js, jstats = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                     js, jp)
        tp, ts, stats = opt.update({k: torch.tensor(v) for k, v in g.items()},
                                   ts, tp)
        _close(stats["grad_norm"], jstats["grad_norm"])
        _close(stats["lr"], jstats["lr"])
        for k in params:
            _close(tp[k], jp[k])
            _close(ts.mu[k], js.mu[k])
            _close(ts.nu[k], js.nu[k])
    assert int(ts.step) == int(js.step) == 4
    for s in (0, 1, 2, 3, 25, 50, 60):
        _close(cosine_schedule(1e-2, 2, 50)(torch.tensor(s)),
               jcosine_schedule(1e-2, 2, 50)(jnp.asarray(s)))
    _close(global_norm({k: torch.tensor(v) for k, v in grads[2].items()}),
           jglobal_norm({k: jnp.asarray(v) for k, v in grads[2].items()}))
    before = {k: v.clone() for k, v in tp.items()}
    mu = {k: v.clone() for k, v in ts.mu.items()}
    bad = {k: torch.tensor(v) for k, v in grads[0].items()}
    bad["b"][3] = float("nan")
    tp, ts2, stats = opt.update(bad, ts, tp)
    assert float(stats["skipped"]) == 1.0 and int(ts2.step) == 4
    assert all(torch.equal(tp[k], before[k]) and torch.equal(ts2.mu[k], mu[k])
               for k in params)


def test_simulate_compress_bitwise():
    """NxFP8 cast -> decode of seeded leaves bitwise the reference's: a
    padded last axis (200 = 6 blocks + 8), whole blocks, a 1-D leaf of exactly ``_MIN_COMPRESS`` values, a stacked leaf, and a
    leaf under 4096 values passed through; the wire bytes too."""
    rng = np.random.default_rng(7)
    tree = {"pad": rng.standard_normal((64, 200)) * 1e-3,
            "whole": rng.standard_normal((40, 256)),
            "vec": rng.standard_normal((4096,)) * 1e-5,
            "stack": rng.standard_normal((3, 50, 96)),
            "small": rng.standard_normal((10, 100))}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    tree["whole"][0, :32] = 0.0
    want = jax.jit(functools.partial(jcompress.simulate_compress,
                                     fmt_name="nxfp8"))(
        {k: jnp.asarray(v) for k, v in tree.items()})
    got = compress.simulate_compress(
        {k: torch.tensor(v) for k, v in tree.items()}, "nxfp8")
    for k in tree:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert np.array_equal(got["small"].numpy(), tree["small"])
    wire, meta, n = compress._leaf_roundtrip(torch.tensor(tree["pad"]),
                                             get_format("nxfp8"))
    jwire, jmeta, jn = jcompress._leaf_roundtrip(jnp.asarray(tree["pad"]),
                                                 jget_format("nxfp8"))
    assert n == jn and np.array_equal(wire.numpy(), np.asarray(jwire))
    assert np.array_equal(meta.numpy(), np.asarray(jmeta))
    inplace = {k: torch.tensor(v) for k, v in tree.items()}
    ptr = inplace["stack"].data_ptr()
    out = compress.simulate_compress(inplace, "nxfp8", inplace=True)
    assert out["stack"].data_ptr() == ptr
    assert out["small"] is inplace["small"]
    want = compress.simulate_compress(
        {k: torch.tensor(v) for k, v in tree.items()}, "nxfp8")
    assert all(torch.equal(out[k], want[k]) for k in tree)


def test_data_iterator_bitwise(tmp_path):
    """SyntheticLM (two vocab sizes), host sharding and ``extras_fn``, and
    TextCorpus: every batch bitwise the reference's."""
    def extras(rng, b):
        return {"frames": rng.standard_normal((b, 3)).astype(np.float32)}

    for vocab, hosts in ((128, 1), (5000, 2)):
        for host in range(hosts):
            kw = dict(seed=5, host_id=host, n_hosts=hosts, extras_fn=extras)
            a = make_data_iter(SyntheticLM(vocab=vocab, seed=1), 8, 48, **kw)
            b = jmake_data_iter(JSyntheticLM(vocab=vocab, seed=1), 8, 48, **kw)
            for _ in range(3):
                x, y = next(a), next(b)
                assert x.keys() == y.keys()
                assert all(np.array_equal(x[k], y[k]) for k in x)
                assert x["tokens"].dtype == np.int32
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(range(256)) * 20)
    a = make_data_iter(TextCorpus(str(path)), 4, 32, seed=2)
    b = jmake_data_iter(JTextCorpus(str(path)), 4, 32, seed=2)
    for _ in range(2):
        assert np.array_equal(next(a)["tokens"], next(b)["tokens"])


def test_checkpoint_round_trip_refusal_and_keep(tmp_path):
    """A TrainState over a tree with bf16, f32, int and QTensor leaves
    comes back bit for bit; a directory without its COMPLETE marker is
    neither listed nor loaded; another structure is refused; keep-k keeps
    the newest k of async saves."""
    cfg, params, _ = _smoke_llama()
    params["tok_embed"] = params["tok_embed"].to(torch.bfloat16)
    cast = load_params(params, QuantPolicy("nxfp4", None), "cpu")
    tree = {"train": init_state(params, AdamW(lr=cosine_schedule(1e-3, 1,
                                                                 5))),
            "cast": cast, "ids": torch.arange(5, dtype=torch.int32),
            "np": np.arange(3.0)}
    save_pytree(tree, tmp_path / "ck")
    back = load_pytree(tree, tmp_path / "ck")
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        if isinstance(a, QTensor):
            assert isinstance(b, QTensor) and b.fmt_name == a.fmt_name
            assert (b.shape, b.axis, b.orig_len) == (a.shape, a.axis,
                                                     a.orig_len)
            assert torch.equal(a.packed, b.packed)
            assert a.meta.dtype == b.meta.dtype
            assert torch.equal(a.meta.to(torch.int32), b.meta.to(torch.int32))
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert np.array_equal(a, b)
    assert type(back["train"]).__name__ == "TrainState"
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert len(manifest["leaves"]) == len(tree_leaves(tree))
    with pytest.raises(ValueError, match="structure"):
        load_pytree({"other": tree["ids"]}, tmp_path / "ck")

    mgr = CheckpointManager(tmp_path / "run", keep=2)
    small = {"x": torch.zeros(4)}
    for step in range(1, 6):
        small["x"].fill_(step)          # in place: the save took a copy
        mgr.save(small, step)
    mgr.close()
    assert mgr.steps() == [4, 5]
    got, step = mgr.restore(small)
    assert step == 5 and torch.equal(got["x"], torch.full((4,), 5.0))
    assert torch.equal(mgr.restore(small, 4)[0]["x"], torch.full((4,), 4.0))
    (tmp_path / "run" / "step_00000009").mkdir()       # no COMPLETE marker
    assert mgr.latest_step() == 5
    with pytest.raises(FileNotFoundError, match="incomplete"):
        load_pytree(small, tmp_path / "run" / "step_00000009")


def test_train_loop_matches_reference():
    """5 steps of the smoke Llama, 2 microbatches, from the reference's
    init: each step's loss within ``LOSS_TOL`` of the reference
    ``train_loop``'s. Then one step with ``grad_compress="nxfp8"``
    against the reference's ``make_train_step``: the loss and the new
    params."""
    cfg, params, _ = _smoke_llama()
    jcfg = jget_smoke_config("llama3_8b")
    kw = dict(steps=5, batch=4, seq=32, n_micro=2, log_every=100)
    _, jlosses = jtrain_loop(jcfg, **kw)
    _, losses = train_loop(cfg, params=params, device="cpu", **kw)
    np.testing.assert_allclose(losses, jlosses, atol=LOSS_TOL, rtol=0)

    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    batch = next(jmake_data_iter(JSyntheticLM(vocab=jcfg.vocab), 4, 32))
    jopt = JAdamW(lr=jcosine_schedule(LR, 1, 10))
    jstep, jinfo = jmake_train_step(jcfg, jopt, n_microbatches=2,
                                    grad_compress="nxfp8")
    jstate, jm = jax.jit(jstep)(jinit_state(jp, jopt),
                                {"tokens": jnp.asarray(batch["tokens"])})
    opt = AdamW(lr=cosine_schedule(LR, 1, 10))
    step, info = make_train_step(cfg, opt, n_microbatches=2,
                                 grad_compress="nxfp8", time_parts=True)
    assert info["compress_mode"] == jinfo["compress_mode"] == "simulated"
    state, m = step(init_state(params_from_jax(_np_tree(jp), device="cpu",
                                               train=True), opt), batch)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert set(m["ms"]) == {"fwd_bwd", "cast", "opt"}
    got = tree_leaves(state.params)
    want = tree_leaves(params_from_jax(_np_tree(jstate.params), device="cpu",
                                       train=True))
    # AdamW's first step moves a weight by about LR whatever its
    # gradient's size: one near 0 may take the other sign's update (or
    # none) here, so a few weights may part by up to 2 LR
    assert not any(a.requires_grad for a in got)
    d = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(got, want)])
    assert float(d.max()) <= 2 * LR
    assert float((d > 1e-6).float().mean()) <= 0.01


class _CrashAfter:
    """A data source that raises on its ``n``-th draw (a crash between
    steps)."""

    def __init__(self, source, n):
        self.source, self.left = source, n

    def sample(self, *args):
        if self.left == 0:
            raise RuntimeError("crash")
        self.left -= 1
        return self.source.sample(*args)


def test_resume_bitwise(tmp_path):
    """A run that crashes after step 4's checkpoint, resumed from it,
    ends bitwise the uninterrupted run (params, moments, the losses of the
    steps it ran again); the engines serve the trained tree."""
    cfg, params, _ = _smoke_llama()
    kw = dict(steps=6, batch=4, seq=32, n_micro=2, log_every=100,
              grad_compress="nxfp8", device="cpu", ckpt_every=2)
    src = SyntheticLM(vocab=cfg.vocab)

    def clone():
        return tree_map(lambda t: t.clone(), params)

    whole, losses = train_loop(cfg, params=clone(), source=src, **kw)
    with pytest.raises(RuntimeError, match="crash"):
        train_loop(cfg, params=clone(), source=_CrashAfter(src, 5),
                   ckpt_dir=tmp_path, **kw)
    assert CheckpointManager(tmp_path).steps() == [2, 4]
    resumed, tail = train_loop(cfg, params=clone(), source=src,
                               ckpt_dir=tmp_path, **kw)
    assert tail == losses[4:]
    assert int(resumed.step) == int(whole.step) == 6
    for a, b in zip(tree_leaves(resumed), tree_leaves(whole)):
        assert torch.equal(a, b)
    eng = ServeEngine(cfg, resumed.params, QuantPolicy("nxfp4", "nxfp4"),
                      max_len=24, device="cpu")
    out = eng.generate({"tokens": np.zeros((1, 8), np.int32)}, max_new=4,
                       loop="host")
    assert out.tokens.shape == (1, 4)
