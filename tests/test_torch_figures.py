"""The paper's figure twins (``src/repro_torch/figures/``) and the two
example twins, on the CPU, against the reference's scripts
(``benchmarks/``, ``examples/``) in the same process, from the reference's
seed-0 ``BENCH_CFG`` parameters (``params_from_jax(train=True)``):

* ``trained_model``'s loop: 5 steps of the bench model (batch 4 x 128,
  the bench loop's learning rate), each loss within
  ``test_torch_train.py``'s ``LOSS_TOL`` of the reference ``train_loop``'s.
* The table cast (``common.cast_tree``): codes and meta of every leaf
  bitwise the reference's ``direct_cast_tree`` (no ``quantize_fn``: its
  ``QTensor.quantize``) for Table 1's W4 row, bfp4 and mxfp4 at bs 8 and
  128 and a Fig. 11 recycle point.
* ``eval_ppl`` (Table 1) and ``top1_acc`` (Fig. 10) within ``PPL_RTOL``
  and ``ACC_TOL``; Fig. 3's scaled blocks and fractions exactly; Fig. 8's
  ``mse_suite`` within ``MSE_RTOL`` and ``model_weight_matrices``' names
  and shapes; Fig. 9's footprints and ``kv_bytes`` exactly; Figs. 11 and
  12's ``sweep_points`` exactly and ``_weight_mse`` within ``MSE_RTOL``.
* The example twins: the train-then-serve eval within ``PPL_RTOL`` and
  its greedy serve's tokens equal; the long-context serve's state bytes
  exactly (three families) and its greedy tokens equal (Danube), at a
  64-token context (the windowed models' 32-row rings wrap).

The ensembles' ``hash(name)`` seed is salted per process: both sides run
in this one.
"""
import dataclasses
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:      # the reference's scripts, as a package
    sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import fig3_profile as jfig3  # noqa: E402
from benchmarks import fig8_quant_error as jfig8  # noqa: E402
from benchmarks import fig9_tradeoff as jfig9  # noqa: E402
from benchmarks import fig10_accuracy as jfig10  # noqa: E402
from benchmarks import fig11_remap_sweep as jfig11  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.core.qtensor import QTensor as JQTensor  # noqa: E402
from repro.core.qtensor import QuantPolicy as JQuantPolicy  # noqa: E402
from repro.core.qtensor import dense_like as jdense_like  # noqa: E402
from repro.core.qtensor import direct_cast_tree as jdirect_cast_tree  # noqa
from repro.core.qtensor import \
    tree_footprint_bytes as jtree_footprint_bytes  # noqa: E402
from repro.kernels.ops import quantize_qtensor as jquantize_qtensor  # noqa
from repro.launch.train import train_loop as jtrain_loop  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qtensor import QTensor, dense_like  # noqa: E402
from repro_torch.core.qtensor import tree_footprint_bytes  # noqa: E402
from repro_torch.figures import common, fig3_profile, fig8_quant_error  # noqa
from repro_torch.figures import fig9_tradeoff, fig10_accuracy  # noqa: E402
from repro_torch.figures import fig11_remap_sweep, fig12_blocksize  # noqa
from repro_torch.launch.train import train_loop  # noqa: E402

import _torch_helpers  # noqa: F401,E402  (one intra-op thread a process)

LOSS_TOL = 5e-4      # absolute (test_torch_train.py's): bf16 activations
PPL_RTOL = 1e-3      # of a perplexity: the logits differ by bf16 rounding
ACC_TOL = 2e-3       # top-1 accuracy: argmax flips at near-tied logits
MSE_RTOL = 1e-5      # an MSE: the same codes, f32 sums in another order
CASTS = ["bfp4", "mxfp4", "nxfp4_nm", "nxfp4_nm_am", "nxfp4", "bfp4_bs8",
         "bfp4_bs128", "mxfp4_bs8", "mxfp4_bs128"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _bench():
    """The reference's seed-0 bench-LM params and the port's copy."""
    jp = jinit_params(jcommon.BENCH_CFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(_np(jp), device="cpu", train=True)


_JQUANTIZE = jax.jit(JQTensor.quantize, static_argnums=(1, 2))
_JDENSE_LIKE = jax.jit(jdense_like)


def _jdefault_cast(params, policy):
    """The reference's ``direct_cast_tree`` with no ``quantize_fn`` (its
    ``QTensor.quantize``), jitted per leaf (eagerly, every op of the
    encoder compiles for every new shape: ~14 s a block size)."""
    return jdirect_cast_tree(params, policy, quantize_fn=_JQUANTIZE)


@functools.lru_cache(maxsize=None)
def _jcast(fmt):
    return _jdefault_cast(_bench()[0], JQuantPolicy(weight_fmt=fmt))


@functools.lru_cache(maxsize=None)
def _cast(fmt):
    return common.cast_tree(_bench()[1], fmt, device="cpu")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_ex_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_config_and_loop_match_reference():
    """The bench model's config is the reference's, and 5 steps of its
    loop (the bench loop's settings at batch 4) from the reference's init
    give the reference ``train_loop``'s losses within ``LOSS_TOL``."""
    jcfg = jcommon.BENCH_CFG
    for f in dataclasses.fields(common.BENCH_CFG):
        if f.name != "dtype":
            assert getattr(common.BENCH_CFG, f.name) == getattr(jcfg, f.name)
    assert common.BENCH_CORPUS == jcommon.BENCH_CORPUS
    assert common.TRAIN_STEPS == jcommon.TRAIN_STEPS
    kw = dict(common.TRAIN_KW, steps=5, batch=4)
    _, jlosses = jtrain_loop(jcfg, source=jcommon.bench_source(jcfg.vocab),
                             **kw)
    params = params_from_jax(_np(_bench()[0]), device="cpu", train=True)
    _, losses = train_loop(common.BENCH_CFG, params=params, device="cpu",
                           source=common.bench_source(jcfg.vocab), **kw)
    np.testing.assert_allclose(losses, jlosses, atol=LOSS_TOL, rtol=0)


def _port_qleaves(qtree):
    """{name: (packed, meta)} of the port's cast leaves, stacked by layer."""
    out = {}
    for layer in qtree["layers"]:
        for k, leaf in layer.items():
            if isinstance(leaf, QTensor):
                p, m = out.setdefault(k, ([], []))
                p.append(leaf.packed.numpy())
                m.append(leaf.meta.numpy())
    return {k: (np.stack(p), np.stack(m)) for k, (p, m) in out.items()}


def _ref_qleaves(jtree):
    return {k: (np.asarray(leaf.packed), np.asarray(leaf.meta))
            for k, leaf in jtree["layers"].items()
            if isinstance(leaf, JQTensor)}


@pytest.mark.parametrize("fmt", CASTS + ["mxfp4_cr@2.500"])
def test_table_cast_is_the_reference_default_cast(fmt):
    """``cast_tree`` (the table-driven encoder, the reference's
    ``QTensor.quantize``) against the reference's ``direct_cast_tree``
    with no ``quantize_fn``: the same leaves cast, every code and meta
    word bitwise."""
    if "@" in fmt:
        fmt = jfig11._fmt_with_recycle("mxfp4", 2.5)
        assert fig11_remap_sweep._fmt_with_recycle("mxfp4", 2.5).name \
            == fmt.name
        got = common.cast_tree(_bench()[1], fig11_remap_sweep.
                               _fmt_with_recycle("mxfp4", 2.5), "cpu")
        want = _jdefault_cast(_bench()[0], JQuantPolicy(weight_fmt=fmt))
    else:
        got, want = _cast(fmt), _jcast(fmt)
    g, w = _port_qleaves(got), _ref_qleaves(want)
    assert sorted(g) == sorted(w) and len(g) == 7
    for k in w:
        np.testing.assert_array_equal(g[k][0], w[k][0])
        np.testing.assert_array_equal(g[k][1].view(w[k][1].dtype), w[k][1])
    assert not any(isinstance(got[k], QTensor) for k in got if k != "layers")


@pytest.mark.parametrize("fmt", [None, "mxfp4"])
def test_eval_ppl_and_top1_match_reference(fmt):
    """Table 1's ``eval_ppl`` and Fig. 10's ``top1_acc`` on the
    reference's params (and their mxfp4 cast's ``dense_like``) within
    ``PPL_RTOL`` and ``ACC_TOL``."""
    jp, tp = _bench()
    cfg, jcfg = common.BENCH_CFG, jcommon.BENCH_CFG
    if fmt is not None:
        jp, tp = _JDENSE_LIKE(_jcast(fmt)), dense_like(_cast(fmt))
    want = jcommon.eval_ppl(jcfg, jp, batches=2)
    got = common.eval_ppl(cfg, tp, batches=2)
    assert abs(got - want) <= PPL_RTOL * want, (got, want)
    want = jfig10.top1_acc(jcfg, jp, batches=1)
    got = fig10_accuracy.top1_acc(cfg, tp, batches=1)
    assert abs(got - want) <= ACC_TOL, (got, want)


def test_fig3_scaled_blocks_exact():
    w = jcommon.weight_ensemble("phi3-like")
    np.testing.assert_array_equal(common.weight_ensemble("phi3-like"), w)
    s = fig3_profile.scaled_blocks(w, device="cpu")
    want = jfig3.scaled_blocks(w)
    np.testing.assert_array_equal(s, want)
    nz = want[np.abs(want) > 0]
    p = fig3_profile.profile(s)
    assert p["vac"] == float(np.mean((np.abs(nz) > 4.0) & (np.abs(nz) < 6.0)))
    assert p["clamp"] == float(np.mean(np.abs(nz) > 6.0))
    assert (p["lo"], p["hi"]) == (np.percentile(nz, 0.01),
                                  np.percentile(nz, 99.99))


def test_fig8_mse_suite_and_matrices_match_reference():
    w = jcommon.weight_ensemble("llama3-like")
    got = fig8_quant_error.mse_suite(w, "cpu")
    want = jfig8.mse_suite(w)
    assert got.keys() == want.keys()
    for f in want:
        assert abs(got[f] - want[f]) <= MSE_RTOL * want[f], (f, got, want)
    g = common.model_weight_matrices(_bench()[1])
    m = jcommon.model_weight_matrices(_bench()[0])
    assert list(g) == list(m)
    for k in m:
        np.testing.assert_array_equal(g[k], m[k])


def test_fig9_footprints_exact():
    jp, tp = _bench()
    assert tree_footprint_bytes(tp) == jtree_footprint_bytes(jp)
    for fmt in ("nxfp5", "mxfp4"):
        assert tree_footprint_bytes(_cast(fmt)) == jtree_footprint_bytes(
            _jcast(fmt))
        assert fig9_tradeoff.quantized_bytes(_cast(fmt)) == sum(
            leaf.nbytes() for leaf in jax.tree.leaves(
                _jcast(fmt), is_leaf=lambda x: isinstance(x, JQTensor))
            if hasattr(leaf, "packed"))
    for fmt in fig9_tradeoff.FMTS + [None]:
        assert fig9_tradeoff.kv_bytes(common.BENCH_CFG, fmt) \
            == jfig9.kv_bytes(jcommon.BENCH_CFG, fmt)


def test_fig11_fig12_sweep_and_weight_mse(monkeypatch):
    """``sweep_points`` exactly; ``_weight_mse`` (Figs. 11 and 12: the
    stacked layers' 2-D leaves, norm scales included) at a recycle point
    within ``MSE_RTOL``. The reference's function runs with its cast and
    decode jitted (the same functions; eagerly every op compiles for
    each new shape)."""
    monkeypatch.setattr(jfig11, "direct_cast_tree", _jdefault_cast)
    monkeypatch.setattr(jfig11, "dense_like", _JDENSE_LIKE)
    for elem in ("e2m1", "int4"):
        assert fig11_remap_sweep.sweep_points(elem) \
            == jfig11.sweep_points(elem)
    assert [fig12_blocksize.fmt_name("bfp4", bs) for bs in (8, 32)] \
        == ["bfp4_bs8", "bfp4"]
    got = fig11_remap_sweep._weight_mse(
        _bench()[1], fig11_remap_sweep._fmt_with_recycle("mxfp4", 5.0))
    want = jfig11._weight_mse(_bench()[0],
                              jfig11._fmt_with_recycle("mxfp4", 5.0))
    assert abs(got - want) <= MSE_RTOL * want, (got, want)


def test_train_then_serve_twin_matches_reference():
    """The example's eval within ``PPL_RTOL`` of the reference example's,
    and its serve (nxfp4 weights cast at load, nxfp4 KV; greedy, 2 x 16
    prompt tokens, 8 new) token for token the reference engine's. The
    reference engine serves its weights pre-cast by its jitted encoder
    (its own load cast is the Pallas quantizer in interpret mode): the
    arithmetic encoder, the port engine's load cast."""
    jex = _example("train_then_serve_quantized")
    tex = _example("train_then_serve_quantized_torch")
    jp, tp = _bench()
    assert tex.CFG.param_count() == jex.CFG.param_count()
    want = jex.eval_ppl(jex.CFG, jp)
    got = tex.eval_ppl(tex.CFG, tp, torch.device("cpu"))
    assert abs(got - want) <= PPL_RTOL * want, (got, want)
    _, res = tex.serve(tp, "cpu", batch=2, prompt=16, max_new=8,
                       temperature=0.0)
    jq = jdirect_cast_tree(jp, JQuantPolicy("nxfp4", "nxfp4"),
                           quantize_fn=jax.jit(jquantize_qtensor,
                                               static_argnums=(1, 2)))
    jeng = JServeEngine(jex.CFG, jq, JQuantPolicy(None, "nxfp4"),
                        max_len=192)
    toks = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(
        np.int32)
    want = jeng.generate({"tokens": toks}, max_new=8, loop="host")
    np.testing.assert_array_equal(res.tokens, np.asarray(want.tokens))


@functools.lru_cache(maxsize=None)
def _long_case(arch, cast=True):
    """The reference example's weights (its table cast of the seed-0
    init; ``cast`` False: the f32 init, for the cache's bytes, which the
    weights do not change) and a prompt of 64 tokens."""
    jcfg = jget_smoke_config(arch)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    if cast:
        jp = _jdefault_cast(jp, JQuantPolicy("nxfp4", "nxfp4"))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab,
                                             (1, 64)).astype(np.int32)
    return jcfg, jp, toks


def _serve_long(arch, steps, cast=True):
    jcfg, jp, toks = _long_case(arch, cast)
    tex = _example("longcontext_ssm_serving_torch")
    return tex.serve_long(get_smoke_config(arch),
                          params_from_jax(_np(jp), device="cpu"),
                          torch.from_numpy(toks).long(), steps,
                          torch.device("cpu"))


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "hymba_1_5b",
                                  "h2o_danube_3_4b"])
def test_longcontext_twin_state_bytes(arch):
    """``serve_long``'s cache bytes after a 64-token prefill with an nxfp4
    KV cache, exactly the reference example's count over its prefill's
    cache (shapes and dtypes from ``jax.eval_shape``; the windowed
    models' 32-row rings wrap)."""
    jcfg, jp, toks = _long_case(arch, cast=False)
    cache = jax.eval_shape(lambda p, b: jprefill(
        jcfg, p, b, max_len=65, kv_fmt="nxfp4"), jp, {"tokens": toks})[1]
    want = sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree.leaves(cache))
    assert _serve_long(arch, 1, cast=False)[1] == want


def test_longcontext_twin_tokens_match_reference():
    """4 greedy steps of ``serve_long`` after a 64-token prompt on
    H2O-Danube3 (its ring wrapped) equal to the reference example's
    computation: ``prefill`` with an nxfp4 KV cache, then greedy
    ``decode_step``s (the SSM and hybrid families' streams are held in
    ``test_torch_ssm.py``)."""
    jcfg, jp, toks = _long_case("h2o_danube_3_4b")
    logits, cache = jax.jit(lambda p, b: jprefill(
        jcfg, p, b, max_len=68, kv_fmt="nxfp4"))(jp, {"tokens": toks})
    step = jax.jit(lambda p, t, c: jdecode_step(jcfg, p, t, c,
                                                kv_fmt="nxfp4"))
    tok, want = jnp.argmax(logits, -1)[:, None].astype(jnp.int32), []
    for _ in range(4):
        logits, cache = step(jp, tok, cache)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(_serve_long("h2o_danube_3_4b", 4)[0],
                                  np.concatenate(want, 1))
