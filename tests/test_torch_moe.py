"""The MoE family in the torch port, on the CPU at smoke size
(``qwen2_moe_a2_7b``: 8 experts top-2 and a shared MLP; ``phi3_5_moe_42b``:
4 experts top-2).

* ``moe_ffn`` against the reference's (``src/repro/models/moe.py``) from
  the same seeded bf16 input and the reference's own layer-0 weights
  carried across by ``params_from_jax`` (nxfp4 experts cast to the
  reference's QTensors, and bf16 experts), with and without a ``valid`` mask: the
  same top-k experts and the same kept assignments (the reference's
  ``gate_idx`` and ``keep``, recomputed from its lines 89-110), outputs
  within 2e-2 of their scale (bf16 outputs of bf16 GEMMs summed in
  another order: the tolerance of ``tests/test_torch_ssm.py``), the aux
  loss within 1e-5. ``moe_ffn_decode`` likewise, and a B 3 batch's rows
  bitwise each row decoded alone (the per-slot capacity).
* The model: smoke prefill logits within 1e-2 of the reference's and a
  greedy stream equal to its ``ServeEngine``'s.
* The engines: ``ContinuousEngine`` under whole admission, every stream
  bitwise its solo host-loop stream and equal to the reference engine's
  (``tests/test_continuous.py:44``); chunked admission warns and serves
  (``tests/test_faults.py:389``); ``speculative=`` raises
  (``tests/test_speculative.py:271``); ``PagedContinuousEngine`` without
  shared prefixes bitwise the solos, and with one equal to the
  reference's paged engine (a claimant maps K/V computed under its
  owner's capacity, so there its stream is not its solo's).
"""
import dataclasses
import functools
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.qtensor import QTensor as JQTensor
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.core.qtensor import direct_cast_tree as jdirect_cast_tree
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.models import prefill as jprefill
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import PagedContinuousEngine as JPagedEngine
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QTensor, QuantPolicy
from repro_torch.kernels.build import bit_view
from repro_torch.kernels.ops import quantize_qtensor
from repro_torch.models import moe, prefill
from repro_torch.serving import (ContinuousEngine, PagedContinuousEngine,
                                 Request, ServeEngine, SpeculativeConfig,
                                 Status)

from _torch_helpers import solo_stream

ARCHS = ("qwen2_moe_a2_7b", "phi3_5_moe_42b")
# the reference's FFNs, jitted (one compile a signature beats eager JAX's
# compile of every op at every shape)
_JMOE_FFN = jax.jit(jmoe.moe_ffn, static_argnums=0)
_JMOE_DECODE = jax.jit(jmoe.moe_ffn_decode, static_argnums=0)
BF16_TOL = 2e-2     # of the scale: bf16 outputs
AUX_TOL = 1e-5
TOL = 1e-2          # logits (tests/test_torch_model.py)
MAX_LEN = 64


def _cast(leaf, fmt, axis):
    """A reference QTensor cast by the port's quantizer on the CPU: the
    reference's codec bit for bit (``tests/test_torch_codec.py``), without
    the Pallas encoder's interpret-mode compiles."""
    q = quantize_qtensor(torch.from_numpy(np.array(leaf)), fmt, axis,
                         device="cpu")
    return JQTensor(jnp.asarray(q.packed.numpy()),
                    jnp.asarray(bit_view(q.meta).numpy().view(np.uint16)),
                    q.fmt_name, q.shape, q.axis, q.orig_len)


@functools.lru_cache(maxsize=None)
def _setup(arch, fmt):
    """The reference's smoke config and params of ``arch`` (cast to
    ``fmt``) and the port's copy of them."""
    jcfg = jget_smoke_config(arch)
    cfg = get_smoke_config(arch)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    if fmt is not None:
        jparams = jdirect_cast_tree(jparams, JQuantPolicy(fmt, fmt),
                                    quantize_fn=_cast)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, cfg, jparams, tparams


def _bf16_input(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    return jx, torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16)


def _ref_routing(jcfg, jp, jx, valid=None):
    """The reference's ``gate_idx`` and ``keep`` (``moe.py:89-110``)."""
    b, t, d = jx.shape
    e, k, n = jcfg.n_experts, jcfg.n_experts_active, b * t
    logits = jx.reshape(n, d).astype(jnp.float32) @ jp["router"]
    _, gate_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    cap = max(int(math.ceil(k * n * jcfg.capacity_factor / e)), 1)
    oh = jax.nn.one_hot(gate_idx.reshape(-1), e, dtype=jnp.int32)
    if valid is not None:
        oh = oh * jnp.repeat(valid, k).astype(jnp.int32)[:, None]
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=-1)
    keep = pos < cap
    if valid is not None:
        keep = keep & jnp.repeat(valid, k)
    return np.asarray(gate_idx), np.asarray(keep)


def _layer0(arch, fmt):
    jcfg, cfg, jparams, tparams = _setup(arch, fmt)
    return (jcfg, cfg, jax.tree.map(lambda a: a[0], jparams["layers"]),
            tparams["layers"][0])


def _close(got, want, tol, what):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def test_param_counts_match_reference():
    for arch in ARCHS:
        assert get_config(arch).param_count() == \
            jget_config(arch).param_count(), arch


@pytest.mark.parametrize("masked", [False, True], ids=["whole", "valid"])
@pytest.mark.parametrize("fmt", ["nxfp4", None])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, fmt, masked):
    """Routing exact, outputs and aux within tolerance, over 2 x 12 tokens;
    ``valid`` masks the last 5 tokens of the flattened batch, as a lane
    chunk's padding. Both sides run a capacity factor of 0.75 (the
    config's 1.25 drops nothing on this little data), so capacity binds
    and some assignments are dropped."""
    jcfg, cfg, jp, tp = _layer0(arch, fmt)
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.75)
    cfg = dataclasses.replace(cfg, capacity_factor=0.75)
    jx, x = _bf16_input((2, 12, cfg.d_model), seed=3)
    valid = None
    if masked:
        valid = np.arange(24) < 19
    jy, jaux = _JMOE_FFN(jcfg, jp, jx, None if valid is None
                         else jnp.asarray(valid))
    tv = None if valid is None else torch.from_numpy(valid)
    y, aux = moe.moe_ffn(cfg, tp, x, valid=tv)
    gate_idx, keep = _ref_routing(jcfg, jp, jx, None if valid is None
                                  else jnp.asarray(valid))
    _, _, idx = moe.route(cfg, tp, x.reshape(-1, cfg.d_model))
    expert, _ = moe.dispatch(cfg, idx, moe.capacity(cfg, 24), tv)
    np.testing.assert_array_equal(idx.numpy(), gate_idx)
    np.testing.assert_array_equal(expert.numpy() >= 0, keep)
    assert not keep.all(), "capacity should drop some assignments here"
    rows = slice(None) if valid is None else valid
    _close(y.reshape(24, -1)[rows], np.asarray(
        jy.astype(jnp.float32)).reshape(24, -1)[rows], BF16_TOL,
        f"{arch}/{fmt}")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=AUX_TOL)


@pytest.mark.parametrize("fmt", ["nxfp4", None])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_decode_rows_alone_and_reference(arch, fmt):
    """A B 3 decode batch: each row bitwise the row decoded alone (no
    capacity couples rows), the batch within tolerance of the reference's
    per-slot ``moe_ffn_decode``, aux within 1e-5."""
    jcfg, cfg, jp, tp = _layer0(arch, fmt)
    jx, x = _bf16_input((3, 1, cfg.d_model), seed=4)
    y, aux = moe.moe_ffn_decode(cfg, tp, x)
    for i in range(3):
        yi, _ = moe.moe_ffn_decode(cfg, tp, x[i:i + 1])
        assert torch.equal(yi[0], y[i]), f"row {i}"
    jy, jaux = _JMOE_DECODE(jcfg, jp, jx)
    _close(y, jy.astype(jnp.float32), BF16_TOL, f"{arch}/{fmt}")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=AUX_TOL)


def test_moe_expert_leaves_carry_across():
    """The reference's stacked expert QTensor (L, E, D, F) becomes one
    QTensor a layer, packed (E, F, KB, bpb), its bytes unchanged."""
    _, cfg, jparams, tparams = _setup("qwen2_moe_a2_7b", "nxfp4")
    jw = jparams["layers"]["experts_w1"]
    for i, layer in enumerate(tparams["layers"]):
        w = layer["experts_w1"]
        assert isinstance(w, QTensor)
        assert w.shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
        np.testing.assert_array_equal(w.packed.numpy(),
                                      np.asarray(jw.packed)[i])
    assert not isinstance(tparams["layers"][0]["router"], QTensor)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_logits_and_greedy_stream_match_reference(arch):
    """Prefill logits within the model tolerance and 8 greedy tokens equal
    to the reference's ``ServeEngine``, nxfp4 weights and KV (the
    reference's cast, carried across)."""
    jcfg, cfg, jparams, tparams = _setup(arch, "nxfp4")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 12)).astype(np.int32)
    jeng = JServeEngine(jcfg, jparams, JQuantPolicy(None, "nxfp4"),
                        max_len=MAX_LEN)
    eng = ServeEngine(cfg, tparams, QuantPolicy("nxfp4", "nxfp4"),
                      max_len=MAX_LEN, device="cpu")
    jl, _ = jprefill(jcfg, jeng.params, {"tokens": toks}, max_len=MAX_LEN,
                     kv_fmt="nxfp4")
    tl, _ = prefill(cfg, eng.params, {"tokens": torch.from_numpy(
        toks).long()}, MAX_LEN, "nxfp4")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    want = jeng.generate({"tokens": toks}, max_new=8, loop="host")
    got = eng.generate({"tokens": toks}, max_new=8, loop="host")
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def _prompts(cfg, n, t, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
            for _ in range(n)]


def _reqs(cfg, max_news, t=8, seed=0):
    return [Request(uid=i, tokens=p, max_new=m) for i, (p, m) in
            enumerate(zip(_prompts(cfg, len(max_news), t, seed), max_news))]


@pytest.mark.parametrize("fmt", ["nxfp4", None])
def test_continuous_whole_matches_solo_and_reference(fmt):
    """The reference's oracle (``tests/test_continuous.py:44``): 5
    requests with mixed max_new over 2 slots, chunk 4; every stream
    bitwise its solo host-loop stream, and (nxfp4) its first 8 tokens
    equal to the JAX engine's stream of the same request (the horizon of
    the model test: two frameworks' bf16 sums part at a near-tie of the
    smoke model's random logits, one 14-token stream at its tenth
    token)."""
    jcfg, cfg, jparams, tparams = _setup("qwen2_moe_a2_7b", fmt)
    policy = QuantPolicy(fmt, fmt)
    reqs = _reqs(cfg, [5, 11, 3, 8, 14])
    eng = ContinuousEngine(cfg, tparams, policy, n_slots=2, max_len=MAX_LEN,
                           chunk=4, device="cpu")
    got = {r.uid: r for r in eng.serve(reqs)}
    for req in reqs:
        solo = solo_stream(cfg, tparams, policy, req, MAX_LEN)
        assert got[req.uid].n_generated == req.max_new
        np.testing.assert_array_equal(got[req.uid].tokens, solo.tokens[0],
                                      err_msg=f"uid={req.uid}")
    if fmt is None:
        return
    jeng = JContinuousEngine(jcfg, jparams, JQuantPolicy(None, fmt),
                             n_slots=2, max_len=MAX_LEN, chunk=4)
    for r in jeng.serve([JRequest(uid=q.uid, tokens=q.tokens,
                                  max_new=q.max_new) for q in reqs]):
        np.testing.assert_array_equal(got[r.uid].tokens[:8],
                                      np.asarray(r.tokens)[:8],
                                      err_msg=f"uid={r.uid} vs JAX")


def test_chunked_admission_warns_and_serves(caplog):
    """MoE with chunked admission is outside the bitwise contract (the
    capacity is the chunk's): the engine warns at construction and
    serves (``tests/test_faults.py:389``)."""
    _, cfg, _, tparams = _setup("qwen2_moe_a2_7b", None)
    with caplog.at_level(logging.WARNING, logger="repro_torch.serving"):
        eng = ContinuousEngine(cfg, tparams, QuantPolicy(None, None),
                               n_slots=2, max_len=MAX_LEN, chunk=4,
                               prefill_mode="chunked", p_chunk=8,
                               device="cpu")
    assert any("chunk-local" in r.getMessage() and "moe" in r.getMessage()
               for r in caplog.records)
    res = eng.serve(_reqs(cfg, [5, 6], t=13))
    assert all(r.status == Status.OK for r in res)
    assert [r.n_generated for r in sorted(res, key=lambda r: r.uid)] \
        == [5, 6]


def test_speculative_refuses_moe():
    _, cfg, _, tparams = _setup("qwen2_moe_a2_7b", "nxfp4")
    with pytest.raises(ValueError, match="family"):
        ContinuousEngine(cfg, tparams, QuantPolicy("nxfp4", "nxfp4"),
                         n_slots=2, max_len=MAX_LEN, chunk=4,
                         speculative=SpeculativeConfig(k=4), device="cpu")


def test_paged_unshared_solo_and_shared_prefix_vs_reference():
    """Prompts that share no prefix: every stream bitwise its solo. A
    shared 16-token prefix (page 8): the port's streams equal the JAX
    paged engine's, the claimants' included, and the pool ends empty."""
    jcfg, cfg, jparams, tparams = _setup("qwen2_moe_a2_7b", "nxfp4")
    policy = QuantPolicy("nxfp4", "nxfp4")
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=4, page_size=8)
    reqs = _reqs(cfg, [5, 9, 3, 7], t=12, seed=1)
    eng = PagedContinuousEngine(cfg, tparams, policy, device="cpu", **kw)
    for r in eng.serve(reqs):
        solo = solo_stream(cfg, tparams, policy, reqs[r.uid], MAX_LEN)
        np.testing.assert_array_equal(r.tokens, solo.tokens[0],
                                      err_msg=f"uid={r.uid}")
    eng.pool.assert_empty()
    prefix = _prompts(cfg, 1, 16, seed=2)[0]
    shared = [Request(uid=i, tokens=np.concatenate([prefix, t]), max_new=6)
              for i, t in enumerate(_prompts(cfg, 3, 4, seed=3))]
    got = {r.uid: r.tokens for r in eng.serve(shared)}
    assert eng.pool.prefix_hits > 0
    eng.pool.assert_empty()
    jeng = JPagedEngine(jcfg, jparams, JQuantPolicy(None, "nxfp4"), **kw)
    for r in jeng.serve([JRequest(uid=q.uid, tokens=q.tokens,
                                  max_new=q.max_new) for q in shared]):
        np.testing.assert_array_equal(got[r.uid], np.asarray(r.tokens),
                                      err_msg=f"uid={r.uid} vs JAX")
