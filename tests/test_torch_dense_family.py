"""The rest of the dense family in the torch port, on the CPU at smoke size.

* The configs: ``llama2_7b``, ``starcoder2_3b``, ``deepseek_67b``,
  ``llama3_405b`` and ``h2o_danube_3_4b`` are the reference's, and their
  parameter counts (computed from the config, nothing allocated) are the
  reference's and near the published sizes
  (``tests/test_models_smoke.py:95``'s bands).
* Four smoke configs through the port against the reference (Llama-2,
  StarCoder2, DeepSeek and Danube; Llama-3-405B's smoke config is
  Llama-3-8B's shapes at twice the width), params from
  ``params_from_jax``: prefill logits within 1e-2 (the model tolerance of
  ``tests/test_torch_model.py``: bf16 activations rounded per op in torch,
  fused in XLA) and greedy streams equal, with nxfp4 KV and bf16 weights
  (nxfp4 weights are shape-agnostic and held on Llama-3-8B by
  ``tests/test_torch_model.py``; the reference's cast costs a case most
  of its seconds).
* The sliding-window ring (``h2o_danube_3_4b``, window 32), bitwise
  against the reference: ``_ring_place``, ``write_prefill``,
  ``write_token`` and ``write_prefill_at`` across the ring's edge (dense
  rows, packed bytes and meta). Banded prefill attention is bitwise the
  unbanded. The ring lane (prompts longer than the lane) is bitwise the
  whole prefill, and its engine streams the whole engine's; a stream that
  wraps the ring in decode is bitwise its solo stream (dense KV here,
  packed in ``tests/test_torch_continuous.py``); the refusals of a chunk
  wider than the window.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models.kvcache import _ring_place as j_ring_place
from repro.models.kvcache import attn_cache_init as jattn_cache_init
from repro.models.kvcache import write_prefill as jwrite_prefill
from repro.models.kvcache import write_prefill_at as jwrite_prefill_at
from repro.models.kvcache import write_token as jwrite_token
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.kernels.ops import quantize_qtensor
from repro_torch.models import init_cache, init_lane, prefill, prefill_chunk
from repro_torch.models import attention
from repro_torch.models.kvcache import (_ring_place, write_prefill,
                                        write_prefill_at, write_token)
from repro_torch.serving import ContinuousEngine, Request, ServeEngine

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

TOL = 1e-2
MAX_LEN = 64
NEW = ("llama2_7b", "starcoder2_3b", "deepseek_67b", "llama3_405b",
       "h2o_danube_3_4b")
SERVED = ("llama2_7b", "starcoder2_3b", "deepseek_67b", "h2o_danube_3_4b")
# published sizes and bands (tests/test_models_smoke.py:95; starcoder2's
# upstream MLP has two matrices, the framework's SwiGLU three)
PUBLIC = {"llama2_7b": (6.7e9, 1.45), "starcoder2_3b": (3.0e9, 1.5),
          "deepseek_67b": (67e9, 1.45), "llama3_405b": (405e9, 1.45),
          "h2o_danube_3_4b": (4.0e9, 1.45)}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = jget_smoke_config(arch)
    cfg = get_smoke_config(arch)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, cfg, jparams, tparams


def _prompt(cfg, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (t,)).astype(np.int32)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _port(a):
    """A reference array as the port's tensor, bit for bit."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return _bf16(a.astype(np.float32))
    if a.dtype == np.uint16:
        return torch.from_numpy(a.astype(np.int32)).to(torch.uint16)
    return torch.from_numpy(a.copy())


def _same(got, want):
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))
    else:
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      want.astype(np.int64))


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW)
def test_configs_and_param_counts_match_reference(arch):
    assert arch in ARCH_IDS
    cfg, jcfg = get_config(arch), jget_config(arch)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "rope_theta", "norm_eps", "sliding_window"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.hd == jcfg.hd and cfg.family == jcfg.family == "dense"
    got = cfg.param_count()
    assert got == jcfg.param_count()
    n, hi = PUBLIC[arch]
    assert 0.6 * n < got < hi * n, (arch, got, n)
    smoke, jsmoke = get_smoke_config(arch), jget_smoke_config(arch)
    assert smoke.param_count() == jsmoke.param_count()
    assert smoke.sliding_window == jsmoke.sliding_window


@pytest.mark.parametrize("arch", SERVED)
def test_smoke_logits_and_greedy_streams_match_reference(arch):
    """Prefill logits within the model tolerance and a greedy stream of 8
    tokens equal to the reference's, nxfp4 KV (danube: a 40-token prompt
    over its 32-row ring, which wraps again in decode)."""
    jcfg, cfg, jparams, tparams = _setup(arch)
    toks = _prompt(cfg, 40 if cfg.sliding_window else 12, seed=1)[None]
    jeng = JServeEngine(jcfg, jparams, JQuantPolicy(None, "nxfp4"),
                        max_len=MAX_LEN)
    eng = ServeEngine(cfg, tparams, QuantPolicy(None, "nxfp4"),
                      max_len=MAX_LEN, device="cpu")
    jl, _ = jprefill(jcfg, jeng.params, {"tokens": toks}, max_len=MAX_LEN,
                     kv_fmt="nxfp4")
    tl, _ = prefill(cfg, eng.params, {"tokens": torch.from_numpy(
        toks).long()}, MAX_LEN, "nxfp4")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    want = jeng.generate({"tokens": toks}, max_new=8, loop="host")
    got = eng.generate({"tokens": toks}, max_new=8, loop="host")
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


# ---------------------------------------------------------------------------
# the ring against the reference, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [20, 32, 45, 77])
def test_ring_place_matches_reference(t):
    x = np.random.default_rng(t).standard_normal((2, t, 3)).astype(
        np.float32)
    got = _ring_place(torch.from_numpy(x), 32, t)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_ring_place(jnp.asarray(x),
                                                          32, t)))


@pytest.mark.parametrize("kv", [None, "nxfp4"])
def test_ring_writes_match_reference(kv):
    """``write_prefill`` of a 45-token prompt (the ring keeps its last 32
    rows at ``p % 32``), then ``write_token`` at ragged positions, one past
    a wrap and one of a parked slot: the reference's rows. A packed ring
    holds the codec's encoding of each of the reference's dense ring rows
    (every row is written; the codec is bitwise the reference's,
    ``tests/test_torch_codec.py``), which spares the reference's packed
    cast its compile."""
    jcfg, cfg = _setup("h2o_danube_3_4b")[:2]
    rng = np.random.default_rng(0)
    k, v = (rng.standard_normal((3, 45, cfg.n_kv_heads, cfg.hd)).astype(
        np.float32) for _ in range(2))
    k1, v1 = (rng.standard_normal((3, 1, cfg.n_kv_heads, cfg.hd)).astype(
        np.float32) for _ in range(2))
    pos = np.array([45, 70, 31], np.int32)
    live = np.array([True, True, False])

    def check(got, ref):
        for name in "kv":
            want = np.asarray(ref[name])
            if kv is None:
                _same(got[name], want)
                continue
            assert got[f"{name}_packed"].shape[1] == 32
            q = quantize_qtensor(_port(want).float(), kv, axis=-1,
                                 device="cpu")
            assert torch.equal(got[f"{name}_packed"], q.packed), name
            assert torch.equal(got[f"{name}_meta"], q.meta), name

    ref = jwrite_prefill(jcfg, jnp.asarray(k, jnp.bfloat16),
                         jnp.asarray(v, jnp.bfloat16), None, MAX_LEN)
    got = write_prefill(cfg, _bf16(k), _bf16(v), kv, MAX_LEN)
    check(got, ref)
    ref = jwrite_token(jcfg, ref, jnp.asarray(k1, jnp.bfloat16),
                       jnp.asarray(v1, jnp.bfloat16), jnp.asarray(pos), None,
                       live=jnp.asarray(live))
    got = write_token(cfg, got, _bf16(k1), _bf16(v1), torch.from_numpy(pos),
                      kv, live=torch.from_numpy(live))
    check(got, ref)


@pytest.mark.parametrize("kv", [None, "nxfp4"])
def test_write_prefill_at_crosses_ring_boundary(kv):
    """A chunk whose rows straddle the ring's edge lands at ``p % w`` (rows
    29, 30, 31, then 0, 1, 2), rows past ``n_valid`` are dropped and the
    neighbour slots are untouched: the reference's scatter, bit for bit
    (``tests/test_prefill_chunk.py:209``, dense and packed)."""
    jcfg, cfg = _setup("h2o_danube_3_4b")[:2]
    w = cfg.sliding_window
    rng = np.random.default_rng(1)
    jl = {n: np.asarray(a[0]) for n, a in
          jattn_cache_init(jcfg, 1, 3, MAX_LEN, kv).items()}
    jl = {n: (np.asarray(jnp.asarray(rng.standard_normal(a.shape), a.dtype))
              if a.dtype == jnp.bfloat16 else
              rng.integers(0, np.iinfo(a.dtype).max, a.shape).astype(a.dtype))
          for n, a in jl.items()}
    k, v = (rng.standard_normal((1, 8, cfg.n_kv_heads, cfg.hd)).astype(
        np.float32) for _ in range(2))
    offset, n_valid = w - 3, 6
    ref = jwrite_prefill_at(jcfg, {n: jnp.asarray(a) for n, a in jl.items()},
                            jnp.asarray(k, jnp.bfloat16),
                            jnp.asarray(v, jnp.bfloat16), 1, offset,
                            n_valid, kv)
    i32 = dict(dtype=torch.int32)
    got = write_prefill_at(cfg, {n: _port(a) for n, a in jl.items()},
                           _bf16(k), _bf16(v), torch.tensor([1], **i32),
                           torch.tensor([offset], **i32),
                           torch.tensor([n_valid], **i32), kv)
    for name, want in ref.items():
        _same(got[name], want)


def test_chunks_wider_than_the_window_are_refused():
    jcfg, cfg, _, tparams = _setup("h2o_danube_3_4b")
    layer = init_cache(cfg, 1, MAX_LEN, None, device="cpu")["layers"][0]
    k = torch.zeros((1, 40, cfg.n_kv_heads, cfg.hd), dtype=torch.bfloat16)
    at = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="chunk of 40 rows"):
        write_prefill_at(cfg, layer, k, k, at, at, at + 40, None)
    with pytest.raises(ValueError, match="sliding_window"):
        init_lane(cfg, MAX_LEN, 40, device="cpu")
    with pytest.raises(ValueError, match="sliding_window"):
        ContinuousEngine(cfg, tparams, QuantPolicy(None, None), n_slots=2,
                         max_len=MAX_LEN, prefill_mode="chunked", p_chunk=48,
                         device="cpu")


def test_banded_attention_is_bitwise_unbanded(monkeypatch):
    """A key tile masked for every query of a chunk leaves the online
    softmax's state bit-unchanged, so the band (3 of 5 tiles for the last
    query chunk here) gives the unbanded bits."""
    rng = np.random.default_rng(2)
    b, t, kvh, g, d = 1, 1100, 2, 2, 16
    q = _bf16(rng.standard_normal((b, t, kvh, g, d)) * 0.25)
    k, v = (_bf16(rng.standard_normal((b, t, kvh, d))) for _ in range(2))
    band = attention.attend_chunked(q, k, v, window=300, chunk_q=256)
    monkeypatch.setattr(attention, "BANDED_SWA", False)
    full = attention.attend_chunked(q, k, v, window=300, chunk_q=256)
    assert torch.equal(band, full)


# ---------------------------------------------------------------------------
# the ring lane and the ring in serving
# ---------------------------------------------------------------------------

def test_ring_lane_prefill_matches_whole_and_reference():
    """A 100-token prompt through a 64-row lane in chunks of 32: the
    chunks at 64 and 96 run the ring lane, and the final logits and the
    slot's ring rows are the whole prefill's bit for bit (the reference's
    own prefill within the model tolerance)."""
    jcfg, cfg, jparams, tparams = _setup("h2o_danube_3_4b")
    toks = _prompt(cfg, 100, seed=3)
    want, whole = prefill(cfg, tparams, {"tokens": torch.from_numpy(
        toks[None]).long()}, MAX_LEN, "nxfp4")
    cache = init_cache(cfg, 2, MAX_LEN, "nxfp4", device="cpu")
    lane = init_lane(cfg, MAX_LEN, 32, device="cpu")
    for off in range(0, 100, 32):
        n = min(32, 100 - off)
        chunk = np.zeros((1, 32), np.int64)
        chunk[0, :n] = toks[off:off + n]
        logits, cache, lane = prefill_chunk(
            cfg, tparams, torch.from_numpy(chunk), cache, 1, off, n, lane,
            "nxfp4", wrapped=off >= 64)
    assert torch.equal(logits, want)
    for lc, wc in zip(cache["layers"], whole["layers"]):
        for name, buf in lc.items():
            assert torch.equal(buf[1], wc[name][0]), name
    jl, _ = jprefill(jcfg, jparams, {"tokens": toks[None]}, max_len=MAX_LEN,
                     kv_fmt="nxfp4")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                               atol=TOL)


def _solo(cfg, params, fmt, req):
    eng = ServeEngine(cfg, params, QuantPolicy(fmt, fmt), max_len=MAX_LEN,
                      rng_seed=req.seed, device="cpu")
    return eng.generate({"tokens": req.tokens[None]}, max_new=req.max_new,
                        loop="host").tokens[0]


def test_ring_lane_engine_matches_whole_engine():
    """Chunked admission takes prompts longer than ``max_len`` through the
    ring lane (``tests/test_paged.py:320``'s dense-engine half): the
    streams are the whole-admission engine's, bit for bit."""
    cfg, tparams = _setup("h2o_danube_3_4b")[1::2]
    reqs = [Request(uid=i, tokens=_prompt(cfg, t, seed=7 + i), max_new=5)
            for i, t in enumerate([100, 40, 72])]
    pol = QuantPolicy(None, None)     # the lane's rows; the packed ring
    #                                   writes: the lane prefill test
    whole = {r.uid: r.tokens for r in ContinuousEngine(
        cfg, tparams, pol, n_slots=2, max_len=MAX_LEN, chunk=4,
        device="cpu").serve(reqs)}
    eng = ContinuousEngine(cfg, tparams, pol, n_slots=2, max_len=MAX_LEN,
                           chunk=4, prefill_mode="chunked", p_chunk=32,
                           device="cpu")
    assert eng._lane_ring
    for r in eng.serve(reqs):
        np.testing.assert_array_equal(r.tokens, whole[r.uid])
    # a lane without rows for a window and a chunk refuses the long prompt
    short = ContinuousEngine(cfg, tparams, pol, n_slots=2, max_len=32,
                             chunk=4, prefill_mode="chunked", p_chunk=32,
                             device="cpu")
    assert not short._lane_ring
    with pytest.raises(ValueError, match="lane scratch"):
        short._check_request(reqs[0])


@pytest.mark.parametrize("fmt", [None])
def test_continuous_ring_wrap_matches_solo(fmt):
    """A request that wraps the ring in decode (28 + 8 tokens over 32
    rows) beside churning neighbours, and one that runs past ``max_len``
    (the ring wraps instead of overflowing): every stream bitwise its solo
    stream (``tests/test_continuous.py:69``, here with the premium tier's
    dense cache; nxfp4 KV: ``tests/test_torch_continuous.py::
    test_continuous_matches_solo_host[danube-nxfp4]``)."""
    cfg, tparams = _setup("h2o_danube_3_4b")[1::2]
    reqs = [Request(uid=0, tokens=_prompt(cfg, 28), max_new=8),
            Request(uid=1, tokens=_prompt(cfg, 8, seed=1), max_new=6),
            Request(uid=2, tokens=_prompt(cfg, 8, seed=2), max_new=6),
            Request(uid=3, tokens=_prompt(cfg, 60, seed=3), max_new=6)]
    eng = ContinuousEngine(cfg, tparams, QuantPolicy(fmt, fmt), n_slots=2,
                           max_len=MAX_LEN, chunk=8, device="cpu")
    for r in eng.serve(reqs):
        assert r.n_generated == reqs[r.uid].max_new
        np.testing.assert_array_equal(r.tokens,
                                      _solo(cfg, tparams, fmt, reqs[r.uid]),
                                      err_msg=f"uid={r.uid}")
