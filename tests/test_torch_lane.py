"""The chunked-prefill lane in the torch port, on the CPU at smoke size.

* Bitwise against the port's own whole-prompt ``prefill``: the final
  chunk's logits of ``prefill_chunk`` and the slot's packed K/V rows
  (the reference's dense-family cases of ``tests/test_prefill_chunk.py``:
  (None, 4, 11), (nxfp4, 16, 24), (nxfp4, 16, 17)), and the chunked
  ``ContinuousEngine``'s streams against their solo host-loop streams,
  greedy and seeded-sampled with a stop token.
* Against the reference, from the same numpy inputs: ``attend_chunked``
  with ``q_offset``/``kv_valid`` and ``self_attention_resume`` (1e-5 of
  max|V| and the model tolerance), ``write_prefill_at`` (packed bytes,
  meta and dense rows, bitwise: the codec is bitwise), and the final
  chunk's logits (tolerance 1e-2, ``tests/test_torch_model.py``'s: bf16
  activations rounded per op in torch, fused in XLA).
* The refusals of ``tests/test_prefill_chunk.py`` that apply to the dense
  family, and the ones of the port's own (the ring lane without a window
  or rows for it, ``"auto"`` with no candidate width that fits).
* The sliding-window family (``h2o_danube_3_4b``, window 32): the same
  prefill-chunk and chunked-engine checks, the ring of the live cache
  wrapping inside the prompt.
"""
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import init_params as jinit_params
from repro.models import prefill_chunk as jprefill_chunk
from repro.models import init_cache as jinit_cache
from repro.models import init_lane as jinit_lane
from repro.models.attention import attend_chunked as jattend_chunked
from repro.models.attention import \
    self_attention_resume as jself_attention_resume
from repro.models.kvcache import attn_cache_init as jattn_cache_init
from repro.models.kvcache import write_prefill_at as jwrite_prefill_at
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.models import (init_cache, init_lane, prefill,
                                prefill_chunk)
from repro_torch.models.attention import (KV_TILE, attend_chunked,
                                          self_attention_resume)
from repro_torch.models.kvcache import attn_cache_init, write_prefill_at
from repro_torch.serving import (ContinuousEngine, Request,
                                 ShortestPromptFirst, SlotScheduler, events)

from _torch_helpers import solo_stream  # one intra-op thread a process

TOL = 1e-2
MAX_LEN = 64


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The reference's smoke params of ``arch`` and the port's copy."""
    jcfg = jget_smoke_config(arch)
    cfg = get_smoke_config(arch)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, cfg, jparams, tparams


@pytest.fixture(scope="module")
def setup():
    """The reference's smoke Llama params and the port's copy of them."""
    return _setup("llama3_8b")


def _prompt(cfg, t, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (t,)).astype(np.int32)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _chunks(toks, p):
    """(tokens (1, P) int64, offset, n_valid) of each lane chunk."""
    t = len(toks)
    for off in range(0, t, p):
        n = min(p, t - off)
        chunk = np.zeros((1, p), np.int64)
        chunk[0, :n] = toks[off:off + n]
        yield chunk, off, n


# ---------------------------------------------------------------------------
# attention against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,rows,offset,n_valid", [
    (4, 64, 0, 4), (4, 64, 8, 3), (16, 64, 32, 16), (16, 160, 144, 9),
    (32, 300, 256, 32), (8, 136, 128, 1)])
def test_attend_chunked_offset_valid_matches_reference(p, rows, offset,
                                                       n_valid):
    """A lane chunk's attention from ``q_offset`` over ``kv_valid`` of the
    lane's rows (stale rows past it, one tile or several) against the
    reference's online softmax over key tiles of the port's width
    (``chunk_kv=KV_TILE``: the tile sets the running max each bf16 p is
    taken against): the same bf16 p, f32 sums in another order (1e-5 of
    max|V|)."""
    rng = np.random.default_rng(p + offset)
    kvh, g, d = 2, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((1, p, kvh, g, d), (1, rows, kvh, d), (1, rows, kvh, d)))
    valid = offset + n_valid
    ref = np.asarray(jattend_chunked(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        q_offset=jnp.int32(offset), kv_valid=jnp.asarray([valid], jnp.int32),
        chunk_q=1024, chunk_kv=KV_TILE))
    got = attend_chunked(*(_bf16(a) for a in (q, k, v)),
                         q_offset=torch.tensor([offset], dtype=torch.int32),
                         kv_valid=torch.tensor([valid], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy()[:, :n_valid], ref[:, :n_valid],
                               rtol=0, atol=1e-5 * np.abs(v).max())


def test_attend_chunked_stale_rows_change_nothing():
    """Rows past ``kv_valid`` (whole tiles of them, or a tile's tail) leave
    every valid query row's output bit-unchanged, whatever they hold."""
    rng = np.random.default_rng(1)
    p, rows, offset = 16, 3 * KV_TILE, KV_TILE + 16
    q = _bf16(rng.standard_normal((1, p, 2, 2, 16)))
    k = _bf16(rng.standard_normal((1, rows, 2, 16)))
    v = _bf16(rng.standard_normal((1, rows, 2, 16)))
    at = torch.tensor([offset], dtype=torch.int32)
    want = attend_chunked(q, k, v, q_offset=at, kv_valid=at + p)
    k2, v2 = k.clone(), v.clone()
    k2[:, offset + p:] = 1e4
    v2[:, offset + p:] = -3e3
    got = attend_chunked(q, k2, v2, q_offset=at, kv_valid=at + p)
    assert torch.equal(got, want)


def test_self_attention_resume_matches_reference(setup):
    """One layer's resumable attention (rope at the global positions, the
    chunk's K/V into the lane at ``offset``, attention over the valid
    rows) against the reference's: the lane rows and the chunk's K/V
    within the model tolerance, the output too, stale rows ignored."""
    jcfg, cfg, jparams, tparams = setup
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])
    tp = tparams["layers"][0]
    rng = np.random.default_rng(2)
    p, offset, n_valid = 8, 16, 5
    x = rng.standard_normal((1, p, cfg.d_model)).astype(np.float32)
    lane = [rng.standard_normal((1, 40, cfg.n_kv_heads, cfg.hd))
            .astype(np.float32) for _ in range(2)]
    pos = np.arange(offset, offset + p, dtype=np.int32)
    jout, jk, jv, jlk, jlv = jself_attention_resume(
        jcfg, jp, jnp.asarray(x, jnp.bfloat16),
        *(jnp.asarray(a, jnp.bfloat16) for a in lane), jnp.asarray(pos),
        jnp.int32(offset), jnp.asarray([offset + n_valid], jnp.int32))
    lk, lv = (_bf16(a) for a in lane)
    at = torch.tensor([offset], dtype=torch.int32)
    out, k, v = self_attention_resume(
        cfg, tp, _bf16(x), lk, lv, torch.from_numpy(pos), at, at + n_valid)
    for got, want in ((k, jk), (v, jv), (lk, jlk), (lv, jlv)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(out.float().numpy()[:, :n_valid],
                               np.asarray(jout, np.float32)[:, :n_valid],
                               rtol=0, atol=TOL)


def test_self_attention_resume_refuses_the_ring_lane(setup):
    """The ring lane needs a sliding window and lane rows for a whole
    window plus the chunk (the reference's assert)."""
    cfg, tparams = setup[1], setup[3]
    x = torch.zeros((1, 4, cfg.d_model), dtype=torch.bfloat16)
    lane = torch.zeros((1, 8, cfg.n_kv_heads, cfg.hd), dtype=torch.bfloat16)
    at = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(ValueError, match="ring lane"):
        self_attention_resume(cfg, tparams["layers"][0], x, lane, lane.clone(),
                              torch.arange(4), at, at + 4, wrapped=True)
    with pytest.raises(ValueError, match="ring lane"):      # 8 < 6 + 4
        self_attention_resume(cfg, tparams["layers"][0], x, lane, lane.clone(),
                              torch.arange(4), at, at + 4, window=6,
                              wrapped=True)


# ---------------------------------------------------------------------------
# write_prefill_at against the reference
# ---------------------------------------------------------------------------

def _sentinel_layer(jcfg, kv, seed):
    """A reference layer cache (3 slots, 16 rows) of random contents and
    the port's copy of the same bits."""
    rng = np.random.default_rng(seed)
    jl = {n: np.asarray(a[0]) for n, a in
          jattn_cache_init(jcfg, 1, 3, 16, kv).items()}
    out = {}
    for name, leaf in jl.items():
        if leaf.dtype in (np.uint8, np.uint16):
            out[name] = rng.integers(0, np.iinfo(leaf.dtype).max,
                                     leaf.shape).astype(leaf.dtype)
        else:
            out[name] = np.asarray(jnp.asarray(
                rng.standard_normal(leaf.shape), leaf.dtype))
    port = {n: (_bf16(a) if a.dtype == jnp.bfloat16 else
                torch.from_numpy(a.astype(np.int32)).to(
                    torch.uint8 if a.dtype == np.uint8 else torch.uint16))
            for n, a in out.items()}
    return out, port


@pytest.mark.parametrize("kv", ["nxfp4", None])
@pytest.mark.parametrize("p,slot,offset,n_valid", [
    (4, 1, 5, 4),            # a whole chunk
    (8, 0, 8, 3),            # a ragged final chunk
    (4, 2, 4, 0),            # n_valid 0: a no-op
    (8, 1, 12, 4),           # rows past the cache end are dropped
])
def test_write_prefill_at_matches_reference(setup, kv, p, slot, offset,
                                            n_valid):
    """The chunk's rows land at ``offset + i`` of slot ``slot``, rows past
    ``n_valid`` and the cache dropped, quantized per row: the same bytes,
    meta and bf16 rows as the reference's scatter, bit for bit, every other
    row and slot untouched."""
    jcfg, cfg = setup[:2]
    jl, tl = _sentinel_layer(jcfg, kv, seed=p + offset)
    rng = np.random.default_rng(offset)
    k, v = (rng.standard_normal((1, p, cfg.n_kv_heads, cfg.hd))
            .astype(np.float32) for _ in range(2))
    ref = jwrite_prefill_at(jcfg, {n: jnp.asarray(a) for n, a in jl.items()},
                            jnp.asarray(k, jnp.bfloat16),
                            jnp.asarray(v, jnp.bfloat16), slot, offset,
                            n_valid, kv)
    i32 = dict(dtype=torch.int32)
    got = write_prefill_at(cfg, tl, _bf16(k), _bf16(v),
                           torch.tensor([slot], **i32),
                           torch.tensor([offset], **i32),
                           torch.tensor([n_valid], **i32), kv)
    for name, want in ref.items():
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:
            np.testing.assert_array_equal(got[name].float().numpy(),
                                          want.astype(np.float32))
        else:
            np.testing.assert_array_equal(got[name].numpy().astype(np.int64),
                                          want.astype(np.int64))
    if n_valid == 0:
        for name, a in jl.items():
            np.testing.assert_array_equal(
                got[name].float().numpy() if a.dtype == jnp.bfloat16
                else got[name].numpy().astype(np.int64),
                a.astype(np.float32) if a.dtype == jnp.bfloat16
                else a.astype(np.int64))


def test_write_prefill_at_refuses_a_chunk_wider_than_the_cache(setup):
    cfg = setup[1]
    layer = attn_cache_init(cfg, 1, 4, None, torch.device("cpu"))
    k = torch.zeros((1, 8, cfg.n_kv_heads, cfg.hd), dtype=torch.bfloat16)
    at = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="chunk of 8 rows"):
        write_prefill_at(cfg, layer, k, k, at, at, at + 8, None)


# ---------------------------------------------------------------------------
# prefill_chunk: bitwise the whole prefill, near the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,fmt,p_chunk,t", [
    pytest.param("llama3_8b", None, 4, 11, id="None-4-11"),
    pytest.param("llama3_8b", "nxfp4", 16, 24, id="nxfp4-16-24"),
    pytest.param("llama3_8b", "nxfp4", 16, 17, id="nxfp4-16-17"),
    # sliding window 32: the live cache's ring wraps inside the prompt
    pytest.param("h2o_danube_3_4b", "nxfp4", 16, 40,
                 id="danube-nxfp4-16-40"),
    # the Mamba state rides the lane (the reference's rows): hybrid, and
    # attention-free with a ragged final chunk
    pytest.param("hymba_1_5b", "nxfp4", 16, 24, id="hymba-nxfp4-16-24"),
    pytest.param("falcon_mamba_7b", None, 16, 17, id="falcon-None-16-17")])
def test_prefill_chunk_matches_whole_and_reference(arch, fmt, p_chunk, t):
    """The lane's final-chunk logits are the port's whole-prompt prefill
    logits bit for bit, and the slot's K/V rows its cache rows (rows past
    the prompt and the other slot stay zero; a ring's rows hold the last
    window of the prompt at ``p % window``; a Mamba block's slot state
    ``h``/``conv`` is the whole prefill's); against the reference's
    ``prefill_chunk`` on the same prompt, the logits agree within the model
    tolerance."""
    jcfg, cfg, jparams, tparams = _setup(arch)
    toks = _prompt(cfg, t)
    want, whole = prefill(cfg, tparams, {"tokens": torch.from_numpy(
        toks[None]).long()}, MAX_LEN, fmt)
    cache = init_cache(cfg, 2, MAX_LEN, fmt, device="cpu")
    lane = init_lane(cfg, MAX_LEN, p_chunk, device="cpu")
    jcache = jinit_cache(jcfg, 2, MAX_LEN, fmt)
    jlane = jinit_lane(jcfg, MAX_LEN, p_chunk)
    jfn = jax.jit(lambda tk, c, ln, o, n: jprefill_chunk(
        jcfg, jparams, tk, c, 1, o, n, ln, fmt))
    for chunk, off, n in _chunks(toks, p_chunk):
        logits, cache, lane = prefill_chunk(cfg, tparams,
                                            torch.from_numpy(chunk), cache,
                                            1, off, n, lane, fmt)
        jlogits, jcache, jlane = jfn(chunk.astype(np.int32), jcache, jlane,
                                     jnp.int32(off), jnp.int32(n))
    assert torch.equal(logits, want)
    for lc, wc in zip(cache["layers"], whole["layers"]):
        for name, buf in lc.items():
            if name in ("h", "conv"):        # the Mamba state: the slot's
                assert torch.equal(buf[1], wc[name][0]), name
                assert not buf[0].any(), name
                continue
            assert torch.equal(buf[1, :t], wc[name][0, :t]), name
            assert not buf[1, t:].any() and not buf[0].any(), name
    assert not cache["pos"].any()            # pos stays parked
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=TOL)


def test_prefill_chunk_reuses_a_stale_lane(setup):
    """One lane serves prompts of every length in turn, never reset: each
    prompt's final logits equal its whole prefill's (the stale rows of the
    one before are masked to exact zeros), and without the head the hidden
    row is returned."""
    cfg, tparams = setup[1], setup[3]
    lane = init_lane(cfg, MAX_LEN, 8, device="cpu")
    for t in (19, 5, 8, 11):
        toks = _prompt(cfg, t, seed=t)
        want, _ = prefill(cfg, tparams, {"tokens": torch.from_numpy(
            toks[None]).long()}, MAX_LEN, "nxfp4")
        cache = init_cache(cfg, 2, MAX_LEN, "nxfp4", device="cpu")
        for chunk, off, n in _chunks(toks, 8):
            final = off + n >= t
            out, cache, lane = prefill_chunk(
                cfg, tparams, torch.from_numpy(chunk), cache, 0, off, n,
                lane, "nxfp4", with_head=final)
            assert out.shape == ((1, cfg.vocab) if final
                                 else (1, cfg.d_model))
        assert torch.equal(out, want), t


def test_prefill_chunk_refusals(setup):
    cfg, tparams = setup[1], setup[3]
    cache = init_cache(cfg, 1, 16, None, device="cpu")
    lane = init_lane(cfg, 16, 4, device="cpu")
    with pytest.raises(ValueError, match="one \\(1, P\\) chunk"):
        prefill_chunk(cfg, tparams, torch.zeros((2, 4), dtype=torch.long),
                      cache, 0, 0, 4, lane, None)
    with pytest.raises(ValueError, match="p_chunk"):
        init_lane(cfg, 16, 0, device="cpu")


# ---------------------------------------------------------------------------
# the chunked engine: every stream its solo stream, bit for bit
# ---------------------------------------------------------------------------

def _engine(setup, fmt, **kw):
    cfg, params = setup[1], setup[3]
    kw = {"n_slots": 2, "max_len": MAX_LEN, "chunk": 4,
          "prefill_mode": "chunked", **kw}
    return ContinuousEngine(cfg, params, QuantPolicy(fmt, fmt), device="cpu",
                            **kw)


def _solo(setup, fmt, req):
    """The request served alone by the port's host loop (once a process
    per request, format and params)."""
    return solo_stream(setup[1], setup[3], QuantPolicy(fmt, fmt), req,
                       MAX_LEN)


def _assert_solo(setup, fmt, reqs, results):
    assert sorted(r.uid for r in results) == sorted(r.uid for r in reqs)
    by_uid = {r.uid: r for r in reqs}
    for r in results:
        solo = _solo(setup, fmt, by_uid[r.uid])
        n = int(solo.n_generated[0])
        assert r.n_generated == n and r.ok
        np.testing.assert_array_equal(r.tokens, solo.tokens[0, :n],
                                      err_msg=f"uid={r.uid}")


@pytest.mark.parametrize("arch,fmt,p_chunk", [
    pytest.param("llama3_8b", None, 4, id="None-4"),
    pytest.param("llama3_8b", "nxfp4", 16, id="nxfp4-16"),
    # the sliding-window ring: a 41-token prompt wraps the live cache in
    # prefill, beside a 17-token one (two and three lane chunks)
    pytest.param("h2o_danube_3_4b", "nxfp4", 16, id="danube-nxfp4-16"),
    # the hybrid and attention-free families (the reference's rows)
    pytest.param("hymba_1_5b", "nxfp4", 16, id="hymba-nxfp4-16"),
    pytest.param("falcon_mamba_7b", None, 16, id="falcon-None-16")])
def test_chunked_engine_matches_solo(arch, fmt, p_chunk):
    """Greedy, through the full lane: prompts divisible and not, one to
    three chunks, admitted into live decode traffic (2 slots)."""
    setup = _setup(arch)
    cfg = setup[1]
    eng = _engine(setup, fmt, p_chunk=p_chunk)
    lens = [8, 3 * p_chunk - 7, 8, 2 * p_chunk, p_chunk + 1]
    news = [5, 11, 3, 8, 6]
    if cfg.sliding_window:
        lens, news = [3 * p_chunk - 7, p_chunk + 1], [6, 4]
    reqs = [Request(uid=i, tokens=_prompt(cfg, t, seed=i), max_new=m)
            for i, (t, m) in enumerate(zip(lens, news))]
    results = eng.serve(reqs)
    assert all(r.n_generated == reqs[r.uid].max_new for r in results)
    _assert_solo(setup, fmt, reqs, results)
    assert eng.lane_chunks == sum(-(-t // p_chunk) for t in lens)
    assert len(eng.lane_seconds) == eng.lane_chunks
    assert eng.replays == eng.lane_replays == 0    # the CPU runs eagerly
    assert eng.admit_seconds == []


@pytest.mark.parametrize("fmt", [None, "nxfp4"])
def test_chunked_engine_seeded_sampling_and_stop(setup, fmt):
    """The lane's first token is drawn as a whole admission draws it (the
    slot's generator re-seeded with the request's seed), and a stop token
    still ends its stream."""
    cfg = setup[1]
    probe = Request(uid=0, tokens=_prompt(cfg, 11), max_new=9)
    stop = int(_solo(setup, fmt, probe).tokens[0, 3])
    reqs = [Request(uid=0, tokens=_prompt(cfg, 11), max_new=9,
                    stop_token=stop),
            Request(uid=1, tokens=_prompt(cfg, 18, seed=5), max_new=7,
                    temperature=1.3, seed=17),
            Request(uid=2, tokens=_prompt(cfg, 9, seed=6), max_new=6,
                    temperature=0.7, seed=3)]
    eng = _engine(setup, fmt, p_chunk=8)
    results = eng.serve(reqs)
    _assert_solo(setup, fmt, reqs, results)
    assert {r.uid: r for r in results}[0].tokens[-1] == stop


def test_chunked_engine_with_spf_policy_matches_solo(setup):
    """Policies only reorder admission: the streams stay their solo
    streams under shortest-prompt-first on the lane."""
    cfg = setup[1]
    eng = _engine(setup, None, p_chunk=8,
                  admission_policy=ShortestPromptFirst())
    reqs = [Request(uid=i, tokens=_prompt(cfg, t, seed=i), max_new=m)
            for i, (t, m) in enumerate([(20, 4), (5, 6), (13, 3), (9, 5)])]
    results = eng.serve(reqs)
    _assert_solo(setup, None, reqs, results)


def test_chunked_engine_matches_whole_engine(setup):
    """The two admission modes serve the same staggered requests into the
    same streams, and the lane bounds the stall behind a decode chunk to
    one lane chunk."""
    cfg = setup[1]
    reqs = [Request(uid=i, tokens=_prompt(cfg, t, seed=i), max_new=m,
                    arrival_time=0.0 if i < 2 else 0.01 * i)
            for i, (t, m) in enumerate([(30, 6), (12, 9), (25, 4), (7, 7)])]
    out = {}
    for mode in ("whole", "chunked"):
        eng = _engine(setup, "nxfp4", prefill_mode=mode, p_chunk=8)
        out[mode] = {r.uid: r for r in eng.serve(reqs)}
        if mode == "chunked":
            assert len(eng.stall_seconds) <= eng.chunks
            assert all(s in eng.lane_seconds for s in eng.stall_seconds
                       if s > 0)
    for uid in out["whole"]:
        np.testing.assert_array_equal(out["whole"][uid].tokens,
                                      out["chunked"][uid].tokens)


def test_chunked_engine_events(setup):
    """A lane admission logs prefill-start (with its chunk count) and
    prefill-done, then finish."""
    cfg = setup[1]
    msgs = []
    handler = logging.Handler()
    handler.emit = lambda rec: msgs.append(rec.getMessage())
    log = logging.getLogger("repro_torch.serving.scheduler")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        eng = _engine(setup, None, p_chunk=4)
        eng.serve([Request(uid=7, tokens=_prompt(cfg, 10), max_new=3)])
    finally:
        log.removeHandler(handler)
    evs = [e for e in map(events.parse_event, msgs) if e]
    assert [e["event"] for e in evs] == ["prefill-start", "prefill-done",
                                         "finish"]
    assert evs[0]["chunks"] == 3 and evs[2]["status"] == "OK"


def test_scheduler_tracks_phases():
    """Admission marks a slot DECODING; the lane marks it PREFILLING until
    its first token exists; release forgets it (as the reference's)."""
    sched = SlotScheduler(1, policy=ShortestPromptFirst())
    for uid, t in ((0, 32), (1, 8)):
        sched.submit(Request(uid=uid, tokens=np.zeros((t,), np.int32),
                             max_new=1))
    slot, req = sched.next_admission(now=1.0)
    assert req.uid == 1 and sched.phase[slot] == "DECODING"
    sched.mark_prefilling(slot)
    assert sched.phase[slot] == "PREFILLING"
    sched.mark_decoding(slot)
    assert sched.phase[slot] == "DECODING"
    sched.release(slot)
    assert slot not in sched.phase
    assert sched.next_admission(now=1.0)[1].uid == 0


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_chunked_rejects_requests_beyond_the_cache_and_lane(setup):
    """A prompt and budget past ``max_len`` fail at submit; the lane's
    scratch covers every prompt the cache takes."""
    cfg = setup[1]
    eng = _engine(setup, None, p_chunk=24, max_len=40)
    assert eng._lane_rows == 48
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.serve([Request(uid=0, tokens=np.zeros((38,), np.int32),
                           max_new=4)])
    eng._check_request(Request(uid=1, tokens=np.zeros((36,), np.int32),
                               max_new=4))
    eng._lane_rows = 32                 # a lane shorter than the prompt
    with pytest.raises(ValueError, match="lane scratch"):
        eng._check_request(Request(uid=2, tokens=np.zeros((36,), np.int32),
                                   max_new=4))
    assert cfg.family == "dense"


@pytest.mark.parametrize("kw,err,match", [
    (dict(p_chunk=0), ValueError, "p_chunk"),
    (dict(p_chunk=80), ValueError, "max_len"),
    # "auto" is served now (tests/test_torch_shedding.py): the case keeps
    # the id it had when "auto" raised NotImplementedError, and holds
    # auto's refusal of candidate widths below 1
    pytest.param(dict(p_chunk="auto", p_chunk_candidates=(0, -16)),
                 ValueError, "no candidate",
                 id="kw2-NotImplementedError-auto"),
    (dict(prefill_mode="lanes"), ValueError, "prefill_mode"),
])
def test_chunked_rejects_bad_settings(setup, kw, err, match):
    with pytest.raises(err, match=match):
        _engine(setup, None, **kw)
