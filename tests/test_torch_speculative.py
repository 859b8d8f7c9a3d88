"""Self-speculative decoding in the port (``serving/speculative.py``,
``models.lm.draft_loop``/``verify_step``/``commit_verify``,
``ContinuousEngine(speculative=)``) on the CPU, smoke configs.

  * ``verify_step`` + ``commit_verify`` against Q sequential
    ``decode_step`` calls of the port, bit for bit: logits, and the whole
    cache tree after a commit of n rows (uniform and ragged), on the
    reference test's five parameters. Its logits against the JAX
    ``decode_step``'s within the model tolerance (the JAX ``verify_step``
    fails its own oracle on this tree, ROADMAP C2: no oracle).
  * ``draft_loop`` leaves the cache as it found it, bit for bit.
  * ``accept_greedy``, ``mask_round_emissions``, ``pack_emissions`` and
    ``AdaptiveK`` bitwise the JAX functions on seeded inputs;
    ``accept_residual``'s emitted token follows the target softmax
    (chi-square).
  * The speculative engine's greedy streams bitwise the plain engine's on
    the reference test's rows and more; one row bitwise the JAX plain
    engine's; stop tokens, self-reproducing sampled requests, and the
    refusals.
"""
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.serving import scheduler as jsched
from repro.serving import speculative as jspec
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.models import (commit_verify, decode_step, draft_loop,
                                init_params, prefill, verify_step)
from repro_torch.serving import (ContinuousEngine, Request,
                                 SpeculativeConfig, TieredContinuousEngine,
                                 default_tiers)
from repro_torch.serving import speculative as spec
from repro_torch.serving.events import parse_event

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

TOL = 1e-2
B, Q = 4, 5
MAX_LEN = 64

# the reference test's parameters (tests/test_speculative.py:53-59)
VERIFY_CASES = [
    pytest.param("llama3_8b", None, False, id="llama-dense"),
    pytest.param("llama3_8b", "nxfp4", False, id="llama-nxfp4"),
    pytest.param("h2o_danube_3_4b", "nxfp4", True, id="danube-ring"),
    pytest.param("hymba_1_5b", "nxfp4", False, id="hymba-nxfp4"),
    pytest.param("falcon_mamba_7b", None, False, id="falcon-dense")]


@functools.lru_cache(maxsize=None)
def _jax_setup(arch):
    """The reference's smoke params of ``arch`` and the port's copy."""
    jcfg = jget_smoke_config(arch)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, get_smoke_config(arch), jparams, tparams


def _clone(cache):
    return {"pos": cache["pos"].clone(),
            "layers": [{k: v.clone() for k, v in lc.items()}
                       for lc in cache["layers"]]}


def _leaves(cache):
    yield "pos", cache["pos"]
    for li, lc in enumerate(cache["layers"]):
        for name in sorted(lc):
            yield f"layer {li} {name}", lc[name]


def _assert_same_cache(got, want, rows=slice(None), what=""):
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a[rows], b[rows]), f"{what} {path}"


@functools.lru_cache(maxsize=None)
def _verify_case(arch, kv, wrap):
    """A prefilled (B, plen) cache, Q candidates a slot, and the port's Q
    sequential decode steps from it: their logits (B, Q, V) and the cache
    after each step; also the JAX side's Q sequential decode logits."""
    jcfg, cfg, jparams, tparams = _jax_setup(arch)
    rng = np.random.default_rng(1)
    plen = 2 * cfg.sliding_window + 8 if wrap else 16
    toks = rng.integers(0, cfg.vocab, (B, plen)).astype(np.int32)
    cands = rng.integers(0, cfg.vocab, (B, Q)).astype(np.int32)
    _, cache = prefill(cfg, tparams, {"tokens": torch.from_numpy(toks)},
                       96, kv)
    seq, logits, after = _clone(cache), [], {}
    for i in range(Q):
        lg, seq = decode_step(cfg, tparams, torch.from_numpy(cands[:, i:i + 1]),
                              seq, kv)
        logits.append(lg)
        after[i + 1] = _clone(seq)
    _, jc = jax.jit(functools.partial(jprefill, jcfg, max_len=96,
                                      kv_fmt=kv))(jparams,
                                                  {"tokens": jnp.asarray(toks)})
    jstep = jax.jit(functools.partial(jdecode_step, jcfg, kv_fmt=kv))
    jlogits = []
    for i in range(Q):
        jl, jc = jstep(jparams, jnp.asarray(cands[:, i:i + 1]), jc)
        jlogits.append(np.asarray(jl))
    return (cfg, tparams, cache, torch.from_numpy(cands),
            torch.stack(logits, 1), after, np.stack(jlogits, 1))


# ---------------------------------------------------------------------------
# the model layer: verify + commit == Q sequential decode steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kv,wrap", VERIFY_CASES)
def test_verify_commit_match_sequential_decode(arch, kv, wrap):
    """One batched verify over Q candidate rows: logits bitwise the port's
    Q sequential decode steps (and within 1e-2 of the JAX decode's), and a
    commit of n rows (1, 3, Q, ragged [1, 2, Q, 3]) leaves the whole cache
    tree of n sequential steps, rows past ``pos`` included."""
    cfg, params, cache, cands, seq_logits, after, jlogits = \
        _verify_case(arch, kv, wrap)
    work = _clone(cache)
    vlogits, pending = verify_step(cfg, params, cands, work, kv)
    assert torch.equal(vlogits, seq_logits)
    np.testing.assert_allclose(vlogits.numpy(), jlogits, rtol=0, atol=TOL)
    for n in (1, 3, Q):
        got = commit_verify(cfg, _clone(work), pending,
                            torch.full((B,), n), kv)
        _assert_same_cache(got, after[n], what=f"n={n}")
    ragged = [1, 2, Q, 3]
    got = commit_verify(cfg, _clone(work), pending, torch.tensor(ragged), kv)
    assert got["pos"].tolist() == (cache["pos"] + torch.tensor(ragged)
                                   ).tolist()
    for b, n in enumerate(ragged):
        _assert_same_cache(got, after[n], rows=b, what=f"slot {b} n={n}")


@pytest.mark.parametrize("arch,kv,wrap", VERIFY_CASES)
def test_draft_loop_leaves_the_cache(arch, kv, wrap):
    """Q draft steps write their rows and state in place and put them
    back: the cache tree is bitwise the one the draft started from, and
    the candidates are the sequential decode's greedy successors."""
    cfg, params, cache, cands, seq_logits, _, _ = _verify_case(arch, kv,
                                                               wrap)
    work = _clone(cache)
    got, dlogits = draft_loop(cfg, params, cands[:, 0], work, Q, kv,
                              lambda lg: torch.argmax(lg, dim=-1),
                              with_logits=True)
    _assert_same_cache(work, cache)
    assert got.shape == (B, Q) and dlogits.shape == (Q, B, cfg.vocab)
    # teacher-forced only at step 0: the first candidate is the argmax of
    # the first sequential step's logits
    assert torch.equal(got[:, 0], seq_logits[:, 0].argmax(-1).int())


# ---------------------------------------------------------------------------
# the round's tensor functions against the reference's
# ---------------------------------------------------------------------------

def _round_inputs(seed, b=6, k=4, v=7):
    """Seeded logits with ties (few distinct values: first-max argmax),
    candidates that often agree, ragged ``spec_k``."""
    rng = np.random.default_rng(seed)
    vl = rng.integers(0, 3, (b, k + 1, v)).astype(np.float32)
    succ = vl.argmax(-1)
    cands = np.where(rng.random((b, k)) < 0.7, succ[:, :k],
                     rng.integers(0, v, (b, k))).astype(np.int32)
    tok = rng.integers(0, v, (b,)).astype(np.int32)
    spec_k = rng.integers(1, k + 2, (b,)).astype(np.int32)
    return tok, cands, vl, spec_k


@pytest.mark.parametrize("seed", range(4))
def test_accept_greedy_matches_reference(seed):
    tok, cands, vl, spec_k = _round_inputs(seed)
    want = jspec.accept_greedy(jnp.asarray(tok), jnp.asarray(cands),
                               jnp.asarray(vl), jnp.asarray(spec_k))
    got = spec.accept_greedy(*map(torch.from_numpy, (tok, cands, vl,
                                                     spec_k)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(4))
def test_mask_round_emissions_matches_reference(seed):
    """Ragged accepts, stop hits inside and past the accepted prefix,
    budgets that end mid-round, slots done at entry."""
    rng = np.random.default_rng(seed)
    b, q = 8, 5
    toks = rng.integers(0, 6, (b, q)).astype(np.int32)
    n_raw = rng.integers(1, q + 1, (b,)).astype(np.int32)
    done = rng.random(b) < 0.2
    n_gen = rng.integers(0, 6, (b,)).astype(np.int32)
    stop = np.where(rng.random(b) < 0.6, rng.integers(0, 6, (b,)),
                    -1).astype(np.int32)
    max_new = (n_gen + rng.integers(0, q + 2, (b,))).astype(np.int32)
    args = (toks, n_raw, done, n_gen, stop, max_new)
    want = jspec.mask_round_emissions(*map(jnp.asarray, args))
    got = spec.mask_round_emissions(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
def test_pack_emissions_matches_reference(seed):
    rng = np.random.default_rng(seed)
    r, b, q = 3, 5, 4
    n_r = rng.integers(0, q + 1, (r, b)).astype(np.int32)
    toks = rng.integers(1, 50, (r, b, q)).astype(np.int32)
    toks = np.where(np.arange(q)[None, None] < n_r[:, :, None], toks, 0)
    want = np.asarray(jspec.pack_emissions(jnp.asarray(toks),
                                           jnp.asarray(n_r)))
    got = spec.pack_emissions(torch.from_numpy(toks), torch.from_numpy(n_r))
    np.testing.assert_array_equal(got.numpy(), want)


def test_adaptive_k_matches_reference():
    """The controller on a seeded stream of chunks: k and the EMA after
    every update, ``round_k`` and ``arm`` as the reference's."""
    cfg = dict(k=8, adaptive=True, k_min=1, ema=0.5, lower=0.35, upper=0.75)
    mine = spec.AdaptiveK(spec.SpeculativeConfig(**cfg), 4)
    ref = jspec.AdaptiveK(jspec.SpeculativeConfig(**cfg), 4)
    rng = np.random.default_rng(3)
    for step in range(40):
        live = rng.random(4) < 0.8
        off = rng.integers(0, 9, (4,))
        acc = (off * rng.random(4) ** (1 + step % 3)).astype(np.int64)
        mine.update(live, acc, off)
        ref.update(live, acc, off)
        np.testing.assert_array_equal(mine.k, ref.k)
        np.testing.assert_array_equal(mine.ema, ref.ema)
        assert mine.round_k(live) == ref.round_k(live)
        if step % 7 == 0:
            mine.arm(step % 4, k=step % 5)
            ref.arm(step % 4, k=step % 5)


# ---------------------------------------------------------------------------
# residual rejection: exact acceptance and the target distribution
# ---------------------------------------------------------------------------

def _gens(n, seed):
    return [torch.Generator().manual_seed(seed + i) for i in range(n)]


def test_accept_residual_accepts_all_when_draft_is_target():
    """pd == pt: every candidate is accepted (u * p <= p), the bonus
    token is drawn from the last row."""
    rng = np.random.default_rng(0)
    b, k, v = 16, 4, 8
    vl = torch.from_numpy(rng.standard_normal((b, k + 1, v)).astype(
        np.float32))
    cands = torch.from_numpy(rng.integers(0, v, (b, k)).astype(np.int32))
    a, out, nxt = spec.accept_residual(
        torch.zeros(b, dtype=torch.int32), cands, vl,
        vl[:, :k].transpose(0, 1), torch.ones(b), _gens(b, 0),
        torch.full((b,), k, dtype=torch.int32))
    assert (a == k).all()
    assert torch.equal(out[:, 1:], cands)
    assert ((nxt >= 0) & (nxt < v)).all()


def test_accept_residual_follows_the_target_distribution():
    """k 1, V 8: candidates drawn from the draft softmax, then the token
    the round emits after ``tok`` (the candidate if accepted, else the
    residual draw) over 24,000 seeded draws against the target softmax:
    chi-square p > 1e-3."""
    v, b, reps = 8, 2000, 12
    rng = np.random.default_rng(7)
    vrow = rng.standard_normal(v).astype(np.float32) * 1.5
    drow = vrow + rng.standard_normal(v).astype(np.float32)
    temp = 1.3
    pt = torch.softmax(torch.from_numpy(vrow) / temp, -1).double().numpy()
    pd = torch.softmax(torch.from_numpy(drow) / temp, -1).double().numpy()
    vl = torch.from_numpy(np.broadcast_to(
        np.stack([vrow, vrow]), (b, 2, v)).copy())
    dl = torch.from_numpy(np.broadcast_to(drow, (1, b, v)).copy())
    counts = np.zeros(v, np.int64)
    for r in range(reps):
        cands = rng.choice(v, size=(b, 1), p=pd / pd.sum()).astype(np.int32)
        a, out, nxt = spec.accept_residual(
            torch.zeros(b, dtype=torch.int32), torch.from_numpy(cands), vl,
            dl, torch.full((b,), temp), _gens(b, 1000 * r),
            torch.ones(b, dtype=torch.int32))
        emitted = torch.where(a > 0, out[:, 1], nxt).numpy()
        counts += np.bincount(emitted, minlength=v)
    assert counts.sum() == b * reps
    assert stats.chisquare(counts, pt / pt.sum() * counts.sum()).pvalue > 1e-3


# ---------------------------------------------------------------------------
# the engine: speculative greedy == plain, bit for bit
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_params(arch):
    cfg = get_smoke_config(arch)
    return cfg, init_params(cfg, seed=0, device="cpu")


def _prompts(cfg, n, t=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
            for _ in range(n)]


def _mixed_reqs(cfg):
    return [Request(uid=i, tokens=p, max_new=m)
            for i, (p, m) in enumerate(zip(_prompts(cfg, 5),
                                           [5, 11, 3, 8, 14]))]


def _serve_pair(arch, wfmt, kvfmt, spec_cfg, reqs_fn, chunk=4, **kw):
    """The plain engine's and the speculative engine's streams of the same
    requests, asserted bitwise equal. Returns the speculative engine."""
    cfg, params = _port_params(arch)
    policy = QuantPolicy(wfmt, kvfmt)
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=chunk, device="cpu", **kw)
    ref = {r.uid: r for r in ContinuousEngine(cfg, params, policy,
                                              **kw).serve(reqs_fn(cfg))}
    eng = ContinuousEngine(cfg, params, policy, speculative=spec_cfg, **kw)
    got = {r.uid: r for r in eng.serve(reqs_fn(cfg))}
    assert got.keys() == ref.keys()
    for uid in ref:
        assert got[uid].n_generated == ref[uid].n_generated, uid
        np.testing.assert_array_equal(got[uid].tokens, ref[uid].tokens,
                                      err_msg=f"{arch} uid={uid}")
    return eng


@pytest.mark.parametrize("arch,wfmt,kvfmt,draft", [
    ("llama3_8b", "nxfp4", "nxfp4", "recycled"),
    ("llama3_8b", None, None, "nxfp4"),
    ("hymba_1_5b", "nxfp4", "nxfp4", "recycled"),
    ("falcon_mamba_7b", "nxfp4", None, "recycled")])
def test_speculative_greedy_matches_plain(arch, wfmt, kvfmt, draft):
    """Staggered admissions, slot reuse, ragged max_new (the reference
    test's rows). A recycled draft accepts every candidate on the CPU:
    its bf16 product and the nxfp4 plain product are f32 sums of the same
    bf16 values in the same order."""
    eng = _serve_pair(arch, wfmt, kvfmt,
                      SpeculativeConfig(k=4, draft=draft), _mixed_reqs)
    st = eng.spec_stats()
    assert st["offered"] > 0
    if draft == "recycled":
        assert st["accept_rate"] == 1.0
    else:
        assert 0.0 < st["accept_rate"] <= 1.0


def test_speculative_k1():
    """k 1: one draft and a 2-row verify a round, still bitwise."""
    eng = _serve_pair("llama3_8b", "nxfp4", None, SpeculativeConfig(k=1),
                      _mixed_reqs)
    assert eng.spec_stats()["offered"] > 0


def test_speculative_adaptive_k_moves_and_matches_plain(caplog):
    """A 3-bit draft against an nxfp4 target with a controller that backs
    off at the first rejection: a slot's k moves (a ``spec-k`` event,
    rounds of another k), the streams stay the plain engine's."""
    caplog.set_level(logging.INFO, logger="repro_torch.serving.scheduler")
    eng = _serve_pair("llama3_8b", "nxfp4", "nxfp4",
                      SpeculativeConfig(k=4, draft="nxfp3", lower=0.99,
                                        upper=0.999), _mixed_reqs)
    assert eng.spec_stats()["accept_rate"] < 1.0
    moves = [e for e in map(parse_event, caplog.messages)
             if e and e["event"] == "spec-k"]
    assert any(e["k"] < 4 for e in moves)


def test_speculative_ring_wrap_matches_plain():
    """Danube's 32-row ring wrapped mid-speculation by a 40-token
    generation (an nxfp6 format draft, chunk 8): the verify writes
    candidate rows into the ring and the commit puts back the rejected
    rows' old tokens."""
    def reqs(cfg):
        return [Request(uid=0, tokens=_prompts(cfg, 1)[0], max_new=40),
                Request(uid=1, tokens=_prompts(cfg, 1, seed=1)[0],
                        max_new=6),
                Request(uid=2, tokens=_prompts(cfg, 1, seed=2)[0],
                        max_new=6)]
    _serve_pair("h2o_danube_3_4b", "nxfp4", "nxfp4",
                SpeculativeConfig(k=4, draft="nxfp6"), reqs, chunk=8)


def test_speculative_hybrid_chunked_matches_plain():
    """Hymba through the chunked lane at P = ssm_chunk (16): prompts of
    several lane chunks, the lane's recurrent carry, then speculation."""
    def reqs(cfg):
        return [Request(uid=i, tokens=_prompts(cfg, 1, t, seed=i)[0],
                        max_new=m)
                for i, (t, m) in enumerate([(40, 9), (17, 12), (8, 5)])]
    cfg, _ = _port_params("hymba_1_5b")
    _serve_pair("hymba_1_5b", "nxfp4", "nxfp4", SpeculativeConfig(k=3),
                reqs, prefill_mode="chunked", p_chunk=cfg.ssm_chunk)


def test_speculative_fills_max_len():
    """prompt + max_new == max_len: the verify's rows past the cache end
    are neither written nor put back, and the stream runs to its last
    row."""
    def reqs(cfg):
        return [Request(uid=0, tokens=_prompts(cfg, 1, 40)[0],
                        max_new=MAX_LEN - 40),
                Request(uid=1, tokens=_prompts(cfg, 1, seed=3)[0],
                        max_new=7)]
    eng = _serve_pair("llama3_8b", "nxfp4", "nxfp4", SpeculativeConfig(k=4),
                      reqs)
    assert eng.spec_stats()["offered"] > 0


def test_speculative_matches_jax_plain_engine():
    """The slice as a whole: the port's speculative engine (nxfp4 weights
    and KV, recycled draft) on the reference's smoke weights emits the
    JAX plain ``ContinuousEngine``'s greedy streams, bit for bit."""
    jcfg, cfg, jparams, tparams = _jax_setup("llama3_8b")
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=4)
    want = {r.uid: np.asarray(r.tokens) for r in jsched.ContinuousEngine(
        jcfg, jparams, JQuantPolicy("nxfp4", "nxfp4"), warn_compile=False,
        **kw).serve([jsched.Request(uid=r.uid, tokens=r.tokens,
                                    max_new=r.max_new)
                     for r in _mixed_reqs(cfg)])}
    eng = ContinuousEngine(cfg, tparams, QuantPolicy("nxfp4", "nxfp4"),
                           speculative=SpeculativeConfig(k=4), device="cpu",
                           **kw)
    got = {r.uid: r.tokens for r in eng.serve(_mixed_reqs(cfg))}
    assert got.keys() == want.keys()
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid={uid}")


def test_speculative_stop_token_and_seeded_sampling():
    """A greedy row with a stop token ends where the plain engine's does,
    bitwise; seeded sampled rows (residual rejection from each slot's own
    generator) reproduce themselves run to run and stay in the vocab."""
    cfg, params = _port_params("llama3_8b")
    policy = QuantPolicy("nxfp4", None)
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=4, device="cpu")
    probe = ContinuousEngine(cfg, params, policy, **kw).serve(
        [Request(uid=0, tokens=_prompts(cfg, 1)[0], max_new=9)])
    stop = int(probe[0].tokens[3])

    def reqs():
        return [Request(uid=0, tokens=_prompts(cfg, 1)[0], max_new=9,
                        stop_token=stop),
                Request(uid=1, tokens=_prompts(cfg, 1, seed=5)[0],
                        max_new=7, temperature=1.3, seed=17),
                Request(uid=2, tokens=_prompts(cfg, 1, seed=6)[0],
                        max_new=7, temperature=0.8, seed=23)]

    def spec_serve():
        eng = ContinuousEngine(cfg, params, policy,
                               speculative=SpeculativeConfig(k=4), **kw)
        return {r.uid: r for r in eng.serve(reqs())}

    a, b = spec_serve(), spec_serve()
    plain = {r.uid: r for r in ContinuousEngine(cfg, params, policy,
                                                **kw).serve(reqs())}
    assert a[0].n_generated == plain[0].n_generated
    np.testing.assert_array_equal(a[0].tokens, plain[0].tokens)
    assert a[0].tokens[-1] == stop
    for uid in (1, 2):
        assert a[uid].n_generated == b[uid].n_generated == 7
        np.testing.assert_array_equal(a[uid].tokens, b[uid].tokens)
        assert ((a[uid].tokens >= 0) & (a[uid].tokens < cfg.vocab)).all()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_speculative_refusals():
    """A recycled draft needs cast weights; the tiered engine does not
    compose with speculation (as the reference's)."""
    cfg, params = _port_params("llama3_8b")
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=4, device="cpu",
              speculative=SpeculativeConfig(k=4))
    with pytest.raises(ValueError, match="recycled"):
        ContinuousEngine(cfg, params, QuantPolicy(None, None), **kw)
    with pytest.raises(ValueError, match="speculative"):
        TieredContinuousEngine(cfg, params, default_tiers(), **kw)
