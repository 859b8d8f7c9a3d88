"""Faults, quarantine and the KV/SSM canaries in the torch port's serving
engines, on the CPU at smoke size.

* Against the reference, bit for bit: ``Fault`` validation, ``FaultPlan``
  seeding, one-shot firing and ``apply_arrivals``; ``flip_kv_bytes`` on
  a packed cache (the same bytes flipped, every buffer edited in place)
  and its refusals; ``kv_slot_checksum`` (packed and dense K/V, horizon
  None, scalar or (B,), a wrapped ring) and ``ssm_state_checksum``
  (Falcon's and Hymba's ``h``/``conv``); one faulted serve against the
  JAX ``ContinuousEngine``: statuses, greedy streams and the ``fault``/
  ``quarantine``/``requeue`` records, then ``restore_from_journal`` on
  both logs.
* Against the port's own fault-free serve or solo stream: only the victim
  leaves OK, with its pre-fault prefix; a retry heals to the full solo
  stream (greedy and sampled, whole and chunked); the kv_flip canary; a
  delay; no plan and a spent plan are no-ops; the SSM canary
  (``ssm_integrity``) on Falcon and Hymba; the speculative, tiered and
  paged engines under ``nan_logits``; the refusals.
"""
import dataclasses
import functools
import logging
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.models import init_params as jinit_params
from repro.models import kvcache as jkv
from repro.serving import events as jevents
from repro.serving import faults as jfaults
from repro.serving import scheduler as jsched
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.kernels.build import bit_view
from repro_torch.models import init_cache, init_paged_cache, init_params
from repro_torch.models import kvcache
from repro_torch.serving import (ContinuousEngine, Fault, FaultPlan,
                                 PagedContinuousEngine, Request,
                                 SpeculativeConfig, Status,
                                 TieredContinuousEngine, TierSpec, events,
                                 flip_kv_bytes)

import _torch_helpers  # noqa: F401  (one intra-op thread a process)
from _torch_helpers import solo_stream

MAX_LEN = 64


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = get_smoke_config(arch)
    return cfg, init_params(cfg, 0, device="cpu")


def _prompts(cfg, n, t=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
            for _ in range(n)]


def _reqs(cfg, max_news, cls=Request, **kw):
    return [cls(uid=i, tokens=p, max_new=m, **kw)
            for i, (p, m) in enumerate(zip(_prompts(cfg, len(max_news)),
                                           max_news))]


def _engine(arch, fmt=None, cls=ContinuousEngine, **kw):
    cfg, params = _model(arch)
    kw = {"n_slots": 2, "max_len": MAX_LEN, "chunk": 4, **kw}
    return cls(cfg, params, QuantPolicy(None, fmt), device="cpu", **kw)


def _by_uid(results):
    return {r.uid: r for r in results}


def _captured(name, fn):
    """``fn()`` with the INFO records of logger ``name`` captured."""
    msgs = []
    h = logging.Handler()
    h.emit = lambda rec: msgs.append(rec.getMessage())
    log = logging.getLogger(name)
    old = log.level
    log.addHandler(h)
    log.setLevel(logging.INFO)
    try:
        return fn(), msgs
    finally:
        log.removeHandler(h)
        log.setLevel(old)


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("raise", str(e))


# ---------------------------------------------------------------------------
# FaultPlan against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(kind="cosmic_ray"), dict(kind="nan_logits"), dict(kind="kv_flip"),
    dict(kind="shard_down"), dict(kind="nan_logits", uid=3, chunk=2),
    dict(kind="kv_flip", uid=1, n_bytes=4), dict(kind="delay", seconds=0.5),
    dict(kind="shard_down", shard=1), dict(kind="burst", t0=1.0, span=2.0)])
def test_fault_validation_matches_reference(kw):
    got = _outcome(lambda: dataclasses.astuple(Fault(**kw)))
    want = _outcome(lambda: dataclasses.astuple(jfaults.Fault(**kw)))
    assert got == want


def _plan_pair(seed):
    faults = [dict(kind="kv_flip", chunk=2, uid=1),
              dict(kind="delay", chunk=0, seconds=0.1),
              dict(kind="nan_logits", chunk=1, uid=0),
              dict(kind="burst", t0=1.0, span=0.5),
              dict(kind="kv_flip", chunk=0, uid=2, n_bytes=3)]
    return (FaultPlan([Fault(**f) for f in faults], seed=seed),
            jfaults.FaultPlan([jfaults.Fault(**f) for f in faults],
                              seed=seed))


@pytest.mark.parametrize("seed", [0, 7])
def test_fault_plan_seeded_one_shot_matches_reference(seed):
    """``pending``, ``fire``, ``reset`` and the per-fault generators draw
    as the reference's."""
    port, ref = _plan_pair(seed)

    def pend(plan):
        return [(i, dataclasses.astuple(f)) for kind in jfaults.KINDS
                for ci in (0, 1, 2, 5) for i, f in plan.pending(kind, ci)]

    assert pend(port) == pend(ref)
    for i in (0, 2, 4):
        np.testing.assert_array_equal(port.rng(i).integers(0, 2**31, 8),
                                      ref.rng(i).integers(0, 2**31, 8))
        port.fire(i)
        ref.fire(i)
        assert pend(port) == pend(ref)
    port.reset()
    ref.reset()
    assert pend(port) == pend(ref)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_apply_arrivals_matches_reference(seed):
    """Burst faults re-time arrivals bit for bit as the reference's, in
    order, once a serve (a second call without ``reset`` is a no-op)."""
    rng = np.random.default_rng(seed)
    times = rng.uniform(0, 5, 6).round(2).tolist()
    times[2] = times[4]                         # a tie keeps index order
    port, ref = _plan_pair(seed)
    mk = [dict(uid=i, tokens=np.zeros((4,), np.int32), max_new=2,
               arrival_time=t) for i, t in enumerate(times)]
    got = port.apply_arrivals([Request(**m) for m in mk])
    want = ref.apply_arrivals([jsched.Request(**m) for m in mk])
    assert [(r.uid, r.arrival_time) for r in got] == \
        [(r.uid, r.arrival_time) for r in want]
    again = port.apply_arrivals(got)
    assert [r.arrival_time for r in again] == [r.arrival_time for r in got]


def test_request_retries_round_trips():
    """``Request.retries`` is a keyword field defaulting to 0, in the
    reference's place, and survives the pickling a checkpoint does."""
    names = [f.name for f in dataclasses.fields(Request)]
    assert names == [f.name for f in dataclasses.fields(jsched.Request)]
    r = Request(uid=3, tokens=np.arange(4), max_new=2, retries=2)
    assert Request(uid=0, tokens=np.arange(4), max_new=1).retries == 0
    assert pickle.loads(pickle.dumps(r)).retries == 2
    assert Status.FAILED == jsched.Status.FAILED == "FAILED"


# ---------------------------------------------------------------------------
# flip_kv_bytes and the checksums against the reference
# ---------------------------------------------------------------------------

def _fill(cache, seed):
    """Seeded random bits in every buffer of a per-layer cache."""
    rng = np.random.default_rng(seed)
    for lc in cache["layers"]:
        for name, buf in lc.items():
            if name == "block":
                continue
            raw = bit_view(buf)
            bits = rng.integers(0, 256, raw.numel() * raw.element_size(),
                                dtype=np.uint8)
            raw.copy_(torch.from_numpy(bits).view(raw.dtype)
                      .reshape(raw.shape))
    return cache


def _np(t):
    """A port buffer as the reference's numpy dtype (bits kept)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    a = bit_view(t).numpy()
    return a.view(np.uint16) if t.dtype == torch.uint16 else a


def _stacked(cache):
    """The reference's layout of a per-layer cache: each leaf stacked over
    the layers that hold it (every layer here)."""
    names = [n for n in cache["layers"][0] if n != "block"]
    return {"pos": jnp.asarray(cache["pos"].numpy()),
            "layers": {n: jnp.asarray(np.stack([_np(lc[n])
                                                for lc in cache["layers"]]))
                       for n in names}}


def _port_bytes(cache):
    return {n: np.stack([_np(lc[n]) for lc in cache["layers"]])
            for n in cache["layers"][0]}


@pytest.mark.parametrize("seed,slot,n_rows,n_bytes",
                         [(0, 0, 5, 1), (1, 1, 64, 3), (2, 2, 17, 8)])
def test_flip_kv_bytes_matches_reference(seed, slot, n_rows, n_bytes):
    """The same plan on the same bytes flips the same bytes in both
    packages, and the port edits every buffer in place."""
    cfg = get_smoke_config("llama3_8b")
    cache = _fill(init_cache(cfg, 3, MAX_LEN, "nxfp4", device="cpu"), seed)
    ref = _stacked(cache)
    ptrs = [{n: b.data_ptr() for n, b in lc.items()}
            for lc in cache["layers"]]
    out = flip_kv_bytes(cache, slot, n_rows, np.random.default_rng(seed),
                        n_bytes=n_bytes)
    want = jfaults.flip_kv_bytes(ref, slot, n_rows,
                                 np.random.default_rng(seed),
                                 n_bytes=n_bytes)
    assert out is cache
    assert [{n: b.data_ptr() for n, b in lc.items()}
            for lc in cache["layers"]] == ptrs
    got = _port_bytes(cache)
    changed = 0
    for name, arr in want["layers"].items():
        np.testing.assert_array_equal(got[name], np.asarray(arr),
                                      err_msg=name)
        changed += int((np.asarray(arr) != np.asarray(ref["layers"][name]))
                       .sum())
    assert 1 <= changed <= n_bytes


@pytest.mark.parametrize("case", ["dense", "ssm", "paged"])
def test_flip_kv_bytes_refuses_unpacked_caches(case):
    """Dense K/V, attention-free and paged caches have no packed per-slot
    leaves: both packages raise."""
    if case == "ssm":
        cfg = get_smoke_config("falcon_mamba_7b")
        cache = init_cache(cfg, 2, MAX_LEN, None, device="cpu")
    elif case == "paged":
        cfg = get_smoke_config("llama3_8b")
        cache = init_paged_cache(cfg, 2, MAX_LEN, "nxfp4", 9, 16,
                                 device="cpu")
    else:
        cfg = get_smoke_config("llama3_8b")
        cache = init_cache(cfg, 2, MAX_LEN, None, device="cpu")
    names = {n: np.zeros((1,)) for n in cache["layers"][0]}
    for fn, c in ((flip_kv_bytes, cache),
                  (jfaults.flip_kv_bytes, {"pos": np.zeros((2,), np.int32),
                                           "layers": names})):
        with pytest.raises(ValueError, match="packed KV"):
            fn(c, 0, 4, np.random.default_rng(0))


def _checksums(cfg, cache, upto, horizon):
    got = kvcache.kv_slot_checksum(cfg, cache, torch.as_tensor(upto),
                                   horizon)
    assert got.dtype == torch.int64
    jh = horizon if horizon is None or np.isscalar(horizon) \
        else jnp.asarray(horizon)
    want = jkv.kv_slot_checksum(None, _stacked(cache),
                                jnp.asarray(upto, jnp.int32), jh)
    return got.numpy().astype(np.uint32), np.asarray(want)


@pytest.mark.parametrize("arch,fmt", [("llama3_8b", "nxfp4"),
                                      ("llama3_8b", None),
                                      ("h2o_danube_3_4b", "nxfp4"),
                                      ("hymba_1_5b", "nxfp4")])
@pytest.mark.parametrize("horizon", [None, 8, "per-slot"])
def test_kv_slot_checksum_matches_reference(arch, fmt, horizon):
    """Bit for bit the reference's uint32 canary on seeded bytes: packed
    and dense K/V, the prefix fold (horizon None) and the window-aware one
    (scalar or per-slot horizon), with slots unwrapped, at the edge and
    past a ring's rows (Danube's and Hymba's 32-row rings wrap)."""
    cfg = get_smoke_config(arch)
    cache = _fill(init_cache(cfg, 4, MAX_LEN, fmt, device="cpu"), 5)
    s = kvcache.cache_rows(cfg, MAX_LEN)
    upto = np.array([0, 9, s, s + 23 if cfg.sliding_window else s - 1])
    hz = np.array([4, 8, 31, 13]) if horizon == "per-slot" else horizon
    got, want = _checksums(cfg, cache, upto, hz)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0


def test_kv_checksum_window_aware_on_wrapped_ring():
    """The reference's ring case (``tests/test_speculative.py``): a row
    beyond the write horizon of a wrapped slot is covered, the next row the
    chunk writes is not, other slots are not touched; an unwrapped slot's
    window-aware fold is the prefix fold."""
    cfg = get_smoke_config("h2o_danube_3_4b")       # sliding_window = 32
    cache = _fill(init_cache(cfg, 2, 96, "nxfp4", device="cpu"), 9)
    w, hz = cfg.sliding_window, 8
    upto = torch.tensor([2 * w + 8, 2 * w + 8])
    base = kvcache.kv_slot_checksum(cfg, cache, upto, hz)
    ptr = int(upto[0]) % w
    leaf = cache["layers"][0]["k_packed"]

    def flipped(row):
        leaf[0, row, 0, 0, 0] ^= 1
        try:
            return kvcache.kv_slot_checksum(cfg, cache, upto, hz)
        finally:
            leaf[0, row, 0, 0, 0] ^= 1

    stable = flipped((ptr + hz) % w)
    assert stable[0] != base[0] and stable[1] == base[1]
    assert flipped(ptr)[0] == base[0]
    short = torch.tensor([16, 5])
    assert torch.equal(kvcache.kv_slot_checksum(cfg, cache, short, hz),
                       kvcache.kv_slot_checksum(cfg, cache, short))


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "hymba_1_5b",
                                  "llama3_8b"])
def test_ssm_state_checksum_matches_reference(arch):
    """Bit for bit the reference's fold of ``h`` (f32) and ``conv`` (bf16)
    over seeded bits; zeros without Mamba state."""
    cfg = get_smoke_config(arch)
    cache = _fill(init_cache(cfg, 3, MAX_LEN, None, device="cpu"), 4)
    got = kvcache.ssm_state_checksum(cfg, cache)
    want = np.asarray(jkv.ssm_state_checksum(None, _stacked(cache)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert got.any() == cfg.has_mamba


# ---------------------------------------------------------------------------
# the engines: containment against the port's own oracles
# ---------------------------------------------------------------------------

def _plan(kind="nan_logits", **kw):
    return FaultPlan(faults=(Fault(kind=kind, **kw),))


@pytest.mark.parametrize("arch,fmt,integrity",
                         [("llama3_8b", None, False),
                          ("hymba_1_5b", "nxfp4", True)])
def test_nan_fault_quarantines_victim_only(arch, fmt, integrity):
    """The victim ends FAILED with a prefix of its fault-free stream (the
    faulted chunk's tokens dropped), every other stream is the fault-free
    one bit for bit, the same plan gives the same outcome again, and the
    journal holds the fault, the quarantine and the FAILED finish."""
    cfg, _ = _model(arch)
    eng = _engine(arch, fmt, kv_integrity=integrity)
    reqs = _reqs(cfg, [6, 12, 5])
    ref = _by_uid(eng.serve(reqs))
    assert all(r.status == Status.OK for r in ref.values())
    plan = _plan(chunk=1, uid=1)
    res, msgs = _captured("repro_torch.serving", lambda: _by_uid(
        eng.serve(reqs, fault_plan=plan)))
    assert res[1].status == Status.FAILED and res[1].n_generated < 12
    np.testing.assert_array_equal(res[1].tokens,
                                  ref[1].tokens[:res[1].n_generated])
    for uid in (0, 2):
        assert res[uid].status == Status.OK
        np.testing.assert_array_equal(res[uid].tokens, ref[uid].tokens)
    again = _by_uid(eng.serve(reqs, fault_plan=plan))
    for uid in res:
        assert again[uid].status == res[uid].status
        np.testing.assert_array_equal(again[uid].tokens, res[uid].tokens)
    evs = [e for e in map(events.parse_event, msgs) if e]
    kinds = [(e["event"], e.get("uid")) for e in evs
             if e["event"] in ("fault", "quarantine", "requeue")]
    assert kinds == [("fault", 1), ("quarantine", 1)]
    assert any(e["event"] == "finish" and e["uid"] == 1
               and e["status"] == Status.FAILED for e in evs)


@pytest.mark.parametrize("mode", ["whole", "chunked"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_retry_heals_to_the_solo_stream(mode, sampled):
    """With ``retries=1`` the one-shot fault burns the budget and the
    requeued request replays from a fresh prefill: every request ends OK
    and is its solo stream bit for bit, greedy and sampled, whole and
    through the lane."""
    cfg, params = _model("llama3_8b")
    kw = dict(prefill_mode="chunked", p_chunk=4) if mode == "chunked" \
        else {}
    eng = _engine("llama3_8b", "nxfp4", **kw)
    reqs = _reqs(cfg, [6, 12, 5], retries=1)
    if sampled:
        reqs[1] = dataclasses.replace(reqs[1], temperature=0.9, seed=5)
    res, msgs = _captured("repro_torch.serving", lambda: _by_uid(
        eng.serve(reqs, fault_plan=_plan(chunk=1, uid=1))))
    policy = QuantPolicy(None, "nxfp4")
    for r in reqs:
        assert res[r.uid].status == Status.OK
        np.testing.assert_array_equal(
            res[r.uid].tokens,
            solo_stream(cfg, params, policy, r, MAX_LEN).tokens[0],
            err_msg=f"uid={r.uid}")
    evs = [e for e in map(events.parse_event, msgs) if e]
    assert [(e["event"], e["retries_left"]) for e in evs
            if e["event"] in ("quarantine", "requeue")] == \
        [("quarantine", 1), ("requeue", 0)]


def test_kv_flip_detected_by_the_canary():
    """A flip of 2 packed bytes of the victim's committed rows trips the
    K/V canary (``kv_integrity``): the victim FAILED with its prefix, the
    neighbours bitwise their fault-free streams."""
    cfg, _ = _model("llama3_8b")
    eng = _engine("llama3_8b", "nxfp4", kv_integrity=True)
    reqs = _reqs(cfg, [6, 12, 5])
    ref = _by_uid(eng.serve(reqs))
    res, msgs = _captured("repro_torch.serving", lambda: _by_uid(eng.serve(
        reqs, fault_plan=_plan("kv_flip", chunk=1, uid=1, n_bytes=2))))
    assert res[1].status == Status.FAILED
    np.testing.assert_array_equal(res[1].tokens,
                                  ref[1].tokens[:res[1].n_generated])
    for uid in (0, 2):
        assert res[uid].status == Status.OK
        np.testing.assert_array_equal(res[uid].tokens, ref[uid].tokens)
    quar = [e for e in map(events.parse_event, msgs)
            if e and e["event"] == "quarantine"]
    assert [(e["uid"], e["cause"]) for e in quar] == [(1, "kv_integrity")]


def test_delay_and_noop_plans_keep_every_stream():
    """A delay slows the serve and changes no token; no plan, a spent plan
    and a plan aimed at a uid that never comes are bitwise the plain
    serve."""
    cfg, _ = _model("llama3_8b")
    eng = _engine("llama3_8b", "nxfp4", kv_integrity=True)
    reqs = _reqs(cfg, [6, 9])
    want = {r.uid: r.tokens for r in eng.serve(reqs)}
    spent = _plan(chunk=0, uid=0)
    spent.fire(0)
    spent.reset = lambda: None                  # keep it spent
    t0 = time.time()
    delayed = eng.serve(reqs, fault_plan=_plan("delay", chunk=1,
                                               seconds=0.2, shard=0))
    assert time.time() - t0 >= 0.2
    for plan in (None, spent, _plan(chunk=0, uid=99)):
        got = {r.uid: r.tokens for r in eng.serve(reqs, fault_plan=plan)}
        for uid in want:
            np.testing.assert_array_equal(got[uid], want[uid])
    for r in delayed:
        assert r.status == Status.OK
        np.testing.assert_array_equal(r.tokens, want[r.uid])


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "hymba_1_5b"])
def test_ssm_canary_detects_idle_corruption_and_retry_heals(arch):
    """``h`` of a live slot changed between chunks (in place, from
    ``progress_cb``) is caught before the next chunk as ``ssm_integrity``;
    the retry replays the request to its solo stream, and the other
    request is its solo stream too."""
    cfg, params = _model(arch)
    eng = _engine(arch, None, kv_integrity=True)
    reqs = [Request(uid=0, tokens=_prompts(cfg, 1)[0], max_new=12,
                    retries=1),
            Request(uid=1, tokens=_prompts(cfg, 1, seed=1)[0], max_new=8)]
    seen = {"n": 0}

    def cb(engine, sched):
        if seen["n"] == 1:
            slot = next(s for s, r in sched.active.items() if r.uid == 0)
            engine.cache["layers"][0]["h"][slot] += 1.0
        seen["n"] += 1

    res, msgs = _captured("repro_torch.serving", lambda: _by_uid(
        eng.serve(reqs, progress_cb=cb)))
    quar = [e for e in map(events.parse_event, msgs)
            if e and e["event"] == "quarantine"]
    assert [(e["uid"], e["cause"]) for e in quar] == [(0, "ssm_integrity")]
    for r in reqs:
        assert res[r.uid].status == Status.OK
        np.testing.assert_array_equal(
            res[r.uid].tokens,
            solo_stream(cfg, params, QuantPolicy(None, None), r,
                        MAX_LEN).tokens[0])


def test_speculative_engine_contains_a_nan_fault():
    """Greedy speculative rounds: the poisoned verify trips the sentinel,
    the victim FAILED with a prefix of its fault-free stream, the others
    bitwise; with ``retries=1`` every stream is the plain engine's."""
    cfg, _ = _model("llama3_8b")
    spec = SpeculativeConfig(k=2, draft="nxfp4")
    eng = _engine("llama3_8b", "nxfp4", speculative=spec, chunk=6)
    reqs = _reqs(cfg, [6, 12, 5])
    ref = _by_uid(eng.serve(reqs))
    res = _by_uid(eng.serve(reqs, fault_plan=_plan(chunk=1, uid=1)))
    assert res[1].status == Status.FAILED
    np.testing.assert_array_equal(res[1].tokens,
                                  ref[1].tokens[:res[1].n_generated])
    for uid in (0, 2):
        np.testing.assert_array_equal(res[uid].tokens, ref[uid].tokens)
    healed = _by_uid(eng.serve(_reqs(cfg, [6, 12, 5], retries=1),
                               fault_plan=_plan(chunk=1, uid=1)))
    plain = _by_uid(_engine("llama3_8b", "nxfp4").serve(reqs))
    for uid in plain:
        assert healed[uid].status == Status.OK
        np.testing.assert_array_equal(healed[uid].tokens,
                                      plain[uid].tokens)


def test_tiered_engine_contains_a_nan_fault():
    """Two tiers (dense and nxfp4 KV): a fault on a request of the second
    group quarantines it alone; both groups' other streams are bitwise the
    fault-free serve's."""
    cfg, params = _model("llama3_8b")
    tiers = {"dense": TierSpec(None, None, None),
             "packed": TierSpec(None, "nxfp4", None)}
    eng = TieredContinuousEngine(cfg, params, tiers, n_slots=3,
                                 max_len=MAX_LEN, chunk=4, device="cpu")
    reqs = [dataclasses.replace(r, tier=("dense", "packed")[r.uid % 2])
            for r in _reqs(cfg, [6, 12, 5, 9])]
    ref = _by_uid(eng.serve(reqs))
    res = _by_uid(eng.serve(reqs, fault_plan=_plan(chunk=1, uid=1)))
    assert res[1].status == Status.FAILED
    np.testing.assert_array_equal(res[1].tokens,
                                  ref[1].tokens[:res[1].n_generated])
    for uid in (0, 2, 3):
        assert res[uid].status == Status.OK
        np.testing.assert_array_equal(res[uid].tokens, ref[uid].tokens)


def test_paged_engine_contains_a_nan_fault_and_frees_its_pages():
    """The paged engine (a shared prompt prefix): the victim FAILED with
    its prefix, the others bitwise; after the faulted serve the pool holds
    what it holds after a fault-free serve."""
    cfg, _ = _model("llama3_8b")
    eng = _engine("llama3_8b", "nxfp4", cls=PagedContinuousEngine,
                  n_slots=3, page_size=8)
    base = _prompts(cfg, 1, t=16, seed=3)[0]
    reqs = [Request(uid=i, tokens=np.concatenate([base, p]), max_new=m)
            for i, (p, m) in enumerate(zip(_prompts(cfg, 3, t=4),
                                           (6, 12, 5)))]
    ref = _by_uid(eng.serve(reqs))
    free = (eng.pool.free, eng.pool.used)
    res = _by_uid(eng.serve(reqs, fault_plan=_plan(chunk=1, uid=1)))
    assert res[1].status == Status.FAILED
    np.testing.assert_array_equal(res[1].tokens,
                                  ref[1].tokens[:res[1].n_generated])
    for uid in (0, 2):
        np.testing.assert_array_equal(res[uid].tokens, ref[uid].tokens)
    assert (eng.pool.free, eng.pool.used) == free


@pytest.mark.parametrize("case", ["tiered", "paged", "shard_down",
                                  "paged kv_flip"])
def test_refusals(case):
    """The tiered and paged engines refuse ``kv_integrity``; an unsharded
    engine refuses a ``shard_down`` fault and the paged one a ``kv_flip``
    (no packed per-slot leaves), both loudly."""
    cfg, params = _model("llama3_8b")
    if case == "tiered":
        with pytest.raises(ValueError, match="KV canaries"):
            TieredContinuousEngine(cfg, params,
                                   {"a": TierSpec(None, None, None)},
                                   kv_integrity=True, device="cpu")
    elif case == "paged":
        with pytest.raises(ValueError, match="kv_integrity"):
            _engine("llama3_8b", "nxfp4", cls=PagedContinuousEngine,
                    kv_integrity=True)
    elif case == "shard_down":
        with pytest.raises(ValueError, match="sharded engine"):
            _engine("llama3_8b").serve(
                _reqs(cfg, [4]), fault_plan=_plan("shard_down", shard=0))
    else:
        with pytest.raises(ValueError, match="packed KV"):
            _engine("llama3_8b", "nxfp4", cls=PagedContinuousEngine).serve(
                _reqs(cfg, [9]), fault_plan=_plan("kv_flip", chunk=1,
                                                  uid=0))


# ---------------------------------------------------------------------------
# one faulted serve against the JAX engine
# ---------------------------------------------------------------------------

_FAULTS = (dict(kind="nan_logits", chunk=1, uid=1),
           dict(kind="kv_flip", chunk=2, uid=2, n_bytes=2),
           dict(kind="delay", chunk=1, seconds=0.01, shard=0))


@pytest.fixture(scope="module")
def faulted():
    """One greedy serve by the port and by the JAX ``ContinuousEngine``
    (bf16 weights, nxfp4 KV, ``kv_integrity``, 2 slots) under the same
    plan: uid 1 poisoned at chunk 1 with a retry left, uid 2's K/V flipped
    at chunk 2 without one, a delay. Returns each engine's results,
    messages and requests."""
    jcfg = jget_smoke_config("llama3_8b")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config("llama3_8b")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=4, kv_integrity=True)
    out = {}
    for name, make, mod, log_name in (
            ("port", lambda: ContinuousEngine(
                cfg, tparams, QuantPolicy(None, "nxfp4"), device="cpu",
                **kw), None, "repro_torch.serving"),
            ("ref", lambda: jsched.ContinuousEngine(
                jcfg, jparams, JQuantPolicy(None, "nxfp4"), **kw),
             jfaults, "repro.serving")):
        req_cls = Request if mod is None else jsched.Request
        fault, plan_cls = (Fault, FaultPlan) if mod is None else \
            (jfaults.Fault, jfaults.FaultPlan)
        reqs = _reqs(cfg, [6, 12, 10, 5], cls=req_cls)
        reqs[1] = dataclasses.replace(reqs[1], retries=1)
        plan = plan_cls([fault(**f) for f in _FAULTS], seed=3)
        eng = make()
        res, msgs = _captured(log_name, lambda: eng.serve(
            reqs, fault_plan=plan))
        out[name] = (eng, _by_uid(res), msgs, reqs)
    return out


def test_faulted_serve_matches_reference(faulted):
    """Equal statuses and greedy streams (uid 1 healed, uid 2 FAILED with
    the same prefix), and equal ``fault``/``quarantine``/``requeue``
    records but their times."""
    (_, res, msgs, _), (_, jres, jmsgs, _) = faulted["port"], faulted["ref"]
    assert res.keys() == jres.keys()
    for uid, r in jres.items():
        assert res[uid].status == r.status, uid
        np.testing.assert_array_equal(res[uid].tokens, np.asarray(r.tokens),
                                      err_msg=f"uid={uid}")
    assert res[1].status == Status.OK and res[2].status == Status.FAILED

    def records(msgs, parse):
        return [{k: v for k, v in e.items() if k not in ("seq", "ts")}
                for e in map(parse, msgs) if e
                and e["event"] in ("fault", "quarantine", "requeue")]

    got = records(msgs, events.parse_event)
    assert got == records(jmsgs, jevents.parse_event)
    assert [e["event"] for e in got] == ["fault", "fault", "quarantine",
                                         "requeue", "fault", "quarantine"]


def test_restore_from_journal_after_faults_matches_reference(faulted):
    """``restore_from_journal`` on each log: a ``requeue`` is not terminal
    (a crash between it and the retry's finish replays the request), a
    FAILED ``finish`` is; the same pending uids in both packages."""
    (eng, _, msgs, reqs), (jeng, _, jmsgs, jreqs) = faulted["port"], \
        faulted["ref"]
    cut = next(i for i, m in enumerate(msgs)
               if (events.parse_event(m) or {}).get("event") == "requeue")
    jcut = next(i for i, m in enumerate(jmsgs)
                if (jevents.parse_event(m) or {}).get("event") == "requeue")
    for upto, jupto in ((cut + 1, jcut + 1), (len(msgs), len(jmsgs))):
        pending, gaps = eng.restore_from_journal(reqs, msgs[:upto])
        jpending, jgaps = jeng.restore_from_journal(jreqs, jmsgs[:jupto])
        assert [r.uid for r in pending] == [r.uid for r in jpending]
        assert gaps == jgaps == []
    early, _ = eng.restore_from_journal(reqs, msgs[:cut + 1])
    assert 1 in {r.uid for r in early}
    late, _ = eng.restore_from_journal(reqs, msgs)
    assert late == []
