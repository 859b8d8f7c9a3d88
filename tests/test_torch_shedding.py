"""Bounded-queue shedding and ``p_chunk="auto"`` in the torch port's
continuous engine, on the CPU at smoke size.

* Against the reference's classes, on the same seeded queues:
  ``RejectNew``, ``DropOldest`` and ``DegradeOverBudget`` (``hard_cap``,
  ``pool_watermark``) through ``SlotScheduler.enforce_bounds`` (the
  ``free`` credit included), then admission with the degrade markers
  applied: the same shed requests, markers, queue and admitted requests.
* The engine at smoke size: a burst over ``max_queue`` under each policy
  ends with the reference engine's statuses and degraded flags and the
  same journal (kinds and uids, in order); every served stream is the
  port's solo stream, a degraded one at its capped budget, greedy.
* ``_autotune_p_chunk``: the reference's pick and sweep from the same
  injected timings (the fallback to the smallest candidate included), and
  ``p_chunk="auto"`` serving every stream bitwise its solo stream.
"""
import dataclasses
import itertools
import logging

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.models import init_params as jinit_params
from repro.serving import events as jevents
from repro.serving import scheduler as jsched
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.serving import (ContinuousEngine, DegradeOverBudget,
                                 DropOldest, RejectNew, Request,
                                 SheddingPolicy, SlotScheduler, Status,
                                 events)

from _torch_helpers import solo_stream  # one intra-op thread a process

MAX_LEN = 64


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_smoke_config("llama3_8b")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, get_smoke_config("llama3_8b"), jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _both(spec):
    return ([Request(**s) for s in spec], [jsched.Request(**s) for s in spec])


def _policies(kind):
    """(port, reference) shedding policies of one kind."""
    if kind == "reject-new":
        return RejectNew(), jsched.RejectNew()
    if kind == "drop-oldest":
        return DropOldest(), jsched.DropOldest()
    kw = {"degrade": dict(max_new_cap=3),
          "degrade-hard-cap": dict(max_new_cap=2, force_greedy=False,
                                   hard_cap=5),
          "degrade-uncapped": dict(max_new_cap=None),
          "degrade-watermark": dict(max_new_cap=4,
                                    pool_watermark=0.5)}[kind]
    return DegradeOverBudget(**kw), jsched.DegradeOverBudget(**kw)


KINDS = ["reject-new", "drop-oldest", "degrade", "degrade-hard-cap",
         "degrade-uncapped", "degrade-watermark"]


def _queue_spec(rng, n):
    return [dict(uid=i, tokens=np.zeros((4,), np.int32),
                 max_new=int(rng.integers(2, 9)),
                 temperature=float(rng.choice([0.0, 0.9])),
                 arrival_time=float(rng.choice([0.0, 0.0, 0.3, 0.6, 2.0])))
            for i in range(n)]


class _Events(logging.Handler):
    def __init__(self, parse):
        super().__init__()
        self.parse = parse
        self.records = []

    def emit(self, rec):
        e = self.parse(rec.getMessage())
        if e:
            self.records.append(e)


@pytest.fixture
def journals():
    """The port's and the reference's scheduler event records."""
    got = {}
    for name, log_name, parse in (
            ("port", "repro_torch.serving.scheduler", events.parse_event),
            ("ref", "repro.serving.scheduler", jevents.parse_event)):
        h = _Events(parse)
        log = logging.getLogger(log_name)
        got[name] = (h, log, log.level)
        log.addHandler(h)
        log.setLevel(logging.INFO)
    yield {name: h.records for name, (h, _, _) in got.items()}
    for h, log, level in got.values():
        log.removeHandler(h)
        log.setLevel(level)


# ---------------------------------------------------------------------------
# the policies and enforce_bounds against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("kind", KINDS)
def test_enforce_bounds_matches_reference(seed, kind):
    """Seeded queues (some arrivals in the future, some slots busy so the
    ``free`` credit varies), the clock stepped: every ``enforce_bounds``
    sheds the reference's requests and records its degrade markers; the
    queue left and each admission (the marker applied: capped max_new,
    greedy) are the reference's. The watermark case reads an occupancy
    that crosses it."""
    rng = np.random.default_rng(seed)
    spec = _queue_spec(rng, 14)
    n_slots, max_queue = int(rng.integers(1, 4)), int(rng.integers(0, 4))
    pol, jpol = _policies(kind)
    port = SlotScheduler(n_slots, max_queue=max_queue, shedding=pol)
    ref = jsched.SlotScheduler(n_slots, max_queue=max_queue,
                               shedding=jpol)
    occupancy = itertools.cycle([0.2, 0.7, 0.4])
    if kind == "degrade-watermark":
        level = {"now": 0.0}
        port.pool_monitor = ref.pool_monitor = lambda: level["now"]
    for a, b in zip(*_both(spec)):
        port.submit(a)
        ref.submit(b)
    for now in (0.0, 0.0, 0.3, 0.5, 0.6, 2.0, 2.5):
        if kind == "degrade-watermark":
            level["now"] = next(occupancy)
        assert [r.uid for r in port.enforce_bounds(now)] == \
            [r.uid for r in ref.enforce_bounds(now)]
        assert port.degraded == ref.degraded
        assert [r.uid for r in port.queue] == [r.uid for r in ref.queue]
        for _ in range(int(rng.integers(0, 2))):
            a, b = port.next_admission(now), ref.next_admission(now)
            assert (a is None) == (b is None)
            if a is not None:
                assert a[0] == b[0]
                assert (a[1].uid, a[1].max_new, a[1].temperature) == \
                    (b[1].uid, b[1].max_new, b[1].temperature)
        if port.active and rng.random() < 0.5:
            slot = sorted(port.active)[0]
            port.release(slot)
            ref.release(slot)


def test_enforce_bounds_cases():
    """The rule by hand: 6 arrived, 2 free slots, max_queue 2 -> 2 over
    budget; a future arrival is not load; without a bound or pressure
    nothing happens; a degrade marker caps and greedies at admission."""
    def queue(sched):
        for i in range(6):
            sched.submit(Request(uid=i, tokens=np.zeros((4,), np.int32),
                                 max_new=10, temperature=0.5))
        sched.submit(Request(uid=6, tokens=np.zeros((4,), np.int32),
                             max_new=10, arrival_time=5.0))

    s = SlotScheduler(2, max_queue=2)
    queue(s)
    assert [r.uid for r in s.enforce_bounds(0.0)] == [5, 4]
    s = SlotScheduler(2, max_queue=2, shedding=DropOldest())
    queue(s)
    assert [r.uid for r in s.enforce_bounds(0.0)] == [1, 0]
    s = SlotScheduler(2, shedding=DropOldest())
    queue(s)
    assert s.enforce_bounds(0.0) == [] and len(s.queue) == 7
    s = SlotScheduler(2, max_queue=2, shedding=DegradeOverBudget(3))
    queue(s)
    assert s.enforce_bounds(0.0) == []
    assert s.degraded == {4: (3, True), 5: (3, True)}
    s.queue = s.queue[4:]                   # 4 and 5 at the head
    slot, req = s.next_admission(0.0)
    assert (slot, req.uid, req.max_new, req.temperature) == (0, 4, 3, 0.0)
    with pytest.raises(NotImplementedError):
        SheddingPolicy().over_budget(s, [0], 1, 0.0)


# ---------------------------------------------------------------------------
# the engine: SHED and degraded results against the reference engine
# ---------------------------------------------------------------------------

def _burst(cfg, n=7):
    """n requests at t 0 of one prompt length (one reference compile),
    two of them sampled."""
    rng = np.random.default_rng(3)
    return [dict(uid=i, tokens=rng.integers(0, cfg.vocab, (8,)).astype(
                 np.int32), max_new=int(m), seed=40 + i,
                 temperature=1.1 if i in (2, 5) else 0.0)
            for i, m in enumerate(rng.integers(3, 9, n))]


def _solo(setup, fmt, req):
    """The request's tokens served alone by the port's host loop (once a
    process per request, format and params)."""
    out = solo_stream(setup[1], setup[3], QuantPolicy(fmt, fmt), req,
                      MAX_LEN)
    return out.tokens[0, :int(out.n_generated[0])]


@pytest.mark.parametrize("kind", ["reject-new", "drop-oldest", "degrade"])
def test_engine_sheds_and_degrades_like_reference(setup, journals, kind):
    """7 requests at t 0 into 2 slots with ``max_queue`` 2 (3 over budget
    at the first sweep): each request ends with the reference engine's
    status and degraded flag, the journals carry the same events (kind and
    uid, in order; ``shed`` and ``degrade`` among them), and every served
    stream is its solo stream, a degraded one's at the capped budget,
    greedy."""
    jcfg, cfg, jparams = setup[:3]
    spec = _burst(cfg)
    pol, jpol = _policies(kind)
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=4, max_queue=2)
    eng = ContinuousEngine(cfg, setup[3], QuantPolicy("nxfp4", "nxfp4"),
                           shedding=pol, device="cpu", **kw)
    jeng = jsched.ContinuousEngine(jcfg, jparams,
                                   JQuantPolicy("nxfp4", "nxfp4"),
                                   shedding=jpol, **kw)
    reqs, jreqs = _both(spec)
    res = {r.uid: r for r in eng.serve(reqs)}
    jres = {r.uid: r for r in jeng.serve(jreqs)}
    assert {u: (r.status, r.degraded) for u, r in res.items()} == \
        {u: (r.status, r.degraded) for u, r in jres.items()}
    n_shed = sum(r.status == Status.SHED for r in res.values())
    n_deg = sum(r.degraded for r in res.values())
    assert (n_shed, n_deg) == ((0, 3) if kind == "degrade" else (3, 0))
    kinds = [(e["event"], e.get("uid")) for e in journals["port"]]
    assert kinds == [(e["event"], e.get("uid")) for e in journals["ref"]]
    assert sum(k == ("shed" if kind != "degrade" else "degrade")
               for k, _ in kinds) == 3
    for req in reqs:
        r = res[req.uid]
        if r.status == Status.SHED:
            assert r.n_generated == 0 and r.ttft == float("inf")
            continue
        assert r.status == Status.OK
        if r.degraded:
            req = dataclasses.replace(req, max_new=min(req.max_new, 3),
                                      temperature=0.0)
        np.testing.assert_array_equal(r.tokens, _solo(setup, "nxfp4", req),
                                      err_msg=f"uid={req.uid}")


def test_engine_without_bound_sheds_nothing(setup):
    """No ``max_queue`` (the default): a burst waits, every request OK."""
    cfg = setup[1]
    eng = ContinuousEngine(cfg, setup[3], QuantPolicy(None, None),
                           n_slots=2, max_len=MAX_LEN, chunk=4,
                           shedding=RejectNew(), device="cpu")
    res = eng.serve(_both(_burst(cfg, 5))[0])
    assert all(r.status == Status.OK and not r.degraded for r in res)


# ---------------------------------------------------------------------------
# p_chunk="auto"
# ---------------------------------------------------------------------------

SWEEPS = {
    # seconds: decode chunk, then the lane chunk at each candidate
    "widest-fits": [1.0, 0.5, 0.6, 0.9, 1.5],
    "middle": [1.0, 0.4, 0.5, 1.9, 2.5],
    "none-fits": [0.1, 0.5, 0.6, 0.9, 1.5],
    "budget-edge": [0.5, 0.9, 1.0, 1.0, 1.01],
}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_autotune_pick_matches_reference(setup, monkeypatch, case):
    """The same timings injected into both engines' ``_time_best``: the
    same sweep and the same pick (the highest p / t among candidates
    within 2 decode chunks, else the smallest candidate)."""
    jcfg, cfg, jparams, tparams = setup
    cands = (16, 8, 32, 16, 4, 128)       # unsorted, a duplicate, > max_len

    def fake(times):
        it = iter(times)
        return lambda self, fn, n=3: next(it)

    monkeypatch.setattr(ContinuousEngine, "_time_best", fake(SWEEPS[case]))
    monkeypatch.setattr(jsched.ContinuousEngine, "_time_best",
                        fake(SWEEPS[case]))
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=4, prefill_mode="chunked",
              p_chunk="auto", p_chunk_candidates=cands)
    eng = ContinuousEngine(cfg, tparams, QuantPolicy("nxfp4", "nxfp4"),
                           device="cpu", **kw)
    jeng = jsched.ContinuousEngine(jcfg, jparams,
                                   JQuantPolicy("nxfp4", "nxfp4"), **kw)
    assert eng.p_chunk == jeng.p_chunk
    assert eng.p_chunk_sweep == jeng.p_chunk_sweep
    assert eng.p_chunk_decode_s == SWEEPS[case][0]
    assert eng.lane["layers"][0]["k"].shape[1] == \
        -(-MAX_LEN // eng.p_chunk) * eng.p_chunk
    assert eng._lane_tok.shape == (1, eng.p_chunk)


def test_autotune_refuses_when_no_candidate_fits(setup):
    with pytest.raises(ValueError, match="no candidate"):
        ContinuousEngine(setup[1], setup[3], QuantPolicy(None, None),
                         n_slots=1, max_len=16, prefill_mode="chunked",
                         p_chunk="auto", p_chunk_candidates=(32, 64),
                         device="cpu")


@pytest.mark.parametrize("fmt", [None, "nxfp4"])
def test_auto_p_chunk_serves_solo_streams(setup, fmt):
    """``p_chunk="auto"`` measures its sweep on this CPU, picks a
    candidate and serves: every stream (one sampled) is its solo stream,
    and a second serve repeats it."""
    cfg = setup[1]
    eng = ContinuousEngine(cfg, setup[3], QuantPolicy(fmt, fmt), n_slots=2,
                           max_len=MAX_LEN, chunk=4, prefill_mode="chunked",
                           p_chunk="auto", p_chunk_candidates=(4, 8, 16),
                           device="cpu")
    assert eng.p_chunk in (4, 8, 16)
    assert sorted(eng.p_chunk_sweep) == [4, 8, 16]
    assert all(s > 0 for s in eng.p_chunk_sweep.values())
    rng = np.random.default_rng(7)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)).astype(
                    np.int32), max_new=m, temperature=0.8 if i == 1 else 0.0,
                    seed=5 + i)
            for i, (t, m) in enumerate([(19, 5), (9, 7), (33, 4)])]
    first = {r.uid: r.tokens for r in eng.serve(reqs)}
    again = {r.uid: r.tokens for r in eng.serve(reqs)}
    for req in reqs:
        want = _solo(setup, fmt, req)
        np.testing.assert_array_equal(first[req.uid], want)
        np.testing.assert_array_equal(again[req.uid], want)


@pytest.mark.parametrize("fmt", [None, "nxfp4"])
def test_autotune_leaves_the_state_of_a_fixed_engine(setup, fmt):
    """The sweep's probes write a lane chunk into slot 0 and the lane:
    after the pick, the cache, the lane scratch and the lane's inputs hold
    what an engine built at that fixed width holds, bit for bit."""
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=4, prefill_mode="chunked",
              device="cpu")
    auto = ContinuousEngine(setup[1], setup[3], QuantPolicy(fmt, fmt),
                            p_chunk="auto", p_chunk_candidates=(4, 8, 16),
                            **kw)
    fixed = ContinuousEngine(setup[1], setup[3], QuantPolicy(fmt, fmt),
                             p_chunk=auto.p_chunk, **kw)

    def buffers(eng):
        return [eng.cache["pos"], eng._lane_tok, eng._lane_idx] + [
            b for part in (eng.cache, eng.lane)
            for layer in part["layers"] for b in layer.values()]

    got, want = buffers(auto), buffers(fixed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.flatten().view(torch.uint8),
                           b.flatten().view(torch.uint8))


def test_fixed_p_chunk_must_be_an_int(setup):
    with pytest.raises(ValueError, match="'auto'"):
        ContinuousEngine(setup[1], setup[3], QuantPolicy(None, None),
                         n_slots=1, max_len=16, prefill_mode="chunked",
                         p_chunk="wide", device="cpu")
