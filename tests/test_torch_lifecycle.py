"""Deadlines and cancellation in the torch port's continuous engine, on
the CPU at smoke size.

* Against the reference's classes, on the same queues: ``TtftDeadline``
  (``select`` and ``expired``), ``SlotScheduler.expire_queued`` and
  ``pop_queued``, the same indices and requests
  (``tests/test_faults.py``, ``tests/test_prefill_chunk.py``).
* The engine's lifecycle, as ``tests/test_faults.py`` holds the
  reference's: a request past its deadline in the queue ends
  DEADLINE_EXPIRED with no tokens and a TTFT of inf, a decoding one with a
  prefix of its stream, a prefilling one aborts the lane; ``cancel``
  likewise; the other requests' streams do not change. The port has no
  fault injection, so a ``time.sleep`` in ``progress_cb`` burns the clock
  where the reference uses a delay fault.
"""
import dataclasses
import logging
import time

import jax
import numpy as np
import pytest

from repro.serving import scheduler as jsched
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.serving import (ContinuousEngine, FifoPolicy, PREFILLING,
                                 Request, SlotScheduler, Status,
                                 TtftDeadline, events)


@pytest.fixture(scope="module")
def llama():
    from repro.configs import get_smoke_config as jget_smoke_config
    from repro.models import init_params as jinit_params
    jparams = jinit_params(jget_smoke_config("llama3_8b"),
                           jax.random.PRNGKey(0))
    return get_smoke_config("llama3_8b"), params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _prompts(cfg, n, t=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
            for _ in range(n)]


def _reqs(cfg, max_news, **kw):
    return [Request(uid=i, tokens=p, max_new=m, **kw)
            for i, (p, m) in enumerate(zip(_prompts(cfg, len(max_news)),
                                           max_news))]


def _engine(llama, **kw):
    cfg, params = llama
    kw = {"n_slots": 2, "max_len": 64, "chunk": 4, **kw}
    return ContinuousEngine(cfg, params, QuantPolicy(None, None),
                            device="cpu", **kw)


def _both(spec):
    """The same requests for the port and the reference."""
    return ([Request(**s) for s in spec], [jsched.Request(**s) for s in spec])


# ---------------------------------------------------------------------------
# policies and the scheduler against the reference
# ---------------------------------------------------------------------------

def _queue_spec(rng, n):
    return [dict(uid=i, tokens=np.zeros((int(rng.integers(1, 64)),),
                                        np.int32), max_new=2,
                 arrival_time=float(rng.uniform(0.0, 1.0)),
                 deadline_s=(None if rng.random() < 0.5
                             else float(rng.uniform(0.0, 0.6))))
            for i in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_ttft_deadline_matches_reference(seed):
    """Least slack first, never a negative slack: ``select`` and
    ``expired`` give the reference's indices on the same queue, at every
    clock reading."""
    rng = np.random.default_rng(seed)
    port_q, ref_q = _both(_queue_spec(rng, 9))
    kw = dict(deadline_s=float(rng.uniform(0.1, 0.8)),
              prefill_s_per_tok=float(rng.choice([0.0, 0.002, 0.01])))
    port, ref = TtftDeadline(**kw), jsched.TtftDeadline(**kw)
    for now in np.linspace(0.0, 1.6, 17):
        assert port.select(port_q, now) == ref.select(ref_q, now)
        assert port.expired(port_q, now) == ref.expired(ref_q, now)


def test_ttft_deadline_selection_order():
    """The reference's cases (``tests/test_prefill_chunk.py``,
    ``tests/test_faults.py``): least non-negative slack first, expired
    requests reported and never selected, FIFO without an estimate."""
    def req(uid, t, arrival):
        return Request(uid=uid, tokens=np.zeros((t,), np.int32), max_new=1,
                       arrival_time=arrival)

    queue = [req(0, 32, 0.0), req(1, 8, 0.1), req(2, 64, 0.2),
             req(3, 4, 9.9)]
    pol = TtftDeadline(deadline_s=1.0, prefill_s_per_tok=0.01)
    assert pol.select(queue, now=0.3) == 2
    assert pol.expired(queue, now=0.3) == []
    stale = TtftDeadline(deadline_s=0.5, prefill_s_per_tok=0.01)
    assert stale.select(queue, now=1.0) is None
    assert stale.expired(queue, now=1.0) == [0, 1, 2]
    assert TtftDeadline(deadline_s=1.5).select(queue, now=1.0) == 0
    q = [req(0, 4, 0.0), req(1, 4, 0.15)]
    pol = TtftDeadline(deadline_s=0.1)
    assert pol.select(q, now=0.2) == 1 and pol.expired(q, now=0.2) == [0]
    assert pol.select(q[:1], now=0.2) is None
    assert FifoPolicy().expired(q, now=5.0) == []


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", ["fifo", "ttft"])
def test_expire_queued_matches_reference(seed, policy):
    """The union of the requests' own deadlines and the policy's expired
    ones: the reference's popped requests, in its order, and the same
    queue left, at every clock reading."""
    rng = np.random.default_rng(10 + seed)
    spec = _queue_spec(rng, 10)
    port_q, ref_q = _both(spec)
    pols = {"fifo": (FifoPolicy(), jsched.FifoPolicy()),
            "ttft": (TtftDeadline(deadline_s=0.7),
                     jsched.TtftDeadline(deadline_s=0.7))}[policy]
    port, ref = SlotScheduler(2, pols[0]), jsched.SlotScheduler(2, pols[1])
    for a, b in zip(port_q, ref_q):
        port.submit(a)
        ref.submit(b)
    for now in np.linspace(0.0, 1.8, 10):
        assert [r.uid for r in port.expire_queued(now)] == \
            [r.uid for r in ref.expire_queued(now)]
        assert [r.uid for r in port.queue] == [r.uid for r in ref.queue]


def test_expire_queued_unions_policy_and_request_deadline():
    sched = SlotScheduler(1, policy=TtftDeadline(deadline_s=0.1))
    sched.submit(Request(uid=0, tokens=np.zeros((4,), np.int32), max_new=2))
    sched.submit(Request(uid=1, tokens=np.zeros((4,), np.int32), max_new=2,
                         deadline_s=0.5))
    sched.submit(Request(uid=2, tokens=np.zeros((4,), np.int32), max_new=2,
                         arrival_time=0.55))
    assert {r.uid for r in sched.expire_queued(now=0.6)} == {0, 1}
    assert [r.uid for r in sched.queue] == [2]


def test_pop_queued_and_phases_match_reference():
    spec = [dict(uid=u, tokens=np.zeros((4,), np.int32), max_new=1)
            for u in (5, 9, 2)]
    port_q, ref_q = _both(spec)
    port, ref = SlotScheduler(2), jsched.SlotScheduler(2)
    for a, b in zip(port_q, ref_q):
        port.submit(a)
        ref.submit(b)
    for sch in (port, ref):
        slot, _ = sch.next_admission(now=0.0)
        sch.mark_prefilling(slot)
    assert port.phase == ref.phase == {0: PREFILLING}
    for uid in (2, 5, 7):
        a, b = port.pop_queued(uid), ref.pop_queued(uid)
        assert (a and a.uid) == (b and b.uid)
    assert [r.uid for r in port.queue] == [r.uid for r in ref.queue] == [9]
    port.release(0)
    ref.release(0)
    assert port.phase == ref.phase == {}


# ---------------------------------------------------------------------------
# the engine's lifecycle
# ---------------------------------------------------------------------------

def _sleep_after(chunk: int, seconds: float):
    """A progress callback that burns the clock once, after decode chunk
    ``chunk`` (the reference's delay fault)."""
    def cb(engine, sched):
        if engine.chunks == chunk:
            time.sleep(seconds)
    return cb


@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_deadline_evicts_partial_and_queued(llama, mode):
    """uid 0 passes its deadline mid-decode and ends with a prefix of its
    stream; uid 2, queued behind the one slot, expires there with no
    tokens; uid 1 is served in full, its stream unchanged."""
    cfg = llama[0]
    eng = _engine(llama, n_slots=1, prefill_mode=mode, p_chunk=4)
    ref = {r.uid: r for r in eng.serve(_reqs(cfg, [50, 6]))}
    reqs = _reqs(cfg, [50, 6])
    reqs[0] = dataclasses.replace(reqs[0], deadline_s=1.0)
    reqs.append(Request(uid=2, tokens=_prompts(cfg, 1)[0], max_new=6,
                        arrival_time=0.02, deadline_s=0.001))
    res = {r.uid: r for r in eng.serve(reqs,
                                       progress_cb=_sleep_after(2, 1.2))}
    assert res[0].status == Status.DEADLINE_EXPIRED
    assert 0 < res[0].n_generated < 50
    np.testing.assert_array_equal(res[0].tokens,
                                  ref[0].tokens[:res[0].n_generated])
    assert res[2].status == Status.DEADLINE_EXPIRED
    assert res[2].n_generated == 0 and res[2].ttft == float("inf")
    assert res[1].status == Status.OK
    np.testing.assert_array_equal(res[1].tokens, ref[1].tokens)


@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_cancel_active_and_queued(llama, mode):
    """A decoding request cancelled at a chunk boundary keeps its partial
    output; a queued one leaves with none; an unknown uid is a no-op."""
    cfg = llama[0]
    eng = _engine(llama, n_slots=1, prefill_mode=mode, p_chunk=4)
    ref = {r.uid: r for r in eng.serve(_reqs(cfg, [20, 6]))}

    def cb(engine, sched):
        engine.cancel(0)         # active decoder
        engine.cancel(1)         # still queued (1 slot)
        engine.cancel(999)       # unknown uid: no-op

    res = {r.uid: r for r in eng.serve(_reqs(cfg, [20, 6]), progress_cb=cb)}
    assert res[0].status == Status.CANCELLED
    assert 0 < res[0].n_generated < 20
    np.testing.assert_array_equal(res[0].tokens,
                                  ref[0].tokens[:res[0].n_generated])
    assert res[1].status == Status.CANCELLED and res[1].n_generated == 0
    assert res[1].ttft == float("inf")


def test_cancel_mid_prefill_aborts_lane(llama):
    """Cancelling a PREFILLING slot drops the lane cursor and frees the
    slot; the decoding neighbour is unperturbed, and a later request
    prefills through the same lane into its solo stream."""
    cfg = llama[0]
    eng = _engine(llama, prefill_mode="chunked", p_chunk=8)
    long_prompt = np.tile(_prompts(cfg, 1, t=8)[0], 6)   # 48 tokens
    ref = {r.uid: r for r in eng.serve(_reqs(cfg, [12, 5]))}
    saw = {"prefilling": False}

    def cb(engine, sched):
        if any(sched.phase.get(s) == PREFILLING and r.uid == 1
               for s, r in sched.active.items()):
            saw["prefilling"] = True
            engine.cancel(1)

    reqs = _reqs(cfg, [12]) + [
        Request(uid=1, tokens=long_prompt, max_new=6),
        Request(uid=2, tokens=_prompts(cfg, 2)[1], max_new=5,
                arrival_time=0.0)]
    res = {r.uid: r for r in eng.serve(reqs, progress_cb=cb)}
    assert saw["prefilling"]
    assert res[1].status == Status.CANCELLED and res[1].n_generated == 0
    assert res[0].status == Status.OK and res[2].status == Status.OK
    np.testing.assert_array_equal(res[0].tokens, ref[0].tokens)
    np.testing.assert_array_equal(res[2].tokens, ref[1].tokens)
    assert eng._pf is None                           # lane cursor dropped


def test_deadline_mid_prefill_aborts_lane(llama):
    """A request whose deadline passes while the lane still feeds its
    prompt ends DEADLINE_EXPIRED with no tokens; the slot is freed and the
    neighbour's stream does not change."""
    cfg = llama[0]
    eng = _engine(llama, prefill_mode="chunked", p_chunk=8)
    ref = {r.uid: r for r in eng.serve(_reqs(cfg, [16]))}
    long_prompt = np.tile(_prompts(cfg, 1, t=8, seed=3)[0], 6)

    def cb(engine, sched):
        if any(sched.phase.get(s) == PREFILLING
               for s in sched.active):
            time.sleep(0.6)

    reqs = _reqs(cfg, [16]) + [Request(uid=1, tokens=long_prompt, max_new=4,
                                       deadline_s=0.5)]
    res = {r.uid: r for r in eng.serve(reqs, progress_cb=cb)}
    assert res[1].status == Status.DEADLINE_EXPIRED
    assert res[1].n_generated == 0 and res[1].ttft == float("inf")
    assert res[0].status == Status.OK
    np.testing.assert_array_equal(res[0].tokens, ref[0].tokens)
    assert eng._pf is None and len(eng.cache["pos"]) == 2


def test_ttft_deadline_engine_expires_unservable_requests(llama):
    """Under ``TtftDeadline`` a queued request whose slack went negative is
    never admitted: it ends DEADLINE_EXPIRED (an ``expire`` event), while
    the admitted ones run to completion, their streams unchanged."""
    cfg = llama[0]
    eng = _engine(llama, n_slots=1)
    ref = {r.uid: r for r in eng.serve(_reqs(cfg, [12, 12]))}
    msgs = []
    handler = logging.Handler()
    handler.emit = lambda rec: msgs.append(rec.getMessage())
    log = logging.getLogger("repro_torch.serving.scheduler")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    eng.admission_policy = TtftDeadline(deadline_s=0.4)
    try:
        res = {r.uid: r for r in eng.serve(
            _reqs(cfg, [12, 12]), progress_cb=_sleep_after(1, 0.5))}
    finally:
        log.removeHandler(handler)
    assert res[0].status == Status.OK
    np.testing.assert_array_equal(res[0].tokens, ref[0].tokens)
    assert res[1].status == Status.DEADLINE_EXPIRED
    assert res[1].n_generated == 0
    evs = [e for e in map(events.parse_event, msgs) if e]
    assert [e["uid"] for e in evs if e["event"] == "expire"] == [1]


def test_cancels_do_not_leak_into_the_next_serve(llama):
    """A cancel of a uid that never showed up is dropped at the next
    serve's start, as the reference's."""
    cfg = llama[0]
    eng = _engine(llama)
    eng.cancel(0)
    res = eng.serve(_reqs(cfg, [3]))
    assert res[0].status == Status.OK and res[0].n_generated == 3
