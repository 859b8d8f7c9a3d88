"""Suspension, preemption, slot snapshots and checkpoints in the torch
port's serving engines, on the CPU at smoke size.

* Against the reference, wherever it is the oracle: ``PriorityPreemption.
  victims``, ``SlotScheduler.next_resume`` and ``suspend_to_queue`` on
  seeded queue, slot and phase states; ``pack_device_state``,
  ``unpack_device_state`` and ``slot_row_capacity`` on dense, ring,
  paged, hybrid and pure-SSM caches with the same seeded bytes (per layer:
  the row axis is 1 in the port, 2 in the reference); one scripted greedy
  serve (a ``suspend`` from ``progress_cb``, then ``PriorityPreemption``)
  against the JAX ``ContinuousEngine``: equal streams and equal
  ``suspend``/``preempt``/``resume`` records; ``restore_from_journal`` on
  the same messages.
* Against the port's own uninterrupted serve, bit for bit: suspend and
  resume across {whole, chunked} x {KV None, nxfp4} x {llama, danube with
  its ring wrapped, hymba, falcon}, a sampled request resumed in another
  slot; a parked request cancelled, expired or shed (its partial output
  kept); ``decode_seconds`` without the parked wall time; checkpoints
  dense -> dense, dense -> paged and paged -> dense; the paged engine's
  restores unshared; ``spec_k`` across a suspension; an economy-tier
  request back in its arena.
"""
import dataclasses
import functools
import logging
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.models import init_params as jinit_params
from repro.models import lm as jlm
from repro.serving import scheduler as jsched
from repro.serving import snapshot as jsnapshot
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.models import init_params, read_cache_slot
from repro_torch.serving import (DECODING, PREFILLING, ContinuousEngine,
                                 DropOldest, PagedContinuousEngine,
                                 PriorityAdmission, PriorityPreemption,
                                 Request, SlotScheduler, SpeculativeConfig,
                                 Status, TieredContinuousEngine,
                                 default_tiers, events, pack_device_state,
                                 slot_row_capacity, unpack_device_state)

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

MAX_LEN = 64


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = get_smoke_config(arch)
    return cfg, init_params(cfg, 0, device="cpu")


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (t,)).astype(np.int32) for t in lens]


def _reqs(cfg, max_news, lens=None, seed=0, **kw):
    lens = lens or [8] * len(max_news)
    return [Request(uid=i, tokens=p, max_new=m, **kw)
            for i, (p, m) in enumerate(zip(_prompts(cfg, lens, seed),
                                           max_news))]


def _engine(arch, fmt, cls=ContinuousEngine, **kw):
    cfg, params = _model(arch)
    kw = {"n_slots": 2, "max_len": MAX_LEN, "chunk": 4, **kw}
    return cls(cfg, params, QuantPolicy(None, fmt), device="cpu", **kw)


def _assert_streams(got, want, what=""):
    assert got.keys() == want.keys()
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"{what} uid={uid}")


def _slot_of(sched, uid):
    return next(s for s, r in sched.active.items() if r.uid == uid)


# ---------------------------------------------------------------------------
# the policies and the scheduler against the reference
# ---------------------------------------------------------------------------

def _sched_pair(rng, n_slots, policy=None):
    """The same seeded scheduler state in both packages: requests admitted
    (some phases PREFILLING), others queued, some arrivals in the future,
    some queued requests resumable."""
    port = SlotScheduler(n_slots, policy=policy() if policy else None)
    ref = jsched.SlotScheduler(n_slots, policy=(getattr(
        jsched, policy.__name__)() if policy else None))
    for i in range(int(rng.integers(n_slots, 3 * n_slots + 2))):
        spec = dict(uid=i, tokens=np.zeros((4,), np.int32), max_new=4,
                    priority=int(rng.integers(0, 4)),
                    arrival_time=float(rng.choice([0.0, 0.0, 0.5, 2.0])))
        port.submit(Request(**spec))
        ref.submit(jsched.Request(**spec))
    for _ in range(int(rng.integers(0, n_slots + 1))):
        a, b = port.next_admission(1.0), ref.next_admission(1.0)
        assert (a and (a[0], a[1].uid)) == (b and (b[0], b[1].uid))
        if a is not None and rng.random() < 0.3:
            port.mark_prefilling(a[0])
            ref.mark_prefilling(b[0])
    return port, ref


@pytest.mark.parametrize("seed", range(8))
def test_priority_preemption_matches_reference(seed):
    """Free slots first, strict priority, never a PREFILLING slot: the
    reference's victims on the same states, at every clock reading."""
    rng = np.random.default_rng(seed)
    port, ref = _sched_pair(rng, int(rng.integers(1, 5)))
    for now in (0.0, 0.6, 3.0):
        got = PriorityPreemption().victims(port, now)
        assert got == jsched.PriorityPreemption().victims(ref, now)
        assert all(port.phase[s] == DECODING for s in got)
    assert jsched.PreemptionPolicy().victims(ref, 3.0) == []


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("policy", [None, PriorityAdmission],
                         ids=["fifo", "priority"])
def test_next_resume_and_suspend_to_queue_match_reference(seed, policy):
    """Decoding slots suspended to the queue (a stand-in snapshot each),
    then ``next_resume`` and ``next_admission`` in turns: the same (slot,
    uid) pairs, queues, free lists and resumable sets as the reference's;
    a resumable request is never admitted ahead of the policy's pick."""
    rng = np.random.default_rng(100 + seed)
    port, ref = _sched_pair(rng, int(rng.integers(1, 4)), policy)
    for slot in sorted(port.active):
        if port.phase[slot] == DECODING and rng.random() < 0.7:
            assert port.suspend_to_queue(slot, f"snap{slot}").uid == \
                ref.suspend_to_queue(slot, f"snap{slot}").uid
    for step in range(12):
        now = float(rng.choice([0.0, 1.0, 3.0]))
        call = "next_resume" if step % 2 == 0 else "next_admission"
        a, b = getattr(port, call)(now), getattr(ref, call)(now)
        assert (a and (a[0], a[1].uid)) == (b and (b[0], b[1].uid)), call
        if a is not None:
            assert port.resumable.pop(a[1].uid, None) == \
                ref.resumable.pop(b[1].uid, None)
            if rng.random() < 0.5:
                port.release(a[0])
                ref.release(b[0])
        assert [r.uid for r in port.queue] == [r.uid for r in ref.queue]
        assert port.free == ref.free
        assert port.resumable == ref.resumable


def test_resumable_request_passes_the_gate_as_resumable():
    """``next_admission`` tells the admission gate whether its pick is
    resumable (the paged engine's restores never share pages)."""
    seen = []
    sched = SlotScheduler(1)
    sched.admission_gate = lambda req, shard, resumable: \
        seen.append((req.uid, resumable)) or True
    for uid in (0, 1):
        sched.submit(Request(uid=uid, tokens=np.zeros((4,), np.int32),
                             max_new=2))
    slot, _ = sched.next_admission(0.0)
    sched.suspend_to_queue(slot, "snap0")
    assert sched.next_resume(0.0) is None           # FIFO: uid 1 first
    sched.next_admission(0.0)
    sched.release(0)
    assert sched.next_resume(0.0)[1].uid == 0
    assert seen == [(0, False), (1, False), (0, True)]


# ---------------------------------------------------------------------------
# the snapshot helpers against the reference
# ---------------------------------------------------------------------------

def _to_torch(x):
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _seeded_caches(arch, fmt, paged, pos, seed=0):
    """The reference's arena (2 slots; paged: 9 pages of 8 rows, slot 1
    mapping shuffled pages over its first ``pos`` rows, the null page
    past them) filled with seeded bytes, and the port's copy of it."""
    jcfg = jget_smoke_config(arch)
    jc = (jlm.init_paged_cache(jcfg, 2, MAX_LEN, fmt, 9, 8) if paged
          else jlm.init_cache(jcfg, 2, MAX_LEN, fmt))
    rng = np.random.default_rng(seed)
    layers = {}
    for name, leaf in jc["layers"].items():
        a = np.asarray(leaf)
        if name == "block":
            row = np.zeros(a.shape[2], np.int32)
            n = min(-(-pos // 8), a.shape[2])
            row[:n] = rng.permutation(np.arange(1, 9))[:n]
            a = np.broadcast_to(row, a.shape).copy()
        elif a.dtype in (np.uint8, np.uint16):
            a = rng.integers(0, np.iinfo(a.dtype).max + 1, a.shape,
                             dtype=a.dtype)
        else:
            a = np.asarray(rng.standard_normal(a.shape), a.dtype)
        if name.startswith("pool_"):
            a[:, 0] = 0                       # the null page is never written
        layers[name] = jnp.asarray(a)
    jc = {"pos": jnp.asarray([3, pos], jnp.int32), "layers": layers}
    block = _to_torch(layers["block"][0]) if paged else None
    tc = {"pos": torch.tensor([3, pos], dtype=torch.int32),
          "layers": [{name: (block if name == "block" else _to_torch(l[i]))
                      for name, l in layers.items()}
                     for i in range(jcfg.n_layers)]}
    return jc, tc


def _assert_solo_equal(tsolo, jsolo, n_layers):
    assert int(tsolo["pos"][0]) == int(np.asarray(jsolo["pos"])[0])
    for i in range(n_layers):
        assert set(tsolo["layers"][i]) == set(jsolo["layers"])
        for name, leaf in tsolo["layers"][i].items():
            want = _to_torch(np.asarray(jsolo["layers"][name])[i])
            assert leaf.dtype == want.dtype, name
            assert torch.equal(leaf, want), (i, name)


@pytest.mark.parametrize("arch,fmt,paged,pos", [
    ("llama3_8b", None, False, 21),
    ("llama3_8b", "nxfp4", False, 21),
    ("h2o_danube_3_4b", "nxfp4", False, 45),     # a wrapped ring: 32 rows
    ("llama3_8b", "nxfp4", True, 21),
    ("hymba_1_5b", None, True, 45),              # paged ring + Mamba state
    ("hymba_1_5b", "nxfp4", False, 12),
    ("falcon_mamba_7b", None, False, 30)],       # no K/V: state only
    ids=["dense", "dense-nxfp4", "ring", "paged", "paged-hybrid", "hybrid",
         "ssm"])
def test_snapshot_helpers_match_reference(arch, fmt, paged, pos):
    """``slot_row_capacity`` of the arena (a paged one's table width times
    its page size) and of slot 1 read back as a batch-1 cache
    (``read_cache_slot``), ``pack_device_state`` at ``min(pos, capacity)``
    rows and ``unpack_device_state`` back to the capacity: the reference's
    values and bytes at each step."""
    cfg = get_smoke_config(arch)
    jc, tc = _seeded_caches(arch, fmt, paged, pos)
    cap = slot_row_capacity(tc)
    assert cap == jsnapshot.slot_row_capacity(jc)
    assert cap == (None if cfg.attn_free else cfg.sliding_window or MAX_LEN)
    tsolo = read_cache_slot(tc, 1)
    jsolo = jax.device_get(jlm.read_cache_slot(jc, 1))
    _assert_solo_equal(tsolo, jsolo, cfg.n_layers)
    assert slot_row_capacity(tsolo) == jsnapshot.slot_row_capacity(jsolo)
    used = min(pos, cap) if cap is not None else 0
    tpack = pack_device_state(tsolo, used)
    jpack = jsnapshot.pack_device_state(jsolo, used)
    _assert_solo_equal(tpack, jpack, cfg.n_layers)
    _assert_solo_equal(unpack_device_state(tpack, cap),
                       jsnapshot.unpack_device_state(jpack, cap),
                       cfg.n_layers)


# ---------------------------------------------------------------------------
# one scripted serve against the JAX engine; journals
# ---------------------------------------------------------------------------

class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, rec):
        self.messages.append(rec.getMessage())


def _captured(log_name, fn):
    h = _Messages()
    log = logging.getLogger(log_name)
    level = log.level
    log.addHandler(h)
    log.setLevel(logging.INFO)
    try:
        return fn(), h.messages
    finally:
        log.removeHandler(h)
        log.setLevel(level)


_SCRIPT = [dict(uid=0, max_new=12), dict(uid=1, max_new=16),
           dict(uid=2, max_new=6, priority=5), dict(uid=3, max_new=8)]


@pytest.fixture(scope="module")
def scripted():
    """One greedy serve by the port and by the JAX ``ContinuousEngine``
    (nxfp4 weights and KV, the reference's smoke weights; 2 slots, FIFO
    admission, ``PriorityPreemption``; arrivals at 0): uid 2 preempts a
    batch request at the first boundary it waits at, and ``progress_cb``
    suspends uid 1 after the third chunk. Returns each engine, its
    results and its captured log messages."""
    jcfg = jget_smoke_config("llama3_8b")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config("llama3_8b")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    prompts = _prompts(cfg, [8] * 4, seed=3)
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=4)
    out = {}
    for name, mod, make, log_name in (
            ("port", None, lambda: ContinuousEngine(
                cfg, tparams, QuantPolicy("nxfp4", "nxfp4"),
                preemption=PriorityPreemption(), device="cpu", **kw),
             "repro_torch.serving"),
            ("ref", jsched, lambda: jsched.ContinuousEngine(
                jcfg, jparams, JQuantPolicy("nxfp4", "nxfp4"),
                preemption=jsched.PriorityPreemption(), **kw),
             "repro.serving")):
        eng = make()
        cls = Request if mod is None else mod.Request
        reqs = [cls(tokens=p, **s) for p, s in zip(prompts, _SCRIPT)]
        seen = {"n": 0}

        def cb(engine, sched):
            seen["n"] += 1
            if seen["n"] == 3:
                engine.suspend(1)

        res, msgs = _captured(log_name, lambda: eng.serve(
            reqs, progress_cb=cb))
        out[name] = (eng, {r.uid: r for r in res}, msgs, reqs)
    return out


def _parse(msgs, parse):
    return [e for e in (parse(m) for m in msgs) if e is not None]


def test_scripted_serve_matches_reference(scripted):
    """Equal greedy streams, equal ``suspend``/``preempt``/``resume``
    records (uid, slot, n_gen, pos), a journal without gaps; the preempted
    request resumed, and it ended after its preemptor."""
    from repro.serving import events as jevents
    (_, res, msgs, _), (_, jres, jmsgs, _) = scripted["port"], \
        scripted["ref"]
    for uid, r in jres.items():
        assert res[uid].status == r.status == Status.OK
        np.testing.assert_array_equal(res[uid].tokens, np.asarray(r.tokens),
                                      err_msg=f"uid={uid}")

    def moves(evs):
        return [(e["event"], e["uid"], e["slot"], e["n_gen"], e["pos"])
                for e in evs if e["event"] in ("suspend", "preempt",
                                                "resume")]

    evs = _parse(msgs, events.parse_event)
    got = moves(evs)
    assert got == moves(_parse(jmsgs, jevents.parse_event))
    kinds = [m[0] for m in got]
    assert kinds.count("preempt") == 1 and kinds.count("suspend") == 1
    assert kinds.count("resume") == 2
    assert events.replay(msgs)[1] == []
    finish = [e["uid"] for e in evs if e["event"] == "finish"]
    victim = next(m[1] for m in got if m[0] == "preempt")
    assert finish.index(2) < finish.index(victim)


def test_restore_from_journal_matches_reference(scripted):
    """The scripted serve's log cut short (a crash) and with a record lost:
    the same pending requests and gaps as the reference's, the journal
    cursor past the last record, and a ``restore`` record."""
    eng, _, msgs, reqs = scripted["port"]
    jeng, _, _, jreqs = scripted["ref"]
    cut = msgs[:len(msgs) * 2 // 3]
    lost = [m for m in cut if '"seq": 5,' not in m]
    got = []
    for messages in (cut, lost, []):
        eng.journal.seq = jeng.journal.seq = 0
        pending, gaps = eng.restore_from_journal(reqs, messages)
        jpending, jgaps = jeng.restore_from_journal(jreqs, messages)
        assert [r.uid for r in pending] == [r.uid for r in jpending]
        assert gaps == jgaps
        assert all(r.arrival_time == 0.0 for r in pending)
        assert eng.journal.seq == jeng.journal.seq > 0
        got.append(([r.uid for r in pending], gaps))
    assert got[0][1] == [] and got[1][1] == [5]
    assert 0 < len(got[0][0]) < 4 and len(got[2][0]) == 4


# ---------------------------------------------------------------------------
# bitwise against the port's own uninterrupted serve
# ---------------------------------------------------------------------------

ARCHS = ["llama3_8b", "h2o_danube_3_4b", "hymba_1_5b", "falcon_mamba_7b"]


def _mode_kw(cfg, mode):
    if mode == "whole":
        return {}
    return dict(prefill_mode="chunked",
                p_chunk=cfg.ssm_chunk if cfg.has_mamba else 8)


@pytest.mark.parametrize("mode", ["whole", "chunked"])
@pytest.mark.parametrize("fmt", [None, "nxfp4"], ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_suspend_resume_matches_uninterrupted(arch, fmt, mode):
    """A sampled request suspended mid-stream (Danube: after its 32-row
    ring wrapped, the whole ring shipped) resumes in the other slot, its
    generator state moved with it, while a waiting request took its slot:
    every stream is the same engine's uninterrupted stream, bit for
    bit."""
    cfg = _model(arch)[0]
    w = cfg.sliding_window
    reqs = _reqs(cfg, [10, 40 if w else 20, 8])
    reqs[1].temperature, reqs[1].seed = 1.3, 17
    eng = _engine(arch, fmt, **_mode_kw(cfg, mode))
    want = {r.uid: r.tokens for r in eng.serve(reqs)}
    box = {}

    def cb(engine, sched):
        if "snap" in box or 1 not in {r.uid for r in sched.active.values()}:
            return
        slot = _slot_of(sched, 1)
        if sched.phase[slot] == DECODING and \
                engine._host["n_gen"][slot] >= (28 if w else 8):
            box["snap"], box["slot"] = engine.snapshot_slot(slot), slot
            engine.suspend(1)

    res, msgs = _captured("repro_torch.serving", lambda: eng.serve(
        reqs, progress_cb=cb))
    _assert_streams({r.uid: r.tokens for r in res}, want, arch)
    snap = box["snap"]
    resume = next(e for e in _parse(msgs, events.parse_event)
                  if e["event"] == "resume")
    assert resume["uid"] == 1
    if mode == "whole":                 # uid 2 took its slot meanwhile
        assert resume["slot"] != box["slot"]
    assert resume["pos"] == snap.pos and resume["n_gen"] == snap.n_gen
    if cfg.attn_free:
        assert snap.used_rows == 0 and slot_row_capacity(eng.cache) is None
    elif w:
        assert snap.pos > w and snap.used_rows == w
    else:
        assert snap.used_rows == snap.pos < MAX_LEN


def test_snapshot_ships_packed_bytes():
    """An nxfp4 slot's snapshot carries the packed codes and meta as they
    are (uint8, uint16), trimmed to ``pos`` rows, and is smaller than the
    bf16 snapshot at the same boundary."""
    snaps = {}
    for fmt in (None, "nxfp4"):
        eng = _engine("llama3_8b", fmt)

        def cb(engine, sched, fmt=fmt):
            if fmt not in snaps:
                snaps[fmt] = engine.snapshot_slot(_slot_of(sched, 0))

        eng.serve(_reqs(_model("llama3_8b")[0], [12]), progress_cb=cb)
    dense, packed = snaps[None], snaps["nxfp4"]
    assert dense.pos == packed.pos == packed.used_rows
    layer = packed.device["layers"][0]
    assert layer["k_packed"].dtype == torch.uint8
    assert layer["k_meta"].dtype == torch.uint16
    assert layer["k_packed"].shape[1] == packed.used_rows
    assert packed.nbytes < dense.nbytes


@pytest.mark.parametrize("how", ["cancel", "expire", "shed"])
def test_parked_request_leaves_with_partial_output(how):
    """A suspended request that leaves the queue (cancelled, past its
    deadline, shed by ``DropOldest``) keeps the tokens it had: a prefix of
    its uninterrupted stream, its realized TTFT; the others' streams do not
    change. One slot: the parked request waits behind the other."""
    cfg = _model("llama3_8b")[0]
    reqs = _reqs(cfg, [20, 20, 4])
    kw = {}
    if how == "expire":
        reqs[0].deadline_s = 1.0
    if how == "shed":
        reqs[2].arrival_time = 1.0
        kw = dict(max_queue=1, shedding=DropOldest())
    else:
        reqs = reqs[:2]
    eng = _engine("llama3_8b", None, n_slots=1, **kw)
    want = {r.uid: r.tokens for r in _engine(
        "llama3_8b", None, n_slots=1).serve([dataclasses.replace(
            r, arrival_time=0.0, deadline_s=None) for r in reqs])}
    seen = {"n": 0}

    def cb(engine, sched):
        seen["n"] += 1
        if seen["n"] == 1:
            engine.suspend(0)
        elif seen["n"] == 2:
            assert 0 in sched.resumable
            if how == "cancel":
                engine.cancel(0)
            else:
                time.sleep(max(0.0, 1.05 - engine._clock()))

    res = {r.uid: r for r in eng.serve(reqs, progress_cb=cb)}
    r0 = res[0]
    assert r0.status == {"cancel": Status.CANCELLED, "shed": Status.SHED,
                         "expire": Status.DEADLINE_EXPIRED}[how]
    assert r0.n_generated == 4 and r0.ttft < float("inf")
    np.testing.assert_array_equal(r0.tokens, want[0][:4])
    for uid in res:
        if uid != 0:
            assert res[uid].ok
            np.testing.assert_array_equal(res[uid].tokens, want[uid])


def test_decode_seconds_exclude_parked_time():
    """A request parked for 0.6 s is not charged for it: ``decode_seconds``
    sums its occupied time only, and its queue delay is the one realized
    at its first admission."""
    cfg = _model("llama3_8b")[0]
    reqs = _reqs(cfg, [16, 12])
    eng = _engine("llama3_8b", None, n_slots=1)
    want = {r.uid: r.tokens for r in eng.serve(reqs)}
    st = {"n": 0, "slept": False}

    def cb(engine, sched):
        st["n"] += 1
        if st["n"] == 1:
            engine.suspend(0)
        elif not st["slept"] and 0 in sched.resumable:
            time.sleep(0.6)
            st["slept"] = True

    t0 = time.time()
    res = {r.uid: r for r in eng.serve(reqs, progress_cb=cb)}
    assert st["slept"] and time.time() - t0 >= 0.6
    r0 = res[0]
    assert r0.ok and r0.n_generated == 16
    assert r0.decode_seconds < 0.4 and r0.queue_delay < 0.4
    _assert_streams({u: r.tokens for u, r in res.items()}, want)


def test_prefilling_request_suspends_plain():
    """A suspended PREFILLING request aborts its lane and requeues without
    a snapshot (``resumable`` false): its prompt restarts from chunk 0 and
    its stream is the uninterrupted one."""
    cfg = _model("llama3_8b")[0]
    reqs = _reqs(cfg, [8, 8], lens=[8, 24])
    eng = _engine("llama3_8b", None, prefill_mode="chunked", p_chunk=8)
    want = {r.uid: r.tokens for r in eng.serve(reqs)}
    fired = []

    def cb(engine, sched):
        if not fired and 1 in {r.uid for r in sched.active.values()}:
            assert sched.phase[_slot_of(sched, 1)] == PREFILLING
            fired.append(engine.suspend(1))

    res, msgs = _captured("repro_torch.serving", lambda: eng.serve(
        reqs, progress_cb=cb))
    _assert_streams({r.uid: r.tokens for r in res}, want)
    sus = [e for e in _parse(msgs, events.parse_event)
           if e["event"] == "suspend"]
    assert fired and sus and sus[0]["resumable"] is False
    assert sus[0]["uid"] == 1


# ---------------------------------------------------------------------------
# checkpoints, and the other engines
# ---------------------------------------------------------------------------

class _Crash(Exception):
    pass


_UNINTERRUPTED = {}


def _ckpt_reqs(cfg):
    reqs = _reqs(cfg, [6, 14, 12, 10], seed=8)
    reqs[1].temperature, reqs[1].seed = 1.1, 5
    return reqs


@pytest.mark.parametrize("src,dst", [
    (ContinuousEngine, ContinuousEngine),
    (ContinuousEngine, PagedContinuousEngine),
    (PagedContinuousEngine, ContinuousEngine)],
    ids=["dense-dense", "dense-paged", "paged-dense"])
def test_checkpoint_restore_round_trip(src, dst, tmp_path):
    """A checkpoint mid-serve, then an exception out of ``progress_cb``
    (the crash); a fresh engine of either layout restores it and serves
    the rest: every stream (one sampled) is the uninterrupted serve's, the
    prior results join the new ones, the journal goes on from the
    checkpoint's cursor and a paged pool is empty at the end."""
    cfg = _model("llama3_8b")[0]
    reqs = _ckpt_reqs(cfg)
    if "want" not in _UNINTERRUPTED:
        _UNINTERRUPTED["want"] = {r.uid: r.tokens for r in _engine(
            "llama3_8b", "nxfp4").serve(reqs)}
    path = tmp_path / "serve.ck"
    st = {"n": 0}

    def cb(engine, sched):
        st["n"] += 1
        if st["n"] == 3:
            ck = engine.checkpoint(path)
            assert ck["snapshots"] and path.exists()
            st["seq"] = ck["seq"]
            raise _Crash

    with pytest.raises(_Crash):
        _engine("llama3_8b", "nxfp4", src).serve(reqs, progress_cb=cb)
    fresh = _engine("llama3_8b", "nxfp4", dst)
    pending, prior = fresh.restore(path)
    assert fresh.journal.seq == st["seq"] + 1        # its restore record
    assert {r.uid for r in pending} | {r.uid for r in prior} == \
        {r.uid for r in reqs}
    got = {r.uid: r.tokens for r in prior}
    got.update({r.uid: r.tokens for r in fresh.serve(pending)})
    _assert_streams(got, _UNINTERRUPTED["want"],
                    f"{src.__name__}->{dst.__name__}")
    if dst is PagedContinuousEngine:
        fresh.pool.assert_empty()


def test_checkpoint_refusals(tmp_path):
    """``restore`` refuses a checkpoint of another KV format or a larger
    ``max_len``; ``checkpoint`` and ``snapshot_slot`` refuse outside a
    serve."""
    cfg = _model("llama3_8b")[0]
    path = tmp_path / "serve.ck"
    eng = _engine("llama3_8b", None)
    with pytest.raises(ValueError, match="no live request"):
        eng.snapshot_slot(0)
    with pytest.raises(RuntimeError, match="mid-serve"):
        eng.checkpoint(path)

    def cb(engine, sched):
        if not path.exists():
            engine.checkpoint(path)

    eng.serve(_reqs(cfg, [8]), progress_cb=cb)
    with pytest.raises(ValueError, match="checkpoint was taken"):
        _engine("llama3_8b", "nxfp4").restore(path)
    with pytest.raises(ValueError, match="checkpoint was taken"):
        _engine("h2o_danube_3_4b", None).restore(path)
    with pytest.raises(ValueError, match="max_len"):
        _engine("llama3_8b", None, max_len=32).restore(path)
    assert not (tmp_path / "serve.ck.tmp").exists()


def test_paged_restore_reenters_unshared():
    """A claimant of a shared prefix, suspended and resumed on the paged
    engine, comes back on private pages (no shared page in its table),
    and every stream is the dense engine's; the pool is empty after."""
    cfg = _model("llama3_8b")[0]
    prefix = _prompts(cfg, [16], seed=2)[0]
    tails = _prompts(cfg, [4] * 3, seed=3)
    reqs = [Request(uid=i, tokens=np.concatenate([prefix, t]),
                    max_new=12) for i, t in enumerate(tails)]
    want = {r.uid: r.tokens for r in _engine("llama3_8b", "nxfp4").serve(
        reqs)}
    eng = _engine("llama3_8b", "nxfp4", PagedContinuousEngine, page_size=8)
    box = {}
    resume = eng._resume

    def spy(sched, state, slot, req, snap, clock, **kw):
        resume(sched, state, slot, req, snap, clock, **kw)
        box["shared"] = eng.pool.has_shared(slot)

    eng._resume = spy

    def cb(engine, sched):
        if "fired" not in box and engine.pool.stats()["prefix_hits"]:
            uid = next(r.uid for s, r in sched.active.items()
                       if engine.pool.has_shared(s))
            box["fired"] = engine.suspend(uid)

    _assert_streams({r.uid: r.tokens for r in eng.serve(
        reqs, progress_cb=cb)}, want, "paged")
    assert "fired" in box and box["shared"] is False
    eng.pool.assert_empty()


def test_paged_attention_free_keeps_dense_steps():
    """An attention-free model's paged engine builds no pool and runs the
    dense engine's steps, suspension included."""
    eng = _engine("falcon_mamba_7b", None, PagedContinuousEngine)
    assert eng.pool is None
    assert "block" not in eng.cache["layers"][0]
    assert eng._restore_dispatch.__func__ is \
        ContinuousEngine._restore_dispatch


def test_speculative_suspend_keeps_spec_k():
    """Both slots of a speculative serve suspended mid-stream resume with
    their learned draft length (one set to 2 before the suspension, where
    a fresh admission arms 4), and the streams are the plain engine's, bit
    for bit (the reference's ``test_speculative_suspend_resume_matches_
    plain``)."""
    cfg, params = _model("llama3_8b")
    reqs = _reqs(cfg, [12, 14, 8])
    pol = QuantPolicy("nxfp4", "nxfp4")
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=4, device="cpu")
    want = {r.uid: r.tokens for r in ContinuousEngine(
        cfg, params, pol, **kw).serve(reqs)}
    eng = ContinuousEngine(cfg, params, pol, speculative=SpeculativeConfig(
        k=4, adaptive=True), **kw)
    seen, armed = {"n": 0}, {}
    resume = eng._resume

    def spy(sched, state, slot, req, snap, clock, **kw):
        resume(sched, state, slot, req, snap, clock, **kw)
        armed[req.uid] = (snap.spec_k, int(eng._adaptive.k[slot]))

    eng._resume = spy

    def cb(engine, sched):
        seen["n"] += 1
        if seen["n"] == 2:
            engine._adaptive.k[_slot_of(sched, 1)] = 2
            engine.suspend(0)
            engine.suspend(1)

    _assert_streams({r.uid: r.tokens for r in eng.serve(
        reqs, progress_cb=cb)}, want, "speculative")
    assert armed[1] == (2, 2) and armed[0][0] == armed[0][1] >= 1


def test_tiered_suspend_keeps_tier_arena():
    """An economy-tier request suspended on a one-slot tiered engine
    resumes into the economy arena and finishes as the uninterrupted serve
    (the reference's ``tests/test_tiers.py:128``); the engine refuses
    ``preemption=``."""
    cfg, params = _model("llama3_8b")
    with pytest.raises(ValueError, match="preemption"):
        TieredContinuousEngine(cfg, params, default_tiers(), n_slots=1,
                               max_len=MAX_LEN, device="cpu",
                               preemption=PriorityPreemption())
    eng = TieredContinuousEngine(cfg, params, default_tiers(),
                                 default_tier="standard", n_slots=1,
                                 max_len=MAX_LEN, chunk=4, device="cpu")
    reqs = _reqs(cfg, [5, 11, 3], lens=[8, 17, 8])
    reqs[0].tier = reqs[1].tier = "economy"
    want = {r.uid: r.tokens for r in eng.serve(reqs)}
    calls, tiers = [], []
    resume = eng._resume

    def spy(sched, state, slot, req, snap, clock, **kw):
        resume(sched, state, slot, req, snap, clock, **kw)
        tiers.append(eng._slot_tier[slot])

    eng._resume = spy

    def cb(engine, sched):
        calls.append(1)
        if len(calls) == 3:
            engine.suspend(1)

    _assert_streams({r.uid: r.tokens for r in eng.serve(
        reqs, progress_cb=cb)}, want, "tiered")
    assert tiers == ["economy"]
