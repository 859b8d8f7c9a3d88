"""Slot-sharded serving in the torch port, on the CPU at smoke size, in one
process on ``["cpu"] * S`` meshes (no subprocess, process group or port).

* The oracle (ported from ``tests/test_sharded_serving.py``): a
  ``ShardedContinuousEngine`` emits the port's unsharded
  ``ContinuousEngine``'s streams bit for bit, staggered, with more
  requests than slots, whole and chunked, for the dense, sliding-window
  (the ring-wrap prompt included), hybrid and SSM families, at 2 and 4
  shards; and the JAX package's own ``ContinuousEngine`` greedy streams
  in one case.
* Against the reference's classes on the same traces: the
  ``ShardedSlotScheduler`` (slot mapping, least-loaded routing, shard
  restriction, the policy ranking the queue, drained shards, ``reassign``,
  a per-shard gate), ``take_owner_row``, ``slot_cache_specs`` and
  ``mesh_fingerprint``.
* The drain oracle (``tests/test_snapshot.py``'s ``_DRAIN_ORACLE``), the
  sharded paged engine (``tests/test_paged.py``), the sharded speculative
  engine with ``spec_shard_stats`` (``tests/test_speculative.py``) and
  one chaos case a fault kind on its victim's shard
  (``tests/test_faults.py``).
"""
import functools
import logging

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.serving import scheduler as jsched
from repro.serving.scheduler import ContinuousEngine as JContinuousEngine
from repro.serving.snapshot import take_owner_row as jtake_owner_row
from repro.sharding import mesh_fingerprint as jmesh_fingerprint
from repro.sharding import slot_cache_specs as jslot_cache_specs
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
from repro_torch.models import init_cache, init_params
from repro_torch.serving import (EVENT_KINDS, ContinuousEngine, Fault,
                                 FaultPlan, Request, ShardedContinuousEngine,
                                 ShardedPagedContinuousEngine, Status,
                                 SpeculativeConfig, parse_event)
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.snapshot import take_owner_row
from repro_torch.sharding import mesh_fingerprint, slot_cache_specs

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

MAX_LEN = 64


@functools.lru_cache(maxsize=None)
def _params(arch):
    return init_params(get_smoke_config(arch), seed=0, device="cpu")


def _mesh(n):
    return make_serving_mesh(n, ["cpu"] * n)


def _prompts(cfg, lens):
    return [np.random.default_rng(s).integers(0, cfg.vocab, (t,))
            .astype(np.int32) for s, t in enumerate(lens)]


def _staggered(cfg, lens, news, extras=None):
    """More requests than slots, the later ones arriving 0.05 s in."""
    return [Request(uid=i, tokens=p, max_new=m,
                    arrival_time=0.0 if i < 3 else 0.05,
                    **(extras or {}).get(i, {}))
            for i, (p, m) in enumerate(zip(_prompts(cfg, lens), news))]


def _tokens(results):
    return {r.uid: r.tokens for r in results}


def _assert_same(got, want, what):
    assert got.keys() == want.keys(), what
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"{what} uid={uid}")


# ---------------------------------------------------------------------------
# the scheduler against the reference's, on the same traces
# ---------------------------------------------------------------------------

def _trace(mod, case):
    """Drive ``mod``'s ``ShardedSlotScheduler`` through ``case``; returns
    what it observed (slots, shards, uids, free lists)."""
    def req(uid, t=8, arrival=0.0):
        return mod.Request(uid=uid, tokens=np.zeros((t,), np.int32),
                           max_new=1, arrival_time=arrival)

    out = []
    if case == "mapping":
        s = mod.ShardedSlotScheduler(n_shards=2, slots_per_shard=3)
        out += [s.n_slots, [s.shard_of(i) for i in range(6)],
                [s.local_slot(i) for i in range(6)], s.free_on(1)]
    elif case == "least_loaded":
        s = mod.ShardedSlotScheduler(n_shards=2, slots_per_shard=2)
        for i in range(4):
            s.submit(req(i))
        slots = [s.next_admission(now=1.0)[0] for _ in range(4)]
        out += [slots, s.next_admission(now=1.0)]
        s.submit(req(9))
        s.release(next(x for x in slots if s.shard_of(x) == 1))
        slot, r = s.next_admission(now=1.0)
        out += [slot, r.uid, [s.load(i) for i in range(2)]]
    elif case == "restriction":
        s = mod.ShardedSlotScheduler(n_shards=2, slots_per_shard=1)
        s.submit(req(0))
        s.submit(req(1))
        out += [s.next_admission(now=1.0, shard=1)[0],
                s.next_admission(now=1.0, shard=1),
                s.next_admission(now=1.0, shard=0)[0]]
    elif case == "policy":
        s = mod.ShardedSlotScheduler(n_shards=2, slots_per_shard=1,
                                     policy=mod.ShortestPromptFirst())
        s.submit(req(0, t=32))
        s.submit(req(1, t=8))
        out.append(s.next_admission(now=1.0)[1].uid)
        s2 = mod.ShardedSlotScheduler(n_shards=2, slots_per_shard=1)
        s2.submit(req(0, arrival=9.9))
        out.append(s2.next_admission(now=1.0))
    elif case == "drained":
        s = mod.ShardedSlotScheduler(n_shards=3, slots_per_shard=2)
        s.drained.add(1)
        for i in range(6):
            s.submit(req(i))
        out += [s.healthy_free(), s.next_admission(now=1.0, shard=1)]
        out.append([s.next_admission(now=1.0)[0] for _ in range(4)])
        out += [s.next_admission(now=1.0), s.free]
        s.release(0)
        s.resumable[5] = "snapshot"
        out.append(s.next_resume(now=1.0))   # FIFO ranks uid 4 first
        s.queue.reverse()
        out.append(s.next_resume(now=1.0))
    elif case == "reassign":
        s = mod.ShardedSlotScheduler(n_shards=2, slots_per_shard=2)
        for i in range(3):
            s.submit(req(i))
        slots = [s.next_admission(now=1.0)[0] for _ in range(3)]
        s.mark_prefilling(slots[1])
        r = s.reassign(slots[1], 3)
        out += [slots, r.uid, sorted(s.active), s.phase[3], s.free,
                [s.load(i) for i in range(2)]]
    elif case == "gate":
        s = mod.ShardedSlotScheduler(n_shards=2, slots_per_shard=2)
        seen = []
        s.admission_gate = lambda r, shard, resumable: (
            seen.append((r.uid, shard, resumable)) or shard == 1)
        for i in range(3):
            s.submit(req(i))
        out += [[s.next_admission(now=1.0) is not None for _ in range(3)],
                sorted(s.active), seen]
    return [x if not isinstance(x, tuple) else (x[0], x[1].uid) for x in out]


@pytest.mark.parametrize("case", ["mapping", "least_loaded", "restriction",
                                  "policy", "drained", "reassign", "gate"])
def test_sharded_scheduler_matches_reference(case):
    assert _trace(tsched, case) == _trace(jsched, case)


def test_take_owner_row_and_specs_match_reference():
    """The reference's stacked layout (layers ahead of the slot axis) and
    the port's (a dict a layer, the slot axis first) carry the same leaves:
    ``slot_cache_specs`` names the same slot axis, and ``take_owner_row``
    picks the same row, bit for bit."""
    for arch in ("llama3_8b", "hymba_1_5b"):
        jcache = jinit_cache(jget_smoke_config(arch), 4, 16, "nxfp4")
        tcache = init_cache(get_smoke_config(arch), 4, 16, "nxfp4",
                            device="cpu")
        jspec, tspec = jslot_cache_specs(jcache), slot_cache_specs(tcache)
        assert tuple(jspec["pos"]) == ("data",) and tspec["pos"] == 0
        for name, ax in tspec["layers"][0].items():
            assert tuple(jspec["layers"])[ax + 1] == "data", (arch, name)
        assert all(layer == tspec["layers"][0] for layer in tspec["layers"])
        assert set(tspec["layers"][0]) == set(jcache["layers"])
    rng = np.random.default_rng(0)
    n_layers, n_shards = 2, 3
    jstacked = {"pos": rng.integers(0, 9, (n_shards,)).astype(np.int32),
                "layers": {"k": rng.standard_normal(
                    (n_layers, n_shards, 5, 2)).astype(np.float32),
                    "h": rng.standard_normal(
                        (n_layers, n_shards, 4)).astype(np.float32)}}
    tstacked = {"pos": jstacked["pos"],
                "layers": [{n: v[i] for n, v in jstacked["layers"].items()}
                           for i in range(n_layers)]}
    for owner in range(n_shards):
        want = jtake_owner_row(jstacked, owner)
        got = take_owner_row(tstacked, owner)
        np.testing.assert_array_equal(got["pos"], want["pos"])
        for i in range(n_layers):
            for name, leaf in got["layers"][i].items():
                assert isinstance(leaf, np.ndarray)
                np.testing.assert_array_equal(leaf,
                                              want["layers"][name][i])


class _FakeDev:
    def __init__(self, i):
        self.id = i


class _FakeMesh:
    def __init__(self, ids, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.devices = np.array([_FakeDev(i) for i in ids])


def test_mesh_and_fingerprint():
    """``make_serving_mesh``'s mesh and ``mesh_fingerprint`` split as the
    reference's do: None, axis layouts, device sets, stable."""
    mesh = _mesh(2)
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 2}
    assert [str(d) for d in mesh.devices] == ["cpu", "cpu"]
    for fp in (mesh_fingerprint, jmesh_fingerprint):
        assert fp(None) is None
    fps = [mesh_fingerprint(m) for m in (
        _mesh(2), _mesh(4), ServingMesh(mesh.devices, ("data", "model"),
                                        {"data": 2, "model": 1}))]
    jfps = [jmesh_fingerprint(_FakeMesh(*a, **k)) for a, k in (
        (([0, 1],), dict(data=2)), (([0, 1, 2, 3],), dict(data=4)),
        (([0, 1],), dict(data=2, model=1)))]
    assert len(set(fps)) == len(set(jfps)) == 3
    assert mesh_fingerprint(_mesh(2)) == fps[0]
    with pytest.raises(ValueError, match="devices for 2 shards"):
        make_serving_mesh(2, ["cpu"])
    assert "migrate" in EVENT_KINDS and "drain" in EVENT_KINDS


@pytest.mark.parametrize("case", ["no data axis", "divisible",
                                  "data-only", "vlm"])
def test_sharded_engine_refusals(case):
    """The reference's three constructor refusals, before any device
    work, and the continuous engines' refusal of the memory families."""
    cfg, params = get_smoke_config("llama3_8b"), _params("llama3_8b")
    policy = QuantPolicy(None, None)
    cpu = _mesh(2).devices
    if case == "no data axis":
        with pytest.raises(ValueError, match="'data' mesh axis"):
            ShardedContinuousEngine(cfg, params, policy, ServingMesh(
                cpu[:1], ("model",), {"model": 1}))
    elif case == "divisible":
        with pytest.raises(ValueError, match="divisible"):
            ShardedContinuousEngine(cfg, params, policy, _mesh(2),
                                    n_slots=3, max_len=32)
    elif case == "data-only":
        with pytest.raises(ValueError, match="data-only mesh"):
            ShardedContinuousEngine(cfg, params, policy, ServingMesh(
                cpu, ("data", "model"), {"data": 1, "model": 2}),
                n_slots=2, max_len=32)
    else:
        vcfg = get_smoke_config("whisper_tiny")
        with pytest.raises(ValueError, match="do not serve"):
            ShardedContinuousEngine(vcfg, _params("whisper_tiny"), policy,
                                    _mesh(2), n_slots=2, max_len=32)


# ---------------------------------------------------------------------------
# the oracle: sharded == unsharded, bit for bit
# ---------------------------------------------------------------------------

ORACLE = {
    # dense, packed KV, ragged lane chunks, a seeded sampled request
    "llama nxfp4 P8 S2": ("llama3_8b", "nxfp4", "chunked", 8, 2,
                          [8, 17, 8, 16, 9, 8], [5, 11, 3, 8, 14, 6],
                          {1: dict(temperature=1.3, seed=17)}),
    # sliding window: a prompt wraps the ring while its neighbours churn
    "danube ring P16 S2": ("h2o_danube_3_4b", "nxfp4", "chunked", 16, 2,
                           [8, 40, 8, 16], [40, 6, 6, 6], None),
    # an 80-token prompt overruns the 64-row lane: the per-shard ring lane
    "danube ring wrap P16 S2": ("h2o_danube_3_4b", "nxfp4", "chunked", 16,
                                2, [8, 80, 8, 16], [6, 6, 6, 6], None),
    # hybrid (ring and Mamba state), whole-prompt admission on the owner
    "hymba whole S2": ("hymba_1_5b", "nxfp4", "whole", None, 2,
                       [8, 24, 17, 8], [5, 11, 3, 8], None),
    # attention-free: recurrent slots through the per-shard lanes
    "falcon P16 S2": ("falcon_mamba_7b", None, "chunked", 16, 2,
                      [8, 17, 8, 33], [5, 11, 3, 8], None),
    # one slot a shard: every admission crosses a shard boundary
    "llama whole S4": ("llama3_8b", None, "whole", None, 4,
                       [8, 17, 8, 16, 9, 8], [5, 11, 3, 8, 14, 6], None),
    "llama nxfp4 P8 S4": ("llama3_8b", "nxfp4", "chunked", 8, 4,
                          [8, 17, 8, 16, 9], [5, 11, 3, 8, 6], None),
}


@pytest.mark.parametrize("case", sorted(ORACLE))
def test_sharded_streams_match_unsharded(case):
    arch, fmt, mode, p_chunk, shards, lens, news, extras = ORACLE[case]
    cfg, params = get_smoke_config(arch), _params(arch)
    policy = QuantPolicy(fmt, fmt)
    kw = dict(n_slots=4, max_len=MAX_LEN, chunk=4, prefill_mode=mode)
    if mode == "chunked":
        kw["p_chunk"] = p_chunk
    want = _tokens(ContinuousEngine(cfg, params, policy, device="cpu",
                                    **kw).serve(_staggered(cfg, lens, news,
                                                           extras)))
    eng = ShardedContinuousEngine(cfg, params, policy, _mesh(shards), **kw)
    assert len(eng.shards) == shards
    assert all(sh.params is eng.shards[0].params for sh in eng.shards)
    got = _tokens(eng.serve(_staggered(cfg, lens, news, extras)))
    _assert_same(got, want, case)


def test_sharded_p_chunk_auto():
    """``p_chunk="auto"`` times shard 0's own decode chunk and lanes; every
    shard builds its lane at the pick, and the streams are an unsharded
    engine's at that width."""
    cfg, params = get_smoke_config("llama3_8b"), _params("llama3_8b")
    policy = QuantPolicy("nxfp4", "nxfp4")
    kw = dict(n_slots=4, max_len=MAX_LEN, chunk=4, prefill_mode="chunked")
    eng = ShardedContinuousEngine(cfg, params, policy, _mesh(2),
                                  p_chunk="auto", p_chunk_candidates=(8, 16),
                                  **kw)
    assert eng.p_chunk in (8, 16) and set(eng.p_chunk_sweep) == {8, 16}
    assert [sh.p_chunk for sh in eng.shards] == [eng.p_chunk] * 2
    reqs = _staggered(cfg, [8, 17, 11], [5, 6, 4])
    want = _tokens(ContinuousEngine(cfg, params, policy, device="cpu",
                                    p_chunk=eng.p_chunk, **kw).serve(reqs))
    _assert_same(_tokens(eng.serve(reqs)), want, "auto")


def test_sharded_greedy_streams_match_jax_engine():
    """The JAX package's own ``ContinuousEngine`` on the same weights
    (``params_from_jax``) and greedy requests: the same streams."""
    jcfg, cfg = jget_smoke_config("llama3_8b"), get_smoke_config("llama3_8b")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    kw = dict(n_slots=4, max_len=MAX_LEN, chunk=4, prefill_mode="chunked",
              p_chunk=8)
    lens, news = [8, 17, 8, 16, 9, 8], [5, 11, 3, 8, 14, 6]
    jreqs = [jsched.Request(uid=r.uid, tokens=r.tokens, max_new=r.max_new,
                            arrival_time=r.arrival_time)
             for r in _staggered(cfg, lens, news)]
    want = _tokens(JContinuousEngine(jcfg, jparams, JQuantPolicy(None, None),
                                     **kw).serve(jreqs))
    got = _tokens(ShardedContinuousEngine(
        cfg, params, QuantPolicy(None, None), _mesh(2), **kw).serve(
            _staggered(cfg, lens, news)))
    _assert_same(got, {u: np.asarray(t) for u, t in want.items()}, "jax")


# ---------------------------------------------------------------------------
# shard drain and live migration
# ---------------------------------------------------------------------------

@pytest.fixture
def events():
    msgs = []
    handler = logging.Handler()
    handler.emit = lambda rec: msgs.append(rec.getMessage())
    log = logging.getLogger("repro_torch.serving")
    log.addHandler(handler)
    old = log.level
    log.setLevel(logging.INFO)
    yield msgs
    log.removeHandler(handler)
    log.setLevel(old)


DRAIN = {"llama nxfp4 whole, shard 1": ("llama3_8b", "nxfp4", "whole", None,
                                        1, 8),
         "llama P8 saturated, shard 0": ("llama3_8b", None, "chunked", 8, 0,
                                         4),
         "hymba nxfp4 whole, shard 1": ("hymba_1_5b", "nxfp4", "whole", None,
                                        1, 8)}


@pytest.mark.parametrize("case", sorted(DRAIN))
def test_shard_drain_migration_bitwise(case, events):
    """A ``shard_down`` fault at chunk 1: every stream ends OK and bitwise
    the no-drain unsharded serve's, live requests migrate (or suspend to
    the queue when every healthy slot is taken), the drained shard takes
    no admission after the ``drain`` record, and draining the last healthy
    shard is refused at the call."""
    arch, fmt, mode, p_chunk, victim, n_slots = DRAIN[case]
    cfg, params = get_smoke_config(arch), _params(arch)
    policy = QuantPolicy(fmt, fmt)
    kw = dict(n_slots=n_slots, max_len=MAX_LEN, chunk=4, prefill_mode=mode)
    if mode == "chunked":
        kw["p_chunk"] = p_chunk

    def reqs():
        rng = np.random.default_rng(0)
        return [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (8,))
                        .astype(np.int32), max_new=m,
                        arrival_time=0.0 if i < 4 else 0.02)
                for i, m in enumerate([16, 18, 12, 14, 16, 10])]

    want = _tokens(ContinuousEngine(cfg, params, policy, device="cpu",
                                    **kw).serve(reqs()))
    eng = ShardedContinuousEngine(cfg, params, policy, _mesh(2), **kw)
    plan = FaultPlan([Fault(kind="shard_down", chunk=1, shard=victim)])
    events.clear()
    got = {r.uid: r for r in eng.serve(reqs(), fault_plan=plan)}
    assert all(r.status == Status.OK for r in got.values())
    _assert_same(_tokens(got.values()), want, case)
    evs = [e for e in map(parse_event, events) if e]
    kinds = [e["event"] for e in evs]
    assert any(e["event"] == "fault" and e["kind"] == "shard_down"
               for e in evs)
    d = kinds.index("drain")
    assert evs[d]["shard"] == victim and evs[d]["live"] > 0
    moved = [e for e in evs[d:] if e["event"] in ("migrate", "suspend")]
    assert moved and all(e["shard"] != victim for e in moved
                         if e["event"] == "migrate")
    if n_slots == 8:          # healthy free slots: a live migration
        assert "migrate" in kinds
        assert len(eng.migrate_seconds) == kinds.count("migrate")
    for e in evs[d + 1:]:
        if e["event"] in ("admit", "prefill-start", "resume"):
            assert e["shard"] != victim, e
    with pytest.raises(ValueError, match="healthy"):
        eng.drain_shard(1 - victim)
    with pytest.raises(ValueError, match="no shard"):
        eng.drain_shard(2)


# ---------------------------------------------------------------------------
# the sharded paged and speculative engines, and chaos on a shard
# ---------------------------------------------------------------------------

PAGED = [("llama3_8b", "nxfp4", "whole", None),
         ("h2o_danube_3_4b", "nxfp4", "chunked", 16),
         ("falcon_mamba_7b", None, "whole", None)]


@pytest.mark.parametrize("arch,fmt,mode,p_chunk", PAGED)
def test_sharded_paged_matches_dense(arch, fmt, mode, p_chunk):
    """A page pool a shard (local page indices, its own null page): every
    stream is the unsharded dense engine's, and every pool ends empty."""
    cfg, params = get_smoke_config(arch), _params(arch)
    policy = QuantPolicy(fmt, fmt)
    kw = dict(n_slots=4, max_len=MAX_LEN, chunk=4, prefill_mode=mode)
    if mode == "chunked":
        kw["p_chunk"] = p_chunk
    rng = np.random.default_rng(12)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,))
                    .astype(np.int32), max_new=m)
            for i, (t, m) in enumerate(zip([8, 12, 9, 8, 10, 8],
                                           [5, 9, 3, 7, 6, 4]))]
    want = _tokens(ContinuousEngine(cfg, params, policy, device="cpu",
                                    **kw).serve(reqs))
    eng = ShardedPagedContinuousEngine(cfg, params, policy, _mesh(2), **kw)
    _assert_same(_tokens(eng.serve(reqs)), want, arch)
    assert len(eng.pools) == (0 if cfg.attn_free else 2)
    for pool in eng.pools:
        pool.assert_empty()
    stats = eng.pool_stats()
    assert [st["shard"] for st in stats] == list(range(len(eng.pools)))
    assert all(st["high_watermark"] > 0 for st in stats)


def test_sharded_paged_refusals():
    cfg, params = get_smoke_config("llama3_8b"), _params("llama3_8b")
    with pytest.raises(ValueError, match="prefix_sharing"):
        ShardedPagedContinuousEngine(cfg, params, QuantPolicy(None, "nxfp4"),
                                     _mesh(2), prefix_sharing=True)
    with pytest.raises(ValueError, match="n_pages"):
        ShardedPagedContinuousEngine(cfg, params, QuantPolicy(None, "nxfp4"),
                                     _mesh(2), n_pages=9, max_len=MAX_LEN)


def test_sharded_speculative_matches_plain():
    """Speculative sharded serving emits the plain unsharded engine's
    greedy streams; ``spec_shard_stats`` splits ``spec_stats`` by shard."""
    cfg, params = get_smoke_config("llama3_8b"), _params("llama3_8b")
    policy = QuantPolicy("nxfp4", "nxfp4")
    kw = dict(n_slots=4, max_len=MAX_LEN, chunk=4)
    lens, news = [8, 17, 8, 16, 9, 8], [5, 11, 3, 8, 14, 6]
    want = _tokens(ContinuousEngine(cfg, params, policy, device="cpu",
                                    **kw).serve(_staggered(cfg, lens, news)))
    eng = ShardedContinuousEngine(cfg, params, policy, _mesh(2),
                                  speculative=SpeculativeConfig(k=4), **kw)
    _assert_same(_tokens(eng.serve(_staggered(cfg, lens, news))), want,
                 "speculative")
    per, tot = eng.spec_shard_stats(), eng.spec_stats()
    assert [d["shard"] for d in per] == [0, 1]
    assert all(d["offered"] > 0 for d in per)
    assert sum(d["accepted"] for d in per) == tot["accepted"]
    assert sum(d["offered"] for d in per) == tot["offered"]
    assert eng.shards[0].draft_params is eng.shards[1].draft_params
    with pytest.raises(ValueError, match="speculative"):
        ShardedContinuousEngine(cfg, params, policy, _mesh(2),
                                **kw).spec_shard_stats()


@pytest.mark.parametrize("kind", ["nan_logits", "kv_flip", "delay"])
def test_sharded_chaos_contained_on_its_shard(kind, events):
    """Each fault class stays on its victim's shard: the victim (uid 1,
    no retries) fails with a prefix of its fault-free stream, quarantined
    on its own shard; every other request is bitwise the fault-free
    serve's."""
    cfg, params = get_smoke_config("llama3_8b"), _params("llama3_8b")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (8,))
                    .astype(np.int32), max_new=m)
            for i, m in enumerate([6, 12, 5, 7])]
    eng = ShardedContinuousEngine(
        cfg, params, QuantPolicy(None, "nxfp4"), _mesh(2), n_slots=4,
        max_len=MAX_LEN, chunk=4, kv_integrity=True, prefill_mode="chunked",
        p_chunk=8)
    ref = {r.uid: r for r in eng.serve(reqs)}
    assert all(r.status == Status.OK for r in ref.values())
    fkw = ({"seconds": 0.05, "shard": 1} if kind == "delay"
           else {"uid": 1, "n_bytes": 2} if kind == "kv_flip"
           else {"uid": 1})
    events.clear()
    res = {r.uid: r for r in eng.serve(
        reqs, fault_plan=FaultPlan([Fault(kind=kind, chunk=1, **fkw)]))}
    healthy = [0, 1, 2, 3] if kind == "delay" else [0, 2, 3]
    if kind != "delay":
        assert res[1].status == Status.FAILED
        np.testing.assert_array_equal(res[1].tokens,
                                      ref[1].tokens[:res[1].n_generated])
        evs = [e for e in map(parse_event, events) if e]
        slot = next(e["slot"] for e in evs
                    if e["event"] == "prefill-start" and e["uid"] == 1)
        q = [e for e in evs if e["event"] == "quarantine"]
        assert [(e["uid"], e["shard"]) for e in q] == [
            (1, eng._shard_of(slot))]
    for uid in healthy:
        assert res[uid].status == Status.OK
        np.testing.assert_array_equal(res[uid].tokens, ref[uid].tokens)
