"""Continuous batching in the torch port, on the CPU at smoke size.

* The oracle (ported from ``tests/test_continuous.py``): every request
  served through the port's ``ContinuousEngine`` emits the tokens the
  port's own ``ServeEngine(loop="host")`` emits serving it alone, bit for
  bit, greedy and seeded-sampled, KV None and nxfp4.
* Against the reference, from the same numpy inputs: the chunk's
  emission masking with the per-slot budget and the scheduler's admission
  order (bitwise), the event journal (the same records), the slot surgery
  on the same cache (bitwise), ``decode_step(live=)`` (frozen rows bitwise,
  live logits within 1e-2), and the slice as a whole by teacher forcing
  (argmax agrees wherever the JAX top-2 margin exceeds twice 1e-2, as
  ``tests/test_torch_model.py:test_teacher_forced_decode``).
* The repairs the oracle needs: a decode row's logits do not depend on
  the batch (bitwise at B 1 to 4), and a K/V row outside the cache is
  skipped on every path.

Tolerance 1e-2 on logits: the reason is ``tests/test_torch_model.py``'s
(bf16 activations rounded per op in torch, fused in XLA).
"""
import dataclasses
import functools
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.core.qtensor import direct_cast_tree as jdirect_cast_tree
from repro.kernels.ops import quantize_qtensor as jquantize_qtensor
from repro.models import decode_step as jdecode_step
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models import read_cache_slot as jread_cache_slot
from repro.models import reset_slot as jreset_slot
from repro.models import write_cache_slot as jwrite_cache_slot
from repro.serving import events as jevents
from repro.serving import scheduler as jsched
from repro.serving.engine import mask_chunk_emissions as jmask
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.kernels.nxfp_quantize import nxfp_quantize_kv_rows
from repro_torch.models import (decode_step, init_cache, init_params,
                                prefill, read_cache_slot, reset_slot,
                                write_cache_slot)
from repro_torch.models.kvcache import write_token
from repro_torch.serving import (ContinuousEngine, FifoPolicy,
                                 PriorityAdmission, Request,
                                 ShortestPromptFirst, SlotScheduler,
                                 mask_chunk_emissions, replay)
from repro_torch.serving import events

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


def _port_setup(arch):
    """``arch``'s smoke config and the port's own seeded params: the oracle
    below holds the port against itself, and needs no reference params."""
    cfg = get_smoke_config(arch)
    return None, cfg, None, init_params(cfg, seed=0, device="cpu")


def _prompts(cfg, n, t, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
            for _ in range(n)]


def _engine(setup, fmt, **kw):
    cfg, params = setup[1], setup[3]
    kw = {"n_slots": 2, "max_len": MAX_LEN, "chunk": 4, **kw}
    return ContinuousEngine(cfg, params, QuantPolicy(fmt, fmt), device="cpu",
                            **kw)


def _solo(setup, fmt, req):
    """The oracle: the request served alone by the port's host loop (once
    a process per request, format and params)."""
    return solo_stream(setup[1], setup[3], QuantPolicy(fmt, fmt), req,
                       MAX_LEN)


def _assert_solo(setup, fmt, reqs, results):
    assert sorted(r.uid for r in results) == sorted(r.uid for r in reqs)
    by_uid = {r.uid: r for r in reqs}
    for r in results:
        solo = _solo(setup, fmt, by_uid[r.uid])
        n = int(solo.n_generated[0])
        assert r.n_generated == n
        np.testing.assert_array_equal(r.tokens, solo.tokens[0, :n],
                                      err_msg=f"uid={r.uid}")


# ---------------------------------------------------------------------------
# the oracle: continuous == solo host loop, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,fmt", [
    pytest.param("llama3_8b", None, id="None"),
    pytest.param("llama3_8b", "nxfp4", id="nxfp4"),
    # sliding window 32: 30-token prompts whose decode wraps the ring
    # (rows 30, 31, then 0, ...), 3 requests over the 2 slots (the
    # reference's test_continuous_ring_wrap_matches_solo)
    pytest.param("h2o_danube_3_4b", "nxfp4", id="danube-nxfp4"),
    # the hybrid family: the ring and the Mamba state reset on reuse; the
    # attention-free family: slots of recurrent state only (the
    # reference's rows)
    pytest.param("hymba_1_5b", "nxfp4", id="hymba-nxfp4"),
    pytest.param("falcon_mamba_7b", None, id="falcon-None")])
def test_continuous_matches_solo_host(arch, fmt):
    """Greedy: 5 requests with mixed max_new over 2 slots (evictions,
    re-admissions, ragged per-slot positions mid-stream)."""
    setup = _setup(arch) if arch == "llama3_8b" else _port_setup(arch)
    eng = _engine(setup, fmt)
    t, news = ((30, [6, 4, 3]) if setup[1].sliding_window
               else (8, [5, 11, 3, 8, 14]))
    reqs = [Request(uid=i, tokens=p, max_new=m)
            for i, (p, m) in enumerate(zip(_prompts(setup[1], 5, t),
                                           news))]
    results = eng.serve(reqs)
    assert all(r.n_generated == reqs[r.uid].max_new for r in results)
    _assert_solo(setup, fmt, reqs, results)
    assert eng.chunks > 0 and len(eng.admit_seconds) == len(reqs)
    assert eng.replays == 0                        # the CPU runs eagerly


@pytest.mark.parametrize("fmt", [None, "nxfp4"])
def test_continuous_stop_token_and_seeded_sampling(setup, fmt):
    """A stop token and per-request seeds survive the scheduler: sampled
    requests reproduce ``ServeEngine(rng_seed=seed)`` serving them alone,
    also when admitted into a slot another sampled request used before
    (its generator re-seeded), and a stop-terminated request emits through
    its stop hit."""
    cfg = setup[1]
    first = Request(uid=0, tokens=_prompts(cfg, 1, 8)[0], max_new=9)
    stop = int(_solo(setup, fmt, first).tokens[0, 3])   # stops after 4
    reqs = [dataclasses.replace(first, stop_token=stop),
            Request(uid=1, tokens=_prompts(cfg, 1, 8, seed=5)[0], max_new=7,
                    temperature=1.3, seed=17),
            Request(uid=2, tokens=_prompts(cfg, 1, 8, seed=6)[0], max_new=7,
                    temperature=0.8, seed=23),
            Request(uid=3, tokens=_prompts(cfg, 1, 8, seed=7)[0], max_new=6,
                    temperature=1.0, seed=29)]
    eng = _engine(setup, fmt)
    results = eng.serve(reqs)
    _assert_solo(setup, fmt, reqs, results)
    got = {r.uid: r for r in results}
    assert got[0].tokens[-1] == stop and got[0].n_generated == 4
    # a second serve of the same requests gives the same tokens
    again = {r.uid: r.tokens for r in eng.serve(reqs)}
    for uid, r in got.items():
        np.testing.assert_array_equal(again[uid], r.tokens)


def test_continuous_rejects_overflowing_request(setup):
    """prompt + max_new beyond max_len fails at submit."""
    eng = _engine(setup, None, max_len=32)
    bad = Request(uid=0, tokens=np.zeros((20,), np.int32), max_new=20)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.serve([bad])


def test_continuous_staggered_arrivals_metrics(setup):
    """Arrival times gate admission; metrics stay causal (queue_delay >= 0,
    ttft >= queue_delay, every token accounted), and the journal holds
    one admit and one finish per request in one sequence."""
    cfg = setup[1]
    eng = _engine(setup, None)
    reqs = [Request(uid=i, tokens=p, max_new=6,
                    arrival_time=0.0 if i < 2 else 0.05)
            for i, p in enumerate(_prompts(cfg, 4, 8))]
    msgs = []
    handler = logging.Handler()
    handler.emit = lambda rec: msgs.append(rec.getMessage())
    log = logging.getLogger("repro_torch.serving")
    log.addHandler(handler)
    old = log.level
    log.setLevel(logging.INFO)
    try:
        results = eng.serve(reqs)
    finally:
        log.removeHandler(handler)
        log.setLevel(old)
    assert len(results) == 4
    for r in results:
        assert r.n_generated == 6 and r.ok
        assert r.queue_delay >= 0.0
        assert r.ttft >= r.queue_delay
        assert r.decode_seconds > 0.0
    late = [r for r in results if r.uid >= 2]
    assert all(r.ttft + reqs[r.uid].arrival_time >= 0.05 for r in late)
    _assert_solo(setup, None, reqs, results)
    evs, gaps = replay(msgs)
    assert gaps == [] and [e["seq"] for e in evs] == list(range(8))
    assert sorted(e["uid"] for e in evs if e["event"] == "admit") == \
        [0, 1, 2, 3]
    assert sorted(e["uid"] for e in evs if e["event"] == "finish") == \
        [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_chunk_emissions_budget_matches_reference(seed):
    """The chunk's masking with the per-slot max_new budget, bitwise."""
    rng = np.random.default_rng(seed)
    b, n = 8, 7
    toks = rng.integers(0, 5, (b, n)).astype(np.int32)
    done = rng.random(b) < 0.3
    n_gen = rng.integers(0, 6, b).astype(np.int32)
    stop = rng.integers(-1, 5, b).astype(np.int32)
    max_new = (n_gen + rng.integers(0, 9, b)).astype(np.int32)
    ref = jmask(jnp.asarray(toks), jnp.asarray(done), jnp.asarray(n_gen),
                jnp.asarray(stop), jnp.asarray(max_new))
    got = mask_chunk_emissions(*(torch.from_numpy(a) for a in
                                 (toks, done, n_gen, stop, max_new)))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


POLICIES = {"fifo": (FifoPolicy, jsched.FifoPolicy),
            "spf": (ShortestPromptFirst, jsched.ShortestPromptFirst),
            "priority": (PriorityAdmission, jsched.PriorityAdmission)}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_slot_scheduler_admission_order_matches_reference(policy):
    """The same queue, clock and releases through both schedulers give the
    same (slot, uid) admission sequence."""
    rng = np.random.default_rng(3)
    n = 12
    spec = [dict(uid=i, tokens=np.zeros((int(rng.integers(1, 30)),),
                                        np.int32),
                 max_new=4, arrival_time=float(rng.integers(0, 6)),
                 priority=int(rng.integers(0, 3))) for i in range(n)]
    port = SlotScheduler(3, POLICIES[policy][0]())
    ref = jsched.SlotScheduler(3, POLICIES[policy][1]())
    for s in spec:
        port.submit(Request(**s))
        ref.submit(jsched.Request(**s))
    seq = {"port": [], "ref": []}
    for now in range(12):
        for name, sch in (("port", port), ("ref", ref)):
            while (adm := sch.next_admission(float(now))) is not None:
                seq[name].append((adm[0], adm[1].uid))
            # the oldest admitted slot finishes at every tick
            if sch.active:
                sch.release(min(sch.active, key=lambda s: sch.active[s].uid))
        assert port.has_work == ref.has_work
        assert port.next_arrival() == ref.next_arrival()
    assert seq["port"] == seq["ref"] and len(seq["port"]) == n


def _capture(logger_name):
    msgs = []
    handler = logging.Handler()
    handler.emit = lambda rec: msgs.append(rec.getMessage())
    log = logging.getLogger(logger_name)
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    return msgs, lambda: log.removeHandler(handler)


def test_journal_and_replay_match_reference():
    """The same emits through both journals log the same records, and
    replay gives the same events and gaps, also from a shuffled log with
    a duplicate, a lost record and human text."""
    records = [("admit", dict(uid=1, slot=0, prompt=8, queue_delay=0.5)),
               ("finish", dict(uid=1, slot=0, status="OK", n=3,
                               ttft=np.float32(0.25), tok_s=None)),
               ("admit", dict(uid=2, slot=1, prompt=4)),
               ("finish", dict(uid=2, slot=1, status="OK", n=0))]
    logs = {}
    for name, mod in (("port", events), ("ref", jevents)):
        msgs, done = _capture(f"test_journal_{name}")
        j = mod.Journal(start=5)
        for ev, fields in records:
            j.emit(logging.getLogger(f"test_journal_{name}"), ev, **fields)
        mod.emit(logging.getLogger(f"test_journal_{name}"), "drain", n=1)
        done()
        logs[name] = msgs
        assert j.seq == 9
    assert logs["port"] == logs["ref"]
    assert events.EVENT_KINDS == jevents.EVENT_KINDS
    msgs = logs["port"]
    mixed = [msgs[3], "compiling prefill", msgs[0], msgs[0], msgs[4],
             msgs[1], "{not json"]
    for seq in (msgs, mixed):
        assert replay(seq) == jevents.replay(seq)
    assert replay(mixed)[1] == [7]
    assert events.parse_event("{not json") is None
    assert json.loads(msgs[0])["seq"] == 5


def _random_cache(jcfg, b, kv, seed):
    """A reference cache of random contents (numpy leaves) and the port's
    copy (per-layer list, the same bits)."""
    rng = np.random.default_rng(seed)
    jc = jax.tree.map(np.asarray, jinit_cache(jcfg, b, 16, kv))
    out = {"pos": rng.integers(0, 16, b).astype(np.int32), "layers": {}}
    for name, leaf in jc["layers"].items():
        if leaf.dtype == np.uint8 or leaf.dtype == np.uint16:
            out["layers"][name] = rng.integers(
                0, np.iinfo(leaf.dtype).max, leaf.shape).astype(leaf.dtype)
        else:
            out["layers"][name] = np.asarray(
                jnp.asarray(rng.standard_normal(leaf.shape), leaf.dtype))
    return out


def _port_cache(c):
    return {"pos": tensor_from_numpy(c["pos"]),
            "layers": [{name: _to_torch(leaf[i])
                        for name, leaf in c["layers"].items()}
                       for i in range(next(iter(c["layers"].values()))
                                      .shape[0])]}


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return tensor_from_numpy(a)


def _assert_same_cache(port, ref):
    np.testing.assert_array_equal(port["pos"].numpy(), np.asarray(ref["pos"]))
    for name, leaf in ref["layers"].items():
        leaf = np.asarray(leaf)
        for i, layer in enumerate(port["layers"]):
            got = layer[name]
            want = leaf[i]
            if got.dtype == torch.bfloat16:
                got, want = got.float(), np.asarray(want, np.float32)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{name} layer {i}")


@pytest.mark.parametrize("kv", [None, "nxfp4"])
def test_slot_surgery_matches_reference(setup, kv):
    """write_cache_slot, read_cache_slot and reset_slot on the same cache,
    bitwise; the read -> write round trip is the identity."""
    jcfg, cfg = setup[:2]
    live = _random_cache(jcfg, 3, kv, 1)
    solo = _random_cache(jcfg, 1, kv, 2)
    ref = jwrite_cache_slot(jax.tree.map(jnp.asarray, live),
                            jax.tree.map(jnp.asarray, solo), 1)
    got = write_cache_slot(_port_cache(live), _port_cache(solo), 1)
    _assert_same_cache(got, ref)
    _assert_same_cache(read_cache_slot(got, 2), jread_cache_slot(ref, 2))
    before = {"pos": got["pos"].clone(),
              "layers": [{k: v.clone() for k, v in layer.items()}
                         for layer in got["layers"]]}
    write_cache_slot(got, read_cache_slot(got, 0), 2)
    write_cache_slot(got, read_cache_slot(before, 2), 2)
    _assert_same_cache(got, jax.tree.map(np.asarray, ref))
    _assert_same_cache(reset_slot(cfg, got, 0), jreset_slot(jcfg, ref, 0))
    del before


@functools.lru_cache(maxsize=None)
def _jfns(jcfg, kv):
    return (jax.jit(lambda p, b: jprefill(jcfg, p, b, max_len=MAX_LEN,
                                          kv_fmt=kv)),
            jax.jit(lambda p, t, c, live: jdecode_step(jcfg, p, t, c, kv,
                                                        live=live)))


_CASTS = {}


def _cast_both(setup, wf):
    jcfg, cfg, jparams, tparams = setup
    if wf is None:
        return jparams, tparams
    if wf not in _CASTS:
        jq = jdirect_cast_tree(jparams, JQuantPolicy(wf, wf),
                               quantize_fn=jax.jit(jquantize_qtensor,
                                                   static_argnums=(1, 2)))
        tq = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
        _CASTS[wf] = jq, tq
    return _CASTS[wf]


@pytest.mark.parametrize("kv", [None, "nxfp4"])
def test_decode_step_live_matches_reference(setup, kv):
    """From the same prefilled cache: a not-live row's cache and pos are
    unchanged bitwise; live rows' logits are within 1e-2 of the
    reference's ``decode_step(live=)``, and bit-identical to
    ``live=None``."""
    jcfg, cfg = setup[:2]
    jq, tq = _cast_both(setup, "nxfp4")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (3, 9))
    jprefill_fn, jdecode_fn = _jfns(jcfg, kv)
    _, jc = jprefill_fn(jq, {"tokens": jnp.asarray(toks)})
    tl, tc = prefill(cfg, tq, {"tokens": torch.from_numpy(toks)},
                     max_len=MAX_LEN, kv_fmt=kv)
    live = np.array([True, False, True])
    tok = np.array([[3], [5], [7]], np.int32)
    jl, _ = jdecode_fn(jq, jnp.asarray(tok), jc, jnp.asarray(live))
    before = read_cache_slot(tc, 1)
    plain = {"pos": tc["pos"].clone(),
             "layers": [{k: v.clone() for k, v in layer.items()}
                        for layer in tc["layers"]]}
    got, new = decode_step(cfg, tq, torch.from_numpy(tok).long(), tc, kv,
                           live=torch.from_numpy(live))
    ref_none, _ = decode_step(cfg, tq, torch.from_numpy(tok).long(), plain,
                              kv)
    assert new["pos"].tolist() == [10, 9, 10]
    after = read_cache_slot(new, 1)
    for a, b in zip(after["layers"], before["layers"]):
        for name in a:
            assert torch.equal(a[name], b[name])
    np.testing.assert_allclose(got.numpy()[live], np.asarray(jl)[live],
                               rtol=0, atol=TOL)
    mask = torch.from_numpy(live)
    assert torch.equal(got[mask], ref_none[mask])


def test_continuous_teacher_forced_matches_reference(setup):
    """The slice as a whole: each request's continuous tokens (nxfp4
    weights and KV), fed through the JAX model, agree with its argmax
    wherever the JAX top-2 margin exceeds twice the tolerance."""
    jcfg, cfg, jparams, tparams = setup
    jq, _ = _cast_both(setup, "nxfp4")
    eng = _engine(setup, "nxfp4")
    reqs = [Request(uid=i, tokens=p, max_new=m)
            for i, (p, m) in enumerate(zip(_prompts(cfg, 4, 8, seed=9),
                                           [6, 10, 4, 8]))]
    results = eng.serve(reqs)
    jprefill_fn, jdecode_fn = _jfns(jcfg, "nxfp4")
    agreed = 0
    for r in results:
        jl, jc = jprefill_fn(jq, {"tokens": jnp.asarray(
            reqs[r.uid].tokens[None])})
        for i, tok in enumerate(r.tokens):
            jl_np = np.asarray(jl)[0]
            top2 = np.sort(jl_np)[-2:]
            if top2[1] - top2[0] > 2 * TOL:
                assert tok == jl_np.argmax(), (r.uid, i)
                agreed += 1
            jl, jc = jdecode_fn(jq, jnp.asarray([[tok]], jnp.int32), jc,
                                None)
    assert agreed > 0
    print(f"argmax checked on {agreed} of "
          f"{sum(len(r.tokens) for r in results)} teacher-forced tokens")


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", [None, "nxfp4"])
@pytest.mark.parametrize("kv", [None, "nxfp4"])
def test_decode_step_rows_batch_invariant(setup, kv, weights):
    """Row b of a B-row decode step equals the same row at B = 1, bitwise
    (B 2 to 4, ragged lengths): each row prefilled alone, the batch caches
    are the rows' caches side by side."""
    cfg = setup[1]
    _, params = _cast_both(setup, weights)
    rows = []
    for i, t in enumerate((9, 5, 13, 2)):
        toks = torch.from_numpy(_prompts(cfg, 1, t, seed=20 + i)[0])[None]
        logits, cache = prefill(cfg, params, {"tokens": toks.long()},
                                max_len=MAX_LEN, kv_fmt=kv)
        rows.append((logits.argmax(-1), cache))

    def step(sel):
        cache = {"pos": torch.cat([rows[i][1]["pos"] for i in sel]),
                 "layers": [{k: torch.cat([rows[i][1]["layers"][li][k]
                                           for i in sel])
                             for k in rows[0][1]["layers"][li]}
                            for li in range(cfg.n_layers)]}
        tok = torch.cat([rows[i][0] for i in sel])[:, None]
        return decode_step(cfg, params, tok, cache, kv)[0]

    solo = [step([i])[0] for i in range(4)]
    for b in (2, 3, 4):
        got = step(list(range(b)))
        for i in range(b):
            assert torch.equal(got[i], solo[i]), (b, i)


@pytest.mark.parametrize("kv", [None, "nxfp4"])
def test_write_token_skips_rows_past_the_cache(setup, kv):
    """A decode write at a row outside [0, S), or for a not-live slot,
    leaves the cache as it was (the reference clamps it to row S - 1,
    which nothing reads); the other slots' rows are written."""
    cfg = setup[1]
    cache = init_cache(cfg, 3, 8, kv, device="cpu")["layers"][0]
    k1 = torch.randn((3, 1, cfg.n_kv_heads, cfg.hd))
    v1 = torch.randn((3, 1, cfg.n_kv_heads, cfg.hd))
    pos = torch.tensor([8, 5, 11], dtype=torch.int32)
    write_token(cfg, cache, k1, v1, pos, kv)
    write_token(cfg, cache, k1, v1, torch.tensor([2, 2, 2], dtype=torch.int32), kv,
                live=torch.tensor([False, False, True]))
    for name, buf in cache.items():
        written = buf.reshape(3, 8, -1).ne(0).any(-1)     # (slot, row)
        assert written[1].tolist() == [r == 5 for r in range(8)], name
        assert written[2].tolist() == [r == 2 for r in range(8)], name
        assert not written[0].any(), name


def test_kv_rows_plain_skips_rows_past_the_cache(setup):
    """The plain K/V write of T rows at ``pos[b] + t`` writes the rows
    inside the cache and skips the rest, as the CUDA kernel does."""
    cfg = setup[1]
    from repro_torch.core.formats import get_format
    cache = init_cache(cfg, 2, 8, "nxfp4", device="cpu")["layers"][0]
    k = torch.randn((2, 4, cfg.n_kv_heads, cfg.hd)) + 3.0
    nxfp_quantize_kv_rows(k, k, cache, torch.tensor([6, 1], dtype=torch.int32),
                          get_format("nxfp4"))
    written = cache["k_meta"].reshape(2, 8, -1).ne(0).any(-1)
    assert written[0].tolist() == [r >= 6 for r in range(8)]
    assert written[1].tolist() == [1 <= r < 5 for r in range(8)]
