"""Per-slot serving tiers in the torch port (``serving/tiers.py``), on the
CPU at smoke size.

* Against the reference, from the same inputs: ``TierSpec``'s and the
  engine's refusals, ``kv_row_bytes`` for every KV format, ``repack_kv``
  on the same packed bytes (bitwise), the slot-state round trip
  (``pack_device_state``/``unpack_device_state``), and the economy tier's
  quantized-activation prefill (``prefill_into_slot(act_fmt="amxfp4")``,
  its first-token logits within ``ACT_TOL``, ``tests/test_torch_act.py``'s
  2e-2: bf16 activations rounded per op in torch, fused in XLA).
* The tier guarantees, bitwise: a tier engine restricted to one tier is
  the plain ``ContinuousEngine`` at that policy, in both admission modes;
  in a mixed-tier serve, greedy and sampled, every stream is its request
  served alone at its tier (the port's host loop; an ``act_fmt`` tier
  prefills with quantized activations), and a second serve repeats it.
  Sampling is where a group's dispatch could move the other groups'
  generators.
* The degrade rung: at the pool watermark a premium slot's K/V is
  re-encoded into the cheap tier (its rows the plain codec's encode of its
  dense rows, bitwise), the result flagged degraded, a ``kv-repack``
  event journaled; below the watermark nothing moves.
"""
import dataclasses
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
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import prefill_into_slot as jprefill_into_slot
from repro.serving import snapshot as jsnapshot
from repro.serving import tiers as jtiers
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.models import (init_cache, prefill, prefill_into_slot,
                                read_cache_slot)
from repro_torch.serving import (ContinuousEngine, DegradeOverBudget,
                                 Request, TieredContinuousEngine,
                                 TierSpec, default_tiers, events,
                                 kv_row_bytes, pack_device_state, repack_kv,
                                 slot_row_capacity, unpack_device_state)

from _torch_helpers import TierSolo, solo_stream  # one intra-op thread

ACT_TOL = 2e-2
MAX_LEN = 64


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_smoke_config("llama3_8b")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, get_smoke_config("llama3_8b"), jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (t,)).astype(np.int32) for t in lens]


def _reqs(cfg, lens, max_news, tiers=None, sampled=()):
    return [Request(uid=i, tokens=p, max_new=m, tier=t, seed=20 + i,
                    temperature=0.9 + 0.2 * i if i in sampled else 0.0)
            for i, (p, m, t) in enumerate(
                zip(_prompts(cfg, lens), max_news,
                    tiers or [None] * len(lens)))]


def _solo(setup, spec, req):
    """The request's tokens served alone at the tier (once a process per
    request, tier formats and params)."""
    out = solo_stream(setup[1], setup[3],
                      QuantPolicy(spec.weight_fmt, spec.kv_fmt), req, MAX_LEN,
                      engine=TierSolo, act_fmt=spec.act_fmt)
    return out.tokens[0, :int(out.n_generated[0])]


def _kw(mode):
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=4, device="cpu")
    if mode == "chunked":
        kw.update(prefill_mode="chunked", p_chunk=8)
    return kw


@pytest.fixture
def journal():
    """The port's scheduler event records of the test."""
    records = []

    class Handler(logging.Handler):
        def emit(self, rec):
            e = events.parse_event(rec.getMessage())
            if e:
                records.append(e)

    h = Handler()
    log = logging.getLogger("repro_torch.serving.scheduler")
    old = log.level
    log.addHandler(h)
    log.setLevel(logging.INFO)
    yield records
    log.removeHandler(h)
    log.setLevel(old)


# ---------------------------------------------------------------------------
# specs, prices and refusals against the reference
# ---------------------------------------------------------------------------

def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kw", [
    dict(), dict(kv_fmt="amxfp4"), dict(kv_fmt="amxfp4_ox"),
    dict(act_fmt="amxfp4"), dict(weight_fmt="nxfp9z"),
    dict(kv_fmt="nxfp4_bs64", act_fmt="amxfp4_bs64"),
    dict(weight_fmt=None, kv_fmt=None), dict(act_fmt="bogus")],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_tier_spec_matches_reference(kw):
    """The same fields, or the same refusal (an unknown format name; a
    uint32-meta format as the KV format)."""
    got = _outcome(lambda: dataclasses.astuple(TierSpec(**kw)))
    want = _outcome(lambda: dataclasses.astuple(jtiers.TierSpec(**kw)))
    assert got == want
    assert default_tiers() == {
        k: TierSpec(*dataclasses.astuple(v))
        for k, v in jtiers.default_tiers().items()}


def test_engine_refusals(setup):
    """The reference's refusals at init and at submit."""
    cfg, params = setup[1], setup[3]
    tiers = {"a": TierSpec(None, None, None)}
    kw = dict(n_slots=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        TieredContinuousEngine(cfg, params, {}, **kw)
    with pytest.raises(ValueError, match="default_tier"):
        TieredContinuousEngine(cfg, params, tiers, default_tier="zzz", **kw)
    with pytest.raises(ValueError, match="degrade_kv_to"):
        TieredContinuousEngine(cfg, params, tiers, degrade_kv_to="zzz", **kw)
    with pytest.raises(ValueError, match="p_chunk"):
        TieredContinuousEngine(cfg, params, tiers, prefill_mode="chunked",
                               p_chunk="auto", **kw)
    eng = TieredContinuousEngine(cfg, params, tiers, **kw)
    with pytest.raises(ValueError, match="unknown tier"):
        eng.serve([Request(uid=0, tokens=np.zeros((4,), np.int32),
                           max_new=2, tier="gold")])


KV_FORMATS = [None, "nxfp4", "nxfp6", "nxfp8", "nxfp3", "mxfp4", "bfp4",
              "nxfp4_bs16", "nxfp4_bs64", "mxfp6_e3m2"]


@pytest.mark.parametrize("wide", [False, True], ids=["smoke", "hd64"])
@pytest.mark.parametrize("fmt", KV_FORMATS, ids=str)
def test_kv_row_bytes_matches_reference(setup, fmt, wide):
    jcfg, cfg = setup[:2]
    if wide:
        jcfg = dataclasses.replace(jcfg, d_model=256, n_heads=4,
                                   n_kv_heads=2)
        cfg = dataclasses.replace(cfg, d_model=256, n_heads=4, n_kv_heads=2)
    assert kv_row_bytes(cfg, fmt) == jtiers.kv_row_bytes(jcfg, fmt) > 0


def _dense_rows(cfg, rows, pos, seed=0):
    """(L, 1, S, KVH, hd) bf16 K and V, zero past ``pos``."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, 1, rows, cfg.n_kv_heads, cfg.hd)
    out = []
    for _ in range(2):
        a = np.zeros(shape, np.float32)
        a[:, :, :pos] = rng.standard_normal(shape[:2] + (pos,) + shape[3:])
        out.append(np.asarray(jnp.asarray(a, jnp.bfloat16).astype(
            jnp.float32)))
    return out


def _solo_pair(cfg, fmt, rows=16, pos=9):
    """The same slot slice for the reference (stacked layers, jnp) and the
    port (a list of layers, torch), K/V encoded at ``fmt`` by the
    reference's codec (its bytes are the port's: the codec is bitwise)."""
    k, v = _dense_rows(cfg, rows, pos)
    jl = {}
    for base, val in (("k", k), ("v", v)):
        if fmt is None:
            jl[base] = jnp.asarray(val, jnp.bfloat16)
        else:
            qt = jquantize_qtensor(jnp.asarray(val, jnp.bfloat16), fmt,
                                   axis=-1)
            jl[f"{base}_packed"], jl[f"{base}_meta"] = qt.packed, qt.meta
    jsolo = {"pos": np.array([pos], np.int32), "layers": jl}
    tsolo = {"pos": torch.tensor([pos], dtype=torch.int32),
             "layers": [{name: _to_torch(leaf[i])
                         for name, leaf in jl.items()}
                        for i in range(cfg.n_layers)]}
    return jsolo, tsolo


def _to_torch(x):
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _assert_solo_equal(tsolo, jsolo, n_layers):
    assert int(tsolo["pos"][0]) == int(np.asarray(jsolo["pos"])[0])
    for i in range(n_layers):
        assert set(tsolo["layers"][i]) == set(jsolo["layers"])
        for name, leaf in tsolo["layers"][i].items():
            want = _to_torch(jsolo["layers"][name][i])
            assert leaf.dtype == want.dtype, name
            assert torch.equal(leaf, want), (i, name)


@pytest.mark.parametrize("src,dst", [(None, "nxfp4"), ("nxfp4", None),
                                     ("nxfp4", "nxfp6"), ("nxfp6", "nxfp4"),
                                     (None, "nxfp4_bs16"),
                                     ("nxfp4", "nxfp4")], ids=str)
def test_repack_kv_matches_reference(setup, src, dst):
    """The same slot bytes re-encoded by both packages: the same bytes
    out (packed codes, meta, bf16 rows), ``pos`` passed through."""
    jcfg, cfg = setup[:2]
    jsolo, tsolo = _solo_pair(cfg, src)
    _assert_solo_equal(repack_kv(cfg, tsolo, src, dst),
                       jtiers.repack_kv(jcfg, jsolo, src, dst),
                       cfg.n_layers)


@pytest.mark.parametrize("fmt", [None, "nxfp4"], ids=str)
def test_slot_state_round_trip_matches_reference(setup, fmt):
    """``pack_device_state`` trims the K/V rows to ``used``,
    ``unpack_device_state`` pads zeros back to the capacity: the
    reference's bytes at each step, and the rows below ``used`` kept."""
    cfg = setup[1]
    jsolo, tsolo = _solo_pair(cfg, fmt, rows=16, pos=9)
    assert slot_row_capacity(tsolo) == 16
    assert slot_row_capacity({"pos": tsolo["pos"], "layers": []}) is None
    for used in (0, 5, 16):
        tpack = pack_device_state(tsolo, used)
        jpack = jsnapshot.pack_device_state(
            {"pos": jsolo["pos"], "layers": jsolo["layers"]}, used)
        _assert_solo_equal(tpack, jpack, cfg.n_layers)
        tback = unpack_device_state(tpack, 16)
        _assert_solo_equal(tback, jsnapshot.unpack_device_state(jpack, 16),
                           cfg.n_layers)
        for mine, orig in zip(tback["layers"], tsolo["layers"]):
            for name, leaf in mine.items():
                assert torch.equal(leaf[:, :used], orig[name][:, :used])
                assert not leaf[:, used:].view(torch.uint8).any()


def test_dense_load_stores_castable_leaves_in_bf16(setup):
    """``load_params`` without a weight format (the premium tier's weight
    set, and the plain dense engines') stores the leaves a cast would
    replace in bf16 and keeps the others as they are; every GEMM rounds
    its weight to bf16 first, so prefill and decode give the f32 tree's
    logits bit for bit."""
    from repro_torch.models import decode_step
    from repro_torch.serving.engine import load_params
    cfg, tparams = setup[1], setup[3]
    policy = QuantPolicy(None, None)
    loaded = load_params(tparams, policy, torch.device("cpu"))
    n_cast = 0
    for i, layer in enumerate(tparams["layers"]):
        for name, leaf in layer.items():
            cast = policy.castable(f"layers/{i}/{name}", leaf)
            n_cast += cast
            got = loaded["layers"][i][name]
            assert got.dtype == (torch.bfloat16 if cast else leaf.dtype)
            assert torch.equal(got, leaf.to(got.dtype))
    assert n_cast == 7 * cfg.n_layers
    for name in ("tok_embed", "lm_head", "final_scale"):
        assert torch.equal(loaded[name], tparams[name])
    toks = torch.as_tensor(np.stack(_prompts(cfg, [12, 12])),
                           dtype=torch.int64)
    for kv in (None, "nxfp4"):
        a, ca = prefill(cfg, tparams, {"tokens": toks}, MAX_LEN, kv)
        b, cb = prefill(cfg, loaded, {"tokens": toks}, MAX_LEN, kv)
        assert torch.equal(a, b)
        tok = a.argmax(-1, keepdim=True)
        assert torch.equal(decode_step(cfg, tparams, tok, ca, kv)[0],
                           decode_step(cfg, loaded, tok, cb, kv)[0])


# ---------------------------------------------------------------------------
# the economy tier's prefill against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cast4(setup):
    """Both packages' nxfp4-cast smoke weights (bitwise the same bytes)."""
    jparams, tparams = setup[2], setup[3]
    jq = jdirect_cast_tree(jparams, JQuantPolicy("nxfp4", "nxfp4"),
                           quantize_fn=jquantize_qtensor)
    from repro_torch.serving.engine import load_params
    return jq, load_params(tparams, QuantPolicy("nxfp4", "nxfp4"),
                           torch.device("cpu"))


@pytest.mark.parametrize("kv", ["nxfp4", None], ids=str)
def test_prefill_into_slot_act_fmt_matches_reference(setup, cast4, kv):
    """``prefill_into_slot(act_fmt="amxfp4")``: logits within ACT_TOL of
    the reference's; the slot's rows are the port's own act prefill's,
    bit for bit, and the other slot stays zero."""
    jcfg, cfg = setup[:2]
    jq, tq = cast4
    toks = _prompts(cfg, [13])[0][None]
    jl, _ = jprefill_into_slot(jcfg, jq, {"tokens": jnp.asarray(toks)},
                               jinit_cache(jcfg, 2, 32, kv), 1, 32, kv,
                               act_fmt="amxfp4")
    cache = init_cache(cfg, 2, 32, kv, device="cpu")
    tl, cache = prefill_into_slot(cfg, tq, {"tokens": torch.from_numpy(
        toks).long()}, cache, 1, 32, kv, act_fmt="amxfp4")
    err = float(np.abs(tl.numpy() - np.asarray(jl)).max())
    print(f"kv={kv}: max |logit diff| {err:.3g} (tolerance {ACT_TOL})")
    assert err <= ACT_TOL
    want, solo = prefill(cfg, tq, {"tokens": torch.from_numpy(toks).long()},
                         32, kv, act_fmt="amxfp4")
    assert torch.equal(tl, want)
    for lc, sc in zip(cache["layers"], solo["layers"]):
        for name, buf in lc.items():
            assert torch.equal(buf[1:2], sc[name]) and not buf[0].any()


def test_economy_first_token_logits_match_reference(setup, cast4):
    """The logits an economy admission samples its first token from, in
    the tier engine, against the reference's ``prefill_into_slot(
    act_fmt="amxfp4")`` over its nxfp4 weights: within ACT_TOL."""
    jcfg, cfg = setup[:2]
    jq = cast4[0]
    eng = TieredContinuousEngine(cfg, setup[3], default_tiers(),
                                 **_kw("whole"))
    seen = []
    first = eng._first_token
    eng._first_token = lambda slot, req, logits: (
        seen.append(logits.clone()), first(slot, req, logits))[1]
    req = _reqs(cfg, [13], [2], ["economy"])[0]
    eng.serve([req])
    jl, _ = jprefill_into_slot(jcfg, jq, {"tokens": jnp.asarray(
        req.tokens[None])}, jinit_cache(jcfg, 2, MAX_LEN, "nxfp4"), 0,
        MAX_LEN, "nxfp4", act_fmt="amxfp4")
    err = float(np.abs(seen[0].numpy() - np.asarray(jl)).max())
    assert err <= ACT_TOL


# ---------------------------------------------------------------------------
# the tier guarantees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [TierSpec("nxfp4", "nxfp4", None),
                                  TierSpec(None, None, None)],
                         ids=["nxfp4", "dense"])
@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_single_tier_engine_bitwise_vs_plain(setup, mode, spec):
    """One tier whose formats are a plain engine's policy: the same tokens,
    bit for bit (one group dispatch a chunk, one arena, the same prefill;
    the dense tier's bf16-stored weights are the values every GEMM rounds
    the plain engine's f32 weights to)."""
    cfg, params = setup[1], setup[3]
    reqs = _reqs(cfg, [8, 17, 8, 16, 9], [5, 11, 3, 8, 14], sampled=(3,))
    base = ContinuousEngine(cfg, params,
                            QuantPolicy(spec.weight_fmt, spec.kv_fmt),
                            **_kw(mode))
    ref = {r.uid: r.tokens for r in base.serve(reqs)}
    eng = TieredContinuousEngine(cfg, params, {"only": spec}, **_kw(mode))
    got = {r.uid: r.tokens for r in eng.serve(reqs)}
    for uid in ref:
        np.testing.assert_array_equal(got[uid], ref[uid],
                                      err_msg=f"{mode} uid={uid}")
    assert set(eng.chunk_groups) == {1} and eng.chunks == base.chunks


MIXED_TIERS = [None, "premium", "economy", "standard", "economy", "premium"]


@pytest.mark.parametrize("sampled", [(), (1, 2, 4)], ids=["greedy",
                                                          "sampled"])
@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_mixed_tiers_match_solo(setup, mode, sampled):
    """Premium, standard and economy requests over 3 slots: every stream,
    greedy or sampled (sampled requests in three tiers, each tier's group
    dispatched while the others decode), is its request served alone at
    its tier, bit for bit; chunks held 2-3 groups."""
    cfg, params = setup[1], setup[3]
    reqs = _reqs(cfg, [8, 17, 8, 16, 9, 12], [5, 11, 3, 8, 14, 6],
                 MIXED_TIERS, sampled)
    kw = dict(_kw(mode), n_slots=3)
    eng = TieredContinuousEngine(cfg, params, default_tiers(),
                                 default_tier="standard", **kw)
    got = {r.uid: r for r in eng.serve(reqs)}
    tiers = default_tiers()
    for req in reqs:
        want = _solo(setup, tiers[req.tier or "standard"], req)
        np.testing.assert_array_equal(got[req.uid].tokens, want,
                                      err_msg=f"{mode} uid={req.uid}")
        assert got[req.uid].ok and not got[req.uid].degraded
    assert max(eng.chunk_groups) >= 2


@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_mixed_tiers_two_serves_equal(setup, mode):
    """Serving the same mixed traffic twice gives the same bytes."""
    cfg, params = setup[1], setup[3]
    eng = TieredContinuousEngine(cfg, params, default_tiers(),
                                 default_tier="economy", **_kw(mode))
    reqs = _reqs(cfg, [8, 17, 8, 16], [5, 11, 3, 8],
                 [None, "premium", "standard", None], sampled=(0,))
    a = {r.uid: r.tokens for r in eng.serve(reqs)}
    b = {r.uid: r.tokens for r in eng.serve(reqs)}
    for uid in a:
        np.testing.assert_array_equal(a[uid], b[uid], err_msg=f"uid={uid}")


# ---------------------------------------------------------------------------
# the degraded-KV rung
# ---------------------------------------------------------------------------

def _cheap_engine(setup, watermark):
    return TieredContinuousEngine(
        setup[1], setup[3],
        {"premium": TierSpec(None, None, None),
         "cheap": TierSpec(None, "nxfp4", None)},
        default_tier="premium", degrade_kv_to="cheap",
        shedding=DegradeOverBudget(max_new_cap=None,
                                   pool_watermark=watermark),
        **_kw("whole"))


def test_degrade_sweep_repacks_at_watermark(setup, journal):
    """Over the watermark the oldest premium slots are re-encoded into the
    cheap tier's arena: their rows are the plain codec's encode of their
    dense rows, bitwise, a ``kv-repack`` event is journaled for each, and
    the requests finish OK with ``degraded=True``."""
    cfg = setup[1]
    eng = _cheap_engine(setup, 0.05)
    moved = []
    repack = eng._repack_slot

    def spy(sched, slot, dst):
        before = read_cache_slot(eng._slot_cache(slot), slot)
        repack(sched, slot, dst)
        moved.append((slot, before, read_cache_slot(eng._slot_cache(slot),
                                                    slot)))

    eng._repack_slot = spy
    res = eng.serve(_reqs(cfg, [8, 17, 8], [6, 11, 4]))
    repacks = [e for e in journal if e["event"] == "kv-repack"]
    assert repacks and repacks[0]["src"] == "premium" \
        and repacks[0]["dst"] == "cheap"
    assert len(moved) == len(repacks) == eng.repacks
    for slot, before, after in moved:
        pos = int(before["pos"][0])
        dense = unpack_device_state(pack_device_state(before, pos), MAX_LEN)
        want = repack_kv(cfg, dense, None, "nxfp4")
        assert int(after["pos"][0]) == pos
        for mine, ref in zip(after["layers"], want["layers"]):
            for name, buf in mine.items():
                assert torch.equal(buf[:, :pos], ref[name][:, :pos]), name
    assert all(r.ok and r.n_generated > 0 for r in res)
    # degraded: the repacked, and the waiters the watermark's pressure
    # admitted degraded (DegradeOverBudget's memory trigger)
    flagged = {r.uid for r in res if r.degraded}
    assert flagged == {e["uid"] for e in journal
                       if e["event"] in ("kv-repack", "degrade")}


def test_degrade_sweep_idle_below_watermark(setup, journal):
    """A watermark never reached moves nothing: no ``kv-repack``, no
    degraded flag, and the premium streams are the dense plain engine's."""
    cfg = setup[1]
    eng = _cheap_engine(setup, 2.0)
    reqs = _reqs(cfg, [8, 17], [6, 11])
    res = {r.uid: r for r in eng.serve(reqs)}
    assert not [e for e in journal if e["event"] == "kv-repack"]
    assert not any(r.degraded for r in res.values()) and eng.repacks == 0
    dense = ContinuousEngine(cfg, setup[3], QuantPolicy(None, None),
                             **_kw("whole"))
    for r in dense.serve(reqs):
        np.testing.assert_array_equal(res[r.uid].tokens, r.tokens)
