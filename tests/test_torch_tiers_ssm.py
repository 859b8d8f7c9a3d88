"""Serving tiers for the SSM and hybrid families in the port
(``serving/tiers.py`` on ``falcon_mamba_7b`` and ``hymba_1_5b``), on the
CPU at smoke size.

* Against the reference, from the same inputs: ``kv_row_bytes`` (0 for
  the attention-free family), ``repack_kv`` (K/V re-encoded bitwise, the
  Mamba state ``h``/``conv`` and ``pos`` passed through; a pure-SSM slice
  returned as it is) and the slot-state helpers (``slot_row_capacity``
  None without attention K/V; ``pack_device_state``/``unpack_device_state``
  trim and pad the K/V rows and copy ``h``/``conv`` whole).
* The degrade rung on Hymba: a repacked slot keeps its ``h``/``conv`` bit
  for bit (only the K/V row leaves past ``pos`` are zeroed before the
  re-encode), its rows are ``repack_kv``'s of its source rows; on Falcon
  the rung stays idle (no KV to price).
* The tier guarantees on both families, bitwise: a one-tier engine is the
  plain ``ContinuousEngine`` at that policy, whole and chunked (P =
  ``ssm_chunk``); every stream of a mixed-tier serve, greedy and sampled,
  is its request served alone at its tier.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.kernels.ops import quantize_qtensor as jquantize_qtensor
from repro.models import init_params as jinit_params
from repro.serving import snapshot as jsnapshot
from repro.serving import tiers as jtiers
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.models import read_cache_slot
from repro_torch.models.kvcache import cache_rows
from repro_torch.serving import (ContinuousEngine, DegradeOverBudget,
                                 Request, TieredContinuousEngine, TierSpec,
                                 default_tiers, kv_row_bytes,
                                 pack_device_state, repack_kv,
                                 slot_row_capacity, unpack_device_state)

from _torch_helpers import TierSolo, solo_stream  # one intra-op thread

ARCHS = ("falcon_mamba_7b", "hymba_1_5b")
MAX_LEN = 64


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The reference's smoke config and params of ``arch`` and the port's
    copy of them."""
    jcfg = jget_smoke_config(arch)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, get_smoke_config(arch), params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")


# ---------------------------------------------------------------------------
# prices, repack and slot state against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fmt", [None, "nxfp4", "nxfp6"], ids=str)
def test_kv_row_bytes_matches_reference(arch, fmt):
    jcfg, cfg, _ = _setup(arch)
    got = kv_row_bytes(cfg, fmt)
    assert got == jtiers.kv_row_bytes(jcfg, fmt)
    assert (got == 0) == cfg.attn_free


def _to_torch(x):
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _solo_pair(cfg, fmt, rows=16, pos=9, seed=0):
    """The same batch-1 slot slice for the reference (stacked layers) and
    the port (a list of layers): seeded K/V rows (zero past ``pos``)
    encoded at ``fmt`` by the reference's codec where the family has
    attention, and a seeded Mamba state (``h`` f32, ``conv`` bf16)."""
    rng = np.random.default_rng(seed)
    n = cfg.n_layers
    jl = {"h": rng.standard_normal((n, 1, cfg.dinner, cfg.ssm_state)
                                   ).astype(np.float32),
          "conv": jnp.asarray(rng.standard_normal(
              (n, 1, cfg.conv_width - 1, cfg.dinner)), jnp.bfloat16)}
    if not cfg.attn_free:
        shape = (n, 1, rows, cfg.n_kv_heads, cfg.hd)
        for base in ("k", "v"):
            a = np.zeros(shape, np.float32)
            a[:, :, :pos] = rng.standard_normal(shape[:2] + (pos,)
                                                + shape[3:])
            val = jnp.asarray(a, jnp.bfloat16)
            if fmt is None:
                jl[base] = val
            else:
                qt = jquantize_qtensor(val, fmt, axis=-1)
                jl[f"{base}_packed"], jl[f"{base}_meta"] = qt.packed, qt.meta
    jsolo = {"pos": np.array([pos], np.int32), "layers": jl}
    tsolo = {"pos": torch.tensor([pos], dtype=torch.int32),
             "layers": [{name: _to_torch(leaf[i])
                         for name, leaf in jl.items()} for i in range(n)]}
    return jsolo, tsolo


def _assert_solo_equal(tsolo, jsolo, n_layers):
    assert int(tsolo["pos"][0]) == int(np.asarray(jsolo["pos"])[0])
    for i in range(n_layers):
        assert set(tsolo["layers"][i]) == set(jsolo["layers"])
        for name, leaf in tsolo["layers"][i].items():
            want = _to_torch(jsolo["layers"][name][i])
            assert leaf.dtype == want.dtype, name
            assert torch.equal(leaf, want), (i, name)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("src,dst", [(None, "nxfp4"), ("nxfp4", None),
                                     ("nxfp4", "nxfp6")], ids=str)
def test_repack_kv_matches_reference(arch, src, dst):
    """The same slot bytes re-encoded by both packages: the same K/V bytes
    out, ``h``/``conv`` and ``pos`` as they came in (a pure-SSM slice is
    returned as it is)."""
    jcfg, cfg, _ = _setup(arch)
    jsolo, tsolo = _solo_pair(cfg, src)
    got = repack_kv(cfg, tsolo, src, dst)
    _assert_solo_equal(got, jtiers.repack_kv(jcfg, jsolo, src, dst),
                       cfg.n_layers)
    for mine, orig in zip(got["layers"], tsolo["layers"]):
        for name in ("h", "conv"):
            assert torch.equal(mine[name], orig[name])
    if cfg.attn_free:
        assert got is tsolo


@pytest.mark.parametrize("arch,fmt", [("falcon_mamba_7b", None),
                                      ("hymba_1_5b", None),
                                      ("hymba_1_5b", "nxfp4")], ids=str)
def test_slot_state_round_trip_matches_reference(arch, fmt):
    """``slot_row_capacity`` (None without attention K/V), then
    ``pack_device_state`` at 0, 5 and every row and ``unpack_device_state``
    back: the reference's bytes at each step, the Mamba state whole."""
    cfg = _setup(arch)[1]
    jsolo, tsolo = _solo_pair(cfg, fmt, rows=16, pos=9)
    cap = slot_row_capacity(tsolo)
    assert cap == jsnapshot.slot_row_capacity(jsolo)
    assert cap == (None if cfg.attn_free else 16)
    for used in (0, 5, 16):
        tpack = pack_device_state(tsolo, used)
        jpack = jsnapshot.pack_device_state(
            {"pos": jsolo["pos"], "layers": jsolo["layers"]}, used)
        _assert_solo_equal(tpack, jpack, cfg.n_layers)
        tback = unpack_device_state(tpack, cap)
        _assert_solo_equal(tback, jsnapshot.unpack_device_state(jpack, cap),
                           cfg.n_layers)
        for mine, orig in zip(tback["layers"], tsolo["layers"]):
            for name in ("h", "conv"):
                assert torch.equal(mine[name], orig[name])


# ---------------------------------------------------------------------------
# the degrade rung
# ---------------------------------------------------------------------------

def _reqs(cfg, lens, max_news, tiers=None, sampled=(), seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)).astype(
        np.int32), max_new=m, tier=tier, seed=20 + i,
        temperature=0.9 + 0.2 * i if i in sampled else 0.0)
        for i, (t, m, tier) in enumerate(
            zip(lens, max_news, tiers or [None] * len(lens)))]


def _kw(cfg, mode, n_slots=2):
    kw = dict(n_slots=n_slots, max_len=MAX_LEN, chunk=4, device="cpu")
    if mode == "chunked":
        kw.update(prefill_mode="chunked", p_chunk=cfg.ssm_chunk)
    return kw


def _cheap_engine(cfg, params, watermark):
    return TieredContinuousEngine(
        cfg, params, {"premium": TierSpec(None, None, None),
                      "cheap": TierSpec(None, "nxfp4", None)},
        default_tier="premium", degrade_kv_to="cheap",
        shedding=DegradeOverBudget(max_new_cap=None,
                                   pool_watermark=watermark),
        **_kw(cfg, "whole"))


def test_repack_slot_keeps_mamba_state():
    """Hymba over the watermark: each repacked slot's ``h``/``conv`` in
    the cheap arena are the premium arena's before the move, bit for bit
    (before the repair every leaf was zeroed past ``pos`` on axis 1, which
    cut ``h``'s channels and ``conv``'s tail); its K/V rows are
    ``repack_kv``'s of its dense rows; the source slot is parked (state
    zeroed); the requests finish OK and degraded."""
    _, cfg, params = _setup("hymba_1_5b")
    eng = _cheap_engine(cfg, params, 0.05)
    rows = cache_rows(cfg, MAX_LEN)
    moved = []
    repack = eng._repack_slot

    def spy(sched, slot, dst):
        src = eng._slot_cache(slot)
        before = read_cache_slot(src, slot)
        repack(sched, slot, dst)
        moved.append((before, read_cache_slot(eng._slot_cache(slot), slot),
                      read_cache_slot(src, slot)))

    eng._repack_slot = spy
    # prompts of 20 and 40 tokens (40 wraps the 32-row ring)
    res = eng.serve(_reqs(cfg, [20, 40, 9], [8, 6, 5]))
    assert moved and len(moved) == eng.repacks
    for before, after, parked in moved:
        pos = int(before["pos"][0])
        assert int(after["pos"][0]) == pos and int(parked["pos"][0]) == 0
        used = min(pos, rows)
        want = repack_kv(cfg, unpack_device_state(
            pack_device_state(before, used), rows), None, "nxfp4")
        for mine, src, old, ref in zip(after["layers"], before["layers"],
                                       parked["layers"], want["layers"]):
            for name in ("h", "conv"):
                assert torch.equal(mine[name], src[name]), name
                assert not old[name].any(), name
            for name in ("k_packed", "k_meta", "v_packed", "v_meta"):
                assert torch.equal(mine[name][:, :used],
                                   ref[name][:, :used]), name
    assert all(r.ok and r.n_generated > 0 for r in res)
    assert sum(r.degraded for r in res) >= len(moved)


def test_degrade_rung_idle_without_attention():
    """Falcon has no KV: its occupancy is 0, nothing is repacked or
    degraded, and the streams are the plain premium engine's."""
    _, cfg, params = _setup("falcon_mamba_7b")
    eng = _cheap_engine(cfg, params, 0.05)
    reqs = _reqs(cfg, [20, 40, 9], [8, 6, 5])
    res = {r.uid: r for r in eng.serve(reqs)}
    assert eng.repacks == 0 and eng._kv_occupancy() == 0.0
    assert not any(r.degraded for r in res.values())
    plain = ContinuousEngine(cfg, params, QuantPolicy(None, None),
                             **_kw(cfg, "whole"))
    for r in plain.serve(reqs):
        np.testing.assert_array_equal(res[r.uid].tokens, r.tokens)


# ---------------------------------------------------------------------------
# the tier guarantees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", [TierSpec("nxfp4", "nxfp4", None),
                                  TierSpec(None, None, None)],
                         ids=["nxfp4", "dense"])
@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_single_tier_engine_bitwise_vs_plain(arch, mode, spec):
    """One tier whose formats are a plain engine's policy: the same
    tokens, bit for bit (one arena holding the Mamba state, one group
    dispatch a chunk), a sampled request included."""
    _, cfg, params = _setup(arch)
    reqs = _reqs(cfg, [8, 20, 5, 17], [5, 9, 3, 7], sampled=(2,))
    kw = _kw(cfg, mode)
    base = ContinuousEngine(cfg, params,
                            QuantPolicy(spec.weight_fmt, spec.kv_fmt), **kw)
    ref = {r.uid: r.tokens for r in base.serve(reqs)}
    eng = TieredContinuousEngine(cfg, params, {"only": spec}, **kw)
    got = {r.uid: r.tokens for r in eng.serve(reqs)}
    for uid in ref:
        np.testing.assert_array_equal(got[uid], ref[uid],
                                      err_msg=f"{arch} {mode} uid={uid}")
    assert set(eng.chunk_groups) == {1} and eng.chunks == base.chunks


MIXED_TIERS = [None, "premium", "economy", "standard", "economy", "premium"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,sampled", [("whole", ()),
                                          ("chunked", (1, 2, 4))],
                         ids=["whole-greedy", "chunked-sampled"])
def test_mixed_tiers_match_solo(arch, mode, sampled):
    """Premium, standard and economy requests over 3 slots: every stream
    (each tier's group dispatched while the others ride not live, their
    Mamba state frozen in their own arenas; the economy prefill with
    amxfp4 activations in the attention and MLP products; sampled
    requests in three tiers, whose groups put back the generators of the
    slots outside them) is its request served alone at its tier, bit for
    bit."""
    _, cfg, params = _setup(arch)
    reqs = _reqs(cfg, [8, 20, 5, 17, 9, 33], [5, 9, 3, 7, 10, 6],
                 MIXED_TIERS, sampled)
    eng = TieredContinuousEngine(cfg, params, default_tiers(),
                                 default_tier="standard",
                                 **_kw(cfg, mode, n_slots=3))
    got = {r.uid: r for r in eng.serve(reqs)}
    tiers = default_tiers()
    for req in reqs:
        spec = tiers[req.tier or "standard"]
        out = solo_stream(cfg, params,
                          QuantPolicy(spec.weight_fmt, spec.kv_fmt), req,
                          MAX_LEN, engine=TierSolo, act_fmt=spec.act_fmt)
        want = out.tokens[0, :int(out.n_generated[0])]
        np.testing.assert_array_equal(got[req.uid].tokens, want,
                                      err_msg=f"{arch} {mode} "
                                              f"uid={req.uid}")
        assert got[req.uid].ok and not got[req.uid].degraded
    assert max(eng.chunk_groups) >= 2


def test_tiered_lane_takes_the_ssm_chunk_rule():
    """The tiered lane's width obeys the Mamba block's rule: a width that
    is not a multiple of ``ssm_chunk`` is refused, as ``"auto"`` is."""
    _, cfg, params = _setup("hymba_1_5b")
    kw = dict(_kw(cfg, "chunked"), p_chunk=cfg.ssm_chunk // 2)
    with pytest.raises(ValueError, match="ssm_chunk"):
        TieredContinuousEngine(cfg, params, default_tiers(), **kw)
    with pytest.raises(ValueError, match="auto"):
        TieredContinuousEngine(cfg, params, default_tiers(),
                               **dict(kw, p_chunk="auto"))
