"""The port's paged KV cache on the CPU: allocator, device half, engine.

* ``PagePool`` (``serving/paged.py``) against the reference's: the same
  seeded operation sequences (allocate, release, register, claim, evict,
  ``cow_break``, ``would_fit``) give the same returns and the same state,
  and a ``hypothesis`` property runs random sequences.
* The paged cache functions (``models/kvcache.py``: ``write_prefill_at``,
  ``write_token``, ``paged_layer_view``; ``models/lm.py``:
  ``write_cache_slot``, ``read_cache_slot``) against the reference's on
  the same seeded pool, table and K/V, byte for byte: dense K/V exactly,
  packed K/V up to counted candidate near-ties (the 32-value mean is summed
  in another order by XLA; ``tests/test_torch_kvwrite.py``). Null-page
  rows and rows past ``n_valid`` are dropped: every other byte of the pool
  keeps its seeded value. Paged ``attend_decode`` equals dense
  ``attend_decode`` on the gathered view, bitwise.
* The port's ``PagedContinuousEngine`` against the port's
  ``ContinuousEngine`` on smoke configs, every stream bitwise, every pool
  empty after its serve; and one slice-level serve against the JAX
  ``PagedContinuousEngine``: equal greedy streams and equal
  ``pool_stats()``.
"""
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.models import init_params as jinit_params
from repro.models import kvcache as jkv
from repro.models import lm as jlm
from repro.serving import PagedContinuousEngine as JPagedEngine
from repro.serving import Request as JRequest
from repro.serving import scheduler as jsched
from repro.serving.paged import PagePool as JPagePool
from repro.serving.paged import auto_page_size as jauto_page_size
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.formats import get_format
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.core.quantize import meta_int32, near_tie_blocks, to_blocks
from repro_torch.models import (init_paged_cache, init_params,
                                read_cache_slot, write_cache_slot)
from repro_torch.models import kvcache
from repro_torch.serving import (NULL_PAGE, ContinuousEngine,
                                 DegradeOverBudget, PagedContinuousEngine,
                                 PagePool, Request, SlotScheduler,
                                 auto_page_size, parse_event)

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

# ---------------------------------------------------------------------------
# PagePool against the reference's
# ---------------------------------------------------------------------------


def _state(pool):
    return (list(pool._free), list(pool._refs), list(pool._registry_holds),
            dict(pool._slots), dict(pool._cow_reserve),
            list(pool._registry.items()), pool.stats(), pool.leaked())


def _call(pool, op):
    """Apply one op; returns its result, or the exception type it raised."""
    name, *args = op
    try:
        return getattr(pool, name)(*args)
    except (RuntimeError, AssertionError) as e:
        return type(e).__name__


def _ops(seed: int, n: int, n_slots: int = 4):
    """A seeded op sequence over a small token alphabet (prefixes collide
    often) and a pool too small for every slot (evictions, refusals)."""
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, 3, 12)) for _ in range(3)]

    def tokens():
        if rng.random() < 0.2:
            return None
        p = prefixes[rng.integers(0, 3)]
        cut = int(rng.integers(0, 13))
        return [int(t) for t in p[:cut]] + [
            int(t) for t in rng.integers(0, 3, int(rng.integers(0, 6)))]

    out = []
    for _ in range(n):
        kind = rng.integers(0, 8)
        slot = int(rng.integers(0, n_slots))
        if kind <= 1:
            out.append(("allocate", slot, int(rng.integers(0, 5)), tokens(),
                        bool(rng.random() < 0.3)))
        elif kind == 2:
            out.append(("release", slot))
        elif kind == 3:
            out.append(("register_prefix", tokens() or [1, 2], slot))
        elif kind == 4:
            out.append(("cow_break", slot))
        elif kind == 5:
            out.append(("would_fit", int(rng.integers(0, 6)), tokens(),
                        bool(rng.random() < 0.3)))
        elif kind == 6:
            out.append(("claimable", tokens(), int(rng.integers(0, 5))))
        else:
            out.append(("drop_prefixes",) if rng.random() < 0.3
                        else ("shared_pages", slot))
    return out


def _run_both(seed: int, n: int, n_pages: int = 9, page: int = 2):
    ref, got = JPagePool(n_pages, page), PagePool(n_pages, page)
    for op in _ops(seed, n):
        assert _call(got, op) == _call(ref, op), op
        assert _state(got) == _state(ref), op
    for slot in list(ref._slots):
        assert got.release(slot) == ref.release(slot)
    assert _call(got, ("assert_empty",)) == _call(ref, ("assert_empty",))
    assert _state(got) == _state(ref)


@pytest.mark.parametrize("seed", range(6))
def test_page_pool_matches_reference_on_seeded_sequences(seed):
    _run_both(seed, 80)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 60),
       st.integers(2, 12), st.integers(1, 4))
def test_page_pool_matches_reference_property(seed, n, n_pages, page):
    _run_both(seed, n, n_pages, page)


def test_page_pool_units_and_errors():
    assert [auto_page_size(r) for r in (2048, 48, 7, 4096)] == \
        [jauto_page_size(r) for r in (2048, 48, 7, 4096)]
    for bad in (0, -1):
        with pytest.raises(ValueError):
            auto_page_size(bad)
    for args in ((1, 8), (5, 0)):
        with pytest.raises(ValueError):
            PagePool(*args)
    assert NULL_PAGE == 0
    pool = PagePool(5, 2)
    pool.allocate(0, 2)
    assert pool.leaked() == 2
    with pytest.raises(AssertionError, match="page leak"):
        pool.assert_empty()


def test_admission_gate_matches_reference_scheduler():
    """``SlotScheduler.admission_gate``: a gate that refuses the policy's
    pick leaves the queue and the free slots as they were, in the port's
    scheduler as in the reference's, pick after pick."""
    rng = np.random.default_rng(11)
    spec = [dict(uid=i, tokens=rng.integers(0, 50, (int(t),)),
                 max_new=int(m)) for i, (t, m) in enumerate(
        zip(rng.integers(1, 9, 12), rng.integers(1, 9, 12)))]
    got, ref = SlotScheduler(3), jsched.SlotScheduler(3)
    seen = {"port": [], "ref": []}

    def gate(tag):
        def fn(req, shard, resumable):
            seen[tag].append((req.uid, shard, resumable))
            return (req.uid + len(seen[tag])) % 3 != 0
        return fn

    got.admission_gate, ref.admission_gate = gate("port"), gate("ref")
    for s in spec:
        got.submit(Request(**s))
        ref.submit(jsched.Request(**s))
    for step in range(20):
        a, b = got.next_admission(0.0), ref.next_admission(0.0)
        assert (a is None) == (b is None), step
        if a is not None:
            assert (a[0], a[1].uid) == (b[0], b[1].uid)
        if step % 4 == 3 and got.active:
            slot = min(got.active)
            assert got.release(slot).uid == ref.release(slot).uid
        assert [r.uid for r in got.queue] == [r.uid for r in ref.queue]
        assert got.free == ref.free
    assert seen["port"] == seen["ref"] and seen["port"]


# ---------------------------------------------------------------------------
# the device half against the reference's
# ---------------------------------------------------------------------------

B, NP, PAGE = 3, 9, 8


def _bf16(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def _pool_layer(cfg, kv_fmt, rows, seed):
    """One paged layer (port dict) filled with seeded bytes, and its block
    table: slot 0 maps pages 3, 1, ... (the rest null), slot 1 pages 5,
    7 and null in between, slot 2 nothing."""
    g = torch.Generator().manual_seed(seed)
    layer = kvcache.paged_attn_cache_init(cfg, B, rows, kv_fmt, NP, PAGE,
                                          torch.device("cpu"))
    for name, buf in layer.items():
        if name == "block":
            continue
        if buf.dtype == torch.bfloat16:
            buf.copy_(torch.randn(buf.shape, generator=g).to(buf.dtype))
        else:
            bits = 8 * buf.element_size()
            buf.copy_(torch.randint(0, 1 << bits, buf.shape, generator=g,
                                    dtype=torch.int64).to(buf.dtype))
    p = layer["block"].shape[1]
    table = np.zeros((B, p), np.int32)
    table[0, :min(p, 4)] = [3, 1, 8, 2][:min(p, 4)]
    table[1, 0], table[1, min(2, p - 1)] = 5, 7
    layer["block"].copy_(torch.from_numpy(table))
    return layer


def _to_jax(layer):
    """A port layer dict as the reference's arrays, bit for bit."""
    def one(v):
        if v.dtype == torch.bfloat16:
            return jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
        if v.dtype == torch.uint16:
            return jnp.asarray(v.view(torch.int16).numpy().view(np.uint16))
        return jnp.asarray(v.numpy())
    return {n: one(v) for n, v in layer.items()}


def _assert_pool_equal(port, ref, kv_fmt, src_rows):
    """Every pool buffer of ``port`` equals ``ref``'s; packed blocks may
    differ only on candidate near-ties of their source rows
    ``src_rows[name]`` ((NP, page, KVH, hd) f32, the value each written row
    holds)."""
    fmt = None if kv_fmt is None else get_format(kv_fmt)
    for name, buf in port.items():
        if name == "block":
            np.testing.assert_array_equal(buf.numpy(), np.asarray(ref[name]))
            continue
        r = np.asarray(ref[name].astype(jnp.float32)) \
            if buf.dtype == torch.bfloat16 else np.asarray(ref[name])
        if fmt is None:
            np.testing.assert_array_equal(buf.float().numpy(), r)
            continue
    if fmt is None:
        return
    for t in "kv":
        packed, meta = port[f"pool_{t}_packed"], port[f"pool_{t}_meta"]
        diff = ((packed.numpy() != np.asarray(ref[f"pool_{t}_packed"]))
                .any(-1) | (meta_int32(meta).numpy() != np.asarray(
                    ref[f"pool_{t}_meta"]).astype(np.int32)))
        if diff.any():
            xb, _ = to_blocks(src_rows[t], fmt.block_size, -1)
            assert bool(near_tie_blocks(xb[torch.from_numpy(diff)],
                                        fmt).all())


@functools.lru_cache(maxsize=None)
def _cfgs(arch):
    return jget_smoke_config(arch), get_smoke_config(arch)


@pytest.mark.parametrize("arch", ["llama3_8b", "h2o_danube_3_4b"])
@pytest.mark.parametrize("kv_fmt", [None, "nxfp4"])
def test_paged_writes_and_view_match_reference(arch, kv_fmt):
    """A lane chunk (rows 5.., 6 valid of 8; the ring wraps for danube)
    into slot 1, then a decode step (slot 2's rows on null pages, slot 1
    not live): the pools equal the reference's, and the gathered views
    too; paged ``attend_decode`` is dense ``attend_decode`` on the view."""
    jcfg, cfg = _cfgs(arch)
    rows = 32 if cfg.sliding_window else 40
    layer = _pool_layer(cfg, kv_fmt, rows, seed=3)
    ref = _to_jax(layer)
    rng = np.random.default_rng(4)
    kvh, hd = cfg.n_kv_heads, cfg.hd
    offset = 29 if cfg.sliding_window else 5
    k, v = _bf16(rng, (1, 8, kvh, hd)), _bf16(rng, (1, 8, kvh, hd), 2.0)
    i32 = functools.partial(torch.tensor, dtype=torch.int32)
    kvcache.write_prefill_at(cfg, layer, k, v, i32([1]), i32([offset]),
                             i32([6]), kv_fmt)
    ref = jax.jit(lambda c, k, v: jkv.write_prefill_at(
        jcfg, c, k, v, 1, offset, 6, kv_fmt))(
        ref, jnp.asarray(k.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(v.float().numpy()).astype(jnp.bfloat16))
    pos = i32([9, 3, 17])
    live = torch.tensor([True, False, True])
    k1, v1 = _bf16(rng, (B, 1, kvh, hd)), _bf16(rng, (B, 1, kvh, hd), 2.0)
    kvcache.write_token(cfg, layer, k1, v1, pos, kv_fmt, live=live)
    ref = jax.jit(lambda c, k, v: jkv.write_token(
        jcfg, c, k, v, jnp.asarray(pos.numpy()), kv_fmt,
        live=jnp.asarray(live.numpy())))(
        ref, jnp.asarray(k1.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(v1.float().numpy()).astype(jnp.bfloat16))
    # the value every written pool row holds, for the near-tie rule
    src = {t: torch.zeros((NP, PAGE, kvh, hd)) for t in "kv"}
    blk = layer["block"]
    w = cfg.sliding_window
    for j in range(6):
        r = (offset + j) % w if w else offset + j
        pg = int(blk[1, r // PAGE])
        if pg:
            src["k"][pg, r % PAGE], src["v"][pg, r % PAGE] = \
                k[0, j].float(), v[0, j].float()
    for b in (0, 2):
        r = int(pos[b]) % w if w else int(pos[b])
        pg = int(blk[b, r // PAGE])
        if pg:
            src["k"][pg, r % PAGE], src["v"][pg, r % PAGE] = \
                k1[b, 0].float(), v1[b, 0].float()
    _assert_pool_equal(layer, ref, kv_fmt, src)
    # rows that nothing wrote keep their seeded bytes: the null page too
    seeded = _pool_layer(cfg, kv_fmt, rows, seed=3)
    written = (src["k"].abs().sum((-1, -2)) > 0) | \
        (src["v"].abs().sum((-1, -2)) > 0)
    for name, buf in layer.items():
        if name != "block":
            assert torch.equal(buf[~written], seeded[name][~written]), name
    assert not written[NULL_PAGE].any()
    # the gathered view is the reference's, byte for byte
    view = kvcache.paged_layer_view(layer)
    jview = jkv.paged_layer_view(_to_jax(layer))
    assert set(view) == set(jview)
    for name, buf in view.items():
        np.testing.assert_array_equal(
            buf.float().numpy() if buf.dtype == torch.bfloat16
            else meta_int32(buf).numpy() if buf.dtype == torch.uint16
            else buf.numpy(),
            np.asarray(jview[name].astype(jnp.float32))
            if buf.dtype == torch.bfloat16
            else np.asarray(jview[name]).astype(np.int32)
            if buf.dtype == torch.uint16 else np.asarray(jview[name]))
    q = torch.from_numpy(rng.standard_normal(
        (B, cfg.n_heads, hd)).astype(np.float32))
    pos2 = i32([30, 12, 3]) if w else i32([35, 12, 3])
    got = kvcache.attend_decode(cfg, layer, q, pos2, kv_fmt)
    want = kvcache.attend_decode(cfg, view, q, pos2, kv_fmt)
    # bit patterns: seeded meta bytes decode to inf and NaN too
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kv_fmt", [None, "nxfp4"])
def test_paged_cache_slot_surgery_matches_reference(kv_fmt):
    """``write_cache_slot`` of a batch-1 dense cache into a paged slot
    (rows past its 3 reserved pages dropped) and ``read_cache_slot`` back:
    the pools and the read equal the reference's ``_write_paged_group``/
    ``_read_paged_group``, and the read is the written cache on the
    reserved rows."""
    jcfg, cfg = _cfgs("llama3_8b")
    max_len = 40
    cache = init_paged_cache(cfg, B, max_len, kv_fmt, NP, PAGE,
                             device="cpu")
    g = torch.Generator().manual_seed(5)
    for layer in cache["layers"]:
        for name, buf in layer.items():
            if name.startswith("pool_"):
                if buf.dtype == torch.bfloat16:
                    buf.copy_(torch.randn(buf.shape, generator=g).to(
                        buf.dtype))
                else:
                    buf.copy_(torch.randint(
                        0, 1 << (8 * buf.element_size()), buf.shape,
                        generator=g, dtype=torch.int64).to(buf.dtype))
    table = torch.zeros_like(cache["layers"][0]["block"])
    table[2, :3] = torch.tensor([6, 2, 4], dtype=torch.int32)
    cache["layers"][0]["block"].copy_(table)
    solo = {"pos": torch.tensor([21], dtype=torch.int32), "layers": []}
    for layer in cache["layers"]:
        dense = kvcache.attn_cache_init(cfg, 1, max_len, kv_fmt,
                                        torch.device("cpu"))
        for name, buf in dense.items():
            if buf.dtype == torch.bfloat16:
                buf.copy_(torch.randn(buf.shape, generator=g).to(buf.dtype))
            else:
                buf.copy_(torch.randint(0, 1 << (8 * buf.element_size()),
                                        buf.shape, generator=g,
                                        dtype=torch.int64).to(buf.dtype))
        solo["layers"].append(dense)

    def jaxed(layers):
        # the reference's stacked group: leaves (L, ...), the table over L
        return {n: jnp.stack([_to_jax(l)[n] for l in layers])
                for n in layers[0]}

    jgroup = jaxed(cache["layers"])
    jsolo = {n: v[:, None] for n, v in jaxed(
        [{n: v[0] for n, v in l.items()} for l in solo["layers"]]).items()}
    write_cache_slot(cache, solo, 2)
    jgroup = jlm._write_paged_group(jgroup, jsolo, 2, None)
    for i, layer in enumerate(cache["layers"]):
        for name, buf in layer.items():
            r = np.asarray(jgroup[name][i])
            if buf.dtype == torch.bfloat16:
                np.testing.assert_array_equal(
                    buf.float().numpy(), r.astype(np.float32))
            elif buf.dtype == torch.uint16:
                np.testing.assert_array_equal(meta_int32(buf).numpy(),
                                              r.astype(np.int32))
            else:
                np.testing.assert_array_equal(buf.numpy(), r)
    assert int(cache["pos"][2]) == 21
    back = read_cache_slot(cache, 2)
    jback = jlm._read_paged_group(jgroup, 2)
    rows = 3 * PAGE
    for i, (got, src) in enumerate(zip(back["layers"], solo["layers"])):
        assert set(got) == set(src)
        for name, buf in got.items():
            assert buf.shape == src[name].shape
            assert torch.equal(buf[:, :rows], src[name][:, :rows])
            r = np.asarray(jback[name][i])
            np.testing.assert_array_equal(
                buf.float().numpy() if buf.dtype == torch.bfloat16
                else meta_int32(buf).numpy() if buf.dtype == torch.uint16
                else buf.numpy(),
                r.astype(np.float32) if buf.dtype == torch.bfloat16
                else r.astype(np.int32) if buf.dtype == torch.uint16 else r)


# ---------------------------------------------------------------------------
# the paged engine against the dense engine (the port's), bitwise
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = get_smoke_config(arch)
    return cfg, init_params(cfg, 0, device="cpu")


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (t,)).astype(np.int32) for t in lens]


def _reqs(cfg, lens, max_news, seed=0, **kw):
    return [Request(uid=i, tokens=p, max_new=m, **kw)
            for i, (p, m) in enumerate(zip(_prompts(cfg, lens, seed),
                                           max_news))]


def _shared_reqs(cfg, n=4, prefix_len=16, tail=4, max_new=6, seed=2):
    prefix = _prompts(cfg, [prefix_len], seed=seed)[0]
    tails = _prompts(cfg, [tail] * n, seed=seed + 1)
    return [Request(uid=i, tokens=np.concatenate([prefix, t]),
                    max_new=max_new) for i, t in enumerate(tails)]


_DENSE = {}


def _dense(arch, fmt, reqs, key, **kw):
    """The dense engine's streams for a request mix, served once a module."""
    if key not in _DENSE:
        cfg, params = _model(arch)
        eng = ContinuousEngine(cfg, params, QuantPolicy(fmt, fmt),
                               device="cpu", **kw)
        _DENSE[key] = {r.uid: r.tokens for r in eng.serve(reqs)}
    return _DENSE[key]


def _paged(arch, fmt, reqs, caplog=None, **kw):
    cfg, params = _model(arch)
    eng = PagedContinuousEngine(cfg, params, QuantPolicy(fmt, fmt),
                                device="cpu", **kw)
    if caplog is None:
        res = eng.serve(reqs)
        events = []
    else:
        with caplog.at_level(logging.INFO, logger="repro_torch.serving"):
            res = eng.serve(reqs)
        events = [e for e in (parse_event(r.getMessage())
                              for r in caplog.records) if e is not None]
    return eng, res, events


def _assert_same(got, ref, msg=""):
    assert got.keys() == ref.keys()
    for uid in ref:
        np.testing.assert_array_equal(got[uid], ref[uid],
                                      err_msg=f"{msg} uid={uid}")


MATRIX = [
    # arch              kv_fmt    mode       p_chunk
    ("llama3_8b",       "nxfp4",  "whole",   None),
    ("llama3_8b",       None,     "chunked", 8),
    ("h2o_danube_3_4b", "nxfp4",  "whole",   None),
    ("h2o_danube_3_4b", None,     "chunked", 16),
    ("hymba_1_5b",      "nxfp4",  "chunked", 16),
    ("falcon_mamba_7b", None,     "whole",   None),
]


@pytest.mark.parametrize("arch,fmt,mode,p_chunk", MATRIX)
def test_paged_engine_matches_dense_engine(arch, fmt, mode, p_chunk):
    """The reference's matrix: same requests, same weights, every stream
    bitwise the dense engine's, the pool empty after the serve (the
    attention-free model has no pages, and its engine builds no pool)."""
    cfg, _ = _model(arch)
    kw = dict(n_slots=2, max_len=64, chunk=4, prefill_mode=mode)
    if mode == "chunked":
        kw["p_chunk"] = p_chunk
    reqs = _reqs(cfg, [8, 12, 9, 8], [5, 9, 3, 7], seed=1)
    ref = _dense(arch, fmt, reqs, ("matrix", arch, fmt, mode), **kw)
    eng, res, _ = _paged(arch, fmt, reqs, **kw)
    _assert_same({r.uid: r.tokens for r in res}, ref, f"{arch}/{fmt}/{mode}")
    if cfg.attn_free:
        assert eng.pool is None
    else:
        eng.pool.assert_empty()


@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_paged_prefix_sharing_bitwise_and_observable(mode, caplog):
    """Prompts extending a registered prefix map shared pages (prefix-hit
    and pool events) and still decode bitwise as the dense engine, which
    shares nothing."""
    cfg, _ = _model("llama3_8b")
    reqs = _shared_reqs(cfg)
    kw = dict(n_slots=2, max_len=64, chunk=4)
    ref = _dense("llama3_8b", "nxfp4", reqs, ("shared",), **kw)
    if mode == "chunked":
        kw.update(prefill_mode="chunked", p_chunk=8)
    eng, res, events = _paged("llama3_8b", "nxfp4", reqs, caplog,
                              page_size=8, **kw)
    _assert_same({r.uid: r.tokens for r in res}, ref, f"sharing/{mode}")
    st = eng.pool_stats()[0]
    assert st["prefix_hits"] >= 1 and st["prefix_pages_shared"] >= 2
    kinds = {e["event"] for e in events}
    assert {"prefix-hit", "pool"} <= kinds
    pools = [e for e in events if e["event"] == "pool"]
    assert all({"used", "free", "occupancy", "hwm", "shared"} <= e.keys()
               for e in pools)
    assert any(e["used"] > 0 for e in pools)
    hit = next(e for e in events if e["event"] == "prefix-hit")
    assert hit["pages"] >= 1 and hit["uid"] in {r.uid for r in reqs}
    eng.pool.assert_empty()


def test_paged_cow_break_on_swa_wrap(caplog):
    """A sliding-window claimant that outlives its window privatizes its
    shared pages (COW) before the ring wraps into them: streams bitwise the
    dense engine's, the registrar's pages untouched."""
    cfg, _ = _model("h2o_danube_3_4b")                # window 32
    prefix = _prompts(cfg, [24], seed=4)[0]
    reqs = [Request(uid=0, tokens=prefix.copy(), max_new=2)]
    reqs += [Request(uid=i, tokens=prefix.copy(), max_new=20)
             for i in (1, 2, 3)]
    kw = dict(n_slots=2, max_len=64, chunk=4)
    ref = _dense("h2o_danube_3_4b", "nxfp4", reqs, ("cow",), **kw)
    eng, res, events = _paged("h2o_danube_3_4b", "nxfp4", reqs, caplog,
                              page_size=8, **kw)
    _assert_same({r.uid: r.tokens for r in res}, ref, "cow")
    st = eng.pool_stats()[0]
    assert st["prefix_hits"] >= 1 and st["cow_breaks"] >= 1
    assert any(e["event"] == "cow-break" and e["pages"] >= 1
               for e in events)
    eng.pool.assert_empty()


def _regime_reqs(cfg):
    """A registrar of 20 tokens that stays live (16 new tokens), a
    claimant of 12 tokens on its first 8 (one page of 8 rows, a prefill in
    the GEMMs' small-M regime on the card) and one of 24 tokens on its
    first 16 (two pages), admitted while the registrar decodes."""
    base, tails = _prompts(cfg, [20], seed=11)[0], _prompts(
        cfg, [4, 8], seed=12)
    return [Request(uid=0, tokens=base, max_new=16),
            Request(uid=1, tokens=np.concatenate([base[:8], tails[0]]),
                    max_new=3),
            Request(uid=2, tokens=np.concatenate([base[:16], tails[1]]),
                    max_new=4)]


@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_paged_claimant_prefill_writes_only_private_pages(mode, caplog):
    """A claimant's table row holds the null page in its claimed entries
    from its allocation until it is armed, so its prefill (whole, or the
    lane at P 8) writes only its private pages and never a page the live
    registrar reads; armed, the row maps the shared pages. A whole prompt
    of at most 16 tokens does not share (its prefill's rows are other
    bits on the card); the lane shares at any length. Streams bitwise the
    dense engine's of the same prefill mode, the null page never
    written, the pool empty after the serve."""
    cfg, params = _model("llama3_8b")
    reqs = _regime_reqs(cfg)
    kw = dict(n_slots=2, max_len=64, chunk=4, prefill_mode=mode)
    if mode == "chunked":
        kw["p_chunk"] = 8
    ref = _dense("llama3_8b", "nxfp4", reqs, ("regimes", mode), **kw)
    rows = []

    class Watched(PagedContinuousEngine):
        def _emit(self, event, **f):
            if event in ("prefix-hit", "admit", "prefill-done"):
                row = self.cache["layers"][0]["block"][f["slot"]].tolist()
                rows.append((event, f["uid"], f.get("pages"), row,
                             self.pool.slot_pages(f["slot"])))
            super()._emit(event, **f)

    eng = Watched(cfg, params, QuantPolicy("nxfp4", "nxfp4"), device="cpu",
                  page_size=8, **kw)
    with caplog.at_level(logging.INFO, logger="repro_torch.serving"):
        res = eng.serve(reqs)
    _assert_same({r.uid: r.tokens for r in res}, ref, f"regimes/{mode}")
    hits = {uid: m for event, uid, m, _, _ in rows if event == "prefix-hit"}
    assert hits == ({2: 2} if mode == "whole" else {1: 1, 2: 2})
    for event, uid, m, row, pages in rows:
        n = len(pages)
        if event == "prefix-hit":       # during the claimant's prefill
            assert row[:m] == [NULL_PAGE] * m and row[m:n] == pages[m:]
        else:                           # armed
            assert row[:n] == pages
        assert row[n:] == [NULL_PAGE] * (len(row) - n)
    for layer in eng.cache["layers"]:
        for name, buf in layer.items():
            page0 = buf[NULL_PAGE] if name.startswith("pool_") else None
            if page0 is not None and page0.dtype in (torch.uint16,
                                                     torch.uint32):
                page0 = meta_int32(page0)
            assert page0 is None or not page0.any(), name
    eng.pool.assert_empty()


def test_paged_admission_gated_on_pages():
    """A pool smaller than the slots: free slots queue behind free pages,
    every request completes bitwise, the pool never oversubscribes."""
    cfg, _ = _model("llama3_8b")
    reqs = _reqs(cfg, [8] * 6, [8, 6, 8, 5, 7, 6], seed=6)
    kw = dict(n_slots=4, max_len=64, chunk=4)
    ref = _dense("llama3_8b", "nxfp4", reqs, ("gated",), **kw)
    gated = []
    eng = PagedContinuousEngine(*_model("llama3_8b"),
                                QuantPolicy("nxfp4", "nxfp4"), device="cpu",
                                page_size=8, n_pages=5, **kw)
    gate = eng._admission_gate

    def spy(req, shard, resumable):
        ok = gate(req, shard, resumable)
        gated.append(ok)
        return ok

    eng._admission_gate = spy
    got = {r.uid: r.tokens for r in eng.serve(reqs)}
    _assert_same(got, ref, "page-gated")
    assert False in gated                      # admission waited on pages
    st = eng.pool_stats()[0]
    assert st["high_watermark"] <= eng.pool.capacity == 4
    eng.pool.assert_empty()


def test_paged_pool_watermark_degrades():
    """``DegradeOverBudget(pool_watermark=)`` reads the pool: with the pool
    at its watermark, arrived waiters are admitted degraded (capped
    ``max_new``); every served stream is a prefix of its dense stream."""
    cfg, _ = _model("llama3_8b")
    reqs = _reqs(cfg, [8] * 5, [12] * 5, seed=9)
    kw = dict(n_slots=4, max_len=64, chunk=4)
    ref = _dense("llama3_8b", "nxfp4", reqs, ("watermark",), **kw)
    eng, res, _ = _paged(
        "llama3_8b", "nxfp4", reqs, page_size=8, n_pages=5,
        shedding=DegradeOverBudget(max_new_cap=3, pool_watermark=0.5), **kw)
    degraded = [r for r in res if r.degraded]
    assert degraded and all(r.n_generated == 3 for r in degraded)
    assert all(r.ok for r in res) and len(res) == len(reqs)
    for r in res:
        np.testing.assert_array_equal(r.tokens, ref[r.uid][:r.n_generated])
    eng.pool.assert_empty()


def test_paged_ring_lane_admits_swa_prompt_past_max_len():
    """Chunked admission of sliding-window prompts longer than ``max_len``
    (the ring lane) through the paged engine: bitwise the dense engine's
    whole prefill."""
    cfg, _ = _model("h2o_danube_3_4b")                # window 32
    reqs = _reqs(cfg, [100, 40, 72], [5, 5, 5], seed=7)
    kw = dict(n_slots=2, max_len=64, chunk=4)
    ref = _dense("h2o_danube_3_4b", "nxfp4", reqs, ("ring",), **kw)
    eng, res, _ = _paged("h2o_danube_3_4b", "nxfp4", reqs,
                         prefill_mode="chunked", p_chunk=32, **kw)
    assert eng._lane_ring
    _assert_same({r.uid: r.tokens for r in res}, ref, "ring lane")
    eng.pool.assert_empty()


def test_paged_engine_matches_jax_paged_engine():
    """The slice against the reference: the JAX ``PagedContinuousEngine``
    and the port's serve the reference's prefix-sharing mix
    (``tests/test_paged.py``) from the same weights, bf16 weights and
    nxfp4 KV: equal greedy streams and equal allocator counters."""
    jcfg = jget_smoke_config("llama3_8b")
    cfg = get_smoke_config("llama3_8b")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    reqs = _shared_reqs(cfg)
    kw = dict(n_slots=2, max_len=64, chunk=4, page_size=8)
    jeng = JPagedEngine(jcfg, jparams, JQuantPolicy(None, "nxfp4"), **kw)
    want = {r.uid: np.asarray(r.tokens) for r in jeng.serve(
        [JRequest(uid=r.uid, tokens=r.tokens, max_new=r.max_new)
         for r in reqs])}
    eng = PagedContinuousEngine(cfg, tparams, QuantPolicy(None, "nxfp4"),
                                device="cpu", **kw)
    got = {r.uid: r.tokens for r in eng.serve(reqs)}
    _assert_same(got, want, "vs JAX")
    assert eng.pool_stats() == jeng.pool_stats()
    eng.pool.assert_empty()


def test_paged_engine_reclaims_an_aborted_serve():
    """A serve that dies mid-flight (an exception from ``progress_cb``)
    leaves pages held; the next serve's scheduler releases them and nulls
    their table rows, serves bitwise the dense engine's streams and ends
    with an empty pool."""
    cfg, _ = _model("llama3_8b")
    reqs = _reqs(cfg, [8, 12, 9, 8], [5, 9, 3, 7], seed=1)
    kw = dict(n_slots=2, max_len=64, chunk=4)
    ref = _dense("llama3_8b", "nxfp4", reqs,
                 ("matrix", "llama3_8b", "nxfp4", "whole"),
                 prefill_mode="whole", **kw)

    class Crash(Exception):
        pass

    def boom(engine, sched):
        raise Crash

    eng = PagedContinuousEngine(*_model("llama3_8b"),
                                QuantPolicy("nxfp4", "nxfp4"), device="cpu",
                                **kw)
    with pytest.raises(Crash):
        eng.serve(reqs, progress_cb=boom)
    assert eng.pool.used > 0
    _assert_same({r.uid: r.tokens for r in eng.serve(reqs)}, ref, "after")
    eng.pool.assert_empty()
    assert not eng.cache["layers"][0]["block"].any()
