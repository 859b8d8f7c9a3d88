"""The paged engine's speculative rounds in the port, on the CPU at smoke
size (``kvcache.save_rows``/``restore_rows`` on a paged layer,
``PagedContinuousEngine(speculative=)``).

* A round's rows through the block table: ``save_rows`` and
  ``restore_rows`` on a paged layer give the dense layout's rows, row for
  row, on a layer holding the same logical rows in shuffled pages; rows
  past a slot's reservation (null pages) and past the cache are neither
  saved into nor put back, and the null page stays all zeros.
* Greedy streams of ``PagedContinuousEngine(speculative=)`` bitwise
  ``ContinuousEngine(speculative=)``'s (and the plain paged engine's) for
  ``llama3_8b`` (prefix sharing, whole and chunked), ``h2o_danube_3_4b``
  (a claimant's ring wrapping into shared pages: the ``cow-break`` fires
  at the round's k + 1 horizon, where the chunk's would not),
  ``hymba_1_5b`` and ``falcon_mamba_7b`` (no pages); ``spec_stats()`` the
  dense engine's, page 0 all zeros and the pool empty after each serve.
* One serve on the reference's smoke weights: the port's paged
  speculative engine emits the JAX plain ``ContinuousEngine``'s streams.
"""
import functools
import logging

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.models import init_params as jinit_params
from repro.serving import scheduler as jsched
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.kernels.build import bit_view
from repro_torch.models import kvcache
from repro_torch.serving import (NULL_PAGE, ContinuousEngine,
                                 PagedContinuousEngine, Request,
                                 SpeculativeConfig, parse_event)

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

PAGE = 8
MAX_LEN = 64
K = 4


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The reference's smoke config and params of ``arch`` and the port's
    copy of them."""
    jcfg = jget_smoke_config(arch)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, get_smoke_config(arch), jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")


# ---------------------------------------------------------------------------
# a round's rows through the block table
# ---------------------------------------------------------------------------

def _random_bits(gen, buf):
    """``buf``'s shape and dtype, random bytes (finite bf16 values)."""
    if buf.dtype == torch.bfloat16:
        return torch.randn(buf.shape, generator=gen).to(buf.dtype)
    return torch.randint(0, 1 << 8 * buf.element_size() - 1, buf.shape,
                         generator=gen, dtype=torch.int64).to(buf.dtype)


def _layers(cfg, kv_fmt, b, seed):
    """A dense (b, S) layer cache of random bytes, and a paged layer
    holding the same logical rows in shuffled pages of ``PAGE`` rows
    (slot b - 1's last two table entries null), two spare pages of random
    bytes and an all-zero null page. Returns (dense, paged, spare pages)."""
    gen = torch.Generator().manual_seed(seed)
    dense = kvcache.attn_cache_init(cfg, b, MAX_LEN, kv_fmt,
                                    torch.device("cpu"))
    for name, buf in dense.items():
        buf.copy_(_random_bits(gen, buf))
    s = kvcache.cache_rows(cfg, MAX_LEN)
    per = s // PAGE
    n_pages = b * per + 3
    paged = kvcache.paged_attn_cache_init(cfg, b, MAX_LEN, kv_fmt, n_pages,
                                          PAGE, torch.device("cpu"))
    pages = (torch.randperm(n_pages - 1, generator=gen) + 1).tolist()
    table = torch.tensor(pages[:b * per], dtype=torch.int32).view(b, per)
    table[b - 1, -2:] = NULL_PAGE
    paged["block"].copy_(table)
    spare = sorted(set(range(1, n_pages)) - set(table.flatten().tolist()))
    for name, buf in dense.items():
        pool = bit_view(paged[f"pool_{name}"])
        pool[spare] = bit_view(_random_bits(gen, pool[spare]))
        for sl in range(b):
            for j in range(per):
                if table[sl, j]:
                    pool[table[sl, j]] = bit_view(
                        buf[sl, j * PAGE:(j + 1) * PAGE])
    return dense, paged, spare


def _mapped_rows_equal(dense, paged):
    """Every row of the paged layer's slots that maps to a page equals the
    dense layer's row, bit for bit."""
    view = kvcache.paged_layer_view(paged)
    mapped = (paged["block"] != NULL_PAGE).repeat_interleave(PAGE, dim=1)
    for name, buf in dense.items():
        assert torch.equal(bit_view(view[name])[mapped],
                           bit_view(buf)[mapped]), name


@pytest.mark.parametrize("arch", ["llama3_8b", "h2o_danube_3_4b"],
                         ids=["dense", "ring"])
@pytest.mark.parametrize("kv_fmt", [None, "nxfp4"], ids=str)
def test_round_rows_through_the_block_table(arch, kv_fmt):
    """``save_rows`` of a paged layer reads the dense layout's rows;
    ``restore_rows`` writes a round's rows (every row) then puts back a
    ragged accepted suffix, as the dense layer's do: afterwards every
    mapped row equals the dense layer's. Rows on null pages (slot 2 runs
    into its reservation's end) and past the cache (slot 1) are neither
    saved nor put back: the null page stays zeros, spare pages and the
    table as they were."""
    cfg = get_smoke_config(arch)
    b, q = 3, K + 1
    dense, paged, spare = _layers(cfg, kv_fmt, b, seed=7)
    s = kvcache.cache_rows(cfg, MAX_LEN)
    # slot 0 mid-cache (a ring: wrapping), slot 1 at the cache's end
    # (rows past S in the dense layout; a ring wraps into row 0), slot 2
    # into its null pages
    pos = torch.tensor([s - 3 if cfg.sliding_window else 11, s - 2,
                        s - 2 * PAGE - 2], dtype=torch.int32)
    table = paged["block"].clone()
    spare_bytes = {n: bit_view(v)[spare].clone() for n, v in paged.items()
                   if n.startswith("pool_")}
    (rows,), inside = kvcache._round_rows(cfg, paged, pos, q, kv_fmt)
    saved_d = kvcache.save_rows(cfg, dense, pos, q, kv_fmt)
    saved_p = kvcache.save_rows(cfg, paged, pos, q, kv_fmt)
    assert set(saved_p) == set(saved_d) == set(dense)
    for name in saved_d:
        assert torch.equal(saved_p[name][inside], saved_d[name][inside])
    assert not inside[2, 2:].any() and inside[2, :2].all()
    assert inside[1].all() == bool(cfg.sliding_window)
    # a round writes every row, then puts back a ragged accepted suffix
    gen = torch.Generator().manual_seed(8)
    new = {n: _random_bits(gen, v) for n, v in saved_d.items()}
    everything = torch.ones((b, q), dtype=torch.bool)
    keep = torch.tensor([[False, False, True, True, True],
                         [False, True, True, True, True],
                         [True, True, True, True, True]])
    for layer, saved in ((dense, saved_d), (paged, saved_p)):
        kvcache.restore_rows(cfg, layer, new, pos, everything, kv_fmt)
        kvcache.restore_rows(cfg, layer, saved, pos, keep, kv_fmt)
    _mapped_rows_equal(dense, paged)
    assert torch.equal(paged["block"], table)
    for name, buf in paged.items():
        if name.startswith("pool_"):
            assert not bit_view(buf)[NULL_PAGE].any(), name
            assert torch.equal(bit_view(buf)[spare], spare_bytes[name])
    # the kept rows hold the round's bytes, the others their old ones
    for name, buf in kvcache._row_buffers(paged).items():
        got = buf[rows]
        assert torch.equal(got[inside & ~keep], new[name][inside & ~keep])
        assert torch.equal(got[inside & keep], saved_d[name][inside & keep])


# ---------------------------------------------------------------------------
# the engine: paged speculative == dense speculative, bit for bit
# ---------------------------------------------------------------------------

def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (t,)).astype(np.int32) for t in lens]


def _shared_reqs(cfg, tails, news, prefix_len=20, seed=3):
    """Requests extending one ``prefix_len``-token prefix (more than the
    GEMMs' 16-row regime, so a whole prompt takes part in sharing)."""
    prefix = _prompts(cfg, [prefix_len], seed)[0]
    return [Request(uid=i, tokens=np.concatenate([prefix, t]), max_new=m)
            for i, (t, m) in enumerate(zip(_prompts(cfg, tails, seed + 1),
                                           news))]


def _serve(eng, reqs, caplog=None):
    if caplog is None:
        return {r.uid: r for r in eng.serve(reqs)}, []
    with caplog.at_level(logging.INFO, logger="repro_torch.serving"):
        caplog.clear()
        res = {r.uid: r for r in eng.serve(reqs)}
    return res, [e for e in map(parse_event, caplog.messages) if e]


def _assert_streams(got, want, what):
    assert got.keys() == want.keys()
    for uid in want:
        assert got[uid].ok, (what, uid)
        assert got[uid].n_generated == want[uid].n_generated, (what, uid)
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens,
                                      err_msg=f"{what} uid={uid}")


def _null_page_clean(eng):
    return all(not bit_view(buf)[NULL_PAGE].any()
               for layer in eng.cache["layers"]
               for name, buf in layer.items() if name.startswith("pool_"))


def _paged_vs_dense(arch, fmt, reqs, caplog=None, plain=False, **kw):
    """The paged speculative engine's serve against the dense speculative
    engine's (and, with ``plain``, the plain paged engine's): streams
    bitwise, ``spec_stats()`` equal, the null page all zeros and the pool
    empty after the serve. Returns (paged engine, its events)."""
    cfg, params = _setup(arch)[1], _setup(arch)[3]
    policy = QuantPolicy("nxfp4", fmt)
    spec = SpeculativeConfig(k=K)
    kw = dict(dict(n_slots=2, max_len=MAX_LEN, chunk=8, device="cpu"), **kw)
    dense = ContinuousEngine(cfg, params, policy, speculative=spec, **kw)
    want, _ = _serve(dense, reqs)
    eng = PagedContinuousEngine(cfg, params, policy, speculative=spec,
                                page_size=PAGE, **kw)
    got, events = _serve(eng, reqs, caplog)
    _assert_streams(got, want, f"{arch} paged speculative")
    assert eng.spec_stats() == dense.spec_stats()
    assert eng.spec_stats()["offered"] > 0
    if plain:
        ref, _ = _serve(PagedContinuousEngine(cfg, params, policy,
                                              page_size=PAGE, **kw), reqs)
        _assert_streams(got, ref, f"{arch} plain paged")
    assert _null_page_clean(eng)
    if cfg.attn_free:                   # no pages: the engine builds no pool
        assert eng.pool is None
    else:
        eng.pool.assert_empty()
    return eng, events


@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_paged_speculative_llama_prefix_sharing(mode, caplog):
    """Four requests on a 20-token prefix into 2 slots (prefix hits),
    whole and through the lane at P 8. Three budgets end on a page's last
    row, so a live round's last rows fall past the reservation, on the
    null page (dropped: never saved, written or put back)."""
    cfg = get_smoke_config("llama3_8b")
    reqs = _shared_reqs(cfg, [4, 9, 2, 6], [8, 11, 3, 6])
    kw = {} if mode == "whole" else dict(prefill_mode="chunked", p_chunk=8)
    eng, events = _paged_vs_dense("llama3_8b", "nxfp4", reqs, caplog,
                                  plain=mode == "whole", **kw)
    assert eng.pool_stats()[0]["prefix_hits"] >= 1
    assert any(e["event"] == "prefix-hit" for e in events)


def test_paged_speculative_ring_cow_break_at_round_horizon(caplog):
    """Danube's 32-row ring, chunk 4 and k 4: a registrar of a 23-token
    prompt (2 new tokens: it never wraps) and three claimants (20 new)
    whose rounds wrap the ring into the shared pages. Each claimant is
    privatized (``cow-break``) at a ``pos`` the chunk's 4 rows would not
    wrap from but the round's k + 1 = 5 rows do; streams bitwise the
    dense speculative engine's."""
    cfg = get_smoke_config("h2o_danube_3_4b")
    w = cfg.sliding_window
    prompt = _prompts(cfg, [23], 4)[0]
    reqs = [Request(uid=0, tokens=prompt.copy(), max_new=2)]
    reqs += [Request(uid=i, tokens=prompt.copy(), max_new=20)
             for i in (1, 2, 3)]
    eng, events = _paged_vs_dense("h2o_danube_3_4b", "nxfp4", reqs, caplog,
                                  chunk=4)
    assert eng._horizon_bound() == K + 1
    breaks = [e for e in events if e["event"] == "cow-break"]
    assert breaks and eng.pool_stats()[0]["cow_breaks"] >= 1
    assert any(e["pos"] + 4 <= w < e["pos"] + K + 1 for e in breaks), breaks


@pytest.mark.parametrize("arch,fmt,kw", [
    ("hymba_1_5b", "nxfp4", dict(prefill_mode="chunked", p_chunk=16)),
    ("falcon_mamba_7b", None, {})], ids=["hymba", "falcon"])
def test_paged_speculative_ssm_families(arch, fmt, kw):
    """The hybrid family (its attention pages shared, its Mamba state per
    slot, through the lane at P = ssm_chunk) and the attention-free one
    (no pages: the dense engine's rounds)."""
    cfg = get_smoke_config(arch)
    reqs = _shared_reqs(cfg, [4, 12, 1], [6, 9, 4], prefix_len=24)
    eng, _ = _paged_vs_dense(arch, fmt, reqs, **kw)
    if cfg.attn_free:
        assert "block" not in eng.cache["layers"][0]


def test_horizon_bound_follows_the_round():
    """A dispatch's write horizon is the chunk, and k + 1 when a round
    writes more (the reference's ``max(chunk, k + 1)``)."""
    cfg, params = _setup("llama3_8b")[1], _setup("llama3_8b")[3]
    for chunk, k, want in ((16, 4, 16), (4, 4, 5), (4, None, 4)):
        spec = None if k is None else SpeculativeConfig(k=k)
        eng = PagedContinuousEngine(cfg, params, QuantPolicy("nxfp4", None),
                                    n_slots=1, max_len=MAX_LEN, chunk=chunk,
                                    speculative=spec, device="cpu")
        assert eng._horizon_bound() == want


def test_paged_speculative_matches_jax_plain_engine():
    """The slice as a whole: the port's paged speculative engine (nxfp4
    weights and KV, recycled draft, prefix sharing) on the reference's
    smoke weights emits the JAX plain ``ContinuousEngine``'s greedy
    streams, bit for bit."""
    jcfg, cfg, jparams, tparams = _setup("llama3_8b")
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=4)
    reqs = _shared_reqs(cfg, [4, 4, 4], [9, 14, 6])
    want = {r.uid: np.asarray(r.tokens) for r in jsched.ContinuousEngine(
        jcfg, jparams, JQuantPolicy("nxfp4", "nxfp4"), warn_compile=False,
        **kw).serve([jsched.Request(uid=r.uid, tokens=r.tokens,
                                    max_new=r.max_new) for r in reqs])}
    eng = PagedContinuousEngine(cfg, tparams, QuantPolicy("nxfp4", "nxfp4"),
                                speculative=SpeculativeConfig(k=K),
                                page_size=PAGE, device="cpu", **kw)
    got = {r.uid: r.tokens for r in eng.serve(reqs)}
    assert got.keys() == want.keys()
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid={uid}")
    assert eng.pool_stats()[0]["prefix_hits"] >= 1
