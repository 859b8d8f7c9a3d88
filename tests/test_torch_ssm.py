"""The SSM and hybrid families in the torch port, on the CPU at smoke size.

* Against the reference (``src/repro/models/ssm.py``), from the same
  seeded numpy inputs and the reference's own smoke weights carried across
  by ``params_from_jax``: ``_causal_conv``, ``_ssm_coeffs``,
  ``_chunked_scan``, ``mamba_block`` (with ``h0``, ``conv0`` and
  ``n_valid``) and ``mamba_step``. Tolerances: the scan coefficients of
  the same bf16 input and the scan itself 1e-5 of their scale (the same
  f32 ops, in another order in XLA); a block's or a step's outputs and
  states 2e-2 of their scale (they follow bf16 activations, rounded per op
  in torch and fused in XLA: ``tests/test_torch_model.py``'s reason). The
  conv tail is a copy of input rows: bitwise against the port's own rows.
* The scan's contract with the chunked-prefill lane: a prefix scanned
  alone gives the same bits as the same prefix padded with identity steps
  to ``ssm_chunk`` (outputs, and the state after its last valid step).
* ``param_count`` of both full configs is the reference's; smoke logits
  within 1e-2 and greedy streams equal to the reference's ``ServeEngine``.
* The port's own invariants: the lane at P 16 bitwise the whole prefill
  (``tests/test_torch_lane.py`` holds the reference's rows), ``decode_step
  (live=)`` freezing a slot's ``h``/``conv``, ``reset_slot`` zeroing them,
  the ``p_chunk % ssm_chunk`` refusal and ``"auto"``'s filter. The
  tiered engine on these families: ``tests/test_torch_tiers_ssm.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.core.qtensor import direct_cast_tree as jdirect_cast_tree
from repro.kernels.ops import quantize_qtensor as jquantize_qtensor
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models import ssm as jssm
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.models import (decode_step, init_cache, init_lane,
                                init_params, prefill, prefill_chunk,
                                reset_slot, write_cache_slot)
from repro_torch.models import ssm
from repro_torch.serving import ContinuousEngine, ServeEngine

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

ARCHS = ("falcon_mamba_7b", "hymba_1_5b")
TOL = 1e-2          # logits (tests/test_torch_model.py)
F32_TOL = 1e-5      # of the scale: f32 coefficients and states
BF16_TOL = 2e-2     # of the scale: bf16 outputs
MAX_LEN = 64


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The reference's smoke config and params of ``arch`` and the port's
    copy of them."""
    jcfg = jget_smoke_config(arch)
    cfg = get_smoke_config(arch)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, cfg, jparams, tparams


def _layer0(arch):
    jcfg, cfg, jparams, tparams = _setup(arch)
    return (jcfg, cfg, jax.tree.map(lambda a: a[0], jparams["layers"]),
            tparams["layers"][0])


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(x):
    """A port tensor or a reference array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _inputs(cfg, b, t, seed):
    """Seeded (B, T, D) bf16 activations, a carried state and conv tail."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((b, cfg.dinner, cfg.ssm_state))
          ).astype(np.float32)
    conv0 = rng.standard_normal((b, cfg.conv_width - 1,
                                 cfg.dinner)).astype(np.float32)
    return x, h0, conv0


# ---------------------------------------------------------------------------
# the Mamba pieces against the reference
# ---------------------------------------------------------------------------

def test_causal_conv_matches_reference():
    jcfg, cfg, jp, tp = _layer0("falcon_mamba_7b")
    rng = np.random.default_rng(0)
    xi = rng.standard_normal((2, 21, cfg.dinner)).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(xi, jnp.bfloat16), jp["ssm_conv_w"],
                             jp["ssm_conv_b"], cfg.conv_width)
    got = ssm._causal_conv(_bf16(xi), tp["ssm_conv_w"], tp["ssm_conv_b"],
                           cfg.conv_width)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_coeffs_match_reference(arch):
    jcfg, cfg, jp, tp = _layer0(arch)
    xc = np.random.default_rng(1).standard_normal(
        (2, 19, cfg.dinner)).astype(np.float32)
    ja, jbx, jc = jssm._ssm_coeffs(jcfg, jp, jnp.asarray(xc, jnp.bfloat16),
                                   "ssm_")
    a, bx, c = ssm._ssm_coeffs(cfg, tp, _bf16(xc))
    for got, want in ((a, ja), (bx, jbx), (c, jc)):
        assert got.dtype == torch.float32
        _close(got, want, F32_TOL)


@pytest.mark.parametrize("t", [5, 16, 37])
def test_chunked_scan_matches_reference(t):
    """T below, at and past the chunk (16): one chunk, one exact chunk, and
    three chunks with an identity-padded tail."""
    rng = np.random.default_rng(t)
    b, di, n = 2, 24, 8
    a = np.exp(-rng.uniform(0.0, 2.0, (b, t, di, n))).astype(np.float32)
    bx = rng.standard_normal((b, t, di, n)).astype(np.float32)
    c = rng.standard_normal((b, t, n)).astype(np.float32)
    h0 = rng.standard_normal((b, di, n)).astype(np.float32)
    jy, jh = jssm._chunked_scan(*(jnp.asarray(v) for v in (a, bx, c, h0)),
                                16)
    y, h = ssm._chunked_scan(*(torch.from_numpy(v) for v in (a, bx, c, h0)),
                             16)
    _close(y, jy, F32_TOL)
    _close(h, jh, F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("resume", [False, True])
def test_mamba_block_matches_reference(arch, resume):
    """From zeros, and resumed from a carried ``h0``/``conv0`` with a
    padded tail (``n_valid`` 13 of 20 rows, the lane's chunk): the output,
    the state and the conv tail (bitwise: a copy of input rows)."""
    jcfg, cfg, jp, tp = _layer0(arch)
    x, h0, conv0 = _inputs(cfg, 1, 20, 2)
    kw, jkw = {}, {}
    if resume:
        kw = dict(h0=torch.from_numpy(h0), conv0=_bf16(conv0),
                  n_valid=torch.tensor([13], dtype=torch.int32))
        jkw = dict(h0=jnp.asarray(h0), conv0=jnp.asarray(conv0, jnp.bfloat16),
                   n_valid=jnp.int32(13))
    jout, jh, jconv = jssm.mamba_block(jcfg, jp, jnp.asarray(x, jnp.bfloat16),
                                       **jkw)
    out, h, conv = ssm.mamba_block(cfg, tp, _bf16(x), **kw)
    _close(out, jout, BF16_TOL)
    _close(h, jh, BF16_TOL)
    xi = ssm.dense(_bf16(x), tp["ssm_in_w"])[..., :cfg.dinner]
    hist = torch.cat([_bf16(conv0) if resume else torch.zeros_like(
        xi[:, :cfg.conv_width - 1]), xi], dim=1)
    end = 13 if resume else 20
    assert torch.equal(conv, hist[:, end:end + cfg.conv_width - 1])
    _close(conv, jconv, BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_step_matches_reference(arch):
    jcfg, cfg, jp, tp = _layer0(arch)
    x, h0, conv0 = _inputs(cfg, 3, 1, 3)
    jout, jh, jconv = jssm.mamba_step(jcfg, jp, jnp.asarray(x, jnp.bfloat16),
                                      jnp.asarray(h0),
                                      jnp.asarray(conv0, jnp.bfloat16))
    out, h, conv = ssm.mamba_step(cfg, tp, _bf16(x), torch.from_numpy(h0),
                                  _bf16(conv0))
    _close(out, jout, BF16_TOL)
    _close(h, jh, BF16_TOL)
    np.testing.assert_array_equal(_np(conv), _np(jconv))     # a shift


def test_scan_prefix_is_length_independent():
    """A prefix of t steps scanned alone (one chunk of t) and the same
    prefix padded with identity steps to the chunk (16) give the same bits:
    every output row, and the state after step t - 1."""
    rng = np.random.default_rng(4)
    b, di, n, chunk = 2, 8, 8, 16
    a = torch.from_numpy(np.exp(-rng.uniform(
        0, 2, (b, chunk, di, n))).astype(np.float32))
    bx = torch.from_numpy(rng.standard_normal((b, chunk, di, n)).astype(
        np.float32))
    c = torch.from_numpy(rng.standard_normal((b, chunk, n)).astype(
        np.float32))
    h0 = torch.from_numpy(rng.standard_normal((b, di, n)).astype(np.float32))
    for t in (1, 3, 7, 11, 15):
        y, h = ssm._chunked_scan(a[:, :t], bx[:, :t], c[:, :t], h0, chunk)
        ap, bp = a.clone(), bx.clone()
        ap[:, t:], bp[:, t:] = 1.0, 0.0
        yp, hp = ssm._scan(lambda lo, hi: (ap[:, lo:hi].clone(),
                                           bp[:, lo:hi].clone()),
                           c, h0, chunk, chunk,
                           torch.tensor([t], dtype=torch.int32))
        assert torch.equal(y, yp[:, :t]), t
        assert torch.equal(h, hp), t


# ---------------------------------------------------------------------------
# configs and the slice against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_reference(arch):
    for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                      (get_smoke_config(arch), jget_smoke_config(arch))):
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab", "sliding_window", "ssm_state", "d_inner",
                  "dt_rank", "conv_width", "ssm_chunk"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert (cfg.dinner, cfg.dtrank, cfg.attn_free) == \
            (jcfg.dinner, jcfg.dtrank, jcfg.attn_free)
        assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch,fmt", [("falcon_mamba_7b", None),
                                      ("falcon_mamba_7b", "nxfp4"),
                                      ("hymba_1_5b", "nxfp4")])
def test_smoke_logits_and_greedy_streams_match_reference(arch, fmt):
    """Prefill logits within the model tolerance and a greedy stream of 8
    tokens equal to the reference's ``ServeEngine`` (hymba: a 40-token
    prompt over its 32-row ring). Both serve the reference's cast of the
    weights (jitted: its engine's own load-time cast runs the Pallas
    quantizer in interpret mode here), carried across bit for bit."""
    jcfg, cfg, jparams, tparams = _setup(arch)
    if fmt is not None:
        jparams = jdirect_cast_tree(
            jparams, JQuantPolicy(fmt, fmt), quantize_fn=jax.jit(
                jquantize_qtensor, static_argnums=(1, 2)))
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 40 if cfg.sliding_window else 12)).astype(np.int32)
    jeng = JServeEngine(jcfg, jparams, JQuantPolicy(None, fmt),
                        max_len=MAX_LEN)
    eng = ServeEngine(cfg, tparams, QuantPolicy(None, fmt), max_len=MAX_LEN,
                      device="cpu")
    jl, _ = jprefill(jcfg, jeng.params, {"tokens": toks}, max_len=MAX_LEN,
                     kv_fmt=fmt)
    tl, _ = prefill(cfg, eng.params, {"tokens": torch.from_numpy(
        toks).long()}, MAX_LEN, fmt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    want = jeng.generate({"tokens": toks}, max_new=8, loop="host")
    got = eng.generate({"tokens": toks}, max_new=8, loop="host")
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lane_state_bitwise_whole_prefill(arch):
    """A prompt shorter than ``ssm_chunk`` (the whole prefill scans 9
    steps, the lane 16 with an identity tail) and one of three lane chunks:
    the slot's ``h``/``conv`` after the lane's last chunk are the whole
    prefill's, bit for bit."""
    _, cfg, _, tparams = _setup(arch)
    p = cfg.ssm_chunk
    for t in (9, 2 * p + 5):
        toks = np.random.default_rng(t).integers(0, cfg.vocab, (t,))
        want, whole = prefill(cfg, tparams, {"tokens": torch.from_numpy(
            toks[None]).long()}, MAX_LEN, "nxfp4")
        cache = init_cache(cfg, 2, MAX_LEN, "nxfp4", device="cpu")
        lane = init_lane(cfg, MAX_LEN, p, device="cpu")
        for off in range(0, t, p):
            n = min(p, t - off)
            chunk = torch.zeros((1, p), dtype=torch.long)
            chunk[0, :n] = torch.from_numpy(toks[off:off + n])
            logits, cache, lane = prefill_chunk(cfg, tparams, chunk, cache,
                                                1, off, n, lane, "nxfp4")
        assert torch.equal(logits, want), t
        for lc, wc in zip(cache["layers"], whole["layers"]):
            for name in ("h", "conv"):
                assert torch.equal(lc[name][1], wc[name][0]), (t, name)
                assert not lc[name][0].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_live_freezes_state_and_reset_zeroes_it(arch):
    """``decode_step(live=)``: a not-live slot's ``h``/``conv`` stay bit for
    bit (and its pos), a live slot's are those of ``live=None``;
    ``reset_slot`` zeroes one slot's state and leaves the other's."""
    _, cfg, _, tparams = _setup(arch)
    cache = init_cache(cfg, 2, MAX_LEN, "nxfp4", device="cpu")
    for slot, t in ((0, 11), (1, 7)):
        toks = np.random.default_rng(slot).integers(0, cfg.vocab, (1, t))
        _, solo = prefill(cfg, tparams, {"tokens": torch.from_numpy(
            toks).long()}, MAX_LEN, "nxfp4")
        write_cache_slot(cache, solo, slot)

    def clone(c):
        return {"pos": c["pos"].clone(),
                "layers": [{k: v.clone() for k, v in lc.items()}
                           for lc in c["layers"]]}

    tok = torch.tensor([[3], [5]])
    free = clone(cache)
    lf, free = decode_step(cfg, tparams, tok, free, "nxfp4")
    live = torch.tensor([True, False])
    before = clone(cache)
    lg, cache = decode_step(cfg, tparams, tok, cache, "nxfp4", live=live)
    assert torch.equal(lg[0], lf[0])
    assert cache["pos"].tolist() == [12, 7]
    for lc, fc, bc in zip(cache["layers"], free["layers"],
                          before["layers"]):
        for name in ("h", "conv"):
            assert torch.equal(lc[name][0], fc[name][0]), name
            assert torch.equal(lc[name][1], bc[name][1]), name
            assert not torch.equal(lc[name][0], bc[name][0]), name
    reset_slot(cfg, cache, 0)
    assert cache["pos"].tolist() == [0, 7]
    for lc, bc in zip(cache["layers"], before["layers"]):
        for name in ("h", "conv"):
            assert not lc[name][0].any()
            assert torch.equal(lc[name][1], bc[name][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_p_chunk_must_align_with_ssm_chunk(arch):
    """A lane width that is not a multiple of ``ssm_chunk`` is refused (it
    would regroup the scan), and ``"auto"`` drops such candidates: none of
    them left is an error, else the pick is a multiple."""
    _, cfg, _, tparams = _setup(arch)
    with pytest.raises(ValueError, match="ssm_chunk"):
        init_lane(cfg, MAX_LEN, 8, device="cpu")
    with pytest.raises(ValueError, match="ssm_chunk"):
        ContinuousEngine(cfg, tparams, QuantPolicy(None, None), n_slots=1,
                         max_len=MAX_LEN, prefill_mode="chunked", p_chunk=24,
                         device="cpu")
    with pytest.raises(ValueError, match="no candidate"):
        ContinuousEngine(cfg, tparams, QuantPolicy(None, None), n_slots=1,
                         max_len=MAX_LEN, prefill_mode="chunked",
                         p_chunk="auto", p_chunk_candidates=(4, 8, 24),
                         device="cpu")
    eng = ContinuousEngine(cfg, tparams, QuantPolicy(None, None), n_slots=1,
                           max_len=MAX_LEN, prefill_mode="chunked",
                           p_chunk="auto", p_chunk_candidates=(8, 16, 24, 32),
                           device="cpu")
    assert sorted(eng.p_chunk_sweep) == [16, 32]
    assert eng.p_chunk in (16, 32)


def test_init_params_shapes():
    """The port's own seeded init: the reference's leaves and shapes."""
    for arch in ARCHS:
        jcfg, cfg, jparams, _ = _setup(arch)
        p = init_params(cfg, seed=0, device="cpu")
        jl = jax.tree.map(lambda a: a[0], jparams["layers"])
        assert sorted(p["layers"][0]) == sorted(jl)
        for name, leaf in p["layers"][0].items():
            assert tuple(leaf.shape) == tuple(jl[name].shape), name
