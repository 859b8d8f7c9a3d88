"""The split plans of the port's redesigned kernels, held on the CPU.

* ``attention_split``: the split-S plan of the decode attention kernel
  (``csrc/nxfp_attention.cu``). Its split-and-merge arithmetic, written
  out here in torch over the ranges the plan gives, is held against the
  reference's Pallas kernel in interpret mode: 1e-5 of max|V| (f32
  throughout; exp and the sums run in another order).
* The qq GEMM as the kernel now computes it: X decoded once to bf16, then
  the dequant GEMM (its plain version here) against the reference's
  Pallas qq kernel in interpret mode: 1e-5 of sum|x||w|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import get_format as jget_format
from repro.core.qtensor import QTensor as JQTensor
from repro.kernels import ops as jops
from repro.kernels.nxfp_qq_matmul import nxfp_qq_matmul_pallas
from repro_torch.convert import tensor_from_numpy
from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import nxfp_attention as na
from repro_torch.kernels.nxfp_matmul import (dequant_weight_bf16,
                                             nxfp_matmul_plain)

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

_jquantize = jax.jit(jops.quantize_qtensor, static_argnums=(1, 2),
                     static_argnames=("impl",))
_NEG = -1e30


def _port_qtensor(jq) -> QTensor:
    return QTensor(tensor_from_numpy(jq.packed), tensor_from_numpy(jq.meta),
                   jq.fmt_name, tuple(jq.shape), jq.axis, jq.orig_len)


def _ranges(s, splits, tps):
    n_tiles = -(-s // na.TILE_ROWS)
    return [(i * tps, min(n_tiles, (i + 1) * tps)) for i in range(splits)]


# (b, kvh, s): the smoke and long Llama-3-8B caches at B 4, one sequence,
# ragged and tiny caches, and batches whose heads alone fill the card
SPLIT_CASES = [(4, 8, 256), (4, 8, 4096), (1, 8, 4096), (1, 1, 100),
               (3, 2, 33), (4, 8, 1), (2, 8, 0), (16, 8, 256), (33, 8, 4096),
               (64, 8, 256)]


@pytest.mark.parametrize("b,kvh,s", SPLIT_CASES)
@pytest.mark.parametrize("n_sm", [132, 4])
def test_attention_split_covers_tiles_once(b, kvh, s, n_sm):
    """Every 32-row tile of the cache lies in exactly one split, no split
    is empty, and one sequence's grid reaches at least half the two CTAs
    per SM it aims at where the tiles allow it (whole tiles, equal
    shares), without a split more than needed. The batch ``b`` of the
    case does not enter the plan (a row's result must not depend on it)."""
    splits, tps = na.attention_split(kvh, s, n_sm)
    n_tiles = max(1, -(-s // na.TILE_ROWS))
    ranges = _ranges(max(s, 1), splits, tps)
    assert all(hi > lo for lo, hi in ranges)                  # none empty
    assert [t for lo, hi in ranges for t in range(lo, hi)] \
        == list(range(n_tiles))                               # each once
    target = na.CTAS_PER_SM * n_sm
    if splits < n_tiles:
        assert 2 * kvh * splits >= target
    assert kvh * (splits - 1) < target or splits == 1


def test_attention_split_main_path_and_full_batches():
    """The smoke run's cache (KVH 8, S 256) gets 8 splits of one tile; S
    4096 32 splits of 4 tiles, at every batch size (the continuous
    engine's slots and a request served alone take the same splits); once
    the KV heads alone reach two CTAs per SM the split falls to 1."""
    assert na.attention_split(8, 256) == (8, 1)
    assert na.attention_split(8, 4096) == (32, 4)
    assert na.attention_split(264, 4096) == (1, 128)
    assert na.attention_split(8, 512) == (16, 1)


def _split_merge(q, kd, vd, lengths, splits, tps):
    """The kernel's arithmetic: per split an online softmax over its
    32-row tiles (-1e30 mask, p zeroed where masked), then the partial
    states merged in split order."""
    b, kvh, g, d = q.shape
    s = kd.shape[1]
    rows = na.TILE_ROWS
    parts = []
    for lo, hi in _ranges(s, splits, tps):
        m = torch.full((b, kvh, g), _NEG)
        l = torch.zeros((b, kvh, g))
        acc = torch.zeros((b, kvh, g, d))
        for s0 in range(lo * rows, min(s, hi * rows), rows):
            kt, vt = kd[:, s0:s0 + rows], vd[:, s0:s0 + rows]
            sc = torch.einsum("bhgd,bshd->bhgs", q, kt)
            valid = ((torch.arange(s0, s0 + kt.shape[1])[None, :]
                      < lengths[:, None])[:, None, None, :])
            sc = torch.where(valid, sc, torch.full_like(sc, _NEG))
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(valid, torch.exp(sc - m_new[..., None]),
                            torch.zeros_like(sc))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgs,bshd->bhgd",
                                                        p, vt)
            m = m_new
        parts.append((m, l, acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    l = sum(pl * torch.exp(pm - mx) for pm, pl, _ in parts)
    acc = sum(pa * torch.exp(pm - mx)[..., None] for pm, _, pa in parts)
    return acc / torch.clamp(l, min=1e-30)[..., None]


@pytest.mark.parametrize("fname", ["nxfp4", "amxfp4", "mxfp4_ox"])
@pytest.mark.parametrize("n_sm", [132, 4])
def test_split_merge_matches_pallas(fname, n_sm):
    """Split-S over the ranges ``attention_split`` plans (one tile per
    split on 132 SMs, two on 4), merged in split order, against the
    reference's Pallas decode attention: sequence 1 leaves whole splits
    masked, sequence 2 has length 0 (its output is 0). asym (uint32 meta)
    and ox caches take the activation-format decode."""
    rng = np.random.default_rng(7)
    b, s, kvh, g, hd = 3, 256, 2, 2, 32
    q = rng.standard_normal((b, kvh * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    k[0, 3, 1, 2] = 30.0                      # an ox outlier in one block
    lengths = np.array([256, 40, 0], np.int32)
    jk = _jquantize(jnp.asarray(k), fname, -1, impl="xla")
    jv = _jquantize(jnp.asarray(v), fname, -1, impl="xla")
    oj = np.asarray(jops.decode_attention(jnp.asarray(q), jk, jv,
                                          jnp.asarray(lengths), kvh,
                                          impl="pallas"))
    tk, tv = _port_qtensor(jk), _port_qtensor(jv)
    kd = na.dequant_cache(tk.packed, tk.meta, tk.fmt)
    vd = na.dequant_cache(tv.packed, tv.meta, tv.fmt)
    qg = (torch.from_numpy(q).reshape(b, kvh, g, hd)
          * float(np.float32(1.0 / np.sqrt(hd))))
    splits, tps = na.attention_split(kvh, s, n_sm)
    assert splits == (8 if n_sm == 132 else 4)
    masked = [i for i, (lo, _) in enumerate(_ranges(s, splits, tps))
              if lo * na.TILE_ROWS >= lengths[1]]
    assert masked                             # a split wholly masked
    ot = _split_merge(qg, kd, vd, torch.from_numpy(lengths), splits, tps)
    ot = ot.reshape(b, kvh * g, hd).numpy()
    vmax = float(vd.abs().max())
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-5 * vmax)
    assert not ot[2].any()                    # length 0 gives 0


# (activation fmt, weight fmt): the PAIRS of tests/test_qq_matmul.py
QQ_PAIRS = [("amxfp4", "nxfp4"), ("amxfp4_ox", "nxfp4"), ("mxfp4_ox", "nxfp4"),
            ("amxfp4", "nxfp6"), ("amxfp4_nm", "nxfp8"), ("mxfp4", "mxfp4")]


@pytest.mark.parametrize("xf,wf", QQ_PAIRS)
def test_qq_as_dequant_gemm_matches_pallas(xf, wf):
    """What the CUDA qq GEMM computes: X decoded once to bf16, then the
    dequant GEMM on it, held against the reference's Pallas qq kernel
    (interpret mode) on the reference's packed operands: 1e-5 of
    sum|x||w|."""
    m, k, n = 17, 256, 64
    rng = np.random.default_rng(11)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    jx = _jquantize(jnp.asarray(x), xf, -1, impl="xla")
    jw = JQTensor.quantize(jnp.asarray(w), jget_format(wf), axis=0)
    yj = np.asarray(nxfp_qq_matmul_pallas(
        jx.packed, jx.meta, jw.packed, jw.meta, jx.fmt, jw.fmt, tile_m=32,
        tile_n=64, tile_k=128, interpret=True))
    tx, tw = _port_qtensor(jx), _port_qtensor(jw)
    xd = dequant_weight_bf16(tx.packed, tx.meta, tx.fmt)
    yt = nxfp_matmul_plain(xd, tw.packed, tw.meta, tw.fmt).numpy()
    assert yt.shape == yj.shape == (m, n)
    wd = dequant_weight_bf16(tw.packed, tw.meta, tw.fmt).float()
    mag = (xd.float().abs() @ wd.abs().T).numpy()
    assert (np.abs(yt - yj) <= 1e-5 * mag).all()
