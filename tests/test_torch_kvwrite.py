"""The quantizer's KV-row entry and its regime plan, on the CPU.

* ``nxfp_quantize_kv_rows`` (plain version, as the CPU runs it) gives the
  cache the port's previous write gave (two encodes through
  ``quantize_qtensor``, then row writes), byte for byte.
* The port's ``write_prefill`` / ``write_token`` caches equal the
  reference's (``repro.models.kvcache``, XLA on the CPU) layer cache
  after a prefill and ragged decode steps, byte for byte up to counted
  candidate near-ties (the 32-value mean is summed in another order by
  XLA; 0 seen so far).
* The codec reads bf16 input exactly: equal to the same codec on the f32
  copy, bitwise.
* ``quantize_plan`` covers every block once, at edge block counts.
* The kernel's skip rule: a nano-0 candidate it skips is the rounded-nano
  candidate before it, codes, meta and MSE alike.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import kvcache as jkv
from repro_torch.configs import get_smoke_config
from repro_torch.core import quantize as tquant
from repro_torch.core.formats import get_format
from repro_torch.core.quantize import meta_int32, near_tie_blocks, to_blocks
from repro_torch.kernels import build
from repro_torch.kernels import nxfp_quantize as nq
from repro_torch.kernels.ops import quantize_qtensor
from repro_torch.models import kvcache

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

KV_FMTS = ["nxfp4", "mxfp6", "nxfp4_bs16"]


def _bf16_values(rng, shape, scale=1.0):
    """Normal values that bf16 holds exactly (as f32 numpy)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _random_cache(fmt, b, s, kvh, hd, seed):
    """A layer cache filled with random bytes, so a row the write must
    leave alone shows if it was touched."""
    g = torch.Generator().manual_seed(seed)
    nb = -(-hd // fmt.block_size)
    out = {}
    for name in "kv":
        out[f"{name}_packed"] = torch.randint(
            0, 256, (b, s, kvh, nb, fmt.bytes_per_block), generator=g,
            dtype=torch.uint8)
        out[f"{name}_meta"] = torch.randint(
            0, 1 << 16, (b, s, kvh, nb), generator=g,
            dtype=torch.int32).to(torch.uint16)
    return out


def _old_write(cache, k, v, pos, fmt):
    """The port's write before the fused entry: ``quantize_qtensor`` on K
    and V, then slice writes (prefill) or index writes at (slot, pos + t)."""
    b, t = k.shape[:2]
    for name, x in (("k", k), ("v", v)):
        qt = quantize_qtensor(x.float(), fmt, axis=-1, device="cpu")
        for key, val in ((f"{name}_packed", qt.packed),
                         (f"{name}_meta", qt.meta)):
            buf = cache[key]
            buf = buf.view(torch.int16) if buf.dtype == torch.uint16 else buf
            val = val.view(torch.int16) if val.dtype == torch.uint16 else val
            if pos is None:
                buf[:, :t] = val
            else:
                for ti in range(t):
                    buf[torch.arange(b), pos + ti] = val[:, ti]
    return cache


# (b, t, kvh, hd, s, pos): a prefill, a decode step at ragged rows, a
# three-token write at ragged rows, head_dim 16 in one zero-padded block
KV_CASES = {
    "prefill": (3, 5, 2, 64, 9, None),
    "decode": (4, 1, 2, 64, 9, (0, 8, 3, 5)),
    "three_rows": (2, 3, 2, 64, 9, (6, 1)),
    "padded_hd": (2, 2, 3, 16, 6, (4, 0)),
}


@pytest.mark.parametrize("fname", KV_FMTS)
@pytest.mark.parametrize("case", sorted(KV_CASES))
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_kv_rows_plain_matches_old_path(fname, case, dtype):
    fmt = get_format(fname)
    b, t, kvh, hd, s, pos = KV_CASES[case]
    rng = np.random.default_rng(sorted(KV_CASES).index(case))
    k = torch.from_numpy(_bf16_values(rng, (b, t, kvh, hd)))
    v = torch.from_numpy(_bf16_values(rng, (b, t, kvh, hd), 3.0))
    if dtype == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    pos_t = None if pos is None else torch.tensor(pos, dtype=torch.int32)
    old = _old_write(_random_cache(fmt, b, s, kvh, hd, 1), k, v, pos_t, fmt)
    new = _random_cache(fmt, b, s, kvh, hd, 1)
    assert nq.nxfp_quantize_kv_rows(k, v, new, pos_t, fmt) is new
    for key in old:
        assert torch.equal(old[key], new[key]), key


def _port_cache(cfg, fmt_name, k, v, steps, max_len):
    cache = kvcache.write_prefill(cfg, k, v, fmt_name, max_len)
    for k1, v1, pos in steps:
        kvcache.write_token(cfg, cache, k1, v1, pos, fmt_name)
    return cache


def _ref_cache(jcfg, fmt_name, k, v, steps, max_len):
    cache = jkv.write_prefill(jcfg, jnp.asarray(k.float().numpy()),
                              jnp.asarray(v.float().numpy()), fmt_name,
                              max_len)
    for k1, v1, pos in steps:
        cache = jkv.write_token(jcfg, cache, jnp.asarray(k1.float().numpy()),
                                jnp.asarray(v1.float().numpy()),
                                jnp.asarray(pos.numpy()), fmt_name)
    return {n: np.asarray(a) for n, a in cache.items()}


@pytest.mark.parametrize("fname", ["nxfp4", "nxfp8", "mxfp4_cr"])
def test_write_prefill_and_token_match_reference(fname):
    """Prefill 5 tokens, then 3 decode steps at ragged rows (slot 1 two
    rows ahead): every packed byte and meta word of the layer cache equals
    the reference's, up to counted near-ties."""
    jcfg, cfg = jget_smoke_config("llama3_8b"), get_smoke_config("llama3_8b")
    fmt = get_format(fname)
    b, t, kvh, hd, max_len = 2, 5, cfg.n_kv_heads, cfg.hd, 12
    rng = np.random.default_rng(7)
    k, v = (torch.from_numpy(_bf16_values(rng, (b, t, kvh, hd), sc))
            .to(torch.bfloat16) for sc in (1.0, 2.0))
    steps = []
    for i in range(3):
        k1, v1 = (torch.from_numpy(_bf16_values(rng, (b, 1, kvh, hd), sc))
                  .to(torch.bfloat16) for sc in (1.0, 2.0))
        steps.append((k1, v1, torch.tensor([t + i, t + 2 + i],
                                           dtype=torch.int32)))
    port = _port_cache(cfg, fname, k, v, steps, max_len)
    ref = _ref_cache(jcfg, fname, k, v, steps, max_len)
    assert set(port) == set(ref)
    # the source block of every cache block, zeros where nothing was written
    src = {"k": torch.zeros((b, max_len, kvh, hd)),
           "v": torch.zeros((b, max_len, kvh, hd))}
    src["k"][:, :t], src["v"][:, :t] = k.float(), v.float()
    for k1, v1, pos in steps:
        src["k"][torch.arange(b), pos] = k1[:, 0].float()
        src["v"][torch.arange(b), pos] = v1[:, 0].float()
    n_ties = 0
    for name in "kv":
        packed, meta = port[f"{name}_packed"], port[f"{name}_meta"]
        diff = ((packed.numpy() != ref[f"{name}_packed"]).any(-1)
                | (meta_int32(meta).numpy()
                   != ref[f"{name}_meta"].astype(np.int32)))
        if diff.any():
            xb, _ = to_blocks(src[name], fmt.block_size, -1)
            ties = near_tie_blocks(xb[torch.from_numpy(diff)], fmt)
            assert bool(ties.all()), f"{name}: {int((~ties).sum())} blocks"
            n_ties += int(diff.sum())
    print(f"{fname}: {n_ties} near-tie blocks")


@pytest.mark.parametrize("fname", ["nxfp4", "nxfp4_bs16", "mxfp6_e3m2",
                                   "nxfp8", "bfp5", "amxfp4", "amxfp4_ox",
                                   "mxfp4_ox"])
def test_plain_codec_reads_bf16_exactly(fname):
    fmt = get_format(fname)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((257, fmt.block_size))
         * np.exp(rng.normal(0, 4, size=(257, 1)))).astype(np.float32)
    x[0, :3] = [np.inf, -np.inf, np.nan]
    x[1] = 1e-40
    xh = torch.from_numpy(x).to(torch.bfloat16)
    ph, mh = nq.nxfp_quantize_pack(xh, fmt)
    pf, mf = nq.nxfp_quantize_pack(xh.float(), fmt)
    assert torch.equal(ph, pf)
    assert torch.equal(meta_int32(mh), meta_int32(mf))


PLAN_BLOCKS = [1, 31, 32, 33, 128, 256, nq.WARP_MAX_BLOCKS,
               nq.WARP_MAX_BLOCKS + 1, 32768, 1_835_008]


@pytest.mark.parametrize("n", PLAN_BLOCKS)
@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("n_sm", [132, 4])
def test_quantize_plan_covers_every_block_once(n, bs, n_sm):
    """CTA c takes blocks [c * per_cta, (c + 1) * per_cta): the ranges
    cover [0, n) once, none is empty, and the CTA's shape is one the
    kernel launches (<= 8 warps of whole blocks; 32 to 128 threads)."""
    plan = nq.quantize_plan(n, bs, n_sm)
    seen = np.zeros(n, np.int32)
    for c in range(plan.grid):
        lo, hi = c * plan.per_cta, min(n, (c + 1) * plan.per_cta)
        assert hi > lo
        seen[lo:hi] += 1
    assert (seen == 1).all()
    if plan.regime == "warp":
        per_warp = 32 // bs
        assert n <= nq.WARP_MAX_BLOCKS
        assert plan.per_cta % per_warp == 0
        assert 1 <= plan.per_cta // per_warp <= 8
    else:
        assert plan.regime == "tile" and n > nq.WARP_MAX_BLOCKS
        assert plan.per_cta in (32, 64, 128)
        # at least two CTAs per SM where 32-block CTAs allow it
        assert plan.grid >= min(2 * n_sm, -(-n // 32))


@pytest.mark.parametrize("fname", ["nxfp4", "nxfp4_nm", "nxfp8", "amxfp4_nm",
                                   "nxfp4_bs16", "amxfp4_nm_am"])
def test_skipped_candidates_are_the_rounded_ones(fname):
    """Where ``evaluated_candidates`` counts a nano-0 candidate as skipped,
    its codes, meta and MSE equal the rounded-nano candidate's just before
    it, so the strict `<` never takes it; and the count is what the list
    less the skips gives."""
    fmt = get_format(fname)
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((2048, fmt.block_size))
                          * np.exp(rng.normal(0, 3, size=(2048, 1))))
                         .astype(np.float32))
    cands = tquant.candidates(fmt)
    res = list(tquant._candidate_results(x, fmt))
    skipped = torch.zeros(x.shape[0], dtype=torch.int32)
    for i, (_, _, mode) in enumerate(cands):
        if mode is None and i > 0 and cands[i - 1][2] == "round":
            (c0, m0, e0), (c1, m1, e1) = res[i - 1], res[i]
            same = ((c0 == c1).all(-1) & (m0 == m1)
                    & (e0.view(torch.int32) == e1.view(torch.int32)))
            zero = ((m0 >> 8) & 3) == 0
            if fmt.asym:
                zero &= ((m0 >> 24) & 3) == 0
            assert bool(same[zero].all())
            skipped += zero.to(torch.int32)
    count = nq.evaluated_candidates(x, fmt)
    assert torch.equal(count, len(cands) - skipped)
    print(f"{fname}: {float(count.float().mean()):.3f} of {len(cands)} "
          "candidates evaluated per block")


def test_kv_rows_cuda_request_takes_no_plain_path(monkeypatch):
    """A CUDA-bound K/V write goes to the kernel (and fails here for want
    of a card), never to the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "on_cuda", lambda *tensors: True)

    def plain_called(*a, **k):
        raise AssertionError("a CUDA request took the plain version")

    monkeypatch.setattr(nq, "nxfp_quantize_kv_rows_plain", plain_called)
    monkeypatch.setattr(nq, "nxfp_quantize_pack_plain", plain_called)
    fmt = get_format("nxfp4")
    k = torch.zeros((2, 1, 2, 64), dtype=torch.bfloat16)
    cache = _random_cache(fmt, 2, 4, 2, 64, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        nq.nxfp_quantize_kv_rows(k, k, cache,
                                 torch.zeros(2, dtype=torch.int32), fmt)
