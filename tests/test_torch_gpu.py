"""CUDA kernels of the torch port against their plain PyTorch versions.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports torch and numpy only, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.formats import get_format
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.core.quantize import meta_int32, near_tie_blocks, to_blocks
from repro_torch.kernels import nxfp_attention as na
from repro_torch.kernels import nxfp_matmul as nm
from repro_torch.kernels import nxfp_qq_matmul as nqq
from repro_torch.kernels import nxfp_quantize as nq
from repro_torch.kernels.ops import quantize_qtensor
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.serving import ServeEngine

pytestmark = pytest.mark.gpu

KERNEL_FMTS = ["bfp4", "bfp4_cr", "mxfp4", "mxfp4_cr", "nxfp4", "nxfp4_nm",
               "nxfp4_nm_am", "nxfp4_bs16", "nxfp8", "mxfp8", "bfp8",
               "nxfp5", "mxfp5", "nxfp6", "mxfp6", "mxfp6_e3m2"]
# the activation formats (asym: uint32 meta; ox: outlier mantissa)
ACT_FMTS = ["amxfp4", "amxfp4_nm", "amxfp4_ox", "mxfp4_ox"]
# (activation fmt, weight fmt): the serving tiers' pairs plus width mixes
QQ_PAIRS = [("amxfp4", "nxfp4"), ("amxfp4_ox", "nxfp4"), ("mxfp4_ox", "nxfp4"),
            ("amxfp4", "nxfp6"), ("amxfp4_nm", "nxfp8"), ("mxfp4", "mxfp4"),
            ("nxfp5", "amxfp4"), ("mxfp8", "nxfp5")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _edge_blocks(fmt, n=513, seed=0):
    rng = np.random.default_rng(seed)
    b = fmt.block_size
    xb = (rng.standard_normal((n, b))
          * np.exp(rng.normal(0, 4, size=(n, 1)))).astype(np.float32)
    xb[0] = 0.0
    xb[1, :4] = [np.nan, np.inf, -np.inf, 0.0]
    xb[2] = 1e30
    xb[3, ::2] = 0.0
    xb[4] = -0.0
    xb[5] = 1e-40
    xb[6] = -np.abs(xb[6])                       # one-signed blocks (asym)
    xb[7] = np.abs(xb[7])
    xb[8, 3], xb[8, min(9, b - 1)] = 7.0, -7.0   # tied |max| of both signs
    return torch.from_numpy(xb)


@pytest.mark.parametrize("fname", KERNEL_FMTS + ACT_FMTS)
def test_quantize_kernel_bitwise(cuda, fname):
    """The CUDA quantizer equals the plain codec bit for bit (packed bytes
    and meta, uint32 for asym formats), up to counted candidate
    near-ties."""
    fmt = get_format(fname)
    xb = _edge_blocks(fmt).to(cuda)
    kp, km = nq.nxfp_quantize_pack(xb, fmt)
    pp, pm = nq.nxfp_quantize_pack_plain(xb, fmt)
    assert km.dtype == pm.dtype == getattr(torch, fmt.meta_dtype)
    diff = (kp != pp).any(-1) | (meta_int32(km) != meta_int32(pm))
    if diff.any():
        assert near_tie_blocks(xb[diff], fmt).all(), int(diff.sum())
    print(f"{fname}: {int(diff.sum())} near-tie blocks")


def _quantize_vs_plain(xb, fmt, plan=None):
    """Kernel vs plain codec on the same blocks; blocks that differ must
    be candidate near-ties. Returns their count."""
    kp, km = nq.nxfp_quantize_pack(xb, fmt, plan)
    pp, pm = nq.nxfp_quantize_pack_plain(xb, fmt)
    assert km.dtype == pm.dtype == getattr(torch, fmt.meta_dtype)
    diff = (kp != pp).any(-1) | (meta_int32(km) != meta_int32(pm))
    if diff.any():
        assert near_tie_blocks(xb[diff], fmt).all(), int(diff.sum())
    return int(diff.sum())


@pytest.mark.parametrize("fname", KERNEL_FMTS + ACT_FMTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", ["warp", "tile"])
def test_quantize_kernel_regimes_bitwise(cuda, fname, dtype, side):
    """Both sides of the regime boundary (``WARP_MAX_BLOCKS`` blocks: a
    warp per block; one more: a thread per block), f32 and bf16 input:
    the kernel equals the plain codec on the same input, up to counted
    near-ties."""
    fmt = get_format(fname)
    n = nq.WARP_MAX_BLOCKS + (side == "tile")
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert nq.quantize_plan(n, fmt.block_size, n_sm).regime == side
    xb = _edge_blocks(fmt, n=n).to(cuda, getattr(torch, dtype))
    print(f"{fname} {dtype} {side}: {_quantize_vs_plain(xb, fmt)} near ties")


@pytest.mark.parametrize("fname", ["nxfp4", "nxfp4_bs16", "amxfp4",
                                   "amxfp4_ox", "mxfp4_ox", "nxfp6",
                                   "bfp4_cr", "nxfp5_bs16"])
@pytest.mark.parametrize("regime", ["warp", "tile"])
@pytest.mark.parametrize("n", [1, 33, 517])
def test_quantize_kernel_either_regime_any_count(cuda, fname, regime, n):
    """Either regime at block counts that fill no CTA evenly (a plan the
    wrapper would not pick at these sizes, to hold both kernels on the
    same blocks)."""
    fmt = get_format(fname)
    per_cta = 3 * (32 // fmt.block_size) if regime == "warp" else 64
    plan = nq.QuantPlan(regime, per_cta, -(-n // per_cta))
    xb = _edge_blocks(fmt, n=max(n, 9))[:n].to(cuda, torch.bfloat16)
    _quantize_vs_plain(xb, fmt, plan)


# (b, t, kvh, hd, s, pos): Llama-3-8B's heads at a decode step (ragged
# rows) and a 4 x 128 prefill, a short ragged write, head_dim 16 padded;
# two in the tile regime: one whose K/V boundary falls inside a tile
# (4848 blocks a tensor, tiles of 32), one of zero-padded blocks (hd 80)
KV_CASES = {
    "decode": (4, 1, 8, 128, 256, (255, 200, 17, 0)),
    "prefill": (4, 128, 8, 128, 256, None),
    "rows": (3, 5, 2, 64, 16, (11, 0, 7)),
    "padded_hd": (2, 3, 2, 16, 8, (5, 0)),
    "tile_kv_boundary": (4, 101, 3, 128, 160, (0, 59, 5, 27)),
    "tile_padded_hd": (4, 300, 4, 80, 320, (0, 10, 20, 5)),
}


def _kv_case(cuda, fmt, case, dtype, seed=0):
    b, t, kvh, hd, s, pos = KV_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(seed)
    k, v = (torch.randn((b, t, kvh, hd), generator=g, device=cuda) * sc
            for sc in (1.0, 3.0))
    k, v = k.to(dtype), v.to(dtype)
    nb = -(-hd // fmt.block_size)
    cache = {}
    for name in "kv":
        cache[f"{name}_packed"] = torch.randint(
            0, 256, (b, s, kvh, nb, fmt.bytes_per_block), generator=g,
            device=cuda, dtype=torch.uint8)
        cache[f"{name}_meta"] = torch.randint(
            0, 1 << 15, (b, s, kvh, nb), generator=g, device=cuda,
            dtype=torch.int32).to(torch.uint16)
    pos_t = (None if pos is None
             else torch.tensor(pos, dtype=torch.int32, device=cuda))
    return k, v, cache, pos_t


@pytest.mark.parametrize("fname", ["nxfp4", "nxfp4_bs16", "mxfp6", "nxfp8"])
@pytest.mark.parametrize("case", sorted(KV_CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kv_rows_kernel_matches_plain(cuda, fname, case, dtype):
    """One launch encodes K and V into the cache rows pos[b] + t (rows 0..T
    at prefill): the cache equals the plain version's (codec, then row
    writes) everywhere, the untouched rows included, up to counted
    near-ties."""
    fmt = get_format(fname)
    k, v, cache, pos = _kv_case(cuda, fmt, case, getattr(torch, dtype))
    plain = {n: a.clone() for n, a in cache.items()}
    before = nq.LAUNCHES
    nq.nxfp_quantize_kv_rows(k, v, cache, pos, fmt)
    assert nq.LAUNCHES == before + 1
    nq.nxfp_quantize_kv_rows_plain(k, v, plain, pos, fmt)
    b, t, kvh, hd, s, _ = KV_CASES[case]
    rows = (torch.arange(t, device=cuda)[None, :] if pos is None
            else pos[:, None] + torch.arange(t, device=cuda))
    slots = torch.arange(b, device=cuda)[:, None]
    for name, x in (("k", k), ("v", v)):
        src = torch.zeros((b, s, kvh, hd), device=cuda)
        src[slots, rows] = x.float()
        xb, _ = to_blocks(src, fmt.block_size, -1)
        diff = ((cache[f"{name}_packed"] != plain[f"{name}_packed"]).any(-1)
                | (cache[f"{name}_meta"].to(torch.int32)
                   != plain[f"{name}_meta"].to(torch.int32)))
        if diff.any():
            assert near_tie_blocks(xb[diff], fmt).all(), int(diff.sum())


def test_kv_rows_kernel_skips_rows_past_the_cache(cuda):
    """A row outside [0, S) is not written: pos at and past S leaves the
    cache as it was."""
    fmt = get_format("nxfp4")
    k, v, cache, _ = _kv_case(cuda, fmt, "rows", torch.bfloat16)
    before = {n: a.clone() for n, a in cache.items()}
    pos = torch.tensor([16, 40, 1 << 20], dtype=torch.int32, device=cuda)
    nq.nxfp_quantize_kv_rows(k, v, cache, pos, fmt)
    torch.cuda.synchronize()
    assert all(torch.equal(before[n], cache[n]) for n in cache)


def _matmul_case(cuda, fname, m, k, n, seed):
    fmt = get_format(fname)
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn((k, n), generator=g, device=cuda)
    wq = quantize_qtensor(w, fmt, axis=-2, device=cuda)
    x = torch.randn((m, k), generator=g, device=cuda)
    return fmt, x, wq


def _assert_matmul_close(x, wq, fmt, y):
    yp = nm.nxfp_matmul_plain(x, wq.packed, wq.meta, fmt)
    wd = nm.dequant_weight_bf16(wq.packed, wq.meta, fmt).float()
    mag = x.to(torch.bfloat16).float().abs() @ wd.abs().T
    assert y.shape == yp.shape and torch.isfinite(y).all()
    assert ((y - yp).abs() <= 1e-5 * mag + 1e-30).all()


@pytest.mark.parametrize("fname", ["nxfp4", "nxfp4_nm_am", "mxfp4_cr",
                                   "nxfp5", "nxfp6", "nxfp8", "nxfp4_bs16",
                                   "nxfp5_bs16", "nxfp6_bs16", "mxfp4_ox",
                                   "amxfp4_ox"])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 37, 130])
def test_matmul_kernel_matches_plain(cuda, fname, m):
    """Ragged M, N and K (K not a multiple of the 64-wide prefill K step,
    nor of a 4-block split); M 16 and 17 on both sides of the regime
    switch. Both sum exact bf16 products in f32 in another order: 1e-5 of
    sum|x||w|."""
    fmt, x, wq = _matmul_case(cuda, fname, m, 320, 200, m)
    _assert_matmul_close(x, wq, fmt, nm.nxfp_matmul(x, wq.packed, wq.meta,
                                                    fmt))


@pytest.mark.parametrize("fname", ["nxfp4", "nxfp4_bs16", "nxfp5"])
def test_matmul_kernel_ragged_split_k(cuda, fname):
    """K 4160 (130 blocks of 32) splits into chunks of 8 blocks with a last
    split of 2; N 72 leaves a ragged N tile."""
    fmt, x, wq = _matmul_case(cuda, fname, 4, 4160, 72, 7)
    # the geometry test_torch_kernels.py plans with on the CPU
    assert tuple(nm.decode_geometry()) == (16, 64, 65536)
    _, splits, chunk = nm.decode_split(4, 72, wq.packed.shape[1],
                                       fmt.block_size, nm.decode_geometry())
    assert splits > 1 and (splits - 1) * chunk < wq.packed.shape[1]
    _assert_matmul_close(x, wq, fmt, nm.nxfp_matmul(x, wq.packed, wq.meta,
                                                    fmt))


@pytest.mark.parametrize("fname", ["nxfp4", "nxfp4_bs16", "nxfp4_bs64"])
def test_matmul_decode_row_independent_of_m(cuda, fname):
    """A Llama-3-8B ``w2``-shaped product (K 14336, N 4096): row 0 of an
    M-row call is the M-1 call's row, bit for bit, at every M up to 16
    (one split plan for all of them: a 16-slot engine's row, or a row of
    the speculative verify's 16-row groups, is the request served
    alone)."""
    fmt, x, wq = _matmul_case(cuda, fname, 16, 14336, 4096, 13)
    ref = nm.nxfp_matmul(x[:1], wq.packed, wq.meta, fmt)
    for m in (2, 4, 9, 10, 12, 15, 16):
        got = nm.nxfp_matmul(x[:m], wq.packed, wq.meta, fmt)
        assert torch.equal(got[:1], ref), m


@pytest.mark.parametrize("arch,kv", [("llama3_8b", "nxfp4"),
                                     ("llama3_8b", None),
                                     ("hymba_1_5b", "nxfp4")])
def test_verify_step_matches_sequential_decode_on_card(cuda, arch, kv):
    """The speculative verify on the card (B 4, Q 5: 20 rows, two row
    groups): logits bitwise 5 sequential ``decode_step`` calls, and a
    commit of 3 rows leaves their cache tree."""
    from repro_torch.models import commit_verify, verify_step
    from repro_torch.serving.engine import load_params
    cfg = get_smoke_config(arch)
    params = load_params(init_params(cfg, seed=0, device=cuda),
                         QuantPolicy("nxfp4", kv), cuda)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)), device=cuda)
    cands = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 5)),
                            dtype=torch.int32, device=cuda)
    _, cache = prefill(cfg, params, {"tokens": toks}, 96, kv)

    def clone(c):
        return {"pos": c["pos"].clone(),
                "layers": [{k: v.clone() for k, v in lc.items()}
                           for lc in c["layers"]]}

    seq, logits = clone(cache), []
    for i in range(5):
        lg, seq = decode_step(cfg, params, cands[:, i:i + 1], seq, kv)
        logits.append(lg)
        if i == 2:
            after3 = clone(seq)
    vlogits, pending = verify_step(cfg, params, cands, cache, kv)
    assert torch.equal(vlogits, torch.stack(logits, 1))
    got = commit_verify(cfg, cache, pending,
                        torch.full((4,), 3, device=cuda), kv)
    assert torch.equal(got["pos"], after3["pos"])
    for a, b in zip(got["layers"], after3["layers"]):
        for name in a:
            assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("m", [4, 16, 512])
def test_matmul_kernel_bitwise_repeatable(cuda, m):
    """Repeated launches on the same inputs give the same bits: the
    split-K partials are summed in split order by the last CTA of each
    tile, never by atomics on y, and the tile counters the first launch
    leaves behind (all 0) serve every later one."""
    fmt, x, wq = _matmul_case(cuda, "nxfp4", m, 4096, 1024, 11)
    first = nm.nxfp_matmul(x, wq.packed, wq.meta, fmt)
    for _ in range(5):
        again = nm.nxfp_matmul(x, wq.packed, wq.meta, fmt)
        assert torch.equal(first, again)
    _assert_matmul_close(x, wq, fmt, first)
    if m <= nm.decode_geometry().max_m:
        key = (x.device, torch.cuda.current_stream(x.device).cuda_stream)
        assert int(nm._scratch[key][1].abs().sum()) == 0


def test_matmul_kernel_split_k_per_stream(cuda):
    """Launches on two streams each use their own split-K buffers: the
    results are the bits of the default stream's, and every stream's tile
    counters are back at 0."""
    fmt, x, wq = _matmul_case(cuda, "nxfp4", 4, 4096, 1024, 13)
    first = nm.nxfp_matmul(x, wq.packed, wq.meta, fmt)
    side = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize(cuda)
    outs = []
    for st in side:
        with torch.cuda.stream(st):
            outs += [nm.nxfp_matmul(x, wq.packed, wq.meta, fmt)
                     for _ in range(3)]
    torch.cuda.synchronize(cuda)
    assert all(torch.equal(first, y) for y in outs)
    for st in side:
        assert int(nm._scratch[(x.device, st.cuda_stream)][1].abs().sum()) == 0


@pytest.mark.parametrize("fname", ["nxfp4", "nxfp6", "nxfp8", "nxfp4_nm_am",
                                   "mxfp4_ox", "amxfp4"])
@pytest.mark.parametrize("hd", [32, 128])
def test_attention_kernel_matches_plain(cuda, fname, hd):
    """Ragged lengths across and inside S tiles; f32 online softmax vs the
    one-pass plain version: 1e-5 of max|V|."""
    fmt = get_format(fname)
    g = torch.Generator(device=cuda).manual_seed(hd)
    b, kvh, grp, s = 3, 2, 4, 100
    k = torch.randn((b, s, kvh, hd), generator=g, device=cuda)
    v = torch.randn((b, s, kvh, hd), generator=g, device=cuda)
    kq = quantize_qtensor(k, fmt, axis=-1, device=cuda)
    vq = quantize_qtensor(v, fmt, axis=-1, device=cuda)
    q = torch.randn((b, kvh, grp, hd), generator=g, device=cuda) * hd ** -0.5
    lengths = torch.tensor([100, 33, 1], dtype=torch.int32, device=cuda)
    args = (q, kq.packed, kq.meta, vq.packed, vq.meta, lengths, fmt)
    out = na.nxfp_decode_attention(*args)
    ref = na.nxfp_decode_attention_plain(*args)
    vmax = float(na.dequant_cache(vq.packed, vq.meta, fmt).abs().max())
    assert float((out - ref).abs().max()) <= 1e-5 * vmax


def _attention_case(cuda, fname, lens, s, seed=0, kvh=8, grp=4, hd=128):
    fmt = get_format(fname)
    g = torch.Generator(device=cuda).manual_seed(seed)
    b = len(lens)
    k = torch.randn((b, s, kvh, hd), generator=g, device=cuda)
    v = torch.randn((b, s, kvh, hd), generator=g, device=cuda)
    kq = quantize_qtensor(k, fmt, axis=-1, device=cuda)
    vq = quantize_qtensor(v, fmt, axis=-1, device=cuda)
    q = torch.randn((b, kvh, grp, hd), generator=g, device=cuda) * hd ** -0.5
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return (q, kq.packed, kq.meta, vq.packed, vq.meta, lengths, fmt)


@pytest.mark.parametrize("fname", ["nxfp4", "amxfp4", "mxfp4_ox"])
@pytest.mark.parametrize("s,lens", [(100, (100, 0, 33, 64)),
                                    (4096, (4096, 3001, 1024, 17))])
def test_attention_kernel_split_edges(cuda, fname, s, lens):
    """Split-S at its edges: S 100 (a ragged last tile, four splits of one
    tile, some wholly past a length), a length-0 row (its output is 0),
    and a 4096-row cache (32 splits of 4 tiles); 1e-5 of max|V|."""
    args = _attention_case(cuda, fname, lens, s, seed=s)
    out = na.nxfp_decode_attention(*args)
    ref = na.nxfp_decode_attention_plain(*args)
    vmax = float(na.dequant_cache(args[3], args[4], args[6]).abs().max())
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert na.attention_split(8, s, n_sm)[0] > 1
    assert float((out - ref).abs().max()) <= 1e-5 * vmax
    for i, n in enumerate(lens):
        if n == 0:
            assert not out[i].any()


def test_attention_kernel_bitwise_repeatable_per_stream(cuda):
    """The split partials are merged in split order by the last CTA of
    each (batch, KV head), never by atomics on the output: a second launch
    and launches on two side streams (each with its own scratch) give the
    same bits, and every stream's counters are back at 0."""
    args = _attention_case(cuda, "nxfp4", (256, 200, 131, 17), 256, seed=3)
    first = na.nxfp_decode_attention(*args)
    outs = [na.nxfp_decode_attention(*args) for _ in range(3)]
    side = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize(cuda)
    for st in side:
        with torch.cuda.stream(st):
            outs += [na.nxfp_decode_attention(*args) for _ in range(3)]
    torch.cuda.synchronize(cuda)
    assert all(torch.equal(first, y) for y in outs)
    streams = [torch.cuda.current_stream(cuda).cuda_stream] + [
        st.cuda_stream for st in side]
    for handle in streams:
        assert int(na._scratch[(args[0].device, handle)][1].abs().sum()) == 0


def _qq_case(cuda, xf, wf, m, k=320, n=200):
    x_fmt, w_fmt = get_format(xf), get_format(wf)
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn((k, n), generator=g, device=cuda) * 0.05
    xq = quantize_qtensor(x, x_fmt, axis=-1, device=cuda)
    wq = quantize_qtensor(w, w_fmt, axis=-2, device=cuda)
    return (xq.packed, xq.meta, wq.packed, wq.meta, x_fmt, w_fmt)


@pytest.mark.parametrize("xf,wf", QQ_PAIRS)
@pytest.mark.parametrize("m", [1, 17, 512])
def test_qq_kernel_matches_plain(cuda, xf, wf, m):
    """Ragged M, N and K (10 blocks: not a multiple of the prefill
    regime's 64-wide K step); both operands decoded to bf16 and summed in
    f32 in another order than the plain matmul: 1e-5 of sum|x||w|."""
    args = _qq_case(cuda, xf, wf, m)
    y = nqq.nxfp_qq_matmul(*args)
    yp = nqq.nxfp_qq_matmul_plain(*args)
    xd = nm.dequant_weight_bf16(args[0], args[1], args[4]).float()
    wd = nm.dequant_weight_bf16(args[2], args[3], args[5]).float()
    assert y.shape == (m, 200) and torch.isfinite(y).all()
    assert ((y - yp).abs() <= 1e-5 * (xd.abs() @ wd.abs().T) + 1e-30).all()


@pytest.mark.parametrize("xf,wf", QQ_PAIRS)
@pytest.mark.parametrize("m", [1, 17, 512])
def test_qq_kernel_bits_of_dequant_gemm(cuda, xf, wf, m):
    """The qq GEMM decodes X once and runs the dequant GEMM's regime on
    it (split-K streaming at M 1, wgmma at 17 and 512): its output is the
    bits of ``nxfp_matmul`` fed the plain-decoded X, and a second launch
    gives the same bits."""
    args = _qq_case(cuda, xf, wf, m)
    y = nqq.nxfp_qq_matmul(*args)
    assert torch.equal(y, nqq.nxfp_qq_matmul(*args))
    xd = nm.dequant_weight_bf16(args[0], args[1], args[4])
    assert torch.equal(y, nm.nxfp_matmul(xd, args[2], args[3], args[5]))


def test_smoke_act_prefill_on_card_matches_cpu(cuda):
    """The smoke Llama's qq prefill (amxfp4 activations, nxfp4 weights and
    KV) through the kernels matches the plain CPU path: a GEMM summed in
    another order can move a bf16 activation by an ulp and that an
    activation code (3e-2 on logits of magnitude ~0.5)."""
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, seed=0, device="cpu")
    pol = QuantPolicy("nxfp4", "nxfp4")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab,
                                                              (2, 9)))
    out = {}
    for d in ("cpu", "cuda"):
        e = ServeEngine(cfg, params, pol, max_len=32, device=d)
        out[d] = prefill(cfg, e.params, {"tokens": toks.to(d)}, max_len=32,
                         kv_fmt="nxfp4", act_fmt="amxfp4")[0].cpu()
    assert torch.isfinite(out["cuda"]).all()
    assert float((out["cpu"] - out["cuda"]).abs().max()) <= 3e-2


def test_smoke_model_on_card_matches_cpu(cuda):
    """The smoke Llama (head_dim 16, padded to a 32-value KV block) through
    the kernels matches the plain CPU path, teacher-forced: one GEMM summed
    in another order can flip a bf16 rounding downstream (1e-2 on logits
    of magnitude ~0.5)."""
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, seed=0, device="cpu")
    pol = QuantPolicy("nxfp4", "nxfp4")
    engines = {d: ServeEngine(cfg, params, pol, max_len=32, device=d)
               for d in ("cpu", "cuda")}
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab,
                                                              (2, 9)))
    out = {d: prefill(cfg, e.params, {"tokens": toks.to(d)}, max_len=32,
                      kv_fmt="nxfp4") for d, e in engines.items()}
    for _ in range(4):
        lc, lg = out["cpu"][0], out["cuda"][0].cpu()
        assert float((lc - lg).abs().max()) <= 1e-2
        tok = torch.argmax(lc, dim=-1)
        for d, e in engines.items():
            out[d] = decode_step(cfg, e.params, tok.to(d)[:, None],
                                 out[d][1], "nxfp4")


def test_engine_loops_bitwise_on_card(cuda):
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, seed=1, device=cuda)
    eng = ServeEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                      max_len=32, device=cuda)
    batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab,
                                                         (3, 7))}
    host = eng.generate(batch, max_new=9, loop="host")
    for chunk in (1, 4, 9):
        dev = eng.generate(batch, max_new=9, loop="device", chunk=chunk)
        np.testing.assert_array_equal(dev.tokens, host.tokens)
        np.testing.assert_array_equal(dev.n_generated, host.n_generated)


# -- every format the reference serves: 2- to 8-bit codes, block sizes 8 to
# 128, custom recycle values (the generic kernel instances and the
# quantizer's table-driven kind)

WIDE_FMTS = ["nxfp3", "mxfp3", "bfp3", "nxfp3_bs8", "mxfp3_bs128",
             "nxfp4_bs8", "nxfp4_bs64", "nxfp4_bs128", "mxfp6_bs8",
             "nxfp6_bs64", "nxfp8_bs128", "mxfp8_bs8", "bfp5_bs64",
             "nxfp5_bs128", "bfp2", "bfp7_bs16", "bfp7_bs64"]
WIDE_ACT_FMTS = ["amxfp4_bs64", "amxfp4_bs8", "amxfp4_ox_bs8",
                 "mxfp4_ox_bs8", "amxfp3", "amxfp3_ox", "amxfp6_bs128"]
# (format, recycled value): Fig. 11's sweep points (benchmarks/
# fig11_remap_sweep.py: -smallest/2 and midpoints of positive levels) on
# the formats it sweeps, and on nxfp (two element formats) and other widths
RECYCLE = [("mxfp4_cr", 5.0), ("mxfp4_cr", 0.75), ("bfp4_cr", 1.5),
           ("bfp4_cr", -0.5), ("nxfp4", 0.75), ("nxfp3", 1.5),
           ("nxfp4_bs64", -0.25), ("mxfp8_cr", 0.0068359375),
           ("bfp7_cr_bs8", 2.5)]


def _wide_edge_blocks(fmt, n):
    """``_edge_blocks`` for any block size (its tied-max block puts the
    negative max at position bs - 1 when a block has fewer than 10)."""
    b = fmt.block_size
    if b > 9:
        return _edge_blocks(fmt, n=n)
    wide = _edge_blocks(dataclasses.replace(fmt, block_size=16), n=n)
    xb = wide[:, :b].clone()
    xb[8, b - 1] = -7.0
    return xb


def _recycled(base, value):
    return dataclasses.replace(get_format(base), recycle=float(value),
                               name=f"{base}@{value}")


def _tie_blocks(fmt, n=64):
    """Blocks whose scale comes out 1 (block max = the element's largest
    level, nano 0) holding every midpoint between two levels of the
    format, of both signs: exact ties for the snap."""
    from repro_torch.core.levels import level_table
    rows = []
    for _, el in fmt.elem_formats:
        t = level_table(el.name, fmt.cr, fmt.recycle)
        vals = np.concatenate([t.boundaries, -t.boundaries])
        for i in range(0, len(vals), fmt.block_size - 1):
            row = np.zeros(fmt.block_size, np.float32)
            row[0] = t.max_pos
            part = vals[i:i + fmt.block_size - 1]
            row[1:1 + len(part)] = part
            rows.append(row)
    xb = np.tile(np.stack(rows), (-(-n // len(rows)), 1))[:n]
    return torch.from_numpy(xb)


@pytest.mark.parametrize("fname", WIDE_FMTS + WIDE_ACT_FMTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", ["warp", "tile"])
def test_quantize_kernel_wide_formats_bitwise(cuda, fname, dtype, side):
    """3-bit (and 2/7-bit BFP) codes and block sizes 8 to 128, on both
    sides of the regime boundary: the kernel equals the plain codec, up to
    counted near-ties."""
    fmt = get_format(fname)
    n = nq.WARP_MAX_BLOCKS + (side == "tile")
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert nq.quantize_plan(n, fmt.block_size, n_sm).regime == side
    xb = _wide_edge_blocks(fmt, n).to(cuda, getattr(torch, dtype))
    print(f"{fname} {dtype} {side}: {_quantize_vs_plain(xb, fmt)} near ties")


@pytest.mark.parametrize("base,value", RECYCLE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", ["warp", "tile"])
def test_quantize_kernel_custom_recycle_bitwise(cuda, base, value, dtype,
                                                side):
    """A custom recycle value: the kernel equals the plain table-driven
    encoder (``core.quantize.quantize_blocks``, a value on a midpoint
    taking the lower level) bit for bit, exact ties included, up to
    counted candidate near-ties."""
    fmt = _recycled(base, value)
    n = nq.WARP_MAX_BLOCKS + (side == "tile")
    xb = torch.cat([_tie_blocks(fmt), _wide_edge_blocks(fmt, n - 64)])
    xb = xb.to(cuda, getattr(torch, dtype))
    print(f"{fmt.name} {dtype} {side}: {_quantize_vs_plain(xb, fmt)} near "
          "ties")
    ties = _tie_blocks(fmt).to(cuda, getattr(torch, dtype))
    kp, km = nq.nxfp_quantize_pack(ties, fmt)
    pp, pm = nq.nxfp_quantize_pack_plain(ties, fmt)
    assert torch.equal(kp, pp) and torch.equal(km, pm)


@pytest.mark.parametrize("fname", ["nxfp3", "nxfp4_bs64", "nxfp4_bs8",
                                   "mxfp6_bs128"])
@pytest.mark.parametrize("case", ["decode", "prefill", "rows"])
def test_kv_rows_kernel_wide_formats(cuda, fname, case):
    """The fused K/V cache write at 3 bits and block sizes 8 to 128 (head
    dims padded to the block): bitwise against the codec + row writes, up
    to counted near-ties."""
    fmt = get_format(fname)
    k, v, cache, pos = _kv_case(cuda, fmt, case, torch.bfloat16)
    plain = {n: a.clone() for n, a in cache.items()}
    nq.nxfp_quantize_kv_rows(k, v, cache, pos, fmt)
    nq.nxfp_quantize_kv_rows_plain(k, v, plain, pos, fmt)
    b, t, kvh, hd, s, _ = KV_CASES[case]
    rows = (torch.arange(t, device=cuda)[None, :] if pos is None
            else pos[:, None] + torch.arange(t, device=cuda))
    slots = torch.arange(b, device=cuda)[:, None]
    for name, x in (("k", k), ("v", v)):
        src = torch.zeros((b, s, kvh, hd), device=cuda)
        src[slots, rows] = x.float()
        xb, _ = to_blocks(src, fmt.block_size, -1)
        diff = ((cache[f"{name}_packed"] != plain[f"{name}_packed"]).any(-1)
                | (cache[f"{name}_meta"].to(torch.int32)
                   != plain[f"{name}_meta"].to(torch.int32)))
        if diff.any():
            assert near_tie_blocks(xb[diff], fmt).all(), int(diff.sum())


WIDE_GEMM_FMTS = ["nxfp3", "mxfp3", "bfp3_bs16", "nxfp4_bs8", "nxfp4_bs64",
                  "nxfp4_bs128", "nxfp6_bs8", "nxfp8_bs64", "bfp7_bs8",
                  "amxfp4_ox_bs8", "amxfp4_bs128"]


@pytest.mark.parametrize("fname", WIDE_GEMM_FMTS)
@pytest.mark.parametrize("m", [1, 4, 16, 17, 130])
@pytest.mark.parametrize("k", [320, 200])
def test_matmul_kernel_wide_formats(cuda, fname, m, k):
    """The generic instances (a row read as one long block in 32-code
    units) at both regimes; K 200 leaves a bs-8 row short of a whole unit
    (the wrapper pads it with zero blocks): 1e-5 of sum|x||w|, and a
    second launch gives the same bits."""
    fmt, x, wq = _matmul_case(cuda, fname, m, k, 72, m + k)
    # the cast pads K to whole blocks; the caller pads x to match
    x = torch.nn.functional.pad(
        x, (0, wq.packed.shape[1] * fmt.block_size - k))
    y = nm.nxfp_matmul(x, wq.packed, wq.meta, fmt)
    assert torch.equal(y, nm.nxfp_matmul(x, wq.packed, wq.meta, fmt))
    _assert_matmul_close(x, wq, fmt, y)


def test_matmul_kernel_custom_recycle(cuda):
    """The decoders read the recycled value from the format: a weight cast
    with a custom value decodes to the plain level-table values."""
    fmt = _recycled("nxfp4", 0.75)
    g = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn((256, 96), generator=g, device=cuda)
    wq = quantize_qtensor(w, fmt, axis=-2, device=cuda)
    x = torch.randn((16, 256), generator=g, device=cuda)
    for m in (4, 16):
        _assert_matmul_close(x[:m], wq, fmt,
                             nm.nxfp_matmul(x[:m], wq.packed, wq.meta, fmt))


@pytest.mark.parametrize("fname", ["nxfp3", "mxfp3", "nxfp4_bs8",
                                   "nxfp4_bs64", "nxfp4_bs128", "nxfp6_bs8",
                                   "amxfp4_ox_bs8", "amxfp4_bs64", "bfp7"])
@pytest.mark.parametrize("hd", [64, 128])
def test_attention_kernel_wide_formats(cuda, fname, hd):
    """The generic instance (each row one long block, 8 codes at a time)
    with ragged lengths and splits: 1e-5 of max|V|, and a second launch
    gives the same bits."""
    args = _attention_case(cuda, fname, (100, 0, 33, 64), 100, seed=hd,
                           kvh=2, hd=hd)
    # the cast pads head_dim to whole blocks; the caller pads q to match
    d_pad = args[1].shape[-2] * args[6].block_size
    args = (torch.nn.functional.pad(args[0], (0, d_pad - hd)),) + args[1:]
    out = na.nxfp_decode_attention(*args)
    assert torch.equal(out, na.nxfp_decode_attention(*args))
    ref = na.nxfp_decode_attention_plain(*args)
    vmax = float(na.dequant_cache(args[3], args[4], args[6]).abs().max())
    assert float((out - ref).abs().max()) <= 1e-5 * vmax
    assert not out[1].any()


def test_attention_kernel_custom_recycle(cuda):
    fmt = _recycled("nxfp4", 0.75)
    g = torch.Generator(device=cuda).manual_seed(9)
    b, s, kvh, grp, hd = 2, 70, 2, 4, 128
    kq, vq = (quantize_qtensor(torch.randn((b, s, kvh, hd), generator=g,
                                           device=cuda), fmt, axis=-1,
                               device=cuda) for _ in range(2))
    q = torch.randn((b, kvh, grp, hd), generator=g, device=cuda) * hd ** -0.5
    lengths = torch.tensor([70, 41], dtype=torch.int32, device=cuda)
    args = (q, kq.packed, kq.meta, vq.packed, vq.meta, lengths, fmt)
    out = na.nxfp_decode_attention(*args)
    ref = na.nxfp_decode_attention_plain(*args)
    vmax = float(na.dequant_cache(vq.packed, vq.meta, fmt).abs().max())
    assert float((out - ref).abs().max()) <= 1e-5 * vmax


WIDE_QQ_PAIRS = [("amxfp3", "nxfp3"), ("amxfp4_bs64", "nxfp4_bs64"),
                 ("amxfp4_ox_bs8", "nxfp4_bs8"), ("mxfp4_bs128",
                                                  "nxfp4_bs128"),
                 ("amxfp3_ox", "nxfp4"), ("amxfp4", "nxfp3"),
                 ("nxfp4_bs16", "bfp3_bs16")]


@pytest.mark.parametrize("xf,wf", WIDE_QQ_PAIRS)
@pytest.mark.parametrize("m", [1, 17, 512])
@pytest.mark.parametrize("k", [320, 200])
def test_qq_kernel_wide_formats(cuda, xf, wf, m, k):
    """The generic X decode (8 codes a thread) and the generic GEMM: the
    bits of ``nxfp_matmul`` on the plain-decoded X, a second launch the
    same bits, and 1e-5 of sum|x||w| against the plain version."""
    args = _qq_case(cuda, xf, wf, m, k=k, n=72)
    y = nqq.nxfp_qq_matmul(*args)
    assert torch.equal(y, nqq.nxfp_qq_matmul(*args))
    xd = nm.dequant_weight_bf16(args[0], args[1], args[4])
    assert torch.equal(y, nm.nxfp_matmul(xd, args[2], args[3], args[5]))
    yp = nqq.nxfp_qq_matmul_plain(*args)
    wd = nm.dequant_weight_bf16(args[2], args[3], args[5]).float()
    assert ((y - yp).abs() <= 1e-5 * (xd.float().abs() @ wd.abs().T)
            + 1e-30).all()


# -- the device loop as one CUDA graph per chunk

def _graph_engine(cuda, kv="nxfp4", weight="nxfp4", seed=0):
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, seed=1, device=cuda)
    return cfg, ServeEngine(cfg, params, QuantPolicy(weight, kv), max_len=32,
                            rng_seed=seed, device=cuda)


def _graph_loop(eng, b):
    from repro_torch.serving import engine as engine_mod
    return [p for k, p in engine_mod._PROGRAM_CACHE.items()
            if k[0] == eng._uid and k[1] == b][0]


@pytest.mark.parametrize("kv,weight", [("nxfp4", "nxfp4"), (None, "nxfp4"),
                                       ("nxfp3", "nxfp3"),
                                       ("nxfp4_bs64", "nxfp4_bs64")])
def test_graph_loop_tokens_equal_host_loop(cuda, kv, weight):
    """Greedy: the captured chunk graphs (chunks of 1, 4 and 9 steps, a
    last chunk shorter than the rest) give the host loop's tokens bit for
    bit, and the loop ran as graph replays."""
    cfg, eng = _graph_engine(cuda, kv, weight)
    batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab,
                                                         (3, 7))}
    host = eng.generate(batch, max_new=9, loop="host")
    for chunk in (1, 4, 9):
        dev = eng.generate(batch, max_new=9, loop="device", chunk=chunk)
        np.testing.assert_array_equal(dev.tokens, host.tokens)
        np.testing.assert_array_equal(dev.n_generated, host.n_generated)
    prog = _graph_loop(eng, 3)
    assert set(prog.graphs) == {(1, True), (4, True), (9, True)}
    assert prog.replays == 9 + 3 + 1


def test_graph_replays_give_the_same_bits(cuda):
    """Two replays of one graph from the same inputs give the same bits:
    the split kernels' counters are back at 0 after each replay and their
    scratch is the capture stream's."""
    cfg, eng = _graph_engine(cuda)
    batch = {"tokens": np.random.default_rng(2).integers(0, cfg.vocab,
                                                         (4, 5))}
    runs = [eng.generate(batch, max_new=8, loop="device", chunk=8)
            for _ in range(3)]
    for r in runs[1:]:
        np.testing.assert_array_equal(r.tokens, runs[0].tokens)
    prog = _graph_loop(eng, 4)
    assert prog.replays == 3 and len(prog.graphs) == 1
    from repro_torch.kernels import nxfp_attention as na_mod
    for scratch in (nm._scratch, na_mod._scratch):
        for _, counters in scratch.values():
            assert int(counters.abs().sum()) == 0


def test_sampled_graph_stream_equals_eager_loops(cuda):
    """Sampled: the graph replays draw through the generator registered
    with them, so for one seed the graph loop's stream equals the host
    loop's and the eager device loop's (``decode_loop`` called directly)
    bit for bit."""
    from repro_torch.models import decode_loop
    cfg, eng = _graph_engine(cuda, seed=11)
    batch = {"tokens": np.random.default_rng(3).integers(0, cfg.vocab,
                                                         (3, 6))}
    temp = np.array([0.7, 1.0, 0.0], np.float32)
    dev = eng.generate(batch, max_new=10, temperature=temp, loop="device",
                       chunk=4)
    host = _graph_engine(cuda, seed=11)[1].generate(
        batch, max_new=10, temperature=temp, loop="host")
    np.testing.assert_array_equal(dev.tokens, host.tokens)
    _, eager_eng = _graph_engine(cuda, seed=11)
    t = torch.as_tensor(temp, device=cuda)
    logits, cache = prefill(cfg, eager_eng.params,
                            {"tokens": torch.as_tensor(batch["tokens"],
                                                       device=cuda)},
                            max_len=32, kv_fmt="nxfp4")

    def sample(lg):
        return eager_eng._sample(lg, t, False).to(torch.int32)

    toks, _, _ = decode_loop(cfg, eager_eng.params, sample(logits), cache,
                             10, "nxfp4", sample)
    np.testing.assert_array_equal(dev.tokens, toks.cpu().numpy())


def test_graph_loop_sync_key_after_early_stop(cuda):
    """After a sampled call that stops mid-chunk, the next sampled call
    gives the same tokens whichever loop ran the first."""
    cfg, probe_eng = _graph_engine(cuda, seed=5)
    batch = {"tokens": np.random.default_rng(4).integers(0, cfg.vocab,
                                                         (3, 6))}
    probe = probe_eng.generate(batch, max_new=10, temperature=0.9,
                               loop="host")
    stop = np.array([row[2] for row in probe.tokens], np.int64)
    second = {}
    for loop in ("host", "device"):
        eng = _graph_engine(cuda, seed=5)[1]
        eng.generate(batch, max_new=10, temperature=0.9, stop_token=stop,
                     loop=loop, chunk=4)
        second[loop] = eng.generate(batch, max_new=6, temperature=0.9,
                                    loop=loop, chunk=4).tokens
    np.testing.assert_array_equal(second["host"], second["device"])


# ---------------------------------------------------------------------------
# continuous batching on the card
# ---------------------------------------------------------------------------

def _continuous_case(cuda, width):
    """(cfg, params) for the smoke Llama or a 2-layer Llama-3-8B at full
    width, random weights from seed 1."""
    from repro_torch.configs import get_config
    cfg = get_smoke_config("llama3_8b") if width == "smoke" else \
        dataclasses.replace(get_config("llama3_8b"), n_layers=2)
    return cfg, init_params(cfg, seed=1, device=cuda)


def _solo_on_card(cfg, params, policy, req, max_len):
    eng = ServeEngine(cfg, params, policy, max_len=max_len,
                      rng_seed=req.seed, device="cuda")
    out = eng.generate({"tokens": req.tokens[None]}, max_new=req.max_new,
                       temperature=req.temperature,
                       stop_token=req.stop_token, loop="host")
    return out.tokens[0, :int(out.n_generated[0])]


@pytest.mark.parametrize("width", ["smoke", "llama3_8b"])
def test_continuous_matches_solo_on_card(cuda, width):
    """Continuous serving through the chunk graph (2 slots, chunk 4, nxfp4
    weights and KV) against each request's solo host-loop stream, bit for
    bit: greedy and seeded-sampled, a stop token, staggered arrivals."""
    from repro_torch.serving import ContinuousEngine, Request
    cfg, params = _continuous_case(cuda, width)
    policy = QuantPolicy("nxfp4", "nxfp4")
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m, temperature=temp, seed=seed,
                    arrival_time=0.0 if i < 2 else 0.02 * i)
            for i, (t, m, temp, seed) in enumerate(
                [(9, 6, 0.0, 0), (17, 11, 0.9, 3), (5, 3, 0.0, 0),
                 (12, 9, 1.2, 7), (7, 13, 0.0, 0)])]
    stop = int(_solo_on_card(cfg, params, policy, reqs[4], 64)[5])
    reqs[4] = dataclasses.replace(reqs[4], stop_token=stop)
    eng = ContinuousEngine(cfg, params, policy, n_slots=2, max_len=64,
                           chunk=4, device=cuda)
    replays = 0
    for _ in range(2):                  # the second serve replays only
        results = {r.uid: r for r in eng.serve(reqs)}
        for req in reqs:
            want = _solo_on_card(cfg, params, policy, req, 64)
            np.testing.assert_array_equal(results[req.uid].tokens, want,
                                          err_msg=f"uid={req.uid}")
        assert eng.replays == replays + eng.chunks
        replays = eng.replays
    assert results[4].tokens[-1] == stop
    assert set(eng._graphs) == {True, False}


def test_continuous_sampled_slot_reuse_through_graph(cuda):
    """One slot, three sampled requests in turn: each is admitted into the
    slot the one before used, its generator re-seeded, and the captured
    sampled graph (registered with that generator) reproduces its solo
    stream bit for bit."""
    from repro_torch.serving import ContinuousEngine, Request
    cfg, params = _continuous_case(cuda, "smoke")
    policy = QuantPolicy("nxfp4", "nxfp4")
    rng = np.random.default_rng(6)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (8,)),
                    max_new=10, temperature=0.8 + 0.2 * i, seed=11 + i)
            for i in range(3)]
    eng = ContinuousEngine(cfg, params, policy, n_slots=1, max_len=32,
                           chunk=4, device=cuda)
    results = {r.uid: r for r in eng.serve(reqs)}
    for req in reqs:
        np.testing.assert_array_equal(
            results[req.uid].tokens,
            _solo_on_card(cfg, params, policy, req, 32))
    assert set(eng._graphs) == {False} and eng.replays == eng.chunks == 9


def test_continuous_graph_replays_per_serve(cuda):
    """Every chunk of a serve is one graph replay, the graphs are captured
    once per engine, and the chunk launches the three main-path kernels."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ContinuousEngine, Request
    cfg, params = _continuous_case(cuda, "smoke")
    eng = ContinuousEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                           n_slots=3, max_len=48, chunk=5, device=cuda)
    rng = np.random.default_rng(7)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (6,)),
                    max_new=int(m)) for i, m in enumerate([4, 12, 7, 9])]
    reset_launch_counts()
    first = eng.serve(reqs)
    counts = launch_counts()
    replays = eng.replays
    assert replays == eng.chunks > 0
    for name in ("nxfp_quantize", "nxfp_matmul", "nxfp_attention"):
        assert counts[name] > 0, name
    second = eng.serve(reqs)
    assert eng.replays == replays + eng.chunks and len(eng._graphs) == 1
    for a, b in zip(sorted(first, key=lambda r: r.uid),
                    sorted(second, key=lambda r: r.uid)):
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("width", ["smoke", "llama3_8b"])
def test_decode_step_batch_invariant_on_card(cuda, width):
    """Row 0 of a decode step at B 4 and 8 (nxfp4 weights and KV, ragged
    lengths, lm_head included) equals the same row at B 1, bit for bit:
    the split plans of the GEMM and of attention do not depend on the
    batch."""
    cfg, params = _continuous_case(cuda, width)
    eng = ServeEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                      max_len=512, device=cuda)
    rng = np.random.default_rng(8)
    rows = []
    for t in (200, 37, 98, 159, 220, 281, 342, 403):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, t)),
                               device=cuda)
        logits, cache = prefill(cfg, eng.params, {"tokens": toks},
                                max_len=512, kv_fmt="nxfp4")
        rows.append((logits.argmax(-1).to(torch.int32), cache))

    def step(b):
        cache = {"pos": torch.cat([c["pos"] for _, c in rows[:b]]),
                 "layers": [{k: torch.cat([c["layers"][i][k]
                                           for _, c in rows[:b]])
                             for k in rows[0][1]["layers"][i]}
                            for i in range(cfg.n_layers)]}
        tok = torch.cat([t for t, _ in rows[:b]])[:, None]
        return decode_step(cfg, eng.params, tok, cache, "nxfp4")[0][0]

    solo = step(1)
    for b in (4, 8):
        assert torch.equal(step(b), solo), b


# ---------------------------------------------------------------------------
# the chunked-prefill lane on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fname", ["nxfp4", "nxfp4_bs16", "mxfp6"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kv_rows_kernel_slot_and_n_valid(cuda, fname, dtype):
    """K/V rows of a batch row go to slot ``slot[b]`` at rows ``pos[b] + t``
    for t < ``n_valid[b]``: one launch, the cache equal to the plain
    version's everywhere (bitwise, up to counted near-ties), a slot out of
    range and n_valid 0 writing nothing, the untouched slots as they were."""
    fmt = get_format(fname)
    g = torch.Generator(device=cuda).manual_seed(3)
    b, t, kvh, hd, cb, s = 3, 7, 2, 64, 5, 16
    k, v = (torch.randn((b, t, kvh, hd), generator=g, device=cuda)
            .to(getattr(torch, dtype)) for _ in range(2))
    nb = -(-hd // fmt.block_size)
    cache = {}
    for name in "kv":
        cache[f"{name}_packed"] = torch.randint(
            0, 256, (cb, s, kvh, nb, fmt.bytes_per_block), generator=g,
            device=cuda, dtype=torch.uint8)
        cache[f"{name}_meta"] = torch.randint(
            0, 1 << 15, (cb, s, kvh, nb), generator=g, device=cuda,
            dtype=torch.int32).to(torch.uint16)
    i32 = dict(dtype=torch.int32, device=cuda)
    pos = torch.tensor([11, 0, 3], **i32)
    slot = torch.tensor([3, 1, cb], **i32)          # the last: no slot
    n_valid = torch.tensor([4, 7, 7], **i32)
    before = {n: a.clone() for n, a in cache.items()}
    plain = {n: a.clone() for n, a in cache.items()}
    launches = nq.LAUNCHES
    nq.nxfp_quantize_kv_rows(k, v, cache, pos, fmt, slot=slot,
                             n_valid=n_valid)
    assert nq.LAUNCHES == launches + 1
    nq.nxfp_quantize_kv_rows_plain(k, v, plain, pos, fmt, slot=slot,
                                   n_valid=n_valid)
    for name in "kv":
        diff = ((cache[f"{name}_packed"] != plain[f"{name}_packed"]).any(-1)
                | (cache[f"{name}_meta"] != plain[f"{name}_meta"]))
        assert not diff.any(), int(diff.sum())
    for sl in (0, 2, 4):
        assert all(torch.equal(cache[n][sl], before[n][sl]) for n in cache)
    assert all(torch.equal(cache[n][3, :11], before[n][3, :11])
               and torch.equal(cache[n][3, 15:], before[n][3, 15:])
               for n in cache)
    zero = torch.zeros((b,), **i32)
    nq.nxfp_quantize_kv_rows(k, v, cache, pos, fmt, slot=slot, n_valid=zero)
    assert all(torch.equal(cache[n], plain[n]) for n in cache)


@pytest.mark.parametrize("case", ["decode", "prefill", "rows"])
def test_kv_rows_kernel_old_call_unchanged(cuda, case):
    """Without slot and n_valid the kernel writes what it wrote before: the
    same bytes as slot b and every row kept, passed explicitly."""
    fmt = get_format("nxfp4")
    k, v, cache, pos = _kv_case(cuda, fmt, case, torch.bfloat16)
    other = {n: a.clone() for n, a in cache.items()}
    b, t = k.shape[:2]
    i32 = dict(dtype=torch.int32, device=cuda)
    nq.nxfp_quantize_kv_rows(k, v, cache, pos, fmt)
    nq.nxfp_quantize_kv_rows(k, v, other, pos, fmt,
                             slot=torch.arange(b, **i32),
                             n_valid=torch.full((b,), t, **i32))
    assert all(torch.equal(cache[n], other[n]) for n in cache)


def _lane_engine(cuda, width, p_chunk, max_len=128):
    from repro_torch.serving import ContinuousEngine
    cfg, params = _continuous_case(cuda, width)
    return ContinuousEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                            n_slots=2, max_len=max_len, chunk=4,
                            prefill_mode="chunked", p_chunk=p_chunk,
                            device=cuda)


@pytest.mark.parametrize("width", ["smoke", "llama3_8b"])
@pytest.mark.parametrize("p_chunk", [16, 32])
def test_lane_graph_replay_matches_eager_lane(cuda, width, p_chunk):
    """Every lane chunk replayed from its captured graph leaves the cache
    slot and the lane scratch with the bits the eager ``prefill_chunk``
    leaves on copies of them, and the final chunk's logits are the eager
    ones; with P > 16 and a prompt > 16 tokens they also equal the whole
    ``prefill``'s logits."""
    from repro_torch.models import prefill_chunk
    eng = _lane_engine(cuda, width, p_chunk)
    cfg, t = eng.cfg, 3 * p_chunk - 5
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (t,))
    cache = {"pos": eng.cache["pos"].clone(),
             "layers": [{n: a.clone() for n, a in lc.items()}
                        for lc in eng.cache["layers"]]}
    lane = {"layers": [{n: a.clone() for n, a in ll.items()}
                       for ll in eng.lane["layers"]]}
    for off in range(0, t, p_chunk):
        n = min(p_chunk, t - off)
        final = off + n >= t
        got = eng._lane_dispatch(1, toks[off:off + n], off, final)
        chunk = np.zeros((1, p_chunk), np.int64)
        chunk[0, :n] = toks[off:off + n]
        want, _, _ = prefill_chunk(cfg, eng.params,
                                   torch.as_tensor(chunk, device=cuda),
                                   cache, 1, off, n, lane, "nxfp4",
                                   with_head=final)
        assert torch.equal(got, want), off
    assert eng.lane_replays == -(-t // p_chunk)
    assert set(eng._lane_graphs) == {False, True}
    for mine, ref in zip(eng.cache["layers"] + eng.lane["layers"],
                         cache["layers"] + lane["layers"]):
        assert all(torch.equal(mine[n], ref[n]) for n in ref)
    whole, _ = prefill(cfg, eng.params,
                       {"tokens": torch.as_tensor(toks[None], device=cuda)},
                       max_len=128, kv_fmt="nxfp4")
    if p_chunk > 16:
        assert torch.equal(got, whole)


@pytest.mark.parametrize("width", ["smoke", "llama3_8b"])
def test_chunked_continuous_matches_solo_on_card(cuda, width):
    """The chunked lane (P 32, lane chunks as graph replays) admitting into
    live decode traffic: every stream equals its solo host-loop stream bit
    for bit, greedy and seeded-sampled with a stop token, on two serves
    (the first captures the graphs)."""
    from repro_torch.serving import Request
    eng = _lane_engine(cuda, width, 32)
    cfg, params = eng.cfg, eng.params
    policy = QuantPolicy(None, "nxfp4")        # the engine's cast weights
    rng = np.random.default_rng(10)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m, temperature=temp, seed=seed,
                    arrival_time=0.0 if i < 2 else 0.02 * i)
            for i, (t, m, temp, seed) in enumerate(
                [(40, 6, 0.0, 0), (75, 11, 0.9, 3), (17, 3, 0.0, 0),
                 (64, 9, 1.2, 7), (33, 13, 0.0, 0)])]
    stop = int(_solo_on_card(cfg, params, policy, reqs[4], 128)[5])
    reqs[4] = dataclasses.replace(reqs[4], stop_token=stop)
    lane_replays = 0
    for _ in range(2):
        results = {r.uid: r for r in eng.serve(reqs)}
        for req in reqs:
            want = _solo_on_card(cfg, params, policy, req, 128)
            np.testing.assert_array_equal(results[req.uid].tokens, want,
                                          err_msg=f"uid={req.uid}")
        assert eng.lane_replays == lane_replays + eng.lane_chunks > 0
        lane_replays = eng.lane_replays
    assert results[4].tokens[-1] == stop


# ---------------------------------------------------------------------------
# p_chunk="auto", serving tiers and the dense path on the card
# ---------------------------------------------------------------------------

def test_auto_p_chunk_on_card(cuda):
    """``p_chunk="auto"`` at 2 layers, full width: the sweep times every
    candidate as a graph replay, only the pick's lane graph is kept, and
    (the pick above 16, the GEMM's wgmma regime) the chunked streams are
    the solo streams bit for bit."""
    from repro_torch.serving import ContinuousEngine, Request
    cfg, params = _continuous_case(cuda, "llama3_8b")
    eng = ContinuousEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                           n_slots=2, max_len=128, chunk=4,
                           prefill_mode="chunked", p_chunk="auto",
                           device=cuda)
    assert sorted(eng.p_chunk_sweep) == [16, 32, 64, 128]
    assert eng.p_chunk in eng.p_chunk_sweep and eng.p_chunk_decode_s > 0
    assert set(eng._lane_graphs) == {False}
    assert eng._lane_tok.shape == (1, eng.p_chunk)
    rng = np.random.default_rng(12)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m, temperature=temp, seed=3)
            for i, (t, m, temp) in enumerate([(40, 6, 0.0), (75, 9, 0.9),
                                              (33, 5, 0.0)])]
    results = {r.uid: r for r in eng.serve(reqs)}
    policy = QuantPolicy(None, "nxfp4")
    for req in reqs:
        want = _solo_on_card(cfg, eng.params, policy, req, 128)
        if eng.p_chunk > 16:
            np.testing.assert_array_equal(results[req.uid].tokens, want)
    assert eng.lane_replays == eng.lane_chunks > 0


@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_tiered_serve_on_card(cuda, mode):
    """``TieredContinuousEngine(default_tiers())`` at 2 layers, full width,
    3 slots: standard and economy streams (greedy and sampled) equal their
    solo streams at their tier bit for bit, the economy prefill launches
    the qq GEMM (7 a layer per prefill, or per lane-graph warm-up and
    capture), every chunk is a graph replay, and the premium streams equal
    the plain dense engine's serving the same traffic (the reference's
    dense-rider guarantee)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import prefill as tprefill
    from repro_torch.serving import (ContinuousEngine, Request,
                                     TieredContinuousEngine, default_tiers)
    cfg, params = _continuous_case(cuda, "llama3_8b")
    tiers = default_tiers()
    kw = dict(n_slots=3, max_len=128, chunk=4, device=cuda)
    if mode == "chunked":
        kw.update(prefill_mode="chunked", p_chunk=32)
    eng = TieredContinuousEngine(cfg, params, tiers, **kw)
    rng = np.random.default_rng(13)
    names = ["premium", "standard", "economy", "economy", "standard",
             "premium"]
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m, temperature=0.9 if i in (3, 4) else 0.0,
                    seed=5 + i, tier=names[i])
            for i, (t, m) in enumerate([(40, 6), (75, 9), (33, 5), (50, 7),
                                        (61, 8), (36, 5)])]
    reset_launch_counts()
    results = {r.uid: r for r in eng.serve(reqs)}
    counts = launch_counts()
    econ = [k for k in getattr(eng, "_lane_graphs", ()) if k[2] is not None]
    want_qq = 7 * cfg.n_layers * (2 if mode == "whole" else 2 * len(econ))
    assert counts["nxfp_qq_matmul"] == want_qq > 0
    assert eng.replays == sum(eng.chunk_groups) and max(eng.chunk_groups) > 1
    assert eng.lane_replays == eng.lane_chunks

    class Solo(ServeEngine):
        act_fmt = None

        def _prefill(self, batch):
            toks = torch.as_tensor(np.asarray(batch["tokens"]),
                                   device=self.device)
            return tprefill(cfg, self.params, {"tokens": toks},
                            max_len=self.max_len, kv_fmt=self.policy.kv_fmt,
                            act_fmt=self.act_fmt)

    for req in reqs:
        spec = tiers[req.tier]
        if req.tier == "premium":
            continue
        solo = Solo(cfg, eng._wparams[spec.weight_fmt],
                    QuantPolicy(None, spec.kv_fmt), max_len=128,
                    rng_seed=req.seed, device=cuda)
        solo.act_fmt = spec.act_fmt
        out = solo.generate({"tokens": req.tokens[None]},
                            max_new=req.max_new,
                            temperature=req.temperature, loop="host")
        np.testing.assert_array_equal(
            results[req.uid].tokens,
            out.tokens[0, :int(out.n_generated[0])],
            err_msg=f"uid={req.uid} ({req.tier})")
    dense = ContinuousEngine(cfg, eng._wparams[None], QuantPolicy(None, None),
                             **kw)
    ref = {r.uid: r.tokens for r in dense.serve(
        [dataclasses.replace(r, tier=None) for r in reqs])}
    for req in reqs:
        if req.tier == "premium":
            np.testing.assert_array_equal(results[req.uid].tokens,
                                          ref[req.uid])


@pytest.mark.parametrize("width", ["smoke", "llama3_8b"])
def test_dense_path_rows_batch_invariant_on_card(cuda, width):
    """The premium tier's path (bf16 weights through cuBLAS, dense KV):
    row 0 of each row-spanning op at B 4 and 8 equals the same row at B
    1, bit for bit: the cuBLAS projections, ``lm_head``, dense decode
    attention (the attention kernel's dense-row instance, whose split
    plan follows S and the KV heads only), the norm and the softmax
    (``scripts/batch_invariance.py --dense``)."""
    import sys
    import pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "scripts"))
    import batch_invariance
    cfg = _continuous_case(cuda, width)[0]
    for op, by_b in batch_invariance.ops(cfg, None).items():
        if op == batch_invariance.PLAIN_MEAN:
            continue
        for b, r in by_b.items():
            assert r["differ"] == 0, (op, b, r)


# the dense family's head shapes (KV heads, G, head_dim): Llama-3-8B's,
# Llama-2-7B's (MHA: G 1), StarCoder2-3B's (G 12), H2O-Danube3-4B's (120)
FAMILY_HEADS = [(8, 4, 128), (32, 1, 128), (2, 12, 128), (8, 4, 120)]


@pytest.mark.parametrize("heads", FAMILY_HEADS,
                         ids=lambda h: "KVH{}-G{}-D{}".format(*h))
def test_dense_attention_kernel_vs_plain(cuda, heads):
    """The dense-row attention instance at S 512 (ragged lengths, one 0)
    within 1e-5 of max|V| of its plain version, bitwise on a second
    launch, and row 0's bits the same at B 1, 4 and 8."""
    from repro_torch.kernels import dense_attention as da
    kvh, g, d = heads
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, s = 8, 512
    k, v = (torch.randn((b, s, kvh, d), generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    q = torch.randn((b, kvh, g, d), generator=gen, device=cuda) * d ** -0.5
    lens = torch.tensor([300, 512, 17, 0, 1, 33, 480, 256], device=cuda,
                        dtype=torch.int32)
    out = da.dense_decode_attention(q, k, v, lens)
    assert torch.equal(out, da.dense_decode_attention(q, k, v, lens))
    ref = da.dense_decode_attention_plain(q, k, v, lens)
    ref[3] = 0.0                    # a length-0 row: the kernel gives 0
    err = float((out - ref).abs().max())
    assert err <= 1e-5 * float(v.float().abs().max()), err
    one = da.dense_decode_attention(q[:1], k[:1], v[:1], lens[:1])
    for bb in (4, 8):
        got = da.dense_decode_attention(q[:bb], k[:bb], v[:bb], lens[:bb])
        assert torch.equal(got[0], one[0]), bb


def test_dense_attention_refuses_shapes_it_does_not_take(cuda):
    from repro_torch.kernels import dense_attention as da
    k = torch.zeros((1, 64, 2, 100), dtype=torch.bfloat16, device=cuda)
    q = torch.zeros((1, 2, 2, 100), device=cuda)
    lens = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        da.dense_decode_attention(q, k, k, lens)
    with pytest.raises(ValueError, match="bf16"):
        da.dense_decode_attention(q[..., :96], k[..., :96].float(),
                                  k[..., :96].float(), lens)


# (K, N) pairs of the dense family's projections (Llama-2-7B, StarCoder2-3B
# and H2O-Danube3-4B) beside Llama-3-8B's wq/wo
FAMILY_KN = [(4096, 4096), (4096, 11008), (11008, 4096), (3072, 256),
             (12288, 3072), (3840, 960), (10240, 3840)]


@pytest.mark.parametrize("kn", FAMILY_KN, ids=lambda kn: "K{}-N{}".format(*kn))
def test_dense_gemm_rows_do_not_follow_m(cuda, kn):
    """The bf16 product (``ops._dense_matmul``): a row's bits at M 17, 32
    and 200 are its bits at M 512 (cuBLAS on fixed 128-row tiles)."""
    from repro_torch.kernels.ops import _dense_matmul
    k, n = kn
    gen = torch.Generator(device=cuda).manual_seed(7)
    w = (torch.randn((k, n), generator=gen, device=cuda) * 0.02).to(
        torch.bfloat16)
    x = torch.randn((512, k), generator=gen, device=cuda).to(torch.bfloat16)
    ref = _dense_matmul(x, w)
    for m in (17, 32, 200):
        assert torch.equal(_dense_matmul(x[:m], w), ref[:m]), m


@pytest.mark.parametrize("kn", FAMILY_KN[1:],
                         ids=lambda kn: "K{}-N{}".format(*kn))
@pytest.mark.parametrize("m", [4, 512])
def test_matmul_kernel_at_family_shapes(cuda, kn, m):
    """The dequant GEMM at the new configs' (K, N) pairs (K 11008: 86
    tiles of 128; N 256 and a ragged N 960) within 1e-5 of sum|x||w| of
    its plain version, bitwise on a second launch."""
    k, n = kn
    fmt = get_format("nxfp4")
    gen = torch.Generator(device=cuda).manual_seed(8)
    wq = quantize_qtensor(torch.randn((k, n), generator=gen, device=cuda)
                          * 0.02, fmt, axis=-2, device=cuda)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    y = nm.nxfp_matmul(x, wq.packed, wq.meta, fmt)
    assert torch.equal(y, nm.nxfp_matmul(x, wq.packed, wq.meta, fmt))
    ref = nm.nxfp_matmul_plain(x, wq.packed, wq.meta, fmt)
    wd = nm.dequant_weight_bf16(wq.packed, wq.meta, fmt)
    mag = x.float().abs() @ wd.float().abs().T
    assert float(((y - ref).abs() / mag.clamp(min=1e-30)).max()) <= 1e-5


@pytest.mark.parametrize("heads", FAMILY_HEADS[1:],
                         ids=lambda h: "KVH{}-G{}-D{}".format(*h))
def test_packed_attention_at_family_shapes(cuda, heads):
    """The packed instance at G 1, G 12 and head_dim 120 (cast in 4
    blocks of 32, q padded as ``ops.decode_attention`` pads it) over a
    4096-row cache: within 1e-5 of max|V|, bitwise on a second launch."""
    import torch.nn.functional as F
    kvh, g, hd = heads
    fmt = get_format("nxfp4")
    gen = torch.Generator(device=cuda).manual_seed(9)
    b, s = 4, 4096
    kq, vq = (quantize_qtensor(torch.randn((b, s, kvh, hd), generator=gen,
                                           device=cuda), fmt, axis=-1,
                               device=cuda) for _ in range(2))
    d = kq.packed.shape[-2] * fmt.block_size
    q = F.pad(torch.randn((b, kvh, g, hd), generator=gen, device=cuda)
              * hd ** -0.5, (0, d - hd))
    lens = torch.tensor([4096, 3001, 1024, 17], dtype=torch.int32,
                        device=cuda)
    args = (q, kq.packed, kq.meta, vq.packed, vq.meta, lens, fmt)
    out = na.nxfp_decode_attention(*args)
    assert torch.equal(out, na.nxfp_decode_attention(*args))
    ref = na.nxfp_decode_attention_plain(*args)
    vd = na.dequant_cache(vq.packed, vq.meta, fmt)
    assert float((out - ref).abs().max()) <= 1e-5 * float(vd.abs().max())
    assert not out[..., hd:].any()


@pytest.mark.parametrize("fmt", [None, "nxfp4"])
def test_ring_serving_on_card(cuda, fmt):
    """The sliding-window smoke model (window 32) on the card: a stream
    that wraps the ring in decode and one whose prompt is longer than the
    lane (the ring lane, P 32) are bitwise their solo streams, the lane
    chunks graph replays, the ring lane a graph of its own."""
    from repro_torch.serving import ContinuousEngine, Request
    cfg = get_smoke_config("h2o_danube_3_4b")
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (t,)),
                    max_new=m)
            for i, (t, m) in enumerate([(100, 6), (40, 30), (20, 8)])]
    pol = QuantPolicy(fmt, fmt)
    for kw in ({}, dict(prefill_mode="chunked", p_chunk=32)):
        eng = ContinuousEngine(cfg, params, pol, n_slots=2, max_len=64,
                               chunk=4, device=cuda, **kw)
        got = {r.uid: r.tokens for r in eng.serve(reqs)}
        for req in reqs:
            out = ServeEngine(cfg, eng.params, QuantPolicy(None, fmt),
                              max_len=64, device=cuda).generate(
                {"tokens": req.tokens[None]}, max_new=req.max_new,
                loop="host")
            np.testing.assert_array_equal(got[req.uid], out.tokens[0],
                                          err_msg=f"uid={req.uid} {kw}")
        if kw:
            assert eng.lane_replays == eng.lane_chunks
            assert (True, "ring") in eng._lane_graphs


def test_chunk_graph_warmup_leaves_a_full_ring_intact(cuda):
    """A decode chunk's graph is captured after a one-step warm-up on the
    live cache: in a full sliding-window ring (window 32, 40 prompt
    tokens) a whole chunk's warm-up would overwrite rows the replay's
    first steps attend to. The replayed chunk's logits equal the eager
    steps' on a copy of the cache, bit for bit."""
    from repro_torch.models import decode_step
    from repro_torch.serving.engine import capture_graph
    cfg = get_smoke_config("h2o_danube_3_4b")
    params = init_params(cfg, seed=0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 40))).to(cuda)
    logits, cache = prefill(cfg, params, {"tokens": toks}, 64, "nxfp4")
    copy = {"pos": cache["pos"].clone(),
            "layers": [{k: v.clone() for k, v in layer.items()}
                       for layer in cache["layers"]]}
    tok = logits.argmax(-1).to(torch.int32)

    def steps(n, c):
        def fn():
            out, t, cc = [], tok, c
            for _ in range(n):
                lg, cc = decode_step(cfg, params, t[:, None], cc, "nxfp4")
                out.append(lg)
                t = lg.argmax(-1).to(torch.int32)
            return torch.stack(out)
        return fn

    want = steps(4, copy)()
    graph, got = capture_graph(steps(4, cache), cuda, warm=steps(1, cache))
    graph.replay()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the paged KV cache: the quantizer through a block table, the paged engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fname", ["nxfp4", "mxfp6", "amxfp4"])
@pytest.mark.parametrize("case", ["decode", "chunk"])
def test_kv_rows_kernel_block_table(cuda, fname, case):
    """K/V rows through a block table: row r of slot s at row r % page of
    page ``block[s, r // page]``, one launch, the pool equal to the plain
    version's everywhere (bitwise, up to counted near-ties), rows on the
    null page, past ``n_valid`` or outside [0, S) not written."""
    fmt = get_format(fname)
    g = torch.Generator(device=cuda).manual_seed(5)
    n_pages, page, kvh, hd, cb, tw = 11, 4, 2, 64, 3, 4
    nb = -(-hd // fmt.block_size)
    meta_top = 1 << (31 if fmt.meta_dtype == "uint32" else 15)
    pool = {}
    for name in "kv":
        pool[f"pool_{name}_packed"] = torch.randint(
            0, 256, (n_pages, page, kvh, nb, fmt.bytes_per_block),
            generator=g, device=cuda, dtype=torch.uint8)
        meta = torch.randint(0, meta_top, (n_pages, page, kvh, nb),
                             generator=g, device=cuda, dtype=torch.int32)
        pool[f"pool_{name}_meta"] = (meta.view(torch.uint32)
                                     if fmt.meta_dtype == "uint32"
                                     else meta.to(torch.uint16))
    block = torch.tensor([[3, 0, 7, 1], [5, 9, 0, 0], [0, 0, 0, 0]],
                         dtype=torch.int32, device=cuda)
    i32 = dict(dtype=torch.int32, device=cuda)
    if case == "decode":
        k, v = (torch.randn((cb, 1, kvh, hd), generator=g, device=cuda)
                .to(torch.bfloat16) for _ in range(2))
        # slot 0 row 9 (page 7), slot 1 row 6 (page 9), slot 2 null
        args = dict(pos=torch.tensor([9, 6, 2], **i32))
    else:
        k, v = (torch.randn((1, 8, kvh, hd), generator=g, device=cuda)
                .to(torch.bfloat16) for _ in range(2))
        # rows 2..9 of slot 0, 6 valid: rows 4..7 are on its null page
        args = dict(pos=torch.tensor([2], **i32),
                    slot=torch.tensor([0], **i32),
                    n_valid=torch.tensor([6], **i32))
    before = {n: a.clone() for n, a in pool.items()}
    plain = {n: a.clone() for n, a in pool.items()}
    launches = nq.LAUNCHES
    nq.nxfp_quantize_kv_rows(k, v, pool, fmt=fmt, block=block, **args)
    assert nq.LAUNCHES == launches + 1
    nq.nxfp_quantize_kv_rows_plain(k, v, plain, fmt=fmt, block=block,
                                   **args)
    n_diff = 0
    for name in "kv":
        pk, pm = pool[f"pool_{name}_packed"], pool[f"pool_{name}_meta"]
        diff = ((pk != plain[f"pool_{name}_packed"]).any(-1)
                | (meta_int32(pm) != meta_int32(plain[f"pool_{name}_meta"])))
        n_diff += int(diff.sum())
    assert n_diff == 0, n_diff
    changed = torch.zeros((n_pages, page), dtype=torch.bool, device=cuda)
    for name in pool:
        a, b = pool[name], before[name]
        if a.dtype in (torch.uint16, torch.uint32):
            a, b = meta_int32(a), meta_int32(b)
        changed |= (a != b).reshape(n_pages, page, -1).any(-1)
    assert not changed[0].any()                       # the null page
    want = {"decode": {(7, 1), (9, 2)},
            "chunk": {(3, 2), (3, 3)}}[case]
    assert {tuple(i) for i in changed.nonzero().tolist()} == want


@pytest.mark.parametrize("fmt", [None, "nxfp4"])
def test_paged_engine_matches_dense_on_card(cuda, fmt):
    """Eager: ``decode_step`` over a paged cache gives the dense cache's
    logits bit for bit. Graphed: the paged engine's streams (whole, the
    lane at P 32, prefix sharing on) equal the dense engine's, every pool
    empty after its serve, the decode chunks graph replays."""
    from repro_torch.models import (init_cache, init_paged_cache,
                                    write_cache_slot)
    from repro_torch.serving import (ContinuousEngine, PagedContinuousEngine,
                                     Request)
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 20))).to(cuda)
    _, solo = prefill(cfg, params, {"tokens": toks}, 64, fmt)
    dense = init_cache(cfg, 2, 64, fmt, device=cuda)
    paged = init_paged_cache(cfg, 2, 64, fmt, 9, 8, device=cuda)
    paged["layers"][0]["block"].copy_(torch.tensor(
        [[2, 5, 1, 0, 0, 0, 0, 0], [3, 8, 4, 6, 0, 0, 0, 0]],
        dtype=torch.int32))
    for s in range(2):
        one = {"pos": solo["pos"][s:s + 1],
               "layers": [{n: b[s:s + 1] for n, b in layer.items()}
                          for layer in solo["layers"]]}
        write_cache_slot(dense, one, s)
        write_cache_slot(paged, one, s)
    tok = toks[:, -1:]
    for _ in range(4):
        ld, dense = decode_step(cfg, params, tok, dense, fmt)
        lp, paged = decode_step(cfg, params, tok, paged, fmt)
        assert torch.equal(ld, lp)
        tok = ld.argmax(-1, keepdim=True)
    shared = rng.integers(0, cfg.vocab, (24,))
    reqs = [Request(uid=i, tokens=np.concatenate(
        [shared, rng.integers(0, cfg.vocab, (t,))]), max_new=m)
        for i, (t, m) in enumerate([(4, 9), (20, 5), (9, 12), (30, 7)])]
    kw = dict(n_slots=2, max_len=64, chunk=4, device=cuda)
    pol = QuantPolicy(fmt, fmt)
    want = {r.uid: r.tokens
            for r in ContinuousEngine(cfg, params, pol, **kw).serve(reqs)}
    for mode in ({}, dict(prefill_mode="chunked", p_chunk=32)):
        eng = PagedContinuousEngine(cfg, params, pol, page_size=8, **kw,
                                    **mode)
        got = {r.uid: r.tokens for r in eng.serve(reqs)}
        for uid in want:
            np.testing.assert_array_equal(got[uid], want[uid],
                                          err_msg=f"uid={uid} {mode}")
        assert eng.replays > 0 and eng.pool_stats()[0]["prefix_hits"] >= 1
        eng.pool.assert_empty()


@pytest.mark.parametrize("fmt", [None, "nxfp4"])
@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_paged_claimant_across_gemm_regimes_on_card(cuda, fmt, mode):
    """``page_size`` 8, a live registrar of 20 tokens, a claimant of 12
    tokens on its first page (at most 16 rows: the GEMMs' small-M regime,
    whose rows are other bits than the registrar's prefill gives) and one
    of 24 tokens on its first two pages. Every stream, the registrar's
    included, is bitwise the dense engine's of the same prefill mode (the
    lane at P 8). Whole admission shares only the 24-token claimant; the
    lane runs every chunk at P 8, and shares both."""
    from repro_torch.kernels.ops import DENSE_SMALL_M
    from repro_torch.serving import (ContinuousEngine, PagedContinuousEngine,
                                     Request)
    assert nm.decode_geometry().max_m == DENSE_SMALL_M
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(11)
    base = rng.integers(0, cfg.vocab, (20,))
    reqs = [Request(uid=0, tokens=base, max_new=16),
            Request(uid=1, tokens=np.concatenate(
                [base[:8], rng.integers(0, cfg.vocab, (4,))]), max_new=3),
            Request(uid=2, tokens=np.concatenate(
                [base[:16], rng.integers(0, cfg.vocab, (8,))]), max_new=4)]
    kw = dict(n_slots=2, max_len=64, chunk=4, device=cuda, prefill_mode=mode)
    if mode == "chunked":
        kw["p_chunk"] = 8
    pol = QuantPolicy(fmt, fmt)
    want = {r.uid: r.tokens
            for r in ContinuousEngine(cfg, params, pol, **kw).serve(reqs)}
    eng = PagedContinuousEngine(cfg, params, pol, page_size=8, **kw)
    got = {r.uid: r.tokens for r in eng.serve(reqs)}
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid={uid} {mode}")
    st = eng.pool_stats()[0]
    assert st["prefix_hits"] == (1 if mode == "whole" else 2)
    eng.pool.assert_empty()


# ---------------------------------------------------------------------------
# the SSM and hybrid families: the kernels at their shapes, the Mamba step
# ---------------------------------------------------------------------------

# (K, N) of the families' narrow and padded GEMMs: Hymba's ssm_x_w (N 132,
# a 4-column last tile of the wgmma regime's 128), Falcon's ssm_x_w (N
# 288) and Hymba's ssm_dt_w (K 100, quantization pads it to 4 blocks)
SSM_KN = ((3200, 132), (8192, 288), (100, 3200))


@pytest.mark.parametrize("k,n", SSM_KN)
def test_matmul_ssm_shapes_match_plain_and_rows_hold_across_m(cuda, k, n):
    """The dequant GEMM through ``ops.qmatmul`` (which pads x to the
    weight's blocks) at the SSM families' narrow and padded shapes: 1e-5
    of sum|x||w| against the plain version at M 4 and 512, and a row's
    bits the same at every M inside one regime (M 1, 4 and 8 against 16
    in split-K; M 17, 64 and 256 against 512 in wgmma)."""
    from repro_torch.kernels.ops import qmatmul
    fmt = get_format("nxfp4")
    g = torch.Generator(device=cuda).manual_seed(k + n)
    wq = quantize_qtensor(torch.randn((k, n), generator=g, device=cuda)
                          * 0.02, fmt, axis=-2, device=cuda)
    x = torch.randn((512, k), generator=g, device=cuda).to(torch.bfloat16)
    k_pad = wq.packed.shape[1] * fmt.block_size
    xp = torch.nn.functional.pad(x, (0, k_pad - k))
    for m in (4, 512):
        _assert_matmul_close(xp[:m], wq, fmt, qmatmul(x[:m], wq))
    for ref_m, ms in ((16, (1, 4, 8)), (512, (17, 64, 256))):
        ref = qmatmul(x[:ref_m], wq)
        for m in ms:
            assert torch.equal(qmatmul(x[:m], wq), ref[:m]), (ref_m, m)


def test_attention_hymba_heads_match_plain(cuda):
    """Decode attention at Hymba's heads (5 KV heads, G 5 over 4 warps, head
    dim 64: two blocks of 32) over its 1024-row ring, ragged lengths:
    1e-5 of max|V|, bitwise on a second launch, row 0 the same bits at
    B 1 and 4."""
    args = _attention_case(cuda, "nxfp4", (1024, 700, 33, 1), 1024, seed=5,
                           kvh=5, grp=5, hd=64)
    out = na.nxfp_decode_attention(*args)
    ref = na.nxfp_decode_attention_plain(*args)
    vmax = float(na.dequant_cache(args[3], args[4], args[6]).abs().max())
    assert float((out - ref).abs().max()) <= 1e-5 * vmax
    assert torch.equal(out, na.nxfp_decode_attention(*args))
    one = na.nxfp_decode_attention(*(a[:1] if torch.is_tensor(a) else a
                                     for a in args))
    assert torch.equal(one[0], out[0])


def _ssm_case(cuda, arch):
    """(cfg, nxfp4 params) of ``arch`` at full width, 2 layers, or its smoke
    config; random weights from seed 1."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import load_params
    if arch.endswith("smoke"):
        cfg = get_smoke_config(arch[:-len("-smoke")])
    else:
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
    return cfg, load_params(init_params(cfg, seed=1, device=cuda),
                            QuantPolicy("nxfp4", None), cuda)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b-smoke", "hymba_1_5b-smoke",
                                  "falcon_mamba_7b", "hymba_1_5b"])
def test_mamba_decode_step_invariant_on_card(cuda, arch):
    """A decode step's rows (f32 logits, every layer's ``h`` and ``conv``)
    at B 4 equal the same rows at B 1, bit for bit, and a captured CUDA
    graph of the step replays the eager step's bits (its warm-up leaves
    the state as it found it: no step is integrated twice)."""
    from repro_torch.models import recurrent_state
    from repro_torch.serving.engine import capture_graph
    cfg, params = _ssm_case(cuda, arch)
    rng = np.random.default_rng(9)
    rows = []
    for t in (40, 17, 29, 33):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, t)),
                               device=cuda)
        logits, cache = prefill(cfg, params, {"tokens": toks}, max_len=64,
                                kv_fmt="nxfp4")
        rows.append((logits.argmax(-1).to(torch.int32), cache))

    def batch(b):
        cache = {"pos": torch.cat([c["pos"] for _, c in rows[:b]]),
                 "layers": [{k: torch.cat([c["layers"][i][k]
                                           for _, c in rows[:b]])
                             for k in rows[0][1]["layers"][i]}
                            for i in range(cfg.n_layers)]}
        return torch.cat([t for t, _ in rows[:b]])[:, None], cache

    tok1, c1 = batch(1)
    tok4, c4 = batch(4)
    l1, c1 = decode_step(cfg, params, tok1, c1, "nxfp4")
    static = {"pos": c4["pos"].clone(),
              "layers": [{k: v.clone() for k, v in lc.items()}
                         for lc in c4["layers"]]}
    l4, c4 = decode_step(cfg, params, tok4, c4, "nxfp4")
    assert torch.equal(l4[0], l1[0])
    for a, b in zip(c4["layers"], c1["layers"]):
        for name in ("h", "conv"):
            assert torch.equal(a[name][:1], b[name]), name

    def step():
        return decode_step(cfg, params, tok4, static, "nxfp4")[0]

    graph, out = capture_graph(step, cuda, keep=recurrent_state(static))
    graph.replay()
    assert torch.equal(out, l4)
    for a, b in zip(static["layers"], c4["layers"]):
        for name in ("h", "conv"):
            assert torch.equal(a[name], b[name]), name


# ---------------------------------------------------------------------------
# the paged engine's speculative rounds; the qq GEMM at Hymba's shapes
# ---------------------------------------------------------------------------

def _pool_bytes(cache):
    """Every pool buffer of a paged cache, as raw bytes (a copy)."""
    return {(i, name): buf.view(torch.uint8).clone()
            for i, layer in enumerate(cache["layers"])
            for name, buf in layer.items() if name.startswith("pool_")}


@pytest.mark.parametrize("kv", [None, "nxfp4"])
def test_paged_round_rows_in_a_graph(cuda, kv):
    """A speculative round's save, verify and restore over a paged cache,
    captured as one CUDA graph (the block table read on the device): a
    replay leaves every pool byte as it was; slot 0's rows 24-25 lie past
    its reservation (a null table entry). A ragged commit through a graph
    leaves every mapped row equal to the dense cache's after the same
    eager commit, and the null page all zeros."""
    from repro_torch.models import (commit_verify, init_paged_cache,
                                    read_cache_slot, verify_step,
                                    write_cache_slot)
    from repro_torch.models.kvcache import paged_layer_view
    from repro_torch.models.lm import restore_round, save_round
    from repro_torch.serving.engine import capture_graph
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, seed=0, device=cuda)
    b, t, q, page, max_len = 2, 21, 5, 8, 32
    rng = np.random.default_rng(12)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, t)), device=cuda)
    cands = torch.as_tensor(rng.integers(0, cfg.vocab, (b, q)),
                            dtype=torch.int32, device=cuda)
    _, dense = prefill(cfg, params, {"tokens": toks}, max_len, kv)
    paged = init_paged_cache(cfg, b, max_len, kv, n_pages=2 * 4 + 1,
                             page_size=page, device=cuda)
    table = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 7]], dtype=torch.int32)
    paged["layers"][0]["block"].copy_(table.to(cuda))
    for s in range(b):
        write_cache_slot(paged, read_cache_slot(dense, s), s)
    before = _pool_bytes(paged)

    def round_trip():
        saved = save_round(cfg, paged, q, kv)
        verify_step(cfg, params, cands, paged, kv)
        restore_round(cfg, paged, saved, kv)

    graph, _ = capture_graph(round_trip, cuda)
    graph.replay()
    torch.cuda.synchronize()
    after = _pool_bytes(paged)
    assert all(torch.equal(after[k], v) for k, v in before.items())

    n = torch.tensor([2, 5], dtype=torch.int32, device=cuda)

    def commit():
        _, pend = verify_step(cfg, params, cands, paged, kv)
        return commit_verify(cfg, paged, pend, n, kv)["pos"]

    graph, pos = capture_graph(commit, cuda)
    graph.replay()
    _, pend = verify_step(cfg, params, cands, dense, kv)
    want = commit_verify(cfg, dense, pend, n, kv)
    torch.cuda.synchronize()
    assert torch.equal(pos, want["pos"])
    mapped = (table != 0).repeat_interleave(page, dim=1).to(cuda)
    for pl, dl in zip(paged["layers"], dense["layers"]):
        view = paged_layer_view(pl)
        for name, buf in dl.items():
            a, d = view[name].view(torch.uint8), buf.view(torch.uint8)
            assert torch.equal(a[mapped], d[mapped]), name
        for name, buf in pl.items():
            if name.startswith("pool_"):
                assert not buf[0].view(torch.uint8).any(), name


HYMBA_QQ = [(1600, 1600), (1600, 320), (1600, 5504), (5504, 1600)]


@pytest.mark.parametrize("k,n", HYMBA_QQ)
@pytest.mark.parametrize("m", [256, 512])
def test_qq_kernel_at_hymba_shapes(cuda, k, n, m):
    """The qq GEMM at Hymba-1.5B's attention and MLP pairs (the economy
    tier's prefill at M 512 and its lane chunk at M 256): within 1e-5 of
    sum|x||w| of its plain version and the bits of ``nxfp_matmul`` on the
    plain-decoded X."""
    x_fmt, w_fmt = get_format("amxfp4"), get_format("nxfp4")
    g = torch.Generator(device=cuda).manual_seed(k + n + m)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn((k, n), generator=g, device=cuda) * 0.02
    xq = quantize_qtensor(x, x_fmt, axis=-1, device=cuda)
    wq = quantize_qtensor(w, w_fmt, axis=-2, device=cuda)
    args = (xq.packed, xq.meta, wq.packed, wq.meta, x_fmt, w_fmt)
    y = nqq.nxfp_qq_matmul(*args)
    yp = nqq.nxfp_qq_matmul_plain(*args)
    xd = nm.dequant_weight_bf16(xq.packed, xq.meta, x_fmt)
    wd = nm.dequant_weight_bf16(wq.packed, wq.meta, w_fmt).float()
    assert y.shape == (m, n) and torch.isfinite(y).all()
    assert ((y - yp).abs() <= 1e-5 * (xd.float().abs() @ wd.abs().T)
            + 1e-30).all()
    assert torch.equal(y, nm.nxfp_matmul(xd, wq.packed, wq.meta, w_fmt))


# ---------------------------------------------------------------------------
# suspension and slot snapshots on the card
# ---------------------------------------------------------------------------

def _suspend_when(uid, n_gen, box, clear_graphs=False):
    """A ``progress_cb`` that suspends ``uid`` once it has decoded
    ``n_gen`` tokens, keeping its snapshot and slot in ``box`` (and, with
    ``clear_graphs``, dropping the engine's decode graphs, so the first
    chunk after the resume captures anew)."""
    from repro_torch.serving import DECODING

    def cb(engine, sched):
        slot = next((s for s, r in sched.active.items() if r.uid == uid),
                    None)
        if "snap" in box or slot is None or \
                sched.phase[slot] != DECODING or \
                engine._host["n_gen"][slot] < n_gen:
            return
        box["snap"], box["from"] = engine.snapshot_slot(slot), slot
        engine.suspend(uid)
        if clear_graphs:
            engine._graphs.clear()
    return cb


def _spy_resume(eng, box):
    """Record each resume's slot and the slot's state read back right
    after the restore (before any chunk)."""
    from repro_torch.models import read_cache_slot
    from repro_torch.serving import pack_device_state
    resume = eng._resume

    def spy(sched, state, slot, req, snap, clock, **kw):
        resume(sched, state, slot, req, snap, clock, **kw)
        box["to"] = slot
        box["back"] = pack_device_state(
            read_cache_slot(eng._slot_cache(slot), slot), snap.used_rows)
    eng._resume = spy


def _same_payload(a, b):
    return torch.equal(a["pos"], b["pos"]) and all(
        set(x) == set(y) and all(torch.equal(x[n], y[n]) for n in x)
        for x, y in zip(a["layers"], b["layers"]))


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_suspend_resume_in_graph_on_card(cuda, sampled):
    """A slot suspended mid-stream resumes in the other slot (a waiting
    request took its own meanwhile), its generator state moved into that
    slot's generator: every stream is the same engine's uninterrupted
    stream bit for bit, every decode chunk a graph replay (a sampled
    request's absence makes some chunks greedy, a graph of their own),
    and a sampled stream is also its solo host-loop stream."""
    from repro_torch.serving import ContinuousEngine, Request
    cfg, params = _continuous_case(cuda, "smoke")
    policy = QuantPolicy("nxfp4", "nxfp4")
    rng = np.random.default_rng(12)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (8,)),
                    max_new=m) for i, m in enumerate((10, 20, 8))]
    if sampled:
        reqs[1] = dataclasses.replace(reqs[1], temperature=1.2, seed=21)
    eng = ContinuousEngine(cfg, params, policy, n_slots=2, max_len=64,
                           chunk=4, device=cuda)
    want = {r.uid: r.tokens for r in eng.serve(reqs)}
    box = {}
    _spy_resume(eng, box)
    replays = eng.replays
    got = {r.uid: r.tokens for r in eng.serve(
        reqs, progress_cb=_suspend_when(1, 8, box))}
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid={uid}")
    assert box["to"] != box["from"]
    assert _same_payload(box["back"], box["snap"].device)
    assert eng.replays == replays + eng.chunks
    if sampled:
        np.testing.assert_array_equal(
            got[1], _solo_on_card(cfg, params, policy, reqs[1], 64))


def test_hymba_state_round_trip_then_first_capture_on_card(cuda):
    """Hymba (smoke; a 32-row ring that has wrapped, the Mamba state): the
    slot's ``h``, ``conv`` and K/V rows read back after the resume are the
    snapshot's bit for bit; the decode graphs are then captured afresh
    with the restored slot live (their warm-up puts its state back), and
    every stream is the uninterrupted one."""
    from repro_torch.serving import ContinuousEngine, Request
    cfg, params = _ssm_case(cuda, "hymba_1_5b-smoke")
    rng = np.random.default_rng(13)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (8,)),
                    max_new=m) for i, m in enumerate((40, 12, 20))]
    eng = ContinuousEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                           n_slots=4, max_len=64, chunk=4, device=cuda)
    want = {r.uid: r.tokens for r in eng.serve(reqs)}
    box = {}
    _spy_resume(eng, box)
    got = {r.uid: r.tokens for r in eng.serve(
        reqs, progress_cb=_suspend_when(0, 28, box, clear_graphs=True))}
    snap = box["snap"]
    assert snap.pos > cfg.sliding_window == snap.used_rows
    assert box["to"] != box["from"]
    assert _same_payload(box["back"], snap.device)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"uid={uid}")
    assert eng._graphs                  # captured after the resume


def test_paged_restore_through_table_on_card(cuda):
    """``PagedContinuousEngine._restore_dispatch`` of a full-capacity
    payload (seeded bytes in the rows past the request's pages): the
    slot's pages are allocated unshared, its rows read back through the
    table are the payload's, the rows past the allocation land on the null
    page and drop, and page 0 stays all zeros."""
    from repro_torch.kernels.build import bit_view
    from repro_torch.models import read_cache_slot
    from repro_torch.serving import (ContinuousEngine, PagedContinuousEngine,
                                     Request, pack_device_state)
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, seed=0, device=cuda)
    policy = QuantPolicy(None, "nxfp4")
    rng = np.random.default_rng(14)
    req = Request(uid=0, tokens=rng.integers(0, cfg.vocab, (8,)), max_new=16)
    box = {}
    ContinuousEngine(cfg, params, policy, n_slots=2, max_len=64, chunk=4,
                     device=cuda).serve([req],
                                        progress_cb=_suspend_when(0, 8, box))
    snap = box["snap"]
    rows = 24                               # 8 + 16: three 8-row pages
    g = torch.Generator().manual_seed(3)
    for layer in snap.device["layers"]:
        for name, buf in list(layer.items()):
            raw = bit_view(buf)             # uint16 meta as int16
            full = torch.randint(1, 127, (1, 64) + tuple(buf.shape[2:]),
                                 generator=g).to(raw.dtype)
            full[:, :buf.shape[1]] = raw
            layer[name] = full.view(buf.dtype)
    snap.used_rows = 64
    eng = PagedContinuousEngine(cfg, params, policy, n_slots=2, max_len=64,
                                chunk=4, page_size=8, device=cuda)
    eng._sched = eng._make_sched()
    eng._restore_dispatch(1, snap)
    torch.cuda.synchronize()
    assert len(eng.pool.slot_pages(1)) == 3 and not eng.pool.has_shared(1)
    back = pack_device_state(read_cache_slot(eng.cache, 1), rows)
    want = {"pos": snap.device["pos"],
            "layers": [{n: b[:, :rows] for n, b in layer.items()}
                       for layer in snap.device["layers"]]}
    assert _same_payload(back, want)
    for layer in eng.cache["layers"]:
        for name, buf in layer.items():
            if name.startswith("pool_"):
                assert not buf[0].view(torch.uint8).any(), name


def _spy_chunks(eng, log):
    """Record each decode dispatch's (poison, finite, emitted, live)."""
    dispatch = eng._dispatch_chunk

    def spy(poison):
        emitted, finite = dispatch(poison)
        log.append((poison.copy(), finite.copy(), emitted.copy(),
                    eng._host["live"].copy()))
        return emitted, finite
    eng._dispatch_chunk = spy


def _fault_case(cuda, sampled=False):
    cfg, params = _continuous_case(cuda, "smoke")
    rng = np.random.default_rng(15)
    from repro_torch.serving import Request
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab, (8,)),
                    max_new=m) for i, m in enumerate((10, 24, 8))]
    if sampled:
        reqs[0] = dataclasses.replace(reqs[0], temperature=0.9, seed=7)
    return cfg, params, reqs


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_all_false_poison_is_transparent_on_card(cuda, sampled):
    """With no plan and with a spent plan the poison buffer stays all
    False: every chunk is a graph replay and every stream is its solo
    host-loop stream, bit for bit."""
    from repro_torch.serving import ContinuousEngine, Fault, FaultPlan
    cfg, params, reqs = _fault_case(cuda, sampled)
    policy = QuantPolicy("nxfp4", "nxfp4")
    eng = ContinuousEngine(cfg, params, policy, n_slots=3, max_len=64,
                           chunk=4, kv_integrity=True, device=cuda)
    spent = FaultPlan((Fault("nan_logits", uid=0),))
    spent.fire(0)
    spent.reset = lambda: None
    for plan in (None, spent):
        replays = eng.replays
        got = {r.uid: r for r in eng.serve(reqs, fault_plan=plan)}
        assert eng.replays == replays + eng.chunks
        assert not eng._buf["poison"].any()
        for r in reqs:
            assert got[r.uid].status == "OK"
            np.testing.assert_array_equal(
                got[r.uid].tokens,
                _solo_on_card(cfg, params, policy, r, 64),
                err_msg=f"uid={r.uid}")


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_poisoned_slot_trips_finite_on_card(cuda, sampled):
    """The chunk that poisons uid 1's slot returns ``finite`` False there
    and True for the other live slots, whose emitted rows are the
    fault-free serve's rows of the same chunk bit for bit; the victim ends
    FAILED with its prefix, the neighbours with their whole streams."""
    from repro_torch.serving import ContinuousEngine, Fault, FaultPlan
    cfg, params, reqs = _fault_case(cuda, sampled)
    eng = ContinuousEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                           n_slots=3, max_len=64, chunk=4, device=cuda)
    clean, faulted = [], []
    _spy_chunks(eng, clean)
    want = {r.uid: r.tokens for r in eng.serve(reqs)}
    eng._dispatch_chunk = type(eng)._dispatch_chunk.__get__(eng)
    _spy_chunks(eng, faulted)
    got = {r.uid: r for r in eng.serve(
        reqs, fault_plan=FaultPlan((Fault("nan_logits", chunk=1, uid=1),)))}
    i = next(j for j, c in enumerate(faulted) if c[0].any())
    poison, finite, emitted, live = faulted[i]
    victim = int(np.nonzero(poison)[0][0])
    assert not finite[victim] and finite[live & ~poison].all()
    assert clean[i][1].all()
    for s in np.nonzero(live & ~poison)[0]:
        np.testing.assert_array_equal(emitted[s], clean[i][2][s])
    assert got[1].status == "FAILED"
    np.testing.assert_array_equal(got[1].tokens,
                                  want[1][:got[1].n_generated])
    for uid in (0, 2):
        assert got[uid].status == "OK"
        np.testing.assert_array_equal(got[uid].tokens, want[uid])


def test_kv_flip_between_replays_is_read_on_card(cuda):
    """A flip of the victim's packed K/V bytes between two replays edits
    the buffers the captured graph reads (no buffer is replaced): without
    the canary the victim's next replays read 512 flipped bytes (its
    result is no longer the fault-free one), with ``kv_integrity`` the
    canary trips on 2 and the victim fails; the neighbours stay bitwise
    either way."""
    from repro_torch.serving import (ContinuousEngine, Fault, FaultPlan,
                                     parse_event)
    import logging
    cfg, params, reqs = _fault_case(cuda)
    for integrity, n_bytes in ((False, 512), (True, 2)):
        eng = ContinuousEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                               n_slots=3, max_len=64, chunk=4,
                               kv_integrity=integrity, device=cuda)
        want = {r.uid: r.tokens for r in eng.serve(reqs)}
        trips = []
        if integrity:
            verify = eng._kv_verify
            eng._kv_verify = lambda: trips.append(verify()) or trips[-1]
        ptrs = [{n: b.data_ptr() for n, b in lc.items()}
                for lc in eng.cache["layers"]]
        msgs = []
        h = logging.Handler()
        h.emit = lambda rec: msgs.append(rec.getMessage())
        log = logging.getLogger("repro_torch.serving")
        old = log.level
        log.addHandler(h)
        log.setLevel(logging.INFO)
        try:
            got = {r.uid: r for r in eng.serve(reqs, fault_plan=FaultPlan(
                (Fault("kv_flip", chunk=1, uid=1, n_bytes=n_bytes),)))}
        finally:
            log.removeHandler(h)
            log.setLevel(old)
        assert [{n: b.data_ptr() for n, b in lc.items()}
                for lc in eng.cache["layers"]] == ptrs
        assert got[1].status != "OK" or \
            not np.array_equal(got[1].tokens, want[1])
        for uid in (0, 2):
            np.testing.assert_array_equal(got[uid].tokens, want[uid])
        causes = [e["cause"] for e in map(parse_event, msgs)
                  if e and e["event"] == "quarantine"]
        if integrity:       # the canary trips (the sentinel may too,
            assert got[1].status == "FAILED"    # and is then the cause)
            assert len(causes) == 1 and any(t.any() for t in trips)


# ---------------------------------------------------------------------------
# the dequant GEMM's grouped instance (MoE routed experts)
# ---------------------------------------------------------------------------

def _experts(cuda, e, k, n, fname="nxfp4", seed=0):
    """A cast expert stack (E, K, N) along axis -2 and each expert's own
    QTensor (the slices ``ops.qmatmul`` takes)."""
    from repro_torch.core.qtensor import QTensor
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn((e, k, n), generator=g, device=cuda) * 0.02
    q = quantize_qtensor(w, fname, axis=-2, device=cuda)
    per = [QTensor(q.packed[i], q.meta[i], q.fmt_name, q.shape[1:], q.axis,
                   q.orig_len) for i in range(e)]
    return q, per


def _routed(cuda, r, k, e, drop=(), skip=(), seed=1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((r, k), generator=g, device=cuda).to(torch.bfloat16)
    live = [i for i in range(e) if i not in skip]
    expert = torch.tensor([live[i % len(live)] for i in range(r)],
                          dtype=torch.int32, device=cuda)
    for i in drop:
        expert[i] = -1
    return x, expert


@pytest.mark.parametrize("r,k,n,e", [(16, 2048, 1408, 60), (8, 4096, 6400, 16),
                                     (16, 1408, 2048, 60),
                                     (300, 2048, 1408, 60)])
def test_grouped_matmul_rows_bitwise_qmatmul(cuda, r, k, n, e):
    """Each row bitwise ``ops.qmatmul`` of that row alone against its
    expert's weight, at decode and prefill row counts; within 1e-5 of the
    plain version's scale; bitwise on a second launch."""
    from repro_torch.kernels import nxfp_matmul_grouped as ng
    from repro_torch.kernels.ops import expert_matmul, qmatmul
    q, per = _experts(cuda, e, k, n)
    x, expert = _routed(cuda, r, k, e)
    y = expert_matmul(x, expert, q)
    assert torch.equal(y, expert_matmul(x, expert, q))
    ex = expert.cpu().tolist()
    for i in range(0, r, max(1, r // 24)):
        assert torch.equal(y[i:i + 1], qmatmul(x[i:i + 1], per[ex[i]])), i
    plain = ng.nxfp_matmul_grouped_plain(x, expert, q.packed, q.meta, q.fmt)
    assert (y - plain).abs().max() <= 1e-5 * plain.abs().max()


def test_grouped_matmul_dropped_rows_zero_and_idle_experts_unread(cuda):
    """Dropped rows come back zero; an expert with no rows reads none of
    its weight (garbage bytes there change nothing) and leaves every
    other row as it was."""
    from repro_torch.kernels.ops import expert_matmul
    q, _ = _experts(cuda, 8, 512, 320)
    x, expert = _routed(cuda, 40, 512, 8, drop=(0, 7, 39), skip=(2, 5))
    y = expert_matmul(x, expert, q)
    assert not y[[0, 7, 39]].any()
    poisoned = dataclasses.replace(q, packed=q.packed.clone(),
                                   meta=q.meta.clone())
    for idle in (2, 5):
        poisoned.packed[idle].fill_(0xFF)
        poisoned.meta[idle].fill_(0x7FFF)
    assert torch.equal(expert_matmul(x, expert, poisoned), y)


def test_moe_decode_rows_bitwise_across_batch_on_card(cuda):
    """A smoke MoE model's decode rows at B 4 bitwise each request decoded
    alone (the router's 16-row product, the grouped GEMM's rows; each
    slot prefilled alone, since a batched prefill's capacity spans the
    batch), and ServeEngine's graph loop bitwise its host loop."""
    import numpy as np
    from repro_torch.models import init_cache, prefill_into_slot
    cfg = get_smoke_config("qwen2_moe_a2_7b")
    policy = QuantPolicy("nxfp4", "nxfp4")
    params = init_params(cfg, 0, device=cuda, policy=policy)
    toks = torch.randint(0, cfg.vocab, (4, 9), device=cuda)
    cache = init_cache(cfg, 4, 32, "nxfp4", device=cuda)
    for i in range(4):
        prefill_into_slot(cfg, params, {"tokens": toks[i:i + 1]}, cache, i,
                          32, "nxfp4")
    step, _ = decode_step(cfg, params, toks[:, -1:], cache, "nxfp4")
    for i in range(4):
        _, c1 = prefill(cfg, params, {"tokens": toks[i:i + 1]}, 32, "nxfp4")
        one, _ = decode_step(cfg, params, toks[i:i + 1, -1:], c1, "nxfp4")
        assert torch.equal(one[0], step[i]), i
    eng = ServeEngine(cfg, params, policy, max_len=64, device=cuda)
    batch = {"tokens": toks.cpu().numpy()}
    graph = eng.generate(batch, max_new=12, loop="device", chunk=4)
    host = eng.generate(batch, max_new=12, loop="host")
    np.testing.assert_array_equal(graph.tokens, host.tokens)


# ---------------------------------------------------------------------------
# the vision and audio families: the dense-row instance over a memory,
# cross decode, the kv_sim route, the smoke models' graph loop
# ---------------------------------------------------------------------------

# (KV heads, G, head_dim, S): Llama-3.2-Vision-90B's cross attention over
# its 1601 patches, Whisper-tiny's over its 1500 frames (neither a whole
# number of the kernel's 32-row tiles)
MEMORY_HEADS = [(8, 8, 128, 1601), (6, 1, 64, 1500)]


@pytest.mark.parametrize("heads", MEMORY_HEADS,
                         ids=lambda h: "KVH{}-G{}-D{}-S{}".format(*h))
def test_dense_attention_over_a_memory(cuda, heads):
    """The dense-row instance at the cross layers' memory lengths (every
    row valid, as cross decode reads it, and two ragged rows): within
    1e-5 of max|V| of its plain version, bitwise on a second launch, row
    0's bits the same at B 1, 4 and 8; a NaN slot right past the last
    row's memory never reaches the output (no read at or past S)."""
    from repro_torch.kernels import dense_attention as da
    kvh, g, d, s = heads
    gen = torch.Generator(device=cuda).manual_seed(29)
    b = 8
    buf = torch.randn((b + 1, s, kvh, d), generator=gen, device=cuda).to(
        torch.bfloat16)
    vbuf = torch.randn((b + 1, s, kvh, d), generator=gen, device=cuda).to(
        torch.bfloat16)
    buf[b] = float("nan")
    vbuf[b] = float("nan")
    k, v = buf[:b], vbuf[:b]
    q = torch.randn((b, kvh, g, d), generator=gen, device=cuda) * d ** -0.5
    lens = torch.full((b,), s, dtype=torch.int32, device=cuda)
    lens[2], lens[5] = 700, 33
    out = da.dense_decode_attention(q, k, v, lens)
    assert torch.isfinite(out).all()
    assert torch.equal(out, da.dense_decode_attention(q, k, v, lens))
    ref = da.dense_decode_attention_plain(q, k, v, lens)
    err = float((out - ref).abs().max())
    assert err <= 1e-5 * float(v.float().abs().max()), err
    one = da.dense_decode_attention(q[:1], k[:1], v[:1], lens[:1])
    for bb in (4, 8):
        got = da.dense_decode_attention(q[:bb], k[:bb], v[:bb], lens[:bb])
        assert torch.equal(got[0], one[0]), bb


@pytest.mark.parametrize("arch", ["llama_3_2_vision_90b", "whisper_tiny"])
def test_cross_decode_rows_and_plain_on_card(cuda, arch):
    """A smoke cross layer's one-token cross attention (``_cross_decode``:
    the dense-row instance) within 1e-5 of the same function with the
    attention's plain version (the reference's einsum) on the same card
    tensors, and a row's bits at B 1 those of the B 4 batch."""
    from repro_torch.kernels import dense_attention as da
    from repro_torch.models import attention, blocks, lm
    cfg = get_smoke_config(arch)
    params = init_params(cfg, 0, device=cuda, policy=QuantPolicy("nxfp4",
                                                                 "nxfp4"))
    i = next(j for j, kind in enumerate(lm.layer_kinds(cfg))
             if kind in blocks.CROSS_KINDS)
    p = params["layers"][i]
    gen = torch.Generator(device=cuda).manual_seed(30)
    s = cfg.n_vision_tokens or cfg.n_audio_frames
    mem = torch.randn((4, s, cfg.d_model), generator=gen, device=cuda).to(
        cfg.dtype)
    mk, mv = attention.memory_kv(cfg, p, mem)
    h = torch.randn((4, 1, cfg.d_model), generator=gen, device=cuda).to(
        cfg.dtype)
    da.LAUNCHES = 0
    out = blocks._cross_decode(cfg, p, h, mk, mv)
    assert da.LAUNCHES == 1
    one = blocks._cross_decode(cfg, p, h[:1], mk[:1], mv[:1])
    assert torch.equal(one[0], out[0])
    q = blocks.dense(h, p["cross_wq"]).reshape(4, cfg.n_kv_heads, -1,
                                               cfg.hd).float() \
        * cfg.hd ** -0.5
    lens = torch.full((4,), s, dtype=torch.int32, device=cuda)
    o_k = da.dense_decode_attention(q, mk, mv, lens)
    o_p = da.dense_decode_attention_plain(q, mk, mv, lens)
    assert float((o_k - o_p).abs().max()) <= 1e-5 * float(
        mv.float().abs().max())


@pytest.mark.parametrize("fname", [
    "nxfp4", "nxfp4_bs16", "mxfp4_cr", "nxfp6", "nxfp8", "nxfp3",
    "nxfp4_bs64",
    # without code recycling (KIND_TAB): BFP, MxFP and the NxFP ablations
    # the reference's figures cast, at block sizes 8 to 128
    "bfp3", "bfp4", "bfp5", "bfp6", "mxfp3", "mxfp4", "mxfp5", "mxfp6",
    "mxfp6_e3m2", "nxfp3_nm", "nxfp4_nm", "nxfp5_nm", "nxfp6_nm",
    "nxfp4_nm_am", "nxfp6_nm_am", "bfp4_bs8", "mxfp4_bs8", "bfp4_bs128",
    "mxfp4_bs128", "mxfp4_bs16", "bfp4_bs64", "bfp2", "bfp7", "mxfp8"])
def test_quantize_kernel_table_rules_bitwise(cuda, fname):
    """``table=True`` (the table-driven encoder's rules: the kernel's
    KIND_CRT with code recycling, KIND_TAB without): bitwise the plain
    ``quantize_blocks`` up to counted candidate near-ties, on the edge
    blocks and on bf16 blocks, whose scaled values often land on a
    midpoint (where the arithmetic encoder rounds half to even and
    differs)."""
    fmt = get_format(fname)
    gen = torch.Generator(device=cuda).manual_seed(33)
    bf = torch.randn((4096, fmt.block_size), generator=gen,
                     device=cuda).to(torch.bfloat16)
    for xb in (_edge_blocks(fmt).to(cuda), bf):
        kp, km = nq.nxfp_quantize_pack(xb, fmt, table=True)
        pp, pm = nq.nxfp_quantize_pack_plain(xb, fmt, table=True)
        diff = (kp != pp).any(-1) | (meta_int32(km) != meta_int32(pm))
        if diff.any():
            assert near_tie_blocks(xb[diff].float(), fmt,
                                   table=True).all(), int(diff.sum())
    arith = nq.nxfp_quantize_pack(bf, fmt)
    print(f"{fname}: table rules bitwise; the arithmetic encoder differs "
          f"on {int((arith[0] != kp).any(-1).sum())} of {bf.shape[0]} "
          "bf16 blocks")


@pytest.mark.parametrize("fname", ["nxfp4", "mxfp4", "bfp4"])
def test_kv_sim_route_is_the_plain_codec_on_card(cuda, fname):
    """``fake_quant_rows`` on a CUDA tensor (the quantizer kernel under the
    table-driven rules, then the QTensor's decode) against the plain
    codec's ``fake_quant`` on the same tensor: bitwise but for counted
    candidate near-tie blocks (the quantizer's own contract), bf16 K rows
    of Llama-3-8B's heads. Formats without code recycling (mxfp4, bfp4:
    Fig. 9's weights+KV points) run the kernel's KIND_TAB instances (they
    raised until the kernel had them)."""
    from repro_torch.core.quantize import fake_quant
    from repro_torch.kernels import nxfp_quantize as nqk
    from repro_torch.kernels.ops import fake_quant_rows
    fmt = get_format(fname)
    gen = torch.Generator(device=cuda).manual_seed(31)
    k = torch.randn((4, 128, 8, 128), generator=gen, device=cuda).to(
        torch.bfloat16)
    nqk.LAUNCHES = 0
    got = fake_quant_rows(k, fname)
    assert nqk.LAUNCHES == 1 and got.dtype == k.dtype
    ne = (got != fake_quant(k, fname, axis=-1)).to(torch.float32)
    diff = to_blocks(ne, 32, -1)[0].reshape(-1, 32).any(-1)
    if diff.any():
        xb, _ = to_blocks(k.float(), 32, -1)
        assert near_tie_blocks(xb.reshape(-1, 32)[diff], fmt,
                               table=True).all()
    print(f"kv_sim route {fname}: {int(diff.sum())} near-tie blocks")


@pytest.mark.parametrize("arch", ["llama_3_2_vision_90b", "whisper_tiny"])
def test_vlm_audio_graph_loop_equals_host_loop(cuda, arch):
    """ServeEngine on a smoke vision or audio model (its memory input on
    the card): the graph device loop's tokens (chunks of 4) bitwise the
    host loop's, and the dense-row instance launched in the loop."""
    from repro_torch.kernels import dense_attention as da
    cfg = get_smoke_config(arch)
    policy = QuantPolicy("nxfp4", "nxfp4")
    params = init_params(cfg, 0, device=cuda, policy=policy)
    eng = ServeEngine(cfg, params, policy, max_len=48, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(32)
    s = cfg.n_vision_tokens or cfg.n_audio_frames
    batch = {"tokens": np.random.default_rng(3).integers(0, cfg.vocab,
                                                         (3, 7)),
             ("vision" if cfg.family == "vlm" else "frames"): torch.randn(
                 (3, s, cfg.d_model), generator=gen, device=cuda)}
    da.LAUNCHES = 0
    dev = eng.generate(batch, max_new=9, loop="device", chunk=4)
    assert da.LAUNCHES > 0
    host = eng.generate(batch, max_new=9, loop="host")
    np.testing.assert_array_equal(dev.tokens, host.tokens)
    assert _graph_loop(eng, 3).replays >= 3


@pytest.mark.parametrize("heads", [(6, 1, 64), (8, 4, 128), (8, 8, 128)],
                         ids=lambda h: "KVH{}-G{}-D{}".format(*h))
def test_prefill_attention_rows_batch_invariant_on_card(cuda, heads):
    """``attend_chunked``'s rows of a B 4 prefill (causal, 128 tokens; and
    without the causal mask over 1500 keys, the audio encoder's and cross
    attention's) bitwise each row attended alone: the tiles' products run
    in calls of a fixed count (``attention._bmm``), whatever the batch."""
    from repro_torch.models import attention
    kvh, g, d = heads
    gen = torch.Generator(device=cuda).manual_seed(34)
    for t, s, causal in ((128, 128, True), (128, 1500, False)):
        q = torch.randn((4, t, kvh, g, d), generator=gen, device=cuda).to(
            torch.bfloat16)
        k, v = (torch.randn((4, s, kvh, d), generator=gen, device=cuda)
                .to(torch.bfloat16) for _ in range(2))
        out = attention.attend_chunked(q, k, v, causal=causal)
        for i in range(4):
            one = attention.attend_chunked(q[i:i + 1], k[i:i + 1],
                                           v[i:i + 1], causal=causal)
            assert torch.equal(one[0], out[i]), (t, s, causal, i)


# ---------------------------------------------------------------------------
# training (A15): the autograd Functions of the batch-invariant routes, the
# out-of-place scan, the gradient cast on the quantizer kernel
# ---------------------------------------------------------------------------

def _grads_of(fn, *inputs, seed=40):
    """(fn(*inputs) with grad off, with grad on, the inputs' gradients of
    a seeded f32 cotangent)."""
    with torch.no_grad():
        off = fn(*inputs)
    live = [x.detach().requires_grad_() for x in inputs]
    on = fn(*live)
    gen = torch.Generator(device=on.device).manual_seed(seed)
    cot = torch.randn(on.shape, generator=gen, device=on.device)
    return off, on.detach(), torch.autograd.grad(on, live, cot), cot


def _assert_close(got, want, rel=1e-6):
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * float(want.float().abs().max()) + 1e-30, err


@pytest.mark.parametrize("m", [5, 16, 200])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_matmul_function_grads_on_card(cuda, m, dtype):
    """``ops._dense_matmul`` under autograd (``_DenseMatmul``: 16-row
    padding or 128-row tiles through ``out=``; the router's f32 route):
    its values with grad on are the bits with grad off, and its gradients
    are plain autograd's of the rounded product (each cast back through
    its rounding)."""
    from repro_torch.kernels import ops
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(41)
    x = torch.randn((m, 96), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn((96, 72), generator=gen, device=cuda)
    off, on, (gx, gw), cot = _grads_of(
        lambda a, b: ops._dense_matmul(a, b, dt), x, w)
    assert torch.equal(off, on)
    xr, wr = (t.detach().requires_grad_() for t in (x, w))
    ref = xr.to(dt).float() @ wr.to(dt).float()
    rx, rw = torch.autograd.grad(ref, (xr, wr), cot)
    _assert_close(gx, rx)
    _assert_close(gw, rw)
    assert gx.dtype == x.dtype and gw.dtype == w.dtype


def test_expert_bmm_and_attention_bmm_grads_on_card(cuda):
    """``ops.expert_bmm`` (``_ExpertBmm``, ``out_dtype`` f32) and the
    attention tiles' ``_bmm`` (``_Bmm``, calls of 64 products, both
    transposes): grad-on values bitwise grad-off, gradients plain
    autograd's."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    gen = torch.Generator(device=cuda).manual_seed(42)
    x = torch.randn((3, 16, 48), generator=gen, device=cuda)
    w = torch.randn((3, 48, 40), generator=gen, device=cuda)
    off, on, (gx, gw), cot = _grads_of(ops.expert_bmm, x, w)
    assert torch.equal(off, on)
    xr, wr = (t.detach().requires_grad_() for t in (x, w))
    rx, rw = torch.autograd.grad(torch.bmm(
        xr.to(torch.bfloat16).float(), wr.to(torch.bfloat16).float()),
        (xr, wr), cot)
    _assert_close(gx, rx)
    _assert_close(gw, rw)
    for trans_b in (False, True):
        a = torch.randn((70, 32, 24), generator=gen, device=cuda)
        b = torch.randn((70, 16, 24) if trans_b else (70, 24, 16),
                        generator=gen, device=cuda)
        off, on, (ga, gb), cot = _grads_of(
            lambda p, q: attention._bmm(p, q, trans_b), a, b)
        assert torch.equal(off, on)
        ar, br = (t.detach().requires_grad_() for t in (a, b))
        ref = torch.bmm(ar, br.transpose(1, 2) if trans_b else br)
        ra, rb = torch.autograd.grad(ref, (ar, br), cot)
        _assert_close(ga, ra)
        _assert_close(gb, rb)


def test_mean_square_and_scan_under_autograd_on_card(cuda):
    """``common.mean_square`` under autograd (fewer rows than its 16-row
    buffer, and more): the grad-off bits, and the plain mean's gradient;
    the selective scan's out-of-place rounds bitwise its in-place ones,
    with plain autograd's gradient of the sequential recurrence."""
    from repro_torch.models import common, ssm
    gen = torch.Generator(device=cuda).manual_seed(43)
    for rows in (3, 40):
        x = torch.randn((rows, 96), generator=gen, device=cuda)
        off, on, (gx,), cot = _grads_of(common.mean_square, x)
        assert torch.equal(off, on)
        xr = x.detach().requires_grad_()
        (rx,) = torch.autograd.grad(torch.mean(xr * xr, -1, keepdim=True),
                                    (xr,), cot)
        _assert_close(gx, rx, 1e-5)
    a = torch.rand((2, 16, 8, 4), generator=gen, device=cuda)
    bx = torch.randn((2, 16, 8, 4), generator=gen, device=cuda)
    ia, ib = ssm._scan_in_chunk(a.clone(), bx.clone())
    la, lb = (t.detach().requires_grad_() for t in (a, bx))
    oa, ob = ssm._scan_in_chunk(la, lb)
    assert torch.equal(oa.detach(), ia) and torch.equal(ob.detach(), ib)
    (g,) = torch.autograd.grad(ob.sum(), (lb,))
    h, want = torch.zeros_like(bx[:, 0]), torch.zeros_like(bx)
    for t in reversed(range(16)):        # d(sum_s h_s)/d bx_t
        h = 1.0 + (a[:, t + 1] * h if t + 1 < 16 else 0.0)
        want[:, t] = h
    _assert_close(g, want, 1e-5)


def test_gradient_cast_on_the_kernel_is_the_plain_codec(cuda):
    """``simulate_compress`` on the card: one quantizer launch a leaf of
    at least 4096 values, and every value the plain codec's on the CPU
    but in counted candidate near-tie blocks."""
    from repro_torch.train import compress
    fmt = get_format("nxfp8")
    rng = np.random.default_rng(44)
    tree = {"pad": rng.standard_normal((64, 200)) * 1e-3,
            "whole": rng.standard_normal((128, 512)),
            "vec": rng.standard_normal((4096,)),
            "small": rng.standard_normal((10, 100))}
    tree = {k: torch.tensor(v.astype(np.float32)) for k, v in tree.items()}
    nq.LAUNCHES = 0
    got = compress.simulate_compress({k: v.to(cuda) for k, v in tree.items()})
    assert nq.LAUNCHES == 3
    want = compress.simulate_compress(tree)
    for k, x in tree.items():
        diff = got[k].cpu() != want[k]
        if not diff.any():
            continue
        n = x.shape[-1]
        xb, _ = to_blocks(x, fmt.block_size, -1)
        bad = _diff_blocks(diff, n, fmt.block_size)
        assert near_tie_blocks(xb[bad], fmt).all(), (k, int(bad.sum()))


def _diff_blocks(diff, n, bs):
    """(..., n) bool -> (..., nb) bool: the blocks holding a True."""
    pad = (-n) % bs
    d = torch.nn.functional.pad(diff, (0, pad)) if pad else diff
    return d.reshape(*d.shape[:-1], -1, bs).any(-1)


def test_train_step_on_card_matches_cpu(cuda):
    """One train step of the smoke Llama (2 microbatches, the NxFP8 cast)
    on the card and on the CPU from the same weights: the loss within
    1e-4 and the new weights within 2 learning rates (a near-0 gradient
    may take the other sign's first update)."""
    from repro_torch.data import SyntheticLM, make_data_iter
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, 0, device="cpu", train=True)
    batch = next(make_data_iter(SyntheticLM(vocab=cfg.vocab), 4, 32))
    out = []
    for dev in ("cpu", cuda):
        opt = AdamW(lr=cosine_schedule(1e-3, 1, 10))
        step, _ = make_train_step(cfg, opt, n_microbatches=2,
                                  grad_compress="nxfp8")
        state, m = step(init_state(tree_map(
            lambda p: p.to(dev, copy=True), params), opt), batch)
        out.append((float(m["loss"]), tree_leaves(state.params)))
    (l_cpu, p_cpu), (l_gpu, p_gpu) = out
    assert abs(l_cpu - l_gpu) <= 1e-4
    for a, b in zip(p_cpu, p_gpu):
        assert float((a - b.cpu()).abs().max()) <= 2e-3


def test_checkpoint_round_trip_on_card(cuda, tmp_path, monkeypatch):
    """A train state and a cast tree on the card through
    ``CheckpointManager`` (async) and back onto the card, bit for bit,
    with the pinned staging buffer cut to 4 KiB so every tensor crosses
    in chunks (a ragged last one)."""
    from repro_torch.checkpoint import CheckpointManager, manager
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.serving.engine import load_params
    from repro_torch.train import init_state
    from repro_torch.tree import tree_leaves
    monkeypatch.setattr(manager, "STAGE_BYTES", 4096)
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, 0, device=cuda, train=True)
    tree = {"state": init_state(params, AdamW(lr=cosine_schedule(1e-3, 1,
                                                                 5))),
            "cast": load_params(params, QuantPolicy("nxfp4", None), cuda),
            "bf16": params["lm_head"].to(torch.bfloat16)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(tree, 1)
    mgr.close()
    back, step = mgr.restore(tree)
    assert step == 1
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        if isinstance(a, torch.Tensor):
            assert b.device == a.device and b.dtype == a.dtype
            assert torch.equal(a, b)
        else:
            assert torch.equal(a.packed, b.packed)
            assert torch.equal(a.meta.to(torch.int32), b.meta.to(torch.int32))


# -- slot-sharded serving: two shards on one card

def _sharded_reqs(cfg, sampled=True):
    from repro_torch.serving import Request
    lens, news = [20, 33, 18, 40, 25, 21], [6, 12, 4, 9, 14, 7]
    return [Request(uid=i, tokens=np.random.default_rng(i).integers(
        0, cfg.vocab, (t,)).astype(np.int32), max_new=m,
        arrival_time=0.0 if i < 3 else 0.05,
        **(dict(temperature=1.3, seed=17) if sampled and i == 1 else {}))
        for i, (t, m) in enumerate(zip(lens, news))]


@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_sharded_streams_on_card(cuda, mode):
    """A 2-shard engine on ``cuda:0`` twice emits the unsharded engine's
    streams bit for bit (4 slots each side: one GEMM regime), a seeded
    sampled request included, every shard replaying its own graphs."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import (ContinuousEngine,
                                     ShardedContinuousEngine)
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, seed=0, device=cuda)
    kw = dict(n_slots=4, max_len=64, chunk=4, prefill_mode=mode)
    if mode == "chunked":
        kw["p_chunk"] = 32
    policy = QuantPolicy("nxfp4", "nxfp4")
    want = {r.uid: r.tokens for r in ContinuousEngine(
        cfg, params, policy, device=cuda, **kw).serve(_sharded_reqs(cfg))}
    eng = ShardedContinuousEngine(cfg, params, policy, make_serving_mesh(
        2, [cuda, cuda]), **kw)
    got = {r.uid: r.tokens for r in eng.serve(_sharded_reqs(cfg))}
    assert got.keys() == want.keys()
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert all(sh._graphs for sh in eng.shards) and eng.replays > 0


def test_sharded_migration_on_card(cuda):
    """A ``shard_down`` at chunk 1 migrates shard 1's live requests onto
    shard 0 through a snapshot and its restore; every stream stays OK and
    bitwise the no-drain unsharded serve's."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import (ContinuousEngine, Fault, FaultPlan,
                                     ShardedContinuousEngine, Status)
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, seed=0, device=cuda)
    kw = dict(n_slots=8, max_len=64, chunk=4)
    policy = QuantPolicy("nxfp4", "nxfp4")
    reqs = _sharded_reqs(cfg, sampled=False)[:4]
    want = {r.uid: r.tokens for r in ContinuousEngine(
        cfg, params, policy, device=cuda, **kw).serve(reqs)}
    eng = ShardedContinuousEngine(cfg, params, policy, make_serving_mesh(
        2, [cuda, cuda]), **kw)
    got = eng.serve(reqs, fault_plan=FaultPlan(
        [Fault(kind="shard_down", chunk=1, shard=1)]))
    assert eng.migrate_seconds
    for r in got:
        assert r.status == Status.OK
        np.testing.assert_array_equal(r.tokens, want[r.uid])


def test_figure_numbers_on_card_match_cpu(cuda):
    """Table 1's and Fig. 12's numbers for the bench model (its seed-0
    f32 init) on the card against the CPU's from the same weights: every
    cast leaf's codes and meta bitwise (the quantizer's table instances
    against the plain ``quantize_blocks``, no near-tie expected on these
    weights), ``quantized_ppl`` within 1e-3 of the ppl (bf16 activations
    summed in other orders) and ``_weight_mse`` within 1e-5 (the same
    codes, f32 sums in other orders)."""
    from repro_torch.core.qtensor import QTensor
    from repro_torch.figures import common
    from repro_torch.figures.fig11_remap_sweep import _weight_mse
    from repro_torch.figures.table1_perplexity import quantized_ppl
    from repro_torch.tree import tree_leaves, tree_map
    cfg = common.BENCH_CFG
    cpu = init_params(cfg, 0, device="cpu", train=True)
    card = tree_map(lambda t: t.to(cuda), cpu)
    for fmt in ("mxfp4", "nxfp4_nm_am", "bfp4_bs128"):
        got = [x for x in tree_leaves(common.cast_tree(card, fmt))
               if isinstance(x, QTensor)]
        want = [x for x in tree_leaves(common.cast_tree(cpu, fmt))
                if isinstance(x, QTensor)]
        assert len(got) == len(want) == 2 * 7
        for g, w in zip(got, want):
            assert torch.equal(g.packed.cpu(), w.packed)
            assert torch.equal(meta_int32(g.meta).cpu(), meta_int32(w.meta))
        pg, pw = quantized_ppl(cfg, card, fmt), quantized_ppl(cfg, cpu, fmt)
        assert abs(pg - pw) <= 1e-3 * pw, (fmt, pg, pw)
        mg, mw = _weight_mse(card, fmt), _weight_mse(cpu, fmt)
        assert abs(mg - mw) <= 1e-5 * mw, (fmt, mg, mw)
