"""The port's plain kernel versions against the reference's Pallas kernels.

The JAX kernels run in interpret mode on the CPU (``impl="pallas"``), as
the reference's own tests run them. Both sides are fed the same packed
bytes: the reference casts, and the bytes carry across through
``convert.tensor_from_numpy``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import dequantize_blocks as jdequantize_blocks
from repro.core.pack import unpack_codes as junpack_codes
from repro.kernels import ops as jops
from repro_torch.convert import tensor_from_numpy
from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import ops
from repro_torch.kernels.nxfp_matmul import dequant_weight_bf16

import _torch_helpers  # noqa: F401  (one intra-op thread a process)


# the reference's cast, jitted once per (shape, format) instead of op by op
_jquantize = jax.jit(jops.quantize_qtensor, static_argnums=(1, 2),
                     static_argnames=("impl",))


def _port_qtensor(jq) -> QTensor:
    return QTensor(tensor_from_numpy(jq.packed), tensor_from_numpy(jq.meta),
                   jq.fmt_name, tuple(jq.shape), jq.axis, jq.orig_len)


@pytest.mark.parametrize("fname", ["nxfp4", "nxfp4_nm_am", "mxfp4_cr",
                                   "nxfp6", "nxfp8", "nxfp4_bs16"])
def test_dequant_weight_tile_bitwise(fname):
    """The bf16 weight tile the GEMM multiplies: the reference's f32
    decode rounded to bf16 (``_decode_tile``), bit for bit."""
    w = np.random.default_rng(2).standard_normal((96, 40)).astype(np.float32)
    jq = _jquantize(jnp.asarray(w), fname, -2, impl="xla")
    fmt = jq.fmt
    ref = jdequantize_blocks(junpack_codes(jq.packed, fmt.bits,
                                           fmt.block_size), jq.meta, fmt)
    ref = np.asarray(ref.reshape(ref.shape[0], -1).astype(jnp.bfloat16))
    tq = _port_qtensor(jq)
    got = dequant_weight_bf16(tq.packed, tq.meta, tq.fmt)
    np.testing.assert_array_equal(ref.view(np.uint16),
                                  got.view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("fname,m,k,n", [
    ("nxfp4", 5, 256, 64),
    ("nxfp4", 1, 80, 24),          # K padded from 80 to 96
    ("nxfp6", 7, 128, 32),
])
def test_qmatmul_plain_matches_pallas(fname, m, k, n):
    """Both sides sum exact bf16 x bf16 products in f32, in different
    orders: |diff| <= 1e-5 * sum_k |x||w| (f32 accumulation order)."""
    rng = np.random.default_rng(m * k)
    x = rng.standard_normal((3, m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jq = _jquantize(jnp.asarray(w), fname, -2, impl="xla")
    yj = np.asarray(jops.qmatmul(jnp.asarray(x), jq, impl="pallas"))
    tq = _port_qtensor(jq)
    yt = ops.qmatmul(torch.from_numpy(x), tq).numpy()
    assert yt.shape == yj.shape == (3, m, n)
    wd = dequant_weight_bf16(tq.packed, tq.meta, tq.fmt).float()[:, :k]
    mag = (torch.from_numpy(x).to(torch.bfloat16).float().abs()
           @ wd.abs().T).numpy()
    assert (np.abs(yt - yj) <= 1e-5 * mag).all()


@pytest.mark.parametrize("fname,hd", [("nxfp4", 16), ("nxfp4", 128),
                                      ("nxfp6", 64)])
def test_decode_attention_plain_matches_pallas(fname, hd):
    """Ragged lengths; head_dim 16 exercises the q padding to one 32-value
    block. f32 throughout on both sides; exp and the dots differ in the
    last ulps and in summation order: 1e-5 of max|V| (absolute)."""
    rng = np.random.default_rng(hd)
    b, s, kvh, g = 3, 32, 2, 2
    q = rng.standard_normal((b, kvh * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    lengths = np.array([32, 9, 1], np.int32)
    jk = _jquantize(jnp.asarray(k), fname, -1, impl="xla")
    jv = _jquantize(jnp.asarray(v), fname, -1, impl="xla")
    oj = np.asarray(jops.decode_attention(jnp.asarray(q), jk, jv,
                                          jnp.asarray(lengths), kvh,
                                          impl="pallas"))
    ot = ops.decode_attention(torch.from_numpy(q), _port_qtensor(jk),
                              _port_qtensor(jv), torch.from_numpy(lengths),
                              kvh).numpy()
    assert ot.shape == oj.shape == (b, kvh * g, hd)
    vmax = np.abs(np.asarray(jv.dequantize(jnp.float32))).max()
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-5 * vmax)


# the dequant GEMM's (K, N) pairs on the Llama-3-8B main path: wq/wo,
# wk/wv, w1/w3, w2
MAIN_PATH_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
# the decode kernel's geometry as csrc/nxfp_matmul_decode.cu reports it
# (test_torch_gpu.py checks the built library against these numbers)
DECODE_GEOMETRY = (16, 64, 65536)


@pytest.mark.parametrize("k,n", MAIN_PATH_KN)
@pytest.mark.parametrize("m", [1, 4, 16, 17, 512])
def test_decode_split_covers_k_once(k, n, m):
    """The decode regime's split-K plan (M <= 16): every split holds at
    least one K block, the splits cover K exactly once, the x slice a CTA
    stages fits its shared memory, and the grid fills 132 SMs. Above 16
    rows the prefill regime runs and there is no split to plan."""
    from repro_torch.kernels import nxfp_matmul as nm
    geom = nm.DecodeGeometry(*DECODE_GEOMETRY)
    kb = k // 32
    if m > geom.max_m:
        with pytest.raises(ValueError):
            nm.decode_split(m, n, kb, 32, geom)
        return
    n_tiles, splits, chunk = nm.decode_split(m, n, kb, 32, geom, n_sm=132)
    assert n_tiles == -(-n // geom.tile_n)
    assert chunk % 4 == 0 and chunk >= 4
    ranges = [(s * chunk, min(kb, (s + 1) * chunk)) for s in range(splits)]
    assert all(hi > lo for lo, hi in ranges)             # no empty split
    covered = [b for lo, hi in ranges for b in range(lo, hi)]
    assert covered == list(range(kb))                    # each block once
    assert m * chunk * 32 * 2 <= geom.x_slice_bytes
    assert n_tiles * splits >= 132


def _weight_kn(cfg, head=True):
    """Every (K, N) a config's layers put through the GEMM (an MoE layer's
    experts and shared MLP included), and with ``head`` its head's (a
    dense bf16 product unless a policy casts it)."""
    d, hd, h, kvh = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    di, n, dr = cfg.dinner, cfg.ssm_state, cfg.dtrank
    attn = [(d, h * hd), (d, kvh * hd), (h * hd, d), (d, cfg.d_ff),
            (cfg.d_ff, d)]
    mamba = [(d, 2 * di), (di, dr + 2 * n), (dr, di), (di, d)]
    shared = ([(d, cfg.shared_d_ff), (cfg.shared_d_ff, d)]
              if cfg.shared_d_ff else [])
    # the vision family's cross layers and the audio decoder's cross
    # attention run the attention's (K, N) pairs again
    kn = {"dense": attn, "ssm": mamba, "hybrid": attn + mamba,
          "moe": attn + shared, "vlm": attn, "audio": attn}[cfg.family]
    return kn + [(d, cfg.vocab)] if head else kn


# the configs the engines serve on the card (chip_smoke.py); the other two
# (deepseek_67b, llama3_405b) do not fit one
SERVED = ("llama3_8b", "llama2_7b", "starcoder2_3b", "h2o_danube_3_4b",
          "falcon_mamba_7b", "hymba_1_5b")


@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
def test_decode_split_plan_independent_of_m(bs):
    """The decode regime's plan is one plan for m = 1 .. 16 at every
    weight of every config: a row's f32 sums then run in one order
    whatever the batch (a 16-slot engine's row, or a speculative verify's
    16-row group, equals the row served alone)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels import nxfp_matmul as nm
    geom = nm.DecodeGeometry(*DECODE_GEOMETRY)
    for arch in ARCH_IDS:
        for k, n in _weight_kn(get_config(arch)):
            kb = -(-k // bs)
            plans = {nm.decode_split(m, n, kb, bs, geom, n_sm=132)
                     for m in range(1, geom.max_m + 1)}
            assert len(plans) == 1, (arch, k, n, bs, plans)


def test_decode_split_keeps_the_served_m4_plans():
    """Capping the x slice for 16 rows cut no served shape's chunk: each
    nxfp4 (bs 32) weight the default policy casts in the served configs
    (the layers' weights; the head stays bf16) keeps the plan it had at
    M 4 when the cap followed m (an x slice of 32768 bytes for m rows,
    the cap of 128 blocks at M 4 that a 16-row geometry of 131072 bytes
    reproduces)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import nxfp_matmul as nm
    geom = nm.DecodeGeometry(*DECODE_GEOMETRY)
    old_m4 = nm.DecodeGeometry(16, 64, 32768 * 16 // 4)
    for arch in SERVED:
        for k, n in _weight_kn(get_config(arch), head=False):
            kb = -(-k // 32)
            assert nm.decode_split(4, n, kb, 32, geom) == \
                nm.decode_split(4, n, kb, 32, old_m4), (arch, k, n)


@pytest.mark.parametrize("kb,n,bs", [(130, 72, 32), (1, 8, 32), (2, 200, 16),
                                     (896, 4096, 16), (3, 100000, 32)])
@pytest.mark.parametrize("m", [1, 16])
def test_decode_split_ragged_shapes(kb, n, bs, m):
    """Ragged and extreme shapes keep the same invariants: a last split
    shorter than the rest, a single block, a wide N with one split."""
    from repro_torch.kernels import nxfp_matmul as nm
    geom = nm.DecodeGeometry(*DECODE_GEOMETRY)
    _, splits, chunk = nm.decode_split(m, n, kb, bs, geom)
    assert (splits - 1) * chunk < kb <= splits * chunk
    assert chunk % 4 == 0 and m * chunk * bs * 2 <= geom.x_slice_bytes
