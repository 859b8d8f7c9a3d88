"""The quantized-activation prefill of the torch port against the reference.

The slice: the activation codecs (``asym``: AMXFP per-sign dual scale,
uint32 meta; ``ox``: MX+ block-max outlier mantissa), the quantized x
quantized GEMM and ``prefill(..., act_fmt=...)``. On the CPU the port runs
its plain versions; the reference runs its XLA path, or its Pallas kernels
in interpret mode where a test says so.

* Codec: bitwise (codes, meta words and their dtype, packed bytes, decoded
  f32 as int32 bit patterns). A block whose two best candidate MSEs lie
  within 4 f32 ulps may pick the other candidate (the 32-element mean is
  summed in another order); such blocks are counted, any other mismatch
  fails.
* qq GEMM: both sides sum exact bf16 x bf16 products in f32 in different
  orders: 1e-5 of sum_k |x||w|.
* Smoke model: logits within ``ACT_TOL``. XLA keeps some elementwise
  intermediates in f32 where torch rounds each op to bf16, so a hidden
  value can move by a bf16 ulp; under ``act_fmt`` that ulp can move an
  activation across an amxfp4 level boundary, i.e. by a whole code. The
  largest difference measured here is 6.2e-3 (KV nxfp4 and dense alike)
  on logits of magnitude ~0.5; the bound is 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import pack as jpack
from repro.core.formats import get_format as jget_format
from repro.core.qtensor import QTensor as JQTensor
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.core.qtensor import direct_cast_tree as jdirect_cast_tree
from repro.core.quantize import dequantize_blocks, quantize_blocks_arith
from repro.kernels import ops as jops
from repro.kernels.decode_lib import decode_block_values as jdecode_values
from repro.kernels.nxfp_qq_matmul import nxfp_qq_matmul_pallas
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import quantize as tquant
from repro_torch.core.formats import get_format
from repro_torch.core.pack import pack_codes
from repro_torch.core.qtensor import QTensor, QuantPolicy, direct_cast_tree
from repro_torch.kernels import ops
from repro_torch.kernels.decode_lib import decode_block_values
from repro_torch.kernels.nxfp_attention import dequant_cache
from repro_torch.kernels.nxfp_matmul import dequant_weight_bf16
from repro_torch.kernels.nxfp_qq_matmul import nxfp_qq_matmul_plain
from repro_torch.models import prefill

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

# the formats of tests/test_act_quant.py
ACT_FMTS = ["amxfp4", "amxfp4_nm", "amxfp4_ox", "mxfp4_ox"]
# (activation fmt, weight fmt): the PAIRS of tests/test_qq_matmul.py
PAIRS = [("amxfp4", "nxfp4"), ("amxfp4_ox", "nxfp4"), ("mxfp4_ox", "nxfp4"),
         ("amxfp4", "nxfp6"), ("amxfp4_nm", "nxfp8"), ("mxfp4", "mxfp4")]
ACT_TOL = 2e-2

# the reference codec and cast, jitted once per (shape, format)
jquantize_blocks_arith = jax.jit(quantize_blocks_arith, static_argnums=1)
jdequantize_blocks = jax.jit(dequantize_blocks, static_argnums=2)
_jquantize = jax.jit(jops.quantize_qtensor, static_argnums=(1, 2),
                     static_argnames=("impl",))


def _edge_blocks(n=1025, seed=0):
    """Exponent-spread random blocks plus the rows the activation codecs
    treat specially: zero / -0 / NaN / +-inf / 1e30 / subnormal, blocks of
    one sign (one asym side empty), a block max tied in |x| between the
    two signs (the ox index takes the first), a lone negative max."""
    rng = np.random.default_rng(seed)
    xb = (rng.standard_normal((n, 32))
          * np.exp(rng.normal(0, 4, size=(n, 1)))).astype(np.float32)
    xb[0] = 0.0
    xb[1, :4] = [np.nan, np.inf, -np.inf, 0.0]
    xb[2] = 1e30
    xb[3, ::2] = 0.0
    xb[4] = -0.0
    xb[5] = 1e-40
    xb[6, :8] = [1e-40, -1e-40, 3.0, -2.5, 1e-39, 0.0, -0.0, 7.0]
    xb[7] = np.abs(xb[7])
    xb[8] = -np.abs(xb[8])
    xb[9, 3], xb[9, 9] = -7.0, 7.0
    xb[10, 20] = -1e4
    xb[11] = -1e30
    return xb


@pytest.mark.parametrize("fname", ACT_FMTS)
def test_act_codec_bitwise(fname):
    """quantize_blocks_arith / pack / dequantize_blocks / the plain
    decode_lib against the reference, bit for bit."""
    fmt, jfmt = get_format(fname), jget_format(fname)
    xb = _edge_blocks()
    jc, jm = (np.array(a) for a in jquantize_blocks_arith(jnp.asarray(xb),
                                                          jfmt))
    tc, tm = tquant.quantize_blocks_arith(torch.from_numpy(xb), fmt)
    tc, tm = tc.numpy(), tm.numpy()
    assert tm.dtype == jm.dtype == np.dtype(fmt.meta_dtype)
    assert tc.dtype == np.uint8
    diff = (jc != tc).any(-1) | (jm != tm)
    if diff.any():
        ties = tquant.near_tie_blocks(torch.from_numpy(xb[diff]), fmt).numpy()
        assert ties.all(), f"{int((~ties).sum())} blocks differ beyond a tie"
    print(f"{fname}: {int(diff.sum())} near-tie blocks of {len(xb)}")
    same = ~diff
    jp = np.array(jpack.pack_codes(jnp.asarray(jc), fmt.bits))
    tp = pack_codes(torch.from_numpy(tc), fmt.bits).numpy()
    np.testing.assert_array_equal(jp[same], tp[same])
    # decode of the reference's codes: the table-driven dequantize and the
    # arithmetic decode_lib, both as f32 bit patterns
    jd = np.asarray(jdequantize_blocks(jnp.asarray(jc), jnp.asarray(jm), jfmt))
    args = (torch.from_numpy(jc), tensor_from_numpy(jm), fmt)
    np.testing.assert_array_equal(
        jd.view(np.int32),
        tquant.dequantize_blocks(*args).numpy().view(np.int32))
    jv = np.asarray(jdecode_values(jnp.asarray(jc, jnp.int32),
                                   jnp.asarray(jm).astype(jnp.int32), jfmt))
    np.testing.assert_array_equal(
        jv.view(np.int32), decode_block_values(*args).numpy().view(np.int32))


@pytest.mark.parametrize("fname", ACT_FMTS)
@pytest.mark.parametrize("shape", [(48, 96), (2, 7, 64)])
def test_act_quantize_qtensor_matches_pallas(fname, shape):
    """The port's CPU quantize_qtensor vs the reference's fused Pallas
    quantizer (interpret mode): packed bytes, meta (dtype too), aux
    fields, stored bytes and the dequantized tensor."""
    x = (np.random.default_rng(1).standard_normal(shape) * 3).astype(
        np.float32)
    jq = _jquantize(jnp.asarray(x), fname, -1, impl="pallas")
    tq = ops.quantize_qtensor(torch.from_numpy(x), fname, axis=-1,
                              device="cpu")
    np.testing.assert_array_equal(np.asarray(jq.packed), tq.packed.numpy())
    assert np.asarray(jq.meta).dtype == tq.meta.numpy().dtype
    np.testing.assert_array_equal(np.asarray(jq.meta), tq.meta.numpy())
    assert (jq.fmt_name, tuple(jq.shape), jq.axis, jq.orig_len) == \
        (tq.fmt_name, tq.shape, tq.axis, tq.orig_len)
    assert jq.nbytes() == tq.nbytes()
    np.testing.assert_array_equal(
        np.asarray(jq.dequantize(jnp.float32)),
        tq.dequantize(torch.float32).numpy())


def _port_qtensor(jq) -> QTensor:
    return QTensor(tensor_from_numpy(jq.packed), tensor_from_numpy(jq.meta),
                   jq.fmt_name, tuple(jq.shape), jq.axis, jq.orig_len)


def _quantize_pair(m, k, n, xf, wf, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    xq = _jquantize(jnp.asarray(x), xf, -1, impl="xla")
    wq = JQTensor.quantize(jnp.asarray(w), jget_format(wf), axis=0)
    return x, w, xq, wq


@pytest.mark.parametrize("xf,wf", PAIRS)
@pytest.mark.parametrize("mkn", [(32, 256, 128), (17, 128, 64)])
def test_qq_plain_matches_pallas(xf, wf, mkn):
    """nxfp_qq_matmul_plain vs nxfp_qq_matmul_pallas (interpret mode) on
    the reference's own packed operands: 1e-5 of sum|x||w|."""
    m, k, n = mkn
    _, _, xq, wq = _quantize_pair(m, k, n, xf, wf)
    yj = np.asarray(nxfp_qq_matmul_pallas(
        xq.packed, xq.meta, wq.packed, wq.meta, xq.fmt, wq.fmt, tile_m=32,
        tile_n=64, tile_k=128, interpret=True))
    tx, tw = _port_qtensor(xq), _port_qtensor(wq)
    yt = nxfp_qq_matmul_plain(tx.packed, tx.meta, tw.packed, tw.meta,
                              tx.fmt, tw.fmt).numpy()
    assert yt.shape == yj.shape == (m, n)
    xd = dequant_weight_bf16(tx.packed, tx.meta, tx.fmt).float()
    wd = dequant_weight_bf16(tw.packed, tw.meta, tw.fmt).float()
    mag = (xd.abs() @ wd.abs().T).numpy()
    assert (np.abs(yt - yj) <= 1e-5 * mag).all()


@pytest.mark.parametrize("fname", ["amxfp4", "amxfp4_ox", "mxfp4_ox"])
def test_qq_decode_tile_bitwise(fname):
    """The bf16 activation tile the qq GEMM multiplies (the reference's
    ``_decode_tile``: decode_block_values, then bf16), bit for bit, on an
    operand with outliers, one-signed rows and all-zero rows."""
    x = np.random.default_rng(3).standard_normal((24, 96)).astype(np.float32)
    x[1] = 0.0
    x[2] = -np.abs(x[2])
    x[3, 5] = 40.0
    jq = _jquantize(jnp.asarray(x), fname, -1, impl="xla")
    fmt = jq.fmt
    codes = jpack.unpack_codes(jq.packed, fmt.bits, fmt.block_size)
    ref = jdecode_values(codes.astype(jnp.int32),
                         jq.meta.astype(jnp.int32), fmt)
    ref = np.asarray(ref.reshape(ref.shape[0], -1).astype(jnp.bfloat16))
    tq = _port_qtensor(jq)
    got = dequant_weight_bf16(tq.packed, tq.meta, tq.fmt)
    np.testing.assert_array_equal(ref.view(np.uint16),
                                  got.view(torch.int16).numpy().view(np.uint16))


def test_qmatmul_qtensor_activation_dispatch():
    """ops.qmatmul with a QTensor activation: a quantized weight takes the
    qq path (leading dims flattened and restored, a K of 3 blocks); a
    dense weight decodes the activation once and takes the dense product;
    an activation quantized along another axis is refused."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) * 0.05).astype(np.float32)
    xq = ops.quantize_qtensor(torch.from_numpy(x), "amxfp4", axis=-1,
                              device="cpu")
    wq = ops.quantize_qtensor(torch.from_numpy(w), "nxfp6", axis=-2,
                              device="cpu")
    got = ops.qmatmul(xq, wq)
    assert got.shape == (2, 5, 40)
    flat = nxfp_qq_matmul_plain(xq.packed.reshape(10, 3, -1),
                                xq.meta.reshape(10, 3), wq.packed, wq.meta,
                                xq.fmt, wq.fmt)
    np.testing.assert_array_equal(got.reshape(10, 40).numpy(), flat.numpy())
    jx = _jquantize(jnp.asarray(x), "amxfp4", -1, impl="xla")
    jw = JQTensor.quantize(jnp.asarray(w), jget_format("nxfp6"), axis=0)
    ref = np.asarray(jops.qmatmul(jx, jw, impl="xla"))
    wd = dequant_weight_bf16(wq.packed, wq.meta, wq.fmt).float()
    xd = xq.dequantize(torch.bfloat16).float().reshape(10, 96)
    mag = (xd.abs() @ wd.abs().T).reshape(2, 5, 40).numpy()
    assert (np.abs(got.numpy() - ref) <= 1e-5 * mag).all()
    dense = ops.qmatmul(xq, torch.from_numpy(w))
    via = ops.qmatmul(xq.dequantize(torch.bfloat16), torch.from_numpy(w))
    np.testing.assert_array_equal(dense.numpy(), via.numpy())
    wrong = ops.quantize_qtensor(torch.from_numpy(x), "amxfp4", axis=-2,
                                 device="cpu")
    with pytest.raises(ValueError):
        ops.qmatmul(wrong, wq)


@pytest.mark.parametrize("fname,hd", [("mxfp4_ox", 64), ("mxfp4_ox", 16),
                                      ("amxfp4", 32)])
def test_decode_attention_plain_ox_asym_matches_pallas(fname, hd):
    """Plain decode attention over an ox (uint16 meta) or asym (uint32
    meta) cache vs the reference's Pallas kernel in interpret mode:
    1e-5 of max|V| (f32 throughout, sums in another order)."""
    rng = np.random.default_rng(hd)
    b, s, kvh, g = 3, 32, 2, 2
    q = rng.standard_normal((b, kvh * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    k[0, 3, 1, 2] = 30.0                      # an ox outlier in one block
    lengths = np.array([32, 9, 1], np.int32)
    jk = _jquantize(jnp.asarray(k), fname, -1, impl="xla")
    jv = _jquantize(jnp.asarray(v), fname, -1, impl="xla")
    oj = np.asarray(jops.decode_attention(jnp.asarray(q), jk, jv,
                                          jnp.asarray(lengths), kvh,
                                          impl="pallas"))
    tk, tv = _port_qtensor(jk), _port_qtensor(jv)
    ot = ops.decode_attention(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(lengths), kvh).numpy()
    assert ot.shape == oj.shape == (b, kvh * g, hd)
    vmax = float(dequant_cache(tv.packed, tv.meta, tv.fmt).abs().max())
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-5 * vmax)


# -- the smoke Llama ---------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """Both packages' smoke Llama from the reference's PRNGKey(0)
    parameters, direct-cast to nxfp4 by each package's own cast."""
    jcfg = jget_smoke_config("llama3_8b")
    cfg = get_smoke_config("llama3_8b")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jq = jdirect_cast_tree(jparams, JQuantPolicy("nxfp4", "nxfp4"),
                           quantize_fn=_jquantize)
    tq = direct_cast_tree(tparams, QuantPolicy("nxfp4", "nxfp4"),
                          quantize_fn=lambda leaf, fmt, axis:
                          ops.quantize_qtensor(leaf, fmt, axis,
                                               device="cpu"))
    return jcfg, cfg, jq, tq


def _tokens(cfg, b=2, t=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (b, t)).astype(np.int32)


@pytest.mark.parametrize("kv", ["nxfp4", None])
def test_act_prefill_matches_reference(smoke, kv):
    """prefill(..., act_fmt="amxfp4") with nxfp4 weights: last logits
    within ACT_TOL of the reference's, cache leaves of its layout."""
    jcfg, cfg, jq, tq = smoke
    toks = _tokens(cfg)
    jl, jc = jax.jit(lambda p, b: jprefill(jcfg, p, b, max_len=32,
                                           kv_fmt=kv, act_fmt="amxfp4"))(
        jq, {"tokens": jnp.asarray(toks)})
    tl, tc = prefill(cfg, tq, {"tokens": torch.from_numpy(toks).long()},
                     max_len=32, kv_fmt=kv, act_fmt="amxfp4")
    err = float(np.abs(tl.numpy() - np.asarray(jl)).max())
    print(f"kv={kv}: max |logit diff| {err:.3g} (tolerance {ACT_TOL})")
    assert err <= ACT_TOL
    for i, lc in enumerate(tc["layers"]):
        for name, buf in lc.items():
            assert tuple(buf.shape) == jc["layers"][name][i].shape


def test_act_prefill_near_dense_and_deterministic(smoke):
    """The port's act prefill stays within 0.10 of its dense-activation
    prefill, relative to the largest |logit| (the bound of
    tests/test_tiers.py), and a second run gives the same bits."""
    _, cfg, _, tq = smoke
    batch = {"tokens": torch.from_numpy(_tokens(cfg, b=1, t=24)).long()}
    ref, _ = prefill(cfg, tq, batch, 32, None)
    got, _ = prefill(cfg, tq, batch, 32, None, act_fmt="amxfp4")
    rel = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert rel < 0.10, rel
    got2, _ = prefill(cfg, tq, batch, 32, None, act_fmt="amxfp4")
    np.testing.assert_array_equal(got.numpy(), got2.numpy())


def test_params_from_jax_carries_uint32_meta():
    """A reference QTensor leaf with uint32 (asym) meta crosses into the
    port bit for bit, split on the stacked layer axis."""
    x = np.random.default_rng(7).standard_normal((3, 8, 64)).astype(
        np.float32)
    jq = _jquantize(jnp.asarray(x), "amxfp4_ox", -1, impl="xla")
    tree = {"tok_embed": np.ones((4, 2), np.float32),
            "layers": {"wq": jax.tree.map(np.asarray, jq)}}
    out = params_from_jax(tree, device="cpu")
    for i, layer in enumerate(out["layers"]):
        leaf = layer["wq"]
        assert isinstance(leaf, QTensor) and leaf.meta.dtype == torch.uint32
        np.testing.assert_array_equal(np.asarray(jq.meta)[i],
                                      leaf.meta.numpy())
        np.testing.assert_array_equal(np.asarray(jq.packed)[i],
                                      leaf.packed.numpy())
        np.testing.assert_array_equal(
            np.asarray(jq.dequantize(jnp.float32))[i],
            leaf.dequantize(torch.float32).numpy())


def test_act_deviation_matches_reference_at_width():
    """At a wider width (d 1024, d_ff 3584, head_dim 128, one layer) the
    logits cannot be compared to a tolerance: XLA's and torch's SiLU differ
    in the last f32 ulps, a few gated hidden values round to another bf16,
    and each such value can take another amxfp4 code. What must agree is
    how far the act prefill lies from the dense-activation prefill on the
    same nxfp4 weights. Measured: reference 0.318, port 0.326 of the
    largest |logit|; held to within 0.05 of each other."""
    import dataclasses
    over = dict(d_model=1024, d_ff=3584, n_heads=8, n_kv_heads=2,
                n_layers=1, vocab=4096, head_dim=128)
    jcfg = dataclasses.replace(jget_smoke_config("llama3_8b"), **over)
    cfg = dataclasses.replace(get_smoke_config("llama3_8b"), **over)
    jq = jdirect_cast_tree(jinit_params(jcfg, jax.random.PRNGKey(0)),
                           JQuantPolicy("nxfp4", "nxfp4"),
                           quantize_fn=_jquantize)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    toks = np.random.default_rng(0).integers(0, 4096, (2, 64)).astype(
        np.int32)
    jfn = jax.jit(lambda p, b, a: jprefill(jcfg, p, b, 128, "nxfp4",
                                           act_fmt=a), static_argnums=2)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks).long()}

    def rel(a, d):
        return float(np.abs(a - d).max() / np.abs(d).max())

    ref = rel(np.asarray(jfn(jq, jb, "amxfp4")[0]),
              np.asarray(jfn(jq, jb, None)[0]))
    got = rel(prefill(cfg, tq, tb, 128, "nxfp4", act_fmt="amxfp4")[0].numpy(),
              prefill(cfg, tq, tb, 128, "nxfp4")[0].numpy())
    print(f"act vs dense-act prefill: reference {ref:.4f}, port {got:.4f}")
    assert abs(got - ref) <= 0.05
