"""The rest of the port's codec against the JAX reference, on the CPU.

``quantize``/``dequantize``/``fake_quant``/``quantize_blocks_gatherfree``
(``core/quantize.py``), ``pack_tile``/``pack_layout``/``byte_fold``
(``core/pack.py``) and ``dense_like`` (``core/qtensor.py``), bitwise. As in
``tests/test_torch_codec.py`` the one allowed difference is a block whose
two best candidate MSEs lie within 4 f32 ulps (the 32-element mean is
summed in another order by XLA and torch): such blocks are counted and
skipped, any other mismatch fails.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import formats as jformats
from repro.core import pack as jpack
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.core.qtensor import dense_like as jdense_like
from repro.core.qtensor import direct_cast_tree as jdirect_cast_tree
from repro.models import init_params as jinit_params
from repro_torch.convert import params_from_jax
from repro_torch.core import formats as tformats
from repro_torch.core import pack as tpack
from repro_torch.core import quantize as tquant
from repro_torch.core.qtensor import QTensor, dense_like

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

# the module (``repro.core`` exports a function of the same name)
jquant = importlib.import_module("repro.core.quantize")

# the format registry of tests/test_fused_quantize.py and the activation
# formats
FMTS = ["bfp4", "bfp4_cr", "mxfp4", "mxfp4_cr", "nxfp4", "nxfp4_nm",
        "nxfp4_nm_am", "nxfp4_bs16", "nxfp8", "mxfp8", "bfp8", "mxfp3",
        "nxfp5", "mxfp5", "nxfp6", "mxfp6", "mxfp6_e3m2", "amxfp4",
        "amxfp4_ox", "mxfp4_ox"]



@functools.lru_cache(maxsize=None)
def _jref(fname, axis, bf16):
    """The reference's quantize, decode of its codes, fake_quant and
    gather-free encode of x along ``axis``, as one compiled program."""
    fmt = jformats.get_format(fname)

    def run(x):
        x = x.astype(jnp.bfloat16) if bf16 else x
        codes, meta, n = jquant.quantize(x, fmt, axis)
        deq = jquant.dequantize(codes, meta, fmt, n, axis)
        fake = jquant.fake_quant(x, fmt, axis).astype(jnp.float32)
        xb, _ = jquant.to_blocks(x, fmt.block_size, axis)
        gf = jquant.quantize_blocks_gatherfree(xb, fmt)
        return codes, meta, deq, fake, gf

    return jax.jit(run)


def _edge_tensor(fmt, rows=96, seed=0):
    """(rows, 3 blocks - 5) values: exponent-spread random rows plus zero,
    NaN/+-inf, 1e30, half-zero, -0 and subnormal rows; the last block of a
    row is zero-padded by the blocking."""
    rng = np.random.default_rng(seed)
    n = 3 * fmt.block_size - 5
    x = (rng.standard_normal((rows, n))
         * np.exp(rng.normal(0, 4, size=(rows, 1)))).astype(np.float32)
    x[0] = 0.0
    x[1, :4] = [np.nan, np.inf, -np.inf, 0.0]
    x[2] = 1e30
    x[3, ::2] = 0.0
    x[4] = -0.0
    x[5] = 1e-40
    x[6, :8] = [1e-40, -1e-40, 3.0, -2.5, 1e-39, 0.0, -0.0, 7.0]
    return x


def _tie_mask(x, fmt, axis):
    """(..., nb) bool: blocks of x (blocked along ``axis``) whose best two
    candidates lie within 4 ulps."""
    xb, _ = tquant.to_blocks(torch.from_numpy(x), fmt.block_size, axis)
    return tquant.near_tie_blocks(xb, fmt).numpy()


def _check_codes(jc, jm, tc, tm, x, fmt, axis):
    """Codes and meta equal but on near-tie blocks; returns the mask of
    blocks that agree."""
    jc, jm = np.asarray(jc), np.asarray(jm)
    tc, tm = tc.numpy(), tm.numpy()
    assert tc.dtype == jc.dtype and tm.dtype == jm.dtype
    diff = (jc != tc).any(-1) | (jm != tm)
    if diff.any():
        assert _tie_mask(x, fmt, axis)[diff].all(), \
            f"{int(diff.sum())} blocks differ, not all near ties"
    return ~diff


def _round_trip(x, fname, axis=-1, bf16=False):
    """``quantize``, ``dequantize``, ``fake_quant`` and
    ``quantize_blocks_gatherfree`` of x along ``axis`` (bf16 input with
    ``bf16``) against the reference's."""
    fmt = tformats.get_format(fname)
    jc, jm, jd, jf, gc, gm = (np.array(a) for a in jax.tree.leaves(
        _jref(fname, axis, bf16)(jnp.asarray(x))))
    tx = torch.from_numpy(x)
    tx = tx.to(torch.bfloat16) if bf16 else tx
    tc, tm, tn = tquant.quantize(tx, fmt, axis)
    assert tn == x.shape[axis]
    same = _check_codes(jc, jm, tc, tm, x, fmt, axis)
    # decode of the reference's codes: bitwise f32, original layout
    td = tquant.dequantize(torch.from_numpy(jc), torch.from_numpy(jm), fmt,
                           tn, axis).numpy()
    assert td.shape == x.shape
    np.testing.assert_array_equal(jd.view(np.int32), td.view(np.int32))
    # the round trip in the input's dtype, on the blocks both encoders
    # agree on
    tf = tquant.fake_quant(tx, fname, axis)
    assert tf.dtype == tx.dtype
    ok = np.moveaxis(np.repeat(same, fmt.block_size, -1)[
        ..., :x.shape[axis]], -1, axis)
    np.testing.assert_array_equal(jf.view(np.int32)[ok],
                                  tf.float().numpy().view(np.int32)[ok])
    # the gather-free encoder: symmetric scales only, as the reference's
    xb, _ = tquant.to_blocks(tx, fmt.block_size, axis)
    tgc, tgm = tquant.quantize_blocks_gatherfree(xb, fmt)
    assert tgm.dtype == torch.uint16
    diff = (gc != tgc.numpy()).any(-1) | (gm != tgm.numpy())
    if diff.any():
        sym = dataclasses.replace(fmt, asym=False, ox=False)
        assert tquant.near_tie_blocks(xb[torch.from_numpy(diff)],
                                      sym).numpy().all()
    if not (fmt.asym or fmt.ox):
        # bit-identical to the table-driven encoder, as in the reference
        np.testing.assert_array_equal(tgc.numpy(), tc.numpy())
        np.testing.assert_array_equal(tgm.numpy(), tm.numpy())


@pytest.mark.parametrize("fname", FMTS)
def test_quantize_dequantize_fake_quant_gatherfree_bitwise(fname):
    _round_trip(_edge_tensor(tformats.get_format(fname)), fname)


@pytest.mark.parametrize("fname,axis,bf16", [
    ("nxfp4", 0, False), ("amxfp4_ox", 0, False), ("nxfp4", -1, True),
    ("amxfp4", -1, True)])
def test_quantize_round_trip_other_axis_and_bf16(fname, axis, bf16):
    x = _edge_tensor(tformats.get_format(fname), seed=2)
    if axis == 0:
        x = np.ascontiguousarray(x.T)
    _round_trip(x, fname, axis, bf16)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("block_size", [8, 16, 32, 64, 128])
def test_pack_tile_and_layout_match_reference(bits, block_size):
    assert tpack.pack_tile(bits, block_size) == \
        jpack.pack_tile(bits, block_size)
    assert tpack.pack_tile(bits) == jpack.pack_tile(bits)
    got, ref = tpack.pack_layout(block_size, bits), \
        jpack.pack_layout(block_size, bits)
    assert got[3] == ref[3]
    for g, r in zip(got[:3], ref[:3]):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    # the pack reads the layout: the reference's bytes
    codes = np.random.default_rng(bits * block_size).integers(
        0, 1 << bits, (3, 5, block_size)).astype(np.uint8)
    np.testing.assert_array_equal(
        tpack.pack_codes(torch.from_numpy(codes), bits).numpy(),
        np.asarray(jpack.pack_codes(jnp.asarray(codes), bits)))


@pytest.mark.parametrize("dtype,keep", [
    (np.uint8, 1), (np.uint8, 3), (np.uint16, 2), (np.uint32, 1),
    (np.float32, 2), ("bfloat16", 1)])
def test_byte_fold_matches_reference(dtype, keep):
    rng = np.random.default_rng(7)
    shape = (3, 4, 5, 33)
    if dtype == "bfloat16":
        f = rng.standard_normal(shape).astype(np.float32)
        jx = jnp.asarray(f).astype(jnp.bfloat16)
        tx = torch.from_numpy(f).to(torch.bfloat16)
    elif np.dtype(dtype).kind == "f":
        f = rng.standard_normal(shape).astype(dtype)
        f.flat[0], f.flat[1] = -0.0, np.inf
        jx, tx = jnp.asarray(f), torch.from_numpy(f)
    else:
        top = np.iinfo(dtype).max
        v = rng.integers(0, top, shape, dtype=np.uint64,
                         endpoint=True).astype(dtype)
        v.flat[0] = top
        jx = jnp.asarray(v)
        tx = (torch.from_numpy(v.astype(np.int64)).to(torch.uint32)
              if dtype == np.uint32 else torch.from_numpy(v))
    got = tpack.byte_fold(tx, keep)
    ref = np.asarray(jpack.byte_fold(jx, keep))
    assert got.dtype == torch.uint32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.to(torch.int64).numpy(),
                                  ref.astype(np.int64))


def test_dense_like_on_a_cast_smoke_tree():
    """The reference's cast tree, carried over byte for byte
    (``params_from_jax``), decodes to the reference's bf16 leaves."""
    jcfg = jget_smoke_config("llama3_8b")
    # each step one compiled program
    jparams = jax.jit(jinit_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    jq = jax.jit(lambda p: jdirect_cast_tree(
        p, JQuantPolicy("nxfp4", None)))(jparams)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    jd = jax.jit(jdense_like)(jq)
    td = dense_like(tq)
    n_cast = 0
    for i, layer in enumerate(td["layers"]):
        for name, leaf in layer.items():
            ref = np.asarray(jd["layers"][name][i])
            if isinstance(tq["layers"][i][name], QTensor):
                n_cast += 1
                assert leaf.dtype == torch.bfloat16
                ref = ref.astype(np.float32)
                leaf = leaf.float()
            np.testing.assert_array_equal(ref, leaf.numpy())
    assert n_cast == 7 * jcfg.n_layers
    for name in ("tok_embed", "lm_head", "final_scale"):
        assert td[name] is tq[name]
