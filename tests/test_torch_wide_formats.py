"""The port's codec at every format the reference serves, on the CPU:
3-bit (and 2/7-bit BFP) codes, block sizes 8 to 128, custom recycle
values (``tests/test_torch_wide_kernels.py`` holds the plain kernels).

Held against the reference where it serves each format: its fused Pallas
quantizer in interpret mode where that takes the format
(``impl="pallas"``), its XLA path otherwise (3-bit codes; custom recycle
values, which take the table-driven ``quantize_blocks``). Bitwise, up to
counted candidate near-ties (the block MSE is summed in another order by
XLA and torch).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import levels as jlevels
from repro.core import pack as jpack
from repro.core.quantize import (dequantize_blocks, quantize_blocks,
                                 quantize_blocks_arith)
from repro.kernels import ops as jops
from repro_torch.core import formats as tformats
from repro_torch.core import pack as tpack
from repro_torch.core import quantize as tquant
from repro_torch.kernels import ops
from repro_torch.kernels.decode_lib import decode_block_values

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

jquantize_blocks_arith = jax.jit(quantize_blocks_arith, static_argnums=1)
jquantize_blocks = jax.jit(quantize_blocks, static_argnums=1)
jdequantize_blocks = jax.jit(dequantize_blocks, static_argnums=2)
_jquantize = jax.jit(jops.quantize_qtensor, static_argnums=(1, 2),
                     static_argnames=("impl",))

# 3-bit codes at every block size, bs 8/64/128 of the wider widths, the
# 2/7-bit BFP formats and the activation formats at the new block sizes
WIDE = ["nxfp3", "mxfp3", "bfp3", "nxfp3_bs8", "mxfp3_bs16", "bfp3_bs64",
        "nxfp3_bs128", "nxfp4_bs8", "nxfp4_bs64", "nxfp4_bs128",
        "mxfp4_cr_bs8", "nxfp5_bs64", "mxfp6_bs8", "nxfp6_bs128",
        "nxfp8_bs8", "mxfp8_bs64", "bfp2", "bfp7_bs16", "amxfp3",
        "amxfp4_bs64", "amxfp4_ox_bs8", "mxfp3_ox"]


def _base(name):
    return name.split("@")[0]


def _formats(name, value=None):
    """(reference, port) BlockFormats for ``name``, with a custom recycle
    value when ``value`` is given (named as Fig. 11's sweep names them)."""
    jf, tf = jformats.get_format(name), tformats.get_format(name)
    if value is None:
        return jf, tf
    new = f"{name}@{float(value):.3f}"
    return (dataclasses.replace(jf, recycle=float(value), name=new),
            dataclasses.replace(tf, recycle=float(value), name=new))


def _sweep(elem):
    """Fig. 11's remap targets for an element format
    (``benchmarks/fig11_remap_sweep.py: sweep_points``): -smallest/2 and
    the midpoints between adjacent positive levels."""
    t = jlevels.level_table(elem, cr=False)
    pos = t.values_sorted[t.values_sorted > 0]
    return [-0.5 * t.smallest_pos] + ((pos[1:] + pos[:-1]) / 2).tolist()


# (format, recycled value): Fig. 11's points on its two formats (mxfp4 and
# bfp4, with _cr), and a few on nxfp (two element formats) and 3-bit
RECYCLE = ([("mxfp4_cr", v) for v in _sweep("e2m1")]
           + [("bfp4_cr", v) for v in _sweep("int4")]
           + [("nxfp4", 0.75), ("nxfp4", -0.25), ("nxfp3", 1.5),
              ("nxfp4_bs64", 5.0), ("mxfp8_cr_bs8", 0.0068359375)])


def _edge_blocks(b, n=513, seed=0):
    rng = np.random.default_rng(seed)
    xb = (rng.standard_normal((n, b))
          * np.exp(rng.normal(0, 4, size=(n, 1)))).astype(np.float32)
    xb[0] = 0.0
    xb[1, :4] = [np.nan, np.inf, -np.inf, 0.0]
    xb[2] = 1e30
    xb[3, ::2] = 0.0
    xb[4] = -0.0
    xb[5, :8] = [1e-40, -1e-40, 3.0, -2.5, 1e-39, 0.0, -0.0, 7.0]
    xb[6] = -np.abs(xb[6])
    return xb


def _tie_blocks(tf):
    """Blocks of scale 1 (max = the element's largest level) that hold
    every midpoint between two levels, both signs: exact snap ties."""
    from repro_torch.core.levels import level_table
    rows = []
    for _, el in tf.elem_formats:
        t = level_table(el.name, tf.cr, tf.recycle)
        vals = np.concatenate([t.boundaries, -t.boundaries])
        for i in range(0, len(vals), tf.block_size - 1):
            row = np.zeros(tf.block_size, np.float32)
            row[0] = t.max_pos
            part = vals[i:i + tf.block_size - 1]
            row[1:1 + len(part)] = part
            rows.append(row)
    return np.stack(rows)


def _check_codec(jc, jm, tc, tm, xb, tf):
    """Codes and meta bitwise outside counted near-ties; returns the
    blocks that agree."""
    jc, jm = np.asarray(jc), np.asarray(jm)
    tc, tm = tc.numpy(), tm.numpy()
    diff = (jc != tc).any(-1) | (jm != tm)
    if diff.any():
        ties = tquant.near_tie_blocks(torch.from_numpy(xb[diff]), tf).numpy()
        assert ties.all(), f"{int((~ties).sum())} blocks differ beyond a tie"
    print(f"{tf.name}: {int(diff.sum())} near-tie blocks of {len(xb)}")
    return ~diff


@pytest.mark.parametrize("fname", WIDE)
def test_wide_codec_bitwise(fname):
    """The arithmetic codec (encode, pack, unpack, decode) against the
    reference's at the new widths and block sizes."""
    jf, tf = _formats(fname)
    xb = _edge_blocks(tf.block_size)
    jc, jm = jquantize_blocks_arith(jnp.asarray(xb), jf)
    tc, tm = tquant.quantize_blocks_arith(torch.from_numpy(xb), tf)
    same = _check_codec(jc, jm, tc, tm, xb, tf)
    jc = np.array(jc)
    jp = np.asarray(jpack.pack_codes(jnp.asarray(jc), tf.bits))
    np.testing.assert_array_equal(
        jp[same], tpack.pack_codes(torch.from_numpy(jc), tf.bits)[same])
    np.testing.assert_array_equal(
        tpack.unpack_codes(torch.from_numpy(jp), tf.bits,
                           tf.block_size).numpy(), jc)
    jd = np.asarray(jdequantize_blocks(jnp.asarray(jc), jm, jf))
    td = tquant.dequantize_blocks(torch.from_numpy(jc),
                                  torch.from_numpy(np.asarray(jm)), tf)
    np.testing.assert_array_equal(jd.view(np.int32),
                                  td.numpy().view(np.int32))
    # the arithmetic field decode the kernels share, the same bits
    ad = decode_block_values(torch.from_numpy(jc),
                             torch.from_numpy(np.asarray(jm)), tf)
    np.testing.assert_array_equal(jd.view(np.int32),
                                  ad.numpy().view(np.int32))


@pytest.mark.parametrize("fname,shape,axis", [
    ("nxfp3", (48, 96), -1), ("nxfp4_bs8", (40, 24), -2),
    ("nxfp4_bs64", (3, 128, 20), -2), ("nxfp6_bs128", (16, 256), -1),
    ("amxfp4_bs8", (12, 40), -1), ("bfp7_bs16", (20, 48), -1)])
def test_wide_quantize_qtensor_matches_reference(fname, shape, axis):
    """The port's CPU cast against the reference's (its fused Pallas
    kernel in interpret mode where that takes the format, the XLA path
    for 3-bit and 2/7-bit codes): the same packed bytes and meta."""
    x = (np.random.default_rng(1).standard_normal(shape) * 3).astype(
        np.float32)
    jq = _jquantize(jnp.asarray(x), fname, axis, impl="pallas")
    tq = ops.quantize_qtensor(torch.from_numpy(x), fname, axis=axis,
                              device="cpu")
    np.testing.assert_array_equal(np.asarray(jq.packed), tq.packed.numpy())
    np.testing.assert_array_equal(np.asarray(jq.meta), tq.meta.numpy())
    np.testing.assert_array_equal(
        np.asarray(jq.dequantize(jnp.float32)),
        tq.dequantize(torch.float32).numpy())


@pytest.mark.parametrize("base,value", RECYCLE,
                         ids=[f"{b}@{v:.4g}" for b, v in RECYCLE])
def test_recycle_table_encoder_matches_reference(base, value):
    """The ported table-driven ``quantize_blocks`` (a value on a midpoint
    takes the lower level) and ``pack_codes_scatter`` against the
    reference's at Fig. 11's recycle values, exact ties included: codes
    and meta bitwise up to counted near-ties, packed bytes and the decode
    (the recycled code reads the custom value) bitwise."""
    jf, tf = _formats(base, value)
    xb = np.concatenate([_tie_blocks(tf), _edge_blocks(tf.block_size)])
    jc, jm = jquantize_blocks(jnp.asarray(xb), jf)
    tc, tm = tquant.quantize_blocks(torch.from_numpy(xb), tf)
    same = _check_codec(jc, jm, tc, tm, xb, tf)
    ties = len(_tie_blocks(tf))
    assert same[:ties].all()          # exact ties are no MSE near-ties
    jc = np.asarray(jc)
    jp = np.asarray(jpack.pack_codes_scatter(jnp.asarray(jc), tf.bits))
    np.testing.assert_array_equal(
        jp, tpack.pack_codes_scatter(torch.from_numpy(jc), tf.bits).numpy())
    np.testing.assert_array_equal(
        jp, tpack.pack_codes(torch.from_numpy(jc), tf.bits).numpy())
    jd = np.asarray(jdequantize_blocks(jnp.asarray(jc), jm, jf))
    for dec in (tquant.dequantize_blocks, decode_block_values):
        td = dec(torch.from_numpy(jc), torch.from_numpy(np.asarray(jm)), tf)
        np.testing.assert_array_equal(jd.view(np.int32),
                                      td.numpy().view(np.int32))
    # the arithmetic encoder keeps refusing a custom value, as the
    # reference's does; the plain quantizer takes the table encoder
    with pytest.raises(NotImplementedError):
        tquant.quantize_blocks_arith(torch.from_numpy(xb), tf)


@pytest.mark.parametrize("base,value", [("mxfp4_cr", 5.0), ("nxfp4", 0.75),
                                        ("bfp4_cr", 1.5)])
def test_recycle_quantize_qtensor_matches_reference(base, value):
    """A custom recycle value through the port's CPU cast (the plain
    quantizer: table encoder, then the pack) equals the reference's
    ``quantize_qtensor`` (its XLA path: ``quantize_blocks``)."""
    jf, tf = _formats(base, value)
    x = (np.random.default_rng(4).standard_normal((64, 96)) * 2).astype(
        np.float32)
    jq = jops.quantize_qtensor(jnp.asarray(x), jf, axis=-2, impl="pallas")
    tq = ops.quantize_qtensor(torch.from_numpy(x), tf, axis=-2, device="cpu")
    np.testing.assert_array_equal(np.asarray(jq.packed), tq.packed.numpy())
    np.testing.assert_array_equal(np.asarray(jq.meta), tq.meta.numpy())
