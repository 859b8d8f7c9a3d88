"""The port's plain kernel versions at every format the reference serves,
on the CPU: 3-bit codes, block sizes 8 to 128, custom recycle values
(``tests/test_torch_wide_formats.py`` holds the codec).

Held against the reference where it serves each format: its Pallas
kernels in interpret mode where they take the format (``impl="pallas"``),
``kernels/ref.py`` where its XLA path serves it (3-bit codes). The GEMMs
and attention are held to their accumulation tolerances: 1e-5 of
sum|x||w| and of max|V| (both sides sum the same exact products in
another order).

The reference's Pallas decode hard-codes the recycled value -smallest/2
(``kernels/decode_lib.py``), so a custom recycle value is held against its
level-table dequantize (``kernels/ref.py``, ``impl="xla"``), never its
Pallas kernels.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core.qtensor import QTensor as JQTensor
from repro.kernels import ops as jops
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import formats as tformats
from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import ops
from repro_torch.kernels.nxfp_attention import dequant_cache
from repro_torch.kernels.nxfp_matmul import dequant_weight_bf16
from repro_torch.kernels.nxfp_qq_matmul import nxfp_qq_matmul_plain

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

_jquantize = jax.jit(jops.quantize_qtensor, static_argnums=(1, 2),
                     static_argnames=("impl",))


def _base(name):
    return name.split("@")[0]


def _formats(name, value=None):
    """(reference, port) BlockFormats for ``name``, with a custom recycle
    value when ``value`` is given."""
    jf, tf = jformats.get_format(name), tformats.get_format(name)
    if value is None:
        return jf, tf
    new = f"{name}@{float(value):.3f}"
    return (dataclasses.replace(jf, recycle=float(value), name=new),
            dataclasses.replace(tf, recycle=float(value), name=new))


def _port_qtensor(jq, tf=None) -> QTensor:
    q = QTensor(tensor_from_numpy(jq.packed), tensor_from_numpy(jq.meta),
                jq.fmt_name, tuple(jq.shape), jq.axis, jq.orig_len)
    if tf is not None:           # a format the registry cannot name
        q = dataclasses.replace(q, fmt_name=tf)
    return q


def _jweight(w, jf):
    return JQTensor.quantize(jnp.asarray(w), jf, axis=0)


@pytest.mark.parametrize("fname,impl", [
    ("nxfp3", "pallas"), ("mxfp3_bs8", "pallas"), ("nxfp4_bs8", "pallas"),
    ("nxfp4_bs64", "pallas"), ("nxfp4_bs128", "pallas"),
    ("mxfp6_bs8", "pallas"), ("bfp7_bs16", "pallas"),
    ("nxfp4@0.750", "xla"), ("mxfp4_cr@5.000", "xla")])
@pytest.mark.parametrize("m,k,n", [(5, 256, 64), (1, 200, 24)])
def test_wide_qmatmul_plain_matches_reference(fname, impl, m, k, n):
    """The plain dequant GEMM against the reference's qmatmul (its Pallas
    kernel where it takes the format, else ``qmatmul_ref``; a custom
    recycle value against ``qmatmul_ref``): 1e-5 of sum|x||w|."""
    value = float(fname.split("@")[1]) if "@" in fname else None
    jf, tf = _formats(_base(fname), value)
    rng = np.random.default_rng(m * k)
    x = rng.standard_normal((3, m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jq = _jweight(w, jf)
    yj = np.asarray(jops.qmatmul(jnp.asarray(x), jq, impl=impl))
    tq = _port_qtensor(jq, tf if value is not None else None)
    yt = ops.qmatmul(torch.from_numpy(x), tq).numpy()
    assert yt.shape == yj.shape == (3, m, n)
    wd = dequant_weight_bf16(tq.packed, tq.meta, tq.fmt).float()[:, :k]
    mag = (torch.from_numpy(x).to(torch.bfloat16).float().abs()
           @ wd.abs().T).numpy()
    assert (np.abs(yt - yj) <= 1e-5 * mag + 1e-30).all()


@pytest.mark.parametrize("fname,impl", [
    ("nxfp3", "pallas"), ("nxfp4_bs8", "pallas"), ("nxfp4_bs64", "pallas"),
    ("nxfp4_bs128", "pallas"), ("mxfp6_bs8", "pallas"),
    ("amxfp4_ox_bs8", "pallas"), ("nxfp4@0.750", "xla")])
@pytest.mark.parametrize("hd", [64, 128])
def test_wide_decode_attention_plain_matches_reference(fname, impl, hd):
    """Plain decode attention against the reference's (Pallas in
    interpret mode where it takes the format): 1e-5 of max|V|."""
    value = float(fname.split("@")[1]) if "@" in fname else None
    jf, tf = _formats(_base(fname), value)
    rng = np.random.default_rng(hd)
    b, s, kvh, g = 3, 32, 2, 2
    q = rng.standard_normal((b, kvh * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    lengths = np.array([32, 9, 1], np.int32)
    jk, jv = (JQTensor.quantize(jnp.asarray(a), jf, axis=-1) for a in (k, v))
    oj = np.asarray(jops.decode_attention(jnp.asarray(q), jk, jv,
                                          jnp.asarray(lengths), kvh,
                                          impl=impl))
    tf_arg = tf if value is not None else None
    ot = ops.decode_attention(torch.from_numpy(q), _port_qtensor(jk, tf_arg),
                              _port_qtensor(jv, tf_arg),
                              torch.from_numpy(lengths), kvh).numpy()
    assert ot.shape == oj.shape == (b, kvh * g, hd)
    tv = _port_qtensor(jv, tf_arg)
    vmax = float(dequant_cache(tv.packed, tv.meta, tv.fmt).abs().max())
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-5 * vmax)


@pytest.mark.parametrize("xf,wf", [("amxfp3", "nxfp3"),
                                   ("amxfp4_bs64", "nxfp4_bs64"),
                                   ("amxfp4_ox_bs8", "nxfp4_bs8"),
                                   ("mxfp4_bs128", "nxfp4_bs128"),
                                   ("amxfp4", "nxfp3")])
@pytest.mark.parametrize("m,k,n", [(17, 256, 64), (4, 384, 32)])
def test_wide_qq_plain_matches_reference(xf, wf, m, k, n):
    """The plain qq GEMM against the reference's (its Pallas qq kernel in
    interpret mode where it takes both formats, ``qq_matmul_ref`` where
    not): 1e-5 of sum|x||w|."""
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    xq = _jquantize(jnp.asarray(x), xf, -1, impl="xla")
    wq = _jweight(w, jformats.get_format(wf))
    yj = np.asarray(jops.qmatmul(xq, wq, impl="pallas"))
    tx, tw = _port_qtensor(xq), _port_qtensor(wq)
    yt = nxfp_qq_matmul_plain(tx.packed, tx.meta, tw.packed, tw.meta,
                              tx.fmt, tw.fmt).numpy()
    assert yt.shape == yj.shape == (m, n)
    xd = dequant_weight_bf16(tx.packed, tx.meta, tx.fmt).float()
    wd = dequant_weight_bf16(tw.packed, tw.meta, tw.fmt).float()
    mag = (xd.abs() @ wd.abs().T).numpy()
    assert (np.abs(yt - yj) <= 1e-5 * mag + 1e-30).all()
