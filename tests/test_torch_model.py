"""The port's smoke Llama and serving engine against the JAX reference.

Both packages start from the same parameters: the reference's
``init_params(cfg, PRNGKey(0))`` as numpy, converted by
``convert.params_from_jax``. On the CPU the reference engine runs its XLA
path (``qmatmul_ref``, ``quantize_blocks_arith``, ``decode_attention_ref``);
the port runs its plain kernel versions.

Logit tolerance, 1e-2 absolute on logits of magnitude ~0.5: activations
are bf16, and XLA keeps some elementwise intermediates in f32 where torch
rounds each op to bf16 (and the GEMMs sum in another order), so a hidden
value can move by a bf16 ulp; a K/V value that sits near an nxfp4 level
boundary can then move by a code. Greedy streams of untrained smoke logits
are near ties and may fork on one such rounding, so decode is held by
teacher forcing: the JAX stream's tokens feed the port's ``decode_step``,
and argmax must agree wherever the JAX top-2 margin exceeds twice the
tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.core.qtensor import direct_cast_tree as jdirect_cast_tree
from repro.kernels.ops import quantize_qtensor as jquantize_qtensor
from repro.models.attention import attend_chunked as jattend_chunked
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.serving.engine import mask_chunk_emissions as jmask
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QTensor, QuantPolicy, direct_cast_tree
from repro_torch.kernels.ops import quantize_qtensor
from repro_torch.models import decode_step, prefill
from repro_torch.models.attention import attend_chunked
from repro_torch.serving import ServeEngine, mask_chunk_emissions

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

TOL = 1e-2


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_smoke_config("llama3_8b")
    cfg = get_smoke_config("llama3_8b")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, cfg, jparams, tparams


def _tokens(cfg, b=2, t=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (b, t)).astype(np.int32)


# the reference's cast, jitted once per (shape, format) instead of op by op
_jquantize = jax.jit(jquantize_qtensor, static_argnums=(1, 2))
_CASTS = {}


def _cast_both(setup, wf, kv):
    """Both parameter trees direct-cast under the same policy (memoized:
    the cast depends on the weight format only)."""
    jcfg, cfg, jparams, tparams = setup
    if wf is None:
        return jparams, tparams
    if wf not in _CASTS:
        jq = jdirect_cast_tree(jparams, JQuantPolicy(wf, kv),
                               quantize_fn=_jquantize)
        tq = direct_cast_tree(tparams, QuantPolicy(wf, kv),
                              quantize_fn=lambda leaf, fmt, axis:
                              quantize_qtensor(leaf, fmt, axis, device="cpu"))
        _CASTS[wf] = jq, tq
    return _CASTS[wf]


@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg, kv, max_len):
    return (jax.jit(lambda p, b: jprefill(jcfg, p, b, max_len=max_len,
                                          kv_fmt=kv)),
            jax.jit(lambda p, t, c: jdecode_step(jcfg, p, t, c, kv_fmt=kv)))


def test_params_from_jax_round_trip(setup):
    jcfg, cfg, jparams, tparams = setup
    np.testing.assert_array_equal(np.asarray(jparams["final_scale"]),
                                  tparams["final_scale"].numpy())
    for name in ("tok_embed", "lm_head"):
        assert tparams[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(jparams[name].astype(jnp.bfloat16).astype(jnp.float32)),
            tparams[name].float().numpy())
    assert len(tparams["layers"]) == jcfg.n_layers
    for i, layer in enumerate(tparams["layers"]):
        assert set(layer) == set(jparams["layers"])
        for name, leaf in layer.items():
            np.testing.assert_array_equal(
                np.asarray(jparams["layers"][name][i]), leaf.numpy())
    # already-cast QTensor leaves carry their exact bytes, split on L
    jq, _ = _cast_both(setup, "nxfp4", "nxfp4")
    tq = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    for i, layer in enumerate(tq["layers"]):
        for name in ("wq", "wk", "wv", "wo", "mlp_w1", "mlp_w3", "mlp_w2"):
            leaf, ref = layer[name], jq["layers"][name]
            assert isinstance(leaf, QTensor) and leaf.shape == ref.shape[1:]
            np.testing.assert_array_equal(np.asarray(ref.packed[i]),
                                          leaf.packed.numpy())
            np.testing.assert_array_equal(np.asarray(ref.meta[i]),
                                          leaf.meta.numpy())


@pytest.mark.parametrize("chunk_q", [5, 1024])
def test_prefill_attention_matches_reference(chunk_q):
    """The port's one-pass causal attention per query chunk vs the
    reference's online softmax (one KV chunk): the same bf16 p, f32 sums
    in another order (1e-5 of max|V|)."""
    rng = np.random.default_rng(4)
    b, t, kvh, g, d = 2, 13, 2, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((b, t, kvh, g, d), (b, t, kvh, d), (b, t, kvh, d)))
    ref = np.asarray(jattend_chunked(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        chunk_q=4, chunk_kv=1024))
    got = attend_chunked(*(torch.from_numpy(a).to(torch.bfloat16)
                           for a in (q, k, v)), chunk_q=chunk_q).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(v).max())


@pytest.mark.parametrize("wf,kv", [("nxfp4", "nxfp4"), ("nxfp4", None),
                                   (None, "nxfp4"), (None, None)])
def test_prefill_logits_match(setup, wf, kv):
    jcfg, cfg = setup[:2]
    jq, tq = _cast_both(setup, wf, kv)
    toks = _tokens(cfg)
    jl, jc = _jax_fns(jcfg, kv, 32)[0](jq, {"tokens": jnp.asarray(toks)})
    tl, tc = prefill(cfg, tq, {"tokens": torch.from_numpy(toks).long()},
                     max_len=32, kv_fmt=kv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    # cache layout as the reference's, per layer
    for i, lc in enumerate(tc["layers"]):
        for name, buf in lc.items():
            ref = jc["layers"][name][i]
            assert tuple(buf.shape) == ref.shape
            assert str(buf.dtype).split(".")[-1] == str(ref.dtype)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("kv", ["nxfp4", None])
def test_teacher_forced_decode(setup, kv):
    jcfg, cfg = setup[:2]
    jq, tq = _cast_both(setup, "nxfp4", kv)
    jprefill_fn, jdecode_fn = _jax_fns(jcfg, kv, 32)
    toks = _tokens(cfg, seed=1)
    jl, jc = jprefill_fn(jq, {"tokens": jnp.asarray(toks)})
    tl, tc = prefill(cfg, tq, {"tokens": torch.from_numpy(toks).long()},
                     max_len=32, kv_fmt=kv)
    agreed = 0
    for _ in range(8):
        jl_np = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl_np, rtol=0, atol=TOL)
        top2 = np.sort(jl_np, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * TOL
        tok = jl_np.argmax(-1).astype(np.int32)
        assert (tl.numpy().argmax(-1)[clear] == tok[clear]).all()
        agreed += int(clear.sum())
        jl, jc = jdecode_fn(jq, jnp.asarray(tok)[:, None], jc)
        tl, tc = decode_step(cfg, tq, torch.from_numpy(tok).long()[:, None],
                             tc, kv)
    print(f"kv={kv}: argmax checked on {agreed} of 16 teacher-forced rows")


@pytest.fixture(scope="module")
def engine(setup):
    cfg, tparams = setup[1], setup[3]
    return ServeEngine(cfg, tparams, QuantPolicy("nxfp4", "nxfp4"),
                       max_len=48, device="cpu")


@pytest.mark.parametrize("chunk", [1, 4, 3])
def test_host_device_loops_bitwise(setup, engine, chunk):
    """Greedy: tokens and n_generated bitwise equal between the loops, at a
    chunk size that divides max_new and one that does not."""
    toks = {"tokens": _tokens(setup[1], b=3, seed=2)}
    rh = engine.generate(toks, max_new=8, loop="host")
    rd = engine.generate(toks, max_new=8, loop="device", chunk=chunk)
    np.testing.assert_array_equal(rh.tokens, rd.tokens)
    np.testing.assert_array_equal(rh.n_generated, rd.n_generated)
    assert (rd.n_generated == 8).all()
    assert rd.tokens.min() >= 0 and rd.tokens.max() < setup[1].vocab


def test_stop_token_mid_chunk(setup, engine):
    toks = {"tokens": _tokens(setup[1], b=3, seed=2)}
    probe = engine.generate(toks, max_new=10, loop="host")
    stop = int(probe.tokens[0, 2])      # stops sequence 0 mid first chunk
    rh = engine.generate(toks, max_new=10, stop_token=stop, loop="host")
    rd = engine.generate(toks, max_new=10, stop_token=stop, loop="device",
                         chunk=4)
    np.testing.assert_array_equal(rh.tokens, rd.tokens)
    np.testing.assert_array_equal(rh.n_generated, rd.n_generated)
    first = int(np.argmax(probe.tokens[0] == stop))
    assert rd.n_generated[0] == first + 1
    assert (rd.tokens[0, first + 1:] == 0).all()


def test_mask_chunk_emissions_matches_reference():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 5, (6, 7)).astype(np.int32)
    done = rng.random(6) < 0.3
    n_gen = rng.integers(0, 4, 6).astype(np.int32)
    stop = np.array([1, 2, -1, 3, 0, 4], np.int32)
    ref = jmask(jnp.asarray(toks), jnp.asarray(done), jnp.asarray(n_gen),
                jnp.asarray(stop))
    got = mask_chunk_emissions(torch.from_numpy(toks), torch.from_numpy(done),
                               torch.from_numpy(n_gen), torch.from_numpy(stop))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


def test_weights_footprint_of_packed_leaves_matches_reference(setup, engine):
    jq, _ = _cast_both(setup, "nxfp4", "nxfp4")
    ref = sum(leaf.nbytes() for leaf in jax.tree.leaves(
        jq, is_leaf=lambda l: hasattr(l, "packed")) if hasattr(leaf,
                                                              "packed"))
    leaves = [leaf for layer in engine.params["layers"]
              for leaf in layer.values() if isinstance(leaf, QTensor)]
    assert len(leaves) == 7 * setup[1].n_layers
    assert sum(leaf.nbytes() for leaf in leaves) == ref
    # dense leaves count what is stored (tok_embed/lm_head in bf16)
    cfg = setup[1]
    dense = (2 * cfg.vocab * cfg.d_model * 2 + cfg.d_model * 4
             + cfg.n_layers * 2 * cfg.d_model * 4)
    assert engine.weights_footprint_bytes() == ref + dense
