"""The vision and audio families in the torch port, on the CPU at smoke
size (``llama_3_2_vision_90b``: 4 layers, a cross layer every second,
16 stub patches; ``whisper_tiny``: 2 encoder and 2 decoder layers, 64
stub frames), against the reference (``src/repro/models``).

* The configs and ``param_count`` equal to the reference's (its double
  count included); ``params_from_jax`` leaf for leaf, bitwise, the vision
  family's (G, every - 1) self stack and (G) cross stack interleaved into
  the port's flat list (cast QTensors and dense leaves alike).
* ``memory_kv``, ``cross_attention`` and the decode step's cross attention
  (``blocks._cross_decode``, the dense-row attention's plain version on
  the CPU) within 2e-2 of their scale (bf16 outputs of bf16 GEMMs summed
  in another order: ``tests/test_torch_moe.py``'s tolerance), at nxfp4
  and bf16 weights; the audio encoder likewise.
* ``prefill`` and teacher-forced ``decode_step`` logits within 1e-2
  (``tests/test_torch_model.py``), nxfp4 weights, nxfp4 and dense KV;
  greedy streams of the port's ``ServeEngine`` (host loop and the device
  loop's chunks on the CPU) equal to the reference ``ServeEngine``'s.
* ``kv_sim_fmt="nxfp4"`` (the paper's quantized-KV simulation): prefill
  logits within 1e-2 of the reference's and not those of
  ``kv_sim_fmt=None``; the lane's resumed attention takes the same hook
  (chunked bitwise whole).
* ``init_params(policy=)`` bitwise ``load_params(init_params())``; the
  continuous engines refuse both families at construction, the lane and
  the speculative verify raise.

The reference's weights are cast by the port's quantizer on the CPU and
wrapped as its QTensors (the codec is bitwise the reference's,
``tests/test_torch_codec.py``; the Pallas encoder in interpret mode would
take longer), and its functions are jitted once a signature.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.qtensor import QTensor as JQTensor
from repro.core.qtensor import QuantPolicy as JQuantPolicy
from repro.core.qtensor import direct_cast_tree as jdirect_cast_tree
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import lm as jlm
from repro.models import prefill as jprefill
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.qtensor import QTensor, QuantPolicy, _leaves
from repro_torch.kernels.build import bit_view
from repro_torch.kernels.ops import quantize_qtensor
from repro_torch.models import (decode_step, init_lane, init_params, prefill,
                                prefill_chunk, verify_step)
from repro_torch.models import attention, blocks, lm
from repro_torch.serving import (ContinuousEngine, PagedContinuousEngine,
                                 ServeEngine, TieredContinuousEngine)
from repro_torch.serving.engine import load_params
from repro_torch.serving.tiers import default_tiers

import _torch_helpers  # noqa: F401  (one intra-op thread a process)

ARCHS = ("llama_3_2_vision_90b", "whisper_tiny")
BF16_TOL = 2e-2     # of the scale: bf16 outputs
TOL = 1e-2          # logits (tests/test_torch_model.py)
MAX_LEN = 32
NXFP4 = QuantPolicy("nxfp4", "nxfp4")

_jmemory_kv = jax.jit(jattention.memory_kv, static_argnums=0)
_jcross = jax.jit(jattention.cross_attention, static_argnums=0)
_jcross_decode = jax.jit(jblocks._cross_decode, static_argnums=0)
_jencode = jax.jit(jlm._encode_audio, static_argnums=0)


def _cast(leaf, fmt, axis):
    """A reference QTensor cast by the port's quantizer on the CPU."""
    q = quantize_qtensor(torch.from_numpy(np.array(leaf)), fmt, axis,
                         device="cpu")
    return JQTensor(jnp.asarray(q.packed.numpy()),
                    jnp.asarray(bit_view(q.meta).numpy().view(np.uint16)),
                    q.fmt_name, q.shape, q.axis, q.orig_len)


@functools.lru_cache(maxsize=None)
def _setup(arch, fmt):
    """The reference's smoke config and params of ``arch`` (cast to
    ``fmt``) and the port's copy of them."""
    jcfg = jget_smoke_config(arch)
    cfg = get_smoke_config(arch)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    if fmt is not None:
        jparams = jdirect_cast_tree(jparams, JQuantPolicy(fmt, fmt),
                                    quantize_fn=_cast)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, cfg, jparams, tparams


@functools.lru_cache(maxsize=None)
def _jfns(jcfg, kv):
    return (jax.jit(lambda p, b: jprefill(jcfg, p, b, max_len=MAX_LEN,
                                          kv_fmt=kv)),
            jax.jit(lambda p, t, c: jdecode_step(jcfg, p, t, c, kv_fmt=kv)))


def _f32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bf16(shape, seed):
    jx = jnp.asarray(_f32(shape, seed)).astype(jnp.bfloat16)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)


def _batch(cfg, b=2, t=12, seed=0):
    """tokens and the family's memory input, numpy, from a seed."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision"] = _f32((b, cfg.n_vision_tokens, cfg.d_model), seed + 1)
    else:
        out["frames"] = _f32((b, cfg.n_audio_frames, cfg.d_model), seed + 1)
    return out


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol, what):
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _ref_layer(arch, jparams, i):
    """The reference's layer ``i`` of the port's execution order."""
    if arch == "whisper_tiny":
        return jax.tree.map(lambda a: a[i], jparams["layers"])
    every = jget_smoke_config(arch).cross_attn_every
    g, j = divmod(i, every)
    if j == every - 1:
        return jax.tree.map(lambda a: a[g], jparams["cross_layers"])
    return jax.tree.map(lambda a: a[g, j], jparams["self_layers"])


def _same_leaf(got, want, what):
    if isinstance(want, JQTensor):
        assert isinstance(got, QTensor), what
        np.testing.assert_array_equal(got.packed.numpy(),
                                      np.asarray(want.packed), err_msg=what)
        np.testing.assert_array_equal(bit_view(got.meta).numpy().view(
            np.uint16), np.asarray(want.meta), err_msg=what)
        assert got.shape[-1] == got.packed.shape[-3], what
    else:
        want = np.asarray(want)
        if got.dtype == torch.bfloat16:
            want = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(
                jnp.float32))
            got = got.float()
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


# ---------------------------------------------------------------------------
# configs and the parameter tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_reference(arch):
    for full, jfull in ((get_config(arch), jget_config(arch)),
                        (get_smoke_config(arch), jget_smoke_config(arch))):
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab", "rope_theta", "norm_eps",
                  "cross_attn_every", "n_vision_tokens", "n_enc_layers",
                  "n_audio_frames", "kv_sim_fmt"):
            assert getattr(full, f) == getattr(jfull, f), (arch, f)
        assert full.hd == jfull.hd
        assert full.param_count() == jfull.param_count()


@pytest.mark.parametrize("fmt", ["nxfp4", None])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_leaf_for_leaf(arch, fmt):
    """Every layer of the port's flat list is the reference's layer of the
    same execution index, leaf for leaf (its kind's keys), bitwise; the
    top-level leaves (the audio encoder's too) likewise."""
    jcfg, cfg, jparams, tparams = _setup(arch, fmt)
    kinds = lm.layer_kinds(cfg)
    assert len(tparams["layers"]) == cfg.n_layers == len(kinds)
    for i, (layer, kind) in enumerate(zip(tparams["layers"], kinds)):
        ref = _ref_layer(arch, jparams, i)
        assert set(layer) == set(ref), (i, kind)
        assert ("cross_wq" in layer) == (kind in blocks.CROSS_KINDS)
        assert ("wq" in layer) == (kind != "cross")
        for name, leaf in layer.items():
            _same_leaf(leaf, ref[name], f"layers/{i}/{name}")
    for name in ("tok_embed", "lm_head", "final_scale", "enc_pos_embed",
                 "enc_scale"):
        if name in jparams:
            _same_leaf(tparams[name], jparams[name], name)
    if arch == "whisper_tiny":
        assert len(tparams["enc_layers"]) == cfg.n_enc_layers
        for i, layer in enumerate(tparams["enc_layers"]):
            ref = jax.tree.map(lambda a: a[i], jparams["enc_layers"])
            for name, leaf in layer.items():
                _same_leaf(leaf, ref[name], f"enc_layers/{i}/{name}")
    if fmt is not None:
        assert isinstance(tparams["layers"][0]["wq"], QTensor)


# ---------------------------------------------------------------------------
# the memory's K/V, cross attention, the audio encoder
# ---------------------------------------------------------------------------

def _cross_layer(arch, fmt):
    jcfg, cfg, jparams, tparams = _setup(arch, fmt)
    i = lm.layer_kinds(cfg).index("cross" if arch != "whisper_tiny"
                                  else "encdec")
    return jcfg, cfg, _ref_layer(arch, jparams, i), tparams["layers"][i]


@pytest.mark.parametrize("fmt", ["nxfp4", None])
@pytest.mark.parametrize("arch", ARCHS)
def test_memory_kv_and_cross_attention_match_reference(arch, fmt):
    """memory_kv over a (2, S, D) memory, cross attention of (2, 9, D)
    queries and the one-token decode cross attention over its K/V."""
    jcfg, cfg, jp, tp = _cross_layer(arch, fmt)
    s = cfg.n_vision_tokens or cfg.n_audio_frames
    jmem, mem = _bf16((2, s, cfg.d_model), 5)
    jk, jv = _jmemory_kv(jcfg, jp, jmem)
    k, v = attention.memory_kv(cfg, tp, mem)
    assert k.dtype == torch.bfloat16 and k.is_contiguous()
    assert tuple(k.shape) == (2, s, cfg.n_kv_heads, cfg.hd)
    _close(k, jk, BF16_TOL, f"{arch}/{fmt} mem_k")
    _close(v, jv, BF16_TOL, f"{arch}/{fmt} mem_v")
    # both sides attend over the same (the reference's) memory K/V
    tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (jk, jv))
    jx, x = _bf16((2, 9, cfg.d_model), 6)
    _close(attention.cross_attention(cfg, tp, x, tk, tv),
           _jcross(jcfg, jp, jx, jk, jv), BF16_TOL,
           f"{arch}/{fmt} cross_attention")
    jh, h = _bf16((2, 1, cfg.d_model), 7)
    _close(blocks._cross_decode(cfg, tp, h, tk, tv),
           _jcross_decode(jcfg, jp, jh, jk, jv), BF16_TOL,
           f"{arch}/{fmt} cross decode")


@pytest.mark.parametrize("fmt", ["nxfp4", None])
def test_encode_audio_matches_reference(fmt):
    jcfg, cfg, jparams, tparams = _setup("whisper_tiny", fmt)
    frames = _f32((2, cfg.n_audio_frames, cfg.d_model), 8)
    got = lm._encode_audio(cfg, tparams, torch.from_numpy(frames))
    assert got.dtype == cfg.dtype
    _close(got, _jencode(jcfg, jparams, jnp.asarray(frames)), BF16_TOL,
           f"encoder/{fmt}")


def test_attend_chunked_without_causal_mask_matches_reference():
    """The encoder's attention: every valid key, 200 keys in one 256-key
    tile (the padded keys masked). One tile on both sides, so the same
    bf16 probabilities: f32 sums in another order (1e-5 of max|V|, as
    ``tests/test_torch_model.py``'s causal case)."""
    rng = np.random.default_rng(9)
    b, t, kvh, g, d = 2, 21, 2, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((b, t, kvh, g, d), (b, 200, kvh, d), (b, 200, kvh, d)))
    ref = np.asarray(jattention.attend_chunked(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=False,
        chunk_q=8, chunk_kv=1024))
    got = attention.attend_chunked(*(torch.from_numpy(a).to(torch.bfloat16)
                                     for a in (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(v).max())


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["nxfp4", None])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode_match_reference(arch, kv):
    """nxfp4 weights: the prefill logits and 6 teacher-forced decode steps
    (the reference's argmax fed to both) within 1e-2; each cross layer's
    cache holds its memory K/V in bf16, contiguous."""
    jcfg, cfg, jparams, tparams = _setup(arch, "nxfp4")
    jpre, jdec = _jfns(jcfg, kv)
    batch = _batch(cfg)
    jl, jc = jpre(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = prefill(cfg, tparams, _tbatch(batch), MAX_LEN, kv)
    for kind, lc in zip(lm.layer_kinds(cfg), tc["layers"]):
        assert ("mem_k" in lc) == (kind in blocks.CROSS_KINDS)
        if "mem_k" in lc:
            assert lc["mem_k"].dtype == cfg.dtype
            assert lc["mem_k"].is_contiguous()
    for step in range(7):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL, err_msg=f"step {step}")
        if step == 6:
            break
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jc = jdec(jparams, jnp.asarray(tok)[:, None], jc)
        tl, tc = decode_step(cfg, tparams,
                             torch.from_numpy(tok).long()[:, None], tc, kv)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_streams_match_reference(arch):
    """8 greedy tokens of B 2 requests through the port's ServeEngine, host
    loop and device loop (chunks of 3 on the CPU), equal to each other and
    to the reference ServeEngine's (nxfp4 weights and KV)."""
    jcfg, cfg, jparams, tparams = _setup(arch, "nxfp4")
    batch = _batch(cfg, seed=3)
    jeng = JServeEngine(jcfg, jparams, JQuantPolicy(None, "nxfp4"),
                        max_len=MAX_LEN)
    want = np.asarray(jeng.generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, max_new=8,
        loop="host").tokens)
    eng = ServeEngine(cfg, tparams, NXFP4, max_len=MAX_LEN, device="cpu")
    host = eng.generate(batch, max_new=8, loop="host")
    dev = eng.generate(batch, max_new=8, loop="device", chunk=3)
    np.testing.assert_array_equal(host.tokens, dev.tokens)
    np.testing.assert_array_equal(host.tokens, want)


@pytest.mark.parametrize("arch", ["llama3_8b", "whisper_tiny"])
def test_kv_sim_prefill_matches_reference(arch):
    """kv_sim_fmt="nxfp4" fake-quantizes the rope'd prefill K/V (the
    audio encoder's too): logits within 1e-2 of the reference's, and not
    the logits of kv_sim_fmt=None. nxfp4 weights, dense KV cache."""
    jcfg, cfg, jparams, tparams = _setup(arch, "nxfp4")
    jsim = dataclasses.replace(jcfg, kv_sim_fmt="nxfp4")
    sim = dataclasses.replace(cfg, kv_sim_fmt="nxfp4")
    batch = _batch(cfg, seed=4) if arch != "llama3_8b" else {
        "tokens": _batch(cfg, seed=4)["tokens"]}
    jl, _ = _jfns(jsim, None)[0](jparams, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    tl, _ = prefill(sim, tparams, _tbatch(batch), MAX_LEN, None)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    plain, _ = prefill(cfg, tparams, _tbatch(batch), MAX_LEN, None)
    assert not torch.equal(tl, plain)


def test_kv_sim_lane_chunks_match_whole_prefill():
    """The lane's resumed attention fake-quantizes its chunk's K/V as the
    whole prefill does: a 13-token prompt in chunks of 4, bitwise."""
    _, cfg, _, tparams = _setup("llama3_8b", "nxfp4")
    cfg = dataclasses.replace(cfg, kv_sim_fmt="nxfp4")
    toks = torch.from_numpy(_batch(cfg, b=1, t=13, seed=5)["tokens"]).long()
    want, whole = prefill(cfg, tparams, {"tokens": toks}, MAX_LEN, "nxfp4")
    cache = lm.init_cache(cfg, 1, MAX_LEN, "nxfp4", device="cpu")
    lane = init_lane(cfg, MAX_LEN, 4, device="cpu")
    for off in range(0, 13, 4):
        chunk = torch.zeros((1, 4), dtype=torch.long)
        n = min(4, 13 - off)
        chunk[0, :n] = toks[0, off:off + n]
        got, cache, lane = prefill_chunk(cfg, tparams, chunk, cache, 0, off,
                                         n, lane, "nxfp4")
    assert torch.equal(got, want)
    for a, b in zip(cache["layers"], whole["layers"]):
        for name in a:
            assert torch.equal(bit_view(a[name]), bit_view(b[name])), name


def test_kv_sim_route_asks_for_the_table_rules():
    """``fake_quant`` encodes with the table-driven ``quantize_blocks``
    (a midpoint takes the lower level), the serving cast with the
    arithmetic encoder (half to even): on bf16 K they differ. The route's
    cast on the card asks the kernel for the table rules (its descriptor),
    and the wrapper's plain version under them is ``fake_quant``'s."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.quantize import fake_quant
    from repro_torch.kernels import ops
    from repro_torch.kernels.nxfp_quantize import _desc
    fmt = get_format("nxfp4")
    assert _desc(fmt, True).table == 1 and _desc(fmt).table == 0
    _, k = _bf16((4, 9, 2, 64), 10)
    want = fake_quant(k, fmt, axis=-1)
    assert torch.equal(ops._cast(k, fmt, -1, table=True).dequantize(
        k.dtype), want)
    assert not torch.equal(ops._cast(k, fmt, -1).dequantize(k.dtype), want)


# ---------------------------------------------------------------------------
# the layered build and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_layer_at_a_time_build_is_bitwise_load_params(arch):
    cfg = get_smoke_config(arch)
    want = load_params(init_params(cfg, 7, device="cpu"), NXFP4,
                       torch.device("cpu"))
    got = init_params(cfg, 7, device="cpu", policy=NXFP4)
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert type(x) is type(y)
        if isinstance(x, QTensor):
            assert x.shape == y.shape and torch.equal(x.packed, y.packed)
            assert torch.equal(bit_view(x.meta), bit_view(y.meta))
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert isinstance(got["layers"][-1]["cross_wk"], QTensor)
    assert [set(layer) for layer in got["layers"]] == \
        [set(blocks.init_layer(torch.Generator(), cfg, kind))
         for kind in lm.layer_kinds(cfg)]


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engines_lane_and_verify_refuse(arch):
    _, cfg, _, tparams = _setup(arch, "nxfp4")
    kw = dict(n_slots=2, max_len=MAX_LEN, chunk=4, device="cpu")
    for make in (lambda: ContinuousEngine(cfg, tparams, NXFP4, **kw),
                 lambda: PagedContinuousEngine(cfg, tparams, NXFP4, **kw),
                 lambda: TieredContinuousEngine(cfg, tparams,
                                                default_tiers(), **kw)):
        with pytest.raises(ValueError, match="memory input"):
            make()
    with pytest.raises(NotImplementedError, match=cfg.family):
        init_lane(cfg, MAX_LEN, 4, device="cpu")
    with pytest.raises(NotImplementedError, match=cfg.family):
        prefill_chunk(cfg, tparams, torch.zeros((1, 4), dtype=torch.long),
                      {}, 0, 0, 4, {}, "nxfp4")
    with pytest.raises(NotImplementedError, match=cfg.family):
        verify_step(cfg, tparams, torch.zeros((2, 3), dtype=torch.long),
                    {"pos": torch.zeros((2,), dtype=torch.int32)}, "nxfp4")
