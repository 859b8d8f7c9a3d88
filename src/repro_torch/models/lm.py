"""Model assembly for every family the port serves: init, prefill, the
chunked prefill's lane chunk, decode.

Layers are a Python list of per-layer dicts (params) and of per-layer
caches, in execution order; prefill and decode loop over them. The cache
is ``{"pos": (B,) int32, "layers": [layer cache, ...]}``: a layer cache
holds the attention K/V (``kvcache.attn_cache_init``) where the layer has
self attention, the Mamba state ``h``/``conv`` (``kvcache.ssm_cache_init``)
where it has a Mamba block, and a memory's cross K/V ``mem_k``/``mem_v``
(B, S_mem, KVH, hd) where it cross-attends (the vision family's every
``cross_attn_every``-th layer, each audio decoder layer; ``layer_kinds``).
The audio family's params also hold the encoder (``enc_layers``, a list,
``enc_pos_embed``, ``enc_scale``). A paged cache (``init_paged_cache``)
has pool buffers and one block table shared by every layer's dict; its
Mamba state stays per slot.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..core.qtensor import QTensor
from ..kernels.build import bit_view
from .attention import memory_kv
from .blocks import (CROSS_KINDS, _put_state, family_kind, init_layer,
                     layer_decode, layer_forward, layer_prefill_chunk,
                     layer_verify)
from .common import (ModelConfig, cast_params, dense, dense_rows, ninit,
                     rmsnorm)
from .kvcache import (_POOL_PREFIX, attn_cache_init, paged_attn_cache_init,
                      paged_layer_view, restore_rows, save_rows,
                      ssm_cache_init, write_prefill)
from .ssm import reset_state_slot

Params = Dict[str, Any]

# the families ``prefill``, ``decode_step`` and ``decode_loop`` serve
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the reference's scanned-stack families (one kind of layer, no memory):
# what the slot caches, the lane and the speculative verify serve
# (``init_cache``, ``init_paged_cache``, ``init_lane``, ``prefill_chunk``,
# ``verify_step``); the reference's continuous engines cannot serve the
# vision and audio families either (a request carries no memory input)
STACK_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _check_family(cfg: ModelConfig, families=FAMILIES) -> None:
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} is not served here (serves "
            f"{', '.join(families)})")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Each layer's kind, in execution order: the vision family's groups
    of ``cross_attn_every - 1`` dense layers and one cross layer (the
    reference's scan over groups), the audio decoder's encdec layers, or
    the family's one kind."""
    if cfg.family == "vlm":
        every = cfg.cross_attn_every
        if not every or cfg.n_layers % every:
            raise ValueError(f"n_layers ({cfg.n_layers}) must be a multiple "
                             f"of cross_attn_every ({every})")
        return ["cross" if i % every == every - 1 else "dense"
                for i in range(cfg.n_layers)]
    return [family_kind(cfg)] * cfg.n_layers


def _state_entries(cfg: ModelConfig, batch: int, dev):
    """A layer's zeroed Mamba state where the family has a Mamba block."""
    if cfg.has_mamba:
        return ssm_cache_init(cfg, batch, dev)
    return {}


def recurrent_state(*trees):
    """The recurrent-state tensors (each layer's ``h`` and ``conv``) of
    caches and lanes: what a CUDA graph's warm-up must leave as it found
    (``serving.engine.capture_graph(keep=)``)."""
    return [buf for tree in trees for layer in tree["layers"]
            for name, buf in layer.items() if name in ("h", "conv")]


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                policy=None, train: bool = False) -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed``.

    Matmul weights and norms are f32, as in the reference. ``tok_embed``
    and ``lm_head`` are stored in bf16: the default policy keeps both
    dense and every use rounds them to bf16, so storing them rounded
    changes no result (the footprint counts what is stored). ``train``
    keeps them in f32, the training tree (``forward_train``): the
    reference trains both in f32, and a bf16 leaf would round most of
    AdamW's small updates away. The draws are the same either way. The
    draws run
    in one order: the embedding, the head, for the audio family the
    encoder's positional embedding and layers, then the layers in
    execution order (``layer_kinds``).

    ``policy`` (a ``QuantPolicy`` with a ``weight_fmt``) builds the tree
    the engines serve a layer at a time: each layer is drawn, its leaves
    are cast at once on the device (``common.cast_params``, what
    ``serving.engine.load_params`` does to the whole tree) and its f32
    leaves are dropped before the next layer is drawn. The draws are the
    same, in the same order, so the result is bitwise ``load_params(
    init_params(cfg, seed), policy)``, and the f32 model never exists:
    the build peaks near the packed bytes plus a layer's f32 weights. A
    policy without a weight format leaves the f32 tree as it is.
    """
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cast = policy is not None and bool(policy.weight_fmt)
    emb = torch.float32 if train else cfg.dtype
    p: Params = {
        "tok_embed": ninit(gen, (cfg.vocab, cfg.d_model), dtype=emb),
        "final_scale": torch.ones((cfg.d_model,), dtype=torch.float32,
                                  device=dev),
        "lm_head": ninit(gen, (cfg.d_model, cfg.vocab), dtype=emb),
    }
    if cfg.family == "audio":
        p["enc_pos_embed"] = ninit(gen, (cfg.n_audio_frames, cfg.d_model))
        p["enc_scale"] = torch.ones((cfg.d_model,), dtype=torch.float32,
                                    device=dev)
    if cast:
        p = cast_params(p, policy, dev)

    def layers(name, kinds):
        if not cast:
            return [init_layer(gen, cfg, k) for k in kinds]
        return [cast_params(init_layer(gen, cfg, k), policy, dev,
                            f"{name}/{i}") for i, k in enumerate(kinds)]

    if cfg.family == "audio":
        p["enc_layers"] = layers("enc_layers", ["dense"] * cfg.n_enc_layers)
    p["layers"] = layers("layers", layer_kinds(cfg))
    return p


def _embed(cfg: ModelConfig, params: Params, tokens):
    return params["tok_embed"][tokens].to(cfg.dtype)


def _head(cfg: ModelConfig, params: Params, x):
    x = rmsnorm(x, params["final_scale"], cfg.norm_eps)
    return dense(x, params["lm_head"], out_dtype=torch.float32)


def _encode_audio(cfg: ModelConfig, params: Params, frames):
    """The audio encoder over stub frame embeddings (B, S_enc, D): the
    positional embedding added in f32, the encoder's dense layers without
    the causal mask, then ``enc_scale``'s rmsnorm. Returns (B, S_enc, D)
    in ``cfg.dtype``."""
    s = frames.shape[1]
    pos = params["enc_pos_embed"]
    if isinstance(pos, QTensor):
        pos = pos.dequantize(torch.float32)
    x = (frames.to(torch.float32) + pos[None, :s]).to(cfg.dtype)
    positions = torch.arange(s, dtype=torch.int32, device=frames.device)
    for lp in params["enc_layers"]:
        x, _ = layer_forward(cfg, lp, x, positions, kind="dense",
                             causal=False)
    return rmsnorm(x, params["enc_scale"], cfg.norm_eps)


def _memory(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    """What the cross layers attend to, in ``cfg.dtype`` on the tokens'
    device: the vision patches (``batch["vision"]``, (B, n_vision_tokens,
    D)), the audio encoder's output over ``batch["frames"]``; None for the
    other families."""
    dev = batch["tokens"].device
    if cfg.family == "vlm":
        return torch.as_tensor(batch["vision"]).to(dev).to(cfg.dtype)
    if cfg.family == "audio":
        return _encode_audio(cfg, params,
                             torch.as_tensor(batch["frames"]).to(dev))
    return None


def forward_train(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole sequence through every layer, differentiable: ``batch``
    holds ``tokens`` (B, T) (a tensor on the params' device) and the
    memory input of the vision or audio family (``prefill``'s). Returns
    (logits (B, T, V) f32, the MoE layers' summed load-balance loss, an
    f32 scalar; 0 for the other families).

    The layers are the serving path's (``layer_forward``), so with grad
    off every value is the bits ``prefill`` computes. Under autograd with
    ``cfg.remat`` each layer runs in ``torch.utils.checkpoint`` (its
    activations recomputed in the backward, as the reference's
    ``jax.checkpoint``); a cross layer projects the memory to its K/V
    inside its checkpoint, the audio encoder runs outside them, as in the
    reference."""
    _check_family(cfg)
    tokens = batch["tokens"]
    t = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device)
    mem = _memory(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp, kind in zip(params["layers"], layer_kinds(cfg)):
        def layer(h, lp=lp, kind=kind):
            kv = memory_kv(cfg, lp, mem) if kind in CROSS_KINDS else None
            h, out = layer_forward(cfg, lp, h, positions, kind=kind, mem=kv)
            return h, out.get("moe_aux")
        if remat:
            x, layer_aux = checkpoint(layer, x, use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            x, layer_aux = layer(x)
        if layer_aux is not None:
            aux = aux + layer_aux
    return _head(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            aux_weight: float = 0.01):
    """Next-token cross entropy of ``forward_train``'s logits, the mean
    over the (B, T - 1) targets (or their ``batch["mask"]``ed mean), plus
    ``aux_weight`` times the MoE load-balance loss. Returns (loss f32
    scalar, {"nll", "aux"}). Without grad it evaluates any tree the
    engines serve, a direct-cast one included (its projections through
    the dequant GEMM: the paper's direct-cast evaluation)."""
    logits, aux = forward_train(cfg, params, batch)
    targets = batch["tokens"][:, 1:].long()
    lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is not None:
        m = mask[:, 1:].to(torch.float32)
        loss = torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    else:
        loss = torch.mean(nll)
    return loss + aux_weight * aux, {"nll": loss, "aux": aux}


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            max_len: int, kv_fmt: Optional[str],
            act_fmt: Optional[str] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the full prompt, build the cache. Returns (last logits (B, V)
    f32, cache).

    ``batch`` holds ``tokens`` (B, T), and for the vision family
    ``vision`` (B, n_vision_tokens, D), for the audio family ``frames``
    (B, n_audio_frames, D) (stub embeddings, f32): each cross layer
    projects the memory (the vision patches in ``cfg.dtype``, the audio
    encoder's output) to its K/V once (``attention.memory_kv``) and keeps
    them in its cache. ``act_fmt`` (e.g. "amxfp4") quantizes each layer's
    GEMM inputs, so every projection runs quantized x quantized; None
    keeps dense activations. The vision and audio families keep dense
    activations whatever ``act_fmt`` says, as in the reference. Decode
    always runs with dense activations.
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    b, t = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device)
    mem = _memory(cfg, params, batch)
    if mem is not None:
        act_fmt = None
    layers = []
    for lp, kind in zip(params["layers"], layer_kinds(cfg)):
        entries, kv = {}, None
        if kind in CROSS_KINDS:
            kv = memory_kv(cfg, lp, mem)
        x, out = layer_forward(cfg, lp, x, positions, act_fmt=act_fmt,
                               kind=kind, mem=kv)
        if "k" in out:
            entries.update(write_prefill(cfg, out["k"], out["v"], kv_fmt,
                                         max_len))
        if "ssm_h" in out:
            entries.update(h=out["ssm_h"], conv=out["ssm_conv"])
        if kv is not None:
            entries.update(mem_k=kv[0], mem_v=kv[1])
        layers.append(entries)
    cache = {"pos": torch.full((b,), t, dtype=torch.int32,
                               device=tokens.device),
             "layers": layers}
    logits = _head(cfg, params, x[:, -1:])
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# chunked prefill: a resumable fixed-shape partial prefill (the serving lane)
# ---------------------------------------------------------------------------

def _check_p_chunk(cfg: ModelConfig, p_chunk: int) -> None:
    """The lane chunk's static invariants: a positive width, no wider than
    a sliding window (a wider chunk would write two of its rows to one
    ring row), and for a Mamba block a multiple of ``ssm_chunk`` (the
    scan's chunks must fall where the whole prompt's fall, or the chunked
    prefill would give other bits, silently)."""
    _check_family(cfg, STACK_FAMILIES)
    if p_chunk < 1:
        raise ValueError(f"p_chunk ({p_chunk}) must be >= 1")
    if cfg.sliding_window and p_chunk > cfg.sliding_window:
        raise ValueError(f"p_chunk ({p_chunk}) must be <= sliding_window "
                         f"({cfg.sliding_window})")
    if cfg.has_mamba and p_chunk % cfg.ssm_chunk:
        raise ValueError(f"p_chunk ({p_chunk}) must be a multiple of "
                         f"ssm_chunk ({cfg.ssm_chunk})")


def init_lane(cfg: ModelConfig, max_len: int, p_chunk: int,
              device=None) -> Dict[str, Any]:
    """The chunked-prefill lane's scratch for one in-flight prompt: per
    layer a dense natural-order K/V buffer (1, R, KVH, hd) in
    ``cfg.dtype``, R = ``ceil(max_len / p_chunk) * p_chunk`` rows, which
    the next chunk attends over: the values the whole-prompt prefill
    attends over, which makes chunked equal to whole bit for bit also
    when the live cache is NxFP-packed. Stale rows need no reset between
    prompts: attention masks rows past the valid length to exact-zero
    contributions. A sliding-window prompt longer than R runs its later
    chunks through the ring lane (``prefill_chunk(wrapped=True)``), which
    R >= window + P allows. A Mamba block's layer also carries the
    recurrent state between chunks (``h``, ``conv``, batch 1), which
    ``prefill_chunk`` zeroes at offset 0; an attention-free layer has no
    K/V scratch. Returns ``{"layers": [{"k", "v", "h", "conv"}, ...]}``.
    (The reference's ``n_lanes`` stacks one lane a shard; the port's
    sharded engine gives each shard an engine, and so a lane, of its
    own.)"""
    _check_p_chunk(cfg, p_chunk)
    dev = resolve_device(device)
    rows = -(-max_len // p_chunk) * p_chunk
    shape = (1, rows, cfg.n_kv_heads, cfg.hd)

    def layer():
        out = _state_entries(cfg, 1, dev)
        if not cfg.attn_free:
            out.update(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                       v=torch.zeros(shape, dtype=cfg.dtype, device=dev))
        return out

    return {"layers": [layer() for _ in range(cfg.n_layers)]}


def _device_int(x, device):
    """An int or a tensor as a (1,) int32 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(1)


def prefill_chunk(cfg: ModelConfig, params: Params, tokens, cache, slot,
                  offset, n_valid, lane, kv_fmt: Optional[str],
                  with_head: bool = True, act_fmt: Optional[str] = None,
                  wrapped: bool = False):
    """Advance an in-flight prefill by one fixed-shape (1, P) chunk.

    ``tokens`` (1, P) holds prompt positions [offset, offset + P),
    padded past ``n_valid``. The chunk's K/V go into slot ``slot`` of the
    live ``cache`` at their global rows (dense, or NxFP-packed by the
    quantizer), the lane keeps the dense attention scratch for the next
    chunk, and the hidden row at the chunk's last valid position goes
    through the head: on the prompt's final chunk, the whole-prompt
    ``prefill``'s last-token logits, bit for bit; a Mamba block's state
    rides the lane across chunks and goes into the slot's state. ``slot``,
    ``offset`` and ``n_valid`` are ints or (1,) int32 tensors on the
    device, read there: the shapes do not depend on them and nothing syncs with the
    host, so one captured CUDA graph serves every chunk of every prompt.

    ``with_head=False`` skips the (D, V) head and returns the last valid
    hidden row (1, D): only the final chunk's logits are read.
    ``act_fmt`` quantizes the chunk's GEMM inputs as ``prefill``'s does.
    ``wrapped`` selects the ring lane for a sliding-window prompt's chunks
    at offsets past the lane's rows (``attention.self_attention_resume``):
    a second static variant, so an engine keeps a graph for each.
    ``cache["pos"][slot]`` stays as it is (the engine parks the slot
    while it prefills and arms it after the final chunk). Cache and lane
    are updated in place. Returns (logits (1, V) f32, or the hidden row
    (1, D), cache, lane).
    """
    b, p = tokens.shape
    if b != 1:
        raise ValueError(f"prefill_chunk takes one (1, P) chunk, got "
                         f"{tuple(tokens.shape)}")
    _check_p_chunk(cfg, p)
    dev = tokens.device
    slot, offset, n_valid = (_device_int(a, dev)
                             for a in (slot, offset, n_valid))
    x = _embed(cfg, params, tokens)
    positions = offset + torch.arange(p, dtype=torch.int32, device=dev)
    for lp, ll, lc in zip(params["layers"], lane["layers"], cache["layers"]):
        x = layer_prefill_chunk(cfg, lp, x, ll, lc, slot, positions, offset,
                                n_valid, kv_fmt, act_fmt=act_fmt,
                                wrapped=wrapped)
    last = x.index_select(1, (n_valid - 1).clamp(min=0).long())
    if not with_head:
        return last[:, 0], cache, lane
    return _head(cfg, params, last)[:, 0], cache, lane


def decode_step(cfg: ModelConfig, params: Params, tokens, cache,
                kv_fmt: Optional[str], live=None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens (B, 1). Returns (logits (B, V) f32, cache with ``pos``
    advanced). The layer caches are updated in place.

    ``live`` (B,) bool (the continuous engine) freezes a not-live slot: it
    writes no K/V row, its Mamba state and its ``pos`` stay; live slots
    are bit-identical to ``live=None``. A row's logits do not depend on
    the other rows of the batch (``tests/test_torch_continuous.py`` holds
    it bitwise)."""
    pos = cache["pos"]
    x = _embed(cfg, params, tokens)
    for lp, lc, kind in zip(params["layers"], cache["layers"],
                            layer_kinds(cfg)):
        x, _ = layer_decode(cfg, lp, x, lc, pos, kv_fmt, live, kind=kind)
    logits = _head(cfg, params, x)
    step = 1 if live is None else live.to(pos.dtype)
    return logits[:, 0], {"pos": pos + step, "layers": cache["layers"]}


def decode_loop(cfg: ModelConfig, params: Params, tok, cache, n_steps: int,
                kv_fmt: Optional[str],
                sample_fn: Callable[[torch.Tensor], torch.Tensor],
                live=None, logits_fn=None, probe_fn=None):
    """``n_steps`` decode steps on the device, sampling included.

    ``tok`` (B,) is the token entering the loop (already sampled from the
    previous logits). Each step records it, advances the model and samples
    the successor with ``sample_fn(logits (B, V) f32) -> (B,)``. Nothing is
    copied to the host. ``live`` is ``decode_step``'s, for every step.
    ``logits_fn`` (optional) rewrites each step's logits before sampling
    (the serving engines' fault hook: a ``torch.where`` on an all-False
    mask returns them bit for bit); ``probe_fn`` (optional) maps each
    step's rewritten logits to a per-step result (the finite-logits
    sentinel), returned stacked on axis 0 as a fourth element.
    Returns (tokens (B, n_steps), tok, cache[, probes]): the emitted tokens
    start with the entering token; the returned ``tok`` enters the next
    chunk.
    """
    out, aux = [], []
    for _ in range(n_steps):
        out.append(tok)
        logits, cache = decode_step(cfg, params, tok[:, None], cache, kv_fmt,
                                    live)
        if logits_fn is not None:
            logits = logits_fn(logits)
        if probe_fn is not None:
            aux.append(probe_fn(logits))
        tok = sample_fn(logits).to(torch.int32)
    if probe_fn is None:
        return torch.stack(out, dim=1), tok, cache
    return torch.stack(out, dim=1), tok, cache, torch.stack(aux)


# ---------------------------------------------------------------------------
# self-speculative decoding: draft (cheap weights) and verify (target weights)
# ---------------------------------------------------------------------------
#
# The reference gets the rollback of a round for free: its draft and verify
# write into functional copies of the cache that it drops. The port's cache
# is written in place (``kvcache.write_token``, ``blocks._put_state``), so
# a round saves the K/V rows it can write (``kvcache.save_rows``: rows
# ``pos + i``, ring rows in a ring, packed bytes and meta raw) and puts
# them back: all of them after the draft, those past the accepted prefix
# after the verify. Rows outside [0, S) are neither written nor put back.


def save_round(cfg: ModelConfig, cache, q: int, kv_fmt: Optional[str]):
    """What ``q`` decode steps from ``cache["pos"]`` can write, copied:
    every attention layer's rows ``pos + i`` (i < q; ``kvcache.save_rows``)
    and the recurrent state. ``restore_round`` puts it back."""
    pos = cache["pos"]
    return {"pos": pos.clone(),
            "rows": [None if cfg.attn_free else
                     save_rows(cfg, lc, pos, q, kv_fmt)
                     for lc in cache["layers"]],
            "state": [t.clone() for t in recurrent_state(cache)]}


def restore_round(cfg: ModelConfig, cache, saved,
                  kv_fmt: Optional[str]) -> None:
    """Put back, in place, what ``save_round`` copied: the cache is then
    bit for bit the one it was saved from (``pos`` is never moved in
    place)."""
    pos = saved["pos"]
    for lc, rows in zip(cache["layers"], saved["rows"]):
        if rows is not None:
            q = next(iter(rows.values())).shape[1]
            keep = torch.ones((pos.shape[0], q), dtype=torch.bool,
                              device=pos.device)
            restore_rows(cfg, lc, rows, pos, keep, kv_fmt)
    for t, state in zip(recurrent_state(cache), saved["state"]):
        t.copy_(state)


def draft_loop(cfg: ModelConfig, draft_params: Params, tok, cache,
               n_steps: int, kv_fmt: Optional[str],
               sample_fn: Callable[[torch.Tensor], torch.Tensor], live=None,
               with_logits: bool = False):
    """Draft ``n_steps`` candidate tokens a slot with the draft weights,
    leaving the cache as it found it.

    ``n_steps`` decode steps of ``draft_params`` from ``tok`` (B,), each
    successor drawn by ``sample_fn(logits (B, V) f32)`` (``live`` is
    ``decode_step``'s). The steps write their K/V rows and Mamba state
    into the cache in place, as decode does; afterwards the rows they
    wrote and the recurrent state are put back (``save_round``,
    ``restore_round``), bit for bit, and ``cache["pos"]`` never moves. Returns
    (candidates (B, n_steps) int32, the draft logits (n_steps, B, V) f32
    with ``with_logits``, else None): residual sampling reads the draft
    distribution at each candidate."""
    saved = save_round(cfg, cache, n_steps, kv_fmt)
    c, cands, logits_all = cache, [], []
    for _ in range(n_steps):
        logits, c = decode_step(cfg, draft_params, tok[:, None], c, kv_fmt,
                                live)
        if with_logits:
            logits_all.append(logits)
        tok = sample_fn(logits).to(torch.int32)
        cands.append(tok)
    restore_round(cfg, cache, saved, kv_fmt)
    return (torch.stack(cands, dim=1),
            torch.stack(logits_all) if with_logits else None)


def verify_step(cfg: ModelConfig, params: Params, tokens, cache,
                kv_fmt: Optional[str], live=None):
    """Score Q candidate rows a slot in one batched target-weight forward.

    ``tokens`` (B, Q) holds [c_0, c_1, .., c_{Q-1}], the last committed
    token then the draft's candidates, at positions ``pos[b] .. pos[b] + Q
    - 1``. Row i's logits are the bits a sequential ``decode_step`` gives
    after rows < i (``blocks.layer_verify``: products in groups of at most
    16 rows, attention and the recurrence row by row through the decode
    ops), so greedy acceptance emits the plain engine's tokens.

    The Q K/V rows are written into the cache in place (not for a slot
    whose ``live`` entry is false); the Mamba state and ``pos`` are not
    touched. ``commit_verify`` lands an accepted prefix and puts the rest
    back. Returns (logits (B, Q, V) f32, pending)."""
    _check_family(cfg, STACK_FAMILIES)
    pos = cache["pos"]
    x = _embed(cfg, params, tokens)
    pending = []
    for lp, lc in zip(params["layers"], cache["layers"]):
        x, pend = layer_verify(cfg, lp, x, lc, pos, kv_fmt, live)
        pending.append(pend)
    x = rmsnorm(x, params["final_scale"], cfg.norm_eps)
    logits = dense_rows(x, params["lm_head"], out_dtype=torch.float32)
    return logits, {"pos": pos, "layers": pending}


def commit_verify(cfg: ModelConfig, cache, pending, n_commit,
                  kv_fmt: Optional[str], live=None):
    """Land each slot's accepted prefix of a ``verify_step``, in place.

    ``n_commit`` (B,) int in [0, Q]: rows ``pos .. pos + n_commit - 1``
    keep the target K/V the verify wrote, every row past them gets back
    the bytes it held before the verify, the Mamba state jumps to the one
    after the slot's ``n_commit`` steps, and ``pos`` advances by
    ``n_commit``. A slot with ``n_commit == 0`` or ``live`` false keeps
    everything. Afterwards the whole cache is the one ``n_commit``
    sequential ``decode_step`` calls leave, bit for bit. Returns the cache
    (a new ``pos`` tensor, the layers updated in place)."""
    pos = pending["pos"]
    b = pos.shape[0]
    n_commit = n_commit.to(torch.int32)
    live_b = (torch.ones((b,), dtype=torch.bool, device=pos.device)
              if live is None else live)
    commit_any = live_b & (n_commit > 0)
    ar = torch.arange(b, device=pos.device)
    for lc, pend in zip(cache["layers"], pending["layers"]):
        if "rows" in pend:
            q = next(iter(pend["rows"].values())).shape[1]
            i = torch.arange(q, device=pos.device)
            keep = live_b[:, None] & (i[None, :] >= n_commit[:, None])
            restore_rows(cfg, lc, pend["rows"], pos, keep, kv_fmt)
        if "h" in pend:
            idx = (n_commit.long() - 1).clamp(0, pend["h"].shape[1] - 1)
            _put_state(lc["h"], pend["h"][ar, idx], commit_any)
            _put_state(lc["conv"], pend["conv"][ar, idx], commit_any)
    return {"pos": pos + torch.where(live_b, n_commit, 0).to(pos.dtype),
            "layers": cache["layers"]}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_fmt: Optional[str], device=None) -> Dict[str, Any]:
    """A zeroed cache with every slot at position 0: per layer the
    attention K/V (not for the attention-free ``ssm`` family) and the
    Mamba state (``ssm`` and ``hybrid``)."""
    _check_family(cfg, STACK_FAMILIES)
    dev = resolve_device(device)

    def layer():
        out = _state_entries(cfg, batch, dev)
        if not cfg.attn_free:
            out.update(attn_cache_init(cfg, batch, max_len, kv_fmt, dev))
        return out

    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "layers": [layer() for _ in range(cfg.n_layers)]}


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     kv_fmt: Optional[str], n_pages: int, page_size: int,
                     device=None) -> Dict[str, Any]:
    """The paged engine's arena: every slot at position 0, per layer the
    pool buffers of ``n_pages`` pages of ``page_size`` rows, and one
    (batch, P) int32 block table, all null pages, shared by every layer's
    dict (the reference replicates it over L for its scan). A slot's
    logical rows are ``init_cache``'s, so ``decode_step`` and
    ``prefill_chunk`` run on it unchanged. The Mamba state has no sequence
    axis and stays per slot (``init_cache``'s); an attention-free model
    has no pool and no table at all."""
    _check_family(cfg, STACK_FAMILIES)
    dev = resolve_device(device)
    layers = [_state_entries(cfg, batch, dev) for _ in range(cfg.n_layers)]
    if not cfg.attn_free:
        block = None
        for layer in layers:
            layer.update(paged_attn_cache_init(
                cfg, batch, max_len, kv_fmt, n_pages, page_size, dev,
                block=block))
            block = layer["block"]
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "layers": layers}


# ---------------------------------------------------------------------------
# slot surgery: one slot of a live B-slot cache (the continuous engine)
# ---------------------------------------------------------------------------

def _paged_slot_table(layer, slot: int):
    """Slot ``slot``'s block-table row (P,) of a paged layer cache."""
    return layer["block"][slot]


def _write_paged_group(dst: Dict[str, Any], src: Dict[str, Any],
                       slot: int) -> None:
    """Copy a dense-layout batch-1 layer cache ``src`` (k/v/k_packed/...,
    (1, S, ...)) into slot ``slot`` of a paged layer cache, page by page
    through the slot's table: rows on a null page (past the slot's
    reservation) are dropped. The per-slot buffers beside the pool (the
    Mamba state) take the slot's row. Reads the table row on the host."""
    row = _paged_slot_table(dst, slot)
    keep = torch.nonzero(row).flatten()
    pages = row[keep].long()
    for name, pool in dst.items():
        if name == "block":
            continue
        if not name.startswith(_POOL_PREFIX):       # the Mamba state
            pool[slot:slot + 1].copy_(src[name])
        else:
            vals = src[name[len(_POOL_PREFIX):]][0]
            vals = vals.reshape(row.shape[0], pool.shape[1], *vals.shape[1:])
            bit_view(pool).index_copy_(0, pages, bit_view(
                vals.index_select(0, keep).to(pool.dtype)))


def _read_paged_group(layer: Dict[str, Any], slot: int) -> Dict[str, Any]:
    """Slot ``slot`` of a paged layer cache gathered into the dense
    batch-1 layout under the dense names (the inverse of
    ``_write_paged_group`` on the reserved rows), with its per-slot
    buffers' rows."""
    out = paged_layer_view(
        dict(layer, block=_paged_slot_table(layer, slot)[None]))
    out.update({name: buf[slot:slot + 1].clone()
                for name, buf in layer.items()
                if name != "block" and not name.startswith(_POOL_PREFIX)})
    return out


def write_cache_slot(cache: Dict[str, Any], solo: Dict[str, Any],
                     slot: int) -> Dict[str, Any]:
    """Copy a batch-1 cache (a batch-1 ``prefill``'s) into slot ``slot``,
    in place: every layer buffer's ``slot:slot+1`` (contiguous) and
    ``pos[slot]``; a paged layer through the slot's block table
    (``_write_paged_group``). Neighbour slots are untouched. Returns
    ``cache``."""
    cache["pos"][slot:slot + 1].copy_(solo["pos"])
    for dst, src in zip(cache["layers"], solo["layers"]):
        if "block" in dst:
            _write_paged_group(dst, src, slot)
            continue
        for name, buf in dst.items():
            buf[slot:slot + 1].copy_(src[name])
    return cache


def read_cache_slot(cache: Dict[str, Any], slot: int) -> Dict[str, Any]:
    """Slot ``slot`` as a batch-1 cache (a copy; the inverse of
    ``write_cache_slot``, bit for bit: packed bytes are copied raw). A
    paged layer comes back in the dense layout (``_read_paged_group``)."""
    return {"pos": cache["pos"][slot:slot + 1].clone(),
            "layers": [_read_paged_group(layer, slot) if "block" in layer
                       else {name: buf[slot:slot + 1].clone()
                             for name, buf in layer.items()}
                       for layer in cache["layers"]]}


def prefill_into_slot(cfg: ModelConfig, params: Params,
                      batch: Dict[str, Any], cache: Dict[str, Any],
                      slot: int, max_len: int, kv_fmt: Optional[str],
                      act_fmt: Optional[str] = None):
    """Prefill one request (batch-1 ``tokens``) into slot ``slot`` of a
    live cache, in place: the ordinary batch-1 ``prefill`` (so its K/V and
    logits are those of serving it alone), then ``write_cache_slot`` of
    its whole cache (rows past the prompt are zero, as the reference's
    scatter leaves them). ``act_fmt`` is ``prefill``'s (the quantized-
    activation prefill of a serving tier). Returns (last logits (1, V),
    cache)."""
    if batch["tokens"].shape[0] != 1:
        raise ValueError(f"prefill_into_slot takes one request, got "
                         f"{tuple(batch['tokens'].shape)}")
    logits, solo = prefill(cfg, params, batch, max_len, kv_fmt,
                           act_fmt=act_fmt)
    return logits, write_cache_slot(cache, solo, slot)


def reset_slot(cfg: ModelConfig, cache: Dict[str, Any],
               slot: int) -> Dict[str, Any]:
    """Park a finished slot, in place: ``pos[slot] = 0`` and its Mamba
    state zeroed (``ssm.reset_state_slot``: the recurrent state feeds
    forward unmasked). Its K/V rows stay stale on purpose: reads are
    masked to ``pos`` and an admission overwrites the whole slot. Returns
    ``cache``."""
    cache["pos"][slot] = 0
    if cfg.has_mamba:
        for layer in cache["layers"]:
            reset_state_slot(layer["h"], layer["conv"], slot)
    return cache
