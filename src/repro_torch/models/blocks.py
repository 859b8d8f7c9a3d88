"""Per-kind layers: full-sequence (prefill), one prefill chunk (the
chunked-prefill lane) and one-token decode. A layer's kind is the
reference's (``src/repro/models/blocks.py``), by default its family's:
``dense`` (GQA attention and a SwiGLU MLP), ``moe`` (GQA attention and
the routed-expert FFN, ``models/moe.py``), ``ssm`` (a Mamba block alone),
``hybrid`` (attention and a Mamba head in parallel, averaged, then the
MLP), ``cross`` (the vision family's every ``cross_attn_every``-th layer:
cross attention to the memory's K/V, then the MLP; no self attention and
no K/V of its own) and ``encdec`` (the audio decoder's: self attention,
then cross attention after ``ln3``, then the MLP). The vision family's
other layers and the audio encoder's are ``dense``.

  layer_forward(cfg, p, x, positions, act_fmt, kind, mem, causal)
                                                 -> (x, cache entries)
  layer_prefill_chunk(cfg, p, x, lane_l, cache_l, slot, positions, offset,
                      n_valid, kv, act_fmt, wrapped) -> x
  layer_decode(cfg, p, x, layer_cache, pos, kv, live, kind) -> (x, cache)
  layer_verify(cfg, p, x, layer_cache, pos, kv, live) -> (x, pending)
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..kernels.ops import decode_attention_dense
from ..sharding.ctx import constrain_act
from .attention import (cross_attention, gqa_project, self_attention,
                        self_attention_resume)
from .common import (ModelConfig, apply_rope, dense, dense_rows, init_attn,
                     init_mlp, rmsnorm, rope_freqs, swiglu)
from .kvcache import attend_decode, save_rows, write_prefill_at, write_token
from .moe import init_moe, moe_ffn, moe_ffn_decode
from .ssm import init_mamba, mamba_block, mamba_step

Params = Dict[str, Any]

# a family's layer kind (the vision family's self layers and the audio
# decoder's; ``lm.layer_kinds`` places the cross layers)
_FAMILY_KIND = {"dense": "dense", "moe": "moe", "ssm": "ssm",
                "hybrid": "hybrid", "vlm": "dense", "audio": "encdec"}
# kinds with cross attention to a memory (cache entries mem_k, mem_v)
CROSS_KINDS = ("cross", "encdec")


def family_kind(cfg: ModelConfig) -> str:
    return _FAMILY_KIND[cfg.family]


def _ones(cfg: ModelConfig, dev):
    return torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)


def init_layer(gen: torch.Generator, cfg: ModelConfig,
               kind: Optional[str] = None) -> Params:
    """One layer's weights for ``kind`` (default: the family's)."""
    kind = kind or family_kind(cfg)
    d = cfg.d_model
    dev = gen.device
    p: Params = {"ln1_scale": _ones(cfg, dev)}
    if kind == "ssm":
        p.update(init_mamba(gen, cfg))
        return p
    if kind == "cross":
        p.update({f"cross_{n}": w for n, w in init_attn(gen, cfg).items()})
        p.update(init_mlp(gen, d, cfg.d_ff, cfg.n_layers))
        p["ln2_scale"] = _ones(cfg, dev)
        return p
    p.update(init_attn(gen, cfg))
    p["ln2_scale"] = _ones(cfg, dev)
    if kind == "moe":
        p.update(init_moe(gen, cfg))
        return p
    if kind == "hybrid":
        p.update(init_mamba(gen, cfg))
    if kind == "encdec":
        p.update({f"cross_{n}": w for n, w in init_attn(gen, cfg).items()})
        p["ln3_scale"] = _ones(cfg, dev)
    p.update(init_mlp(gen, d, cfg.d_ff, cfg.n_layers))
    return p


def _mix(cfg: ModelConfig, p: Params, x, attn_y, ssm_y,
         act_fmt: Optional[str] = None, mm=dense, ffn=None, cross=None):
    """The residual add of a layer's attention and/or Mamba outputs (a
    hybrid layer averages the two), then, in an encdec layer, the residual
    add of ``cross(rmsnorm(x, ln3))`` (its cross attention), then the FFN
    where the kind has one: the MLP (its products ``mm``), or ``ffn(h2)``
    (the MoE FFN, whose experts keep dense activations under ``act_fmt``,
    as in the reference)."""
    if attn_y is None:
        return x + ssm_y
    x = x + (attn_y if ssm_y is None else 0.5 * (attn_y + ssm_y))
    if cross is not None:
        x = x + cross(rmsnorm(x, p["ln3_scale"], cfg.norm_eps))
    h2 = rmsnorm(x, p["ln2_scale"], cfg.norm_eps)
    if ffn is not None:
        return x + ffn(h2)
    return x + swiglu(h2, p["mlp_w1"], p["mlp_w3"], p["mlp_w2"],
                      act_fmt=act_fmt, mm=mm)


def layer_forward(cfg: ModelConfig, p: Params, x, positions,
                  act_fmt: Optional[str] = None, kind: Optional[str] = None,
                  mem=None, causal: bool = True):
    """x (B, T, D) -> (x, cache entries): ``k``/``v`` of self attention,
    ``ssm_h``/``ssm_conv`` of the Mamba block (the state after the last
    token), ``moe_aux`` of the MoE FFN (its load-balance loss). ``kind``
    defaults to the family's; a cross or encdec layer attends to ``mem``,
    the memory's (K, V) (``attention.memory_kv``). ``causal`` False drops
    the causal mask (the audio encoder's dense layers). ``act_fmt``
    quantizes the GEMM inputs of self attention and MLP (qq prefill); the
    Mamba block and the MoE FFN keep dense activations, as in the
    reference. None keeps dense activations."""
    kind = kind or family_kind(cfg)
    x = constrain_act(x)  # the residual stream batch-data sharded
    h = rmsnorm(x, p["ln1_scale"], cfg.norm_eps)
    out: Dict[str, Any] = {}
    attn_y = ssm_y = ffn = cross = None
    if kind == "cross":
        attn_y = cross_attention(cfg, p, h, *mem)
    elif kind != "ssm":
        attn_y, out["k"], out["v"] = self_attention(
            cfg, p, h, positions, window=cfg.sliding_window,
            act_fmt=act_fmt, causal=causal)
    if kind in ("ssm", "hybrid"):
        ssm_y, out["ssm_h"], out["ssm_conv"] = mamba_block(cfg, p, h)
    if kind == "moe":
        def ffn(h2):
            y, out["moe_aux"] = moe_ffn(cfg, p, h2)
            return y
    if kind == "encdec":
        def cross(h3):
            return cross_attention(cfg, p, h3, *mem)
    return _mix(cfg, p, x, attn_y, ssm_y, act_fmt, ffn=ffn,
                cross=cross), out


def _refuse_cross(kind: str, what: str) -> None:
    """The reference's refusal of the memory kinds outside prefill and
    decode (``src/repro/models/blocks.py:422``)."""
    if kind in CROSS_KINDS:
        raise NotImplementedError(f"{what} does not support kind={kind!r}")


def layer_prefill_chunk(cfg: ModelConfig, p: Params, x, lane_l, cache_l,
                        slot, positions, offset, n_valid,
                        kv_fmt: Optional[str],
                        act_fmt: Optional[str] = None,
                        wrapped: bool = False):
    """One layer of the chunked prefill over a (1, P) chunk x,
    ``layer_forward`` resumed. Attention reads the lane's dense
    natural-order K/V scratch ``lane_l`` (earlier chunks and this one,
    ``attention.self_attention_resume``; ``wrapped``, its ring lane), so
    every hidden row is the whole prompt's, bit for bit; the chunk's
    rope'd K/V rows also go into slot ``slot`` of the live layer cache
    ``cache_l`` at their global rows, ring rows in a sliding-window cache
    (``kvcache.write_prefill_at``; rows past ``n_valid`` dropped). The
    Mamba block resumes from the lane's recurrent carry (``h``, ``conv``;
    zeros at offset 0, the whole prompt's start), steps past ``n_valid``
    are identity steps, and the carry it leaves also goes into the slot's
    state in the live cache every chunk (a prefilling slot is frozen in
    decode, so the final chunk's carry is what it decodes from). Lane and
    cache are updated in place. Returns x. The memory kinds (cross,
    encdec) raise NotImplementedError, as in the reference."""
    _refuse_cross(family_kind(cfg), "chunked prefill")
    x = constrain_act(x)
    h = rmsnorm(x, p["ln1_scale"], cfg.norm_eps)
    attn_y = ssm_y = None
    if not cfg.attn_free:
        attn_y, k, v = self_attention_resume(
            cfg, p, h, lane_l["k"], lane_l["v"], positions, offset,
            offset + n_valid, window=cfg.sliding_window, act_fmt=act_fmt,
            wrapped=wrapped)
        write_prefill_at(cfg, cache_l, k, v, slot, offset, n_valid, kv_fmt)
    if cfg.has_mamba:
        first = (offset == 0).reshape(1, 1, 1)
        h0 = torch.where(first, 0.0, lane_l["h"])
        conv0 = torch.where(first, 0.0, lane_l["conv"])
        ssm_y, hf, conv = mamba_block(cfg, p, h, h0=h0, conv0=conv0,
                                      n_valid=n_valid)
        lane_l["h"].copy_(hf)
        lane_l["conv"].copy_(conv)
        sl = slot.to(torch.int64)
        cache_l["h"].index_copy_(0, sl, hf)
        cache_l["conv"].index_copy_(0, sl, conv)
    ffn = None
    if cfg.family == "moe":
        valid = torch.arange(x.shape[1], device=x.device) < n_valid

        def ffn(h2):
            return moe_ffn(cfg, p, h2, valid=valid)[0]
    return _mix(cfg, p, x, attn_y, ssm_y, act_fmt, ffn=ffn)


def _attn_decode(cfg: ModelConfig, p: Params, h, layer_cache, pos,
                 kv_fmt: Optional[str], live=None):
    """h (B, 1, D) -> attn out (B, 1, D); writes the token's K/V row
    (not for a slot whose ``live`` entry is false)."""
    b = h.shape[0]
    q, k1, v1 = gqa_project(cfg, p, h)
    positions = pos.reshape(b, 1)
    cos, sin = rope_freqs(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q.reshape(b, 1, -1, cfg.hd), cos, sin).reshape(q.shape)
    k1 = apply_rope(k1, cos, sin)
    write_token(cfg, layer_cache, k1, v1, pos, kv_fmt, live=live)
    o = attend_decode(cfg, layer_cache, q.reshape(b, cfg.n_heads, cfg.hd),
                      pos, kv_fmt)
    o = o.reshape(b, 1, cfg.n_heads * cfg.hd).to(h.dtype)
    return dense(o, p["wo"])


def _put_state(buf, new, live):
    """Write a layer's new recurrent state into its cache buffer (B, ...)
    in place, keeping a not-live slot's (``live`` (B,) bool; None: every
    slot takes it)."""
    if live is not None:
        new = torch.where(live.reshape((-1,) + (1,) * (new.dim() - 1)),
                          new, buf)
    buf.copy_(new)


def _cross_decode(cfg: ModelConfig, p: Params, h, mem_k, mem_v):
    """One token's cross attention over the whole memory (B, S, KVH, hd)
    (the reference's ``_cross_decode``): through the dense-row attention
    (``ops.decode_attention_dense``; on the CPU its plain version, the
    reference's f32 einsum and softmax) with every row valid, so on the
    card a row's bits do not depend on the batch. h (B, 1, D) -> (B, 1,
    D)."""
    b = h.shape[0]
    q = dense(h, p["cross_wq"]).reshape(b, cfg.n_heads, cfg.hd)
    lengths = torch.full((b,), mem_k.shape[1], dtype=torch.int32,
                         device=h.device)
    o = decode_attention_dense(q, mem_k, mem_v, lengths, cfg.n_kv_heads)
    o = o.reshape(b, 1, cfg.n_heads * cfg.hd).to(h.dtype)
    return dense(o, p["cross_wo"])


def layer_decode(cfg: ModelConfig, p: Params, x, layer_cache, pos,
                 kv_fmt: Optional[str], live=None,
                 kind: Optional[str] = None):
    """x (B, 1, D) -> (x, layer_cache), the cache updated in place: the
    token's K/V row, and the Mamba state ``h``/``conv`` (the buffers keep
    their storage, so a captured CUDA graph carries them). ``live`` (B,)
    bool: a not-live slot runs through the batch but writes no K/V row
    (``kvcache.write_token``) and keeps its recurrent state. ``kind``
    defaults to the family's; a cross or encdec layer reads its memory's
    K/V from the cache (``mem_k``, ``mem_v``), which decode never
    writes."""
    kind = kind or family_kind(cfg)
    h = rmsnorm(x, p["ln1_scale"], cfg.norm_eps)
    attn_y = ssm_y = ffn = cross = None
    if kind == "cross":
        attn_y = _cross_decode(cfg, p, h, layer_cache["mem_k"],
                               layer_cache["mem_v"])
    elif kind != "ssm":
        attn_y = _attn_decode(cfg, p, h, layer_cache, pos, kv_fmt, live)
    if kind in ("ssm", "hybrid"):
        ssm_y, hf, conv = mamba_step(cfg, p, h, layer_cache["h"],
                                     layer_cache["conv"])
        _put_state(layer_cache["h"], hf, live)
        _put_state(layer_cache["conv"], conv, live)
    if kind == "moe":
        def ffn(h2):
            return moe_ffn_decode(cfg, p, h2)[0]
    if kind == "encdec":
        def cross(h3):
            return _cross_decode(cfg, p, h3, layer_cache["mem_k"],
                                 layer_cache["mem_v"])
    return _mix(cfg, p, x, attn_y, ssm_y, ffn=ffn, cross=cross), layer_cache


# ---------------------------------------------------------------------------
# the speculative verify: Q candidate rows a slot in one batched forward
# ---------------------------------------------------------------------------

def _attn_verify(cfg: ModelConfig, p: Params, h, layer_cache, pos,
                 kv_fmt: Optional[str], live=None):
    """h (B, Q, D) -> attn out (B, Q, D); row i's K/V written at
    ``pos + i``, in place.

    The q/k/v/o products run once over the B * Q rows, in row groups of
    at most 16 (``dense_rows``: each row the bits of a decode step's row).
    Then row by row the exact decode ops at (B, 1): rope at ``pos + i``,
    ``write_token``, ``attend_decode``. Row i is written before query i
    reads and rows past i are not written yet: a sequential decode's
    memory, sliding-window ring included. A not-live slot writes
    nothing."""
    b, qn, _ = h.shape
    q, k1, v1 = gqa_project(cfg, p, h, mm=dense_rows)
    outs = []
    for i in range(qn):
        pi = pos + i
        cos, sin = rope_freqs(pi.reshape(b, 1), cfg.hd, cfg.rope_theta)
        qi = apply_rope(q[:, i:i + 1].reshape(b, 1, -1, cfg.hd), cos, sin)
        write_token(cfg, layer_cache, apply_rope(k1[:, i:i + 1], cos, sin),
                    v1[:, i:i + 1], pi, kv_fmt, live=live)
        outs.append(attend_decode(cfg, layer_cache,
                                  qi.reshape(b, cfg.n_heads, cfg.hd), pi,
                                  kv_fmt))
    o = torch.stack(outs, dim=1).reshape(b, qn, cfg.n_heads * cfg.hd)
    return dense_rows(o.to(h.dtype), p["wo"])


def _ssm_verify(cfg: ModelConfig, p: Params, h, h0, conv0):
    """h (B, Q, D) -> (out (B, Q, D), states h (B, Q, di, N), conv (B, Q,
    cw - 1, di)): Q ``mamba_step`` calls at the decode shapes (the
    recurrence does not batch; the same op keeps each step the sequential
    decode's bits), every step's state kept so that a commit can jump each
    slot to the state after its own accepted length. Writes nothing."""
    ys, hs, convs = [], [], []
    hh, cc = h0, conv0
    for i in range(h.shape[1]):
        y, hh, cc = mamba_step(cfg, p, h[:, i:i + 1], hh, cc)
        ys.append(y)
        hs.append(hh)
        convs.append(cc)
    return (torch.cat(ys, dim=1), torch.stack(hs, dim=1),
            torch.stack(convs, dim=1))


def layer_verify(cfg: ModelConfig, p: Params, x, layer_cache, pos,
                 kv_fmt: Optional[str], live=None):
    """x (B, Q, D) -> (x, pending): one layer of the speculative verify,
    Q candidate rows a slot at positions ``pos[b] + i``.

    Norms and the MLP run over the (B, Q, D) rows, the products in row
    groups of at most 16 (``dense_rows``); attention and the Mamba
    recurrence run row by row through the exact decode ops. Each row's
    output is the sequential ``layer_decode``'s, bit for bit. Attention
    writes the Q K/V rows into the cache in place; ``pending`` holds what
    ``lm.commit_verify`` needs to land an accepted prefix: the rows those
    writes replaced (``rows``, from ``kvcache.save_rows``) and the Mamba
    state after every step (``h``, ``conv``; the cache's state is not
    touched).

    MoE raises NotImplementedError, as in the reference: its capacity is
    resolved per dispatch, so a (B * Q)-row verify drops other assignments
    than Q one-row decode steps, and no batched verify is bitwise. The
    memory kinds (cross, encdec) raise too, as in the reference."""
    kind = family_kind(cfg)
    if kind == "moe":
        raise NotImplementedError("speculative verify does not support "
                                  "kind='moe'")
    _refuse_cross(kind, "speculative verify")
    h = rmsnorm(x, p["ln1_scale"], cfg.norm_eps)
    pending: Dict[str, Any] = {}
    attn_y = ssm_y = None
    if not cfg.attn_free:
        pending["rows"] = save_rows(cfg, layer_cache, pos, x.shape[1],
                                    kv_fmt)
        attn_y = _attn_verify(cfg, p, h, layer_cache, pos, kv_fmt, live)
    if cfg.has_mamba:
        ssm_y, pending["h"], pending["conv"] = _ssm_verify(
            cfg, p, h, layer_cache["h"], layer_cache["conv"])
    return _mix(cfg, p, x, attn_y, ssm_y, mm=dense_rows), pending
