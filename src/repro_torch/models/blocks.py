"""Dense transformer layer: full-sequence (prefill), one prefill chunk
(the chunked-prefill lane) and one-token decode.

  layer_forward(cfg, p, x, positions, act_fmt)   -> (x, {"k", "v"})
  layer_prefill_chunk(cfg, p, x, lane_l, cache_l, slot, positions, offset,
                      n_valid, kv, act_fmt, wrapped) -> x
  layer_decode(cfg, p, x, layer_cache, pos, kv, live) -> (x, layer_cache)
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .attention import gqa_project, self_attention, self_attention_resume
from .common import (ModelConfig, apply_rope, dense, init_attn, init_mlp,
                     rmsnorm, rope_freqs, swiglu)
from .kvcache import attend_decode, write_prefill_at, write_token

Params = Dict[str, Any]


def init_layer(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    dev = gen.device
    p: Params = {"ln1_scale": torch.ones((d,), dtype=torch.float32,
                                         device=dev)}
    p.update(init_attn(gen, cfg))
    p["ln2_scale"] = torch.ones((d,), dtype=torch.float32, device=dev)
    p.update(init_mlp(gen, d, cfg.d_ff, cfg.n_layers))
    return p


def layer_forward(cfg: ModelConfig, p: Params, x, positions,
                  act_fmt: Optional[str] = None):
    """x (B, T, D) -> (x, {"k", "v"}) for the cache. ``act_fmt`` quantizes
    the GEMM inputs of attention and MLP (qq prefill); None keeps dense
    activations."""
    h = rmsnorm(x, p["ln1_scale"], cfg.norm_eps)
    y, k, v = self_attention(cfg, p, h, positions,
                             window=cfg.sliding_window, act_fmt=act_fmt)
    x = x + y
    h2 = rmsnorm(x, p["ln2_scale"], cfg.norm_eps)
    return x + swiglu(h2, p["mlp_w1"], p["mlp_w3"], p["mlp_w2"],
                      act_fmt=act_fmt), {"k": k, "v": v}


def layer_prefill_chunk(cfg: ModelConfig, p: Params, x, lane_l, cache_l,
                        slot, positions, offset, n_valid,
                        kv_fmt: Optional[str],
                        act_fmt: Optional[str] = None,
                        wrapped: bool = False):
    """One layer of the chunked prefill over a (1, P) chunk x, the dense
    family's ``layer_forward`` resumed: attention reads the lane's dense
    natural-order K/V scratch ``lane_l`` (earlier chunks and this one,
    ``attention.self_attention_resume``; ``wrapped``, its ring lane), so
    every hidden row is the whole prompt's, bit for bit; the chunk's
    rope'd K/V rows also go into slot ``slot`` of the live layer cache
    ``cache_l`` at their global rows, ring rows in a sliding-window cache
    (``kvcache.write_prefill_at``; rows past ``n_valid`` dropped). Lane
    and cache are updated in place. Returns x."""
    h = rmsnorm(x, p["ln1_scale"], cfg.norm_eps)
    y, k, v = self_attention_resume(
        cfg, p, h, lane_l["k"], lane_l["v"], positions, offset,
        offset + n_valid, window=cfg.sliding_window, act_fmt=act_fmt,
        wrapped=wrapped)
    write_prefill_at(cfg, cache_l, k, v, slot, offset, n_valid, kv_fmt)
    x = x + y
    h2 = rmsnorm(x, p["ln2_scale"], cfg.norm_eps)
    return x + swiglu(h2, p["mlp_w1"], p["mlp_w3"], p["mlp_w2"],
                      act_fmt=act_fmt)


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


def layer_decode(cfg: ModelConfig, p: Params, x, layer_cache, pos,
                 kv_fmt: Optional[str], live=None):
    """x (B, 1, D) -> (x, layer_cache), the cache updated in place.
    ``live`` (B,) bool: a not-live slot runs through the batch but writes
    no K/V row (``kvcache.write_token``)."""
    h = rmsnorm(x, p["ln1_scale"], cfg.norm_eps)
    x = x + _attn_decode(cfg, p, h, layer_cache, pos, kv_fmt, live)
    h2 = rmsnorm(x, p["ln2_scale"], cfg.norm_eps)
    return (x + swiglu(h2, p["mlp_w1"], p["mlp_w3"], p["mlp_w2"]),
            layer_cache)
