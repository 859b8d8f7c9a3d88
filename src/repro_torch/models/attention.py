"""Prefill self-attention (causal, no window) and GQA projections.

The reference runs prefill attention as a doubly chunked online softmax in
XLA (not Pallas). Here it is plain PyTorch: for each chunk of queries, f32
scores against every key, the -1e30 mask, ``exp(s - max)`` zeroed where
masked, the probabilities cast to bf16 before the PV product (f32
accumulation) and a divisor of ``max(l, 1e-30)``. Chunking the queries
bounds the score buffer at full width. Decode attention over the packed
cache goes through ``kernels.ops.decode_attention``.
"""
from __future__ import annotations

import math

import torch

from .common import (ModelConfig, apply_rope, dense, qact, rope_freqs,
                     scale_like)

_NEG = -1e30


def attend_chunked(q, k, v, *, chunk_q: int = 1024):
    """Causal attention of q (B, T, KVH, G, D), rope'd and scaled, over
    k, v (B, T, KVH, D). Returns (B, T, KVH, G, D) f32."""
    tq = q.shape[1]
    kpos = torch.arange(k.shape[1], device=q.device)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    outs = []
    for q0 in range(0, tq, chunk_q):
        qi = q[:, q0:q0 + chunk_q].to(torch.float32)
        cq = qi.shape[1]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kf)        # f32 scores
        qpos = q0 + torch.arange(cq, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]                # (q, k)
        s = torch.where(mask, s, _NEG)
        m = torch.clamp(s.amax(dim=-1, keepdim=True), min=_NEG)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd",
                          p.to(v.dtype).to(torch.float32), vf)
        out = pv / torch.clamp(l, min=1e-30)[..., None]      # (B,h,g,q,d)
        outs.append(out.permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1)


def gqa_project(cfg: ModelConfig, p, x, xq=None):
    """x (B, T, D) -> q (B, T, KVH, G, hd), k, v (B, T, KVH, hd).

    ``xq``, a quantized encoding of ``x`` (QTensor, axis -1), feeds all
    three projections from one encode; ``x`` still gives shapes and dtype.
    """
    b, t, _ = x.shape
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    src = x if xq is None else xq
    q = dense(src, p["wq"], out_dtype=x.dtype).reshape(b, t, kvh, h // kvh,
                                                       hd)
    k = dense(src, p["wk"], out_dtype=x.dtype).reshape(b, t, kvh, hd)
    v = dense(src, p["wv"], out_dtype=x.dtype).reshape(b, t, kvh, hd)
    return q, k, v


def self_attention(cfg: ModelConfig, p, x, positions, act_fmt=None):
    """Causal full-sequence self attention (prefill). x (B, T, D).

    ``act_fmt`` encodes the layer input once for Q/K/V and the attention
    output once for W_o (qq prefill). Returns (attn out (B, T, D), rope'd
    k, v (B, T, KVH, hd)).
    """
    b, t, _ = x.shape
    q, k, v = gqa_project(cfg, p, x, xq=qact(x, act_fmt))
    cos, sin = rope_freqs(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q.reshape(b, t, -1, cfg.hd), cos, sin).reshape(q.shape)
    k = apply_rope(k, cos, sin)
    q = scale_like(q, 1.0 / math.sqrt(cfg.hd))
    o = attend_chunked(q.to(x.dtype), k.to(x.dtype), v.to(x.dtype))
    o = o.reshape(b, t, cfg.n_heads * cfg.hd).to(x.dtype)
    return dense(qact(o, act_fmt), p["wo"], out_dtype=x.dtype), k, v
