"""Prefill self-attention (causal, no window) and GQA projections.

The reference runs prefill attention as a doubly chunked online softmax in
XLA (not Pallas). Here it is plain PyTorch, the same recurrence: f32
scores of a query tile against each key tile, the -1e30 mask,
``exp(s - m)`` zeroed where masked, the probabilities cast to bf16 before
the PV product (f32 accumulation) and a divisor of ``max(l, 1e-30)``.

The tiles have fixed widths (``KV_TILE`` keys, ``Q_TILE`` queries a
product): on CUDA and in MKL the order of a product's or a reduction's
sums follows its shape, and the whole prompt's T keys and the lane's R
scratch rows would otherwise reduce in different orders. With fixed tiles
a query row meets the same products whether its prompt runs whole
(``self_attention``) or in lane chunks (``self_attention_resume``), and
the tiles past its last key change nothing. Decode attention over the
packed cache goes through ``kernels.ops.decode_attention``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import (ModelConfig, apply_rope, dense, qact, rope_freqs,
                     scale_like)

_NEG = -1e30


# keys per tile of the online softmax, and queries per product: every
# product and row reduction of a prefill has one shape whatever the prompt
# length, so a query row's result is the same bits whether the prompt runs
# whole or in the chunked-prefill lane's (1, P) chunks (module docstring).
# One 256-key tile covers the main path's prompts (128 to 256 tokens), so
# the whole prefill pays one pass of the recurrence; the lane's scratch
# (ceil(max_len / P) * P rows) runs a pass a tile.
KV_TILE = 256
Q_TILE = 16


def _f32(x):
    """``x`` as a contiguous f32 tensor: one copy kernel, whatever its
    strides (a permuted or expanded view)."""
    return x.to(torch.float32, memory_format=torch.contiguous_format)


def _pad_rows(x, rows: int):
    """x (B, T, ...) zero-padded to ``rows`` along T (no copy when T is
    ``rows`` already)."""
    pad = rows - x.shape[1]
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad)) if pad else x


def attend_chunked(q, k, v, *, q_offset=0, kv_valid=None,
                   chunk_q: int = 1024):
    """Causal attention of q (B, Tq, KVH, G, D), rope'd and scaled, over
    k, v (B, Tk, KVH, D). Returns (B, Tq, KVH, G, D) f32.

    ``q_offset`` is q[0]'s global position (an int, or an int tensor on
    the device, as the lane's graph reads it); ``kv_valid`` (B,) int
    tensor, the keys past which are masked (default: all Tk). Keys run in
    tiles of ``KV_TILE`` (Tk zero-padded to a whole tile) through the
    reference's online softmax; a tile wholly masked for a query leaves
    its running max, sum and output bit-unchanged (alpha = exp(0) = 1,
    p = 0), so stale or padded rows past ``kv_valid`` never perturb it.
    Queries run in chunks of ``chunk_q`` (a multiple of ``Q_TILE`` at
    least), each cut into ``Q_TILE`` rows a product: a key tile's
    products with every query tile are the batch of one ``bmm``."""
    b, tq, kvh, g, d = q.shape
    tk = k.shape[1]
    nk = -(-tk // KV_TILE)
    rows = nk * KV_TILE
    kpos = torch.arange(rows, device=q.device)
    valid = (kpos < (tk if kv_valid is None else kv_valid.reshape(-1, 1))
             ).reshape(-1, 1, 1, 1, 1, rows)
    k, v = _pad_rows(k, rows), _pad_rows(v, rows)
    cq = -(-min(chunk_q, tq) // Q_TILE) * Q_TILE
    outs = []
    for q0 in range(0, tq, cq):
        n = min(cq, tq - q0)
        nq = -(-n // Q_TILE)
        qi = _pad_rows(q[:, q0:q0 + n], nq * Q_TILE)
        # (B, KVH, nq, G, QT, D): rows (G, QT) of one product each
        qt = _f32(qi.reshape(b, nq, Q_TILE, kvh, g, d).permute(
            0, 3, 1, 4, 2, 5)).reshape(-1, g * Q_TILE, d)
        # (B, KVH, nq, nk, KT, D): each key tile once per query tile
        kt, vt = (_f32(a.reshape(b, nk, KV_TILE, kvh, d).permute(
            0, 3, 1, 2, 4)[:, :, None].expand(b, kvh, nq, nk, KV_TILE, d))
            for a in (k, v))
        qpos = (q_offset + q0 + torch.arange(nq * Q_TILE, device=q.device)
                ).reshape(nq, 1, Q_TILE, 1)
        mask = valid & (kpos <= qpos)              # (B|1, 1, nq, 1, QT, rows)
        for j in range(nk):
            s = torch.bmm(qt, kt[:, :, :, j].reshape(-1, KV_TILE, d)
                          .transpose(1, 2)).reshape(b, kvh, nq, g, Q_TILE,
                                                    KV_TILE)
            mj = mask[..., j * KV_TILE:(j + 1) * KV_TILE]
            s = torch.where(mj, s, _NEG)
            # the first tile's max(-1e30, max s) is max s: s >= -1e30
            m_new = s.amax(dim=-1) if j == 0 else torch.maximum(
                m, s.amax(dim=-1))
            p = torch.where(mj, torch.exp(s - m_new[..., None]), 0.0)
            pv = torch.bmm(p.to(v.dtype).to(torch.float32).reshape(
                -1, g * Q_TILE, KV_TILE), vt[:, :, :, j].reshape(
                    -1, KV_TILE, d)).reshape(b, kvh, nq, g, Q_TILE, d)
            if j == 0:      # the reference's 0 * alpha + x, less the ops
                l, acc = p.sum(dim=-1), pv
            else:
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,h,n,g,q,d)
        outs.append(out.permute(0, 2, 4, 1, 3, 5).reshape(
            b, nq * Q_TILE, kvh, g, d)[:, :n])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


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


def self_attention_resume(cfg: ModelConfig, p, x, lane_k, lane_v, positions,
                          offset, kv_valid, act_fmt=None,
                          wrapped: bool = False):
    """Resumable prefill attention: one (1, P) chunk of a prompt against
    the lane (the chunked-prefill lane's attention).

    ``lane_k``/``lane_v`` (1, R, KVH, hd) are a dense scratch holding the
    prompt's K/V in natural order (earlier chunks at rows [0, offset)).
    The chunk's K/V are computed as ``self_attention`` computes them (rope
    at the global ``positions``), written into the lane at rows
    ``offset + i`` (``offset`` (1,) int tensor on the device: no host
    sync, so the chunk is capturable), and the chunk attends from
    ``q_offset=offset`` over the ``kv_valid`` (1,) valid rows. Rows past
    ``kv_valid``, stale ones of an earlier prompt included, are masked to
    exact-zero contributions, and the key tiles and query products have
    the whole prefill's shapes (``attend_chunked``), so the outputs are
    the bits ``self_attention`` gives the same rows of the whole prompt.

    ``wrapped``, the reference's ring lane for sliding-window prompts
    longer than the lane, belongs to a family the port does not serve yet
    and raises. The lane is updated in place. Returns (attn out
    (1, P, D), rope'd chunk k, v (1, P, KVH, hd) for the cache write).
    """
    if wrapped:
        raise NotImplementedError("the ring lane serves the sliding-window "
                                  "family, which is not ported")
    b, t, _ = x.shape
    q, k, v = gqa_project(cfg, p, x, xq=qact(x, act_fmt))
    cos, sin = rope_freqs(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q.reshape(b, t, -1, cfg.hd), cos, sin).reshape(q.shape)
    k = apply_rope(k, cos, sin)
    rows = (offset.reshape(()) + torch.arange(t, device=x.device)).long()
    lane_k.index_copy_(1, rows, k.to(lane_k.dtype))
    lane_v.index_copy_(1, rows, v.to(lane_v.dtype))
    q = scale_like(q, 1.0 / math.sqrt(cfg.hd))
    o = attend_chunked(q.to(x.dtype), lane_k.to(x.dtype), lane_v.to(x.dtype),
                       q_offset=offset, kv_valid=kv_valid)
    o = o.reshape(b, t, cfg.n_heads * cfg.hd).to(x.dtype)
    return dense(qact(o, act_fmt), p["wo"], out_dtype=x.dtype), k, v
