"""Prefill self-attention (causal, optionally sliding-window; the audio
encoder's without the causal mask), cross attention to a precomputed
memory (vision patches, the audio encoder's output) and GQA projections.

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
the tiles past its last key change nothing. On CUDA the products also run
in calls of a fixed count (``_bmm``): cuBLAS picks its kernel from the
batch count too. A sliding window masks keys
``window`` or more positions back, and the whole prefill visits only the
key tiles that meet a query chunk's band (``BANDED_SWA``): a tile masked
for every query leaves (m, l, acc) bit-unchanged, so banded and unbanded
attention give the same bits. Decode attention goes through
``kernels.ops.decode_attention`` (packed) and ``decode_attention_dense``.

``cfg.kv_sim_fmt`` (the paper's section 7.1 quantized-KV simulation)
fake-quantizes the rope'd prefill K and V before attention, as the
reference does, through ``kernels.ops.fake_quant_rows``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ops import fake_quant_rows, needs_grad
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
# sliding-window prefill visits only the key tiles that meet the window
# band of a query chunk (the reference's ``BANDED_SWA``)
BANDED_SWA = True


def _f32(x):
    """``x`` as a contiguous f32 tensor: one copy kernel, whatever its
    strides (a permuted or expanded view)."""
    return x.to(torch.float32, memory_format=torch.contiguous_format)


def _pad_rows(x, rows: int):
    """x (B, T, ...) zero-padded to ``rows`` along T (no copy when T is
    ``rows`` already)."""
    pad = rows - x.shape[1]
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad)) if pad else x


# on CUDA the tiles' products run in calls of exactly this many (``_bmm``)
BMM_GROUP = 64


def _padded(x, n: int):
    """x (m, ...) as a contiguous (n, ...) tensor, rows past m zero: x
    itself where it is one already (its groups then have a new buffer's
    shapes and strides), else a new buffer."""
    if x.shape[0] == n and x.is_contiguous():
        return x
    buf = x.new_zeros((n,) + tuple(x.shape[1:]))
    buf[:x.shape[0]].copy_(x)
    return buf


def _bmm(a, b, trans_b: bool = False):
    """The products a (n, m, k) @ b (n, k, p) (``trans_b``: b (n, p, k),
    transposed), f32. On CUDA they run in calls of exactly ``BMM_GROUP``
    products over contiguous buffers, the last zero-padded: cuBLAS picks
    its kernel, and with it a product's order of sums, from the batch
    count as well as the shapes (Whisper's 16 x 64 query tiles over a
    256-key tile gave other bits in 192 products than in 48: a B 4
    prefill's row was not the row prefilled alone), so a product's bits
    do not depend on how many share its call (the batch, the prompt
    length, the lane's chunk). On the CPU one ``torch.bmm``. Under
    autograd the same route runs in ``_Bmm``."""
    if needs_grad(a, b):
        return _Bmm.apply(a, b, trans_b)
    return _bmm_route(a, b, trans_b)


class _Bmm(torch.autograd.Function):
    """``_bmm`` under autograd: the forward is its route, bit for bit; the
    backward is the plain f32 products of the gradients (the operands are
    f32 here, so nothing is rounded)."""

    @staticmethod
    def forward(ctx, a, b, trans_b):
        ctx.trans_b = trans_b
        ctx.save_for_backward(a, b)
        return _bmm_route(a, b, trans_b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b if ctx.trans_b else b.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            gb = (torch.bmm(g.transpose(1, 2), a) if ctx.trans_b
                  else torch.bmm(a.transpose(1, 2), g))
        return ga, gb, None


def _bmm_route(a, b, trans_b: bool):
    """``_bmm``'s products as serving runs them."""
    if a.device.type != "cuda":
        return torch.bmm(a, b.transpose(1, 2) if trans_b else b)
    n = a.shape[0]
    n_pad = -(-n // BMM_GROUP) * BMM_GROUP
    a, b = _padded(a, n_pad), _padded(b, n_pad)
    if trans_b:
        b = b.transpose(1, 2)
    out = torch.empty((n_pad, a.shape[1], b.shape[2]), dtype=torch.float32,
                      device=a.device)
    for i in range(0, n_pad, BMM_GROUP):
        torch.bmm(a[i:i + BMM_GROUP], b[i:i + BMM_GROUP],
                  out=out[i:i + BMM_GROUP])
    return out[:n]


def attend_chunked(q, k, v, *, causal: bool = True, window=None,
                   q_offset=0, kv_valid=None, chunk_q: int = 1024):
    """Attention of q (B, Tq, KVH, G, D), rope'd and scaled, over k, v
    (B, Tk, KVH, D). Returns (B, Tq, KVH, G, D) f32.

    ``causal`` masks keys past the query's position (False: the audio
    encoder and cross attention, every valid key). ``window`` masks keys
    ``window`` or more positions before the query (sliding-window
    attention); with an int ``q_offset`` only the key tiles inside a
    query chunk's band run (``BANDED_SWA``). ``q_offset``
    is q[0]'s global position (an int, or an int tensor on the device, as
    the lane's graph reads it); ``kv_valid`` (B,) int tensor, the keys
    past which are masked (default: all Tk). Keys run in
    tiles of ``KV_TILE`` (Tk zero-padded to a whole tile) through the
    reference's online softmax; a tile wholly masked for a query leaves
    its running max, sum and output bit-unchanged (alpha = exp(0) = 1,
    p = 0), so stale or padded rows past ``kv_valid`` never perturb it.
    Queries run in chunks of ``chunk_q`` (a multiple of ``Q_TILE`` at
    least), each cut into ``Q_TILE`` rows a product: a key tile's
    products with every query tile are the batch of one ``bmm`` (on CUDA
    of fixed-size groups of them, ``_bmm``)."""
    b, tq, kvh, g, d = q.shape
    tk = k.shape[1]
    nk = -(-tk // KV_TILE)
    rows = nk * KV_TILE
    kpos = torch.arange(rows, device=q.device)
    valid = (kpos < (tk if kv_valid is None else kv_valid.reshape(-1, 1))
             ).reshape(-1, 1, 1, 1, 1, rows)
    k, v = _pad_rows(k, rows), _pad_rows(v, rows)
    cq = -(-min(chunk_q, tq) // Q_TILE) * Q_TILE
    banded = BANDED_SWA and window is not None and isinstance(q_offset, int)
    outs = []
    for q0 in range(0, tq, cq):
        n = min(cq, tq - q0)
        nq = -(-n // Q_TILE)
        # the key tiles this chunk visits: all, or its window band (the
        # others are masked for every query of the chunk)
        lo, hi = 0, nk
        if banded:
            lo = max(0, (q_offset + q0 - window + 1) // KV_TILE)
            hi = min(nk, (q_offset + q0 + n - 1) // KV_TILE + 1)
        qi = _pad_rows(q[:, q0:q0 + n], nq * Q_TILE)
        # (B, KVH, nq, G, QT, D): rows (G, QT) of one product each
        qt = _f32(qi.reshape(b, nq, Q_TILE, kvh, g, d).permute(
            0, 3, 1, 4, 2, 5)).reshape(-1, g * Q_TILE, d)
        # (B, KVH, nq, tiles, KT, D): each key tile once per query tile
        kt, vt = (_f32(a[:, lo * KV_TILE:hi * KV_TILE].reshape(
            b, hi - lo, KV_TILE, kvh, d).permute(0, 3, 1, 2, 4)[:, :, None]
            .expand(b, kvh, nq, hi - lo, KV_TILE, d)) for a in (k, v))
        qpos = (q_offset + q0 + torch.arange(nq * Q_TILE, device=q.device)
                ).reshape(nq, 1, Q_TILE, 1)
        # (B|1, 1, nq, 1, QT, rows); without the causal term (B|1, 1, 1,
        # 1, 1, rows)
        mask = valid & (kpos <= qpos) if causal else valid
        if window is not None:
            mask = mask & (qpos - kpos < window)
        for j in range(lo, hi):
            s = _bmm(qt, kt[:, :, :, j - lo].reshape(-1, KV_TILE, d),
                     trans_b=True).reshape(b, kvh, nq, g, Q_TILE, KV_TILE)
            mj = mask[..., j * KV_TILE:(j + 1) * KV_TILE]
            s = torch.where(mj, s, _NEG)
            # the first tile's max(-1e30, max s) is max s: s >= -1e30
            m_new = s.amax(dim=-1) if j == lo else torch.maximum(
                m, s.amax(dim=-1))
            p = torch.where(mj, torch.exp(s - m_new[..., None]), 0.0)
            pv = _bmm(p.to(v.dtype).to(torch.float32).reshape(
                -1, g * Q_TILE, KV_TILE), vt[:, :, :, j - lo].reshape(
                    -1, KV_TILE, d)).reshape(b, kvh, nq, g, Q_TILE, d)
            if j == lo:     # the reference's 0 * alpha + x, less the ops
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


def gqa_project(cfg: ModelConfig, p, x, xq=None, mm=dense):
    """x (B, T, D) -> q (B, T, KVH, G, hd), k, v (B, T, KVH, hd).

    ``xq``, a quantized encoding of ``x`` (QTensor, axis -1), feeds all
    three projections from one encode; ``x`` still gives shapes and dtype.
    ``mm`` is the product (``dense_rows`` in the speculative verify).
    """
    b, t, _ = x.shape
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    src = x if xq is None else xq
    q = mm(src, p["wq"], out_dtype=x.dtype).reshape(b, t, kvh, h // kvh, hd)
    k = mm(src, p["wk"], out_dtype=x.dtype).reshape(b, t, kvh, hd)
    v = mm(src, p["wv"], out_dtype=x.dtype).reshape(b, t, kvh, hd)
    return q, k, v


def _kv_sim(cfg: ModelConfig, k, v):
    """The rope'd K/V as a ``cfg.kv_sim_fmt`` cache would hold them (the
    identity when it is None). Under autograd it raises: the reference
    differentiates through its codec's rounding, which the port's cast
    (the quantizer kernel on the card) has no derivative for; evaluate a
    ``kv_sim_fmt`` model without grad."""
    if not cfg.kv_sim_fmt:
        return k, v
    if needs_grad(k, v):
        raise NotImplementedError(
            f"kv_sim_fmt={cfg.kv_sim_fmt!r} under autograd: the reference "
            "differentiates through its codec, and the port's cast has no "
            "derivative; run loss_fn without grad (torch.no_grad())")
    return (fake_quant_rows(k, cfg.kv_sim_fmt),
            fake_quant_rows(v, cfg.kv_sim_fmt))


def self_attention(cfg: ModelConfig, p, x, positions, window=None,
                   act_fmt=None, causal: bool = True):
    """Full-sequence self attention (prefill). x (B, T, D).

    ``window`` is the sliding window (None: full attention); ``causal``
    False drops the causal mask (the audio encoder). ``act_fmt`` encodes
    the layer input once for Q/K/V and the attention output once for W_o
    (qq prefill). Returns (attn out (B, T, D), rope'd k, v (B, T, KVH,
    hd), fake-quantized under ``cfg.kv_sim_fmt``).
    """
    b, t, _ = x.shape
    q, k, v = gqa_project(cfg, p, x, xq=qact(x, act_fmt))
    cos, sin = rope_freqs(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q.reshape(b, t, -1, cfg.hd), cos, sin).reshape(q.shape)
    k = apply_rope(k, cos, sin)
    k, v = _kv_sim(cfg, k, v)
    q = scale_like(q, 1.0 / math.sqrt(cfg.hd))
    o = attend_chunked(q.to(x.dtype), k.to(x.dtype), v.to(x.dtype),
                       causal=causal, window=window)
    o = o.reshape(b, t, cfg.n_heads * cfg.hd).to(x.dtype)
    return dense(qact(o, act_fmt), p["wo"], out_dtype=x.dtype), k, v


def self_attention_resume(cfg: ModelConfig, p, x, lane_k, lane_v, positions,
                          offset, kv_valid, window=None, act_fmt=None,
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

    ``window`` is the sliding window. ``wrapped`` is the ring lane (the
    reference's, for sliding-window prompts longer than the lane's R
    rows; sound when R >= window + P, and only for offsets >= R): the
    chunk's rows go to lane rows ``offset % R``, and the chunk attends
    over a view of the lane gathered in global order from the key tile
    that holds position ``offset + P - R`` on, so that key position x
    sits at row x % ``KV_TILE`` of a tile, as it does in the whole
    prefill, and its products sum as the whole prefill's do. Rows of the
    view older than ``offset + P - R`` (stale, or aliases of later rows)
    lie outside every query's window, and rows past ``kv_valid`` are
    masked. The lane is updated in place. Returns (attn out (1, P, D),
    rope'd chunk k, v (1, P, KVH, hd) for the cache write).
    """
    r_lane = lane_k.shape[1]
    b, t, _ = x.shape
    if wrapped and (window is None or r_lane < window + t):
        raise ValueError(f"the ring lane needs a sliding window and lane "
                         f"rows ({r_lane}) >= window ({window}) + P ({t})")
    q, k, v = gqa_project(cfg, p, x, xq=qact(x, act_fmt))
    cos, sin = rope_freqs(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q.reshape(b, t, -1, cfg.hd), cos, sin).reshape(q.shape)
    k = apply_rope(k, cos, sin)
    k, v = _kv_sim(cfg, k, v)
    at = offset % r_lane if wrapped else offset
    rows = (at.reshape(()) + torch.arange(t, device=x.device)).long()
    lane_k.index_copy_(1, rows, k.to(lane_k.dtype))
    lane_v.index_copy_(1, rows, v.to(lane_v.dtype))
    q = scale_like(q, 1.0 / math.sqrt(cfg.hd))
    read_k, read_v, q_off, valid = lane_k, lane_v, offset, kv_valid
    if wrapped:
        gbase = offset + t - r_lane
        base = gbase - gbase % KV_TILE          # a whole tile, globally
        idx = ((base + torch.arange(r_lane + KV_TILE, device=x.device))
               % r_lane).long()
        read_k, read_v = (lane.index_select(1, idx)
                          for lane in (lane_k, lane_v))
        q_off, valid = offset - base, kv_valid - base
    o = attend_chunked(q.to(x.dtype), read_k.to(x.dtype), read_v.to(x.dtype),
                       window=window, q_offset=q_off, kv_valid=valid)
    o = o.reshape(b, t, cfg.n_heads * cfg.hd).to(x.dtype)
    return dense(qact(o, act_fmt), p["wo"], out_dtype=x.dtype), k, v


def cross_attention(cfg: ModelConfig, p, x, mem_k, mem_v):
    """x (B, T, D) attends to a precomputed memory's K/V (B, S, KVH, hd)
    (``memory_kv``), without rope and without the causal mask, through
    the ``cross_`` projections. Returns (B, T, D)."""
    b, t, _ = x.shape
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = dense(x, p["cross_wq"]).reshape(b, t, kvh, h // kvh, hd)
    q = scale_like(q, 1.0 / math.sqrt(hd))
    o = attend_chunked(q.to(x.dtype), mem_k.to(x.dtype), mem_v.to(x.dtype),
                       causal=False)
    return dense(o.reshape(b, t, h * hd).to(x.dtype), p["cross_wo"])


def memory_kv(cfg: ModelConfig, p, mem):
    """A memory (B, S, D) (vision patches, the audio encoder's output)
    projected once to a layer's cross K/V, each (B, S, KVH, hd) in the
    memory's dtype, contiguous."""
    b, s, _ = mem.shape
    hd, kvh = cfg.hd, cfg.n_kv_heads
    return (dense(mem, p["cross_wk"]).reshape(b, s, kvh, hd),
            dense(mem, p["cross_wv"]).reshape(b, s, kvh, hd))
