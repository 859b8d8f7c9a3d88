"""Attention KV cache: dense bf16 or NxFP-packed, one dict per layer.

The quantized cache is the paper's "weights AND KV cache" configuration
(section 7.1): K/V rows are direct-cast per token (blocks along head_dim)
into packed bytes, and decode attention dequantizes tiles on the fly.

Layout per layer, as the reference's (without its stacked layer axis):
  dense:  k, v            (B, S, KVH, hd) bf16
  packed: k_packed, v_packed (B, S, KVH, NB, bpb) uint8
          k_meta, v_meta     (B, S, KVH, NB) uint16

Positions are per slot: ``pos`` is a (B,) int tensor and each slot writes
and attends at its own offset. A sliding-window model's cache is a ring of
``cfg.sliding_window`` rows: position p lives at row ``p % window``, and a
slot attends over its last ``min(pos + 1, window)`` rows (no paging).
Unlike the reference, ``write_token`` updates the layer's buffers in place
(a decode step owns its cache), which keeps the decode loop free of
per-step copies of the whole cache. A packed cache is written by the
quantizer itself: K and V of a layer in one launch, straight into rows
``pos[b] + t`` (``kernels/nxfp_quantize.py:nxfp_quantize_kv_rows``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.pack import bytes_per_block
from ..core.qtensor import QTensor, fmt_key
from ..core.quantize import resolve_format
from ..kernels.nxfp_quantize import nxfp_quantize_kv_rows
from ..kernels.ops import decode_attention, decode_attention_dense
from .common import ModelConfig


def cache_rows(cfg: ModelConfig, max_len: int) -> int:
    """A slot's cache rows: the window of a sliding-window model (a ring),
    else ``max_len``."""
    return cfg.sliding_window or max_len


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                    kv_fmt: Optional[str], device: torch.device):
    """One layer's zeroed attention cache (``cache_rows`` rows a slot)."""
    kvh, hd, rows = cfg.n_kv_heads, cfg.hd, cache_rows(cfg, max_len)
    if kv_fmt is None:
        shape = (batch, rows, kvh, hd)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    fmt = resolve_format(kv_fmt)
    nb = -(-hd // fmt.block_size)
    bpb = bytes_per_block(fmt.block_size, fmt.bits)

    def z(*tail, dtype):
        return torch.zeros((batch, rows, kvh) + tail, dtype=dtype,
                           device=device)

    return {"k_packed": z(nb, bpb, dtype=torch.uint8),
            "k_meta": z(nb, dtype=torch.uint16),
            "v_packed": z(nb, bpb, dtype=torch.uint8),
            "v_meta": z(nb, dtype=torch.uint16)}


def _ring_place(x, window: int, t: int):
    """The last ``window`` rows of x (B, T, ...) at their ring rows
    (position p at row p % window), (B, window, ...); T <= window pads."""
    if t <= window:
        return torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 2) + (0, window - t))
    return torch.roll(x[:, t - window:], t % window, dims=1)


def write_prefill(cfg: ModelConfig, k, v, kv_fmt: Optional[str],
                  max_len: int):
    """Build one layer's cache from full prefill K/V (B, T, KVH, hd); a
    packed cache takes K and V in one quantizer launch. A ring keeps the
    prompt's last ``window`` rows at rows ``p % window``: each row is cast
    on its own, so placing the inputs is placing the codes."""
    b, t = k.shape[:2]
    cache = attn_cache_init(cfg, b, max_len, kv_fmt, k.device)
    w = cfg.sliding_window
    if w and t > w:
        k, v, t = _ring_place(k, w, t), _ring_place(v, w, t), w
    if kv_fmt is None:
        cache["k"][:, :t] = k.to(cfg.dtype)
        cache["v"][:, :t] = v.to(cfg.dtype)
        return cache
    return nxfp_quantize_kv_rows(k.contiguous(), v.contiguous(), cache, None,
                                 resolve_format(kv_fmt))


def write_prefill_at(cfg: ModelConfig, layer_cache, k, v, slot, offset,
                     n_valid, kv_fmt: Optional[str]):
    """Write one prefill chunk's K/V (1, P, KVH, hd) into slot ``slot`` of
    a live layer cache, in place (the chunked-prefill lane's cache write):
    chunk row i lands at row ``offset + i``, ``(offset + i) % window`` in
    a ring (P <= window, so the rows are distinct); rows i >= ``n_valid``
    (a ragged final chunk's padding) and rows past the cache are dropped.
    ``slot``, ``offset`` and ``n_valid`` are (1,) int32 tensors on the
    device, read there (no host sync: the lane's chunk is capturable). A
    packed cache takes K and V in one quantizer launch (a ring two: rows
    from ``offset % window`` up to the ring's end, then the rest from row
    0, each launch dropping the other's rows); its blocks run along
    head_dim, inside one row, so the bytes are a whole-prompt cast's.
    ``n_valid = 0`` writes nothing. Returns ``layer_cache``."""
    p = k.shape[1]
    w = cfg.sliding_window
    s = layer_cache["k" if kv_fmt is None else "k_packed"].shape[1]
    if p > s:
        raise ValueError(f"chunk of {p} rows over a cache of {s}")
    if kv_fmt is not None:
        fmt = resolve_format(kv_fmt)
        k, v = k.contiguous(), v.contiguous()
        at = offset % w if w else offset
        for start in ((at, at - w) if w else (at,)):
            nxfp_quantize_kv_rows(k, v, layer_cache, start, fmt, slot=slot,
                                  n_valid=n_valid)
        return layer_cache
    i = torch.arange(p, device=k.device)
    if w:
        row = (offset.long() + i) % w
        keep = i < n_valid
    else:
        row = offset.long() + i
        keep = (i < n_valid) & (row < s)
        # a dropped row past the cache writes the value it reads back to
        # row - P, which lies below the chunk: every index is distinct, so
        # the scatter is deterministic, and nothing syncs with the host
        row = torch.where(row < s, row, row - p)
    sl = slot.long()
    for name, val in (("k", k), ("v", v)):
        buf = layer_cache[name]
        buf[sl, row] = torch.where(keep[:, None, None],
                                   val[0].to(buf.dtype), buf[sl, row])
    return layer_cache


def write_token(cfg: ModelConfig, layer_cache, k1, v1, pos,
                kv_fmt: Optional[str], live=None):
    """Write one token's K/V (B, 1, KVH, hd) at per-slot rows ``pos`` (B,)
    (``pos % window`` in a ring, computed on the device), in place; a
    packed cache takes K and V in one quantizer launch, which reads the
    rows on the device. Returns ``layer_cache``.

    ``live`` (B,) bool, when given, suppresses slot b's write where
    ``live[b]`` is false (the continuous engine's parked slots): its row is
    handed on as S, past the cache end. A row outside [0, S) is not
    written, on either device (the reference's ``dynamic_update_slice``
    clamps it to row S - 1 instead). Nothing reads such a row: a slot
    writes past its end only after its request finished (it decodes on to
    the end of the chunk), and the next admission overwrites the whole
    slot, so skipping and clamping cannot be told apart. Live rows are
    bit-identical to ``live=None``."""
    s = layer_cache["k" if kv_fmt is None else "k_packed"].shape[1]
    if cfg.sliding_window:
        pos = pos % cfg.sliding_window
    if live is not None:
        pos = torch.where(live, pos, s)
    if kv_fmt is not None:
        return nxfp_quantize_kv_rows(k1.contiguous(), v1.contiguous(),
                                     layer_cache, pos, resolve_format(kv_fmt))
    # rows outside the cache write their old value back: no host sync, so
    # the write stays capturable in a CUDA graph
    slots = torch.arange(k1.shape[0], device=k1.device)
    inside = ((pos >= 0) & (pos < s))[:, None, None]
    row = pos.clamp(0, s - 1)
    for name, val in (("k", k1), ("v", v1)):
        buf = layer_cache[name]
        buf[slots, row] = torch.where(inside, val[:, 0].to(buf.dtype),
                                      buf[slots, row])
    return layer_cache


def attend_decode(cfg: ModelConfig, layer_cache, q, pos,
                  kv_fmt: Optional[str]):
    """q (B, H, hd) attends to one layer's cache over each slot's own
    valid length ``pos[b] + 1`` (``min(pos[b] + 1, window)`` in a ring,
    on the device). Dense or packed, the kernel's split plan follows the
    cache rows and never the batch, so a row's bits do not depend on the
    other slots. Returns (B, H, hd) f32."""
    b, h, hd = q.shape
    kvh = cfg.n_kv_heads
    lengths = pos + 1
    if cfg.sliding_window:
        lengths = torch.clamp(lengths, max=cfg.sliding_window)

    if kv_fmt is not None:
        fmt = resolve_format(kv_fmt)
        s = layer_cache["k_packed"].shape[1]
        shape = (b, s, kvh, hd)
        kq = QTensor(layer_cache["k_packed"], layer_cache["k_meta"],
                     fmt_key(fmt), shape, -1, hd)
        vq = QTensor(layer_cache["v_packed"], layer_cache["v_meta"],
                     fmt_key(fmt), shape, -1, hd)
        return decode_attention(q, kq, vq, lengths, kvh)

    return decode_attention_dense(q, layer_cache["k"], layer_cache["v"],
                                  lengths, kvh)
