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

The paged cache (the paged engine, ``serving/paged_engine.py``) keeps each
buffer <name> as a pool twin ``pool_<name>`` of shape (NP, page, ...tail)
and a ``block`` (B, P) int32 table, one tensor shared by every layer's
dict: logical row r of slot b lives at ``pool[block[b, r // page], r %
page]``, and physical page 0 is the null page, never written (a write that
resolves to it is dropped). A slot's logical rows are the dense cache's
(``cache_rows``), so decode attention runs on the gathered view
``pool[block]`` with the dense cache's shape, split plan and bits.

A Mamba block's layer (the ``ssm`` and ``hybrid`` families) holds its
recurrent state beside the K/V buffers (``ssm_cache_init``): ``h``
(B, d_inner, N) f32 and ``conv`` (B, cw - 1, d_inner), per slot in the
paged cache too.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.pack import byte_fold_wide, bytes_per_block
from ..core.qtensor import QTensor, fmt_key
from ..core.quantize import resolve_format
from ..kernels.build import bit_view
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


def ssm_cache_init(cfg: ModelConfig, batch: int, device: torch.device):
    """One layer's zeroed Mamba state: ``h`` (B, d_inner, ssm_state) f32
    and the conv tail ``conv`` (B, conv_width - 1, d_inner) in the
    activation dtype (the prefill emits it so). Constant in the context
    length."""
    di, n, cw = cfg.dinner, cfg.ssm_state, cfg.conv_width
    return {"h": torch.zeros((batch, di, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cw - 1, di), dtype=cfg.dtype,
                                device=device)}


# the pool twin of a dense buffer <name> is "pool_<name>"
_POOL_PREFIX = "pool_"
# a layer cache's K/V buffers: the leaves with a sequence-row axis (1)
_KV_LEAVES = ("k", "v", "k_packed", "k_meta", "v_packed", "v_meta")


def paged_attn_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                          kv_fmt: Optional[str], n_pages: int,
                          page_size: int, device: torch.device, block=None):
    """One layer's zeroed paged attention cache: the dense buffers' pool
    twins of ``n_pages`` pages of ``page_size`` rows, and ``block``, the
    (batch, P) int32 table (all null pages; pass one table to share it
    between layers). ``page_size`` must divide ``cache_rows``."""
    rows = cache_rows(cfg, max_len)
    if rows % page_size:
        raise ValueError(f"page_size {page_size} must divide the slot row "
                         f"capacity {rows} (sliding window or max_len)")
    if block is None:
        block = torch.zeros((batch, rows // page_size), dtype=torch.int32,
                            device=device)
    dense = attn_cache_init(cfg, 1, 1, kv_fmt, device)
    out = {"block": block}
    for name, buf in dense.items():
        out[_POOL_PREFIX + name] = torch.zeros(
            (n_pages, page_size) + tuple(buf.shape[2:]), dtype=buf.dtype,
            device=device)
    return out


def paged_layer_view(layer_cache):
    """One layer's paged pool gathered into the dense (B, S, ...) layout:
    ``pool[block]`` reshaped to (B, P * page, ...), the dense buffers'
    shape, so attention over it is the dense cache's program. Rows mapped
    through the null page (or a stale page) hold garbage bytes, only where
    attention gives them an exactly zero share. A new tensor per call."""
    blk = layer_cache["block"]
    out = {}
    for name, pool in layer_cache.items():
        if name.startswith(_POOL_PREFIX):
            g = _page_words(pool).index_select(0, blk.reshape(-1))
            out[name[len(_POOL_PREFIX):]] = g.view(pool.dtype).reshape(
                blk.shape[0], blk.shape[1] * pool.shape[1], *pool.shape[2:])
    return out


def _page_words(pool):
    """A pool as (NP, words): each page's bytes as the widest integers that
    tile it, so a gather moves pages in 8-byte words and not in elements
    (a packed page is bytes, a meta page uint16, which CUDA cannot index)."""
    n = pool[0].numel() * pool.element_size()
    word = next(dt for dt in (torch.int64, torch.int32, torch.int16,
                              torch.uint8) if n % dt.itemsize == 0)
    return pool.view(pool.shape[0], -1).view(word)


def _pool_dims(layer_cache):
    """(block table, n_pages, page_size) of one layer's paged cache."""
    pool0 = next(v for n, v in layer_cache.items()
                 if n.startswith(_POOL_PREFIX))
    return layer_cache["block"], pool0.shape[0], pool0.shape[1]


def _logical_rows(layer_cache, kv_fmt) -> int:
    """A slot's rows S of a dense or paged layer cache (P * page)."""
    if "block" in layer_cache:
        blk, _, page = _pool_dims(layer_cache)
        return blk.shape[1] * page
    return layer_cache["k" if kv_fmt is None else "k_packed"].shape[1]


def _paged_put(layer_cache, slot, row, keep, vals):
    """Dense-KV paged write: logical rows ``row`` (N,) of slots ``slot``
    (N,) take ``vals[name]`` (N, KVH, hd) where ``keep`` (N,) holds and
    their page is not the null page. Capturable (no host sync): a dropped
    row writes the value it reads back at its target, null page included,
    whose bytes do not change."""
    blk, n_pages, page = _pool_dims(layer_cache)
    pg = blk[slot.clamp(0, blk.shape[0] - 1),
             (row // page).clamp(0, blk.shape[1] - 1)].long()
    keep = keep & (row >= 0) & (row < blk.shape[1] * page) & (pg > 0)
    flat = pg * page + row.clamp(min=0) % page
    for name, val in vals.items():
        pool = layer_cache[_POOL_PREFIX + name]
        view = pool.view(n_pages * page, *pool.shape[2:])
        view[flat] = torch.where(keep[:, None, None], val.to(pool.dtype),
                                 view[flat])
    return layer_cache


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
    ``n_valid = 0`` writes nothing. A paged cache takes the same rows
    through its block table (rows on the null page dropped too). Returns
    ``layer_cache``."""
    p = k.shape[1]
    w = cfg.sliding_window
    block = layer_cache.get("block")
    s = _logical_rows(layer_cache, kv_fmt)
    if p > s:
        raise ValueError(f"chunk of {p} rows over a cache of {s}")
    if kv_fmt is not None:
        fmt = resolve_format(kv_fmt)
        k, v = k.contiguous(), v.contiguous()
        at = offset % w if w else offset
        for start in ((at, at - w) if w else (at,)):
            nxfp_quantize_kv_rows(k, v, layer_cache, start, fmt, slot=slot,
                                  n_valid=n_valid, block=block)
        return layer_cache
    i = torch.arange(p, device=k.device)
    if block is not None:
        row = offset.long() + i
        row = row % w if w else row
        keep = (i < n_valid) & (row < s)
        # as below: a row past the cache reads and writes back row - P
        row = torch.where(row < s, row, row - p)
        return _paged_put(layer_cache, slot.long().expand(p), row, keep,
                          {"k": k[0], "v": v[0]})
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
    bit-identical to ``live=None``. A paged cache takes the rows through
    its block table, dropping rows on the null page."""
    block = layer_cache.get("block")
    s = _logical_rows(layer_cache, kv_fmt)
    if cfg.sliding_window:
        pos = pos % cfg.sliding_window
    if live is not None:
        pos = torch.where(live, pos, s)
    if kv_fmt is not None:
        return nxfp_quantize_kv_rows(k1.contiguous(), v1.contiguous(),
                                     layer_cache, pos, resolve_format(kv_fmt),
                                     block=block)
    if block is not None:
        slots = torch.arange(k1.shape[0], device=k1.device)
        return _paged_put(layer_cache, slots, pos.long(),
                          torch.ones_like(slots, dtype=torch.bool),
                          {"k": k1[:, 0], "v": v1[:, 0]})
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


def _round_rows(cfg: ModelConfig, layer_cache, pos, q: int, kv_fmt):
    """The rows ``pos[b] + i`` (i < q) of every slot, as ``write_token``
    places them: (index, inside (B, q) bool), ``index`` a tuple that picks
    the (B, q) rows out of each buffer of ``_row_buffers``. A ring's rows
    are ``% window`` (distinct: q <= window). A row outside [0, S) is never
    written; it is handed ``row - q``, below the slot's q rows and distinct
    from them, clamped into the cache, so a scatter over the rows has
    distinct indices wherever it writes something new.

    A paged cache's rows are flat pool rows ``page * page_size + r %
    page_size`` through the slot's block table, read on the device (a
    round runs inside a captured graph). A row past S or whose entry is
    the null page is not inside (the K/V write drops it) and is handed its
    null-page row ``r % page_size``: every inside row lies on a page of
    its own slot (a shared page is privatized before a round can reach
    it), so the only indices that repeat are the null page's, whose bytes
    a scatter writes back as it read them."""
    s = _logical_rows(layer_cache, kv_fmt)
    if q > s:
        raise ValueError(f"{q} rows a round over a cache of {s}")
    row = pos.long()[:, None] + torch.arange(q, device=pos.device)[None, :]
    slots = torch.arange(row.shape[0], device=row.device)[:, None]
    if cfg.sliding_window:
        row = row % cfg.sliding_window
        inside = torch.ones_like(row, dtype=torch.bool)
    else:
        inside = (row >= 0) & (row < s)
    if "block" in layer_cache:
        blk, _, page = _pool_dims(layer_cache)
        row = row.clamp(0, s - 1)
        pg = blk[slots, row // page].long()
        inside = inside & (pg > 0)
        return (torch.where(inside, pg * page, 0) + row % page,), inside
    if not cfg.sliding_window:
        row = torch.where(inside, row, row - q).clamp(0, s - 1)
    return (slots, row), inside


def _row_buffers(layer_cache):
    """One layer's K/V buffers under the dense names, as ``bit_view``
    sees them: a dense cache's (B, S, ...) as they are, a paged cache's
    pools as flat (NP * page, ...) views."""
    if "block" not in layer_cache:
        return {name: bit_view(buf) for name, buf in layer_cache.items()
                if name in _KV_LEAVES}
    return {name[len(_POOL_PREFIX):]: bit_view(pool).view(
        pool.shape[0] * pool.shape[1], *pool.shape[2:])
        for name, pool in layer_cache.items()
        if name.startswith(_POOL_PREFIX)}


def save_rows(cfg: ModelConfig, layer_cache, pos, q: int,
              kv_fmt: Optional[str]):
    """Copies of the rows a speculative round may write (``pos[b] + i``,
    i < q; ring rows in a ring) of every K/V buffer of one layer cache:
    {name: (B, q, ...)}, packed bytes and meta raw. A paged cache's rows
    are read through the block table, under the dense names (a row on the
    null page reads its bytes and is never put back). ``restore_rows``
    puts them back."""
    at, _ = _round_rows(cfg, layer_cache, pos, q, kv_fmt)
    return {name: buf[at] for name, buf in _row_buffers(layer_cache).items()}


def restore_rows(cfg: ModelConfig, layer_cache, saved, pos, keep,
                 kv_fmt: Optional[str]):
    """Put back, in place, the saved rows ``pos[b] + i`` of slot b where
    ``keep`` (B, q) holds and the row lies in the cache (a paged cache's:
    on a page of the slot's, not the null page); every other row keeps
    what it holds. No host sync (capturable). Returns ``layer_cache``."""
    q = keep.shape[1]
    at, inside = _round_rows(cfg, layer_cache, pos, q, kv_fmt)
    keep = keep & inside
    for name, buf in _row_buffers(layer_cache).items():
        val = saved[name]
        mask = keep.reshape(keep.shape + (1,) * (val.dim() - 2))
        buf[at] = torch.where(mask, val, buf[at])
    return layer_cache


_M32 = 0xFFFFFFFF


def _layer_fold(layer_cache, names, keep: int) -> torch.Tensor:
    """One layer's leaves ``names`` folded (``byte_fold_wide``) and added:
    int64, not yet reduced mod 2^32."""
    folds = [byte_fold_wide(layer_cache[n], keep) for n in names
             if n in layer_cache]
    return sum(folds[1:], folds[0])


def kv_slot_checksum(cfg: ModelConfig, cache, upto, horizon=None):
    """(B,) int64 canary, values in [0, 2^32), over each slot's K/V rows
    that the next decode chunk cannot write: the reference's uint32
    ``kv_slot_checksum``, bit for bit.

    Decode appends at ``pos``, so the rows a chunk does not write must
    read back the same after it, or the slot's cache was corrupted. Each
    (layer, slot, row) is folded by ``byte_fold`` (bits: packed bytes,
    meta words, bf16 alike) and weighted by the odd ``2 * row + 1``, so a
    flipped byte and two swapped rows both change the sum (mod 2^32).
    ``upto`` (B,) holds each slot's ``pos`` (0: the slot contributes 0).
    With ``horizon`` None the fold covers the prefix ``[0, upto)``; with
    ``horizon`` (scalar or (B,): the most rows the next chunk may write a
    slot) it covers the occupied rows (``row < min(upto, S)``, the whole
    ring once wrapped) less those within ``horizon`` of the write pointer
    in ring distance (``(row - upto) mod S``, floor-mod).

    The folds run a layer at a time (a whole-cache fold would widen
    every byte to 8 at once), in int64 (``byte_fold_wide``). Everything
    is mod 2^32, so the sums may be regrouped: the layers' row folds are
    added first, weighted by row once. A cache without K/V buffers
    returns zeros."""
    pos = cache["pos"]
    b, dev = pos.shape[0], pos.device
    folds = [_layer_fold(lc, _KV_LEAVES, 2) for lc in cache["layers"]
             if any(n in lc for n in _KV_LEAVES)]
    if not folds:
        return torch.zeros((b,), dtype=torch.int64, device=dev)
    s = folds[0].shape[1]
    upto = torch.as_tensor(upto, device=dev).to(torch.int64).reshape(b, 1)
    r = torch.arange(s, dtype=torch.int64, device=dev)[None, :]
    if horizon is None:
        mask = r < upto
    else:
        hz = torch.as_tensor(horizon, device=dev).to(torch.int64)
        mask = (r < upto.clamp(max=s)) & (
            torch.remainder(r - upto, s) >= hz.reshape(-1, 1))
    f = (torch.stack(folds) & _M32).sum(dim=0) & _M32        # (B, S)
    return ((f * ((2 * r + 1) * mask)) & _M32).sum(dim=1) & _M32


def ssm_state_checksum(cfg: ModelConfig, cache):
    """(B,) int64 canary, values in [0, 2^32), over each slot's recurrent
    state (``h``, ``conv``): the reference's uint32 ``ssm_state_checksum``,
    bit for bit. The state changes inside a chunk, so this pins it at
    rest: the fold taken after one chunk must match right before the next
    (the engine disarms a slot whose state it writes in between). Every
    element folds (no row mask), a layer at a time; a cache without
    Mamba state returns zeros."""
    pos = cache["pos"]
    folds = [_layer_fold(lc, ("h", "conv"), 1) for lc in cache["layers"]
             if "h" in lc or "conv" in lc]
    if not folds:
        return torch.zeros((pos.shape[0],), dtype=torch.int64,
                           device=pos.device)
    return (torch.stack(folds) & _M32).sum(dim=0) & _M32


def attend_decode(cfg: ModelConfig, layer_cache, q, pos,
                  kv_fmt: Optional[str]):
    """q (B, H, hd) attends to one layer's cache over each slot's own
    valid length ``pos[b] + 1`` (``min(pos[b] + 1, window)`` in a ring,
    on the device). Dense or packed, the kernel's split plan follows the
    cache rows and never the batch, so a row's bits do not depend on the
    other slots. A paged cache is gathered into the dense layout first
    (``paged_layer_view``: the same shape, so the same split plan and
    bits). Returns (B, H, hd) f32."""
    b, h, hd = q.shape
    kvh = cfg.n_kv_heads
    lengths = pos + 1
    if cfg.sliding_window:
        lengths = torch.clamp(lengths, max=cfg.sliding_window)
    if "block" in layer_cache:
        layer_cache = paged_layer_view(layer_cache)

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
