"""Fused NxFP block quantizer (Algorithm-1 encode + bit-pack).

CUDA kernel: ``csrc/nxfp_quantize_kernels.cuh`` (host entry
``csrc/nxfp_quantize.cu``; replaces the reference's
``kernels/nxfp_quantize.py:nxfp_quantize_pack_pallas``). Plain version:
``nxfp_quantize_pack_plain``, the arithmetic codec of ``core.quantize``
followed by ``core.pack.pack_codes``; the two are bitwise equal. Both take
bf16 or f32 input and the symmetric weight/KV formats, the asymmetric
(``asym``, uint32 meta) and the outlier-mantissa (``ox``) activation
formats, at 2 to 8 bits and block sizes 8 to 128. A custom recycle
value is encoded as the reference's table-driven ``quantize_blocks`` does
(a value on a midpoint takes the lower level), and the plain version is
that encoder; ``nxfp_quantize_pack(table=True)`` asks for that encoder for
any code-recycling format (the reference's ``fake_quant`` encodes with
it: the quantized-KV simulation).

``quantize_plan`` picks the kernel's regime from the block count: a warp
per block for a small T (a decode step's K/V rows), a thread per block over
a shared-memory tile otherwise. ``nxfp_quantize_kv_rows`` encodes a
layer's K and V in one launch straight into its cache rows ``pos[b] + t``
of slot ``slot[b]``, dropping rows past ``n_valid[b]`` (the chunked-prefill
lane writes one (1, P) chunk into a live slot); its plain version is the
codec followed by the same row writes. With a block table (the paged
cache) the rows land in pool pages instead: row r of slot s at row r %
page of page ``block[s, r // page]``, dropped where that entry is the null
page 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..core.formats import BlockFormat
from ..core.levels import level_table
from ..core.pack import bytes_per_block, pack_codes
from ..core.quantize import (_side, arith_ok, block_maxima, candidates,
                              encode_blocks, quantize_blocks, to_blocks)
from . import build

__all__ = ["nxfp_quantize_pack", "nxfp_quantize_pack_plain",
           "nxfp_quantize_kv_rows", "nxfp_quantize_kv_rows_plain",
           "quantize_plan", "warp_plan", "tile_plan", "QuantPlan",
           "kernel_supports", "evaluated_candidates"]

LAUNCHES = 0          # kernel launches since the caller last set it to 0
_MAX_CANDS = 8
# the warp-per-block regime up to this many blocks, the tile regime above
# (on the H100 the two cross between 4096 and 8192 nxfp4 blocks:
# scripts/compare_kernels.py's regime sweep)
WARP_MAX_BLOCKS = 4096
_MAX_WARPS = 8        # warps per CTA of the warp regime
_TILE_MAX = 128       # blocks (threads) per CTA of the tile regime
_TILE_MAX_BS128 = 64  # ... at block size 128 (its shared-memory rows)
_REGIME = {"tile": 0, "warp": 1}


class _Cand(ctypes.Structure):
    _fields_ = [("fmt_bit", ctypes.c_int), ("is_bfp", ctypes.c_int),
                ("mbits", ctypes.c_int), ("bias", ctypes.c_int),
                ("emax", ctypes.c_int), ("nano_mode", ctypes.c_int),
                ("max_pos", ctypes.c_float)]


class _CandList(ctypes.Structure):
    _fields_ = [("cr", ctypes.c_int), ("asym", ctypes.c_int),
                ("ox", ctypes.c_int), ("n_cands", ctypes.c_int),
                ("c", _Cand * _MAX_CANDS), ("table", ctypes.c_int),
                ("cr_lo", ctypes.c_float * 2), ("cr_hi", ctypes.c_float * 2),
                ("cr_val", ctypes.c_float * 2)]


class _Job(ctypes.Structure):
    """``nxfpq::Job`` of ``csrc/nxfp_quantize.cuh``."""
    _fields_ = [("src", ctypes.c_void_p * 2), ("packed", ctypes.c_void_p * 2),
                ("meta", ctypes.c_void_p * 2), ("pos", ctypes.c_void_p),
                ("slot", ctypes.c_void_p), ("n_valid", ctypes.c_void_p),
                ("n_per", ctypes.c_longlong)] + [
        (n, ctypes.c_int) for n in ("n_tensors", "in_bf16", "b", "t", "kvh",
                                    "hd", "nb", "s", "cb")] + [
        ("block", ctypes.c_void_p), ("page", ctypes.c_int),
        ("tw", ctypes.c_int), ("n_pages", ctypes.c_int)]


def recycle_window(elem_name: str, recycle):
    """(lo, hi, value): the recycled -0 code's value and the window of
    scaled values (lo, hi] that the table-driven encoder snaps to it, the
    midpoints with its neighbouring levels (+-inf at the ends of the grid;
    lo > hi, an empty window, when the value duplicates a level and the
    table keeps another code for it)."""
    t = level_table(elem_name, True, recycle)
    code = 1 << (t.fmt.bits - 1)
    val = float(t.decode[code])
    at = np.nonzero(t.codes_sorted == code)[0]
    if at.size == 0:
        return float("inf"), float("-inf"), val
    i = int(at[0])
    lo = float(t.boundaries[i - 1]) if i > 0 else float("-inf")
    hi = (float(t.boundaries[i]) if i < t.boundaries.size
          else float("inf"))
    return lo, hi, val


@functools.lru_cache(maxsize=None)
def _desc(fmt: BlockFormat, table: bool = False) -> _CandList:
    """The format's candidate list for the host entry (built once; the C
    side checks it against the kernel's compile-time element formats).
    ``table`` selects the table-driven encoder's rules (the kernel's
    ``KIND_CRT``) for a format whose recycle value is not custom too."""
    cands = candidates(fmt)
    d = _CandList(int(fmt.cr), int(fmt.asym), int(fmt.ox), len(cands))
    for i, (fmt_bit, levels, nano_mode) in enumerate(cands):
        el = levels.fmt
        mode = -1 if nano_mode is None else (-2 if nano_mode == "round"
                                             else int(nano_mode))
        d.c[i] = _Cand(fmt_bit, int(el.is_bfp), el.mbits, el.bias,
                       levels.emax, mode, float(np.float32(levels.max_pos)))
    if table or not arith_ok(fmt):
        d.table = 1
        for fmt_bit, el in fmt.elem_formats:
            lo, hi, val = recycle_window(el.name, fmt.recycle)
            d.cr_lo[fmt_bit], d.cr_hi[fmt_bit] = lo, hi
            d.cr_val[fmt_bit] = val
    return d


def kernel_supports(fmt: BlockFormat) -> bool:
    """What the kernel takes: 2- to 8-bit codes, block sizes 8 to 128,
    any recycle value."""
    return (fmt.bits in build.KERNEL_BITS
            and fmt.block_size in build.KERNEL_BLOCK_SIZES
            and len(candidates(fmt)) <= _MAX_CANDS)


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """CTA ``c`` encodes blocks [c * per_cta, (c + 1) * per_cta): in the
    ``tile`` regime a thread each, in the ``warp`` regime a warp each (two
    per warp for 16-value blocks)."""
    regime: str
    per_cta: int
    grid: int


def warp_plan(n_blocks: int, block_size: int, n_sm: int) -> QuantPlan:
    """A warp per block (32 / bs blocks a warp below 32 values, bs / 32
    values a lane above), with as few warps per CTA as spread the CTAs
    over every SM."""
    per_warp = max(1, 32 // block_size)
    warps = -(-max(n_blocks, 1) // per_warp)
    per_cta = per_warp * min(_MAX_WARPS, max(1, -(-warps // n_sm)))
    return QuantPlan("warp", per_cta, -(-max(n_blocks, 1) // per_cta))


def tile_plan(n_blocks: int, n_sm: int, block_size: int = 32) -> QuantPlan:
    """A thread per block, 128 per CTA (64 at block size 128), halved (to
    32 at least) while the grid is under two CTAs per SM."""
    per_cta = _TILE_MAX_BS128 if block_size >= 128 else _TILE_MAX
    while per_cta > 32 and -(-n_blocks // per_cta) < 2 * n_sm:
        per_cta //= 2
    return QuantPlan("tile", per_cta, -(-max(n_blocks, 1) // per_cta))


def quantize_plan(n_blocks: int, block_size: int, n_sm: int = 132
                  ) -> QuantPlan:
    """The kernel's regime and grid for ``n_blocks`` blocks: the warp
    regime up to ``WARP_MAX_BLOCKS`` blocks (a decode step's K and V:
    256), the tile regime above. Planned on the host from the shape
    alone."""
    if n_blocks <= WARP_MAX_BLOCKS:
        return warp_plan(n_blocks, block_size, n_sm)
    return tile_plan(n_blocks, n_sm, block_size)


def evaluated_candidates(xb, fmt: BlockFormat):
    """(T,) int32: how many candidates the kernel evaluates for each of the
    (T, B) blocks. It skips the nano-0 candidate that follows a
    rounded-nano one of the same element format when the rounded nano came
    out 0 on every side: the two are the same candidate. Plain PyTorch,
    for a bound that counts the work this data needs."""
    x, sides = block_maxima(xb, fmt)
    count = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    for _, table, nano_mode in candidates(fmt):
        if nano_mode == "round":
            zero = torch.ones_like(count, dtype=torch.bool)
            for vm, vm_e in sides:
                zero &= _side(vm, vm_e, "round", table)[1] == 0
            count += 1
        elif nano_mode is None and fmt.nm and fmt.nano_search != "exhaustive":
            count += (~zero).to(torch.int32)
        else:
            count += 1
    return count


def nxfp_quantize_pack_plain(xb, fmt: BlockFormat, table: bool = False):
    """(T, B) float blocks -> (packed uint8 (T, bpb), meta (T,) of
    ``fmt.meta_dtype``): the encoder the reference serves ``fmt`` with
    (table-driven for a custom recycle value; with ``table``, the
    table-driven ``quantize_blocks`` for every format), then the pack."""
    codes, meta = (quantize_blocks if table else encode_blocks)(xb, fmt)
    return pack_codes(codes, fmt.bits), meta


def _require_kernel(fmt: BlockFormat) -> None:
    if not kernel_supports(fmt):
        raise NotImplementedError(
            f"{fmt.name}: the CUDA quantizer takes 2- to 8-bit formats "
            "with block sizes 8 to 128")


def _check_input(x, name: str) -> None:
    build.require(x.dtype in (torch.float32, torch.bfloat16),
                  f"{name}: expected float32 or bfloat16, got {x.dtype}")
    build.require(x.is_contiguous() and x.data_ptr() % 16 == 0,
                  f"{name} must be contiguous and 16-byte aligned")


def _launch(job: _Job, fmt: BlockFormat, n_blocks: int, device,
            plan: QuantPlan | None, table: bool = False) -> None:
    global LAUNCHES
    lib = build.library()
    plan = plan or quantize_plan(n_blocks, fmt.block_size,
                                 build.sm_count(device))
    rc = lib.nxfp_quantize_launch(
        ctypes.addressof(job), fmt.bits, fmt.block_size,
        ctypes.addressof(_desc(fmt, table)), _REGIME[plan.regime],
        plan.per_cta,
        plan.grid, build.stream_handle(device))
    build.check(rc, "nxfp_quantize")
    LAUNCHES += 1


def nxfp_quantize_pack(xb, fmt: BlockFormat, plan: QuantPlan | None = None,
                       table: bool = False):
    """(T, B) f32 or bf16 blocks -> (packed uint8 (T, bpb), meta (T,)
    uint16, or uint32 for asym formats).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which raises ``NotImplementedError`` for formats it does not take.
    ``plan`` overrides ``quantize_plan`` (the tests and
    ``scripts/compare_kernels.py`` run both regimes on the same blocks).
    ``table`` encodes with the table-driven encoder's rules
    (``core.quantize.quantize_blocks``: a value on a midpoint takes the
    lower level), which the kernel runs for code-recycling formats only
    (its ``KIND_CRT``); for another symmetric format it raises
    ``NotImplementedError`` on CUDA.
    """
    if not build.on_cuda(xb):
        return nxfp_quantize_pack_plain(xb, fmt, table)
    _require_kernel(fmt)
    if table and not fmt.cr:
        raise NotImplementedError(
            f"{fmt.name}: the kernel runs the table-driven encoder for "
            "code-recycling formats only")
    t, b = xb.shape
    build.require(b == fmt.block_size, f"block axis {b} != {fmt.block_size}")
    _check_input(xb, "input")
    packed = torch.empty((t, bytes_per_block(b, fmt.bits)), dtype=torch.uint8,
                         device=xb.device)
    meta = torch.empty((t,), dtype=build.meta_dtype(fmt), device=xb.device)
    job = _Job(src=(xb.data_ptr(), 0), packed=(packed.data_ptr(), 0),
               meta=(meta.data_ptr(), 0), pos=None, n_per=t, n_tensors=1,
               in_bf16=int(xb.dtype == torch.bfloat16), b=t, t=1, kvh=1,
               hd=b, nb=1, s=1, cb=t)
    _launch(job, fmt, t, xb.device, plan, table)
    return packed, meta


def _row_targets(b: int, t: int, s: int, cb: int, pos, slot, n_valid,
                 device, block=None, n_pages: int = 0):
    """(slot (B, T), row (B, T), written (B, T) bool) of the K/V rows'
    cache targets, as the kernel computes them (``dest_block``). With a
    block table (CB, P) over ``n_pages`` pages of s // P rows: (physical
    page, row in the page, written), a row whose entry is the null page 0
    not written."""
    at = torch.arange(t, device=device)[None, :].expand(b, t)
    row = at if pos is None else pos[:, None].long() + at
    sl = (torch.arange(b, device=device) if slot is None
          else slot.long())[:, None].expand(b, t)
    ok = (row >= 0) & (row < s) & (sl >= 0) & (sl < cb)
    if n_valid is not None:
        ok &= at < n_valid[:, None]
    if block is None:
        return sl, row, ok
    page = s // block.shape[1]
    pg = block[sl.clamp(0, cb - 1), (row // page).clamp(0, block.shape[1] - 1)]
    ok &= (pg > 0) & (pg < n_pages)
    return pg.long(), row % page, ok


def _targets_shape(cache: dict, block):
    """(key prefix, CB, S, n_pages) of a dense or paged layer cache: a paged
    one's buffers are ``pool_*`` (n_pages, page, ...), its slots the
    table's rows and its rows P * page."""
    if block is None:
        cb, s = cache["k_packed"].shape[:2]
        return "", cb, s, 0
    n_pages, page = cache["pool_k_packed"].shape[:2]
    return "pool_", block.shape[0], block.shape[1] * page, n_pages


def nxfp_quantize_kv_rows_plain(k, v, cache: dict, pos, fmt: BlockFormat,
                                slot=None, n_valid=None, block=None):
    """The codec on K and V (B, T, KVH, hd), then row writes into the
    layer cache, to the rows the kernel writes (``nxfp_quantize_kv_rows``)
    and no others. In place; returns ``cache``."""
    b, t = k.shape[:2]
    pre, cb, s, n_pages = _targets_shape(cache, block)
    sl, row, ok = _row_targets(b, t, s, cb, pos, slot, n_valid, k.device,
                               block, n_pages)
    for name, x in (("k", k), ("v", v)):
        xb, _ = to_blocks(x, fmt.block_size, -1)
        packed, meta = nxfp_quantize_pack_plain(
            xb.reshape(-1, fmt.block_size), fmt)
        rows = {f"{name}_packed": packed.reshape(*xb.shape[:-1], -1),
                f"{name}_meta": meta.reshape(xb.shape[:-1])}
        for key, val in rows.items():
            buf = build.bit_view(cache[pre + key])
            buf[sl[ok], row[ok]] = build.bit_view(val)[ok]
    return cache


def nxfp_quantize_kv_rows(k, v, cache: dict, pos, fmt: BlockFormat,
                          slot=None, n_valid=None, block=None):
    """Encode K and V (B, T, KVH, hd), bf16 or f32, into the layer cache's
    ``k_packed``/``k_meta``/``v_packed``/``v_meta`` (CB, S, KVH, NB[, bpb])
    at rows ``pos[b] + t`` (``pos`` (B,) int32 on the device, read there:
    no sync), or rows [0, T) when ``pos`` is None, of slot ``slot[b]``
    ((B,) int32; None: slot b, and then CB must be B). ``n_valid`` (B,)
    int32 drops rows t >= ``n_valid[b]`` (the chunked-prefill lane's
    padded tail; None keeps them all). A row outside [0, S) or a slot
    outside [0, CB) is not written either. ``block`` (CB, P) int32 on the
    device makes the cache paged: its buffers are ``pool_k_packed``...
    (n_pages, page, KVH, NB[, bpb]), S is P * page, and row r of slot s
    lands at row r % page of page ``block[s, r // page]``, not written
    where that is the null page 0. CUDA tensors: one launch for K and V.
    CPU tensors: the plain version. Returns ``cache``, updated in
    place."""
    pre, cb, s, n_pages = _targets_shape(cache, block)
    tensors = [k, v] + [cache[f"{pre}{n}_{key}"] for n in "kv"
                        for key in ("packed", "meta")]
    tensors += [x for x in (pos, slot, n_valid, block) if x is not None]
    if not build.on_cuda(*tensors):
        return nxfp_quantize_kv_rows_plain(k, v, cache, pos, fmt, slot,
                                           n_valid, block)
    _require_kernel(fmt)
    b, t, kvh, hd = k.shape
    build.require(v.shape == k.shape and v.dtype == k.dtype,
                  f"K {tuple(k.shape)} {k.dtype} and V {tuple(v.shape)} "
                  f"{v.dtype} differ")
    _check_input(k, "K")
    _check_input(v, "V")
    nb = -(-hd // fmt.block_size)
    build.require(slot is not None or cb == b,
                  f"cache has {cb} slots, K {b} rows: pass slot")
    bpb = bytes_per_block(fmt.block_size, fmt.bits)
    lead = (cb, s) if block is None else (n_pages, s // block.shape[1])
    for key, tail, dtype in (("packed", (nb, bpb), torch.uint8),
                             ("meta", (nb,), build.meta_dtype(fmt))):
        for name in "kv":
            buf = cache[f"{pre}{name}_{key}"]
            build.require(buf.shape == lead + (kvh,) + tail
                          and buf.dtype == dtype and buf.is_contiguous(),
                          f"cache {pre}{name}_{key}: {tuple(buf.shape)} "
                          f"{buf.dtype}, expected {lead + (kvh,) + tail} "
                          f"{dtype}, contiguous")
    if block is not None:
        build.require(block.dim() == 2 and block.dtype == torch.int32
                      and block.is_contiguous(),
                      f"block table must be (CB, P) int32, got "
                      f"{tuple(block.shape)} {block.dtype}")
    for arg, val in (("pos", pos), ("slot", slot), ("n_valid", n_valid)):
        if val is not None:
            build.require(val.shape == (b,) and val.dtype == torch.int32
                          and val.is_contiguous(),
                          f"{arg} must be ({b},) int32, got "
                          f"{tuple(val.shape)} {val.dtype}")
    n_per = b * t * kvh * nb

    def ptr(x):
        return None if x is None else x.data_ptr()

    job = _Job(src=(k.data_ptr(), v.data_ptr()),
               packed=(cache[pre + "k_packed"].data_ptr(),
                       cache[pre + "v_packed"].data_ptr()),
               meta=(cache[pre + "k_meta"].data_ptr(),
                     cache[pre + "v_meta"].data_ptr()),
               pos=ptr(pos), slot=ptr(slot), n_valid=ptr(n_valid),
               n_per=n_per, n_tensors=2,
               in_bf16=int(k.dtype == torch.bfloat16), b=b, t=t, kvh=kvh,
               hd=hd, nb=nb, s=s, cb=cb, block=ptr(block),
               page=0 if block is None else s // block.shape[1],
               tw=0 if block is None else block.shape[1], n_pages=n_pages)
    _launch(job, fmt, 2 * n_per, k.device, None)
    return cache
