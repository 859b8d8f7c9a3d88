"""NxFP codec (paper Algorithm 1) on torch tensors.

Port of the reference's arithmetic encoder (``arith_encode_blocks`` /
``_encode_candidate_arith``), of its table-driven encoder
(``quantize_blocks``, which serves custom recycle values), of its
gather-free variant (``quantize_blocks_gatherfree``), of its decode
(``dequantize_blocks``) and of the dense-tensor helpers over them
(``quantize``, ``dequantize``, ``fake_quant``). Every
operation repeats the reference's f32 arithmetic step for step so that
codes, meta words and decoded values are bitwise equal:

  * ``x * (1/scale)`` (a reciprocal, then a multiply), never ``x / scale``;
  * ``torch.round`` (round half to even, as ``jnp.round``);
  * powers of two assembled from exponent bits (``pow2i``);
  * code fields read straight out of the snapped value's f32 bit pattern.

Subnormal inputs are read as zero: the reference's XLA (CPU) and TPU
arithmetic flushes them. Intermediates are not flushed, so a block whose
squared errors fall below 2**-126 (values under ~1e-19) may still pick
another candidate than the reference.

The one place the order of operations is free in the reference is the
candidate MSE, a 32-element mean. Here it is a left-to-right sum, the
order the CUDA quantizer (``csrc/nxfp_quantize.cu``) uses, so kernel and
plain version agree bitwise; against the reference a block whose two best
candidates lie within an ulp may pick the other one.

The activation formats are ported too: ``asym`` (AMXFP) fits a shared
exponent and nano per sign and scales each element by its input's sign;
``ox`` (MX+) re-codes the block max's slot with ``bits-1`` extra mantissa
bits and records its index in meta bits [11:16]. Their meta is uint32
when ``asym`` (26 bits: E+ | nano+ | fmt | ox index | E- | nano-), else
uint16. torch's CPU ops stop at storing uint32, so every field is read
after a view as int32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .formats import BlockFormat, get_format
from .levels import level_table

__all__ = ["pow2i", "floor_log2_bits", "meta_fields", "meta_int32",
           "arith_encode_blocks", "quantize_blocks_arith", "quantize_blocks",
           "arith_ok", "encode_blocks", "recycled_value",
           "dequantize_blocks", "to_blocks", "from_blocks", "candidates",
           "near_tie_blocks", "ox_emax", "ox_substitute", "block_maxima",
           "quantize", "dequantize", "quantize_blocks_gatherfree",
           "fake_quant"]

_E_BIAS = 128
_F32_TINY = float(np.finfo(np.float32).tiny)


def pow2i(e):
    """Exact 2**e (f32) for int32 e, clipped to [-126, 127], from exponent bits."""
    e = torch.clamp(e, -126, 127).to(torch.int32)
    return ((e + 127) << 23).view(torch.float32)


def floor_log2_bits(v):
    """floor(log2 v) for positive f32 by exponent-field extraction; zeros
    and subnormals clamp to -126 (as the reference)."""
    bits = v.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    return torch.where(v < _F32_TINY, torch.full_like(e, -126), e)


def meta_int32(meta):
    """uint16/uint32 meta -> int32 with the same bits (asym meta is 26
    bits, so the value is unchanged)."""
    if meta.dtype == torch.uint32:
        return meta.view(torch.int32)
    return meta.to(torch.int32)


def meta_fields(meta):
    """uint16 meta -> (E_shared, nano, fmt_bit), each int32."""
    m = meta_int32(meta) & 0xFFFF
    return (m & 0xFF) - _E_BIAS, (m >> 8) & 0x3, (m >> 10) & 0x1


def ox_emax(fmt: BlockFormat) -> int:
    """emax of the element grid the ox outlier value is scaled from."""
    elem = fmt.elem_formats[0][1]
    return level_table(elem.name, False, fmt.recycle).emax


def candidates(fmt: BlockFormat):
    """Static candidate list (fmt_bit, LevelTable, nano_mode), in the
    reference's order: nano_mode None = 0, "round" = Alg.-1 rounded nano,
    int = that nano code (exhaustive search)."""
    cands = []
    for fmt_bit, elem in fmt.elem_formats:
        table = level_table(elem.name, fmt.cr, fmt.recycle)
        if not fmt.nm:
            cands.append((fmt_bit, table, None))
        elif fmt.nano_search == "exhaustive":
            cands.extend((fmt_bit, table, n) for n in range(4))
        else:
            cands.append((fmt_bit, table, "round"))
            cands.append((fmt_bit, table, None))
    return cands


def arith_ok(fmt: BlockFormat) -> bool:
    """The arithmetic encoder hard-codes the default CR remap
    (``recycle="half_smallest"``); a custom recycle value takes the
    table-driven ``quantize_blocks``, as in the reference."""
    return not fmt.cr or fmt.recycle == "half_smallest"


def recycled_value(elem_name: str, recycle) -> float:
    """The f32 value the recycled -0 code (10...0) decodes to."""
    elem = level_table(elem_name, True, recycle)
    return float(elem.decode[1 << (elem.fmt.bits - 1)])


def _block_mean(d):
    """Mean over the last axis as a left-to-right f32 sum (the kernel's order)."""
    s = d[..., 0]
    for i in range(1, d.shape[-1]):
        s = s + d[..., i]
    return s / d.shape[-1]


def _side(vm, vm_e, nano_mode, table):
    """Shared exponent, nano code and scale fit to one block max."""
    e_sh = torch.clamp(vm_e - table.emax, -126, 127)
    scale0 = pow2i(e_sh)
    if nano_mode is None:
        nano = torch.zeros_like(e_sh)
    elif nano_mode == "round":
        r = vm / (scale0 * float(np.float32(table.max_pos)))
        nano = torch.clamp(torch.round((r - 1.0) * 4.0), 0, 3).to(torch.int32)
    else:
        nano = torch.full_like(e_sh, int(nano_mode))
    return e_sh, nano, scale0 * (1.0 + nano.to(torch.float32) * 0.25)


def _encode_candidate(xb, vmax, vmax_e, fmt_bit, nano_mode, table, cr,
                      vmax_n=None, vmax_n_e=None, ox=False):
    """One (element format x nano) candidate: int32 codes, meta, f32 MSE.

    ``vmax_n``/``vmax_n_e`` (asym): ``vmax`` is the positive side's block
    max and these the negative side's; each side gets its own exponent and
    nano, and an element scales by its input's sign. ``ox``: the first
    element with ``|x| >= max|x|`` is re-coded as sign | ``bits-1``
    mantissa bits of the max, decoded off its sign's shared exponent; the
    MSE counts the substituted value.
    """
    elem = table.fmt
    bits, mbits, bias = elem.bits, elem.mbits, elem.bias
    max_pos = float(np.float32(table.max_pos))

    e_sh, nano, scale = _side(vmax, vmax_e, nano_mode, table)
    asym = vmax_n is not None
    if asym:
        e_sh_n, nano_n, scale_n = _side(vmax_n, vmax_n_e, nano_mode, table)
        vp = xb * torch.where(xb < 0, torch.reciprocal(scale_n)[..., None],
                              torch.reciprocal(scale)[..., None])
    else:
        vp = xb * torch.reciprocal(scale)[..., None]
    a = vp.abs()
    neg = vp < 0

    if elem.is_bfp:
        mmax = (1 << (bits - 1)) - 1
        q = torch.clamp(torch.round(a), 0, mmax)
        mag = q.to(torch.int32)
        smallest = 1.0
    else:
        emin = 1 - bias
        a_c = torch.clamp(a, max=max_pos)
        e_eff = torch.clamp(floor_log2_bits(a_c), min=emin)
        q = torch.round(a_c * pow2i(mbits - e_eff)) * pow2i(e_eff - mbits)
        q = torch.clamp(q, max=max_pos)
        qbits = q.view(torch.int32)
        e_q = ((qbits >> 23) & 0xFF) - 127
        m_top = (qbits >> (23 - mbits)) & ((1 << mbits) - 1)
        m_sub = (q * float(2.0 ** (mbits - emin))).to(torch.int32)
        normal = q >= float(2.0 ** emin)
        mag = torch.where(normal, ((e_q + bias) << mbits) | m_top, m_sub)
        smallest = (0.5 ** mbits) * 2.0 ** emin
    sign_code = 1 << (bits - 1)
    codes = torch.where(neg, mag | sign_code, mag)
    val = torch.where(neg, -q, q)
    # negatives that snap to zero take the canonical +0 code
    codes = torch.where((mag == 0) & neg, torch.zeros_like(codes), codes)
    if cr:
        win = ((vp > float(np.float32(-0.75 * smallest)))
               & (vp < float(np.float32(-0.25 * smallest))))
        codes = torch.where(win, torch.full_like(codes, sign_code), codes)
        val = torch.where(win, torch.full_like(val, -0.5 * smallest), val)
    if asym:
        deq = val * torch.where(neg, scale_n[..., None], scale[..., None])
    else:
        deq = val * scale[..., None]
    meta = (e_sh + _E_BIAS) | (nano << 8) | (fmt_bit << 10)
    if ox:
        bs = xb.shape[-1]
        iota = torch.arange(bs, dtype=torch.int32, device=xb.device)
        vtot = torch.maximum(vmax, vmax_n) if asym else vmax
        ismax = xb.abs() >= vtot[..., None]
        idx = torch.where(ismax, iota, bs).amin(dim=-1)
        at = iota == idx[..., None]
        neg_ox = (at & (xb < 0)).any(dim=-1)
        if asym:
            e_v = torch.where(neg_ox, vmax_n_e, vmax_e)
            vm_sel = torch.where(neg_ox, vmax_n, vmax)
            e_used = torch.where(neg_ox, e_sh_n, e_sh)
        else:
            e_v, vm_sel, e_used = vmax_e, vmax, e_sh
        mb = bits - 1
        frac = vm_sel * pow2i(-e_v) - 1.0
        m_ox = torch.clamp(torch.round(frac * float(2.0 ** mb)), 0,
                           (1 << mb) - 1).to(torch.int32)
        code_ox = torch.where(neg_ox, 1 << mb, 0).to(torch.int32) | m_ox
        v_ox = ((1.0 + m_ox.to(torch.float32) * float(0.5 ** mb))
                * pow2i(e_used + table.emax))
        v_ox = torch.where(neg_ox, -v_ox, v_ox)
        has = vtot > 0
        sub = at & has[..., None]
        codes = torch.where(sub, code_ox[..., None], codes)
        deq = torch.where(sub, v_ox[..., None], deq)
        meta = meta | (idx << 11)
        # all-zero blocks: clear the E byte so the decode's substitution
        # gate stays off (zero padding rows are exactly this case)
        meta = torch.where(has, meta, meta & ~0xFF)
    if asym:
        meta = meta | ((e_sh_n + _E_BIAS) << 16) | (nano_n << 24)
    mse = _block_mean(torch.square(deq - xb))
    return codes, meta, mse


def block_maxima(xb, fmt: BlockFormat):
    """The codec's input cleanup and block maxima: (f32 blocks with NaN as
    0, +-inf as +-1e30 and subnormals as 0, [(vmax, vmax_e)] for one side,
    or for the positive and the negative side of an asym format)."""
    xb = torch.nan_to_num(xb.to(torch.float32), nan=0.0, posinf=1e30,
                          neginf=-1e30)
    # subnormal inputs read as zero, as the reference's XLA and TPU
    # arithmetic flushes them
    xb = torch.where(xb.abs() < _F32_TINY, 0.0, xb)
    if fmt.asym:
        # per-sign block maxima: each side's exponent fits its own half of
        # the value range (AMXFP dual scale)
        maxima = (torch.clamp(xb, min=0.0).amax(dim=-1),
                  torch.clamp(-xb, min=0.0).amax(dim=-1))
    else:
        maxima = (xb.abs().amax(dim=-1),)
    return xb, [(vm, floor_log2_bits(vm)) for vm in maxima]


def _table_candidate(xb, vmax, vmax_e, fmt_bit, nano_mode, table):
    """One candidate of the table-driven encoder: the reference's
    ``_quantize_candidate``. Each scaled value takes the level of its
    ``searchsorted`` slot among the midpoints (side left: a value on a
    midpoint takes the lower level)."""
    e_sh, nano, scale = _side(vmax, vmax_e, nano_mode, table)
    vp = xb * torch.reciprocal(scale)[..., None]
    dev = xb.device
    bounds = torch.from_numpy(table.boundaries).to(dev)
    idx = torch.searchsorted(bounds, vp.contiguous())
    codes = torch.from_numpy(table.codes_sorted.astype(np.int32)).to(dev)[idx]
    deq = torch.from_numpy(table.values_sorted).to(dev)[idx] * scale[..., None]
    meta = (e_sh + _E_BIAS) | (nano << 8) | (fmt_bit << 10)
    return codes, meta, _block_mean(torch.square(deq - xb))


def _candidate_results(xb, fmt: BlockFormat, table: bool = False):
    """Yield (codes, meta, mse) of every candidate, in the reference's
    order: the arithmetic encoder's, or with ``table`` the table-driven
    one's (symmetric formats only)."""
    xb, sides = block_maxima(xb, fmt)
    (vmax, vmax_e), extra = sides[0], {}
    if fmt.asym:
        extra = dict(vmax_n=sides[1][0], vmax_n_e=sides[1][1])
    for fmt_bit, tbl, nano_mode in candidates(fmt):
        if table:
            yield _table_candidate(xb, vmax, vmax_e, fmt_bit, nano_mode, tbl)
        else:
            yield _encode_candidate(xb, vmax, vmax_e, fmt_bit, nano_mode,
                                    tbl, fmt.cr, ox=fmt.ox, **extra)


def _best(results):
    """The first candidate, then each later one that has a strictly lower
    MSE (the reference's argmin)."""
    best_codes = best_meta = best_mse = None
    for ci, (codes, meta, mse) in enumerate(results):
        if ci == 0:
            # first candidate unconditional: inf-MSE blocks still encode
            best_codes, best_meta, best_mse = codes, meta, mse
            continue
        take = mse < best_mse
        best_codes = torch.where(take[..., None], codes, best_codes)
        best_meta = torch.where(take, meta, best_meta)
        best_mse = torch.where(take, mse, best_mse)
    return best_codes, best_meta


def arith_encode_blocks(xb, fmt: BlockFormat):
    """(..., nb, B) float -> (codes int32 (..., nb, B), meta int32 (..., nb))."""
    return _best(_candidate_results(xb, fmt))


def near_tie_blocks(xb, fmt: BlockFormat, ulps: int = 4):
    """(..., nb) bool: blocks whose best and runner-up candidate MSEs lie
    within ``ulps`` f32 ulps of each other.

    Only there may two correct encoders pick different candidates: the
    32-element mean is summed in another order by XLA, torch and CUDA.
    Used to tell such blocks from real faults when codes differ.
    """
    table = not arith_ok(fmt) and not (fmt.asym or fmt.ox)
    mses = torch.stack([mse for _, _, mse in
                        _candidate_results(xb, fmt, table)])
    if mses.shape[0] < 2:
        return torch.zeros(mses.shape[1:], dtype=torch.bool,
                           device=mses.device)
    best, second = torch.topk(mses, 2, dim=0, largest=False).values
    ulp = torch.nextafter(best, torch.full_like(best, float("inf"))) - best
    return (second - best) <= ulps * ulp


def _typed(codes, meta, fmt: BlockFormat):
    if fmt.meta_dtype == "uint32":
        return codes.to(torch.uint8), meta.contiguous().view(torch.uint32)
    return codes.to(torch.uint8), meta.to(torch.uint16)


def quantize_blocks_arith(xb, fmt: BlockFormat):
    """Blocked encode -> (codes uint8 (..., nb, B), meta (..., nb) of
    ``fmt.meta_dtype``: uint32 for asym formats, else uint16).

    Only the default ``recycle="half_smallest"`` remap is supported (the
    CR window is hard-coded to it), as in the reference; a custom recycle
    value takes ``quantize_blocks``.
    """
    if not arith_ok(fmt):
        raise NotImplementedError(
            f"{fmt.name}: the arithmetic encoder takes the default recycle "
            "value only; custom values take quantize_blocks")
    return _typed(*arith_encode_blocks(xb, fmt), fmt)


def quantize_blocks(xb, fmt: BlockFormat):
    """The reference's table-driven encoder (``core/quantize.py:
    quantize_blocks``): each candidate snaps every scaled value to its
    ``searchsorted`` level among the midpoints of the format's levels
    (a value on a midpoint takes the lower level), the recycled value
    included wherever the format puts it. The activation formats (asym,
    ox) have no table form and take the arithmetic encoder, as there.
    Returns (codes uint8 (..., nb, B), meta (..., nb) of
    ``fmt.meta_dtype``)."""
    if fmt.asym or fmt.ox:
        return _typed(*arith_encode_blocks(xb, fmt), fmt)
    return _typed(*_best(_candidate_results(xb, fmt, table=True)), fmt)


def encode_blocks(xb, fmt: BlockFormat):
    """The encoder the reference serves ``fmt`` with: the arithmetic one,
    or the table-driven one for a custom recycle value."""
    if arith_ok(fmt):
        return quantize_blocks_arith(xb, fmt)
    return quantize_blocks(xb, fmt)


def _level_values(codes, fmt_bit, fmt: BlockFormat):
    """Element values (scaled units) from the level LUTs, AM-selected."""
    c = codes.to(torch.int64)
    luts = {fb: torch.from_numpy(
                level_table(el.name, fmt.cr, fmt.recycle).decode
            ).to(codes.device)
            for fb, el in fmt.elem_formats}
    if fmt.am:
        return torch.where((fmt_bit == 1)[..., None], luts[1][c], luts[0][c])
    return next(iter(luts.values()))[c]


def ox_substitute(out, c, m, e_p, e_n, fmt: BlockFormat):
    """Put the ox outlier value ``+-(1 + mag/2^(bits-1)) * 2^(E_sign +
    emax)`` at the block-max index of meta bits [11:16], unless the E byte
    is 0. ``c`` int32 codes, ``m`` int32 meta, ``e_p``/``e_n`` the shared
    exponents of the positive and negative side (equal unless asym)."""
    mb = fmt.bits - 1
    sign = (c >> mb) & 1
    mag = c & ((1 << mb) - 1)
    e_used = torch.where(sign == 1, e_n[..., None], e_p[..., None])
    vox = ((1.0 + mag.to(torch.float32) * float(0.5 ** mb))
           * pow2i(e_used + ox_emax(fmt)))
    vox = torch.where(sign == 1, -vox, vox)
    iota = torch.arange(c.shape[-1], dtype=torch.int32, device=c.device)
    sub = ((iota == ((m >> 11) & 0x1F)[..., None])
           & ((m & 0xFF) != 0)[..., None])
    return torch.where(sub, vox, out)


def _dequantize_blocks_ex(codes, meta, fmt: BlockFormat, dtype):
    """Decode the activation formats: per-sign scales (``asym``; the sign
    of the DECODED value picks the scale, so a -0 code takes the positive
    one) and the ox substitution of the stored block-max index, gated on a
    non-zero E byte."""
    m = meta_int32(meta)
    e_p = (m & 0xFF) - _E_BIAS
    scale_p = torch.ldexp(1.0 + ((m >> 8) & 0x3).to(torch.float32) * 0.25,
                          e_p)
    v = _level_values(codes, (m >> 10) & 0x1, fmt)
    if fmt.asym:
        e_n = ((m >> 16) & 0xFF) - _E_BIAS
        scale_n = torch.ldexp(
            1.0 + ((m >> 24) & 0x3).to(torch.float32) * 0.25, e_n)
        out = v * torch.where(v < 0, scale_n[..., None], scale_p[..., None])
    else:
        e_n = e_p
        out = v * scale_p[..., None]
    if fmt.ox:
        out = ox_substitute(out, codes.to(torch.int32), m, e_p, e_n, fmt)
    return out.to(dtype)


def dequantize_blocks(codes, meta, fmt: BlockFormat, dtype=torch.float32):
    """codes (..., nb, B) uint8 + meta (..., nb) -> values (..., nb, B)."""
    if fmt.asym or fmt.ox:
        return _dequantize_blocks_ex(codes, meta, fmt, dtype)
    e_shared, nano, fmt_bit = meta_fields(meta)
    scale = torch.ldexp(1.0 + nano.to(torch.float32) * 0.25, e_shared)
    return (_level_values(codes, fmt_bit, fmt) * scale[..., None]).to(dtype)


def to_blocks(x, block_size: int, axis: int = -1):
    """Move ``axis`` last, zero-pad to a block multiple, reshape to blocks.

    Returns (xb (..., nb, block_size), orig_len).
    """
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    pad = (-n) % block_size
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], (n + pad) // block_size, block_size), n


def from_blocks(xb, orig_len: int, axis: int = -1):
    """Inverse of to_blocks."""
    x = xb.reshape(*xb.shape[:-2], xb.shape[-2] * xb.shape[-1])
    return torch.movedim(x[..., :orig_len], -1, axis)


def resolve_format(fmt) -> BlockFormat:
    return get_format(fmt) if isinstance(fmt, str) else fmt


def quantize(x, fmt, axis: int = -1):
    """Quantize a dense tensor along ``axis`` with the reference's encoder
    (``quantize_blocks``). Returns (codes (..., nb, B) uint8, meta (...,
    nb), orig_len)."""
    fmt = resolve_format(fmt)
    xb, n = to_blocks(x, fmt.block_size, axis)
    codes, meta = quantize_blocks(xb, fmt)
    return codes, meta, n


def dequantize(codes, meta, fmt, orig_len: int, axis: int = -1,
               dtype=torch.float32):
    """The inverse of ``quantize``: decoded values in the original layout."""
    fmt = resolve_format(fmt)
    return from_blocks(dequantize_blocks(codes, meta, fmt, dtype), orig_len,
                       axis)


def quantize_blocks_gatherfree(xb, fmt: BlockFormat):
    """The reference's gather-free encoder (``core/quantize.py:
    quantize_blocks_gatherfree``): a scaled value's level is the count of
    midpoints below it, and its code and value are one-hot sums over the
    level grid instead of lookups. Symmetric scales only, as there (an
    asym or ox format is encoded with one scale a block). Returns (codes
    uint8 (..., nb, B), meta uint16 (..., nb)), ``quantize_blocks``'s for
    the symmetric formats."""
    xb, sides = block_maxima(xb, dataclasses.replace(fmt, asym=False))
    vmax, vmax_e = sides[0]
    best_codes = best_meta = best_mse = None
    dev = xb.device
    for ci, (fmt_bit, table, nano_mode) in enumerate(candidates(fmt)):
        e_sh, nano, scale = _side(vmax, vmax_e, nano_mode, table)
        vp = xb * torch.reciprocal(scale)[..., None]
        bounds = torch.from_numpy(table.boundaries).to(dev)
        idx = (vp[..., None] > bounds).to(torch.int32).sum(-1)
        onehot = idx[..., None] == torch.arange(table.num_levels,
                                                dtype=torch.int32,
                                                device=dev)
        values = (onehot.to(torch.float32)
                  * torch.from_numpy(table.values_sorted).to(dev)).sum(-1)
        codes = (onehot.to(torch.int32) * torch.from_numpy(
            table.codes_sorted.astype(np.int32)).to(dev)).sum(-1)
        mse = _block_mean(torch.square(values * scale[..., None] - xb))
        meta = (e_sh + _E_BIAS) | (nano << 8) | (fmt_bit << 10)
        if ci == 0:
            # the first candidate unconditionally: inf-MSE blocks encode
            best_codes, best_meta, best_mse = codes, meta, mse
            continue
        take = mse < best_mse
        best_codes = torch.where(take[..., None], codes, best_codes)
        best_meta = torch.where(take, meta, best_meta)
        best_mse = torch.where(take, mse, best_mse)
    return best_codes.to(torch.uint8), best_meta.to(torch.uint16)


def fake_quant(x, fmt, axis: int = -1):
    """The direct-cast round trip (``quantize``, then ``dequantize``) in
    the original layout and dtype: the values a quantized buffer holds."""
    fmt = resolve_format(fmt)
    codes, meta, n = quantize(x, fmt, axis)
    return dequantize(codes, meta, fmt, n, axis).to(x.dtype)
