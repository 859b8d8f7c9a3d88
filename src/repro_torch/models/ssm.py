"""Mamba-1 selective SSM block (falcon-mamba, and hymba's SSM heads).

The selective scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t is a first-order
linear recurrence, run as a chunked scan as in the reference: chunks of
``ssm_chunk`` steps one after the other, a parallel scan inside a chunk,
and the coefficients (B, chunk, d_inner, N) built one chunk at a time,
never for the whole prompt. Decode (``mamba_step``) is one state update a
token, constant in the context length.

The whole-prompt prefill and the chunked-prefill lane must give the same
bits (the continuous engine's oracle), and so must a decode row at every
batch size. So every sum here has a fixed order that depends on neither
the batch nor the number of steps:

* chunk boundaries at multiples of ``ssm_chunk`` (``min(ssm_chunk, T)``
  for a shorter prompt), the tail padded with identity steps (a = 1,
  bx = 0);
* the in-chunk scan is Hillis-Steele doubling, where step i's value is
  built from steps 0..i only, in an order that does not depend on the
  chunk's length; the state carried out of a chunk is the one at its last
  valid step;
* the contraction y = sum_n h c and the decode conv window are
  elementwise sums in a fixed order, never an einsum or a bmm (whose
  order on CUDA can follow the shapes).

Every operation is elementwise or a GEMM through ``common.dense``; nothing
syncs with the host, so the lane chunk and the decode step are capturable
in CUDA graphs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ops import needs_grad
from .common import ModelConfig, dense, ninit

PREFIX = "ssm_"          # the Mamba weights' keys in a layer's params


def init_mamba(gen: torch.Generator, cfg: ModelConfig):
    """One layer's Mamba weights drawn from ``gen`` on ``gen.device`` (the
    reference's init: S4D-real A, dt bias the inverse softplus of a
    log-uniform dt in [1e-3, 0.1])."""
    d, di, n, dr, cw = (cfg.d_model, cfg.dinner, cfg.ssm_state, cfg.dtrank,
                        cfg.conv_width)
    dev = gen.device
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    a_init = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                    device=dev)).expand(di, n).contiguous()
    u = torch.rand((di,), generator=gen, device=dev, dtype=torch.float32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    return {
        f"{PREFIX}in_w": ninit(gen, (d, 2 * di)),
        f"{PREFIX}conv_w": ninit(gen, (di, cw), scale=0.5),
        f"{PREFIX}conv_b": torch.zeros((di,), dtype=torch.float32,
                                       device=dev),
        f"{PREFIX}x_w": ninit(gen, (di, dr + 2 * n)),
        f"{PREFIX}dt_w": ninit(gen, (dr, di), scale=dr ** -0.5),
        f"{PREFIX}dt_bias": dt_bias,
        f"{PREFIX}a_log": a_init,
        f"{PREFIX}d_skip": torch.ones((di,), dtype=torch.float32,
                                      device=dev),
        f"{PREFIX}out_w": ninit(gen, (di, d), scale=out_scale),
    }


def _window_conv(hist, w, bias, cw: int):
    """Depthwise conv over a history hist (B, T + cw - 1, di): output row r
    is sum_j hist[r + j] w[:, j], the cw shifted products added left to
    right in the activation dtype (the reference's ``sum`` over j), then
    the bias."""
    t = hist.shape[1] - (cw - 1)
    out = hist[:, 0:t] * w[:, 0].to(hist.dtype)
    for j in range(1, cw):
        out = out + hist[:, j:j + t] * w[:, j].to(hist.dtype)
    return out + bias.to(hist.dtype)


def _causal_conv(xi, w, bias, cw: int):
    """Depthwise causal conv via cw shifted adds. xi (B, T, di), w (di, cw)."""
    return _window_conv(F.pad(xi, (0, 0, cw - 1, 0)), w, bias, cw)


def softplus(x):
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _ssm_inputs(cfg: ModelConfig, p, xc):
    """xc (B, T, di) -> (dt, dt * x, B_t, C_t, A): the per-step inputs of
    the scan coefficients, all f32 (dt, dt * x (B, T, di); B_t, C_t
    (B, T, N); A (di, N))."""
    n, dr = cfg.ssm_state, cfg.dtrank
    proj = dense(xc, p[f"{PREFIX}x_w"]).to(torch.float32)     # (B,T,dr+2N)
    dt_r, b_c, c_c = proj[..., :dr], proj[..., dr:dr + n], proj[..., dr + n:]
    dt = softplus(dense(dt_r.to(xc.dtype), p[f"{PREFIX}dt_w"]).to(
        torch.float32) + p[f"{PREFIX}dt_bias"])
    a_mat = -torch.exp(p[f"{PREFIX}a_log"].to(torch.float32))
    return dt, dt * xc.to(torch.float32), b_c, c_c, a_mat


def _coeffs(dt, dtx, b_c, a_mat):
    """(a, bx) (B, T, di, N) f32 of T steps' inputs."""
    return torch.exp(dt[..., None] * a_mat), dtx[..., None] * b_c[:, :, None]


def _ssm_coeffs(cfg: ModelConfig, p, xc):
    """xc (B, T, di) -> (a, bx, c): scan coefficients, all f32."""
    dt, dtx, b_c, c_c, a_mat = _ssm_inputs(cfg, p, xc)
    a, bx = _coeffs(dt, dtx, b_c, a_mat)
    return a, bx, c_c


def _sum_last(x):
    """Sum over the last axis in a fixed order that depends only on its
    length: halve while the length is even, then add the rest left to
    right. Elementwise adds, so a row's bits follow no other shape."""
    while x.shape[-1] % 2 == 0 and x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def _scan_in_chunk(a, bx):
    """Inclusive scan of the steps (a, bx) (B, L, di, N) along axis 1, in
    place (Hillis-Steele doubling): step i ends as the composition of steps
    0..i, combined as the reference's ``(a1 a2, a2 b1 + b2)``, and which
    steps it is combined with depends on i alone, not on L. Under autograd
    each round builds new tensors of the same values (an in-place round
    would overwrite what the backward reads)."""
    grad = needs_grad(a, bx)
    d = 1
    while d < a.shape[1]:
        nb = a[:, d:] * bx[:, :-d] + bx[:, d:]
        na = a[:, :-d] * a[:, d:]
        if grad:
            bx = torch.cat([bx[:, :d], nb], dim=1)
            a = torch.cat([a[:, :d], na], dim=1)
        else:
            bx[:, d:] = nb
            a[:, d:] = na
        d *= 2
    return a, bx


def _scan(coeffs, c, h0, t: int, chunk: int, n_valid=None):
    """The chunked scan over T steps: ``coeffs(lo, hi)`` gives the steps
    [lo, hi) as (a, bx) (B, hi - lo, di, N) f32, c (B, T, N) f32, h0
    (B, di, N) f32. Steps at or past ``n_valid`` (an int, or a (1,) int32
    tensor read on the device; None: T) are identity steps, as is the
    padding of a last partial chunk. Returns (y (B, T, di) f32, the state
    after the last valid step (B, di, N))."""
    ch = min(chunk, t)
    nv = t if n_valid is None else n_valid
    ys, h = [], h0
    for lo in range(0, t, ch):
        hi = min(lo + ch, t)
        a, bx = coeffs(lo, hi)
        cc = c[:, lo:hi]
        if hi - lo < ch:                  # identity steps pad the chunk
            pad = ch - (hi - lo)
            a = F.pad(a, (0, 0, 0, 0, 0, pad), value=1.0)
            bx = F.pad(bx, (0, 0, 0, 0, 0, pad))
            cc = F.pad(cc, (0, 0, 0, pad))
        if n_valid is not None:
            valid = (torch.arange(lo, lo + ch, device=a.device)
                     < n_valid)[None, :, None, None]
            a = torch.where(valid, a, 1.0)
            bx = torch.where(valid, bx, 0.0)
        a, bx = _scan_in_chunk(a.contiguous(), bx.contiguous())
        hs = a * h[:, None] + bx                                # (B,ch,di,N)
        ys.append(_sum_last(hs * cc[:, :, None, :])[:, :hi - lo])
        # the carry: the state at the chunk's last valid step (an all-
        # identity chunk's step 0 is h itself), a copy: a view would keep
        # the chunk's (B, ch, di, N) states alive in the cache
        if isinstance(nv, int):
            h = hs[:, min(max(nv - 1 - lo, 0), ch - 1)].clone()
        else:
            last = (nv.to(torch.int64) - 1 - lo).clamp(0, ch - 1)
            h = hs.index_select(1, last)[:, 0]
    return torch.cat(ys, dim=1), h


def _chunked_scan(a, bx, c, h0, chunk: int):
    """Linear recurrence h_t = a_t h_{t-1} + bx_t, y_t = <c_t, h_t>.

    a, bx: (B, T, di, N) f32; c: (B, T, N); h0: (B, di, N).
    Returns (y (B, T, di), h_final).
    """
    return _scan(lambda lo, hi: (a[:, lo:hi].clone(), bx[:, lo:hi].clone()),
                 c, h0, a.shape[1], chunk)


def mamba_block(cfg: ModelConfig, p, x, h0=None, conv0=None, n_valid=None):
    """Full-sequence Mamba (prefill, or one lane chunk). x (B, T, D).

    ``h0`` (B, di, N) f32 and ``conv0`` (B, cw - 1, di) resume from a
    carried state (default zeros). ``n_valid`` (a (1,) int32 tensor on the
    device, the chunked-prefill lane) marks a padded tail: steps past it
    are identity steps, so the returned state is the one after the last
    valid step, and the conv tail is cut from the full history (``conv0``
    included) at ``n_valid`` instead of T.

    Returns (out (B, T, D), h_final (B, di, N) f32, conv tail
    (B, cw - 1, di)).
    """
    b, t, _ = x.shape
    di, n, cw = cfg.dinner, cfg.ssm_state, cfg.conv_width
    xz = dense(x, p[f"{PREFIX}in_w"])
    xi, z = xz[..., :di], xz[..., di:]                         # (B,T,di)
    if conv0 is None:
        conv0 = torch.zeros((b, cw - 1, di), dtype=xi.dtype, device=x.device)
    xi_hist = torch.cat([conv0.to(xi.dtype), xi], dim=1)
    xc = F.silu(_window_conv(xi_hist, p[f"{PREFIX}conv_w"],
                             p[f"{PREFIX}conv_b"], cw))
    dt, dtx, b_c, c_c, a_mat = _ssm_inputs(cfg, p, xc)
    if h0 is None:
        h0 = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    y, hf = _scan(lambda lo, hi: _coeffs(dt[:, lo:hi], dtx[:, lo:hi],
                                         b_c[:, lo:hi], a_mat),
                  c_c, h0, t, cfg.ssm_chunk, n_valid)
    y = y + xc.to(torch.float32) * p[f"{PREFIX}d_skip"]
    y = y * F.silu(z.to(torch.float32))
    # the tail from the full history: a resumed chunk with fewer than
    # cw - 1 valid rows owes part of its tail to the chunk before
    if n_valid is None:
        conv_tail = xi_hist[:, t:t + cw - 1].clone()
    else:
        rows = n_valid.to(torch.int64) + torch.arange(cw - 1,
                                                      device=x.device)
        conv_tail = xi_hist.index_select(1, rows)
    return dense(y.to(x.dtype), p[f"{PREFIX}out_w"]), hf, conv_tail


def reset_state_slot(h, conv, slot: int):
    """Zero one batch slot of a layer's SSM state (B, ...), in place.

    Attention rows are reset implicitly (reads are masked to ``pos``,
    admission overwrites them), but the recurrent state feeds forward
    unmasked: a parked slot must not integrate a finished request's state
    into the next one's. Returns (h, conv)."""
    h[slot].zero_()
    conv[slot].zero_()
    return h, conv


def mamba_step(cfg: ModelConfig, p, x, h, conv_state):
    """Single-token decode. x (B, 1, D); h (B, di, N); conv_state
    (B, cw - 1, di). The conv window is an f32 sum over its cw taps, left
    to right. Returns (out (B, 1, D), h', conv_state')."""
    cw, di = cfg.conv_width, cfg.dinner
    xz = dense(x, p[f"{PREFIX}in_w"])
    xi, z = xz[..., :di], xz[..., di:]                         # (B,1,di)
    window = torch.cat([conv_state.to(xi.dtype), xi], dim=1)   # (B,cw,di)
    w = p[f"{PREFIX}conv_w"].to(torch.float32)                 # (di, cw)
    xc = window[:, 0].to(torch.float32) * w[:, 0]
    for j in range(1, cw):
        xc = xc + window[:, j].to(torch.float32) * w[:, j]
    xc = F.silu(xc + p[f"{PREFIX}conv_b"])[:, None, :].to(x.dtype)
    dt, dtx, b_c, c_c, a_mat = _ssm_inputs(cfg, p, xc)
    a, bx = _coeffs(dt, dtx, b_c, a_mat)
    h_new = a[:, 0] * h + bx[:, 0]                             # (B,di,N)
    y = _sum_last(h_new * c_c[:, 0, None, :])[:, None]         # (B,1,di)
    y = y + xc.to(torch.float32) * p[f"{PREFIX}d_skip"]
    y = y * F.silu(z.to(torch.float32))
    out = dense(y.to(x.dtype), p[f"{PREFIX}out_w"])
    return out, h_new, window[:, 1:].contiguous()
