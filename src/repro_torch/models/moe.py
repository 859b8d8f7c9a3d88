"""Mixture-of-Experts FFN: top-k routing, per-expert capacity, the routed
experts' SwiGLU and an optional shared MLP (the reference's
``models/moe.py``).

The router runs in f32 and is never cast (``QuantPolicy.skip`` names it).
A token's k experts are picked by top-k of the softmax, their gates
renormalised; an assignment (token, j) is kept while its expert has taken
fewer than ``cap`` earlier assignments in token-major order. The routed
products differ from the reference's in how they run, not in what they
compute: the reference scatters every assignment into an (E, C, D)
dispatch buffer and multiplies it by every expert, dequantized
(``_expert_mm``); here, with cast experts, each assignment is one row of
the dequant GEMM's grouped instance (``kernels.ops.expert_matmul``),
which reads only the routed experts' weights, and a dropped row is
computed as zero. bf16 experts (no weight format) keep the reference's
dispatch buffer and one batched product (``kernels.ops.expert_bmm``).

Nothing here syncs with the host on CUDA (no ``nonzero``, ``bincount``,
boolean indexing or ``.item()``): the decode chunk and the lane chunk are
captured as CUDA graphs.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.qtensor import QTensor
from ..kernels.ops import expert_bmm, expert_matmul, router_matmul
from .common import ModelConfig, ninit, swiglu

# rows a dense expert takes at decode: fixed, so a row's bits in the
# batched product do not follow the batch
DECODE_ROWS = 16


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    """A layer's router, routed experts (E, D, F) / (E, F, D) and shared
    MLP, drawn in the reference's order with its scales."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    ep = cfg.n_experts_padded or e
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    p = {
        "router": ninit(gen, (d, e)),
        "experts_w1": ninit(gen, (ep, d, ff)),
        "experts_w3": ninit(gen, (ep, d, ff)),
        "experts_w2": ninit(gen, (ep, ff, d), scale=out_scale),
    }
    if cfg.shared_d_ff:
        p.update({
            "shared_w1": ninit(gen, (d, cfg.shared_d_ff)),
            "shared_w3": ninit(gen, (d, cfg.shared_d_ff)),
            "shared_w2": ninit(gen, (cfg.shared_d_ff, d), scale=out_scale),
        })
    return p


def _sum_k(t):
    """t (N, k, ...) summed over k left to right (elementwise adds: a
    row's sum does not depend on how many rows there are)."""
    out = t[:, 0]
    for j in range(1, t.shape[1]):
        out = out + t[:, j]
    return out


def route(cfg: ModelConfig, p, xf):
    """xf (N, D) -> (probs (N, E) f32, gate weights (N, k) f32 renormalised
    over the k picks, expert ids (N, k) int64)."""
    router = p["router"]
    if isinstance(router, QTensor):  # defensive: the policy skips it
        router = router.dequantize(torch.float32)
    logits = router_matmul(xf.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, cfg.n_experts_active, dim=-1)
    gate_w = gate_w / torch.clamp(_sum_k(gate_w), min=1e-9)[:, None]
    return probs, gate_w, gate_idx


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for a dispatch of ``n_tokens`` tokens (the
    reference's ``cap``)."""
    return max(int(math.ceil(cfg.n_experts_active * n_tokens
                             * cfg.capacity_factor / cfg.n_experts)), 1)


def dispatch(cfg: ModelConfig, gate_idx, cap: int, valid=None):
    """Arrival order and capacity of the flat token-major assignments:
    (expert (N*k,) int32, -1 where dropped; pos (N*k,) int64, each
    assignment's place among its expert's). ``valid`` (N,) bool takes a
    token out of the count and drops it."""
    n, k = gate_idx.shape
    flat = gate_idx.reshape(-1)
    ar = torch.arange(cfg.n_experts, device=flat.device)
    oh = (flat[:, None] == ar).to(torch.int32)
    vk = None
    if valid is not None:
        vk = valid[:, None].expand(n, k).reshape(-1)
        oh = oh * vk[:, None].to(torch.int32)
    pos = torch.sum((torch.cumsum(oh, dim=0) - oh) * oh, dim=-1)
    keep = pos < cap
    if vk is not None:
        keep = keep & vk
    return torch.where(keep, flat, -1).to(torch.int32), pos


def _experts(cfg: ModelConfig, p, x_rows, expert, pos, cap: int):
    """The routed SwiGLU of every assignment row: x_rows (R, D) -> (R, D)
    bf16, zero where ``expert`` is -1. Cast experts: three launches of the
    grouped GEMM. bf16 experts: the reference's dispatch buffer (E, cap,
    D), a dump row for the dropped, and one ``expert_bmm`` a product."""
    dt = x_rows.dtype
    w1, w3, w2 = p["experts_w1"], p["experts_w3"], p["experts_w2"]
    if isinstance(w1, QTensor):
        def mm(x, w):
            return expert_matmul(x, expert, w).to(dt)
        h = (F.silu(mm(x_rows, w1).to(torch.float32))
             * mm(x_rows, w3).to(torch.float32))
        return mm(h.to(dt), w2)
    ep, d = w1.shape[0], x_rows.shape[-1]
    slot = torch.where(expert >= 0, expert.long() * cap + pos,
                       ep * cap)
    buf = torch.zeros((ep * cap + 1, d), dtype=dt, device=x_rows.device)
    buf.index_copy_(0, slot, x_rows)
    xe = buf[:ep * cap].reshape(ep, cap, d)
    h = (F.silu(expert_bmm(xe, w1).to(dt).to(torch.float32))
         * expert_bmm(xe, w3).to(dt).to(torch.float32))
    out = expert_bmm(h.to(dt), w2).to(dt).reshape(ep * cap, d)
    out = torch.cat([out, torch.zeros((1, d), dtype=dt, device=out.device)])
    return out[slot]


def _combine(cfg: ModelConfig, p, xf, rows, gate_w, expert):
    """The gate-weighted sum over each token's k rows in f32 (a dropped
    row weighs 0), plus the shared SwiGLU. -> (N, D) f32."""
    n, k = gate_w.shape
    w_eff = gate_w * (expert.reshape(n, k) >= 0).to(torch.float32)
    y = _sum_k(rows.reshape(n, k, -1).to(torch.float32) * w_eff[..., None])
    if cfg.shared_d_ff:
        y = y + swiglu(xf, p["shared_w1"], p["shared_w3"],
                       p["shared_w2"]).to(torch.float32)
    return y


def _aux(cfg: ModelConfig, probs, gate_idx):
    """Switch-style load-balance loss: E * sum(mean prob * mean picks)."""
    e = cfg.n_experts
    me = torch.mean(probs, dim=0)
    picks = (gate_idx[..., None] == torch.arange(
        e, device=gate_idx.device)).to(torch.float32)
    ce = torch.mean(torch.sum(picks, dim=1), dim=0)
    return e * torch.sum(me * ce)


def _rows(xf, k: int):
    """Each token's row repeated for its k assignments, token-major."""
    n, d = xf.shape
    return xf[:, None].expand(n, k, d).reshape(n * k, d)


def moe_ffn(cfg: ModelConfig, p, x, valid=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, D) -> (y (B, T, D), load-balance aux loss (f32 scalar)).

    Capacity and arrival order run over the whole flattened batch:
    ``cap = max(ceil(k * B*T * capacity_factor / E), 1)``. ``valid``
    (B*T,) bool (the chunked-prefill lane): a padded token is taken out
    of the capacity count and dropped, so padding never takes a real
    token's slot; its output is unused."""
    b, t, d = x.shape
    n, k = b * t, cfg.n_experts_active
    xf = x.reshape(n, d)
    probs, gate_w, gate_idx = route(cfg, p, xf)
    cap = capacity(cfg, n)
    expert, pos = dispatch(cfg, gate_idx, cap, valid)
    rows = _experts(cfg, p, _rows(xf, k), expert, pos, cap)
    y = _combine(cfg, p, xf, rows, gate_w, expert)
    return y.reshape(b, t, d).to(x.dtype), _aux(cfg, probs, gate_idx)


def moe_ffn_decode(cfg: ModelConfig, p, x
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-path MoE with a per-slot capacity: x (B, 1, D) -> (y (B, 1,
    D), the rows' summed aux loss).

    The reference runs ``moe_ffn`` on each row alone (``vmap``), so a
    slot's routing never depends on its neighbours. A row's k experts are
    distinct and its capacity is at least 1, so every assignment is kept:
    the B*k rows go straight to the expert products. bf16 experts take a
    dispatch buffer of ``DECODE_ROWS`` rows an expert (a multiple of it
    for more than 16 slots), so a row's bits do not follow B."""
    b, _, d = x.shape
    k = cfg.n_experts_active
    xf = x.reshape(b, d)
    probs, gate_w, gate_idx = route(cfg, p, xf)
    expert, pos = dispatch(cfg, gate_idx, b)
    cap = -(-b // DECODE_ROWS) * DECODE_ROWS
    rows = _experts(cfg, p, _rows(xf, k), expert, pos, cap)
    y = _combine(cfg, p, xf, rows, gate_w, expert)
    aux = cfg.n_experts * torch.sum(
        torch.gather(probs, 1, gate_idx))
    return y.reshape(b, 1, d).to(x.dtype), aux
