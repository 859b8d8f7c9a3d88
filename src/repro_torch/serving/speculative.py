"""Self-speculative decoding: cheap-weight drafts, target-weight verify.

The direct-cast premise means the engine holds the same model at two
widths: the nxfp4 codes, and the bf16 tensors they decode to. One width
drafts, the other verifies (DESIGN.md section 13; the reference's
``serving/speculative.py``). A round drafts ``k`` candidate tokens per
slot with the draft weights (``models.lm.draft_loop``, which puts back
every cache row and recurrent state it wrote), scores the ``k + 1`` rows
in one batched target-weight forward (``models.lm.verify_step``) and
commits only the accepted prefix (``models.lm.commit_verify``, which puts
back the rows past it).

Which pairing pays is a property of the device. On the CPU the nxfp4
product is the dearer one, so ``draft="recycled"`` (the bf16 tensors the
cast weights decode to) drafts and the nxfp4 product verifies. On the
H100 the nxfp4 split-K GEMM streams ~4.25 bits a weight against the bf16
product's 16, so a bf16 target with ``draft="nxfp4"`` is the pairing
that may pay there.

Contract: a greedy request served speculatively emits the tokens of the
plain engine bit for bit. The emitted tokens are always the argmax chain
of target logits (``accept_greedy``), and those logits are the
sequential decode's, bit for bit (``verify_step``). Sampled requests use
residual rejection (``accept_residual``): the emitted tokens follow the
target distribution, and a seeded request reproduces itself, but not
the plain engine's sample path. Every draw comes from the slot's own
``torch.Generator`` over its own row, as ``engine.sample_tokens`` draws,
so a neighbour slot cannot move a request's stream.

Everything here but ``AdaptiveK`` (host numpy) is tensor code with no
host sync, capturable in a CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["SpeculativeConfig", "accept_greedy", "accept_residual",
           "mask_round_emissions", "pack_emissions", "spec_round",
           "AdaptiveK"]


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """Engine-level speculative decoding knobs (the reference's, field for
    field).

    ``k``: the most draft tokens a round (and each slot's starting
    ``spec_k``). ``draft``: "recycled" decodes the engine's own cast
    weights back to bf16 (needs a weight format), any format name casts
    the engine's weights to that format. ``adaptive`` turns on the per-slot
    controller (``AdaptiveK``): an EMA of each slot's accept fraction
    halves its ``spec_k`` below ``lower`` and doubles it back toward ``k``
    above ``upper``.
    """

    k: int = 4
    draft: str = "recycled"
    adaptive: bool = True
    k_min: int = 1
    ema: float = 0.7            # EMA decay of the accept-rate estimate
    lower: float = 0.35         # back off below this accept fraction
    upper: float = 0.75         # raise toward k above this


def _accepted_prefix(ok, spec_k, k: int):
    """Length of each row's leading run of true ``ok`` (B, k), capped at
    ``spec_k``."""
    idx = torch.arange(k, dtype=torch.int32, device=ok.device)
    ok = ok & (idx[None, :] < torch.clamp(spec_k, max=k)[:, None])
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1,
                                                        dtype=torch.int32)


def accept_greedy(tok, cands, vlogits, spec_k):
    """Greedy accept-prefix: emit the verify forward's own argmax chain.

    ``vlogits`` (B, k+1, V) row i scores the context through candidate
    row i, so ``succ[:, i] = argmax(vlogits[:, i])`` (the first maximum)
    is the target's token at emission slot i+1. Candidate i (1-based) is
    accepted while it equals ``succ[:, i-1]`` and ``i <= spec_k``. Returns
    (a (B,), out_toks (B, k+1) = [tok, succ_1 .. succ_k], nxt (B,) =
    succ[a], the token entering the next round), all int32.
    """
    k = cands.shape[1]
    succ = torch.argmax(vlogits, dim=-1).to(torch.int32)       # (B, k+1)
    a = _accepted_prefix(cands == succ[:, :k], spec_k, k)
    out_toks = torch.cat([tok[:, None].to(torch.int32), succ[:, :k]], dim=1)
    nxt = torch.gather(succ, 1, a[:, None].long())[:, 0]
    return a, out_toks, nxt


def accept_residual(tok, cands, vlogits, dlogits, temperature, gens,
                    spec_k):
    """Residual-rejection acceptance of sampled slots (distribution-exact).

    Candidate i, drawn from the draft distribution ``pd_i``, is accepted
    with probability ``min(1, pt_i(c_i) / pd_i(c_i))`` against the target
    ``pt_i``; at the first rejection the next token is drawn from
    ``max(pt - pd, 0)`` (normalised), and when all k are accepted the
    bonus token comes from ``pt_{k+1}`` (a zero ``pd`` row). A residual
    that sums to 0 (``pd == pt``) falls back to ``pt``.

    ``dlogits`` (k, B, V) are the draft's logits at each candidate;
    ``gens`` one generator per slot. Slot b draws its k uniforms and then
    E ~ Exp(1) over its own (1, V) row from ``gens[b]``, and takes
    ``argmax(resid / E)``: a draw with probability resid / sum(resid),
    with no normalisation and no host sync. Returns (a, out_toks (B, k+1)
    = [tok, c_1 .. c_k], nxt (B,)), like ``accept_greedy``.
    """
    b, k = cands.shape
    safe = torch.where(temperature > 0, temperature, 1.0)
    pt = torch.softmax(vlogits / safe[:, None, None], dim=-1)  # (B, k+1, V)
    pd = torch.softmax(dlogits.transpose(0, 1) / safe[:, None, None],
                       dim=-1)                                  # (B, k, V)
    pd = torch.cat([pd, torch.zeros_like(pd[:, :1])], dim=1)
    u = torch.empty((b, k), dtype=torch.float32, device=vlogits.device)
    for i, gen in enumerate(gens):
        u[i:i + 1].uniform_(generator=gen)
    c = cands.long()[:, :, None]
    p_t = torch.gather(pt[:, :k], 2, c)[..., 0]
    p_d = torch.gather(pd[:, :k], 2, c)[..., 0]
    a = _accepted_prefix(u * p_d <= p_t, spec_k, k)
    ix = a.long()[:, None, None].expand(b, 1, pt.shape[-1])
    pt_a = torch.gather(pt, 1, ix)[:, 0]                        # (B, V)
    pd_a = torch.gather(pd, 1, ix)[:, 0]
    resid = torch.clamp(pt_a - pd_a, min=0.0)
    resid = torch.where(resid.sum(dim=-1, keepdim=True) > 0, resid, pt_a)
    noise = torch.empty_like(resid)
    for i, gen in enumerate(gens):
        noise[i:i + 1].exponential_(1.0, generator=gen)
    nxt = torch.argmax(resid / noise, dim=-1).to(torch.int32)
    out_toks = torch.cat([tok[:, None].to(torch.int32),
                          cands.to(torch.int32)], dim=1)
    return a, out_toks, nxt


def mask_round_emissions(toks, n_raw, done, n_gen, stop, max_new):
    """A round's ``engine.mask_chunk_emissions``, with the accept cap.

    ``toks`` (B, k+1) are the round's proposed emissions, ``n_raw`` (B,)
    the accepted-prefix emission count (``a + 1``). Step j of slot b is
    live iff the slot was not done at the round's entry, ``j < n_raw``, no
    stop token landed strictly earlier in the round (the hit itself
    emits) and ``n_gen + j < max_new``. Returns (emitted (B, k+1), n_emit
    (B,), n_gen', done').
    """
    q = toks.shape[1]
    j = torch.arange(q, dtype=torch.int32, device=toks.device)
    beyond = j[None, :] >= n_raw[:, None]
    hits = (toks == stop[:, None]) & ~beyond           # stop < 0: never
    hi = hits.to(torch.int32)
    before = torch.cumsum(hi, dim=1) - hi
    done_before = done[:, None] | (before > 0) | beyond
    done_before = done_before | (n_gen[:, None] + j[None, :]
                                 >= max_new[:, None])
    emitted = torch.where(done_before, torch.zeros_like(toks), toks)
    n_emit = (~done_before).sum(dim=1, dtype=torch.int32)
    n_gen = n_gen + n_emit
    done = done | (hits & ~done_before).any(dim=1) | (n_gen >= max_new)
    return emitted, n_emit, n_gen, done


def pack_emissions(toks_r, n_r):
    """Left-pack the rounds' ragged emissions into one prefix per slot.

    ``toks_r`` (R, B, k+1) stacks each round's masked emissions, ``n_r``
    (R, B) its emission counts. A slot's valid tokens keep their round
    order (a stable sort on the reference's key: a valid entry's flat
    position, an invalid one's pushed past the end). Returns (B,
    R*(k+1)), zeros after each slot's prefix.
    """
    r, b, q = toks_r.shape
    n = r * q
    toks = toks_r.permute(1, 0, 2).reshape(b, n)
    valid = (torch.arange(q, dtype=torch.int32, device=toks.device)
             [None, None, :] < n_r[:, :, None])
    valid = valid.permute(1, 0, 2).reshape(b, n)
    flat = torch.arange(n, dtype=torch.int32, device=toks.device)[None, :]
    key = torch.where(valid, 0, n) + flat
    order = torch.argsort(key, dim=1, stable=True)
    return torch.gather(torch.where(valid, toks, torch.zeros_like(toks)), 1,
                        order)


def spec_round(cfg, params, draft_params, tok, cache, done, n_gen, max_new,
               temperature, stop, live_r, poison, spec_k, gens: Sequence,
               *, kv_fmt: Optional[str], k: int, greedy: bool):
    """One draft -> verify -> accept -> commit round, on the device.

    ``live_r`` (B,) gates every cache write: a parked, prefilling or done
    slot rides the batch and keeps its rows, state and ``pos``. ``poison``
    (B,) bool makes a slot's verify logits NaN (the authoritative ones: a
    poisoned draft would only propose tokens the verify corrects); the
    all-False mask leaves them bit for bit. ``greedy`` (static: no sampled
    slot is live) skips the draft's sampling, the residual acceptance and
    every generator. ``cache`` is updated in place (its ``pos`` is a new
    tensor, as ``decode_step``'s). Returns (emitted (B, k+1), n_emit,
    tok', cache, done', n_gen', finite (B,), a (B,)): ``finite`` is each
    slot's AND of ``isfinite`` over its verify logits (the containment
    sentinel), ``a`` its accepted candidate count (the adaptive-k signal).
    """
    from ..models.lm import commit_verify, draft_loop, verify_step
    from .engine import sample_tokens

    def d_sample(logits):
        return sample_tokens(logits, temperature, greedy, gens)

    cands, dlogits = draft_loop(cfg, draft_params, tok, cache, k, kv_fmt,
                                d_sample, live=live_r,
                                with_logits=not greedy)
    vlogits, pending = verify_step(
        cfg, params, torch.cat([tok[:, None].to(cands.dtype), cands], dim=1),
        cache, kv_fmt, live=live_r)
    vlogits = torch.where(poison[:, None, None], float("nan"), vlogits)
    finite = torch.isfinite(vlogits).all(dim=2).all(dim=1)
    a, out_toks, nxt = accept_greedy(tok, cands, vlogits, spec_k)
    if not greedy:
        a_s, out_s, nxt_s = accept_residual(tok, cands, vlogits, dlogits,
                                            temperature, gens, spec_k)
        sampled = temperature > 0
        a = torch.where(sampled, a_s, a)
        out_toks = torch.where(sampled[:, None], out_s, out_toks)
        nxt = torch.where(sampled, nxt_s, nxt)
    emitted, n_emit, n_gen, done = mask_round_emissions(
        out_toks, a + 1, done, n_gen, stop, max_new)
    cache = commit_verify(cfg, cache, pending,
                          torch.where(live_r, n_emit, 0), kv_fmt,
                          live=live_r)
    tok = torch.where(live_r, nxt, tok.to(torch.int32))
    return emitted, n_emit, tok, cache, done, n_gen, finite, a


class AdaptiveK:
    """Host-side per-slot draft-length controller (the reference's, as it
    is).

    Tracks an EMA of each slot's accept fraction (accepted over offered
    candidates, summed over a chunk's rounds). Below ``lower`` the slot's
    ``spec_k`` halves (floor ``k_min``); above ``upper`` it doubles back
    toward the configured ``k``. ``spec_k`` caps acceptance on the device
    per slot, while the dispatched round length is the most of the live
    slots' (``round_k``): one program per distinct k, and halving and
    doubling keep that set small.
    """

    def __init__(self, spec: SpeculativeConfig, n_slots: int):
        self.spec = spec
        self.ema = np.ones((n_slots,), np.float64)
        self.k = np.full((n_slots,), spec.k, np.int32)

    def arm(self, slot: int, k: Optional[int] = None) -> None:
        """Reset a slot's controller at admission (or seed it at resume)."""
        self.ema[slot] = 1.0
        self.k[slot] = self.spec.k if not k else min(k, self.spec.k)

    def update(self, live, accepted, offered) -> None:
        """Fold one chunk's per-slot acceptance counts into the EMAs."""
        spec = self.spec
        if not spec.adaptive:
            return
        act = np.asarray(live, bool) & (np.asarray(offered) > 0)
        rate = np.where(act, accepted / np.maximum(offered, 1), 0.0)
        self.ema = np.where(act, spec.ema * self.ema
                            + (1 - spec.ema) * rate, self.ema)
        self.k = np.where(act & (self.ema < spec.lower),
                          np.maximum(self.k // 2, spec.k_min), self.k)
        self.k = np.where(act & (self.ema > spec.upper),
                          np.minimum(self.k * 2, spec.k), self.k)

    def round_k(self, live) -> int:
        """Dispatch-wide draft length: the most live cap (>= 1 when
        idle)."""
        ks = self.k[np.asarray(live, bool)]
        return int(max(1, ks.max())) if ks.size else max(1, self.spec.k)
