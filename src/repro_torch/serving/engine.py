"""Batched serving engine with direct-cast NxFP weights + KV cache.

The deployment the paper targets (section 6): dense-trained weights are
direct-cast once at load time (Algorithm 1, the CUDA quantizer), the KV
cache is cast per token, and every projection GEMM dequantizes on the fly.

Two decode loops, bitwise equal by construction (same ops, same order):

  * ``loop="device"``: ``chunk`` decode steps run back to back on the card,
    sampling and stop-token masking included; the host copies the chunk's
    tokens once. (A CUDA graph per chunk is later work.)
  * ``loop="host"``: one decode step and one host copy per token, the
    dispatch-bound baseline and the equality oracle.

Sampling draws from a ``torch.Generator`` seeded with ``rng_seed``. It does
not reproduce the reference's JAX PRNG stream. Greedy decoding (all
temperatures 0) never touches the generator.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..core.qtensor import (QTensor, QuantPolicy, direct_cast_tree,
                            tree_footprint_bytes)
from ..kernels.ops import quantize_qtensor
from ..models import decode_loop, decode_step, prefill
from ..models.common import ModelConfig

logger = logging.getLogger("repro_torch.serving")


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, max_new)
    n_generated: np.ndarray     # (B,)
    prefill_seconds: float
    decode_seconds: float
    step_times: List[float]     # host loop: per token; device loop: per chunk


def _watchdog(times: List[float], unit: str):
    """Straggler telemetry: flag steps > 3x median (host clock)."""
    if len(times) > 4:
        med = float(np.median(times))
        slow = [i for i, s in enumerate(times) if s > 3 * med]
        if slow:
            logger.warning("%d slow decode %ss (>%.1f ms): %s",
                           len(slow), unit, 3 * med * 1e3, slow[:8])


def _per_seq(value, b: int, dtype, default):
    """Broadcast a scalar / per-sequence sampling config to a (B,) array."""
    if value is None:
        value = default
    return np.broadcast_to(np.asarray(value, dtype), (b,)).copy()


def mask_chunk_emissions(toks, done, n_gen, stop):
    """Shared chunk emission/stop semantics (host-loop equivalent).

    toks (B, n) are a chunk's raw decode outputs. Step i of row b is live
    iff the row was not done at chunk entry and no stop token landed
    strictly earlier in the chunk (the hit itself emits). (The reference's
    per-slot ``max_new`` budget serves its continuous engine, not ported.)
    Returns (emitted (B, n), n_gen', done').
    """
    hits = toks == stop[:, None]                       # stop<0: never
    hi = hits.to(torch.int32)
    before = torch.cumsum(hi, dim=1) - hi              # stops before i
    done_before = done[:, None] | (before > 0)         # (B, n)
    emitted = torch.where(done_before, torch.zeros_like(toks), toks)
    n_gen = n_gen + (~done_before).sum(dim=1).to(torch.int32)
    done = done | hits.any(dim=1)
    return emitted, n_gen, done


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, policy: QuantPolicy,
                 max_len: int = 2048, rng_seed: int = 0, device=None):
        self.cfg = cfg
        self.policy = policy
        self.max_len = max_len
        self.device = resolve_device(device)
        params = _to_device(params, self.device)
        # load-time weight cast through the fused encode+pack quantizer
        dev = self.device
        self.params = (direct_cast_tree(
            params, policy,
            quantize_fn=lambda leaf, fmt, axis: quantize_qtensor(
                leaf, fmt, axis, device=dev))
            if policy.weight_fmt else params)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)

    def _sample(self, logits, temperature, all_greedy: bool):
        """logits (B, V); temperature (B,) tensor, rows with 0 take argmax.
        An all-greedy batch never touches the generator."""
        greedy = torch.argmax(logits, dim=-1)
        if all_greedy:
            return greedy
        safe = torch.where(temperature > 0, temperature, 1.0)
        probs = torch.softmax(logits / safe[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.where(temperature > 0, sampled, greedy)

    def _prefill(self, batch):
        tokens = torch.as_tensor(np.asarray(batch["tokens"]),
                                 dtype=torch.int64).to(self.device)
        logits, cache = prefill(self.cfg, self.params, {"tokens": tokens},
                                max_len=self.max_len,
                                kv_fmt=self.policy.kv_fmt)
        return logits, cache

    def generate(self, batch: Dict[str, Any], max_new: int,
                 temperature: Union[float, np.ndarray] = 0.0,
                 stop_token: Optional[Union[int, np.ndarray]] = None,
                 loop: str = "device", chunk: int = 32) -> GenerationResult:
        """Generate ``max_new`` tokens per sequence.

        ``temperature`` / ``stop_token`` take a scalar or a per-sequence
        (B,) vector; a stop entry of -1 disables the stop token for that
        row. ``loop="device"`` runs ``chunk`` steps per host copy,
        ``loop="host"`` one step per host copy (see the module doc).
        """
        if loop not in ("device", "host"):
            raise ValueError(f"loop must be 'device' or 'host', got {loop!r}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        b = np.asarray(batch["tokens"]).shape[0]
        temp_np = _per_seq(temperature, b, np.float32, 0.0)
        stop_np = _per_seq(stop_token, b, np.int64, -1)
        greedy = bool((temp_np == 0.0).all())
        temp = torch.as_tensor(temp_np).to(self.device)
        stop = torch.as_tensor(stop_np).to(self.device)

        def sample(logits):
            return self._sample(logits, temp, greedy).to(torch.int32)

        if loop == "host":
            return self._generate_host(batch, max_new, sample, stop_np)
        has_stop = bool((stop_np >= 0).any())
        kv = self.policy.kv_fmt

        t0 = time.time()
        logits, cache = self._prefill(batch)
        _sync(self.device)
        t1 = time.time()

        out = np.zeros((b, max_new), np.int32)
        tok = sample(logits)
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        n_gen = torch.zeros((b,), dtype=torch.int32, device=self.device)
        chunk_times: List[float] = []
        i = 0
        while i < max_new:
            c = min(chunk, max_new - i)
            ts = time.time()
            toks, tok, cache = decode_loop(self.cfg, self.params, tok, cache,
                                           c, kv, sample)
            emitted, n_gen, done = mask_chunk_emissions(toks, done, n_gen,
                                                        stop)
            out[:, i:i + c] = emitted.cpu().numpy()   # one copy per chunk
            chunk_times.append(time.time() - ts)
            i += c
            if has_stop and bool(done.all()):
                break
        t2 = time.time()
        _watchdog(chunk_times, "chunk")
        return GenerationResult(out, n_gen.cpu().numpy(), t1 - t0, t2 - t1,
                                chunk_times)

    def _generate_host(self, batch: Dict[str, Any], max_new: int, sample,
                       stop: np.ndarray) -> GenerationResult:
        t0 = time.time()
        logits, cache = self._prefill(batch)
        _sync(self.device)
        t1 = time.time()

        tok = sample(logits)
        tok_np = tok.cpu().numpy()

        b = tok_np.shape[0]
        has_stop = bool((stop >= 0).any())
        out = np.zeros((b, max_new), np.int32)
        done = np.zeros((b,), bool)
        n_gen = np.zeros((b,), np.int32)
        step_times: List[float] = []
        for i in range(max_new):
            out[:, i] = np.where(done, 0, tok_np)
            n_gen += (~done).astype(np.int32)
            if has_stop:
                done |= tok_np == stop
            if done.all():
                break
            ts = time.time()
            logits, cache = decode_step(self.cfg, self.params, tok[:, None],
                                        cache, self.policy.kv_fmt)
            tok = sample(logits)
            tok_np = tok.cpu().numpy()
            step_times.append(time.time() - ts)
        t2 = time.time()
        _watchdog(step_times, "step")
        return GenerationResult(out, n_gen, t1 - t0, t2 - t1, step_times)

    def weights_footprint_bytes(self) -> int:
        return tree_footprint_bytes(self.params)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(tree, device):
    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, packed=tree.packed.to(device),
                                   meta=tree.meta.to(device))
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
