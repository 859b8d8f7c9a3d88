"""Batched serving engine with direct-cast NxFP weights + KV cache.

The deployment the paper targets (section 6): dense-trained weights are
direct-cast once at load time (Algorithm 1, the CUDA quantizer), the KV
cache is cast per token, and every projection GEMM dequantizes on the fly.

Two decode loops, bitwise equal by construction (same ops, same order):

  * ``loop="device"``: one chunk function (``decode_chunk``: ``chunk``
    decode steps, sampling and stop-token masking) per host copy. On CUDA
    the chunk is one captured ``torch.cuda.CUDAGraph`` replayed from
    static buffers, the counterpart of the reference's jitted
    ``lax.scan`` chunk; graphs are cached process-wide per (engine,
    batch, steps, greedy or sampled; the engine fixes max_len and kv_fmt),
    the counterpart of its ``cached_program``. A capture that fails raises: there is no eager
    loop behind it on CUDA. On the CPU the same chunk function runs
    eagerly from the same static buffers.
  * ``loop="host"``: one decode step and one host copy per token, the
    dispatch-bound baseline and the equality oracle.

Sampling draws from a ``torch.Generator`` seeded with ``rng_seed``: one
draw of exponential noise over the (B, V) probabilities per sampled token,
which the CUDA graph replays through the generator registered with it. It
does not reproduce the reference's JAX PRNG stream. Greedy decoding (all
temperatures 0) never touches the generator. After a sampled call the
generator stands where the host loop leaves it, whichever loop ran
(``_sync_key``, as the reference's), so later sampled calls do not depend
on the loop mode.

A sliding-window model's cache is a ring of ``window`` rows
(``models/kvcache.py``), so ``max_len`` bounds nothing there: a prompt and
its generation may run past it, as in the reference.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import time
import weakref
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..core.qtensor import QuantPolicy, tree_footprint_bytes
from ..models import decode_loop, decode_step, prefill, recurrent_state
from ..models.common import ModelConfig, cast_params

logger = logging.getLogger("repro_torch.serving")

# process-wide chunk programs: captured CUDA graphs (and, on the CPU, the
# static buffers the eager chunk runs from), keyed by everything a capture
# closes over: the engine (its weights, generator, max_len, kv_fmt and
# device) and the batch (a _DeviceLoop), then steps and greedy (its
# graphs). An engine's entries go when the engine is collected.
_PROGRAM_CACHE: Dict[Any, "_DeviceLoop"] = {}
# a batch's memory inputs: the vision family's patch embeddings, the audio
# family's frame embeddings (``models.lm.prefill``)
_MEMORY_INPUTS = ("vision", "frames")
_ENGINE_IDS = itertools.count()


def cached_program(key, build):
    """The cached program under ``key``, built by ``build()`` on a miss."""
    prog = _PROGRAM_CACHE.get(key)
    if prog is None:
        prog = _PROGRAM_CACHE[key] = build()
    return prog


def _drop_engine(uid: int) -> None:
    for key in [k for k in _PROGRAM_CACHE if k[0] == uid]:
        del _PROGRAM_CACHE[key]


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


def mask_chunk_emissions(toks, done, n_gen, stop, max_new=None):
    """Shared chunk emission/stop semantics (host-loop equivalent).

    toks (B, n) are a chunk's raw decode outputs. Step i of row b is live
    iff the row was not done at chunk entry, no stop token landed
    strictly earlier in the chunk (the hit itself emits), and, when a
    per-slot ``max_new`` budget (B,) is given (the continuous engine),
    ``n_gen + i < max_new``. Returns (emitted (B, n), n_gen', done').
    """
    hits = toks == stop[:, None]                       # stop<0: never
    hi = hits.to(torch.int32)
    before = torch.cumsum(hi, dim=1) - hi              # stops before i
    done_before = done[:, None] | (before > 0)         # (B, n)
    if max_new is not None:
        budget = n_gen[:, None] + torch.arange(
            toks.shape[1], dtype=torch.int32, device=toks.device)[None, :]
        done_before = done_before | (budget >= max_new[:, None])
    emitted = torch.where(done_before, torch.zeros_like(toks), toks)
    n_gen = n_gen + (~done_before).sum(dim=1).to(torch.int32)
    done = done | hits.any(dim=1)
    if max_new is not None:
        done = done | (n_gen >= max_new)
    return emitted, n_gen, done


def exp_noise(probs, gen):
    """The sampler's one use of a generator: Exp(1) noise over the
    probabilities (``ServeEngine._sync_key`` replays these draws)."""
    return torch.empty_like(probs).exponential_(1.0, generator=gen)


def sample_tokens(logits, temperature, all_greedy: bool, gens):
    """logits (B, V); temperature (B,) tensor, rows with 0 take argmax.
    A sampled row takes argmax(p / E), E ~ Exp(1) i.i.d.: token i with
    probability p_i, as ``torch.multinomial`` draws one sample, with no
    host sync (capturable). ``gens`` is one generator drawing E over the
    (B, V) probabilities (``ServeEngine``), or one per row, each drawing
    over its own (1, V) row as a solo engine's draws (the continuous
    engine's slots; a row's softmax, division and argmax do not depend on
    the other rows). An all-greedy batch never touches a generator."""
    greedy = torch.argmax(logits, dim=-1)
    if all_greedy:
        return greedy
    safe = torch.where(temperature > 0, temperature, 1.0)
    probs = torch.softmax(logits / safe[:, None], dim=-1)
    if isinstance(gens, torch.Generator):
        noise = exp_noise(probs, gens)
    else:
        noise = torch.empty_like(probs)
        for b, gen in enumerate(gens):
            noise[b:b + 1].exponential_(1.0, generator=gen)
    sampled = torch.argmax(probs / noise, dim=-1)
    return torch.where(temperature > 0, sampled, greedy)


def capture_graph(fn, device, gens=(), warm=None, keep=()):
    """Capture ``fn()`` as a CUDA graph; returns (graph, outputs).

    One warm-up call first (``warm()``, default ``fn()``), on the capture
    stream, so the split kernels plan and allocate their per-stream
    scratch (``kernels/build.py:split_scratch``) before the capture (their
    counters are back at 0 after every launch, so every replay starts
    clean). The warm-up runs for real on the live buffers, so it must
    write nothing the replay reads first: a decode chunk warms up with
    one step, which writes only the K/V row its replay's first step
    writes again with the same bits (a whole chunk's later steps would
    overwrite rows of a full sliding-window ring that the replay's first
    steps still attend to). A recurrent state is read and then advanced,
    so the tensors in ``keep`` (the Mamba state of cache and lane,
    ``models.recurrent_state``) are put back after the warm-up: without
    that the replay would integrate the warm-up's step a second time.
    The generators in
    ``gens`` are put back where they were after the warm-up and the
    capture, and registered with the graph, so that every replay draws
    from (and advances) their state at replay time. A capture that fails
    raises."""
    states = [g.get_state() for g in gens]
    saved = [t.clone() for t in keep]
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        (warm or fn)()                # warm-up: plans and scratch of `side`
        for t, s in zip(keep, saved):
            t.copy_(s)
    torch.cuda.current_stream(device).wait_stream(side)
    del saved
    for g, state in zip(gens, states):
        g.set_state(state)
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, stream=side):
        outs = fn()
    for g, state in zip(gens, states):
        g.set_state(state)
    return graph, outs


def decode_chunk(cfg: ModelConfig, params, kv_fmt: Optional[str],
                 n_steps: int, sample_fn, tok, done, n_gen, stop, cache):
    """One device-loop chunk (the reference's ``_chunk_fn``): ``n_steps``
    decode steps with sampling (``decode_loop``), then the chunk's
    emission and stop masking. Returns (emitted (B, n), tok, n_gen, done,
    cache)."""
    toks, tok, cache = decode_loop(cfg, params, tok, cache, n_steps, kv_fmt,
                                   sample_fn)
    emitted, n_gen, done = mask_chunk_emissions(toks, done, n_gen, stop)
    return emitted, tok, n_gen, done, cache


class _DeviceLoop:
    """The device loop of one (engine, batch): static
    input buffers (tok, done, n_gen, temperature, stop, and the whole
    cache), and per (steps, greedy) one chunk program over them: a
    captured CUDA graph on CUDA, the eager chunk function on the CPU.

    A chunk copies its inputs into the static buffers, runs the program and
    copies emitted tokens, n_gen and done to the host in one copy; tok,
    n_gen, done and the cache stay on the device for the next chunk.
    Capture: ``capture_graph``, the engine's generator registered with a
    sampled chunk's graph.
    """

    def __init__(self, engine: "ServeEngine", cache):
        # weak: the cache entry must not keep its engine alive (the
        # engine's finalizer drops the entry)
        self._engine = weakref.ref(engine)
        self.dev = engine.device
        b = cache["pos"].shape[0]

        def z(t):
            return torch.zeros_like(t)

        self.cache = {"pos": z(cache["pos"]),
                      "layers": [{k: z(v) for k, v in layer.items()}
                                 for layer in cache["layers"]]}
        self.tok = torch.zeros((b,), dtype=torch.int32, device=self.dev)
        self.done = torch.zeros((b,), dtype=torch.bool, device=self.dev)
        self.n_gen = torch.zeros((b,), dtype=torch.int32, device=self.dev)
        self.temp = torch.zeros((b,), dtype=torch.float32, device=self.dev)
        self.stop = torch.zeros((b,), dtype=torch.int64, device=self.dev)
        self.graphs: Dict[Any, Any] = {}   # (steps, greedy) -> (graph, outs)
        self.replays = 0

    def load(self, cache) -> None:
        """Copy a prefilled cache into the static one."""
        self.cache["pos"].copy_(cache["pos"])
        for dst, src in zip(self.cache["layers"], cache["layers"]):
            for k, v in src.items():
                dst[k].copy_(v)

    def _fn(self, steps: int, greedy: bool):
        eng = self._engine()

        def sample(logits):
            return eng._sample(logits, self.temp, greedy).to(torch.int32)

        return lambda: decode_chunk(
            eng.cfg, eng.params, eng.policy.kv_fmt, steps, sample, self.tok,
            self.done, self.n_gen, self.stop, self.cache)

    def _capture(self, steps: int, greedy: bool):
        gens = () if greedy else (self._engine()._gen,)
        return capture_graph(self._fn(steps, greedy), self.dev, gens,
                             warm=self._fn(1, greedy),
                             keep=recurrent_state(self.cache))

    def run(self, steps: int, greedy: bool, tok, done, n_gen, temp, stop):
        """One chunk from these inputs. Returns (emitted, tok, n_gen, done)
        on the device and, in one host copy, emitted (B, steps), n_gen and
        done as numpy."""
        for dst, src in ((self.tok, tok), (self.done, done),
                         (self.n_gen, n_gen), (self.temp, temp),
                         (self.stop, stop)):
            dst.copy_(src)
        if self.dev.type == "cuda":
            key = (steps, greedy)
            if key not in self.graphs:
                self.graphs[key] = self._capture(steps, greedy)
            graph, outs = self.graphs[key]
            graph.replay()
            self.replays += 1
        else:
            outs = self._fn(steps, greedy)()
        emitted, tok, n_gen, done, cache = outs
        self.cache["pos"].copy_(cache["pos"])
        host = torch.cat([emitted, n_gen[:, None],
                          done[:, None].to(torch.int32)], dim=1).cpu().numpy()
        return ((emitted, tok, n_gen, done),
                (host[:, :steps], host[:, steps], host[:, steps + 1] != 0))


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, policy: QuantPolicy,
                 max_len: int = 2048, rng_seed: int = 0, device=None):
        self.cfg = cfg
        self.policy = policy
        self.max_len = max_len
        self.device = resolve_device(device)
        self.params = load_params(params, policy, self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)
        self._uid = next(_ENGINE_IDS)
        weakref.finalize(self, _drop_engine, self._uid)

    def _sample(self, logits, temperature, all_greedy: bool):
        """``sample_tokens`` through the engine's generator."""
        return sample_tokens(logits, temperature, all_greedy, self._gen)

    def _device_loop(self, cache) -> _DeviceLoop:
        """This engine's device loop for the cache's batch (cached
        process-wide)."""
        key = (self._uid, cache["pos"].shape[0])
        return cached_program(key, lambda: _DeviceLoop(self, cache))

    def _prefill(self, batch):
        """``prefill`` of the batch on the engine's device: its tokens and
        the memory input its family reads (``vision``, ``frames``)."""
        return prefill(self.cfg, self.params, self._inputs(batch),
                       max_len=self.max_len, kv_fmt=self.policy.kv_fmt)

    def _inputs(self, batch) -> Dict[str, Any]:
        """The batch as tensors on the engine's device: ``tokens`` int64
        and, where present, the memory inputs as they are given."""
        out = {"tokens": torch.as_tensor(np.asarray(batch["tokens"]),
                                         dtype=torch.int64).to(self.device)}
        for name in _MEMORY_INPUTS:
            if name in batch:
                out[name] = torch.as_tensor(batch[name]).to(self.device)
        return out

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

        t0 = time.time()
        logits, cache = self._prefill(batch)
        _sync(self.device)
        t1 = time.time()

        out = np.zeros((b, max_new), np.int32)
        n_host = np.zeros((b,), np.int32)
        tok = sample(logits)
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        n_gen = torch.zeros((b,), dtype=torch.int32, device=self.device)
        loop_prog = self._device_loop(cache)
        loop_prog.load(cache)
        del cache
        chunk_times: List[float] = []
        i, gen_before = 0, None
        while i < max_new:
            c = min(chunk, max_new - i)
            ts = time.time()
            if not greedy:            # where the generator stood (_sync_key)
                gen_before = (i, self._gen.get_state())
            (_, tok, n_gen, done), (emitted, n_host, done_host) = \
                loop_prog.run(c, greedy, tok, done, n_gen, temp, stop)
            out[:, i:i + c] = emitted
            chunk_times.append(time.time() - ts)
            i += c
            if has_stop and done_host.all():
                break
        if not greedy:
            self._sync_key(out, n_host, max_new, stop_np, gen_before,
                           logits.shape)
        t2 = time.time()
        _watchdog(chunk_times, "chunk")
        return GenerationResult(out, n_host.copy(), t1 - t0, t2 - t1,
                                chunk_times)

    def _sync_key(self, out, n_gen, max_new: int, stop: np.ndarray,
                  before, shape):
        """Put the generator where the host loop leaves it (the reference's
        ``_sync_key``). The host loop draws once after prefill and once per
        step until ``done.all()``, which it checks before each step: it
        draws max(n_gen) times when every row ended on its stop token, else
        1 + max_new. The device loop always finishes its chunk; the host
        loop's stop falls in the last chunk, so the generator goes back to
        where that chunk began (``before``: its first step and the state)
        and draws the host loop's remaining draws again (each draw's
        advance depends only on the (B, V) shape)."""
        draws = 1 + max_new
        if (stop >= 0).any() and max_new > 0:
            last = out[np.arange(out.shape[0]), np.maximum(n_gen, 1) - 1]
            if (n_gen > 0).all() and (last == stop).all():
                draws = int(n_gen.max())
        i0, state = before
        if draws >= 1 + max_new:
            return
        self._gen.set_state(state)
        probs = torch.empty(shape, dtype=torch.float32, device=self.device)
        for _ in range(draws - 1 - i0):
            exp_noise(probs, self._gen)

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


def load_params(params, policy: QuantPolicy, device: torch.device):
    """The weights on ``device``, direct-cast at load time through the
    fused encode+pack quantizer when the policy has a weight format.
    Without one, the leaves a cast would replace are stored in bf16: each
    only ever enters a GEMM that rounds it to bf16 first
    (``kernels/ops.py``), so the stored rounding changes no result and
    halves an f32 tree. Other leaves keep their dtype
    (``models.common.cast_params``).

    A tree built cast (``models.init_params(policy=)``) passes through:
    its QTensor leaves stay as they are when their format is the policy's
    ``weight_fmt`` (or the policy has none: a tree cast before is served
    as it is); a leaf cast to another format raises ValueError naming the
    leaf."""
    return cast_params(params, policy, device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
