#!/usr/bin/env python3
"""Where a decode step of the torch port spends its time, on one GPU.

    python3 scripts/profile_decode.py              # Llama-3-8B, 32 layers
    python3 scripts/profile_decode.py --layers 4 --steps 4

Builds Llama-3-8B at full width (random weights, seed 0) behind
``ServeEngine`` with nxfp4 weights and nxfp4 KV, prefills 4 prompts of 128
tokens, warms up, then runs ``--steps`` decode steps under
``torch.profiler`` (CPU and CUDA activity), ``GRAPH_CHUNKS`` chunks of
``GRAPH_STEPS`` greedy steps through the device loop's CUDA graph (one
replay a chunk, after the capturing call), and ``PREFILLS`` prefills of
the same prompts with dense activations and with the qq path
(``act_fmt="amxfp4"``). Prints, per decode step and per prefill: the
host-clock time, the device time summed over kernels (busy) and the idle
share, the top kernels by device time and the top CPU operators by self
time; then the host cost of one call of each kernel wrapper at a decode
step's shapes (the quantizer: K and V into the cache), launch only, no
synchronise. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFILLS = 3          # prefills traced per activation format
GRAPH_STEPS = 8       # decode steps per traced graph replay
GRAPH_CHUNKS = 4      # graph replays traced (the cache holds them all)


def wrapper_host_us(n: int = 200):
    """Host microseconds per wrapper call at decode shapes (launch only)."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import nxfp_attention as na
    from repro_torch.kernels import nxfp_matmul as nm
    from repro_torch.kernels import nxfp_quantize as nq
    from repro_torch.kernels.ops import quantize_qtensor

    fmt = get_format("nxfp4")
    dev = torch.device("cuda")
    w = quantize_qtensor(torch.randn((4096, 4096), device=dev), fmt, -2,
                         device=dev)
    x = torch.randn((4, 4096), device=dev).to(torch.bfloat16)
    k1 = torch.randn((4, 1, 8, 128), device=dev).to(torch.bfloat16)
    cache = {f"{n}_{key}": torch.zeros((4, 256, 8, 4) + tail, dtype=dt,
                                       device=dev)
             for n in "kv" for key, tail, dt in (
                 ("packed", (16,), torch.uint8), ("meta", (), torch.uint16))}
    pos = torch.full((4,), 200, dtype=torch.int32, device=dev)
    kv = quantize_qtensor(torch.randn((4, 256, 8, 128), device=dev), fmt, -1,
                          device=dev)
    q = torch.randn((4, 8, 4, 128), device=dev)
    lens = torch.full((4,), 200, dtype=torch.int32, device=dev)
    calls = {
        "nxfp_matmul": lambda: nm.nxfp_matmul(x, w.packed, w.meta, fmt),
        "nxfp_quantize": lambda: nq.nxfp_quantize_kv_rows(k1, k1, cache, pos,
                                                          fmt),
        "nxfp_decode_attention": lambda: na.nxfp_decode_attention(
            q, kv.packed, kv.meta, kv.packed, kv.meta, lens, fmt),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return out


def trace(label: str, fn, n: int) -> None:
    """Time ``n`` calls of ``fn`` untraced (host clock, after a warm-up
    call), then ``n`` more under ``torch.profiler``, and print per call:
    the host-clock time, the device time summed over kernels (busy) and
    the idle share, the top kernels by device time and the top CPU
    operators by self time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / n * 1e3

    dev_type = torch.autograd.DeviceType.CUDA
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == dev_type]
    busy_us = sum(e.self_device_time_total for e in kernels) / n
    print(f"{label}: {wall_ms:.3f} ms (host clock, untraced), "
          f"{traced_ms:.3f} ms traced", flush=True)
    print(f"device busy {busy_us / 1e3:.3f} ms per call (sum of kernel "
          f"times), idle share {1 - busy_us / 1e3 / traced_ms:.3f} of the "
          f"traced call; {sum(e.count for e in kernels) / n:.0f} kernels "
          "per call")
    print("top kernels by device time per call:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / n / 1e3:9.4f} ms  "
              f"{e.count / n:6.1f}x  {e.key[:100]}")
    cpu_ops = [e for e in avgs if e.device_type != dev_type]
    print("top CPU operators by self host time per call:")
    for e in sorted(cpu_ops, key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"  {e.self_cpu_time_total / n / 1e3:9.4f} ms  "
              f"{e.count / n:6.1f}x  {e.key[:100]}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_decode: needs a CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))

    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServeEngine

    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=args.layers)
    params = init_params(cfg, seed=0, device="cuda")
    engine = ServeEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                         max_len=256, device="cuda")
    del params
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (4, 128), generator=gen).cuda()
    logits, cache = prefill(cfg, engine.params, {"tokens": tokens},
                            max_len=256, kv_fmt="nxfp4")
    state = {"logits": logits, "cache": cache}

    def step():
        tok = torch.argmax(state["logits"], dim=-1).to(torch.int32)
        state["logits"], state["cache"] = decode_step(
            cfg, engine.params, tok[:, None], state["cache"], "nxfp4")

    for _ in range(3):                                     # warm-up
        step()
    trace(f"{cfg.name}, {cfg.n_layers} layers, B 4, context 128+: decode "
          "step", step, args.steps)
    # the device loop: one captured graph of GRAPH_STEPS steps
    logits, cache = prefill(cfg, engine.params, {"tokens": tokens},
                            max_len=256, kv_fmt="nxfp4")
    prog = engine._device_loop(cache)
    prog.load(cache)
    del cache
    b = tokens.shape[0]
    loop = {"tok": torch.argmax(logits, dim=-1).to(torch.int32),
            "done": torch.zeros((b,), dtype=torch.bool, device="cuda"),
            "n_gen": torch.zeros((b,), dtype=torch.int32, device="cuda")}
    temp = torch.zeros((b,), device="cuda")
    stop = torch.full((b,), -1, dtype=torch.int64, device="cuda")

    def chunk():
        (_, loop["tok"], loop["n_gen"], loop["done"]), _ = prog.run(
            GRAPH_STEPS, True, loop["tok"], loop["done"], loop["n_gen"],
            temp, stop)

    trace(f"graph device loop, one replay of {GRAPH_STEPS} decode steps "
          "(per-step figures: divide by it)", chunk, GRAPH_CHUNKS)
    for act_fmt in (None, "amxfp4"):
        trace(f"prefill of 4 x 128 tokens, act_fmt={act_fmt}",
              lambda: prefill(cfg, engine.params, {"tokens": tokens},
                              max_len=256, kv_fmt="nxfp4", act_fmt=act_fmt),
              PREFILLS)
    print("host microseconds per wrapper call (launch only): "
          + ", ".join(f"{k} {v:.1f}" for k, v in wrapper_host_us().items()))


if __name__ == "__main__":
    main()
