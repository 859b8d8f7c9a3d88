#!/usr/bin/env python3
"""Time one checkout's graph decode loop (or its dense prefill), to compare
two trees in one call.

    python3 scripts/compare_decode.py               # this checkout
    python3 scripts/compare_decode.py --tree DIR    # another checkout
    python3 scripts/compare_decode.py --prefill     # the prefill instead
    python3 scripts/compare_decode.py --continuous  # ContinuousEngine's chunk

Builds the kernels of ``DIR/src/repro_torch``, then Llama-3-8B at full
width (random weights, seed 0; ``--layers`` cuts the depth) behind
``ServeEngine`` with nxfp4 weights and KV, and times ms per decode step of
the CUDA-graph device loop, the main path of ``chip_smoke.py`` phase 5:
4 prompts of 128 tokens, 32 greedy tokens a call in chunks of 16, after a
warm-up call that captures the graph; ``--rounds`` calls, each step's
time its call's decode seconds over 32. ``--prefill`` times the dense
prefill instead (``models.prefill``, nxfp4 weights and KV, host clock
around a synchronized call, after two warm-ups): phase 5/6's 4 x 128
tokens and phase 8's largest admission, 1 x 256, ``--rounds`` each in
turns, then 3 of each under ``torch.profiler`` for the CUDA kernels and
the device-busy ms per prefill. ``--continuous`` times
``ContinuousEngine`` (4 slots, chunk 16, max_len 512, nxfp4 weights and
KV, no ``kv_integrity``) serving ``chip_smoke.py`` phase 8's 8 greedy
requests: each serve's median dispatch ms of the chunks with every slot
live (host clock, the chunk's one host copy included) and its wall a
chunk, ``--rounds`` serves after one that captures the graphs, then 2
serves under ``torch.profiler``: a serve's CUDA kernels and device-busy
ms (prefills included) over its chunks. Run it in one call on the card for each tree, in the order
parent, change, change, parent. The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, CHUNK = 32, 16
CONT_PROMPTS = (32, 64, 128, 256, 32, 64, 128, 256)     # chip_smoke phase 8
CONT_MAX_NEW = (8, 16, 24, 32, 40, 48, 56, 64)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="root of the checkout whose decode loop to time")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--prefill", action="store_true",
                    help="time the dense prefill, not the decode loop")
    ap.add_argument("--continuous", action="store_true",
                    help="time ContinuousEngine's decode chunks instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_decode: needs a CUDA device")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import repro_torch  # noqa: F401  (pins the TF32 flags)
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    if not os.path.abspath(build.__file__).startswith(tree + os.sep):
        sys.exit(f"compare_decode: imported {build.__file__}, not {tree}")
    build.build()
    cfg = dataclasses.replace(get_config("llama3_8b"), n_layers=args.layers)
    params = init_params(cfg, seed=0, device="cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.continuous:
        return time_continuous(cfg, params, args.rounds, tree, smi)
    engine = ServeEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                         max_len=256, device="cuda")
    del params
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 128),
                                     generator=gen).numpy()}
    if args.prefill:
        return time_prefill(cfg, engine, gen, args.rounds, tree, smi)
    first = engine.generate(batch, max_new=STEPS, loop="device", chunk=CHUNK)
    ms = []
    for _ in range(args.rounds):
        r = engine.generate(batch, max_new=STEPS, loop="device", chunk=CHUNK)
        if not (r.tokens == first.tokens).all():
            sys.exit("compare_decode: a round's tokens differ")
        ms.append(round(r.decode_seconds / STEPS * 1e3, 4))
    print(f"tree {tree}: graph decode loop ms/step {ms}, median "
          f"{statistics.median(ms):.4f} ({smi})", flush=True)
    print(json.dumps({"tree": tree, "layers": args.layers, "ms_per_step": ms,
                      "median": statistics.median(ms), "card": smi}),
          flush=True)


def time_prefill(cfg, engine, gen, rounds: int, tree: str, smi: str):
    """Seconds of the dense prefill at 4 x 128 and 1 x 256 tokens, in
    turns; every round's logits equal the first's."""
    import time
    from repro_torch.models import prefill

    shapes = {"4x128": (4, 128), "1x256": (1, 256)}
    toks = {k: torch.randint(0, cfg.vocab, s, generator=gen).to("cuda")
            for k, s in shapes.items()}

    def run(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(cfg, engine.params, {"tokens": toks[k]},
                                max_len=256, kv_fmt="nxfp4")
        torch.cuda.synchronize()
        return logits, time.perf_counter() - t0

    first = {k: run(k)[0] for k in shapes}
    for k in shapes:                                  # a second warm-up
        run(k)
    secs = {k: [] for k in shapes}
    for _ in range(rounds):
        for k in shapes:
            logits, sec = run(k)
            if not torch.equal(logits, first[k]):
                sys.exit(f"compare_decode: a {k} prefill's logits differ")
            secs[k].append(round(sec, 5))
    med = {k: statistics.median(v) for k, v in secs.items()}
    traced = {k: kernels_per_prefill(lambda k=k: run(k)) for k in shapes}
    print(f"tree {tree}: dense prefill seconds {secs}, medians {med}; "
          f"kernels and device-busy ms per prefill (traced) {traced} "
          f"({smi})", flush=True)
    print(json.dumps({"tree": tree, "layers": cfg.n_layers,
                      "prefill_seconds": secs, "median": med,
                      "traced": traced, "card": smi}), flush=True)


def time_continuous(cfg, params, rounds: int, tree: str, smi: str):
    """ms of ``ContinuousEngine``'s decode chunks over ``rounds`` serves of
    phase 8's requests; every serve's streams equal the first's."""
    import time
    import numpy as np
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.serving import ContinuousEngine, Request
    from repro_torch.serving.engine import load_params

    nx = load_params(params, QuantPolicy("nxfp4", None), torch.device("cuda"))
    del params
    torch.cuda.empty_cache()
    eng = ContinuousEngine(cfg, nx, QuantPolicy("nxfp4", "nxfp4"),
                           n_slots=4, chunk=16, max_len=512, device="cuda")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, max_new=n,
                    tokens=rng.integers(0, cfg.vocab, t, dtype=np.int32))
            for i, (t, n) in enumerate(zip(CONT_PROMPTS, CONT_MAX_NEW))]

    def serve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.serve(reqs)
        torch.cuda.synchronize()
        return ({r.uid: r.tokens.tolist() for r in res},
                time.perf_counter() - t0)

    first = serve()[0]
    chunk, wall = [], []
    for _ in range(rounds):
        toks, sec = serve()
        if toks != first:
            sys.exit("compare_decode: a serve's streams differ")
        full = [t for live, t in eng.chunk_times if live == eng.n_slots]
        chunk.append(round(statistics.median(full) * 1e3, 4))
        wall.append(round(sec / eng.chunks * 1e3, 4))
    n_kernels, busy = kernels_per_prefill(lambda: serve(), n=2)
    traced = (round(n_kernels / eng.chunks, 1), round(busy / eng.chunks, 4))
    med = {"chunk_ms": statistics.median(chunk),
           "wall_ms_a_chunk": statistics.median(wall)}
    print(f"tree {tree}: ContinuousEngine chunk ms {chunk}, wall a chunk "
          f"{wall}, medians {med}; a serve's CUDA kernels and device-busy ms "
          f"over its {eng.chunks} chunks (traced) {traced} ({smi})",
          flush=True)
    print(json.dumps({"tree": tree, "layers": cfg.n_layers,
                      "chunk_ms": chunk, "wall_ms_a_chunk": wall,
                      "median": med, "traced": traced, "card": smi}),
          flush=True)


def kernels_per_prefill(fn, n: int = 3):
    """(CUDA kernels, device-busy ms) per call of ``fn``, from
    ``torch.profiler`` over ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
    dev = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == dev]
    return (round(sum(e.count for e in kernels) / n, 1),
            round(sum(e.self_device_time_total for e in kernels) / n / 1e3,
                  4))


if __name__ == "__main__":
    main()
