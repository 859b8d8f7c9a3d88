#!/usr/bin/env python3
"""Time one checkout's graph decode loop, to compare two trees in one call.

    python3 scripts/compare_decode.py               # this checkout
    python3 scripts/compare_decode.py --tree DIR    # another checkout

Builds the kernels of ``DIR/src/repro_torch``, then Llama-3-8B at full
width (random weights, seed 0; ``--layers`` cuts the depth) behind
``ServeEngine`` with nxfp4 weights and KV, and times ms per decode step of
the CUDA-graph device loop, the main path of ``chip_smoke.py`` phase 5:
4 prompts of 128 tokens, 32 greedy tokens a call in chunks of 16, after a
warm-up call that captures the graph; ``--rounds`` calls, each step's
time its call's decode seconds over 32. Run it in one call on the card
for each tree, in the order parent, change, change, parent. The last
line is one JSON object.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="root of the checkout whose decode loop to time")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=8)
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
    engine = ServeEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                         max_len=256, device="cuda")
    del params
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 128),
                                     generator=gen).numpy()}
    first = engine.generate(batch, max_new=STEPS, loop="device", chunk=CHUNK)
    ms = []
    for _ in range(args.rounds):
        r = engine.generate(batch, max_new=STEPS, loop="device", chunk=CHUNK)
        if not (r.tokens == first.tokens).all():
            sys.exit("compare_decode: a round's tokens differ")
        ms.append(round(r.decode_seconds / STEPS * 1e3, 4))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"tree {tree}: graph decode loop ms/step {ms}, median "
          f"{statistics.median(ms):.4f} ({smi})", flush=True)
    print(json.dumps({"tree": tree, "layers": args.layers, "ms_per_step": ms,
                      "median": statistics.median(ms), "card": smi}),
          flush=True)


if __name__ == "__main__":
    main()
