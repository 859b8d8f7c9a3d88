#!/usr/bin/env python3
"""How fast a checkpoint can leave the card and reach the disk on this
host: a 4 GiB f32 tensor copied to the host pageable and pinned (the
pinned buffer's allocation timed apart), written with ``np.save``,
flushed with ``os.sync``, read back with ``np.load`` and copied to the
card again. These rates bound a train state's save and restore
(``repro_torch.checkpoint``; chip_smoke phase 20).

    python3 scripts/host_copy_rates.py [--gib 4]

Needs a CUDA card; writes under the temporary directory and removes
what it wrote.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch


def _timed(what: str, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    print(f"{what}: {time.perf_counter() - t0:.3f} s", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gib", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; {args.gib} GiB f32", flush=True)
    x = torch.randn(args.gib << 28, device="cuda")
    torch.cuda.synchronize()
    _timed("pageable copy to the host", lambda: x.to("cpu", copy=True))
    pinned = _timed("pinned allocation", lambda: torch.empty(
        x.shape, dtype=x.dtype, pin_memory=True))
    _timed("pinned copy to the host", lambda: pinned.copy_(x))
    d = tempfile.mkdtemp()
    try:
        path = os.path.join(d, "x.npy")
        _timed("np.save", lambda: np.save(path, pinned.numpy()))
        _timed("os.sync", os.sync)
        back = _timed("np.load", lambda: np.load(path))
        _timed("pageable copy to the card",
               lambda: torch.from_numpy(back).to("cuda"))
    finally:
        shutil.rmtree(d)


if __name__ == "__main__":
    main()
