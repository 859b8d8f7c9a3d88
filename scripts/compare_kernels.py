#!/usr/bin/env python3
"""Time the port's kernels of one checkout with ``chip_smoke.py``'s timer.

    python3 scripts/compare_kernels.py               # this checkout
    python3 scripts/compare_kernels.py --tree DIR    # another checkout

Builds the kernels of ``DIR/src/repro_torch`` and times them on one GPU
with the ``Timer`` and ``bound`` of the ``chip_smoke.py`` beside this
script (CUDA events, L2 flushed and the card spun before every launch), so
two versions of the kernels compare under one timer. Run it in one call
on the card for each tree, in the order parent, change, change, parent.

Times: the dequant GEMM at ``chip_smoke.MATMUL_KN`` x ``MATMUL_M`` beside
``torch.matmul`` bf16 and, at the decode rows, beside a PyTorch reduction
that reads the packed weight bytes once (``amax``: how fast a plain read of
those bytes streams on this card); then the quantizer (weight and
activation), decode attention (S 256 and 4096) and the qq GEMM (M 16 and
512) through ``chip_smoke``'s own checks. The last line is one JSON
object.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_matmul(cs, timer):
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import nxfp_matmul as nm
    from repro_torch.kernels.ops import quantize_qtensor

    fmt = get_format("nxfp4")
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for k, n in cs.MATMUL_KN:
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
        wq = quantize_qtensor(w, fmt, axis=-2, device="cuda")
        del w
        wd = nm.dequant_weight_bf16(wq.packed, wq.meta, fmt)     # (N, K)
        words = wq.packed.view(torch.int32)
        for m in cs.MATMUL_M:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            ms = timer(lambda: nm.nxfp_matmul(x, wq.packed, wq.meta, fmt))
            lib_ms = timer(lambda: torch.matmul(x, wd.T))
            n_bytes = (wq.packed.numel() + wq.meta.numel() * 2 + m * k * 2
                       + m * n * 4)
            b_ms, b_by = cs.bound(n_bytes, 2.0 * m * n * k, cs.PEAK_BF16)
            row = dict(ms=ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            if m < 512:
                row["read_packed_ms"] = timer(lambda: words.amax())
                row["read_packed_tb_s"] = (wq.packed.numel()
                                           / row["read_packed_ms"] / 1e9)
                row["kernel_tb_s"] = n_bytes / ms / 1e9
            cs.log(f"qmatmul M={m} K={k} N={n}: {json.dumps(row)}")
            rows[f"nxfp_matmul M={m} K={k} N={n}"] = row
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="root of the checkout whose kernels to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_kernels: needs a CUDA device")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (pins the TF32 flags)
    from repro_torch.kernels import build

    if not os.path.abspath(build.__file__).startswith(tree + os.sep):
        sys.exit(f"compare_kernels: imported {build.__file__}, not {tree}")
    info = build.build()
    cs.log(f"tree {tree}: build {info['seconds']:.1f} s"
           f"{' (cached)' if info['cached'] else ''}")
    timer = cs.Timer("cuda")
    rows = time_matmul(cs, timer)
    cs.check_quantizer(timer, rows)
    cs.check_act_quantizer(timer, rows)
    cs.check_attention(timer, rows)
    cs.check_qq_matmul(timer, rows)
    print(json.dumps({"tree": tree, "build_seconds": info["seconds"],
                      "cached": info["cached"], "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
