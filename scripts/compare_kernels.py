#!/usr/bin/env python3
"""Time the port's kernels of one checkout with ``chip_smoke.py``'s timer.

    python3 scripts/compare_kernels.py               # this checkout
    python3 scripts/compare_kernels.py --tree DIR    # another checkout
    python3 scripts/compare_kernels.py --only attention   # one kernel's rows
                                           # (matmul, quantize, attention)

Builds the kernels of ``DIR/src/repro_torch`` and times them on one GPU
with the ``Timer`` and ``bound`` of the ``chip_smoke.py`` beside this
script (CUDA events, L2 flushed and the card spun before every launch), so
two versions of the kernels compare under one timer. Run it in one call
on the card for each tree, in the order parent, change, change, parent.

Times: the dequant GEMM at ``chip_smoke.MATMUL_KN`` x ``MATMUL_M`` beside
``torch.matmul`` bf16 and, at the decode rows, beside a PyTorch reduction
that reads the packed weight bytes once (``amax``: how fast a plain read of
those bytes streams on this card); then the quantizer (weight,
activation, and the decode and prefill K/V cache writes), decode
attention (S 256 and 4096) and the qq GEMM (M 16 and 512) through
``chip_smoke``'s own checks, and the quantizer's two regimes forced at
``REGIME_BLOCKS`` block counts, and the SASS instructions per value and
candidate of its main-path kernels; first the timer's floor (a
one-element add), the least time it reads for any launch. A checkout whose quantizer has no K/V
entry (``nxfp_quantize_kv_rows``) skips the K/V rows and the sweep. The last line is one JSON
object.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
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


# block counts for the quantizer's regime sweep (nxfp4, bf16 input)
REGIME_BLOCKS = (256, 1024, 4096, 8192, 16384, 32768, 131072)


def time_quantize_regimes(cs, timer):
    """The quantizer's two regimes forced at each of ``REGIME_BLOCKS``
    blocks (nxfp4 bf16 blocks of 32): where the warp-per-block regime
    stops paying, which ``quantize_plan`` uses to pick one."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import build
    from repro_torch.kernels import nxfp_quantize as nq

    fmt = get_format("nxfp4")
    n_sm = build.sm_count(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {}
    for n in REGIME_BLOCKS:
        xb = torch.randn((n, 32), generator=gen, device="cuda").to(
            torch.bfloat16)
        row = {"planned": nq.quantize_plan(n, 32, n_sm).regime}
        for plan in (nq.warp_plan(n, 32, n_sm), nq.tile_plan(n, n_sm)):
            row[f"{plan.regime}_ms"] = timer(
                lambda: nq.nxfp_quantize_pack(xb, fmt, plan))
        cs.log(f"quantizer regimes, {n} nxfp4 bf16 blocks: {json.dumps(row)}")
        rows[f"nxfp_quantize regimes n={n}"] = row
    return rows


# the quantizer's main-path kernels: nxfp4 weights and K/V (tile and warp
# regime), amxfp4 activations; a 4-bit value-loop step covers 8 values
SASS_KERNELS = {
    "tile nxfp4": "_ZN5nxfpq20quantize_tile_kernelILi4ELi32ELi2ELi1EEEvNS_3JobENS_3FmtE",
    "tile amxfp4": "_ZN5nxfpq20quantize_tile_kernelILi4ELi32ELi2ELi2EEEvNS_3JobENS_3FmtE",
    "warp nxfp4": "_ZN5nxfpq20quantize_warp_kernelILi4ELi32ELi2ELi1EEEvNS_3JobENS_3FmtE",
}
VALUES_PER_STEP = 8


def quantizer_sass(cs, lib_path: str) -> dict:
    """SASS instructions (``cuobjdump -sass``) of the quantizer's
    main-path kernels and, for each innermost loop that clamps values to
    an element format's top value (``FMNMX |x|, max``: a candidate's value
    loop), its instructions per value and candidate."""
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(
        shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc")), "cuobjdump")
    rows = {}
    for name, fn in SASS_KERNELS.items():
        out = subprocess.run([cuobjdump, "-sass", "-fun", fn, lib_path],
                             capture_output=True, text=True, timeout=300,
                             check=True).stdout
        body = next(sec for sec in re.split(r"Function : ", out)
                    if sec.startswith(fn + "\n") or sec.startswith(fn + " "))
        ins = [(int(a, 16), t) for a, t in
               re.findall(r"/\*([0-9a-f]{4,5})\*/\s+([^;]*);", body)]
        index = {a: i for i, (a, _) in enumerate(ins)}
        loops = set()
        for i, (a, t) in enumerate(ins):
            m = re.search(r"BRA (?:\S+, )?0x([0-9a-f]+)", t)
            if m and int(m.group(1), 16) < a and int(m.group(1), 16) in index:
                loops.add((index[int(m.group(1), 16)], i))
        per_value = {}
        for lo, hi in sorted(loops):
            if any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                   for l2, h2 in loops):
                continue                              # not innermost
            m = re.search(r"FMNMX \S+, \|R\d+\|, ([0-9.]+)",
                          " ".join(t for _, t in ins[lo:hi + 1]))
            if m:
                per_value[f"clamp {m.group(1)}"] = (hi - lo + 1) / VALUES_PER_STEP
        rows[name] = {"instructions": len(ins),
                      "per_value_and_candidate": per_value}
        cs.log(f"quantizer SASS, {name}: {json.dumps(rows[name])}")
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="root of the checkout whose kernels to time")
    ap.add_argument("--only", choices=("matmul", "quantize", "attention"),
                    help="time the dequant GEMM's, the quantizer's or "
                         "decode attention's rows alone")
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
    one = torch.zeros(1, device="cuda")
    floor_ms = timer(lambda: one.add_(1.0))
    cs.log(f"timer floor (a one-element add): {floor_ms:.4f} ms")
    rows = time_matmul(cs, timer) if args.only in (None, "matmul") else {}
    rows["timer floor"] = {"ms": floor_ms}
    if args.only in (None, "quantize"):
        cs.check_quantizer(timer, rows)
        cs.check_act_quantizer(timer, rows)
        from repro_torch.kernels import nxfp_quantize
        if hasattr(nxfp_quantize, "nxfp_quantize_kv_rows"):
            cs.check_kv_write(timer, rows)
            rows.update(time_quantize_regimes(cs, timer))
            rows["quantizer sass"] = quantizer_sass(cs, info["path"])
    if args.only in (None, "attention"):
        cs.check_attention(timer, rows)
    if not args.only:
        cs.check_qq_matmul(timer, rows)
    print(json.dumps({"tree": tree, "build_seconds": info["seconds"],
                      "cached": info["cached"], "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
