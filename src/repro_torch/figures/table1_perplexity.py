"""Paper Table 1: weight-only direct-cast perplexity at W4/W5/W6 for
BFP / MxFP / NxFP(NM) / NxFP(NM+AM) / NxFP(NM+AM+CR) (the twin of the
reference's ``benchmarks/table1_perplexity.py``).

The reference's claims, asserted with its tolerances:
  - degradation grows as bits shrink (6 -> 5 -> 4),
  - at every bitwidth NxFP(full) <= MxFP and the NM/AM/CR ablation is
    monotone non-increasing (the paper's Table 1 ordering),
  - MxFP6 uses the best element variant (e2m3 vs e3m2).
On the 2-layer benchmark LM the ppl deltas sit inside the eval's noise,
so these orderings are a finding about the trained model: the
reference's own script fails two of them on its model.

    PYTHONPATH=src python -m repro_torch.figures.table1_perplexity [--device cpu]
"""
from __future__ import annotations

import time

from ..core.qtensor import dense_like
from .common import Csv, cast_tree, check, eval_ppl, main_for, trained_model

ROWS = {
    4: ["bfp4", "mxfp4", "nxfp4_nm", "nxfp4_nm_am", "nxfp4"],
    5: ["bfp5", "mxfp5", "nxfp5_nm", "nxfp5_nm_am", "nxfp5"],
    6: ["bfp6", "mxfp6", "mxfp6_e3m2", "nxfp6_nm", "nxfp6_nm_am", "nxfp6"],
}


def quantized_ppl(cfg, params, fmt: str) -> float:
    return eval_ppl(cfg, dense_like(cast_tree(params, fmt)))


def compute(csv: Csv, model=None, device=None) -> dict:
    """The fp32 baseline and every format's ppl. ``model`` (cfg, params):
    the trained model (default ``trained_model(device=device)``)."""
    cfg, params = model or trained_model(device=device)
    base = eval_ppl(cfg, params)
    csv.add("table1/fp32-baseline", 0.0, f"ppl={base:.4f}")
    results = {}
    for bits, fmts in ROWS.items():
        for f in fmts:
            t0 = time.time()
            ppl = quantized_ppl(cfg, params, f)
            us = (time.time() - t0) * 1e6
            results[f] = ppl
            csv.add(f"table1/W{bits}/{f}", us,
                    f"ppl={ppl:.4f} delta={ppl - base:+.4f}")
    return dict(base=base, ppl=results)


def orderings(results: dict):
    """(ordering, verdict) for every assert of the reference's script."""
    r = results["ppl"]
    mx6 = min(r["mxfp6"], r["mxfp6_e3m2"])
    return [
        ("nxfp4 <= mxfp4 + 1e-3", r["nxfp4"] <= r["mxfp4"] + 1e-3),
        ("nxfp5 <= mxfp5 + 1e-3", r["nxfp5"] <= r["mxfp5"] + 1e-3),
        ("nxfp4 <= nxfp4_nm + 5e-3", r["nxfp4"] <= r["nxfp4_nm"] + 5e-3),
        ("nxfp6 <= min(mxfp6, mxfp6_e3m2) + 2e-2", r["nxfp6"] <= mx6 + 2e-2),
        # degradation monotone in bits for the full NxFP column
        ("nxfp6 <= nxfp5 + 1e-2 and nxfp5 <= nxfp4 + 1e-2",
         r["nxfp6"] <= r["nxfp5"] + 1e-2 and r["nxfp5"] <= r["nxfp4"] + 1e-2),
    ]


def run(csv: Csv, device=None, model=None) -> dict:
    results = compute(csv, model, device)
    check(orderings(results), results)
    csv.add("table1/orderings", 0.0, "all paper orderings hold")
    return results


def main():
    return main_for(run, __doc__)


if __name__ == "__main__":
    main()
