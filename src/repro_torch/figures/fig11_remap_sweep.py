"""Paper Fig. 11: sweeping the recycled value of the wasted -0 code on
(a) MxFP4 and (b) BFP4 (the twin of the reference's
``benchmarks/fig11_remap_sweep.py``).

Candidate remap targets are the midpoints between adjacent positive levels
(the paper's low-implementation-overhead set) plus -half-smallest; each is
a custom recycle value, cast by the quantizer kernel's ``KIND_CRT``
instances on the card. Claim: half of the smallest level is among the
best remaps on both element formats (the best on BFP4).

    PYTHONPATH=src python -m repro_torch.figures.fig11_remap_sweep [--device cpu]
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import get_format, level_table
from ..core.formats import BlockFormat
from ..core.qtensor import dense_like
from .common import (Csv, cast_tree, check, eval_ppl, main_for,
                     stacked_leaves, trained_model)

BASES = [("mxfp4", "e2m1"), ("bfp4", "int4")]


def _fmt_with_recycle(base: str, value) -> BlockFormat:
    f = get_format(base + "_cr")
    return dataclasses.replace(f, recycle=value,
                               name=f"{base}_cr@{value:.3f}")


def sweep_points(elem: str):
    t = level_table(elem, cr=False)
    pos = t.values_sorted[t.values_sorted > 0]
    mids = ((pos[1:] + pos[:-1]) / 2).tolist()
    return [-0.5 * t.smallest_pos] + mids


def _weight_mse(params, fmt):
    """The cast's mean squared error over every 2-D leaf as the reference
    stacks its layers (a stacked norm scale (L, D) is one, with no error)
    (a deterministic selection metric: ppl deltas at this model's scale
    are within the eval's noise; the paper's own Fig. 11 spreads are
    ~0.01 ppl)."""
    dq = dense_like(cast_tree(params, fmt))
    num = den = 0.0
    for (_, a), (_, b) in zip(stacked_leaves(params), stacked_leaves(dq)):
        if a.ndim >= 2:
            num += float(torch.sum(torch.square(a.to(torch.float32)
                                                - b.to(torch.float32))))
            den += a.numel()
    return num / den


def compute(csv: Csv, model=None, device=None) -> dict:
    """For each base format its no-recycle ppl and MSE, then every sweep
    point's. ``model`` (cfg, params): the trained model (default
    ``trained_model(device=device)``)."""
    cfg, params = model or trained_model(device=device)
    out = {}
    for base, elem in BASES:
        baseline = eval_ppl(cfg, dense_like(cast_tree(params, base)))
        base_mse = _weight_mse(params, base)
        csv.add(f"fig11/{base}/no-recycle", 0.0,
                f"ppl={baseline:.4f} mse={base_mse:.3e}")
        ppls, mses = {}, {}
        for val in sweep_points(elem):
            fmt = _fmt_with_recycle(base, float(val))
            v = float(val)
            ppls[v] = eval_ppl(cfg, dense_like(cast_tree(params, fmt)))
            mses[v] = _weight_mse(params, fmt)
            csv.add(f"fig11/{base}/remap={val:+.3f}", 0.0,
                    f"ppl={ppls[v]:.4f} mse={mses[v]:.3e} "
                    f"ppl_delta_vs_nocr={ppls[v] - baseline:+.4f}")
        half = min(v for v in mses if v < 0)      # the -half_smallest point
        rank = sorted(mses.values()).index(mses[half]) + 1
        best = min(mses, key=mses.get)
        csv.add(f"fig11/{base}/best", 0.0,
                f"best_by_mse={best:+.3f} "
                f"best_by_ppl={min(ppls, key=ppls.get):+.3f} "
                f"half_smallest_mse_rank={rank}/{len(mses)}")
        out[base] = dict(baseline=baseline, base_mse=base_mse, ppl=ppls,
                         mse=mses, half=half, mid_top=max(mses), rank=rank,
                         best=best)
    return out


def orderings(results: dict):
    """(ordering, verdict) for every assert of the reference's script:
    on MxFP4 both half-smallest and the midpoint of the two largest
    levels improve the most (the paper picks half-smallest for its cheap
    right-shift decode); on BFP4 half-smallest wins."""
    out = []
    for base, r in results.items():
        if base == "mxfp4":
            out.append((f"{base}: the best remap is -half-smallest or the "
                        "top midpoint", r["best"] in (r["half"], r["mid_top"])))
        else:
            out.append((f"{base}: -half-smallest ranks <= 2 by MSE",
                        r["rank"] <= 2))
        out.append((f"{base}: -half-smallest's MSE < no recycle's",
                    r["mse"][r["half"]] < r["base_mse"]))
    return out


def run(csv: Csv, device=None, model=None) -> dict:
    results = compute(csv, model, device)
    check(orderings(results), results)
    return results


def main():
    return main_for(run, __doc__)


if __name__ == "__main__":
    main()
