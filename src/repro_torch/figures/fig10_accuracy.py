"""Paper Fig. 10: task-accuracy degradation at low bitwidths (3/4-bit)
(the twin of the reference's ``benchmarks/fig10_accuracy.py``).

Offline proxy for MMLU: top-1 next-token accuracy on the held-out
synthetic corpus, whose copy structure makes accuracy a retrieval-flavoured
metric rather than pure calibration. Claim: at 3-4 bits NxFP keeps
materially more accuracy than MxFP/BFP; at higher bits everything
converges.

    PYTHONPATH=src python -m repro_torch.figures.fig10_accuracy [--device cpu]
"""
from __future__ import annotations

import torch

from ..core.qtensor import dense_like
from ..models import forward_train
from .common import (Csv, cast_tree, check, held_out, main_for,
                     params_device, trained_model)

FMTS = ["bfp3", "mxfp3", "nxfp3", "bfp4", "mxfp4", "nxfp4", "nxfp6"]


def top1_acc(cfg, params, batches: int = 4, seed: int = 777) -> float:
    correct = total = 0
    with torch.no_grad():
        for b in held_out(cfg, seed, batches, params_device(params)):
            pred = forward_train(cfg, params, b)[0][:, :-1].argmax(-1)
            correct += int((pred == b["tokens"][:, 1:]).sum())
            total += pred.numel()
    return correct / total


def compute(csv: Csv, model=None, device=None) -> dict:
    """The fp32 baseline's and every format's accuracy. ``model`` (cfg,
    params): the trained model (default ``trained_model(device=
    device)``)."""
    cfg, params = model or trained_model(device=device)
    base = top1_acc(cfg, params)
    csv.add("fig10/fp-baseline", 0.0, f"acc={base:.4f}")
    accs = {}
    for f in FMTS:
        accs[f] = top1_acc(cfg, dense_like(cast_tree(params, f)))
        csv.add(f"fig10/{f}", 0.0,
                f"acc={accs[f]:.4f} delta={accs[f] - base:+.4f}")
    return dict(base=base, acc=accs)


def orderings(results: dict):
    """(ordering, verdict) for every assert of the reference's script."""
    a, base = results["acc"], results["base"]
    return [("nxfp4 >= mxfp4 - 0.005", a["nxfp4"] >= a["mxfp4"] - 0.005),
            ("nxfp3 >= mxfp3 - 0.005", a["nxfp3"] >= a["mxfp3"] - 0.005),
            ("nxfp6 >= fp32 - 0.01", a["nxfp6"] >= base - 0.01)]


def run(csv: Csv, device=None, model=None) -> dict:
    results = compute(csv, model, device)
    check(orderings(results), results)
    csv.add("fig10/orderings", 0.0, "NxFP >= MxFP at 3 and 4 bits")
    return results


def main():
    return main_for(run, __doc__)


if __name__ == "__main__":
    main()
