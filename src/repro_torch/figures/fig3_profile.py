"""Paper Fig. 3: profile of weights scaled by the per-block shared exponent
(the twin of the reference's ``benchmarks/fig3_profile.py``).

Validates the three observations motivating NxFP:
  (a) scaled weights span roughly (-8, 8), beyond FP4's top level 6,
  (b) a measurable mass of values falls in FP4's vacant region (4, 6),
  (c) a measurable mass clamps above 6 (inaccurate outlier tracking).

    PYTHONPATH=src python -m repro_torch.figures.fig3_profile [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import level_table, to_blocks
from .common import Csv, _MODEL_STATS, check, main_for, timed, \
    weight_ensemble


def scaled_blocks(w: np.ndarray, block: int = 32, device=None) -> np.ndarray:
    """v / 2**E_shared per MX convention (FP4: block max lands in [4, 8)):
    the blocks and their maxima on ``device``, the exponent arithmetic in
    numpy as the reference's."""
    xb, _ = to_blocks(torch.from_numpy(w).to(resolve_device(device)), block)
    vmax = xb.abs().amax(-1, keepdim=True).cpu().numpy()
    xb = xb.cpu().numpy()
    emax = level_table("e2m1", cr=False).emax
    e = np.floor(np.log2(np.maximum(vmax, 1e-30))).astype(np.int32) - emax
    return xb / np.exp2(e)


def profile(s: np.ndarray) -> dict:
    """The figure's numbers for scaled blocks ``s``: the 0.01% / 99.99%
    range of the non-zero values, their mass in (4, 6) and above 6."""
    nz = s[np.abs(s) > 0]
    return dict(lo=np.percentile(nz, 0.01), hi=np.percentile(nz, 99.99),
                vac=float(np.mean((np.abs(nz) > 4.0) & (np.abs(nz) < 6.0))),
                clamp=float(np.mean(np.abs(nz) > 6.0)))


def compute(csv: Csv, model=None, device=None) -> dict:
    """Each ensemble's profile and CSV row (``model`` is unused: the
    figure reads no trained model)."""
    out = {}
    for name in _MODEL_STATS:
        w = weight_ensemble(name)
        us, s = timed(lambda: scaled_blocks(w, device=device))
        p = out[name] = profile(s)
        csv.add(f"fig3/{name}", us,
                f"range=[{p['lo']:.2f};{p['hi']:.2f}] "
                f"vacant_(4;6)_frac={p['vac']:.4f} "
                f"clamp_gt6_frac={p['clamp']:.5f}")
    return out


def orderings(results: dict):
    """(ordering, verdict) for every assert of the reference's script."""
    out = []
    for name, p in results.items():
        out.append((f"{name}: range within [-8.01, 8.01]",
                    bool(p["hi"] <= 8.01 and p["lo"] >= -8.01)))
        out.append((f"{name}: vacant (4, 6) and clamp > 6 masses > 0",
                    bool(p["vac"] > 0 and p["clamp"] > 0)))
    return out


def run(csv: Csv, device=None, model=None) -> dict:
    results = compute(csv, model, device)
    check(orderings(results), results)
    return results


def main():
    return main_for(run, __doc__)


if __name__ == "__main__":
    main()
