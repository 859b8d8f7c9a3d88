"""Paper Fig. 12: perplexity-to-footprint across block sizes, 4-bit (the
twin of the reference's ``benchmarks/fig12_blocksize.py``).

Claims, asserted on the weight MSE (deterministic; the ppl deltas at this
model's scale sit inside the eval's noise and are reported):
  - NxFP4 beats MxFP4 and BFP4 at every block size in {8,16,32,64,128},
  - MxFP4 overtakes BFP4 at large block sizes (microexponents keep the
    element-wise dynamic range once blocks get wide).

    PYTHONPATH=src python -m repro_torch.figures.fig12_blocksize [--device cpu]
"""
from __future__ import annotations

from ..core import get_format
from ..core.qtensor import dense_like
from .common import Csv, cast_tree, check, eval_ppl, main_for, trained_model
from .fig11_remap_sweep import _weight_mse

BS = [8, 16, 32, 64, 128]
FAMILIES = ["bfp4", "mxfp4", "nxfp4"]


def fmt_name(fam: str, bs: int) -> str:
    return f"{fam}_bs{bs}" if bs != 32 else fam


def compute(csv: Csv, model=None, device=None) -> dict:
    """Every (family, block size)'s ppl and weight MSE. ``model`` (cfg,
    params): the trained model (default ``trained_model(device=
    device)``)."""
    cfg, params = model or trained_model(device=device)
    ppl, mse = {}, {}
    for bs in BS:
        for fam in FAMILIES:
            name = fmt_name(fam, bs)
            fmt = get_format(name)
            ppl[(fam, bs)] = eval_ppl(cfg, dense_like(cast_tree(params,
                                                                name)))
            mse[(fam, bs)] = _weight_mse(params, name)
            csv.add(f"fig12/bs{bs}/{fam}", 0.0,
                    f"ppl={ppl[(fam, bs)]:.4f} mse={mse[(fam, bs)]:.3e} "
                    f"bits_per_value={fmt.bits_per_value:.3f}")
    return dict(ppl=ppl, mse=mse)


def orderings(results: dict):
    """(ordering, verdict) for every assert of the reference's script."""
    mse = results["mse"]
    out = []
    for bs in BS:
        out.append((f"bs{bs}: nxfp4 <= mxfp4 * 1.001",
                    mse[("nxfp4", bs)] <= mse[("mxfp4", bs)] * 1.001))
        out.append((f"bs{bs}: nxfp4 <= bfp4 * 1.001",
                    mse[("nxfp4", bs)] <= mse[("bfp4", bs)] * 1.001))
    # the MxFP4 vs BFP4 crossover at large blocks
    out.append(("bs128: mxfp4 <= bfp4", mse[("mxfp4", 128)]
                <= mse[("bfp4", 128)]))
    out.append(("bs8: bfp4 <= mxfp4", mse[("bfp4", 8)] <= mse[("mxfp4", 8)]))
    return out


def run(csv: Csv, device=None, model=None) -> dict:
    results = compute(csv, model, device)
    check(orderings(results), results)
    csv.add("fig12/orderings", 0.0,
            "by MSE: NxFP4 best at all block sizes; BFP4<MxFP4 at bs8, "
            "MxFP4<BFP4 at bs128 (the paper's crossover)")
    return results


def main():
    return main_for(run, __doc__)


if __name__ == "__main__":
    main()
