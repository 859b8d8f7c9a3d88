"""Paper Fig. 9: perplexity-to-footprint Pareto, weight-only and
weights+KV-cache quantization (the twin of the reference's
``benchmarks/fig9_tradeoff.py``).

Footprint is measured from the packed buffers (QTensor bytes for the
weights; packed-cache bytes for the KV cache at the paper's 2k sequence),
not computed from nominal bit counts. The KV share of the perplexity runs
through ``kv_sim_fmt`` (every prefill K/V fake-quantized: on CUDA the
quantizer kernel's table instances, then the decode). Claims:
  - NxFP consistently sits on the Pareto frontier,
  - NxFP5 reaches MxFP6-level perplexity at a measurably smaller
    footprint (paper: 13-16% smaller).

    PYTHONPATH=src python -m repro_torch.figures.fig9_tradeoff [--device cpu]
"""
from __future__ import annotations

import dataclasses

from ..core import get_format
from ..core.qtensor import QTensor, dense_like, tree_footprint_bytes
from ..tree import tree_leaves
from .common import Csv, cast_tree, check, eval_ppl, main_for, trained_model

SEQ = 2048  # the paper's Fig. 9 sequence length for the KV share
FMTS = ["bfp4", "mxfp4", "nxfp4", "bfp5", "mxfp5", "nxfp5",
        "bfp6", "mxfp6", "nxfp6"]


def kv_bytes(cfg, fmt_name, batch: int = 1) -> int:
    """Packed KV-cache footprint at SEQ tokens (the paper's Fig. 9 setup)."""
    hd, kvh, L = cfg.hd, cfg.n_kv_heads, cfg.n_layers
    n = batch * SEQ * kvh * hd * L * 2      # K and V values
    if fmt_name is None:
        return n * 2                         # bf16
    f = get_format(fmt_name)
    nb = -(-hd // f.block_size)
    per_row = nb * f.bytes_per_block + nb * 2
    return batch * SEQ * kvh * L * 2 * per_row


def quantized_bytes(qparams) -> int:
    """The bytes of a cast tree's QTensor leaves alone."""
    return sum(leaf.nbytes() for leaf in tree_leaves(qparams)
               if isinstance(leaf, QTensor))


def compute(csv: Csv, model=None, device=None) -> dict:
    """Each format's weight bytes and ppl, weights+KV bytes and ppl.
    ``model`` (cfg, params): the trained model (default
    ``trained_model(device=device)``)."""
    cfg, params = model or trained_model(device=device)
    base_ppl = eval_ppl(cfg, params)
    dense_w = tree_footprint_bytes(params)
    csv.add("fig9/fp-baseline", 0.0,
            f"ppl={base_ppl:.4f} weights_bytes={dense_w}")
    pts_w, pts_wkv, qbytes = {}, {}, {}
    for f in FMTS:
        qp = cast_tree(params, f)
        wb = tree_footprint_bytes(qp)
        qbytes[f] = quantized_bytes(qp)
        ppl_w = eval_ppl(cfg, dense_like(qp))
        pts_w[f] = (wb, ppl_w)
        # weights + KV: fake-quant the KV path in the forward
        ppl_wkv = eval_ppl(dataclasses.replace(cfg, kv_sim_fmt=f),
                           dense_like(qp))
        tot = wb + kv_bytes(cfg, f)
        pts_wkv[f] = (tot, ppl_wkv)
        csv.add(f"fig9/weights/{f}", 0.0, f"bytes={wb} ppl={ppl_w:.4f}")
        csv.add(f"fig9/weights+kv/{f}", 0.0,
                f"bytes={tot} ppl={ppl_wkv:.4f}")
    # headline: NxFP5 vs MxFP6 footprint at comparable ppl. The whole-model
    # saving is diluted by never-quantized leaves (embeddings and norms
    # are a large share of a small model), so the claim is on the
    # quantized-tensor bytes; both are reported
    nx5_b, nx5_p = pts_w["nxfp5"]
    mx6_b, mx6_p = pts_w["mxfp6"]
    saving_all = 1 - nx5_b / mx6_b
    saving_q = 1 - qbytes["nxfp5"] / qbytes["mxfp6"]
    csv.add("fig9/nxfp5-vs-mxfp6", 0.0,
            f"quantized_tensor_saving={saving_q:.1%} "
            f"whole_model_saving={saving_all:.1%} "
            f"ppl_delta={nx5_p - mx6_p:+.4f} (paper: 13-16% at <=0.1 ppl)")
    return dict(base=base_ppl, dense_bytes=dense_w, weights=pts_w,
                weights_kv=pts_wkv, quantized_bytes=qbytes,
                saving_q=saving_q, saving_all=saving_all)


def orderings(results: dict):
    """(ordering, verdict) for every assert of the reference's script."""
    w, wkv = results["weights"], results["weights_kv"]
    nx5_p, mx6_p = w["nxfp5"][1], w["mxfp6"][1]
    return [
        ("nxfp5 saves > 12% of mxfp6's quantized bytes",
         results["saving_q"] > 0.12),
        ("nxfp5 ppl - mxfp6 ppl < 15% of mxfp6's", nx5_p - mx6_p
         < 0.15 * mx6_p),
        # NxFP on the frontier at 4 bits (a small tolerance for the noise)
        ("weights: nxfp4 ppl <= mxfp4 + 0.02", w["nxfp4"][1]
         <= w["mxfp4"][1] + 0.02),
        ("weights+KV: nxfp4 ppl <= mxfp4 + 0.02", wkv["nxfp4"][1]
         <= wkv["mxfp4"][1] + 0.02),
    ]


def run(csv: Csv, device=None, model=None) -> dict:
    results = compute(csv, model, device)
    check(orderings(results), results)
    return results


def main():
    return main_for(run, __doc__)


if __name__ == "__main__":
    main()
