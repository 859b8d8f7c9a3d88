"""End-to-end driver on the PyTorch/CUDA port (the twin of
``examples/train_then_serve_quantized.py``, the paper's deployment story):

  1. train a small LM for a few hundred steps (checkpointing, NaN-guarded),
  2. direct-cast the weights to NxFP4 (Algorithm 1), no calibration,
  3. compare perplexity and footprint against the FP baseline and MxFP4,
  4. serve batched requests with NxFP4 weights and an NxFP4 KV cache.

    PYTHONPATH=src python examples/train_then_serve_quantized_torch.py               # card
    PYTHONPATH=src python examples/train_then_serve_quantized_torch.py --device cpu  # CPU

Checkpoints go to ``results/e2e_ckpt_torch`` (a rerun resumes from them).
On the card training, the casts (the quantizer kernel under the reference's
table-driven rules, as its ``direct_cast_tree`` casts) and the serve (the
dequant GEMM, decode attention and the K/V writes, in CUDA graphs) run the
port's kernels; ``--device cpu`` runs their plain versions.
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.qtensor import (QuantPolicy, dense_like,
                                      tree_footprint_bytes)
from repro_torch.data import SyntheticLM, make_data_iter
from repro_torch.figures.common import cast_tree
from repro_torch.launch.train import train_loop
from repro_torch.models import loss_fn
from repro_torch.models.common import ModelConfig
from repro_torch.serving import ServeEngine

# ~2M-param llama-family model (trainable on a CPU in a few minutes)
CFG = ModelConfig(name="e2e-lm", family="dense", n_layers=2, d_model=128,
                  n_heads=4, n_kv_heads=2, d_ff=512, vocab=256, remat=False)
STEPS = 200
_CORPUS = dict(n_states=8, zipf_a=1.6, copy_prob=0.5, copy_back=8)
CKPT_DIR = Path(__file__).resolve().parents[1] / "results" / "e2e_ckpt_torch"


def _source(vocab):
    return SyntheticLM(vocab=vocab, seed=0, **_CORPUS)


def eval_ppl(cfg, params, device):
    it = make_data_iter(_source(cfg.vocab), 16, 128, seed=4242)
    with torch.no_grad():
        losses = [float(loss_fn(cfg, params, {"tokens": torch.as_tensor(
            next(it)["tokens"]).to(device)})[0]) for _ in range(3)]
    return float(np.exp(np.mean(losses)))


def serve(params, device, batch: int = 8, prompt: int = 32,
          max_new: int = 32, temperature: float = 0.8):
    """``batch`` random prompts served with NxFP4 weights (the engine's
    load-time cast) and an NxFP4 KV cache. Returns (engine, result)."""
    eng = ServeEngine(CFG, params,
                      QuantPolicy(weight_fmt="nxfp4", kv_fmt="nxfp4"),
                      max_len=192, device=device)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, CFG.vocab, (batch, prompt)).astype(np.int32)
    return eng, eng.generate({"tokens": toks}, max_new=max_new,
                             temperature=temperature)


def main(device=None, ckpt_dir=CKPT_DIR):
    dev = resolve_device(device)                   # raises without a card
    print(f"== 1. train {CFG.name} (~{CFG.param_count()/1e6:.1f}M params) ==")
    state, losses = train_loop(CFG, steps=STEPS, batch=16, seq=128, lr=3e-3,
                               ckpt_dir=ckpt_dir, ckpt_every=100,
                               log_every=50, source=_source(CFG.vocab),
                               device=dev)
    params = state.params

    print("== 2. direct-cast (no calibration set, Algorithm 1) ==")
    base_ppl = eval_ppl(CFG, params, dev)
    print(f"fp32 ppl {base_ppl:.3f}, "
          f"{tree_footprint_bytes(params)/1e6:.2f} MB")
    for fmt in ["mxfp4", "nxfp4"]:
        qp = cast_tree(params, fmt)
        ppl = eval_ppl(CFG, dense_like(qp), dev)
        print(f"{fmt}: ppl {ppl:.3f} (delta {ppl-base_ppl:+.3f}), "
              f"{tree_footprint_bytes(qp)/1e6:.2f} MB packed")

    print("== 3. serve batched requests (NxFP4 weights + NxFP4 KV) ==")
    eng, res = serve(params, dev)
    toks = res.n_generated.sum()
    print(f"generated {toks} tokens: prefill {res.prefill_seconds:.2f}s, "
          f"decode {res.decode_seconds:.2f}s "
          f"({toks/max(res.decode_seconds,1e-9):.1f} tok/s)")
    print(f"served weight footprint: "
          f"{eng.weights_footprint_bytes()/1e6:.2f} MB "
          f"(vs {tree_footprint_bytes(params)/1e6:.2f} MB dense)")
    print("sample:", res.tokens[0, :16].tolist())
    return dict(base_ppl=base_ppl, tokens=res.tokens)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain versions")
    main(ap.parse_args().device)
