"""Shared harness of the figures (the twin of the reference's
``benchmarks/common.py``): a cached trained model, weight corpora, the
cast and the evaluation, CSV rows.

The perplexity figures (Table 1, Figs. 9-12) evaluate a 2-layer LM
trained here on the in-repo synthetic corpus (nothing is downloaded);
the quantization-error figures (Figs. 3, 8) also use weight ensembles
matched to LLM statistics and named after the paper's models. Each
figure splits into ``compute`` (its numbers and CSV rows) and
``orderings`` (every ordering the reference asserts, with its verdict);
``run`` asserts them as the reference does.

The casts are the reference's default, ``QTensor.quantize`` (its
``direct_cast_tree`` given no ``quantize_fn``): the table-driven encoder,
where a scaled value on a midpoint takes the lower level. On CUDA it is
the quantizer kernel's table instances (``ops.quantize_qtensor(table=
True)``), on the CPU the plain ``quantize_blocks``; the serving engines
cast with the arithmetic encoder instead (``serving.engine.load_params``),
which rounds such a value half to even.
"""
from __future__ import annotations

import argparse
import functools
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..core.qtensor import QuantPolicy, direct_cast_tree
from ..data import SyntheticLM, make_data_iter
from ..kernels.ops import quantize_qtensor
from ..launch.train import train_loop
from ..models import init_params, loss_fn
from ..models.common import ModelConfig
from ..optim.adamw import AdamW, cosine_schedule
from ..train.state import init_state
from ..tree import tree_leaves

ROOT = Path(__file__).resolve().parents[3]
# the reference caches its model in results/bench_model; this one in its own
CACHE = ROOT / "results" / "bench_model_torch"

BENCH_CFG = ModelConfig(
    name="bench-lm", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab=256, remat=False,
)

# corpus tuned to be learnable in a few hundred steps (sharp HMM + heavy
# copy structure): small models are also more quantization-sensitive
# (paper Fig. 10), which makes format orderings measurable
BENCH_CORPUS = dict(n_states=8, zipf_a=1.6, copy_prob=0.5, copy_back=8)

TRAIN_STEPS = 600
# the loop's settings besides its steps (the reference's ``trained_model``)
TRAIN_KW = dict(batch=24, seq=128, lr=3e-3, log_every=200)


def bench_source(vocab: int, seed: int = 0) -> SyntheticLM:
    return SyntheticLM(vocab=vocab, seed=seed, **BENCH_CORPUS)


def params_device(params) -> torch.device:
    """The device a tree's tensors (or QTensors) lie on."""
    return next(leaf.device for leaf in tree_leaves(params)
                if hasattr(leaf, "device"))


def cast_tree(params, fmt, device=None):
    """``params`` direct-cast to ``fmt`` (a format name or a BlockFormat)
    by the reference's default cast, the table-driven encoder, on
    ``device`` (the params' own by default)."""
    dev = params_device(params) if device is None else device
    cast = functools.partial(quantize_qtensor, device=dev, table=True)
    return direct_cast_tree(params, QuantPolicy(weight_fmt=fmt), cast)


def trained_model(steps: int = TRAIN_STEPS, device=None, cache=CACHE):
    """Train (or load the cached) benchmark LM on ``device`` (CUDA by
    default): 600 steps of 24 x 128 tokens, as the reference's. Returns
    (cfg, params), f32 leaves."""
    dev = resolve_device(device)
    cfg = BENCH_CFG
    mgr = CheckpointManager(cache, keep=1, async_save=False)
    if mgr.latest_step() == steps:
        optimizer = AdamW(lr=cosine_schedule(1e-3, steps // 20, steps))
        template = init_state(init_params(cfg, 0, device=dev, train=True),
                              optimizer)
        state, _ = mgr.restore(template)
        return cfg, state.params
    state, losses = train_loop(cfg, steps=steps,
                               source=bench_source(cfg.vocab), device=dev,
                               **TRAIN_KW)
    mgr.save(state, steps, block=True)
    print(f"[bench] trained {cfg.name}: loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}")
    return cfg, state.params


def held_out(cfg, seed: int, batches: int, device):
    """``batches`` held-out batches of 16 x 128 tokens (the same
    distribution), as tensors on ``device``."""
    it = make_data_iter(bench_source(cfg.vocab), 16, 128, seed=seed)
    return [{"tokens": torch.as_tensor(next(it)["tokens"]).to(device)}
            for _ in range(batches)]


def eval_ppl(cfg, params, batches: int = 4, seed: int = 999):
    """Held-out perplexity on the (same-distribution) synthetic corpus."""
    tot = 0.0
    with torch.no_grad():
        for b in held_out(cfg, seed, batches, params_device(params)):
            tot += float(loss_fn(cfg, params, b)[0])
    return float(np.exp(tot / batches))


# --- LLM-statistics-matched weight ensembles (paper Fig. 3 profile) -------

_MODEL_STATS = {
    # name: (per-channel scale lognormal sigma, outlier df, outlier frac)
    "llama3-like": (0.5, 4.0, 0.003),
    "llama3.1-like": (0.5, 4.0, 0.004),
    "phi3-like": (0.4, 3.0, 0.002),
    "llama2-like": (0.6, 5.0, 0.003),
    "mistral-like": (0.45, 4.0, 0.0025),
}


def weight_ensemble(name: str, rows: int = 2048, cols: int = 512,
                    seed: int = 0) -> np.ndarray:
    """The reference's ensemble. Its generator is seeded with
    ``hash(name)``, which Python salts per process (``PYTHONHASHSEED``),
    so the draws differ from run to run, as the reference's do."""
    sigma, df, frac = _MODEL_STATS[name]
    rng = np.random.default_rng((hash(name) & 0xFFFF, seed))
    scale = np.exp(rng.normal(0, sigma, size=(rows, 1))) * 0.02
    w = rng.standard_normal((rows, cols)) * scale
    mask = rng.random((rows, cols)) < frac
    w = np.where(mask, rng.standard_t(df, size=(rows, cols)) * scale * 8, w)
    return w.astype(np.float32)


def stacked_leaves(tree, path: str = ""):
    """(name, leaf) in the reference's flattening order and naming: dict
    keys sorted, joined by "/"; the list of layers stacked leaf by leaf
    on a leading axis, as the reference stores its layers."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from stacked_leaves(tree[k], f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for k in sorted(tree[0]):
            yield f"{path}/{k}", torch.stack([layer[k] for layer in tree])
    else:
        yield path, tree


def model_weight_matrices(params, min_size: int = 4096):
    """The trained model's 2-D weights (real trained distributions): the
    reference's (L * rows, cols) matrix for each stacked leaf name."""
    out = {}
    for name, leaf in stacked_leaves(params):
        if getattr(leaf, "ndim", 0) >= 2 and leaf.numel() >= min_size \
                and "embed" not in name:
            out[name] = leaf.detach().float().cpu().numpy().reshape(
                -1, leaf.shape[-1])
    return out


class Csv:
    """Collects ``name,us_per_call,derived`` rows, printing each (the
    reference's rows, under the same names)."""

    def __init__(self):
        self.rows = []

    def add(self, name: str, us_per_call: float, derived: str,
            unit: str = "us_per_call"):
        self.rows.append((name, us_per_call, derived, unit))
        print(f"{name},{us_per_call:.2f},{derived}", flush=True)

    def extend(self, other: "Csv"):
        self.rows.extend(other.rows)


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, warmup: int = 1, iters: int = 3):
    """(us a call, the last output) on the host clock, the device
    synchronised after the warm-up and after the timed calls."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    _sync()
    return (time.time() - t0) / iters * 1e6, out


def check(verdicts, results) -> None:
    """Assert every ordering, as the reference's script does."""
    for name, ok in verdicts:
        assert ok, (name, results)


def main_for(run, doc: str):
    """A figure's command line: ``--device`` (cuda by default, or cpu for
    the plain versions), then ``run(csv, device=)``."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain versions")
    dev = resolve_device(ap.parse_args().device)   # raises without a card
    csv = Csv()
    run(csv, device=dev)
    return csv
