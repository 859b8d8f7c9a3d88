#!/usr/bin/env python3
"""Batch invariance of the port's decode step on one GPU: does a row's
result depend on how many rows share the step?

    python3 scripts/batch_invariance.py              # smoke + 2-layer Llama-3-8B
    python3 scripts/batch_invariance.py --layers 4
    python3 scripts/batch_invariance.py --device cpu # the plain path, smoke only

Row 0 of every input equals the B = 1 input and the other rows are
random. For B in ``BATCHES`` the script counts the elements of row 0 that
differ from the B = 1 result, with the largest difference: for each op of
the decode step whose work spans rows (the rmsnorm reduction in f32, and a
plain ``torch.mean`` of the same squares for comparison; the dequant
GEMM at the four Llama-3-8B (K, N) pairs, the ``lm_head`` product, decode
attention at S 512 with per-row lengths, the sampler's softmax) and for
``decode_step``'s logits end to end (nxfp4 weights and KV; the smoke
Llama and Llama-3-8B at full width, ``lm_head`` included). On the card
``lm_head`` and ``decode_step`` at B 4 and 8 also run as a replay of a
captured CUDA graph (as the engines' chunks do) against B 1 eager. The
continuous engine holds a request's stream bitwise to its solo stream,
which needs every count but the plain ``torch.mean``'s to be 0. The last
line is one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = "cuda"          # --device cpu runs the plain path (smoke only)
BATCHES = (4, 8)
MAX_LEN = 512
KN = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
# a row the port does not run: torch.mean over the batch's own rows, for
# comparison with the norm's row-grouped reduction
PLAIN_MEAN = "plain torch.mean of squares"


def _diff(ref, got) -> dict:
    d = (got.float() - ref.float()).abs()
    return {"differ": int((got != ref).sum()), "of": int(ref.numel()),
            "max_abs": float(d.max())}


def row0(fn, make, fn_b=None):
    """``fn(*make(1))[0]`` against ``(fn_b or fn)(*make(b))[0]`` at each
    of ``BATCHES``: row 0's differing elements and largest difference."""
    ref = fn(*make(1))[0]
    return {b: _diff(ref, (fn_b or fn)(*make(b))[0]) for b in BATCHES}


def graphed(fn):
    """``fn`` captured in a CUDA graph over its inputs and replayed once,
    as the engines' decode chunks run (``serving.engine.capture_graph``)."""
    from repro_torch.serving.engine import capture_graph

    def run(*args):
        graph, out = capture_graph(lambda: fn(*args), torch.device(DEV))
        graph.replay()
        return out
    return run


def _gen(seed):
    return torch.Generator(device=DEV).manual_seed(seed)


def _rows(shape, b, seed, dtype=torch.float32):
    """(b, *shape): row 0 from ``seed``, the rest from ``seed + 1``."""
    first = torch.randn((1,) + shape, generator=_gen(seed), device=DEV)
    rest = torch.randn((b - 1,) + shape, generator=_gen(seed + 1),
                       device=DEV)
    return torch.cat([first, rest]).to(dtype)


def ops(cfg) -> dict:
    """The decode step's row-spanning ops at ``cfg``'s widths."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.qtensor import QTensor, fmt_key
    from repro_torch.kernels.nxfp_quantize import nxfp_quantize_kv_rows
    from repro_torch.kernels.ops import decode_attention, qmatmul
    from repro_torch.kernels.ops import quantize_qtensor
    from repro_torch.models.common import dense, mean_square
    from repro_torch.models.kvcache import attn_cache_init

    out = {}
    d, v = cfg.d_model, cfg.vocab
    # the norm's f32 mean of squares (its bf16 output hides most last-bit
    # differences of the mean), one value a row: 32 inputs
    out[PLAIN_MEAN] = row0(
        lambda *xs: torch.cat([torch.mean(torch.square(x.float()), dim=-1)
                               for x in xs], dim=1),
        lambda b: tuple(_rows((1, d), b, 100 + 2 * i, torch.bfloat16)
                        for i in range(32)))
    out["rmsnorm mean_square"] = row0(
        lambda *xs: torch.cat([mean_square(x) for x in xs], dim=1),
        lambda b: tuple(_rows((1, d), b, 100 + 2 * i, torch.bfloat16)
                        for i in range(32)))
    head = (torch.randn((d, v), device=DEV, generator=_gen(2))
            * 0.02).to(torch.bfloat16)
    lm_head = lambda x: dense(x, head, out_dtype=torch.float32)  # noqa: E731
    lm_rows = lambda b: (_rows((1, d), b, 3, torch.bfloat16),)     # noqa: E731
    out["lm_head"] = row0(lm_head, lm_rows)
    if DEV == "cuda":
        out["lm_head graph"] = row0(lm_head, lm_rows, graphed(lm_head))
    del head
    gen = _gen(4)
    for k, n in KN if d == 4096 else ((d, d), (d, cfg.d_ff), (cfg.d_ff, d)):
        wq = quantize_qtensor(torch.randn((k, n), generator=gen,
                                          device=DEV) * 0.02,
                              "nxfp4", axis=-2, device=DEV)
        out[f"nxfp_matmul K={k} N={n}"] = row0(
            lambda x: qmatmul(x, wq), lambda b: (_rows((k,), b, 5,
                                                       torch.bfloat16),))
        del wq
    fmt = get_format("nxfp4")
    kvh, hd, h = cfg.n_kv_heads, cfg.hd, cfg.n_heads

    def attention(b):
        cache = attn_cache_init(cfg, b, MAX_LEN, "nxfp4", torch.device(DEV))
        k = _rows((MAX_LEN, kvh, hd), b, 6, torch.bfloat16)
        vv = _rows((MAX_LEN, kvh, hd), b, 8, torch.bfloat16)
        nxfp_quantize_kv_rows(k, vv, cache, None, fmt)
        lens = torch.tensor([300] + [17 + 97 * i for i in range(1, b)],
                            dtype=torch.int32, device=DEV)
        shape = (b, MAX_LEN, kvh, hd)
        kq = QTensor(cache["k_packed"], cache["k_meta"], fmt_key(fmt), shape,
                     -1, hd)
        vq = QTensor(cache["v_packed"], cache["v_meta"], fmt_key(fmt), shape,
                     -1, hd)
        return _rows((h, hd), b, 10), kq, vq, lens

    out[f"decode_attention S={MAX_LEN}"] = row0(
        lambda q, kq, vq, lens: decode_attention(q, kq, vq, lens, kvh),
        attention)
    out["softmax"] = row0(lambda x: torch.softmax(x, dim=-1),
                          lambda b: (_rows((v,), b, 12),))
    return out


def decode(cfg, params, kv) -> dict:
    """``decode_step`` logits: each row its own prompt (row 0's fixed,
    lengths ragged), prefilled alone; the batch caches are the rows'
    caches side by side."""
    from repro_torch.models import decode_step, prefill

    rng = np.random.default_rng(0)
    lens = [200] + [37 + 61 * i for i in range(1, max(BATCHES))]
    solo = []
    for t in lens:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, t))).to(DEV)
        logits, cache = prefill(cfg, params, {"tokens": toks},
                                max_len=MAX_LEN, kv_fmt=kv)
        solo.append((logits.argmax(-1).to(torch.int32), cache))

    def make(b):
        rows = solo[:b]
        cache = {"pos": torch.cat([c["pos"] for _, c in rows]),
                 "layers": [{k: torch.cat([c["layers"][i][k]
                                           for _, c in rows])
                             for k in rows[0][1]["layers"][i]}
                            for i in range(cfg.n_layers)]}
        tok = torch.cat([t for t, _ in rows])[:, None]
        return tok, cache

    def step(tok, cache):
        return decode_step(cfg, params, tok, cache, kv)[0]

    out = {"": row0(step, make)}
    if DEV == "cuda":
        out[" graph"] = row0(step, make, graphed(step))
    return out


def measure(n_layers: int = 2) -> dict:
    """Every row-0 difference, smoke and Llama-3-8B width."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    out = {}
    models = [("smoke", get_smoke_config("llama3_8b"))]
    if DEV == "cuda":
        models.append(("llama3_8b", dataclasses.replace(
            get_config("llama3_8b"), n_layers=n_layers)))
    for name, cfg in models:
        params = init_params(cfg, seed=0, device=DEV)
        eng = ServeEngine(cfg, params, QuantPolicy("nxfp4", "nxfp4"),
                          max_len=MAX_LEN, device=DEV)
        del params
        res = ops(cfg)
        for suffix, r in decode(cfg, eng.params, "nxfp4").items():
            res["decode_step nxfp4" + suffix] = r
        out[name] = res
        del eng
        if DEV == "cuda":
            torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2,
                    help="Llama-3-8B depth (default 2)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    global DEV
    DEV = args.device
    if DEV == "cuda" and not torch.cuda.is_available():
        sys.exit("batch_invariance.py needs a CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (pins the TF32 flags)
    res = measure(args.layers)
    for model, rows in res.items():
        for op, by_b in rows.items():
            print(f"{model} {op}: " + "; ".join(
                f"B={b}: {r['differ']} of {r['of']} differ, max |d| "
                f"{r['max_abs']:.3g}" for b, r in by_b.items()), flush=True)
    card = "cpu"
    if DEV == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps({"device": card, "batch_invariance": res}), flush=True)


if __name__ == "__main__":
    main()
