#!/usr/bin/env python3
"""Batch invariance of the port on one GPU: does a row's result depend on
how many rows share the call?

    python3 scripts/batch_invariance.py              # smoke + 2-layer Llama-3-8B
    python3 scripts/batch_invariance.py --layers 4
    python3 scripts/batch_invariance.py --device cpu # the plain path, smoke only
    python3 scripts/batch_invariance.py --chunked    # whole prefill vs the lane
    python3 scripts/batch_invariance.py --dense      # bf16 weights, dense KV
    python3 scripts/batch_invariance.py --arch h2o_danube_3_4b  # its widths

Decode (the default). Row 0 of every input equals the B = 1 input and the
other rows are random. For B in ``BATCHES`` the script counts the elements
of row 0 that differ from the B = 1 result, with the largest difference:
for each op of the decode step whose work spans rows (the rmsnorm
reduction in f32, and a plain ``torch.mean`` of the same squares for
comparison; the dequant GEMM at the four Llama-3-8B (K, N) pairs, the
``lm_head`` product, decode attention at S 512 with per-row lengths, the
sampler's softmax) and for ``decode_step``'s logits end to end (nxfp4
weights and KV; the smoke Llama and Llama-3-8B at full width, ``lm_head``
included). On the card ``lm_head`` and ``decode_step`` at each B also
run as a replay of a captured CUDA graph (as the engines' chunks do)
against B 1 eager. The continuous engine holds a request's stream bitwise
to its solo stream, which needs every count but the plain
``torch.mean``'s to be 0.

``--chunked``: a prompt's rows through the whole prefill against the same
rows through the chunked-prefill lane, at lane widths P in ``LANE_P``:
each op's f32 result (the norm's mean of squares of P-row chunks, and a
plain ``torch.mean`` of them for comparison; prefill
attention, a lane chunk over the lane's R scratch rows from its offset
against the whole prompt; the dequant GEMM's row products at M 16 to 256
against M 512, the regimes being split-K up to 16 rows and
wgmma above), then ``prefill_chunk``'s final logits and the slot's packed
K/V bytes against ``prefill``'s, eagerly and (on the card) as a replay of
a captured graph. The chunked engine's oracle (a lane-admitted stream
equals its solo stream) needs every count of the lane's own path to be 0.

``--dense``: the same with bf16 weights (cuBLAS products, on fixed
128-row tiles above 16 rows) and a dense KV cache instead of nxfp4 (the
premium serving tier's path): the GEMM rows are ``ops._dense_matmul``'s,
decode attention the attention kernel's dense-row instance through
``attend_decode``, prefill attention ``attend_chunked``, and
``decode_step``/``prefill_chunk`` run the dense model.

The last line is one JSON object.
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
# 16: the most rows the decode GEMM's split-K regime takes (its plan is
# one plan for 1-16 rows) and the most slots the engines' oracle covers
BATCHES = (4, 8, 16)
MAX_LEN = 512
KN = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
LANE_P = (16, 32, 64, 128)    # --chunked: the lane widths
PROMPT = 200                  # --chunked: the prompt (a ragged last chunk)
GEMM_M = (16, 32, 64, 128, 256)   # --chunked: GEMM rows against M 512
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


def _weight(k, n, gen, fmt):
    """A (K, N) weight of N(0, 0.02): cast to ``fmt``, or bf16."""
    from repro_torch.kernels.ops import quantize_qtensor
    w = torch.randn((k, n), generator=gen, device=DEV) * 0.02
    if fmt is None:
        return w.to(torch.bfloat16)
    return quantize_qtensor(w, fmt, axis=-2, device=DEV)


def _gemm_name(fmt) -> str:
    return "nxfp_matmul" if fmt is not None else "dense_matmul (torch.mm)"


def ops(cfg, fmt="nxfp4") -> dict:
    """The decode step's row-spanning ops at ``cfg``'s widths, with
    weights and KV at ``fmt`` (None: bf16 weights, dense KV)."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.qtensor import QTensor, fmt_key
    from repro_torch.kernels.nxfp_quantize import nxfp_quantize_kv_rows
    from repro_torch.kernels.ops import decode_attention, qmatmul
    from repro_torch.models.common import dense, mean_square
    from repro_torch.models.kvcache import attend_decode, attn_cache_init

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
        wq = _weight(k, n, gen, fmt)
        out[f"{_gemm_name(fmt)} K={k} N={n}"] = row0(
            lambda x: qmatmul(x, wq), lambda b: (_rows((k,), b, 5,
                                                       torch.bfloat16),))
        del wq
    kvh, hd, h = cfg.n_kv_heads, cfg.hd, cfg.n_heads

    def dense_attention(b):
        cache = attn_cache_init(cfg, b, MAX_LEN, None, torch.device(DEV))
        cache["k"].copy_(_rows((MAX_LEN, kvh, hd), b, 6, torch.bfloat16))
        cache["v"].copy_(_rows((MAX_LEN, kvh, hd), b, 8, torch.bfloat16))
        pos = torch.tensor([299] + [16 + 97 * i for i in range(1, b)],
                           dtype=torch.int32, device=DEV)
        return _rows((h, hd), b, 10), cache, pos

    def attention(b):
        qfmt = get_format(fmt)
        cache = attn_cache_init(cfg, b, MAX_LEN, fmt, torch.device(DEV))
        k = _rows((MAX_LEN, kvh, hd), b, 6, torch.bfloat16)
        vv = _rows((MAX_LEN, kvh, hd), b, 8, torch.bfloat16)
        nxfp_quantize_kv_rows(k, vv, cache, None, qfmt)
        lens = torch.tensor([300] + [17 + 97 * i for i in range(1, b)],
                            dtype=torch.int32, device=DEV)
        shape = (b, MAX_LEN, kvh, hd)
        kq = QTensor(cache["k_packed"], cache["k_meta"], fmt_key(qfmt),
                     shape, -1, hd)
        vq = QTensor(cache["v_packed"], cache["v_meta"], fmt_key(qfmt),
                     shape, -1, hd)
        return _rows((h, hd), b, 10), kq, vq, lens

    if fmt is None:
        out[f"decode_attention dense S={MAX_LEN}"] = row0(
            lambda q, cache, pos: attend_decode(cfg, cache, q, pos, None),
            dense_attention)
    else:
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
    # ragged lengths below MAX_LEN (the first seven as before B 16 came)
    lens = [200] + [37 + 61 * i % 440 for i in range(1, max(BATCHES))]
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


def measure(n_layers: int = 2, fmt="nxfp4", archs=("llama3_8b",)) -> dict:
    """Every row-0 difference, smoke Llama and ``archs`` at full width
    (``n_layers`` deep), weights and KV at ``fmt`` (None: bf16 weights and
    a dense KV cache)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    out = {}
    models = [("smoke", get_smoke_config("llama3_8b"))]
    if DEV == "cuda":
        models += [(arch, dataclasses.replace(get_config(arch),
                                              n_layers=n_layers))
                   for arch in archs]
    for name, cfg in models:
        params = init_params(cfg, seed=0, device=DEV)
        eng = ServeEngine(cfg, params, QuantPolicy(fmt, fmt),
                          max_len=MAX_LEN, device=DEV)
        del params
        res = ops(cfg, fmt)
        for suffix, r in decode(cfg, eng.params, fmt).items():
            res[f"decode_step {fmt or 'dense'}" + suffix] = r
        out[name] = res
        del eng
        if DEV == "cuda":
            torch.cuda.empty_cache()
    return out


def _lane_rows(t: int, p: int):
    """The (offset, n_valid) of each lane chunk of a t-token prompt."""
    return [(o, min(p, t - o)) for o in range(0, t, p)]


def chunked_ops(cfg, p: int) -> dict:
    """Whole against lane, per op, at lane width ``p``: the norm's mean of
    squares and prefill attention."""
    from repro_torch.models.attention import attend_chunked
    from repro_torch.models.common import mean_square

    out = {}
    t, d = PROMPT, cfg.d_model
    rows = _lane_rows(t, p)
    lane_r = -(-MAX_LEN // p) * p
    x = (torch.randn((1, t, d), generator=_gen(20), device=DEV)
         ).to(torch.bfloat16)
    whole = mean_square(x)[0]
    got = torch.empty_like(whole)
    for off, n in rows:
        chunk = torch.zeros((1, p, d), dtype=x.dtype, device=DEV)
        chunk[:, :n] = x[:, off:off + n]
        got[off:off + n] = mean_square(chunk)[0, :n]
    out["rmsnorm mean_square"] = _diff(whole, got)
    whole = torch.mean(torch.square(x.float()), dim=-1)[0]
    for off, n in rows:
        chunk = torch.zeros((1, p, d), dtype=x.dtype, device=DEV)
        chunk[:, :n] = x[:, off:off + n]
        got[off:off + n, 0] = torch.mean(torch.square(chunk.float()),
                                         dim=-1)[0, :n]
    out[PLAIN_MEAN] = _diff(whole, got[:, 0])

    kvh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    q = torch.randn((1, t, kvh, g, hd), generator=_gen(21), device=DEV)
    k = torch.randn((1, t, kvh, hd), generator=_gen(22), device=DEV)
    v = torch.randn((1, t, kvh, hd), generator=_gen(23), device=DEV)
    q, k, v = (a.to(torch.bfloat16) for a in (q, k, v))
    whole = attend_chunked(q, k, v)
    lk = torch.randn((1, lane_r, kvh, hd), generator=_gen(24),
                     device=DEV).to(torch.bfloat16)      # stale rows
    lv = torch.randn((1, lane_r, kvh, hd), generator=_gen(25),
                     device=DEV).to(torch.bfloat16)
    got = torch.empty_like(whole)
    for off, n in rows:
        lk[:, off:off + n] = k[:, off:off + n]
        lv[:, off:off + n] = v[:, off:off + n]
        qc = torch.zeros((1, p, kvh, g, hd), dtype=q.dtype, device=DEV)
        qc[:, :n] = q[:, off:off + n]
        at = torch.tensor([off], dtype=torch.int32, device=DEV)
        got[:, off:off + n] = attend_chunked(qc, lk, lv, q_offset=at,
                                             kv_valid=at + n)[:, :n]
    out["prefill attention"] = _diff(whole, got)

    return out


def gemm_rows(cfg, fmt="nxfp4") -> dict:
    """The GEMM's row products at M in ``GEMM_M`` against the same rows at
    M 512: the dequant GEMM's (split-K up to 16 rows, wgmma above), or
    with ``fmt`` None the dense product's (``torch.mm``)."""
    from repro_torch.kernels.ops import qmatmul

    out = {}
    gen = _gen(26)
    d = cfg.d_model
    for kk, nn in KN if d == 4096 else ((d, d), (d, cfg.d_ff)):
        wq = _weight(kk, nn, gen, fmt)
        xs = (torch.randn((512, kk), generator=gen, device=DEV)
              ).to(torch.bfloat16)
        ref = qmatmul(xs, wq)
        out[f"{_gemm_name(fmt)} K={kk} N={nn} rows vs M=512"] = {
            f"M={m}": _diff(ref[:m], qmatmul(xs[:m], wq)) for m in GEMM_M}
        del wq
    return out


def chunked_model(cfg, params, p: int, fmt="nxfp4") -> dict:
    """``prefill_chunk`` over a prompt's chunks against ``prefill``: the
    final logits and the slot's packed K/V rows, eagerly and, on the card,
    with every chunk a replay of a captured graph (the engine's lane)."""
    from repro_torch.models import (init_cache, init_lane, prefill,
                                    prefill_chunk)

    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (PROMPT,))
    want, wc = prefill(cfg, params, {"tokens": torch.as_tensor(
        toks[None], device=DEV)}, max_len=MAX_LEN, kv_fmt=fmt)
    rows = _lane_rows(PROMPT, p)

    def run(graph: bool):
        cache = init_cache(cfg, 2, MAX_LEN, fmt, device=DEV)
        lane = init_lane(cfg, MAX_LEN, p, device=DEV)
        tok = torch.zeros((1, p), dtype=torch.int64, device=DEV)
        idx = torch.zeros((3,), dtype=torch.int32, device=DEV)
        graphs = {}
        logits = None
        for off, n in rows:
            host = np.zeros((1, p), np.int64)
            host[0, :n] = toks[off:off + n]
            tok.copy_(torch.from_numpy(host))
            idx.copy_(torch.tensor([1, off, n], dtype=torch.int32))
            head = off + n >= PROMPT

            def fn():
                return prefill_chunk(cfg, params, tok, cache, idx[0:1],
                                     idx[1:2], idx[2:3], lane, fmt,
                                     with_head=head)[0]
            if graph:
                from repro_torch.serving.engine import capture_graph
                if head not in graphs:
                    graphs[head] = capture_graph(fn, torch.device(DEV))
                graphs[head][0].replay()
                logits = graphs[head][1]
            else:
                logits = fn()
        kv = sum(int((cache["layers"][i][name][1, :PROMPT]
                      != wc["layers"][i][name][0, :PROMPT]).sum())
                 for i in range(cfg.n_layers) for name in wc["layers"][i])
        return logits, kv

    out = {}
    for graph in (False, True) if DEV == "cuda" else (False,):
        logits, kv = run(graph)
        tag = " graph" if graph else ""
        out["prefill_chunk logits" + tag] = _diff(want, logits)
        out["prefill_chunk K/V bytes" + tag] = {"differ": kv}
    return out


def measure_chunked(n_layers: int = 2, fmt="nxfp4", lane_p=LANE_P) -> dict:
    """Whole against lane at every width of ``lane_p``, smoke and (on the
    card) Llama-3-8B at full width, weights and KV at ``fmt`` (None: bf16
    weights, dense KV)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.qtensor import QuantPolicy
    from repro_torch.models import init_params
    from repro_torch.serving.engine import load_params

    out = {}
    models = [("smoke", get_smoke_config("llama3_8b"))]
    if DEV == "cuda":
        models.append(("llama3_8b", dataclasses.replace(
            get_config("llama3_8b"), n_layers=n_layers)))
    for name, cfg in models:
        params = load_params(init_params(cfg, seed=0, device=DEV),
                             QuantPolicy(fmt, fmt), torch.device(DEV))
        res = gemm_rows(cfg, fmt)
        for p in lane_p:
            for op, r in {**chunked_ops(cfg, p),
                          **chunked_model(cfg, params, p, fmt)}.items():
                res.setdefault(op, {})[f"P={p}"] = r
        out[name] = res
        del params
        if DEV == "cuda":
            torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2,
                    help="Llama-3-8B depth (default 2)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--chunked", action="store_true",
                    help="whole prefill against the chunked-prefill lane")
    ap.add_argument("--dense", action="store_true",
                    help="bf16 weights and a dense KV cache (not nxfp4)")
    ap.add_argument("--arch", action="append",
                    help="decode: a full-width model besides the smoke "
                         "Llama (default llama3_8b; repeatable)")
    args = ap.parse_args()
    global DEV
    DEV = args.device
    if DEV == "cuda" and not torch.cuda.is_available():
        sys.exit("batch_invariance.py needs a CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (pins the TF32 flags)
    fmt = None if args.dense else "nxfp4"
    res = (measure_chunked(args.layers, fmt) if args.chunked else
           measure(args.layers, fmt, tuple(args.arch or ("llama3_8b",))))
    for model, rows in res.items():
        for op, by_b in rows.items():
            print(f"{model} {op}: " + "; ".join(
                f"{b if args.chunked else f'B={b}'}: {r['differ']} differ"
                + (f" of {r['of']}, max |d| {r['max_abs']:.3g}"
                   if "of" in r else "")
                for b, r in by_b.items()), flush=True)
    card = "cpu"
    if DEV == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps({"device": card, ("chunked_invariance" if args.chunked
                                       else "batch_invariance"): res}),
          flush=True)


if __name__ == "__main__":
    main()
