"""Helpers shared by the port's CPU tests (``tests/test_torch_*.py``).

Importing this module sets one intra-op thread a process: the pytest
workers run side by side, and torch's default of a thread a core
oversubscribes the cores."""
import numpy as np
import torch

from repro_torch.serving import ServeEngine

torch.set_num_threads(1)

_SOLOS = {}


def solo_stream(cfg, params, policy, req, max_len, engine=ServeEngine, **kw):
    """``req`` served alone by the port's host loop (``engine``, a
    ``ServeEngine`` by default, built with ``kw``): the oracle the
    serving engines' streams are held to. Served once a process per
    weights, formats, engine and request, and shared by every case that
    asserts on it; the memo keeps ``params`` alive, so its id, the key's
    first part, never names another object."""
    key = (id(params), policy.weight_fmt, policy.kv_fmt, max_len, engine,
           tuple(sorted(kw.items())), np.asarray(req.tokens).tobytes(),
           req.max_new, req.temperature, req.stop_token, req.seed)
    if key not in _SOLOS:
        eng = engine(cfg, params, policy, max_len=max_len, rng_seed=req.seed,
                     device="cpu", **kw)
        _SOLOS[key] = (params, eng.generate(
            {"tokens": req.tokens[None]}, max_new=req.max_new,
            temperature=req.temperature, stop_token=req.stop_token,
            loop="host"))
    return _SOLOS[key][1]
