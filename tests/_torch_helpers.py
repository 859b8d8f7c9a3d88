"""Helpers shared by the port's CPU tests (``tests/test_torch_*.py``).

Importing this module sets one intra-op thread a process: the pytest
workers run side by side, and torch's default of a thread a core
oversubscribes the cores."""
import numpy as np
import torch

from repro_torch.models import prefill
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


class TierSolo(ServeEngine):
    """``ServeEngine`` whose prefill quantizes its activations to
    ``act_fmt``: a request served alone at a serving tier (the tiers
    tests' oracle, through ``solo_stream(engine=TierSolo, act_fmt=)``)."""

    def __init__(self, *args, act_fmt=None, **kw):
        super().__init__(*args, **kw)
        self.act_fmt = act_fmt

    def _prefill(self, batch):
        tokens = torch.as_tensor(np.asarray(batch["tokens"]),
                                 dtype=torch.int64)
        return prefill(self.cfg, self.params, {"tokens": tokens},
                       max_len=self.max_len, kv_fmt=self.policy.kv_fmt,
                       act_fmt=self.act_fmt)
