"""Long-context serving with attention-free and windowed models + NxFP on
the PyTorch/CUDA port (the twin of ``examples/longcontext_ssm_serving.py``).

Shows why the long_500k cell only runs for SSM, hybrid and windowed
archs: the recurrent state is O(1) in the context length, and the NxFP
direct cast shrinks both the weights and (for the hybrid and windowed
archs) the K/V ring.

    PYTHONPATH=src python examples/longcontext_ssm_serving_torch.py               # card
    PYTHONPATH=src python examples/longcontext_ssm_serving_torch.py --device cpu  # CPU

Weights are cast as the reference casts them (its ``direct_cast_tree``
default, the table-driven encoder); on the card the cast, the prefill's
and decode's K/V writes, the GEMMs and decode attention run the port's
kernels, ``--device cpu`` their plain versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.figures.common import cast_tree
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.tree import tree_leaves

ARCHS = ["falcon_mamba_7b", "hymba_1_5b", "h2o_danube_3_4b"]
CONTEXT = 2048          # smoke-scale stand-in for 500k
DECODE_STEPS = 16


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def state_bytes(cache) -> int:
    """The serving state's bytes: every tensor of the cache."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(cache)
               if isinstance(t, torch.Tensor))


def serve_long(cfg, params, tokens, decode_steps: int, device):
    """Prefill ``tokens`` (1, T) with an nxfp4 KV cache, then
    ``decode_steps`` greedy steps. Returns (the greedy tokens, the
    cache's bytes after the prefill, prefill seconds, decode seconds)."""
    t = tokens.shape[1]
    t0 = time.time()
    logits, cache = prefill(cfg, params, {"tokens": tokens},
                            max_len=t + decode_steps, kv_fmt="nxfp4")
    _sync(device)
    t1 = time.time()
    # serving state size: O(1) for ssm, O(window) for swa/hybrid
    nbytes = state_bytes(cache)
    tok = torch.argmax(logits, -1)[:, None]
    out = []
    for _ in range(decode_steps):
        logits, cache = decode_step(cfg, params, tok, cache, kv_fmt="nxfp4")
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
    _sync(device)
    return torch.cat(out, 1).cpu().numpy(), nbytes, t1 - t0, time.time() - t1


def main(device=None, archs=ARCHS, context=CONTEXT,
         decode_steps=DECODE_STEPS):
    dev = resolve_device(device)                   # raises without a card
    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        params = cast_tree(init_params(cfg, 0, device=dev), "nxfp4")
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (1, context))).to(dev)
        toks, nbytes, pre_s, dec_s = serve_long(cfg, params, tokens,
                                                decode_steps, dev)
        window = cfg.sliding_window or "-"
        print(f"{arch:20s} ctx={context} prefill={pre_s:6.2f}s "
              f"decode={decode_steps/dec_s:6.1f} tok/s "
              f"state={nbytes/1e6:7.2f}MB window={window} "
              f"(state is context-length independent)")
        out[arch] = dict(tokens=toks, state_bytes=nbytes)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain versions")
    main(ap.parse_args().device)
