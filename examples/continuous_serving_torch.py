"""Continuous batching in the PyTorch/CUDA port, NxFP weights + KV cache.

The torch twin of ``examples/continuous_serving.py``'s first scenario: a
stream of requests with mixed output lengths, arriving one every 10 ms, is
admitted into a 2-slot live cache at chunk boundaries (finished slots are
retired and re-prefilled while their neighbours keep decoding), and every
request's greedy output is checked bit-identical to serving it alone
through the per-token host loop.

    PYTHONPATH=src python examples/continuous_serving_torch.py               # card
    PYTHONPATH=src python examples/continuous_serving_torch.py --device cpu  # CPU

On the card each decode chunk is one CUDA graph replay through the port's
kernels; ``--device cpu`` runs their plain versions. The reference's
preempt/resume and shard-drain scenarios are not ported yet.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.models import init_params
from repro_torch.serving import ContinuousEngine, Request, ServeEngine

N_SLOTS = 2
N_REQUESTS = 6
CHUNK = 8


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain versions")
    dev = resolve_device(ap.parse_args().device)    # raises without a card
    cfg = get_smoke_config("llama3_8b")
    params = init_params(cfg, seed=0, device=dev)
    policy = QuantPolicy(weight_fmt="nxfp4", kv_fmt="nxfp4")

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    tokens=rng.integers(0, cfg.vocab, (8,)).astype(np.int32),
                    max_new=int(rng.choice([6, 12, 24])),
                    arrival_time=i * 0.01)
            for i in range(N_REQUESTS)]

    eng = ContinuousEngine(cfg, params, policy, n_slots=N_SLOTS,
                           max_len=64, chunk=CHUNK, device=dev)
    # warm up (on the card: capture the chunk graph) so the metrics below
    # show steady-state serving
    eng.serve([Request(uid=-1, tokens=np.zeros((8,), np.int32), max_new=1)])
    results = eng.serve(reqs)

    solo = ServeEngine(cfg, params, policy, max_len=64, device=dev)
    print(f"\n{'uid':>3} {'n_tok':>5} {'queue_ms':>8} {'ttft_ms':>7} "
          f"{'tok/s':>7}  solo-identical")
    for r in sorted(results, key=lambda x: x.uid):
        ref = solo.generate({"tokens": reqs[r.uid].tokens[None]},
                            max_new=reqs[r.uid].max_new, loop="host")
        ok = bool(np.array_equal(r.tokens, ref.tokens[0]))
        print(f"{r.uid:>3} {r.n_generated:>5} {r.queue_delay*1e3:>8.1f} "
              f"{r.ttft*1e3:>7.1f} {r.decode_tok_s:>7.0f}  {ok}")
        assert ok, f"uid={r.uid} diverged from the solo oracle"
    total = sum(r.n_generated for r in results)
    print(f"\n{N_REQUESTS} requests over {N_SLOTS} slots on {dev}, {total} "
          f"tokens, {eng.chunks} decode chunks ({eng.replays} graph replays "
          f"since the engine was built); every output bit-identical to solo "
          f"host-loop serving.")


if __name__ == "__main__":
    main()
