"""The device decode loop of the torch port on the CPU: the chunk function
run from the static buffers a CUDA graph would be captured over, the
sampled streams of both loops, and the generator after an early stop
(the port of the reference's ``_sync_key``).

On CUDA the same ``_DeviceLoop`` captures the chunk into one graph per
(steps, greedy); here it runs the chunk function eagerly from the same
buffers, so these tests hold the plumbing the graph replays (copy in,
chunk, copy out, one host copy) against ``decode_loop`` and the host loop.
``tests/test_torch_gpu.py`` holds the graph itself on the card.
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.qtensor import QuantPolicy
from repro_torch.models import decode_loop, init_params, prefill
from repro_torch.serving import ServeEngine, mask_chunk_emissions
from repro_torch.serving import engine as engine_mod

import _torch_helpers  # noqa: F401  (one intra-op thread a process)


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config("llama3_8b")


def _engine(cfg, kv="nxfp4", seed=0):
    params = init_params(cfg, seed=1, device="cpu")
    return ServeEngine(cfg, params, QuantPolicy("nxfp4", kv), max_len=40,
                       rng_seed=seed, device="cpu")


def _batch(cfg, b=3, t=6, seed=2):
    return {"tokens": np.random.default_rng(seed).integers(0, cfg.vocab,
                                                           (b, t))}


@pytest.mark.parametrize("kv", ["nxfp4", "nxfp3", None])
@pytest.mark.parametrize("greedy", [True, False])
def test_chunk_from_static_buffers_equals_decode_loop(cfg, kv, greedy):
    """One chunk run by ``_DeviceLoop`` from its static buffers (inputs
    copied in, the cache loaded) gives the bits of ``decode_loop`` +
    ``mask_chunk_emissions`` on the same state: emitted tokens, the next
    token, n_gen, done and every cache tensor."""
    eng = _engine(cfg, kv)
    toks = torch.as_tensor(_batch(cfg)["tokens"])
    logits, cache = prefill(cfg, eng.params, {"tokens": toks}, max_len=40,
                            kv_fmt=kv)
    b = toks.shape[0]
    temp = torch.full((b,), 0.0 if greedy else 0.9)
    stop = torch.tensor([-1, 7, 3], dtype=torch.int64)
    tok = logits.argmax(-1).to(torch.int32)
    done = torch.tensor([False, False, True])
    n_gen = torch.tensor([0, 2, 1], dtype=torch.int32)
    loop = engine_mod._DeviceLoop(eng, cache)
    loop.load(cache)
    state = eng._gen.get_state()
    (emitted, tok1, n1, d1), (host, n_host, d_host) = loop.run(
        5, greedy, tok, done, n_gen, temp, stop)
    after = eng._gen.get_state()
    eng._gen.set_state(state)

    def sample(lg):
        return eng._sample(lg, temp, greedy).to(torch.int32)

    toks_ref, tok_ref, cache_ref = decode_loop(cfg, eng.params, tok, cache,
                                               5, kv, sample)
    em_ref, n_ref, d_ref = mask_chunk_emissions(toks_ref, done, n_gen, stop)
    assert torch.equal(eng._gen.get_state(), after)
    for got, ref in ((emitted, em_ref), (tok1, tok_ref), (n1, n_ref),
                     (d1, d_ref)):
        assert torch.equal(got, ref)
    np.testing.assert_array_equal(host, em_ref.numpy())
    np.testing.assert_array_equal(n_host, n_ref.numpy())
    np.testing.assert_array_equal(d_host, d_ref.numpy())
    assert torch.equal(loop.cache["pos"], cache_ref["pos"])
    for got, ref in zip(loop.cache["layers"], cache_ref["layers"]):
        assert all(torch.equal(got[k], ref[k]) for k in ref)


@pytest.mark.parametrize("chunk", [1, 4, 3])
def test_sampled_loops_bitwise(cfg, chunk):
    """Sampled (temperature 0.8, one greedy row): both loops draw the same
    noise in the same order from engines seeded alike, so the streams are
    bitwise equal."""
    batch = _batch(cfg)
    temp = np.array([0.8, 0.0, 1.3], np.float32)
    rh = _engine(cfg, seed=5).generate(batch, max_new=8, temperature=temp,
                                       loop="host")
    rd = _engine(cfg, seed=5).generate(batch, max_new=8, temperature=temp,
                                       loop="device", chunk=chunk)
    np.testing.assert_array_equal(rh.tokens, rd.tokens)
    np.testing.assert_array_equal(rh.n_generated, rd.n_generated)


@pytest.mark.parametrize("chunk", [4, 10])
def test_sync_key_after_early_stop(cfg, chunk):
    """A sampled call that stops early mid-chunk leaves the generator where
    the host loop leaves it: the call after it gives the same tokens
    whichever loop ran the first call (the reference's ``_sync_key``)."""
    batch = _batch(cfg, seed=3)
    temp = 0.9
    probe = _engine(cfg, seed=7).generate(batch, max_new=10,
                                          temperature=temp, loop="host")
    # the stop token every row reaches first in the probe stream ends the
    # host loop early
    stop = np.array([row[1] for row in probe.tokens], np.int64)
    runs = {}
    for loop in ("host", "device"):
        eng = _engine(cfg, seed=7)
        first = eng.generate(batch, max_new=10, temperature=temp,
                             stop_token=stop, loop=loop, chunk=chunk)
        second = eng.generate(batch, max_new=6, temperature=temp,
                              loop=loop, chunk=chunk)
        runs[loop] = (first, second, eng._gen.get_state())
    (fh, sh, gh), (fd, sd, gd) = runs["host"], runs["device"]
    np.testing.assert_array_equal(fh.tokens, fd.tokens)
    np.testing.assert_array_equal(fh.n_generated, fd.n_generated)
    assert (fh.n_generated == 2).all()         # stopped on the 2nd token
    np.testing.assert_array_equal(sh.tokens, sd.tokens)
    assert torch.equal(gh, gd)


def test_device_loop_is_cached_and_dropped(cfg):
    """The device loop (its static buffers and, on CUDA, its graphs) is
    cached process-wide per (engine, batch) and reused by later calls; the
    entries go with their engine."""
    eng = _engine(cfg)
    batch = _batch(cfg)
    eng.generate(batch, max_new=3, loop="device", chunk=2)
    mine = [k for k in engine_mod._PROGRAM_CACHE if k[0] == eng._uid]
    assert len(mine) == 1
    prog = engine_mod._PROGRAM_CACHE[mine[0]]
    eng.generate(batch, max_new=5, loop="device", chunk=4)
    assert engine_mod._PROGRAM_CACHE[mine[0]] is prog
    eng.generate(_batch(cfg, b=2), max_new=2, loop="device")
    assert len([k for k in engine_mod._PROGRAM_CACHE
                if k[0] == eng._uid]) == 2
    uid = eng._uid
    del eng, prog
    gc.collect()
    assert not [k for k in engine_mod._PROGRAM_CACHE if k[0] == uid]
