"""Deterministic, host-shardable data pipelines: the reference's
``data/pipeline.py`` in numpy, batch for batch the same tokens.

``SyntheticLM`` generates a *learnable* language: a hidden-state Markov
process over a Zipfian vocabulary with local copy structure, so losses
drop well below the uniform floor within a few hundred steps and a
direct-cast comparison of eval losses (the paper's Table 1) means
something on a model trained here. ``TextCorpus`` samples byte windows of
a file.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Hidden-Markov + copy-structure synthetic corpus."""

    vocab: int
    n_states: int = 64
    zipf_a: float = 1.2
    copy_prob: float = 0.25
    copy_back: int = 16
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v_eff = self.vocab - 1
        # per-state Zipfian emission over a state-specific permutation
        ranks = np.arange(1, v_eff + 1, dtype=np.float64)
        base = 1.0 / ranks ** self.zipf_a
        base /= base.sum()
        emit = np.stack([
            base[rng.permutation(v_eff)] for _ in range(self.n_states)])
        self.emit_cdf = np.cumsum(emit, axis=1)
        trans = rng.dirichlet(np.full(self.n_states, 0.3),
                              size=self.n_states)
        self.trans_cdf = np.cumsum(trans, axis=1)

    def _emit(self, state, u):
        """The emitted token of each row: 1 + the number of its state's
        CDF entries below u. A CDF of positive terms never decreases, so
        that count is ``searchsorted``'s left insertion point: the
        reference's count (a (B, V) comparison a position) in a binary
        search a row."""
        return np.array([np.searchsorted(self.emit_cdf[s], x, side="left")
                         for s, x in zip(state, u)], dtype=np.int64) + 1

    def sample(self, rng: np.random.Generator, batch: int, seq: int
               ) -> np.ndarray:
        out = np.zeros((batch, seq), np.int64)
        state = rng.integers(0, self.n_states, size=batch)
        for t in range(seq):
            copy = (rng.random(batch) < self.copy_prob) & (t > self.copy_back)
            back = rng.integers(1, self.copy_back, size=batch)
            u = rng.random(batch)
            emitted = self._emit(state, u)
            copied = out[np.arange(batch), np.maximum(t - back, 0)]
            out[:, t] = np.where(copy, copied, emitted)
            u2 = rng.random(batch)
            state = (self.trans_cdf[state] < u2[:, None]).sum(1)
            state = np.minimum(state, self.n_states - 1)
        return out


@dataclasses.dataclass
class TextCorpus:
    """Byte-level corpus from a file, same iterator API."""

    path: str
    vocab: int = 256

    def __post_init__(self):
        with open(self.path, "rb") as f:
            self._data = np.frombuffer(f.read(),
                                       dtype=np.uint8).astype(np.int64)

    def sample(self, rng: np.random.Generator, batch: int, seq: int):
        starts = rng.integers(0, len(self._data) - seq - 1, size=batch)
        return np.stack([self._data[s: s + seq] for s in starts])


def make_data_iter(source, batch: int, seq: int, *, seed: int = 0,
                   host_id: int = 0, n_hosts: int = 1,
                   extras_fn=None) -> Iterator[dict]:
    """Deterministic host-sharded iterator: host i draws stream (seed, i).

    Restart-safe: step k's batch is drawn from the seed (seed, host, k),
    so a run resumed at step k regenerates batch k without checkpointing
    the pipeline. Yields {"tokens": (batch / n_hosts, seq) int32} plus
    ``extras_fn(rng, local_batch)``'s arrays."""
    if batch % n_hosts:
        raise ValueError(f"batch {batch} does not split over {n_hosts} "
                         "hosts")
    local = batch // n_hosts
    step = 0
    while True:
        rng = np.random.default_rng((seed, host_id, step))
        tokens = source.sample(rng, local, seq)
        out = {"tokens": tokens.astype(np.int32)}
        if extras_fn is not None:
            out.update(extras_fn(rng, local))
        yield out
        step += 1
