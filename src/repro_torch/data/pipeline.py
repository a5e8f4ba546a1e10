"""Deterministic, host-sharded synthetic LM data pipeline (port of
``repro.data.pipeline``, numpy only: batches equal the reference's).

Production posture: every host generates exactly its shard of the global
batch from a counter-based PRNG (hash of (seed, step, host)) — no data
server, no cross-host coordination, bit-reproducible, and restart-safe
(pipeline state is just the step counter, stored in each checkpoint).
The "markov" mode produces learnable structure so integration tests can
assert loss decreases; "uniform" is for pure throughput work.

A byte-level corpus reader (``CorpusDataset``) covers the
train-on-real-text example: documents -> byte tokens -> packed sequences
with -1 padding labels at document boundaries.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mode: str = "markov"  # "markov" | "uniform"
    num_codebooks: int = 1
    process_index: int = 0
    process_count: int = 1


class SyntheticLMDataset:
    """Counter-based deterministic batches (per-host shard)."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.process_count:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.process_count
        # fixed random markov transition table (shared across hosts)
        rng = np.random.default_rng(cfg.seed)
        v = min(cfg.vocab_size, 512)
        self._v = v
        probs = rng.dirichlet(np.ones(8), size=v)
        nexts = rng.integers(0, v, size=(v, 8))
        self._probs = probs
        self._nexts = nexts

    def _rng_for(self, step: int) -> np.random.Generator:
        h = hashlib.sha256(
            f"{self.cfg.seed}:{step}:{self.cfg.process_index}".encode()
        ).digest()
        return np.random.default_rng(int.from_bytes(h[:8], "little"))

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for ``step`` (resume == replay)."""
        cfg = self.cfg
        rng = self._rng_for(step)
        shape = (self.local_batch, cfg.seq_len)
        if cfg.num_codebooks > 1:
            shape = (*shape, cfg.num_codebooks)
        if cfg.mode == "uniform":
            tokens = rng.integers(0, cfg.vocab_size, size=shape,
                                  dtype=np.int32)
        else:
            tokens = self._markov(rng, shape)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1  # no target for the last position
        return {"tokens": tokens, "labels": labels.astype(np.int32)}

    def _markov(self, rng, shape):
        b, s = shape[0], shape[1]
        flatshape = (b, s) if len(shape) == 2 else shape
        out = np.zeros((b, s), np.int32)
        state = rng.integers(0, self._v, size=b)
        # vectorized markov walk over the (small) synthetic vocabulary
        for t in range(s):
            out[:, t] = state
            u = rng.random(b)
            cum = np.cumsum(self._probs[state], axis=1)
            choice = (u[:, None] < cum).argmax(axis=1)
            state = self._nexts[state, choice]
        if len(shape) == 3:
            out = np.broadcast_to(out[..., None], shape).copy()
            out = (out + np.arange(shape[-1])) % self.cfg.vocab_size
        return out % self.cfg.vocab_size

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class CorpusDataset:
    """Byte-level corpus with sequence packing (real-text example path)."""

    def __init__(self, text: str, cfg: DataConfig):
        self.cfg = cfg
        data = np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(
            np.int32)
        self.data = data
        self.local_batch = cfg.global_batch // cfg.process_count

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.process_index, 7919))
        n = len(self.data) - cfg.seq_len - 1
        starts = rng.integers(0, max(n, 1), size=self.local_batch)
        tokens = np.stack([self.data[s:s + cfg.seq_len] for s in starts])
        labels = np.stack([self.data[s + 1:s + cfg.seq_len + 1]
                           for s in starts])
        return {"tokens": tokens, "labels": labels.astype(np.int32)}
