"""Deterministic synthetic LM data pipeline.

The port's own copy of ``repro/data/tokens.py`` (numpy in, numpy out, the
same numbers): seeded, reproducible token streams with enough structure
that a model can visibly learn (Zipfian unigrams + a first-order Markov
chain), sharded by (host, step) so every data-parallel worker draws a
disjoint deterministic slice.  ``batch(step)`` is a pure function, so
resuming from a checkpoint at step k replays the exact stream.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["TokenPipeline", "synthetic_batch"]


def synthetic_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                    *, shard: int = 0, num_shards: int = 1):
    """One (tokens, labels) batch — pure function of (seed, step, shard)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard, num_shards])
    )
    b = batch // num_shards
    # Zipf unigram base + Markov "grammar": next ≈ (cur * a + c) mod vocab
    base = rng.zipf(1.3, size=(b, seq + 1)) % vocab
    a = 31
    markov = (base[:, :1] * a + np.cumsum(base, axis=1)[:, :-1]) % vocab
    mix = rng.random((b, seq)) < 0.7
    toks = np.where(mix, markov[:, :seq], base[:, :seq]).astype(np.int32)
    labels = np.where(mix[:, 1:], markov[:, 1:seq], base[:, 1:seq])
    labels = np.concatenate([labels, base[:, seq:seq + 1]], 1).astype(np.int32)
    return dict(tokens=toks, labels=labels)


@dataclass
class TokenPipeline:
    seed: int
    batch: int
    seq: int
    vocab: int
    shard: int = 0
    num_shards: int = 1

    def __call__(self, step: int) -> dict:
        return synthetic_batch(
            self.seed, step, self.batch, self.seq, self.vocab,
            shard=self.shard, num_shards=self.num_shards,
        )

    def iterate(self, start_step: int = 0):
        step = start_step
        while True:
            yield self(step)
            step += 1
