"""Synthetic LM token pipeline: deterministic, shardable, restartable.

Each (step, dp_shard) pair maps to an independent PRNG stream, so
  - resuming from a checkpoint replays the exact same data (fault tolerance),
  - elastic rescale re-buckets shards deterministically (elastic.py),
  - straggler mitigation can skip a step on every host coherently.
Tokens follow a Zipf-ish distribution with Markov structure so losses move.
"""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, batch: int, seq_len: int, *,
                 dp_rank: int = 0, dp_size: int = 1, seed: int = 1234):
        assert batch % dp_size == 0
        self.vocab = vocab_size
        self.local_batch = batch // dp_size
        self.seq = seq_len
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.seed = seed

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 131 + self.dp_rank)
        # Zipf head + uniform tail, with short-range repetition structure
        z = rng.zipf(1.3, size=(self.local_batch, self.seq)).astype(np.int64)
        toks = np.clip(z, 1, self.vocab - 1)
        rep = rng.random((self.local_batch, self.seq)) < 0.2
        shifted = np.roll(toks, 3, axis=1)
        toks = np.where(rep, shifted, toks)
        return toks.astype(np.int32)
