"""Deterministic synthetic token stream, the port's own copy of
``repro.train.data.SyntheticLMData``: the same seed gives the same batches."""
from __future__ import annotations

import numpy as np


class SyntheticLMData:
    """Noisy arithmetic sequences mod vocab (Philox keyed by (seed, step)),
    so training loss actually decreases."""

    def __init__(self, vocab: int, batch: int, seq_len: int, *, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self._step = 0

    def _rng(self, step: int) -> np.random.Generator:
        key = (self.seed << 32) ^ (step << 8)
        return np.random.Generator(np.random.Philox(key=[key, 0]))

    def next_batch(self) -> dict:
        """→ {"tokens", "labels"}: int32 (batch, seq_len), labels shifted by one."""
        rng = self._rng(self._step)
        self._step += 1
        b, s, v = self.batch, self.seq_len + 1, self.vocab
        start = rng.integers(0, v, (b, 1))
        stride = rng.integers(1, 7, (b, 1))
        seq = (start + stride * np.arange(s)[None, :]) % v
        noise = rng.random((b, s)) < 0.05
        seq = np.where(noise, rng.integers(0, v, (b, s)), seq)
        seq = seq.astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
