"""Data pipeline: the deterministic synthetic stream and binary token
shards, the port's copy of ``repro.train.data`` (the same seed, host and
cursor give the same batches).

Both sources are (a) deterministic given (seed, step) so a restarted job
resumes bit-identically, (b) host-shardable, and (c) stateful with an
explicit, checkpointable ``state()`` dict.
"""
from __future__ import annotations

import json
import os

import numpy as np


class SyntheticLMData:
    """Deterministic synthetic token stream (Philox keyed by (seed, step)).

    Draws structured sequences (a noisy integer-sequence task) rather than
    i.i.d. tokens so training loss actually decreases — used by the
    end-to-end example and convergence tests.
    """

    def __init__(self, vocab: int, batch: int, seq_len: int, *, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._step = 0

    def state(self) -> dict:
        return {"step": self._step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self._step = int(state["step"])
        self.seed = int(state["seed"])

    def _rng(self, step: int) -> np.random.Generator:
        key = (self.seed << 32) ^ (step << 8) ^ self.host_id
        return np.random.Generator(np.random.Philox(key=[key, 0]))

    def next_batch(self) -> dict:
        rng = self._rng(self._step)
        self._step += 1
        b, s, v = self.batch, self.seq_len + 1, self.vocab
        # arithmetic sequences mod vocab with token noise — learnable structure
        start = rng.integers(0, v, (b, 1))
        stride = rng.integers(1, 7, (b, 1))
        seq = (start + stride * np.arange(s)[None, :]) % v
        noise = rng.random((b, s)) < 0.05
        seq = np.where(noise, rng.integers(0, v, (b, s)), seq)
        seq = seq.astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


class BinaryShardData:
    """Flat binary token shards (np.uint16/uint32 .bin files).

    Layout-compatible with common LM pretraining dumps.  Hosts stride over
    documents; the cursor state is checkpointable for exact resume.
    """

    def __init__(self, paths: list[str], batch: int, seq_len: int, *,
                 dtype=np.uint16, host_id: int = 0, num_hosts: int = 1,
                 seed: int = 0):
        if not paths:
            raise ValueError("no shard paths given")
        self.paths = sorted(paths)
        self.batch = batch
        self.seq_len = seq_len
        self.dtype = np.dtype(dtype)
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.seed = seed
        self._shard_idx = 0
        self._offset = host_id * batch * (seq_len + 1)
        self._epoch = 0
        self._mm = None
        self._open()

    def _open(self):
        self._mm = np.memmap(self.paths[self._shard_idx], dtype=self.dtype,
                             mode="r")

    def state(self) -> dict:
        return {
            "shard_idx": self._shard_idx,
            "offset": int(self._offset),
            "epoch": self._epoch,
        }

    def restore(self, state: dict) -> None:
        self._shard_idx = int(state["shard_idx"])
        self._offset = int(state["offset"])
        self._epoch = int(state["epoch"])
        self._open()

    def next_batch(self) -> dict:
        need = self.batch * (self.seq_len + 1)
        stride = need * self.num_hosts
        if self._offset + need > len(self._mm):
            self._shard_idx = (self._shard_idx + 1) % len(self.paths)
            if self._shard_idx == 0:
                self._epoch += 1
            self._offset = self.host_id * need
            self._open()
        flat = np.asarray(self._mm[self._offset : self._offset + need],
                          dtype=np.int32)
        self._offset += stride
        seq = flat.reshape(self.batch, self.seq_len + 1)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def write_binary_shard(path: str, tokens: np.ndarray, dtype=np.uint16) -> None:
    """Write ``tokens`` as one flat shard file of ``dtype``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tokens.astype(dtype).tofile(path)


def save_data_state(path: str, state: dict) -> None:
    with open(path, "w") as f:
        json.dump(state, f)


def load_data_state(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
