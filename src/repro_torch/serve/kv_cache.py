"""The dense GQA ring KV cache.

Layout (L = layers, B = slots, S = max_len): ``k``, ``v`` (L, B, Hkv, S, dh)
and ``length`` (B,) int32.  Writes land at ``pos mod S``; ``length`` counts
every token ever written, so the live window is the most recent
``min(length, S)`` tokens and RoPE positions stay absolute.
"""
from __future__ import annotations

import torch


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
