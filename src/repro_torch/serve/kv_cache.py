"""The dense GQA ring KV cache, and the static permutations of the fused-K̂
decode cache.

Layout (L = layers, B = slots, S = max_len): ``k``, ``v`` (L, B, Hkv, S, dh)
and ``length`` (B,) int32.  Writes land at ``pos mod S``; ``length`` counts
every token ever written, so the live window is the most recent
``min(length, S)`` tokens and RoPE positions stay absolute.
"""
from __future__ import annotations

import torch

from repro_torch.core import grouping


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def static_perms(cfg) -> torch.Tensor:
    """Static per-(layer, KV head) grouping permutations (L, Hkv, dh) int64
    of the fused-K̂ decode cache, on the CPU: one ``torch.randperm`` per
    (layer, KV head) from a generator seeded with ``proj_seed + 13``.  The
    reference draws its own with ``jax.random``; the two differ, so the
    tests pass the reference's across (``models.convert.convert_perms``)."""
    gen = torch.Generator().manual_seed(cfg.attention.distr.proj_seed + 13)
    return torch.stack([
        torch.stack([torch.randperm(cfg.head_dim_, generator=gen)
                     for _ in range(cfg.n_kv_heads)])
        for _ in range(cfg.n_layers)
    ])


def fuse_new_k(k_new: torch.Tensor, perm: torch.Tensor, group_size: int) -> torch.Tensor:
    """Fuse K rows into K̂ in f32.  k_new: (B, Hkv, w, dh); perm: (Hkv, dh)
    → (B, Hkv, w, dh/G*)."""
    return grouping.fuse_columns(k_new.float(), perm[None], group_size)


def sample_q(q: torch.Tensor, perm: torch.Tensor, group_size: int,
             q_per_kv: int) -> torch.Tensor:
    """Sample Q columns under the per-KV-head static permutation.  q: (B, Hq,
    n, dh); perm: (Hkv, dh) → (B, Hq, n, dh/G*).  ``q_per_kv`` is implied by
    the head counts (kept for the reference's signature)."""
    del q_per_kv
    return grouping.sample_q_heads(q, perm, group_size)
