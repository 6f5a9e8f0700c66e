"""Sampling and fusion over grouped embedding-dim columns (paper §3.1-3.2).

Groups are the consecutive runs of ``group_size`` permuted columns:

* ``sample`` — pick one representative Q column per group (the paper's);
* ``fuse``   — sum the K columns of each group (the paper's fusion);
* ``mean``   — average the Q columns of each group (beyond-paper estimator).
"""
from __future__ import annotations

import torch


def _take_columns(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather embedding-dim columns: x ``(..., n, d)``, idx ``(..., k)``,
    idx broadcast over the row axis (and any leading axes)."""
    idx = idx.to(torch.int64).unsqueeze(-2)
    lead = torch.broadcast_shapes(x.shape[:-1], idx.shape[:-1])
    x = x.expand(*lead, x.shape[-1])
    return torch.gather(x, -1, idx.expand(*lead, idx.shape[-1]))


def sampled_indices(perm: torch.Tensor, group_size: int) -> torch.Tensor:
    """Representative column index per group: first column in sorted order."""
    return perm[..., ::group_size]


def sample_columns(x: torch.Tensor, perm: torch.Tensor,
                   group_size: int) -> torch.Tensor:
    """Q-side sampling: ``(..., n, d) → (..., n, d // group_size)``."""
    return _take_columns(x, sampled_indices(perm, group_size))


def sample_q_heads(q: torch.Tensor, perm: torch.Tensor,
                   group_size: int) -> torch.Tensor:
    """Sample Q columns under a per-KV-head permutation.

    q: ``(B, Hq, n, d)``; perm: ``(Hkv, d)`` → ``(B, Hq, n, d // group_size)``.
    Every query head of a GQA group shares its KV head's permutation.
    """
    b, hq, n, d = q.shape
    hkv = perm.shape[0]
    idx = sampled_indices(perm, group_size)  # (Hkv, d/g)
    qg = q.reshape(b, hkv, hq // hkv, n, d)
    out = _take_columns(qg, idx[None, :, None, :])
    return out.reshape(b, hq, n, d // group_size)


def fuse_columns(x: torch.Tensor, perm: torch.Tensor,
                 group_size: int) -> torch.Tensor:
    """K-side fusion: permute columns, then sum each run of ``group_size``.

    ``(..., n, d) → (..., n, d // group_size)``
    """
    d = x.shape[-1]
    if d % group_size:
        raise ValueError(f"d={d} not divisible by group_size={group_size}")
    permuted = _take_columns(x, perm)
    return permuted.reshape(*permuted.shape[:-1], d // group_size,
                            group_size).sum(dim=-1)


def mean_columns(x: torch.Tensor, perm: torch.Tensor,
                 group_size: int) -> torch.Tensor:
    """Beyond-paper Q estimator: group mean instead of a single sample."""
    return fuse_columns(x, perm, group_size) / group_size


def reduce_qk(q: torch.Tensor, k: torch.Tensor, perm: torch.Tensor, group_size: int,
              estimator: str = "sample") -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's reduction of a (Q block, K block) pair.

    q: ``(..., l, d)``; k: ``(..., m, d)`` (not transposed); perm: ``(...,
    d)``, the grouping permutation of the Q block; ``estimator`` "sample"
    (paper) or "mean" (beyond-paper).  Returns ``(q_hat, k_hat)`` of
    trailing dim ``d // group_size``, whose ``q_hat @ k_hat^T``
    approximates ``q @ k^T`` (still scaled by 1/sqrt(d) downstream)."""
    if estimator == "sample":
        q_hat = sample_columns(q, perm, group_size)
    elif estimator == "mean":
        q_hat = mean_columns(q, perm, group_size)
    else:
        raise ValueError(f"unknown estimator {estimator!r}")
    return q_hat, fuse_columns(k, perm, group_size)
