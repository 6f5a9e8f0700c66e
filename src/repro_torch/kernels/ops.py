"""Public wrappers around the kernels (forward half of ``repro.kernels.ops``).

Handles what the kernels keep out of their grids: GQA flattening, the
DistrAttention stage 1 (LSH permutations and Q̂ sampling with the softmax
scale folded in), GQA row packing for decode, and the cross-split merge.
Each op takes the kernel on CUDA tensors and the kernel's plain version on
CPU tensors (``kernels/*.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.distr_attention import (
    DistrConfig, block_permutations, default_projection, pad_to_multiple, sample_q,
)
from repro_torch.core import grouping
from repro_torch.kernels import decode as decode_kernels
from repro_torch.kernels.decode import merge_splits
from repro_torch.kernels.distr_attention import distr_attention_kernel_call
from repro_torch.kernels.flash_attention import flash_attention_kernel_call

DEFAULT_DECODE_BLOCK = 128

__all__ = [
    "decode_attention", "distr_attention", "distr_stage1", "flash_attention",
    "merge_splits",
]


def _flatten_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.reshape(b * h, n, d).contiguous()


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """Exact FA-2.  q: (B, Hq, N, d); k, v: (B, Hkv, Nk, d) → (B, Hq, N, d).
    The kernel masks the ragged KV tail itself, so nothing is padded."""
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    out = flash_attention_kernel_call(
        _flatten_heads(q), _flatten_heads(k), _flatten_heads(v),
        q_per_kv=hq // hkv, scale=scale, causal=causal, kv_len=k.shape[2],
    )
    return out.reshape(b, hq, n, v.shape[-1])


def distr_stage1(cfg: DistrConfig, qp: torch.Tensor, scale: float, *,
                 proj: torch.Tensor | None = None, hkv: int | None = None):
    """The paper's lightweight pre-kernel stage (§4.8) on a block_q-padded
    q (B, Hq, N_pad, d): per-Q-block LSH permutations and Q̂ sampling with
    the softmax scale folded in.  Returns (q_hat (B, Hq, N_pad, d/G*) in
    qp's dtype, perms (B, Hq, nq, d) int64)."""
    cfg = cfg.resolved()
    b, hq, n_pad, d = qp.shape
    nq = n_pad // cfg.block_q
    if proj is None:
        proj = default_projection(cfg, qp.device)
    if cfg.shared_kv_perm and hkv is None:
        raise ValueError("shared_kv_perm needs the KV head count")
    perms = block_permutations(qp, cfg, proj, hkv if hkv is not None else hq)
    q_hat = sample_q(qp.reshape(b, hq, nq, cfg.block_q, d), perms, cfg)
    q_hat = (q_hat * scale).reshape(b, hq, n_pad, d // cfg.group_size).to(qp.dtype)
    return q_hat, perms


def distr_attention(q, k, v, cfg: DistrConfig = DistrConfig(), *,
                    causal: bool = False, scale: float | None = None,
                    proj: torch.Tensor | None = None) -> torch.Tensor:
    """DistrAttention: stage 1 in PyTorch, stage 2 in the kernel.
    q: (B, Hq, N, d); k, v: (B, Hkv, Nk, d) → (B, Hq, N, d).  Q is zero-padded
    to block_q (the pad rows enter the last block's hash, as in the
    reference); K/V are not padded."""
    cfg = cfg.resolved()
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    qp = pad_to_multiple(q, cfg.block_q, dim=2)
    n_pad = qp.shape[2]
    q_hat, perms = distr_stage1(cfg, qp, scale, proj=proj, hkv=hkv)
    out = distr_attention_kernel_call(
        _flatten_heads(q_hat), _flatten_heads(k), _flatten_heads(v),
        perms.reshape(b * hq, n_pad // cfg.block_q, d),
        q_per_kv=hq // hkv, causal=causal, group_size=cfg.group_size,
        block_q=cfg.block_q, kv_len=k.shape[2],
    )
    return out.reshape(b, hq, n_pad, v.shape[-1])[:, :, :n]


def _pack_gqa_rows(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Hq, q_len, d) → (B, Hkv, (Hq/Hkv)·q_len, d): the query heads of a
    KV head (× q_len) packed into the kernel's rows."""
    b, hq, q_len, d = q.shape
    return q.reshape(b, hkv, (hq // hkv) * q_len, d).contiguous()


def decode_attention(q, k, v, *, lengths: torch.Tensor | None = None,
                     k_fused: torch.Tensor | None = None,
                     perm: torch.Tensor | None = None, group_size: int = 1,
                     scale: float | None = None,
                     block_k: int | None = None) -> torch.Tensor:
    """Split-K flash-decoding over a KV cache.

    q: (B, Hq, q_len, d); k, v: (B, Hkv, S, d); ``lengths`` (B,) live token
    counts (None ⇒ all S live; clamped to S).  The fused-K̂ variant takes
    ``k_fused`` (B, Hkv, S, d/G*), the static ``perm`` (Hkv, d) and
    ``group_size``; ``k`` may then be None.  ``scale`` refers to the full
    head dim.  Returns (B, Hq, q_len, d) in q's dtype.
    """
    b, hq, q_len, _ = q.shape
    d = v.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    if k_fused is not None:
        if perm is None or group_size <= 1:
            raise ValueError("k_fused needs perm and group_size > 1")
        k_score = k_fused
        q_score = grouping.sample_q_heads(q, perm, group_size)
    else:
        k_score, q_score = k, q
    hkv, s_len = k_score.shape[1], k_score.shape[2]
    block_k = min(block_k or DEFAULT_DECODE_BLOCK, s_len)
    if lengths is None:
        lengths = torch.full((b,), s_len, dtype=torch.int32, device=q.device)
    lengths = torch.clamp(lengths.to(torch.int32), max=s_len)
    # The kernel reads one dtype: a cache narrower than q is upcast (exact),
    # as the reference kernel upcasts every operand to f32.
    o, m, l = decode_kernels.decode_kernel_call(
        _pack_gqa_rows(q_score, hkv), k_score.to(q.dtype).contiguous(),
        v.to(q.dtype).contiguous(), lengths,
        scale=scale, block_k=block_k, q_len=q_len,
    )
    out = merge_splits(o, m, l)  # (B, Hkv, rows, d) f32
    return out.reshape(b, hq, q_len, d).to(q.dtype)
