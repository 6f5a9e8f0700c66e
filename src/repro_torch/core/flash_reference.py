"""Exact attention references.

``reference_attention``       — naive masked-softmax oracle (f32 softmax).
``blockwise_flash_reference`` — FlashAttention-2 double loop (online
softmax) in plain PyTorch; numerically equals the oracle.

Both are GQA-aware: ``q`` is ``(B, Hq, N, d)``; ``k``/``v`` are
``(B, Hkv, Nk, d)`` with ``Hq % Hkv == 0``.  Masked scores are ``NEG_INF``
(-1e30), never -inf, so a fully masked row cannot produce NaN.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _group_queries(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, Hq, N, d) → (B, Hkv, r, N, d) with r = Hq // Hkv."""
    b, hq, n, d = q.shape
    if hq % n_kv:
        raise ValueError(f"Hq={hq} not divisible by Hkv={n_kv}")
    return q.reshape(b, n_kv, hq // n_kv, n, d)


def causal_mask(n_q: int, n_k: int, q_offset: int = 0,
                device=None) -> torch.Tensor:
    """Boolean mask (n_q, n_k): True where key j may attend to query i."""
    qi = q_offset + torch.arange(n_q, device=device)[:, None]
    kj = torch.arange(n_k, device=device)[None, :]
    return kj <= qi


def reference_attention(q, k, v, *, causal: bool = False,
                        scale: float | None = None,
                        kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Naive exact attention oracle.

    kv_mask: optional ``(B, Nk)`` bool — False keys are masked out.  Scores
    accumulate in f32; P is rounded to q's dtype before the PV product, as
    in the reference.
    """
    b, hq, n, d = q.shape
    n_kv = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = _group_queries(q, n_kv)
    s = torch.einsum("bgrnd,bgmd->bgrnm", qg.float(), k.float()) * scale
    if causal:
        s = torch.where(causal_mask(n, k.shape[2], device=q.device), s, NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrnm,bgmd->bgrnd", p.to(q.dtype).float(), v.float())
    return o.reshape(b, hq, n, v.shape[-1]).to(q.dtype)


def blockwise_flash_reference(q, k, v, *, block_q: int = 128,
                              block_k: int = 128, causal: bool = False,
                              scale: float | None = None) -> torch.Tensor:
    """FA-2 blockwise exact attention (online softmax) in plain PyTorch.
    Ragged lengths are padded to the block grid and the dead KV tail is
    masked."""
    b, hq, n, d = q.shape
    dv = v.shape[-1]
    n_kv, nk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    r = hq // n_kv
    nk_blocks = -(-nk // block_k)
    qg = _group_queries(q, n_kv)
    outs = []
    for q0 in range(0, n, block_q):
        q_blk = qg[:, :, :, q0:q0 + block_q].float()
        lq = q_blk.shape[3]
        acc = q.new_zeros((b, n_kv, r, lq, dv), dtype=torch.float32)
        m_i = torch.full((b, n_kv, r, lq), NEG_INF, device=q.device)
        l_i = torch.zeros((b, n_kv, r, lq), device=q.device)
        qi = q0 + torch.arange(lq, device=q.device)[:, None]
        for ik in range(nk_blocks):
            k0 = ik * block_k
            k_blk = k[:, :, k0:k0 + block_k].float()
            v_blk = v[:, :, k0:k0 + block_k]
            s = torch.einsum("bgrnd,bgmd->bgrnm", q_blk, k_blk) * scale
            if causal:
                kj = k0 + torch.arange(k_blk.shape[2], device=q.device)[None, :]
                s = torch.where(kj <= qi, s, NEG_INF)
            m_new = torch.maximum(m_i, s.amax(dim=-1))
            alpha = torch.exp(m_i - m_new)
            p = torch.exp(s - m_new[..., None])
            l_i = l_i * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrnm,bgmd->bgrnd", p.to(q.dtype).float(), v_blk.float()
            )
            m_i = m_new
        outs.append((acc / l_i[..., None]).to(q.dtype))
    o = torch.cat(outs, dim=3)
    return o.reshape(b, hq, n, dv)
