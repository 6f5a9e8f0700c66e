"""Plain PyTorch oracles for every kernel of the package, under the
reference's names and signatures (``repro/kernels/ref.py``), in PyTorch's
(B, H, N, d) layout.

Each wraps the plain version or the core function that already lives
beside its kernel's wrapper, so kernel semantics and framework semantics
cannot drift apart.
"""
from __future__ import annotations

import torch

from repro_torch.core.distr_attention import DistrConfig, distr_attention
from repro_torch.core.flash_reference import reference_attention
from repro_torch.kernels.ssd import ssd_plain


def flash_attention_ref(q, k, v, *, causal: bool = False,
                        scale: float | None = None) -> torch.Tensor:
    """Oracle for ``kernels/flash_attention.py`` (exact attention)."""
    return reference_attention(q, k, v, causal=causal, scale=scale)


def distr_attention_ref(q, k, v, cfg: DistrConfig, *, causal: bool = False,
                        scale: float | None = None,
                        proj: torch.Tensor | None = None) -> torch.Tensor:
    """Oracle for ``kernels/distr_attention.py``: the blockwise
    DistrAttention with a full-row softmax a Q block, which the kernel
    computes with an online softmax under the same permutations.  ``proj``
    is the LSH projection (None draws it from ``cfg.proj_seed``)."""
    return distr_attention(q, k, v, cfg, causal=causal, scale=scale, proj=proj)


def decode_attention_ref(q, k, v, lengths: torch.Tensor | None = None, *,
                         scale: float | None = None) -> torch.Tensor:
    """Oracle for ``kernels/decode.py`` (q_len 1).  q: (B, Hq, 1, d); k, v:
    (B, Hkv, S, d); ``lengths`` (B,) live token counts (None: all S live).
    The fused-K̂ variant shares it: pass the fused cache as ``k`` and the
    sampled queries as ``q`` with the full-d scale."""
    kv_mask = (torch.arange(k.shape[2], device=q.device)[None, :] < lengths[:, None]
               if lengths is not None else None)
    return reference_attention(q, k.to(q.dtype), v.to(q.dtype), scale=scale, kv_mask=kv_mask)


def ssd_ref(x, a, b, c, *, chunk: int = 64) -> torch.Tensor:
    """Oracle for ``kernels/ssd.py`` (Mamba-2's state-space duality).  x: (B,
    N, H, P) inputs; a: (B, N, H) log-decays; b, c: (B, N, G, S) → y (B, N,
    H, P) in x's dtype, computed in f32 by the kernel's plain version over
    the heads flattened as the kernel takes them."""
    bsz, n, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    y = ssd_plain(x.transpose(1, 2).reshape(bsz * h, n, p),
                  a.transpose(1, 2).reshape(bsz * h, n),
                  b.transpose(1, 2).reshape(bsz * g, n, s),
                  c.transpose(1, 2).reshape(bsz * g, n, s),
                  heads_per_group=h // g, chunk=chunk)
    return y.reshape(bsz, h, n, p).transpose(1, 2)
