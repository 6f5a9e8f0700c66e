"""GQA/MHA attention with a ring KV cache.

Every score stage dispatches through ``repro_torch.core.api`` so
DistrAttention drops in via config.  The cache is updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import attend, attend_decode
from repro_torch.models import layers


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, n, _ = x.shape
    return x.reshape(b, n, n_heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def attention_init(generator, cfg, dtype=torch.float32) -> dict:
    dh = cfg.head_dim_
    return {
        "wq": layers.linear_init(generator, cfg.d_model, cfg.n_heads * dh,
                                 bias=cfg.qkv_bias, dtype=dtype),
        "wk": layers.linear_init(generator, cfg.d_model, cfg.n_kv_heads * dh,
                                 bias=cfg.qkv_bias, dtype=dtype),
        "wv": layers.linear_init(generator, cfg.d_model, cfg.n_kv_heads * dh,
                                 bias=cfg.qkv_bias, dtype=dtype),
        "wo": layers.linear_init(generator, cfg.n_heads * dh, cfg.d_model, dtype=dtype),
    }


def attention_apply(params: dict, x: torch.Tensor, cfg, *,
                    positions: torch.Tensor | None = None, causal: bool = True,
                    proj: torch.Tensor | None = None):
    """Self-attention for prefill.  Returns ``(out, (k, v))`` with the raw
    per-head K/V (B, Hkv, N, dh) so the serve layer can build caches."""
    b, n, _ = x.shape
    q = _split_heads(layers.linear_apply(params["wq"], x), cfg.n_heads)
    k = _split_heads(layers.linear_apply(params["wk"], x), cfg.n_kv_heads)
    v = _split_heads(layers.linear_apply(params["wv"], x), cfg.n_kv_heads)
    if positions is None:
        positions = torch.arange(n, device=x.device).expand(b, n)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    o = attend(q, k, v, cfg.attention, causal=causal, proj=proj)
    out = layers.linear_apply(params["wo"], _merge_heads(o))
    return out, (k, v)


def _as_pos_vector(cache_index, b: int, device) -> torch.Tensor:
    idx = torch.as_tensor(cache_index, dtype=torch.int64, device=device)
    return idx.expand(b) if idx.ndim == 0 else idx


def cache_insert(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write per-batch rows at per-batch positions, in place (ring layout).

    cache: (B, H, S, d); new: (B, H, 1, d); pos: (B,) absolute positions —
    the write slot is ``pos mod S``.  Returns ``cache``.
    """
    b, _, s, _ = cache.shape
    rows = torch.arange(b, device=cache.device)
    cache[rows, :, pos.to(torch.int64) % s] = new[:, :, 0].to(cache.dtype)
    return cache


def _live_lengths(length, pos: torch.Tensor, max_len: int) -> torch.Tensor:
    total = length if length is not None else pos + 1
    return torch.clamp(torch.as_tensor(total, dtype=torch.int32, device=pos.device),
                       max=max_len)


def attention_decode_apply(params: dict, x: torch.Tensor, cfg, *,
                           cache_k: torch.Tensor, cache_v: torch.Tensor,
                           cache_index, length: torch.Tensor | None = None):
    """One-token decode against a (B, Hkv, S, dh) ring cache: inserts the
    new K/V at ``cache_index`` (in place) and attends over the live window
    through the split-K decode kernel.  Returns ``(out, (cache_k, cache_v))``."""
    b = x.shape[0]
    pos = _as_pos_vector(cache_index, b, x.device)
    q = _split_heads(layers.linear_apply(params["wq"], x), cfg.n_heads)
    k = _split_heads(layers.linear_apply(params["wk"], x), cfg.n_kv_heads)
    v = _split_heads(layers.linear_apply(params["wv"], x), cfg.n_kv_heads)
    q = layers.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = layers.apply_rope(k, pos[:, None], cfg.rope_theta)
    cache_insert(cache_k, k, pos)
    cache_insert(cache_v, v, pos)
    lengths = _live_lengths(length, pos, cache_k.shape[2])
    o = attend_decode(q, cache_k, cache_v, cfg.attention, lengths=lengths)
    out = layers.linear_apply(params["wo"], _merge_heads(o.to(x.dtype)))
    return out, (cache_k, cache_v)
