"""Dense pre-norm transformer block (prefill, one-token decode, and windowed
decode against the paged pool)."""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers


def norm_init(cfg, device=None) -> dict:
    if cfg.norm == "rmsnorm":
        return layers.rmsnorm_init(cfg.d_model, device)
    return layers.layernorm_init(cfg.d_model, device)


def norm_apply(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return layers.rmsnorm_apply(params, x, cfg.norm_eps)
    return layers.layernorm_apply(params, x, cfg.norm_eps)


def block_init(generator, cfg, dtype=torch.float32) -> dict:
    return {
        "norm1": norm_init(cfg, generator.device),
        "norm2": norm_init(cfg, generator.device),
        "attn": attn_mod.attention_init(generator, cfg, dtype),
        "ffn": layers.mlp_init(generator, cfg.d_model, cfg.d_ff, act=cfg.act, dtype=dtype),
    }


def block_apply(params: dict, x: torch.Tensor, cfg, *, positions=None,
                causal: bool = True, proj: torch.Tensor | None = None):
    """Full-sequence block.  Returns ``(x, (k, v))``."""
    h = norm_apply(params["norm1"], x, cfg)
    o, kv = attn_mod.attention_apply(params["attn"], h, cfg, positions=positions,
                                     causal=causal, proj=proj)
    x = x + o
    h2 = norm_apply(params["norm2"], x, cfg)
    return x + layers.mlp_apply(params["ffn"], h2, act=cfg.act), kv


def block_decode_apply(params: dict, x: torch.Tensor, cfg, *, cache: dict,
                       cache_index, length=None):
    """One-token decode.  ``cache`` holds this layer's ``k``/``v``
    (B, Hkv, S, dh), updated in place; ``length`` is the per-slot live
    token count including the new token.  Returns ``(x, cache)``."""
    h = norm_apply(params["norm1"], x, cfg)
    o, (ck, cv) = attn_mod.attention_decode_apply(
        params["attn"], h, cfg, cache_k=cache["k"], cache_v=cache["v"],
        cache_index=cache_index, length=length,
    )
    x = x + o
    h2 = norm_apply(params["norm2"], x, cfg)
    return x + layers.mlp_apply(params["ffn"], h2, act=cfg.act), {**cache, "k": ck, "v": cv}


def block_paged_decode_apply(params: dict, x: torch.Tensor, cfg, *, pool_k, pool_v,
                             block_tables, pos, count=None, pool_k_fused=None, perm=None):
    """Windowed decode of one block against the paged pool (w = 1: a decode
    tick; w = the chunk width: chunked prefill).  Pools are updated in
    place.  Returns ``(x, (pool_k, pool_v, pool_k_fused))``."""
    h = norm_apply(params["norm1"], x, cfg)
    o, pools = attn_mod.attention_decode_paged(
        params["attn"], h, cfg, pool_k=pool_k, pool_v=pool_v, block_tables=block_tables,
        cache_index=pos, count=count, pool_k_fused=pool_k_fused, perm=perm,
    )
    x = x + o
    h2 = norm_apply(params["norm2"], x, cfg)
    return x + layers.mlp_apply(params["ffn"], h2, act=cfg.act), pools
