"""Pre-norm blocks: the dense transformer block (prefill, one-token decode,
and windowed decode against the paged pool), the Mamba-2 block, and the
hybrid's shared attention block.

``layer_type`` is ``"dense"`` or ``"mamba"``.  A dense block returns its
(k, v); a Mamba block returns its (conv_state, ssm_state) when asked."""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, mamba


def norm_init(cfg, device=None) -> dict:
    if cfg.norm == "rmsnorm":
        return layers.rmsnorm_init(cfg.d_model, device)
    return layers.layernorm_init(cfg.d_model, device)


def norm_apply(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return layers.rmsnorm_apply(params, x, cfg.norm_eps)
    return layers.layernorm_apply(params, x, cfg.norm_eps)


def block_init(generator, cfg, dtype=torch.float32, layer_type: str = "dense") -> dict:
    if layer_type == "mamba":
        return {"norm1": norm_init(cfg, generator.device),
                "mixer": mamba.mamba_init(generator, cfg, dtype)}
    return {
        "norm1": norm_init(cfg, generator.device),
        "norm2": norm_init(cfg, generator.device),
        "attn": attn_mod.attention_init(generator, cfg, dtype),
        "ffn": layers.mlp_init(generator, cfg.d_model, cfg.d_ff, act=cfg.act, dtype=dtype),
    }


def block_apply(params: dict, x: torch.Tensor, cfg, *, positions=None,
                causal: bool = True, proj: torch.Tensor | None = None,
                layer_type: str = "dense", collect_cache: bool = False):
    """Full-sequence block.  Returns ``(x, (k, v))`` for a dense block, and
    ``(x, (conv_state, ssm_state))`` for a Mamba block with
    ``collect_cache`` (else ``(x, None)``)."""
    if layer_type == "mamba":
        h = norm_apply(params["norm1"], x, cfg)
        if collect_cache:
            y, states = mamba.mamba_apply(params["mixer"], h, cfg, return_state=True)
            return x + y, states
        return x + mamba.mamba_apply(params["mixer"], h, cfg), None
    h = norm_apply(params["norm1"], x, cfg)
    o, kv = attn_mod.attention_apply(params["attn"], h, cfg, positions=positions,
                                     causal=causal, proj=proj)
    x = x + o
    h2 = norm_apply(params["norm2"], x, cfg)
    return x + layers.mlp_apply(params["ffn"], h2, act=cfg.act), kv


def block_decode_apply(params: dict, x: torch.Tensor, cfg, *, cache: dict,
                       cache_index, length=None, layer_type: str = "dense",
                       perm: torch.Tensor | None = None):
    """One-token decode.  A dense block's ``cache`` holds this layer's
    ``k``/``v`` (B, Hkv, S, dh), updated in place; ``length`` is the
    per-slot live token count including the new token (None: pos + 1).
    With the layer's static ``perm`` the cache holds ``v`` and ``k_fused``
    instead, and scores read K̂ (``attention_decode_fused``).  A Mamba
    block's holds ``conv``/``ssm``, returned anew.  Returns ``(x, cache)``."""
    if layer_type == "mamba":
        y, (conv_s, ssm_s) = mamba.mamba_decode_apply(
            params["mixer"], norm_apply(params["norm1"], x, cfg), cfg,
            conv_state=cache["conv"], ssm_state=cache["ssm"],
        )
        return x + y, {**cache, "conv": conv_s, "ssm": ssm_s}
    h = norm_apply(params["norm1"], x, cfg)
    if perm is not None:
        o, (cv, ckf) = attn_mod.attention_decode_fused(
            params["attn"], h, cfg, cache_v=cache["v"], cache_k_fused=cache["k_fused"],
            perm=perm, cache_index=cache_index, length=length,
        )
        new = {"v": cv, "k_fused": ckf}
    else:
        o, (ck, cv) = attn_mod.attention_decode_apply(
            params["attn"], h, cfg, cache_k=cache["k"], cache_v=cache["v"],
            cache_index=cache_index, length=length,
        )
        new = {"k": ck, "v": cv}
    x = x + o
    h2 = norm_apply(params["norm2"], x, cfg)
    return x + layers.mlp_apply(params["ffn"], h2, act=cfg.act), {**cache, **new}


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


# ---------------------------------------------------------------------------
# Hybrid (zamba2) shared attention block: fuse(concat(x, x0)) → dense block
# ---------------------------------------------------------------------------


def shared_block_init(generator, cfg, dtype=torch.float32) -> dict:
    return {
        "fuse": layers.linear_init(generator, 2 * cfg.d_model, cfg.d_model, dtype=dtype),
        "block": block_init(generator, cfg, dtype),
    }


def shared_block_apply(params: dict, x: torch.Tensor, x0: torch.Tensor, cfg, *,
                       positions=None, proj: torch.Tensor | None = None):
    """Fuse the trunk with the embedded input ``x0``, run a dense block, and
    add only its residual delta to the trunk.  Returns ``(x, (k, v))``."""
    h = layers.linear_apply(params["fuse"], torch.cat([x, x0], dim=-1))
    y, kv = block_apply(params["block"], h, cfg, positions=positions, causal=True, proj=proj)
    return x + (y - h), kv


def shared_block_decode_apply(params: dict, x: torch.Tensor, x0: torch.Tensor, cfg, *,
                              cache: dict, cache_index):
    """One-token decode of a shared block over its site's ``k``/``v``
    cache; the live length is ``cache_index + 1``.  Returns ``(x, cache)``."""
    h = layers.linear_apply(params["fuse"], torch.cat([x, x0], dim=-1))
    y, new_cache = block_decode_apply(params["block"], h, cfg, cache=cache,
                                      cache_index=cache_index)
    return x + (y - h), new_cache
