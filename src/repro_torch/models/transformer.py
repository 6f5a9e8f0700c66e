"""Pre-norm blocks: the transformer block (prefill, one-token decode, and
windowed decode against the paged pool), the Mamba-2 block, and the
hybrid's shared attention block.

``layer_type`` is ``"dense"`` (a dense FFN), ``"moe"`` (the MoE FFN of
``models.moe``) or ``"mamba"``.  A transformer block's attention is GQA, or
MLA under ``cfg.use_mla``; it returns its cache parts: (k, v) for GQA,
(c_kv, k_rope) for MLA.  A Mamba block returns its (conv_state, ssm_state)
when asked.  ``block_apply_aux`` also returns the block's MoE aux loss
(None for the other layer types), where the reference's ``block_apply``
returns it.  An enc-dec decoder block (``block_init(cross=True)``) adds
``norm_cross`` and ``cross_attn``: a non-causal cross-attention without
RoPE over the encoder output, after the self-attention."""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, mamba, moe


def norm_init(cfg, device=None) -> dict:
    if cfg.norm == "rmsnorm":
        return layers.rmsnorm_init(cfg.d_model, device)
    return layers.layernorm_init(cfg.d_model, device)


def norm_axes(cfg) -> dict:
    return layers.rmsnorm_axes() if cfg.norm == "rmsnorm" else layers.layernorm_axes()


def norm_apply(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return layers.rmsnorm_apply(params, x, cfg.norm_eps)
    return layers.layernorm_apply(params, x, cfg.norm_eps)


def block_init(generator, cfg, dtype=torch.float32, layer_type: str = "dense", *,
               cross: bool = False) -> dict:
    if layer_type == "mamba":
        return {"norm1": norm_init(cfg, generator.device),
                "mixer": mamba.mamba_init(generator, cfg, dtype)}
    attn_init = attn_mod.mla_init if cfg.use_mla else attn_mod.attention_init
    params = {
        "norm1": norm_init(cfg, generator.device),
        "norm2": norm_init(cfg, generator.device),
        "attn": attn_init(generator, cfg, dtype),
    }
    if cross:
        params["norm_cross"] = norm_init(cfg, generator.device)
        params["cross_attn"] = attn_mod.attention_init(generator, cfg, dtype)
    params["ffn"] = (moe.moe_init(generator, cfg, dtype) if layer_type == "moe" else
                     layers.mlp_init(generator, cfg.d_model, cfg.d_ff, act=cfg.act,
                                     dtype=dtype))
    return params


def block_axes(cfg, layer_type: str = "dense", *, cross: bool = False) -> dict:
    if layer_type == "mamba":
        return {"norm1": norm_axes(cfg), "mixer": mamba.mamba_axes(cfg)}
    axes = {"norm1": norm_axes(cfg), "norm2": norm_axes(cfg),
            "attn": (attn_mod.mla_axes if cfg.use_mla else attn_mod.attention_axes)(cfg)}
    if cross:
        axes["norm_cross"] = norm_axes(cfg)
        axes["cross_attn"] = attn_mod.attention_axes(cfg)
    axes["ffn"] = (moe.moe_axes(cfg) if layer_type == "moe" else
                   layers.mlp_axes(act=cfg.act))
    return axes


def ffn_apply(params: dict, h: torch.Tensor, cfg, layer_type: str, *, decode: bool = False):
    """The block's FFN → (y, aux): the MoE's aux loss, or None.  ``decode``
    tells the MoE a decode step is calling (its dispatch under expert
    parallelism)."""
    if layer_type == "moe":
        return moe.moe_apply(params, h, cfg, decode=decode)
    return layers.mlp_apply(params, h, act=cfg.act, d_ff=cfg.d_ff), None


def block_apply_aux(params: dict, x: torch.Tensor, cfg, *, positions=None,
                    causal: bool = True, proj: torch.Tensor | None = None,
                    layer_type: str = "dense", collect_cache: bool = False,
                    enc_out: torch.Tensor | None = None):
    """Full-sequence block → ``(x, aux, parts)``: ``aux`` the MoE aux loss
    (None for a dense or Mamba block); ``parts`` (k, v) for GQA, (c_kv,
    k_rope) for MLA, and for a Mamba block (conv_state, ssm_state) with
    ``collect_cache`` (else None).  With ``enc_out`` (B, N_enc, D) an
    enc-dec decoder block cross-attends to it after its self-attention."""
    if layer_type == "mamba":
        h = norm_apply(params["norm1"], x, cfg)
        if collect_cache:
            y, states = mamba.mamba_apply(params["mixer"], h, cfg, return_state=True)
            return x + y, None, states
        return x + mamba.mamba_apply(params["mixer"], h, cfg), None, None
    h = norm_apply(params["norm1"], x, cfg)
    attn = attn_mod.mla_apply if cfg.use_mla else attn_mod.attention_apply
    o, kv = attn(params["attn"], h, cfg, positions=positions, causal=causal, proj=proj)
    x = x + o
    if enc_out is not None:
        hc = norm_apply(params["norm_cross"], x, cfg)
        oc, _ = attn_mod.attention_apply(params["cross_attn"], hc, cfg, causal=False,
                                         proj=proj, x_kv=enc_out, use_rope=False)
        x = x + oc
    y, aux = ffn_apply(params["ffn"], norm_apply(params["norm2"], x, cfg), cfg, layer_type)
    x = x + y
    # The reference's sequence-parallel residual stream hint (a no-op here).
    return layers.constrain(x, "data", "model" if x.shape[1] > 1 else None, None), aux, kv


def block_apply(params: dict, x: torch.Tensor, cfg, *, positions=None,
                causal: bool = True, proj: torch.Tensor | None = None,
                layer_type: str = "dense", collect_cache: bool = False,
                enc_out: torch.Tensor | None = None):
    """``block_apply_aux`` without the aux: ``(x, parts)``."""
    x, _, parts = block_apply_aux(params, x, cfg, positions=positions, causal=causal,
                                  proj=proj, layer_type=layer_type,
                                  collect_cache=collect_cache, enc_out=enc_out)
    return x, parts


def block_decode_apply(params: dict, x: torch.Tensor, cfg, *, cache: dict,
                       cache_index, length=None, layer_type: str = "dense",
                       perm: torch.Tensor | None = None, cross_len=None,
                       layout: str = "whole", cross_layout: str = "whole"):
    """One-token decode.  A GQA block's ``cache`` holds this layer's
    ``k``/``v`` (B, Hkv, S, dh), updated in place; ``length`` is the
    per-slot live token count including the new token (None: pos + 1).
    With the layer's static ``perm`` the cache holds ``v`` and ``k_fused``
    instead, and scores read K̂ (``attention_decode_fused``).  An MLA
    block's holds ``ckv``/``krope`` (B, S, ·), updated in place.  A Mamba
    block's holds ``conv``/``ssm``, returned anew.  An enc-dec decoder
    block's also holds ``cross_k``/``cross_v`` (B, Hkv, S_enc, dh), which it
    reads over ``min(cross_len, S_enc)`` positions a slot and never writes.
    ``layout`` and ``cross_layout`` are how a GQA self and cross cache lie
    over "model" (``attention.cache_layout``); an MLA cache's positions lie
    by ``layout``.  Returns ``(x, cache)``."""
    if layer_type == "mamba":
        y, (conv_s, ssm_s) = mamba.mamba_decode_apply(
            params["mixer"], norm_apply(params["norm1"], x, cfg), cfg,
            conv_state=cache["conv"], ssm_state=cache["ssm"],
        )
        return x + y, {**cache, "conv": conv_s, "ssm": ssm_s}
    h = norm_apply(params["norm1"], x, cfg)
    if cfg.use_mla:
        o, (ckv, krope) = attn_mod.mla_decode_apply(
            params["attn"], h, cfg, cache_ckv=cache["ckv"], cache_krope=cache["krope"],
            cache_index=cache_index, layout=layout,
        )
        new = {"ckv": ckv, "krope": krope}
    elif perm is not None:
        o, (cv, ckf) = attn_mod.attention_decode_fused(
            params["attn"], h, cfg, cache_v=cache["v"], cache_k_fused=cache["k_fused"],
            perm=perm, cache_index=cache_index, length=length, layout=layout,
        )
        new = {"v": cv, "k_fused": ckf}
    else:
        o, (ck, cv) = attn_mod.attention_decode_apply(
            params["attn"], h, cfg, cache_k=cache["k"], cache_v=cache["v"],
            cache_index=cache_index, length=length, layout=layout,
        )
        new = {"k": ck, "v": cv}
    x = x + o
    if "cross_k" in cache:
        hc = norm_apply(params["norm_cross"], x, cfg)
        oc, _ = attn_mod.attention_decode_apply(
            params["cross_attn"], hc, cfg, cache_k=cache["cross_k"], cache_v=cache["cross_v"],
            cache_index=cache_index, is_cross=True, cross_len=cross_len, layout=cross_layout,
        )
        x = x + oc
    y, _ = ffn_apply(params["ffn"], norm_apply(params["norm2"], x, cfg), cfg, layer_type,
                     decode=True)
    return x + y, {**cache, **new}


def block_paged_decode_apply(params: dict, x: torch.Tensor, cfg, *, pool_k, pool_v,
                             block_tables, pos, count=None, pool_k_fused=None, perm=None,
                             layer_type: str = "dense"):
    """Windowed decode of one GQA block (dense or MoE FFN) against the
    paged pool (w = 1: a decode tick; w = the chunk width: chunked
    prefill).  Pools are updated in place.  Returns ``(x, (pool_k, pool_v,
    pool_k_fused))``."""
    h = norm_apply(params["norm1"], x, cfg)
    o, pools = attn_mod.attention_decode_paged(
        params["attn"], h, cfg, pool_k=pool_k, pool_v=pool_v, block_tables=block_tables,
        cache_index=pos, count=count, pool_k_fused=pool_k_fused, perm=perm,
    )
    x = x + o
    y, _ = ffn_apply(params["ffn"], norm_apply(params["norm2"], x, cfg), cfg, layer_type,
                     decode=True)
    return x + y, pools


# ---------------------------------------------------------------------------
# Hybrid (zamba2) shared attention block: fuse(concat(x, x0)) → dense block
# ---------------------------------------------------------------------------


def shared_block_init(generator, cfg, dtype=torch.float32) -> dict:
    return {
        "fuse": layers.linear_init(generator, 2 * cfg.d_model, cfg.d_model, dtype=dtype),
        "block": block_init(generator, cfg, dtype),
    }


def shared_block_axes(cfg) -> dict:
    return {"fuse": layers.linear_axes(None, None), "block": block_axes(cfg)}


def shared_block_apply(params: dict, x: torch.Tensor, x0: torch.Tensor, cfg, *,
                       positions=None, proj: torch.Tensor | None = None):
    """Fuse the trunk with the embedded input ``x0``, run a dense block, and
    add only its residual delta to the trunk.  Returns ``(x, (k, v))``."""
    h = layers.linear_apply(params["fuse"], torch.cat([x, x0], dim=-1))
    y, kv = block_apply(params["block"], h, cfg, positions=positions, causal=True, proj=proj)
    return x + (y - h), kv


def shared_block_decode_apply(params: dict, x: torch.Tensor, x0: torch.Tensor, cfg, *,
                              cache: dict, cache_index, layout: str = "whole"):
    """One-token decode of a shared block over its site's ``k``/``v``
    cache; the live length is ``cache_index + 1``.  Returns ``(x, cache)``."""
    h = layers.linear_apply(params["fuse"], torch.cat([x, x0], dim=-1))
    y, new_cache = block_decode_apply(params["block"], h, cfg, cache=cache,
                                      cache_index=cache_index, layout=layout)
    return x + (y - h), new_cache
