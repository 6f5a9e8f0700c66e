"""Serving steps for the dense family: prefill (build the cache from a full
forward) and one-token decode over the ring cache.

The decode step updates the cache's K/V in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm, transformer


def _pad_seq_to(x: torch.Tensor, max_len: int, dim: int) -> torch.Tensor:
    pad = max_len - x.shape[dim]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def make_prefill(cfg, max_len: int):
    """→ prefill(params, tokens (B, N)) → (logits (B, 1, V) of the last
    position, cache ready for decode at position N)."""

    @torch.no_grad()
    def prefill(params, tokens):
        hidden, kvs = lm.backbone(params, cfg, tokens, collect_cache=True)
        logits = lm.logits_fn(params, cfg, hidden[:, -1:])
        dtype = lm.compute_dtype(cfg)
        k = torch.stack([kv[0] for kv in kvs]).to(dtype)  # (L, B, Hkv, N, dh)
        v = torch.stack([kv[1] for kv in kvs]).to(dtype)
        cache = {
            "k": _pad_seq_to(k, max_len, 3),
            "v": _pad_seq_to(v, max_len, 3),
            # The whole prompt is live; the engine overrides this for
            # right-padded prompts.
            "length": torch.full((tokens.shape[0],), k.shape[3], dtype=torch.int32,
                                 device=tokens.device),
        }
        return logits, cache

    return prefill


def make_decode_step(cfg):
    """→ decode_step(params, tokens (B, 1), cache, pos (B,)) → (logits
    (B, 1, V), cache).  Each slot writes its token at ``pos mod S``; the
    live length becomes ``min(max(length, pos + 1), S)``."""

    @torch.no_grad()
    def decode_step(params, tokens, cache, pos):
        x = lm.embed(params, cfg, tokens)
        pos = pos.to(torch.int32)
        max_len = cache["k"].shape[3]
        total = torch.maximum(cache["length"], pos + 1)
        length = torch.clamp(total, max=max_len)
        for i, lp in enumerate(params["blocks"]):
            x, _ = transformer.block_decode_apply(
                lp, x, cfg, cache={"k": cache["k"][i], "v": cache["v"][i]},
                cache_index=pos, length=length,
            )
        x = transformer.norm_apply(params["final_norm"], x, cfg)
        return lm.logits_fn(params, cfg, x), {**cache, "length": total}

    return decode_step
