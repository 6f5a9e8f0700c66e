"""The slot engine's cache layouts per family, and the static permutations
of the fused-K̂ decode cache.

Layouts (L = layers, B = slots, S = max_len, G = hybrid groups):
  dense, moe (GQA):  ``k``, ``v`` (L, B, Hkv, S, dh) and ``length`` (B,)
          int32; for dense under ``attention.distr_decode`` also ``k_fused``
          (L, B, Hkv, S, dh/G*) (a moe config decodes from raw K, so it
          keeps none)
  mla:    ``ckv`` (L, B, S, kv_lora), ``krope`` (L, B, S, rope_d)
  ssm:    ``conv`` (L, B, k−1, conv_dim), ``ssm`` (L, B, H, S_state, P) f32
  hybrid: ``groups_conv`` (G, attn_every, B, k−1, conv_dim), ``groups_ssm``
          (G, attn_every, B, H, S_state, P) f32, ``shared_k`` / ``shared_v``
          (G, B, Hkv, S, dh) for the shared block after each group, and
          ``tail_conv`` / ``tail_ssm`` for the Mamba layers past the last group
  encdec: ``k``, ``v`` (L, B, Hkv, S, dh) of the decoder's self-attention,
          ``cross_k`` / ``cross_v`` (L, B, Hkv, cross_len, dh), the encoder
          output's keys and values a decoder layer, and ``cross_len`` (B,)
          int32, the live encoder positions a slot

The GQA cache is a ring: writes land at ``pos mod S``; ``length`` counts
every token ever written, so the live window is the most recent
``min(length, S)`` tokens and RoPE positions stay absolute.  The MLA, ssm,
hybrid and encdec layouts have no ``length``: their sequences finish before
the window would wrap (encdec decodes over ``pos + 1`` positions).

On a mesh (``cache_pspecs``, the reference's specs) the batch shards over
the data-parallel axes and the cache's heads or positions over "model" by
``cfg.attn_shard``: under "seq" every KV head for S/model positions
(flash-decoding across the ranks), under "heads" the rank's KV heads; MLA's
positions, the SSM state's heads and the conv state's channels lie over
"model" too.  ``local_cache`` cuts a rank's cache out of a whole one.

The fused-K̂ decode cache holds K̂ = fuse(K, perm) under one static
permutation per (layer, KV head): decode scores read d/G* columns a token
in place of d, and raw K is no longer written at decode (it stays as the
prefill left it).
"""
from __future__ import annotations

import torch

from repro_torch.core import grouping
from repro_torch.models.lm import hybrid_layout
from repro_torch.models.mamba import conv_dim


def cache_struct(cfg, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
    """The cache tree's shapes and dtypes without an allocation: tensors on
    the ``meta`` device (the reference's ``ShapeDtypeStruct`` tree)."""
    def spec(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    conv = (cfg.ssm_conv - 1, conv_dim(cfg))
    ssm = (cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    if cfg.family == "ssm":
        return {"conv": spec((cfg.n_layers, batch) + conv),
                "ssm": spec((cfg.n_layers, batch) + ssm, torch.float32)}
    if cfg.use_mla:
        return {"ckv": spec((cfg.n_layers, batch, max_len, cfg.kv_lora_rank)),
                "krope": spec((cfg.n_layers, batch, max_len, cfg.qk_rope_dim))}
    kv = (cfg.n_kv_heads, max_len, cfg.head_dim_)
    if cfg.family == "encdec":
        cross = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.cross_len, cfg.head_dim_)
        return {"k": spec((cfg.n_layers, batch) + kv), "v": spec((cfg.n_layers, batch) + kv),
                "cross_k": spec(cross), "cross_v": spec(cross),
                "cross_len": spec((batch,), torch.int32)}
    if cfg.family == "hybrid":
        g, t = hybrid_layout(cfg)
        cache = {
            "groups_conv": spec((g, cfg.attn_every, batch) + conv),
            "groups_ssm": spec((g, cfg.attn_every, batch) + ssm, torch.float32),
            "shared_k": spec((g, batch) + kv),
            "shared_v": spec((g, batch) + kv),
        }
        if t:
            cache["tail_conv"] = spec((t, batch) + conv)
            cache["tail_ssm"] = spec((t, batch) + ssm, torch.float32)
        return cache
    cache = {
        "k": spec((cfg.n_layers, batch) + kv),
        "v": spec((cfg.n_layers, batch) + kv),
        "length": spec((batch,), torch.int32),
    }
    if cfg.attention.distr_decode and cfg.family == "dense":
        g = cfg.attention.distr.group_size
        cache["k_fused"] = spec((cfg.n_layers, batch, cfg.n_kv_heads, max_len,
                                 cfg.head_dim_ // g))
    return cache


def cache_pspecs(cfg, mesh, *, batch: int = 0, max_len: int = 0) -> dict:
    """The partition spec (``distributed.sharding.P``) of each cache key:
    the batch over every axis but "model"; the sequence or head dim over
    "model" by ``cfg.attn_shard`` (flash-decoding style for "seq").  An
    assignment that does not divide its cache dim (batch 1 of long_500k,
    say) is dropped; pass ``batch`` and ``max_len`` to check.  The
    reference's ``cache_pspecs``, key for key; ``mesh`` needs only
    ``axis_names`` and ``shape``."""
    from repro_torch.distributed.sharding import P

    dp = tuple(a for a in mesh.axis_names if a != "model")
    seq_sharded = cfg.attn_shard == "seq"

    def spec_for(key: str, ndim: int) -> P:
        if key in ("k", "v", "cross_k", "cross_v", "k_fused"):  # (L, B, Hkv, S, dh)
            return (P(None, dp, None, "model", None) if seq_sharded else
                    P(None, dp, "model", None, None))
        if key in ("ckv", "krope"):  # (L, B, S, C)
            return P(None, dp, "model", None)
        if key in ("ssm", "tail_ssm"):  # (L, B, H, S, P)
            return P(None, dp, "model", None, None)
        if key in ("conv", "tail_conv"):  # (L, B, k-1, conv_dim)
            return P(None, dp, None, "model")
        if key == "groups_ssm":  # (G, per, B, H, S, P)
            return P(None, None, dp, "model", None, None)
        if key == "groups_conv":  # (G, per, B, k-1, conv_dim)
            return P(None, None, dp, None, "model")
        if key in ("shared_k", "shared_v"):  # (G, B, Hkv, S, dh)
            return P(None, dp, "model", None, None)
        return P(*([None] * ndim))

    struct = cache_struct(cfg, max(batch, 1), max(max_len, 2))
    axis_size = {a: int(mesh.shape[a]) for a in mesh.axis_names}

    def prune(spec: P, shape: tuple) -> P:
        entries = []
        for i, s in enumerate(spec):
            need = 1
            for a in (() if s is None else s if isinstance(s, tuple) else (s,)):
                need *= axis_size.get(a, 1)
            entries.append(None if s is None or (batch and shape[i] % need) else s)
        return P(*entries)

    return {k: prune(spec_for(k, v.ndim), tuple(v.shape)) for k, v in struct.items()}


def local_cache(cache: dict, cfg, mesh, *, batch: int, max_len: int) -> dict:
    """This rank's blocks of a whole cache (views) under ``cache_pspecs``."""
    from repro_torch.distributed.sharding import local_slice

    specs = cache_pspecs(cfg, mesh, batch=batch, max_len=max_len)
    return {k: local_slice(v, mesh, specs[k]) for k, v in cache.items()}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    """``cache_struct``'s tree as zeros on ``device``."""
    return {name: torch.zeros(t.shape, dtype=t.dtype, device=device)
            for name, t in cache_struct(cfg, batch, max_len, dtype).items()}


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
