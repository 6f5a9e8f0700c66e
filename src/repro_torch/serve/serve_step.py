"""Serving steps: prefill (build the cache from a full forward) and
one-token decode for the dense (ring cache, raw K or fused K̂), moe (GQA
ring cache of raw K, or MLA's compressed cache), ssm, hybrid and encdec
(self-attention ring cache and the encoder's cross cache) families, a
``patch_stub`` model's prefill taking its patch prefix;
for GQA dense and moe also the paged step (a decode tick or a
chunked-prefill window over the block pool) and the whole-prompt paged
prefills of the degradation dial and of a mesh engine.  A moe config decodes from raw K even with
``attention.distr_decode`` set: the fused K̂ engages for dense only, as in
the reference.

Steps update caches and pools in place.

Tensor-parallel serving (``make_prefill(mesh=)``, ``make_decode_step(mesh=)``
with a "model" axis): the params are this rank's shards
(``distributed.sharding.shard_params`` under ``train_step.mesh_specs``), the
tokens and positions this rank's rows of the batch, and each rank's cache
is its block of one device's cache under ``kv_cache.cache_pspecs``: the
prefill moves K/V from the heads its layers ran to the cache's layout (an
all-to-all over "model" from heads to positions under "seq", this rank's
slice where a layer ran whole or sharded the sequence, whose positions are
all-gathered first), and the decode writes and attends as
``models.attention`` describes.  The logits come back whole, gathered over
"model" from the vocab-parallel head.  The replicated ``length`` vector
holds the whole batch: a step reads its own rows and all-gathers the new
counts over the data-parallel axes.  MLA's compressed cache lies by
positions over "model" and its absorbed decode merges the ranks' stats as
the GQA decode does; the enc-dec cross cache lies as the self cache.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import grouping
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import set_mesh
from repro_torch.models import layers, lm, transformer
from repro_torch.models.attention import (_split_heads, cache_layout, heads_to_run,
                                          local_heads, paged_insert, seq_mesh)
from repro_torch.serve import kv_cache
from repro_torch.serve.paged import check_pageable
from repro_torch.tune.autotune import sweeps_refused, warm_decode


def _pad_seq_to(x: torch.Tensor, max_len: int, dim: int) -> torch.Tensor:
    pad = max_len - x.shape[dim]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _stack_states(states: list, dtype: torch.dtype):
    """Per-layer (conv_state, ssm_state) → (conv (L, B, ...) in ``dtype``,
    ssm (L, B, ...) f32)."""
    return (torch.stack([c for c, _ in states]).to(dtype),
            torch.stack([s for _, s in states]))


def _mamba_prefill_cache(cfg, parts, max_len: int, dtype: torch.dtype) -> dict:
    if cfg.family == "ssm":
        conv, ssm = _stack_states(parts, dtype)
        return {"conv": conv, "ssm": ssm}
    groups = [_stack_states(states, dtype) for states in parts["groups"]]
    cache = {
        "groups_conv": torch.stack([c for c, _ in groups]),  # (G, attn_every, B, ...)
        "groups_ssm": torch.stack([s for _, s in groups]),
        "shared_k": _pad_seq_to(torch.stack([k for k, _ in parts["shared_kv"]]).to(dtype),
                                max_len, 3),
        "shared_v": _pad_seq_to(torch.stack([v for _, v in parts["shared_kv"]]).to(dtype),
                                max_len, 3),
    }
    if parts["tail"]:
        cache["tail_conv"], cache["tail_ssm"] = _stack_states(parts["tail"], dtype)
    return cache


def _cross_cache(cfg, params: dict, enc_out: torch.Tensor, dtype: torch.dtype,
                 mesh=None) -> dict:
    """The encoder output's keys and values a decoder layer, projected by its
    ``cross_attn`` and zero-padded or cut to ``cross_len`` positions
    (``cross_k`` / ``cross_v`` (L, B, Hkv, cross_len, dh); on a "model"
    ``mesh`` this rank's block of them), and each slot's live count
    ``cross_len`` (B,) = min(N_enc, cfg.cross_len)."""
    n = cfg.cross_len
    parts = {"wk": [], "wv": []}
    for lp in params["blocks"]:
        attn, _, hkv, heads_mesh = heads_to_run(sharding.gather_on_use(lp["cross_attn"]), cfg)
        for w in parts:
            parts[w].append(_split_heads(layers.linear_apply(attn[w], enc_out), hkv).to(dtype))
    ck, cv = (_pad_seq_to(torch.stack(parts[w]), n, 3)[:, :, :, :n] for w in ("wk", "wv"))
    b, n_enc = enc_out.shape[:2]
    if mesh is not None:
        layout = cache_layout(cfg, mesh, "cross_k", n)
        ck, cv = (_kv_layout(t, heads_mesh, layout, mesh, n) for t in (ck, cv))
    return {"cross_k": ck, "cross_v": cv,
            "cross_len": _replicated_rows(torch.full((b,), min(n_enc, n), dtype=torch.int32,
                                                     device=enc_out.device), mesh)}


def _model_size(mesh) -> int:
    return coll.axis_size(mesh, "model") if mesh is not None else 1


def _mesh_specs(cfg, mesh):
    if mesh is None:
        return None
    from repro_torch.train.train_step import mesh_specs

    return mesh_specs(cfg, mesh)


def _scope(mesh, params: dict, specs):
    """The step's context on ``mesh``: the mesh active, and the FSDP leaves
    of ``params`` under ``specs`` (``train_step.mesh_specs``) gathered on
    use."""
    if mesh is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(set_mesh(mesh))
    stack.enter_context(sharding.fsdp_gathering(mesh, params, specs))
    return stack


def _gathered_top(params: dict) -> dict:
    """``params`` with its non-layer leaves gathered on use (FSDP)."""
    return {**params, **sharding.gather_on_use(
        {k: v for k, v in params.items() if k not in lm.LAYER_KEYS})}


def full_logits(params: dict, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """``lm.logits_fn`` with the whole vocab: a vocab-parallel head's
    columns all-gathered over "model"."""
    logits = lm.logits_fn(params, cfg, hidden)
    mesh = layers.tp_mesh(logits.shape[-1], cfg.padded_vocab)
    return logits if mesh is None else coll.all_gather(logits, mesh, "model", logits.ndim - 1)


def _kv_layout(kv: torch.Tensor, heads_mesh, layout: str, mesh, max_len: int) -> torch.Tensor:
    """Stacked K or V (L, B, h, N, dh), ``h`` this rank's heads under a
    heads-parallel ``heads_mesh`` (else every head), → the cache's block
    (L, B, ·, ·, dh) under ``layout``, zero-padded to ``max_len``
    positions."""
    kv = _pad_seq_to(kv, max_len, 3)
    if heads_mesh is not None:
        if layout == "heads":
            return kv
        m = _model_size(mesh)
        if layout == "whole":
            return coll.all_gather(kv, mesh, "model", 2)
        l, b, h, s, dh = kv.shape
        parts = kv.reshape(l, b, h, m, s // m, dh).permute(3, 0, 1, 2, 4, 5)
        got = coll.all_to_all(parts.contiguous(), mesh, "model")  # chunk i: rank i's heads
        return got.permute(1, 2, 0, 3, 4, 5).reshape(l, b, m * h, s // m, dh)
    if layout == "whole":
        return kv
    return sharding.local_slice(kv, mesh, (None, None, "model" if layout == "heads" else None,
                                           "model" if layout == "seq" else None, None))


def _model_blocks(cache: dict, cfg, mesh, batch: int, max_len: int) -> dict:
    """This rank's blocks over "model" (``kv_cache.cache_pspecs``, pruned
    as for ``batch`` rows) of a cache replicated over "model" whose batch
    rows are already this rank's, each block a tensor of its own."""
    specs = kv_cache.cache_pspecs(cfg, mesh, batch=batch, max_len=max_len)
    return {k: sharding.local_slice(v, mesh, tuple(e if e == "model" else None
                                                  for e in specs[k])).contiguous()
            for k, v in cache.items()}


def _replicated_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """A (B_local,) vector of this rank's rows → the whole batch's
    (all-gathered over the data-parallel axes)."""
    if mesh is None:
        return x
    return coll.all_gather(x, mesh, sharding.dp_axes(mesh), 0)


def make_prefill(cfg, max_len: int, backbone_cfg=None, perms: torch.Tensor | None = None,
                 *, mesh=None):
    """→ prefill(params, tokens (B, N), patches=None, frames=None) →
    (logits (B, 1, V) of the last position, cache ready for decode at
    position N, or N + P after a patch prefix of P rows).  For ssm / hybrid
    the SSM state is the state after all N tokens, padding included.  An
    enc-dec model encodes ``frames`` and its cache adds the cross cache
    (``_cross_cache``); it has no ``length``: its decode attends over
    ``pos + 1`` positions.

    ``backbone_cfg`` (default ``cfg``) runs the forward alone: the slot
    engine's degradation dial passes ``cfg.attention.degraded(G*)`` there,
    while the cache layout stays the engine's own.  Under
    ``attention.distr_decode`` a dense cache also holds ``k_fused`` (f32),
    K fused at the engine's own G* under its static ``perms`` (see
    ``_resolve_perms``), whatever attention ``backbone_cfg`` ran.

    With ``mesh`` the step runs tensor parallel (see the module docstring):
    ``tokens`` and ``patches`` are this rank's rows and the cache comes back
    as this rank's block under ``kv_cache.cache_pspecs``."""
    bcfg = cfg if backbone_cfg is None else backbone_cfg
    perms = _resolve_perms(cfg, perms)
    specs = _mesh_specs(cfg, mesh)

    def prefill(params, tokens, patches=None, frames=None):
        with _scope(mesh, params, specs):
            return step(params, tokens, patches, frames)

    @torch.no_grad()
    def step(params, tokens, patches=None, frames=None):
        nonlocal perms
        hidden, kvs = lm.backbone(params, bcfg, tokens, patches=patches, frames=frames,
                                  collect_cache=True)
        logits = full_logits(params, cfg, hidden[:, -1:])
        dtype = lm.compute_dtype(cfg)
        if cfg.family in ("ssm", "hybrid"):
            cache = _mamba_prefill_cache(cfg, kvs, max_len, dtype)
            if _model_size(mesh) > 1:
                shared = {k: cache.pop(k) for k in ("shared_k", "shared_v") if k in cache}
                cache = _model_blocks(cache, cfg, mesh, tokens.shape[0], max_len)
                if shared:
                    heads_mesh = local_heads(params["shared"][0]["block"]["attn"], cfg)[2]
                    layout = cache_layout(cfg, mesh, "shared_k", max_len)
                    cache.update({k: _kv_layout(t, heads_mesh, layout, mesh, max_len)
                                  for k, t in shared.items()})
            return logits, cache
        if cfg.use_mla:
            ckv = torch.stack([c for c, _ in kvs]).to(dtype)  # (L, B, N, kv_lora)
            krope = torch.stack([r[:, 0] for _, r in kvs]).to(dtype)  # (L, B, N, rope_d)
            cache = {"ckv": _pad_seq_to(ckv, max_len, 2), "krope": _pad_seq_to(krope, max_len, 2)}
            if _model_size(mesh) > 1:  # c_kv and k_rope are replicated over "model"
                cache = _model_blocks(cache, cfg, mesh, tokens.shape[0], max_len)
            return logits, cache
        cross = None
        if cfg.family == "encdec":
            cross = _cross_cache(cfg, params, kvs["enc_out"], dtype,
                                 mesh if _model_size(mesh) > 1 else None)
            kvs = kvs["kv"]
        k = torch.stack([kv[0] for kv in kvs]).to(dtype)  # (L, B, Hkv, N, dh)
        v = torch.stack([kv[1] for kv in kvs]).to(dtype)
        n = hidden.shape[1]
        ring_mesh = seq_mesh(bcfg, n)
        if ring_mesh is not None:
            # The "seq" layout's K/V are this rank's positions (B, Hkv, s,
            # dh): gathered over "model" and cut to N, then taken as the
            # cache's block below like a layer that ran whole.
            k, v = (coll.all_gather(t, ring_mesh, "model", 3)[:, :, :, :n] for t in (k, v))
            heads_mesh = None
        else:
            heads_mesh = local_heads(lm.decoder_layers(params, cfg)[0][1]["attn"], cfg)[2]
        layout = cache_layout(cfg, mesh, max_len=max_len)
        k, v = (_kv_layout(t, heads_mesh, layout, mesh, max_len) for t in (k, v))
        cache = {"k": k, "v": v}
        if cross is not None:
            return logits, {**cache, **cross}
        # The whole prompt is live; the engine overrides this for
        # right-padded prompts.
        cache["length"] = _replicated_rows(
            torch.full((tokens.shape[0],), n, dtype=torch.int32, device=tokens.device), mesh)
        if perms is not None:
            if perms.device != tokens.device:
                perms = perms.to(tokens.device)  # once, not a host copy every call
            p = perms
            if layout == "heads":
                p = sharding.local_slice(perms, mesh, (None, "model", None))
            # K̂ of a zero row is a zero row: fusing the padded cache is exact.
            cache["k_fused"] = grouping.fuse_columns(  # p (L, 1, Hkv, dh) over B and N
                k.float(), p[:, None], cfg.attention.distr.group_size)
        return logits, cache

    return prefill


def _widen_conv(cache: dict, cfg) -> dict:
    """The conv caches in the dtype a decode step writes: the wider of the
    cache's and the compute dtype (the reference's decode window promotes,
    so an engine's bf16 conv cache turns f32 under f32 activations)."""
    out = dict(cache)
    for key in ("conv", "groups_conv", "tail_conv"):
        if key in out:
            want = torch.promote_types(out[key].dtype, lm.compute_dtype(cfg))
            if out[key].dtype != want:
                out[key] = out[key].to(want)
    return out


def _mamba_decode(cfg, lp: dict, x: torch.Tensor, conv: torch.Tensor, ssm: torch.Tensor,
                  idx: tuple) -> torch.Tensor:
    """Decode one Mamba layer and write its new conv / SSM state back into
    ``conv[idx]`` / ``ssm[idx]`` in place."""
    x, nc = transformer.block_decode_apply(
        sharding.gather_on_use(lp), x, cfg, cache={"conv": conv[idx], "ssm": ssm[idx]},
        cache_index=None, layer_type="mamba")
    conv[idx].copy_(nc["conv"])
    ssm[idx].copy_(nc["ssm"])
    return x


def _mamba_decode_trunk(cfg, params: dict, x: torch.Tensor, cache: dict, pos,
                        mesh=None) -> torch.Tensor:
    if cfg.family == "ssm":
        for i, lp in enumerate(params["blocks"]):
            x = _mamba_decode(cfg, lp, x, cache["conv"], cache["ssm"], (i,))
        return x
    x0 = x
    for gi, group in enumerate(params["groups"]):
        for li, lp in enumerate(group):
            x = _mamba_decode(cfg, lp, x, cache["groups_conv"], cache["groups_ssm"], (gi, li))
        x, _ = transformer.shared_block_decode_apply(
            params["shared"][gi % cfg.n_shared_attn_blocks], x, x0, cfg,
            cache={"k": cache["shared_k"][gi], "v": cache["shared_v"][gi]}, cache_index=pos,
            layout=cache_layout(cfg, mesh, "shared_k"))
    for i, lp in enumerate(params.get("tail", [])):
        x = _mamba_decode(cfg, lp, x, cache["tail_conv"], cache["tail_ssm"], (i,))
    return x


def make_decode_step(cfg, perms: torch.Tensor | None = None, *, max_len: int | None = None,
                     device: str | torch.device = "cuda", mesh=None):
    """→ decode_step(params, tokens (B, 1), cache, pos (B,)) → (logits
    (B, 1, V), cache).  Dense: each slot writes its token at ``pos mod S``;
    the live length becomes ``min(max(length, pos + 1), S)``, and
    ``length`` counts ``max(length, pos + 1)`` in place.  Under
    ``attention.distr_decode`` a dense model's scores read the fused
    ``k_fused`` cache under the static ``perms`` (``_resolve_perms``) and
    raw K is not written.  A moe model runs its ``dense_blocks`` and then
    its MoE blocks; under MLA each writes c_kv and k_rope at ``pos`` and
    attends over ``pos + 1`` positions.  ssm / hybrid: each Mamba layer
    steps its recurrence, and each shared block writes at ``pos`` and
    attends over ``pos + 1`` positions.  encdec: the token takes row ``pos``
    of the learned position table; each decoder layer writes its K/V at
    ``pos``, attends over ``pos + 1`` positions and then over the slot's
    ``cross_len`` encoder positions.
    Every cache tensor is written in place, so a captured step reads and
    writes fixed addresses; only a conv cache narrower than the compute
    dtype comes back as a new, wider tensor (``_widen_conv``).

    ``max_len`` (the self cache's capacity) resolves the decode splits here,
    on ``device`` (``tune.warm_decode``: under ``REPRO_TUNE=measure`` the
    sweeps run now).  A step never sweeps: under ``measure`` a split that
    is still unresolved raises (``tune.sweeps_refused``).

    With ``mesh`` the step runs tensor parallel (see the module docstring):
    ``tokens`` and ``pos`` are this rank's rows, ``cache`` this rank's block
    under ``kv_cache.cache_pspecs``, and the logits the whole vocab."""
    perms = _resolve_perms(cfg, perms)
    layout = cache_layout(cfg, mesh, max_len=max_len)
    if max_len is not None:
        warm_decode(cfg, max_len // (_model_size(mesh) if layout == "seq" else 1),
                    device=device)
    specs = _mesh_specs(cfg, mesh)

    def decode_step(params, tokens, cache, pos):
        with sweeps_refused("a decode step"), _scope(mesh, params, specs):
            return step(params, tokens, cache, pos)

    @torch.no_grad()
    def step(params, tokens, cache, pos):
        nonlocal perms
        pos = pos.to(torch.int32)
        params = _gathered_top(params)
        x = lm.add_learned_pos(params, cfg, lm.embed(params, cfg, tokens), pos[:, None])
        if cfg.family == "encdec":
            cross_len = cache["cross_len"][_own_rows(cache["cross_len"], cache["k"].shape[1],
                                                     mesh)]
            cross_layout = cache_layout(cfg, mesh, "cross_k", cfg.cross_len)
            for i, lp in enumerate(params["blocks"]):
                x, _ = transformer.block_decode_apply(
                    sharding.gather_on_use(lp), x, cfg,
                    cache={key: cache[key][i] for key in ("k", "v", "cross_k", "cross_v")},
                    cache_index=pos, cross_len=cross_len, layout=layout,
                    cross_layout=cross_layout)
            x = transformer.norm_apply(params["final_norm"], x, cfg)
            return full_logits(params, cfg, x), cache
        if cfg.family in ("ssm", "hybrid"):
            cache = _widen_conv(cache, cfg)
            x = _mamba_decode_trunk(cfg, params, x, cache, pos, mesh)
            x = transformer.norm_apply(params["final_norm"], x, cfg)
            return full_logits(params, cfg, x), cache
        stack = lm.decoder_layers(params, cfg)
        if cfg.use_mla:
            mla_layout = cache_layout(cfg, mesh, "ckv", max_len)
            for i, (layer_type, lp) in enumerate(stack):
                x, _ = transformer.block_decode_apply(
                    sharding.gather_on_use(lp), x, cfg,
                    cache={"ckv": cache["ckv"][i], "krope": cache["krope"][i]},
                    cache_index=pos, layer_type=layer_type, layout=mla_layout)
            x = transformer.norm_apply(params["final_norm"], x, cfg)
            return full_logits(params, cfg, x), cache
        if perms is not None and perms.device != x.device:
            # On the eager first call, before any capture: a host copy
            # inside a captured step would fail.
            perms = perms.to(x.device)
        capacity = cache["k"].shape[3] * (_model_size(mesh) if layout == "seq" else 1)
        rows = _own_rows(cache["length"], cache["k"].shape[1], mesh)
        total = torch.maximum(cache["length"][rows], pos + 1)
        length = torch.clamp(total, max=capacity)
        for i, (layer_type, lp) in enumerate(stack):
            layer = ({"v": cache["v"][i], "k_fused": cache["k_fused"][i]} if perms is not None
                     else {"k": cache["k"][i], "v": cache["v"][i]})
            x, _ = transformer.block_decode_apply(
                sharding.gather_on_use(lp), x, cfg, cache=layer, cache_index=pos,
                length=length, layer_type=layer_type,
                perm=perms[i] if perms is not None else None, layout=layout,
            )
        if rows == slice(None):
            cache["length"].copy_(total)
        else:
            cache["length"].copy_(_replicated_rows(total, mesh))
        x = transformer.norm_apply(params["final_norm"], x, cfg)
        return full_logits(params, cfg, x), cache

    return decode_step


def _own_rows(length: torch.Tensor, batch: int, mesh):
    """This rank's rows of the replicated ``length`` vector: all of it when
    it is as long as the cache's batch, else the block of this rank's
    coordinate over the data-parallel axes."""
    if length.shape[0] == batch:
        return slice(None)
    idx, _ = coll.axes_index(mesh, sharding.dp_axes(mesh))
    return slice(idx * batch, (idx + 1) * batch)


def _resolve_perms(cfg, perms: torch.Tensor | None) -> torch.Tensor | None:
    """The fused-K̂ cache's or pool's static perms (L, Hkv, dh), or None for
    raw K (and for the moe, ssm and hybrid families, which keep no fused
    cache).
    ``perms`` passes given ones across (the tests hand over the
    reference's); None draws the port's own."""
    if not cfg.attention.distr_decode or cfg.family != "dense":
        return None
    return perms if perms is not None else kv_cache.static_perms(cfg)


def make_paged_step(cfg, width: int, perms: torch.Tensor | None = None):
    """→ paged_step(params, tokens (B, width), pools, block_tables, pos,
    count) → (logits (B, width, V), pools).

    ``width = 1`` is the batched decode tick, ``width = chunk`` one
    chunked-prefill window: the same banded windowed decode, so chunked
    prefill runs on the paged decode kernel.  pos: (B,) start positions;
    count: (B,) live tokens per row (padding writes go to the garbage block;
    the caller ignores padded logits).  Under ``attention.distr_decode`` a
    dense model's pools hold fused K̂ under ``perms`` (see
    ``_resolve_perms``).  GQA dense and moe only."""
    check_pageable(cfg)
    perms = _resolve_perms(cfg, perms)

    @torch.no_grad()
    def paged_step(params, tokens, pools, block_tables, pos, count):
        nonlocal perms
        x = lm.embed(params, cfg, tokens)
        if perms is not None and perms.device != x.device:
            perms = perms.to(x.device)  # once, not a host copy every step
        fused = perms
        for i, (layer_type, lp) in enumerate(lm.decoder_layers(params, cfg)):
            x, _ = transformer.block_paged_decode_apply(
                lp, x, cfg, pool_k=None if fused is not None else pools["k"][i],
                pool_v=pools["v"][i], block_tables=block_tables, pos=pos, count=count,
                pool_k_fused=pools["k_fused"][i] if fused is not None else None,
                perm=fused[i] if fused is not None else None, layer_type=layer_type,
            )
        x = transformer.norm_apply(params["final_norm"], x, cfg)
        return lm.logits_fn(params, cfg, x), pools

    return paged_step


def _make_paged_full_prefill(cfg, backbone_cfg, perms: torch.Tensor | None = None):
    """Whole-prompt paged prefill: one forward under ``backbone_cfg``, the
    last live row's logits, and every layer's K/V written into the
    request's blocks through the table (padded rows go to the garbage
    block).  A fused K̂ is always written at the engine's own G* from its
    static perms, whatever attention ``backbone_cfg`` ran: the cache layout
    belongs to the engine, the forward to the caller."""
    check_pageable(cfg)
    perms = _resolve_perms(cfg, perms)

    @torch.no_grad()
    def prefill(params, tokens, n, pools, block_tables):
        nonlocal perms
        if perms is not None and perms.device != tokens.device:
            perms = perms.to(tokens.device)
        hidden, kvs = lm.backbone(params, backbone_cfg, tokens, collect_cache=True)
        logits = lm.logits_fn(params, cfg, hidden[:, n - 1])[0]  # (V,)
        pos0 = torch.zeros((1,), dtype=torch.int64, device=tokens.device)
        count = torch.full((1,), n, dtype=torch.int64, device=tokens.device)
        g = cfg.attention.distr.group_size
        for i, (k, v) in enumerate(kvs):
            paged_insert(pools["v"][i], v, block_tables, pos0, count)
            if perms is not None:
                k_f = grouping.fuse_columns(k.float(), perms[i][None], g)
                paged_insert(pools["k_fused"][i], k_f, block_tables, pos0, count)
            else:
                paged_insert(pools["k"][i], k, block_tables, pos0, count)
        return logits, pools

    return prefill


def make_mesh_paged_prefill(cfg, bucket: int, perms: torch.Tensor | None = None):
    """→ prefill(params, tokens (1, bucket), n, pools, block_tables) → (last
    live row's logits (V,), pools).

    The mesh engine's whole-prompt prefill (``PagedServeEngine(mesh=)``):
    the engine calls it under its context mesh (``launch.mesh.set_mesh``),
    so each attention takes the ring through ``core.api.attend`` when the
    bucket spans at least ring size × ``MIN_RING_SHARD`` positions.  It runs
    the engine's own exact attention; under the ring's contract every rank
    of the context group ends with every layer's global K/V, so the leader
    writes them into its own pool with no gather, the fused K̂ at the
    engine's own G*, and decode continues on the paged kernel.  ``bucket``
    is the padded prompt length, which the tokens carry."""
    del bucket
    return _make_paged_full_prefill(cfg, cfg, perms)


def make_degraded_paged_prefill(cfg, bucket: int, group_size: int,
                                perms: torch.Tensor | None = None):
    """→ prefill(params, tokens (1, bucket), n, pools, block_tables) →
    (last live row's logits (V,), pools).

    The degradation dial's prefill (serve.degrade): under overload the
    scheduler trades chunked exact prefill for one whole-prompt forward
    whose attention runs DistrAttention at G* = ``group_size``
    (``AttentionConfig.degraded``), then writes the resulting K/V into the
    request's blocks.  Decode continues on the paged kernel untouched.
    ``bucket`` is the padded prompt length, which the tokens carry."""
    del bucket
    dcfg = cfg.replace(attention=cfg.attention.degraded(group_size))
    return _make_paged_full_prefill(cfg, dcfg, perms)
