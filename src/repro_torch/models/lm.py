"""Decoder LMs of the dense, ssm and hybrid families: init, trunk, logits,
loss.

Parameters are a dict: ``embed``, the family's layers, ``final_norm``,
``lm_head`` (absent under tied embeddings, where the LM head reads the
embedding table) and ``lsh_proj`` — the fixed LSH projection of the
DistrAttention impls, model state drawn once at init and never trained.
The layers: ``blocks`` (one dict per layer) for dense and ssm; for hybrid
``groups`` (n_groups lists of ``attn_every`` Mamba layers), ``tail`` (the
Mamba layers past the last group, when there are any) and ``shared`` (the
``n_shared_attn_blocks`` shared attention blocks; group ``gi`` is followed
by block ``gi % n_shared_attn_blocks``).  Per-layer Python loops stand in
for the reference's ``lax.scan``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import lsh
from repro_torch.models import layers, transformer
from repro_torch.utils.device import resolve_device

PAD_LOGIT = -1e30
Z_LOSS_WEIGHT = 1e-4
FAMILIES = ("dense", "ssm", "hybrid")


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def compute_dtype(cfg) -> torch.dtype:
    return _dtype(cfg.compute_dtype)


def param_dtype(cfg) -> torch.dtype:
    """The dtype training holds its master weights in."""
    return _dtype(cfg.param_dtype)


def init_lsh_projection(cfg, device) -> torch.Tensor:
    """The LSH projection drawn from ``proj_seed`` on a CPU generator."""
    dcfg = cfg.attention.distr.resolved()
    gen = torch.Generator().manual_seed(dcfg.proj_seed)
    return lsh.make_projection(gen, dcfg.block_q).to(device)


def hybrid_layout(cfg) -> tuple[int, int]:
    """(n_groups, n_tail) of the hybrid's Mamba / shared-attention interleave."""
    n_groups = cfg.n_layers // cfg.attn_every
    return n_groups, cfg.n_layers - n_groups * cfg.attn_every


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves the {', '.join(FAMILIES)} families")


def init_params(cfg, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda", dtype: torch.dtype | None = None) -> dict:
    """Random weights with the reference's distributions, drawn on
    ``device``: linear ``normal · d_in^-0.5`` with zero biases, embedding
    ``normal · 0.02``, norms ones/zeros.  Matmul weights, embeddings and
    biases are held in ``dtype`` — by default the compute dtype, as serving
    holds them; training passes ``param_dtype(cfg)`` — and norm parameters in
    f32.  Raises when ``device`` is CUDA and CUDA is absent."""
    check_family(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = dtype or compute_dtype(cfg)
    params = {"embed": layers.embedding_init(generator, cfg.padded_vocab, cfg.d_model, dtype)}

    def mamba_layers(n: int) -> list:
        return [transformer.block_init(generator, cfg, dtype, "mamba") for _ in range(n)]

    if cfg.family == "dense":
        params["blocks"] = [transformer.block_init(generator, cfg, dtype)
                            for _ in range(cfg.n_layers)]
    elif cfg.family == "ssm":
        params["blocks"] = mamba_layers(cfg.n_layers)
    else:
        n_groups, n_tail = hybrid_layout(cfg)
        params["groups"] = [mamba_layers(cfg.attn_every) for _ in range(n_groups)]
        if n_tail:
            params["tail"] = mamba_layers(n_tail)
        params["shared"] = [transformer.shared_block_init(generator, cfg, dtype)
                            for _ in range(cfg.n_shared_attn_blocks)]
    params["final_norm"] = transformer.norm_init(cfg, dev)
    params["lsh_proj"] = init_lsh_projection(cfg, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.linear_init(generator, cfg.d_model, cfg.padded_vocab,
                                               dtype=dtype)
    return params


def named_trainable(params: dict) -> list[tuple[str, torch.Tensor]]:
    """``(key path, tensor)`` of the trained leaves of ``params`` in a fixed
    order (dict keys sorted, lists by index, paths like
    ``blocks/0/attn/wq/w``): every tensor but the LSH projection."""
    leaves: list[tuple[str, torch.Tensor]] = []

    def walk(tree, path: str):
        if isinstance(tree, dict):
            for key in sorted(tree):
                walk(tree[key], f"{path}/{key}" if path else str(key))
        elif isinstance(tree, list):
            for i, item in enumerate(tree):
                walk(item, f"{path}/{i}")
        else:
            leaves.append((path, tree))

    walk({k: v for k, v in params.items() if k != "lsh_proj"}, "")
    return leaves


def trainable(params: dict) -> list[torch.Tensor]:
    """The trained leaves of ``params`` in ``named_trainable``'s order."""
    return [t for _, t in named_trainable(params)]


def embed(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return layers.embedding_apply(params["embed"], tokens).to(compute_dtype(cfg))


def _block_hidden(lp: dict, x: torch.Tensor, cfg, positions, proj) -> torch.Tensor:
    return transformer.block_apply(lp, x, cfg, positions=positions, proj=proj)[0]


def _mamba_layers(layer_params: list, x: torch.Tensor, cfg, collect_cache: bool):
    states = []
    for lp in layer_params:
        x, st = transformer.block_apply(lp, x, cfg, layer_type="mamba",
                                        collect_cache=collect_cache)
        states.append(st)
    return x, states


def backbone(params: dict, cfg, tokens: torch.Tensor, *, collect_cache: bool = False):
    """Trunk → (hidden (B, N, D) after the final norm, cache parts), the
    parts None unless ``collect_cache``.  Dense: a list of per-layer (k, v)
    (B, Hkv, N, dh).  ssm: a list of per-layer (conv_state, ssm_state).
    hybrid: ``{"groups": [[(conv, ssm)] per Mamba layer] per group,
    "shared_kv": [(k, v)] per group site, "tail": [(conv, ssm)]}``; the
    shared blocks read the embedded tokens ``x0`` through their concat skip.

    Under autograd with ``cfg.remat == "full"`` each dense block is one
    ``checkpoint``: only its input is kept, and the backward recomputes the
    block (the reference's ``_remat``)."""
    x = embed(params, cfg, tokens)
    b, n = tokens.shape
    positions = torch.arange(n, device=tokens.device).expand(b, n)
    proj = params.get("lsh_proj")
    if cfg.family == "ssm":
        x, states = _mamba_layers(params["blocks"], x, cfg, collect_cache)
        x = transformer.norm_apply(params["final_norm"], x, cfg)
        return x, (states if collect_cache else None)
    if cfg.family == "hybrid":
        x0 = x
        groups, shared_kv = [], []
        for gi, group in enumerate(params["groups"]):
            x, states = _mamba_layers(group, x, cfg, collect_cache)
            sp = params["shared"][gi % cfg.n_shared_attn_blocks]
            x, kv = transformer.shared_block_apply(sp, x, x0, cfg, positions=positions,
                                                   proj=proj)
            groups.append(states)
            shared_kv.append(kv)
        x, tail = _mamba_layers(params.get("tail", []), x, cfg, collect_cache)
        x = transformer.norm_apply(params["final_norm"], x, cfg)
        parts = {"groups": groups, "shared_kv": shared_kv, "tail": tail}
        return x, (parts if collect_cache else None)
    remat = cfg.remat == "full" and torch.is_grad_enabled() and not collect_cache
    kvs = []
    for lp in params["blocks"]:
        if remat:
            x = checkpoint(_block_hidden, lp, x, cfg, positions, proj, use_reentrant=False)
            continue
        x, kv = transformer.block_apply(lp, x, cfg, positions=positions, proj=proj)
        if collect_cache:
            kvs.append(kv)
    x = transformer.norm_apply(params["final_norm"], x, cfg)
    return x, (kvs if collect_cache else None)


def logits_fn(params: dict, cfg, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = layers.embedding_logits(params["embed"], hidden)
    else:
        logits = layers.linear_apply(params["lm_head"], hidden)
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, PAD_LOGIT)
    return logits


def forward(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence logits (B, N, padded_vocab)."""
    hidden, _ = backbone(params, cfg, tokens)
    return logits_fn(params, cfg, hidden)


def loss_fn(params: dict, cfg, batch: dict):
    """Next-token cross-entropy over f32 logits plus the 1e-4 z-loss →
    (loss, metrics).  Labels below 0 are masked out.  The reference adds a
    router aux term; a dense model has none, so ``aux`` is 0."""
    logits = forward(params, cfg, batch["tokens"]).float()
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    denom = mask.sum().clamp(min=1.0)
    ce = (nll * mask).sum() / denom
    zloss = (lse.square() * mask).sum() / denom
    aux = torch.zeros((), device=logits.device)
    return ce + Z_LOSS_WEIGHT * zloss, {"ce": ce, "aux": aux, "zloss": zloss}
