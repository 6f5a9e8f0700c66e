"""Dense decoder LM: init, trunk, logits.

Parameters are a dict: ``embed``, ``blocks`` (one dict per layer),
``final_norm``, ``lm_head`` (untied) and ``lsh_proj`` — the fixed LSH projection of
the DistrAttention impls, model state drawn once at init.
"""
from __future__ import annotations

import torch

from repro_torch.core import lsh
from repro_torch.models import layers, transformer
from repro_torch.utils.device import resolve_device

PAD_LOGIT = -1e30


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def init_lsh_projection(cfg, device) -> torch.Tensor:
    """The LSH projection drawn from ``proj_seed`` on a CPU generator."""
    dcfg = cfg.attention.distr.resolved()
    gen = torch.Generator().manual_seed(dcfg.proj_seed)
    return lsh.make_projection(gen, dcfg.block_q).to(device)


def init_params(cfg, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda") -> dict:
    """Random weights with the reference's distributions, drawn on
    ``device``: linear ``normal · d_in^-0.5`` with zero biases, embedding
    ``normal · 0.02``, norms ones/zeros.  Matmul weights, embeddings and
    biases are held in the compute dtype, norm parameters in f32.
    Raises when ``device`` is CUDA and CUDA is absent."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r}: the port serves dense models")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = compute_dtype(cfg)
    params = {
        "embed": layers.embedding_init(generator, cfg.padded_vocab, cfg.d_model, dtype),
        "blocks": [transformer.block_init(generator, cfg, dtype) for _ in range(cfg.n_layers)],
        "final_norm": transformer.norm_init(cfg, dev),
        "lsh_proj": init_lsh_projection(cfg, dev),
        "lm_head": layers.linear_init(generator, cfg.d_model, cfg.padded_vocab, dtype=dtype),
    }
    return params


def embed(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return layers.embedding_apply(params["embed"], tokens).to(compute_dtype(cfg))


def backbone(params: dict, cfg, tokens: torch.Tensor, *, collect_cache: bool = False):
    """Trunk → (hidden (B, N, D) after the final norm, kv) where kv is a
    list of per-layer (k, v) (B, Hkv, N, dh) when ``collect_cache``."""
    x = embed(params, cfg, tokens)
    b, n = tokens.shape
    positions = torch.arange(n, device=tokens.device).expand(b, n)
    kvs = []
    for lp in params["blocks"]:
        x, kv = transformer.block_apply(lp, x, cfg, positions=positions,
                                        proj=params.get("lsh_proj"))
        if collect_cache:
            kvs.append(kv)
    x = transformer.norm_apply(params["final_norm"], x, cfg)
    return x, (kvs if collect_cache else None)


def logits_fn(params: dict, cfg, hidden: torch.Tensor) -> torch.Tensor:
    logits = layers.linear_apply(params["lm_head"], hidden)
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, PAD_LOGIT)
    return logits


def forward(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence logits (B, N, padded_vocab)."""
    hidden, _ = backbone(params, cfg, tokens)
    return logits_fn(params, cfg, hidden)
