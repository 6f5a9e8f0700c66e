"""Build the port's parameters from the reference's parameter tree.

The reference keeps per-layer parameters stacked on axis 0 under
``blocks`` (moe: also ``dense_blocks``, the first ``first_dense_layers``
layers; the hybrid: on axes 0 and 1 under ``groups``, axis 0 under
``tail``, and a list of unstacked ``shared`` blocks; encdec: also
``enc_blocks``, beside ``enc_norm``, and decoder ``blocks`` with
``norm_cross`` and ``cross_attn``), an optional learned position table
``pos_embed``, and linear weights as
``(d_in, d_out)``; the port keeps the same layout, one dict per layer, a
MoE layer's experts stacked (E, ·, ·) as in the reference.  A
tied-embedding tree has no ``lm_head``.
The reference draws two pieces of model state from ``jax.random`` that torch
cannot regenerate: the LSH projection (``from_jax_params(proj=)``) and the
fused-K̂ cache's static permutations (``convert_perms``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import (
    check_family, compute_dtype, hybrid_layout, init_lsh_projection, n_encoder_layers,
)
from repro_torch.utils.device import resolve_device


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device=device, dtype=dtype)


def _layer(stacked, i: int):
    """Layer ``i`` of a tree stacked on axis 0."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return np.asarray(stacked)[i]


# Mamba parameters held in f32 whatever the compute dtype (``mamba_init``).
F32_LEAVES = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip")


# Subtrees held in f32 whatever the compute dtype: the MoE router
# (``moe_init``).
F32_SUBTREES = ("router",)


def _leaf_dtype(path: tuple, cdtype: torch.dtype) -> torch.dtype:
    """Norm parameters (MLA's ``q_norm`` and ``kv_norm`` among them), the
    Mamba leaves of ``F32_LEAVES`` and the subtrees of ``F32_SUBTREES``
    stay f32; matmul weights, biases and tables take the compute dtype."""
    if (any("norm" in p for p in path) or path[-1] in F32_LEAVES
            or any(p in F32_SUBTREES for p in path)):
        return torch.float32
    return cdtype


def _convert(tree, path, cdtype, device):
    if isinstance(tree, dict):
        return {k: _convert(v, path + (k,), cdtype, device) for k, v in tree.items()}
    return _tensor(tree, _leaf_dtype(path, cdtype), device)


def from_jax_params(params_np: dict, cfg, *, proj: np.ndarray | None = None,
                    device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None) -> dict:
    """Reference ``lm.init_params`` tree (numpy leaves, layers stacked as
    the module docstring says) → the port's parameter dict, with matmul weights,
    tables and biases in ``dtype`` (default the compute dtype, as serving
    holds them; training passes ``lm.param_dtype(cfg)``).  ``proj`` is the
    reference's LSH projection ``(16, block_q)``; without it the port's
    own seeded projection is kept."""
    check_family(cfg)
    dev = resolve_device(device)
    cdtype = dtype or compute_dtype(cfg)

    def unstack(stacked, n: int, name: str) -> list:
        return [_convert(_layer(stacked, i), (name,), cdtype, dev) for i in range(n)]

    params = {"embed": _convert(params_np["embed"], ("embed",), cdtype, dev)}
    if "pos_embed" in params_np:
        params["pos_embed"] = _convert(params_np["pos_embed"], ("pos_embed",), cdtype, dev)
    if cfg.family == "encdec":
        params["enc_blocks"] = unstack(params_np["enc_blocks"], n_encoder_layers(cfg),
                                       "enc_blocks")
        params["enc_norm"] = _convert(params_np["enc_norm"], ("enc_norm",), cdtype, dev)
    if cfg.family == "hybrid":
        n_groups, n_tail = hybrid_layout(cfg)
        params["groups"] = [unstack(_layer(params_np["groups"], gi), cfg.attn_every, "groups")
                            for gi in range(n_groups)]
        if n_tail:
            params["tail"] = unstack(params_np["tail"], n_tail, "tail")
        params["shared"] = [_convert(sp, ("shared",), cdtype, dev) for sp in params_np["shared"]]
    elif cfg.family == "moe":
        fd = cfg.first_dense_layers
        if fd:
            params["dense_blocks"] = unstack(params_np["dense_blocks"], fd, "dense_blocks")
        params["blocks"] = unstack(params_np["blocks"], cfg.n_layers - fd, "blocks")
    else:
        params["blocks"] = unstack(params_np["blocks"], cfg.n_layers, "blocks")
    params["final_norm"] = _convert(params_np["final_norm"], ("final_norm",), cdtype, dev)
    params["lsh_proj"] = (_tensor(proj, torch.float32, dev) if proj is not None
                          else init_lsh_projection(cfg, dev))
    if not cfg.tie_embeddings:
        params["lm_head"] = _convert(params_np["lm_head"], ("lm_head",), cdtype, dev)
    return params


def convert_perms(perms_np, cfg, device: str | torch.device = "cuda") -> torch.Tensor:
    """The reference's static decode permutations (``serve.kv_cache.
    static_perms``: (L, Hkv, dh) int32, numpy) → the port's (L, Hkv, dh)
    int64 tensor, for the ``perms=`` argument of the paged steps and
    ``PagedServeEngine``."""
    perms = np.asarray(perms_np)
    want = (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_)
    if perms.shape != want:
        raise ValueError(f"static perms of shape {perms.shape}, want {want}")
    return torch.from_numpy(perms.astype(np.int64)).to(resolve_device(device))
