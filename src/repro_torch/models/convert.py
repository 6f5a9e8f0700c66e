"""Build the port's parameters from the reference's parameter tree.

The reference keeps per-layer parameters stacked on axis 0 under
``blocks`` and linear weights as ``(d_in, d_out)``; the port keeps the same
layout, one dict per layer.  A tied-embedding tree has no ``lm_head``.
The reference draws two pieces of model state from ``jax.random`` that torch
cannot regenerate: the LSH projection (``from_jax_params(proj=)``) and the
fused-K̂ cache's static permutations (``convert_perms``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import compute_dtype, init_lsh_projection
from repro_torch.utils.device import resolve_device


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device=device, dtype=dtype)


def _layer(stacked, i: int):
    """Layer ``i`` of a tree stacked on axis 0."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return np.asarray(stacked)[i]


def _leaf_dtype(path: tuple, cdtype: torch.dtype) -> torch.dtype:
    """Norm parameters stay f32; matmul weights, biases and tables take the
    compute dtype."""
    return torch.float32 if any("norm" in p for p in path) else cdtype


def _convert(tree, path, cdtype, device):
    if isinstance(tree, dict):
        return {k: _convert(v, path + (k,), cdtype, device) for k, v in tree.items()}
    return _tensor(tree, _leaf_dtype(path, cdtype), device)


def from_jax_params(params_np: dict, cfg, *, proj: np.ndarray | None = None,
                    device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None) -> dict:
    """Reference ``lm.init_params`` tree (numpy leaves, ``blocks`` stacked on
    the layer axis) → the port's parameter dict, with matmul weights,
    tables and biases in ``dtype`` (default the compute dtype, as serving
    holds them; training passes ``lm.param_dtype(cfg)``).  ``proj`` is the
    reference's LSH projection ``(16, block_q)``; without it the port's
    own seeded projection is kept."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r}: the port serves dense models")
    dev = resolve_device(device)
    cdtype = dtype or compute_dtype(cfg)
    blocks = [_convert(_layer(params_np["blocks"], i), ("blocks",), cdtype, dev)
              for i in range(cfg.n_layers)]
    params = {
        "embed": _convert(params_np["embed"], ("embed",), cdtype, dev),
        "blocks": blocks,
        "final_norm": _convert(params_np["final_norm"], ("final_norm",), cdtype, dev),
        "lsh_proj": (_tensor(proj, torch.float32, dev) if proj is not None
                     else init_lsh_projection(cfg, dev)),
    }
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
