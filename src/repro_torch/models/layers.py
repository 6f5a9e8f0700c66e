"""Primitive layers as functions over parameter dicts: linear, norms,
embedding, rotary, MLP.

Linear weights keep the reference's ``(d_in, d_out)`` layout (``y = x @ w``)
and are held in the compute dtype; norm parameters stay f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _normal(generator: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def linear_init(generator, d_in: int, d_out: int, *, bias: bool = False,
                dtype=torch.float32, scale: float | None = None) -> dict:
    params = {"w": _normal(generator, (d_in, d_out),
                           scale if scale is not None else d_in ** -0.5, dtype)}
    if bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return params


def linear_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def rmsnorm_init(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_apply(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm_apply(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def embedding_init(generator, vocab: int, d: int, dtype=torch.float32) -> dict:
    return {"table": _normal(generator, (vocab, d), 0.02, dtype)}


def embedding_apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def embedding_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding readout: ``x @ tableᵀ`` in x's dtype."""
    return x @ params["table"].to(x.dtype).T


def rope_frequencies(dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate interleaved feature pairs ``(x[..., 2i], x[..., 2i+1])``.

    x: (B, H, N, d); positions: (B, N) int.
    """
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    angles = positions[:, None, :, None].to(torch.float32) * freqs  # (B,1,N,d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., ::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def mlp_init(generator, d_model: int, d_ff: int, *, act: str = "silu",
             dtype=torch.float32) -> dict:
    params = {
        "up": linear_init(generator, d_model, d_ff, dtype=dtype),
        "down": linear_init(generator, d_ff, d_model, dtype=dtype),
    }
    if act == "silu":
        params["gate"] = linear_init(generator, d_model, d_ff, dtype=dtype)
    return params


def mlp_apply(params: dict, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    up = linear_apply(params["up"], x)
    if act == "silu":
        h = F.silu(linear_apply(params["gate"], x)) * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown act {act!r}")
    return linear_apply(params["down"], h)
