"""Primitive layers as functions over parameter dicts: linear, norms,
embedding, rotary, MLP.

Linear weights keep the reference's ``(d_in, d_out)`` layout (``y = x @ w``)
and are held in the compute dtype; norm parameters stay f32.  Every init has
a matching ``*_axes`` giving the same tree with logical-axis tuples for the
sharding rules (``distributed.sharding``).

Tensor parallelism (Megatron-style) is read off the parameters a layer is
given: a weight that holds a slice of its logical "mlp" or "vocab" dim (the
rules put it on "model") makes the layer run its slice, bracketed by
``collectives.tp_enter`` / ``tp_reduce`` over the active mesh's "model"
axis (``tp_mesh``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's sharding hint (``with_sharding_constraint``): a
    layout with no numeric effect.  Under the port's explicit collectives an
    activation is already this rank's, so ``x`` comes back as it is;
    ``distributed.sharding.expand_spec`` reads the spec as the reference
    does."""
    return x


def tp_mesh(local: int, full: int):
    """The active mesh when a dim of size ``full`` is held as its ``local``
    slice over "model" (tensor parallel), None when it is held whole."""
    if local == full:
        return None
    from repro_torch.launch.mesh import active_mesh

    mesh = active_mesh()
    m = coll.axis_size(mesh, "model") if mesh is not None else 1
    if local * m != full:
        raise ValueError(f"a dim of {full} held as {local} rows, which is not its slice over "
                         f"a 'model' axis of {m}")
    return mesh


def _normal(generator: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    meta = generator.device.type == "meta"  # shapes only: lm.param_shapes
    x = torch.randn(shape, generator=None if meta else generator, device=generator.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def linear_init(generator, d_in: int, d_out: int, *, bias: bool = False,
                dtype=torch.float32, scale: float | None = None) -> dict:
    params = {"w": _normal(generator, (d_in, d_out),
                           scale if scale is not None else d_in ** -0.5, dtype)}
    if bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return params


def linear_axes(in_axis: str | None, out_axis: str | None, *, bias: bool = False) -> dict:
    axes = {"w": (in_axis, out_axis)}
    if bias:
        axes["b"] = (out_axis,)
    return axes


def linear_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def rmsnorm_init(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_axes() -> dict:
    return {"scale": (None,)}


def rmsnorm_apply(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm_axes() -> dict:
    return {"scale": (None,), "bias": (None,)}


def layernorm_apply(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def embedding_init(generator, vocab: int, d: int, dtype=torch.float32) -> dict:
    return {"table": _normal(generator, (vocab, d), 0.02, dtype)}


def embedding_axes() -> dict:
    return {"table": ("vocab", None)}


def embedding_apply(params: dict, tokens: torch.Tensor, vocab: int | None = None) -> torch.Tensor:
    """The table's rows at ``tokens``.  A table that holds a slice of its
    ``vocab`` rows over "model" looks up the tokens in its slice (the
    others give zero rows) and the ranks' rows are summed."""
    table = params["table"]
    mesh = tp_mesh(table.shape[0], vocab) if vocab is not None else None
    if mesh is None:
        return table[tokens]
    rows = table.shape[0]
    local = tokens - int(mesh.coords["model"]) * rows
    inside = (local >= 0) & (local < rows)
    out = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
    return coll.tp_reduce(out, mesh)


def embedding_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding readout: ``x @ tableᵀ`` in x's dtype (this rank's
    vocab columns when the table holds a slice of its rows)."""
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


def mlp_axes(act: str = "silu") -> dict:
    axes = {"up": linear_axes(None, "mlp"), "down": linear_axes("mlp", None)}
    if act == "silu":
        axes["gate"] = linear_axes(None, "mlp")
    return axes


def mlp_apply(params: dict, x: torch.Tensor, *, act: str = "silu",
              d_ff: int | None = None) -> torch.Tensor:
    """The MLP; given the full width ``d_ff``, weights that hold a slice of
    it run tensor parallel: gate and up column-parallel, down row-parallel
    with its partial products summed over "model"."""
    mesh = tp_mesh(params["up"]["w"].shape[1], d_ff) if d_ff is not None else None
    if mesh is not None:
        x = coll.tp_enter(x, mesh)
    up = linear_apply(params["up"], x)
    if act == "silu":
        h = F.silu(linear_apply(params["gate"], x)) * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown act {act!r}")
    h = constrain(h, "data", None, "model")
    y = linear_apply(params["down"], h)
    return y if mesh is None else coll.tp_reduce(y, mesh)
