"""Int8 error-feedback gradient compression for the data-parallel mean
(``repro/train/compression.py``).

``compress`` quantises a tensor to int8 with one f32 scale (symmetric,
rounding half to even as ``jnp.round`` does); ``ef_step`` compresses the
gradient plus the carried residual and returns the new residual, the
quantisation error, so nothing is lost across steps.  ``ef_pmean`` is the
mean over a mesh axis: each rank's int8 payload and its scale are what cross
the wire (all-gathered), and every rank decompresses and averages them.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.utils.tree import tree_leaves, tree_map


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation → (q int8, scale f32 scalar)."""
    amax = g.abs().max().float()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_step(g: torch.Tensor, residual: torch.Tensor):
    """One error-feedback step → ((q, scale), new residual): the payload
    decompresses to ≈ g + residual, and the new residual carries the
    quantisation error into the next step."""
    corrected = g.float() + residual
    q, scale = compress(corrected)
    return (q, scale), corrected - decompress(q, scale)


def ef_pmean(grads, residuals, mesh, axis: str):
    """The error-feedback-compressed gradient mean over ``axis`` → (mean
    grads, new residuals), trees shaped like ``grads``.  Each rank
    all-gathers the others' int8 payloads and f32 scales, so 1 byte an
    element crosses the wire instead of 4."""
    p = coll.axis_size(mesh, axis)
    means, new_res = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residuals)):
        (q, scale), nr = ef_step(g, r)
        qs = coll.all_gather(q[None], mesh, axis, 0)
        scales = coll.all_gather(scale.reshape(1), mesh, axis, 0)
        deq = qs.float() * scales.reshape((p,) + (1,) * q.ndim)
        means.append(deq.sum(0) / p)
        new_res.append(nr)
    means, new_res = iter(means), iter(new_res)
    return tree_map(lambda _: next(means), grads), tree_map(lambda _: next(new_res), grads)


def init_residuals(params):
    """Zero f32 residuals shaped like ``params``."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device),
                    params)
