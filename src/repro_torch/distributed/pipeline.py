"""GPipe-style pipeline parallelism over a mesh axis (default: "pod"), as
``repro/distributed/pipeline.py``.

The layer stages live on successive ranks of the axis and activations hop
rank to rank (``collectives.shift``) while microbatches fill the pipeline:
M + S − 1 ticks for M microbatches over S stages.  ``pipeline_apply`` is
generic: ``stage_fn(stage_params, x)`` is any per-stage transform (a slice
of transformer layers, say).  It is differentiable: the hop's backward sends
the cotangent one rank back, the transpose of the forward permute.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.utils.tree import tree_map


def pipeline_apply(stage_fn, stage_params, x: torch.Tensor, mesh, *, axis: str = "pod",
                   num_microbatches: int | None = None) -> torch.Tensor:
    """Run ``x`` through the S stages laid out along ``axis``.

    stage_params: this rank's stage (stage ``mesh.coords[axis]``; the
      reference passes every stage stacked and shards them over ``axis``).
    x: (M, mb, ...) M microbatches, the same on every rank.
    Returns (M, mb, ...) with every stage applied in order, on every rank.
    """
    s_total = coll.axis_size(mesh, axis)
    stage = int(mesh.coords[axis]) if s_total > 1 else 0
    m = num_microbatches or x.shape[0]
    assert x.shape[0] == m
    # x is replicated over the axis: its cotangent (stage 0's) reaches every rank.
    x = coll.tp_enter(x, mesh, axis)
    first = torch.tensor(stage == 0, device=x.device)
    zeros = torch.zeros_like(x[0])
    outs = []
    cur = zeros
    for t in range(m + s_total - 1):
        # Stage 0 injects microbatch t; drain ticks (t ≥ M) inject zeros:
        # re-injecting microbatch M − 1 would make every stage recompute it
        # S − 1 more times.  A select, as the reference's, so that every
        # rank's graph holds every hop: each hop's backward is a collective.
        cur = torch.where(first, x[t] if t < m else zeros, cur)
        y = stage_fn(stage_params, cur)
        if t >= s_total - 1:  # the last stage emits microbatch t − (S − 1)
            outs.append(y.to(x.dtype))
        if t < m + s_total - 2:  # the last tick's hop would reach no stage
            cur = coll.shift(y, mesh, axis, 1)
    # Only the last stage holds the outputs; every rank gets them.
    last = float(stage == s_total - 1)
    return coll.tp_reduce(torch.stack(outs) * last, mesh, axis)


def stage_split(layers, n_stages: int):
    """Split a model's layers into ``n_stages`` equal stages: a list of
    layers into a list of lists, or a (L, ...) stacked tree into (S, L/S,
    ...) as the reference's."""
    if isinstance(layers, list):
        per, rem = divmod(len(layers), n_stages)
        assert rem == 0, (len(layers), n_stages)
        return [layers[i * per:(i + 1) * per] for i in range(n_stages)]

    def reshape(t):
        n = t.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return t.reshape((n_stages, n // n_stages) + tuple(t.shape[1:]))

    return tree_map(reshape, layers)
