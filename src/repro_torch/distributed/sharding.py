"""Logical-axis → mesh sharding rules (DP / FSDP × TP), as
``repro/distributed/sharding.py``, and the tensors they shard.

Parameters carry logical axis tuples (``models.lm.param_axes``); the rules
map them onto the mesh:

  vocab / mlp / heads / kv_heads / experts → "model"   (TP / EP)
  one large unsharded dim per tensor       → "data"    (FSDP, if cfg.fsdp)

FSDP picks the largest dim with no logical axis whose size divides the data
axis's size and is at least ``MIN_FSDP_DIM``; the AdamW moments shard
exactly like their parameter.  An assignment that does not divide its dim is
dropped.  The port keeps a model's layers as lists, where the reference
stacks them on a leading dim the rules never shard, so a port leaf's spec is
the reference leaf's with that stack entry dropped.  Activations: the batch
shards over every axis but "model" and ``CONTEXT_AXIS``.

``P`` is the port's spec: a tuple with one entry a dim (an axis name, a
tuple of them, or None).  ``shard_params`` takes this rank's slices of full
tensors and ``gather_params`` puts them back together, bit for bit;
``gather_to`` puts one leaf together on one rank's host only.  Under
FSDP the train step gathers a block's ``"data"``-sharded leaves on use
(``fsdp_gathering`` / ``gather_on_use``): an all-gather forward whose
backward reduce-scatters the gradient back onto the shard.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as coll
from repro_torch.utils.tree import tree_map

LOGICAL_RULES = {
    "vocab": "model",
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
    None: None,
}

MIN_FSDP_DIM = 1024

# The reserved mesh-axis name of ring sequence-parallel attention
# (``distributed.ring_attention``): the batch never shards over it, and
# ``expand_spec`` maps the "seq" entry onto it.
CONTEXT_AXIS = "context"


def _entry(e):
    if isinstance(e, (tuple, list)):
        return None if not e else e[0] if len(e) == 1 else tuple(e)
    return e


class P(tuple):
    """A partition spec: one entry a dim, each an axis name, a tuple of axis
    names (the dim split over their product, row-major) or None; a tuple of
    one name is that name and an empty one None, as in JAX's."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes the batch dimension shards over: every one but "model" (TP) and
    ``CONTEXT_AXIS`` (each ring rank holds a sequence shard of the same
    batch)."""
    return tuple(a for a in mesh.axis_names if a not in ("model", CONTEXT_AXIS))


def data_axis_size(mesh) -> int:
    return int(mesh.shape.get("data", 1))


def _spec_for(axes: tuple, shape: tuple, mesh, *, fsdp: bool) -> P:
    assignment = [LOGICAL_RULES.get(a, None) for a in axes]
    for i, a in enumerate(assignment):
        if a is not None and shape[i] % int(mesh.shape.get(a, 1)):
            assignment[i] = None
    if fsdp and "data" in mesh.axis_names:
        dsz = data_axis_size(mesh)
        candidates = [i for i, a in enumerate(axes)
                      if a is None and shape[i] >= MIN_FSDP_DIM and shape[i] % dsz == 0]
        if candidates:
            assignment[max(candidates, key=lambda i: shape[i])] = "data"
    return P(*assignment)


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def param_pspecs(axes_tree, shapes_tree, mesh, *, fsdp: bool = True):
    """Tree of ``P`` matching ``axes_tree`` (``models.lm.param_axes``);
    ``shapes_tree`` holds tensors (on the meta device, say) at the same
    paths.  Leaves of ``shapes_tree`` without axes (the LSH projection) get
    no spec: they are replicated."""
    if is_axes_leaf(axes_tree):
        return _spec_for(axes_tree, tuple(shapes_tree.shape), mesh, fsdp=fsdp)
    if isinstance(axes_tree, dict):
        return {k: param_pspecs(v, shapes_tree[k], mesh, fsdp=fsdp)
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [param_pspecs(a, s, mesh, fsdp=fsdp) for a, s in zip(axes_tree, shapes_tree)]
    raise TypeError(f"unexpected axes node {type(axes_tree)}")


def batch_pspec(mesh) -> P:
    """Token batches: the batch dim over every data-parallel axis."""
    return P(dp_axes(mesh))


def dp_axes_for(mesh, dim: int) -> tuple[str, ...] | None:
    """The data-parallel axes whose product divides ``dim`` (a prefix of
    them, skipping any that would not divide)."""
    axes, prod = [], 1
    for a in dp_axes(mesh):
        size = int(mesh.shape[a])
        if dim % (prod * size) == 0:
            axes.append(a)
            prod *= size
    return tuple(axes) or None


def batch_shardings(batch_shapes: dict, mesh) -> dict:
    """Specs of an ``input_specs()`` dict: dim 0 the batch, the rest
    replicated."""
    out = {}
    for k, v in batch_shapes.items():
        spec = [None] * len(v.shape)
        spec[0] = dp_axes_for(mesh, v.shape[0])
        out[k] = P(*spec)
    return out


def kv_cache_pspec(mesh, *, seq_axis_sharded: bool) -> P:
    """(B, Hkv, S, dh) cache: batch over the data-parallel axes; the
    sequence over "model" when the head count does not divide it."""
    if seq_axis_sharded:
        return P(dp_axes(mesh), None, "model", None)
    return P(dp_axes(mesh), "model", None, None)


def expand_spec(mesh, spec) -> P:
    """An activation spec as ``layers.constrain`` reads it: ``"data"`` is
    the batch (every data-parallel axis) and ``"seq"`` the sequence
    (``CONTEXT_AXIS`` when the mesh has it, else None)."""
    ctx = CONTEXT_AXIS if CONTEXT_AXIS in mesh.axis_names else None
    return P(*(dp_axes(mesh) if s == "data" else ctx if s == "seq" else s for s in spec))


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= int(mesh.shape[a])
    return n


# ---------------------------------------------------------------------------
# Sharded tensors
# ---------------------------------------------------------------------------


def entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple[str, ...]:
    """Every mesh axis ``spec`` shards over, in order."""
    return tuple(a for e in (spec or ()) for a in entry_axes(e))


def local_slice(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec`` (a view)."""
    for dim, entry in enumerate(spec or ()):
        idx, n = coll.axes_index(mesh, entry_axes(entry))
        if n > 1:
            step = x.shape[dim] // n
            x = x.narrow(dim, idx * step, step)
    return x


def full_shape(local_shape, mesh, spec) -> tuple[int, ...]:
    shape = list(local_shape)
    for dim, entry in enumerate(spec or ()):
        shape[dim] *= coll.axes_index(mesh, entry_axes(entry))[1]
    return tuple(shape)


def gather_full(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The full tensor from every rank's block ``x`` under ``spec``: a new
    tensor, never ``x``'s storage (a replicated leaf comes back copied)."""
    out = x
    for dim, entry in enumerate(spec or ()):
        if entry is not None:
            out = coll.all_gather(out, mesh, entry_axes(entry), dim)
    return out.clone() if out is x else out


@torch.no_grad()
def gather_to(x: torch.Tensor, mesh, spec, dst: int = 0) -> torch.Tensor | None:
    """The full tensor of every rank's block ``x`` under ``spec``, on the
    host of global rank ``dst`` and None on the others (every rank must
    call it): one ``dist.gather`` of the staged blocks, so no rank holds a
    full copy on its device.  The mesh covers the world in row-major order
    (``launch.mesh.make_mesh``)."""
    if not (dist.is_available() and dist.is_initialized()):
        return x.detach().cpu().clone()
    host = coll.to_wire(x.detach().contiguous())
    rank, world = dist.get_rank(), dist.get_world_size()
    parts = [torch.empty_like(host) for _ in range(world)] if rank == dst else None
    dist.gather(host, parts, dst=dst)
    if rank != dst:
        return None
    full = torch.empty(full_shape(x.shape, mesh, spec), dtype=x.dtype)
    for r, part in enumerate(parts):
        coords, rest = {}, r
        for a in reversed(mesh.axis_names):
            coords[a], rest = rest % int(mesh.shape[a]), rest // int(mesh.shape[a])
        view = full
        for dim, entry in enumerate(spec or ()):
            idx, n = 0, 1
            for a in entry_axes(entry):
                idx, n = idx * int(mesh.shape[a]) + coords[a], n * int(mesh.shape[a])
            if n > 1:
                step = full.shape[dim] // n
                view = view.narrow(dim, idx * step, step)
        view.copy_(part)
    return full


def _zip_map(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _zip_map(v, (specs or {}).get(k), fn) for k, v in tree.items()}
    if isinstance(tree, list):
        specs = specs or [None] * len(tree)
        return [_zip_map(v, s, fn) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_params(full, mesh, specs):
    """This rank's slices of the full tensors of ``full`` (each a copy, so
    the full tree can be freed); a leaf without a spec is copied whole."""
    return _zip_map(full, specs, lambda t, s: local_slice(t, mesh, s).clone())


@torch.no_grad()
def gather_params(local, mesh, specs):
    """The full tensors of every rank's slices ``local`` (every rank must
    call it: each sharded leaf is all-gathered)."""
    return _zip_map(local, specs, lambda t, s: gather_full(t.detach(), mesh, s))


# ---------------------------------------------------------------------------
# FSDP gather on use
# ---------------------------------------------------------------------------

_PLAN: list = []


def fsdp_dims(local, specs) -> dict:
    """{id(leaf): dim} of the leaves of ``local`` whose spec puts "data" on
    a dim (their FSDP dim)."""
    out = {}

    def visit(t, s):
        for dim, entry in enumerate(s or ()):
            if "data" in entry_axes(entry):
                out[id(t)] = dim
        return t

    _zip_map(local, specs, visit)
    return out


@contextlib.contextmanager
def fsdp_gathering(mesh, local, specs):
    """Within the context ``gather_on_use`` all-gathers the FSDP dim of the
    leaves of ``local`` over "data" (and reduce-scatters their gradient
    back in the backward, which must run inside the context too)."""
    _PLAN.append((mesh, fsdp_dims(local, specs)))
    try:
        yield
    finally:
        _PLAN.pop()


def gather_on_use(tree):
    """``tree`` with every leaf the active FSDP plan shards gathered over
    "data"; ``tree`` itself when no plan is active."""
    if not _PLAN:
        return tree
    mesh, dims = _PLAN[-1]

    def one(t):
        dim = dims.get(id(t))
        return t if dim is None else coll.gather_dim(t, mesh, "data", dim)

    return tree_map(one, tree)


def active_dp():
    """(the active mesh, its data-parallel axes) when the mesh splits the
    batch over more than one rank, else None: the statistics a loss
    normalises by then sum over those axes."""
    from repro_torch.launch.mesh import active_mesh

    mesh = active_mesh()
    if mesh is None or dp_size(mesh) == 1:
        return None
    return mesh, dp_axes(mesh)
