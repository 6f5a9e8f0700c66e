"""Explicit collectives over the axes of a host mesh
(``repro/distributed/collectives.py``).

**The wire layer.**  ``all_reduce``, ``all_gather``, ``reduce_scatter``,
``all_to_all`` and ``permute`` move a tensor among the ranks of one mesh axis (the ranks that
differ from this one on that axis alone: ``HostMesh.groups[axis]``), or of
several axes in turn.  An axis of size 1 moves nothing.  The group must be a
``gloo`` group, which moves host tensors only and is the backend that can
put several ranks on one card: a CUDA tensor is staged through a pinned host
buffer and its result copied back to its device.  Other backends (NCCL
across cards) are refused.  gloo has no reduce-scatter, so ``reduce_scatter``
sends each rank its slice (all-to-all) and sums what it receives; a bf16
tensor is summed in f32 (one rounding, whatever the axis size).  The ring
(``distributed/ring_attention.py``) hops on ``send_recv``.

**The dry path.**  On a dry mesh (``launch.mesh.DryMesh``: the dry run's
production mesh, axis names, sizes and this rank's coordinates with no
process group) each collective returns what it would on a live world, in
shape and dtype, without moving anything: its own operand for every peer's.
The test is by the mesh's type, and the operand must be a meta tensor (a
tensor with values raises rather than come back wrong); a live mesh whose
group is absent raises as before.  Under ``roofline.analysis.CostCounter`` each of the five wire
sites (``all_reduce``, ``all_gather``, ``reduce_scatter``, ``all_to_all``,
``send_recv``) charges the bytes it hands the wire, live or dry alike.

**Autograd.**  ``tp_enter`` (identity forward, all-reduce backward) and
``tp_reduce`` (all-reduce forward, identity backward) are the conjugate pair
that brackets a tensor-parallel region over "model"; ``gather_dim`` is the
FSDP gather (all-gather forward, reduce-scatter backward); ``sum_dp`` sums a
statistic over the data-parallel axes with the sum's own transpose;
``shift`` permutes along an axis and sends the cotangent back the other way;
``exchange`` is the all-to-all, its own transpose; ``take_slice`` (this
rank's slice of a replicated tensor) and ``gather_slices`` (the slices put
back together, replicated) are each other's transpose, as expert
parallelism (``models.moe``) brackets its sequence-sharded region with them.
The convention: a replicated value carries the same cotangent on every rank
of its axis, so a replicated parameter gets one gradient, never a sum over
the ranks that replicate it.

**The reference's building blocks.**  ``ring_allgather_matmul`` and
``psum_scatter_matmul`` take x replicated over ``axis`` and this rank's block
of W's input rows, and return this rank's output as the reference's
``out_specs`` say: the whole product, or its N-slice.  Their ``torch.matmul``
are the reference's own plain products.  ``allreduce_with_compression`` is
the data-parallel gradient mean with an optional compression hook
(``train.compression`` builds the int8 error-feedback one).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import DryMesh
from repro_torch.utils.counting import charge_collective, on_wire
from repro_torch.utils.tree import tree_map

# The group a dry mesh's axis stands for: nothing is sent.
DRY = "dry"

# ---------------------------------------------------------------------------
# The wire layer
# ---------------------------------------------------------------------------


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[axis]) if axis in mesh.axis_names else 1


def require_gloo(group, what: str) -> None:
    """Raise unless ``group`` is a gloo group (the wire stages CUDA tensors
    through host memory, which only gloo moves)."""
    backend = dist.get_backend(group)
    if backend != "gloo":
        raise NotImplementedError(
            f"{what} runs on gloo groups only (it stages CUDA tensors through host "
            f"memory); this group's backend is {backend!r}")


def _require_meta(x: torch.Tensor, what: str) -> None:
    """Raise unless ``x`` is a meta tensor: a dry mesh moves nothing, so a
    tensor with values on it would come back as its own peers'."""
    if x.device.type != "meta":
        raise RuntimeError(
            f"{what} on a dry mesh takes meta tensors, not {x.device.type} ones: a dry mesh "
            "has no process group (a live one comes from init_process_group and make_mesh)")


def _group(mesh, axis: str, x: torch.Tensor):
    """(group, size, this rank's index, the group's global ranks) of ``axis``,
    or None for an axis of size 1 (or absent).  On a dry mesh ``x``, the
    operand, must be a meta tensor."""
    size = axis_size(mesh, axis)
    if size == 1:
        return None
    if isinstance(mesh, DryMesh):
        _require_meta(x, f"a collective over {axis!r}")
        return DRY, size, int(mesh.coords[axis]), mesh.ranks[axis]
    group = mesh.groups[axis]
    require_gloo(group, f"a collective over {axis!r}")
    return group, size, int(mesh.coords[axis]), mesh.ranks[axis]


def to_wire(x: torch.Tensor) -> torch.Tensor:
    """x on the host (gloo moves host tensors only), pinned when staged from
    the card."""
    if not x.is_cuda:
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return host


def _host_empty(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype, pin_memory=like.is_pinned())


@on_wire
def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` reduced (``sum`` or ``max``) over every rank of
    ``axes`` (one axis or several), on ``x``'s device and in its dtype."""
    out = x
    for axis in _axes(axes):
        g = _group(mesh, axis, out)
        if g is None:
            continue
        src = out.float() if out.dtype in (torch.bfloat16, torch.float16) else out
        charge_collective("all-reduce", src)
        if g[0] is DRY:
            out = src.to(dtype=x.dtype, copy=True)
            continue
        wire = to_wire(src)
        if wire is x:
            wire = wire.clone()  # never reduce into the caller's tensor
        dist.all_reduce(wire, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=g[0])
        out = wire.to(device=x.device, dtype=x.dtype)
    return out if out is not x else x.clone()


@on_wire
def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``axes`` concatenated along ``dim`` in mesh
    order (row-major over several axes: the last axis varies fastest)."""
    out = x
    for axis in reversed(_axes(axes)):
        g = _group(mesh, axis, out)
        if g is None:
            continue
        group, size = g[0], g[1]
        charge_collective("all-gather", out)
        if group is DRY:
            out = torch.cat([out] * size, dim=dim)
            continue
        wire = to_wire(out.contiguous())
        parts = _host_empty((size, *wire.shape), wire)
        dist.all_gather(list(parts.unbind(0)), wire, group=group)
        parts = parts.to(out.device)
        out = torch.cat(parts.unbind(0), dim=dim)
    return out


def axes_index(mesh, axes) -> tuple[int, int]:
    """(this rank's row-major index over ``axes``, their product size)."""
    idx, n = 0, 1
    for axis in _axes(axes):
        s = axis_size(mesh, axis)
        idx, n = idx * s + (int(mesh.coords[axis]) if s > 1 else 0), n * s
    return idx, n


@on_wire
def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` (mesh order, as ``all_gather``
    concatenates) of ``x`` summed over ``axes``: an all-to-all of the
    slices, then a local sum (in f32 for bf16)."""
    out = x
    for axis in _axes(axes):
        g = _group(mesh, axis, out)
        if g is None:
            continue
        group, size = g[0], g[1]
        src = out.float() if out.dtype in (torch.bfloat16, torch.float16) else out
        parts = torch.stack(src.chunk(size, dim=dim))  # (size, ...): slice i to rank i
        charge_collective("reduce-scatter", parts)
        if group is DRY:
            out = parts[0].to(dtype=x.dtype, copy=True)
            continue
        send = to_wire(parts)
        recv = _host_empty(send.shape, send)
        dist.all_to_all_single(recv, send, group=group)
        out = recv.sum(0).to(device=x.device, dtype=x.dtype)
    return out if out is not x else x.clone()


@on_wire
def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Chunk j of ``x``'s dim 0 (cut in equal chunks, one a rank of
    ``axis``) goes to rank j; returns the chunks received, chunk i from rank
    i, in ``x``'s shape, on its device."""
    g = _group(mesh, axis, x)
    if g is None:
        return x.clone()
    if x.shape[0] % g[1]:
        raise ValueError(f"dim 0 of {x.shape[0]} rows does not split over {g[1]} ranks")
    charge_collective("all-to-all", x)
    if g[0] is DRY:
        return x.clone()
    send = to_wire(x.contiguous())
    recv = _host_empty(send.shape, send)
    dist.all_to_all_single(recv, send, group=g[0])
    return recv.to(x.device)


@on_wire
def send_recv(flat: torch.Tensor, group, dst: int, src: int) -> torch.Tensor:
    """Send ``flat`` to global rank ``dst`` while receiving a tensor of its
    shape and dtype from ``src``, on ``flat``'s device (a dry group:
    ``flat`` itself, copied)."""
    charge_collective("collective-permute", flat)
    if group is DRY:
        _require_meta(flat, "a send and receive")
        return flat.clone()
    send = to_wire(flat)
    recv = _host_empty(send.shape, send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                   dist.P2POp(dist.irecv, recv, src, group)])
    for req in reqs:
        req.wait()
    return recv.to(flat.device, non_blocking=True)


def permute(x: torch.Tensor, mesh, axis: str, by: int) -> torch.Tensor:
    """Every rank of ``axis`` sends ``x`` ``by`` positions on (cyclically)
    and returns what it received from ``by`` positions back."""
    g = _group(mesh, axis, x)
    if g is None:
        return x.clone()
    group, size, idx, ranks = g
    flat = x.contiguous().view(-1).view(torch.uint8)
    got = send_recv(flat, group, ranks[(idx + by) % size], ranks[(idx - by) % size])
    return got.view(x.dtype).view(x.shape)


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, by):
        ctx.mesh, ctx.axis, ctx.by = mesh, axis, by
        return permute(x, mesh, axis, by)

    @staticmethod
    def backward(ctx, g):
        return permute(g, ctx.mesh, ctx.axis, -ctx.by), None, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        # Chunk j of rank i went to rank j's chunk i: the same exchange sends
        # each cotangent chunk back where its value came from.
        return all_to_all(g, ctx.mesh, ctx.axis), None, None


def _own_slice(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    step = x.shape[dim] // n
    return x.narrow(dim, int(mesh.coords[axis]) * step, step)


class _TakeSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own_slice(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        # x is replicated, so its cotangent is too: every rank's slice of it.
        return all_gather(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _GatherSlices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        # The replicated result's cotangent is the same on every rank: each
        # takes its own slice of it.
        return _own_slice(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


def tp_enter(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Enter a tensor-parallel region: identity forward; the backward
    all-reduces the cotangent (each rank holds a partial one)."""
    return _Enter.apply(x, mesh, axis) if axis_size(mesh, axis) > 1 else x


def tp_reduce(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Leave a tensor-parallel region: sum the ranks' partials forward; the
    cotangent of the replicated sum passes through unchanged."""
    return _Reduce.apply(x, mesh, axis) if axis_size(mesh, axis) > 1 else x


def gather_dim(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` (forward), reduce-scatter of the cotangent
    (backward): the FSDP gather on use."""
    if all(axis_size(mesh, a) == 1 for a in _axes(axes)):
        return x
    return _GatherDim.apply(x, mesh, _axes(axes), dim)


def sum_dp(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum a per-rank statistic over ``axes``; the backward sums the ranks'
    cotangents, as the sum's transpose under a loss that is the sum of the
    ranks' losses."""
    if all(axis_size(mesh, a) == 1 for a in _axes(axes)):
        return x
    return _SumBoth.apply(x, mesh, _axes(axes))


def shift(x: torch.Tensor, mesh, axis: str, by: int = 1) -> torch.Tensor:
    """``permute`` by ``by``, differentiable: the backward permutes the
    cotangent by ``-by``."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Shift.apply(x, mesh, axis, by)


def exchange(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``all_to_all``, differentiable: the backward is the same exchange of
    the cotangent."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Exchange.apply(x, mesh, axis)


def take_slice(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``x``, replicated over ``axis``
    (which must divide it); the backward all-gathers the slices'
    cotangents into the replicated one."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {x.shape[dim]} does not split over the {n} ranks of "
                         f"{axis!r}")
    return _TakeSlice.apply(x, mesh, axis, dim)


def gather_slices(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's slice ``x`` of ``axis`` put back together along ``dim``,
    replicated; the backward takes this rank's slice of the cotangent."""
    if axis_size(mesh, axis) == 1:
        return x
    return _GatherSlices.apply(x, mesh, axis, dim)


# ---------------------------------------------------------------------------
# The reference's building blocks
# ---------------------------------------------------------------------------


def ring_allgather_matmul(x: torch.Tensor, w_local: torch.Tensor, mesh,
                          axis: str = "model") -> torch.Tensor:
    """``x @ W`` where W's input dim is sharded over ``axis``: x (..., K)
    replicated, ``w_local`` (K/P, N) this rank's block.  At ring step i each
    rank multiplies the x-chunk of the block it holds while the blocks move
    one hop on; every rank ends with the whole (..., N) product."""
    p = axis_size(mesh, axis)
    idx = int(mesh.coords[axis]) if p > 1 else 0
    k_loc = w_local.shape[0]

    def chunk(i):
        return x.narrow(-1, ((idx + i) % p) * k_loc, k_loc)

    acc = chunk(0) @ w_local
    w = w_local
    for i in range(1, p):
        # After i hops back this rank holds block (idx + i) mod p.
        w = permute(w, mesh, axis, -1)
        acc = acc + chunk(i) @ w
    return acc


def psum_scatter_matmul(x: torch.Tensor, w_local: torch.Tensor, mesh,
                        axis: str = "model") -> torch.Tensor:
    """Row-parallel ``x @ W`` with a reduce-scatter epilogue: x (..., K)
    replicated (each rank takes its K block), ``w_local`` (K/P, N) → this
    rank's (..., N/P) slice of the product."""
    p = axis_size(mesh, axis)
    idx = int(mesh.coords[axis]) if p > 1 else 0
    k_loc = w_local.shape[0]
    partial = x.narrow(-1, idx * k_loc, k_loc) @ w_local
    return reduce_scatter(partial, mesh, axis, partial.ndim - 1)


def allreduce_with_compression(grads, mesh, *, compress_fn=None, decompress_fn=None):
    """The data-parallel gradient mean over every axis but "model", with a
    compression hook: ``compress_fn`` before the mean and
    ``decompress_fn`` after it (identity: the plain mean)."""
    axes = tuple(a for a in mesh.axis_names if a != "model")
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)

    def one(g):
        if compress_fn is not None:
            g = compress_fn(g)
        g = all_reduce(g, mesh, axes) / n
        if decompress_fn is not None:
            g = decompress_fn(g)
        return g

    return tree_map(one, grads)
