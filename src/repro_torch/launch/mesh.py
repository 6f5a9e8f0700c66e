"""Host meshes over the ``torch.distributed`` process world
(``repro/launch/mesh.py``).

A :class:`HostMesh` names the world's axes with their sizes, this rank's
coordinate on each axis, and a process group for each axis (the ranks that
differ from this one on that axis alone).  Ranks lie on the mesh in
row-major order, as devices lie on a JAX mesh.  ``set_mesh`` makes a mesh
active (the counterpart of ``jax_compat.set_mesh`` / ``get_abstract_mesh``)
for what reads it: ``core.api.attend``'s ring dispatch, the tensor-parallel
layers and the loss (``models``), and the train step
(``train.train_step``), which sets it around its forward and backward.
``run_world`` spawns a world of processes on one host over a ``FileStore``.

The production meshes: ``make_production_mesh`` gives the reference's
(data 16, model 16), or (pod 2, data 16, model 16), as a ``DryMesh``: axis
names, sizes and one rank's coordinates with no process group, on which
the collectives return shapes and move nothing (``launch.dryrun`` traces a
rank's step on it).  ``compat_make_mesh`` is the reference's name for "a
mesh of this shape": ``make_mesh`` over the live world; a world that is
not running is never taken for a dry one (a dry mesh comes from
``make_production_mesh`` or ``dry_mesh``).
"""
from __future__ import annotations

import contextlib
import itertools
import os
import queue as queue_mod
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class HostMesh:
    """Named axes over the process world.  ``shape[a]`` is axis ``a``'s size,
    ``coords[a]`` this rank's position on it, ``ranks[a]`` the global ranks
    of this rank's group along ``a`` in coordinate order and ``groups[a]``
    its process group (None for an axis of size 1)."""

    axis_names: tuple[str, ...]
    shape: dict
    coords: dict
    ranks: dict
    groups: dict = field(default_factory=dict, compare=False)


@dataclass(frozen=True)
class DryMesh(HostMesh):
    """A mesh with no process group: the collectives
    (``distributed.collectives``) return the shapes a live world would give
    and move nothing."""


def dry_mesh(shape: tuple[int, ...], axes: tuple[str, ...], rank: int = 0) -> DryMesh:
    """The mesh ``make_mesh`` would build over a world of ``prod(shape)``
    ranks, seen from global ``rank``, without a process group."""
    world = int(torch.tensor(shape).prod())
    if len(shape) != len(axes) or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of mesh {dict(zip(axes, shape))}")
    grid = torch.arange(world).reshape(shape)
    coord = [int(c) for c in torch.nonzero(grid == rank)[0]]
    coords, ranks = {}, {}
    for i, a in enumerate(axes):
        coords[a] = coord[i]
        idx = list(coord)
        idx[i] = slice(None)
        ranks[a] = tuple(int(r) for r in grid[tuple(idx)])
    return DryMesh(tuple(axes), dict(zip(axes, shape)), coords, ranks,
                   {a: None for a in axes})


def compat_make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> HostMesh:
    """A mesh of ``shape`` over ``axes``: ``make_mesh`` over the live world
    (every rank must call it; a shape the world does not cover raises)."""
    return make_mesh(tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> DryMesh:
    """Single pod: (data 16, model 16), 256 cards.  Multi-pod: (pod 2,
    data 16, model 16), 512; "pod" is pure data parallelism.  A dry mesh
    seen from global ``rank``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dry_mesh(shape, axes, rank)


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> HostMesh:
    """A mesh of ``shape`` over the whole world, axes in ``axes`` order.  Every
    rank must call it with the same arguments: each axis group is created
    on all ranks, in one order."""
    rank, world = _world()
    if len(shape) != len(axes) or int(torch.tensor(shape).prod()) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} does not cover a world of {world}")
    grid = torch.arange(world).reshape(shape)
    coord = [int(c) for c in torch.nonzero(grid == rank)[0]]
    coords, ranks, groups = {}, {}, {}
    for i, a in enumerate(axes):
        coords[a] = coord[i]
        mine = None
        others = [range(s) for j, s in enumerate(shape) if j != i]
        for rest in itertools.product(*others):
            idx = list(rest)
            idx.insert(i, slice(None))
            members = [int(r) for r in grid[tuple(idx)]]
            group = dist.new_group(members) if shape[i] > 1 else None
            if rank in members:
                mine = (tuple(members), group)
        ranks[a], groups[a] = mine
    return HostMesh(tuple(axes), dict(zip(axes, shape)), coords, ranks, groups)


def make_host_mesh(model_parallel: int = 1, context_parallel: int = 1) -> HostMesh:
    """Mesh over the process world (a world of one without
    ``torch.distributed``).

    ``context_parallel > 1`` adds a "context" axis for ring sequence-parallel
    attention (``distributed.ring_attention``): the sequence dimension shards
    over it, so it is not a data-parallel axis."""
    n = _world()[1]
    if n % (model_parallel * context_parallel):
        raise ValueError(
            f"{n} device(s) cannot host model_parallel={model_parallel} × "
            f"context_parallel={context_parallel} (need a divisor of the "
            f"device count)"
        )
    if context_parallel > 1:
        return make_mesh((n // (model_parallel * context_parallel), context_parallel,
                          model_parallel), ("data", "context", "model"))
    return make_mesh((n // model_parallel, model_parallel), ("data", "model"))


_ACTIVE: list[HostMesh] = []


@contextlib.contextmanager
def set_mesh(mesh: HostMesh | None):
    """Make ``mesh`` the active mesh inside the context (None: no mesh)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh() -> HostMesh | None:
    """The innermost mesh ``set_mesh`` made active, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


# ---------------------------------------------------------------------------
# A world of processes on one host
# ---------------------------------------------------------------------------


def init_world(rank: int, world_size: int, store_path: str, *, backend: str = "gloo",
               timeout_s: float = 300.0) -> None:
    """Join the process group of ``world_size`` ranks that share the
    ``FileStore`` at ``store_path`` (no TCP port, so concurrent worlds on
    one host never race for one).  A rank that waits longer than
    ``timeout_s`` for a peer raises."""
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))


def _world_main(rank, world_size, store_path, backend, timeout_s, fn, args, results):
    try:
        init_world(rank, world_size, store_path, backend=backend, timeout_s=timeout_s)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def _failures(results, failed: dict, world_size: int, grace_s: float = 5.0) -> str:
    """Every rank's failure that reaches the queue within ``grace_s`` of the
    first: one rank's fault makes its peers fail too (a closed
    connection), so all are reported, in rank order."""
    end = time.monotonic() + grace_s
    while len(failed) < world_size and time.monotonic() < end:
        try:
            rank, ok, out = results.get(timeout=max(end - time.monotonic(), 0.01))
        except queue_mod.Empty:
            break
        if not ok:
            failed[rank] = out
    return "\n".join(f"rank {r} of {world_size} failed:\n{failed[r]}" for r in sorted(failed))


def run_world(fn, world_size: int, *args, backend: str = "gloo",
              timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one process group; return the ranks' results in rank
    order.  ``fn`` must be importable by the children (a module-level
    function).  Raises, with the rank's traceback, when a rank fails, and
    when the world has not finished within ``timeout_s``; every process is
    ended either way."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_world_main,
                             args=(r, world_size, store, backend, timeout_s / 2, fn, args,
                                   results), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got: dict[int, object] = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world_size:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue_mod.Empty:
                    lost = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if lost:
                        raise RuntimeError(f"rank {lost[0]} of {world_size} exited with code "
                                           f"{procs[lost[0]].exitcode} and no result") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"world of {world_size} unfinished after "
                                           f"{timeout_s} s; ranks done: {sorted(got)}") from None
                    continue
                if not ok:
                    raise RuntimeError(_failures(results, {rank: out}, world_size))
                got[rank] = out
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
            results.close()
    return [got[r] for r in range(world_size)]
