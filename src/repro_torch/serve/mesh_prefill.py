"""Serving over a context mesh: the leader rank and its followers.

The reference's engines take a ``mesh`` and one controller runs each
prefill over all of it (``ServeEngine(mesh=)``, ``PagedServeEngine(mesh=)``).
The port's mesh is a set of processes (``launch.mesh``), so a serving
context group splits the work:

* the **leader**, the rank at coordinate 0 of the context axis
  (``cfg.attention.context_axis``), holds the engine, its scheduler and its
  cache or block pool.  Before each prefill that takes the ring
  (``core.api.ring_mesh``: a kernel impl, the context axis at size > 1, a
  bucket of at least ring size × ``MIN_RING_SHARD``) the engine's
  ``MeshLink`` broadcasts one fixed-size header over the group: the op, the
  bucket, the prompt length, the G* the prefill runs at (1: exact), the
  dead-shard set and the token row, padded to ``max_len``;
* every other rank of the group runs ``follow``: it holds the same params
  and no cache, waits for a header (never longer than ``timeout_s``) and
  runs the same forward under the mesh and the header's dead shards, so
  that its part of every ring hop happens; what it computes is dropped.
  Under the ring's contract every rank holds every layer's global K/V, so
  the leader writes them into its own cache or pool with no gather.

Every rank rewires the ring from the header's dead-shard set, never from a
fault injector of its own.  The leader's engine raises every injected fault
before it sends a header (a raise after it would leave the followers inside
a collective), and sends a stop header when it closes (``close()``, or the
end of its ``with`` block, an exception included); a follower then
returns.  A follower serves one engine: a leader that builds several
engines over one group has its followers call ``follow`` once for each, in
order.  The group must be a ``gloo`` group, as the ring's is.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as coll
from repro_torch.launch.mesh import set_mesh

OP_STOP, OP_PREFILL = 0, 1
_FIELDS = 4  # op, bucket, n, G*; then the dead-shard mask and the token row


def _context_axis(cfg, mesh) -> str | None:
    """The mesh's context axis when the engine's prefill can take the ring
    over it (``cfg.attention.context_axis``, at size > 1), else None.
    Raises for a mesh with another axis of size > 1: the port serves one
    context group."""
    others = {a: int(mesh.shape[a]) for a in mesh.axis_names
              if a != cfg.attention.context_axis and int(mesh.shape[a]) > 1}
    if others:
        raise NotImplementedError(f"serving on a mesh with {others} beside the context axis "
                                  "is not ported: a serving mesh is one context group")
    axis = cfg.attention.context_axis
    if not axis or axis not in mesh.axis_names or int(mesh.shape[axis]) == 1:
        return None
    return axis


class MeshLink:
    """The leader's end of a context group: sends the headers."""

    def __init__(self, mesh, axis: str, max_len: int):
        self.mesh, self.axis, self.max_len = mesh, axis, max_len
        self.size = int(mesh.shape[axis])
        self.group = mesh.groups[axis]
        self.src = mesh.ranks[axis][0]
        coll.require_gloo(self.group, "a serving context group")
        self.closed = False
        self.sent = 0  # prefill headers

    def send(self, op: int, *, bucket: int = 0, n: int = 0, group: int = 1, dead=(),
             tokens=()) -> None:
        if self.closed:
            raise RuntimeError("the context group's followers were stopped")
        head = torch.zeros(_FIELDS + self.size + self.max_len, dtype=torch.int64)
        head[:_FIELDS] = torch.tensor([op, bucket, n, group])
        for s in dead:
            if 0 <= int(s) < self.size:  # a shard past the ring is no hop's source
                head[_FIELDS + int(s)] = 1
        tokens = list(tokens)
        head[_FIELDS + self.size:_FIELDS + self.size + len(tokens)] = torch.tensor(
            tokens, dtype=torch.int64)
        dist.broadcast(head, src=self.src, group=self.group)
        self.sent += op == OP_PREFILL

    def prefill(self, bucket: int, tokens, *, n: int, group: int = 1, dead=()) -> None:
        """Tell the followers to run the prefill of ``tokens`` (a bucket's
        row)."""
        if bucket > self.max_len:
            raise ValueError(f"bucket {bucket} exceeds the group's max_len {self.max_len}")
        self.send(OP_PREFILL, bucket=bucket, n=n, group=group, dead=dead, tokens=tokens)

    def close(self) -> None:
        """Send the stop header, once."""
        if not self.closed:
            self.send(OP_STOP)
            self.closed = True


def leader_link(cfg, mesh, max_len: int) -> MeshLink | None:
    """The engine's link to its followers, or None when its prefill never
    takes a ring (no mesh, or no context axis of size > 1 on it).  Raises
    on a rank that is not its context group's leader."""
    if mesh is None:
        return None
    axis = _context_axis(cfg, mesh)
    if axis is None:
        return None
    if int(mesh.coords[axis]) != 0:
        raise ValueError(f"a serving engine runs on its context group's leader (coordinate 0 "
                         f"of {axis!r}); this rank is at {mesh.coords[axis]}: run "
                         "serve.mesh_prefill.follow here")
    return MeshLink(mesh, axis, max_len)


@torch.no_grad()
def follow(cfg, params, mesh, *, max_len: int, device: str | torch.device = "cuda",
           timeout_s: float = 600.0) -> dict:
    """The follower loop of one engine (see the module docstring): run each
    prefill the leader announces until it sends the stop header.  ``cfg``,
    ``params`` and ``max_len`` are the leader engine's.  Raises
    ``TimeoutError`` when no header comes within ``timeout_s`` (a leader
    that died or hangs cannot hold this rank).  Returns {"prefills": count,
    "buckets": [...], "dead": [the dead-shard set of each]}."""
    from repro_torch.distributed.ring_attention import dead_shard_fault
    from repro_torch.models import lm
    from repro_torch.tune.autotune import warm_paged_engine

    axis = _context_axis(cfg, mesh)
    if axis is None or int(mesh.coords[axis]) == 0:
        raise ValueError("follow runs on a context group's follower ranks")
    size = int(mesh.shape[axis])
    group, src = mesh.groups[axis], mesh.ranks[axis][0]
    coll.require_gloo(group, "a serving context group")
    with set_mesh(mesh):  # the prefill buckets' keys, per ring shard as the leader's
        warm_paged_engine(cfg, max_len, device=device, decode=False, mesh_prefill_buckets=True)
    head = torch.empty(_FIELDS + size + max_len, dtype=torch.int64)
    stats = {"prefills": 0, "buckets": [], "dead": []}
    while True:
        work = dist.broadcast(head, src=src, group=group, async_op=True)
        try:
            work.wait(timeout=datetime.timedelta(seconds=timeout_s))
        except RuntimeError as e:  # gloo's timeout, or the leader's connection lost
            raise TimeoutError(f"no header from the context group's leader (rank {src}) "
                               f"within {timeout_s} s: {e}") from e
        op, bucket, n, g = (int(v) for v in head[:_FIELDS])
        if op == OP_STOP:
            return stats
        if op != OP_PREFILL or not 0 < n <= bucket <= max_len:
            raise RuntimeError(f"malformed header: op {op}, bucket {bucket}, n {n}")
        dead = frozenset(i for i in range(size) if head[_FIELDS + i])
        tokens = head[_FIELDS + size:_FIELDS + size + bucket][None].to(device)
        bcfg = cfg if g <= 1 else cfg.replace(attention=cfg.attention.degraded(g))
        with set_mesh(mesh), dead_shard_fault(dead):
            lm.backbone(params, bcfg, tokens, collect_cache=True)
        stats["prefills"] += 1
        stats["buckets"].append(bucket)
        stats["dead"].append(sorted(dead))
