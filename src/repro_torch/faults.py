"""Deterministic fault injection for the serving and training tiers (a copy
of ``repro.faults``' catalog and trigger semantics).

The engines and the scheduler consult a :class:`FaultInjector` at named
fault points; each point models one production failure, so the chaos tests
can show that every request still ends in an explicit terminal status,
that nothing leaks, and that only the request at fault is affected.

Serve points:

  pool_exhausted    ``PagedServeEngine.alloc`` fails although blocks are
                    free (fragmentation, an allocator bug under load).
  nan_logits        a request's logits row turns NaN wherever logits are
                    produced (prefill, chunk window, decode step, decode
                    tick); the numeric health guards quarantine it.
  stuck_step        a model step raises :class:`InjectedFault` before it
                    touches any cache or pool; the culprit is retried a
                    bounded number of times, then failed.
  restore_failure   ``restore`` of a preempted request's KV raises (a
                    host-device copy failure); retried with doubling
                    backoff, bounded, then the request fails.
  slow_step         the clock jumps forward by ``delay`` (a straggling
                    step); deadlines expire without a wall-clock sleep.
  dead_ring_shard   a ring context-parallel KV shard never arrives.
  mesh_prefill      the whole-prompt ring prefill of a mesh replica raises.
  replica_crash     a whole replica dies (``uid`` is the replica id).

The last three belong to the ring (``distributed.ring_attention.
dead_shard_fault``, which a mesh engine's ``prefill_mesh_run`` enters and
sends to its followers), the paged engine's mesh prefill
(``PagedServeEngine.prefill_mesh_run``) and the cluster router
(``serve.cluster``).

Train points: ``ckpt_torn_write`` (a checkpoint publishes corrupt bytes;
``uid`` is the step), ``nan_grad`` (the loss goes non-finite in the step),
``loss_spike`` (loss and grad norm jump by ``scale``), ``worker_loss`` and
``slow_worker`` (``uid`` is the worker id; ``delay`` inflates its step
time) and ``data_shard_corrupt`` (a batch arrives with scrambled labels).

Triggers are counted: a :class:`FaultSpec` fires on its matching hits
``after <= hit < after + times`` (``times=-1``: forever), so a fault is
transient or persistent and every run is reproducible.
"""
from __future__ import annotations

from dataclasses import dataclass, field

#: Fault points consulted by the serving tier.
SERVE_POINTS = (
    "pool_exhausted",
    "nan_logits",
    "stuck_step",
    "restore_failure",
    "slow_step",
    "dead_ring_shard",
    "mesh_prefill",
    "replica_crash",
)

#: Fault points consulted by the training tier.
TRAIN_POINTS = (
    "ckpt_torn_write",
    "nan_grad",
    "loss_spike",
    "worker_loss",
    "slow_worker",
    "data_shard_corrupt",
)

#: The catalog a FaultSpec validates against.
POINTS = SERVE_POINTS + TRAIN_POINTS


class InjectedFault(Exception):
    """An injected failure raised through an engine primitive; carries the
    point and the culprit uid, so the scheduler retries or fails exactly
    that request and keeps the batch alive."""

    def __init__(self, point: str, uid: int | None = None):
        self.point = point
        self.uid = uid
        super().__init__(f"injected fault {point!r} (uid={uid})")


@dataclass
class FaultSpec:
    """One trigger: fire ``point`` on hits ``after <= hit < after + times``
    (``times=-1``: forever), only for ``uid`` when it is given.  ``delay``
    is the clock jump of ``slow_step`` (and the step-time inflation of
    ``slow_worker``), ``scale`` the loss multiplier of ``loss_spike``
    (0: the trainer's default), ``shards`` the dead set of
    ``dead_ring_shard``."""

    point: str
    uid: int | None = None
    after: int = 0
    times: int = 1
    delay: float = 0.0
    scale: float = 0.0
    shards: tuple[int, ...] = ()
    _hits: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown fault point {self.point!r}; catalog: {POINTS}")

    def _matches(self, uid: int | None) -> bool:
        return self.uid is None or uid == self.uid

    def _hit(self) -> bool:
        """Count one hit; True when it lies inside the firing window."""
        h = self._hits
        self._hits += 1
        if h < self.after:
            return False
        return self.times < 0 or h < self.after + self.times


class FaultInjector:
    """A set of :class:`FaultSpec` triggers.  ``fires(point, uid)`` counts
    one hit on every matching spec and returns the first whose window
    covers it, else None: host-side bookkeeping, deterministic."""

    def __init__(self, specs: list[FaultSpec] | tuple[FaultSpec, ...] = ()):
        self.specs = list(specs)

    def fires(self, point: str, uid: int | None = None) -> FaultSpec | None:
        fired = None
        for s in self.specs:
            if s.point == point and s._matches(uid) and s._hit() and fired is None:
                fired = s
        return fired

    def raise_if(self, point: str, uid: int | None = None) -> None:
        if self.fires(point, uid) is not None:
            raise InjectedFault(point, uid)

    def dead_shards(self) -> frozenset[int]:
        """The union of the shard ids of every ``dead_ring_shard`` spec."""
        out: set[int] = set()
        for s in self.specs:
            if s.point == "dead_ring_shard":
                out.update(s.shards)
        return frozenset(out)


#: The engines' default: nothing is injected.
NULL_INJECTOR = FaultInjector(())
