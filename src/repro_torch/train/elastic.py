"""Elasticity, failure handling and straggler mitigation: the control-plane
logic (pure Python), the port's copy of ``repro.train.elastic``.

When a host drops, a job controller (1) drains, (2) checkpoints from the
surviving hosts, (3) replans the mesh for the surviving device count and
(4) restarts from the latest step with a deterministic re-assignment of
data shards.  These helpers are the deterministic pieces of that loop;
``train.supervisor.TrainSupervisor`` drives them against a live Trainer.
``COUNTER_KEYS`` is the frozen schema ``Trainer.counters_snapshot`` and
``obs.metrics.train_registry`` read.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# -- frozen observability schema --------------------------------------------
# The training analog of serve.lifecycle.COUNTER_KEYS: the Trainer and
# the TrainSupervisor snapshot against THIS key set (zero-filled);
# the reference's tests freeze it and the port's tests hold it equal.
# Adding a counter means adding it here, on purpose.

#: Robustness counters of the Trainer and the supervisor.
COUNTER_KEYS = (
    "nan_skips",  # in-step NaN guard suppressed an update
    "rollbacks",  # anomaly guard restored params+opt from a checkpoint
    "anomaly_halts",  # rollback retries exhausted → AnomalyHalt
    "torn_ckpt_fallbacks",  # resume/rollback skipped corrupt checkpoints
    "data_corrupt_batches",  # injected data_shard_corrupt batches seen
    "emergency_saves",  # best-effort checkpoint on an escaping exception
    "emergency_save_failures",  # ... and the save itself failed (logged)
    "remesh_events",  # mesh replanned to a new survivor count
    "worker_deaths",  # workers declared dead by the FailureDetector
    "straggler_flags",  # StragglerPolicy flag events (per worker per tick)
)


def counters_view(counters) -> dict:
    """Freeze a Counter/dict into the canonical zero-filled schema."""
    return {k: int(counters.get(k, 0)) for k in COUNTER_KEYS}


def reassign_shards(num_shards: int, alive_workers: list[int]) -> dict[int, list[int]]:
    """Deterministic round-robin data-shard → surviving-worker assignment.

    Restart-safe: depends only on (num_shards, sorted alive set).
    """
    alive = sorted(alive_workers)
    if not alive:
        raise ValueError("no surviving workers")
    out: dict[int, list[int]] = {w: [] for w in alive}
    for s in range(num_shards):
        out[alive[s % len(alive)]].append(s)
    return out


def replan_mesh(n_devices: int, *, model_parallel: int = 16,
                pods: int | None = None) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest (pod, data, model) mesh fitting the surviving device count.

    Keeps TP fixed (model_parallel must divide per-pod devices — resharding
    TP means re-tiling every weight, whereas shrinking DP is free with
    mesh-agnostic checkpoints).
    """
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by TP={model_parallel}")
    data = n_devices // model_parallel
    if pods and pods > 1:
        if data % pods:
            pods = 1  # fall back to single logical pod
        else:
            return (pods, data // pods, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")


@dataclass
class StragglerPolicy:
    """Flag workers whose step time exceeds ``threshold``× the median.

    The trainer reacts by (a) logging, (b) after ``patience`` consecutive
    flags, excluding the worker and triggering the elastic replan path.
    """

    threshold: float = 2.0
    patience: int = 3

    def flag(self, step_times: dict[int, float]) -> list[int]:
        if not step_times:
            return []
        times = sorted(step_times.values())
        median = times[len(times) // 2]
        return [w for w, t in step_times.items() if t > self.threshold * median]


@dataclass
class StragglerTracker:
    """Stateful wrapper over :class:`StragglerPolicy`: tracks *consecutive*
    flags per worker and reports the ones that crossed ``patience`` —
    the point where the supervisor excludes the worker and triggers the
    elastic replan path.  A single slow step clears on the next fast one;
    only a persistent straggler escalates."""

    policy: StragglerPolicy = field(default_factory=StragglerPolicy)
    _consecutive: dict[int, int] = field(default_factory=dict, repr=False)

    def observe(self, step_times: dict[int, float]) -> tuple[list[int], list[int]]:
        """Feed one round of per-worker step times → ``(flagged, to_exclude)``:
        workers flagged this round, and those whose consecutive-flag streak
        just reached ``policy.patience``."""
        flagged = set(self.policy.flag(step_times))
        to_exclude = []
        for w in step_times:
            if w in flagged:
                self._consecutive[w] = self._consecutive.get(w, 0) + 1
                if self._consecutive[w] == self.policy.patience:
                    to_exclude.append(w)
            else:
                self._consecutive[w] = 0
        return sorted(flagged), sorted(to_exclude)

    def forget(self, worker: int) -> None:
        """Drop tracking for an excluded/dead worker."""
        self._consecutive.pop(worker, None)


class FailureDetector:
    """Heartbeat bookkeeping: a worker missing ``max_missed`` beats is dead."""

    def __init__(self, workers: list[int], max_missed: int = 3):
        self.max_missed = max_missed
        self._missed = {w: 0 for w in workers}

    def beat(self, worker: int) -> None:
        if worker in self._missed:
            self._missed[worker] = 0

    def tick(self) -> list[int]:
        """Advance one heartbeat interval; returns newly-dead workers."""
        dead = []
        for w in list(self._missed):
            self._missed[w] += 1
            if self._missed[w] >= self.max_missed:
                dead.append(w)
                del self._missed[w]
        return dead

    @property
    def alive(self) -> list[int]:
        return sorted(self._missed)
