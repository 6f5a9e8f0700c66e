"""Elastic training supervisor: heartbeats, remesh, restore, stragglers (the
port's copy of ``repro.train.supervisor``).

``TrainSupervisor`` drives the control-plane pieces of
:mod:`repro_torch.train.elastic` against a live
:class:`~repro_torch.train.trainer.Trainer` under simulated workers: the
training counterpart of the serving tier's ``ClusterRouter``.  One tick is
one heartbeat interval and one training step:

1. consult the fault points ``worker_loss`` and ``slow_worker`` (``uid`` =
   the worker id): a lost worker never beats again, a slow one reports an
   inflated step time;
2. feed the surviving heartbeats to the :class:`FailureDetector` and the
   step times to a :class:`StragglerTracker`; a worker flagged
   ``patience`` times in a row is excluded (it stops beating, so it leaves
   through the same death path);
3. on newly dead workers: ``replan_mesh`` to the survivors' count,
   ``reassign_shards`` deterministically, and restore the Trainer from the
   last verified checkpoint, then go on;
4. run one guarded training step (``Trainer.step_once``: the NaN skip, the
   anomaly rollback and the periodic checkpoint all apply).

The workers are simulated: the model runs on the Trainer's one device,
whatever the plan says.  Every decision (death detection, the replan,
shard reassignment, restore and continue) is the deterministic logic a real
job controller would run.  Because a restore replays params, optimizer
state and the data cursor from the checkpoint, and the data stream is
deterministic, the loss history after a recovery is that of an
uninterrupted run, to the device's determinism.

``counters_snapshot()`` follows the frozen ``train.elastic.COUNTER_KEYS``,
merging the Trainer's counters with the supervisor's remesh and straggler
counts.
"""
from __future__ import annotations

from collections import Counter

from repro_torch.faults import NULL_INJECTOR
from repro_torch.obs.trace import get_recorder
from repro_torch.train.elastic import (
    FailureDetector,
    StragglerPolicy,
    StragglerTracker,
    counters_view,
    reassign_shards,
    replan_mesh,
)


class NoSurvivorsError(RuntimeError):
    """Every worker died; the job cannot continue (the last verified
    checkpoint on disk is the restart point)."""


class TrainSupervisor:
    """Drives a Trainer under simulated elastic membership.

    ``trainer`` needs the Trainer surface: ``step``, ``step_once()``,
    ``restore_from_checkpoint()``, ``counters``; tests drive a
    lightweight fake through here.  ``clock`` is injectable and only
    used to timestamp events (ticks are the logical time base).
    """

    def __init__(
        self,
        trainer,
        *,
        num_workers: int = 4,
        model_parallel: int = 1,
        num_shards: int | None = None,
        max_missed: int = 3,
        straggler_policy: StragglerPolicy | None = None,
        base_step_time: float = 1.0,
        faults=None,
        clock=None,
        trace=None,
    ):
        if num_workers < 1:
            raise ValueError("need at least one worker")
        self.trainer = trainer
        self.model_parallel = model_parallel
        self.num_shards = num_shards or 2 * num_workers
        self.base_step_time = base_step_time
        self.faults = faults or NULL_INJECTOR
        self.clock = clock or (lambda: float(self.ticks))
        self.trace = trace if trace is not None else get_recorder()
        self.ticks = 0
        self.counters: Counter = Counter()
        self.detector = FailureDetector(
            list(range(num_workers)), max_missed=max_missed
        )
        self.straggler = StragglerTracker(straggler_policy or StragglerPolicy())
        #: workers that crashed / were excluded — they never heartbeat again
        self.lost: set[int] = set()
        self.mesh_plan = replan_mesh(
            num_workers * model_parallel, model_parallel=model_parallel
        )
        self.shard_assignment = reassign_shards(
            self.num_shards, self.detector.alive
        )
        self.events: list[dict] = []

    # ------------------------------------------------------------------
    @property
    def alive(self) -> list[int]:
        return self.detector.alive

    def counters_snapshot(self) -> dict:
        """Merged Trainer + supervisor robustness counters, zero-filled to
        the frozen train.elastic.COUNTER_KEYS schema."""
        merged = Counter(getattr(self.trainer, "counters", {}))
        merged.update(self.counters)
        return counters_view(merged)

    # ------------------------------------------------------------------
    def _handle_deaths(self, dead: list[int]) -> None:
        for w in dead:
            self.straggler.forget(w)
        self.counters["worker_deaths"] += len(dead)
        survivors = self.detector.alive
        if not survivors:
            raise NoSurvivorsError(
                f"all workers dead at tick {self.ticks}; restart from the "
                "last verified checkpoint"
            )
        self.counters["remesh_events"] += 1
        self.mesh_plan = replan_mesh(
            len(survivors) * self.model_parallel,
            model_parallel=self.model_parallel,
        )
        self.shard_assignment = reassign_shards(self.num_shards, survivors)
        restored = self.trainer.restore_from_checkpoint()
        self.events.append({
            "tick": self.ticks, "t": self.clock(), "kind": "remesh",
            "dead": sorted(dead), "survivors": survivors,
            "mesh": self.mesh_plan[0], "restored_step": restored,
        })
        self.trace.instant("remesh", tick=self.ticks, dead=sorted(dead),
                           survivors=len(survivors), restored_step=restored)
        print(
            f"[supervisor] tick {self.ticks}: workers {sorted(dead)} lost; "
            f"remeshed to {self.mesh_plan[0]} over {len(survivors)} "
            f"worker(s), restored from verified step {restored}"
        )

    def tick(self) -> dict | None:
        """One heartbeat interval + one training step.  Returns the
        Trainer's history record (None when the step was consumed by an
        anomaly rollback)."""
        self.ticks += 1
        # 1) membership faults: a crashed worker never beats again
        for w in list(self.detector.alive):
            if w not in self.lost and (
                self.faults.fires("worker_loss", uid=w) is not None
            ):
                self.lost.add(w)
                self.events.append({
                    "tick": self.ticks, "t": self.clock(),
                    "kind": "worker_loss", "worker": w,
                })
                self.trace.instant("worker_loss", tick=self.ticks, worker=w)
        # 2) step-time reports from workers that are still responsive
        step_times = {}
        for w in self.detector.alive:
            if w in self.lost:
                continue
            t = self.base_step_time
            spec = self.faults.fires("slow_worker", uid=w)
            if spec is not None:
                t += spec.delay if spec.delay > 0 else self.base_step_time * 4
            step_times[w] = t
        flagged, to_exclude = self.straggler.observe(step_times)
        self.counters["straggler_flags"] += len(flagged)
        for w in to_exclude:
            # a persistent straggler is excluded: it stops being heartbeat,
            # so it drains through the same detector-death → remesh path a
            # crash does (one recovery mechanism, not two)
            self.lost.add(w)
            self.events.append({
                "tick": self.ticks, "t": self.clock(),
                "kind": "straggler_excluded", "worker": w,
            })
            self.trace.instant("straggler_excluded", tick=self.ticks,
                               worker=w)
        # 3) heartbeats + death detection
        for w in step_times:
            if w not in self.lost:
                self.detector.beat(w)
        dead = self.detector.tick()
        if dead:
            self._handle_deaths(dead)
        # 4) one guarded training step
        return self.trainer.step_once()

    def run(self, num_steps: int, *, max_ticks: int | None = None) -> list[dict]:
        """Advance the Trainer ``num_steps`` beyond its current step, under
        supervision.  Rollbacks/restores rewind the Trainer, so the tick
        count can exceed ``num_steps``; ``max_ticks`` (default 10×) bounds
        a pathological loop the same way the serve engines' step budgets
        do."""
        target = self.trainer.step + num_steps
        budget = self.ticks + (max_ticks if max_ticks is not None
                               else 10 * num_steps)
        while self.trainer.step < target:
            if self.ticks >= budget:
                raise RuntimeError(
                    f"supervisor exhausted {budget} ticks with the trainer "
                    f"at step {self.trainer.step} < target {target}"
                )
            self.tick()
        return self.trainer.history
