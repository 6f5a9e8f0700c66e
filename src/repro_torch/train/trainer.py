"""Training loop with the reference's guards (``repro.train.trainer``): the
NaN guard, anomaly rollback, periodic and emergency checkpoints, verified
resume, fault injection and trace spans, on one device or a mesh.

* **NaN guard** (train_step): a non-finite loss or grad norm skips the
  update inside the step; the Trainer counts the skip and either continues
  (``nan_policy="skip"``) or halts with a tagged checkpoint.
* **Anomaly guard** (train.anomaly): an EWMA/z-score detector over the loss
  and grad-norm streams catches finite divergence.  On a spike the Trainer
  restores params and AdamW state from the last verified checkpoint, in
  place, and does NOT rewind the data stream, so the bad batch is never
  replayed.  Consecutive rollbacks without a new checkpoint between them
  are bounded by ``AnomalyConfig.max_rollbacks``; past it the Trainer makes
  an ``-anomaly-halt`` save and raises :class:`AnomalyHalt`.
* **Verified resume** (train.checkpoint): construction resumes from the
  newest checkpoint that verifies, counting the torn ones it skipped in
  ``counters["torn_ckpt_fallbacks"]``; with none it writes a baseline at
  step 0, so the guard always has a rollback target.
* **Emergency save**: an escaping exception triggers a best-effort
  ``-emergency`` save; a failed save is logged and counted.
* **Faults** (faults.py): ``data_shard_corrupt``, ``nan_grad`` and
  ``loss_spike`` are consulted once a step, ``ckpt_torn_write`` once a save.
* **Trace**: ``train/step``, ``data`` and ``fwd_bwd`` spans a step and the
  ``ckpt``, ``rollback``, ``anomaly_halt``, ``nan_skip`` and
  ``emergency_save`` instants; the step time is read from the injectable
  ``clock`` at the reference's two points.

* **Mesh** (``mesh=``, a ``launch.mesh.HostMesh`` over the process world):
  every rank builds the Trainer with the same full params and keeps its
  shards of them and of the AdamW moments (``train_step.mesh_specs``); the
  step is ``make_train_step(mesh=)``'s.  Checkpoints stay mesh-agnostic, as
  the reference's: full tensors by key path, gathered leaf by leaf onto
  rank 0's host and written there, and sliced on load, so a run saved on a mesh resumes on one device and
  the other way round.

Without a ``workdir`` no checkpoint is written or read, and the anomaly
guard is off, because it has no verified rollback target; the NaN guard
still skips updates.  ``train.supervisor.TrainSupervisor`` drives this
Trainer under simulated workers.
"""
from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding
from repro_torch.faults import NULL_INJECTOR
from repro_torch.models import lm
from repro_torch.obs.clock import resolve_clock
from repro_torch.obs.trace import get_recorder
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.anomaly import AnomalyConfig, AnomalyDetector, AnomalyHalt
from repro_torch.train.elastic import counters_view
from repro_torch.train.train_step import leaf_specs, make_train_step, mesh_specs

#: Loss / grad-norm multiplier of an injected ``loss_spike`` whose spec
#: leaves ``scale`` unset.
DEFAULT_SPIKE_SCALE = 64.0


def _scramble_labels(batch: dict, step: int, vocab: int) -> dict:
    """A corrupt data shard: the labels become uniform random tokens keyed
    by the step, decoupled from the inputs."""
    rng = np.random.Generator(np.random.Philox(key=[0xDA7A ^ step, 0]))
    bad = dict(batch)
    labels = np.asarray(batch["labels"])
    bad["labels"] = rng.integers(0, vocab, labels.shape).astype(labels.dtype)
    return bad


class Trainer:
    def __init__(
        self,
        cfg,
        opt_cfg: opt_mod.OptimizerConfig,
        dataset,
        params: dict,
        *,
        workdir: str | None = None,
        mesh=None,
        log_every: int = 10,
        ckpt_every: int = 200,
        ckpt_keep: int = 3,
        nan_policy: str = "skip",  # skip | halt
        anomaly: AnomalyConfig | None = None,
        faults=None,
        clock=None,
        trace=None,
    ):
        """``params`` is the model's dict on the device training runs on,
        its trainable leaves in ``cfg.param_dtype``; a resume or a rollback
        copies into these tensors in place.  With ``mesh`` they are the full
        params, the same on every rank, and the trainer keeps this rank's
        shards of them (``self.params``)."""
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.dataset = dataset
        self.mesh = mesh
        if mesh is not None:
            self.specs = mesh_specs(cfg, mesh)
            params = sharding.shard_params(params, mesh, self.specs)
            self._leaf_specs = leaf_specs(params, self.specs)
        self.params = params
        self.device = lm.trainable(params)[0].device
        self.workdir = workdir
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.ckpt_keep = ckpt_keep
        self.nan_policy = nan_policy
        self.anomaly = anomaly or AnomalyConfig()
        self.faults = faults or NULL_INJECTOR
        self.clock = resolve_clock(clock)
        self.trace = trace if trace is not None else get_recorder()
        self.ckpt_dir = None if workdir is None else os.path.join(workdir, "checkpoints")

        self.counters: Counter = Counter()
        self._detector = AnomalyDetector(
            self.anomaly if workdir is not None else AnomalyConfig(enabled=False))
        self._ckpts_written = 0
        self._rollback_streak = 0
        self._rollback_ckpt_mark = -1
        self.opt_state = opt_mod.adamw_init(lm.trainable(params))
        self._step_fn = make_train_step(cfg, opt_cfg, mesh)

        self.step = 0
        self.history: list[dict] = []
        if self.ckpt_dir is None:
            return
        os.makedirs(self.ckpt_dir, exist_ok=True)
        resume = ckpt.latest_step(self.ckpt_dir) is not None
        self._barrier()  # every rank has looked before rank 0 writes a baseline
        if resume:
            step, meta = self._load()
            self.counters["torn_ckpt_fallbacks"] += meta.get("_fallback_skipped", 0)
            self.step = step
            if meta.get("data_state"):
                self.dataset.restore(meta["data_state"])
            print(f"[trainer] resumed from step {self.step} ({meta.get('_name')})")
        else:
            self._checkpoint()  # the baseline: a rollback target from step 0

    # ------------------------------------------------------------------
    def _barrier(self) -> None:
        if self.mesh is not None and dist.is_initialized():
            dist.barrier()

    def _full_state(self) -> tuple[dict | None, dict | None]:
        """The full params and AdamW moments on rank 0's host, gathered
        leaf by leaf from every rank's shards (``sharding.gather_to``);
        (None, None) on the other ranks.  Every rank calls it; no rank holds
        a full leaf on its device."""
        mesh = self.mesh
        params = sharding._zip_map(self.params, self.specs,
                                   lambda t, s: sharding.gather_to(t, mesh, s))
        opt = {name: [sharding.gather_to(t, mesh, spec)
                      for t, spec in zip(self.opt_state[name], self._leaf_specs)]
               for name in ("m", "v")}
        if dist.is_initialized() and dist.get_rank() != 0:
            return None, None
        return params, {**opt, "count": self.opt_state["count"]}

    def _load(self, **kw) -> tuple[int, dict]:
        """``ckpt.load_checkpoint`` into the live tensors, in place → (step,
        meta); on a mesh every rank reads the full tensors on the host and
        keeps its slices."""
        if self.mesh is None:
            step, _, _, meta = ckpt.load_checkpoint(self.ckpt_dir, self.params, self.opt_state,
                                                    **kw)
            return step, meta
        full = sharding._zip_map(self.params, self.specs, lambda t, s: torch.empty(
            sharding.full_shape(t.shape, self.mesh, s), dtype=t.dtype))
        opt = {name: [torch.empty(sharding.full_shape(t.shape, self.mesh, spec), dtype=t.dtype)
                      for t, spec in zip(self.opt_state[name], self._leaf_specs)]
               for name in ("m", "v")}
        opt["count"] = 0
        step, _, _, meta = ckpt.load_checkpoint(self.ckpt_dir, full, opt, **kw)
        with torch.no_grad():
            pairs = list(zip(lm.trainable(self.params), lm.trainable(full)))
            pairs += list(zip(self.opt_state["m"] + self.opt_state["v"], opt["m"] + opt["v"]))
            specs = self._leaf_specs * 3
            for (local, whole), spec in zip(pairs, specs):
                local.copy_(sharding.local_slice(whole, self.mesh, spec))
        self.opt_state["count"] = opt["count"]
        return step, meta

    def _checkpoint(self, tag: str = "") -> None:
        if self.ckpt_dir is None:
            return
        params, opt_state = self.params, self.opt_state
        if self.mesh is not None:
            params, opt_state = self._full_state()
        if self.mesh is None or not dist.is_initialized() or dist.get_rank() == 0:
            ckpt.save_checkpoint(
                self.ckpt_dir, self.step, params, opt_state, self.dataset.state(),
                extra_meta={"arch": self.cfg.name}, keep=self.ckpt_keep, tag=tag,
                faults=self.faults,
            )
        del params, opt_state
        self._barrier()
        self._ckpts_written += 1
        self.trace.instant("ckpt", step=self.step, tag=tag)

    def counters_snapshot(self) -> dict:
        """Robustness counters, zero-filled to the frozen schema
        (``train.elastic.COUNTER_KEYS``)."""
        return counters_view(self.counters)

    # ------------------------------------------------------------------
    def restore_from_checkpoint(self, *, restore_data: bool = True) -> int:
        """Reload params and AdamW state (and the data cursor unless
        ``restore_data=False``, the rollback mode) in place from the newest
        verified checkpoint; rewinds ``step`` and trims the history.
        Returns the restored step."""
        step, meta = self._load()
        self.counters["torn_ckpt_fallbacks"] += meta.get("_fallback_skipped", 0)
        self.step = step
        if restore_data and meta.get("data_state"):
            self.dataset.restore(meta["data_state"])
        self.history = [r for r in self.history if r["step"] <= step]
        # The detector's statistics are kept: the restored params re-live the
        # regime they describe, and a reset would let a persistent divergence
        # become the new baseline.
        return step

    def _rollback_or_halt(self, loss: float, report: dict) -> None:
        """Bounded rollback to the last verified checkpoint, else
        :class:`AnomalyHalt` after a tagged save."""
        if self._ckpts_written > self._rollback_ckpt_mark >= 0:
            # A checkpoint landed since the last rollback: progress, so the
            # retry budget resets.
            self._rollback_streak = 0
        if self._rollback_streak >= self.anomaly.max_rollbacks:
            self.counters["anomaly_halts"] += 1
            self.trace.instant("anomaly_halt", step=self.step)
            self._checkpoint(tag="anomaly-halt")
            raise AnomalyHalt(self.step, self._rollback_streak, f"loss={loss:.4g}, z={report}")
        self._rollback_streak += 1
        self._rollback_ckpt_mark = self._ckpts_written
        self.counters["rollbacks"] += 1
        at = self.step
        restored = self.restore_from_checkpoint(restore_data=False)
        self.trace.instant("rollback", at=at, restored=restored)
        print(f"[trainer] anomaly at step {at} (loss {loss:.4g}, {report}): rolled back to "
              f"step {restored}, data stream advanced past the window (retry "
              f"{self._rollback_streak}/{self.anomaly.max_rollbacks})")

    # ------------------------------------------------------------------
    def step_once(self) -> dict | None:
        """One training step with every guard → its history record, or None
        when an anomaly rollback consumed it (``step`` then rewound)."""
        with self.trace.span("train/step", step=self.step):
            return self._step_once_inner()

    def _step_once_inner(self) -> dict | None:
        with self.trace.span("data", step=self.step):
            batch = self.dataset.next_batch()
        if self.faults.fires("data_shard_corrupt") is not None:
            batch = _scramble_labels(batch, self.step, self.cfg.vocab)
            self.counters["data_corrupt_batches"] += 1
        batch = {k: torch.as_tensor(v, dtype=torch.int64).to(self.device)
                 for k, v in batch.items()}
        inject = float("nan") if self.faults.fires("nan_grad") is not None else 0.0
        t0 = self.clock()
        with self.trace.span("fwd_bwd", step=self.step):
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch, self.step, inject)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the update's kernels too
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        spec = self.faults.fires("loss_spike")
        if spec is not None:
            scale = spec.scale if spec.scale > 0 else DEFAULT_SPIKE_SCALE
            loss *= scale
            gnorm *= scale
        if float(metrics["skipped"]) > 0:
            self.counters["nan_skips"] += 1
            self.trace.instant("nan_skip", step=self.step)
            if self.nan_policy == "halt":
                self._checkpoint(tag="nan-halt")
                raise FloatingPointError(f"NaN loss at step {self.step}")
            print(f"[trainer] step {self.step}: non-finite loss, skipped")
        else:
            report = self._detector.update(loss, gnorm)
            if report is not None:
                self._rollback_or_halt(loss, report)
                return None
        dt = self.clock() - t0
        self.step += 1
        rec = {"step": self.step, "loss": loss, "grad_norm": gnorm,
               "lr": float(metrics["lr"]), "sec": dt}
        self.history.append(rec)
        if self.step % self.log_every == 0:
            print(f"[trainer] step {rec['step']:>6} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"lr {rec['lr']:.2e} {dt * 1e3:.0f} ms")
        if self.step % self.ckpt_every == 0:
            self._checkpoint()
        return rec

    def run(self, num_steps: int) -> list[dict]:
        """Train until ``step`` has advanced by ``num_steps`` → the history
        (records past a rolled-back step trimmed)."""
        target = self.step + num_steps
        try:
            while self.step < target:
                self.step_once()
        except KeyboardInterrupt:
            self._checkpoint(tag="interrupt")
            raise
        except (AnomalyHalt, FloatingPointError):
            raise  # already saved under their own tag
        except Exception:
            # On a mesh the save would gather from ranks that may not be
            # there to answer: a mesh run keeps its periodic checkpoints.
            if self.ckpt_dir is not None and self.mesh is None:
                # Best effort: the tag keeps it from clobbering a periodic
                # checkpoint at the same step; a failed save is logged and
                # counted, never swallowed.
                try:
                    self._checkpoint(tag="emergency")
                    self.counters["emergency_saves"] += 1
                    self.trace.instant("emergency_save", step=self.step)
                except Exception as save_err:  # noqa: BLE001
                    self.counters["emergency_save_failures"] += 1
                    print(f"[trainer] EMERGENCY SAVE FAILED at step {self.step}: "
                          f"{save_err!r}")
            raise
        self._checkpoint(tag="final")
        return self.history
