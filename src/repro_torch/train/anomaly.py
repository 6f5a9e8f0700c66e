"""Loss/grad-norm anomaly detection for the training loop.

The in-step NaN guard (train_step) only catches *non-finite* blow-ups; a
silently diverging run — loss spiking 100× while staying finite — sails
through it and poisons every later step.  The :class:`AnomalyDetector`
watches the loss and grad-norm streams with an EWMA mean/variance and flags
a sample whose one-sided z-score exceeds ``z_threshold`` — the Trainer then
rolls params+opt back to the last *verified* checkpoint and advances the
deterministic data stream past the offending window.  The port's copy of
``repro.train.anomaly``.

Design notes:

* **One-sided** — only upward excursions flag; a loss cliff downward is
  suspicious but not damaging, and flagging it would fight convergence.
* **Spikes are not absorbed** — a flagged sample does not update the EWMA
  statistics, so a divergence cannot drag the baseline up after itself and
  mask its own continuation.
* **Warmup** — the first ``warmup`` samples only feed the statistics; early
  training is legitimately volatile and the variance estimate needs mass
  before z-scores mean anything.
* **Bounded retries** — the Trainer tracks consecutive rollbacks that made
  no forward progress and raises :class:`AnomalyHalt` after
  ``max_rollbacks``: a persistently bad region halts loudly instead of
  looping rollback→spike forever.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


class AnomalyHalt(RuntimeError):
    """Rollback retries exhausted: the run is halted with a tagged
    checkpoint on disk rather than looping over a persistently bad
    region."""

    def __init__(self, step: int, rollbacks: int, detail: str = ""):
        self.step = step
        self.rollbacks = rollbacks
        super().__init__(
            f"anomaly guard halted training at step {step} after "
            f"{rollbacks} rollback(s) without progress"
            + (f": {detail}" if detail else "")
        )


@dataclass(frozen=True)
class AnomalyConfig:
    """Knobs for the Trainer's anomaly guard.

    ``z_threshold`` is deliberately loose by default (8σ): the guard exists
    to catch divergence, not to second-guess ordinary gradient noise.
    ``min_rel_increase`` is an absolute backstop under near-zero variance —
    a perfectly flat loss plateau would otherwise flag on femto-scale
    jitter.  ``max_rollbacks`` bounds consecutive no-progress rollbacks
    before :class:`AnomalyHalt`.
    """

    enabled: bool = True
    z_threshold: float = 8.0
    ewma_alpha: float = 0.1
    warmup: int = 20
    min_rel_increase: float = 0.25
    max_rollbacks: int = 3


class AnomalyDetector:
    """EWMA mean/variance z-score detector over (loss, grad_norm)."""

    def __init__(self, cfg: AnomalyConfig | None = None):
        self.cfg = cfg or AnomalyConfig()
        self.reset()

    def reset(self) -> None:
        """Forget all statistics.  NOT called on rollback — the restored
        params re-live the regime the current stats describe, and resetting
        would let a persistent divergence launder itself into the fresh
        warmup as the new baseline."""
        self._stats = {"loss": [None, 0.0, 0], "grad_norm": [None, 0.0, 0]}

    def _update_one(self, name: str, x: float) -> float | None:
        """Feed one sample; returns the z-score when it flags, else None."""
        mean, var, n = self._stats[name]
        if mean is None:
            self._stats[name] = [x, 0.0, 1]
            return None
        sigma = math.sqrt(var)
        z = (x - mean) / sigma if sigma > 0 else float("inf")
        flagged = (
            n >= self.cfg.warmup
            and x > mean * (1.0 + self.cfg.min_rel_increase)
            and z > self.cfg.z_threshold
        )
        if not flagged:
            a = self.cfg.ewma_alpha
            delta = x - mean
            mean = mean + a * delta
            # EW variance of the residual stream (West 1979 style):
            var = (1 - a) * (var + a * delta * delta)
            self._stats[name] = [mean, var, n + 1]
            return None
        return z

    def update(self, loss: float, grad_norm: float) -> dict | None:
        """Feed one step's scalars; returns a spike report dict when either
        signal flags (the sample is then NOT absorbed), else None.  Callers
        should gate non-finite values through the NaN guard first."""
        if not self.cfg.enabled:
            return None
        report = {}
        z = self._update_one("loss", loss)
        if z is not None:
            report["loss_z"] = z
        z = self._update_one("grad_norm", grad_norm)
        if z is not None:
            report["grad_norm_z"] = z
        return report or None
