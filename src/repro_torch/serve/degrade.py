"""Graceful-degradation controller: the DistrAttention accuracy↔speed dial
driven by serving pressure.

DistrAttention's knob, embedding-dimension grouping at fraction 1/G*, can
change per call.  Under sustained overload the scheduler dials **prefill**
onto progressively coarser grouping; when pressure drains it dials back to
the engine's configured exact path.  The accuracy cost is attributed per
request (``Request.degrade_group`` in ``metrics()``).

The controller is pure tick-driven policy with hysteresis: no wall clock,
no model state.  After pressure drops below the low watermark, level 0 is
reached within ``down_after × max_level`` ticks.  Escalation signal:
waiting-queue depth, and optionally the rolling p50 TTFT; one level step
per decision.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DegradeConfig:
    """Hysteresis policy for the degradation dial.

    group_sizes: G* per escalation level; level 0 is always the engine's
      configured (exact) prefill path, level L ≥ 1 runs DistrAttention
      prefill at ``group_sizes[L-1]``.
    high_watermark / low_watermark: waiting-queue depths.  Pressure =
      depth > high (or rolling p50 TTFT > ttft_p50_high_s, when set);
      drain = depth ≤ low (and TTFT below the threshold).
    up_after / down_after: consecutive pressure (resp. drain) ticks before
      one level step up (resp. down).
    """

    group_sizes: tuple[int, ...] = (2, 4)
    high_watermark: int = 6
    low_watermark: int = 1
    up_after: int = 2
    down_after: int = 4
    ttft_p50_high_s: float | None = None

    def __post_init__(self):
        if not self.group_sizes or any(g < 2 for g in self.group_sizes):
            raise ValueError(
                "group_sizes must be non-empty with every G* ≥ 2 "
                "(level 0 is implicitly the exact path)"
            )
        if self.low_watermark > self.high_watermark:
            raise ValueError("low_watermark must be ≤ high_watermark")
        if self.up_after < 1 or self.down_after < 1:
            raise ValueError("up_after / down_after must be ≥ 1")

    @property
    def max_level(self) -> int:
        return len(self.group_sizes)

    def group_for(self, level: int) -> int:
        """G* for a level (1 = exact, i.e. no grouping)."""
        if level <= 0:
            return 1
        return self.group_sizes[min(level, self.max_level) - 1]

    def return_bound_ticks(self) -> int:
        """Upper bound on ticks from any level back to exact once pressure
        stays below the low watermark."""
        return self.down_after * self.max_level


class DegradationController:
    """Tick-driven hysteresis state machine over :class:`DegradeConfig`."""

    def __init__(self, cfg: DegradeConfig):
        self.cfg = cfg
        self.level = 0
        self._over = 0  # consecutive pressure ticks
        self._under = 0  # consecutive drain ticks
        self.transitions: list[tuple[int, int]] = []  # (tick#, new level)
        self._ticks = 0

    @property
    def group_size(self) -> int:
        return self.cfg.group_for(self.level)

    def observe(self, queue_depth: int, ttft_p50: float | None = None) -> int:
        """One scheduler tick's pressure reading; returns the level to use
        for prefills started this tick."""
        self._ticks += 1
        c = self.cfg
        hot = queue_depth > c.high_watermark
        if c.ttft_p50_high_s is not None and ttft_p50 is not None:
            hot = hot or ttft_p50 > c.ttft_p50_high_s
        cool = queue_depth <= c.low_watermark and not hot
        self._over = self._over + 1 if hot else 0
        self._under = self._under + 1 if cool else 0
        if self._over >= c.up_after and self.level < c.max_level:
            self.level += 1
            self._over = 0
            self.transitions.append((self._ticks, self.level))
        elif self._under >= c.down_after and self.level > 0:
            self.level -= 1
            self._under = 0
            self.transitions.append((self._ticks, self.level))
        return self.level
