"""The single wall-clock source for serve and train time reads.

Every serve and train component (the engines, the scheduler, the trainer,
the trace recorder) takes an injectable ``clock`` (tests inject tick and
step clocks, so deadlines, TTFT, step times and trace timestamps are
deterministic) and defaults to :data:`perf_clock` via :func:`resolve_clock`.
No other module under ``serve``, ``train`` or ``obs`` reads the time
directly; ``tests/test_torch_obs.py`` enforces it with a source scan that
whitelists only this module.
"""
from __future__ import annotations

import time

#: The production clock: monotonic, sub-µs resolution, not wall-time-adjusted.
perf_clock = time.perf_counter


def resolve_clock(clock):
    """``clock or perf_clock`` without treating a falsy callable as unset."""
    return perf_clock if clock is None else clock
