"""The wall-clock source of the paged serving path.

The scheduler and the paged engine take an injectable ``clock`` (tests
inject tick clocks so deadlines and TTFT are deterministic) and default to
:data:`perf_clock` via :func:`resolve_clock`.
"""
from __future__ import annotations

import time

#: The production clock: monotonic, sub-µs resolution, not wall-time-adjusted.
perf_clock = time.perf_counter


def resolve_clock(clock):
    """``clock or perf_clock`` without treating a falsy callable as unset."""
    return perf_clock if clock is None else clock
