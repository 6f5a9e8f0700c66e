"""Request status names (a local copy of ``repro.serve.lifecycle``'s).

Every request terminates in exactly one terminal status; ``done`` is the
only successful one.
"""
from __future__ import annotations

# -- non-terminal -----------------------------------------------------------
QUEUED = "queued"
PREFILL = "prefill"
RUNNING = "running"
PREEMPTED = "preempted"

# -- terminal ---------------------------------------------------------------
DONE = "done"
REJECTED = "rejected"
EXPIRED = "expired"
CANCELLED = "cancelled"
FAILED = "failed"

TERMINAL = frozenset({DONE, REJECTED, EXPIRED, CANCELLED, FAILED})


def is_terminal(status: str) -> bool:
    return status in TERMINAL


class IncompleteRun(RuntimeError):
    """``run_to_completion(max_steps)`` ran out of steps with requests still
    in flight (listed by uid in ``uids``)."""

    def __init__(self, uids: list[int], max_steps: int):
        self.uids = list(uids)
        self.max_steps = max_steps
        super().__init__(
            f"run_to_completion exhausted {max_steps} steps with "
            f"{len(self.uids)} request(s) still in flight (uids {self.uids})"
        )
