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


# -- frozen observability schema (the reference's, key for key) --------------

#: Robustness counters of the scheduler (``counters_snapshot``).
COUNTER_KEYS = (
    "shed",  # load-shed at submission (bounded waiting queue)
    "expired",  # missed a TTFT / e2e deadline
    "cancelled",  # explicit cancel(uid)
    "failed_numeric",  # non-finite logits quarantined
    "failed_fault",  # step/restore retry budget exhausted
    "step_retries",  # faulting model steps retried in place
    "restore_retries",  # faulting restores retried with backoff
    "watchdog_fails",  # global-stall watchdog fired
    "degraded_prefills",  # prompts served under coarser grouping
    "mesh_prefills",  # whole-prompt ring prefills (mesh one-tick admission)
)

#: Per-request ``metrics()`` row keys of the paged engine and the scheduler.
METRIC_KEYS = (
    "uid", "ttft_s", "tpot_s", "n_generated", "n_preemptions", "status",
    "degrade_group",
)


def counters_view(counters) -> dict:
    """Freeze a Counter/dict into the canonical zero-filled schema."""
    return {k: int(counters.get(k, 0)) for k in COUNTER_KEYS}


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
