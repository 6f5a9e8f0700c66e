"""Time candidate block sizes with an injectable timer
(``repro.tune.measure``).

``cuda_graph_timer`` times a candidate on the card as replays of a CUDA
graph, for the calls the serving steps make inside captured graphs (the
decode split, the paged block), so host dispatch is out of the number as
it is out of the step; ``cuda_event_timer`` times an eager call between
CUDA events, as an eager prefill runs it; ``wall_timer`` times the plain
versions on the CPU with the host clock.  Each returns its repeated
timings, so the pick can hold a candidate to their spread.  Tests inject a
deterministic ``timer(run_fn, candidate) -> seconds``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.obs.clock import perf_clock

ROUNDS = 3  # passes over the candidates, interleaved, so drift and a capture's luck show

# timer(run_fn, candidate) -> seconds, or a sequence of repeated timings
# in seconds; run_fn is a zero-arg callable that runs one candidate
# configuration end to end.
Timer = Callable[[Callable[[], object], object], float | Sequence[float]]


def wall_timer(*, warmup: int = 1, iters: int = 3) -> Timer:
    """Host-clock seconds of ``iters`` calls (the CPU's plain versions)."""

    def timer(run_fn: Callable[[], object], candidate: object) -> float:
        del candidate
        for _ in range(warmup):
            run_fn()
        times = []
        for _ in range(iters):
            t0 = perf_clock()
            run_fn()
            times.append(perf_clock() - t0)
        return times

    return timer


def cuda_event_timer(*, warmup: int = 2, iters: int = 10) -> Timer:
    """Device seconds of ``iters`` calls, each between two CUDA events on
    the current stream, after ``warmup`` calls (the first builds and loads
    the kernels)."""

    def timer(run_fn: Callable[[], object], candidate: object) -> float:
        del candidate
        for _ in range(warmup):
            run_fn()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for start, end in events:
            start.record()
            run_fn()
            end.record()
        torch.cuda.synchronize()
        return [s.elapsed_time(e) / 1e3 for s, e in events]

    return timer


def cuda_graph_timer(*, warmup: int = 2, iters: int = 10, replays: int = 10) -> Timer:
    """Device seconds of one replay of the call captured as a CUDA graph,
    ``iters`` times: ``warmup`` eager calls on a side stream (the first
    builds and loads the kernels), the capture, then ``iters`` pairs of
    CUDA events around ``replays`` replays each."""

    def timer(run_fn: Callable[[], object], candidate: object) -> float:
        del candidate
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(warmup):
                run_fn()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            run_fn()
        graph.replay()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for start, end in events:
            start.record()
            for _ in range(replays):
                graph.replay()
            end.record()
        torch.cuda.synchronize()
        return [s.elapsed_time(e) / 1e3 / replays for s, e in events]

    return timer


def default_timer(device: torch.device, *, graph: bool = False) -> Timer:
    """On the card CUDA graph replays (``graph``) or eager calls between
    CUDA events; the host clock on the CPU."""
    if device.type != "cuda":
        return wall_timer()
    return cuda_graph_timer() if graph else cuda_event_timer()


def measure_candidates(make_run, candidates: list, timer: Timer) -> dict:
    """Time every candidate → ``{candidate: [seconds, ...]}``: ``ROUNDS``
    interleaved passes, each candidate timed once a pass, and every timing
    the timer returned (the reference keeps one number a candidate).

    ``make_run(candidate)`` builds the zero-arg callable for one candidate
    (inputs closed over, so every candidate sees the same data).  A
    candidate that a wrapper refuses (``ValueError``: a shape its kernel
    does not take) is skipped; any other error propagates."""
    runs: dict = {}
    for cand in candidates:
        try:
            runs[cand] = make_run(cand)
        except ValueError:
            continue
    results: dict = {}
    for _ in range(ROUNDS):
        for cand, run_fn in list(runs.items()):
            try:
                got = timer(run_fn, cand)
            except ValueError:
                del runs[cand]
                results.pop(cand, None)
                continue
            results.setdefault(cand, []).extend(
                [float(got)] if isinstance(got, (int, float)) else [float(t) for t in got])
    if not results:
        raise RuntimeError(f"no candidate in {candidates!r} was measurable")
    return results
