"""Span-based structured tracing with Chrome ``trace_event`` JSON export
(the port's copy of ``repro.obs.trace``; stdlib only).

One :class:`TraceRecorder` holds a *bounded* ring buffer of completed events
(oldest evicted first) plus a separate stack of currently-open sync spans, so
eviction can never corrupt a span that is still open.  Timestamps come from
an injectable clock (obs.clock): a test driving a tick clock gets
bit-deterministic traces.

Event taxonomy:

  * **sync spans** (``with rec.span("train/step", step=i): ...``): Chrome
    phase ``"X"`` (ts + dur), nested by the call stack; the trainer's
    per-step data / fwd_bwd phases, the engines' prefill and decode.
  * **async spans** (``rec.begin("request", uid)`` … ``rec.end("request",
    uid, **row)``): Chrome phases ``"b"``/``"e"``, correlated by ``id``; a
    request's life crosses many steps, so its span cannot nest on one call
    stack.  :meth:`TraceRecorder.ns` hands each emitting component a
    namespace so ids stay unique across components (``id = "3:7"``).
  * **instants** (``rec.instant("preempt", uid=9)``): Chrome phase ``"i"``:
    first tokens, preemption and restore, degradation level changes,
    checkpoint and rollback marks.

Export is :meth:`to_chrome`, ``{"traceEvents": [...]}``, loadable in
Perfetto / ``chrome://tracing``; still-open spans export as ``"B"`` events.
Clock units export as microseconds (×1e6).

The process-global recorder (:func:`get_recorder` / :func:`set_recorder`,
default :data:`NULL_RECORDER`) is what a component constructed without an
explicit ``trace`` emits to; ``--trace`` on the launchers installs a real
one.  :class:`NullRecorder` has the same surface as no-ops, so call sites
are unconditional and cost one empty call when tracing is off.

On the card a sync span measures host time: no span synchronises the
device, so a span around an asynchronous launch covers its dispatch only.
"""
from __future__ import annotations

import itertools
import json
from collections import deque
from contextlib import contextmanager

from repro_torch.obs.clock import resolve_clock

#: Default ring-buffer capacity (completed events).
DEFAULT_MAXLEN = 65536


class _Span:
    """Re-entrant handle for one open sync span (lives on the recorder's
    open stack, never in the ring buffer, until it closes)."""

    __slots__ = ("rec", "name", "args", "tid", "t0")

    def __init__(self, rec: "TraceRecorder", name: str, tid: int, args: dict):
        self.rec = rec
        self.name = name
        self.tid = tid
        self.args = args
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = self.rec.clock()
        self.rec._open.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.rec._open.remove(self)
        self.rec._push({
            "name": self.name, "ph": "X", "t": self.t0,
            "dur": self.rec.clock() - self.t0,
            "tid": self.tid, "args": self.args,
        })
        return False


class TraceRecorder:
    """Bounded structured-trace recorder on an injectable clock.

    ``maxlen`` bounds the *completed*-event ring; open sync spans are
    tracked separately and immune to eviction.  ``enabled`` is a cheap
    instrumentation-site guard (always True here; the NullRecorder's is
    False) — call sites may branch on it before building expensive args.
    """

    enabled = True

    def __init__(self, *, clock=None, maxlen: int = DEFAULT_MAXLEN,
                 pid: int = 0):
        self.clock = resolve_clock(clock)
        self.pid = pid
        self.events: deque = deque(maxlen=maxlen)
        self._open: list[_Span] = []
        self._ns = itertools.count(1)
        self.dropped = 0  # completed events evicted by the ring bound

    # -- emission ---------------------------------------------------------

    def ns(self) -> int:
        """A fresh id namespace for one emitting component (engine,
        scheduler, router): async-span ids are ``"<ns>:<local id>"`` so
        engine-local uid counters never collide across replicas."""
        return next(self._ns)

    def _push(self, ev: dict) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(ev)

    def span(self, name: str, *, tid: int = 0, **args) -> _Span:
        """Sync nested span context manager (Chrome ``"X"``)."""
        return _Span(self, name, tid, args)

    def begin(self, name: str, span_id, *, tid: int = 0, **args) -> None:
        """Open an async span correlated by ``span_id`` (Chrome ``"b"``)."""
        self._push({"name": name, "ph": "b", "t": self.clock(),
                    "id": str(span_id), "tid": tid, "args": args})

    def end(self, name: str, span_id, *, tid: int = 0, **args) -> None:
        """Close the async span ``span_id`` (Chrome ``"e"``).  ``args`` on
        the end event carry the request's terminal metrics row — the
        bit-consistency anchor tests compare against ``metrics()``."""
        self._push({"name": name, "ph": "e", "t": self.clock(),
                    "id": str(span_id), "tid": tid, "args": args})

    def instant(self, name: str, *, tid: int = 0, **args) -> None:
        """Point event (Chrome ``"i"``, thread scope)."""
        self._push({"name": name, "ph": "i", "t": self.clock(),
                    "tid": tid, "args": args})

    # -- export -----------------------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` JSON object format (Perfetto-loadable).

        Clock units export as microseconds: a tick clock's tick becomes
        1 µs — proportions survive, and the format stays uniform."""
        out = []
        for ev in self.events:
            rec = {
                "name": ev["name"], "ph": ev["ph"],
                "ts": ev["t"] * 1e6, "pid": self.pid, "tid": ev["tid"],
                "args": ev["args"],
            }
            if ev["ph"] == "X":
                rec["dur"] = ev["dur"] * 1e6
            if "id" in ev:
                rec["id"] = ev["id"]
                rec["cat"] = "async"  # b/e events require a category
            if ev["ph"] == "i":
                rec["s"] = "t"
            out.append(rec)
        for sp in self._open:  # still-open sync spans: visible, unclosed
            out.append({
                "name": sp.name, "ph": "B", "ts": sp.t0 * 1e6,
                "pid": self.pid, "tid": sp.tid, "args": sp.args,
            })
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)


class _NullSpan:
    """Shared, allocation-free context manager for disabled tracing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """No-op recorder with the full TraceRecorder surface.  Installed by
    default, so instrumentation sites are unconditional and cost one
    attribute lookup + one empty call when tracing is off."""

    enabled = False
    events = ()
    dropped = 0

    def ns(self) -> int:
        return 0

    def span(self, name, *, tid=0, **args):
        return _NULL_SPAN

    def begin(self, name, span_id, *, tid=0, **args) -> None:
        pass

    def end(self, name, span_id, *, tid=0, **args) -> None:
        pass

    def instant(self, name, *, tid=0, **args) -> None:
        pass

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"dropped_events": 0}}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


NULL_RECORDER = NullRecorder()

_current = NULL_RECORDER


def get_recorder():
    """The process-global recorder (NULL_RECORDER unless --trace installed
    one).  Constructors resolve ``trace or get_recorder()`` so explicitly
    injected recorders always win."""
    return _current


def set_recorder(rec) -> None:
    global _current
    _current = rec if rec is not None else NULL_RECORDER


@contextmanager
def use_recorder(rec):
    """Scoped global-recorder install (tests; benchmark runs)."""
    global _current
    prev = _current
    _current = rec if rec is not None else NULL_RECORDER
    try:
        yield rec
    finally:
        _current = prev
