"""Typed metrics registry: counters, gauges, fixed-bucket histograms (the
port's copy of ``repro.obs.metrics``; stdlib only).

The registry wraps the frozen counter schemas the engines and the trainer
expose (``serve.lifecycle.COUNTER_KEYS``, ``serve.cluster.ROUTER_COUNTER_KEYS``,
``train.elastic.COUNTER_KEYS``):
:meth:`MetricsRegistry.bind_counters` registers one pull-style source whose
keys ARE the frozen schema (``counters_snapshot()`` zero-fills against it),
and every bound name is claimed exactly once: binding the same schema
twice, or colliding with a typed metric, raises.

Two exports:

  * :meth:`to_prometheus`: Prometheus text exposition (``# HELP`` /
    ``# TYPE``, cumulative ``_bucket{le=...}`` histograms);
  * :meth:`snapshot`: a JSON-ready dict that ``--metrics-out`` writes
    (``obs.validate`` checks its schema).

Histogram buckets are fixed at registration.  The default grids cover TTFT
and TPOT in clock units (seconds on the wall clock, ticks under a tick
clock: the decade grid covers both) and train step time in seconds.
"""
from __future__ import annotations

import math

#: Decade-ish grids: meaningful for wall-clock seconds AND tick clocks.
TTFT_BUCKETS_S = (0.001, 0.005, 0.02, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0)
TPOT_BUCKETS_S = (0.0005, 0.002, 0.01, 0.05, 0.2, 1.0, 2.0, 5.0)
STEP_TIME_BUCKETS_S = (0.01, 0.05, 0.2, 0.5, 1.0, 2.0, 5.0, 15.0, 60.0)


def _fmt(v) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """Monotonic counter (push-style)."""

    mtype = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {v})")
        self.value += v


class Gauge:
    """Point-in-time value; ``fn`` makes it pull-style (read at export)."""

    mtype = "gauge"

    def __init__(self, name: str, help: str = "", fn=None):
        self.name, self.help, self.fn = name, help, fn
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return float(self.fn()) if self.fn is not None else self._value


class Histogram:
    """Fixed-bucket histogram (upper bounds ascending; +Inf implicit)."""

    mtype = "histogram"

    def __init__(self, name: str, help: str = "", buckets=TTFT_BUCKETS_S):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must ascend")
        self.name, self.help = name, help
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> list[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class MetricsRegistry:
    """Name-unique registry of typed metrics + bound counter schemas."""

    def __init__(self):
        self._metrics: dict[str, object] = {}  # insertion-ordered
        self._bound: list[tuple[str, tuple, object, str]] = []
        self._names: set[str] = set()

    # -- registration -----------------------------------------------------

    def _claim(self, name: str) -> None:
        if name in self._names:
            raise ValueError(f"metric {name!r} already registered")
        self._names.add(name)

    def counter(self, name: str, help: str = "") -> Counter:
        self._claim(name)
        m = Counter(name, help)
        self._metrics[name] = m
        return m

    def gauge(self, name: str, help: str = "", fn=None) -> Gauge:
        self._claim(name)
        m = Gauge(name, help, fn)
        self._metrics[name] = m
        return m

    def histogram(self, name: str, help: str = "",
                  buckets=TTFT_BUCKETS_S) -> Histogram:
        self._claim(name)
        m = Histogram(name, help, buckets)
        self._metrics[name] = m
        return m

    def bind_counters(self, prefix: str, snapshot_fn, keys=None,
                      help: str = "") -> tuple:
        """Bind a frozen counter schema as pull-style counters named
        ``<prefix>_<key>``.  ``keys=None`` reads them from one snapshot —
        the zero-filled frozen schema itself.  Every name is claimed now,
        so a double bind (or a typed-metric collision) raises immediately:
        the 'every frozen key appears exactly once' guarantee."""
        if keys is None:
            keys = tuple(snapshot_fn().keys())
        for k in keys:
            self._claim(f"{prefix}_{k}")
        self._bound.append((prefix, tuple(keys), snapshot_fn, help))
        return tuple(keys)

    # -- export -----------------------------------------------------------

    def _bound_samples(self):
        for prefix, keys, fn, help in self._bound:
            snap = fn()
            for k in keys:
                yield f"{prefix}_{k}", float(snap.get(k, 0)), help

    def to_prometheus(self) -> str:
        lines: list[str] = []
        for name, value, help in self._bound_samples():
            lines.append(f"# HELP {name} {help}".rstrip())
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {_fmt(value)}")
        for m in self._metrics.values():
            lines.append(f"# HELP {m.name} {m.help}".rstrip())
            lines.append(f"# TYPE {m.name} {m.mtype}")
            if m.mtype == "histogram":
                cum = m.cumulative()
                for ub, c in zip(m.buckets, cum):
                    lines.append(
                        f'{m.name}_bucket{{le="{_fmt(ub)}"}} {c}')
                lines.append(f'{m.name}_bucket{{le="+Inf"}} {cum[-1]}')
                lines.append(f"{m.name}_sum {_fmt(m.sum)}")
                lines.append(f"{m.name}_count {m.count}")
            else:
                lines.append(f"{m.name} {_fmt(m.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-ready snapshot (schema checked by obs.validate)."""
        out = {"schema": 1, "counters": {}, "gauges": {}, "histograms": {}}
        for name, value, _ in self._bound_samples():
            out["counters"][name] = value
        for m in self._metrics.values():
            if m.mtype == "counter":
                out["counters"][m.name] = m.value
            elif m.mtype == "gauge":
                out["gauges"][m.name] = m.value
            else:
                out["histograms"][m.name] = {
                    "buckets": list(m.buckets),
                    "counts": list(m.counts),
                    "sum": m.sum,
                    "count": m.count,
                }
        return out


# -- component bindings ------------------------------------------------------
# Duck-typed on the public surfaces (counters_snapshot / metrics / history)
# so obs never imports serve/train — no cycles, and fakes bind identically.


def _observe_rows(ttft: Histogram, tpot: Histogram, rows) -> None:
    for row in rows:
        if row.get("ttft_s") is not None:
            ttft.observe(row["ttft_s"])
        if row.get("tpot_s") is not None:
            tpot.observe(row["tpot_s"])


def serving_registry(engine, prefix: str = "serve") -> MetricsRegistry:
    """One-shot registry over an engine (slot or paged): the frozen
    ``lifecycle.COUNTER_KEYS`` bound pull-style, queue/degrade gauges, and
    TTFT/TPOT histograms filled from the ``metrics()`` rows at call time."""
    reg = MetricsRegistry()
    reg.bind_counters(prefix, engine.counters_snapshot,
                      help="engine robustness counter (frozen schema)")
    reg.gauge(f"{prefix}_queue_depth", "requests waiting for admission",
              fn=engine.queue_depth)
    reg.gauge(f"{prefix}_degrade_level", "degradation controller level",
              fn=engine.degrade_level)
    ttft = reg.histogram(f"{prefix}_ttft_s", "time to first token",
                         buckets=TTFT_BUCKETS_S)
    tpot = reg.histogram(f"{prefix}_tpot_s", "mean inter-token time",
                         buckets=TPOT_BUCKETS_S)
    _observe_rows(ttft, tpot, engine.metrics())
    return reg


def router_registry(router) -> MetricsRegistry:
    """Registry over a ClusterRouter: its own frozen ROUTER_COUNTER_KEYS
    plus the live replicas' aggregated engine counters, and cluster-level
    TTFT/TPOT histograms from the router's ledger metrics."""
    reg = MetricsRegistry()
    reg.bind_counters("router", router.counters_snapshot,
                      help="router counter (frozen schema)")
    reg.bind_counters("cluster", router.cluster_counters,
                      help="engine counters summed over live replicas")
    ttft = reg.histogram("cluster_ttft_s", "time to first emitted token",
                         buckets=TTFT_BUCKETS_S)
    tpot = reg.histogram("cluster_tpot_s", "mean inter-token time",
                         buckets=TPOT_BUCKETS_S)
    _observe_rows(ttft, tpot, router.metrics())
    return reg


def train_registry(trainer, prefix: str = "train") -> MetricsRegistry:
    """Registry over a Trainer (or TrainSupervisor): the frozen
    ``train.elastic.COUNTER_KEYS`` bound pull-style, the current step as a
    gauge, and a step-time histogram from the history records."""
    reg = MetricsRegistry()
    reg.bind_counters(prefix, trainer.counters_snapshot,
                      help="train robustness counter (frozen schema)")
    target = getattr(trainer, "trainer", trainer)  # a supervisor wraps one
    reg.gauge(f"{prefix}_step", "current optimizer step",
              fn=lambda: target.step)
    hist = reg.histogram(f"{prefix}_step_time_s", "wall time per step",
                         buckets=STEP_TIME_BUCKETS_S)
    for rec in getattr(target, "history", []):
        if "sec" in rec:
            hist.observe(rec["sec"])
    return reg
