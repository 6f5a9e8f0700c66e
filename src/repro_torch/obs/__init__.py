"""Observability, stdlib only, so every layer can emit without import cycles:

  * :mod:`repro_torch.obs.clock`: the one wall-clock source for serve and
    train time reads; everything else takes an injectable ``clock`` (tick
    clocks in the tests) and defaults to it.
  * :mod:`repro_torch.obs.trace`: the bounded ring-buffer
    :class:`TraceRecorder` (sync spans, async request spans, instants),
    exported as Chrome ``trace_event`` JSON, and the process-global
    recorder (default: no-op).
  * :mod:`repro_torch.obs.metrics`: the typed registry (counters, gauges,
    fixed-bucket histograms) over the frozen counter schemas, with
    Prometheus text and a JSON snapshot.
  * :mod:`repro_torch.obs.utilization`: measured time against the roofline.
  * :mod:`repro_torch.obs.validate`: schema validators for the exported
    trace and metrics snapshot.
"""
from repro_torch.obs.clock import perf_clock, resolve_clock
from repro_torch.obs.trace import (
    NULL_RECORDER,
    NullRecorder,
    TraceRecorder,
    get_recorder,
    set_recorder,
    use_recorder,
)
from repro_torch.obs.metrics import (
    MetricsRegistry,
    STEP_TIME_BUCKETS_S,
    TPOT_BUCKETS_S,
    TTFT_BUCKETS_S,
    router_registry,
    serving_registry,
    train_registry,
)
from repro_torch.obs.utilization import (
    achieved_fraction,
    roofline_lower_bound_s,
    utilization_columns,
)

__all__ = [
    "perf_clock",
    "resolve_clock",
    "TraceRecorder",
    "NullRecorder",
    "NULL_RECORDER",
    "get_recorder",
    "set_recorder",
    "use_recorder",
    "MetricsRegistry",
    "TTFT_BUCKETS_S",
    "TPOT_BUCKETS_S",
    "STEP_TIME_BUCKETS_S",
    "serving_registry",
    "router_registry",
    "train_registry",
    "roofline_lower_bound_s",
    "achieved_fraction",
    "utilization_columns",
]
