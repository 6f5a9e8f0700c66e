"""Measured-vs-roofline utilization on the H100.

``roofline/analysis.py`` carries the model side: per-call FLOP and
HBM-byte costs and the H100's data-sheet peaks.  This module joins a
measured time against that model:

  lower bound  t_roof = max(flops / PEAK_FLOPS, bytes / HBM_BW)
  utilization  u      = t_roof / t_measured          (achieved fraction)

``u`` close to 1.0 means the kernel runs at the binding roofline term;
``u`` > 1.0 means the cost model under-counts.  A measured time comes from
the card only: a CPU run's fraction is not a device metric.

``utilization_columns`` turns one roofline cost dict (e.g.
``decode_attention_cost(...)``) plus a measured microsecond timing into
record columns.  ``kernel_bound`` is a kernel's own bound: it prices the
least work of the function the kernel computes (the ``*_work`` functions,
which count no padding, no masked pairs and no partials a design chooses),
each kind of FLOP at its own peak.
"""
from __future__ import annotations

from repro_torch.roofline.analysis import HBM_BW, PEAK_F32_FLOPS, PEAK_FLOPS


def roofline_lower_bound_s(flops: float, hbm_bytes: float, *,
                           peak_flops: float = PEAK_FLOPS,
                           hbm_bw: float = HBM_BW) -> float:
    """Minimum achievable seconds: the slower of the compute and memory
    terms (the roofline ridge)."""
    if flops < 0 or hbm_bytes < 0:
        raise ValueError("flops/bytes must be non-negative")
    return max(flops / peak_flops, hbm_bytes / hbm_bw)


def achieved_fraction(measured_s: float, flops: float, hbm_bytes: float, *,
                      peak_flops: float = PEAK_FLOPS,
                      hbm_bw: float = HBM_BW) -> float:
    """Fraction of the roofline lower bound actually achieved (0..1 on a
    correct cost model; > 1 flags the model, not the kernel)."""
    if measured_s <= 0:
        raise ValueError(f"measured_s must be positive, got {measured_s}")
    bound = roofline_lower_bound_s(flops, hbm_bytes,
                                   peak_flops=peak_flops, hbm_bw=hbm_bw)
    return bound / measured_s


def utilization_columns(cost: dict, measured_us: float) -> dict:
    """Record columns from a roofline cost dict + measured µs.

    ``cost`` is any cost dict carrying ``total_flops`` and ``hbm_bytes``
    (``decode_attention_cost``, ``paged_decode_attention_cost``,
    ``kernels.ops.attention_cost``).
    """
    flops = float(cost["total_flops"])
    hbm_bytes = float(cost["hbm_bytes"])
    bound_s = roofline_lower_bound_s(flops, hbm_bytes)
    return {
        "roofline_flops": flops,
        "roofline_hbm_bytes": hbm_bytes,
        "roofline_lower_bound_us": bound_s * 1e6,
        "roofline_util": achieved_fraction(measured_us * 1e-6, flops,
                                           hbm_bytes),
    }


def kernel_bound(work: dict, measured_ms: float | None = None) -> dict:
    """A kernel's bound from its least work (``kernels.ops.attention_work``,
    ``delta_work``, ``ssd_work``, ``decode_attention_work``):
    tensor-core FLOPs at ``PEAK_FLOPS``, other FLOPs at ``PEAK_F32_FLOPS``,
    bytes at ``HBM_BW``.  The slowest term is the least time the card could
    take; ``bound_by`` names it ("operations" or "bytes").  With a measured
    time, ``utilization`` is the bound's share of it."""
    ops_s = max(work["tensor_flops"] / PEAK_FLOPS, work["f32_flops"] / PEAK_F32_FLOPS)
    bytes_s = work["hbm_bytes"] / HBM_BW
    bound_s = max(ops_s, bytes_s)
    row = {"bound_ms": bound_s * 1e3, "bound_by": "operations" if ops_s > bytes_s else "bytes"}
    if measured_ms is not None:
        row["utilization"] = bound_s * 1e3 / measured_ms
    return row
