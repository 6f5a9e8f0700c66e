"""Schema validators for exported observability artifacts (the port's copy
of ``repro.obs.validate``; stdlib only).

    python -m repro_torch.obs.validate --trace t.json --metrics m.json

exits non-zero with a readable problem list if either artifact violates its
schema.  The checks are structural: every field Perfetto and the metrics
consumers rely on.
"""
from __future__ import annotations

import argparse
import json
import sys

_PHASES = {"X", "B", "E", "b", "e", "i"}


def validate_chrome_trace(doc) -> list[str]:
    """Problems (empty = valid) with a Chrome ``trace_event`` object doc."""
    probs: list[str] = []
    if not isinstance(doc, dict):
        return [f"trace doc must be an object, got {type(doc).__name__}"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["trace doc lacks a traceEvents list"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            probs.append(f"{where}: not an object")
            continue
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                probs.append(f"{where}: missing {field!r}")
        ph = ev.get("ph")
        if ph not in _PHASES:
            probs.append(f"{where}: unknown phase {ph!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            probs.append(f"{where}: ts must be a non-negative number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                probs.append(f"{where}: complete event needs dur >= 0")
        if ph in ("b", "e"):
            if "id" not in ev:
                probs.append(f"{where}: async event needs an id")
            if "cat" not in ev:
                probs.append(f"{where}: async event needs a cat")
        if ph == "i" and ev.get("s") not in ("t", "p", "g"):
            probs.append(f"{where}: instant needs scope s in t/p/g")
    # Every async end must match an open begin with the same (name, id).
    open_async: set = set()
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            continue
        key = (ev.get("name"), ev.get("id"))
        if ev.get("ph") == "b":
            open_async.add(key)
        elif ev.get("ph") == "e" and key not in open_async:
            probs.append(f"traceEvents[{i}]: end without begin for {key}")
    return probs


def validate_metrics_snapshot(doc) -> list[str]:
    """Problems (empty = valid) with a MetricsRegistry.snapshot() doc."""
    probs: list[str] = []
    if not isinstance(doc, dict):
        return [f"metrics doc must be an object, got {type(doc).__name__}"]
    if doc.get("schema") != 1:
        probs.append(f"unknown metrics schema {doc.get('schema')!r}")
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(doc.get(section), dict):
            probs.append(f"missing {section!r} object")
    for name, v in (doc.get("counters") or {}).items():
        if not isinstance(v, (int, float)) or v < 0:
            probs.append(f"counter {name}: must be a non-negative number")
    for name, v in (doc.get("gauges") or {}).items():
        if not isinstance(v, (int, float)):
            probs.append(f"gauge {name}: must be a number")
    for name, h in (doc.get("histograms") or {}).items():
        if not isinstance(h, dict):
            probs.append(f"histogram {name}: not an object")
            continue
        buckets, counts = h.get("buckets"), h.get("counts")
        if not isinstance(buckets, list) or sorted(buckets) != buckets:
            probs.append(f"histogram {name}: buckets must ascend")
            continue
        if not isinstance(counts, list) or len(counts) != len(buckets) + 1:
            probs.append(f"histogram {name}: need len(buckets)+1 counts")
            continue
        if any((not isinstance(c, int)) or c < 0 for c in counts):
            probs.append(f"histogram {name}: counts must be ints >= 0")
        elif h.get("count") != sum(counts):
            probs.append(f"histogram {name}: count != sum(counts)")
    return probs


def _check(path: str, validator) -> list[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable ({e})"]
    return [f"{path}: {p}" for p in validator(doc)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate exported trace/metrics artifacts")
    ap.add_argument("--trace", help="Chrome trace JSON to validate")
    ap.add_argument("--metrics", help="metrics snapshot JSON to validate")
    args = ap.parse_args(argv)
    if not args.trace and not args.metrics:
        ap.error("nothing to validate: pass --trace and/or --metrics")
    probs: list[str] = []
    if args.trace:
        probs += _check(args.trace, validate_chrome_trace)
    if args.metrics:
        probs += _check(args.metrics, validate_metrics_snapshot)
    for p in probs:
        print(f"VALIDATE FAIL {p}")
    if not probs:
        print("validate: artifacts conform")
    return 1 if probs else 0


if __name__ == "__main__":
    sys.exit(main())
