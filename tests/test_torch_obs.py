"""Port parity of the observability layer (``repro_torch.obs``), on the CPU,
against the JAX package.

The pure modules side by side: the same call sequence into both packages'
``TraceRecorder`` gives equal Chrome docs (nesting, ring eviction with open
spans, namespaced ids, the Null recorder), both validators give the same
problem lists, and the same registry built in both gives the same
Prometheus text and snapshot.  The registries over the port's scheduler,
both real engines and the Trainer show every frozen key exactly once,
equal to ``counters_snapshot()``.  The acceptance test: the port's slot and
paged engines, driven beside the reference's on a tick clock through a
shed, a preemption, degraded prefills and an injected fault, export the
same Chrome trace event for event, and every request's end args equal its
``metrics()`` row.  Also the port's clock audit, the launchers' ``--trace``
/ ``--metrics-out`` on the CPU through ``python -m repro_torch.obs.validate``,
and the Null recorder's overhead bound.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as ref_obs  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import lsh as ref_lsh  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.obs import validate as ref_validate  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve.degrade import DegradeConfig as RefDegradeConfig  # noqa: E402
from repro.serve.faults import FaultInjector as RefFaultInjector  # noqa: E402
from repro.serve.faults import FaultSpec as RefFaultSpec  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.faults import FaultInjector, FaultSpec  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.obs import trace as trace_mod  # noqa: E402
from repro_torch.obs import validate  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve.degrade import DegradeConfig  # noqa: E402
from repro_torch.serve.lifecycle import COUNTER_KEYS, METRIC_KEYS  # noqa: E402
from repro_torch.train.elastic import COUNTER_KEYS as TRAIN_COUNTER_KEYS  # noqa: E402

from test_torch_chaos import PORT, FakeEngine, FakeReq, TickClock, _drive  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its many small steps
    lose most of their time to thread hand-offs when test workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StepClock:
    """Advances by ``step`` on every read: span timestamps become exact."""

    def __init__(self, step=1.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        t, self.t = self.t, self.t + self.step
        return t


def _roundtrip(doc):
    return json.loads(json.dumps(doc))


# ---------------------------------------------------------------------------
# The clock audit
# ---------------------------------------------------------------------------


def test_clock_audit_serve_train_obs_never_read_time_directly():
    """No module under the port's serve, train or obs (obs/clock.py aside)
    imports ``time`` or reads the wall clock: every time read goes through
    the injectable clock, so tick-clock tests stay deterministic."""
    roots = [os.path.join(SRC, "repro_torch", d) for d in ("serve", "train", "obs")]
    whitelist = {os.path.join(SRC, "repro_torch", "obs", "clock.py")}
    needles = ("import time", "time.time(", "time.perf_counter", "time.monotonic")
    offenders = []
    for root in roots:
        for dirpath, _, files in os.walk(root):
            for fname in files:
                path = os.path.join(dirpath, fname)
                if not fname.endswith(".py") or path in whitelist:
                    continue
                with open(path) as f:
                    src = f.read()
                offenders += [(os.path.relpath(path, SRC), n) for n in needles if n in src]
    assert not offenders, f"direct wall-time reads outside obs/clock.py: {offenders}"
    assert obs.resolve_clock(None) is obs.perf_clock


# ---------------------------------------------------------------------------
# The recorder, the validators and the registry against the reference's
# ---------------------------------------------------------------------------


def _nested(pkg):
    rec = pkg.TraceRecorder(clock=StepClock())
    with rec.span("outer", step=1):
        with rec.span("inner"):
            pass
    return rec


def _eviction(pkg):
    rec = pkg.TraceRecorder(clock=StepClock(), maxlen=4)
    with rec.span("long_lived"):
        for i in range(10):
            rec.instant("flood", i=i)
        mid = rec.to_chrome()  # the open span exports as "B"
    return rec, mid


def _namespaced(pkg):
    rec = pkg.TraceRecorder(clock=StepClock(0.5), pid=3)
    ns_a, ns_b = rec.ns(), rec.ns()
    rec.begin("request", f"{ns_a}:0", uid=0)
    rec.begin("request", f"{ns_b}:0", uid=0, tid=2)
    with rec.span("prefill", uid=7):
        rec.instant("first_token", uid=7)
    rec.end("request", f"{ns_a}:0", status="done", ttft_s=None)
    rec.end("request", f"{ns_b}:0", status="failed")
    rec.span("decode").__enter__()  # left open
    return rec, (ns_a, ns_b)


def _null(pkg):
    n = pkg.NullRecorder()
    with n.span("anything", big=list(range(10))):
        n.begin("r", "1:1", uid=1)
        n.end("r", "1:1", uid=1)
        n.instant("x")
    return n, n.ns(), n.enabled, pkg.NULL_RECORDER.enabled


@pytest.mark.parametrize("case", [_nested, _eviction, _namespaced, _null],
                         ids=["nesting", "eviction", "namespaces", "null"])
def test_recorder_matches_reference(case, tmp_path):
    """The same calls into both recorders: equal events, exports, dropped
    counts and saved files."""
    want, got = case(ref_obs), case(obs)
    if isinstance(want, tuple):
        (want, *want_rest), (got, *got_rest) = want, got
        assert _roundtrip(got_rest) == _roundtrip(want_rest)
    assert list(got.events) == list(want.events)
    assert got.to_chrome() == want.to_chrome()
    assert got.dropped == want.dropped
    for rec, name in ((want, "ref.json"), (got, "port.json")):
        rec.save(str(tmp_path / name))
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "ref.json").read_text())
    assert validate.validate_chrome_trace(got.to_chrome()) == []


def test_ring_eviction_never_corrupts_open_spans():
    rec, mid = _eviction(obs)
    assert [e for e in mid["traceEvents"] if e["ph"] == "B"]
    assert rec.dropped == 7 and "long_lived" in [e["name"] for e in rec.events]
    assert not rec._open
    inner, outer = _nested(obs).events
    assert (inner["t"], inner["dur"], outer["t"], outer["dur"]) == (1.0, 1.0, 0.0, 3.0)


def test_global_recorder_install_and_scoping():
    assert obs.get_recorder() is obs.NULL_RECORDER
    rec = obs.TraceRecorder(clock=StepClock())
    with obs.use_recorder(rec):
        assert obs.get_recorder() is rec
        with obs.use_recorder(None):
            assert obs.get_recorder() is obs.NULL_RECORDER
        assert obs.get_recorder() is rec
    obs.set_recorder(rec)
    try:
        assert trace_mod.get_recorder() is rec
    finally:
        obs.set_recorder(None)
    assert obs.get_recorder() is obs.NULL_RECORDER


MALFORMED_TRACES = [
    [],
    {"traceEvents": "nope"},
    {"traceEvents": [{}]},
    {"traceEvents": [7, {"name": "r", "ph": "e", "ts": 0, "pid": 0, "tid": 0, "id": "1:1",
                         "cat": "async"}]},
    {"traceEvents": [{"name": "s", "ph": "X", "ts": 0, "pid": 0, "tid": 0}]},
    {"traceEvents": [{"name": "s", "ph": "Q", "ts": -1, "pid": 0, "tid": 0},
                     {"name": "i", "ph": "i", "ts": 1, "pid": 0, "tid": 0, "s": "z"},
                     {"name": "b", "ph": "b", "ts": 1, "pid": 0, "tid": 0}]},
]
MALFORMED_METRICS = [
    [],
    {"schema": 2},
    {"schema": 1, "counters": {"c": -1, "d": "x"}, "gauges": {"g": "x"}, "histograms": []},
    {"schema": 1, "counters": {}, "gauges": {},
     "histograms": {"a": 3, "b": {"buckets": [2, 1], "counts": [0, 0, 0]},
                    "c": {"buckets": [1], "counts": [0]},
                    "d": {"buckets": [1], "counts": [1, -1], "count": 0},
                    "e": {"buckets": [1], "counts": [1, 1], "count": 3}}},
]


@pytest.mark.parametrize("i", range(len(MALFORMED_TRACES)))
def test_trace_validator_matches_reference(i):
    doc = MALFORMED_TRACES[i]
    probs = validate.validate_chrome_trace(doc)
    assert probs and probs == ref_validate.validate_chrome_trace(doc)


@pytest.mark.parametrize("i", range(len(MALFORMED_METRICS)))
def test_metrics_validator_matches_reference(i):
    doc = MALFORMED_METRICS[i]
    probs = validate.validate_metrics_snapshot(doc)
    assert probs and probs == ref_validate.validate_metrics_snapshot(doc)


def _registry(pkg):
    reg = pkg.MetricsRegistry()
    source = {"shed": 3, "expired": 0}
    reg.bind_counters("eng", lambda: dict(source), help="frozen")
    reg.counter("rows", "rows emitted").inc(2)
    reg.gauge("depth", "queue depth").set(1.5)
    reg.gauge("live", "pulled", fn=lambda: 4)
    h = reg.histogram("ttft_s", "time to first token", buckets=(0.5, 2.0))
    for v in (0.1, 7.0, 0.5, 1e-9):
        h.observe(v)
    reg.histogram("step_time_s", buckets=pkg.STEP_TIME_BUCKETS_S).observe(0.3)
    source["expired"] = 2  # bound counters are pulled at export
    errors = []
    for bad in (lambda: reg.gauge("rows"), lambda: reg.counter("c").inc(-1),
                lambda: reg.histogram("h", buckets=(2.0, 1.0)),
                lambda: reg.bind_counters("eng", lambda: {"shed": 0})):
        with pytest.raises(ValueError) as ei:
            bad()
        errors.append(str(ei.value))
    return reg.to_prometheus(), reg.snapshot(), errors


def test_registry_matches_reference():
    text, snap, errors = _registry(obs)
    assert (text, snap, errors) == _registry(ref_obs)
    assert validate.validate_metrics_snapshot(snap) == []
    assert snap["counters"]["eng_expired"] == 2.0
    assert (obs.TTFT_BUCKETS_S, obs.TPOT_BUCKETS_S, obs.STEP_TIME_BUCKETS_S) == (
        ref_obs.TTFT_BUCKETS_S, ref_obs.TPOT_BUCKETS_S, ref_obs.STEP_TIME_BUCKETS_S)


def test_null_recorder_overhead_unmeasurable():
    """Tracing off costs nothing measurable: the disabled path stays within
    the reference's per-call budget."""
    n = obs.NULL_RECORDER
    iters = 50_000
    t0 = time.perf_counter()
    for i in range(iters):
        with n.span("decode", n_active=4):
            pass
        n.instant("tick", i=i)
    per_call_us = (time.perf_counter() - t0) / (2 * iters) * 1e6
    assert per_call_us < 25.0, f"NullRecorder costs {per_call_us:.2f}us/call"


# ---------------------------------------------------------------------------
# Registries over the port's components: every frozen key exactly once
# ---------------------------------------------------------------------------


def _bound(reg, prefix):
    return [n for n, _, _ in reg._bound_samples() if n.startswith(prefix)]


def _assert_frozen_once(reg, prefix, keys, counters):
    names = _bound(reg, f"{prefix}_")
    assert sorted(names) == sorted(f"{prefix}_{k}" for k in keys)
    assert len(names) == len(set(names)), "a frozen key bound twice"
    snap = reg.snapshot()
    assert validate.validate_metrics_snapshot(snap) == []
    for k in keys:
        assert snap["counters"][f"{prefix}_{k}"] == float(counters[k])
    return snap


def test_scheduler_registry_every_frozen_key_exactly_once():
    clock = TickClock()
    eng = FakeEngine(PORT)
    rec = obs.TraceRecorder(clock=clock)
    sched = PORT.scheduler.Scheduler(
        PORT.scheduler.SchedulerConfig(max_batch=4, prefill_chunk=8, max_waiting=2),
        clock=clock, faults=eng.faults, trace=rec)
    eng.scheduler = sched
    reqs = [FakeReq(uid, deadline_e2e=100) for uid in range(4)]
    for r in reqs:
        sched.submit(r)
    _drive(sched, eng, clock=clock)

    class Surface:  # the scheduler and the gauges serving_registry reads
        counters_snapshot = sched.counters_snapshot
        metrics = sched.metrics

        @staticmethod
        def queue_depth():
            return len(sched.waiting)

        @staticmethod
        def degrade_level():
            return 0

    reg = obs.serving_registry(Surface)
    snap = _assert_frozen_once(reg, "serve", COUNTER_KEYS, sched.counters_snapshot())
    assert snap["counters"]["serve_shed"] == 2.0
    assert snap["histograms"]["serve_ttft_s"]["count"] == 2
    with pytest.raises(ValueError, match="already registered"):
        reg.bind_counters("serve", sched.counters_snapshot)
    ends = {e["args"]["uid"]: e["args"] for e in _roundtrip(rec.to_chrome())["traceEvents"]
            if e["ph"] == "e"}
    rows = {m["uid"]: m for m in sched.metrics()}
    assert ends == {u: _roundtrip(r) for u, r in rows.items()} and all(set(r) == set(METRIC_KEYS) for r in rows.values())


# ---------------------------------------------------------------------------
# The acceptance test: the engines' traces against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    rcfg = ref_get_config("starcoder2-7b", reduced=True)
    tcfg = get_config("starcoder2-7b", reduced=True)
    rparams = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    dcfg = rcfg.attention.distr
    proj = np.array(ref_lsh.make_projection(jax.random.PRNGKey(dcfg.proj_seed), dcfg.block_q))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, rparams), tcfg, proj=proj,
                              device="cpu")
    rcfg, tcfg = (c.replace(attention=c.attention.with_impl("reference")) for c in (rcfg, tcfg))
    return rcfg, rparams, tcfg, tparams


PROMPTS = [list(range(3, 11)), list(range(5, 17)), list(range(2, 8)), list(range(4, 14)),
           list(range(7, 12)), list(range(1, 20))]
DEGRADE = dict(group_sizes=(2,), high_watermark=2, low_watermark=0, up_after=1, down_after=1)
# Each run: engine settings, (max_new, submission step) a request, fault
# specs and the instants it must show.
TRACE_RUNS = {
    "slot": dict(
        engine=dict(max_slots=2, max_len=64, max_waiting=3),
        reqs=[(5, 0), (6, 0), (4, 0), (3, 0), (5, 0), (4, 4)],
        specs=[dict(point="nan_logits", uid=1, after=2, times=1)],
        degrade=DEGRADE, want=("shed", "degrade_level", "first_token")),
    "paged": dict(
        engine=dict(max_batch=3, max_len=64, block_size=8, prefill_chunk=8, num_blocks=9,
                    max_waiting=4),
        reqs=[(16, 0), (16, 0), (16, 0), (16, 0), (6, 0), (16, 3)],
        specs=[dict(point="nan_logits", uid=1, after=3, times=1)],
        degrade=DEGRADE, want=("shed", "preempt", "restore", "degraded_prefill",
                                "degrade_level", "first_token")),
}


def _traced(models, pkg, kind, run):
    """Drive one run on a tick clock under a recorder on the same clock →
    (the exported trace after a JSON round trip, metrics rows by uid,
    counters, decode steps, the engine)."""
    rcfg, rparams, tcfg, tparams = models
    clock = TickClock()
    ref = pkg == "ref"
    rec = (ref_obs if ref else obs).TraceRecorder(clock=clock)
    Injector, Spec, Degrade = ((RefFaultInjector, RefFaultSpec, RefDegradeConfig) if ref
                               else (FaultInjector, FaultSpec, DegradeConfig))
    kw = dict(run["engine"], clock=clock, trace=rec, degrade=Degrade(**run["degrade"]),
              faults=Injector([Spec(**s) for s in run["specs"]]))
    if kind == "slot":
        eng = (ref_engine.ServeEngine(rcfg, rparams, **kw) if ref
               else engine.ServeEngine(tcfg, tparams, device="cpu", **kw))
    else:
        eng = (ref_engine.PagedServeEngine(rcfg, rparams, cache_dtype=jnp.float32, **kw) if ref
               else engine.PagedServeEngine(tcfg, tparams, cache_dtype=torch.float32,
                                            device="cpu", **kw))
    submitted = 0
    for step in range(300):
        for i, (new, at) in enumerate(run["reqs"]):
            if at == step:
                eng.add_request(PROMPTS[i], max_new_tokens=new)
                submitted += 1
        eng.step()
        clock.t += 1
        if submitted == len(run["reqs"]) and not eng.has_work():
            break
    assert not eng.has_work()
    rows = {m["uid"]: m for m in eng.metrics()}
    return _roundtrip(rec.to_chrome()), rows, eng.counters_snapshot(), eng


@pytest.mark.parametrize("kind", sorted(TRACE_RUNS))
def test_engine_trace_matches_reference(models, kind):
    """The port's engine and the reference's, on a tick clock through a
    shed, a preemption and restore (paged), degraded prefills and an
    injected fault, export the same Chrome trace event for event: names,
    phases, ids, args and ts.  Each request opens and closes one span, its
    end args equal its ``metrics()`` row, and the registry over the engine
    shows every frozen key once."""
    run = TRACE_RUNS[kind]
    want, want_rows, want_counters, _ = _traced(models, "ref", kind, run)
    got, rows, counters, eng = _traced(models, "port", kind, run)
    assert validate.validate_chrome_trace(got) == []
    assert len(got["traceEvents"]) == len(want["traceEvents"])
    for i, (g, w) in enumerate(zip(got["traceEvents"], want["traceEvents"])):
        assert g == w, f"event {i} differs"
    assert got == want and rows == want_rows and counters == want_counters
    names = {e["name"] for e in got["traceEvents"]}
    assert set(run["want"]) <= names, set(run["want"]) - names
    begins = [e["args"]["uid"] for e in got["traceEvents"]
              if e["ph"] == "b" and e["name"] == "request"]
    ends = {e["args"]["uid"]: e["args"] for e in got["traceEvents"]
            if e["ph"] == "e" and e["name"] == "request"}
    assert sorted(begins) == sorted(ends) == sorted(rows) == list(range(len(run["reqs"])))
    assert ends == {u: _roundtrip(r) for u, r in rows.items()}
    assert any(r["status"] not in ("done", "rejected") for r in rows.values()), "no fault hit"
    reg = obs.serving_registry(eng)
    _assert_frozen_once(reg, "serve", COUNTER_KEYS, eng.counters_snapshot())
    assert reg.snapshot() == _roundtrip(reg.snapshot())


# ---------------------------------------------------------------------------
# The launchers on the CPU, checked by the validator's command line
# ---------------------------------------------------------------------------


def _validate_cli(trace, metrics):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", "repro_torch.obs.validate", "--trace", trace,
                           "--metrics", metrics], capture_output=True, text=True, env=env,
                          timeout=120)


def test_launch_serve_trace_and_metrics_validate(tmp_path, capsys):
    from repro_torch.launch import serve

    t, m = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    out = serve.main(["--arch", "starcoder2-7b", "--reduced", "--device", "cpu", "--requests",
                      "3", "--max-new", "3", "--max-len", "64", "--trace", t,
                      "--metrics-out", m])
    assert "[serve] trace:" in capsys.readouterr().out
    res = _validate_cli(t, m)
    assert res.returncode == 0 and "conform" in res.stdout, res.stdout + res.stderr
    doc = json.loads(open(t).read())
    ends = [e for e in doc["traceEvents"] if e["ph"] == "e"]
    assert len(ends) == 3 and sum(e["name"] == "decode" for e in doc["traceEvents"]) > 0
    snap = json.loads(open(m).read())
    assert {f"serve_{k}" for k in COUNTER_KEYS} <= set(snap["counters"])
    assert snap["histograms"]["serve_ttft_s"]["count"] == len(out["metrics"]) == 3


def test_launch_train_trace_and_metrics_validate(tmp_path, capsys):
    from repro_torch.launch import train

    t, m, w = str(tmp_path / "t.json"), str(tmp_path / "m.json"), str(tmp_path / "w")
    argv = ["--arch", "minicpm-2b", "--reduced", "--device", "cpu", "--steps", "3", "--batch",
            "2", "--seq", "16", "--workdir", w, "--ckpt-every", "2", "--trace", t,
            "--metrics-out", m]
    out = train.main(argv)
    assert "[train] trace:" in capsys.readouterr().out
    assert obs.get_recorder() is obs.NULL_RECORDER
    res = _validate_cli(t, m)
    assert res.returncode == 0 and "conform" in res.stdout, res.stdout + res.stderr
    doc = json.loads(open(t).read())
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("train/step") == 3 and names.count("fwd_bwd") == 3
    assert [e["args"]["tag"] for e in doc["traceEvents"] if e["name"] == "ckpt"] == [
        "", "", "final"]
    snap = json.loads(open(m).read())
    trainer = out["trainer"]
    reg = obs.train_registry(trainer)
    _assert_frozen_once(reg, "train", TRAIN_COUNTER_KEYS, trainer.counters_snapshot())
    assert snap == _roundtrip(reg.snapshot())
    assert snap["gauges"]["train_step"] == 3
    assert snap["histograms"]["train_step_time_s"]["count"] == 3
    resumed = train.main(argv[:-4])  # the same workdir: resumes at step 3
    assert resumed["trainer"].step == 6 and [r["step"] for r in resumed["history"]] == [4, 5, 6]
