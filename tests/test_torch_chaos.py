"""Port parity of the fault layer (``repro_torch.faults``, serve.faults), on
the CPU, against the JAX package.

The FaultSpec / FaultInjector triggers and the frozen catalogs and scheduler
settings; the continuous-batching scheduler's fault containment through a
fake engine (policy only, no model: ``tests/test_chaos.py``'s fake-engine
cases, each run on both packages with equal outcomes); and the real slot
and paged engines (starcoder2-7b ``reduced()``, f32, the reference's
weights carried across, the ``reference`` attention impl) fed the same
fault specs and a tick clock: equal statuses, counters, metrics rows and
tokens to the reference engines', every request terminal, no pool block
leaked, and the requests not at fault bit-identical to a fault-free run.
"""
from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as ref_faults  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.serve import degrade as ref_degrade  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import lifecycle as ref_lifecycle  # noqa: E402
from repro.serve import paged as ref_paged  # noqa: E402
from repro.serve import scheduler as ref_scheduler  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.obs import trace as port_trace  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve import degrade, engine, lifecycle, paged, scheduler  # noqa: E402
from repro_torch.serve import faults as serve_faults  # noqa: E402

REF = SimpleNamespace(name="ref", faults=ref_faults, paged=ref_paged, scheduler=ref_scheduler,
                      degrade=ref_degrade, lifecycle=ref_lifecycle, trace=ref_trace)
PORT = SimpleNamespace(name="port", faults=faults, paged=paged, scheduler=scheduler,
                       degrade=degrade, lifecycle=lifecycle, trace=port_trace)

FaultInjector, FaultSpec, InjectedFault = faults.FaultInjector, faults.FaultSpec, faults.InjectedFault


# ---------------------------------------------------------------------------
# The triggers and the frozen catalogs
# ---------------------------------------------------------------------------


def test_fault_spec_counted_window():
    """A spec fires exactly on hits [after, after + times); times=-1 fires
    forever."""
    inj = FaultInjector([FaultSpec("stuck_step", after=2, times=3)])
    fired = [inj.fires("stuck_step") is not None for _ in range(8)]
    assert fired == [False, False, True, True, True, False, False, False]
    persistent = FaultInjector([FaultSpec("nan_logits", times=-1)])
    assert all(persistent.fires("nan_logits") is not None for _ in range(20))


def test_fault_spec_rejects_unknown_point():
    with pytest.raises(ValueError, match="unknown fault point"):
        FaultSpec("disk_on_fire")


def test_injector_uid_filter_and_dead_shards():
    inj = FaultInjector([
        FaultSpec("nan_logits", uid=7, times=-1),
        FaultSpec("dead_ring_shard", shards=(1, 3)),
        FaultSpec("dead_ring_shard", shards=(3, 5)),
    ])
    assert inj.fires("nan_logits", uid=3) is None
    assert inj.fires("nan_logits", uid=7) is not None
    assert inj.dead_shards() == frozenset({1, 3, 5})
    assert inj.raise_if("pool_exhausted", uid=7) is None  # no spec: a no-op
    with pytest.raises(InjectedFault) as ei:
        FaultInjector([FaultSpec("stuck_step")]).raise_if("stuck_step", 4)
    assert ei.value.point == "stuck_step" and ei.value.uid == 4


def test_fault_spec_counts_hits_per_matching_uid():
    """A uid-filtered spec counts only the consultations it matches."""
    inj = FaultInjector([FaultSpec("nan_logits", uid=1, after=2, times=1)])
    fired = []
    for _ in range(4):
        inj.fires("nan_logits", uid=0)  # never matches, never counts
        fired.append(inj.fires("nan_logits", uid=1) is not None)
    assert fired == [False, False, True, False]
    inj = FaultInjector([FaultSpec("nan_logits", after=2, times=1)])
    assert [inj.fires("nan_logits", uid=u) is not None for u in (0, 1, 0, 1)] == [
        False, False, True, False]


def test_multiple_specs_on_one_point():
    """Every matching spec counts the hit; the first whose window covers it
    is returned, so staggered windows hand over deterministically."""
    a = FaultSpec("stuck_step", after=0, times=2)
    b = FaultSpec("stuck_step", after=1, times=3)
    inj = FaultInjector([a, b])
    winners = []
    for _ in range(5):
        s = inj.fires("stuck_step")
        winners.append(None if s is None else ("a" if s is a else "b"))
    assert winners == ["a", "a", "b", "b", None]
    assert inj.fires("stuck_step") is None  # exhaustion is permanent
    u = FaultSpec("pool_exhausted", uid=5, times=-1)
    g = FaultSpec("pool_exhausted", after=1, times=-1)
    inj = FaultInjector([u, g])
    assert inj.fires("pool_exhausted", uid=3) is None  # g's hit 0 (after=1)
    assert inj.fires("pool_exhausted", uid=5) is u
    assert inj.fires("pool_exhausted", uid=3) is g


def test_replica_crash_point_in_catalog():
    inj = FaultInjector([FaultSpec("replica_crash", uid=1, after=2)])
    assert inj.fires("replica_crash", uid=0) is None
    assert [inj.fires("replica_crash", uid=1) is not None for _ in range(4)] == [
        False, False, True, False]


def test_catalogs_and_settings_match_reference():
    """The fault catalogs, the counter schema, the scheduler's settings and
    their defaults, and the scheduler's per-request fields are the
    reference's; serve.faults re-exports the shared module."""
    assert faults.SERVE_POINTS == ref_faults.SERVE_POINTS
    assert faults.TRAIN_POINTS == ref_faults.TRAIN_POINTS
    assert faults.POINTS == ref_faults.POINTS
    assert lifecycle.COUNTER_KEYS == ref_lifecycle.COUNTER_KEYS
    assert lifecycle.METRIC_KEYS == ref_lifecycle.METRIC_KEYS
    for name in serve_faults.__all__:
        assert getattr(serve_faults, name) is getattr(faults, name)

    def defaults(cls):
        return [(f.name, f.default) for f in fields(cls)]

    assert defaults(scheduler.SchedulerConfig) == defaults(ref_scheduler.SchedulerConfig)
    assert [f.name for f in fields(scheduler.Entry)] == [
        f.name for f in fields(ref_scheduler.Entry)]
    assert not faults.NULL_INJECTOR.specs


# ---------------------------------------------------------------------------
# The scheduler through a fake engine, on both packages
# ---------------------------------------------------------------------------


class FakeReq:
    def __init__(self, uid, n_prompt=8, max_new=4, deadline_ttft=None, deadline_e2e=None):
        self.uid = uid
        self.prompt = list(range(1, n_prompt + 1))
        self.max_new_tokens = max_new
        self.eos_id = None
        self.generated = []
        self.done = False
        self.status = "queued"
        self.deadline_ttft = deadline_ttft
        self.deadline_e2e = deadline_e2e
        self.degrade_group = 1


class FakeEngine:
    """The scheduler's primitive surface over one package's bare BlockPool,
    consulting its FaultInjector at the points the real paged engine does."""

    def __init__(self, pkg, specs=(), num_blocks=16, block_size=8, max_batch=4,
                 capacity=64):
        self.pkg = pkg
        self.pool = pkg.paged.BlockPool(num_blocks, block_size)
        self.bs = block_size
        self.max_batch = max_batch
        self.capacity_tokens = capacity
        self.faults = pkg.faults.FaultInjector([pkg.faults.FaultSpec(**s) for s in specs])
        self.ids: dict[int, list[int]] = {}
        self.evicted_uids: set[int] = set()
        self.degraded_prompts: list[tuple[int, int]] = []
        self.scheduler = None

    def free_lane(self):
        return next(lane for lane in range(self.max_batch)
                    if lane not in self.scheduler.running)

    def alloc(self, entry, n_tokens):
        if self.faults.fires("pool_exhausted", entry.uid) is not None:
            return False
        need = -(-n_tokens // self.bs) - len(self.ids.get(entry.uid, []))
        if need <= 0:
            return True
        try:
            got = self.pool.alloc(need)
        except self.pkg.paged.PoolExhausted:
            return False
        self.ids.setdefault(entry.uid, []).extend(got)
        return True

    def can_admit(self, entry):
        need = -(-min(len(entry.req.prompt) + 1, self.capacity_tokens) // self.bs)
        return self.pool.num_free >= need

    def holds_blocks(self, entry):
        return bool(self.ids.get(entry.uid))

    def evict(self, entry):
        for b in self.ids.pop(entry.uid):
            self.pool.free(b)
        self.evicted_uids.add(entry.uid)

    def restore(self, entry):
        self.faults.raise_if("restore_failure", entry.uid)
        try:
            self.ids[entry.uid] = self.pool.alloc(-(-max(entry.length, 1) // self.bs))
        except self.pkg.paged.PoolExhausted:
            return False
        return True

    def release(self, entry):
        for b in self.ids.pop(entry.uid, []):
            self.pool.free(b)

    def sample_one(self, logits):
        return 1

    def prefill_chunk_run(self, entry, chunk):
        self.faults.raise_if("stuck_step", entry.uid)
        if self.faults.fires("nan_logits", entry.uid) is not None:
            return float("nan")
        return float(entry.uid)

    def decode_tick(self, running):
        for e in running.values():
            self.faults.raise_if("stuck_step", e.uid)
        ok = np.ones((self.max_batch,), bool)
        for lane, e in running.items():
            if self.faults.fires("nan_logits", e.uid) is not None:
                ok[lane] = False
        return np.full((self.max_batch,), 1, np.int64), ok


class DegradedFakeEngine(FakeEngine):
    def prefill_full_run(self, entry, group):
        self.faults.raise_if("stuck_step", entry.uid)
        self.degraded_prompts.append((entry.uid, group))
        return float(entry.uid)


class MeshFakeEngine(FakeEngine):
    """The fake engine with the mesh admission surface: a prompt longer than
    ``threshold`` prefills whole in one tick, consulting ``stuck_step`` and
    ``mesh_prefill`` before any pool write, as ``PagedServeEngine.
    prefill_mesh_run`` does."""

    def __init__(self, pkg, specs=(), threshold=8, **kw):
        super().__init__(pkg, specs, **kw)
        self.threshold = threshold
        self.mesh_prompts: list[int] = []

    def mesh_prefill_ready(self, n):
        return n > self.threshold

    def prefill_mesh_run(self, entry):
        self.faults.raise_if("stuck_step", entry.uid)
        self.faults.raise_if("mesh_prefill", entry.uid)
        self.mesh_prompts.append(entry.uid)
        if self.faults.fires("nan_logits", entry.uid) is not None:
            return float("nan")
        return float(entry.uid)


class TickClock:
    """Deadlines, TTFT and TPOT in ticks."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _sched(pkg, eng, *, max_batch=4, chunk=8, clock=None, degrade_cfg=None, trace=None,
           **cfg_kw):
    s = pkg.scheduler.Scheduler(
        pkg.scheduler.SchedulerConfig(max_batch=max_batch, prefill_chunk=chunk, **cfg_kw),
        clock=clock or (lambda: 0.0), faults=eng.faults,
        degrade=pkg.degrade.DegradeConfig(**degrade_cfg) if degrade_cfg else None, trace=trace)
    eng.scheduler = s
    return s


def _drive(sched, eng, clock=None, max_ticks=500):
    for _ in range(max_ticks):
        sched.tick(eng)
        if clock is not None:
            clock.t += 1
        if not sched.has_work():
            return
    raise AssertionError("scheduler did not drain within max_ticks")


def _outcome(pkg, sched, eng, reqs, **extra) -> dict:
    """What a run ends with; also asserts every request terminal and every
    block back in the pool."""
    assert not sched.has_work()
    for r in reqs:
        assert pkg.lifecycle.is_terminal(r.status), (r.uid, r.status)
    assert eng.pool.num_free == eng.pool.num_blocks - 1, "blocks leaked"
    assert not eng.ids, "the fake engine still maps a uid to blocks"
    return {"status": [r.status for r in reqs], "generated": [r.generated for r in reqs],
            "counters": sched.counters_snapshot(), "metrics": sched.metrics(),
            "evicted": sorted(eng.evicted_uids), "degraded": eng.degraded_prompts, **extra}


def _both(run) -> dict:
    """``run(pkg)`` on the reference and on the port: equal outcomes; the
    port's is returned for the case's own assertions."""
    want, got = run(REF), run(PORT)
    assert got == want
    return got


def _simple(specs=(), n=3, eng_kw=None, req_kw=None, **sched_kw):
    """A run of ``n`` FakeReqs submitted at once, driven to the end."""
    def run(pkg):
        eng = FakeEngine(pkg, specs, **(eng_kw or {}))
        sched = _sched(pkg, eng, **sched_kw)
        reqs = [FakeReq(uid, **(req_kw or {})) for uid in range(n)]
        for r in reqs:
            sched.submit(r)
        _drive(sched, eng)
        return _outcome(pkg, sched, eng, reqs)
    return _both(run)


def test_shed_rejects_newest_when_queue_full():
    def run(pkg):
        eng = FakeEngine(pkg)
        sched = _sched(pkg, eng, max_waiting=2)
        reqs = [FakeReq(uid) for uid in range(5)]
        entries = [sched.submit(r) for r in reqs]
        _drive(sched, eng)
        return _outcome(pkg, sched, eng, reqs, admitted=[e is not None for e in entries])
    got = _both(run)
    assert got["admitted"] == [True, True, False, False, False]
    assert got["status"] == ["done"] * 2 + ["rejected"] * 3
    assert got["counters"]["shed"] == 3


def test_cancel_frees_blocks_immediately():
    def run(pkg):
        eng = FakeEngine(pkg)
        sched = _sched(pkg, eng, chunk=4)
        reqs = [FakeReq(uid, n_prompt=12, max_new=8) for uid in range(3)]
        for r in reqs:
            sched.submit(r)
        unknown = sched.cancel(99, eng)
        waiting = sched.cancel(2, eng)
        sched.tick(eng)  # uid 0 mid-prefill
        held = len(eng.ids.get(0, []))
        mid = sched.cancel(0, eng)
        freed = 0 not in eng.ids
        _drive(sched, eng)
        return _outcome(pkg, sched, eng, reqs, calls=(unknown, waiting, held > 0, mid, freed))
    got = _both(run)
    assert got["calls"] == (False, True, True, True, True)
    assert got["status"] == ["cancelled", "done", "cancelled"]
    assert got["counters"]["cancelled"] == 2


def test_cancel_running_entry_mid_decode():
    def run(pkg):
        eng = FakeEngine(pkg)
        sched = _sched(pkg, eng)
        reqs = [FakeReq(uid, max_new=32) for uid in range(2)]
        for r in reqs:
            sched.submit(r)
        for _ in range(3):
            sched.tick(eng)
        running = any(e.uid == 1 for e in sched.running.values())
        cancelled = sched.cancel(1, eng)
        _drive(sched, eng)
        return _outcome(pkg, sched, eng, reqs, calls=(running, cancelled))
    got = _both(run)
    assert got["calls"] == (True, True)
    assert got["status"] == ["done", "cancelled"]


def test_ttft_deadline_expires_waiting_requests():
    def run(pkg):
        eng = FakeEngine(pkg, max_batch=1)
        clock = TickClock()
        sched = _sched(pkg, eng, max_batch=1, clock=clock)
        reqs = [FakeReq(0, max_new=16), FakeReq(1, deadline_ttft=2),
                FakeReq(2, deadline_ttft=1000)]
        for r in reqs:
            sched.submit(r)
        _drive(sched, eng, clock=clock)
        return _outcome(pkg, sched, eng, reqs)
    got = _both(run)
    assert got["status"] == ["done", "expired", "done"]
    assert got["counters"]["expired"] == 1


def test_e2e_deadline_expires_running_request():
    def run(pkg):
        eng = FakeEngine(pkg)
        clock = TickClock()
        sched = _sched(pkg, eng, clock=clock)
        reqs = [FakeReq(0, max_new=100, deadline_e2e=5), FakeReq(1, max_new=2)]
        for r in reqs:
            sched.submit(r)
        _drive(sched, eng, clock=clock)
        return _outcome(pkg, sched, eng, reqs)
    got = _both(run)
    assert got["status"] == ["expired", "done"]
    assert 0 < len(got["generated"][0]) < 100, "expiry never interrupted it"


def test_slow_step_fault_ages_deadlines_without_sleeping():
    def run(pkg):
        eng = FakeEngine(pkg, [dict(point="slow_step", after=1, delay=50.0)])
        clock = TickClock()
        sched = _sched(pkg, eng, clock=clock)
        reqs = [FakeReq(0, max_new=100, deadline_e2e=20),
                FakeReq(1, max_new=3, deadline_e2e=10_000)]
        for r in reqs:
            sched.submit(r)
        _drive(sched, eng, clock=clock)
        return _outcome(pkg, sched, eng, reqs)
    assert _both(run)["status"] == ["expired", "done"]  # 50 > 20 after one tick


def test_stuck_prefill_transient_fault_recovers():
    got = _simple([dict(point="stuck_step", uid=1, times=2)])  # the budget is 2 retries
    assert got["status"] == ["done"] * 3
    assert got["counters"]["step_retries"] == 2


def test_stuck_prefill_persistent_fault_fails_culprit_only():
    got = _simple([dict(point="stuck_step", uid=1, times=-1)])
    assert got["status"] == ["done", "failed", "done"]
    assert got["counters"]["failed_fault"] == 1


def test_stuck_decode_fails_culprit_only():
    got = _simple([dict(point="stuck_step", uid=1, after=2, times=-1)], req_kw=dict(max_new=6))
    assert got["status"] == ["done", "failed", "done"]
    assert len(got["generated"][0]) == 6


def test_nan_prefill_quarantined_before_lane():
    got = _simple([dict(point="nan_logits", uid=0, times=-1)], n=2)
    assert got["status"] == ["failed", "done"]
    assert got["generated"][0] == [], "a poisoned prompt must not sample"
    assert got["counters"]["failed_numeric"] == 1


def test_nan_decode_quarantines_lane_only():
    got = _simple([dict(point="nan_logits", uid=1, after=2, times=1)], req_kw=dict(max_new=6))
    assert got["status"] == ["done", "failed", "done"]
    assert len(got["generated"][0]) == 6 and len(got["generated"][2]) == 6


def test_restore_fault_backoff_then_fail():
    """A restore that raises backs off and fails after its budget; a
    capacity wait (a False return) costs no retry."""
    got = _simple([dict(point="restore_failure", uid=3, times=-1)], n=4,
                  eng_kw=dict(num_blocks=9), req_kw=dict(n_prompt=10, max_new=16),
                  restore_max_retries=3, restore_backoff_ticks=1)
    assert 3 in got["evicted"], "pressure never preempted uid 3"
    assert got["status"] == ["done"] * 3 + ["failed"]
    assert got["counters"]["restore_retries"] == 4  # 3 retries and the last
    assert all(len(g) == 16 for g in got["generated"][:3])


def test_restore_transient_fault_recovers():
    got = _simple([dict(point="restore_failure", uid=3, times=2)], n=4,
                  eng_kw=dict(num_blocks=9), req_kw=dict(n_prompt=10, max_new=16))
    assert got["status"] == ["done"] * 4
    assert all(len(g) == 16 for g in got["generated"])
    assert got["counters"]["restore_retries"] == 2


def test_watchdog_fails_head_on_global_stall():
    got = _simple([dict(point="pool_exhausted", uid=0, times=-1)], watchdog_ticks=6)
    assert got["status"] == ["failed", "done", "done"]
    assert got["counters"]["watchdog_fails"] == 1


@pytest.mark.parametrize("point,kw", [
    ("pool_exhausted", dict(uid=1, times=-1)),
    ("nan_logits", dict(uid=1, times=-1)),
    ("stuck_step", dict(uid=1, times=-1)),
    ("restore_failure", dict(uid=1, times=-1)),
    ("slow_step", dict(delay=1.0, times=3)),
])
def test_every_fault_reaches_terminal_status(point, kw):
    _simple([dict(point=point, **kw)], n=4, watchdog_ticks=6)


def test_scheduler_degrades_under_pressure_and_recovers():
    """A flooded queue raises the dial, new prompts prefill degraded (G*
    recorded on the request), and the drained dial returns to exact within
    its bound; a stuck whole-prompt prefill is retried, then its request
    fails alone."""
    dcfg = dict(group_sizes=(2, 4), high_watermark=3, low_watermark=1, up_after=2,
                down_after=2)

    def run(pkg):
        eng = DegradedFakeEngine(pkg, [dict(point="stuck_step", uid=5, times=-1)],
                                 num_blocks=64, max_batch=2)
        sched = _sched(pkg, eng, max_batch=2, degrade_cfg=dcfg)
        flood = [FakeReq(uid, n_prompt=16, max_new=2) for uid in range(12)]
        for r in flood:
            sched.submit(r)
        _drive(sched, eng)
        moved = sched.degrade.level > 0 or bool(sched.degrade.transitions)
        bound = pkg.degrade.DegradeConfig(**dcfg).return_bound_ticks()
        for _ in range(bound + dcfg["down_after"]):
            sched.tick(eng)
        level = sched.degrade.level
        late = FakeReq(100, n_prompt=16, max_new=2)
        sched.submit(late)
        _drive(sched, eng)
        return _outcome(pkg, sched, eng, flood + [late], checks=(moved, level),
                        groups=[r.degrade_group for r in flood + [late]])
    got = _both(run)
    assert got["checks"] == (True, 0), "the dial did not move or did not return to exact"
    assert got["degraded"], "overload never triggered a degraded prefill"
    degraded = {uid for uid, _ in got["degraded"]}
    assert all((g > 1) == (uid in degraded) for uid, g in enumerate(got["groups"][:12]))
    assert got["groups"][-1] == 1, "a prompt after the drain should be exact"
    assert got["status"][5] == "failed" and got["status"].count("done") == 12
    assert got["counters"]["degraded_prefills"] == len(got["degraded"])
    assert got["counters"]["failed_fault"] == 1 and got["counters"]["step_retries"] == 3


def _mesh_run(specs=(), threshold=8, n=3, req_kw=None, **sched_kw):
    """``tests/test_chaos.py``'s mesh-admission scenarios: ``n`` FakeReqs
    through a ``MeshFakeEngine``, on both packages, with the trace events
    in the outcome (a recorder on the scheduler's constant clock)."""
    def run(pkg):
        eng = MeshFakeEngine(pkg, specs, threshold=threshold)
        rec = pkg.trace.TraceRecorder(clock=lambda: 0.0)
        sched = _sched(pkg, eng, trace=rec, **sched_kw)
        reqs = [FakeReq(uid, **(req_kw or {})) for uid in range(n)]
        for r in reqs:
            sched.submit(r)
        _drive(sched, eng)
        return _outcome(pkg, sched, eng, reqs, mesh=eng.mesh_prompts,
                        events=rec.to_chrome()["traceEvents"])
    return _both(run)


def test_mesh_prefill_one_tick_admission():
    """A prompt past the threshold admits whole in one tick, a shorter one
    keeps the chunked path; both drain clean."""
    def run(pkg):
        eng = MeshFakeEngine(pkg, threshold=8)
        rec = pkg.trace.TraceRecorder(clock=lambda: 0.0)
        sched = _sched(pkg, eng, chunk=4, trace=rec)
        reqs = [FakeReq(0, n_prompt=16, max_new=3), FakeReq(1, n_prompt=16, max_new=3),
                FakeReq(2, n_prompt=6, max_new=3)]
        for r in reqs:
            sched.submit(r)
        _drive(sched, eng)
        return _outcome(pkg, sched, eng, reqs, mesh=eng.mesh_prompts,
                        events=rec.to_chrome()["traceEvents"])
    got = _both(run)
    assert got["status"] == ["done"] * 3
    assert got["mesh"] == [0, 1]
    assert got["counters"]["mesh_prefills"] == 2
    instants = [e for e in got["events"] if e["name"] == "mesh_prefill"]
    assert [(e["args"]["uid"], e["args"]["n"]) for e in instants] == [(0, 16), (1, 16)]


def test_mesh_prefill_transient_fault_recovers():
    """A ``mesh_prefill`` fault within the retry budget costs ticks, not the
    request: it raises before any pool write."""
    got = _mesh_run([dict(point="mesh_prefill", uid=1, times=2)], req_kw=dict(n_prompt=16,
                                                                             max_new=3))
    assert got["status"] == ["done"] * 3
    assert got["counters"]["step_retries"] == 2
    assert got["counters"]["mesh_prefills"] == 3


def test_mesh_prefill_persistent_fault_fails_culprit_only():
    got = _mesh_run([dict(point="mesh_prefill", uid=1, times=-1)], req_kw=dict(n_prompt=16,
                                                                              max_new=3))
    assert got["status"] == ["done", "failed", "done"]
    assert got["counters"]["failed_fault"] == 1
    assert 1 not in got["mesh"], "the faulted prefill reached the pool"


@pytest.mark.parametrize("point,kw", [
    ("mesh_prefill", dict(uid=1, times=-1)),
    ("nan_logits", dict(uid=1, times=-1)),
    ("stuck_step", dict(uid=1, times=-1)),
    ("pool_exhausted", dict(uid=1, times=-1)),
])
def test_every_fault_reaches_terminal_under_mesh_admission(point, kw):
    """Every prompt (8 > 4) admits through the mesh path."""
    got = _mesh_run([dict(point=point, **kw)], threshold=4, n=4, watchdog_ticks=6)
    assert got["counters"]["mesh_prefills"] >= 1


def test_metrics_rows_carry_status_and_degrade_group():
    got = _simple(n=1)
    (row,) = got["metrics"]
    assert row["status"] == "done" and row["degrade_group"] == 1
    assert row["n_generated"] == len(got["generated"][0])


# ---------------------------------------------------------------------------
# The real engines against the reference engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    rcfg = ref_get_config("starcoder2-7b", reduced=True)
    tcfg = get_config("starcoder2-7b", reduced=True)
    rparams = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, rparams), tcfg, device="cpu")
    rcfg, tcfg = (c.replace(attention=c.attention.with_impl("reference")) for c in (rcfg, tcfg))
    return rcfg, rparams, tcfg, tparams


PROMPTS = [list(range(3, 11)), list(range(5, 17)), list(range(2, 8))]
SLOT = dict(max_slots=3, max_len=64)
PAGED = dict(max_batch=3, max_len=64, block_size=8, prefill_chunk=8)
# Each case: fault specs, per-request (max_new, deadlines, submission step),
# engine settings, and cancels {step: uid}.  uid 1 is the request at fault.
BASE_REQS = ((6, {}, 0),) * 3
CLEAN = dict()
CASES = {
    "nan_prefill": dict(specs=[dict(point="nan_logits", uid=1, times=-1)]),
    # uid 1's prompt takes three chunk windows on the paged engine.
    "nan_decode": dict(specs=[dict(point="nan_logits", uid=1, after=3, times=1)]),
    "stuck_prefill": dict(specs=[dict(point="stuck_step", uid=1, times=-1)]),
    "stuck_decode": dict(specs=[dict(point="stuck_step", uid=1, after=2, times=-1)]),
    "slow_step": dict(specs=[dict(point="slow_step", after=3, delay=50.0)],
                      reqs=((6, {}, 0), (6, dict(deadline_e2e=20.0), 0), (6, {}, 0))),
    "cancel": dict(cancel={3: 1}),
    "e2e_deadline": dict(reqs=((6, {}, 0), (30, dict(deadline_e2e=4.0), 0), (6, {}, 0))),
    "shed_and_ttft": dict(reqs=((6, {}, 0), (6, dict(deadline_ttft=2.0), 1), (6, {}, 1)),
                          engine=dict(max_waiting=1, lanes=1)),
}
PAGED_CASES = {
    "pool_exhausted": dict(specs=[dict(point="pool_exhausted", uid=1, times=-1)]),
    # Six lanes' worth of requests in a 9-block pool: decode growth preempts
    # the newest holder, uid 2, whose restores then fail.
    "restore_failure": dict(specs=[dict(point="restore_failure", uid=2, times=-1)],
                            reqs=((16, {}, 0),) * 3, engine=dict(num_blocks=9)),
}


def _engine(models, pkg, kind, case, clock):
    rcfg, rparams, tcfg, tparams = models
    kw = dict(case.get("engine", {}))
    lanes = kw.pop("lanes", None)
    specs = [pkg.faults.FaultSpec(**s) for s in case.get("specs", ())]
    kw.update(clock=clock, faults=pkg.faults.FaultInjector(specs))
    if kind == "slot":
        kw = {**SLOT, **kw, **({"max_slots": lanes} if lanes else {})}
        if pkg is REF:
            return ref_engine.ServeEngine(rcfg, rparams, **kw)
        return engine.ServeEngine(tcfg, tparams, device="cpu", **kw)
    kw = {**PAGED, **kw, **({"max_batch": lanes} if lanes else {})}
    if pkg is REF:
        return ref_engine.PagedServeEngine(rcfg, rparams, cache_dtype=jnp.float32, **kw)
    return engine.PagedServeEngine(tcfg, tparams, cache_dtype=torch.float32, device="cpu", **kw)


def _serve(models, pkg, kind, case) -> dict:
    """Submit, cancel and step on the case's schedule, one tick a step, to
    the end → statuses, tokens, counters and metrics rows by uid."""
    clock = TickClock()
    eng = _engine(models, pkg, kind, case, clock)
    free0 = eng.cache.pool.num_free if kind == "paged" else None
    reqs = case.get("reqs", BASE_REQS)
    uids = {}
    for step in range(300):
        for i, (new, deadlines, at) in enumerate(reqs):
            if at == step:
                uids[i] = eng.add_request(PROMPTS[i], max_new_tokens=new, **deadlines)
        if step in case.get("cancel", {}):
            assert eng.cancel(case["cancel"][step])
        eng.step()
        clock.t += 1
        if len(uids) == len(reqs) and not eng.has_work():
            break
    assert not eng.has_work()
    by_uid = {r.uid: r for r in eng.finished}
    assert sorted(by_uid) == sorted(uids.values())
    assert all(pkg.lifecycle.is_terminal(r.status) for r in by_uid.values())
    if kind == "paged":
        assert eng.cache.pool.num_free == free0, "pool blocks leaked"
    return {"status": {u: r.status for u, r in by_uid.items()},
            "tokens": {u: r.generated for u, r in by_uid.items()},
            "counters": eng.counters_snapshot(),
            "metrics": sorted(eng.metrics(), key=lambda m: m["uid"])}


@pytest.fixture(scope="module")
def clean_runs(models):
    return {kind: _serve(models, PORT, kind, CLEAN) for kind in ("slot", "paged")}


@pytest.mark.parametrize("kind,name", [("slot", n) for n in CASES]
                         + [("paged", n) for n in {**CASES, **PAGED_CASES}])
def test_engine_under_fault_matches_reference(models, clean_runs, kind, name):
    """The port's engine and the reference's, fed the same fault specs and
    a tick clock, end with equal statuses, counters, metrics and tokens;
    the requests not at fault finish with the fault-free run's tokens."""
    case = {**CASES, **PAGED_CASES}[name]
    want = _serve(models, REF, kind, case)
    got = _serve(models, PORT, kind, case)
    assert got == want
    counters = {k: v for k, v in got["counters"].items() if v}
    if "lanes" not in case.get("engine", {}):  # the same batch shape as the clean run
        clean = clean_runs[kind]["tokens"]
        for uid, status in got["status"].items():
            n = min(len(got["tokens"][uid]), len(clean[uid]))
            if status == "done":
                assert got["tokens"][uid][:n] == clean[uid][:n]
    if name in ("nan_prefill", "nan_decode"):
        assert got["status"][1] == "failed" and counters == {"failed_numeric": 1}
        assert (got["tokens"][1] == []) == (name == "nan_prefill")
    elif name == "stuck_prefill" or name == "stuck_decode":
        assert got["status"][1] == "failed"
        assert counters == {"failed_fault": 1, "step_retries": 3}
    elif name in ("slow_step", "e2e_deadline"):
        assert got["status"][1] == "expired" and counters == {"expired": 1}
    elif name == "cancel":
        assert got["status"][1] == "cancelled" and counters == {"cancelled": 1}
        assert 0 < len(got["tokens"][1]) < 6
    elif name == "shed_and_ttft":
        assert got["status"] == {0: "done", 1: "expired", 2: "rejected"}
        assert counters == {"expired": 1, "shed": 1}
    elif name == "pool_exhausted":
        assert got["status"][1] == "failed" and counters == {"watchdog_fails": 1}
    elif name == "restore_failure":
        assert got["status"][2] == "failed"
        assert counters == {"failed_fault": 1, "restore_retries": 5}
    if name != "shed_and_ttft":
        culprit = 2 if name == "restore_failure" else 1
        assert all(s == "done" for u, s in got["status"].items() if u != culprit)
