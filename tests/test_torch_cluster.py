"""Port parity of the cluster router (``repro_torch.serve.cluster``), on the
CPU, against the JAX package's ``repro.serve.cluster``.

The reference's fake-client suite (``tests/test_cluster.py``), each
scenario run through both packages' routers over identical deterministic
fake replica clients, tick clocks, fault specs and trace recorders: request
by request the chosen replica, engine uid, ``base``, emitted stream, status
and redelivery count are equal, and so are the router counters, the summed
engine counters, the replica states, the health scores, the metrics rows,
the trace events and the ``router_registry`` snapshot.  Each scenario also
keeps the reference test's own assertions, run on both packages.  Beside
them: the frozen ``ROUTER_COUNTER_KEYS`` and ``POLICIES``, ``p2c``'s picks
for a seed, ``EngineReplica`` over the port's engines (``lookup`` finds a
request wherever each engine keeps it, the advertised ``max_prompt_len``),
and one real-engine case: a slot and a paged replica of starcoder2-7b
``reduced()`` in f32 through both routers with a ``replica_crash``, equal
tokens.
"""
import itertools
from collections import Counter
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import faults as ref_faults  # noqa: E402
from repro import obs as ref_obs  # noqa: E402
from repro.obs import validate as ref_validate  # noqa: E402
from repro.serve import cluster as ref_cluster  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import lifecycle as ref_lifecycle  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import validate  # noqa: E402
from repro_torch.serve import cluster, engine, lifecycle  # noqa: E402

from _torch_helpers import load_reduced_models, one_intra_op_thread  # noqa: E402,F401

REF = SimpleNamespace(name="ref", cluster=ref_cluster, lifecycle=ref_lifecycle,
                      faults=ref_faults, obs=ref_obs, validate=ref_validate)
PORT = SimpleNamespace(name="port", cluster=cluster, lifecycle=lifecycle, faults=faults,
                       obs=obs, validate=validate)


# ---------------------------------------------------------------------------
# Deterministic fake replica client (one class a package: its statuses and
# counter views come from that package's lifecycle module)
# ---------------------------------------------------------------------------


def next_token(seq: list[int]) -> int:
    """The fake's greedy model: a pure function of the whole sequence, so a
    replay from prompt + emitted regenerates the dead replica's tokens."""
    return (seq[-1] * 31 + 7 * len(seq)) % 1009


def expected_stream(prompt: list[int], n: int, eos_id: int | None = None) -> list[int]:
    seq, out = list(prompt), []
    for _ in range(n):
        t = next_token(seq)
        seq.append(t)
        out.append(t)
        if eos_id is not None and t == eos_id:
            break
    return out


class _FakeReq:
    def __init__(self, lc, uid, prompt, max_new, eos_id):
        self.uid = uid
        self.prompt = list(prompt)
        self.max_new_tokens = max_new
        self.eos_id = eos_id
        self.prompt_left = len(prompt)
        self.generated = []
        self.status = lc.QUEUED
        self.degrade_group = 1


class FakeReplicaClient:
    """The replica-client surface over a toy engine: ``chunk`` prompt tokens
    a tick of prefill, one decode token a tick, ``lanes`` requests at a
    time, first come first served."""

    def __init__(self, lc, chunk=4, lanes=2, wedged=False, depth=None, cap="none"):
        self.lc = lc
        self._uid = itertools.count()
        self.reqs: dict = {}
        self.order: list[int] = []
        self.chunk, self.lanes, self.wedged = chunk, lanes, wedged
        self.steps = 0
        self._counters = Counter()
        self._depth = depth
        if cap != "none":  # a capability surface, as EngineReplica has
            self.max_prompt_len = cap

    def submit(self, prompt, *, max_new_tokens, eos_id=None, deadline_ttft=None,
               deadline_e2e=None) -> int:
        if not prompt:
            raise ValueError("prompt must hold at least one token")
        uid = next(self._uid)
        self.reqs[uid] = _FakeReq(self.lc, uid, prompt, max_new_tokens, eos_id)
        self.order.append(uid)
        return uid

    def cancel(self, uid) -> bool:
        r = self.reqs.get(uid)
        if r is None or self.lc.is_terminal(r.status):
            return False
        r.status = self.lc.CANCELLED
        self._counters["cancelled"] += 1
        return True

    def _live(self):
        return [self.reqs[u] for u in self.order if not self.lc.is_terminal(self.reqs[u].status)]

    def step(self):
        self.steps += 1
        done = []
        if self.wedged:
            return done
        for r in self._live()[: self.lanes]:
            if r.prompt_left > 0:
                r.prompt_left -= self.chunk
                r.status = self.lc.PREFILL
                if r.prompt_left > 0:
                    continue
            r.status = self.lc.RUNNING
            t = next_token(r.prompt + r.generated)
            r.generated.append(t)
            if len(r.generated) >= r.max_new_tokens or (r.eos_id is not None
                                                        and t == r.eos_id):
                r.status = self.lc.DONE
                done.append(r)
        return done

    def has_work(self) -> bool:
        return bool(self._live())

    def queue_depth(self) -> int:
        if self._depth is not None:
            return self._depth
        return max(0, len(self._live()) - self.lanes)

    def degrade_level(self) -> int:
        return 0

    def counters(self) -> dict:
        return self.lc.counters_view(self._counters)

    def pool_free(self):
        return None

    def lookup(self, uid):
        return self.reqs.get(uid)


class ExplodingClient(FakeReplicaClient):
    def step(self):
        raise RuntimeError("segfault, basically")


class TickClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Run:
    """One scenario's run in one package: the package's modules, a tick
    clock and a trace recorder on it, and the routers built."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.cl, self.lc = pkg.cluster, pkg.lifecycle
        self.clock = TickClock()
        self.rec = pkg.obs.TraceRecorder(clock=self.clock)
        self.routers = []

    def client(self, **kw):
        return FakeReplicaClient(self.lc, **kw)

    def faults(self, *specs):
        return self.pkg.faults.FaultInjector([self.pkg.faults.FaultSpec(**s) for s in specs])

    def router(self, clients=None, n=3, policy="round_robin", faults=None, **kw):
        clients = clients if clients is not None else [self.client() for _ in range(n)]
        r = self.cl.ClusterRouter(clients, policy=policy, faults=faults, clock=self.clock,
                                  trace=self.rec, **kw)
        self.routers.append(r)
        return r, clients

    def drive(self, router, max_ticks=500):
        for _ in range(max_ticks):
            router.tick()
            self.clock.t += 1
            if not router.has_work():
                return
        raise AssertionError("router did not drain within max_ticks")


PROMPTS = [[3, 5, 8], [11, 4, 9, 2, 6], [7, 7], [21, 13, 5, 1], [2, 9, 4, 4, 8, 1], [5],
           [17, 3], [8, 8, 8, 2], [1, 2]]


def _submit_all(router, max_new=5):
    return [router.add_request(p, max_new_tokens=max_new) for p in PROMPTS]


def _observe(run: Run) -> dict:
    """Everything a router exposes, for each router of the run, and the
    run's trace events."""
    out = []
    for router in run.routers:
        reqs = {u: (c.rid, c.ruid, c.base, list(c.emitted), c.status, c.redeliveries,
                    c.t_submit, c.t_first, c.t_done)
                for u, c in sorted(router._all.items())}
        snap = run.pkg.obs.router_registry(router).snapshot()
        assert run.pkg.validate.validate_metrics_snapshot(snap) == []
        out.append({"reqs": reqs, "counters": router.counters_snapshot(),
                    "cluster": router.cluster_counters(), "states": router.replica_states(),
                    "health": router.health(), "metrics": router.metrics(),
                    "registry": snap, "inflight": router.has_work()})
    return {"routers": out, "events": list(run.rec.events),
            "trace_problems": run.pkg.validate.validate_chrome_trace(run.rec.to_chrome())}


# ---------------------------------------------------------------------------
# The scenarios of the reference's fake-client suite
# ---------------------------------------------------------------------------


def sc_failover_at_most_once(run: Run):
    """Kill replica 1 mid-flight: every request done, every stream equal
    to the healthy run's, the redelivery counted."""
    healthy, _ = run.router()
    uids_h = _submit_all(healthy)
    run.drive(healthy)
    want = {u: list(healthy.request(u).emitted) for u in uids_h}
    for u, p in zip(uids_h, PROMPTS):
        assert want[u] == expected_stream(p, 5)
    router, _ = run.router(faults=run.faults(dict(point="replica_crash", uid=1, after=2)))
    uids = _submit_all(router)
    run.drive(router)
    snap = router.counters_snapshot()
    assert snap["replica_deaths"] == 1 and snap["redelivered"] > 0
    assert router.replica_states()[1] == run.cl.DEAD
    assert any(router.request(u).redeliveries for u in uids)
    for u in uids:
        creq = router.request(u)
        assert creq.status == run.lc.DONE and creq.emitted == want[u]


def sc_failover_regenerates_unobserved(run: Run):
    """A token the dead replica made but the router never saw is generated
    again on the survivor, never duplicated."""
    router, clients = run.router(n=2)
    uid = router.add_request([3, 5, 8], max_new_tokens=6)
    creq = router.request(uid)
    router.tick()
    router.tick()
    observed = list(creq.emitted)
    assert observed
    r = clients[0].lookup(creq.ruid)
    r.generated.append(next_token(r.prompt + r.generated))
    router.faults = run.faults(dict(point="replica_crash", uid=0))
    run.drive(router)
    assert creq.status == run.lc.DONE and creq.redeliveries == 1
    assert creq.emitted[: len(observed)] == observed
    assert creq.emitted == expected_stream([3, 5, 8], 6)


def sc_failover_budget_met(run: Run):
    """A request whose ledger already meets its budget or its EOS is
    finalized at redelivery, never replayed."""
    router, clients = run.router(n=2)
    creq = run.cl.ClusterRequest(99, [5], 2)
    creq.emitted = expected_stream([5], 2)
    ceos = run.cl.ClusterRequest(100, [5], 8, eos_id=42)
    ceos.emitted = [7, 42]
    for c in (creq, ceos):
        router._all[c.uid] = router._inflight[c.uid] = c
        router._redeliver(c, [])
        assert c.status == run.lc.DONE and c.redeliveries == 0
    assert router.counters_snapshot()["redelivered"] == 0
    assert all(not c.reqs for c in clients)


def sc_heartbeat_latency(run: Run):
    """A crashed replica is declared dead after exactly heartbeat_misses
    missed ticks."""
    router, _ = run.router(n=2, faults=run.faults(dict(point="replica_crash", uid=0)),
                           heartbeat_misses=3)
    router.add_request([3, 5, 8, 9], max_new_tokens=8)
    states = []
    for _ in range(3):
        router.tick()
        run.clock.t += 1
        states.append(router.replica_states()[0])
    assert states == [run.cl.HEALTHY, run.cl.HEALTHY, run.cl.DEAD]
    run.drive(router)


def sc_raising_step_is_crash(run: Run):
    router, _ = run.router([ExplodingClient(run.lc), run.client()])
    uid0 = router.add_request([3, 5, 8], max_new_tokens=3)
    uid1 = router.add_request([7, 7], max_new_tokens=3)
    run.drive(router)
    assert router.replica_states()[0] == run.cl.DEAD
    assert all(router.request(u).status == run.lc.DONE for u in (uid0, uid1))
    assert router.request(uid0).redeliveries == 1


def sc_all_dead(run: Run):
    router, _ = run.router(n=2, faults=run.faults(dict(point="replica_crash", uid=0),
                                                  dict(point="replica_crash", uid=1)))
    uid = router.add_request([3, 5, 8, 1, 1, 1, 1, 1], max_new_tokens=8)
    for _ in range(4):
        router.tick()
        run.clock.t += 1
    assert router.request(uid).status == run.lc.FAILED
    late = router.add_request([4, 4], max_new_tokens=2)
    assert router.request(late).status == run.lc.REJECTED
    snap = router.counters_snapshot()
    assert snap["failover_failed"] == 1 and snap["no_replica_rejects"] == 1
    assert not router.has_work()


def sc_redelivery_deadline(run: Run):
    """A request whose e2e deadline lapsed while its replica died expires
    at redelivery."""
    router, _ = run.router(n=2, faults=run.faults(dict(point="replica_crash", uid=0, after=1)))
    uid = router.add_request([9] * 20, max_new_tokens=4, deadline_e2e=2)
    ok = router.add_request([7, 7], max_new_tokens=2)
    for _ in range(8):
        router.tick()
        run.clock.t += 1
    assert router.request(uid).status == run.lc.EXPIRED
    assert router.request(ok).status == run.lc.DONE


def sc_cancel_propagates(run: Run):
    router, clients = run.router()
    uids = _submit_all(router, max_new=8)
    router.tick()
    target = router.request(uids[1])
    rid, ruid = target.rid, target.ruid
    assert router.cancel(uids[1]) is True
    assert target.status == run.lc.CANCELLED
    assert clients[rid].reqs[ruid].status == run.lc.CANCELLED
    assert router.cancel(uids[1]) is False and router.cancel(10**9) is False
    run.drive(router)
    assert router.counters_snapshot()["cancelled"] == 1


def sc_cancelled_not_redelivered(run: Run):
    router, _ = run.router(n=2, faults=run.faults(dict(point="replica_crash", uid=0, after=3)))
    uid = router.add_request([9] * 12, max_new_tokens=8)
    router.tick()
    assert router.cancel(uid) is True
    for _ in range(20):
        router.tick()
        run.clock.t += 1
    creq = router.request(uid)
    assert creq.status == run.lc.CANCELLED and creq.redeliveries == 0
    assert router.counters_snapshot()["redelivered"] == 0


def sc_drain_fences(run: Run):
    router, clients = run.router()
    uids = _submit_all(router, max_new=6)
    router.tick()
    router.drain(1)
    assert router.replica_states()[1] == run.cl.DRAINING
    before = len(clients[1].reqs)
    late = [router.add_request([4, 2], max_new_tokens=2) for _ in range(6)]
    assert len(clients[1].reqs) == before
    run.drive(router)
    assert all(router.request(u).status == run.lc.DONE for u in uids + late)
    assert router.replica_states()[1] == run.cl.DRAINED
    router.drain(1)
    assert router.counters_snapshot()["drains"] == 1
    router.resume(1)
    assert router.replica_states()[1] == run.cl.HEALTHY


def sc_drain_migrate(run: Run):
    healthy, _ = run.router()
    uids_h = _submit_all(healthy, max_new=6)
    run.drive(healthy)
    want = {u: list(healthy.request(u).emitted) for u in uids_h}
    router, _ = run.router()
    uids = _submit_all(router, max_new=6)
    router.tick()
    moved = [c for c in map(router.request, uids)
             if c.rid == 1 and not run.lc.is_terminal(c.status)]
    assert moved
    router.drain(1, migrate=True)
    snap = router.counters_snapshot()
    assert snap["migrated"] == snap["redelivered"] == len(moved)
    assert all(c.rid != 1 for c in moved)
    run.drive(router)
    assert router.replica_states()[1] == run.cl.DRAINED
    for u in uids:
        assert router.request(u).status == run.lc.DONE
        assert router.request(u).emitted == want[u]


def sc_replace_dead(run: Run):
    router, _ = run.router(n=2, faults=run.faults(dict(point="replica_crash", uid=0, after=1)))
    uids = _submit_all(router, max_new=4)
    run.drive(router)
    assert router.replica_states()[0] == run.cl.DEAD
    for call in (router.drain, router.resume):
        with pytest.raises(ValueError, match="dead"):
            call(0)
    router.replace(0, run.client())
    assert router.replica_states()[0] == run.cl.HEALTHY
    late = [router.add_request([4, 2], max_new_tokens=2) for _ in range(4)]
    run.drive(router)
    assert all(router.request(u).status == run.lc.DONE for u in uids + late)
    assert 0 in {router.request(u).rid for u in late}


def _wedge(policy, expect_skew):
    def scenario(run: Run):
        clients = [run.client(), run.client(wedged=True), run.client()]
        router, _ = run.router(clients, policy=policy)
        landed = Counter()
        for i in range(24):
            uid = router.add_request([3 + i, 5], max_new_tokens=2)
            landed[router.request(uid).rid] += 1
            router.tick()
            run.clock.t += 1
        assert (landed[1] <= 2) if expect_skew else (landed[1] >= 7), landed
        clients[1].wedged = False
        run.drive(router)
    return scenario


def sc_p2c_health_weighting(run: Run):
    clients = [run.client(), run.client()]
    router, _ = run.router(clients, policy="p2c", policy_seed=3)
    clients[0]._counters["failed_numeric"] += 10
    router.replicas[0].observe()
    landed = Counter()
    for i in range(16):
        uid = router.add_request([2 + i], max_new_tokens=1)
        landed[router.request(uid).rid] += 1
    assert landed[1] > landed[0], landed
    run.drive(router)


def sc_capability_steering(run: Run):
    router, _ = run.router([run.client(cap=4), run.client(cap=4), run.client(cap=None)])
    long_prompt = list(range(1, 13))
    long_uids = [router.add_request(long_prompt, max_new_tokens=3) for _ in range(3)]
    assert all(router.request(u).rid == 2 for u in long_uids)
    short = [router.add_request([1, 2], max_new_tokens=2) for _ in range(6)]
    assert {router.request(u).rid for u in short} == {0, 1, 2}
    run.drive(router)
    for u in long_uids:
        assert router.request(u).emitted == expected_stream(long_prompt, 3)
    assert router.counters_snapshot()["capability_rejects"] == 0


def sc_capability_reject(run: Run):
    router, _ = run.router([run.client(cap=4), run.client(cap=6)])
    uid = router.add_request(list(range(10)), max_new_tokens=2)
    assert router.request(uid).status == run.lc.REJECTED
    snap = router.counters_snapshot()
    assert snap["capability_rejects"] == 1 and snap["no_replica_rejects"] == 0
    assert not router.has_work()


def sc_failover_replay_capability(run: Run):
    router, _ = run.router([run.client(cap=64), run.client(cap=4), run.client(cap=64)],
                           faults=run.faults(dict(point="replica_crash", uid=0, after=2)))
    prompt = list(range(3, 11))
    uid = router.add_request(prompt, max_new_tokens=6)
    assert router.request(uid).rid == 0
    run.drive(router)
    creq = router.request(uid)
    assert creq.status == run.lc.DONE and creq.redeliveries == 1 and creq.rid == 2
    assert creq.emitted == expected_stream(prompt, 6)


def sc_failover_no_capable_survivor(run: Run):
    router, _ = run.router([run.client(cap=64), run.client(cap=4)],
                           faults=run.faults(dict(point="replica_crash", uid=0, after=1)))
    uid = router.add_request(list(range(8)), max_new_tokens=6)
    ok = router.add_request([1, 2], max_new_tokens=2)
    run.drive(router, max_ticks=60)
    assert router.request(uid).status == run.lc.FAILED
    assert router.counters_snapshot()["failover_failed"] == 1
    assert router.request(ok).status == run.lc.DONE


def sc_incomplete_run(run: Run):
    router, _ = run.router([run.client(wedged=True)])
    uid = router.add_request([1, 2], max_new_tokens=2)
    with pytest.raises(run.lc.IncompleteRun) as ei:
        router.run_to_completion(max_ticks=10)
    assert uid in ei.value.uids


def sc_schema_and_validation(run: Run):
    router, _ = run.router()
    snap = router.counters_snapshot()
    assert set(snap) == set(run.cl.ROUTER_COUNTER_KEYS) and not any(snap.values())
    assert set(router.cluster_counters()) == set(run.lc.COUNTER_KEYS)
    with pytest.raises(ValueError):
        router.add_request([], max_new_tokens=2)
    assert not router.has_work() and router.counters_snapshot()["routed"] == 0


def sc_metrics_rows(run: Run):
    """The router's rows are a superset of the engines' METRIC_KEYS, and
    the crequest end events equal them."""
    router, _ = run.router(n=2)
    for p in PROMPTS[:5]:
        router.add_request(p, max_new_tokens=3)
    run.drive(router)
    rows = {m["uid"]: m for m in router.metrics()}
    ends = {e["args"]["uid"]: e["args"] for e in run.rec.events
            if e["ph"] == "e" and e["name"] == "crequest"}
    assert ends == rows and set(run.lc.METRIC_KEYS) < set(rows[0])
    assert {"rid", "redeliveries"} <= set(rows[0])


def sc_p2c_crash_mix(run: Run):
    """p2c over four replicas with a crash and a drain mid-flight: the
    seeded draws and the health model decide every route."""
    router, _ = run.router(n=4, policy="p2c", policy_seed=11,
                           faults=run.faults(dict(point="replica_crash", uid=2, after=3)))
    uids = _submit_all(router, max_new=7)
    router.tick()
    router.drain(0, migrate=True)
    uids += [router.add_request(p, max_new_tokens=4) for p in PROMPTS[:4]]
    run.drive(router)
    for u in uids:
        assert router.request(u).status == run.lc.DONE


SCENARIOS = {
    "failover_at_most_once": sc_failover_at_most_once,
    "failover_regenerates_unobserved": sc_failover_regenerates_unobserved,
    "failover_budget_met": sc_failover_budget_met,
    "heartbeat_latency": sc_heartbeat_latency,
    "raising_step_is_crash": sc_raising_step_is_crash,
    "all_dead": sc_all_dead,
    "redelivery_deadline": sc_redelivery_deadline,
    "cancel_propagates": sc_cancel_propagates,
    "cancelled_not_redelivered": sc_cancelled_not_redelivered,
    "drain_fences": sc_drain_fences,
    "drain_migrate": sc_drain_migrate,
    "replace_dead": sc_replace_dead,
    "least_queue_routes_around_wedge": _wedge("least_queue", True),
    "round_robin_feeds_wedge": _wedge("round_robin", False),
    "p2c_health_weighting": sc_p2c_health_weighting,
    "capability_steering": sc_capability_steering,
    "capability_reject": sc_capability_reject,
    "failover_replay_capability": sc_failover_replay_capability,
    "failover_no_capable_survivor": sc_failover_no_capable_survivor,
    "incomplete_run": sc_incomplete_run,
    "schema_and_validation": sc_schema_and_validation,
    "metrics_rows": sc_metrics_rows,
    "p2c_crash_mix": sc_p2c_crash_mix,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name):
    """One scenario in each package: the same routes, streams, statuses,
    counters, health, metrics rows, trace events and registry snapshot."""
    outcomes = {}
    for pkg in (REF, PORT):
        run = Run(pkg)
        SCENARIOS[name](run)
        outcomes[pkg.name] = _observe(run)
    assert outcomes["port"] == outcomes["ref"]
    # The budget-met case plants requests without a crequest begin event.
    assert bool(outcomes["port"]["trace_problems"]) == (name == "failover_budget_met")


# ---------------------------------------------------------------------------
# The frozen surfaces and the policies
# ---------------------------------------------------------------------------


def test_frozen_keys_states_and_policies_match_reference():
    assert cluster.ROUTER_COUNTER_KEYS == ref_cluster.ROUTER_COUNTER_KEYS
    for name in ("HEALTHY", "DRAINING", "DRAINED", "DEAD"):
        assert getattr(cluster, name) == getattr(ref_cluster, name)
    assert list(cluster.POLICIES) == list(ref_cluster.POLICIES)
    assert cluster.ReplicaHandle.FAILURE_KEYS == ref_cluster.ReplicaHandle.FAILURE_KEYS
    for name in cluster.POLICIES:
        assert cluster.make_policy(name).name == ref_cluster.make_policy(name).name == name
    p = cluster.LeastQueuePolicy()
    assert cluster.make_policy(p) is p
    with pytest.raises(ValueError, match="unknown policy"):
        cluster.make_policy("dartboard")


def _handles(pkg, depths, sick=()):
    hs = [pkg.cluster.ReplicaHandle(rid, FakeReplicaClient(pkg.lifecycle, depth=d))
          for rid, d in enumerate(depths)]
    for rid in sick:
        hs[rid]._fail_ewma = 50.0
    return hs


@pytest.mark.parametrize("seed", [0, 3, 7, 123])
@pytest.mark.parametrize("n", [2, 3, 5])
def test_p2c_draws_match_reference(seed, n):
    """The same seed picks the same pair, so both packages route alike;
    a sick replica never wins a draw it shares."""
    picks = {}
    for pkg in (REF, PORT):
        hs = _handles(pkg, [i % 3 for i in range(n)], sick=(1,))
        pol = pkg.cluster.PowerOfTwoPolicy(seed=seed)
        picks[pkg.name] = [pol.choose(hs).rid for _ in range(60)]
    assert picks["port"] == picks["ref"]
    assert 1 not in picks["port"]


def test_policies_and_health_match_reference():
    """Round robin's cycle, least-queue's pick and tie-break, and each
    health signal, in both packages."""
    for pkg in (REF, PORT):
        rr = pkg.cluster.RoundRobinPolicy()
        hs = _handles(pkg, [0, 0, 0])
        assert [rr.choose(hs).rid for _ in range(6)] == [0, 1, 2, 0, 1, 2]
        assert set(rr.choose(hs[1:]).rid for _ in range(4)) == {1, 2}
        assert pkg.cluster.LeastQueuePolicy().choose(_handles(pkg, [5, 2, 9])).rid == 1
        assert pkg.cluster.LeastQueuePolicy().choose(_handles(pkg, [2, 2, 2])).rid == 0
    scores = {}
    for pkg in (REF, PORT):
        h = _handles(pkg, [0])[0]
        seq = [h.health_score()]
        h.client._depth = 8
        seq.append(h.health_score())
        h.client._depth = 0
        h.missed = 1
        seq.append(h.health_score())
        h.missed = 0
        h.client._counters["failed_numeric"] += 4
        h.observe()
        seq.append(h.health_score())
        for _ in range(8):
            h.observe()
        seq.append(h.health_score())
        h.crashed = True
        seq.append(h.health_score())
        scores[pkg.name] = seq
    assert scores["port"] == scores["ref"]
    s = scores["port"]
    assert s[0] == 1.0 and s[1] < 1.0 and 0.0 < s[2] < 1.0 and s[3] < 0.5 < 0.9 < s[4]
    assert s[5] == 0.0


# ---------------------------------------------------------------------------
# EngineReplica over the port's engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    rcfg, rparams, tcfg, tparams = load_reduced_models("starcoder2-7b", draw_qkv_bias=False)
    rcfg, tcfg = (c.replace(attention=c.attention.with_impl("reference")) for c in (rcfg, tcfg))
    return rcfg, rparams, tcfg, tparams


SLOT = dict(max_slots=2, max_len=64)
PAGED = dict(max_batch=2, max_len=64, block_size=8, prefill_chunk=8)


def _engines(models, pkg, clock):
    rcfg, rparams, tcfg, tparams = models
    if pkg is REF:
        return [ref_engine.ServeEngine(rcfg, rparams, clock=clock, **SLOT),
                ref_engine.PagedServeEngine(rcfg, rparams, cache_dtype=jnp.float32, clock=clock,
                                            **PAGED)]
    return [engine.ServeEngine(tcfg, tparams, device="cpu", clock=clock, **SLOT),
            engine.PagedServeEngine(tcfg, tparams, cache_dtype=torch.float32, device="cpu",
                                    clock=clock, **PAGED)]


def test_engine_replica_lookup_finds_requests_where_each_engine_keeps_them(models):
    """``EngineReplica.lookup`` reads the slot engine's ``pending`` /
    ``active`` / ``finished`` and the paged engine's ``scheduler.waiting`` /
    ``scheduler.running`` / ``finished``: a request is found queued,
    running and finished on both engines, and an unknown uid is None.
    Also the advertised capability and the pool's free blocks."""
    slot, paged = _engines(models, PORT, TickClock())
    for eng in (slot, paged):
        rep = cluster.EngineReplica(eng)
        uids = [rep.submit(list(range(3, 9)), max_new_tokens=3) for _ in range(3)]
        assert all(rep.lookup(u).uid == u for u in uids)  # queued
        rep.step()
        running = [u for u in uids if rep.lookup(u).status in (lifecycle.RUNNING,
                                                                lifecycle.PREFILL)]
        assert running and all(rep.lookup(u).uid == u for u in uids)
        while rep.has_work():
            rep.step()
        assert all(rep.lookup(u).status == lifecycle.DONE for u in uids)
        assert all(isinstance(t, int) for u in uids for t in rep.lookup(u).generated)
        assert rep.lookup(10**6) is None
        assert rep.counters() == eng.counters_snapshot()
        assert rep.queue_depth() == 0 and rep.degrade_level() == 0
    assert cluster.EngineReplica(slot).max_prompt_len() == 64
    assert cluster.EngineReplica(paged).max_prompt_len() == min(64, paged.capacity_tokens - 1)
    assert cluster.EngineReplica(slot).pool_free() is None
    assert cluster.EngineReplica(paged).pool_free() == paged.cache.pool.num_free
    assert cluster.ClusterRouter._capacity(
        cluster.ReplicaHandle(0, FakeReplicaClient(lifecycle))) is None


REAL_PROMPTS = [list(range(3, 11)), list(range(5, 17)), list(range(2, 8)),
                list(range(20, 29))]


def _real_cluster(models, pkg, specs):
    clock = TickClock()
    rec = pkg.obs.TraceRecorder(clock=clock)
    engines = _engines(models, pkg, clock)
    inj = pkg.faults.FaultInjector([pkg.faults.FaultSpec(**s) for s in specs])
    router = pkg.cluster.ClusterRouter(engines, policy="round_robin", faults=inj, clock=clock,
                                       trace=rec)
    free0 = engines[1].cache.pool.num_free
    uids = [router.add_request(p, max_new_tokens=5) for p in REAL_PROMPTS]
    for _ in range(200):
        router.tick()
        clock.t += 1
        if not router.has_work():
            break
    assert not router.has_work()
    reqs = {u: (router.request(u).rid, router.request(u).base, router.request(u).emitted,
                router.request(u).status, router.request(u).redeliveries) for u in uids}
    return {"reqs": reqs, "counters": router.counters_snapshot(),
            "states": router.replica_states(), "metrics": router.metrics(),
            "events": [(e["name"], e["ph"], e["t"], e["args"]) for e in rec.events
                       if e["name"] in ("crequest", "replica_death", "redeliver",
                                        "first_token", "failover_failed")],
            "paged_free": (free0, engines[1].cache.pool.num_free)}


@pytest.mark.parametrize("crash", [None, 0, 1], ids=["healthy", "slot_dies", "paged_dies"])
def test_real_engines_through_both_routers(models, crash):
    """A slot and a paged replica of starcoder2-7b ``reduced()`` (f32,
    ``impl="reference"``, temperature 0) behind each package's router, with
    replica ``crash`` killed after three ticks: the same routes, statuses,
    ledgers, counters, metrics and trace events, and every request done
    with its full budget; the paged pool is back at its free count when it
    survives."""
    specs = [] if crash is None else [dict(point="replica_crash", uid=crash, after=3)]
    want = _real_cluster(models, REF, specs)
    got = _real_cluster(models, PORT, specs)
    assert got == want
    assert all(s == lifecycle.DONE and len(e) == 5 for _, _, e, s, _ in got["reqs"].values())
    if crash is None:
        assert got["counters"]["replica_deaths"] == 0
    else:
        assert got["counters"]["replica_deaths"] == 1 and got["counters"]["redelivered"] > 0
    if crash != 1:
        assert got["paged_free"][0] == got["paged_free"][1]


@pytest.mark.parametrize("how", ["dead", "drained"])
def test_router_frees_a_replaced_replica_without_the_cycle_collector(how, monkeypatch):
    """A replica that died (``replica_crash``) or was drained with
    ``migrate=True`` mid-flight, then ``replace``d by a fresh engine: with
    the collector off, the old engine, its cache and its captured steps
    (through a fake device, as on the card) are freed at the replace, so on
    the card its memory returns before the next phase; the survivors'
    requests all finish."""
    import gc
    import weakref

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import graphs

    def record(self, call):
        return (self.fn, call, self.fn(*call)), self.fn(*call)

    def replay(graph):
        fn, call, outputs = graph
        for dst, src in zip(graphs._tensors(outputs, []), graphs._tensors(fn(*call), [])):
            dst.copy_(src)

    monkeypatch.setattr(graphs.StepGraph, "_uses_graphs", staticmethod(lambda args: True))
    monkeypatch.setattr(graphs.StepGraph, "_warm_up", lambda self, args: self.fn(*args))
    monkeypatch.setattr(graphs.StepGraph, "_record", record)
    monkeypatch.setattr(graphs.StepGraph, "_replay", staticmethod(replay))
    cfg = get_config("starcoder2-7b", reduced=True)
    gc.collect()
    gc.disable()
    try:
        params = lm.init_params(cfg, device="cpu")

        def paged():
            return engine.PagedServeEngine(cfg, params, max_batch=2, max_len=64, block_size=16,
                                           prefill_chunk=8, device="cpu")

        engines = [engine.ServeEngine(cfg, params, max_slots=2, max_len=64, device="cpu"),
                   paged()]
        specs = [faults.FaultSpec("replica_crash", uid=1, after=4)] if how == "dead" else []
        router = cluster.ClusterRouter(engines, policy="round_robin",
                                       faults=faults.FaultInjector(specs), clock=TickClock())
        uids = [router.add_request(p, max_new_tokens=6)
                for p in ([1, 2, 3], list(range(1, 20)), [7] * 9, [4, 5])]
        for _ in range(5):
            router.tick()
        if how == "drained":
            router.drain(1, migrate=True)
        router.run_to_completion(max_ticks=200)
        assert router.replica_states()[1] == (cluster.DEAD if how == "dead"
                                              else cluster.DRAINED)
        assert all(router.request(u).status == lifecycle.DONE for u in uids)
        old = engines[1]
        assert old._decode._captured  # the old replica's steps were captured
        held = [weakref.ref(t) for t in graphs._tensors(old.cache.pools, [])]
        gone = weakref.ref(old)
        del engines, old
        assert gone() is not None  # the router's handle still holds it
        router.replace(1, paged())
        assert gone() is None
        assert all(ref() is None for ref in held)
        late = router.add_request([9, 9, 9], max_new_tokens=3)
        router.add_request([8, 8], max_new_tokens=3)
        router.run_to_completion(max_ticks=200)
        assert router.request(late).status == lifecycle.DONE
    finally:
        gc.enable()
