"""Multi-replica serving: a health-aware router over N engine replicas (the
port's copy of ``repro.serve.cluster``).

One engine, slot or paged, is one failure domain: a NaN storm, a wedged
block pool or a lost process takes down every request it holds.  A
:class:`ClusterRouter` balances requests over N replicas, keeps serving
through the loss of any one of them, and turns a replica's death into a
recoverable event: the dead replica's in-flight requests are redelivered
to survivors, and no client sees a token twice.

  * **ReplicaHandle** wraps one engine behind the small replica-client
    surface (:class:`EngineReplica` adapts both engines; tests fake it)
    and keeps its health.  Health reads only what the engines expose:
    ``counters_snapshot()`` (failure-counter deltas, EWMA-smoothed),
    ``queue_depth()`` and ``degrade_level()``, plus a missed-tick
    heartbeat (a replica beats by finishing its ``step()`` inside the
    router's tick; a crashed one stops beating).

  * **Routing policies** share one interface (:meth:`RoutingPolicy.choose`
    over the routable handles): ``round_robin``, ``least_queue`` and
    ``p2c`` (two replicas drawn at random, the healthier one taken).
    Dead, crashed and draining replicas are never candidates, and neither
    is a replica whose advertised ``max_prompt_len`` cannot hold the
    prompt (failover replay applies the same filter to prompt + emitted
    tokens); with routable replicas but none capable, the request is
    rejected (``capability_rejects``).

  * **Failover, each token at most once.**  The router owns the client's
    token stream: each request keeps an ``emitted`` ledger, extended only
    by tokens observed on the owning replica (``base`` is the ledger's
    length when the request reached that replica, so engine-local
    ``generated`` indexes never alias).  A replica that misses
    ``heartbeat_misses`` ticks in a row is declared dead, and each of its
    live requests is replayed as an extended prefill on a survivor: the
    prompt plus the emitted tokens, the remaining budget and e2e deadline.
    Tokens the dead replica made but the router never saw are generated
    again; tokens in the ledger ride the replay prompt and are never
    emitted again.

  * **Draining** (``drain(rid)``) quiesces a replica for a rolling
    restart: admission stops at once, in-flight work finishes in place or,
    with ``migrate=True``, is cancelled and redelivered through the replay
    path, and the handle parks as ``drained``; ``replace(rid, engine)``
    then swaps in a fresh engine and returns it to rotation.

``tick()`` steps every live replica, harvests tokens, detects deaths and
completes drains, against an injectable clock, so the tier runs on a tick
clock over fake clients in tests.
"""
from __future__ import annotations

import itertools
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs.clock import resolve_clock
from repro_torch.obs.trace import get_recorder
from repro_torch.serve import lifecycle
from repro_torch.serve.faults import NULL_INJECTOR
from repro_torch.serve.lifecycle import IncompleteRun

# -- replica states ---------------------------------------------------------
HEALTHY = "healthy"  # in rotation
DRAINING = "draining"  # admission fenced, in-flight finishing/migrating
DRAINED = "drained"  # quiesced: no work, awaiting replace()/resume()
DEAD = "dead"  # heartbeat lost; in-flight redelivered

#: Router-level counters (replica-level ones stay on the engines and are
#: aggregated by :meth:`ClusterRouter.cluster_counters`).  Frozen like
#: ``lifecycle.COUNTER_KEYS`` — zero-filled in every snapshot.
ROUTER_COUNTER_KEYS = (
    "routed",  # requests delivered to a replica (incl. redeliveries)
    "no_replica_rejects",  # submissions with zero routable replicas
    "capability_rejects",  # no routable replica can hold the prompt
    "replica_deaths",  # heartbeat-detected replica losses
    "redelivered",  # in-flight requests replayed onto a survivor
    "failover_failed",  # redelivery impossible (no survivor / too long)
    "cancelled",  # router-level cancel(uid)
    "drains",  # drain() calls accepted
    "migrated",  # in-flight requests moved off a draining replica
)


# ---------------------------------------------------------------------------
# Replica client surface
# ---------------------------------------------------------------------------


class EngineReplica:
    """The router's replica-client surface over a real engine (slot
    ``ServeEngine`` or ``PagedServeEngine``).  Everything the router needs
    is already public engine API; ``lookup`` additionally resolves an
    engine-local uid to its live ``Request`` so the router can harvest
    tokens as they are generated (a real RPC tier would stream them)."""

    def __init__(self, engine):
        self.engine = engine

    def submit(self, prompt, *, max_new_tokens, eos_id=None,
               deadline_ttft=None, deadline_e2e=None) -> int:
        return self.engine.add_request(
            prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
            deadline_ttft=deadline_ttft, deadline_e2e=deadline_e2e,
        )

    def cancel(self, uid: int) -> bool:
        return self.engine.cancel(uid)

    def step(self):
        return self.engine.step()

    def has_work(self) -> bool:
        return self.engine.has_work()

    def queue_depth(self) -> int:
        return self.engine.queue_depth()

    def degrade_level(self) -> int:
        return self.engine.degrade_level()

    def max_prompt_len(self) -> int | None:
        """Longest prompt this replica admits — the *capability* the
        router steers on: a mesh-backed long-context replica advertises a
        large limit, a small replica a small one.  None → unknown
        (treated as unlimited, the pre-capability behaviour)."""
        return getattr(self.engine, "max_prompt_len", None)

    def counters(self) -> dict:
        return self.engine.counters_snapshot()

    def pool_free(self) -> int | None:
        """Free KV blocks (paged engines; None for slot engines)."""
        cache = getattr(self.engine, "cache", None)
        pool = getattr(cache, "pool", None)
        return None if pool is None else pool.num_free

    def lookup(self, uid: int):
        """Resolve an engine-local uid to its Request, wherever it lives
        (waiting / running / finished) — None for unknown uids."""
        eng = self.engine
        sched = getattr(eng, "scheduler", None)
        if sched is not None:  # paged engine
            for e in sched.waiting:
                if e.uid == uid:
                    return e.req
            for e in sched.running.values():
                if e.uid == uid:
                    return e.req
        else:  # slot engine
            for r in eng.pending:
                if r.uid == uid:
                    return r
            for r in eng.active.values():
                if r.uid == uid:
                    return r
        for r in eng.finished:
            if r.uid == uid:
                return r
        return None


def _as_client(obj):
    """Engines are wrapped in :class:`EngineReplica`; anything already
    speaking the client surface (fakes, remote proxies) passes through."""
    return obj if hasattr(obj, "submit") else EngineReplica(obj)


# ---------------------------------------------------------------------------
# Replica handle + health model
# ---------------------------------------------------------------------------


class ReplicaHandle:
    """One replica: its client, lifecycle state, heartbeat, and health.

    The health score multiplies independent [0, 1] penalties from the
    replica's own robustness signals — no new instrumentation:

      * heartbeat: ``1 − missed/heartbeat_misses`` (a silent replica
        decays linearly to 0 by the tick it would be declared dead);
      * backlog: ``1/(1 + queue_depth/4)`` (deep queues mean long TTFT);
      * degradation: ``1/(1 + level)`` (a dialed-down replica is shedding
        accuracy to survive — send new work elsewhere first);
      * failures: ``1/(1 + ewma)`` over per-tick deltas of the failure
        counters (``failed_*``, ``watchdog_fails``, ``expired``), halved
        each tick — a NaN storm sinks the score fast, a single old
        failure is forgiven.
    """

    FAILURE_KEYS = ("failed_numeric", "failed_fault", "watchdog_fails",
                    "expired")

    def __init__(self, rid: int, client, *, heartbeat_misses: int = 2):
        self.rid = rid
        self.client = client
        self.heartbeat_misses = heartbeat_misses
        self.state = HEALTHY
        self.crashed = False  # process gone; stops beating
        self.missed = 0  # consecutive missed heartbeats
        self.owned: dict[int, "ClusterRequest"] = {}  # engine uid → request
        self._fail_ewma = 0.0
        self._last_bad = 0

    @property
    def routable(self) -> bool:
        return self.state == HEALTHY and not self.crashed

    def observe(self) -> None:
        """Fold this tick's failure-counter delta into the EWMA (called
        once per successful heartbeat)."""
        snap = self.client.counters()
        bad = sum(int(snap.get(k, 0)) for k in self.FAILURE_KEYS)
        delta = max(bad - self._last_bad, 0)
        self._last_bad = bad
        self._fail_ewma = 0.5 * self._fail_ewma + delta

    def health_score(self) -> float:
        if self.state == DEAD or self.crashed:
            return 0.0
        s = max(0.0, 1.0 - self.missed / max(self.heartbeat_misses, 1))
        s *= 1.0 / (1.0 + self.client.queue_depth() / 4.0)
        s *= 1.0 / (1.0 + self.client.degrade_level())
        s *= 1.0 / (1.0 + self._fail_ewma)
        return s


# ---------------------------------------------------------------------------
# Routing policies
# ---------------------------------------------------------------------------


class RoutingPolicy:
    """Pick one handle from the routable candidates (non-empty list; the
    router guards emptiness).  Implementations must be deterministic for
    a given seed — the chaos suite and benchmarks rely on it."""

    name = "base"

    def choose(self, candidates: list[ReplicaHandle]) -> ReplicaHandle:
        raise NotImplementedError


class RoundRobinPolicy(RoutingPolicy):
    """Cycle over the routable set in rid order — health-blind baseline."""

    name = "round_robin"

    def __init__(self):
        self._i = 0

    def choose(self, candidates):
        cands = sorted(candidates, key=lambda h: h.rid)
        h = cands[self._i % len(cands)]
        self._i += 1
        return h


class LeastQueuePolicy(RoutingPolicy):
    """Route to the shallowest waiting queue (join-shortest-queue); rid
    breaks ties so the choice is deterministic."""

    name = "least_queue"

    def choose(self, candidates):
        return min(candidates, key=lambda h: (h.client.queue_depth(), h.rid))


class PowerOfTwoPolicy(RoutingPolicy):
    """Power-of-two-choices weighted by health: sample two distinct
    replicas (seeded rng) and take the higher health score — O(1) per
    request with near-best-of-N tail behaviour, and the health weighting
    folds in every robustness signal, not just queue depth."""

    name = "p2c"

    def __init__(self, seed: int = 0):
        self.rng = np.random.RandomState(seed)

    def choose(self, candidates):
        if len(candidates) == 1:
            return candidates[0]
        cands = sorted(candidates, key=lambda h: h.rid)
        i, j = self.rng.choice(len(cands), size=2, replace=False)
        a, b = cands[int(i)], cands[int(j)]
        # Higher health wins; ties → shallower queue, then lower rid.
        ka = (a.health_score(), -a.client.queue_depth(), -a.rid)
        kb = (b.health_score(), -b.client.queue_depth(), -b.rid)
        return a if ka >= kb else b


POLICIES = {
    "round_robin": RoundRobinPolicy,
    "least_queue": LeastQueuePolicy,
    "p2c": PowerOfTwoPolicy,
}


def make_policy(policy, seed: int = 0) -> RoutingPolicy:
    if isinstance(policy, RoutingPolicy):
        return policy
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; one of {sorted(POLICIES)}")
    cls = POLICIES[policy]
    return cls(seed) if cls is PowerOfTwoPolicy else cls()


# ---------------------------------------------------------------------------
# Router-side request record
# ---------------------------------------------------------------------------


@dataclass
class ClusterRequest:
    """The router-owned view of one client request.  ``emitted`` is the
    at-most-once ledger: the only tokens a client ever sees, appended
    strictly in order as the router observes them from the owning replica.
    ``base`` is the ledger length when the request was (re)delivered to
    the current replica — engine-local ``generated[i]`` corresponds to
    ledger position ``base + i``, so replays never re-emit."""

    uid: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    deadline_ttft: float | None = None
    deadline_e2e: float | None = None
    emitted: list[int] = field(default_factory=list)
    status: str = lifecycle.QUEUED
    rid: int | None = None  # owning replica
    ruid: int | None = None  # engine-local uid on that replica
    base: int = 0  # ledger length at delivery to the current replica
    redeliveries: int = 0
    degrade_group: int = 1
    t_submit: float = 0.0
    t_first: float | None = None
    t_done: float | None = None

    @property
    def done(self) -> bool:
        return self.status == lifecycle.DONE


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------


class ClusterRouter:
    """Load-balance requests over N engine replicas and keep the cluster
    serving through replica failure (module docstring for the design).

    ``replicas``: engines (slot or paged — each with its own KV pool) or
    objects already speaking the replica-client surface.  ``policy``: a
    name from :data:`POLICIES` or a :class:`RoutingPolicy` instance.
    ``faults``: a :class:`~repro_torch.serve.faults.FaultInjector` consulted at
    the ``replica_crash`` point once per tick per replica (uid = rid).
    ``clock``: injectable — deadlines passed to engines are converted to
    remain relative to *their* submission, so the router and engines may
    share one tick clock in tests."""

    def __init__(self, replicas, *, policy="p2c", policy_seed: int = 0,
                 heartbeat_misses: int = 2, clock=None, faults=None,
                 trace=None):
        if not replicas:
            raise ValueError("a cluster needs at least one replica")
        self.replicas = [
            ReplicaHandle(rid, _as_client(r),
                          heartbeat_misses=heartbeat_misses)
            for rid, r in enumerate(replicas)
        ]
        self._by_rid = {h.rid: h for h in self.replicas}
        self.policy = make_policy(policy, policy_seed)
        self.heartbeat_misses = heartbeat_misses
        self.clock = resolve_clock(clock)
        self.faults = faults or NULL_INJECTOR
        self.trace = trace if trace is not None else get_recorder()
        self._tns = self.trace.ns()  # async-span id namespace (obs.trace)
        self.counters: Counter = Counter()
        self.finished: list[ClusterRequest] = []
        self._uid = itertools.count()
        self._inflight: dict[int, ClusterRequest] = {}
        self._all: dict[int, ClusterRequest] = {}
        self._tick = 0

    # -- public API (mirrors the engines) --------------------------------

    def _now(self) -> float:
        return self.clock()

    def add_request(self, prompt: list[int], *, max_new_tokens: int = 32,
                    eos_id: int | None = None, deadline_ttft=None,
                    deadline_e2e=None) -> int:
        """Route a new request to a replica chosen by the policy.  With no
        routable replica the request is rejected immediately (terminal
        status, ``no_replica_rejects``) — the cluster analog of engine
        load shedding.  Invalid requests (empty prompt, overlong, bad
        budget) raise ``ValueError`` exactly like ``engine.add_request``.
        """
        creq = ClusterRequest(
            next(self._uid), list(prompt), max_new_tokens, eos_id,
            deadline_ttft=deadline_ttft, deadline_e2e=deadline_e2e,
            t_submit=self._now(),
        )
        self._all[creq.uid] = creq
        self.trace.begin("crequest", f"{self._tns}:{creq.uid}", uid=creq.uid,
                         prompt_len=len(creq.prompt),
                         max_new=max_new_tokens)
        cands = self._routable()
        if not cands:
            self.counters["no_replica_rejects"] += 1
            self._finalize(creq, lifecycle.REJECTED, [])
            return creq.uid
        # Capability steering: only replicas whose advertised
        # max_prompt_len admits this prompt are candidates — long prompts
        # go to mesh-backed long-context replicas, short prompts keep the
        # full routable set (and the policy's usual balancing).
        capable = self._capable(cands, len(creq.prompt))
        if not capable:
            self.counters["capability_rejects"] += 1
            self._finalize(creq, lifecycle.REJECTED, [])
            return creq.uid
        try:
            self._deliver(creq, self.policy.choose(capable))
        except ValueError:
            # Engine-side validation (empty prompt, overlong, bad budget):
            # the caller's bug — same contract as engine.add_request.
            del self._all[creq.uid]
            raise
        self._inflight[creq.uid] = creq
        return creq.uid

    def cancel(self, uid: int) -> bool:
        """Cancel wherever the request lives: propagated to the owning
        replica (which frees its KV in the same call) and finalized at
        the router.  False — never a raise — for unknown or already-
        terminal uids."""
        creq = self._all.get(uid)
        if creq is None or lifecycle.is_terminal(creq.status):
            return False
        h = self._by_rid.get(creq.rid) if creq.rid is not None else None
        if h is not None:
            h.owned.pop(creq.ruid, None)
            if not h.crashed and h.state != DEAD:
                try:
                    h.client.cancel(creq.ruid)
                except Exception:  # a dying replica must not block cancel
                    pass
        self.counters["cancelled"] += 1
        self._finalize(creq, lifecycle.CANCELLED, [])
        return True

    def tick(self) -> list[ClusterRequest]:
        """One cluster tick: fire crash faults, step every live replica
        (a completed step is that replica's heartbeat), harvest emitted
        tokens and terminal statuses, declare heartbeat-lost replicas
        dead (redelivering their in-flight), and complete drains.
        Returns the requests that reached a terminal status this tick."""
        self._tick += 1
        finished: list[ClusterRequest] = []
        for h in self.replicas:
            if (h.state != DEAD and not h.crashed
                    and self.faults.fires("replica_crash", uid=h.rid)
                    is not None):
                h.crashed = True
        for h in self.replicas:
            if h.state == DEAD:
                continue
            if h.crashed:
                h.missed += 1
                continue
            try:
                h.client.step()
            except Exception:
                # A raising step is indistinguishable from a dying
                # process: stop trusting the replica, let the heartbeat
                # detector take it from here.
                h.crashed = True
                h.missed += 1
                continue
            h.missed = 0
            self._harvest(h, finished)
            h.observe()
        for h in self.replicas:
            if (h.state != DEAD and h.missed >= self.heartbeat_misses):
                self._mark_dead(h, finished)
        for h in self.replicas:
            if h.state == DRAINING and not h.owned and not self._busy(h):
                h.state = DRAINED
        return finished

    def run_to_completion(self, max_ticks: int = 10_000) \
            -> list[ClusterRequest]:
        for _ in range(max_ticks):
            self.tick()
            if not self._inflight:
                return self.finished
        raise IncompleteRun(sorted(self._inflight), max_ticks)

    def has_work(self) -> bool:
        return bool(self._inflight)

    def request(self, uid: int) -> ClusterRequest | None:
        return self._all.get(uid)

    # -- draining / rolling restart --------------------------------------

    def drain(self, rid: int, *, migrate: bool = False) -> None:
        """Quiesce replica ``rid`` for rolling restart: admission is
        fenced now (the policy stops seeing it); in-flight work finishes
        in place, or with ``migrate=True`` is cancelled on the source and
        redelivered to survivors through the failover replay path.  Once
        idle the handle parks in state ``drained``."""
        h = self._by_rid[rid]
        if h.state == DEAD or h.crashed:
            raise ValueError(f"replica {rid} is dead; replace() it instead")
        if h.state in (DRAINING, DRAINED):
            return
        h.state = DRAINING
        self.counters["drains"] += 1
        self.trace.instant("drain", rid=rid, migrate=migrate)
        if migrate:
            orphans = sorted(h.owned.values(), key=lambda c: c.uid)
            h.owned = {}
            for creq in orphans:
                try:
                    h.client.cancel(creq.ruid)
                except Exception:
                    pass
                self.counters["migrated"] += 1
                self.trace.instant("migrate", uid=creq.uid, src_rid=rid)
                self._redeliver(creq, [])

    def resume(self, rid: int) -> None:
        """Return a draining/drained replica to rotation (rolling restart
        aborted or completed in place)."""
        h = self._by_rid[rid]
        if h.state == DEAD or h.crashed:
            raise ValueError(f"replica {rid} is dead; replace() it instead")
        h.state = HEALTHY

    def replace(self, rid: int, engine) -> None:
        """Swap a dead or drained replica for a fresh engine and return
        the slot to rotation — the completion of a rolling restart.  The
        old handle must hold no in-flight work (death redelivers it;
        drain finishes or migrates it)."""
        h = self._by_rid[rid]
        if h.owned:
            raise ValueError(
                f"replica {rid} still owns {sorted(h.owned)}; drain it first"
            )
        h.client = _as_client(engine)
        h.state = HEALTHY
        h.crashed = False
        h.missed = 0
        h._fail_ewma = 0.0
        h._last_bad = 0

    # -- observability ----------------------------------------------------

    def counters_snapshot(self) -> dict:
        """Router counters, frozen to :data:`ROUTER_COUNTER_KEYS`."""
        return {k: int(self.counters.get(k, 0))
                for k in ROUTER_COUNTER_KEYS}

    def replica_counters(self) -> dict[int, dict]:
        """Latest engine-level counter snapshot per live replica (dead
        replicas report their last observable state as zeros-safe)."""
        out = {}
        for h in self.replicas:
            if h.crashed or h.state == DEAD:
                continue
            out[h.rid] = h.client.counters()
        return out

    def cluster_counters(self) -> dict:
        """Sum of live replicas' engine counters (schema
        ``lifecycle.COUNTER_KEYS``)."""
        total = Counter()
        for snap in self.replica_counters().values():
            total.update(snap)
        return lifecycle.counters_view(total)

    def replica_states(self) -> dict[int, str]:
        return {h.rid: h.state for h in self.replicas}

    def health(self) -> dict[int, float]:
        return {h.rid: h.health_score() for h in self.replicas}

    def metrics(self) -> list[dict]:
        """Per-request rows carrying the engines' frozen METRIC_KEYS
        schema plus the router-level columns (owning replica,
        redelivery count)."""
        return [self._metric_row(creq) for creq in self.finished]

    @staticmethod
    def _metric_row(creq: ClusterRequest) -> dict:
        """One function feeds both metrics() and the trace's async
        end-event args — the exported trace is bit-consistent with
        metrics() by construction."""
        n = len(creq.emitted)
        ttft = (None if creq.t_first is None
                else creq.t_first - creq.t_submit)
        tpot = None
        if creq.t_done is not None and creq.t_first is not None:
            tpot = ((creq.t_done - creq.t_first) / (n - 1)
                    if n > 1 else 0.0)
        return {
            "uid": creq.uid,
            "ttft_s": ttft,
            "tpot_s": tpot,
            "n_generated": n,
            "n_preemptions": 0,  # engine-level; see replica metrics
            "status": creq.status,
            "degrade_group": creq.degrade_group,
            "rid": creq.rid,
            "redeliveries": creq.redeliveries,
        }

    # -- internals --------------------------------------------------------

    def _routable(self) -> list[ReplicaHandle]:
        return [h for h in self.replicas if h.routable]

    @staticmethod
    def _capacity(h: ReplicaHandle) -> int | None:
        cap = getattr(h.client, "max_prompt_len", None)
        if cap is None:
            return None
        cap = cap() if callable(cap) else cap
        return None if cap is None else int(cap)

    @staticmethod
    def _capable(cands: list[ReplicaHandle],
                 n_prompt: int) -> list[ReplicaHandle]:
        """Candidates able to admit an ``n_prompt``-token prompt: a
        replica advertising ``max_prompt_len`` < n_prompt would
        deterministically ValueError the submission, so routing there
        wastes the attempt.  Unknown capability (fakes / proxies without
        the surface) is treated as unlimited — the pre-capability
        behaviour."""
        out = []
        for h in cands:
            cap = ClusterRouter._capacity(h)
            if cap is None or n_prompt <= cap:
                out.append(h)
        return out

    def _busy(self, h: ReplicaHandle) -> bool:
        try:
            return h.client.has_work()
        except Exception:
            return False

    def _deliver(self, creq: ClusterRequest, h: ReplicaHandle) -> None:
        """Submit to a chosen replica (ValueError propagates: an invalid
        request is the caller's bug, same contract as the engines)."""
        d_ttft, d_e2e = creq.deadline_ttft, creq.deadline_e2e
        if creq.redeliveries or creq.emitted:
            # Redelivery: deadlines are absolute from the ORIGINAL
            # submission; re-base them for the new engine's clock.
            elapsed = self._now() - creq.t_submit
            d_e2e = None if d_e2e is None else d_e2e - elapsed
            # TTFT already satisfied once a token was emitted.
            d_ttft = None if creq.emitted else (
                None if d_ttft is None else d_ttft - elapsed)
        ruid = h.client.submit(
            creq.prompt + creq.emitted,
            max_new_tokens=creq.max_new_tokens - len(creq.emitted),
            eos_id=creq.eos_id, deadline_ttft=d_ttft, deadline_e2e=d_e2e,
        )
        creq.rid, creq.ruid, creq.base = h.rid, ruid, len(creq.emitted)
        h.owned[ruid] = creq
        self.counters["routed"] += 1

    def _harvest(self, h: ReplicaHandle, finished: list) -> None:
        """Pull newly generated tokens into each owned request's ledger
        and finalize the ones the replica drove to a terminal status."""
        for ruid, creq in list(h.owned.items()):
            r = h.client.lookup(ruid)
            if r is None:
                continue
            gen = list(r.generated)
            new = gen[len(creq.emitted) - creq.base:]
            if new:
                # At-most-once: never emit past the client's budget even
                # if an engine somehow overshoots.
                new = new[:creq.max_new_tokens - len(creq.emitted)]
            if new:
                if not creq.emitted:
                    creq.t_first = self._now()
                    self.trace.instant("first_token", uid=creq.uid,
                                       rid=h.rid)
                creq.emitted.extend(new)
            status = getattr(r, "status", None)
            if status is not None and lifecycle.is_terminal(status):
                del h.owned[ruid]
                creq.degrade_group = max(
                    creq.degrade_group, getattr(r, "degrade_group", 1))
                if status == lifecycle.REJECTED and creq.base > 0:
                    # An engine shedding a REDELIVERY is a failover
                    # failure, not a client-visible admission verdict.
                    self.counters["failover_failed"] += 1
                    status = lifecycle.FAILED
                self._finalize(creq, status, finished)

    def _mark_dead(self, h: ReplicaHandle, finished: list) -> None:
        h.state = DEAD
        self.counters["replica_deaths"] += 1
        self.trace.instant("replica_death", rid=h.rid,
                           orphans=len(h.owned))
        orphans = sorted(h.owned.values(), key=lambda c: c.uid)
        h.owned = {}
        for creq in orphans:
            self._redeliver(creq, finished)

    def _redeliver(self, creq: ClusterRequest, finished: list) -> None:
        """Replay a request whose replica died (or is migrating away):
        prompt + emitted tokens as an extended prefill on a survivor,
        remaining budget and deadline.  Emitted tokens ride the prompt,
        so they are never generated — or emitted — twice."""
        remaining = creq.max_new_tokens - len(creq.emitted)
        if remaining <= 0 or (creq.eos_id is not None and creq.emitted
                              and creq.emitted[-1] == creq.eos_id):
            # The ledger already satisfies a stop condition: the replica
            # died between generating the last token and finalizing.
            self._finalize(creq, lifecycle.DONE, finished)
            return
        now = self._now()
        if (creq.deadline_e2e is not None
                and now - creq.t_submit >= creq.deadline_e2e):
            self._finalize(creq, lifecycle.EXPIRED, finished)
            return
        if (creq.deadline_ttft is not None and not creq.emitted
                and now - creq.t_submit >= creq.deadline_ttft):
            self._finalize(creq, lifecycle.EXPIRED, finished)
            return
        # Failover respects capabilities too: the replay prompt is the
        # ORIGINAL prompt plus the emitted ledger, so only replicas that
        # can hold the extended prefill are candidates.
        cands = self._capable(
            self._routable(), len(creq.prompt) + len(creq.emitted)
        )
        if not cands:
            self.counters["failover_failed"] += 1
            self._finalize(creq, lifecycle.FAILED, finished)
            return
        creq.redeliveries += 1
        try:
            self._deliver(creq, self.policy.choose(cands))
        except ValueError:
            # e.g. prompt + emitted no longer fits the survivor's cache.
            self.counters["failover_failed"] += 1
            self.trace.instant("failover_failed", uid=creq.uid)
            self._finalize(creq, lifecycle.FAILED, finished)
            return
        self.counters["redelivered"] += 1
        self.trace.instant("redeliver", uid=creq.uid, rid=creq.rid,
                           emitted=len(creq.emitted))

    def _finalize(self, creq: ClusterRequest, status: str,
                  finished: list) -> None:
        creq.status = status
        creq.t_done = self._now()
        self._inflight.pop(creq.uid, None)
        self.finished.append(creq)
        self.trace.end("crequest", f"{self._tns}:{creq.uid}",
                       **self._metric_row(creq))
        finished.append(creq)
