"""Continuous-batching scheduler over the paged KV cache.

The slot engine admits a request only when a whole ``max_len`` slab frees
up.  This scheduler makes admission memory-bound and budget-bound,
deciding every tick:

  * **Token-budget admission.**  A tick spends at most ``token_budget``
    tokens of model work: one per running decode lane plus chunked-prefill
    tokens for the head of the queue.  New work is admitted every tick.
  * **Chunked prefill interleaved with decode.**  Prompts run in
    ``prefill_chunk``-token windows on the paged decode kernel (banded
    windows, ``serve_step.make_paged_step``), so a long prompt never stalls
    the running decodes for its full length.
  * **FCFS with preemption when the pool runs dry.**  Requests start in
    arrival order.  When the pool cannot grow a running request for its
    next token, the newest block holder is preempted: its whole KV goes to
    host and it resumes bit-identically later.  Admission and restores never
    preempt; they wait for free blocks, so the oldest request always
    advances.
  * **Lifecycle control** (serve.lifecycle).  TTFT and end-to-end deadlines
    against the injectable clock (``expired``), a bounded waiting queue
    that sheds the newest arrival (``rejected``), ``cancel`` (``cancelled``),
    and numeric quarantine of exactly the offending request (``failed``).
    A global-stall watchdog fails the queue head when nothing progressed
    for ``watchdog_ticks`` ticks with work present.
  * **Mesh one-tick admission.**  An engine over a context mesh
    (``PagedServeEngine(mesh=)``) offers ``mesh_prefill_ready`` and
    ``prefill_mesh_run``: a prompt longer than one chunk prefills whole, in
    one exact forward across the mesh's ring, and its K/V lands in the pool
    in the same tick, in place of ceil(n / chunk) chunk ticks.  Shorter
    prompts keep chunked prefill.
  * **Graceful degradation** (serve.degrade).  Under sustained overload new
    prompts switch from exact chunked prefill to one whole-prompt
    DistrAttention forward (``engine.prefill_full_run``) at a per-level G*.
  * **Fault containment** (serve.faults).  A model step (chunk, whole-prompt
    prefill, decode tick) that raises :class:`InjectedFault` is retried
    ``step_max_retries`` times before the culprit alone is failed; a
    ``restore`` that raises backs off ``restore_backoff_ticks`` doubling
    per attempt, holding the FCFS head, for ``restore_max_retries``
    attempts; the ``slow_step`` fault moves the clock the deadlines read.
  * **Per-request metrics**: TTFT, TPOT, preemptions, terminal status and
    degradation level, plus ``counters_snapshot()``.
  * **Trace events** (obs.trace) to ``trace`` (None: the process-global
    recorder): a ``request`` async span per request, ids
    ``"<namespace>:<uid>"``, whose end args are its metrics row; the
    ``decode`` span around each decode tick; the ``shed``, ``preempt``,
    ``first_token``, ``degrade_level``, ``restore``, ``degraded_prefill``,
    ``mesh_prefill`` and ``watchdog`` instants.

The scheduler is pure policy: it talks to the engine through a small
primitive surface (``free_lane``, ``alloc``, ``can_admit``,
``prefill_chunk_run``, ``prefill_full_run``, ``mesh_prefill_ready`` /
``prefill_mesh_run``, ``decode_tick``, ``evict`` /
``restore`` / ``release``, ``holds_blocks``, ``sample_one``), so tests drive
it with a fake engine and no model.
"""
from __future__ import annotations

import statistics
from collections import Counter, deque
from dataclasses import dataclass, field

import torch

from repro_torch.obs.clock import resolve_clock
from repro_torch.obs.trace import get_recorder
from repro_torch.serve import lifecycle
from repro_torch.serve.degrade import DegradationController, DegradeConfig
from repro_torch.serve.faults import NULL_INJECTOR, InjectedFault


@dataclass
class SchedulerConfig:
    max_batch: int = 8  # concurrent decode lanes
    prefill_chunk: int = 32  # chunked-prefill window
    # Model tokens per tick (decode lanes + prefill chunks); 0 → max_batch +
    # 2·prefill_chunk (one decode tick and two chunks).
    token_budget: int = 0
    # Bounded waiting queue: submissions past this depth are shed; None →
    # unbounded.
    max_waiting: int | None = None
    # Global-stall watchdog: ticks with work present and no progress
    # anywhere before the queue head is failed.  It must outlast the restore
    # backoff (the sum of restore_backoff_ticks · 2^k) or it fires mid-backoff.
    watchdog_ticks: int = 16
    # Bounded retry with backoff for a restore that raises (a False return
    # is a capacity wait and costs no retry).
    restore_max_retries: int = 4
    restore_backoff_ticks: int = 1  # doubles each attempt
    # Bounded retry for a model step that raises (chunk, whole-prompt
    # prefill, decode tick).
    step_max_retries: int = 2

    def budget(self) -> int:
        return self.token_budget or (self.max_batch + 2 * self.prefill_chunk)


@dataclass
class RequestMetrics:
    t_submit: float = 0.0
    t_first_token: float | None = None
    t_done: float | None = None
    n_preemptions: int = 0

    @property
    def ttft(self) -> float | None:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    def tpot(self, n_generated: int) -> float | None:
        if self.t_done is None or self.t_first_token is None:
            return None
        if n_generated <= 1:
            return 0.0
        return (self.t_done - self.t_first_token) / (n_generated - 1)


@dataclass
class Entry:
    """Scheduler-side state of one request (the engine's Request rides along)."""
    req: object  # serve.engine.Request
    prompt_done: int = 0  # prompt tokens prefilled so far
    length: int = 0  # live KV tokens in the pool
    next_token: int | None = None  # sampled, not yet fed to decode
    lane: int | None = None
    evicted: bool = False
    restore_tries: int = 0  # consecutive restores that raised (not waits)
    restore_next_tick: int = 0  # backoff: no restore attempt before this tick
    step_tries: int = 0  # consecutive model steps that raised
    metrics: RequestMetrics = field(default_factory=RequestMetrics)

    @property
    def uid(self) -> int:
        return self.req.uid


def _finite(logits_row) -> bool:
    return bool(torch.isfinite(torch.as_tensor(logits_row)).all())


class Scheduler:
    """FCFS continuous batching with chunked prefill and preemption."""

    def __init__(self, cfg: SchedulerConfig, *, clock=None,
                 degrade: DegradeConfig | DegradationController | None = None,
                 faults=NULL_INJECTOR, trace=None):
        self.cfg = cfg
        self.clock = resolve_clock(clock)
        if isinstance(degrade, DegradeConfig):
            degrade = DegradationController(degrade)
        self.degrade = degrade
        self.faults = faults
        self.trace = trace if trace is not None else get_recorder()
        self._tns = self.trace.ns()  # the request spans' id namespace
        self.waiting: deque[Entry] = deque()
        self.running: dict[int, Entry] = {}  # lane → entry
        self.done: list[Entry] = []
        self.counters: Counter = Counter()
        self._tick = 0
        # Advanced only by the slow_step fault: deadlines, TTFT and TPOT read
        # clock() + offset, so a straggling step ages them without a sleep.
        self._clock_offset = 0.0
        self._stall_ticks = 0
        self._level = 0  # degradation level chosen this tick
        self._last_level = 0  # the last level a degrade_level instant recorded

    def _now(self) -> float:
        return self.clock() + self._clock_offset

    # -- queue ----------------------------------------------------------

    def submit(self, req) -> Entry | None:
        """Queue a request, or shed it (status ``rejected``, returns None)
        when the bounded waiting queue is full.  Reject-newest: accepted
        requests keep their FCFS position."""
        e = Entry(req=req)
        e.metrics.t_submit = self._now()
        self.trace.begin("request", f"{self._tns}:{e.uid}", uid=e.uid,
                         prompt_len=len(req.prompt), max_new=req.max_new_tokens)
        if (self.cfg.max_waiting is not None
                and len(self.waiting) >= self.cfg.max_waiting):
            self.counters["shed"] += 1
            self.trace.instant("shed", uid=e.uid)
            e.metrics.t_done = e.metrics.t_submit
            req.status = lifecycle.REJECTED
            self.done.append(e)
            self.trace.end("request", f"{self._tns}:{e.uid}", **self._metric_row(e))
            return None
        req.status = lifecycle.QUEUED
        self.waiting.append(e)
        return e

    def cancel(self, uid: int, engine) -> bool:
        """Terminate ``uid`` now, wherever it is: its blocks, lane or host
        copy are freed in this call.  False for unknown or terminal uids."""
        for e in list(self.waiting) + list(self.running.values()):
            if e.uid == uid:
                if e.lane is None:
                    self.waiting.remove(e)
                self._finalize(e, engine, lifecycle.CANCELLED)
                self.counters["cancelled"] += 1
                return True
        return False

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def _metric_row(self, e: Entry) -> dict:
        """The row ``metrics()`` lists and the request span's end args carry."""
        return {
            "uid": e.uid,
            "ttft_s": e.metrics.ttft,
            "tpot_s": e.metrics.tpot(len(e.req.generated)),
            "n_generated": len(e.req.generated),
            "n_preemptions": e.metrics.n_preemptions,
            "status": getattr(e.req, "status", lifecycle.DONE),
            "degrade_group": getattr(e.req, "degrade_group", 1),
        }

    def metrics(self) -> list[dict]:
        return [self._metric_row(e) for e in self.done]

    def counters_snapshot(self) -> dict:
        """Frozen to ``lifecycle.COUNTER_KEYS``, zero-filled."""
        return lifecycle.counters_view(self.counters)

    # -- termination ----------------------------------------------------

    def _finalize(self, e: Entry, engine, status: str) -> None:
        """Move an entry to its terminal status, freeing its lane, pool
        blocks and host copy (``release`` covers the last two)."""
        if e.lane is not None:
            self.running.pop(e.lane, None)
            e.lane = None
        if e.evicted or engine.holds_blocks(e):
            engine.release(e)
            e.evicted = False
        e.req.status = status
        e.metrics.t_done = self._now()
        self.done.append(e)
        self.trace.end("request", f"{self._tns}:{e.uid}", **self._metric_row(e))

    def _fail(self, e: Entry, engine, kind: str, finished: list) -> None:
        self._finalize(e, engine, lifecycle.FAILED)
        self.counters[kind] += 1
        finished.append(e.req)

    def _expire_pass(self, engine, finished: list) -> bool:
        """Deadline sweep: TTFT deadlines apply until the first token
        (waiting or mid-prefill entries), end-to-end deadlines throughout.
        Running entries always hold a first token."""
        now = self._now()
        progressed = False
        for e in list(self.waiting):
            r = e.req
            d_ttft = getattr(r, "deadline_ttft", None)
            d_e2e = getattr(r, "deadline_e2e", None)
            waited = now - e.metrics.t_submit
            if (d_ttft is not None and e.metrics.t_first_token is None
                    and waited > d_ttft) or (d_e2e is not None and waited > d_e2e):
                self.waiting.remove(e)
                self._finalize(e, engine, lifecycle.EXPIRED)
                self.counters["expired"] += 1
                finished.append(r)
                progressed = True
        for e in list(self.running.values()):
            d_e2e = getattr(e.req, "deadline_e2e", None)
            if d_e2e is not None and now - e.metrics.t_submit > d_e2e:
                self._finalize(e, engine, lifecycle.EXPIRED)
                self.counters["expired"] += 1
                finished.append(e.req)
                progressed = True
        return progressed

    def _ttft_p50(self) -> float | None:
        """Rolling p50 TTFT over the last 32 finished requests (None until
        one finishes)."""
        vals = [e.metrics.ttft for e in self.done[-32:] if e.metrics.ttft is not None]
        return float(statistics.median(vals)) if vals else None

    # -- preemption -----------------------------------------------------

    def _requeue(self, victim: Entry) -> None:
        """Put a preempted entry back into the waiting queue at its arrival
        position (by uid): the queue stays uid-sorted, so a just-evicted
        runner never jumps an older evicted request."""
        idx = 0
        for e in self.waiting:
            if e.uid > victim.uid:
                break
            idx += 1
        self.waiting.insert(idx, victim)

    def _preempt_newest_holder(self, engine, grower: Entry) -> bool:
        """Evict the newest request holding pool blocks (LIFO: the oldest
        keeps its memory), the grower itself included.  Candidates are the
        running set plus partially prefilled waiters.  True when an eviction
        freed memory the grower may retry with; False when the grower itself
        was evicted or nothing holds blocks."""
        cands = list(self.running.values()) + [
            e for e in self.waiting if not e.evicted and engine.holds_blocks(e)
        ]
        if not cands:
            return False
        victim = max(cands, key=lambda e: e.uid)
        engine.evict(victim)
        victim.evicted = True
        victim.req.status = lifecycle.PREEMPTED
        victim.metrics.n_preemptions += 1
        self.trace.instant("preempt", uid=victim.uid)
        if victim.lane is not None:
            del self.running[victim.lane]
            victim.lane = None
            self._requeue(victim)
        # else: a partially prefilled waiter, already queued in uid order.
        return victim is not grower

    def _alloc_or_preempt(self, engine, entry: Entry, n_tokens: int) -> bool:
        """Cover ``n_tokens`` positions for a running ``entry``, preempting
        newest holders until it fits.  False when the entry itself was
        evicted (the caller skips it)."""
        while not engine.alloc(entry, n_tokens):
            if not self._preempt_newest_holder(engine, grower=entry):
                return False
        return True

    # -- prompt completion ----------------------------------------------

    def _finish_prompt(self, engine, head: Entry, logits_row, finished: list) -> None:
        """Prompt fully prefilled: health-check the last position's logits,
        sample the first token, then finish (max_new_tokens=1 / eos) or move
        to a decode lane."""
        if not _finite(logits_row):
            self._fail(head, engine, "failed_numeric", finished)
            return
        tok = engine.sample_one(logits_row)
        head.req.generated.append(tok)
        head.next_token = tok
        head.metrics.t_first_token = self._now()
        self.trace.instant("first_token", uid=head.uid)
        if (len(head.req.generated) >= head.req.max_new_tokens
                or (head.req.eos_id is not None and tok == head.req.eos_id)):
            head.req.done = True
            self._finalize(head, engine, lifecycle.DONE)
            finished.append(head.req)
            return
        head.req.status = lifecycle.RUNNING
        head.lane = engine.free_lane()
        self.running[head.lane] = head

    def _step_fault(self, engine, e: Entry, finished: list) -> bool:
        """Bounded retry of a model step that raised: True when the entry
        was failed (its budget spent), False when it should retry."""
        e.step_tries += 1
        self.counters["step_retries"] += 1
        if e.step_tries > self.cfg.step_max_retries:
            self._fail(e, engine, "failed_fault", finished)
            return True
        return False

    def _restore(self, engine, head: Entry, finished: list) -> bool:
        """Restore an evicted head from genuinely free blocks, never by
        preempting.  True when the head waits, back in front (backing off,
        or its blocks are not free yet); False when it moved (restored, or
        failed with its retry budget spent)."""
        if head.restore_next_tick > self._tick:
            # Backing off after a failed restore: hold the FCFS head, so no
            # younger entry jumps it; the decode lanes keep draining.
            self.waiting.appendleft(head)
            return True
        try:
            restored = engine.restore(head)
        except InjectedFault:
            # A raise is a fault and spends retry budget; a False return
            # is a capacity wait and never does.
            head.restore_tries += 1
            self.counters["restore_retries"] += 1
            if head.restore_tries > self.cfg.restore_max_retries:
                self._fail(head, engine, "failed_fault", finished)
                return False
            head.restore_next_tick = self._tick + (
                self.cfg.restore_backoff_ticks << (head.restore_tries - 1))
            self.waiting.appendleft(head)
            return True
        if not restored:
            self.waiting.appendleft(head)
            return True
        head.evicted = False
        head.restore_tries = 0
        self.trace.instant("restore", uid=head.uid)
        if head.prompt_done == len(head.req.prompt):
            head.req.status = lifecycle.RUNNING
            head.lane = engine.free_lane()
            self.running[head.lane] = head
        else:  # preempted mid-prefill: resume its chunks next
            head.req.status = lifecycle.PREFILL
            self.waiting.appendleft(head)
        return False

    def _prefill_step(self, engine, head: Entry, run, arg: int, finished: list):
        """One prefill step of ``head``, ``run(head, arg)`` (the engine's
        ``prefill_chunk_run``, ``prefill_full_run`` or, ``arg`` unused,
        ``prefill_mesh_run``) → the last live row's logits.  A step that
        raised is retried later (the head goes back in front) or, its budget
        spent, fails the head.  Returns the row, or None after a fault."""
        head.req.status = lifecycle.PREFILL
        try:
            row = run(head, arg)
        except InjectedFault:
            # Engines raise before they write a block, so a retry re-runs
            # against clean blocks.
            if not self._step_fault(engine, head, finished):
                self.waiting.appendleft(head)
            return None
        head.step_tries = 0
        return row

    # -- the tick -------------------------------------------------------

    def tick(self, engine) -> list:
        """One scheduling step.  Returns the Requests that became terminal
        this tick (rejected and cancelled ones terminate inside
        ``submit`` / ``cancel``)."""
        self._tick += 1
        finished: list = []
        spec = self.faults.fires("slow_step")
        if spec is not None:  # a straggling step ages every deadline first
            self._clock_offset += spec.delay
        progressed = self._expire_pass(engine, finished)

        if self.degrade is not None:
            self._level = self.degrade.observe(len(self.waiting), self._ttft_p50())
            if self._level != self._last_level:
                self.trace.instant("degrade_level", level=self._level)
                self._last_level = self._level

        budget = self.cfg.budget() - len(self.running)  # decode reserved first

        # ---- admission / chunked prefill (FCFS head of the queue) -------
        # The head is popped before any allocation: preemption may insert
        # victims at the front, so any path that leaves the head unfinished
        # puts it back in front (it is the oldest entry).
        while budget > 0 and self.waiting and len(self.running) < self.cfg.max_batch:
            head = self.waiting.popleft()
            if head.evicted:
                if self._restore(engine, head, finished):
                    break
                progressed = True
                continue
            if head.prompt_done == 0 and not engine.can_admit(head):
                # Admission watermark: start a prompt only when its whole
                # prefill plus one decode token fits in free memory now.
                self.waiting.appendleft(head)
                break
            if (head.prompt_done == 0 and hasattr(engine, "prefill_mesh_run")
                    and engine.mesh_prefill_ready(len(head.req.prompt))):
                # Mesh admission: one whole-prompt exact prefill across the
                # engine's ring in place of ceil(n / chunk) chunks (the
                # degraded branch below stays the overload valve).
                n = len(head.req.prompt)
                if not engine.alloc(head, n):
                    self.waiting.appendleft(head)
                    break
                # mesh_prefill and stuck_step raise before any pool write.
                row = self._prefill_step(engine, head, lambda e, _: engine.prefill_mesh_run(e),
                                         n, finished)
                if row is None:
                    progressed |= lifecycle.is_terminal(head.req.status)
                    break
                head.prompt_done = n
                head.length = n
                self.counters["mesh_prefills"] += 1
                self.trace.instant("mesh_prefill", uid=head.uid, n=n)
                budget -= n
                progressed = True
                self._finish_prompt(engine, head, row, finished)
                continue
            if (self._level > 0 and head.prompt_done == 0
                    and hasattr(engine, "prefill_full_run")):
                # Degraded admission: one whole-prompt DistrAttention forward
                # in place of ceil(n / chunk) exact chunks.
                n = len(head.req.prompt)
                if not engine.alloc(head, n):
                    self.waiting.appendleft(head)
                    break
                group = self.degrade.group_size
                row = self._prefill_step(engine, head, engine.prefill_full_run, group, finished)
                if row is None:
                    progressed |= lifecycle.is_terminal(head.req.status)
                    break
                head.prompt_done = n
                head.length = n
                head.req.degrade_group = group
                self.counters["degraded_prefills"] += 1
                self.trace.instant("degraded_prefill", uid=head.uid, group=group)
                budget -= n
                progressed = True
                self._finish_prompt(engine, head, row, finished)
                continue
            chunk = min(self.cfg.prefill_chunk, len(head.req.prompt) - head.prompt_done,
                        budget)
            if chunk <= 0 or not engine.alloc(head, head.prompt_done + chunk):
                self.waiting.appendleft(head)
                break
            logits_last = self._prefill_step(engine, head, engine.prefill_chunk_run, chunk,
                                             finished)
            if logits_last is None:
                progressed |= lifecycle.is_terminal(head.req.status)
                break
            head.prompt_done += chunk
            head.length = head.prompt_done
            budget -= chunk
            progressed = True
            if head.prompt_done == len(head.req.prompt):
                # The final chunk's last live row is the exact last-position
                # distribution: the first token comes from it.
                self._finish_prompt(engine, head, logits_last, finished)
            else:
                self.waiting.appendleft(head)

        # ---- decode tick over all running lanes ------------------------
        if self.running:
            # Decode writes one token at position `length` per lane: every
            # lane's table must cover it (preempting if needed).
            for lane in sorted(self.running):
                e = self.running.get(lane)
                if e is None:
                    continue
                if not self._alloc_or_preempt(engine, e, e.length + 1) and not e.evicted:
                    raise RuntimeError(
                        f"request {e.uid} cannot grow to {e.length + 1} tokens with an "
                        "empty pool"
                    )
            if self.running:
                try:
                    with self.trace.span("decode", n_lanes=len(self.running)):
                        toks, ok = engine.decode_tick(self.running)
                except InjectedFault as f:
                    # The whole batched step is lost (engines raise before
                    # they touch a pool), but only the culprit spends retry
                    # budget; the others lose one tick.
                    culprit = next((x for x in self.running.values() if x.uid == f.uid), None)
                    if culprit is not None and self._step_fault(engine, culprit, finished):
                        progressed = True
                else:
                    progressed |= self._decoded(engine, toks, ok, finished)

        # ---- global-stall watchdog -------------------------------------
        # Fires only when nothing moved anywhere, then fails the FCFS head;
        # failing it is progress, so the counter resets.
        if progressed or not self.has_work():
            self._stall_ticks = 0
        else:
            self._stall_ticks += 1
            if self._stall_ticks >= self.cfg.watchdog_ticks:
                if self.waiting:
                    victim = self.waiting.popleft()
                else:
                    victim = min(self.running.values(), key=lambda x: x.uid)
                self.trace.instant("watchdog", uid=victim.uid)
                self._fail(victim, engine, "watchdog_fails", finished)
                self._stall_ticks = 0
        return finished

    def _decoded(self, engine, toks, ok, finished: list) -> bool:
        """Take one decode tick's tokens; True when any lane moved."""
        progressed = False
        for lane, e in list(self.running.items()):
            progressed = True
            if not ok[lane]:
                # Numeric quarantine: only the offending lane dies.
                self._fail(e, engine, "failed_numeric", finished)
                continue
            e.step_tries = 0
            t = int(toks[lane])
            e.req.generated.append(t)
            e.next_token = t
            e.length += 1
            limit = len(e.req.generated) >= e.req.max_new_tokens
            hit_eos = e.req.eos_id is not None and t == e.req.eos_id
            # Window-decoding engines slide past the table bound; others
            # force-finish at capacity.
            full = (not getattr(engine, "window_decode", False)
                    and e.length >= engine.capacity_tokens - 1)
            if limit or hit_eos or full:
                e.req.done = True
                self._finalize(e, engine, lifecycle.DONE)
                finished.append(e.req)
        return progressed
