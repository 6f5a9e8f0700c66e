"""Serving engines: the slot engine over contiguous ring caches, and the
paged engine over a shared block pool driven by the continuous-batching
scheduler (``PagedServeEngine``, below).

The slot engine's decode cache holds ``max_slots`` sequences with a
``max_len`` slab each.  Requests are prefilled one at a time (prompts right-padded to a
bucket) and their caches copied into free slots; every ``step()`` decodes
one token for all active slots.  A finished sequence frees its slot at
once.  A dense model's decoding continues past ``max_len`` by sliding the
ring window; the ssm and hybrid caches have no ring, so their sequences
finish at ``pos ≥ max_len − 2``.  Under ``attention.distr_decode`` the
dense cache also holds the fused K̂ (``kv_cache``), from which decode
scores read.

Both engines give every request one terminal status (serve.lifecycle)
under deadlines, shedding, cancel, numeric quarantine and injected faults
(serve.faults), and report the same ``counters_snapshot()`` keys.  Both
emit the reference's trace events (obs.trace) to ``trace`` (None: the
process-global recorder): a ``request`` async span per request whose end
args are its ``metrics()`` row, ``prefill`` and ``decode`` spans, and the
``shed``, ``first_token`` and ``degrade_level`` instants (the paged
engine's come from its scheduler).  Every span sits around a step, never
inside a captured graph, and none adds a synchronisation: on the card a
span is the host's time in its step, the dispatch alone unless the step
reads a result back (the paged decode tick returns its tokens and health
mask, so its span includes the tick's device time).

As in the reference engine, admission sets ``pos = n - 1`` and the next
token to the prompt's last token, so the first decode step feeds that token
again at position ``n``; the prefill logits only guard numeric health.
Also as there, an ssm / hybrid prefill's SSM and conv state is the state
after the whole bucket, the pad tokens (id 0) included.
"""
from __future__ import annotations

import itertools
from collections import Counter
from dataclasses import dataclass, field

import torch

from repro_torch.models.lm import check_family
from repro_torch.obs.clock import resolve_clock
from repro_torch.obs.trace import get_recorder
from repro_torch.serve import kv_cache, lifecycle, paged
from repro_torch.serve.degrade import DegradationController, DegradeConfig
from repro_torch.serve.faults import NULL_INJECTOR
from repro_torch.serve.graphs import StepGraph
from repro_torch.serve.lifecycle import IncompleteRun
from repro_torch.serve.sampler import sample
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig
from repro_torch.serve.serve_step import (
    make_decode_step, make_degraded_paged_prefill, make_paged_step, make_prefill,
)
from repro_torch.utils.device import resolve_device

BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def _validate_request(prompt, limit: int, max_new_tokens: int,
                      what: str = "max_len") -> None:
    if len(prompt) > limit:
        raise ValueError(f"prompt length {len(prompt)} exceeds the engine's {what}={limit}")
    if not prompt:
        raise ValueError("prompt must hold at least one token")
    if max_new_tokens <= 0:
        raise ValueError(f"max_new_tokens must be ≥ 1, got {max_new_tokens}")


def _bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return ((n + 4095) // 4096) * 4096


@dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: int | None = None
    generated: list[int] = field(default_factory=list)
    done: bool = False  # completed successfully (status == "done")
    status: str = lifecycle.QUEUED
    # Deadlines in clock units relative to submission; None → none.
    deadline_ttft: float | None = None
    deadline_e2e: float | None = None
    # G* the prefill ran at (1 = exact; > 1 = degraded under overload).
    degrade_group: int = 1


class ServeEngine:
    """The slot engine (see the module docstring) with the request
    lifecycle: deadlines against an injectable ``clock`` (tests pass tick
    clocks), shedding of the newest request past ``max_waiting`` waiting,
    ``cancel``, the degradation dial (``degrade``: under a backlog new
    prompts prefill under DistrAttention at the dial's G*), numeric
    quarantine, and the ``faults`` hooks (serve.faults: ``stuck_step`` at
    admission and before a decode step, ``nan_logits`` on the prefill row
    and each decoded row, ``slow_step``).  Every request ends in one
    terminal status (serve.lifecycle).  ``trace`` takes the trace events
    (see the module docstring).

    Under ``attention.distr_decode`` a dense model decodes from the fused
    K̂ cache under static ``perms`` (L, Hkv, dh) (None draws the port's
    own).  ``device`` defaults to CUDA and raises when it is absent."""

    def __init__(self, cfg, params, *, max_slots: int = 8, max_len: int = 512,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 seed: int = 0, clock=None, max_waiting: int | None = None,
                 degrade: DegradeConfig | DegradationController | None = None, faults=None,
                 device: str | torch.device = "cuda", perms: torch.Tensor | None = None,
                 trace=None):
        check_family(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.clock = resolve_clock(clock)
        self.max_waiting = max_waiting
        if isinstance(degrade, DegradeConfig):
            degrade = DegradationController(degrade)
        self.degrade = degrade
        self.faults = faults or NULL_INJECTOR
        self.trace = trace if trace is not None else get_recorder()
        self._tns = self.trace.ns()  # the request spans' id namespace
        self._last_degrade_level = 0
        self.counters: Counter = Counter()
        self._clock_offset = 0.0  # advanced only by the slow_step fault
        self._step_tries: dict[int, int] = {}  # uid → consecutive faulting steps
        self._uid = itertools.count()
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

        self.cache = kv_cache.init_cache(cfg, max_slots, max_len, device=self.device)
        self.pos = torch.zeros((max_slots,), dtype=torch.int32, device=self.device)
        self.tokens = torch.zeros((max_slots, 1), dtype=torch.int64, device=self.device)
        self.active: dict[int, Request] = {}  # slot -> request
        self.pending: list[Request] = []
        self.finished: list[Request] = []
        self.perms = perms
        self._prefills: dict[int, object] = {}
        # A CUDA graph on the card (tokens and positions are its inputs);
        # the cache, pos and tokens are updated in place, never rebound.
        self._decode = StepGraph(make_decode_step(cfg, perms), inputs=(1, 3))
        self._t_submit: dict[int, float] = {}
        self._t_first: dict[int, float] = {}
        self._metric_records: dict[int, dict] = {}

    def _now(self) -> float:
        return self.clock() + self._clock_offset

    def add_request(self, prompt: list[int], *, max_new_tokens: int = 32,
                    eos_id: int | None = None, deadline_ttft: float | None = None,
                    deadline_e2e: float | None = None) -> int:
        """Queue a request, or shed it (status ``rejected``, terminal at
        once) when ``max_waiting`` requests already wait.  Deadlines are in
        clock units from submission."""
        _validate_request(prompt, self.max_len, max_new_tokens)
        req = Request(next(self._uid), list(prompt), max_new_tokens, eos_id,
                      deadline_ttft=deadline_ttft, deadline_e2e=deadline_e2e)
        now = self._now()
        self.trace.begin("request", f"{self._tns}:{req.uid}", uid=req.uid,
                         prompt_len=len(req.prompt), max_new=max_new_tokens)
        if self.max_waiting is not None and len(self.pending) >= self.max_waiting:
            self.counters["shed"] += 1
            self.trace.instant("shed", uid=req.uid)
            self._terminal(req, lifecycle.REJECTED, now, t_submit=now)
            return req.uid
        self.pending.append(req)
        self._t_submit[req.uid] = now
        return req.uid

    def cancel(self, uid: int) -> bool:
        """Terminate ``uid`` now, freeing its slot if it holds one; False
        for unknown or terminal uids."""
        for req in self.pending:
            if req.uid == uid:
                self.pending.remove(req)
                self.counters["cancelled"] += 1
                self._terminal(req, lifecycle.CANCELLED, self._now())
                return True
        for slot, req in list(self.active.items()):
            if req.uid == uid:
                self._release_slot(slot)
                self.counters["cancelled"] += 1
                self._terminal(req, lifecycle.CANCELLED, self._now())
                return True
        return False

    def _terminal(self, req: Request, status: str, now: float, *,
                  t_submit: float | None = None) -> None:
        req.status = status
        t0 = self._t_submit.pop(req.uid, t_submit)
        t1 = self._t_first.pop(req.uid, None)
        n = len(req.generated)
        self._metric_records[req.uid] = {
            "uid": req.uid,
            "ttft_s": None if t0 is None or t1 is None else t1 - t0,
            "tpot_s": None if t1 is None else (now - t1) / max(n - 1, 1),
            "n_generated": n,
            "n_preemptions": 0,
            "status": status,
            "degrade_group": req.degrade_group,
        }
        # The end event's args ARE the metrics row.
        self.trace.end("request", f"{self._tns}:{req.uid}", **self._metric_records[req.uid])
        self.finished.append(req)

    def _release_slot(self, slot: int) -> None:
        """Free a slot in place; its garbage decode then walks one KV block."""
        del self.active[slot]
        self.pos[slot] = 0
        if "length" in self.cache:
            self.cache["length"][slot] = 0

    def _fail_step(self, req: Request, slot: int | None, done_now: list) -> bool:
        """Count a model step that "raised" for ``req``: True when its
        retry budget (two retries) is spent and it was failed."""
        tries = self._step_tries.get(req.uid, 0) + 1
        self._step_tries[req.uid] = tries
        self.counters["step_retries"] += 1
        if tries <= 2:
            return False
        self._step_tries.pop(req.uid, None)
        if slot is not None:
            self._release_slot(slot)
        self.counters["failed_fault"] += 1
        self._terminal(req, lifecycle.FAILED, self._now())
        done_now.append(req)
        return True

    def _expire_pass(self, done_now: list) -> None:
        """Deadline sweep: a TTFT deadline applies while a request waits for
        admission (its first token comes with the step after), an e2e
        deadline throughout."""
        now = self._now()
        for req in list(self.pending):
            waited = now - self._t_submit.get(req.uid, now)
            if ((req.deadline_ttft is not None and waited > req.deadline_ttft)
                    or (req.deadline_e2e is not None and waited > req.deadline_e2e)):
                self.pending.remove(req)
                self.counters["expired"] += 1
                self._terminal(req, lifecycle.EXPIRED, now)
                done_now.append(req)
        for slot, req in list(self.active.items()):
            waited = now - self._t_submit.get(req.uid, now)
            if req.deadline_e2e is not None and waited > req.deadline_e2e:
                self._release_slot(slot)
                self.counters["expired"] += 1
                self._terminal(req, lifecycle.EXPIRED, now)
                done_now.append(req)

    @staticmethod
    def _slot_axis(key: str) -> int:
        """The slot axis of each cache layout (serve.kv_cache)."""
        if key == "length":
            return 0
        return 2 if key.startswith("groups_") else 1

    def _free_slots(self) -> list[int]:
        return [s for s in range(self.max_slots) if s not in self.active]

    def _prefill_fn(self, group: int):
        """The prefill at G* = ``group``: 1 is the engine's own attention,
        > 1 runs the backbone under ``attention.degraded(group)`` while the
        cache layout stays the engine's.  The prefill is not compiled, so
        one function serves every bucket."""
        if group not in self._prefills:
            bcfg = (self.cfg.replace(attention=self.cfg.attention.degraded(group))
                    if group > 1 else None)
            self._prefills[group] = make_prefill(self.cfg, self.max_len, backbone_cfg=bcfg,
                                                 perms=self.perms)
        return self._prefills[group]

    def _admit(self, done_now: list) -> None:
        group = 1
        if self.degrade is not None:
            # The backlog is the pressure signal, read once a step.
            level = self.degrade.observe(len(self.pending))
            group = self.degrade.cfg.group_for(level)
            if level != self._last_degrade_level:
                self.trace.instant("degrade_level", level=level, group=group)
                self._last_degrade_level = level
        for slot in self._free_slots():
            if not self.pending:
                break
            req = self.pending.pop(0)
            if self.faults.fires("stuck_step", req.uid) is not None:
                # The prefill "raised": retry at the front next step, then
                # fail this request alone.
                if not self._fail_step(req, None, done_now):
                    self.pending.insert(0, req)
                    break
                continue
            self._step_tries.pop(req.uid, None)
            n = len(req.prompt)
            bucket = min(_bucket(n), self.max_len)
            toks = torch.zeros((1, bucket), dtype=torch.int64)
            toks[0, :n] = torch.tensor(req.prompt)
            req.status = lifecycle.PREFILL
            with self.trace.span("prefill", uid=req.uid, bucket=bucket, group=group):
                logits, cache1 = self._prefill_fn(group)(self.params, toks.to(self.device))
            # Numeric health guard, before the cache touches the slot.
            if (self.faults.fires("nan_logits", req.uid) is not None
                    or not bool(torch.isfinite(logits[0, -1]).all())):
                self.counters["failed_numeric"] += 1
                self._terminal(req, lifecycle.FAILED, self._now())
                done_now.append(req)
                continue
            req.degrade_group = group
            if group > 1:
                self.counters["degraded_prefills"] += 1
            req.status = lifecycle.RUNNING
            for key in self.cache:  # cache1's K/V are zero-padded to max_len
                if key != "length":
                    axis = self._slot_axis(key)
                    self.cache[key].select(axis, slot).copy_(cache1[key].select(axis, 0))
            if "length" in self.cache:
                # Bucketed prefill right-pads the prompt: only n tokens are live.
                self.cache["length"][slot] = n
            self.pos[slot] = n - 1
            self.tokens[slot, 0] = req.prompt[-1]
            self.active[slot] = req

    def step(self) -> list[Request]:
        """Admit pending requests, decode one token for every active slot;
        returns the requests that reached a terminal status this step."""
        done_now: list[Request] = []
        spec = self.faults.fires("slow_step")
        if spec is not None:  # a straggling step ages every deadline
            self._clock_offset += spec.delay
        self._expire_pass(done_now)
        self._admit(done_now)
        if not self.active:
            return done_now
        for slot, req in list(self.active.items()):
            if self.faults.fires("stuck_step", req.uid) is not None:
                # The batched decode "raised" before it touched the cache:
                # retry next step; only the culprit spends retry budget.
                self._fail_step(req, slot, done_now)
                return done_now
        occupied = torch.zeros((self.max_slots,), dtype=torch.bool)
        occupied[list(self.active)] = True
        # Idle slots stay pinned at 0 so their garbage decode walks one block.
        step_pos = torch.where(occupied.to(self.device), self.pos + 1, 0).to(torch.int32)
        with self.trace.span("decode", n_active=len(self.active)):
            logits, cache = self._decode(self.params, self.tokens, self.cache, step_pos)
        for key, t in cache.items():  # a conv cache the first step widened
            if t is not self.cache[key]:
                self.cache[key] = t
        nan_slots = [slot for slot, req in self.active.items()
                     if self.faults.fires("nan_logits", req.uid) is not None]
        if nan_slots:  # out of place: ``logits`` may be a graph's output buffer
            poison = torch.zeros((self.max_slots, 1, 1), dtype=torch.bool)
            poison[nan_slots] = True
            logits = torch.where(poison.to(logits.device), float("nan"), logits)
        row_ok = torch.isfinite(logits[:, -1]).all(dim=-1).cpu()
        next_tokens = sample(logits, generator=self._generator,
                             temperature=self.temperature, top_k=self.top_k,
                             top_p=self.top_p)
        self.pos.copy_(step_pos)
        self.tokens.copy_(next_tokens[:, None])
        toks = next_tokens.cpu().tolist()
        # Without the ring's ``length`` a sequence must finish before wrap.
        no_room = (set() if "length" in self.cache else
                   {s for s, p in enumerate(step_pos.cpu().tolist()) if p >= self.max_len - 2})
        now = self._now()
        for slot, req in list(self.active.items()):
            if not row_ok[slot]:
                # Quarantine: this slot alone fails; the others' cache rows
                # and tokens are untouched.
                self._release_slot(slot)
                self.counters["failed_numeric"] += 1
                self._terminal(req, lifecycle.FAILED, now)
                done_now.append(req)
                continue
            self._step_tries.pop(req.uid, None)
            t = toks[slot]
            req.generated.append(t)
            if len(req.generated) == 1:
                self._t_first[req.uid] = now
                self.trace.instant("first_token", uid=req.uid)
            if len(req.generated) >= req.max_new_tokens or (
                    req.eos_id is not None and t == req.eos_id) or slot in no_room:
                req.done = True
                self._release_slot(slot)
                self._terminal(req, lifecycle.DONE, now)
                done_now.append(req)
        return done_now

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        for _ in range(max_steps):
            self.step()
            if not self.active and not self.pending:
                return self.finished
        raise IncompleteRun(
            sorted([r.uid for r in self.active.values()] + [r.uid for r in self.pending]),
            max_steps,
        )

    def metrics(self) -> list[dict]:
        """Per-request TTFT / TPOT / status / G* rows
        (``lifecycle.METRIC_KEYS``), in completion order."""
        return [self._metric_records[r.uid] for r in self.finished
                if r.uid in self._metric_records]

    def counters_snapshot(self) -> dict:
        """Robustness counters, frozen to ``lifecycle.COUNTER_KEYS`` (the
        paged engine reports the same keys)."""
        return lifecycle.counters_view(self.counters)

    def has_work(self) -> bool:
        return bool(self.active or self.pending)

    def queue_depth(self) -> int:
        """Requests waiting for admission."""
        return len(self.pending)

    def degrade_level(self) -> int:
        """The degradation controller's level (0: exact, or no controller)."""
        return 0 if self.degrade is None else self.degrade.level

    @property
    def max_prompt_len(self) -> int:
        """The longest prompt ``add_request`` accepts."""
        return self.max_len


class PagedServeEngine:
    """Serving engine over the paged KV cache (serve.paged, serve.scheduler,
    kernels/paged_decode.py).

    KV is committed per live token (rounded to ``block_size``), not per
    worst-case sequence.  Every ``step()`` is one tick of the
    continuous-batching :class:`~repro_torch.serve.scheduler.Scheduler`:
    token-budget admission, chunked prefill on the paged decode kernel, FCFS
    with whole-request preemption to host when the pool runs dry, and the
    optional degradation dial.  A request's prompt is bounded by the table
    (``max_len``); its decode slides past it by recycling head blocks.
    ``faults`` (serve.faults) fires ``pool_exhausted`` in ``alloc``,
    ``restore_failure`` in ``restore`` and ``stuck_step`` and
    ``nan_logits`` in every model step; the scheduler contains them.
    ``trace`` is handed to the scheduler, which emits the trace events.

    Dense family only; fused-K̂ pools under ``attention.distr_decode`` with
    static ``perms`` (L, Hkv, dh) (None draws the port's own).
    ``block_size=None`` resolves to 128, the reference's value without its
    tuner.  ``device`` defaults to CUDA and raises when it is absent.
    """

    #: Decode slides past capacity by recycling head blocks.
    window_decode = True

    def __init__(self, cfg, params, *, max_batch: int = 8, max_len: int = 512,
                 block_size: int | None = None, num_blocks: int | None = None,
                 prefill_chunk: int = 32, token_budget: int = 0,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 seed: int = 0, cache_dtype=torch.bfloat16, clock=None,
                 max_waiting: int | None = None, degrade: DegradeConfig | None = None,
                 faults=None, device: str | torch.device = "cuda",
                 perms: torch.Tensor | None = None, trace=None):
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r}: the port pages dense models")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self._uid = itertools.count()
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

        self.block_size = min(block_size or 128, max_len)
        self.max_blocks = -(-max_len // self.block_size)
        self.capacity_tokens = self.max_blocks * self.block_size
        if num_blocks is None:  # every lane can hold max_len
            num_blocks = 1 + max_batch * self.max_blocks
        if num_blocks - 1 < self.max_blocks:
            raise ValueError(
                f"pool of {num_blocks} blocks (1 reserved) cannot hold one full request "
                f"({self.max_blocks} blocks of {self.block_size}); preemption could not "
                "guarantee progress"
            )
        self.cache = paged.PagedKVCache(cfg, num_blocks, self.block_size, dtype=cache_dtype,
                                        device=self.device)
        self.prefill_chunk = min(prefill_chunk, max_len)
        self.faults = faults or NULL_INJECTOR
        self.trace = trace if trace is not None else get_recorder()
        self.scheduler = Scheduler(
            SchedulerConfig(max_batch=max_batch, prefill_chunk=self.prefill_chunk,
                            token_budget=token_budget, max_waiting=max_waiting),
            clock=clock, degrade=degrade, faults=self.faults, trace=self.trace,
        )
        self.perms = perms
        # The decode tick and the chunk window run as CUDA graphs on the
        # card; their inputs are static buffers filled in place each step.
        self._decode = StepGraph(make_paged_step(cfg, 1, perms), inputs=(1, 3, 4, 5))
        self._chunk = StepGraph(make_paged_step(cfg, self.prefill_chunk, perms),
                                inputs=(1, 3, 4, 5))
        self._tick_in = self._step_buffers(max_batch, 1)
        self._chunk_in = self._step_buffers(1, self.prefill_chunk)
        self._degraded: dict[int, object] = {}
        self.finished: list[Request] = []

    # -- public API -------------------------------------------------------

    def add_request(self, prompt: list[int], *, max_new_tokens: int = 32,
                    eos_id: int | None = None, deadline_ttft: float | None = None,
                    deadline_e2e: float | None = None) -> int:
        # The first decode token writes at position len(prompt), so a prompt
        # leaves one table slot free; max_new_tokens may cross capacity.
        _validate_request(prompt, min(self.max_len, self.capacity_tokens - 1),
                          max_new_tokens, what="max_len (capacity − 1)")
        req = Request(next(self._uid), list(prompt), max_new_tokens, eos_id,
                      deadline_ttft=deadline_ttft, deadline_e2e=deadline_e2e)
        if self.scheduler.submit(req) is None:
            self.finished.append(req)  # shed at the gate (status rejected)
        return req.uid

    def cancel(self, uid: int) -> bool:
        """Terminate ``uid`` now; False for unknown or terminal uids."""
        if self.scheduler.cancel(uid, self):
            self.finished.append(self.scheduler.done[-1].req)
            return True
        return False

    def step(self) -> list[Request]:
        """One scheduler tick: admission, chunked prefill, batched decode."""
        done = self.scheduler.tick(self)
        self.finished.extend(done)
        return done

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        for _ in range(max_steps):
            self.step()
            if not self.scheduler.has_work():
                return self.finished
        raise IncompleteRun(
            sorted([e.uid for e in self.scheduler.waiting]
                   + [e.uid for e in self.scheduler.running.values()]),
            max_steps,
        )

    def metrics(self) -> list[dict]:
        """Per-request TTFT / TPOT / preemptions / status / degradation
        level (``lifecycle.METRIC_KEYS``)."""
        return self.scheduler.metrics()

    def counters_snapshot(self) -> dict:
        """Robustness counters, frozen to ``lifecycle.COUNTER_KEYS``."""
        return self.scheduler.counters_snapshot()

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def queue_depth(self) -> int:
        """Requests waiting for admission."""
        return len(self.scheduler.waiting)

    def degrade_level(self) -> int:
        """The degradation controller's level (0: exact, or no controller)."""
        d = self.scheduler.degrade
        return 0 if d is None else d.level

    @property
    def max_prompt_len(self) -> int:
        """The longest prompt ``add_request`` accepts."""
        return min(self.max_len, self.capacity_tokens - 1)

    # -- scheduler primitives --------------------------------------------

    def free_lane(self) -> int:
        for lane in range(self.max_batch):
            if lane not in self.scheduler.running:
                return lane
        raise RuntimeError("no free lane (scheduler admitted past max_batch)")

    def alloc(self, entry, n_tokens: int) -> bool:
        if self.faults.fires("pool_exhausted", entry.uid) is not None:
            return False  # presents as the real failure: the scheduler waits
        try:
            self.cache.allocate_to(entry.uid, min(n_tokens, self.capacity_tokens))
            return True
        except paged.PoolExhausted:
            return False

    def can_admit(self, entry) -> bool:
        """Admission watermark: the whole prompt plus one decode token must
        fit in free blocks before the first chunk runs."""
        need = self.cache.blocks_for(min(len(entry.req.prompt) + 1, self.capacity_tokens))
        return self.cache.pool.num_free >= need

    def evict(self, entry) -> None:
        self.cache.evict_to_host(entry.uid, entry.length, pad_to=self.max_blocks)

    def restore(self, entry) -> bool:
        # A raise is a restore fault (retried with backoff), raised before
        # any copy; a False return is a capacity wait.
        self.faults.raise_if("restore_failure", entry.uid)
        try:
            self.cache.restore(entry.uid)
            return True
        except paged.PoolExhausted:
            return False

    def release(self, entry) -> None:
        self.cache.free(entry.uid)

    def holds_blocks(self, entry) -> bool:
        return bool(self.cache.tables.get(entry.uid))

    def sample_one(self, logits_row: torch.Tensor) -> int:
        tok = sample(logits_row[None], generator=self._generator,
                     temperature=self.temperature, top_k=self.top_k, top_p=self.top_p)
        return int(tok[0])

    def _ints(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int64).to(self.device)

    def _step_buffers(self, batch: int, width: int) -> dict:
        """A paged step's inputs: tokens (batch, width), the block table,
        start positions and live counts (batch,)."""
        ints = dict(dtype=torch.int64, device=self.device)
        return {"tokens": torch.zeros((batch, width), **ints),
                "table": torch.zeros((batch, self.max_blocks), dtype=torch.int32,
                                     device=self.device),
                "pos": torch.zeros((batch,), **ints), "count": torch.zeros((batch,), **ints)}

    def _run_paged(self, step, bufs: dict, uids, toks, pos, count) -> torch.Tensor:
        """Fill ``bufs`` in place and run ``step`` on them → logits."""
        self.cache.table_array(uids, self.max_blocks, out=bufs["table"])
        for key, values in (("tokens", toks), ("pos", pos), ("count", count)):
            bufs[key].copy_(torch.tensor(values, dtype=torch.int64))
        logits, _ = step(self.params, bufs["tokens"], self.cache.pools, bufs["table"],
                         bufs["pos"], bufs["count"])
        return logits

    def prefill_chunk_run(self, entry, chunk: int) -> torch.Tensor:
        """One chunked-prefill window for ``entry`` (B = 1); returns the last
        live row's logits (the exact last-position distribution once the
        prompt completes), a view the next window overwrites."""
        self.faults.raise_if("stuck_step", entry.uid)  # before any pool write
        start = entry.prompt_done
        toks = [0] * self.prefill_chunk
        toks[:chunk] = entry.req.prompt[start:start + chunk]
        logits = self._run_paged(self._chunk, self._chunk_in, [entry.uid], [toks], [start],
                                 [chunk])
        return self._poisoned(entry, logits[0, chunk - 1])

    def _poisoned(self, entry, row: torch.Tensor) -> torch.Tensor:
        """``row``, or a NaN row in its place (never written into ``row``,
        which may be a graph's output) when ``nan_logits`` fires."""
        if self.faults.fires("nan_logits", entry.uid) is not None:
            return torch.full_like(row, float("nan"))
        return row

    def prefill_full_run(self, entry, group: int) -> torch.Tensor:
        """Whole-prompt degraded prefill (serve.degrade): one forward under
        DistrAttention at G* = ``group`` writes the prompt's K/V into the
        already-allocated blocks; returns the last live row's logits."""
        self.faults.raise_if("stuck_step", entry.uid)
        n = len(entry.req.prompt)
        bucket = min(_bucket(n), self.max_len)
        toks = list(entry.req.prompt) + [0] * (bucket - n)
        if group not in self._degraded:
            self._degraded[group] = make_degraded_paged_prefill(self.cfg, bucket, group,
                                                                self.perms)
        bt = self.cache.table_array([entry.uid], self.max_blocks)
        row, _ = self._degraded[group](self.params, self._ints([toks]), n,
                                       self.cache.pools, bt)
        return self._poisoned(entry, row)

    def decode_tick(self, running: dict):
        """One batched decode over all running lanes → ``(tokens, ok)``:
        (max_batch,) sampled tokens (idle lanes decode garbage that is never
        read) and the numeric health mask (False: that lane's logits went
        non-finite).  An injected ``stuck_step`` raises before the step
        runs, so no pool is touched."""
        for e in running.values():
            self.faults.raise_if("stuck_step", e.uid)
        occupied = [False] * self.max_batch
        pos = [0] * self.max_batch
        toks = [[0] for _ in range(self.max_batch)]
        uids = [-1] * self.max_batch
        for lane, e in running.items():
            occupied[lane] = True
            pos[lane] = e.length
            toks[lane][0] = e.next_token
            uids[lane] = e.uid
        logits = self._run_paged(self._decode, self._tick_in, uids, toks, pos,
                                 [int(o) for o in occupied])
        nan_lanes = [lane for lane, e in running.items()
                     if self.faults.fires("nan_logits", e.uid) is not None]
        if nan_lanes:  # out of place: ``logits`` is the graph's output buffer
            poison = torch.zeros((self.max_batch, 1, 1), dtype=torch.bool)
            poison[nan_lanes] = True
            logits = torch.where(poison.to(logits.device), float("nan"), logits)
        ok = (torch.isfinite(logits[:, -1]).all(dim=-1).cpu()
              | ~torch.tensor(occupied)).tolist()
        next_tokens = sample(logits[:, -1], generator=self._generator,
                             temperature=self.temperature, top_k=self.top_k,
                             top_p=self.top_p)
        return next_tokens.cpu().tolist(), ok
