"""The slot serving engine over contiguous ring caches.

The decode cache holds ``max_slots`` sequences with a ``max_len`` slab
each.  Requests are prefilled one at a time (prompts right-padded to a
bucket) and their caches copied into free slots; every ``step()`` decodes
one token for all active slots.  A finished sequence frees its slot at
once.  Decoding continues past ``max_len`` by sliding the ring window.

As in the reference engine, admission sets ``pos = n - 1`` and the next
token to the prompt's last token, so the first decode step feeds that token
again at position ``n``; the prefill logits only guard numeric health.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import torch

from repro_torch.serve import kv_cache, lifecycle
from repro_torch.serve.lifecycle import IncompleteRun
from repro_torch.serve.sampler import sample
from repro_torch.serve.serve_step import make_decode_step, make_prefill
from repro_torch.utils.device import resolve_device

BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def _validate_request(prompt, limit: int, max_new_tokens: int) -> None:
    if len(prompt) > limit:
        raise ValueError(f"prompt length {len(prompt)} exceeds the engine's max_len={limit}")
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


class ServeEngine:
    def __init__(self, cfg, params, *, max_slots: int = 8, max_len: int = 512,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 seed: int = 0, device: str | torch.device = "cuda"):
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r}: the port serves dense models")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self._uid = itertools.count()
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

        self.cache = kv_cache.init_cache(cfg, max_slots, max_len, device=self.device)
        self.pos = torch.zeros((max_slots,), dtype=torch.int32, device=self.device)
        self.tokens = torch.zeros((max_slots, 1), dtype=torch.int64, device=self.device)
        self.active: dict[int, Request] = {}  # slot -> request
        self.pending: list[Request] = []
        self.finished: list[Request] = []
        self._prefill = make_prefill(cfg, max_len)
        self._decode = make_decode_step(cfg)
        self._t_submit: dict[int, float] = {}
        self._t_first: dict[int, float] = {}
        self._metric_records: dict[int, dict] = {}

    def add_request(self, prompt: list[int], *, max_new_tokens: int = 32,
                    eos_id: int | None = None) -> int:
        _validate_request(prompt, self.max_len, max_new_tokens)
        req = Request(next(self._uid), list(prompt), max_new_tokens, eos_id)
        self.pending.append(req)
        self._t_submit[req.uid] = time.perf_counter()
        return req.uid

    def _terminal(self, req: Request, status: str, now: float) -> None:
        req.status = status
        t0 = self._t_submit.pop(req.uid, None)
        t1 = self._t_first.pop(req.uid, None)
        n = len(req.generated)
        self._metric_records[req.uid] = {
            "uid": req.uid,
            "ttft_s": None if t0 is None or t1 is None else t1 - t0,
            "tpot_s": None if t1 is None else (now - t1) / max(n - 1, 1),
            "n_generated": n,
            "status": status,
        }
        self.finished.append(req)

    def _release_slot(self, slot: int) -> None:
        """Free a slot; its garbage decode then walks one KV block."""
        del self.active[slot]
        self.pos[slot] = 0
        self.cache["length"][slot] = 0

    def _free_slots(self) -> list[int]:
        return [s for s in range(self.max_slots) if s not in self.active]

    def _admit(self, done_now: list) -> None:
        for slot in self._free_slots():
            if not self.pending:
                break
            req = self.pending.pop(0)
            n = len(req.prompt)
            bucket = min(_bucket(n), self.max_len)
            toks = torch.zeros((1, bucket), dtype=torch.int64)
            toks[0, :n] = torch.tensor(req.prompt)
            req.status = lifecycle.PREFILL
            logits, cache1 = self._prefill(self.params, toks.to(self.device))
            if not bool(torch.isfinite(logits[0, -1]).all()):
                self._terminal(req, lifecycle.FAILED, time.perf_counter())
                done_now.append(req)
                continue
            req.status = lifecycle.RUNNING
            for key in ("k", "v"):  # cache1 is zero-padded to max_len
                self.cache[key][:, slot].copy_(cache1[key][:, 0])
            # Bucketed prefill right-pads the prompt: only n tokens are live.
            self.cache["length"][slot] = n
            self.pos[slot] = n - 1
            self.tokens[slot, 0] = req.prompt[-1]
            self.active[slot] = req

    def step(self) -> list[Request]:
        """Admit pending requests, decode one token for every active slot;
        returns the requests that reached a terminal status this step."""
        done_now: list[Request] = []
        self._admit(done_now)
        if not self.active:
            return done_now
        occupied = torch.zeros((self.max_slots,), dtype=torch.bool)
        occupied[list(self.active)] = True
        # Idle slots stay pinned at 0 so their garbage decode walks one block.
        step_pos = torch.where(occupied.to(self.device), self.pos + 1, 0).to(torch.int32)
        logits, self.cache = self._decode(self.params, self.tokens, self.cache, step_pos)
        row_ok = torch.isfinite(logits[:, -1]).all(dim=-1).cpu()
        next_tokens = sample(logits, generator=self._generator,
                             temperature=self.temperature, top_k=self.top_k,
                             top_p=self.top_p)
        self.pos = step_pos
        self.tokens = next_tokens[:, None]
        toks = next_tokens.cpu().tolist()
        now = time.perf_counter()
        for slot, req in list(self.active.items()):
            if not row_ok[slot]:
                self._release_slot(slot)
                self._terminal(req, lifecycle.FAILED, now)
                done_now.append(req)
                continue
            t = toks[slot]
            req.generated.append(t)
            if len(req.generated) == 1:
                self._t_first[req.uid] = now
            if len(req.generated) >= req.max_new_tokens or (
                    req.eos_id is not None and t == req.eos_id):
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
        """Per-request TTFT / TPOT rows, in completion order."""
        return [self._metric_records[r.uid] for r in self.finished
                if r.uid in self._metric_records]
