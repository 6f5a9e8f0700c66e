"""The block-size autotuner (``repro.tune.autotune``), for the port's kernels.

Three modes resolve an "auto" (``None``) block size, chosen by the
``REPRO_TUNE`` environment variable:

  off       the static values: the decode split min(128, S), the paged
            pool's block 128, DistrAttention's block_q 128.
  analytic  the paper's §3.3.1 rule on Hopper's shared memory
            (``core.block_size``), clamped to the sequence bucket; no
            measurement.
  measure   candidates ranked by that model, each timed on the live device
            (on the card the decode split and the paged block as CUDA
            graph replays, as the serving steps run them, and block_q as
            an eager call, as a prefill runs it; the plain versions on the
            CPU), the pick cached in the persistent JSON cache.  The pick
            is the static value unless a candidate's median time beats it
            by more than the spread of either one's repeated timings.

The knobs swept are the ones the port's kernels take at run time: the
decode split ``block_k`` of ``ops.decode_attention`` (multiples of the
decode tile's 64-key K/V tile, ``csrc/decode_tc.cuh::DT_KEYS``), the paged
pool's block size, and DistrAttention's ``block_q``, which is also the LSH
permutation granularity (multiples of ``kernels/distr_attention.py::
ROW_TILE``).  The flash forward's tile and the backward kernels' tiles are
compiled into ``kernels/csrc`` (``compiled_tile``): in every mode those
keys resolve to the compiled tile, recorded as a single candidate, never
swept.  xla_flash's blocks stay at the static 128.

Sweeps run on synthetic inputs at the key's sequence bucket (capped),
with the timer injectable so tests are deterministic.  The decode and
paged sweeps serve a ragged length mix (the caller's ``lengths``, or
``batch`` requests spread evenly up to the capacity) over enough distinct
K/V copies to exceed twice the card's L2, one call a copy, as a step runs
one a layer, so the timings read HBM as serving does; their table holds
seconds a call.  A sweep runs only when a caller resolves a key the memo
and the cache do not hold: the engines, ``make_decode_step(max_len=)``
and the training launcher resolve theirs at construction and warm-up,
and inside a captured CUDA graph or a decode step (``sweeps_refused``) an
unresolved key raises instead of sweeping.  Resolutions are memoised per
(mode, cache path, key, backend), so a process pays a sweep once and the
JSON cache makes later processes pay nothing.  Each sweep is a
``tune/measure`` span and each pick a ``tune/pick`` instant on the global
trace recorder.  A sweep's launches count on the kernels' counters like
any other: a reader of the counters zeroes them after the warm-up.
"""
from __future__ import annotations

import os
import statistics
from contextlib import contextmanager

import torch

from repro_torch.core.block_size import MAX_TILE, enumerate_block_sizes
from repro_torch.core.distr_attention import DEFAULT_BLOCK
from repro_torch.obs.trace import get_recorder
from repro_torch.tune.block_sizes import BlockSizes
from repro_torch.tune.cache import TuneCache, cache_key, seq_bucket
from repro_torch.tune.measure import Timer, default_timer, measure_candidates
from repro_torch.utils.device import resolve_device

MODES = ("off", "analytic", "measure")
TOP_K = 8
# Sequence cap of a sweep: the CPU's plain versions are slow past a few
# hundred rows; on the card the bucket is measured up to 2048.
MEASURE_SEQ_CAP_CPU = 512
MEASURE_SEQ_CAP_CUDA = 2048
DT_KEYS = 64  # keys per K/V tile of the decode tile (csrc/decode_tc.cuh)
ROW_TILE = 64  # query rows a DistrAttention CTA holds (kernels/distr_attention.py)


def tune_mode() -> str:
    mode = os.environ.get("REPRO_TUNE", "off").lower()
    if mode not in MODES:
        raise ValueError(f"REPRO_TUNE={mode!r}; choose from {MODES}")
    return mode


def backend_tag(device: torch.device) -> str:
    """``sm_<major><minor>`` of the card, or ``cpu`` for the plain versions."""
    if device.type != "cuda":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(device)
    return f"sm_{major}{minor}"


def compiled_tile(kernel: str, *, d: int, dtype: str) -> tuple[int, int]:
    """(query rows, keys) of the tile a kernel compiles: bf16 runs the
    tensor-core tiles, f32 the FMA tiles.

      flash_fwd, distr_fwd  bf16 BM × BN = 64 × 64 (``flash_fwd_tc.cuh``),
                            f32 64 × 32 (``attention_tile.cuh``); distr's
                            block_q is its own knob, the pair's m is the
                            KV tile
      *_dq                  bf16 DQ_ROWS × DQ_KEYS = 64 × 64
                            (``flash_bwd_tc.cuh``), f32 DQ_BM × DQ_BN = 64 × 32
                            (``attention_bwd_tile.cuh``)
      *_dkv                 bf16 dkv_rows<d>() × DKV_KEYS = (32 if d > 64
                            else 64) × 64, f32 DKV_BQ × DKV_BK = 32 × 64
    """
    bf16 = dtype == "bfloat16"
    if kernel in ("flash_fwd", "distr_fwd", "flash_dq", "distr_dq"):
        return (64, 64) if bf16 else (64, 32)
    if kernel in ("flash_dkv", "distr_dkv"):
        return ((32 if d > 64 else 64), 64) if bf16 else (32, 64)
    raise ValueError(f"no compiled tile for {kernel!r}")


# ---------------------------------------------------------------------------
# Candidate spaces, pruned by the analytic model
# ---------------------------------------------------------------------------


def pair_candidates(d: int, *, n: int, group_size: int = 1, w: int = 2, ls=None,
                    m: int | None = None) -> list[tuple[int, int]]:
    """Top-K (l, m) candidates: every tile that fits Hopper's shared memory
    (``enumerate_block_sizes``), clamped to the sequence bucket,
    deduplicated and ranked by the paper's objective (max l, then max m);
    the 128 × 128 default always appended.  ``ls`` restricts l to those values and
    ``m`` pins the KV tile (a kernel's compiled one)."""
    nb = min(seq_bucket(n), MAX_TILE)
    legal = enumerate_block_sizes(d, group_size=group_size, w=w)
    clamped = {(min(l, nb), mm if m is not None else min(mm, nb)) for l, mm, _ in legal
               if (ls is None or l in ls) and (m is None or mm == m)}
    cands = sorted(clamped, key=lambda t: (-t[0], -t[1]))[:TOP_K]
    default = (min(DEFAULT_BLOCK, nb), m if m is not None else min(DEFAULT_BLOCK, nb))
    if default not in cands:
        cands.append(default)
    return cands


def distr_candidates(d: int, *, n: int, group_size: int, dtype: str = "bfloat16") -> list[int]:
    """DistrAttention ``block_q`` candidates: ROW_TILE times a power of two
    up to 1024 whose tile fits the model at the kernel's KV tile, largest
    first (the paper's max-l rule), clamped to the bucket; 128 always among
    them."""
    kv = compiled_tile("distr_fwd", d=d, dtype=dtype)[1]
    ls = tuple(ROW_TILE << i for i in range(5))
    pairs = pair_candidates(d, n=n, group_size=group_size,
                            w=2 if dtype == "bfloat16" else 4, ls=ls, m=kv)
    return list(dict.fromkeys(l for l, _ in pairs))


def decode_candidates(n: int) -> list[int]:
    """Split-K decode ``block_k`` candidates: multiples of the decode
    tile's 64 keys, doubling up to the cache capacity.  Fewer, longer
    splits amortise the per-split merge; more, shorter ones add CTAs."""
    nb = min(seq_bucket(n), 1024)
    cands = [bk for bk in (DT_KEYS << i for i in range(5)) if bk <= nb]
    return cands or [nb]


def paged_block_candidates(n: int) -> list[int]:
    """Pool block-size candidates for the paged decode kernel.  The block is
    both the unit a split streams (bigger amortises its overhead) and the
    allocator's granularity (smaller wastes less of a request's last
    block); the sweep measures the kernel's side."""
    nb = min(seq_bucket(n), 512)
    cands = [bs for bs in (DT_KEYS << i for i in range(4)) if bs <= nb]
    return cands or [nb]


def _analytic_decode(n: int) -> int:
    # About 8 live splits, never below 128 keys, clamped to the bucket.
    nb = min(seq_bucket(n), 1024)
    bk = 128
    while bk * 8 < nb:
        bk *= 2
    return min(bk, nb, 512)


# ---------------------------------------------------------------------------
# Sweep runners: synthetic inputs at the measured shape, one callable a
# candidate
# ---------------------------------------------------------------------------


def _torch_dtype(dtype: str) -> torch.dtype:
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _randn(gen, shape, dtype: str, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device).to(_torch_dtype(dtype))


def _static_perm(d: int, hkv: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(1)
    return torch.randperm(d, generator=gen)[None].expand(hkv, d).to(device)


def sweep_lengths(n: int, *, batch: int = 1, lengths=None) -> list[int]:
    """The live lengths a decode or paged sweep serves at capacity ``n``:
    ``lengths`` (a serving workload's mix) clamped to [1, n], or ``batch``
    requests spread evenly over (0, n]."""
    if lengths is not None:
        return [min(max(int(x), 1), n) for x in lengths]
    return [max(1, n * (i + 1) // batch) for i in range(batch)]


def _copies(bytes_per_copy: int, device: torch.device) -> int:
    """Distinct K/V copies a sweep cycles through: their live bytes
    together over twice the card's L2 (at most 64 copies), so each call
    reads HBM as a step's layers do; one on the CPU."""
    if device.type != "cuda":
        return 1
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    return max(1, min(64, -(-2 * l2 // bytes_per_copy)))


def _make_run_decode(n, d, dtype, device, group_size, lengths, heads=(2, 1)):
    """One call a K/V copy, each over ``lengths`` live tokens of a capacity
    ``n`` cache; ``make_run.calls`` copies."""
    from repro_torch.core import grouping
    from repro_torch.kernels import ops

    hq, hkv = heads
    batch = len(lengths)
    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn(gen, (batch, hq, 1, d), dtype, device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    esize = 2 if dtype == "bfloat16" else 4
    caches = []
    for _ in range(_copies(2 * sum(lengths) * hkv * d * esize, device)):
        k = _randn(gen, (batch, hkv, n, d), dtype, device)
        v = _randn(gen, (batch, hkv, n, d), dtype, device)
        if group_size > 1:  # the fused-K̂ layout: narrow scores, full-width V
            perm = _static_perm(d, hkv, device)
            caches.append(dict(k=None, v=v, perm=perm, group_size=group_size,
                               k_fused=grouping.fuse_columns(k.float(), perm[None], group_size)
                               .to(k.dtype)))
        else:
            caches.append(dict(k=k, v=v))

    def make_run(cand):
        def run():
            for kw in caches:
                ops.decode_attention(q, lengths=lens, block_k=int(cand), **kw)
        return run

    make_run.calls = len(caches)
    return make_run


def _make_run_paged_decode(n, d, dtype, device, group_size, lengths, heads=(2, 1)):
    """One table a request spanning the capacity ``n``, its physical blocks
    shuffled so the sweep sees the table's indirection; one call a pool
    copy, ``make_run.calls`` copies."""
    from repro_torch.core import grouping
    from repro_torch.kernels import ops

    hq, hkv = heads
    batch = len(lengths)
    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn(gen, (batch, hq, 1, d), dtype, device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    perm = _static_perm(d, hkv, device) if group_size > 1 else None
    esize = 2 if dtype == "bfloat16" else 4
    copies = _copies(2 * sum(lengths) * hkv * d * esize, device)

    def make_run(cand):
        bs = int(cand)
        mb = -(-n // bs)
        p = 1 + batch * mb  # + the reserved garbage block
        order = torch.randperm(p - 1, generator=torch.Generator().manual_seed(2)) + 1
        tables = order.reshape(batch, mb).to(device=device, dtype=torch.int32)
        pools = []
        for _ in range(copies):
            k_pool = _randn(gen, (p, hkv, bs, d), dtype, device)
            v_pool = _randn(gen, (p, hkv, bs, d), dtype, device)
            if group_size > 1:
                pools.append(dict(k_pool=None, v_pool=v_pool, perm=perm,
                                  group_size=group_size,
                                  k_fused_pool=grouping.fuse_columns(
                                      k_pool.float(), perm[None], group_size).to(k_pool.dtype)))
            else:
                pools.append(dict(k_pool=k_pool, v_pool=v_pool))

        def run():
            for kw in pools:
                ops.paged_decode_attention(q, block_tables=tables, lengths=lens, **kw)
        return run

    make_run.calls = copies
    return make_run


def _make_run_distr(n, d, dtype, causal, device, group_size, *, xla: bool, heads=(1, 1)):
    from dataclasses import replace

    from repro_torch.core.distr_attention import DistrConfig, distr_attention
    from repro_torch.kernels import ops

    hq, hkv = heads
    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn(gen, (1, hq, n, d), dtype, device)
    k = _randn(gen, (1, hkv, n, d), dtype, device)
    v = _randn(gen, (1, hkv, n, d), dtype, device)
    base = DistrConfig(group_size=group_size)
    fn = distr_attention if xla else ops.distr_attention

    def make_run(cand):
        cfg = replace(base, block_q=int(cand))
        return lambda: fn(q, k, v, cfg, causal=causal)

    return make_run


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------


def _jsonable(c):
    return list(c) if isinstance(c, tuple) else int(c)


_REFUSING: str | None = None  # the site inside which a sweep raises


@contextmanager
def sweeps_refused(site: str):
    """Inside, resolving a key that the memo and the cache do not hold
    raises instead of sweeping: ``site`` (a serving step) must have been
    warmed first."""
    global _REFUSING
    prev, _REFUSING = _REFUSING, site
    try:
        yield
    finally:
        _REFUSING = prev


def pick(stats: dict, default) -> object:
    """The fastest candidate by median, or ``default`` unless that one beats
    it by more than the spread (max − min) of either's repeated timings.
    ``stats``: {candidate: (median seconds, spread seconds)}."""
    best = min(stats, key=lambda c: stats[c][0])
    if default in stats:
        margin = max(stats[best][1], stats[default][1])
        if stats[default][0] - stats[best][0] <= margin:
            return default
    return best


class Autotuner:
    """Resolution, measurement and caching.  ``timer`` is injectable
    (tests pass a deterministic fake; None times on the device the key
    resolves for); ``cache`` defaults to the env-pointed JSON."""

    def __init__(self, cache: TuneCache | None = None, timer: Timer | None = None):
        self.cache = cache if cache is not None else TuneCache()
        self.timer = timer
        self._memo: dict = {}

    def _measure_seq(self, n: int, device: torch.device) -> int:
        cap = MEASURE_SEQ_CAP_CUDA if device.type == "cuda" else MEASURE_SEQ_CAP_CPU
        return max(128, min(seq_bucket(n), cap))

    def _resolve_measured(self, kernel: str, key: str, candidates: list, default,
                          make_run_thunk, device: torch.device, *,
                          graph: bool = False) -> dict:
        """Cache lookup → sweep → persist; returns the cache entry.
        ``make_run_thunk()`` builds the runners lazily, so a cache hit
        touches no device; a runner's ``calls`` (default 1) divides its
        timings into seconds a call.  ``graph``: time the calls as CUDA
        graph replays (the serving steps capture them).  ``default`` is the
        static value the pick keeps unless a candidate clearly beats it
        (``pick``)."""
        entry = self.cache.get(key)
        if entry is not None:
            return entry
        capturing = device.type == "cuda" and torch.cuda.is_current_stream_capturing()
        if _REFUSING is not None or capturing:
            where = _REFUSING or "a CUDA graph capture"
            raise RuntimeError(f"tuner key {key!r} is not resolved and {where} may not "
                               "sweep; warm it first (tune.warm_decode, tune.warm_engine)")
        rec = get_recorder()
        timer = self.timer if self.timer is not None else default_timer(device, graph=graph)
        with rec.span("tune/measure", kernel=kernel, n_candidates=len(candidates)):
            with torch.no_grad():
                make_run = make_run_thunk()
                samples = measure_candidates(make_run, candidates, timer)
        calls = getattr(make_run, "calls", 1)
        stats = {c: (statistics.median(t) / calls, (max(t) - min(t)) / calls)
                 for c, t in samples.items()}
        best = pick(stats, default)
        rec.instant("tune/pick", kernel=kernel, best=_jsonable(best), seconds=stats[best][0])
        entry = {
            "kernel": kernel,
            "best": _jsonable(best),
            "default": _jsonable(default),
            "calls": calls,
            "table": [{"candidate": _jsonable(c), "seconds": m, "spread": sp}
                      for c, (m, sp) in sorted(stats.items(), key=lambda kv: kv[1][0])],
        }
        self.cache.put(key, entry)
        return entry

    def _record_compiled(self, kernel: str, key: str, tile: tuple[int, int]) -> None:
        """A compiled tile's key: one recorded candidate, no sweep."""
        if self.cache.get(key) is not None:
            return
        get_recorder().instant("tune/pick", kernel=kernel, best=list(tile), seconds=None,
                               compiled=True)
        self.cache.put(key, {"kernel": kernel, "best": list(tile), "compiled": True,
                             "table": [{"candidate": list(tile), "seconds": None}]})

    def resolve_compiled(self, kernel: str, *, d: int, n: int, dtype: str = "bfloat16",
                         group_size: int = 1, causal: bool = False,
                         device: str | torch.device = "cuda") -> tuple[int, int]:
        """The compiled tile of ``kernel`` (``compiled_tile``) in every mode;
        under ``measure`` its key is recorded in the cache once."""
        tile = compiled_tile(kernel, d=d, dtype=dtype)
        if tune_mode() == "measure":
            dev = resolve_device(device)
            memo_key = ("compiled", self.cache.path, kernel, d, seq_bucket(n), dtype,
                        group_size, causal, backend_tag(dev))
            if memo_key not in self._memo:
                key = cache_key(kernel, backend=backend_tag(dev), dtype=dtype, d=d,
                                group_size=group_size, n=self._measure_seq(n, dev),
                                causal=causal)
                self._record_compiled(kernel, key, tile)
                self._memo[memo_key] = tile
        return tile

    def resolve_distr(self, *, d: int, n: int, dtype: str = "bfloat16", group_size: int = 2,
                      causal: bool = False, xla: bool = False,
                      device: str | torch.device = "cuda") -> int:
        """DistrAttention's ``block_q`` through the mode: kernel
        ``distr_fwd``, or ``xla_distr`` for the plain impl."""
        kernel = "xla_distr" if xla else "distr_fwd"
        mode = tune_mode()
        if mode == "off":
            return min(DEFAULT_BLOCK, seq_bucket(n))
        if mode == "analytic":  # the largest block the model admits: max l
            return distr_candidates(d, n=n, group_size=group_size, dtype=dtype)[0]
        dev = resolve_device(device)
        tag = backend_tag(dev)
        memo_key = (mode, self.cache.path, kernel, d, seq_bucket(n), dtype, group_size,
                    causal, tag)
        if memo_key not in self._memo:
            n_meas = self._measure_seq(n, dev)
            cands = distr_candidates(d, n=n_meas, group_size=group_size, dtype=dtype)
            key = cache_key(kernel, backend=tag, dtype=dtype, d=d, group_size=group_size,
                            n=n_meas, causal=causal)
            entry = self._resolve_measured(
                kernel, key, cands, min(DEFAULT_BLOCK, seq_bucket(n_meas)),
                lambda: _make_run_distr(n_meas, d, dtype, causal, dev, group_size, xla=xla),
                dev)
            self._memo[memo_key] = int(entry["best"])
        return self._memo[memo_key]

    def resolve_distr_bwd(self, kernel: str, *, block_q: int, d: int, n: int,
                          dtype: str = "bfloat16", group_size: int = 2,
                          causal: bool = False,
                          device: str | torch.device = "cuda") -> tuple[int, int]:
        """(block_q, keys) of a DistrAttention backward kernel ("distr_dq"
        | "distr_dkv"): ``block_q`` pinned by the caller (the LSH grouping
        granularity the forward's permutations were drawn at), the keys the
        kernel's compiled tile."""
        if kernel not in ("distr_dq", "distr_dkv"):
            raise ValueError(f"unknown distr bwd kernel {kernel!r}")
        tile = self.resolve_compiled(kernel, d=d, n=n, dtype=dtype,
                                     group_size=group_size, causal=causal, device=device)
        return (block_q, tile[1])

    def _resolve_split(self, kernel: str, candidates_fn, analytic_fn, make_run, *, d: int,
                       n: int, dtype: str, group_size: int,
                       device: str | torch.device) -> int:
        mode = tune_mode()
        if mode == "off":
            return min(DEFAULT_BLOCK, seq_bucket(n))
        if mode == "analytic":
            return analytic_fn(n)
        dev = resolve_device(device)
        tag = backend_tag(dev)
        memo_key = (mode, self.cache.path, kernel, d, seq_bucket(n), dtype, group_size, tag)
        if memo_key not in self._memo:
            n_meas = self._measure_seq(n, dev)
            key = cache_key(kernel, backend=tag, dtype=dtype, d=d, group_size=group_size,
                            n=n_meas, causal=False)
            entry = self._resolve_measured(kernel, key, candidates_fn(n_meas),
                                           min(DEFAULT_BLOCK, seq_bucket(n_meas)),
                                           lambda: make_run(n_meas, dev), dev, graph=True)
            self._memo[memo_key] = int(entry["best"])
        return self._memo[memo_key]

    def resolve_decode(self, *, d: int, n: int, dtype: str = "bfloat16", group_size: int = 1,
                       device: str | torch.device = "cuda", batch: int = 1,
                       heads: tuple[int, int] = (2, 1), lengths=None) -> int:
        """Split-K ``block_k`` of the decode kernel at cache capacity n.
        ``batch``, ``lengths`` (``sweep_lengths``) and ``heads`` (hq, hkv)
        shape the sweep's inputs only."""
        return self._resolve_split(
            "decode", decode_candidates, _analytic_decode,
            lambda n_meas, dev: _make_run_decode(
                n_meas, d, dtype, dev, group_size,
                sweep_lengths(n_meas, batch=batch, lengths=lengths), heads),
            d=d, n=n, dtype=dtype, group_size=group_size, device=device)

    def resolve_paged_decode(self, *, d: int, n: int, dtype: str = "bfloat16",
                             group_size: int = 1, device: str | torch.device = "cuda",
                             batch: int = 1, heads: tuple[int, int] = (2, 1),
                             lengths=None) -> int:
        """Pool block size of the paged decode kernel at a request capacity
        ``n``: also the allocator's granularity, so ``PagedServeEngine``
        resolves it once at construction, before its pools are shaped."""
        return self._resolve_split(
            "paged_decode", paged_block_candidates, _analytic_decode,
            lambda n_meas, dev: _make_run_paged_decode(
                n_meas, d, dtype, dev, group_size,
                sweep_lengths(n_meas, batch=batch, lengths=lengths), heads),
            d=d, n=n, dtype=dtype, group_size=group_size, device=device)

    def resolve(self, kind: str, *, d: int, n: int, dtype: str = "bfloat16",
                group_size: int = 1, causal: bool = False, bwd: bool = False,
                block_q: int | None = None,
                device: str | torch.device = "cuda") -> BlockSizes:
        """The ``BlockSizes`` of an implementation kind: "flash" (the
        kernel's compiled tiles), "distr" (the
        kernel: ``block_q`` through the mode unless pinned by ``block_q``,
        the KV tile compiled) or "xla_distr" (the plain impl, which has no
        KV tile: the static 128 is reported).  ``bwd=True`` also fills the
        backward kernels' tiles (training's warm-up)."""
        kw = dict(d=d, n=n, dtype=dtype, causal=causal, device=device)
        if kind == "flash":
            bs = BlockSizes.from_pair(*self.resolve_compiled("flash_fwd", **kw))
            if bwd:
                dq = self.resolve_compiled("flash_dq", **kw)
                dkv = self.resolve_compiled("flash_dkv", **kw)
                bs = bs.with_(block_q_dq=dq[0], block_k_dq=dq[1], block_q_dkv=dkv[0],
                              block_k_dkv=dkv[1])
            return bs
        if kind in ("distr", "xla_distr"):
            if block_q is None:
                block_q = self.resolve_distr(group_size=group_size, xla=kind == "xla_distr",
                                             **kw)
            if kind == "xla_distr":
                return BlockSizes.from_pair(block_q, DEFAULT_BLOCK)
            bs = BlockSizes.from_pair(block_q, compiled_tile("distr_fwd", d=d, dtype=dtype)[1])
            if bwd:
                dq = self.resolve_distr_bwd("distr_dq", block_q=block_q, group_size=group_size,
                                            **kw)
                dkv = self.resolve_distr_bwd("distr_dkv", block_q=block_q,
                                             group_size=group_size, **kw)
                bs = bs.with_(block_q_dq=dq[0], block_k_dq=dq[1], block_q_dkv=dkv[0],
                              block_k_dkv=dkv[1])
            return bs
        raise ValueError(f"unknown resolution kind {kind!r}")


# ---------------------------------------------------------------------------
# The process-wide tuner and the dispatch entry points
# ---------------------------------------------------------------------------

_AUTOTUNER: Autotuner | None = None


def get_autotuner() -> Autotuner:
    global _AUTOTUNER
    if _AUTOTUNER is None:
        _AUTOTUNER = Autotuner()
    return _AUTOTUNER


def reset_autotuner(tuner: Autotuner | None = None) -> None:
    """Swap or clear the process-wide tuner (tests inject fake timers)."""
    global _AUTOTUNER
    _AUTOTUNER = tuner


def resolve_block_sizes(kind: str, **kw) -> BlockSizes:
    return get_autotuner().resolve(kind, **kw)


def resolve_decode_block(**kw) -> int:
    return get_autotuner().resolve_decode(**kw)


def resolve_paged_decode_block(**kw) -> int:
    return get_autotuner().resolve_paged_decode(**kw)


def tuned_attention(cfg) -> bool:
    """Whether the model's attention has keys to resolve: not under the
    reference impl, MLA (plain PyTorch in both packages) or the SSM
    family."""
    return not (cfg.attention.impl == "reference" or cfg.use_mla or cfg.family == "ssm")


def _compute_dtype(cfg) -> str:
    return "bfloat16" if cfg.compute_dtype == "bfloat16" else "float32"


def _decode_group(cfg) -> int:
    """G* of the self cache a decode reads: the fused K̂ engages under
    ``distr_decode`` for the dense family only (``serve_step._resolve_perms``,
    ``serve/paged.py``), raw K (1) otherwise."""
    return (cfg.attention.distr.group_size
            if cfg.attention.distr_decode and cfg.family == "dense" else 1)


# The padded prompt lengths the engines prefill at (``serve.engine._bucket``).
PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def _prefill_buckets(max_len: int, buckets) -> list[int]:
    """The padded lengths a prefill of at most ``max_len`` tokens runs at."""
    return sorted({b for b in buckets if b <= max_len} | {max_len})


def warm_paged_engine(cfg, max_len: int, *, device: str | torch.device = "cuda",
                      batch: int = 1, dtype=torch.bfloat16, lengths=None, decode: bool = True,
                      mesh_prefill_buckets: bool = False) -> dict:
    """Resolve the keys a ``PagedServeEngine`` hits before it is built: with
    ``decode``, the paged decode pool block (pools of ``dtype``), which
    shapes the pools (measure-mode sweeps at ``batch`` requests of the
    config's heads, or ``lengths``); with ``mesh_prefill_buckets``, the
    whole-prompt ring prefill's attention at each bucket ≤ max_len (the
    mesh engine's ``prefill_mesh_run``).  Call the latter with the engine's
    mesh active (``launch.mesh.set_mesh``): ``api.resolve_attention_blocks``
    then keys a bucket the ring takes by the shard one rank streams.
    Measure-mode sweeps run here, once.  Returns {site: resolved} for
    logging."""
    from repro_torch.core import api
    from repro_torch.tune.cache import dtype_str

    out: dict = {}
    if not tuned_attention(cfg):
        return out
    if decode:
        out["paged_decode"] = get_autotuner().resolve_paged_decode(
            d=cfg.head_dim_, n=max_len, dtype=dtype_str(dtype), group_size=_decode_group(cfg),
            device=device, batch=batch, heads=(cfg.n_heads, cfg.n_kv_heads), lengths=lengths)
    if mesh_prefill_buckets:
        for b in _prefill_buckets(max_len, PREFILL_BUCKETS):
            out[f"mesh_prefill/{b}"] = api.resolve_attention_blocks(
                cfg.attention, d=cfg.head_dim_, n_q=b, n_k=b, dtype=_compute_dtype(cfg),
                causal=True, device=device)
    return out


def warm_decode(cfg, max_len: int, *, device: str | torch.device = "cuda", batch: int = 1,
                lengths=None) -> dict:
    """Resolve the decode split of every cache a decode step attends over:
    the self cache at its capacity ``max_len`` and an enc-dec model's cross
    cache at ``cross_len`` (``batch`` slots of the config's heads, or
    ``lengths`` for the self cache, shape the sweeps).  Returns {site:
    BlockSizes} for logging."""
    out: dict = {}
    if not tuned_attention(cfg):
        return out
    sites = {"decode": (max_len, _decode_group(cfg), lengths)}
    if cfg.family == "encdec":
        sites["decode/cross"] = (cfg.cross_len, 1, None)
    for site, (n, g, lens) in sites.items():
        bk = get_autotuner().resolve_decode(d=cfg.head_dim_, n=n, dtype=_compute_dtype(cfg),
                                            group_size=g, device=device, batch=batch,
                                            heads=(cfg.n_heads, cfg.n_kv_heads), lengths=lens)
        out[site] = BlockSizes(block_k_decode=bk, num_splits=-(-n // bk))
    return out


def warm_engine(cfg, max_len: int, *, device: str | torch.device = "cuda", batch: int = 1,
                lengths=None, buckets=PREFILL_BUCKETS) -> dict:
    """Resolve every block-size key a ``ServeEngine`` hits: the prefill
    attention at each bucket ≤ max_len and the decode split at the cache
    capacity (``warm_decode``), so under ``measure`` the sweeps run and
    persist here and no serving step or captured decode graph ever waits
    on one.  Forward keys only.  Returns {site: resolved} for logging."""
    from repro_torch.core import api

    out: dict = {}
    if not tuned_attention(cfg):
        return out
    for b in _prefill_buckets(max_len, buckets):
        out[f"prefill/{b}"] = api.resolve_attention_blocks(
            cfg.attention, d=cfg.head_dim_, n_q=b, n_k=b, dtype=_compute_dtype(cfg),
            causal=True, device=device)
    out.update(warm_decode(cfg, max_len, device=device, batch=batch, lengths=lengths))
    return out
