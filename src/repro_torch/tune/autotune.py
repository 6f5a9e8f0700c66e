"""The block-size autotuner (``repro.tune.autotune``), for the port's kernels.

Three modes resolve an "auto" (``None``) block size, chosen by the
``REPRO_TUNE`` environment variable:

  off       the static values: the decode split min(128, S), the paged
            pool's block 128, DistrAttention's block_q 128, xla_flash's
            128 × 128, and each attention kernel's static tile
            (``static_tile``).
  analytic  the paper's §3.3.1 rule on Hopper's shared memory
            (``core.block_size``), clamped to the sequence bucket: for a
            kernel the largest compiled tile the model admits; no
            measurement.
  measure   candidates ranked by that model, each timed on the live device
            (on the card the decode split and the paged block as CUDA
            graph replays, as the serving steps run them, and the
            attention tiles and block_q as eager calls, as a prefill or a
            training step runs them; the plain versions on the CPU), the
            pick cached in the persistent JSON cache.  The pick is the
            static value unless a candidate's median time beats it by more
            than the spread of either one's repeated timings.

The knobs swept are the ones the port's kernels take at run time: the
decode split ``block_k`` of ``ops.decode_attention`` (multiples of the
decode tile's 64-key K/V tile, ``csrc/decode_tc.cuh::DT_KEYS``), the paged
pool's block size, DistrAttention's ``block_q``, which is also the LSH
permutation granularity (multiples of ``kernels/distr_attention.py::
ROW_TILE``), and the tiles of the attention kernels: the flash forward's
(rows, keys), the DistrAttention forward's keys beside its block_q (the
pair key ``distr_fwd``), the flash backward's dq and dkv tiles, and the
DistrAttention backward's keys with block_q pinned (``distr_dq@l=…``,
``distr_dkv@l=…``).  A kernel takes only the tiles its sources compile
(``compiled_tiles``); a key with one such tile (the f32 FMA tiles) is
recorded with that one candidate and timed never.  The port's static tile
is 64 × 64 (dkv: 32 or 64 rows × 64 keys) where the reference's is 128 ×
128: a stated difference (``core/block_size.py`` ranks the tiles alike).

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
# The attention kernels' tunable tiles: (rows, keys) of each bf16
# tensor-core walk (flash: a CTA's query rows × a K/V tile's keys; dkv: a
# Q tile's rows × a CTA's keys), the grid the sources under kernels/csrc
# are templated over (``*_r<rows>.cu`` instantiate it at each head dim of
# ``kernels/build.HEAD_DIMS``).  DistrAttention's CTA rows stay fixed (64,
# dkv's Q tile ``_dkv_rows``): only its keys vary.
FLASH_ROWS, DKV_ROWS, TILE_KEYS = (64, 128), (32, 64), (64, 128)
# Tiles of the grid the sources do not compile, by (kernel, head dim,
# tile), with the reason (PERF.md §6 lists them): those that spill or
# need a stack frame under ``-Xptxas -v`` (every one at the cap of 255
# registers a thread).  Every tile of the grid fits
# the 232,448 bytes of shared memory a block may take.
DROPPED_TILES = {
    ("flash_fwd", 112, (64, 128)): "24 bytes spilled, 24-byte stack frame",
    ("distr_fwd", 112, (64, 128)): "24 bytes spilled (32 reloaded), 24-byte stack frame",
    ("flash_dq", 112, (64, 128)): "60 bytes spilled, 64-byte stack frame",
    ("flash_dq", 112, (128, 128)): "40 bytes spilled, 40-byte stack frame",
    ("flash_dq", 128, (64, 128)): "32 bytes spilled, 32-byte stack frame",
    ("distr_dq", 112, (64, 128)): "40 bytes spilled, 40-byte stack frame",
    ("distr_dq", 128, (64, 128)): "32 bytes spilled, 32-byte stack frame",
}
# The f32 FMA tiles (csrc/attention_tile.cuh, attention_bwd_tile.cuh):
# one each, never swept.
FMA_TILES = {"flash_fwd": (64, 32), "distr_fwd": (64, 32), "flash_dq": (64, 32),
             "distr_dq": (64, 32), "flash_dkv": (32, 64), "distr_dkv": (32, 64)}


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


def _dkv_rows(d: int) -> int:
    """dkv's static Q tile, and DistrAttention's dkv rows
    (``flash_bwd_tc.cuh::dkv_rows``)."""
    return 32 if d > 64 else 64


def tile_grid(kernel: str, *, d: int) -> list[tuple[int, int]]:
    """The bf16 tiles (rows, keys) a kernel's walk is templated over."""
    if kernel in ("flash_fwd", "flash_dq"):
        return [(r, k) for r in FLASH_ROWS for k in TILE_KEYS]
    if kernel == "flash_dkv":
        return [(r, k) for r in DKV_ROWS for k in TILE_KEYS]
    if kernel in ("distr_fwd", "distr_dq"):
        return [(ROW_TILE, k) for k in TILE_KEYS]
    if kernel == "distr_dkv":
        return [(_dkv_rows(d), k) for k in TILE_KEYS]
    raise ValueError(f"no tiles for {kernel!r}")


def compiled_tiles(kernel: str, *, d: int, dtype: str) -> list[tuple[int, int]]:
    """The tiles (rows, keys) of ``kernel`` that its sources compile at
    head dim ``d``: in bf16 the grid less ``DROPPED_TILES``, in f32 the FMA
    tile.  A wrapper takes these and no other."""
    if dtype != "bfloat16":
        if kernel not in FMA_TILES:
            raise ValueError(f"no tiles for {kernel!r}")
        return [FMA_TILES[kernel]]
    return [t for t in tile_grid(kernel, d=d) if (kernel, d, t) not in DROPPED_TILES]


def static_tile(kernel: str, *, d: int, dtype: str) -> tuple[int, int]:
    """The tile ``REPRO_TUNE=off`` runs, the one every kernel ran before
    the tiles were swept: bf16 64 × 64 (dkv ``_dkv_rows(d)`` × 64), f32 the
    FMA tile."""
    if dtype != "bfloat16":
        return compiled_tiles(kernel, d=d, dtype=dtype)[0]
    tile_grid(kernel, d=d)  # an unknown kernel raises
    return (_dkv_rows(d), 64) if kernel.endswith("dkv") else (64, 64)


def check_tile(kernel: str, tile: tuple, *, d: int, dtype: str) -> tuple[int, int]:
    """``tile`` (rows, keys), a None in it taking the static tile's value;
    raises ValueError for a tile the sources do not compile (nothing falls
    back to another)."""
    static = static_tile(kernel, d=d, dtype=dtype)
    tile = tuple(int(s if t is None else t) for t, s in zip(tile, static))
    if tile not in compiled_tiles(kernel, d=d, dtype=dtype):
        raise ValueError(f"{kernel}: tile {tile} is not compiled at d={d} {dtype}; the "
                         f"compiled tiles are {compiled_tiles(kernel, d=d, dtype=dtype)}")
    return tile


# ---------------------------------------------------------------------------
# Candidate spaces, pruned by the analytic model
# ---------------------------------------------------------------------------


def pair_candidates(d: int, *, n: int, group_size: int = 1, w: int = 2, ls=None, ms=None,
                    tiles=None, default=None) -> list[tuple[int, int]]:
    """Top-K (l, m) candidates: every tile that fits Hopper's shared memory
    (``enumerate_block_sizes``), clamped to the sequence bucket,
    deduplicated and ranked by the paper's objective (max l, then max m);
    ``default`` (the 128 × 128 one when None, clamped) always appended.
    ``ls`` and ``ms`` restrict l and m to those values, ``tiles`` the pair
    to those (a kernel's compiled tiles, which the bucket never clamps: it
    is at least 128)."""
    nb = min(seq_bucket(n), MAX_TILE)
    legal = enumerate_block_sizes(d, group_size=group_size, w=w)
    clamped = {(min(l, nb), min(m, nb)) for l, m, _ in legal
               if (ls is None or l in ls) and (ms is None or m in ms)
               and (tiles is None or (l, m) in tiles)}
    cands = sorted(clamped, key=lambda t: (-t[0], -t[1]))[:TOP_K]
    if default is None:
        default = (min(DEFAULT_BLOCK, nb), min(DEFAULT_BLOCK, nb))
    if default not in cands:
        cands.append(default)
    return cands


def _w(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def distr_pair_candidates(d: int, *, n: int, group_size: int,
                          dtype: str = "bfloat16") -> list[tuple[int, int]]:
    """DistrAttention forward (block_q, keys) candidates: block_q ROW_TILE
    times a power of two up to 1024, the keys a compiled key tile, each
    pair fitting the model; ranked by the paper's max-l rule, clamped to
    the bucket; the static (128, static keys) always among them."""
    keys = {m for _, m in compiled_tiles("distr_fwd", d=d, dtype=dtype)}
    ls = tuple(ROW_TILE << i for i in range(5))
    nb = seq_bucket(n)
    default = (min(DEFAULT_BLOCK, nb), static_tile("distr_fwd", d=d, dtype=dtype)[1])
    return pair_candidates(d, n=n, group_size=group_size, w=_w(dtype), ls=ls, ms=keys,
                           default=default)


def distr_candidates(d: int, *, n: int, group_size: int, dtype: str = "bfloat16") -> list[int]:
    """DistrAttention ``block_q`` candidates: the block_q axis of
    ``distr_pair_candidates``, largest first; 128 always among them."""
    pairs = distr_pair_candidates(d, n=n, group_size=group_size, dtype=dtype)
    return sorted({l for l, _ in pairs}, reverse=True)


def kernel_pair_candidates(kernel: str, *, d: int, n: int, dtype: str = "bfloat16",
                           group_size: int = 1) -> list[tuple[int, int]]:
    """The (rows, keys) candidates of a flash kernel's key (``flash_fwd``,
    ``flash_dq``, ``flash_dkv``): its compiled tiles that fit the model,
    ranked by it (max rows, then max keys), the static tile always among
    them."""
    return pair_candidates(d, n=n, group_size=group_size, w=_w(dtype),
                           tiles=compiled_tiles(kernel, d=d, dtype=dtype),
                           default=static_tile(kernel, d=d, dtype=dtype))


def distr_bwd_candidates(kernel: str, *, d: int, n: int, group_size: int,
                         dtype: str = "bfloat16") -> list[int]:
    """Keys candidates of a DistrAttention backward kernel (``distr_dq`` |
    ``distr_dkv``), whose block_q stays pinned (it is the LSH grouping
    granularity, never swept): the compiled key tiles that fit the model,
    largest first, the static keys always among them.  The reference asks
    the model at l = block_q, its kernels' row tile; the port's rows are
    the kernel's own (64, dkv's Q tile), whatever block_q is, so the model
    is asked at those."""
    rows, default = static_tile(kernel, d=d, dtype=dtype)
    keys = {m for _, m in compiled_tiles(kernel, d=d, dtype=dtype)}
    legal = enumerate_block_sizes(d, group_size=group_size, w=_w(dtype))
    nb = seq_bucket(n)
    ms = sorted({min(m, nb) for l, m, _ in legal if l == rows and m in keys},
                reverse=True)[:TOP_K]
    if default not in ms:
        ms.append(default)
    return ms


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


def _static_pair(kernel: str, *, d: int, n: int, dtype: str) -> tuple[int, int]:
    """A pair key's static value: what ``off`` resolves it to, and what a
    sweep keeps unless a candidate clearly beats it."""
    nb = seq_bucket(n)
    if kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
        return static_tile(kernel, d=d, dtype=dtype)
    if kernel == "distr_fwd":
        return (min(DEFAULT_BLOCK, nb), static_tile(kernel, d=d, dtype=dtype)[1])
    if kernel in ("xla_flash", "xla_distr"):
        return (min(DEFAULT_BLOCK, nb), DEFAULT_BLOCK if kernel == "xla_distr"
                else min(DEFAULT_BLOCK, nb))
    raise ValueError(f"unknown pair kernel {kernel!r}")


def _pair_candidates(kernel: str, *, d: int, n: int, dtype: str,
                     group_size: int) -> list[tuple[int, int]]:
    """The candidates of a pair key, ranked by the model."""
    if kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
        return kernel_pair_candidates(kernel, d=d, n=n, dtype=dtype)
    if kernel == "distr_fwd":
        return distr_pair_candidates(d, n=n, group_size=group_size, dtype=dtype)
    if kernel == "xla_distr":  # the plain impl has no KV tile: block_q alone
        return [(l, DEFAULT_BLOCK) for l in
                distr_candidates(d, n=n, group_size=group_size, dtype=dtype)]
    return pair_candidates(d, n=n, group_size=group_size, w=_w(dtype))


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


def _qkv(n, d, dtype, device, heads):
    hq, hkv = heads
    gen = torch.Generator(device=device).manual_seed(0)
    return (_randn(gen, (1, hq, n, d), dtype, device), _randn(gen, (1, hkv, n, d), dtype, device),
            _randn(gen, (1, hkv, n, d), dtype, device))


def _make_run_flash_fwd(n, d, dtype, causal, device, heads=(1, 1)):
    from repro_torch.kernels import ops

    q, k, v = _qkv(n, d, dtype, device, heads)

    def make_run(cand):
        bq, bk = cand
        return lambda: ops.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)

    return make_run


def _make_run_xla_flash(n, d, dtype, causal, device, heads=(1, 1)):
    from repro_torch.core.flash_reference import blockwise_flash_reference

    q, k, v = _qkv(n, d, dtype, device, heads)

    def make_run(cand):
        bq, bk = cand
        return lambda: blockwise_flash_reference(q, k, v, block_q=bq, block_k=bk, causal=causal)

    return make_run


def _make_run_distr(n, d, dtype, causal, device, group_size, *, xla: bool, heads=(1, 1)):
    """(block_q, keys) pairs; the plain impl (``xla``) has no KV tile and
    takes block_q alone."""
    from dataclasses import replace

    from repro_torch.core.distr_attention import DistrConfig, distr_attention
    from repro_torch.kernels import ops

    q, k, v = _qkv(n, d, dtype, device, heads)
    base = DistrConfig(group_size=group_size)
    fn = distr_attention if xla else ops.distr_attention

    def make_run(cand):
        bq, bk = cand
        cfg = replace(base, block_q=int(bq), block_k=None if xla else int(bk))
        return lambda: fn(q, k, v, cfg, causal=causal)

    return make_run


def _flash_bwd_inputs(n, d, dtype, causal, device, heads):
    """The dq and dkv sweeps' residuals: one forward kernel call at the
    static tile gives O and the LSE, the delta kernel D (the reference's
    ``_flash_bwd_inputs``).  Flattened to the kernels' (B·H, N, d)."""
    from repro_torch.kernels import backward as bwd
    from repro_torch.kernels.flash_attention import flash_attention_kernel_call

    hq, hkv = heads
    q, k, v = (x[0] for x in _qkv(n, d, dtype, device, heads))
    scale = 1.0 / d ** 0.5
    o, lse = flash_attention_kernel_call(q, k, v, q_per_kv=hq // hkv, scale=scale,
                                         causal=causal, kv_len=n, return_lse=True)
    do = _randn(torch.Generator(device=device).manual_seed(7), o.shape, dtype, device)
    return q, k, v, do, lse, bwd.delta_kernel_call(o, do), scale


def _make_run_flash_bwd(n, d, dtype, causal, device, *, which: str, heads=(1, 1)):
    from repro_torch.kernels import backward as bwd

    q, k, v, do, lse, delta, scale = _flash_bwd_inputs(n, d, dtype, causal, device, heads)
    call = bwd.flash_dq_kernel_call if which == "dq" else bwd.flash_dkv_kernel_call
    kw = dict(q_per_kv=heads[0] // heads[1], scale=scale, causal=causal, kv_len=n)

    def make_run(cand):
        bq, bk = cand
        return lambda: call(q, k, v, do, lse, delta, block_q=bq, block_k=bk, **kw)

    return make_run


def _make_run_distr_bwd(n, d, dtype, causal, device, group_size, block_q, *, which: str,
                        heads=(1, 1)):
    """The DistrAttention backward's sweep: one forward at the pinned
    block_q and the static keys gives O, the LSE, Q̂ and the permutations;
    only the keys vary."""
    from repro_torch.core.distr_attention import DistrConfig
    from repro_torch.kernels import backward as bwd
    from repro_torch.kernels import ops

    hq, hkv = heads
    q, k, v = _qkv(n, d, dtype, device, heads)
    cfg = DistrConfig(group_size=group_size, block_q=min(block_q, n),
                      block_k=static_tile("distr_fwd", d=d, dtype=dtype)[1])
    out, lse, q_hat, perms = ops._distr_fwd(q, k, v, cfg, causal, 1.0 / d ** 0.5, None, True)
    o = out[0]
    do = _randn(torch.Generator(device=device).manual_seed(7), o.shape, dtype, device)
    delta = bwd.delta_kernel_call(o, do)
    perm_f = perms.reshape(hq, -1, d)
    call = bwd.distr_dq_kernel_call if which == "dq" else bwd.distr_dkv_kernel_call
    kw = dict(q_per_kv=hq // hkv, causal=causal, group_size=group_size, block_q=cfg.block_q,
              kv_len=n)

    def make_run(cand):
        return lambda: call(q_hat, k[0], v[0], perm_f, do, lse, delta, block_k=int(cand), **kw)

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
        (``pick``).  A key with one candidate (an f32 kernel's one tile)
        is recorded with it and timed never."""
        entry = self.cache.get(key)
        if entry is not None:
            return entry
        if len(candidates) == 1:
            only = _jsonable(candidates[0])
            get_recorder().instant("tune/pick", kernel=kernel, best=only, seconds=None)
            entry = {"kernel": kernel, "best": only, "default": only, "calls": 0,
                     "table": [{"candidate": only, "seconds": None, "spread": None}]}
            self.cache.put(key, entry)
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

    def resolve_pair(self, kernel: str, *, d: int, n: int, dtype: str = "bfloat16",
                     group_size: int = 1, causal: bool = False,
                     device: str | torch.device = "cuda",
                     heads: tuple[int, int] = (1, 1)) -> tuple[int, int]:
        """(block_q, block_k) of one kernel key: ``flash_fwd``, ``flash_dq``,
        ``flash_dkv`` (a compiled tile, rows × keys), ``distr_fwd``
        (block_q × a compiled key tile), ``xla_flash`` (any tile of the
        plain blockwise path) or ``xla_distr`` (block_q; the plain impl's
        static 128 keys).  ``heads`` (hq, hkv) shapes a sweep's inputs
        only."""
        mode = tune_mode()
        if mode == "off":
            return _static_pair(kernel, d=d, n=n, dtype=dtype)
        if mode == "analytic":  # the largest tile the model admits: max l, then max m
            return _pair_candidates(kernel, d=d, n=n, dtype=dtype,
                                         group_size=group_size)[0]
        dev = resolve_device(device)
        tag = backend_tag(dev)
        memo_key = (mode, self.cache.path, kernel, d, seq_bucket(n), dtype, group_size,
                    causal, tag)
        if memo_key not in self._memo:
            n_meas = self._measure_seq(n, dev)
            cands = _pair_candidates(kernel, d=d, n=n_meas, dtype=dtype,
                                          group_size=group_size)
            key = cache_key(kernel, backend=tag, dtype=dtype, d=d, group_size=group_size,
                            n=n_meas, causal=causal)

            def runner():
                if kernel == "flash_fwd":
                    return _make_run_flash_fwd(n_meas, d, dtype, causal, dev, heads)
                if kernel == "xla_flash":
                    return _make_run_xla_flash(n_meas, d, dtype, causal, dev, heads)
                if kernel in ("flash_dq", "flash_dkv"):
                    return _make_run_flash_bwd(n_meas, d, dtype, causal, dev,
                                               which=kernel.split("_")[1], heads=heads)
                return _make_run_distr(n_meas, d, dtype, causal, dev, group_size,
                                       xla=kernel == "xla_distr", heads=heads)

            entry = self._resolve_measured(
                kernel, key, cands, _static_pair(kernel, d=d, n=n_meas, dtype=dtype),
                runner, dev)
            self._memo[memo_key] = tuple(int(x) for x in entry["best"])
        return self._memo[memo_key]

    def resolve_distr(self, *, d: int, n: int, dtype: str = "bfloat16", group_size: int = 2,
                      causal: bool = False, xla: bool = False,
                      device: str | torch.device = "cuda") -> int:
        """DistrAttention's ``block_q`` through the mode: the block_q of the
        pair key ``distr_fwd``, or ``xla_distr`` for the plain impl."""
        return self.resolve_pair("xla_distr" if xla else "distr_fwd", d=d, n=n, dtype=dtype,
                                 group_size=group_size, causal=causal, device=device)[0]

    def resolve_distr_bwd(self, kernel: str, *, block_q: int, d: int, n: int,
                          dtype: str = "bfloat16", group_size: int = 2,
                          causal: bool = False, device: str | torch.device = "cuda",
                          fwd_block_k: int | None = None,
                          heads: tuple[int, int] = (1, 1)) -> tuple[int, int]:
        """(block_q, keys) of a DistrAttention backward kernel ("distr_dq"
        | "distr_dkv").  ``block_q`` is pinned by the caller (the LSH
        grouping granularity the forward's permutations were drawn at) and
        only the keys resolve: outside ``measure`` the forward's
        ``fwd_block_k`` where the kernel compiles it, else its static keys;
        under ``measure`` a sweep of its own, keyed ``{kernel}@l={block_q}``."""
        if kernel not in ("distr_dq", "distr_dkv"):
            raise ValueError(f"unknown distr bwd kernel {kernel!r}")
        rows, static_keys = static_tile(kernel, d=d, dtype=dtype)
        mode = tune_mode()
        if mode != "measure":
            compiled = (rows, fwd_block_k) in compiled_tiles(kernel, d=d, dtype=dtype)
            return (block_q, fwd_block_k if compiled else static_keys)
        dev = resolve_device(device)
        tag = backend_tag(dev)
        memo_key = (mode, self.cache.path, kernel, block_q, d, seq_bucket(n), dtype,
                    group_size, causal, tag)
        if memo_key not in self._memo:
            n_meas = self._measure_seq(n, dev)
            bq = min(block_q, n_meas)
            cands = distr_bwd_candidates(kernel, d=d, n=n_meas, group_size=group_size,
                                         dtype=dtype)
            # The grouping pin: the backward varies the keys only.  A pair
            # among the candidates or in the cache would change which
            # columns the saved permutations group.
            assert all(not isinstance(c, (tuple, list)) for c in cands), (
                "distr backward candidates must be key scalars; block_q is the LSH grouping "
                "granularity and stays pinned")
            key = cache_key(f"{kernel}@l={block_q}", backend=tag, dtype=dtype, d=d,
                            group_size=group_size, n=n_meas, causal=causal)
            entry = self._resolve_measured(
                kernel, key, cands, static_keys,
                lambda: _make_run_distr_bwd(n_meas, d, dtype, causal, dev, group_size, bq,
                                            which=kernel.split("_")[1], heads=heads),
                dev)
            assert not isinstance(entry["best"], (tuple, list)), (
                f"distr backward cache entry for {key!r} holds a pair: block_q must stay "
                "pinned to the LSH grouping granularity, only the keys are tuned")
            self._memo[memo_key] = (block_q, int(entry["best"]))
        return self._memo[memo_key]

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
                block_q: int | None = None, block_k: int | None = None,
                device: str | torch.device = "cuda",
                heads: tuple[int, int] = (1, 1)) -> BlockSizes:
        """The ``BlockSizes`` of an implementation kind: "flash" (the
        kernel's tile, key ``flash_fwd``), "xla_flash" (the plain blockwise
        path's), "distr" (the kernel's block_q and keys, key
        ``distr_fwd``) or "xla_distr" (the plain impl's block_q; it has no
        KV tile, so the static 128 is reported).  Explicit ``block_q`` /
        ``block_k`` win; a partial pin takes the static value for the free
        one; both None resolve through the mode.  ``bwd=True`` (training's
        warm-up) also fills the backward kernels' tiles the backward will
        run: under ``measure`` swept (the distr keys with block_q pinned),
        else the static tiles (distr: the forward's keys where compiled)."""
        kw = dict(d=d, n=n, dtype=dtype, causal=causal, device=device, heads=heads)
        kernel = {"flash": "flash_fwd", "xla_flash": "xla_flash", "distr": "distr_fwd",
                  "xla_distr": "xla_distr"}.get(kind)
        if kernel is None:
            raise ValueError(f"unknown resolution kind {kind!r}")
        if block_q is None and block_k is None:
            fwd = self.resolve_pair(kernel, group_size=group_size, **kw)
        else:
            static = _static_pair(kernel, d=d, n=n, dtype=dtype)
            fwd = (block_q or static[0], block_k or static[1])
        bs = BlockSizes.from_pair(*fwd)
        if not bwd or kind.startswith("xla"):
            return bs
        if kind == "flash":
            measure = tune_mode() == "measure"
            dq, dkv = ((self.resolve_pair(k, **kw) if measure
                        else static_tile(k, d=d, dtype=dtype)) for k in ("flash_dq", "flash_dkv"))
        else:
            dq, dkv = (self.resolve_distr_bwd(k, block_q=fwd[0], group_size=group_size,
                                              fwd_block_k=fwd[1], **kw)
                       for k in ("distr_dq", "distr_dkv"))
        return bs.with_(block_q_dq=dq[0], block_k_dq=dq[1], block_q_dkv=dkv[0],
                        block_k_dkv=dkv[1])


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
                causal=True, device=device, heads=(cfg.n_heads, cfg.n_kv_heads))
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
    on one: the flash forward's tile and DistrAttention's (block_q, keys)
    pair where the config leaves them free.  Forward keys only: a serving
    process never runs a backward.  Returns {site: resolved} for
    logging."""
    from repro_torch.core import api

    out: dict = {}
    if not tuned_attention(cfg):
        return out
    for b in _prefill_buckets(max_len, buckets):
        out[f"prefill/{b}"] = api.resolve_attention_blocks(
            cfg.attention, d=cfg.head_dim_, n_q=b, n_k=b, dtype=_compute_dtype(cfg),
            causal=True, device=device, heads=(cfg.n_heads, cfg.n_kv_heads))
    out.update(warm_decode(cfg, max_len, device=device, batch=batch, lengths=lengths))
    return out
