#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out PATH] [--only kernels]

In order: prints the card's name and power limit; builds the CUDA kernels
from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a; counts the bf16
flash forward's and backward's (dq, dkv), the bf16 DistrAttention
forward's and backward's (dq, dkv), the bf16 decode and paged decode
kernels' and the bf16 SSD kernel's tensor-core (HMMA),
ldmatrix (LDSM) and cp.async (LDGSTS) instructions in the library's SASS
and fails on a zero count or a register spill; checks that every
instantiation of the delta kernel loads 16-byte vectors (LDG.E.128) and
spills nothing; holds each kernel against
its plain PyTorch version in bf16 at the shapes of the serving path
(starcoder2-7b) and of the training path (minicpm-2b) — the forward
kernels with their LSE, DistrAttention also at G* = 4, the decode and
paged decode kernels, the five backward kernels at both, and delta also
at the training step's own call, head dim 112, a ragged row count and
f32 — and times
kernel, plain version and, as a yardstick only, one PyTorch library call,
each kernel against its bound, the package's count of the function's
least work (``kernels/ops.py::attention_work``, ``delta_work``,
``ssd_work``, ``roofline/analysis.py::decode_attention_work``) through
``obs/utilization.py::kernel_bound``, with the bound of the package's cost
model of the mechanism (``attention_cost``, ``ssd_cost``,
``decode_attention_cost``, ``paged_decode_attention_cost``) logged beside;
serves starcoder2-7b at full width with seeded random weights through
``repro_torch.launch.serve.run`` under ``pallas_distr`` and
``pallas_flash`` (6 requests on 4 slots, max_len 2048, 32 new tokens,
greedy); serves 8 requests with the same weights through
``PagedServeEngine`` (block pool, continuous-batching scheduler, chunked
prefill on the paged kernel): a raw-K pool, a fused-K̂ pool, a pool small
enough to preempt, and an overload that turns on the degradation dial;
serves the same prompts on the slot engine over the fused-K̂ cache
(``distr_decode``, G* = 2: the decode kernel at score width 64 in the
captured decode step); runs the chaos runs, 3 requests an engine on a
tick clock with one injected fault each (``serve/faults.py``: NaN logits,
a stuck step, a slow step against a deadline, a cancel, and on the paged
engine an exhausted pool and a failing restore), each held to its
terminal statuses, counters, pool and the other requests' tokens; the
trace runs: the serve workload again under a ``TraceRecorder`` on the slot
engine and on ``PagedServeEngine`` (raw-K), each trace and metrics
snapshot validated, one request span per request whose end args equal its
metrics row, one ``decode`` span a decode step, the wall split by span;
then trains minicpm-2b at its published size with seeded random f32 params
through ``repro_torch.launch.train.run`` under both impls (4 steps of
4 × 2048 tokens, full remat), and profiles one more step per impl for the
attention kernels' share; then the training robustness run: minicpm-2b at
full width cut to one layer through ``Trainer`` with verified checkpoints
in a temporary workdir, a loss spike (one rollback), a NaN step (one
skip) and a torn final save, and a second trainer that resumes past the
torn checkpoint.  The hybrid slice: the SSD kernel against its
plain version at zamba2-7b's shape (112 heads of 64, state 64, chunk 128;
N = 2048 and the ragged 600, B = 1 and 2) and mamba2-130m's (24 heads,
state 128), and ``ops.ssd`` (head flattening included) at the first; the
flash, DistrAttention (G* = 2) and decode kernels at zamba2-7b's head dim
112; and zamba2-7b served at full width (81 Mamba-2
layers, 2 shared attention blocks applied 13 times) through the same
launcher and slot engine under both impls.  The engines run their decode
steps as CUDA graphs (``serve/graphs.py``), whose replays add the launches
their capture counted; each kernel's launches are counted in the serve
and train runs, and each training impl prints its ``model_flops_share``
(6 · active params · tokens over the bf16 peak and the steady step).
Before the last three lines come
the ``[distr vs flash]`` lines: the DistrAttention forward beside the
flash forward at each of its four shapes, and the DistrAttention backward
kernels beside the flash ones at both backward shapes.  The line before
the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero; without CUDA, or outside a checkout, it
exits non-zero before any result.

``python3 chip_smoke.py --serve-load slot|hybrid|paged`` runs none of the
above: it serves one serve workload as a closed-loop load under both
impls, the slot workload also over the fused-K̂ cache (timed passes and
the device's busy share, ``serve_load``) and prints a JSON summary last.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import statistics
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Element-wise atol = rtol.  Flash and distr: the reference's bf16
# tolerances (O is rounded to bf16).  Decode, LSE, delta and the backward
# kernels: both sides compute in f32 from the same bf16 inputs and write
# f32, so they differ only in summation order and exp; set from the
# readings (PERF.md).
TOL = {"flash": 2e-2, "distr": 3e-2, "decode": 1e-4, "lse": 1e-4, "delta": 1e-4,
       "bwd": 1e-4}
PREFILL_NS = (600, 2048)
DECODE_LENGTHS = (1, 200, 1537, 2048)
SERVE_PROMPTS = (96, 200, 517, 1000, 1100, 1536)
# Attention shapes (B·Hq, Hkv, d, G*) at N = 2048, causal: the training
# path's (minicpm-2b, MHA, head dim 64) and a GQA one (starcoder2-7b).
TRAIN_SHAPE = (36, 36, 64, 2)
GQA_SHAPE = (36, 4, 128, 2)
TRAIN_N = 2048
TRAIN_BATCH, TRAIN_STEPS = 4, 4
# The paged kernel at the serving shape: 8 requests, 36 query heads over 4
# KV heads, head dim 128, 16 blocks of 128 per table; the last length
# overhangs the table as a padded chunk window does.
PAGED_LENGTHS = (1, 127, 128, 129, 1000, 1537, 2048, 2048 + 31)
PAGED_PROMPTS = (96, 200, 517, 1000, 1100, 1536, 1800, 2000)
PAGED_NEW = 32
# ``--serve-load``: the serve workloads' prompts LOAD_PASSES times over as
# a closed-loop stream, LOAD_NEW new tokens a request, LOAD_RUNS timed runs
# and a window of LOAD_PROFILE_STEPS engine steps under the profiler.  The
# paged engine's max_len holds the longest prompt and its new tokens (17
# blocks of 128).
LOAD_PASSES, LOAD_NEW, LOAD_RUNS, LOAD_PROFILE_STEPS = 2, 96, 3, 64
LOAD_PAGED_MAX_LEN = 2176
# The pressure run: the least pool the engine accepts (one whole request of
# 16 blocks plus the garbage block) and 40 new tokens.  The admission
# watermark keeps these prompts from ever preempting at 32 new tokens, at
# any pool size from 17 to 40 blocks (the scheduler run on the CPU with a
# fake engine); 40 is the fewest that make a decode grow into a full pool.
PRESSURE_BLOCKS, PRESSURE_NEW = 17, 40
# The chaos phase: 3 requests a run on the slot engine (4 slots) and the
# paged one (8 lanes), CHAOS_NEW new tokens, greedy, on a tick clock; the
# fault always on uid 1.  restore_failure runs in the 17-block pool with
# two 1000-token prompts: uid 0's decode grows into a full pool at its
# 25th token and preempts uid 1, the newest block holder (uid 2 waits
# behind it for a free block), whose restores then fail.
CHAOS_PROMPTS = (96, 200, 517)
CHAOS_PRESSURE_PROMPTS = (1000, 1000, 96)
CHAOS_NEW, CHAOS_CANCEL_STEP, CHAOS_MAX_STEPS = 32, 10, 400
# The training robustness phase: minicpm-2b at full width cut to one layer,
# f32, 1 x 2048 tokens a step, ROBUST_STEPS steps; faults: a loss spike on
# the 6th step's consult (rolled back to the step-0 baseline), a NaN on the
# 4th (skipped, then trimmed by the rollback) and a torn final save at step
# 8.  A checkpoint with AdamW's moments is 4.13 GB, and on the card a save
# took 19-29 s and a verified load 16-23 s (PERF.md sections 5 and 6), so the run
# keeps to the two saves the trainer makes anyway (the step-0 baseline and
# the final save): no periodic save falls inside it.
ROBUST_STEPS, ROBUST_CKPT_EVERY, ROBUST_SEQ = 8, 100, 2048
ROBUST_FAULTS = (dict(point="loss_spike", after=5), dict(point="nan_grad", after=3),
                 dict(point="ckpt_torn_write", uid=8))
# The SSD kernel: (label, B, H, P, G, S, chunk, N).  zamba2-7b's Mamba-2
# heads (the headline: B = 1, N = 2048), its ragged tail and B = 2, and
# mamba2-130m's state width 128.
SSD_SHAPES = (("zamba2-7b", 1, 112, 64, 1, 64, 128, 2048),
              ("zamba2-7b ragged", 1, 112, 64, 1, 64, 128, 600),
              ("zamba2-7b B=2", 2, 112, 64, 1, 64, 128, 2048),
              ("mamba2-130m", 1, 24, 64, 1, 128, 128, 2048))
# SSD tolerances, element-wise atol = rtol: y is bf16 on both sides (set
# from the readings, PERF.md); the state is f32 on both sides.
SSD_TOL = {"y": 2e-2, "state": 1e-3}
# zamba2-7b's shared attention blocks: 32 heads (MHA) of 112, G* = 2.
HYBRID_ATTN = (32, 32, 112, 2)
# Kernel names (C++ templates) that count as attention in the profile.
# Matched by substring, so each template is named whole.
ATTN_KERNEL_NAMES = ("attn_fwd_mma_kernel", "attn_fwd_kernel", "distr_fwd_exact_kernel",
                     "attn_bwd_dq_mma_kernel", "attn_bwd_dkv_mma_kernel", "attn_bwd_dq_kernel",
                     "attn_bwd_dkv_kernel", "distr_expand_q_kernel", "distr_bwd_dq_mma_kernel",
                     "distr_bwd_dkv_mma_kernel", "delta_kernel")
# The bf16 templates on the tensor cores and their instantiations (template
# arguments): the flash forward and backward (csrc/flash_fwd_tc.cuh,
# csrc/flash_bwd_tc.cuh), the DistrAttention forward (csrc/distr_fwd_tc.cuh)
# and backward (csrc/distr_bwd_tc.cuh) at each head dim, and the decode and paged decode
# kernels on the tile of csrc/decode_tc.cuh at each value width and number
# of warps that share an m-tile (4: one m-tile, 2: two, 1: more), and the
# SSD kernel (csrc/ssd_tc.cuh) at each P-slice width and k-steps of the
# state width (4: S ≤ 64, 8: S ≤ 128).  The SASS
# of every instantiation must hold tensor-core products (HMMA), ldmatrix
# (LDSM) and cp.async (LDGSTS).
TC_KERNELS = {"attn_fwd_mma_kernel": ((64,), (112,), (128,)),
              "distr_fwd_exact_kernel": ((64,), (112,), (128,)),
              "attn_bwd_dq_mma_kernel": ((64,), (128,)),
              "attn_bwd_dkv_mma_kernel": ((64,), (128,)),
              "distr_bwd_dq_mma_kernel": ((64,), (128,)),
              "distr_bwd_dkv_mma_kernel": ((64,), (128,)),
              "decode_mma_kernel": tuple((d, kw) for d in (64, 112, 128) for kw in (4, 2)),
              "paged_mma_kernel": tuple((d, kw) for d in (64, 112, 128) for kw in (4, 2, 1)),
              "ssd_mma_kernel": ((16, 4), (16, 8), (32, 4), (32, 8))}
TC_SASS_OPS = ("HMMA", "LDSM", "LDGSTS")
# The delta kernel's instantiations (csrc/delta.cu): dtype, lanes a row
# (8, 16, 32 by head dim) and row-steps a warp takes a pass (4 in bf16, 2
# in f32: the same bytes).
DELTA_INSTANCES = {f"delta_kernel<{t}, {lpr}, {u}>" for t, u in (("bf16", 4), ("f32", 2))
                   for lpr in (8, 16, 32)}
# Delta alone beyond the two backward shapes (label, B·Hq, N, d, dtype): the
# training step's own call (B = 4), zamba2-7b's head dim 112, a ragged row
# count (not a multiple of a warp's 16 rows) and f32.
DELTA_SHAPES = (("minicpm-2b train B=4", 4 * 36, 2048, 64, "bf16"),
                ("zamba2-7b d=112", 32, 2048, 112, "bf16"),
                ("ragged 36x601", 36, 601, 64, "bf16"),
                ("minicpm-2b f32", 36, 2048, 64, "f32"))
DELTA_ITERS = 50  # delta takes ~10 µs a call


def tc_smem_bytes(template: str, args: tuple) -> int:
    """Dynamic shared memory of a tensor-core instantiation: bf16 tiles with
    rows padded by 8 (the headers' smem_bytes functions); the decode tile's
    at a score width equal to its value width; the SSD kernel's at
    chunk 128 and the widest state its k-steps hold (64: zamba2-7b; 128:
    mamba2-130m)."""
    d = args[0]
    if template == "ssd_mma_kernel":  # 2 stages of b, c, x; H hi, lo; a; 8 warps' scans
        q, s = 128, 16 * args[1]
        return (2 * 2 * q * (s + 8) * 2 + 2 * q * (d + 8) * 2 + 2 * s * (d + 8) * 2
                + 2 * q * 4 + 8 * 2 * q * 4)
    row = (d + 8) * 2
    if template in ("attn_fwd_mma_kernel", "distr_fwd_exact_kernel"):  # Q, 2 stages of K and V
        return (64 + 4 * 64) * row
    if template in ("attn_bwd_dq_mma_kernel", "distr_bwd_dq_mma_kernel"):  # Q, dO, 2 stages of K, V
        return (2 * 64 + 4 * 64) * row
    if template in ("decode_mma_kernel", "paged_mma_kernel"):  # 2 stages of K, V and Q
        return 2 * (64 * 2 * row + 16 * (4 // args[1]) * row)
    rows = 32 if d > 64 else 64  # dkv: K, V, 2 stages of Q, dO, LSE, D
    return (2 * 64 + 4 * rows) * row + 4 * rows * 4


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_sass(build, templates, ops: dict) -> dict:
    """Every function of the built library whose name holds one of
    ``templates``: how many of its SASS lines (``cuobjdump -sass``) match
    each pattern of ``ops``, and its registers and spill bytes from nvcc's
    ``-Xptxas -v`` output."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(build.build())], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if any(name in fn for name in templates):
                found[fn] = dict.fromkeys(ops, 0)
        elif fn in found:
            for op, pattern in ops.items():
                found[fn][op] += bool(pattern.search(line))
    fn = None
    for line in build.build_log().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn in found and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            found[fn]["spill_bytes"] = nums[1] + nums[2]
        elif fn in found and "Used" in line and "registers" in line:
            found[fn]["registers"] = int(line.split("Used")[1].split()[0])
    return found


def tensor_core_check(build) -> dict:
    """Proof that the bf16 flash forward and backward, the bf16
    DistrAttention forward and backward, the bf16 decode and paged decode
    kernels and the bf16 SSD kernel run on the tensor cores: count each
    instantiation's HMMA, LDSM and LDGSTS instructions in the built
    library's SASS and read its registers and spills.  Raises if an
    instantiation is missing, lacks one of the three or spills."""
    found = kernel_sass(build, TC_KERNELS, {op: re.compile(rf" {op}[. ]") for op in TC_SASS_OPS})
    out = {}
    for fn, row in found.items():
        template = next(name for name in TC_KERNELS if name in fn)
        # Template arguments of the mangled name: I Li<n>E ... E.
        args = tuple(int(x) for x in re.findall(r"Li(\d+)E", fn.split(template, 1)[1]))
        key = f"{template}<{', '.join(map(str, args))}>"
        row.update(template=template, args=list(args),
                   dynamic_smem_bytes=tc_smem_bytes(template, args))
        log(f"[tensor cores] {key}: {row}")
        if any(row[op] == 0 for op in TC_SASS_OPS) or row.get("spill_bytes", 1) != 0:
            raise AssertionError(f"{fn}: no {TC_SASS_OPS} in its SASS, or spills: {row}")
        out[key] = row
    want = {f"{name}<{', '.join(map(str, args))}>" for name, inst in TC_KERNELS.items()
            for args in inst}
    if set(out) != want:
        raise AssertionError(f"expected the instantiations {sorted(want)} in the SASS, "
                             f"got {sorted(out)}")
    return out


def delta_sass_check(build) -> dict:
    """Every instantiation of the delta kernel (``csrc/delta.cu``) loads
    its rows as 16-byte vectors (``LDG.E.128``, whatever cache modifiers)
    and spills nothing.  Raises otherwise, or if one is missing."""
    found = kernel_sass(build, ("delta_kernel",),
                        {"LDG.E.128": re.compile(r" LDG\.E(?:\.\w+)*\.128\b")})
    out = {}
    for fn, row in found.items():
        m = re.search(r"delta_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E", fn)
        if m is None:
            raise AssertionError(f"unexpected delta kernel in the SASS: {fn}")
        dtype = "f32" if m.group(1) == "f" else "bf16"
        key = f"delta_kernel<{dtype}, {m.group(2)}, {m.group(3)}>"
        log(f"[delta sass] {key}: {row}")
        if row["LDG.E.128"] == 0 or row.get("spill_bytes", 1) != 0:
            raise AssertionError(f"{fn}: no LDG.E.128 in its SASS, or spills: {row}")
        out[key] = row
    if set(out) != DELTA_INSTANCES:
        raise AssertionError(f"expected the delta instantiations {sorted(DELTA_INSTANCES)}, "
                             f"got {sorted(out)}")
    return out


def time_ms(torch, fn, iters: int, flush: "torch.Tensor") -> float:
    """Mean ms per call over ``iters`` calls, each timed with CUDA events
    after writing a 256 MiB buffer, so every call finds the 50 MB L2 cold
    as a serving step's layer does.  A ~1 ms device sleep before the start
    event keeps the card busy while the host enqueues the call, so the
    wrapper's host-side latency does not count as kernel time."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def roofline(work: dict, ms: float, model: dict | None = None) -> dict:
    """A kernel row's bound: ``obs.utilization.kernel_bound`` over the
    package's count of the function's least work (a ``*_work`` function),
    that is the least time the card could take, what bounds it, and the
    share of it achieved in ``ms``.  ``model_bound_ms``, logged beside it,
    is the bound of the package's cost model of the mechanism
    (``attention_cost``, ``decode_attention_cost``,
    ``paged_decode_attention_cost``, ``ssd_cost``) through
    ``utilization_columns``: those count work the function does not need
    (whole diagonal blocks, K/V a query head, split partials), so they
    are no kernel's bound."""
    from repro_torch.obs.utilization import kernel_bound, utilization_columns

    row = kernel_bound(work, ms)
    if model is not None:
        row["model_bound_ms"] = utilization_columns(model, ms * 1e3)["roofline_lower_bound_us"] / 1e3
    return row


def summed(costs) -> dict:
    """One cost dict of several calls' (the per-request decode costs of a
    ragged batch: every term is linear in the batch)."""
    costs = list(costs)
    return {k: sum(c[k] for c in costs) for k in ("total_flops", "hbm_bytes")}


def check_close(torch, name, got, want, tol) -> float:
    """Element by element, |got - want| <= tol + tol·|want|, and all finite.
    Returns the largest |got - want|; logs the largest error as a share of
    its element's allowance."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=tol, rtol=tol, msg=lambda m: f"{name}: {m}")
    share = float(((got - want).abs() / (tol + tol * want.abs())).max())
    log(f"  {name}: largest error is {share:.3g} of its element's allowance (tol {tol}); "
        f"largest |want| {float(want.abs().max()):.3g}")
    return max_err(torch, got, want)


def prefill_phase(torch, flush) -> dict:
    """Flash and DistrAttention kernels at the prefill shapes of
    starcoder2-7b: B·Hq = 36, Hkv = 4, d = 128, G* = 2, causal, bf16."""
    import torch.nn.functional as F

    from repro_torch.core.distr_attention import DistrConfig
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import attention_cost, attention_work

    hq, hkv, d, g = 36, 4, 128, 2
    dcfg = DistrConfig(group_size=g, block_q=128)
    scale = d ** -0.5
    out = {"flash": {"max_abs_err": 0.0}, "distr": {"max_abs_err": 0.0}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in PREFILL_NS:
        q = torch.randn((1, hq, n, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((1, hkv, n, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((1, hkv, n, d), generator=gen, device="cuda").to(torch.bfloat16)
        qf, kf, vf = q[0].contiguous(), k[0].contiguous(), v[0].contiguous()
        kw = dict(q_per_kv=hq // hkv, scale=scale, causal=True, kv_len=n)
        got = fk.flash_attention_kernel_call(qf, kf, vf, **kw)
        want = fk.flash_attention_plain(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        err_f = check_close(torch, f"flash N={n}", got, want, TOL["flash"])

        qp = ops.pad_to_multiple(q, dcfg.block_q, dim=2)
        q_hat, perms = ops.distr_stage1(dcfg, qp, scale, hkv=hkv)
        q_hat = q_hat[0].contiguous()
        perm = perms[0].to(torch.int32).contiguous()
        dkw = dict(q_per_kv=hq // hkv, causal=True, group_size=g,
                   block_q=dcfg.block_q, kv_len=n)
        got_d = dk.distr_attention_kernel_call(q_hat, kf, vf, perm, **dkw)
        want_d = dk.distr_attention_plain(q_hat, kf, vf, perm, **dkw)
        torch.cuda.synchronize()
        err_d = check_close(torch, f"distr N={n}", got_d, want_d, TOL["distr"])
        out["flash"]["max_abs_err"] = max(out["flash"]["max_abs_err"], err_f)
        out["distr"]["max_abs_err"] = max(out["distr"]["max_abs_err"], err_d)

        # Timings: kernel, plain version, and SDPA as a yardstick (K/V
        # expanded to the query heads outside the timed call).
        kx = k.repeat_interleave(hq // hkv, dim=1)
        vx = v.repeat_interleave(hq // hkv, dim=1)
        t = {
            "flash_ms": time_ms(torch, lambda: fk.flash_attention_kernel_call(qf, kf, vf, **kw), 10, flush),
            "flash_plain_ms": time_ms(torch, lambda: fk.flash_attention_plain(qf, kf, vf, **kw), 3, flush),
            "sdpa_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True), 10, flush),
            "distr_ms": time_ms(torch, lambda: dk.distr_attention_kernel_call(q_hat, kf, vf, perm, **dkw), 10, flush),
            "distr_plain_ms": time_ms(torch, lambda: dk.distr_attention_plain(q_hat, kf, vf, perm, **dkw), 3, flush),
        }
        dist = dict(group_size=g, block_q=dcfg.block_q)
        bounds = {
            "flash": roofline(attention_work(1, hq, hkv, n, n, d, causal=True)["fwd"],
                              t["flash_ms"], attention_cost(1, hq, n, n, d, causal=True)),
            "distr": roofline(attention_work(1, hq, hkv, n, n, d, causal=True, **dist)["fwd"],
                              t["distr_ms"], attention_cost(1, hq, n, n, d, causal=True, **dist)),
        }
        log(f"[prefill N={n}] flash err {err_f:.3e} {t['flash_ms']:.3f} ms "
            f"(plain {t['flash_plain_ms']:.3f}, sdpa {t['sdpa_ms']:.3f}, bound "
            f"{bounds['flash']['bound_ms']:.4f}, {bounds['flash']['utilization']:.1%} of it; "
            f"model {bounds['flash']['model_bound_ms']:.4f}) | distr err {err_d:.3e} "
            f"{t['distr_ms']:.3f} ms (plain {t['distr_plain_ms']:.3f}, bound "
            f"{bounds['distr']['bound_ms']:.4f}, {bounds['distr']['utilization']:.1%} of it; "
            f"model {bounds['distr']['model_bound_ms']:.4f})")
        out.setdefault("shapes", []).append(
            {"n": n, **t, **{f"{k}_{c}": bounds[k][c] for k in bounds
                             for c in ("bound_ms", "model_bound_ms")}})
        if n == max(PREFILL_NS):  # the headline shape of the JSON line
            out["flash"].update(ms=t["flash_ms"], plain_ms=t["flash_plain_ms"],
                                library_ms=t["sdpa_ms"], **bounds["flash"])
            out["distr"].update(ms=t["distr_ms"], plain_ms=t["distr_plain_ms"],
                                library_ms=None, **bounds["distr"])
    out["shapes"].append(train_shape_forward(torch, flush, out))
    return out


def train_shape_forward(torch, flush, out: dict) -> dict:
    """Both forward kernels at the training path's shape (minicpm-2b:
    B·Hq = 36, MHA, d = 64, G* = 2, N = 2048, causal, bf16) with the LSE
    the backward reads; O and LSE held against the plain versions."""
    import torch.nn.functional as F

    from repro_torch.core.distr_attention import DistrConfig
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import attention_cost, attention_work

    hq, hkv, d, g = TRAIN_SHAPE
    n = TRAIN_N
    dcfg = DistrConfig(group_size=g, block_q=128)
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((1, h, n, d), generator=gen, device="cuda").to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    qf, kf, vf = q[0].contiguous(), k[0].contiguous(), v[0].contiguous()
    kw = dict(q_per_kv=hq // hkv, scale=d ** -0.5, causal=True, kv_len=n, return_lse=True)
    o, lse = fk.flash_attention_kernel_call(qf, kf, vf, **kw)
    o_p, lse_p = fk.flash_attention_plain(qf, kf, vf, **kw)
    torch.cuda.synchronize()
    err_f = check_close(torch, "flash d=64 O", o, o_p, TOL["flash"])
    check_close(torch, "flash d=64 LSE", lse, lse_p, TOL["lse"])
    q_hat, perms = ops.distr_stage1(dcfg, q, d ** -0.5, hkv=hkv)
    q_hat, perm = q_hat[0].contiguous(), perms[0].to(torch.int32).contiguous()
    dkw = dict(q_per_kv=hq // hkv, causal=True, group_size=g, block_q=dcfg.block_q,
               kv_len=n, return_lse=True)
    od, lsed = dk.distr_attention_kernel_call(q_hat, kf, vf, perm, **dkw)
    od_p, lsed_p = dk.distr_attention_plain(q_hat, kf, vf, perm, **dkw)
    torch.cuda.synchronize()
    err_d = check_close(torch, "distr d=64 O", od, od_p, TOL["distr"])
    check_close(torch, "distr d=64 LSE", lsed, lsed_p, TOL["lse"])
    out["flash"]["max_abs_err"] = max(out["flash"]["max_abs_err"], err_f)
    out["distr"]["max_abs_err"] = max(out["distr"]["max_abs_err"], err_d)
    t = {
        "flash_ms": time_ms(torch, lambda: fk.flash_attention_kernel_call(qf, kf, vf, **kw), 10, flush),
        "flash_plain_ms": time_ms(torch, lambda: fk.flash_attention_plain(qf, kf, vf, **kw), 3, flush),
        "sdpa_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 10, flush),
        "distr_ms": time_ms(torch, lambda: dk.distr_attention_kernel_call(q_hat, kf, vf, perm, **dkw), 10, flush),
        "distr_plain_ms": time_ms(torch, lambda: dk.distr_attention_plain(q_hat, kf, vf, perm, **dkw), 3, flush),
    }
    dist = dict(group_size=g, block_q=dcfg.block_q)
    f_bound = roofline(attention_work(1, hq, hkv, n, n, d, causal=True, lse=True)["fwd"],
                       t["flash_ms"], attention_cost(1, hq, n, n, d, causal=True))
    d_bound = roofline(attention_work(1, hq, hkv, n, n, d, causal=True, lse=True, **dist)["fwd"],
                       t["distr_ms"], attention_cost(1, hq, n, n, d, causal=True, **dist))
    log(f"[prefill train shape d=64 N={n}, with LSE] flash {t['flash_ms']:.3f} ms (plain "
        f"{t['flash_plain_ms']:.3f}, sdpa {t['sdpa_ms']:.3f}, bound {f_bound['bound_ms']:.4f}, "
        f"model {f_bound['model_bound_ms']:.4f}) | distr {t['distr_ms']:.3f} ms (plain "
        f"{t['distr_plain_ms']:.3f}, bound {d_bound['bound_ms']:.4f}, model "
        f"{d_bound['model_bound_ms']:.4f})")
    return {"n": n, "d": d, "hkv": hkv, **t, "flash_bound_ms": f_bound["bound_ms"],
            "distr_bound_ms": d_bound["bound_ms"], "flash_model_bound_ms": f_bound["model_bound_ms"],
            "distr_model_bound_ms": d_bound["model_bound_ms"]}


def backward_phase(torch, flush) -> dict:
    """The five backward kernels at the training shape (minicpm-2b) and at
    a GQA shape (starcoder2-7b), N = 2048, causal, bf16: each held element
    by element against its plain version on the same inputs (the forward
    kernels' O and LSE), timed beside it, with its bound.  The yardstick
    for flash dq and dkv is one backward of SDPA (dQ, dK, dV together),
    split between the two in proportion to their products (3 : 4); delta's
    is ``torch.linalg.vecdot``, which reads the same bytes but writes bf16.
    Delta is then held and timed alone at ``DELTA_SHAPES``."""
    import torch.nn.functional as F

    from repro_torch.core.distr_attention import DistrConfig
    from repro_torch.kernels import backward as bwd
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import attention_work, delta_work

    names = ("delta", "flash_dq", "flash_dkv", "distr_dq", "distr_dkv")
    out = {name: {"max_abs_err": 0.0} for name in names}
    shapes = []
    n = TRAIN_N
    for label, (hq, hkv, d, g) in (("minicpm-2b", TRAIN_SHAPE), ("starcoder2-7b", GQA_SHAPE)):
        gen = torch.Generator(device="cuda").manual_seed(3)
        q, k, v, do = (torch.randn((1, h, n, d), generator=gen, device="cuda").to(torch.bfloat16)
                       for h in (hq, hkv, hkv, hq))
        qf, kf, vf, dof = (x[0].contiguous() for x in (q, k, v, do))
        scale = d ** -0.5
        r = hq // hkv
        fkw = dict(q_per_kv=r, scale=scale, causal=True, kv_len=n)
        o, lse = fk.flash_attention_kernel_call(qf, kf, vf, return_lse=True, **fkw)
        dcfg = DistrConfig(group_size=g, block_q=128)
        q_hat, perms = ops.distr_stage1(dcfg, q, scale, hkv=hkv)
        q_hat, perm = q_hat[0].contiguous(), perms[0].to(torch.int32).contiguous()
        dkw = dict(q_per_kv=r, causal=True, group_size=g, block_q=dcfg.block_q, kv_len=n)
        od, lsed = dk.distr_attention_kernel_call(q_hat, kf, vf, perm, return_lse=True, **dkw)
        delta = bwd.delta_plain(o, dof)
        deltad = bwd.delta_plain(od, dof)
        calls = {
            "delta": (lambda: bwd.delta_kernel_call(o, dof), lambda: bwd.delta_plain(o, dof)),
            "flash_dq": (lambda: bwd.flash_dq_kernel_call(qf, kf, vf, dof, lse, delta, **fkw),
                         lambda: bwd.flash_dq_plain(qf, kf, vf, dof, lse, delta, **fkw)),
            "flash_dkv": (lambda: bwd.flash_dkv_kernel_call(qf, kf, vf, dof, lse, delta, **fkw),
                          lambda: bwd.flash_dkv_plain(qf, kf, vf, dof, lse, delta, **fkw)),
            "distr_dq": (lambda: bwd.distr_dq_kernel_call(q_hat, kf, vf, perm, dof, lsed, deltad, **dkw),
                         lambda: bwd.distr_dq_plain(q_hat, kf, vf, perm, dof, lsed, deltad, **dkw)),
            "distr_dkv": (lambda: bwd.distr_dkv_kernel_call(q_hat, kf, vf, perm, dof, lsed, deltad, **dkw),
                          lambda: bwd.distr_dkv_plain(q_hat, kf, vf, perm, dof, lsed, deltad, **dkw)),
        }
        flash_w = attention_work(1, hq, hkv, n, n, d, causal=True)
        distr_w = attention_work(1, hq, hkv, n, n, d, causal=True, group_size=g,
                                 block_q=dcfg.block_q)
        work = {"delta": delta_work(hq * n, d, 2),
                **{f"flash_{k}": flash_w[k] for k in ("dq", "dkv")},
                **{f"distr_{k}": distr_w[k] for k in ("dq", "dkv")}}
        row = {"shape": label, "bhq": hq, "hkv": hkv, "d": d, "group_size": g, "n": n}
        for name in names:
            kern, plain = calls[name]
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            tol = TOL["delta"] if name == "delta" else TOL["bwd"]
            err = max(check_close(torch, f"{name} {label}{' d' + 'kv'[i] if len(got) > 1 else ''}",
                                  a, b, tol) for i, (a, b) in enumerate(zip(got, want)))
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            del got, want
            ms = time_ms(torch, kern, DELTA_ITERS if name == "delta" else 10, flush)
            plain_ms = time_ms(torch, plain, 3, flush)
            row[name] = {"ms": ms, "plain_ms": plain_ms, **roofline(work[name], ms),
                         "max_abs_err": err}
            log(f"[backward {label}] {name}: {ms:.3f} ms (plain {plain_ms:.3f}, bound "
                f"{row[name]['bound_ms']:.4f} by {row[name]['bound_by']}) err {err:.3e}")
        row["delta"]["library_ms"] = time_ms(torch, lambda: torch.linalg.vecdot(o, dof),
                                             DELTA_ITERS, flush)
        log(f"[backward {label}] delta's yardstick torch.linalg.vecdot (same bytes read, "
            f"bf16 out): {row['delta']['library_ms']:.4f} ms")
        log(f"[distr vs flash] backward {label}: distr dq {row['distr_dq']['ms']:.4f} / dkv "
            f"{row['distr_dkv']['ms']:.4f} ms, flash dq {row['flash_dq']['ms']:.4f} / dkv "
            f"{row['flash_dkv']['ms']:.4f} ms")
        # SDPA's backward as the yardstick of flash dq + dkv (K/V expanded
        # to the query heads outside the timed call, as ours are per head).
        qg = q.detach().requires_grad_(True)
        kx = k.repeat_interleave(r, dim=1).requires_grad_(True)
        vx = v.repeat_interleave(r, dim=1).requires_grad_(True)
        sdpa_out = F.scaled_dot_product_attention(qg, kx, vx, is_causal=True)
        sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qg, kx, vx), do, retain_graph=True), 10, flush)
        row["sdpa_bwd_ms"] = sdpa_bwd
        row["flash_dq"]["library_ms"] = sdpa_bwd * 3 / 7
        row["flash_dkv"]["library_ms"] = sdpa_bwd * 4 / 7
        log(f"[backward {label}] SDPA backward {sdpa_bwd:.3f} ms (dq {sdpa_bwd * 3 / 7:.3f}, "
            f"dkv {sdpa_bwd * 4 / 7:.3f} by the 3 : 4 product split)")
        shapes.append(row)
        del sdpa_out, qg, kx, vx
    out["delta_shapes"] = []
    for label, bhq, n, d, dtype in DELTA_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(4)
        o, dof = (torch.randn((bhq, n, d), generator=gen, device="cuda").to(
            torch.bfloat16 if dtype == "bf16" else torch.float32) for _ in range(2))
        err = check_close(torch, f"delta {label}", bwd.delta_kernel_call(o, dof),
                          bwd.delta_plain(o, dof), TOL["delta"])
        out["delta"]["max_abs_err"] = max(out["delta"]["max_abs_err"], err)
        row = {"shape": label, "bhq": bhq, "n": n, "d": d, "dtype": dtype, "max_abs_err": err,
               "ms": time_ms(torch, lambda: bwd.delta_kernel_call(o, dof), DELTA_ITERS, flush),
               "plain_ms": time_ms(torch, lambda: bwd.delta_plain(o, dof), 3, flush),
               "library_ms": time_ms(torch, lambda: torch.linalg.vecdot(o, dof), DELTA_ITERS,
                                     flush)}
        row.update(roofline(delta_work(bhq * n, d, o.element_size()), row["ms"]))
        log(f"[backward delta {label}] {row['ms']:.4f} ms (plain {row['plain_ms']:.3f}, vecdot "
            f"{row['library_ms']:.4f}, bound {row['bound_ms']:.5f} by {row['bound_by']}) "
            f"err {err:.3e}")
        out["delta_shapes"].append(row)
        del o, dof
    headline = shapes[0]  # the training path's shape
    for name in names:
        h = headline[name]
        out[name].update(ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
                         bound_by=h["bound_by"], library_ms=h.get("library_ms"))
    out["shapes"] = shapes
    torch.cuda.empty_cache()
    return out


def decode_phase(torch, flush) -> dict:
    """The split-K decode kernel at the decode shape of starcoder2-7b:
    B = 4 slots, Hq = 36 over Hkv = 4, S = 2048, lengths {1, 200, 1537,
    2048}, q_len 1 and 2, score width 128 and 64 (fused K̂), bf16."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode as dec
    from repro_torch.kernels.ops import _pack_gqa_rows
    from repro_torch.roofline.analysis import decode_attention_cost, decode_attention_work

    b, hq, hkv, s, d, bk = 4, 36, 4, 2048, 128, 128
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"max_abs_err": 0.0}
    for q_len in (1, 2):
        for ds in (128, 64):
            q = torch.randn((b, hq, q_len, ds), generator=gen, device="cuda").to(torch.bfloat16)
            k = torch.randn((b, hkv, s, ds), generator=gen, device="cuda").to(torch.bfloat16)
            v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
            qp = _pack_gqa_rows(q, hkv)
            kw = dict(scale=d ** -0.5, block_k=bk, q_len=q_len)
            got = dec.merge_splits(*dec.decode_kernel_call(qp, k, v, lengths, **kw))
            want = dec.merge_splits(*dec.decode_plain(qp, k, v, lengths, **kw))
            torch.cuda.synchronize()
            err = check_close(torch, f"decode q_len={q_len} d_score={ds}", got, want, TOL["decode"])
            out["max_abs_err"] = max(out["max_abs_err"], err)
            log(f"[decode q_len={q_len} d_score={ds}] err {err:.3e}")
            if q_len == 1 and ds == d:  # the serving path's shape
                mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None])
                mask = mask[:, None, None, :]
                kx = k.repeat_interleave(hq // hkv, dim=1)
                vx = v.repeat_interleave(hq // hkv, dim=1)
                ms = time_ms(torch, lambda: dec.decode_kernel_call(qp, k, v, lengths, **kw), 20, flush)
                plain_ms = time_ms(torch, lambda: dec.decode_plain(qp, k, v, lengths, **kw), 5, flush)
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask), 20, flush)
                cost = summed(decode_attention_cost(1, hq, hkv, n, s, d, block_k=bk)
                              for n in DECODE_LENGTHS)
                out.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           **roofline(decode_attention_work(DECODE_LENGTHS, hq, hkv, d, s),
                                      ms, cost))
                log(f"[decode serve shape] {ms:.4f} ms (plain {plain_ms:.4f}, sdpa "
                    f"{lib_ms:.4f}, bound {out['bound_ms']:.4f}, model "
                    f"{out['model_bound_ms']:.4f})")
    return out


def distr_g4_phase(torch, flush) -> dict:
    """The DistrAttention forward kernel at G* = 4 (score width 32) at the
    starcoder2-7b prefill shape, N = 2048, causal, bf16: the degraded
    prefill's second level."""
    from repro_torch.core.distr_attention import DistrConfig
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import attention_cost, attention_work

    hq, hkv, d, g, n = 36, 4, 128, 4, max(PREFILL_NS)
    dcfg = DistrConfig(group_size=g, block_q=128)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((1, h, n, d), generator=gen, device="cuda").to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    kf, vf = k[0].contiguous(), v[0].contiguous()
    q_hat, perms = ops.distr_stage1(dcfg, q, d ** -0.5, hkv=hkv)
    q_hat, perm = q_hat[0].contiguous(), perms[0].to(torch.int32).contiguous()
    dkw = dict(q_per_kv=hq // hkv, causal=True, group_size=g, block_q=dcfg.block_q, kv_len=n)
    got = dk.distr_attention_kernel_call(q_hat, kf, vf, perm, **dkw)
    want = dk.distr_attention_plain(q_hat, kf, vf, perm, **dkw)
    torch.cuda.synchronize()
    err = check_close(torch, f"distr G*=4 N={n}", got, want, TOL["distr"])
    ms = time_ms(torch, lambda: dk.distr_attention_kernel_call(q_hat, kf, vf, perm, **dkw), 10, flush)
    plain_ms = time_ms(torch, lambda: dk.distr_attention_plain(q_hat, kf, vf, perm, **dkw), 3, flush)
    dist = dict(group_size=g, block_q=dcfg.block_q)
    b = roofline(attention_work(1, hq, hkv, n, n, d, causal=True, **dist)["fwd"], ms,
                 attention_cost(1, hq, n, n, d, causal=True, **dist))
    log(f"[prefill G*=4 N={n}] distr {ms:.3f} ms (plain {plain_ms:.3f}, bound "
        f"{b['bound_ms']:.4f} by {b['bound_by']}, model {b['model_bound_ms']:.4f}) err {err:.3e}")
    return {"n": n, "group_size": g, "ms": ms, "plain_ms": plain_ms, **b, "max_abs_err": err}


def paged_kernel_phase(torch, flush) -> dict:
    """The paged decode kernel at the serving shape: B = 8, Hq 36 over Hkv 4,
    d = 128, blocks of 128, 16 per table, a pool of 129 blocks whose physical
    ids are shuffled from a seed and whose garbage block 0 holds NaN,
    lengths PAGED_LENGTHS; q_len 1 (a decode tick) and 32 (a prefill chunk),
    score width 128 (raw K) and 64 (fused K̂, G* = 2), bf16.  o, m and l are
    held against the plain version element by element.  The yardstick is
    SDPA with a boolean band mask over the same KV gathered into a
    contiguous cache beforehand (the gather is not timed)."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels.ops import _pack_gqa_rows
    from repro_torch.roofline.analysis import decode_attention_work, paged_decode_attention_cost

    b, hq, hkv, d, bs, mb = len(PAGED_LENGTHS), 36, 4, 128, 128, 16
    cap = bs * mb
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    bt = (torch.randperm(b * mb, generator=gen, device="cuda") + 1).reshape(b, mb)
    bt = bt.to(torch.int32)
    for i, n in enumerate(PAGED_LENGTHS):  # entries past a request's blocks
        bt[i, -(-min(n, cap) // bs):] = pd.GARBAGE_BLOCK
    out = {"max_abs_err": 0.0, "shapes": []}
    for q_len in (1, 32):
        for ds in (128, 64):
            q = torch.randn((b, hq, q_len, ds), generator=gen, device="cuda").to(torch.bfloat16)
            k_pool = torch.randn((1 + b * mb, hkv, bs, ds), generator=gen,
                                 device="cuda").to(torch.bfloat16)
            v_pool = torch.randn((1 + b * mb, hkv, bs, d), generator=gen,
                                 device="cuda").to(torch.bfloat16)
            k_pool[pd.GARBAGE_BLOCK] = float("nan")
            v_pool[pd.GARBAGE_BLOCK] = float("nan")
            qp = _pack_gqa_rows(q, hkv)
            kw = dict(scale=d ** -0.5, q_len=q_len)
            got = pd.paged_decode_kernel_call(qp, k_pool, v_pool, bt, lengths, **kw)
            want = pd.paged_decode_plain(qp, k_pool, v_pool, bt, lengths, **kw)
            torch.cuda.synchronize()
            err = max(check_close(torch, f"paged q_len={q_len} d_score={ds} {name}", g_, w_,
                                  TOL["decode"])
                      for name, g_, w_ in zip("oml", got, want))
            out["max_abs_err"] = max(out["max_abs_err"], err)
            del got, want
            ms = time_ms(torch, lambda: pd.paged_decode_kernel_call(qp, k_pool, v_pool, bt,
                                                                    lengths, **kw), 20, flush)
            plain_ms = time_ms(torch, lambda: pd.paged_decode_plain(qp, k_pool, v_pool, bt,
                                                                    lengths, **kw), 3, flush)
            cost = summed(paged_decode_attention_cost(1, hq, hkv, n, mb, bs, d,
                                                      group_size=d // ds, q_len=q_len)
                          for n in PAGED_LENGTHS)
            work = decode_attention_work(PAGED_LENGTHS, hq, hkv, d, cap, group_size=d // ds,
                                         q_len=q_len, table_entries=mb)
            row = {"q_len": q_len, "d_score": ds, "ms": ms, "plain_ms": plain_ms,
                   **roofline(work, ms, cost), "max_abs_err": err, "library_ms": None}
            if ds == d:
                k_c = pd.gather_blocks(k_pool, bt)
                v_c = pd.gather_blocks(v_pool, bt)
                col = torch.arange(cap, device="cuda")
                dead = (col[None, :] >= lengths[:, None])[:, None, :, None]
                kx = k_c.masked_fill(dead, 0).repeat_interleave(hq // hkv, dim=1)
                vx = v_c.masked_fill(dead, 0).repeat_interleave(hq // hkv, dim=1)
                tok = torch.arange(q_len, device="cuda")
                band = col[None, None, :] < (lengths[:, None, None] - (q_len - 1 - tok)[None, :, None])
                mask = band[:, None]  # (B, 1, q_len, S)
                row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, kx, vx, attn_mask=mask), 20, flush)
                del k_c, v_c, kx, vx
            out["shapes"].append(row)
            log(f"[paged q_len={q_len} d_score={ds}] {ms:.4f} ms (plain {plain_ms:.4f}, sdpa "
                f"{row['library_ms']}, bound {row['bound_ms']:.4f} by {row['bound_by']}, model "
                f"{row['model_bound_ms']:.4f}) err {err:.3e}")
    head = out["shapes"][0]  # a decode tick over the raw-K pool
    out.update({k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    return out


def ssd_phase(torch, flush) -> dict:
    """The SSD kernel at SSD_SHAPES, bf16 x / b / c and f32 log-decays
    a = −softplus(N(0, 1)): y and the final state held against the plain
    version element by element; kernel and plain version timed at each
    shape (the plain one at the headline only), and the instantiation that
    ran (its P-slice width) read from the profiler.  At the headline also
    ``ops.ssd`` on the same values in the model's (B, N, H, P) layout: the
    op's head flattening copies beside the kernel.  The bound is
    ``kernels.ops.ssd_work``'s (x, a, b, c read once, y and the state
    written once, a chunk's causal triangle); the model bound beside it
    takes ``kernels.ops.ssd_cost``'s FLOPs (the full Q × Q products a
    chunk), which counts no bytes, with the same bytes."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd as sk
    from repro_torch.kernels.ops import ssd_cost, ssd_work

    out = {"max_abs_err": 0.0, "shapes": []}
    gen = torch.Generator(device="cuda").manual_seed(6)
    for label, b, h, p, g, s, chunk, n in SSD_SHAPES:
        x = torch.randn((b * h, n, p), generator=gen, device="cuda").to(torch.bfloat16)
        a = -torch.nn.functional.softplus(torch.randn((b * h, n), generator=gen, device="cuda"))
        bm = torch.randn((b * g, n, s), generator=gen, device="cuda").to(torch.bfloat16)
        c = torch.randn((b * g, n, s), generator=gen, device="cuda").to(torch.bfloat16)
        kw = dict(heads_per_group=h // g, chunk=chunk, return_state=True)
        y, state = sk.ssd_kernel_call(x, a, bm, c, **kw)
        y_p, state_p = sk.ssd_plain(x, a, bm, c, **kw)
        torch.cuda.synchronize()
        err = check_close(torch, f"ssd {label} y", y, y_p, SSD_TOL["y"])
        err_s = check_close(torch, f"ssd {label} state", state, state_p, SSD_TOL["state"])
        out["max_abs_err"] = max(out["max_abs_err"], err)
        ms = time_ms(torch, lambda: sk.ssd_kernel_call(x, a, bm, c, **kw), 10, flush)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sk.ssd_kernel_call(x, a, bm, c, **kw)
            torch.cuda.synchronize()
        ran = sorted({e.key for e in prof.key_averages() if "ssd" in e.key})
        headline = not out["shapes"]
        plain_ms = (time_ms(torch, lambda: sk.ssd_plain(x, a, bm, c, **kw), 3, flush)
                    if headline else None)
        op_ms = None
        if headline:
            x4, a3 = (t.reshape(b, h, n, *t.shape[2:]).transpose(1, 2).contiguous() for t in (x, a))
            b4, c4 = (t.reshape(b, g, n, s).transpose(1, 2).contiguous() for t in (bm, c))
            y_op, state_op = ops.ssd(x4, a3, b4, c4, chunk=chunk, return_state=True)
            torch.testing.assert_close(y_op.transpose(1, 2).reshape(b * h, n, p), y, atol=0, rtol=0)
            torch.testing.assert_close(state_op.reshape(b * h, s, p), state, atol=0, rtol=0)
            op_ms = time_ms(torch, lambda: ops.ssd(x4, a3, b4, c4, chunk=chunk, return_state=True),
                            10, flush)
            del x4, a3, b4, c4, y_op, state_op
        work = ssd_work(b, n, h, p, g, s, chunk=chunk)
        cost = {"total_flops": ssd_cost(b, n, h, p, s, chunk=chunk)["total_flops"],
                "hbm_bytes": work["hbm_bytes"]}
        row = {"label": label, "b": b, "h": h, "p": p, "g": g, "s": s, "chunk": chunk, "n": n,
               "ms": ms, "plain_ms": plain_ms, "op_ms": op_ms, **roofline(work, ms, cost),
               "max_abs_err": err, "state_max_abs_err": err_s, "kernel": ran}
        out["shapes"].append(row)
        log(f"[ssd {label}] {ms:.4f} ms (plain {plain_ms}, ops.ssd {op_ms}, bound "
            f"{row['bound_ms']:.4f} by {row['bound_by']}, model {row['model_bound_ms']:.4f}) y err {err:.3e} state err "
            f"{err_s:.3e}; ran {ran}")
        del x, a, bm, c, y, state, y_p, state_p
    head = out["shapes"][0]
    out.update(ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
               bound_by=head["bound_by"], library_ms=None)
    return out


def attn112_phase(torch, flush) -> dict:
    """The flash, DistrAttention (G* = 2, block_q 128) and decode kernels at
    zamba2-7b's shared-block shape, head dim 112: B·Hq = 32, MHA, N = 2048,
    causal; decode B = 4 slots, 32 KV heads, one query row each, S = 2048,
    lengths DECODE_LENGTHS.  Held against the plain versions at TOL, timed
    beside them and an SDPA yardstick."""
    import torch.nn.functional as F

    from repro_torch.core.distr_attention import DistrConfig
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import _pack_gqa_rows, attention_cost, attention_work
    from repro_torch.roofline.analysis import decode_attention_cost, decode_attention_work

    hq, hkv, d, g = HYBRID_ATTN
    n = max(PREFILL_NS)
    dcfg = DistrConfig(group_size=g, block_q=128)
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn((1, h, n, d), generator=gen, device="cuda").to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    qf, kf, vf = q[0].contiguous(), k[0].contiguous(), v[0].contiguous()
    kw = dict(q_per_kv=hq // hkv, scale=d ** -0.5, causal=True, kv_len=n)
    err_f = check_close(torch, "flash d=112", fk.flash_attention_kernel_call(qf, kf, vf, **kw),
                        fk.flash_attention_plain(qf, kf, vf, **kw), TOL["flash"])
    q_hat, perms = ops.distr_stage1(dcfg, q, d ** -0.5, hkv=hkv)
    q_hat, perm = q_hat[0].contiguous(), perms[0].to(torch.int32).contiguous()
    dkw = dict(q_per_kv=hq // hkv, causal=True, group_size=g, block_q=dcfg.block_q, kv_len=n)
    err_d = check_close(torch, "distr d=112", dk.distr_attention_kernel_call(q_hat, kf, vf, perm, **dkw),
                        dk.distr_attention_plain(q_hat, kf, vf, perm, **dkw), TOL["distr"])
    out = {
        "flash": {"ms": time_ms(torch, lambda: fk.flash_attention_kernel_call(qf, kf, vf, **kw), 10, flush),
                  "plain_ms": time_ms(torch, lambda: fk.flash_attention_plain(qf, kf, vf, **kw), 3, flush),
                  "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 10, flush),
                  "max_abs_err": err_f},
        "distr": {"ms": time_ms(torch, lambda: dk.distr_attention_kernel_call(q_hat, kf, vf, perm, **dkw), 10, flush),
                  "plain_ms": time_ms(torch, lambda: dk.distr_attention_plain(q_hat, kf, vf, perm, **dkw), 3, flush),
                  "library_ms": None, "max_abs_err": err_d},
    }
    dist = dict(group_size=g, block_q=dcfg.block_q)
    out["flash"].update(roofline(attention_work(1, hq, hkv, n, n, d, causal=True)["fwd"],
                                 out["flash"]["ms"], attention_cost(1, hq, n, n, d, causal=True)))
    out["distr"].update(roofline(attention_work(1, hq, hkv, n, n, d, causal=True, **dist)["fwd"],
                                 out["distr"]["ms"],
                                 attention_cost(1, hq, n, n, d, causal=True, **dist)))
    del q, k, v, qf, kf, vf, q_hat, perm

    b, s_len = 4, max(PREFILL_NS)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    qd = torch.randn((b, hq, 1, d), generator=gen, device="cuda").to(torch.bfloat16)
    kd, vd = (torch.randn((b, hkv, s_len, d), generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    qp = _pack_gqa_rows(qd, hkv)
    dkw = dict(scale=d ** -0.5, block_k=128, q_len=1)
    got = dec.merge_splits(*dec.decode_kernel_call(qp, kd, vd, lengths, **dkw))
    want = dec.merge_splits(*dec.decode_plain(qp, kd, vd, lengths, **dkw))
    err = check_close(torch, "decode d=112", got, want, TOL["decode"])
    mask = (torch.arange(s_len, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    out["decode"] = {
        "ms": time_ms(torch, lambda: dec.decode_kernel_call(qp, kd, vd, lengths, **dkw), 20, flush),
        "plain_ms": time_ms(torch, lambda: dec.decode_plain(qp, kd, vd, lengths, **dkw), 5, flush),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask), 20, flush),
        "max_abs_err": err,
    }
    out["decode"].update(roofline(decode_attention_work(DECODE_LENGTHS, hq, hkv, d, s_len),
                                  out["decode"]["ms"],
                                  summed(decode_attention_cost(1, hq, hkv, n, s_len, d,
                                                               block_k=128)
                                         for n in DECODE_LENGTHS)))
    for name, row in out.items():
        log(f"[d=112 {name}] {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, library "
            f"{row['library_ms']}, bound {row['bound_ms']:.4f} by {row['bound_by']}, model "
            f"{row['model_bound_ms']:.4f}) err {row['max_abs_err']:.3e}")
    torch.cuda.empty_cache()
    return out


def hybrid_serve_phase(torch) -> dict:
    """zamba2-7b at full width (81 Mamba-2 layers, d_model 3584, 2 shared
    attention blocks of 32 heads of 112 applied after every 6th layer),
    seeded random bf16 weights initialised on the card, served through the
    launcher's run function under both kernel impls: 6 requests on 4 slots,
    prompts SERVE_PROMPTS, 32 new tokens, greedy, max_len 2048.  Every
    request must finish ``done`` with its tokens (a non-finite logit row
    fails its request), and each prefill must launch the SSD kernel 81
    times and the impl's attention kernel 13 times, each decode step the
    decode kernel 13 times."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ssd as sk
    from repro_torch.launch.serve import run
    from repro_torch.models import lm

    cfg = get_config("zamba2-7b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    log(f"[hybrid serve] zamba2-7b params on the card in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    n_sites, _ = lm.hybrid_layout(cfg)
    launches = {"flash": 0, "distr": 0, "decode": 0, "ssd": 0}
    report = {}
    for impl, kernel in (("pallas_distr", "distr"), ("pallas_flash", "flash")):
        cfg_i = cfg.replace(attention=cfg.attention.with_impl(impl))
        fk.launches = dk.launches = dec.launches = sk.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res = run(cfg_i, params, max_new=32, max_slots=4, max_len=2048,
                  prompt_lens=list(SERVE_PROMPTS), device="cuda")
        peak = torch.cuda.max_memory_allocated()
        counts = {"flash": fk.launches, "distr": dk.launches, "decode": dec.launches,
                  "ssd": sk.launches}
        log(f"[hybrid serve {impl}] {len(res['done'])} requests, {res['tokens']} tokens in "
            f"{res['seconds']:.2f}s ({res['tok_per_s']:.1f} tok/s); peak allocated "
            f"{peak / 2**30:.2f} GiB; launches {counts}")
        for m in res["metrics"]:
            log(f"  req {m['uid']}: status {m['status']} ttft {m['ttft_s']:.4f}s "
                f"tpot {m['tpot_s']:.4f}s n={m['n_generated']}")
        bad = [r.uid for r in res["done"] if r.status != "done" or len(r.generated) != 32]
        if len(res["done"]) != len(SERVE_PROMPTS) or bad:
            raise AssertionError(f"hybrid serve {impl}: requests not done: {bad}")
        n_req = len(SERVE_PROMPTS)
        other = "flash" if kernel == "distr" else "distr"
        if (counts["ssd"] != cfg.n_layers * n_req or counts[kernel] != n_sites * n_req
                or counts[other] or counts["decode"] == 0 or counts["decode"] % n_sites):
            raise AssertionError(f"hybrid serve {impl}: launches off the path: {counts}")
        for name in (kernel, "decode", "ssd"):
            launches[name] += counts[name]
        report[impl] = {"seconds": res["seconds"], "tokens": res["tokens"],
                        "tok_per_s": res["tok_per_s"], "peak_allocated": peak,
                        "launches": counts, "metrics": res["metrics"]}
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "report": report}


def serve_phase(torch):
    """starcoder2-7b at full width, seeded random weights, served through
    the launcher's run function under both kernel impls.  Returns the
    launches and the weights, which the paged serve phase reuses."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.launch.serve import run
    from repro_torch.models import lm

    cfg = get_config("starcoder2-7b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    log(f"[serve] starcoder2-7b params on the card in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    launches = {"flash": 0, "distr": 0, "decode": 0}
    tokens = {}
    for impl, kernel in (("pallas_distr", "distr"), ("pallas_flash", "flash")):
        cfg_i = cfg.replace(attention=cfg.attention.with_impl(impl))
        fk.launches = dk.launches = dec.launches = 0
        res = run(cfg_i, params, max_new=32, max_slots=4, max_len=2048,
                  prompt_lens=list(SERVE_PROMPTS), device="cuda")
        tokens[impl] = {r.uid: r.generated for r in res["done"]}
        counts = {"flash": fk.launches, "distr": dk.launches, "decode": dec.launches}
        log(f"[serve {impl}] {len(res['done'])} requests, {res['tokens']} tokens in "
            f"{res['seconds']:.2f}s ({res['tok_per_s']:.1f} tok/s); launches {counts}")
        for m in res["metrics"]:
            log(f"  req {m['uid']}: status {m['status']} ttft {m['ttft_s']:.4f}s "
                f"tpot {m['tpot_s']:.4f}s n={m['n_generated']}")
        bad = [r.uid for r in res["done"] if r.status != "done" or len(r.generated) != 32]
        if len(res["done"]) != len(SERVE_PROMPTS) or bad:
            raise AssertionError(f"serve {impl}: requests not done: {bad}")
        if counts[kernel] == 0 or counts["decode"] == 0:
            raise AssertionError(f"serve {impl}: a kernel of the path never launched: {counts}")
        launches[kernel] += counts[kernel]
        launches["decode"] += counts["decode"]
    return launches, params, tokens


def fused_slot_phase(torch, params, raw_tokens: dict, base=None, device="cuda") -> dict:
    """starcoder2-7b at full width with the serve phase's weights on the
    slot engine over the fused-K̂ cache: pallas_distr with
    ``distr_decode`` at G* = 2, 4 slots, max_len 2048, the serve phase's
    prompts (SERVE_PROMPTS, drawn as ``launch.serve.run`` draws them), 32
    new tokens, greedy, the decode step captured as a CUDA graph.  Raises
    unless every request is done, the cache holds ``k_fused`` d/G* = 64
    wide, the decode kernel launched (from the graph's replays) and the
    first decode step's logits are finite.  Logs the share of its tokens
    equal to the raw-K pallas_distr serve run's (not gated: the fused
    decode approximates the scores)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.serve.engine import ServeEngine

    base = base or get_config("starcoder2-7b")
    cfg = base.replace(attention=replace(base.attention, impl="pallas_distr", distr_decode=True))
    width = cfg.head_dim_ // cfg.attention.distr.group_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=n).tolist() for n in SERVE_PROMPTS]
    eng = ServeEngine(cfg, params, max_slots=4, max_len=2048, device=device)
    graph, first = eng._decode, []

    def decode_step(*args):  # keeps a copy of the first step's logits
        out = graph(*args)
        if not first:
            first.append(out[0].clone())
        return out

    eng._decode = decode_step
    fk.launches = dk.launches = dec.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        eng.add_request(p, max_new_tokens=32)
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"flash": fk.launches, "distr": dk.launches, "decode": dec.launches}
    tokens = {r.uid: r.generated for r in done}
    n_tok = sum(len(g) for g in tokens.values())
    same = sum(a == b for uid, g in tokens.items() for a, b in zip(g, raw_tokens[uid]))
    log(f"[fused slot] {len(done)} requests, {n_tok} tokens in {seconds:.2f}s "
        f"({n_tok / seconds:.1f} tok/s); k_fused {tuple(eng.cache['k_fused'].shape)}; "
        f"launches {counts}; graphs captured {len(graph._captured)}; {same} of {n_tok} tokens "
        f"({same / n_tok:.3f}) equal the raw-K pallas_distr run's (not gated)")
    bad = [r.uid for r in done if r.status != "done" or len(r.generated) != 32]
    if len(done) != len(prompts) or bad:
        raise AssertionError(f"fused slot: requests not done: {bad}")
    if eng.cache["k_fused"].shape[-1] != width or width != base.head_dim_ // 2:
        raise AssertionError(f"fused slot: k_fused {tuple(eng.cache['k_fused'].shape)}, "
                             f"want a last dimension of {width}")
    if counts["decode"] == 0 or counts["distr"] == 0 or counts["flash"] or not graph._captured:
        raise AssertionError(f"fused slot: launches off the path: {counts}")
    if not bool(torch.isfinite(first[0]).all()):
        raise AssertionError("fused slot: the first decode step's logits are not finite")
    return {"launches": counts, "seconds": seconds, "tokens": n_tok,
            "tok_per_s": n_tok / seconds, "agreement": same / n_tok}


class TickClock:
    """A clock the chaos phase advances by one a step: deadlines in steps."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def chaos_phase(torch, params, base=None, device="cuda") -> dict:
    """starcoder2-7b at full width with the serve phase's weights under
    pallas_flash, 3 requests a run on the slot engine (4 slots, max_len
    2048) and on ``PagedServeEngine`` (8 lanes, blocks of 128, chunks of
    32), CHAOS_NEW new tokens, greedy, a tick clock; a fault on uid 1 a
    run: ``nan_logits`` from its 13th logits row on, a persistent
    ``stuck_step``, a ``slow_step`` of 50 ticks against its e2e deadline of
    20, a ``cancel`` at step CHAOS_CANCEL_STEP, and on the paged engine
    also a persistent ``pool_exhausted`` (the watchdog fails it) and a
    persistent ``restore_failure`` in the 17-block pool.  Raises unless
    every request is terminal, the pool's free blocks are back at their
    count at the start, the robustness counters are exactly those the
    reference's chaos tests expect, uid 1 ends failed, expired or
    cancelled, and the other requests' tokens equal those of the
    fault-free run of the same engine."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.faults import FaultInjector, FaultSpec
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine
    from repro_torch.serve.lifecycle import is_terminal

    base = base or get_config("starcoder2-7b")
    cfg = base.replace(attention=base.attention.with_impl("pallas_flash"))
    rng = np.random.default_rng(1)
    prompts = {key: [rng.integers(1, cfg.vocab, size=n).tolist() for n in lens]
               for key, lens in (("roomy", CHAOS_PROMPTS), ("pressure", CHAOS_PRESSURE_PROMPTS))}

    def engine(kind, pool, clock, faults):
        if kind == "slot":
            return ServeEngine(cfg, params, max_slots=4, max_len=2048, clock=clock,
                               faults=faults, device=device)
        return PagedServeEngine(cfg, params, max_batch=8, max_len=2048, block_size=128,
                                prefill_chunk=32, clock=clock, faults=faults, device=device,
                                **({"num_blocks": PRESSURE_BLOCKS} if pool == "pressure" else {}))

    failed_fault = {"failed_fault": 1, "step_retries": 3}
    cases = [  # engine, pool, name, spec on uid 1, uid 1's deadline, cancel, counters, uid 1 ends
        (kind, "roomy", name, spec, dl, cancel, want, status)
        for kind in ("slot", "paged")
        for name, spec, dl, cancel, want, status in (
            ("clean", None, {}, False, {}, "done"),
            ("nan_logits", dict(point="nan_logits", uid=1, after=12, times=-1), {}, False,
             {"failed_numeric": 1}, "failed"),
            ("stuck_step", dict(point="stuck_step", uid=1, times=-1), {}, False, failed_fault,
             "failed"),
            ("slow_step", dict(point="slow_step", after=3, delay=50.0),
             {"deadline_e2e": 20.0}, False, {"expired": 1}, "expired"),
            ("cancel", None, {}, True, {"cancelled": 1}, "cancelled"))
    ] + [
        ("paged", "roomy", "pool_exhausted", dict(point="pool_exhausted", uid=1, times=-1), {},
         False, {"watchdog_fails": 1}, "failed"),
        ("paged", "pressure", "clean", None, {}, False, {}, "done"),
        ("paged", "pressure", "restore_failure", dict(point="restore_failure", uid=1, times=-1),
         {}, False, {"failed_fault": 1, "restore_retries": 5}, "failed"),
    ]
    clean, report = {}, {}
    launches = {"flash": 0, "decode": 0, "paged": 0}
    for kind, pool, name, spec, deadline, cancel, want, status in cases:
        clock = TickClock()
        eng = engine(kind, pool, clock, FaultInjector([FaultSpec(**spec)] if spec else []))
        free0 = eng.cache.pool.num_free if kind == "paged" else None
        fk.launches = dec.launches = pd.launches = 0
        t0 = time.perf_counter()
        for uid, p in enumerate(prompts[pool]):
            eng.add_request(p, max_new_tokens=CHAOS_NEW, **(deadline if uid == 1 else {}))
        for step in range(CHAOS_MAX_STEPS):
            if cancel and step == CHAOS_CANCEL_STEP and not eng.cancel(1):
                raise AssertionError(f"chaos {kind} {name}: cancel(1) found no request")
            eng.step()
            clock.t += 1
            if not eng.has_work():
                break
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        reqs = {r.uid: r for r in eng.finished}
        counters = {k: v for k, v in eng.counters_snapshot().items() if v}
        counts = {"flash": fk.launches, "decode": dec.launches, "paged": pd.launches}
        free = eng.cache.pool.num_free if kind == "paged" else None
        log(f"[chaos {kind} {pool} {name}] {step + 1} steps in {seconds:.2f}s; statuses "
            f"{ {u: r.status for u, r in sorted(reqs.items())} }; tokens "
            f"{ {u: len(r.generated) for u, r in sorted(reqs.items())} }; counters {counters}; "
            f"free blocks {free} of {free0}; launches {counts}")
        if eng.has_work() or sorted(reqs) != [0, 1, 2] or not all(
                is_terminal(r.status) for r in reqs.values()):
            raise AssertionError(f"chaos {kind} {name}: requests not terminal")
        if free != free0:
            raise AssertionError(f"chaos {kind} {name}: {free0 - free} pool blocks leaked")
        if counters != want or reqs[1].status != status:
            raise AssertionError(f"chaos {kind} {name}: counters {counters} (want {want}), "
                                 f"uid 1 {reqs[1].status} (want {status})")
        tokens = {u: r.generated for u, r in reqs.items()}
        if name == "clean":
            if any(len(g) != CHAOS_NEW for g in tokens.values()):
                raise AssertionError(f"chaos {kind} {pool}: the clean run is short")
            clean[kind, pool] = tokens
        elif any(tokens[u] != clean[kind, pool][u] for u in (0, 2)):
            raise AssertionError(f"chaos {kind} {name}: the other requests' tokens differ "
                                 "from the fault-free run's")
        if name == "cancel" and not 0 < len(tokens[1]) < CHAOS_NEW:
            raise AssertionError(f"chaos {kind} cancel: not mid-decode ({len(tokens[1])} tokens)")
        for key, n in counts.items():
            launches[key] += n
        report[f"{kind} {pool} {name}"] = {"steps": step + 1, "seconds": seconds,
                                           "counters": counters, "launches": counts}
        del eng
        torch.cuda.empty_cache()
    return {"launches": launches, "report": report}


def trace_phase(torch, params, base=None, device="cuda") -> dict:
    """starcoder2-7b at full width with the serve phase's weights and
    prompts (SERVE_PROMPTS, drawn as ``launch.serve.run`` draws them),
    pallas_distr, 32 new tokens, greedy, under a ``TraceRecorder`` on the
    wall clock: once on the slot engine (4 slots, max_len 2048, the decode
    step captured) and once on ``PagedServeEngine`` (raw-K pool, 8 lanes,
    blocks of 128, chunks of 32).  Each run's trace and registry snapshot
    (``obs.metrics.serving_registry``) go through a JSON file and the
    validators.  Raises unless both validate, each request has one
    ``request`` begin and one end whose args equal its ``metrics()`` row,
    the ``decode`` spans number the engine's decode steps, every
    ``lifecycle.COUNTER_KEYS`` key is in the snapshot once, every request
    is done, and the decode (slot) or paged (paged) kernel launched.  Logs
    the wall split by span name.  A span is host time: none synchronises
    the card, so the slot engine's ``prefill`` and ``decode`` spans cover
    the dispatch of their step, while the paged ``decode`` span also waits
    for its tick, whose tokens and health mask it reads back."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.obs import TraceRecorder, serving_registry
    from repro_torch.obs.validate import validate_chrome_trace, validate_metrics_snapshot
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine
    from repro_torch.serve.lifecycle import COUNTER_KEYS

    base = base or get_config("starcoder2-7b")
    cfg = base.replace(attention=base.attention.with_impl("pallas_distr"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=n).tolist() for n in SERVE_PROMPTS]
    launches = {"distr": 0, "decode": 0, "paged": 0}
    report = {}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        for kind in ("slot", "paged"):
            rec = TraceRecorder()
            if kind == "slot":
                eng = ServeEngine(cfg, params, max_slots=4, max_len=2048, device=device,
                                  trace=rec)
                attr = "_decode"
            else:
                eng = PagedServeEngine(cfg, params, max_batch=8, max_len=2048, block_size=128,
                                       prefill_chunk=32, device=device, trace=rec)
                attr = "decode_tick"
            step_fn, steps = getattr(eng, attr), [0]

            def counted(*args, step_fn=step_fn, steps=steps):
                steps[0] += 1
                return step_fn(*args)

            setattr(eng, attr, counted)
            fk.launches = dk.launches = dec.launches = pd.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for p in prompts:
                eng.add_request(p, max_new_tokens=32)
            done = eng.run_to_completion()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {"flash": fk.launches, "distr": dk.launches, "decode": dec.launches,
                      "paged": pd.launches}
            tpath, mpath = Path(out_dir, f"{kind}_trace.json"), Path(out_dir, f"{kind}_m.json")
            rec.save(str(tpath))
            mpath.write_text(json.dumps(serving_registry(eng).snapshot()))
            doc, snap = json.loads(tpath.read_text()), json.loads(mpath.read_text())
            problems = validate_chrome_trace(doc) + validate_metrics_snapshot(snap)
            evs = doc["traceEvents"]
            span_s, span_ms = {}, {}
            for e in evs:
                if e["ph"] == "X":
                    span_s[e["name"]] = span_s.get(e["name"], 0.0) + e["dur"] / 1e6
                    span_ms.setdefault(e["name"], []).append(round(e["dur"] / 1e3, 4))
            # The first two decode steps are the graph's warm-up and capture.
            replay_ms = statistics.median(span_ms["decode"][2:] or [0.0])
            rows = {m["uid"]: json.loads(json.dumps(m)) for m in eng.metrics()}
            begins = sorted(e["args"]["uid"] for e in evs
                            if e["ph"] == "b" and e["name"] == "request")
            ends = [e for e in evs if e["ph"] == "e" and e["name"] == "request"]
            n_decode = sum(e["ph"] == "X" and e["name"] == "decode" for e in evs)
            names = [n for n in snap["counters"] if n.startswith("serve_")]
            log(f"[trace {kind}] {len(done)} requests in {wall:.3f}s; {len(evs)} events "
                f"({tpath.stat().st_size} bytes), {rec.dropped} dropped; wall by span (host "
                f"time: no span synchronises the card; the paged tick reads its tokens back "
                f"inside its span, the slot step after its span): "
                + ", ".join(f"{k} {v:.4f}s" for k, v in sorted(span_s.items()))
                + f", the rest {wall - sum(span_s.values()):.4f}s; {n_decode} decode spans, "
                f"{steps[0]} decode steps; decode span ms: the first two {span_ms['decode'][:2]}, "
                f"median after {replay_ms}; prefill span ms {span_ms.get('prefill')}; "
                f"launches {counts}; problems {problems}")
            if problems:
                raise AssertionError(f"trace {kind}: the validators found {problems}")
            if begins != sorted(rows) or sorted(e["args"]["uid"] for e in ends) != sorted(rows):
                raise AssertionError(f"trace {kind}: request spans {begins} / "
                                     f"{len(ends)} ends for requests {sorted(rows)}")
            bad = [e["args"]["uid"] for e in ends if e["args"] != rows[e["args"]["uid"]]]
            if bad:
                raise AssertionError(f"trace {kind}: end args differ from metrics() for {bad}")
            if n_decode != steps[0] or steps[0] == 0:
                raise AssertionError(f"trace {kind}: {n_decode} decode spans for "
                                     f"{steps[0]} decode steps")
            if sorted(names) != sorted(f"serve_{k}" for k in COUNTER_KEYS):
                raise AssertionError(f"trace {kind}: counters in the snapshot {names}")
            if len(done) != len(prompts) or any(
                    r.status != "done" or len(r.generated) != 32 for r in done):
                raise AssertionError(f"trace {kind}: requests not done")
            if counts["decode" if kind == "slot" else "paged"] == 0:
                raise AssertionError(f"trace {kind}: no decode launches: {counts}")
            for key in launches:
                launches[key] += counts[key]
            report[kind] = {"wall_s": wall, "events": len(evs), "span_s": span_s,
                            "span_ms": span_ms, "decode_steps": steps[0], "launches": counts}
            del eng
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"launches": launches, "report": report}


def paged_serve_phase(torch, params) -> dict:
    """starcoder2-7b at full width through ``PagedServeEngine`` with the slot
    phase's weights: 8 requests (prompts PAGED_PROMPTS, greedy), 8 lanes,
    max_len 2048, blocks of 128, chunks of 32.  (a) A raw-K pool under
    pallas_flash and (b) a fused-K̂ pool (G* = 2) under pallas_distr: every
    request done with its tokens, the paged kernel launched and the
    contiguous decode, flash and distr kernels not (chunked prefill runs on
    the paged kernel).  (c) (a) in a pool that forces preemption: the pool
    comes back whole.  (d) (a) under overload with the degradation dial on:
    degraded prefills run the DistrAttention kernel."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.serve.degrade import DegradeConfig
    from repro_torch.serve.engine import PagedServeEngine
    from repro_torch.serve.lifecycle import is_terminal

    base = get_config("starcoder2-7b")
    flash = base.replace(attention=base.attention.with_impl("pallas_flash"))
    fused = base.replace(attention=replace(base.attention, impl="pallas_distr",
                                           distr_decode=True))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, base.vocab, size=n).tolist() for n in PAGED_PROMPTS]
    overload = DegradeConfig(group_sizes=(2, 4), high_watermark=2, low_watermark=0,
                             up_after=1, down_after=2)
    runs = (("a_raw", flash, {}, PAGED_NEW), ("b_fused", fused, {}, PAGED_NEW),
            ("c_pressure", flash, {"num_blocks": PRESSURE_BLOCKS}, PRESSURE_NEW),
            ("d_overload", flash, {"degrade": overload}, PAGED_NEW))
    report, tokens = {}, {}
    launches = {"paged": 0, "distr": 0}
    for name, cfg, kw, new in runs:
        eng = PagedServeEngine(cfg, params, max_batch=8, max_len=2048, block_size=128,
                               prefill_chunk=32, device="cuda", **kw)
        pool_gib = sum(p.numel() * p.element_size() for p in eng.cache.pools.values()) / 2**30
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.launches = dk.launches = dec.launches = pd.launches = 0
        t0 = time.perf_counter()
        for p in prompts:
            eng.add_request(p, max_new_tokens=new)
        done = eng.run_to_completion()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {"paged": pd.launches, "decode": dec.launches, "flash": fk.launches,
                  "distr": dk.launches}
        metrics = eng.metrics()
        counters = eng.counters_snapshot()
        n_tok = sum(len(r.generated) for r in done)
        peak = torch.cuda.max_memory_allocated()
        log(f"[paged {name}] {len(done)} requests, {n_tok} tokens in {seconds:.2f}s "
            f"({n_tok / seconds:.1f} tok/s); pools {sorted(eng.cache.pools)} {pool_gib:.3f} GiB "
            f"of {eng.cache.pool.num_blocks} blocks; peak allocated {peak / 2**30:.2f} GiB; "
            f"launches {counts}; counters "
            f"{ {k: v for k, v in counters.items() if v} }")
        for m in metrics:
            log(f"  req {m['uid']}: status {m['status']} ttft {m['ttft_s']:.4f}s tpot "
                f"{m['tpot_s']:.4f}s n={m['n_generated']} preemptions {m['n_preemptions']} "
                f"G* {m['degrade_group']}")
        tokens[name] = {r.uid: r.generated for r in done}
        if len(done) != len(prompts) or any(not is_terminal(r.status) for r in done):
            raise AssertionError(f"paged {name}: requests not terminal: {metrics}")
        if counts["paged"] == 0 or counts["decode"]:
            raise AssertionError(f"paged {name}: launches off the path: {counts}")
        if name != "d_overload":
            bad = [r.uid for r in done if r.status != "done" or len(r.generated) != new]
            if bad or counts["flash"] or counts["distr"]:
                raise AssertionError(f"paged {name}: requests not done {bad} or prefill "
                                     f"off the paged kernel: {counts}")
        if name == "b_fused" and "k" in eng.cache.pools:
            raise AssertionError("paged b_fused: the fused pool kept raw K")
        if name == "c_pressure":
            n_pre = sum(m["n_preemptions"] for m in metrics)
            if n_pre == 0 or eng.cache.pool.num_free != eng.cache.pool.num_blocks - 1:
                raise AssertionError(f"paged c_pressure: {n_pre} preemptions, "
                                     f"{eng.cache.pool.num_free} blocks free")
            same = sum(a == b for uid, toks in tokens[name].items()
                       for a, b in zip(toks[:PAGED_NEW], tokens["a_raw"][uid]))
            log(f"[paged c_pressure] {same} of {PAGED_NEW * len(prompts)} of the first "
                f"{PAGED_NEW} tokens equal run (a)'s (not gated: bf16, a different batch)")
        if name == "d_overload" and (counters["degraded_prefills"] == 0 or counts["distr"] == 0):
            raise AssertionError(f"paged d_overload: no degraded prefill: {counters} {counts}")
        launches["paged"] += counts["paged"]
        launches["distr"] += counts["distr"]
        report[name] = {"seconds": seconds, "tokens": n_tok, "tok_per_s": n_tok / seconds,
                        "pool_gib": pool_gib, "peak_allocated": peak, "launches": counts,
                        "counters": counters, "metrics": metrics}
        del eng
        torch.cuda.empty_cache()
    return {"launches": launches, "report": report}


def _attention_device_ms(torch, run_one) -> tuple[float, float, dict]:
    """Profile ``run_one()``: (attention kernels' device ms, all device ms,
    device ms by attention kernel name)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_one()
        torch.cuda.synchronize()
    total, attn, by_name = 0.0, 0.0, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        total += us
        for name in ATTN_KERNEL_NAMES:
            if name in e.key:
                attn += us
                by_name[name] = by_name.get(name, 0.0) + us / 1e3
    return attn / 1e3, total / 1e3, by_name


def train_phase(torch) -> dict:
    """minicpm-2b at its published size (40 layers), seeded random f32
    params, trained through the launcher's run function under both kernel
    impls: 4 steps of 4 × 2048 tokens (the first is warm-up), full remat.
    Raises if a loss or grad norm is not finite, a step was skipped, or a
    kernel of the impl's path never launched (the other impl's kernels
    must stay at 0).  One more profiled step per impl gives the attention
    kernels' share of the device time."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels import backward as bwd
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.launch.train import init_train_params, run
    from repro_torch.roofline.analysis import PEAK_FLOPS, active_params, model_flops

    cfg = get_config("minicpm-2b")
    shape = ShapeSpec("chip_smoke", "train", TRAIN_N, TRAIN_BATCH)
    launches = {"flash": 0, "distr": 0, **{name: 0 for name in bwd.launches}}
    report = {}
    for impl, mine, other in (("pallas_distr", "distr", "flash"),
                              ("pallas_flash", "flash", "distr")):
        cfg_i = cfg.replace(attention=cfg.attention.with_impl(impl))
        t0 = time.perf_counter()
        params = init_train_params(cfg_i, seed=0, device="cuda")
        torch.cuda.synchronize()
        log(f"[train {impl}] minicpm-2b params (f32) on the card in "
            f"{time.perf_counter() - t0:.1f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        fk.launches = dk.launches = dec.launches = 0
        for name in bwd.launches:
            bwd.launches[name] = 0
        res = run(cfg_i, params, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_N, lr=1e-3,
                  seed=0, device="cuda")
        counts = {"flash": fk.launches, "distr": dk.launches, "decode": dec.launches,
                  **bwd.launches}
        hist = res["history"]
        log(f"[train {impl}] losses {[r['loss'] for r in hist]} grad norms "
            f"{[r['grad_norm'] for r in hist]}")
        log(f"[train {impl}] step times {res['step_times']} s; {res['tok_per_s']:.1f} tok/s "
            f"after the warm-up step; peak allocated "
            f"{res['max_memory_allocated'] / 2**30:.2f} GiB; launches {counts}")
        bad = [r for r in hist if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]))]
        if bad or res["nan_skips"]:
            raise AssertionError(f"train {impl}: non-finite or skipped steps: {bad}, "
                                 f"{res['nan_skips']} skipped")
        path = (mine, "delta", f"{mine}_dq", f"{mine}_dkv")
        off = (other, f"{other}_dq", f"{other}_dkv", "decode")
        if any(counts[name] == 0 for name in path) or any(counts[name] for name in off):
            raise AssertionError(f"train {impl}: launches off the path: {counts}")
        for name in path:
            launches[name] += counts[name]
        steady = res["step_times"][1:]
        step_s = sum(steady) / len(steady)
        # The whole step's share of the card: 6 · active params · tokens
        # over the bf16 peak and the measured step (printed, not a metric).
        _, active = active_params(cfg_i, params)
        flops = model_flops(cfg_i, shape, active)
        share = flops / PEAK_FLOPS / step_s
        log(f"[train {impl}] model_flops_share {share:.4f}: {flops:.4e} model FLOPs a step "
            f"(6 x {active} active params x {TRAIN_BATCH * TRAIN_N} tokens) over "
            f"{PEAK_FLOPS:.4g} FLOP/s and the mean steady step {step_s:.4f} s")
        attn_ms, device_ms, by_name = _attention_device_ms(
            torch, lambda: run(cfg_i, params, steps=1, batch=TRAIN_BATCH, seq=TRAIN_N,
                               lr=1e-3, seed=1, device="cuda"))
        log(f"[train {impl}] profiled step: attention kernels {attn_ms:.1f} ms of "
            f"{device_ms:.1f} ms device time; {attn_ms / 1e3 / step_s:.1%} of the mean "
            f"steady step ({step_s:.3f} s); by kernel {by_name}")
        report[impl] = {"losses": [r["loss"] for r in hist],
                        "grad_norms": [r["grad_norm"] for r in hist],
                        "step_times": res["step_times"], "tok_per_s": res["tok_per_s"],
                        "max_memory_allocated": res["max_memory_allocated"],
                        "launches": counts, "model_flops": flops,
                        "model_flops_share": share, "attention_device_ms": attn_ms,
                        "device_ms": device_ms, "attention_ms_by_kernel": by_name}
        del params, res
        torch.cuda.empty_cache()
    return {"launches": launches, "report": report}


def train_robustness_phase(torch, base=None, device="cuda", seq=ROBUST_SEQ) -> dict:
    """minicpm-2b at full width cut to 1 layer (the embedding and one
    layer, f32), pallas_distr, 1 x ``seq`` tokens a step, trained through
    ``Trainer`` with a ``TraceRecorder`` and a checkpoint workdir in a fresh
    temporary directory (removed at the end): ROBUST_STEPS steps, keep 2,
    ``AnomalyConfig(warmup=3, z_threshold=6.0)`` and the faults
    ROBUST_FAULTS.  Raises unless the trainer rolled back once and skipped
    one NaN step, its history is steps 1..8 with finite losses, the trace
    and the registry snapshot validate, and a second trainer in the same
    workdir resumes from the newest verified checkpoint below the torn one
    (the baseline, one torn fallback) with that checkpoint's data cursor
    and takes a finite step; and unless the distr forward, delta and distr
    backward kernels launched and the flash ones did not.  Logs each save's
    and load's seconds, bytes and split (host copy, sha256, ``np.savez``,
    fsync, verification, the copy into the card's tensors)."""
    from repro_torch.configs import get_config
    from repro_torch.faults import FaultInjector, FaultSpec
    from repro_torch.kernels import backward as bwd
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.launch.train import init_train_params
    from repro_torch.models import lm
    from repro_torch.obs import TraceRecorder, train_registry
    from repro_torch.obs.validate import validate_chrome_trace, validate_metrics_snapshot
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.anomaly import AnomalyConfig
    from repro_torch.train.data import SyntheticLMData
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer

    base = base or get_config("minicpm-2b")
    cfg = base.replace(n_layers=1, attention=base.attention.with_impl("pallas_distr"))
    opt = OptimizerConfig(peak_lr=1e-4, warmup_steps=1, total_steps=ROBUST_STEPS,
                          schedule=cfg.schedule)
    anomaly = AnomalyConfig(warmup=3, z_threshold=6.0)
    io = []  # (what, name, seconds, bytes, split)
    # The split: seconds inside these functions of train/checkpoint.py
    # (verify_checkpoint also runs inside _gc, the save's keep-k check).
    parts = ("_to_numpy", "_array_digest", "_write_npz", "_fsync_file", "_fsync_dir",
             "_gc", "verify_checkpoint", "_load_dir")
    spent = dict.fromkeys(parts, 0.0)
    originals = {name: getattr(ckpt, name) for name in parts + ("save_checkpoint",
                                                                 "load_checkpoint")}

    def timed(name):
        fn = originals[name]

        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapper

    def split(before):
        return {k: round(spent[k] - before[k], 4) for k in parts if spent[k] > before[k]}

    def timed_save(ckpt_dir, step, *args, **kw):
        before, t0 = dict(spent), time.perf_counter()
        path = originals["save_checkpoint"](ckpt_dir, step, *args, **kw)
        seconds = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        io.append(("save", Path(path).name, seconds, size, split(before)))
        log(f"[train robustness] save {Path(path).name}: {seconds:.3f}s, {size} bytes; "
            f"split {io[-1][4]} (_write_npz holds the host copy, the hash and np.savez)")
        return path

    def timed_load(*args, **kw):
        before, t0 = dict(spent), time.perf_counter()
        out = originals["load_checkpoint"](*args, **kw)
        seconds = time.perf_counter() - t0
        io.append(("load", out[3]["_name"], seconds, None, split(before)))
        log(f"[train robustness] load {out[3]['_name']} (verified, "
            f"{out[3]['_fallback_skipped']} skipped): {seconds:.3f}s; split {io[-1][4]}")
        return out

    def trainer(params, trace, faults=None):
        return Trainer(cfg, opt, SyntheticLMData(cfg.vocab, 1, seq, seed=0), params,
                       workdir=workdir, ckpt_every=ROBUST_CKPT_EVERY, ckpt_keep=2,
                       anomaly=anomaly, faults=faults, trace=trace)

    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    for name in parts:
        setattr(ckpt, name, timed(name))
    ckpt.save_checkpoint, ckpt.load_checkpoint = timed_save, timed_load
    try:
        t0 = time.perf_counter()
        params = init_train_params(cfg, seed=0, device=device)
        n_params = sum(p.numel() for p in lm.trainable(params))
        fk.launches = dk.launches = 0
        for name in bwd.launches:
            bwd.launches[name] = 0
        rec = TraceRecorder()
        tr = trainer(params, rec, FaultInjector([FaultSpec(**f) for f in ROBUST_FAULTS]))
        hist = tr.run(ROBUST_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"flash": fk.launches, "distr": dk.launches, **bwd.launches}
        counters = {k: v for k, v in tr.counters_snapshot().items() if v}
        doc = json.loads(json.dumps(rec.to_chrome()))
        snap = json.loads(json.dumps(train_registry(tr).snapshot()))
        problems = validate_chrome_trace(doc) + validate_metrics_snapshot(snap)
        instants = [(e["name"], e["args"]) for e in doc["traceEvents"] if e["ph"] == "i"]
        log(f"[train robustness] minicpm-2b, 1 layer: {n_params} params (f32), {wall:.2f}s "
            f"for {ROBUST_STEPS} steps with saves; losses {[r['loss'] for r in hist]}; "
            f"step s {[r['sec'] for r in hist]}; counters {counters}; instants {instants}; "
            f"launches {counts}; problems {problems}")
        if counters.get("rollbacks") != 1 or counters.get("nan_skips") != 1:
            raise AssertionError(f"train robustness: counters {counters}")
        if [r["step"] for r in hist] != list(range(1, ROBUST_STEPS + 1)) or not all(
                math.isfinite(r["loss"]) for r in hist):
            raise AssertionError(f"train robustness: history {hist}")
        if problems:
            raise AssertionError(f"train robustness: the validators found {problems}")
        names = ckpt.list_checkpoint_names(tr.ckpt_dir)
        del tr, params
        torch.cuda.empty_cache()

        t1 = time.perf_counter()
        tr2 = trainer(init_train_params(cfg, seed=1, device=device), TraceRecorder())
        meta = json.loads(Path(tr2.ckpt_dir, "step_00000000", "meta.json").read_text())
        resumed = (tr2.step, tr2.counters_snapshot()["torn_ckpt_fallbacks"],
                   tr2.dataset.state(), meta["data_state"])
        step = tr2.step_once()
        torch.cuda.synchronize()
        log(f"[train robustness] checkpoints {names}; resumed at step {resumed[0]} with "
            f"{resumed[1]} torn fallback(s), data cursor {resumed[2]} (checkpoint's "
            f"{resumed[3]}), next step loss {step['loss']} in {time.perf_counter() - t1:.2f}s")
        if resumed[:2] != (0, 1) or resumed[2] != resumed[3] or not math.isfinite(step["loss"]):
            raise AssertionError(f"train robustness: resume {resumed}, next step {step}")
        path = ("distr", "delta", "distr_dq", "distr_dkv")
        off = ("flash", "flash_dq", "flash_dkv")
        if any(counts[n] == 0 for n in path) or any(counts[n] for n in off):
            raise AssertionError(f"train robustness: launches off the path: {counts}")
        counts = {"flash": fk.launches, "distr": dk.launches, **bwd.launches}
        del tr2
        torch.cuda.empty_cache()
    finally:
        for name, fn in originals.items():
            setattr(ckpt, name, fn)
        shutil.rmtree(workdir, ignore_errors=True)
    return {"launches": {n: counts[n] for n in path},
            "report": {"params": n_params, "wall_s": wall, "losses": [r["loss"] for r in hist],
                       "counters": counters, "checkpoints": names, "io": io,
                       "launches": counts}}


def distr_vs_flash_table(prefill_shapes: list, g4: dict, a112: dict, back: list) -> list:
    """The bf16 DistrAttention kernels beside the flash kernels at N = 2048,
    causal, from this run, ms: the forward at the serving shapes without the
    LSE and at the training shape with it; the backward dq and dkv at both
    backward shapes."""
    head = next(r for r in prefill_shapes if r["n"] == max(PREFILL_NS) and "d" not in r)
    train = next(r for r in prefill_shapes if r.get("d") == TRAIN_SHAPE[2])
    return [
        {"shape": "starcoder2-7b d=128 G*=2", "distr_ms": head["distr_ms"],
         "flash_ms": head["flash_ms"], "bound_ms": head["distr_bound_ms"]},
        {"shape": "starcoder2-7b d=128 G*=4", "distr_ms": g4["ms"],
         "flash_ms": head["flash_ms"], "bound_ms": g4["bound_ms"]},
        {"shape": "minicpm-2b d=64 G*=2 with LSE", "distr_ms": train["distr_ms"],
         "flash_ms": train["flash_ms"], "bound_ms": train["distr_bound_ms"]},
        {"shape": "zamba2-7b d=112 G*=2", "distr_ms": a112["distr"]["ms"],
         "flash_ms": a112["flash"]["ms"], "bound_ms": a112["distr"]["bound_ms"]},
        *({"shape": f"backward {r['shape']} d={r['d']} G*={r['group_size']} {part}",
           "distr_ms": r[f"distr_{part}"]["ms"], "flash_ms": r[f"flash_{part}"]["ms"],
           "bound_ms": r[f"distr_{part}"]["bound_ms"]} for r in back for part in ("dq", "dkv")),
    ]


def closed_loop(eng, prompts, lanes: int, new: int):
    """Serve ``prompts`` in order as a closed loop holding ``lanes``
    requests in flight (one is submitted as one ends), yielding after each
    engine step whether the step took a request off the waiting queue
    (the slot engine: admitted and prefilled it)."""
    queue, in_flight = list(prompts), 0
    while queue or in_flight:
        while queue and in_flight < lanes:
            eng.add_request(queue.pop(0), max_new_tokens=new)
            in_flight += 1
        waiting = eng.queue_depth()
        in_flight -= len(eng.step())
        yield eng.queue_depth() < waiting


def serve_load_run(torch, eng, prompts, lanes: int) -> dict:
    """One timed pass of the load: wall time (clock stopped after a
    synchronise), engine steps, tokens/s, mean TTFT (from submission) and
    mean TPOT of its requests, the median wall time of the steps that took
    no request off the queue and the mean of those that did (a step ends
    in the host's read of its tokens, which waits for the device; on the
    slot engine the first are decode steps and the second carry a prefill,
    and TPOT carries both); every request must finish with its tokens."""
    seen = len(eng.metrics())
    torch.cuda.synchronize()
    t0 = last = time.perf_counter()
    step_ms, admit_ms = [], []
    for admitted in closed_loop(eng, prompts, lanes, LOAD_NEW):
        now = time.perf_counter()
        (admit_ms if admitted else step_ms).append((now - last) * 1e3)
        last = now
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps = len(step_ms) + len(admit_ms)
    rows = eng.metrics()[seen:]
    if len(rows) != len(prompts) or any(r["status"] != "done" or r["n_generated"] != LOAD_NEW
                                        for r in rows):
        raise AssertionError(f"serve load: requests not done: {rows}")
    tokens = sum(r["n_generated"] for r in rows)
    return {"seconds": seconds, "steps": steps, "tokens": tokens, "tok_per_s": tokens / seconds,
            "ttft_s": statistics.fmean(r["ttft_s"] for r in rows),
            "tpot_s": statistics.fmean(r["tpot_s"] for r in rows),
            "step_ms_median": statistics.median(step_ms),
            "admit_step_ms": statistics.fmean(admit_ms) if admit_ms else None}


def serve_load_busy(torch, eng, prompts, lanes: int, start: int) -> dict:
    """The device's busy share over LOAD_PROFILE_STEPS engine steps of one
    more pass, from step ``start``, under ``torch.profiler``: device time
    (``launch.serve.device_busy_s``) over the window's wall time.  The
    pass is left unfinished; its engine is not used again."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import device_busy_s

    steps = closed_loop(eng, prompts, lanes, LOAD_NEW)
    for _ in itertools.islice(steps, start):
        pass
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = sum(1 for _ in itertools.islice(steps, LOAD_PROFILE_STEPS))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    busy = device_busy_s(prof)
    return {"start": start, "steps": n, "seconds": seconds, "device_s": busy,
            "busy_share": busy / seconds}


def serve_load(torch, workload: str) -> dict:
    """``--serve-load``: one serve workload at full width with seeded random
    weights, as a closed-loop stream (its prompts LOAD_PASSES times over,
    LOAD_NEW new tokens each, greedy, as many in flight as the engine has
    lanes).  slot: starcoder2-7b on the slot engine (4 slots, max_len
    2048, prompts SERVE_PROMPTS), and under pallas_distr also over the
    fused-K̂ cache (``distr_decode``, G* = 2); hybrid: zamba2-7b on the
    same; paged: starcoder2-7b on ``PagedServeEngine`` over a raw-K pool
    (8 lanes, blocks of 128, chunks of 32, max_len LOAD_PAGED_MAX_LEN,
    prompts PAGED_PROMPTS).  Under each impl: one engine, a warm-up request of 64
    prompt tokens (kernel builds, graph captures; not reported), LOAD_RUNS
    timed passes, then the busy share over a window in the middle of one
    more.  Only the engines' public calls are used (``queue_depth``
    among them), so the same file measures another tree whose engines
    have them."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine

    base = get_config("zamba2-7b" if workload == "hybrid" else "starcoder2-7b")
    params = lm.init_params(base, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    lens = PAGED_PROMPTS if workload == "paged" else SERVE_PROMPTS
    prompts = [rng.integers(1, base.vocab, size=n).tolist() for n in lens] * LOAD_PASSES
    out = {}
    runs = [("pallas_distr", False), ("pallas_flash", False)]
    if workload == "slot":
        runs.append(("pallas_distr", True))  # the fused-K̂ decode cache, G* = 2
    for impl, fused in runs:
        cfg = base.replace(attention=replace(base.attention, impl=impl, distr_decode=fused))
        name = impl + ("+fused_k" if fused else "")
        if workload == "paged":
            lanes = 8
            eng = PagedServeEngine(cfg, params, max_batch=lanes, max_len=LOAD_PAGED_MAX_LEN,
                                   block_size=128, prefill_chunk=32, device="cuda")
        else:
            lanes = 4
            eng = ServeEngine(cfg, params, max_slots=lanes, max_len=2048, device="cuda")
        for _ in closed_loop(eng, [prompts[0][:64]], 1, LOAD_NEW):
            pass
        timed = []
        for i in range(LOAD_RUNS):
            timed.append(serve_load_run(torch, eng, prompts, lanes))
            r = timed[-1]
            log(f"[load {workload} {name}] run {i}: {r['tokens']} tokens, {r['steps']} steps in "
                f"{r['seconds']:.3f}s, {r['tok_per_s']:.2f} tok/s, mean TTFT {r['ttft_s']:.4f}s, "
                f"mean TPOT {r['tpot_s']:.5f}s, median step {r['step_ms_median']:.3f} ms, "
                f"mean admitting step {r['admit_step_ms']} ms")
        start = max(0, timed[0]["steps"] // 2 - LOAD_PROFILE_STEPS // 2)
        busy = serve_load_busy(torch, eng, prompts, lanes, start)
        log(f"[load {workload} {name}] steps {start}-{start + busy['steps']} of a pass under the "
            f"profiler: device busy {busy['device_s']:.4f}s of {busy['seconds']:.4f}s "
            f"({busy['busy_share']:.1%})")
        out[name] = {"runs": timed, "busy": busy}
        del eng
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    ap.add_argument("--only", choices=("kernels",), default=None,
                    help="stop after the kernel phases")
    ap.add_argument("--serve-load", choices=("slot", "paged", "hybrid"), default=None,
                    help="only serve this workload as a closed-loop load under both impls "
                         "(timed passes and the device's busy share), no checks")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    card = gpu_name_and_power()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.lib()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f}s")
    if args.serve_load:
        load = serve_load(torch, args.serve_load)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"card": card, **load}, indent=1))
        log(card)
        summary = {impl: {**{k: [r[k] for r in res["runs"]]
                             for k in ("tok_per_s", "ttft_s", "tpot_s", "step_ms_median",
                                       "admit_step_ms")},
                          "busy_share": res["busy"]["busy_share"]}
                   for impl, res in load.items()}
        print(json.dumps(summary), flush=True)
        return 0
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  " + line.strip())
    tensor_cores = tensor_core_check(build)
    delta_sass = delta_sass_check(build)

    # The plain versions' f32 products run in full f32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    pre = prefill_phase(torch, flush)
    g4 = distr_g4_phase(torch, flush)
    pre["distr"]["max_abs_err"] = max(pre["distr"]["max_abs_err"], g4["max_abs_err"])
    dec = decode_phase(torch, flush)
    pdec = paged_kernel_phase(torch, flush)
    back = backward_phase(torch, flush)
    ssd = ssd_phase(torch, flush)
    a112 = attn112_phase(torch, flush)
    for name in ("flash", "distr"):
        pre[name]["max_abs_err"] = max(pre[name]["max_abs_err"], a112[name]["max_abs_err"])
    dec["max_abs_err"] = max(dec["max_abs_err"], a112["decode"]["max_abs_err"])
    del flush
    results = {"card": card, "tensor_cores": tensor_cores, "delta_sass": delta_sass,
               "distr_vs_flash": distr_vs_flash_table(pre["shapes"], g4, a112, back["shapes"]),
               "prefill_shapes": pre.pop("shapes"), "distr_g4": g4,
               "paged_shapes": pdec.pop("shapes"), "backward_shapes": back.pop("shapes"),
               "delta_shapes": back.pop("delta_shapes"),
               "ssd_shapes": ssd.pop("shapes"), "head_dim_112": a112}
    launches = {"flash": 0, "distr": 0, "decode": 0, "paged": 0, "ssd": 0,
                **dict.fromkeys(back, 0)}
    if args.only != "kernels":
        serve_launches, params, serve_tokens = serve_phase(torch)
        launches.update(serve_launches)
        paged = paged_serve_phase(torch, params)
        results["paged_serve"] = paged["report"]
        for name, count in paged["launches"].items():
            launches[name] += count
        fused = fused_slot_phase(torch, params, serve_tokens["pallas_distr"])
        results["fused_slot"] = fused
        chaos = chaos_phase(torch, params)
        results["chaos"] = chaos["report"]
        traced = trace_phase(torch, params)
        results["trace"] = traced["report"]
        del params
        torch.cuda.empty_cache()
        for name, count in (*fused["launches"].items(), *chaos["launches"].items(),
                            *traced["launches"].items()):
            launches[name] += count
        hybrid = hybrid_serve_phase(torch)
        results["hybrid_serve"] = hybrid["report"]
        for name, count in hybrid["launches"].items():
            launches[name] += count
        train = train_phase(torch)
        results["train"] = train["report"]
        robust = train_robustness_phase(torch)
        results["train_robustness"] = robust["report"]
        for name, count in (*train["launches"].items(), *robust["launches"].items()):
            launches[name] += count

    csrc = "src/repro_torch/kernels/csrc"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda", "source": f"{csrc}/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:41", "launches": launches["flash"],
         **pre["flash"]},
        {"name": "distr_attention_fwd", "route": "cuda", "source": f"{csrc}/distr_attention.cu",
         "replaces": "src/repro/kernels/distr_attention.py:42", "launches": launches["distr"],
         **pre["distr"]},
        {"name": "decode_splitk", "route": "cuda", "source": f"{csrc}/decode.cu",
         "replaces": "src/repro/kernels/decode.py:68", "launches": launches["decode"], **dec},
        {"name": "paged_decode", "route": "cuda", "source": f"{csrc}/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_decode.py:58", "launches": launches["paged"],
         **pdec},
    ]
    for name, source, line in (("delta", "delta.cu", 50), ("flash_dq", "flash_backward.cu", 114),
                               ("flash_dkv", "flash_backward.cu", 199),
                               ("distr_dq", "distr_backward.cu", 306),
                               ("distr_dkv", "distr_backward.cu", 398)):
        kernels.append({"name": f"{name}_bwd",
                        "route": "cuda", "source": f"{csrc}/{source}",
                        "replaces": f"src/repro/kernels/backward.py:{line}",
                        "launches": launches[name], **back[name]})
    kernels.append({"name": "ssd_chunk_scan", "route": "cuda", "source": f"{csrc}/ssd.cu",
                    "replaces": "src/repro/kernels/ssd.py:28", "launches": launches["ssd"],
                    **ssd})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: kern[k] for k in keys} for kern in kernels]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({**results, "kernels": kernels}, indent=1))
    for row in results["distr_vs_flash"]:
        log(f"[distr vs flash] {json.dumps(row)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
