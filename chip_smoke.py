#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out PATH] [--only kernels|moe|encdec|tune|cluster|ring]

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
launcher and slot engine under both impls.  The dense qwen configs: the
forward kernels at qwen1.5-4b's MHA prefill shape, the decode and paged
kernels at qwen2.5-32b's 5 query rows a KV head (160 in a 32-token
chunk); after the trace runs qwen1.5-4b at its published size and
qwen2.5-32b at full width cut to 8 of its 64 layers, each serving the
serve workload on the slot engine under both impls and on
``PagedServeEngine`` (raw-K), every weight freed between models.  The
error study: ``core.distr_scores`` at G* 2, 4 and 8 on Gaussian q, k and
on qwen1.5-4b's layer 0, its error growing with G*, with the distr
kernel's output beside flash's.  The MoE family: one MoE layer of
llama4-scout-17b-a16e and of deepseek-v2-236b at full width (bf16) at
T = 2048 and T = 4, the index dispatch of ``models/moe.py`` against the
reference's one-hot dispatch (identical expert ids, y within MOE_TOL,
dropped assignments counted); llama4-scout-17b-a16e at full width cut to
8 of its 48 layers serving the serve workload on the slot engine under
both impls and on ``PagedServeEngine``, and deepseek-v2-236b (MLA) cut to
its dense layer and 5 MoE layers on the slot engine under pallas_distr
and xla_flash, launching no attention kernel (MLA runs none, as in the
reference); then both trained 4 steps through
``repro_torch.launch.train.run`` under pallas_distr with f32 params, grads
and AdamW moments on the card: llama4-scout-17b-a16e at full width cut
to one MoE layer (4.27 B params) on 1 × 2048 tokens a step, launching the
DistrAttention forward and its backward kernels and nothing else, and
deepseek-v2-236b at reduced() widths on 4 × 2048, launching none.  The
block-size tuner: after the trace runs, under ``REPRO_TUNE=measure`` with
a temporary cache, the slot and paged engines' warm-ups at
starcoder2-7b's serving shapes sweep the decode split and the paged pool
block (each table logged), the decode and paged kernels are held against
their plain versions at the picks, a ``PagedServeEngine`` with
``block_size=None`` serves the serve workload at the picked block, and a
second construction reads the cache without a sweep.  SSM training: ``ops.ssd``'s gradient
(the kernel forward, the chunked backward) against autograd through the
plain version at mamba2-130m's layer shape, and mamba2-130m trained at
its published size (4 steps of 4 × 2048 tokens, the SSD kernel twice a
layer and step under full remat).  The engines run their decode
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

The enc-dec and VLM slice: after the qwen kernel checks, flash and
DistrAttention forward and backward non-causal at whisper-small's shapes
(48 heads of 64, 448 and 1500 rows over 1500 keys, a ragged last key tile),
and the decode kernel at whisper-small's self and 1500-position cross
caches (d = 64) and internvl2-2b's 16 over 8 heads (d = 128), all held
against their plain versions; after the MoE phases whisper-small (12
encoder and 12 decoder layers, learned positions, cross-attention) served
at its published size through ``serve_step`` over 1500 seeded frames a
request (the reference's slot engine refuses enc-dec), and internvl2-2b
served through ``serve_step`` with 256 seeded patch embeddings a request
and on the slot engine over the serve workload's text prompts, both under
both impls, each first decode step held against the same step under
impl="reference", in bf16 and again with the step in f32; after mamba2-130m's training both trained at their
published sizes in f32 through ``make_train_step`` (4 steps each under
both impls: whisper 4 × 448 tokens over 1500 frames, internvl 2 × (256
patches + 1792 tokens)), card memory back at each run's start after it.

The cluster router and the training supervisor: after the tuner's phase,
starcoder2-7b at full width with the serve phase's weights behind a
``ClusterRouter`` of two slot engines and one ``PagedServeEngine``
sharing those weights (``cluster_phase``: a healthy run, slot replica 1
killed mid-flight, the paged replica drained with ``migrate=True`` and
replaced, a replica that advertises a shorter ``max_prompt_len``, a
wedged pool and a NaN storm, and the healthy run again under the
profiler), each request's statuses, tokens and emitted prefix held to the
healthy run's and the reference's real-engine cluster tests, the dead and
replaced engines' card memory given back; after the robustness run
``supervisor_phase``: the same one-layer minicpm-2b under a 4-worker
``TrainSupervisor`` through a worker loss and a straggler's exclusion on
one tick, one restore from the step-3 checkpoint, its losses held to an
uninterrupted run's bit for bit (two identical steps agree bit for bit on
the card), the step-3 checkpoint served through the ``--ckpt`` loader
with the trainer's logits, and one step at grad_accum 2 against 1.

Ring context-parallel attention: after the supervisor phase,
``ring_phase`` spawns 4 ranks as processes that share the card, in a gloo
world over a ``FileStore`` (each hop's K and V staged through pinned host
memory), and holds ring flash and ring DistrAttention, forward and
gradients, at starcoder2-7b's and minicpm-2b's widths on 4 × 2048 tokens
(causal, non-causal, f32, a ragged length causal and not, a dead shard)
against the single-device kernels on the same card, each tensor also
relative to its own scale, with the hop counts and one launch of each
kernel a hop; then minicpm-2b (40 layers) under the 4-rank context mesh,
every attention through ``core.api._ring_dispatch``: each layer's
attention against the single-device one on the same layer input, and the
whole forward (finite, its gap from the single-device forward reported).
Four processes on one card check what the ring computes, not its speed
across cards.

``python3 chip_smoke.py --only moe`` builds the kernels and runs only the
MoE phases (the check, serving and training), then prints their launches
as a JSON line last;
``--only encdec`` the same for the enc-dec and VLM slice's phases;
``--only tune`` the same for the tuner's phase (starcoder2-7b's weights,
then ``tune_phase``); ``--only cluster`` the same for ``cluster_phase``
(starcoder2-7b's weights) and ``supervisor_phase``; ``--only ring`` the
same for ``ring_phase``.
``python3 chip_smoke.py --serve-load slot|hybrid|paged`` runs none of the
above: it serves one serve workload as a closed-loop load under both
impls, the slot workload also over the fused-K̂ cache (timed passes and
the device's busy share, ``serve_load``) and prints a JSON summary last.
"""
from __future__ import annotations

import argparse
import gc
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
# The cluster phase: starcoder2-7b at full width with the serve phase's
# weights, pallas_distr, greedy, a tick clock; three replicas sharing the
# weights (two slot engines of 4 slots and max_len 2048, one
# PagedServeEngine: raw K, 8 lanes, blocks of 128, chunks of 32) behind a
# round-robin ClusterRouter; the serve workload, CLUSTER_NEW new tokens a
# request.  The kill: slot replica 1 crashes at its 4th tick and is
# declared dead two missed heartbeats later.  The drain: the paged replica
# drained with migrate=True after CLUSTER_DRAIN_TICK ticks, then replaced.
# The capability run's replica 0 takes prompts up to CLUSTER_SMALL_LEN
# tokens (its max_len), so the 1536-token prompt must go elsewhere.  The
# wedge run: persistent pool_exhausted on the paged replica's first
# request, NaN logits on slot replica 0's first from its 2nd row on.
CLUSTER_NEW, CLUSTER_MAX_TICKS, CLUSTER_DRAIN_TICK, CLUSTER_SMALL_LEN = 32, 600, 24, 1152
CLUSTER_CRASH = dict(point="replica_crash", uid=1, after=3)
CLUSTER_WEDGE = {0: dict(point="nan_logits", uid=0, after=1, times=-1),
                 2: dict(point="pool_exhausted", uid=0, times=-1)}
# The supervisor phase: train_robustness_phase's model, f32 state and
# sequence under a TrainSupervisor of SUPERVISE_WORKERS simulated workers
# (max_missed 2, stragglers flagged above 2x the median step time, excluded
# after 2 flags) for SUPERVISE_STEPS steps, checkpoints every
# SUPERVISE_CKPT_EVERY (so the saves are the step-0 baseline and step 3).
# Worker 2 is lost at tick 5 and worker 1 turns slow at tick 4, so its
# second flag excludes it at tick 5 too: one remesh to 2 workers and one
# restore to step 3, then steps 4 and 5 again.  SUPERVISE_COUNTERS are the
# counters the reference's supervisor gives for this schedule
# (tests/test_torch_supervisor.py, case "card_schedule").  The losses after
# recovery must equal an uninterrupted run's bit for bit where two
# identical steps on the card agree bit for bit, else within
# SUPERVISE_LOSS_RTOL.  Grad-accum: one step at grad_accum 2 against 1 on
# the same 2 x seq batch, loss within GRAD_ACCUM_RTOL and every param
# within GRAD_ACCUM_PARAM_TOL after the update (the reference's bounds).
SUPERVISE_WORKERS, SUPERVISE_STEPS, SUPERVISE_CKPT_EVERY = 4, 5, 3
SUPERVISE_FAULTS = (dict(point="worker_loss", uid=2, after=4, times=-1),
                    dict(point="slow_worker", uid=1, after=3, times=-1, delay=9.0))
SUPERVISE_COUNTERS = {"worker_deaths": 2, "remesh_events": 1, "straggler_flags": 2}
SUPERVISE_LOSS_RTOL = 1e-5
GRAD_ACCUM_RTOL, GRAD_ACCUM_PARAM_TOL = 1e-5, 2e-2
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
# ops.ssd's gradient (the kernel forward, the chunked backward) against
# autograd through the plain version at mamba2-130m's layer shape for
# training: (B, N, H, P, G, S, chunk).  f32 at 1e-4, bf16 at 2e-2, of the
# element plus of the gradient's largest element (the gradients sum over the
# sequence, so an element that cancels keeps the rounding of its sum).
SSD_GRAD_SHAPE = (4, 2048, 24, 64, 1, 128, 128)
SSD_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The dense configs of the qwen phases: (arch, layers kept; None = all).
# qwen2.5-32b at full width is 32.8 B params (65.5 GB in bf16): 8 of its 64
# layers keep 5.46 B (10.9 GB).
QWEN_SERVE = (("qwen1.5-4b", None), ("qwen2.5-32b", 8))
# Their attention shapes for the kernel checks: (arch, query heads, KV heads).
QWEN_KERNEL_SHAPES = (("qwen1.5-4b", 20, 20), ("qwen2.5-32b", 40, 8))
# The MoE configs at full width: (arch, layers kept).  llama4-scout-17b-a16e
# is 107.8 B params (215.5 GB in bf16): 8 of its 48 layers keep 19.69 B
# (39.4 GB).  deepseek-v2-236b is 235.7 B (471.5 GB): its dense layer and 5
# of its 59 MoE layers keep 21.25 B (42.5 GB).
MOE_SERVE = (("llama4-scout-17b-a16e", 8), ("deepseek-v2-236b", 6))
# deepseek's MLA runs no kernel under either impl, in the reference too.
MLA_IMPLS = (("pallas_distr", None), ("xla_flash", None))
# MoE and MLA training on the card, through launch/train.py::run (arch,
# reduced widths, layers kept or None for the config's, batch, tokens a
# row).  llama4-scout-17b-a16e keeps its full width cut to one MoE layer:
# the layer is 2.20 B params and the untied embedding and head 2.07 B, so
# f32 params, grads and AdamW moments take 63.7 GiB of the card's 79.1.
# deepseek-v2-236b's one MoE layer alone is 63.5 GB of such state, so it
# trains at reduced() widths.
MOE_TRAIN = (("llama4-scout-17b-a16e", False, 1, 1, 2048),
             ("deepseek-v2-236b", True, None, TRAIN_BATCH, TRAIN_N))
# The MoE check: index dispatch against one-hot, element-wise atol = rtol.
# Both compute the experts in f32 and round y to bf16, so they differ by at
# most a bf16 rounding step of y; the flash kernels' bf16 tolerance.
MOE_TOL, MOE_ITERS = 2e-2, 5
# Card memory that free_card lets the cycle collector free (small tensors a
# caught exception's frames may hold).
CYCLE_SLACK = 64 * 2**20
# The enc-dec and VLM slice.  Non-causal kernels at whisper-small's
# attention shapes: B·H = 4 × 12 (MHA), d = 64, G* = 2, Nk = 1500 encoder
# frames (no tile divides it) against Nq = 448 decoder rows (cross-attention
# in training) and 1500 (the encoder's self-attention).
NONCAUSAL_SHAPE = (48, 64, 2, 1500)
NONCAUSAL_NQ = (448, 1500)
# whisper-small served through serve_step: 4 requests over 1500 seeded
# frames each, decoder prompts of 4–64 tokens, ENCDEC_NEW greedy decode
# steps; the decode step as a CUDA graph, as the slot engine runs it.
WHISPER_PROMPTS = (4, 17, 40, 64)
ENCDEC_NEW = 32
WHISPER_MAX_LEN = 128
# internvl2-2b through serve_step: 256 seeded patch embeddings before each of
# these text prompts; then the slot engine on the serve workload's prompts.
VLM_PROMPTS = (96, 200, 517, 1000)
VLM_MAX_LEN = 2048
# The decode kernel at the serving steps' shapes, before the models run it:
# (label, Hq, Hkv, d, S, one live length a slot).  whisper-small's self
# cache (the first step's lengths: prompt + 1) and its 1500-position cross
# cache (12 splits of 128, the last 92 keys ragged; lengths cross_len and
# two ragged ones), MHA at d = 64; internvl2-2b's 16 over 8 (2 rows a KV
# head) at d = 128, the first step's lengths 256 patches + prompt + 1.
ENCDEC_DECODE_SHAPES = (
    ("whisper-small self", 12, 12, 64, WHISPER_MAX_LEN, tuple(n + 1 for n in WHISPER_PROMPTS)),
    ("whisper-small cross", 12, 12, 64, 1500, (1500, 77, 1437, 1500)),
    ("internvl2-2b", 16, 8, 128, VLM_MAX_LEN, tuple(256 + n + 1 for n in VLM_PROMPTS)))
# A served model's first decode step against the same step under
# impl="reference" (plain attention) on the same cache, over the vocab's
# live columns: rtol, and atol this share of the largest |logit|.  Both are
# bf16 models: every layer rounds its attention output to bf16 (the plain
# version also its P), and the difference grows with depth and the logits'
# scale (on an NVIDIA H100 at 700 W: whisper-small, 12 layers, 0.041;
# internvl2-2b, 24, 0.137, on logits of random weights up to ≈ 4.7).  The
# relative L2 error over the live logits is held to ENCDEC_LOGIT_REL_L2
# (readings there: 0.0086 and 0.026), so that a kernel fault that moves
# many logits a little still fails.  The same step with the params, the
# cache and the compute in f32 on both sides is held to ENCDEC_F32_REL_L2:
# the bf16 gap closes there if it is the models' rounding, not the kernel.
ENCDEC_LOGIT_TOL, ENCDEC_LOGIT_REL_L2, ENCDEC_F32_REL_L2 = 5e-2, 5e-2, 1e-3
# Training at the published sizes in f32 through make_train_step:
# (arch, batch, text tokens, frames or patches a row, the frontend's key).
ENCDEC_TRAIN = (("whisper-small", 4, 448, 1500, "frames"),
                ("internvl2-2b", 2, 1792, 256, "patches"))
# The error study of Ŝ (distr_scores) at d = 128, N = 2048: these G*.
SCORE_GROUPS = (2, 4, 8)
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


# The ring phase (context-parallel attention, ``distributed/ring_attention.py``):
# RING_WORLD ranks as processes that share cuda:0 on the gloo backend (NCCL
# puts no two ranks on one device), every hop's K and V staged through
# pinned host buffers.  One card checks what the ring computes, not its
# speed across cards.
RING_WORLD = 4
RING_N = 4 * 2048
# Ragged: shards of 1920 rows, the last one 1432 rows live (causal and
# non-causal: only the non-causal ring needs the kernels' kv_len mask on
# the tail shard, the causal mask hides its padded keys anyway).
RING_RAGGED_N = 4 * 2048 - 1000
# (label, query heads, KV heads, head dim): starcoder2-7b's serving widths
# and minicpm-2b's training widths.
RING_WIDTHS = (("starcoder2-7b", 36, 4, 128), ("minicpm-2b", 36, 36, 64))
RING_SMALL = ("small", 4, 2, 64)  # the f32 case, at N = 1024
RING_SMALL_N = 1024
# The reference ring test's tolerances (tests/test_distributed.py): the
# largest |ring − single device| on O, and on the gradients of q, k and v.
RING_TOL = {"bfloat16": (2e-2, 2e-1), "float32": (2e-5, 5e-5)}
# They were set at N = 300.  At N = 8192 the bf16 values compared are about
# as small as them (|O| ≈ 0.02 non-causal), so each tensor is also held to
# its own scale: its largest error at most RING_REL[dtype][0] of the
# single-device tensor's largest |value| (2^-5: at least four bf16 ulps of
# it; the ring's errors are one ulp of some element), and its relative L2
# error at most RING_REL[dtype][1] (a tail shard whose padded keys are not
# masked shrinks O by ≈ 4%; a lost hop, or a dK / dV that does not come
# home, moves a shard's rows by tens of percent).
RING_REL = {"bfloat16": (2.0 ** -5, 1e-2), "float32": (1e-5, 1e-5)}
RING_DEAD = (3,)
# minicpm-2b under the context mesh, each impl: RING_LAYERS_CHECKED layers'
# attention output, spread from the first layer to the last
# (``models/attention.py::attention_apply`` through attend →
# _ring_dispatch), on the single-device forward's input to that layer,
# against the single-device attention on the same input, relative L2 at
# most RING_LAYER_TOL.  Both see the same q, so DistrAttention groups alike
# and only rounding differs; a lost hop moves a shard's rows by tens of
# percent.  The whole 40-layer forward under the mesh is held to finite
# hidden states and the ring's launches; its relative L2 from the
# single-device forward and the last position's argmax are reported only:
# over 40 layers bf16 roundings, and the LSH sign flips they cause under
# DistrAttention, move it as far as a fault would (on one H100: 0.0173
# flash, 0.0844 distr).
RING_LAYER_TOL = 1e-2
# On one H100 each of the 40 layers read 0.00265–0.00273 under both impls,
# at ≈ 0.2 s of host staging a layer; 8 of them keep the phase near a minute.
RING_LAYERS_CHECKED = 8
RING_IMPLS = ("pallas_flash", "pallas_distr")
RING_ITERS = 3
RING_KERNELS = ("flash", "distr", "delta", "flash_dq", "flash_dkv", "distr_dq", "distr_dkv")


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


def free_card(torch, what: str, gate: bool = True, base: int | None = None) -> None:
    """After a phase has dropped its weights and engines: run the cycle
    collector, log how much card memory it freed, and with ``gate`` raise
    if that passes CYCLE_SLACK (the serving engines hold none in a
    reference cycle, so ``del`` alone frees their weights and caches); then
    return the cached blocks to the driver.  Training phases log without
    the gate: in the first training step of a process, torch's lazy setup
    under ``torch._disable_dynamo`` leaves that step's frames in a cycle
    that only the collector frees.  With ``base`` (the bytes allocated
    before the phase) raise if more than CYCLE_SLACK above it is still
    allocated after the collector, naming the tensors it finds alive."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gc.collect()
    left = torch.cuda.memory_allocated()
    cyclic = held - left
    log(f"[memory] after {what}: {held / 2**30:.2f} GiB allocated, {cyclic} bytes of it "
        "freed by the cycle collector" + ("" if base is None else
                                          f"; {(left - base) / 2**20:.1f} MiB above the "
                                          "phase's start"))
    if gate and cyclic > CYCLE_SLACK:
        raise AssertionError(f"after {what}: reference cycles held {cyclic / 2**30:.2f} GiB "
                             "of card memory")
    if base is not None and left - base > CYCLE_SLACK:
        alive = sorted(((t.numel() * t.element_size(), tuple(t.shape), str(t.dtype))
                        for t in gc.get_objects()
                        if isinstance(t, torch.Tensor) and t.is_cuda), reverse=True)
        raise AssertionError(f"after {what}: {(left - base) / 2**30:.2f} GiB of card memory "
                             f"still allocated; the largest tensors alive: {alive[:10]}")
    torch.cuda.empty_cache()


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


def prefill_phase(torch, flush, hq: int = 36, hkv: int = 4, ns=PREFILL_NS, label: str = "",
                  train_shape: bool = True) -> dict:
    """Flash and DistrAttention kernels at the prefill shapes of
    starcoder2-7b: B·Hq = 36, Hkv = 4, d = 128, G* = 2, causal, bf16 (or
    ``hq`` over ``hkv`` at the lengths ``ns``, the model ``label`` names;
    then without the training shape)."""
    import torch.nn.functional as F

    from repro_torch.core.distr_attention import DistrConfig
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import attention_cost, attention_work

    d, g = 128, 2
    tag = f" {label}" if label else ""
    dcfg = DistrConfig(group_size=g, block_q=128)
    scale = d ** -0.5
    out = {"flash": {"max_abs_err": 0.0}, "distr": {"max_abs_err": 0.0}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in ns:
        q = torch.randn((1, hq, n, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((1, hkv, n, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((1, hkv, n, d), generator=gen, device="cuda").to(torch.bfloat16)
        qf, kf, vf = q[0].contiguous(), k[0].contiguous(), v[0].contiguous()
        kw = dict(q_per_kv=hq // hkv, scale=scale, causal=True, kv_len=n)
        got = fk.flash_attention_kernel_call(qf, kf, vf, **kw)
        want = fk.flash_attention_plain(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        err_f = check_close(torch, f"flash{tag} N={n}", got, want, TOL["flash"])

        qp = ops.pad_to_multiple(q, dcfg.block_q, dim=2)
        q_hat, perms = ops.distr_stage1(dcfg, qp, scale, hkv=hkv)
        q_hat = q_hat[0].contiguous()
        perm = perms[0].to(torch.int32).contiguous()
        dkw = dict(q_per_kv=hq // hkv, causal=True, group_size=g,
                   block_q=dcfg.block_q, kv_len=n)
        got_d = dk.distr_attention_kernel_call(q_hat, kf, vf, perm, **dkw)
        want_d = dk.distr_attention_plain(q_hat, kf, vf, perm, **dkw)
        torch.cuda.synchronize()
        err_d = check_close(torch, f"distr{tag} N={n}", got_d, want_d, TOL["distr"])
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
        log(f"[prefill{tag} N={n}] flash err {err_f:.3e} {t['flash_ms']:.3f} ms "
            f"(plain {t['flash_plain_ms']:.3f}, sdpa {t['sdpa_ms']:.3f}, bound "
            f"{bounds['flash']['bound_ms']:.4f}, {bounds['flash']['utilization']:.1%} of it; "
            f"model {bounds['flash']['model_bound_ms']:.4f}) | distr err {err_d:.3e} "
            f"{t['distr_ms']:.3f} ms (plain {t['distr_plain_ms']:.3f}, bound "
            f"{bounds['distr']['bound_ms']:.4f}, {bounds['distr']['utilization']:.1%} of it; "
            f"model {bounds['distr']['model_bound_ms']:.4f})")
        out.setdefault("shapes", []).append(
            {"n": n, **t, **{f"{k}_{c}": bounds[k][c] for k in bounds
                             for c in ("bound_ms", "model_bound_ms")}})
        if n == max(ns):  # the headline shape of the JSON line
            out["flash"].update(ms=t["flash_ms"], plain_ms=t["flash_plain_ms"],
                                library_ms=t["sdpa_ms"], **bounds["flash"])
            out["distr"].update(ms=t["distr_ms"], plain_ms=t["distr_plain_ms"],
                                library_ms=None, **bounds["distr"])
    if train_shape:
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


def decode_phase(torch, flush, hq: int = 36, hkv: int = 4, label: str = "", *, d: int = 128,
                 s: int = 2048, lengths=DECODE_LENGTHS, q_lens=(1, 2),
                 score_widths=None) -> dict:
    """The split-K decode kernel at the decode shape of starcoder2-7b:
    B = 4 slots, Hq = 36 over Hkv = 4, S = 2048, lengths {1, 200, 1537,
    2048}, q_len 1 and 2, score width 128 and 64 (fused K̂), bf16 (or
    ``hq`` over ``hkv``, value width ``d``, ``s`` cache positions, one slot
    a length of ``lengths``, ``q_lens`` and ``score_widths`` (default d and
    d/2) at the shape the model ``label`` names).  Timed at q_len 1 and
    score width d, the serving path's shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode as dec
    from repro_torch.kernels.ops import DEFAULT_DECODE_BLOCK, _pack_gqa_rows
    from repro_torch.roofline.analysis import decode_attention_cost, decode_attention_work

    b, bk = len(lengths), min(DEFAULT_DECODE_BLOCK, s)
    tag = f" {label}" if label else ""
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"max_abs_err": 0.0}
    for q_len in q_lens:
        for ds in score_widths or (d, d // 2):
            q = torch.randn((b, hq, q_len, ds), generator=gen, device="cuda").to(torch.bfloat16)
            k = torch.randn((b, hkv, s, ds), generator=gen, device="cuda").to(torch.bfloat16)
            v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
            qp = _pack_gqa_rows(q, hkv)
            kw = dict(scale=d ** -0.5, block_k=bk, q_len=q_len)
            got = dec.merge_splits(*dec.decode_kernel_call(qp, k, v, lens, **kw))
            want = dec.merge_splits(*dec.decode_plain(qp, k, v, lens, **kw))
            torch.cuda.synchronize()
            err = check_close(torch, f"decode{tag} q_len={q_len} d_score={ds}", got, want,
                              TOL["decode"])
            out["max_abs_err"] = max(out["max_abs_err"], err)
            log(f"[decode{tag} q_len={q_len} d_score={ds}] err {err:.3e}")
            if q_len == 1 and ds == d:  # the serving path's shape
                mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])
                mask = mask[:, None, None, :]
                kx = k.repeat_interleave(hq // hkv, dim=1)
                vx = v.repeat_interleave(hq // hkv, dim=1)
                ms = time_ms(torch, lambda: dec.decode_kernel_call(qp, k, v, lens, **kw), 20, flush)
                plain_ms = time_ms(torch, lambda: dec.decode_plain(qp, k, v, lens, **kw), 5, flush)
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask), 20, flush)
                cost = summed(decode_attention_cost(1, hq, hkv, n, s, d, block_k=bk)
                              for n in lengths)
                out.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           **roofline(decode_attention_work(lengths, hq, hkv, d, s),
                                      ms, cost))
                log(f"[decode{tag} serve shape] {ms:.4f} ms (plain {plain_ms:.4f}, sdpa "
                    f"{lib_ms:.4f}, bound {out['bound_ms']:.4f}, model "
                    f"{out['model_bound_ms']:.4f})")
    return out


def encdec_decode_phase(torch, flush) -> dict:
    """The decode kernel at the shapes the enc-dec and VLM serving steps
    give it (ENCDEC_DECODE_SHAPES), q_len 1 at score width d, each held
    element by element against ``decode_plain`` at TOL["decode"] and timed
    with its bound, before any model runs them."""
    shapes, err = {}, 0.0
    for label, hq, hkv, d, s, lengths in ENCDEC_DECODE_SHAPES:
        res = decode_phase(torch, flush, hq=hq, hkv=hkv, label=label, d=d, s=s,
                           lengths=lengths, q_lens=(1,), score_widths=(d,))
        shapes[label] = {"hq": hq, "hkv": hkv, "d": d, "s": s, "lengths": list(lengths), **res}
        err = max(err, res["max_abs_err"])
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "shapes": shapes}


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


def paged_kernel_phase(torch, flush, hq: int = 36, hkv: int = 4, label: str = "") -> dict:
    """The paged decode kernel at the serving shape: B = 8, Hq 36 over Hkv 4
    (or ``hq`` over ``hkv``, the model ``label`` names),
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

    b, d, bs, mb = len(PAGED_LENGTHS), 128, 128, 16
    tag = f" {label}" if label else ""
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
            err = max(check_close(torch, f"paged{tag} q_len={q_len} d_score={ds} {name}", g_, w_,
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
            log(f"[paged{tag} q_len={q_len} d_score={ds}] {ms:.4f} ms (plain {plain_ms:.4f}, sdpa "
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


def ssd_grad_phase(torch) -> dict:
    """``ops.ssd`` with a gradient (the ``_SSD`` autograd Function: the SSD
    kernel forward, the chunked ``models/mamba.py::ssd_chunked`` backward)
    against autograd through the kernel's plain version ``ssd_plain`` on
    the same inputs, at SSD_GRAD_SHAPE, in f32 and bf16 (x, b, c; the
    log-decays a = −softplus(N(0, 1)) f32), with a seeded f32 cotangent of
    y: dx, da, db and dc held element by element at SSD_GRAD_TOL.  The
    forward must launch the kernel once and the backward never.  Forward
    plus backward timed on both sides (host clock around a synchronised
    call)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd as sk

    bsz, n, h, p, g, s, chunk = SSD_GRAD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {"shape": SSD_GRAD_SHAPE}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        ins = [torch.randn(shape, generator=gen, device="cuda") for shape in
               ((bsz, n, h, p), (bsz, n, h), (bsz, n, g, s), (bsz, n, g, s))]
        ins = [ins[0].to(dtype), -torch.nn.functional.softplus(ins[1]), ins[2].to(dtype),
               ins[3].to(dtype)]
        wy = torch.randn((bsz, n, h, p), generator=gen, device="cuda")

        def plain(x, a, b, c):
            y = sk.ssd_plain(x.transpose(1, 2).reshape(bsz * h, n, p),
                             a.transpose(1, 2).reshape(bsz * h, n),
                             b.transpose(1, 2).reshape(bsz * g, n, s),
                             c.transpose(1, 2).reshape(bsz * g, n, s),
                             heads_per_group=h // g, chunk=chunk)
            return y.reshape(bsz, h, n, p).transpose(1, 2)

        grads, secs, launched = {}, {}, {}
        for side, fn in (("op", lambda *t: ops.ssd(*t, chunk=chunk)), ("plain", plain)):
            for rep in range(2):  # the first pass warms up
                xs = [t.detach().clone().requires_grad_(True) for t in ins]
                torch.cuda.synchronize()
                before = sk.launches
                t0 = time.perf_counter()
                y = fn(*xs)
                fwd = sk.launches - before
                (y.float() * wy).sum().backward()
                torch.cuda.synchronize()
                secs[side] = time.perf_counter() - t0
                launched[side] = (fwd, sk.launches - before)
            grads[side] = [t.grad for t in xs]
        if launched["op"] != (1, 1) or launched["plain"] != (0, 0):
            raise AssertionError(f"ssd grad {name}: launches (forward, forward + backward) "
                                 f"{launched}")
        tol = SSD_GRAD_TOL[name]
        errs = {}
        for arg, got, want in zip("xabc", grads["op"], grads["plain"]):
            got, want = got.float(), want.float()
            scale = max(1.0, float(want.abs().max()))
            torch.testing.assert_close(got, want, atol=tol * scale, rtol=tol,
                                       msg=lambda m, arg=arg: f"ssd grad {name} d{arg}: {m}")
            err = float((got - want).abs().max())
            share = float(((got - want).abs() / (tol * scale + tol * want.abs())).max())
            errs[f"d{arg}"] = {"max_abs_err": err, "largest": scale, "share": share}
        log(f"[ssd grad {name}] B={bsz} N={n} H={h} P={p} S={s}: {errs}; fwd + bwd "
            f"{secs['op'] * 1e3:.2f} ms (plain autograd {secs['plain'] * 1e3:.2f} ms)")
        out[name] = {"errors": errs, "op_ms": secs["op"] * 1e3, "plain_ms": secs["plain"] * 1e3}
        del ins, grads, wy
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


def scores_phase(torch, q, k, v, label: str, proj=None, block_q: int = 128) -> dict:
    """The error study of Ŝ (``core.distr_scores``, the paper's Tables 3-4)
    on q, k (1, H, N, d): mean |Ŝ − S| / mean |S| for each G* of
    SCORE_GROUPS, S = q·kᵀ in f32, Q blocks of ``block_q`` hashed with
    ``proj``; and on q, k, v in bf16 the
    DistrAttention forward kernel's output beside the flash kernel's, max
    and mean |O_distr − O_flash| (causal).  Gates: every value finite, and
    the Ŝ error growing with G*."""
    from repro_torch.core import distr_scores
    from repro_torch.core.distr_attention import DistrConfig
    from repro_torch.kernels import ops

    s_exact = q.float() @ k.float().transpose(-1, -2)
    mean_s = float(s_exact.abs().mean())
    o_flash = ops.flash_attention(q, k, v, causal=True).float()
    rows = []
    for g in SCORE_GROUPS:
        cfg = DistrConfig(group_size=g, block_q=block_q)
        s_hat = distr_scores(q, k, cfg, proj=proj)
        rel = float((s_hat - s_exact).abs().mean()) / mean_s
        o_distr = ops.distr_attention(q, k, v, cfg, causal=True, proj=proj).float()
        diff = (o_distr - o_flash).abs()
        row = {"group_size": g, "s_rel_err": rel, "o_max_abs_diff": float(diff.max()),
               "o_mean_abs_diff": float(diff.mean()),
               "finite": bool(torch.isfinite(s_hat).all() and torch.isfinite(o_distr).all())}
        rows.append(row)
        log(f"[scores {label}] G*={g}: mean |S^ - S| / mean |S| = {rel:.6f}; |O_distr - "
            f"O_flash| max {row['o_max_abs_diff']:.6f} mean {row['o_mean_abs_diff']:.6f}")
        del s_hat, o_distr, diff
    rels = [r["s_rel_err"] for r in rows]
    if not all(r["finite"] for r in rows) or not torch.isfinite(o_flash).all():
        raise AssertionError(f"scores {label}: non-finite values: {rows}")
    if any(b <= a for a, b in zip(rels, rels[1:])):
        raise AssertionError(f"scores {label}: the S^ error does not grow with G*: {rels}")
    return {"label": label, "shape": list(q.shape), "rows": rows}


def layer0_qkv(torch, cfg, params, tokens):
    """Layer 0's q, k, v (1, H, N, d) after the QKV bias and RoPE, as the
    model's prefill computes them, for the prompt ``tokens`` (1, N)."""
    from repro_torch.models import attention as attn
    from repro_torch.models import layers, lm, transformer

    p0 = params["blocks"][0]
    h = transformer.norm_apply(p0["norm1"], lm.embed(params, cfg, tokens), cfg)
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
    q = attn._split_heads(layers.linear_apply(p0["attn"]["wq"], h), cfg.n_heads)
    k = attn._split_heads(layers.linear_apply(p0["attn"]["wk"], h), cfg.n_kv_heads)
    v = attn._split_heads(layers.linear_apply(p0["attn"]["wv"], h), cfg.n_kv_heads)
    return (layers.apply_rope(q, pos, cfg.rope_theta), layers.apply_rope(k, pos, cfg.rope_theta),
            v)


def cache_bytes_per_token(cfg) -> int:
    """Bytes of bf16 cache a token takes across the model's layers: K and V
    for GQA, c_kv and k_rope for MLA."""
    if cfg.use_mla:
        return cfg.n_layers * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    return 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim_ * 2


SLOT_IMPLS = (("pallas_distr", "distr"), ("pallas_flash", "flash"))


def model_serve_phase(torch, arch: str, n_layers: int | None = None, scores: bool = False,
                      slot_impls=SLOT_IMPLS, paged: bool = True) -> dict:
    """A config at full width (``n_layers`` of its layers when given),
    seeded random bf16 weights initialised on the card, serving
    starcoder2-7b's workload (6 requests, prompts SERVE_PROMPTS, 32 new
    tokens, greedy, max_len 2048): on the slot engine (4 slots) through the
    launcher's run function under each impl of ``slot_impls`` (impl, the
    prefill kernel it must launch, or None for none), then with ``paged``
    on ``PagedServeEngine`` (4 lanes, a raw-K pool of 128-token blocks,
    chunks of 32) under pallas_flash.  Every request must end ``done`` with
    32 tokens; each slot run must launch its prefill kernel and, unless it
    launches no kernel at all (MLA, whose attention is plain PyTorch), the
    decode kernel; the paged run the paged kernel and none of the others.
    With ``scores`` it then runs ``scores_phase`` on layer 0's q, k, v for
    a 2048-token prompt drawn as the workload draws its prompts.  The
    weights are freed before it returns."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.launch.serve import run
    from repro_torch.models import lm
    from repro_torch.serve.engine import PagedServeEngine

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm.trainable(params))
    kv_token = cache_bytes_per_token(cfg)
    allocated = torch.cuda.memory_allocated()
    log(f"[{arch}] {cfg.n_layers} layers, {n_params} params (bf16) on the card in "
        f"{time.perf_counter() - t0:.1f}s, {allocated / 2**30:.2f} GiB "
        f"allocated; {'MLA' if cfg.use_mla else 'KV'} cache {kv_token} bytes a token")
    launches = {"flash": 0, "distr": 0, "decode": 0, "paged": 0}
    report = {"n_layers": cfg.n_layers, "n_params": n_params, "allocated": allocated,
              "cache_bytes_per_token": kv_token}

    def gate(name, done, counts, path):
        bad = [r.uid for r in done if r.status != "done" or len(r.generated) != 32]
        if len(done) != len(SERVE_PROMPTS) or bad:
            raise AssertionError(f"{arch} {name}: requests not done: {bad}")
        off = [k for k in counts if k not in path and counts[k]]
        if any(counts[k] == 0 for k in path) or off:
            raise AssertionError(f"{arch} {name}: launches off the path: {counts}")
        for k in path:
            launches[k] += counts[k]

    res = None
    for impl, kernel in slot_impls:
        cfg_i = cfg.replace(attention=cfg.attention.with_impl(impl))
        fk.launches = dk.launches = dec.launches = pd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res = run(cfg_i, params, max_new=32, max_slots=4, max_len=2048,
                  prompt_lens=list(SERVE_PROMPTS), device="cuda")
        peak = torch.cuda.max_memory_allocated()
        counts = {"flash": fk.launches, "distr": dk.launches, "decode": dec.launches,
                  "paged": pd.launches}
        log(f"[{arch} serve {impl}] {len(res['done'])} requests, {res['tokens']} tokens in "
            f"{res['seconds']:.2f}s ({res['tok_per_s']:.1f} tok/s); peak allocated "
            f"{peak / 2**30:.2f} GiB; launches {counts}")
        for m in res["metrics"]:
            log(f"  req {m['uid']}: status {m['status']} ttft {m['ttft_s']:.4f}s "
                f"tpot {m['tpot_s']:.4f}s n={m['n_generated']}")
        gate(f"serve {impl}", res["done"], counts,
             (kernel, "decode") if kernel is not None else ())
        report[impl] = {"seconds": res["seconds"], "tokens": res["tokens"],
                        "tok_per_s": res["tok_per_s"], "peak_allocated": peak,
                        "launches": counts, "metrics": res["metrics"]}

    if paged:
        flash = cfg.replace(attention=cfg.attention.with_impl("pallas_flash"))
        eng = PagedServeEngine(flash, params, max_batch=4, max_len=2048, block_size=128,
                               prefill_chunk=32, device="cuda")
        pool_gib = sum(t.numel() * t.element_size() for t in eng.cache.pools.values()) / 2**30
        rng = np.random.default_rng(0)  # the prompts launch.serve.run draws
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.launches = dk.launches = dec.launches = pd.launches = 0
        t0 = time.perf_counter()
        for n in SERVE_PROMPTS:
            eng.add_request(rng.integers(1, cfg.vocab, size=n).tolist(), max_new_tokens=32)
        done = eng.run_to_completion()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = {"flash": fk.launches, "distr": dk.launches, "decode": dec.launches,
                  "paged": pd.launches}
        n_tok = sum(len(r.generated) for r in done)
        metrics = eng.metrics()
        log(f"[{arch} paged raw-K] {len(done)} requests, {n_tok} tokens in {seconds:.2f}s "
            f"({n_tok / seconds:.1f} tok/s); pool {pool_gib:.3f} GiB of "
            f"{eng.cache.pool.num_blocks} blocks; peak allocated {peak / 2**30:.2f} GiB; "
            f"launches {counts}")
        for m in metrics:
            log(f"  req {m['uid']}: status {m['status']} ttft {m['ttft_s']:.4f}s tpot "
                f"{m['tpot_s']:.4f}s n={m['n_generated']}")
        gate("paged raw-K", done, counts, ("paged",))
        report["paged_raw_k"] = {"seconds": seconds, "tokens": n_tok,
                                 "tok_per_s": n_tok / seconds, "pool_gib": pool_gib,
                                 "peak_allocated": peak, "launches": counts,
                                 "metrics": metrics}
        del eng
    if scores:
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            1, cfg.vocab, size=(1, max(PREFILL_NS)))).to("cuda")
        with torch.no_grad():
            q, k, v = layer0_qkv(torch, cfg, params, toks)
        report["scores"] = scores_phase(torch, q, k, v, f"{arch} layer 0",
                                        proj=params["lsh_proj"],
                                        block_q=cfg.attention.distr.resolved().block_q)
        del q, k, v
    del params, res  # the last slot run's engine holds the weights and its cache
    free_card(torch, arch)
    return {"launches": launches, "report": report}


def moe_check_phase(torch) -> dict:
    """One MoE layer of each MoE config at full width (seeded random bf16
    weights on the card, the router f32), at its prefill call (T = 2048)
    and a decode step's (T = 4): the index dispatch of ``moe_apply``
    against the reference's one-hot dispatch (``moe_apply_onehot``) on the
    same bf16 x.  Each call's routed expert ids must be identical, y must
    agree element by element within MOE_TOL (``check_close``) and the aux
    losses within 1e-6; the dropped assignments are counted.  Times both
    forms (CUDA events, MOE_ITERS calls)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    rows = []
    for arch, _ in MOE_SERVE:
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(3)
        params = moe.moe_init(gen, cfg, torch.bfloat16)
        weight_gib = sum(t.numel() * t.element_size()
                         for t in params["experts"].values()) / 2**30
        chunk = moe._expert_chunk(params["experts"])
        for b, s in ((1, max(PREFILL_NS)), (4, 1)):
            t = b * s
            label = f"moe {arch} T={t}"
            x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
            with torch.no_grad():
                got, aux, ids = moe.moe_routed(params, x, cfg)
                want, aux_plain, ids_plain = moe.moe_routed(params, x, cfg, onehot=True)
                cap = moe.capacity(cfg, t)
                dropped = int((moe.queue_ranks(ids, cfg.n_experts) >= cap).sum())
                ms = time_moe(torch, lambda: moe.moe_apply(params, x, cfg))
                plain_ms = time_moe(torch, lambda: moe.moe_apply_onehot(params, x, cfg))
            if not torch.equal(ids, ids_plain):
                raise AssertionError(f"{label}: the two dispatches routed different experts")
            err = check_close(torch, label, got, want, MOE_TOL)
            if abs(float(aux) - float(aux_plain)) > 1e-6:
                raise AssertionError(f"{label}: aux {float(aux)} != {float(aux_plain)}")
            row = {"arch": arch, "tokens": t, "capacity": cap, "dropped": dropped,
                   "assignments": t * cfg.moe_top_k, "max_abs_err": err, "aux": float(aux),
                   "ms": ms, "plain_ms": plain_ms, "expert_weights_gib": weight_gib,
                   "experts_per_upcast_chunk": chunk}
            log(f"[{label}] capacity {cap}, {dropped} of {t * cfg.moe_top_k} assignments "
                f"dropped; expert ids identical; index vs one-hot max |dy| {err:.3e}; aux "
                f"{float(aux):.6f}; {ms:.3f} ms vs one-hot {plain_ms:.3f} ms; experts "
                f"{weight_gib:.2f} GiB bf16, {chunk} to an f32 upcast chunk")
            rows.append(row)
            del x, got, want, ids, ids_plain
        del params
        free_card(torch, f"moe check {arch}")
    return {"rows": rows}


def moe_phases(torch) -> dict:
    """The MoE check, then each MoE config served at full width cut in depth
    (MOE_SERVE): llama4-scout-17b-a16e on the slot engine under both kernel
    impls and on ``PagedServeEngine``; deepseek-v2-236b (MLA) on the slot
    engine under MLA_IMPLS, launching no attention kernel; then both
    trained (``moe_train_phase``)."""
    from repro_torch.configs import get_config

    results = {"moe_check": moe_check_phase(torch)}
    launches: dict = {}
    for arch, n_layers in MOE_SERVE:
        mla = get_config(arch).use_mla
        res = model_serve_phase(torch, arch, n_layers,
                                slot_impls=MLA_IMPLS if mla else SLOT_IMPLS, paged=not mla)
        results[f"{arch} serve"] = res["report"]
        for name, count in res["launches"].items():
            launches[name] = launches.get(name, 0) + count
    train = moe_train_phase(torch)
    results["moe train"] = train["report"]
    for name, count in train["launches"].items():
        launches[name] = launches.get(name, 0) + count
    return {"results": results, "launches": launches}


def moe_train_phase(torch, device="cuda", configs=MOE_TRAIN, steps=TRAIN_STEPS) -> dict:
    """Each MOE_TRAIN config under pallas_distr, seeded random f32 params,
    trained ``steps`` steps through the launcher's run function (AdamW,
    full remat; every param, grad and moment on the card).  Raises if a
    loss or grad norm is not finite, a step was skipped, card memory is not
    back at the run's start once its params are dropped, or the launches
    leave the path: llama4-scout-17b-a16e runs the DistrAttention forward
    at least once a layer and step (again in the recompute) and delta, dq
    and dkv once, and no other kernel; deepseek-v2-236b's MLA runs no
    kernel at all, as in the reference.  Logs the step times, tok/s after
    the warm-up step and the peak allocated memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import init_train_params, run
    from repro_torch.models import lm
    from repro_torch.serve.graphs import LaunchCounters

    counters = LaunchCounters()
    launches = {"distr": 0, "delta": 0, "distr_dq": 0, "distr_dkv": 0}
    report = {}
    for arch, reduced, n_layers, batch, seq in configs:
        cfg = get_config(arch, reduced=reduced)
        if n_layers is not None:
            cfg = cfg.replace(n_layers=n_layers)
        cfg = cfg.replace(attention=cfg.attention.with_impl("pallas_distr"))
        name = f"{arch}{' reduced()' if reduced else ''} {cfg.n_layers} layer(s)"
        base = torch.cuda.memory_allocated() if device == "cuda" else None
        t0 = time.perf_counter()
        params = init_train_params(cfg, seed=0, device=device)
        n_params = sum(t.numel() for t in lm.trainable(params))
        if device == "cuda":
            torch.cuda.synchronize()
        log(f"[train {name}] {n_params} params (f32) on {device} in "
            f"{time.perf_counter() - t0:.1f}s; f32 params, grads and AdamW moments "
            f"{16 * n_params / 2**30:.2f} GiB")
        before = counters.read()
        res = run(cfg, params, steps=steps, batch=batch, seq=seq, lr=1e-3, seed=0,
                  device=device)
        after = counters.read()
        counts = {k: after[k] - before[k] for k in after}
        hist = res["history"]
        peak = res["max_memory_allocated"]
        steady = res["step_times"][1:]
        step_s = sum(steady) / len(steady)
        log(f"[train {name}] losses {[r['loss'] for r in hist]} grad norms "
            f"{[r['grad_norm'] for r in hist]}")
        log(f"[train {name}] {batch} x {seq} tokens a step; step times {res['step_times']} s; "
            f"mean steady step {step_s:.4f} s; {res['tok_per_s']:.1f} tok/s after the warm-up "
            f"step; peak allocated {(peak or 0) / 2**30:.2f} GiB; launches {counts}")
        bad = [r for r in hist if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]))]
        if bad or res["nan_skips"] or len(hist) != steps:
            raise AssertionError(f"train {name}: non-finite or skipped steps: {bad}, "
                                 f"{res['nan_skips']} skipped, {len(hist)} of {steps} steps")
        if cfg.use_mla:
            on, per_step = {}, 0
        else:
            per_step = cfg.n_layers * steps
            on = {"backward.delta": per_step, "backward.distr_dq": per_step,
                  "backward.distr_dkv": per_step}
        fwd = counts["distr_attention"]
        if (any(counts[k] != n for k, n in on.items()) or fwd < per_step
                or (cfg.use_mla and fwd)
                or any(counts[k] for k in counts if k not in on and k != "distr_attention")):
            raise AssertionError(f"train {name}: launches off the path: {counts}")
        launches["distr"] += fwd
        for k in on:
            launches[k.split(".", 1)[1]] += counts[k]
        top = []
        if device == "cuda":
            # One more step of the same trainer under the profiler (its
            # launches not counted): the device's time and its largest ops.
            before = counters.read()
            top, device_ms = _device_ms_by_op(torch, res["trainer"].step_once)
            after = counters.read()
            counters.add({k: before[k] - after[k] for k in after})
            log(f"[train {name}] profiled step: {device_ms:.1f} ms of device time "
                f"({device_ms / 1e3 / step_s:.1%} of the mean steady step); largest ops "
                + ", ".join(f"{op} {ms:.1f} ms" for op, ms in top[:6]))
        report[name] = {"n_params": n_params, "batch": batch, "seq": seq, "top_ops_ms": top[:10],
                        "losses": [r["loss"] for r in hist],
                        "grad_norms": [r["grad_norm"] for r in hist],
                        "step_times": res["step_times"], "step_s": step_s,
                        "tok_per_s": res["tok_per_s"], "max_memory_allocated": peak,
                        "launches": counts}
        del params, res
        if device == "cuda":
            free_card(torch, f"{name} training", gate=False, base=base)
    return {"launches": launches, "report": report}


def time_moe(torch, fn) -> float:
    """Milliseconds a call of ``fn`` (CUDA events over MOE_ITERS calls after
    one warm-up; the expert weights exceed the L2 cache, so no flush)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(MOE_ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / MOE_ITERS


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
            else:
                eng = PagedServeEngine(cfg, params, max_batch=8, max_len=2048, block_size=128,
                                       prefill_chunk=32, device=device, trace=rec)
            # Both engines call their decode graph once a decode step.
            step_fn, steps = eng._decode, [0]

            def counted(*args, step_fn=step_fn, steps=steps):
                steps[0] += 1
                return step_fn(*args)

            eng._decode = counted
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


def tune_phase(torch, params) -> dict:
    """The block-size tuner under ``REPRO_TUNE=measure`` with a fresh cache
    in a temporary directory (``REPRO_TUNE_CACHE``) at starcoder2-7b's
    serving shapes: the slot engine's warm-up (``tune.warm_engine``: the
    prefill buckets, whose flash tile is compiled and only recorded, and the
    decode split at capacity 2048, swept over DECODE_LENGTHS' 4 slots of 36
    over 4 heads of 128) and the paged engine's (the pool block size, swept
    over PAGED_LENGTHS' 8 lanes), each sweep table logged with every
    candidate's median, spread and the copies of K/V each run cycles
    through (over twice the L2), and whether the pick left the static 128.  The decode and paged kernels are held
    element-wise against their plain versions at the picked split and
    block, at the serving shapes (TOL["decode"]).  A ``PagedServeEngine``
    with ``block_size=None`` takes the picked block and serves the serve
    workload (SERVE_PROMPTS, 32 new tokens, pallas_flash, raw K) to
    completion; a second construction, by a fresh tuner, reads the JSON
    cache and sweeps nothing.  Raises if a sweep skipped a candidate, a
    check fails, a request is not done or the second construction swept."""
    import os

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels.ops import _pack_gqa_rows
    from repro_torch.obs.trace import TraceRecorder, set_recorder
    from repro_torch.serve.engine import PagedServeEngine
    from repro_torch.tune import (decode_candidates, paged_block_candidates, reset_autotuner,
                                  warm_engine, warm_paged_engine)

    base = get_config("starcoder2-7b")
    cfg = base.replace(attention=base.attention.with_impl("pallas_flash"))
    d, hq, hkv, s = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads, 2048
    tmp = tempfile.mkdtemp(prefix="repro_torch_tune_")
    saved = {k: os.environ.get(k) for k in ("REPRO_TUNE", "REPRO_TUNE_CACHE")}
    os.environ.update(REPRO_TUNE="measure", REPRO_TUNE_CACHE=os.path.join(tmp, "tune.json"))
    rec = TraceRecorder()
    set_recorder(rec)
    reset_autotuner(None)
    report, launches = {}, {"paged": 0}
    try:
        t0 = time.perf_counter()
        slot = warm_engine(cfg, s, device="cuda", lengths=DECODE_LENGTHS)
        paged = warm_paged_engine(cfg, s, device="cuda", lengths=PAGED_LENGTHS)
        warm_s = time.perf_counter() - t0
        bk, bs = slot["decode"].decode(), paged["paged_decode"]
        entries = json.loads(Path(os.environ["REPRO_TUNE_CACHE"]).read_text())
        for key, entry in sorted(entries.items()):
            log(f"[tune] {key}: best {entry['best']}"
                + ("" if entry.get("compiled") else
                   f" (static {entry['default']}, {entry['calls']} K/V copies a run)")
                + "; " + ", ".join(
                    f"{r['candidate']}: " + ("compiled" if r["seconds"] is None else
                                             f"{r['seconds'] * 1e3:.5f} ± "
                                             f"{r['spread'] * 1e3:.5f} ms")
                    for r in entry["table"]))
        sweeps = {e["kernel"]: e for e in entries.values() if not e.get("compiled")}
        want = {"decode": decode_candidates(s), "paged_decode": paged_block_candidates(s)}
        for kernel, cands in want.items():
            timed = sorted(r["candidate"] for r in sweeps[kernel]["table"])
            if timed != sorted(cands) or not all(
                    math.isfinite(r["seconds"]) and r["seconds"] > 0
                    for r in sweeps[kernel]["table"]):
                raise AssertionError(f"tune {kernel}: timed {timed} of {cands}")
        n_measure = sum(e["name"] == "tune/measure" for e in rec.events)
        log(f"[tune] warm-ups {warm_s:.1f}s, {n_measure} sweeps; decode split {bk} "
            f"({slot['decode'].num_splits} splits), paged block {bs}; {gpu_name_and_power()}")
        if n_measure != 2:
            raise AssertionError(f"tune: {n_measure} sweeps, want the decode and paged keys")

        # The kernels at the picked values against their plain versions.
        gen = torch.Generator(device="cuda").manual_seed(11)
        err = {"decode": 0.0, "paged": 0.0}
        lens = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
        q = torch.randn((len(DECODE_LENGTHS), hq, 1, d), generator=gen,
                        device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((len(DECODE_LENGTHS), hkv, s, d), generator=gen,
                            device="cuda").to(torch.bfloat16) for _ in range(2))
        kw = dict(scale=d ** -0.5, block_k=bk, q_len=1)
        qp = _pack_gqa_rows(q, hkv)
        got = dec.merge_splits(*dec.decode_kernel_call(qp, k, v, lens, **kw))
        plain = dec.merge_splits(*dec.decode_plain(qp, k, v, lens, **kw))
        err["decode"] = check_close(torch, f"tune decode block_k={bk}", got, plain, TOL["decode"])
        b = len(PAGED_LENGTHS)
        mb = -(-max(PAGED_LENGTHS) // bs)
        k_pool, v_pool = (torch.randn((1 + b * mb, hkv, bs, d), generator=gen,
                                      device="cuda").to(torch.bfloat16) for _ in range(2))
        tables = (torch.randperm(b * mb, generator=gen, device="cuda") + 1).reshape(b, mb)
        tables = tables.to(torch.int32)
        plens = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device="cuda")
        for q_len in (1, 32):
            qc = torch.randn((b, hq, q_len, d), generator=gen, device="cuda").to(torch.bfloat16)
            kw = dict(scale=d ** -0.5, q_len=q_len)
            args = (_pack_gqa_rows(qc, hkv), k_pool, v_pool, tables, plens)
            got = dec.merge_splits(*pd.paged_decode_kernel_call(*args, **kw))
            plain = dec.merge_splits(*pd.paged_decode_plain(*args, **kw))
            err["paged"] = max(err["paged"], check_close(
                torch, f"tune paged block={bs} q_len={q_len}", got, plain, TOL["decode"]))
        del q, k, v, k_pool, v_pool, got, plain

        # The paged engine shaped by the tuner, serving the serve workload.
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab, size=n).tolist() for n in SERVE_PROMPTS]
        eng = PagedServeEngine(cfg, params, max_batch=4, max_len=s, block_size=None,
                               prefill_chunk=32, device="cuda")
        if eng.block_size != bs or eng.tuned_blocks != {"paged_decode": bs}:
            raise AssertionError(f"tune: engine block {eng.block_size}, {eng.tuned_blocks}; "
                                 f"picked {bs}")
        pd.launches = 0
        t0 = time.perf_counter()
        for p in prompts:
            eng.add_request(p, max_new_tokens=32)
        done = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["paged"] = pd.launches
        n_tok = sum(len(r.generated) for r in done)
        log(f"[tune] PagedServeEngine at block {bs}: {len(done)} requests, {n_tok} tokens in "
            f"{wall:.2f}s ({n_tok / wall:.1f} tok/s); paged launches {pd.launches}")
        if len(done) != len(prompts) or any(
                r.status != "done" or len(r.generated) != 32 for r in done) or not pd.launches:
            raise AssertionError("tune: the paged engine's requests are not done")
        del eng
        reset_autotuner(None)  # a fresh tuner: the second construction reads the file
        again = PagedServeEngine(cfg, params, max_batch=4, max_len=s, block_size=None,
                                 prefill_chunk=32, device="cuda")
        n_after = sum(e["name"] == "tune/measure" for e in rec.events)
        if again.block_size != bs or n_after != n_measure:
            raise AssertionError(f"tune: the second construction took block "
                                 f"{again.block_size} with {n_after - n_measure} new sweeps")
        log(f"[tune] a second PagedServeEngine read block {again.block_size} from the cache, "
            "no sweep")
        del again
        report = {"decode_block_k": bk, "paged_block_size": bs, "warm_s": warm_s,
                  "sweeps": {k: {f: e[f] for f in ("table", "default", "best", "calls")}
                             for k, e in sweeps.items()}, "max_abs_err": err,
                  "paged_serve_wall_s": wall, "paged_serve_tok_per_s": n_tok / wall}
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
        reset_autotuner(None)
        set_recorder(None)
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
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


def _device_ms_by_op(torch, run_one) -> tuple[list, float]:
    """Profile ``run_one()`` → ([(op, device ms)] largest first, all device
    ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_one()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us:
            ops[e.key] = ops.get(e.key, 0.0) + us / 1e3
    return sorted(ops.items(), key=lambda kv: -kv[1]), sum(ops.values())


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


def mamba_train_phase(torch) -> dict:
    """mamba2-130m at its published size (24 layers, d_model 768, tied
    embedding), seeded random f32 params, trained through the launcher's
    run function: TRAIN_STEPS steps of TRAIN_BATCH × TRAIN_N tokens, full
    remat, so each step runs the SSD kernel twice a layer (the forward and
    its recompute) and the chunked backward of ``ops.ssd``.  Raises if a
    loss or grad norm is not finite, a step was skipped, or the SSD kernel
    did not launch twice a layer and step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd as sk
    from repro_torch.launch.train import init_train_params, run
    from repro_torch.models import lm

    cfg = get_config("mamba2-130m")
    t0 = time.perf_counter()
    params = init_train_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm.trainable(params))
    log(f"[train mamba2-130m] {n_params} params (f32) on the card in "
        f"{time.perf_counter() - t0:.1f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    sk.launches = 0
    res = run(cfg, params, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_N, lr=1e-3, seed=0,
              device="cuda")
    hist = res["history"]
    steady = res["step_times"][1:]
    step_s = sum(steady) / len(steady)
    peak = res["max_memory_allocated"]
    log(f"[train mamba2-130m] losses {[r['loss'] for r in hist]} grad norms "
        f"{[r['grad_norm'] for r in hist]}")
    log(f"[train mamba2-130m] step times {res['step_times']} s; mean steady step "
        f"{step_s:.4f} s; {res['tok_per_s']:.1f} tok/s after the warm-up step; peak "
        f"allocated {peak / 2**30:.2f} GiB; ssd launches {sk.launches}; {gpu_name_and_power()}")
    bad = [r for r in hist if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]))]
    if bad or res["nan_skips"]:
        raise AssertionError(f"train mamba2-130m: non-finite or skipped steps: {bad}, "
                             f"{res['nan_skips']} skipped")
    if sk.launches != 2 * cfg.n_layers * TRAIN_STEPS:
        raise AssertionError(f"train mamba2-130m: {sk.launches} SSD launches, want "
                             f"{2 * cfg.n_layers * TRAIN_STEPS}")
    report = {"n_params": n_params, "losses": [r["loss"] for r in hist],
              "grad_norms": [r["grad_norm"] for r in hist], "step_times": res["step_times"],
              "step_s": step_s, "tok_per_s": res["tok_per_s"], "max_memory_allocated": peak,
              "launches": {"ssd": sk.launches}}
    del params, res
    free_card(torch, "mamba2-130m training", gate=False)
    return {"launches": {"ssd": report["launches"]["ssd"]}, "report": report}


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


def noncausal_phase(torch, flush) -> dict:
    """Flash and DistrAttention, forward (with the LSE) and the five
    backward kernels, non-causal at whisper-small's attention shapes
    (NONCAUSAL_SHAPE: B·H = 48 MHA, d = 64, G* = 2, Nk = 1500 keys, whose
    last 64-key tile is ragged) for Nq in NONCAUSAL_NQ (448 rows over 1500
    keys: the cross-attention; 1500: the encoder), bf16: each held element
    by element against its plain version, timed beside it and beside SDPA
    (forward, and its backward split 3 : 4 for flash dq and dkv), with its
    bound over ``attention_work``'s count, which is first checked to count
    every (row, key) pair of a non-causal call once.  DistrAttention pads Q
    (and dO) to its 128-row block, as ``ops.distr_attention`` does."""
    import torch.nn.functional as F

    from repro_torch.core.distr_attention import DistrConfig
    from repro_torch.kernels import backward as bwd
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import attention_work, delta_work

    bh, d, g, nk = NONCAUSAL_SHAPE
    ds = d // g
    dcfg = DistrConfig(group_size=g, block_q=128)
    scale = d ** -0.5
    names = ("flash", "distr", "delta", "flash_dq", "flash_dkv", "distr_dq", "distr_dkv")
    out = {name: {"max_abs_err": 0.0} for name in names}
    shapes = []
    for nq in NONCAUSAL_NQ:
        flash_w = attention_work(1, bh, bh, nq, nk, d, lse=True)
        distr_w = attention_work(1, bh, bh, nq, nk, d, lse=True, group_size=g,
                                 block_q=dcfg.block_q)
        for w, width in ((flash_w, d), (distr_w, ds)):
            if w["fwd"]["tensor_flops"] != 2 * (width + d) * bh * nq * nk:
                raise AssertionError(f"attention_work miscounts a non-causal {nq} x {nk} call")
        gen = torch.Generator(device="cuda").manual_seed(5)
        q, do = (torch.randn((1, bh, nq, d), generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((1, bh, nk, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        qf, kf, vf, dof = (x[0].contiguous() for x in (q, k, v, do))
        fkw = dict(q_per_kv=1, scale=scale, causal=False, kv_len=nk)
        label = f"non-causal Nq={nq} Nk={nk}"
        o, lse = fk.flash_attention_kernel_call(qf, kf, vf, return_lse=True, **fkw)
        o_p, lse_p = fk.flash_attention_plain(qf, kf, vf, return_lse=True, **fkw)
        torch.cuda.synchronize()
        errs = {"flash": check_close(torch, f"flash {label} O", o, o_p, TOL["flash"])}
        check_close(torch, f"flash {label} LSE", lse, lse_p, TOL["lse"])
        q_hat, perms = ops.distr_stage1(dcfg, ops.pad_to_multiple(q, dcfg.block_q, dim=2),
                                        scale, hkv=bh)
        q_hat, perm = q_hat[0].contiguous(), perms[0].to(torch.int32).contiguous()
        dofp = ops.pad_to_multiple(do, dcfg.block_q, dim=2)[0].contiguous()
        dkw = dict(q_per_kv=1, causal=False, group_size=g, block_q=dcfg.block_q, kv_len=nk)
        od, lsed = dk.distr_attention_kernel_call(q_hat, kf, vf, perm, return_lse=True, **dkw)
        od_p, lsed_p = dk.distr_attention_plain(q_hat, kf, vf, perm, return_lse=True, **dkw)
        torch.cuda.synchronize()
        errs["distr"] = check_close(torch, f"distr {label} O", od, od_p, TOL["distr"])
        check_close(torch, f"distr {label} LSE", lsed, lsed_p, TOL["lse"])
        del o_p, lse_p, od_p, lsed_p
        delta, deltad = bwd.delta_plain(o, dof), bwd.delta_plain(od, dofp)
        calls = {
            "flash": (lambda: fk.flash_attention_kernel_call(qf, kf, vf, return_lse=True, **fkw),
                      lambda: fk.flash_attention_plain(qf, kf, vf, return_lse=True, **fkw)),
            "distr": (lambda: dk.distr_attention_kernel_call(q_hat, kf, vf, perm,
                                                             return_lse=True, **dkw),
                      lambda: dk.distr_attention_plain(q_hat, kf, vf, perm, return_lse=True,
                                                       **dkw)),
            "delta": (lambda: bwd.delta_kernel_call(o, dof), lambda: bwd.delta_plain(o, dof)),
            "flash_dq": (lambda: bwd.flash_dq_kernel_call(qf, kf, vf, dof, lse, delta, **fkw),
                         lambda: bwd.flash_dq_plain(qf, kf, vf, dof, lse, delta, **fkw)),
            "flash_dkv": (lambda: bwd.flash_dkv_kernel_call(qf, kf, vf, dof, lse, delta, **fkw),
                          lambda: bwd.flash_dkv_plain(qf, kf, vf, dof, lse, delta, **fkw)),
            "distr_dq": (lambda: bwd.distr_dq_kernel_call(q_hat, kf, vf, perm, dofp, lsed,
                                                          deltad, **dkw),
                         lambda: bwd.distr_dq_plain(q_hat, kf, vf, perm, dofp, lsed, deltad,
                                                    **dkw)),
            "distr_dkv": (lambda: bwd.distr_dkv_kernel_call(q_hat, kf, vf, perm, dofp, lsed,
                                                            deltad, **dkw),
                          lambda: bwd.distr_dkv_plain(q_hat, kf, vf, perm, dofp, lsed, deltad,
                                                      **dkw)),
        }
        work = {"flash": flash_w["fwd"], "distr": distr_w["fwd"],
                "delta": delta_work(bh * nq, d, 2),
                **{f"flash_{c}": flash_w[c] for c in ("dq", "dkv")},
                **{f"distr_{c}": distr_w[c] for c in ("dq", "dkv")}}
        row = {"nq": nq, "nk": nk, "bh": bh, "d": d, "group_size": g}
        for name in names:
            kern, plain = calls[name]
            if name not in errs:
                got, want = kern(), plain()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                tol = TOL["delta"] if name == "delta" else TOL["bwd"]
                errs[name] = max(check_close(torch, f"{name} {label} [{i}]", a, b, tol)
                                 for i, (a, b) in enumerate(zip(got, want)))
                del got, want
            ms = time_ms(torch, kern, DELTA_ITERS if name == "delta" else 10, flush)
            plain_ms = time_ms(torch, plain, 3, flush)
            row[name] = {"ms": ms, "plain_ms": plain_ms, **roofline(work[name], ms),
                         "max_abs_err": errs[name]}
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], errs[name])
        row["flash"]["library_ms"] = time_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v), 10, flush)
        row["distr"]["library_ms"] = None
        row["delta"]["library_ms"] = time_ms(torch, lambda: torch.linalg.vecdot(o, dof),
                                             DELTA_ITERS, flush)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)
        sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), do, retain_graph=True), 10, flush)
        row["flash_dq"]["library_ms"] = sdpa_bwd * 3 / 7
        row["flash_dkv"]["library_ms"] = sdpa_bwd * 4 / 7
        row["distr_dq"]["library_ms"] = row["distr_dkv"]["library_ms"] = None
        for name in names:
            r = row[name]
            lib = r["library_ms"]
            log(f"[{label}] {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, bound "
                f"{r['bound_ms']:.5f} by {r['bound_by']}, {r['utilization']:.1%} of it"
                + (f"; library {lib:.4f}" if lib is not None else "")
                + f") err {r['max_abs_err']:.3e}")
        shapes.append(row)
        del sdpa_out, qg, kg, vg, q, k, v, do, o, lse, od, lsed
    out["shapes"] = shapes
    torch.cuda.empty_cache()
    return out


def _frontend_rows(torch, cfg, n: int, rows: int, seed: int):
    """``rows`` seeded Gaussian stub-frontend embeddings (rows, n, d_model)
    in bf16 on the card, as the reference's tests feed the stubs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((rows, n, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)


def step_serve(torch, cfg, params, prompt_lens, *, frames=None, patches=None,
               max_len: int, new: int = ENCDEC_NEW) -> dict:
    """Serve one request a prompt length through ``serve_step``: each
    prefilled alone (B = 1, with its row of ``frames`` or ``patches``,
    prompts drawn as ``launch.serve.run`` draws them), the caches stacked
    into one batch, then ``new`` greedy decode steps of the batch, each slot
    at its own position (after a patch prefix: prompt + P), the step a CUDA
    graph (``serve/graphs.py::StepGraph``) as the slot engine runs it.  The
    first decode step's logits are held against the same step under
    impl="reference" (plain attention) on a copy of the cache.  Returns the
    prefill ms, decode seconds (warm-up and capture included), TPOT (the
    mean replayed step), tok/s over the run, tokens, launches, the peak
    allocated outside the f32 check (from the caller's reset) and the
    reference check's errors, and the same check with the step in f32."""
    import numpy as np

    from repro_torch.serve.graphs import LaunchCounters, StepGraph
    from repro_torch.serve.serve_step import make_decode_step, make_prefill

    counters = LaunchCounters()
    before = counters.read()
    prefill = make_prefill(cfg, max_len)
    rng = np.random.default_rng(0)
    caches, first, prefill_ms = [], [], []
    n_prefix = 0 if patches is None else patches.shape[1]
    t_start = time.perf_counter()
    for i, n in enumerate(prompt_lens):
        toks = torch.from_numpy(rng.integers(1, cfg.vocab, size=(1, n))).to("cuda")
        kw = ({"frames": frames[i:i + 1]} if frames is not None else
              {"patches": patches[i:i + 1]} if patches is not None else {})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, toks, **kw)
        first.append(logits[:, -1].argmax(-1))
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        caches.append(cache)
    cache = {key: torch.cat([c[key] for c in caches], dim=0 if caches[0][key].ndim == 1 else 1)
             for key in caches[0]}
    del caches
    tokens = torch.stack(first)  # (B, 1)
    pos = torch.tensor([n + n_prefix for n in prompt_lens], dtype=torch.int32, device="cuda")
    ref_cfg = cfg.replace(attention=cfg.attention.with_impl("reference"))
    after_prefill = counters.read()
    want = make_decode_step(ref_cfg)(params, tokens, {k: t.clone() for k, t in cache.items()},
                                     pos)[0].clone()
    if counters.read() != after_prefill:
        raise AssertionError(f"{cfg.name}: the impl=reference decode step launched a kernel")
    # The witness, kept out of the launches and the peak: the same first
    # step with params, cache and compute in f32, under the impl and under
    # reference; its time comes off the run's wall.
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    t_witness = time.perf_counter()
    params32 = _float32(torch, params)
    got32, want32 = (make_decode_step(c.replace(compute_dtype="float32"))(
        params32, tokens, _float32(torch, cache), pos)[0] for c in (cfg, ref_cfg))
    err32, rel32 = logits_close(torch, f"{cfg.name} first decode step in f32 vs impl=reference",
                                got32, want32, cfg.vocab, rel_limit=ENCDEC_F32_REL_L2,
                                element_tol=None)
    del params32, got32, want32
    witness = {k: n - after_prefill[k] for k, n in counters.read().items()}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t_witness = time.perf_counter() - t_witness
    decode = StepGraph(make_decode_step(cfg, max_len=max_len, device="cuda"), inputs=(1, 3))
    generated = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(new):
        if step == 2:  # after the eager warm-up and the capture
            torch.cuda.synchronize()
            t_replays = time.perf_counter()
        logits, cache = decode(params, tokens, cache, pos)
        if step == 0:
            got = logits.clone()
        tokens = logits[:, -1].argmax(-1)[:, None]
        generated.append(tokens)
        pos = pos + 1
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    decode_s = t_end - t0
    tpot_s = (t_end - t_replays) / (new - 2)
    wall = t_end - t_start - t_witness
    after = counters.read()
    peak = max(peak, torch.cuda.max_memory_allocated())
    launches = {k: after[k] - before[k] - witness[k] for k in after}
    err, rel = logits_close(torch, f"{cfg.name} first decode step vs impl=reference", got,
                            want, cfg.vocab)
    gen_tokens = torch.cat(generated, dim=1).tolist()
    n_tok = len(prompt_lens) * new
    return {"prefill_ms": prefill_ms, "decode_s": decode_s, "tpot_s": tpot_s,
            "tok_per_s": n_tok / wall, "decode_tok_per_s": n_tok / decode_s, "seconds": wall,
            "tokens": n_tok, "generated": gen_tokens, "launches": launches,
            "peak_allocated": peak, "max_abs_err_vs_reference": err, "rel_l2_vs_reference": rel,
            "f32_max_abs_err_vs_reference": err32, "f32_rel_l2_vs_reference": rel32}


def _float32(torch, tree):
    """A copy of ``tree`` (dicts, lists and tuples of tensors) with every
    floating tensor cast to f32 and every other tensor cloned."""
    if isinstance(tree, dict):
        return {k: _float32(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_float32(torch, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.float() if tree.is_floating_point() and tree.dtype != torch.float32 \
            else tree.clone()
    return tree


def logits_close(torch, name: str, got, want, vocab: int, *,
                 rel_limit: float = ENCDEC_LOGIT_REL_L2,
                 element_tol: float | None = ENCDEC_LOGIT_TOL) -> tuple[float, float]:
    """Logits (B, 1, padded vocab) over the ``vocab`` live columns: all
    finite, the pad columns equal, the relative L2 error at most
    ``rel_limit``, and with ``element_tol`` each element within it (rtol,
    and atol that share of the largest |logit|).  Returns (the largest
    |got - want| live, the relative L2 error)."""
    live_got, live_want = got[..., :vocab].float(), want[..., :vocab].float()
    if not (torch.isfinite(live_got).all() and torch.isfinite(live_want).all()):
        raise AssertionError(f"{name}: non-finite logits")
    if not torch.equal(got[..., vocab:].float(), want[..., vocab:].float()):
        raise AssertionError(f"{name}: the pad logits differ")
    scale = float(live_want.abs().max())
    diff = (live_got - live_want).abs()
    rel = float(diff.norm() / live_want.norm())
    log(f"  {name}: largest error {float(diff.max()):.4g} (largest |logit| {scale:.4g}); "
        f"relative L2 error {rel:.3g} (limit {rel_limit:g})")
    if rel > rel_limit:
        raise AssertionError(f"{name}: relative L2 error {rel:.3g} over {rel_limit:g}")
    if element_tol is not None:
        atol = element_tol * scale
        torch.testing.assert_close(live_got, live_want, atol=atol, rtol=element_tol,
                                   msg=lambda m: f"{name}: {m}")
        share = float((diff / (atol + element_tol * live_want.abs())).max())
        log(f"    its largest error is {share:.3g} of its element's allowance")
    return float(diff.max()), rel


def _served(arch: str, impl: str, res: dict, peak: int) -> None:
    log(f"[{arch} serve_step {impl}] prefill ms {[round(x, 2) for x in res['prefill_ms']]}; "
        f"{res['tokens']} tokens in {res['seconds']:.3f}s ({res['tok_per_s']:.1f} tok/s, "
        f"decode {res['decode_tok_per_s']:.1f} tok/s); TPOT {res['tpot_s'] * 1e3:.3f} ms "
        "(replays); "
        f"peak allocated {peak / 2**30:.2f} GiB; first decode step vs reference max |dlogit| "
        f"{res['max_abs_err_vs_reference']:.3e}, rel L2 {res['rel_l2_vs_reference']:.3g} "
        f"(in f32: {res['f32_max_abs_err_vs_reference']:.3e}, "
        f"{res['f32_rel_l2_vs_reference']:.3g}); launches {res['launches']}")


def _gate_counts(name: str, counts: dict, want: dict) -> None:
    """Each kernel's launches in ``counts`` (LaunchCounters' keys) must be
    exactly ``want``'s, and every other kernel's 0."""
    off = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    if off:
        raise AssertionError(f"{name}: launches off the path: {counts}, want {want}")


def whisper_serve_phase(torch) -> dict:
    """whisper-small at its published size (12 encoder and 12 decoder
    layers, d_model 768, 12 heads of 64, learned positions), seeded random
    bf16 weights made on the card, served through ``serve_step`` (the
    reference's slot engine refuses enc-dec) under both kernel impls:
    4 requests over 1500 seeded frames each (the audio stub's embeddings),
    prompts WHISPER_PROMPTS, ENCDEC_NEW greedy decode steps.  A request's
    prefill launches the impl's forward kernel 36 times (12 encoder, 12
    decoder self- and 12 cross-attentions); a decode step the decode
    kernel 24 times (self and cross over the 1500-position cross cache,
    cross_len each)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("whisper-small")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm.trainable(params))
    cross_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.cross_len * cfg.head_dim_ * 2
    log(f"[whisper-small] {n_params} params (bf16) on the card in "
        f"{time.perf_counter() - t0:.1f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated; cross cache {cross_bytes} bytes a request")
    frames = _frontend_rows(torch, cfg, cfg.cross_len, len(WHISPER_PROMPTS), 1)
    report = {"n_params": n_params}
    launches = {"flash": 0, "distr": 0, "decode": 0}
    n_req, layers = len(WHISPER_PROMPTS), cfg.n_layers
    for impl, kernel in SLOT_IMPLS:
        cfg_i = cfg.replace(attention=cfg.attention.with_impl(impl))
        torch.cuda.reset_peak_memory_stats()
        res = step_serve(torch, cfg_i, params, WHISPER_PROMPTS, frames=frames,
                         max_len=WHISPER_MAX_LEN)
        peak = res["peak_allocated"]
        _served("whisper-small", impl, res, peak)
        counts = {"flash": res["launches"]["flash_attention"],
                  "distr": res["launches"]["distr_attention"],
                  "decode": res["launches"]["decode"]}
        _gate_counts(f"whisper-small serve {impl}", res["launches"], {
            f"{kernel}_attention": (lm.n_encoder_layers(cfg) + 2 * layers) * n_req,
            "decode": 2 * layers * ENCDEC_NEW})
        for name in (kernel, "decode"):
            launches[name] += counts[name]
        report[impl] = {**{k: res[k] for k in res if k != "generated"},
                        "peak_allocated": peak}
    del params, frames
    free_card(torch, "whisper-small serving")
    return {"launches": launches, "report": report}


def vlm_serve_phase(torch) -> dict:
    """internvl2-2b at its published size (24 layers, d_model 2048, 16 query
    heads over 8 KV heads of 128), seeded random bf16 weights made on the
    card, under both kernel impls: through ``serve_step`` with 256 seeded
    patch embeddings (the InternViT stub's) before each of VLM_PROMPTS
    (prefill launches the impl's forward kernel 24 times a request, decode
    the decode kernel 24 times a step, at position prompt + 256), then on
    the slot engine (``launch.serve.run``) over the serve workload's text
    prompts, which the reference's engine serves without patches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.launch.serve import run
    from repro_torch.models import lm

    cfg = get_config("internvl2-2b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm.trainable(params))
    log(f"[internvl2-2b] {n_params} params (bf16) on the card in "
        f"{time.perf_counter() - t0:.1f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated; KV cache {cache_bytes_per_token(cfg)} bytes a token")
    patches = _frontend_rows(torch, cfg, cfg.num_patch_tokens, len(VLM_PROMPTS), 2)
    report = {"n_params": n_params}
    launches = {"flash": 0, "distr": 0, "decode": 0}
    for impl, kernel in SLOT_IMPLS:
        cfg_i = cfg.replace(attention=cfg.attention.with_impl(impl))
        torch.cuda.reset_peak_memory_stats()
        res = step_serve(torch, cfg_i, params, VLM_PROMPTS, patches=patches,
                         max_len=VLM_MAX_LEN)
        peak = res["peak_allocated"]
        _served("internvl2-2b", impl, res, peak)
        _gate_counts(f"internvl2-2b serve_step {impl}", res["launches"], {
            f"{kernel}_attention": cfg.n_layers * len(VLM_PROMPTS),
            "decode": cfg.n_layers * ENCDEC_NEW})
        launches[kernel] += res["launches"][f"{kernel}_attention"]
        launches["decode"] += res["launches"]["decode"]
        report[f"patches {impl}"] = {**{k: res[k] for k in res if k != "generated"},
                                     "peak_allocated": peak}

        fk.launches = dk.launches = dec.launches = pd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        eng = run(cfg_i, params, max_new=32, max_slots=4, max_len=2048,
                  prompt_lens=list(SERVE_PROMPTS), device="cuda")
        peak = torch.cuda.max_memory_allocated()
        counts = {"flash": fk.launches, "distr": dk.launches, "decode": dec.launches,
                  "paged": pd.launches}
        log(f"[internvl2-2b slot engine {impl}] {len(eng['done'])} requests, {eng['tokens']} "
            f"tokens in {eng['seconds']:.2f}s ({eng['tok_per_s']:.1f} tok/s); peak allocated "
            f"{peak / 2**30:.2f} GiB; launches {counts}")
        for m in eng["metrics"]:
            log(f"  req {m['uid']}: status {m['status']} ttft {m['ttft_s']:.4f}s "
                f"tpot {m['tpot_s']:.4f}s n={m['n_generated']}")
        bad = [r.uid for r in eng["done"] if r.status != "done" or len(r.generated) != 32]
        other = "flash" if kernel == "distr" else "distr"
        if len(eng["done"]) != len(SERVE_PROMPTS) or bad:
            raise AssertionError(f"internvl2-2b slot engine {impl}: requests not done: {bad}")
        if counts[kernel] == 0 or counts["decode"] == 0 or counts[other] or counts["paged"]:
            raise AssertionError(f"internvl2-2b slot engine {impl}: launches off the path: "
                                 f"{counts}")
        launches[kernel] += counts[kernel]
        launches["decode"] += counts["decode"]
        report[f"slot {impl}"] = {"seconds": eng["seconds"], "tokens": eng["tokens"],
                                  "tok_per_s": eng["tok_per_s"], "peak_allocated": peak,
                                  "launches": counts, "metrics": eng["metrics"]}
        del eng
    del params, patches
    free_card(torch, "internvl2-2b serving")
    return {"launches": launches, "report": report}


def encdec_train_phase(torch) -> dict:
    """whisper-small and internvl2-2b at their published sizes, seeded
    random f32 params, TRAIN_STEPS steps each through ``make_train_step``
    (AdamW, full remat) under both kernel impls, on one seeded batch of
    ENCDEC_TRAIN's shape: whisper 4 × 448 tokens over 1500 frames a row,
    internvl 2 × (256 patches + 1792 tokens).  Raises if a loss or grad
    norm is not finite, a step was skipped, card memory is not back at
    the run's start once its params and state are dropped, or the launches
    leave the
    impl's path: each attention call (whisper 36 a step: encoder, decoder
    self- and cross-attention; internvl 24) runs delta, dq and dkv once a
    step, and the forward kernel at least once (again in the recompute).
    One more step per run is profiled for its device time."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import init_train_params
    from repro_torch.models import lm
    from repro_torch.serve.graphs import LaunchCounters
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    counters = LaunchCounters()
    launches = {"flash": 0, "distr": 0, "delta": 0, "flash_dq": 0, "flash_dkv": 0,
                "distr_dq": 0, "distr_dkv": 0}
    report = {}
    for arch, batch, n_tok, n_in, key in ENCDEC_TRAIN:
        cfg = get_config(arch)
        calls = (lm.n_encoder_layers(cfg) + 2 * cfg.n_layers if cfg.family == "encdec"
                 else cfg.n_layers)
        for impl, mine, other in (("pallas_distr", "distr", "flash"),
                                  ("pallas_flash", "flash", "distr")):
            cfg_i = cfg.replace(attention=cfg.attention.with_impl(impl))
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            params = init_train_params(cfg_i, seed=0, device="cuda")
            leaves = lm.trainable(params)
            n_params = sum(t.numel() for t in leaves)
            state = adamw_init(leaves)
            step = make_train_step(cfg_i, OptimizerConfig(
                peak_lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS, schedule=cfg.schedule))
            gen = torch.Generator(device="cuda").manual_seed(0)
            toks = torch.randint(0, cfg.vocab, (batch, n_tok + 1), generator=gen, device="cuda")
            data = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    key: torch.randn((batch, n_in, cfg.d_model), generator=gen,
                                     device="cuda").to(torch.bfloat16)}
            torch.cuda.synchronize()
            log(f"[train {arch} {impl}] {n_params} params (f32) and AdamW state on the card "
                f"in {time.perf_counter() - t0:.1f}s, "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
            torch.cuda.reset_peak_memory_stats()
            before = counters.read()
            losses, norms, times = [], [], []
            for i in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                params, state, m = step(params, state, data, i)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if float(m["skipped"]):
                    raise AssertionError(f"train {arch} {impl}: step {i} skipped")
            after = counters.read()
            counts = {k: after[k] - before[k] for k in after}
            peak = torch.cuda.max_memory_allocated()
            steady = times[1:]
            step_s = sum(steady) / len(steady)
            tok_s = batch * n_tok / step_s
            log(f"[train {arch} {impl}] losses {losses} grad norms {norms}")
            log(f"[train {arch} {impl}] step times {times} s; mean steady step {step_s:.4f} s; "
                f"{tok_s:.1f} text tok/s ({batch} x ({n_in} {key} + {n_tok} tokens)); peak "
                f"allocated {peak / 2**30:.2f} GiB; launches {counts}")
            if not all(math.isfinite(x) for x in losses + norms):
                raise AssertionError(f"train {arch} {impl}: non-finite loss or grad norm")
            per_step = calls * TRAIN_STEPS
            fwd = counts[f"{mine}_attention"]
            bwd_counts = {f"backward.{n}": counts[f"backward.{n}"]
                          for n in ("delta", f"{mine}_dq", f"{mine}_dkv")}
            if (any(c != per_step for c in bwd_counts.values()) or fwd < per_step
                    or counts[f"{other}_attention"] or counts[f"backward.{other}_dq"]
                    or counts[f"backward.{other}_dkv"] or counts["decode"]
                    or counts["paged_decode"] or counts["ssd"]):
                raise AssertionError(f"train {arch} {impl}: launches off the path: {counts}")
            launches[mine] += fwd
            for name, c in bwd_counts.items():
                launches[name.split(".", 1)[1]] += c
            # One more step under the profiler (its launches not counted):
            # the device's time beside the steady step's wall.
            attn_ms, device_ms, _ = _attention_device_ms(
                torch, lambda: step(params, state, data, TRAIN_STEPS))
            log(f"[train {arch} {impl}] profiled step: {device_ms:.1f} ms of device time "
                f"({device_ms / 1e3 / step_s:.1%} of the mean steady step), attention "
                f"kernels {attn_ms:.1f} ms")
            report[f"{arch} {impl}"] = {"n_params": n_params, "losses": losses,
                                        "grad_norms": norms, "step_times": times,
                                        "step_s": step_s, "tok_per_s": tok_s,
                                        "max_memory_allocated": peak, "launches": counts,
                                        "device_ms": device_ms, "attention_device_ms": attn_ms}
            del params, leaves, state, step, data, toks, m
            free_card(torch, f"{arch} training {impl}", gate=False, base=base)
    return {"launches": launches, "report": report}


def encdec_phases(torch) -> dict:
    """The enc-dec and VLM slice's model phases: whisper-small and
    internvl2-2b served, then trained, at their published sizes."""
    results, launches = {}, {}
    for name, phase in (("whisper-small serve", whisper_serve_phase),
                        ("internvl2-2b serve", vlm_serve_phase),
                        ("encdec train", encdec_train_phase)):
        t0 = time.perf_counter()
        res = phase(torch)
        log(f"[{name}] phase took {time.perf_counter() - t0:.1f}s")
        results[name] = res["report"]
        for k, n in res["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return {"results": results, "launches": launches}


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


def cluster_phase(torch, params, base=None, device="cuda") -> dict:
    """starcoder2-7b at full width with the serve phase's weights behind a
    ``ClusterRouter`` (``serve/cluster.py``): two slot engines (4 slots,
    max_len 2048) and one ``PagedServeEngine`` (raw K, 8 lanes, blocks of
    128, chunks of 32) sharing the weights, pallas_distr, greedy, a tick
    clock, round robin, the serve workload at CLUSTER_NEW new tokens.
    Runs: healthy; slot replica 1 killed mid-flight (CLUSTER_CRASH) under a
    ``TraceRecorder``; the paged replica drained with ``migrate=True``
    mid-flight, then replaced by a fresh engine that serves three more
    requests; a capability run whose replica 0 takes prompts of at most
    CLUSTER_SMALL_LEN tokens; a wedge-and-NaN run (CLUSTER_WEDGE); and the
    healthy run again under the profiler for the card's busy share.
    Raises unless every request ends with the statuses the reference's
    real-engine cluster tests expect and its full budget, the requests
    that never touched a dead, drained or faulted replica emit the healthy
    run's tokens exactly, each redelivered or migrated request keeps its
    prefix ``emitted[:base]``, the survivors' pools are back at their free
    counts, only the kill run records a replica death, the kill run's
    ``router_registry`` snapshot and trace pass the validators, the long
    prompt never lands on the small replica, the decode, paged decode and
    DistrAttention forward kernels launched (flash none), and, once the
    runs' routers are dropped, the card's memory is back within
    CYCLE_SLACK of where it stood after the healthy run without the cycle
    collector (the dead and the replaced engines gave theirs back).  Logs
    each run's tokens/s, the router's harvest time a tick, each replay's
    time from redelivery to its first new token, and the card memory a
    replaced or dead engine gives back."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.faults import FaultInjector, FaultSpec
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.launch.serve import device_busy_s
    from repro_torch.obs import TraceRecorder, router_registry
    from repro_torch.obs.validate import validate_chrome_trace, validate_metrics_snapshot
    from repro_torch.serve import cluster
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def allocated():
        sync()
        return torch.cuda.memory_allocated() if cuda else 0

    class TimedRouter(cluster.ClusterRouter):
        """The router with its harvest (the host reads of each replica's
        new tokens) timed."""

        harvest_s = 0.0

        def _harvest(self, h, finished):
            t0 = time.perf_counter()
            try:
                super()._harvest(h, finished)
            finally:
                self.harvest_s += time.perf_counter() - t0

    base = base or get_config("starcoder2-7b")
    cfg = base.replace(attention=base.attention.with_impl("pallas_distr"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=n).tolist() for n in SERVE_PROMPTS]
    t_phase = time.perf_counter()
    start = allocated()

    def slot(clock, faults=None, max_len=2048, trace=None):
        return ServeEngine(cfg, params, max_slots=4, max_len=max_len, clock=clock,
                           faults=faults, device=device, trace=trace)

    def paged(clock, faults=None, trace=None):
        return PagedServeEngine(cfg, params, max_batch=8, max_len=2048, block_size=128,
                                prefill_chunk=32, clock=clock, faults=faults, device=device,
                                trace=trace)

    def engines(clock, faults=None, small=None, trace=None):
        faults = faults or {}
        return [slot(clock, faults.get(0), max_len=small or 2048, trace=trace),
                slot(clock, faults.get(1), trace=trace), paged(clock, faults.get(2), trace=trace)]

    def launches():
        return {"flash": fk.launches, "distr": dk.launches, "decode": dec.launches,
                "paged": pd.launches}

    totals = dict.fromkeys(launches(), 0)
    report = {}

    def drive(name, router, clock, reps, *, submit=None, on_tick=None):
        """Submit ``submit`` (default: the workload), tick to the end, count
        launches → (uids, ticks, seconds)."""
        fk.launches = dk.launches = dec.launches = pd.launches = 0
        free0 = {i: e.cache.pool.num_free for i, e in enumerate(reps)
                 if isinstance(e, PagedServeEngine)}
        sync()
        t0 = time.perf_counter()
        uids = [router.add_request(p, max_new_tokens=CLUSTER_NEW)
                for p in (submit if submit is not None else prompts)]
        ticks = 0
        while router.has_work():
            if ticks == CLUSTER_MAX_TICKS:
                raise AssertionError(f"cluster {name}: requests {sorted(router._inflight)} "
                                     f"still in flight after {ticks} ticks")
            router.tick()
            clock.t += 1
            ticks += 1
            if on_tick is not None:
                uids += on_tick(ticks) or []
        sync()
        seconds = time.perf_counter() - t0
        counts = launches()
        for k, n in counts.items():
            totals[k] += n
        reqs = {u: router.request(u) for u in uids}
        n_tok = sum(len(c.emitted) for c in reqs.values())
        counters = {k: v for k, v in router.counters_snapshot().items() if v}
        states = router.replica_states()
        pools = {i: (free0[i], reps[i].cache.pool.num_free) for i in free0
                 if i < len(reps) and states[i] != cluster.DEAD}
        log(f"[cluster {name}] {len(uids)} requests, {n_tok} tokens in {ticks} ticks, "
            f"{seconds:.2f}s ({n_tok / seconds:.1f} tok/s); harvest "
            f"{router.harvest_s / ticks * 1e3:.3f} ms a tick; rids "
            f"{ {u: c.rid for u, c in reqs.items()} }; statuses "
            f"{ {u: c.status for u, c in reqs.items()} }; redeliveries "
            f"{ {u: (c.redeliveries, c.base) for u, c in reqs.items() if c.redeliveries} }; "
            f"router counters {counters}; states {states}; paged pool free (start, end) "
            f"{pools}; launches {counts}")
        for i, (before, after) in pools.items():
            if before != after:
                raise AssertionError(f"cluster {name}: replica {i} leaked {before - after} "
                                     "pool blocks")
        if name != "kill" and counters.get("replica_deaths"):
            raise AssertionError(f"cluster {name}: a replica died in a run without a kill: "
                                 f"{counters}")
        report[name] = {"requests": len(uids), "tokens": n_tok, "ticks": ticks,
                        "seconds": seconds, "tok_per_s": n_tok / seconds,
                        "harvest_ms_per_tick": router.harvest_s / ticks * 1e3,
                        "counters": counters, "launches": counts,
                        "rids": {u: c.rid for u, c in reqs.items()},
                        "statuses": {u: c.status for u, c in reqs.items()}}
        return uids, reqs

    def done_with_budget(name, reqs, only=None):
        bad = {u: (c.status, len(c.emitted)) for u, c in reqs.items()
               if (only is None or u in only)
               and (c.status != "done" or len(c.emitted) != CLUSTER_NEW)}
        if bad:
            raise AssertionError(f"cluster {name}: requests not done with their budget: {bad}")

    def same_as_healthy(name, reqs, uids):
        for u in uids:
            got, want = reqs[u].emitted, healthy[u]
            if got != want:
                at = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
                raise AssertionError(f"cluster {name}: uid {u} (rid {reqs[u].rid}) diverged "
                                     f"from the healthy run at token {at}: {got[at]} vs "
                                     f"{want[at]}")

    def prefix_kept(name, reqs, uids):
        for u in uids:
            k = reqs[u].base
            if reqs[u].emitted[:k] != healthy[u][:k]:
                raise AssertionError(f"cluster {name}: uid {u} lost or reordered its first "
                                     f"{k} tokens")

    # 1. healthy
    clock = TickClock()
    reps = engines(clock)
    router = TimedRouter(reps, policy="round_robin", clock=clock)
    uids, reqs = drive("healthy", router, clock, reps)
    done_with_budget("healthy", reqs)
    healthy = {u: list(c.emitted) for u, c in reqs.items()}
    if [reqs[u].rid for u in uids] != [u % 3 for u in uids]:
        raise AssertionError(f"cluster healthy: round robin routed {report['healthy']['rids']}")
    del router, reps, reqs
    # The mark later runs must come back to: the first engines' warm-ups
    # also made the process's lasting cuBLAS workspaces (one a stream).
    mark = allocated()

    # 2. kill slot replica 1 mid-flight, traced on the wall clock
    clock = TickClock()
    rec = TraceRecorder()
    reps = engines(clock, trace=rec)
    router = TimedRouter(reps, policy="round_robin", clock=clock, trace=rec,
                         faults=FaultInjector([FaultSpec(**CLUSTER_CRASH)]))
    replays = {}  # uid → [tick redelivered, wall then, emitted then, ticks, seconds]

    def watch_replays(tick):
        now = time.perf_counter()
        for c in router._all.values():
            r = replays.get(c.uid)
            if c.redeliveries and r is None:
                replays[c.uid] = [tick, now, len(c.emitted), None, None, c.rid,
                                  len(c.prompt) + len(c.emitted)]
            elif r is not None and r[3] is None and len(c.emitted) > r[2]:
                r[3], r[4] = tick - r[0], now - r[1]

    uids, reqs = drive("kill", router, clock, reps, on_tick=watch_replays)
    done_with_budget("kill", reqs)
    snap = router.counters_snapshot()
    moved = [u for u in uids if reqs[u].redeliveries]
    if (snap["replica_deaths"], router.replica_states()[1]) != (1, cluster.DEAD) or not moved \
            or snap["redelivered"] != len(moved):
        raise AssertionError(f"cluster kill: counters {snap}, states "
                             f"{router.replica_states()}, redelivered {moved}")
    same_as_healthy("kill", reqs, [u for u in uids if u not in moved])
    prefix_kept("kill", reqs, moved)
    for u, (t, _, n, ticks, sec, rid, n_replay) in sorted(replays.items()):
        log(f"  [cluster kill] uid {u}: redelivered at tick {t} with {n} tokens emitted to "
            f"replica {rid} (replay prefill of {n_replay} tokens); first new token "
            f"{ticks} tick(s), {sec:.4f}s later; its tail equals the healthy run's: "
            f"{reqs[u].emitted == healthy[u]}")
    report["kill"]["replays"] = {u: {"replica": r[5], "replay_tokens": r[6], "ticks": r[3],
                                     "seconds": r[4]} for u, r in replays.items()}
    reg = json.loads(json.dumps(router_registry(router).snapshot()))
    doc = json.loads(json.dumps(rec.to_chrome()))
    problems = validate_metrics_snapshot(reg) + validate_chrome_trace(doc)
    names = [e["name"] for e in doc["traceEvents"]]
    ends = {e["args"]["uid"]: e["args"] for e in doc["traceEvents"]
            if e["ph"] == "e" and e["name"] == "crequest"}
    rows = {m["uid"]: m for m in json.loads(json.dumps(router.metrics()))}
    log(f"  [cluster kill] trace: {len(names)} events, replica_death {names.count('replica_death')}"
        f", redeliver {names.count('redeliver')}; problems {problems}")
    if problems or names.count("replica_death") != 1 or names.count("redeliver") != len(moved) \
            or ends != rows:
        raise AssertionError(f"cluster kill: trace or registry: problems {problems}, "
                             f"crequest ends equal the metrics rows: {ends == rows}")
    for key in ("router_replica_deaths", "router_redelivered"):
        if reg["counters"][key] != snap[key.removeprefix("router_")]:
            raise AssertionError(f"cluster kill: registry {key} {reg['counters'][key]}")
    dead = reps[1]
    del router, reps, reqs, rec

    # The dead replica gives its memory back once the router that held it goes.
    held = allocated()
    del dead
    log(f"  [cluster kill] the dead slot replica held "
        f"{(held - allocated()) / 2**20:.1f} MiB of card memory until its router went")

    # 3. drain the paged replica with migrate=True mid-flight, then replace it
    clock = TickClock()
    reps = engines(clock)
    router = TimedRouter(reps, policy="round_robin", clock=clock)
    drained = {}

    def drain_then_replace(tick):
        if tick == CLUSTER_DRAIN_TICK:
            drained["moved"] = sorted(c.uid for c in router._by_rid[2].owned.values())
            router.drain(2, migrate=True)
        elif tick > CLUSTER_DRAIN_TICK and "late" not in drained \
                and router.replica_states()[2] == cluster.DRAINED:
            before = allocated()
            old = reps[2]
            reps[2] = paged(clock)
            router.replace(2, reps[2])
            new = allocated()
            del old
            freed = new - allocated()
            drained["memory"] = (before, new, freed)
            log(f"  [cluster drain] tick {tick}: replica 2 replaced; the fresh engine took "
                f"{(new - before) / 2**20:.1f} MiB, the drained one gave back "
                f"{freed / 2**20:.1f} MiB")
            drained["late"] = [router.add_request(p, max_new_tokens=CLUSTER_NEW)
                               for p in prompts[:3]]
            return drained["late"]
        return None

    uids, reqs = drive("drain", router, clock, reps, on_tick=drain_then_replace)
    done_with_budget("drain", reqs)
    snap = router.counters_snapshot()
    moved = drained["moved"]
    if not moved or (snap["drains"], snap["migrated"], snap["redelivered"]) != (
            1, len(moved), len(moved)) or router.replica_states()[2] != cluster.HEALTHY:
        raise AssertionError(f"cluster drain: moved {moved}, counters {snap}, states "
                             f"{router.replica_states()}")
    if 2 not in {reqs[u].rid for u in drained["late"]}:
        raise AssertionError("cluster drain: the replaced replica served no request")
    first = [u for u in uids if u not in drained["late"]]
    same_as_healthy("drain", reqs, [u for u in first if u not in moved])
    prefix_kept("drain", reqs, moved)
    before, new, freed = drained["memory"]
    if cuda and freed < 0.5 * (new - before):
        raise AssertionError(f"cluster drain: the replaced engine gave back {freed} bytes of "
                             f"the {new - before} its replacement took")
    report["drain"]["memory_mib"] = {"replacement": (new - before) / 2**20,
                                     "freed_by_replace": freed / 2**20}
    del router, reps, reqs

    # 4. capability: replica 0 holds prompts of at most CLUSTER_SMALL_LEN
    # tokens; longest prompt first, so round robin's first turn (replica 0)
    # falls to the one prompt it cannot hold
    clock = TickClock()
    reps = engines(clock, small=CLUSTER_SMALL_LEN)
    router = TimedRouter(reps, policy="round_robin", clock=clock)
    caps = [cluster.ClusterRouter._capacity(h) for h in router.replicas]
    longest_first = sorted(prompts, key=len, reverse=True)
    uids, reqs = drive("capability", router, clock, reps, submit=longest_first)
    done_with_budget("capability", reqs)
    long = [u for u, p in zip(uids, longest_first) if len(p) > CLUSTER_SMALL_LEN]
    if caps != [CLUSTER_SMALL_LEN, 2048, 2047] or not long \
            or any(reqs[u].rid == 0 for u in long) \
            or router.counters_snapshot()["capability_rejects"]:
        raise AssertionError(f"cluster capability: capacities {caps}, long prompts {long} on "
                             f"{[reqs[u].rid for u in long]}")
    del router, reps, reqs

    # 5. a wedged pool and a NaN storm: only their victims fail
    clock = TickClock()
    reps = engines(clock, faults={i: FaultInjector([FaultSpec(**spec)])
                                  for i, spec in CLUSTER_WEDGE.items()})
    router = TimedRouter(reps, policy="round_robin", clock=clock)
    uids, reqs = drive("wedge", router, clock, reps)
    victims = [uids[0], uids[2]]  # round robin: each replica's engine uid 0
    statuses = {u: reqs[u].status for u in uids}
    agg = router.cluster_counters()
    health = router.health()
    if [statuses[u] for u in victims] != ["failed", "failed"] \
            or agg["failed_numeric"] < 1 or agg["watchdog_fails"] < 1 \
            or health[1] < max(health[0], health[2]):
        raise AssertionError(f"cluster wedge: statuses {statuses}, engine counters "
                             f"{ {k: v for k, v in agg.items() if v} }, health {health}")
    rest = [u for u in uids if u not in victims]
    done_with_budget("wedge", reqs, only=rest)
    same_as_healthy("wedge", reqs, rest)
    report["wedge"]["health"] = health
    del router, reps, reqs

    # 6. the healthy run again under the profiler: the card's busy share
    busy = None
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        clock = TickClock()
        reps = engines(clock)
        router = TimedRouter(reps, policy="round_robin", clock=clock)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            uids, reqs = drive("healthy profiled", router, clock, reps)
        same_as_healthy("healthy profiled", reqs, uids)
        busy = device_busy_s(prof) / report["healthy profiled"]["seconds"]
        log(f"  [cluster healthy profiled] card busy {busy:.1%} of the run's wall")
        report["healthy profiled"]["busy_share"] = busy
        del router, reps, reqs, prof

    log(f"[cluster] launches {totals}; {time.perf_counter() - t_phase:.1f}s for the phase; "
        f"card memory {(allocated() - start) / 2**20:.1f} MiB above the phase's start, "
        f"{(allocated() - mark) / 2**20:.1f} MiB above the mark after the healthy run")
    if any(totals[k] == 0 for k in ("distr", "decode", "paged")) or totals["flash"]:
        raise AssertionError(f"cluster: launches off the path: {totals}")
    if cuda:
        free_card(torch, "the cluster phase", base=mark)
    report["phase_s"] = time.perf_counter() - t_phase
    return {"launches": {k: totals[k] for k in ("distr", "decode", "paged")},
            "report": report}


def supervisor_phase(torch, base=None, device="cuda", seq=ROBUST_SEQ) -> dict:
    """minicpm-2b at full width cut to 1 layer (train_robustness_phase's
    model, f32 state, 1 x ``seq`` tokens a step), pallas_distr, trained
    through ``launch.train.run(supervise=SUPERVISE_WORKERS)``'s pieces: a
    ``TrainSupervisor`` (max_missed 2, the straggler policy of
    SUPERVISE_COUNTERS' schedule) over a ``Trainer`` with a fresh temporary
    workdir (checkpoints every SUPERVISE_CKPT_EVERY steps), the faults
    SUPERVISE_FAULTS, SUPERVISE_STEPS steps.  Raises unless the supervisor
    logged the worker's loss, the straggler's exclusion and one remesh to
    the 2 survivors (their shard assignment every shard once) with a
    restore from the step-3 checkpoint, its counters are
    SUPERVISE_COUNTERS, the history is steps 1..5 with the losses of an
    uninterrupted run of the same steps without checkpoints (bit for bit
    when two identical steps on the card agree bit for bit, else within
    SUPERVISE_LOSS_RTOL), the distr forward, delta and distr backward
    kernels launched and the flash ones did not; unless the step-3
    checkpoint, loaded by ``launch.serve.load_params`` (the ``--ckpt``
    loader), holds exactly the params the trainer saved there and gives
    the same prefill and first decode step logits; and unless one step at
    grad_accum 2 matches grad_accum 1 on the same 2 x ``seq`` batch (loss
    within GRAD_ACCUM_RTOL, params within GRAD_ACCUM_PARAM_TOL).  Logs each
    save's and load's seconds."""
    from repro_torch.configs import get_config
    from repro_torch.faults import FaultInjector, FaultSpec
    from repro_torch.kernels import backward as bwd
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.launch.serve import load_params
    from repro_torch.launch.train import init_train_params
    from repro_torch.models import lm
    from repro_torch.obs import TraceRecorder, train_registry
    from repro_torch.obs.validate import validate_chrome_trace, validate_metrics_snapshot
    from repro_torch.serve.serve_step import make_decode_step, make_prefill
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.data import SyntheticLMData
    from repro_torch.train.elastic import StragglerPolicy
    from repro_torch.train.supervisor import TrainSupervisor
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    base = base or get_config("minicpm-2b")
    cfg = base.replace(n_layers=1, attention=base.attention.with_impl("pallas_distr"))
    opt = opt_mod.OptimizerConfig(peak_lr=1e-4, warmup_steps=1, total_steps=SUPERVISE_STEPS,
                                  schedule=cfg.schedule)
    io, saved = [], {}
    originals = {name: getattr(ckpt, name) for name in ("save_checkpoint", "load_checkpoint")}

    def timed_save(ckpt_dir, step, params, *args, **kw):
        if step == SUPERVISE_CKPT_EVERY:  # the params the serving check expects back
            saved["params"] = _float32(torch, params)
        t0 = time.perf_counter()
        path = originals["save_checkpoint"](ckpt_dir, step, params, *args, **kw)
        io.append(("save", Path(path).name, time.perf_counter() - t0))
        log(f"[supervisor] save {io[-1][1]}: {io[-1][2]:.3f}s")
        return path

    def timed_load(*args, **kw):
        t0 = time.perf_counter()
        out = originals["load_checkpoint"](*args, **kw)
        io.append(("load", out[3]["_name"], time.perf_counter() - t0))
        what = "params and AdamW state" if len(args) > 2 else "params"
        log(f"[supervisor] verified load of {io[-1][1]} ({what}): {io[-1][2]:.3f}s")
        return out

    def data(batch=1):
        return SyntheticLMData(cfg.vocab, batch, seq, seed=0)

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_supervise_")
    ckpt.save_checkpoint, ckpt.load_checkpoint = timed_save, timed_load
    try:
        # The supervised run.
        fk.launches = dk.launches = 0
        for name in bwd.launches:
            bwd.launches[name] = 0
        t0 = time.perf_counter()
        rec = TraceRecorder()
        tr = Trainer(cfg, opt, data(), init_train_params(cfg, seed=0, device=device),
                     workdir=workdir, ckpt_every=SUPERVISE_CKPT_EVERY, trace=rec)
        sup = TrainSupervisor(
            tr, num_workers=SUPERVISE_WORKERS, max_missed=2, trace=rec,
            straggler_policy=StragglerPolicy(threshold=2.0, patience=2),
            faults=FaultInjector([FaultSpec(**f) for f in SUPERVISE_FAULTS]))
        hist = [(r["step"], r["loss"]) for r in sup.run(SUPERVISE_STEPS)]
        sync()
        wall = time.perf_counter() - t0
        counts = {"flash": fk.launches, "distr": dk.launches, **bwd.launches}
        counters = {k: v for k, v in sup.counters_snapshot().items() if v}
        events = sup.events
        doc = json.loads(json.dumps(rec.to_chrome()))
        snap = json.loads(json.dumps(train_registry(sup).snapshot()))
        problems = validate_chrome_trace(doc) + validate_metrics_snapshot(snap)
        instants = [(e["name"], e["args"]) for e in doc["traceEvents"]
                    if e["ph"] == "i" and e["name"] in ("worker_loss", "straggler_excluded",
                                                        "remesh")]
        plan = (sup.alive, sup.mesh_plan, sup.shard_assignment, sup.ticks)
        log(f"[supervisor] minicpm-2b, 1 layer, {SUPERVISE_WORKERS} workers: {wall:.2f}s for "
            f"{sup.ticks} ticks; history {hist}; counters {counters}; events {events}; "
            f"alive {plan[0]}, mesh {plan[1]}, shards {plan[2]}; trace instants {instants}; "
            f"launches {counts}; problems {problems}")
        kinds = [e["kind"] for e in events]
        shards = sorted(s for v in sup.shard_assignment.values() for s in v)
        if kinds != ["worker_loss", "straggler_excluded", "remesh"] \
                or events[-1]["restored_step"] != SUPERVISE_CKPT_EVERY \
                or events[-1]["dead"] != [1, 2] or plan[0] != [0, 3] \
                or plan[1] != ((2, 1), ("data", "model")) \
                or shards != list(range(sup.num_shards)) or set(sup.shard_assignment) != {0, 3}:
            raise AssertionError(f"supervisor: events {events}, plan {plan}")
        if counters != SUPERVISE_COUNTERS or [n for n, _ in instants] != kinds or problems:
            raise AssertionError(f"supervisor: counters {counters} (want "
                                 f"{SUPERVISE_COUNTERS}), instants {instants}, problems "
                                 f"{problems}")
        if [s for s, _ in hist] != list(range(1, SUPERVISE_STEPS + 1)):
            raise AssertionError(f"supervisor: history {hist}")
        path = ("distr", "delta", "distr_dq", "distr_dkv")
        if any(counts[n] == 0 for n in path) or any(counts[n] for n in
                                                    ("flash", "flash_dq", "flash_dkv")):
            raise AssertionError(f"supervisor: launches off the path: {counts}")
        del tr, sup, rec
        if cuda:
            torch.cuda.empty_cache()

        # Two identical steps: is the card's training step deterministic?
        batch = {k: torch.as_tensor(v, dtype=torch.int64).to(device)
                 for k, v in data(2).next_batch().items()}
        init = init_train_params(cfg, seed=0, device=device)
        after = []
        for _ in range(2):
            p = _float32(torch, init)
            step = make_train_step(cfg, opt)
            _, _, m = step(p, opt_mod.adamw_init(lm.trainable(p)),
                           {k: v[:1] for k, v in batch.items()}, 0)
            after.append((float(m["loss"]), dict(lm.named_trainable(p))))
        differ = [n for n, t in after[0][1].items() if not torch.equal(t, after[1][1][n])]
        deterministic = after[0][0] == after[1][0] and not differ
        log(f"[supervisor] two identical steps on the card: losses {after[0][0]!r} and "
            f"{after[1][0]!r}; params that differ after the update: {differ or 'none'}")
        del after, p

        # The uninterrupted run: the same steps, no checkpoints.
        plain = Trainer(cfg, opt, data(), _float32(torch, init), workdir=None)
        want = [(r["step"], r["loss"]) for r in (plain.step_once()
                                                for _ in range(SUPERVISE_STEPS))]
        del plain
        gaps = [abs(a - b) / abs(b) for (_, a), (_, b) in zip(hist, want)]
        log(f"[supervisor] uninterrupted losses {want}; relative gaps {gaps}")
        if deterministic and hist != want:
            raise AssertionError(f"supervisor: the recovered losses {hist} differ from the "
                                 f"uninterrupted run's {want} on a deterministic card")
        if max(gaps) > SUPERVISE_LOSS_RTOL:
            raise AssertionError(f"supervisor: recovered losses off by {max(gaps):.3g}")

        # Serve the step-3 checkpoint through the --ckpt loader.
        ckpt_dir = str(Path(workdir, "checkpoints"))
        name = ckpt.latest_verified_name(ckpt_dir)
        loaded = load_params(cfg, ckpt_dir, device=device)
        mismatch = [n for (n, a), (_, b) in zip(lm.named_trainable(loaded),
                                                lm.named_trainable(saved["params"]))
                    if a.dtype != b.dtype or not torch.equal(a, b)]
        toks = batch["tokens"][:1, :seq // 4]
        logits = []
        for params in (loaded, saved["params"]):
            lg, cache = make_prefill(cfg, seq)(params, toks)
            nxt = lg[:, -1].argmax(-1)[:, None]
            pos = torch.full((1,), toks.shape[1], dtype=torch.int32, device=device)
            logits.append((lg, make_decode_step(cfg)(params, nxt, cache, pos)[0]))
        same = [torch.equal(a, b) for a, b in zip(*logits)]
        log(f"[supervisor] served {name}: params equal to the trainer's at its save: "
            f"{not mismatch}; prefill and first decode step logits equal: {same}")
        if name != f"step_{SUPERVISE_CKPT_EVERY:08d}" or mismatch or not all(same):
            raise AssertionError(f"supervisor: serving {name}: params differ at {mismatch}, "
                                 f"logits equal {same}")
        del loaded, saved["params"], logits, cache

        # Grad-accum: one step at 2 microbatches against the whole batch.
        res = {}
        for accum in (1, 2):
            ocfg = opt_mod.OptimizerConfig(peak_lr=1e-2, warmup_steps=0, total_steps=10,
                                           schedule="constant", grad_accum=accum)
            p = _float32(torch, init)
            before = dict(bwd.launches)
            _, _, m = make_train_step(cfg, ocfg)(p, opt_mod.adamw_init(lm.trainable(p)),
                                                 batch, 0)
            sync()
            res[accum] = (float(m["loss"]), p,
                          {k: bwd.launches[k] - before[k] for k in bwd.launches})
        rel = abs(res[2][0] - res[1][0]) / abs(res[1][0])
        dparam = max(float((a - b).detach().abs().max()) for a, b in zip(lm.trainable(res[1][1]),
                                                                lm.trainable(res[2][1])))
        log(f"[supervisor] grad_accum 2 vs 1 on 2 x {seq}: losses {res[2][0]!r} vs "
            f"{res[1][0]!r} (relative gap {rel:.3g}, limit {GRAD_ACCUM_RTOL:g}); largest "
            f"param difference after the update {dparam:.3g} (limit {GRAD_ACCUM_PARAM_TOL:g}); "
            f"backward launches {res[2][2]} vs {res[1][2]}")
        if rel > GRAD_ACCUM_RTOL or dparam > GRAD_ACCUM_PARAM_TOL \
                or res[2][2]["distr_dq"] != 2 * res[1][2]["distr_dq"] or res[1][2]["distr_dq"] == 0:
            raise AssertionError(f"supervisor: grad_accum gap {rel:.3g}, params {dparam:.3g}, "
                                 f"launches {res[2][2]} vs {res[1][2]}")
        accum_report = {"loss_1": res[1][0], "loss_2": res[2][0], "rel_gap": rel,
                        "max_param_diff": dparam}
        del res, p, init, batch
    finally:
        for name_, fn in originals.items():
            setattr(ckpt, name_, fn)
        shutil.rmtree(workdir, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"[supervisor] {phase_s:.1f}s for the phase")
    return {"launches": {n: counts[n] for n in path},
            "report": {"phase_s": phase_s, "wall_s": wall, "history": hist, "uninterrupted": want,
                       "rel_gaps": gaps, "deterministic": deterministic,
                       "params_differing_between_identical_steps": differ,
                       "counters": counters, "events": events, "io": io,
                       "grad_accum": accum_report, "launches": counts}}


def ring_rank(rank: int, world: int, device: str, small: bool) -> dict:
    """One rank of ``ring_phase``, spawned by ``launch.mesh.run_world``; see
    there.  Returns this rank's launches on the ring's calls and, on rank
    0, the checks, hop counts and times."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.distr_attention import DistrConfig
    from repro_torch.distributed import ring_attention as ra
    from repro_torch.kernels import backward as bwd
    from repro_torch.kernels import distr_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.models import lm, transformer
    from repro_torch.models.attention import attention_apply

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    mesh = make_host_mesh(context_parallel=world)
    lead = rank == 0
    dcfg = DistrConfig(group_size=2, block_q=128)
    widths = (RING_SMALL,) if small else RING_WIDTHS
    n_full = RING_SMALL_N if small else RING_N
    n_ragged = RING_SMALL_N - 130 if small else RING_RAGGED_N
    full_hops = {True: world * (world + 1) // 2, False: world * world}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    base = torch.cuda.memory_allocated() if cuda else 0

    def zero():
        fk.launches = dk.launches = 0
        for name in bwd.launches:
            bwd.launches[name] = 0

    ring_launches = dict.fromkeys(RING_KERNELS, 0)

    def ring_call(fn):
        """Run one ring path with every count zeroed just before it and
        read just after; returns its result and the launches summed over
        the ring."""
        sync()
        zero()
        out = fn()
        sync()
        mine = {"flash": fk.launches, "distr": dk.launches, **bwd.launches}
        for name in RING_KERNELS:
            ring_launches[name] += mine[name]
        total = torch.tensor([mine[name] for name in RING_KERNELS], dtype=torch.int64)
        dist.all_reduce(total)
        return out, dict(zip(RING_KERNELS, (int(x) for x in total)))

    def draw(hq, hkv, d, n, dtype, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        shapes = ((1, hq, n, d), (1, hkv, n, d), (1, hkv, n, d))
        q, k, v = (torch.randn(s, generator=gen, device=device).to(dtype) for s in shapes)
        return q, k, v, torch.randn((1, hq, n, d), generator=gen, device=device)

    def ring_fn(impl, q, k, v, causal, **kw):
        if impl == "flash":
            return ra.ring_flash_attention(q, k, v, mesh, causal=causal, **kw)
        return ra.ring_distr_attention(q, k, v, dcfg, mesh, causal=causal, **kw)

    def single_fn(impl, q, k, v, causal):
        if impl == "flash":
            return ops.flash_attention(q, k, v, causal=causal)
        return ops.distr_attention(q, k, v, dcfg, causal=causal)

    failures = []  # raised after the phase's last collective

    def gate(label, share, text):
        """Log a check's reading; a share of its tolerance over 1 (or NaN)
        fails."""
        log(f"  [ring] {label}: {text}; {share:.3g} of its tolerance")
        if not share <= 1.0:
            failures.append(f"ring {label}: {text}")
        return share

    def hold(label, pairs, dtype, *, grads=False):
        """Each (got, want) pair within RING_TOL (the largest error, on O
        or on the gradients) and RING_REL (the largest error as a share of
        the want's largest |value|, and the relative L2 error); returns the
        largest share of a tolerance over the pairs."""
        key = str(dtype).split(".")[-1]
        tol, (rel_max, rel_l2) = RING_TOL[key][int(grads)], RING_REL[key]
        shares = []
        for got, want, name in zip(*zip(*pairs), ("dq", "dk", "dv") if grads else ("",)):
            g, w = got.float(), want.float()
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            l2 = float((g - w).norm() / w.norm())
            shares.append(gate(f"{label}{name}", max(err / tol, err / (rel_max * scale),
                                                     l2 / rel_l2), (
                f"largest error {err:.3g} (tolerance {tol}), {err / scale:.3g} of its largest "
                f"|value| {scale:.3g} (tolerance {rel_max:.3g}), relative L2 {l2:.3g} "
                f"(tolerance {rel_l2})")))
        return max(shares) if all(x == x for x in shares) else math.nan

    def launches_gate(label, got, impl, hops, backward):
        if not cuda:  # CPU tensors take the plain versions, which launch nothing
            return
        want = dict.fromkeys(RING_KERNELS, 0)
        want["flash" if impl == "flash" else "distr"] = hops
        if backward:
            want.update({f"{impl}_dq": hops, f"{impl}_dkv": hops, "delta": world})
        if got != want:
            raise AssertionError(f"ring {label}: launches {got}, want {want} (one launch "
                                 "of each kernel a hop run)")

    checks, hop_counts = [], {}

    def case(label, impl, hq, hkv, d, n, causal, dtype, seed):
        t0 = time.perf_counter()
        q, k, v, w = draw(hq, hkv, d, n, dtype, seed)
        q, k, v = (x.requires_grad_() for x in (q, k, v))

        def fwd_bwd():
            out, hops = ring_fn(impl, q, k, v, causal, return_hops=True)
            return out, hops, torch.autograd.grad((out.float() * w).sum(), (q, k, v))

        (out, hops, grads), got = ring_call(fwd_bwd)
        name = f"{impl} {label} N={n} {'causal' if causal else 'non-causal'} {dtype}"
        hop_counts[name] = hops
        if hops != full_hops[causal]:
            raise AssertionError(f"ring {name}: {hops} hops, want {full_hops[causal]}")
        launches_gate(name, got, impl, hops, backward=True)
        row = {"case": name, "hops": hops, "launches": got}
        if lead:
            ref = single_fn(impl, q, k, v, causal)
            ref_grads = torch.autograd.grad((ref.float() * w).sum(), (q, k, v))
            if not (torch.isfinite(out).all() and all(torch.isfinite(g).all() for g in grads)):
                failures.append(f"ring {name}: a non-finite output or gradient")
            row["o_share"] = hold(f"{name} O", [(out, ref)], dtype)
            row["grad_share"] = hold(f"{name} ", list(zip(grads, ref_grads)), dtype,
                                     grads=True)
            row["s"] = time.perf_counter() - t0
            log(f"  [ring] {name}: {row['s']:.2f} s")
        checks.append(row)

    t_cases = time.perf_counter()
    seed = 0
    for label, hq, hkv, d in widths:
        for impl in ("flash", "distr"):
            for causal in (True, False):
                seed += 1
                case(label, impl, hq, hkv, d, n_full, causal,
                     torch.float32 if small else torch.bfloat16, seed)
    label, hq, hkv, d = widths[0]
    if not small:
        for impl in ("flash", "distr"):
            case(RING_SMALL[0], impl, *RING_SMALL[1:], RING_SMALL_N, True, torch.float32, 90)
    for impl in ("flash", "distr"):  # a partly live tail shard
        for causal in (True, False):
            case(f"{label} ragged", impl, hq, hkv, d, n_ragged, causal,
                 torch.float32 if small else torch.bfloat16, 91)
    cases_s = time.perf_counter() - t_cases

    def dead_case(dtype):
        """A dead shard: its KV never arrives, hop 0 always runs.
        Non-causal, so the dead source's hops to the other P − 1 ranks are
        all skipped."""
        t0 = time.perf_counter()
        q, k, v, _ = draw(hq, hkv, d, n_full, dtype, 92)
        with torch.no_grad(), ra.dead_shard_fault(RING_DEAD):
            (out, hops), got = ring_call(lambda: ra.ring_flash_attention(
                q, k, v, mesh, causal=False, return_hops=True))
        want = world * world - (world - 1) * len(RING_DEAD)
        name = f"flash {label} N={n_full} non-causal, dead shards {RING_DEAD}"
        hop_counts[name] = hops
        if hops != want or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"ring {name}: {hops} hops (want {want}), or a non-finite "
                                 "output")
        launches_gate(name, got, "flash", hops, backward=False)
        row = {"case": name, "hops": hops, "launches": got}
        if lead:
            # Rows of the live shards see every key but the dead shard's;
            # the dead shard's own rows see every key.
            live = (world - len(RING_DEAD)) * (n_full // world)
            with torch.no_grad():
                ref_live = ops.flash_attention(q[:, :, :live], k[:, :, :live], v[:, :, :live])
                ref_all = ops.flash_attention(q, k, v)
            row["o_share"] = hold(f"{name} O (live rows)", [(out[:, :, :live], ref_live)],
                                  dtype)
            row["dead_o_share"] = hold(f"{name} O (the dead shard's rows)",
                                       [(out[:, :, live:], ref_all[:, :, live:])], dtype)
            row["s"] = time.perf_counter() - t0
            log(f"  [ring] {name}: {row['s']:.2f} s")
        checks.append(row)

    def wall_times(dtype):
        """The ring's wall time beside the single-device call (flash
        forward, causal, the first widths): P processes sharing one card,
        so this measures the hops' host staging, not ring speed across
        cards."""
        q, k, v, _ = draw(hq, hkv, d, n_full, dtype, 93)
        times = {"shape": f"{label} N={n_full} causal", "ring_s": [], "single_s": []}
        with torch.no_grad():
            for _ in range(RING_ITERS):
                dist.barrier()
                sync()
                t0 = time.perf_counter()
                ring_call(lambda: ra.ring_flash_attention(q, k, v, mesh, causal=True))
                times["ring_s"].append(time.perf_counter() - t0)
            dist.barrier()
            if lead:
                for _ in range(RING_ITERS + 1):
                    sync()
                    t0 = time.perf_counter()
                    ops.flash_attention(q, k, v, causal=True)
                    sync()
                    times["single_s"].append(time.perf_counter() - t0)
                times["single_s"] = times["single_s"][1:]
            dist.barrier()
        return times

    dtype = torch.float32 if small else torch.bfloat16
    dead_case(dtype)
    times = wall_times(dtype)

    # minicpm-2b through attend → _ring_dispatch, per impl: the whole
    # forward, then every layer's attention on the single-device input.
    base_cfg = get_config("minicpm-2b", reduced=small)
    params = lm.init_params(base_cfg, torch.Generator(device=device).manual_seed(0), device)
    tokens = torch.randint(1, base_cfg.vocab, (1, n_full), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    proj = params.get("lsh_proj")
    model = {}

    def rel_l2(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    def layer_pass(cfg) -> list:
        """Layer by layer on the single-device forward's hidden states
        (every rank runs it, so every rank holds the same layer input):
        the checked layers' attention output under the mesh against the
        single-device one; {layer: relative L2} on rank 0."""
        x, positions = lm.embed_inputs(params, cfg, tokens)
        stack = lm.decoder_layers(params, cfg)
        k = min(RING_LAYERS_CHECKED, len(stack))
        checked = {round(i * (len(stack) - 1) / max(k - 1, 1)) for i in range(k)}
        errs = {}
        for i, (layer_type, lp) in enumerate(stack):
            if i in checked:
                h = transformer.norm_apply(lp["norm1"], x, cfg)
                with set_mesh(mesh):
                    o_ring, _ = attention_apply(lp["attn"], h, cfg, positions=positions,
                                                proj=proj)
                if lead:
                    o_one, _ = attention_apply(lp["attn"], h, cfg, positions=positions,
                                               proj=proj)
                    errs[i] = (rel_l2(o_ring, o_one) if bool(torch.isfinite(o_ring).all())
                               else math.nan)
            x, _, _ = transformer.block_apply_aux(lp, x, cfg, positions=positions, proj=proj,
                                                  layer_type=layer_type)
        return errs

    with torch.no_grad():
        for impl in RING_IMPLS:
            cfg = base_cfg.replace(attention=replace(base_cfg.attention, impl=impl,
                                                     context_axis="context"))
            row = model[impl] = {}
            dist.barrier()
            t0 = time.perf_counter()
            with set_mesh(mesh):
                (hidden, _), got = ring_call(lambda: lm.backbone(params, cfg, tokens))
            row["ring_s"] = time.perf_counter() - t0
            want = dict.fromkeys(RING_KERNELS, 0)
            want["flash" if impl == "pallas_flash" else "distr"] = cfg.n_layers * full_hops[True]
            if cuda and got != want:
                raise AssertionError(f"minicpm-2b {impl} under the ring: launches {got}, "
                                     f"want {want}")
            row["launches"] = got
            if lead:
                sync()
                t0 = time.perf_counter()
                ref, _ = lm.backbone(params, cfg, tokens)  # no active mesh: one device
                sync()
                row["single_s"] = time.perf_counter() - t0
                if not bool(torch.isfinite(hidden).all()):
                    failures.append(f"minicpm-2b {impl} under the ring: non-finite hidden "
                                    "states")
                row["hidden_rel_l2"] = rel_l2(hidden, ref)
                logits = lm.logits_fn(params, cfg, hidden[:, -1:]).float()[..., :cfg.vocab]
                ref_logits = lm.logits_fn(params, cfg, ref[:, -1:]).float()[..., :cfg.vocab]
                row["last_logits_max_abs_err"] = max_err(torch, logits, ref_logits)
                row["last_logits_scale"] = float(ref_logits.abs().max())
                row["last_argmax_equal"] = bool(logits.argmax(-1).eq(ref_logits.argmax(-1)).all())
                del ref, logits, ref_logits
            del hidden
            dist.barrier()
            t0 = time.perf_counter()
            layer_l2 = layer_pass(cfg)
            sync()
            row["layers_s"] = time.perf_counter() - t0
            if lead:
                row["layer_rel_l2"] = layer_l2
                errs = list(layer_l2.values())
                worst = max(errs) if all(e == e for e in errs) else math.nan
                row["layer_share"] = gate(
                    f"minicpm-2b {impl}, the attention output of layers {sorted(layer_l2)} on "
                    f"the single-device layer input (N={n_full})", worst / RING_LAYER_TOL,
                    f"largest relative L2 {worst:.3g} (median {statistics.median(errs):.3g}; "
                    f"tolerance {RING_LAYER_TOL})")
                log(f"  [ring] minicpm-2b {impl}: {json.dumps(row)}")
            dist.barrier()
    del params, tokens, proj
    gc.collect()
    sync()
    left = (torch.cuda.memory_allocated() - base) if cuda else 0
    if cuda:
        torch.cuda.empty_cache()
    if left > CYCLE_SLACK:
        failures.append(f"rank {rank}: {left / 2**20:.1f} MiB still allocated after the ring "
                        "phase")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"rank": rank, "launches": ring_launches, "left_bytes": left,
            **({"checks": checks, "hops": hop_counts, "times": times, "model": model,
                "cases_s": cases_s} if lead else {})}


def ring_phase(torch, device="cuda", small: bool = False) -> dict:
    """Ring context-parallel attention (``distributed/ring_attention.py``) on
    RING_WORLD ranks spawned as processes that share the card, joined in a
    gloo world over a ``FileStore`` (``launch.mesh.run_world``), each
    holding the same seeded global tensors.  Rank by rank (``ring_rank``):
    ring flash and ring DistrAttention (G* = 2, block_q 128), forward and
    the gradients of q, k and v, at starcoder2-7b's serving widths (36 query
    heads over 4, d = 128) and minicpm-2b's training widths (36 heads of
    64), N = RING_N, causal and non-causal, bf16, a small f32 case, and a
    ragged N whose last shard is partly live, causal and non-causal; each
    held on rank 0 against the single-device op (``kernels.ops``) on the
    same card within RING_TOL and, tensor by tensor, RING_REL of its own
    scale, each hop count P(P+1)/2 causal or P² non-causal, and each
    call's launches one of the forward kernel a hop (and of dq and dkv,
    and of delta a rank).  A flash ring under ``dead_shard_fault(RING_DEAD)``:
    P² − (P − 1) hops, finite, the live shards' rows equal to attention
    over the live keys and the dead shard's rows to full attention.  The
    ring flash forward's wall time beside the single-device call's.  Then
    minicpm-2b at its published size (40 layers, seeded random bf16
    weights, a kernel impl with ``context_axis="context"``) through
    ``models/lm.py::backbone`` on an N-token prompt under the active mesh,
    every attention through ``core.api._ring_dispatch`` (the launches: one
    forward kernel a hop and layer), its final hidden states finite, their
    gap from the single-device forward's and the last position's logits
    reported; then layer by layer on the single-device forward's hidden
    states, RING_LAYERS_CHECKED layers' attention output under the mesh
    against the single-device one on the same input within RING_LAYER_TOL
    (relative L2); under pallas_flash, then pallas_distr.  A rank collects its
    failed checks and raises them after its last collective.  Raises on
    any failure, when a ring kernel of RING_KERNELS never launched, when a
    rank leaves more than CYCLE_SLACK allocated, and when the card's free
    memory is not back within CYCLE_SLACK of the phase's start once the
    ranks have exited."""
    from repro_torch.launch.mesh import run_world

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    reports = run_world(ring_rank, RING_WORLD, device, small, timeout_s=900)
    wall = time.perf_counter() - t0
    gap = 0
    if cuda:
        for _ in range(20):  # the CUDA driver frees an exited process's memory
            gap = free0 - torch.cuda.mem_get_info()[0]
            if gap <= CYCLE_SLACK:
                break
            time.sleep(0.5)
        log(f"[memory] after the ring phase: the card's free memory is {gap / 2**20:.1f} MiB "
            "below its start")
        if gap > CYCLE_SLACK:
            raise AssertionError(f"the ring phase left {gap / 2**20:.1f} MiB of the card in use")
    lead = reports[0]
    launches = {name: sum(r["launches"][name] for r in reports) for name in RING_KERNELS}
    missing = [name for name in RING_KERNELS if launches[name] == 0]
    if cuda and missing:
        raise AssertionError(f"the ring path never launched {missing}: {launches}")
    for row in lead["checks"]:
        log(f"[ring] {json.dumps({k: row[k] for k in row if k != 'launches'})}")
    log(f"[ring] hops: {json.dumps(lead['hops'])}")
    times = lead["times"]
    model = lead["model"]
    log(f"[ring] flash forward, {times['shape']}: ring "
        f"{statistics.median(times['ring_s']) * 1e3:.1f} ms, single device "
        f"{statistics.median(times['single_s']) * 1e3:.1f} ms (wall, median of {RING_ITERS}; "
        f"{RING_WORLD} processes sharing one card: correctness, not ring speed)")
    log(f"[ring] minicpm-2b forward: {json.dumps(model)}")
    log(f"[ring] phase {wall:.1f} s, checks {lead['cases_s']:.1f} s; launches {launches}")
    report = {"checks": lead["checks"], "hops": lead["hops"], "times": times, "model": model,
              "wall_s": wall, "free_gap_bytes": gap, "launches": launches}
    return {"report": report, "launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    ap.add_argument("--only", choices=("kernels", "moe", "encdec", "tune", "cluster", "ring"),
                    default=None,
                    help="kernels: stop after the kernel phases; moe: run only the MoE "
                         "check and the MoE configs' serving; encdec: run only the "
                         "non-causal kernel checks and whisper-small's and internvl2-2b's "
                         "serving and training; tune: run only the tuner's phase; cluster: "
                         "run only the cluster router's and the training supervisor's "
                         "phases; ring: run only the ring context-parallel attention "
                         "phase (4 ranks sharing the card); each prints a JSON summary")
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
    if args.only == "moe":
        moe = moe_phases(torch)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"card": card, **moe["results"]}, indent=1))
        log(card)
        print(json.dumps({"launches": moe["launches"]}), flush=True)
        return 0
    if args.only == "tune":
        from repro_torch.configs import get_config
        from repro_torch.models import lm

        params = lm.init_params(get_config("starcoder2-7b"),
                                torch.Generator(device="cuda").manual_seed(0), "cuda")
        tuned = tune_phase(torch, params)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"card": card, "tune": tuned["report"]},
                                                 indent=1))
        log(card)
        print(json.dumps({"launches": tuned["launches"]}), flush=True)
        return 0
    if args.only == "cluster":
        from repro_torch.configs import get_config
        from repro_torch.models import lm

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        params = lm.init_params(get_config("starcoder2-7b"),
                                torch.Generator(device="cuda").manual_seed(0), "cuda")
        clustered = cluster_phase(torch, params)
        del params
        free_card(torch, "starcoder2-7b serving")
        supervised = supervisor_phase(torch)
        free_card(torch, "the supervisor phase", gate=False)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"card": card, "cluster": clustered["report"],
                                                  "supervisor": supervised["report"]},
                                                 indent=1))
        log(card)
        print(json.dumps({"launches": {"cluster": clustered["launches"],
                                       "supervisor": supervised["launches"]}}), flush=True)
        return 0
    if args.only == "ring":
        ringed = ring_phase(torch)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"card": card, "ring": ringed["report"]},
                                                 indent=1))
        log(card)
        print(json.dumps({"launches": {"ring": ringed["launches"]}}), flush=True)
        return 0
    if args.only == "encdec":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        nc = noncausal_phase(torch, flush)
        enc_dec = encdec_decode_phase(torch, flush)
        del flush
        enc = encdec_phases(torch)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"card": card, "noncausal": nc["shapes"],
                                                  "encdec_decode": enc_dec["shapes"],
                                                  **enc["results"]}, indent=1))
        log(card)
        print(json.dumps({"launches": enc["launches"]}), flush=True)
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
    # The dense qwen configs' shapes through the serving kernels' checks:
    # qwen1.5-4b is MHA (B·H = 20; one row a KV head in a decode tick, 32 in
    # a chunk), qwen2.5-32b GQA at 40 over 8 (5 rows a KV head; 160).
    qwen = {}
    for label, hq, hkv in QWEN_KERNEL_SHAPES:
        qwen[label] = {
            "prefill": prefill_phase(torch, flush, hq=hq, hkv=hkv, ns=(max(PREFILL_NS),),
                                     label=label, train_shape=False),
            "decode": decode_phase(torch, flush, hq=hq, hkv=hkv, label=label),
            "paged": paged_kernel_phase(torch, flush, hq=hq, hkv=hkv, label=label)}
        for name in ("flash", "distr"):
            pre[name]["max_abs_err"] = max(pre[name]["max_abs_err"],
                                           qwen[label]["prefill"][name]["max_abs_err"])
        dec["max_abs_err"] = max(dec["max_abs_err"], qwen[label]["decode"]["max_abs_err"])
        pdec["max_abs_err"] = max(pdec["max_abs_err"], qwen[label]["paged"]["max_abs_err"])
    # whisper-small's non-causal shapes (Nq = 448 and 1500 over 1500 keys),
    # forward and backward, and the decode kernel at the enc-dec and VLM
    # serving steps' shapes, before any model runs them.
    nc = noncausal_phase(torch, flush)
    enc_dec = encdec_decode_phase(torch, flush)
    dec["max_abs_err"] = max(dec["max_abs_err"], enc_dec["max_abs_err"])
    for name in ("flash", "distr"):
        pre[name]["max_abs_err"] = max(pre[name]["max_abs_err"], nc[name]["max_abs_err"])
    for name in ("delta", "flash_dq", "flash_dkv", "distr_dq", "distr_dkv"):
        back[name]["max_abs_err"] = max(back[name]["max_abs_err"], nc[name]["max_abs_err"])
    log(card)
    ssd_grad = ssd_grad_phase(torch)
    gen = torch.Generator(device="cuda").manual_seed(10)
    q, k, v = (torch.randn((1, 20, max(PREFILL_NS), 128), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    gaussian_scores = scores_phase(torch, q, k, v, "gaussian")
    del flush, q, k, v
    results = {"card": card, "tensor_cores": tensor_cores, "delta_sass": delta_sass,
               "distr_vs_flash": distr_vs_flash_table(pre["shapes"], g4, a112, back["shapes"]),
               "prefill_shapes": pre.pop("shapes"), "distr_g4": g4,
               "paged_shapes": pdec.pop("shapes"), "backward_shapes": back.pop("shapes"),
               "delta_shapes": back.pop("delta_shapes"),
               "ssd_shapes": ssd.pop("shapes"), "head_dim_112": a112, "qwen_kernels": qwen,
               "ssd_grad": ssd_grad, "scores": {"gaussian": gaussian_scores},
               "noncausal": nc["shapes"], "encdec_decode": enc_dec["shapes"]}
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
        tuned = tune_phase(torch, params)
        results["tune"] = tuned["report"]
        dec["max_abs_err"] = max(dec["max_abs_err"], tuned["report"]["max_abs_err"]["decode"])
        pdec["max_abs_err"] = max(pdec["max_abs_err"], tuned["report"]["max_abs_err"]["paged"])
        clustered = cluster_phase(torch, params)
        results["cluster"] = clustered["report"]
        del params
        free_card(torch, "starcoder2-7b serving")
        for name, count in (*fused["launches"].items(), *chaos["launches"].items(),
                            *traced["launches"].items(), *tuned["launches"].items(),
                            *clustered["launches"].items()):
            launches[name] += count
        for arch, n_layers in QWEN_SERVE:
            res = model_serve_phase(torch, arch, n_layers, scores=arch == "qwen1.5-4b")
            results[f"{arch} serve"] = res["report"]
            for name, count in res["launches"].items():
                launches[name] += count
        results["scores"]["qwen1.5-4b layer 0"] = results["qwen1.5-4b serve"].pop("scores")
        moe = moe_phases(torch)
        results.update(moe["results"])
        for name, count in moe["launches"].items():
            launches[name] += count
        for phase in (whisper_serve_phase, vlm_serve_phase):
            res = phase(torch)
            results[phase.__name__] = res["report"]
            for name, count in res["launches"].items():
                launches[name] += count
        hybrid = hybrid_serve_phase(torch)
        results["hybrid_serve"] = hybrid["report"]
        for name, count in hybrid["launches"].items():
            launches[name] += count
        train = train_phase(torch)
        results["train"] = train["report"]
        mamba = mamba_train_phase(torch)
        results["train_mamba2_130m"] = mamba["report"]
        encdec_train = encdec_train_phase(torch)
        results["train_encdec_vlm"] = encdec_train["report"]
        robust = train_robustness_phase(torch)
        results["train_robustness"] = robust["report"]
        supervised = supervisor_phase(torch)
        results["supervisor"] = supervised["report"]
        free_card(torch, "the supervisor phase", gate=False)
        ringed = ring_phase(torch)
        results["ring"] = ringed["report"]
        for name, count in (*train["launches"].items(), *mamba["launches"].items(),
                            *encdec_train["launches"].items(),
                            *robust["launches"].items(), *supervised["launches"].items(),
                            *ringed["launches"].items()):
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
