"""Training launcher: the trainer over a model with seeded random weights
and the synthetic token stream (or binary token shards).

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
      --impl pallas_distr --steps 4 --batch 4 --seq 2048

Every family trains: the dense configs, the attention-free mamba2-130m
(``--arch mamba2-130m``) and the hybrid zamba2-7b, whose Mamba-2 layers
take ``ops.ssd``'s gradient.

Runs on the GPU unless ``--device cpu`` is given (then use ``--reduced``:
the CPU runs the kernels' plain PyTorch versions).  The run keeps
verified checkpoints in ``--workdir`` (default ``default_workdir``: one
directory a config under the temporary directory, as the reference's
launcher defaults to its own): a baseline at step 0, every
``--ckpt-every`` steps, emergency and final saves; it resumes from the
newest verified one and keeps the anomaly guard on (``--anomaly-z``,
``--max-rollbacks``).  ``--trace PATH`` writes a Chrome trace of
the per-step spans and the checkpoint and rollback instants,
``--metrics-out PATH`` the trainer's metrics snapshot
(``obs.metrics.train_registry``).  ``--tune off|analytic|measure`` sets
``REPRO_TUNE`` (default: the environment's); the run then resolves the
training shape's attention blocks, forward and backward, before its first
step, so under ``measure`` a sweep runs there and never inside a step.
``--supervise N`` runs the trainer under ``train.supervisor.TrainSupervisor``
with N simulated workers (heartbeat failure detection, straggler
exclusion, remesh and restore from the newest verified checkpoint on a
worker's loss); ``--metrics-out`` then reads the supervisor, whose
counters merge the trainer's.

On a mesh: started by ``torchrun`` (``WORLD_SIZE`` > 1) the launcher joins
the world from its environment on a gloo group (the wire layer of
``distributed.collectives``) and trains on ``make_host_mesh(--model-parallel,
--context-parallel)`` (defaults 1 and 1, as the reference's):
data-parallel and FSDP over the ranks left, tensor parallel over "model",
the ring over "context" (``--context-parallel`` > 1 sets the config's
``context_axis``).  ``--device cuda`` becomes ``cuda:{LOCAL_RANK %
device_count}``.  Every rank draws the same seeded params and data; rank 0
writes the checkpoints.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch minicpm-2b \
      --reduced --device cpu --model-parallel 2
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
from dataclasses import replace

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.api import IMPLS, resolve_attention_blocks
from repro_torch.launch.mesh import make_host_mesh, set_mesh
from repro_torch.models import lm
from repro_torch.obs import TraceRecorder, set_recorder, train_registry
from repro_torch.train.anomaly import AnomalyConfig
from repro_torch.train.data import BinaryShardData, SyntheticLMData
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.supervisor import TrainSupervisor
from repro_torch.train.trainer import Trainer
from repro_torch.tune.autotune import tune_mode, tuned_attention
from repro_torch.utils.device import resolve_device



def default_workdir(arch: str, reduced: bool = False) -> str:
    """The launcher's checkpoint directory when ``--workdir`` is not given:
    ``<tmp>/repro_torch_train/<arch>[-reduced]``, under
    ``tempfile.gettempdir()`` (it follows ``TMPDIR``), one for each config,
    so that a run never resumes another config's checkpoints."""
    name = f"{arch}-reduced" if reduced else arch
    return os.path.join(tempfile.gettempdir(), "repro_torch_train", name)


def init_train_params(cfg, *, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Seeded random params in ``cfg.param_dtype`` on ``device``."""
    dev = resolve_device(device)
    return lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                          dtype=lm.param_dtype(cfg))


def warm_train(cfg, seq: int, *, device: str | torch.device = "cuda"):
    """Resolve (under ``REPRO_TUNE=measure``: sweep and persist) the
    attention blocks of a ``seq``-token training step, forward and
    backward (the flash kernels' tiles, or DistrAttention's with the
    backward's keys swept at the pinned block_q) → their ``BlockSizes``,
    or None for a model that runs no attention kernel (the reference impl,
    MLA, the SSM family)."""
    if not tuned_attention(cfg):
        return None
    return resolve_attention_blocks(
        cfg.attention, d=cfg.head_dim_, n_q=seq,
        dtype="bfloat16" if cfg.compute_dtype == "bfloat16" else "float32", causal=True,
        bwd=True, device=resolve_device(device), heads=(cfg.n_heads, cfg.n_kv_heads))


def join_world() -> None:
    """Join the process group ``torchrun``'s environment names (gloo, the
    backend the mesh's wire layer takes), unless there is none to join or
    this process has joined one already."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        dist.init_process_group("gloo", init_method="env://")


def rank_device(device: str) -> str:
    """``cuda`` as this rank's card, ``cuda:{LOCAL_RANK % device_count}``;
    any other device as given."""
    if device != "cuda" or not torch.cuda.is_available():
        return device
    return f"cuda:{int(os.environ.get('LOCAL_RANK', '0')) % torch.cuda.device_count()}"


def train_mesh(cfg, model_parallel: int = 1, context_parallel: int = 1):
    """(cfg, the mesh) the run trains on: a host mesh over the process world
    when it has more than one rank or ``context_parallel`` > 1 (which also
    sets the config's ``context_axis``), else (cfg, None)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1 and context_parallel == 1 and model_parallel == 1:
        return cfg, None
    if context_parallel > 1:
        cfg = cfg.replace(attention=replace(cfg.attention, context_axis="context"))
    return cfg, make_host_mesh(model_parallel, context_parallel)


def run(cfg, params: dict, *, steps: int = 100, batch: int = 8, seq: int = 128,
        lr: float = 1e-3, grad_accum: int = 1, seed: int = 0,
        device: str | torch.device = "cuda", workdir: str | None = None,
        data: str | None = None, ckpt_every: int = 200, anomaly_z: float = 8.0,
        max_rollbacks: int = 3, supervise: int = 0, model_parallel: int = 1,
        context_parallel: int = 1, trace=None) -> dict:
    """Train ``params`` (on ``device``) for ``steps`` steps on
    ``SyntheticLMData(cfg.vocab, batch, seq, seed)``, or on the ``.bin``
    shards the glob ``data`` names, logging every 10th step.  With ``workdir``
    the trainer checkpoints there and resumes from it; with ``supervise``
    > 0 a ``TrainSupervisor`` of that many simulated workers drives it;
    ``trace`` is the recorder both emit to (None: the process-global one).
    In a world of several ranks (or with ``context_parallel`` > 1) it trains
    on ``train_mesh``'s mesh, ``params`` the full params on every rank.
    Returns the trainer, the supervisor (None without one), the history,
    the step times, tokens/s over the steps after the first (which pays for
    the kernel build and first-use setup), the count of skipped steps and,
    on CUDA, the peak of
    ``torch.cuda.max_memory_allocated`` in bytes (None on the CPU)."""
    dev = resolve_device(device)
    opt_cfg = OptimizerConfig(peak_lr=lr, warmup_steps=max(steps // 20, 1), total_steps=steps,
                              schedule=cfg.schedule, grad_accum=grad_accum)
    if data:
        dataset = BinaryShardData(sorted(glob.glob(data)), batch, seq)
    else:
        dataset = SyntheticLMData(cfg.vocab, batch, seq, seed=seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    anomaly = AnomalyConfig(enabled=anomaly_z > 0, z_threshold=anomaly_z or 8.0,
                            max_rollbacks=max_rollbacks)
    cfg, mesh = train_mesh(cfg, model_parallel, context_parallel)
    trainer = Trainer(cfg, opt_cfg, dataset, params, workdir=workdir, mesh=mesh,
                      ckpt_every=ckpt_every, anomaly=anomaly, trace=trace)
    sup = None
    if supervise > 0:
        sup = TrainSupervisor(trainer, num_workers=supervise, model_parallel=model_parallel,
                              trace=trace)
        hist = sup.run(steps)
        print(f"[train] supervisor counters: {sup.counters_snapshot()}")
    else:
        hist = trainer.run(steps)
    times = [r["sec"] for r in hist]
    warm = times[1:] or times
    return {
        "trainer": trainer,
        "supervisor": sup,
        "mesh": mesh,
        "history": hist,
        "step_times": times,
        "tok_per_s": batch * seq * len(warm) / sum(warm),
        "nan_skips": trainer.counters["nan_skips"],
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--impl", choices=IMPLS, default=None,
                    help="attention impl (default: the config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel degree: the 'model' axis of the mesh over the "
                         "process world")
    ap.add_argument("--context-parallel", type=int, default=1,
                    help="ring sequence-parallel attention degree: shards the sequence over "
                         "a 'context' mesh axis (distributed.ring_attention)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None,
                    help="checkpoint here and resume from the newest verified checkpoint "
                         "(default: <tmp>/repro_torch_train/<arch>[-reduced])")
    ap.add_argument("--data", default=None,
                    help="glob of .bin token shards (default: synthetic)")
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--anomaly-z", type=float, default=8.0,
                    help="z-score threshold of the loss/grad-norm spike detector (rolls "
                         "back to the last verified checkpoint; 0 disables the guard)")
    ap.add_argument("--max-rollbacks", type=int, default=3,
                    help="consecutive no-progress anomaly rollbacks before the run halts")
    ap.add_argument("--supervise", type=int, default=0, metavar="N",
                    help="run under TrainSupervisor with N simulated workers: heartbeat "
                         "failure detection, straggler exclusion, remesh and verified-"
                         "checkpoint restore on a worker's loss (0: the plain Trainer)")
    ap.add_argument("--tune", choices=("off", "analytic", "measure"), default=None,
                    help="block-size autotuning mode (sets REPRO_TUNE; default: the "
                         "environment's)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace_event JSON of the run")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a typed metrics snapshot of the run")
    args = ap.parse_args(argv)

    if args.tune:
        os.environ["REPRO_TUNE"] = args.tune
    join_world()
    device = rank_device(args.device)
    print(f"[train] device {device}"
          + (f", rank {dist.get_rank()} of {dist.get_world_size()}" if dist.is_initialized()
             else ""))
    cfg = get_config(args.arch, reduced=args.reduced)
    workdir = args.workdir or default_workdir(args.arch, args.reduced)
    print(f"[train] checkpoints in {workdir}")
    if args.impl is not None:
        cfg = cfg.replace(attention=cfg.attention.with_impl(args.impl))
    rec = None
    if args.trace:
        rec = TraceRecorder()
        set_recorder(rec)  # the tuner's sweeps ride the global recorder
    try:
        mesh_cfg, mesh = train_mesh(cfg, args.model_parallel, args.context_parallel)
        if mesh is not None:
            print(f"[train] mesh: {dict(mesh.shape)}")
        with set_mesh(mesh):  # a ring's tuner key is one rank's shard
            blocks = warm_train(mesh_cfg, args.seq, device=device)
        if blocks is not None:
            print(f"[train] attention blocks ({tune_mode()}): {blocks}")
        params = init_train_params(cfg, seed=args.seed, device=device)
        out = run(cfg, params, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                  grad_accum=args.grad_accum, seed=args.seed, device=device,
                  workdir=workdir, data=args.data, ckpt_every=args.ckpt_every,
                  anomaly_z=args.anomaly_z, max_rollbacks=args.max_rollbacks,
                  supervise=args.supervise, model_parallel=args.model_parallel,
                  context_parallel=args.context_parallel, trace=rec)
    finally:
        set_recorder(None)
    hist = out["history"]
    if hist:
        print(f"[train] loss {hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f} over {len(hist)} "
              f"steps; {out['tok_per_s']:.1f} tok/s after the first step; "
              f"{out['nan_skips']} skipped")
    if out["max_memory_allocated"] is not None:
        print(f"[train] peak memory allocated {out['max_memory_allocated'] / 2**30:.2f} GiB")
    if rec is not None:
        rec.save(args.trace)
        print(f"[train] trace: {args.trace} ({len(rec.events)} events)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(train_registry(out["supervisor"] or out["trainer"]).snapshot(), f,
                      indent=1)
        print(f"[train] metrics: {args.metrics_out}")
    return out


if __name__ == "__main__":
    main()
