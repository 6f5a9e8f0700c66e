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
Loading weights from disk and the supervisor (``--supervise``) are not
ported yet.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.api import IMPLS, resolve_attention_blocks
from repro_torch.models import lm
from repro_torch.obs import TraceRecorder, set_recorder, train_registry
from repro_torch.train.anomaly import AnomalyConfig
from repro_torch.train.data import BinaryShardData, SyntheticLMData
from repro_torch.train.optimizer import OptimizerConfig
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
    backward → their ``BlockSizes``, or None for a model that runs no
    attention kernel (the reference impl, MLA, the SSM family)."""
    if not tuned_attention(cfg):
        return None
    return resolve_attention_blocks(
        cfg.attention, d=cfg.head_dim_, n_q=seq,
        dtype="bfloat16" if cfg.compute_dtype == "bfloat16" else "float32", causal=True,
        bwd=True, device=resolve_device(device))


def run(cfg, params: dict, *, steps: int = 10, batch: int = 8, seq: int = 128,
        lr: float = 1e-3, grad_accum: int = 1, seed: int = 0,
        device: str | torch.device = "cuda", workdir: str | None = None,
        data: str | None = None, ckpt_every: int = 200, anomaly_z: float = 8.0,
        max_rollbacks: int = 3, trace=None) -> dict:
    """Train ``params`` (on ``device``) for ``steps`` steps on
    ``SyntheticLMData(cfg.vocab, batch, seq, seed)``, or on the ``.bin``
    shards the glob ``data`` names, logging every step.  With ``workdir``
    the trainer checkpoints there and resumes from it; ``trace`` is the
    recorder it emits to (None: the process-global one).  Returns the
    trainer, the history, the step times, tokens/s over the steps after the
    first (which pays for the kernel build and first-use setup), the count
    of skipped steps and, on CUDA, the peak of
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
    trainer = Trainer(cfg, opt_cfg, dataset, params, workdir=workdir, ckpt_every=ckpt_every,
                      anomaly=anomaly, trace=trace)
    hist = trainer.run(steps)
    times = [r["sec"] for r in hist]
    warm = times[1:] or times
    return {
        "trainer": trainer,
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
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
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
        blocks = warm_train(cfg, args.seq, device=args.device)
        if blocks is not None:
            print(f"[train] attention blocks ({tune_mode()}): {blocks}")
        params = init_train_params(cfg, seed=args.seed, device=args.device)
        out = run(cfg, params, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                  grad_accum=args.grad_accum, seed=args.seed, device=args.device,
                  workdir=workdir, data=args.data, ckpt_every=args.ckpt_every,
                  anomaly_z=args.anomaly_z, max_rollbacks=args.max_rollbacks, trace=rec)
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
            json.dump(train_registry(out["trainer"]).snapshot(), f, indent=1)
        print(f"[train] metrics: {args.metrics_out}")
    return out


if __name__ == "__main__":
    main()
