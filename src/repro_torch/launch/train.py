"""Training launcher: the trainer over a model with seeded random weights
and the synthetic token stream.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
      --impl pallas_distr --steps 4 --batch 4 --seq 2048

Runs on the GPU unless ``--device cpu`` is given (then use ``--reduced``:
the CPU runs the kernels' plain PyTorch versions).  Loading weights from
disk is not ported yet.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.api import IMPLS
from repro_torch.models import lm
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer
from repro_torch.utils.device import resolve_device


def init_train_params(cfg, *, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Seeded random params in ``cfg.param_dtype`` on ``device``."""
    dev = resolve_device(device)
    return lm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                          dtype=lm.param_dtype(cfg))


def run(cfg, params: dict, *, steps: int = 10, batch: int = 8, seq: int = 128,
        lr: float = 1e-3, grad_accum: int = 1, seed: int = 0,
        device: str | torch.device = "cuda") -> dict:
    """Train ``params`` (on ``device``) for ``steps`` steps on
    ``SyntheticLMData(cfg.vocab, batch, seq, seed)``, logging every step.
    Returns the history, the step times, tokens/s over the steps after the
    first (which pays for the kernel build and first-use setup), the count
    of skipped steps and, on CUDA, the peak of
    ``torch.cuda.max_memory_allocated`` in bytes (None on the CPU)."""
    dev = resolve_device(device)
    opt_cfg = OptimizerConfig(peak_lr=lr, warmup_steps=max(steps // 20, 1), total_steps=steps,
                              schedule=cfg.schedule, grad_accum=grad_accum)
    data = SyntheticLMData(cfg.vocab, batch, seq, seed=seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(cfg, opt_cfg, data, params)
    hist = trainer.run(steps)
    times = [r["sec"] for r in hist]
    warm = times[1:] or times
    return {
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if args.impl is not None:
        cfg = cfg.replace(attention=cfg.attention.with_impl(args.impl))
    params = init_train_params(cfg, seed=args.seed, device=args.device)
    out = run(cfg, params, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
              grad_accum=args.grad_accum, seed=args.seed, device=args.device)
    hist = out["history"]
    print(f"[train] loss {hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f} over {len(hist)} "
          f"steps; {out['tok_per_s']:.1f} tok/s after the first step; "
          f"{out['nan_skips']} skipped")
    if out["max_memory_allocated"] is not None:
        print(f"[train] peak memory allocated {out['max_memory_allocated'] / 2**30:.2f} GiB")
    return out


if __name__ == "__main__":
    main()
