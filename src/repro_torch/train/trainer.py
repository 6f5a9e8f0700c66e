"""Training loop (the step, history and logging of ``repro.train.trainer``).

Each step draws a batch, runs the train step on the params' device, and
records and logs ``{"step", "loss", "grad_norm", "lr", "sec"}``; a step
the NaN guard skipped counts in ``counters["nan_skips"]``.  Checkpoints, resume, the
anomaly rollback, fault injection and trace spans are not ported yet.
"""
from __future__ import annotations

import time
from collections import Counter

import torch

from repro_torch.models import lm
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import make_train_step


class Trainer:
    def __init__(self, cfg, opt_cfg: opt_mod.OptimizerConfig, dataset, params: dict):
        """``params`` is the model's dict on the device training runs on,
        its trainable leaves in ``cfg.param_dtype``."""
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.dataset = dataset
        self.params = params
        self.device = lm.trainable(params)[0].device
        self.opt_state = opt_mod.adamw_init(lm.trainable(params))
        self._step_fn = make_train_step(cfg, opt_cfg)
        self.counters: Counter = Counter()
        self.step = 0
        self.history: list[dict] = []

    def step_once(self) -> dict:
        batch = {k: torch.as_tensor(v, dtype=torch.int64).to(self.device)
                 for k, v in self.dataset.next_batch().items()}
        t0 = time.perf_counter()
        self.params, self.opt_state, metrics = self._step_fn(
            self.params, self.opt_state, batch, self.step)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the update's kernels too
        dt = time.perf_counter() - t0
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        if float(metrics["skipped"]) > 0:
            self.counters["nan_skips"] += 1
            print(f"[trainer] step {self.step}: non-finite loss, skipped")
        self.step += 1
        rec = {"step": self.step, "loss": loss, "grad_norm": gnorm,
               "lr": float(metrics["lr"]), "sec": dt}
        self.history.append(rec)
        print(f"[trainer] step {rec['step']:>6} loss {loss:.4f} gnorm {gnorm:.3f} "
              f"lr {rec['lr']:.2e} {dt * 1e3:.0f} ms")
        return rec

    def run(self, num_steps: int) -> list[dict]:
        for _ in range(num_steps):
            self.step_once()
        return self.history
