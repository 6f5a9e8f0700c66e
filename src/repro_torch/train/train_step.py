"""The train step: loss → grads → clip → AdamW, with optional microbatch
gradient accumulation and the NaN guard (``repro.train.train_step``)."""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.train import optimizer as opt_mod


def make_train_step(cfg, opt_cfg: opt_mod.OptimizerConfig):
    """→ train_step(params, opt_state, batch, step) → (params, opt_state,
    metrics).  ``params`` is the model's dict (its ``lm.trainable`` leaves
    are updated in place), ``opt_state`` comes from
    ``adamw_init(lm.trainable(params))``, ``batch`` holds int ``tokens`` and
    ``labels`` tensors on the params' device, ``step`` is the int step the
    LR schedule reads.  Metrics are 0-dim tensors (``lr`` a float)."""

    def train_step(params: dict, opt_state: dict, batch: dict, step: int):
        leaves = lm.trainable(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        if opt_cfg.grad_accum > 1:
            # Split the leading batch dim into microbatches; backward() sums
            # their grads into .grad.
            micro = {k: v.chunk(opt_cfg.grad_accum) for k, v in batch.items()}
            loss = torch.zeros((), device=leaves[0].device)
            for i in range(opt_cfg.grad_accum):
                mb_loss, _ = lm.loss_fn(params, cfg, {k: v[i] for k, v in micro.items()})
                mb_loss.backward()
                loss = loss + mb_loss.detach()
            loss = loss / opt_cfg.grad_accum
            metrics = {}
            for p in leaves:
                p.grad.div_(opt_cfg.grad_accum)
        else:
            loss, metrics = lm.loss_fn(params, cfg, batch)
            loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        grads = [p.grad for p in leaves]
        grads, gnorm = opt_mod.clip_by_global_norm(grads, opt_cfg.grad_clip)
        lr = opt_mod.schedule(opt_cfg, step)
        # NaN guard: a non-finite loss or grad norm skips the update.  The
        # reference computes the update and selects where(ok, new, old)
        # inside jit; skipping it gives the same params and state without a
        # second copy of the params on the card.
        ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        if ok:
            opt_mod.adamw_update(leaves, grads, opt_state, opt_cfg, lr)
        for p in leaves:
            p.grad = None
        out = {"loss": loss.float(), "grad_norm": gnorm, "lr": lr,
               "skipped": torch.tensor(0.0 if ok else 1.0), **metrics}
        return params, opt_state, out

    return train_step


def make_eval_step(cfg):
    @torch.no_grad()
    def eval_step(params: dict, batch: dict) -> dict:
        loss, metrics = lm.loss_fn(params, cfg, batch)
        return {"loss": loss, **metrics}

    return eval_step
