"""AdamW with LR schedules (constant, cosine, WSD), as ``repro.train.optimizer``.

Parameters, gradients and both moments are flat lists of tensors in
``lm.trainable`` order; the moments are f32.  ``clip_by_global_norm`` and
``adamw_update`` work in place, so training holds one copy of the params,
one of the grads and one of each moment on the card (16 bytes a parameter).
Both walk a tensor larger than ``CHUNK_ELEMS`` in flat pieces, so their f32
temporaries never exceed a piece: a 202048 × 5120 embedding would
otherwise take several 4 GiB temporaries beside its state.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

# Elements of one piece of the optimizer's elementwise work (256 MiB in f32).
CHUNK_ELEMS = 2**26


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | wsd | constant
    wsd_decay_frac: float = 0.1  # WSD: final fraction of steps spent decaying
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_accum: int = 1  # microbatch accumulation steps


def schedule(opt_cfg: OptimizerConfig, step: int) -> float:
    """Learning rate at ``step``: linear warmup, then the configured decay."""
    warm = opt_cfg.warmup_steps
    total = opt_cfg.total_steps
    peak = opt_cfg.peak_lr
    floor = peak * opt_cfg.min_lr_ratio
    if step < warm:
        return peak * step / max(warm, 1)
    if opt_cfg.schedule == "constant":
        return peak
    if opt_cfg.schedule == "cosine":
        frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
        return floor + 0.5 * (peak - floor) * (1 + math.cos(math.pi * frac))
    if opt_cfg.schedule == "wsd":
        # Warmup-Stable-Decay (minicpm): hold at peak, then decay linearly
        # over the final wsd_decay_frac of training.
        decay_steps = max(total * opt_cfg.wsd_decay_frac, 1)
        frac = min(max((step - (total - decay_steps)) / decay_steps, 0.0), 1.0)
        return peak - (peak - floor) * frac
    raise ValueError(f"unknown schedule {opt_cfg.schedule!r}")


def adamw_init(params: list[torch.Tensor]) -> dict:
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    return {"m": zeros, "v": [torch.zeros_like(z) for z in zeros], "count": 0}


def _pieces(*tensors: torch.Tensor):
    """Matching flat views of at most ``CHUNK_ELEMS`` elements of
    same-shaped contiguous tensors (in-place work on a view lands in its
    tensor); a small or non-contiguous tensor comes whole."""
    n = tensors[0].numel()
    if n <= CHUNK_ELEMS or not all(t.is_contiguous() for t in tensors):
        yield tensors
        return
    flat = [t.view(-1) for t in tensors]
    for s in range(0, n, CHUNK_ELEMS):
        yield tuple(f[s:s + CHUNK_ELEMS] for f in flat)


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float, *, total_sq=None):
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm`` → (grads, their global f32 norm before clipping).
    ``total_sq`` maps the list of each gradient's sum of squares to the
    global sum (default: their sum; on a mesh, over unique shards)."""
    sq = [sum(piece.float().square().sum() for (piece,) in _pieces(g)) for g in grads]
    gnorm = torch.sqrt(total_sq(sq) if total_sq is not None else sum(sq))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return grads, gnorm


@torch.no_grad()
def adamw_update(params: list[torch.Tensor], grads: list[torch.Tensor], state: dict,
                 opt_cfg: OptimizerConfig, lr: float):
    """One AdamW step, in place on ``params`` and ``state`` →
    (params, state).  Decoupled weight decay on every float leaf."""
    count = state["count"] + 1
    b1, b2 = opt_cfg.b1, opt_cfg.b2
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    for tensors in zip(params, grads, state["m"], state["v"]):
        for p, g, m, v in _pieces(*tensors):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            step = (m / c1) / (torch.sqrt(v / c2) + opt_cfg.eps)
            if opt_cfg.weight_decay:
                step.add_(p.float(), alpha=opt_cfg.weight_decay)
            p.copy_(p.float() - lr * step)
    state["count"] = count
    return params, state
