"""Mixture-of-Experts FFN: the reference's single-device dispatch
(``repro.models.moe._moe_dense_onehot``, which the reference takes whenever
no mesh is active), computed with index operations.

Router: an f32 softmax over the experts, top-k, the k weights renormalised;
the switch-style load-balance aux loss plus ``1e-3`` times a z-loss.

Dispatch: each expert takes at most ``capacity(cfg, T)`` assignments, T
counting every token of the call.  A token's place in an expert's queue is
its first-come rank over the flattened (B·S) index, batch-major; an
assignment at or past the capacity is dropped (it contributes zero, and the
token's other weights are not renormalised).  ``moe_apply`` gathers the kept
tokens into an (E, C, D) f32 buffer, runs the stacked SwiGLU experts on it
and adds each expert's output, times its top-k weight, back onto its token.
``moe_apply_onehot`` computes the same function through the reference's
(T, E, C) one-hot dispatch and combine tensors: the plain version the tests
hold the index form against.

Every shape depends on T alone, and nothing is read back to the host, so a
decode step that holds a MoE layer can be captured as a CUDA graph.  The
experts run in f32, as in the reference (it casts the dispatched tokens to
f32 and upcasts the bf16 expert weights inside its einsums); bf16 weights
are upcast a chunk of experts at a time, so the f32 copy never exceeds
``EXPERT_CHUNK_BYTES``, and f32 weights run in one product.  The shared expert, when the config has one, is a
SwiGLU MLP over every token in x's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.models import layers

# Bound on the f32 copy of the expert weights that one chunk of experts takes.
EXPERT_CHUNK_BYTES = 2**30


def moe_init(generator, cfg, dtype=torch.float32) -> dict:
    """The reference's distributions: the router ``normal · d^-0.5`` held in
    f32 whatever ``dtype``, the experts' gate and up ``normal · d^-0.5``
    and down ``normal · f^-0.5``, stacked (E, ·, ·)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    params = {
        "router": {"w": layers._normal(generator, (d, e), d ** -0.5, torch.float32)},
        "experts": {
            "gate": layers._normal(generator, (e, d, f), d ** -0.5, dtype),
            "up": layers._normal(generator, (e, d, f), d ** -0.5, dtype),
            "down": layers._normal(generator, (e, f, d), f ** -0.5, dtype),
        },
    }
    if cfg.n_shared_experts:
        params["shared"] = layers.mlp_init(generator, d, f * cfg.n_shared_experts,
                                           act="silu", dtype=dtype)
    return params


def moe_axes(cfg) -> dict:
    axes = {
        "router": {"w": (None, None)},
        "experts": {"gate": ("experts", None, None), "up": ("experts", None, None),
                    "down": ("experts", None, None)},
    }
    if cfg.n_shared_experts:
        axes["shared"] = layers.mlp_axes(act="silu")
    return axes


def capacity(cfg, t: int) -> int:
    """Assignments an expert takes in a call of ``t`` tokens.  The floor of
    min(t, 8) keeps small decode batches drop-free."""
    return max(int(cfg.capacity_factor * t * cfg.moe_top_k / cfg.n_experts), min(t, 8))


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(…,) int → (…, n) int64 0/1.  ``F.one_hot`` on the CPU reads the ids'
    range back to check it; a comparison reads nothing."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def route(router_w: torch.Tensor, x_flat: torch.Tensor, cfg):
    """x_flat (T, D) → (weights (T, k) f32, ids (T, k) int64, aux scalar)."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    weights, ids = torch.topk(probs, cfg.moe_top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    e = cfg.n_experts
    ce = _one_hot(ids.reshape(-1), e).sum(dim=0).float()
    lse_sq = torch.logsumexp(logits, dim=-1) ** 2
    dp = sharding.active_dp()
    if dp is None:
        me, z = probs.mean(dim=0), torch.mean(lse_sq)  # me: mean router probability an expert
    else:
        # The statistics of the whole batch, which the data-parallel ranks
        # split: the aux loss is the single device's.
        n_tok = coll.all_reduce(torch.full((), float(probs.shape[0]), device=probs.device), *dp)
        me = coll.sum_dp(probs.sum(dim=0), *dp) / n_tok
        z = coll.sum_dp(lse_sq.sum(), *dp) / n_tok
        ce = coll.all_reduce(ce, *dp)
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    aux = e * torch.sum(me * ce)
    return weights, ids, aux + 1e-3 * z


def queue_ranks(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each assignment's first-come place in its expert's queue: ids (T, k)
    → ranks (T, k) int64, counting over tokens in order."""
    mask = _one_hot(ids, n_experts).sum(dim=1)  # (T, E) 0/1: top-k ids are distinct
    ranks = torch.cumsum(mask, dim=0) - 1
    return torch.gather(ranks, 1, ids)


def _expert_chunk(w: dict) -> int:
    """Experts a chunk of the f32 weight upcast holds: all of them when the
    weights are f32 already (training's master weights), since ``.float()``
    then copies nothing, and slicing them would only make the backward
    build a zero-filled gradient of the whole stack for every chunk."""
    e = next(iter(w.values())).shape[0]
    if all(t.dtype == torch.float32 for t in w.values()):
        return e
    per_expert = sum(t[0].numel() for t in w.values()) * 4
    return max(1, EXPERT_CHUNK_BYTES // per_expert)


def expert_ffn(w: dict, xe: torch.Tensor) -> torch.Tensor:
    """Batched SwiGLU over the stacked experts in f32.  xe: (E, C, D) f32 →
    (E, C, D) f32; ``w`` holds ``gate``, ``up`` (E, D, F) and ``down``
    (E, F, D), upcast a chunk of experts at a time."""
    e = xe.shape[0]
    step = _expert_chunk(w)
    outs = []
    for e0 in range(0, e, step):
        x = xe[e0:e0 + step]
        gate = torch.bmm(x, w["gate"][e0:e0 + step].float())
        up = torch.bmm(x, w["up"][e0:e0 + step].float())
        outs.append(torch.bmm(F.silu(gate) * up, w["down"][e0:e0 + step].float()))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _dispatch_index(params: dict, xf: torch.Tensor, weights, ids, cfg) -> torch.Tensor:
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = capacity(cfg, t)
    ranks = queue_ranks(ids, e)
    keep = ranks < cap
    # Dropped assignments write to an overflow row past the E·C buffer.
    slot = torch.where(keep, ids * cap + ranks, e * cap)  # (T, k)
    buf = xf.new_zeros((e * cap + 1, d), dtype=torch.float32)
    buf[slot.reshape(-1)] = xf.float().repeat_interleave(k, dim=0)
    ye = expert_ffn(params["experts"], buf[:-1].view(e, cap, d)).view(e * cap, d)
    w = torch.where(keep, weights, 0.0)
    rows = torch.clamp(slot, max=e * cap - 1)
    y = w[:, 0, None] * ye[rows[:, 0]]
    for j in range(1, k):
        y = y + w[:, j, None] * ye[rows[:, j]]
    return y


def _dispatch_onehot(params: dict, xf: torch.Tensor, weights, ids, cfg) -> torch.Tensor:
    t = xf.shape[0]
    e = cfg.n_experts
    cap = capacity(cfg, t)
    onehot = _one_hot(ids, e).float()  # (T, k, E)
    mask = onehot.amax(dim=1)  # (T, E) 0/1
    weight_e = (onehot * weights[..., None]).sum(dim=1)  # (T, E)
    pos = torch.cumsum(mask, dim=0) - 1.0  # place in the expert's queue
    keep = (pos < cap) * mask
    pos_oh = (pos.long()[..., None] == torch.arange(cap, device=xf.device)).float()
    dispatch = keep[..., None] * pos_oh  # (T, E, C)
    combine = (keep * weight_e)[..., None] * pos_oh
    xe = torch.einsum("tec,td->ecd", dispatch, xf.float())
    ye = expert_ffn(params["experts"], xe)
    return torch.einsum("tec,ecd->td", combine, ye)


def moe_routed(params: dict, x: torch.Tensor, cfg, *, onehot: bool = False):
    """(B, S, D) → (y (B, S, D) in x's dtype, aux loss scalar f32, the
    routed expert ids (B·S, k)), through the index dispatch or, with
    ``onehot``, the one-hot one."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    weights, ids, aux = route(params["router"]["w"], xf, cfg)
    dispatch = _dispatch_onehot if onehot else _dispatch_index
    y = dispatch(params, xf, weights, ids, cfg).reshape(b, s, d).to(x.dtype)
    if "shared" in params:
        y = y + layers.mlp_apply(params["shared"], x, act="silu")
    return y, aux, ids


def moe_apply(params: dict, x: torch.Tensor, cfg):
    """(B, S, D) → (y (B, S, D) in x's dtype, aux loss scalar f32)."""
    y, aux, _ = moe_routed(params, x, cfg)
    return y, aux


def moe_apply_onehot(params: dict, x: torch.Tensor, cfg):
    """``moe_apply`` through the reference's one-hot dispatch: the plain
    version, O(T·E·C) memory."""
    y, aux, _ = moe_routed(params, x, cfg, onehot=True)
    return y, aux
