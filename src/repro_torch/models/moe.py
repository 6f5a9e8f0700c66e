"""Mixture-of-Experts FFN: the reference's single-device dispatch
(``repro.models.moe._moe_dense_onehot``, which the reference takes whenever
no mesh is active), computed with index operations, and its two
expert-parallel dispatches over a "model" axis (``_moe_ep_a2a``,
``_moe_ep_psum``), which ``moe_apply`` chooses as the reference does.

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
SwiGLU MLP over every token in x's dtype, tensor parallel over "model"
when its weights hold a slice of its width, as the dense MLP is.

Expert parallelism (an active mesh, ``launch.mesh.set_mesh``, that has a
"model" axis; ``cfg.moe_impl`` "auto" or naming the impl).  Each rank holds
E / ep experts (the ``"experts": "model"`` rule; full expert weights are
sliced here) and the replicated activation x of its data-parallel rows:

* ``ep_a2a`` (training and prefill) takes this rank's slice of the
  sequence, routes it, caps each destination shard at
  ``max(int(cf · t · k / ep), 8)`` assignments of the local t (grouped by
  destination in stable argsort order; the overflow goes nowhere), sends
  them with one all-to-all of tokens and one of local expert ids, batches
  them by local expert at ``cap2 = max(int(cf · ep · cap / (E / ep)), 8)``
  (the same drop rule), runs the experts, sends the outputs back with a
  third all-to-all, combines them with a weighted scatter-add and gathers
  the sequence back, replicated.  What drops is ``ep_a2a``'s own pattern,
  not the single device's.
* ``ep_psum`` (decode) runs every token through this rank's experts, each
  weighted by its routing weight where it routed there, and sums over
  "model".

In both the aux loss is each shard's own (its tokens' statistics), meaned
over "model" and then every data-parallel axis: the reference's, which
differs from the single device's whole-batch loss.  Gradients follow the
collectives' convention (a replicated value carries the same cotangent on
every rank): the router weight and, in ``ep_psum``, x enter through
``tp_enter``; the all-to-all is its own transpose; the sequence slice and
gather are each other's.  The sequence must divide by the "model" size.
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


def route(router_w: torch.Tensor, x_flat: torch.Tensor, cfg, *, local: bool = False):
    """x_flat (T, D) → (weights (T, k) f32, ids (T, k) int64, aux scalar).
    Under data parallelism the aux loss takes the whole batch's statistics
    unless ``local`` (expert parallelism's shard-local loss)."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    weights, ids = torch.topk(probs, cfg.moe_top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    e = cfg.n_experts
    ce = _one_hot(ids.reshape(-1), e).sum(dim=0).float()
    lse_sq = torch.logsumexp(logits, dim=-1) ** 2
    dp = None if local else sharding.active_dp()
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
        y = y + _shared(params["shared"], x, cfg)
    return y, aux, ids


def _shared(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The shared expert: a SwiGLU MLP, tensor parallel when its weights hold
    a slice of its width."""
    return layers.mlp_apply(params, x, act="silu", d_ff=cfg.d_ff_expert * cfg.n_shared_experts)


# ---------------------------------------------------------------------------
# Expert parallelism over "model"
# ---------------------------------------------------------------------------


def _model_mesh():
    """The active mesh when it has a "model" axis (of any size, as the
    reference's ``_active_mesh``), else None."""
    from repro_torch.launch.mesh import active_mesh

    mesh = active_mesh()
    return mesh if mesh is not None and "model" in mesh.axis_names else None


def _local_experts(params: dict, cfg, mesh) -> tuple[dict, int]:
    """This rank's expert weights (sliced from full ones) and the global id
    of its first expert."""
    ep = coll.axis_size(mesh, "model")
    if cfg.n_experts % ep:
        raise ValueError(f"{cfg.n_experts} experts do not split over a 'model' axis of {ep}")
    e_loc = cfg.n_experts // ep
    lo = coll.axes_index(mesh, "model")[0] * e_loc
    w = params["experts"]
    held = w["gate"].shape[0]
    if held == cfg.n_experts:
        w = {k: t.narrow(0, lo, e_loc) for k, t in w.items()}
    elif held != e_loc:
        raise ValueError(f"expert weights of {held} experts are neither all {cfg.n_experts} "
                         f"nor this rank's {e_loc}")
    return w, lo


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """bincount of ``ids`` over ``n`` bins, read nothing back to the host."""
    return _one_hot(ids, n).sum(dim=0)


def _ep_aux(aux: torch.Tensor, mesh) -> torch.Tensor:
    """The shards' aux losses meaned over "model" (replicated there: each
    shard's share of the cotangent is 1/ep of it), then over every
    data-parallel axis (the ranks' losses sum, so the cotangents do too)."""
    aux = coll.tp_reduce(aux, mesh) / coll.axis_size(mesh, "model")
    dp = tuple(a for a in mesh.axis_names if a != "model")
    n = 1
    for a in dp:
        n *= coll.axis_size(mesh, a)
    return coll.sum_dp(aux, mesh, dp) / n if n > 1 else aux


def _moe_ep_a2a(params: dict, x: torch.Tensor, cfg, mesh):
    """Expert parallelism by all-to-all (see the module docstring) → (y (B,
    S, D) replicated over "model", in x's dtype, without the shared expert;
    aux)."""
    ep = coll.axis_size(mesh, "model")
    w, _ = _local_experts(params, cfg, mesh)
    b, s, d = x.shape
    xl = coll.take_slice(x, mesh, "model", 1)  # (b, s / ep, d): this rank's tokens
    t = xl.shape[0] * xl.shape[1]
    xf = xl.reshape(t, d)
    weights, ids, aux = route(coll.tp_enter(params["router"]["w"], mesh), xf, cfg, local=True)
    k = cfg.moe_top_k
    e_loc = cfg.n_experts // ep
    cap = max(int(cfg.capacity_factor * t * k / ep), 8)
    dev = x.device

    # Group the routed assignments by destination shard, first come first.
    flat_ids = ids.reshape(-1)
    dest = flat_ids // e_loc
    order = torch.argsort(dest, stable=True)
    dsorted = dest[order]
    counts = _counts(dest, ep)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - starts[dsorted]
    keep = pos < cap
    slot = torch.where(keep, dsorted * cap + pos, ep * cap)  # ep · cap: the overflow bin
    src_tok = order // k
    send_x = xf.new_zeros((ep * cap + 1, d)).index_put((slot,), xf[src_tok])[:-1]
    send_e = torch.full((ep * cap + 1,), e_loc, dtype=torch.int64, device=dev).index_put(
        (slot,), flat_ids[order] % e_loc)[:-1]

    # Chunk j of this shard goes to shard j.
    recv_x = coll.exchange(send_x, mesh, "model")
    recv_e = coll.all_to_all(send_e, mesh, "model")

    # Batch by local expert, first come first, at the local capacity.
    t_r = ep * cap
    cap2 = max(int(cfg.capacity_factor * t_r / e_loc), 8)
    order2 = torch.argsort(recv_e, stable=True)
    esort = recv_e[order2]
    counts2 = _counts(recv_e, e_loc + 1)
    starts2 = torch.cumsum(counts2, 0) - counts2
    pos2 = torch.arange(t_r, device=dev) - starts2[torch.clamp(esort, max=e_loc)]
    valid2 = (esort < e_loc) & (pos2 < cap2)
    slot2 = torch.where(valid2, esort * cap2 + pos2, e_loc * cap2)
    xe = xf.new_zeros((e_loc * cap2 + 1, d), dtype=torch.float32).index_put(
        (slot2,), recv_x[order2].float())[:-1]
    ye = expert_ffn(w, xe.view(e_loc, cap2, d)).view(e_loc * cap2, d)

    # Undo the local sort, send the outputs back, combine onto the tokens.
    y_sorted = torch.where(valid2[:, None], ye[torch.clamp(slot2, max=e_loc * cap2 - 1)], 0.0)
    y_recv = ye.new_zeros((t_r, d)).index_put((order2,), y_sorted)
    y_send = coll.exchange(y_recv, mesh, "model")
    contrib = torch.where(keep[:, None],
                          y_send[torch.clamp(slot, max=t_r - 1)] * weights.reshape(-1)[order][:, None],
                          0.0)
    y_tok = ye.new_zeros((t, d)).index_add(0, src_tok, contrib)
    y = coll.gather_slices(y_tok.view(xl.shape).to(x.dtype), mesh, "model", 1)
    return y, _ep_aux(aux, mesh)


def _moe_ep_psum(params: dict, x: torch.Tensor, cfg, mesh):
    """Expert parallelism by a sum over "model" (see the module docstring)
    → (y (B, S, D) in x's dtype, without the shared expert; aux)."""
    ep = coll.axis_size(mesh, "model")
    w, lo = _local_experts(params, cfg, mesh)
    e_loc = cfg.n_experts // ep
    b, s, d = x.shape
    xf = coll.tp_enter(x, mesh).reshape(b * s, d)
    weights, ids, aux = route(coll.tp_enter(params["router"]["w"], mesh), xf, cfg, local=True)
    rel = ids - lo
    in_range = (rel >= 0) & (rel < e_loc)
    local_w = (_one_hot(torch.where(in_range, rel, 0), e_loc).float()
               * torch.where(in_range, weights, 0.0)[..., None]).sum(dim=1)  # (T, e_loc)
    ye = expert_ffn(w, xf.float().expand(e_loc, b * s, d))
    y = coll.tp_reduce(torch.einsum("te,etd->td", local_w, ye), mesh)
    return y.view(b, s, d).to(x.dtype), _ep_aux(aux, mesh)


EP_IMPLS = {"ep_a2a": _moe_ep_a2a, "ep_psum": _moe_ep_psum}


def moe_apply(params: dict, x: torch.Tensor, cfg, *, decode: bool = False):
    """(B, S, D) → (y (B, S, D) in x's dtype, aux loss scalar f32).  The
    single-device dispatch with no active mesh that has "model" or under
    ``moe_impl="dense_onehot"``; otherwise ``ep_psum`` when ``decode`` and
    ``ep_a2a`` when not, unless ``cfg.moe_impl`` names one."""
    mesh = _model_mesh()
    impl = cfg.moe_impl
    if impl == "auto":
        impl = "dense_onehot" if mesh is None else "ep_psum" if decode else "ep_a2a"
    if impl == "dense_onehot" or mesh is None:
        y, aux, _ = moe_routed(params, x, cfg)
        return y, aux
    if impl not in EP_IMPLS:
        raise ValueError(f"unknown moe_impl {impl!r}")
    y, aux = EP_IMPLS[impl](params, x, cfg, mesh)
    if "shared" in params:
        y = y + _shared(params["shared"], x, cfg)
    return y, aux


def moe_apply_onehot(params: dict, x: torch.Tensor, cfg):
    """``moe_apply`` through the reference's one-hot dispatch: the plain
    version, O(T·E·C) memory."""
    y, aux, _ = moe_routed(params, x, cfg, onehot=True)
    return y, aux
