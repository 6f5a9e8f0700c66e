"""Public wrappers around the kernels (``repro.kernels.ops``).

Handles what the kernels keep out of their grids: GQA flattening, the
DistrAttention stage 1 (LSH permutations and Q̂ sampling with the softmax
scale folded in), GQA row packing for decode (contiguous and paged), the
cross-split merge, and the head flattening of the Mamba-2 SSD.
Each op takes the kernel on CUDA tensors and the kernel's plain version on
CPU tensors (``kernels/*.py``).

``flash_attention`` and ``distr_attention`` are differentiable: when an
input requires grad, a ``torch.autograd.Function`` runs the forward kernel
with its LSE residual and a backward of kernels only (``kernels/backward.py``:
delta, then dq, then dkv, and for distr the map of dQ̂ back to dQ).  The
DistrAttention backward treats the LSH permutation as fixed
(straight-through): gradients flow through the Q̂ sampling and the K̂
fusion only, never into the projection or the hash.  Without grad the
primal path runs the forward kernel alone, with no LSE.
"""
from __future__ import annotations

import torch

from repro_torch.core.distr_attention import (
    DistrConfig, block_permutations, default_projection, pad_to_multiple, sample_q,
)
from repro_torch.core import grouping
from repro_torch.kernels import backward as bwd
from repro_torch.kernels import decode as decode_kernels
from repro_torch.kernels.decode import merge_splits
from repro_torch.kernels.distr_attention import distr_attention_kernel_call
from repro_torch.kernels.flash_attention import flash_attention_kernel_call
from repro_torch.kernels.paged_decode import paged_decode_kernel_call
from repro_torch.kernels.ssd import ssd_kernel_call

DEFAULT_DECODE_BLOCK = 128

__all__ = [
    "decode_attention", "distr_attention", "distr_dq_from_dq_hat", "distr_stage1",
    "flash_attention", "merge_splits", "paged_decode_attention", "ssd",
]


def _flatten_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.reshape(b * h, n, d).contiguous()


def _gqa_sum(dx_per_q_head: torch.Tensor, b: int, hkv: int) -> torch.Tensor:
    """(B·Hq, Nk, d) per-query-head grads → (B, Hkv, Nk, d)."""
    bhq, nk, d = dx_per_q_head.shape
    return dx_per_q_head.reshape(b, hkv, bhq // (b * hkv), nk, d).sum(dim=2)


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FlashAttention(torch.autograd.Function):
    """Exact FA-2 with a kernel backward (``ops._flash_vjp_fwd/_bwd`` of the
    reference).  The kernels mask ragged tiles themselves, so nothing is
    padded; rows past N inside a kernel tile take LSE = ``bwd.LSE_PAD``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        b, hq, n, d = q.shape
        hkv = k.shape[1]
        qf, kf, vf = _flatten_heads(q), _flatten_heads(k), _flatten_heads(v)
        o, lse = flash_attention_kernel_call(
            qf, kf, vf, q_per_kv=hq // hkv, scale=scale, causal=causal,
            kv_len=k.shape[2], return_lse=True,
        )
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.meta = (b, hq, hkv, causal, scale)
        return o.reshape(b, hq, n, d)

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, o, lse = ctx.saved_tensors
        b, hq, hkv, causal, scale = ctx.meta
        dof = _flatten_heads(do.to(qf.dtype))
        kw = dict(q_per_kv=hq // hkv, scale=scale, causal=causal, kv_len=kf.shape[1])
        delta = bwd.delta_kernel_call(o, dof)
        dq = bwd.flash_dq_kernel_call(qf, kf, vf, dof, lse, delta, **kw)
        dk_h, dv_h = bwd.flash_dkv_kernel_call(qf, kf, vf, dof, lse, delta, **kw)
        dq = dq.reshape(b, hq, *qf.shape[1:]).to(qf.dtype)
        dk = _gqa_sum(dk_h, b, hkv).to(kf.dtype)
        dv = _gqa_sum(dv_h, b, hkv).to(vf.dtype)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """Exact FA-2, differentiable.  q: (B, Hq, N, d); k, v: (B, Hkv, Nk, d)
    → (B, Hq, N, d).  The kernel masks the ragged KV tail itself, so nothing
    is padded."""
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale)
    out = flash_attention_kernel_call(
        _flatten_heads(q), _flatten_heads(k), _flatten_heads(v),
        q_per_kv=hq // hkv, scale=scale, causal=causal, kv_len=k.shape[2],
    )
    return out.reshape(b, hq, n, v.shape[-1])


def distr_stage1(cfg: DistrConfig, qp: torch.Tensor, scale: float, *,
                 proj: torch.Tensor | None = None, hkv: int | None = None):
    """The paper's lightweight pre-kernel stage (§4.8) on a block_q-padded
    q (B, Hq, N_pad, d): per-Q-block LSH permutations and Q̂ sampling with
    the softmax scale folded in.  Returns (q_hat (B, Hq, N_pad, d/G*) in
    qp's dtype, perms (B, Hq, nq, d) int64)."""
    cfg = cfg.resolved()
    b, hq, n_pad, d = qp.shape
    nq = n_pad // cfg.block_q
    if proj is None:
        proj = default_projection(cfg, qp.device)
    if cfg.shared_kv_perm and hkv is None:
        raise ValueError("shared_kv_perm needs the KV head count")
    perms = block_permutations(qp, cfg, proj, hkv if hkv is not None else hq)
    q_hat = sample_q(qp.reshape(b, hq, nq, cfg.block_q, d), perms, cfg)
    q_hat = (q_hat * scale).reshape(b, hq, n_pad, d // cfg.group_size).to(qp.dtype)
    return q_hat, perms


def distr_dq_from_dq_hat(estimator: str, dq_hat: torch.Tensor, perms: torch.Tensor, *,
                         block_q: int, group_size: int, scale: float) -> torch.Tensor:
    """dQ̂ → dQ: the transpose of the Q̂ sampling (or group mean), with the
    forward's pre-scale folded in.  dq_hat: (B, Hq, N_pad, d/G*); perms:
    (B, Hq, nq, d) → (B, Hq, N_pad, d) f32.

    Written out as a scatter through each Q block's permutation: under
    ``sample`` column ``perm[g·G*]`` receives ``dq_hat[g]·scale`` and the
    other d − d/G* columns get exactly zero; under ``mean`` every member
    ``perm[g·G* + u]`` receives ``dq_hat[g]·scale / G*``.  A permutation is a
    bijection, so no two sources meet and a plain scatter is exact."""
    b, hq, n_pad, dg = dq_hat.shape
    d = perms.shape[-1]
    nq = n_pad // block_q
    src = dq_hat.float().reshape(b, hq, nq, block_q, dg) * scale
    perms = perms.to(torch.int64)
    if estimator == "sample":
        idx = grouping.sampled_indices(perms, group_size)
    elif estimator == "mean":
        idx = perms
        src = src.repeat_interleave(group_size, dim=-1) / group_size
    else:
        raise ValueError(f"unknown estimator {estimator!r}")
    idx = idx[:, :, :, None, :].expand(b, hq, nq, block_q, idx.shape[-1])
    dq = torch.zeros((b, hq, nq, block_q, d), device=dq_hat.device, dtype=torch.float32)
    return dq.scatter_(-1, idx, src).reshape(b, hq, n_pad, d)


def _distr_fwd(q, k, v, cfg: DistrConfig, causal: bool, scale: float, proj,
               return_lse: bool):
    """Stage 1 on the block_q-padded Q, then the kernel → (out (B, Hq,
    N_pad, d), lse (B·Hq, N_pad) or None, q_hat (B·Hq, N_pad, d/G*), perms
    (B, Hq, nq, d))."""
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    qp = pad_to_multiple(q, cfg.block_q, dim=2)
    n_pad = qp.shape[2]
    q_hat, perms = distr_stage1(cfg, qp, scale, proj=proj, hkv=hkv)
    q_hat = _flatten_heads(q_hat)
    res = distr_attention_kernel_call(
        q_hat, _flatten_heads(k), _flatten_heads(v),
        perms.reshape(b * hq, n_pad // cfg.block_q, d),
        q_per_kv=hq // hkv, causal=causal, group_size=cfg.group_size,
        block_q=cfg.block_q, kv_len=k.shape[2], return_lse=return_lse,
    )
    out, lse = res if return_lse else (res, None)
    return out.reshape(b, hq, n_pad, v.shape[-1]), lse, q_hat, perms


class _DistrAttention(torch.autograd.Function):
    """DistrAttention with a kernel backward (``ops._distr_vjp_fwd/_bwd`` of
    the reference).  Stage 1 runs inside ``forward``, where autograd is off:
    the permutations and the projection get no gradient (straight-through).
    The zero rows that pad Q to block_q have dO = 0 and D = 0, so their dS
    is 0 and they add nothing to dK / dV."""

    @staticmethod
    def forward(ctx, q, k, v, cfg: DistrConfig, causal: bool, scale: float, proj):
        out, lse, q_hat, perms = _distr_fwd(q, k, v, cfg, causal, scale, proj, True)
        ctx.save_for_backward(q_hat, k, v, perms, out, lse)
        ctx.meta = (cfg, causal, scale, q.shape[2], q.dtype)
        return out[:, :, :q.shape[2]]

    @staticmethod
    def backward(ctx, do):
        qf, k, v, perms, out, lse = ctx.saved_tensors
        cfg, causal, scale, n, q_dtype = ctx.meta
        b, hq, nq, d = perms.shape
        hkv = k.shape[1]
        n_pad = out.shape[2]
        kf, vf = _flatten_heads(k), _flatten_heads(v)
        o = _flatten_heads(out)
        dof = _flatten_heads(pad_to_multiple(do.to(qf.dtype), cfg.block_q, dim=2))
        perm_f = perms.reshape(b * hq, nq, d)
        kw = dict(q_per_kv=hq // hkv, causal=causal, group_size=cfg.group_size,
                  block_q=cfg.block_q, kv_len=kf.shape[1])
        delta = bwd.delta_kernel_call(o, dof)
        dq_hat = bwd.distr_dq_kernel_call(qf, kf, vf, perm_f, dof, lse, delta, **kw)
        dk_h, dv_h = bwd.distr_dkv_kernel_call(qf, kf, vf, perm_f, dof, lse, delta, **kw)
        dq = distr_dq_from_dq_hat(
            cfg.estimator, dq_hat.reshape(b, hq, n_pad, -1), perms,
            block_q=cfg.block_q, group_size=cfg.group_size, scale=scale,
        )
        dq = dq[:, :, :n].to(q_dtype)
        dk = _gqa_sum(dk_h, b, hkv).to(kf.dtype)
        dv = _gqa_sum(dv_h, b, hkv).to(vf.dtype)
        return dq, dk, dv, None, None, None, None


def distr_attention(q, k, v, cfg: DistrConfig = DistrConfig(), *,
                    causal: bool = False, scale: float | None = None,
                    proj: torch.Tensor | None = None) -> torch.Tensor:
    """DistrAttention: stage 1 in PyTorch, stage 2 in the kernel;
    differentiable under straight-through permutations.
    q: (B, Hq, N, d); k, v: (B, Hkv, Nk, d) → (B, Hq, N, d).  Q is zero-padded
    to block_q (the pad rows enter the last block's hash, as in the
    reference); K/V are not padded."""
    cfg = cfg.resolved()
    scale = float(scale) if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if _wants_grad(q, k, v):
        return _DistrAttention.apply(q, k, v, cfg, causal, scale, proj)
    out = _distr_fwd(q, k, v, cfg, causal, scale, proj, False)[0]
    return out[:, :, :q.shape[2]]


def _pack_gqa_rows(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Hq, q_len, d) → (B, Hkv, (Hq/Hkv)·q_len, d): the query heads of a
    KV head (× q_len) packed into the kernel's rows."""
    b, hq, q_len, d = q.shape
    return q.reshape(b, hkv, (hq // hkv) * q_len, d).contiguous()


def decode_attention(q, k, v, *, lengths: torch.Tensor | None = None,
                     k_fused: torch.Tensor | None = None,
                     perm: torch.Tensor | None = None, group_size: int = 1,
                     scale: float | None = None,
                     block_k: int | None = None) -> torch.Tensor:
    """Split-K flash-decoding over a KV cache.

    q: (B, Hq, q_len, d); k, v: (B, Hkv, S, d); ``lengths`` (B,) live token
    counts (None ⇒ all S live; clamped to S).  The fused-K̂ variant takes
    ``k_fused`` (B, Hkv, S, d/G*), the static ``perm`` (Hkv, d) and
    ``group_size``; ``k`` may then be None.  ``scale`` refers to the full
    head dim.  Returns (B, Hq, q_len, d) in q's dtype.
    """
    b, hq, q_len, _ = q.shape
    d = v.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    if k_fused is not None:
        if perm is None or group_size <= 1:
            raise ValueError("k_fused needs perm and group_size > 1")
        k_score = k_fused
        q_score = grouping.sample_q_heads(q, perm, group_size)
    else:
        k_score, q_score = k, q
    hkv, s_len = k_score.shape[1], k_score.shape[2]
    block_k = min(block_k or DEFAULT_DECODE_BLOCK, s_len)
    if lengths is None:
        lengths = torch.full((b,), s_len, dtype=torch.int32, device=q.device)
    lengths = torch.clamp(lengths.to(torch.int32), max=s_len)
    # The kernel reads one dtype: a cache narrower than q is upcast (exact),
    # as the reference kernel upcasts every operand to f32.
    o, m, l = decode_kernels.decode_kernel_call(
        _pack_gqa_rows(q_score, hkv), k_score.to(q.dtype).contiguous(),
        v.to(q.dtype).contiguous(), lengths,
        scale=scale, block_k=block_k, q_len=q_len,
    )
    out = merge_splits(o, m, l)  # (B, Hkv, rows, d) f32
    return out.reshape(b, hq, q_len, d).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, *, block_tables: torch.Tensor,
                           lengths: torch.Tensor | None,
                           k_fused_pool: torch.Tensor | None = None,
                           perm: torch.Tensor | None = None, group_size: int = 1,
                           scale: float | None = None) -> torch.Tensor:
    """Block-table split-K flash-decoding over a paged KV pool.

    q: (B, Hq, q_len, d), q_len 1 (a decode tick) or a chunked-prefill
    window, banded: query token i sees positions < length − (q_len − 1 − i);
    k_pool, v_pool: (P, Hkv, bs, d); ``block_tables`` (B, max_blocks)
    physical block ids; ``lengths`` (B,) live token counts (None ⇒ the whole
    table).  The fused-K̂ variant takes ``k_fused_pool`` (P, Hkv, bs, d/G*),
    the layer's static ``perm`` (Hkv, d) and ``group_size``; ``k_pool`` may
    then be None.  ``scale`` refers to the full head dim.  The kernel reads
    one dtype: q is cast to the pool's (the pool is never copied).  Returns
    (B, Hq, q_len, d) in q's dtype.
    """
    b, hq, q_len, _ = q.shape
    d = v_pool.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    if lengths is None:
        capacity = block_tables.shape[1] * v_pool.shape[2]
        lengths = torch.full((b,), capacity, dtype=torch.int32, device=q.device)
    # Deliberately NOT clamped to capacity: a padded chunk window may
    # overhang it (lengths = pos + w with the last rows dead), and clamping
    # would shift the live rows' band col < length − (q_len − 1 − i) down,
    # dropping their most recent context.  The kernel bounds every read by
    # the block's live-key count, so an overhanging length is safe.
    if k_fused_pool is not None:
        if perm is None or group_size <= 1:
            raise ValueError("k_fused_pool needs perm and group_size > 1")
        k_score = k_fused_pool
        q_score = grouping.sample_q_heads(q, perm, group_size)
    else:
        k_score, q_score = k_pool, q
    hkv = k_score.shape[1]
    o, m, l = paged_decode_kernel_call(
        _pack_gqa_rows(q_score, hkv).to(k_score.dtype), k_score, v_pool,
        block_tables, lengths, scale=scale, q_len=q_len,
    )
    out = merge_splits(o, m, l)  # (B, Hkv, rows, d) f32
    return out.reshape(b, hq, q_len, d).to(q.dtype)


def ssd(x, a, b, c, *, chunk: int = 64, return_state: bool = False):
    """Mamba-2 SSD.  x: (B, N, H, P); a: (B, N, H) log-decays; b, c: (B, N,
    G, S) → y (B, N, H, P) in x's dtype, and with ``return_state`` also the
    state at position N, (B, H, S, P) f32 (``ssd_xla(return_state=True)``).

    Flattens to (B·H, N, P) / (B·G, N, S) for the kernel, as the reference's
    ``_ssd_jit`` does.  The kernel masks a ragged tail itself and has no
    backward: a CUDA input that wants a gradient raises."""
    if _wants_grad(x, a, b, c) and x.device.type != "cpu":
        raise NotImplementedError("the SSD kernel has no backward")
    bsz, n, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    res = ssd_kernel_call(
        x.transpose(1, 2).reshape(bsz * h, n, p).contiguous(),
        a.transpose(1, 2).reshape(bsz * h, n).contiguous(),
        b.transpose(1, 2).reshape(bsz * g, n, s).contiguous(),
        c.transpose(1, 2).reshape(bsz * g, n, s).contiguous(),
        heads_per_group=h // g, chunk=chunk, return_state=return_state,
    )
    y, state = res if return_state else (res, None)
    y = y.reshape(bsz, h, n, p).transpose(1, 2)
    return (y, state.reshape(bsz, h, s, p)) if return_state else y
