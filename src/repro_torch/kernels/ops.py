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

Tiles: the kernels take theirs at run time (``tune.autotune.compiled_tiles``).
``flash_attention``'s ``block_q`` / ``block_k`` and ``DistrConfig.block_k``
follow the reference's rule: explicit ints win, a partial pin takes the
static tile for the free one, and both None resolve through the tuner
(``REPRO_TUNE``).  The backward's tiles resolve when the backward first
runs, and are swept only under ``measure`` (``_resolve_bwd_blocks``,
``resolve_distr_bwd_blocks``), so a serving process never pays a backward
sweep.
"""
from __future__ import annotations

import torch

from repro_torch.core.distr_attention import (
    DEFAULT_BLOCK, DistrConfig, block_permutations, default_projection, pad_to_multiple,
    resolve_at, sample_q,
)
from repro_torch.core import grouping, lsh
from repro_torch.kernels import backward as bwd
from repro_torch.kernels import decode as decode_kernels
from repro_torch.kernels.decode import merge_splits
from repro_torch.kernels.distr_attention import distr_attention_kernel_call
from repro_torch.kernels.flash_attention import flash_attention_kernel_call
from repro_torch.kernels.paged_decode import paged_decode_kernel_call
from repro_torch.kernels.ssd import ssd_kernel_call
from repro_torch.tune.block_sizes import BlockSizes
from repro_torch.tune.cache import dtype_str

DEFAULT_DECODE_BLOCK = DEFAULT_BLOCK  # the split REPRO_TUNE=off resolves to

__all__ = [
    "attention_cost", "decode_attention", "distr_attention", "distr_dq_from_dq_hat",
    "distr_stage1", "flash_attention", "merge_splits", "paged_decode_attention", "ssd",
    "ssd_cost",
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


def _resolve_flash_blocks(q, k, causal: bool, block_q, block_k) -> BlockSizes:
    """Explicit ints win (a partial pin takes the static tile for the free
    one, never a value tuned for another pair); both None resolve the
    forward pair through the tuner.  The backward tiles stay unset here:
    ``_resolve_bwd_blocks`` fills them when the backward runs."""
    from repro_torch.tune.autotune import resolve_block_sizes, static_tile

    if block_q is not None or block_k is not None:
        static = static_tile("flash_fwd", d=q.shape[-1], dtype=dtype_str(q))
        return BlockSizes.from_pair(block_q or static[0], block_k or static[1])
    return resolve_block_sizes("flash", d=q.shape[-1], n=max(q.shape[2], k.shape[2]),
                               dtype=dtype_str(q), causal=causal, device=q.device)


def _resolve_bwd_blocks(blocks: BlockSizes, q, k, causal: bool) -> BlockSizes:
    """The backward's dq and dkv tiles, filled when the backward first runs
    and only under ``REPRO_TUNE=measure`` (a sweep each, at the call's
    shape): forward-only dispatch (serving) never pays a backward sweep.
    Tiles already set, and the other modes, pass through (``bwd_tiles``
    then runs the static tiles).  q, k: (B·H, N, d)."""
    if blocks.block_q_dq is not None or blocks.block_q_dkv is not None:
        return blocks
    from repro_torch.tune.autotune import get_autotuner, tune_mode

    if tune_mode() != "measure":
        return blocks
    kw = dict(d=q.shape[-1], n=max(q.shape[1], k.shape[1]), dtype=dtype_str(q),
              causal=causal, device=q.device)
    tuner = get_autotuner()
    dq = tuner.resolve_pair("flash_dq", **kw)
    dkv = tuner.resolve_pair("flash_dkv", **kw)
    return blocks.with_(block_q_dq=dq[0], block_k_dq=dq[1], block_q_dkv=dkv[0],
                        block_k_dkv=dkv[1])


def bwd_tiles(blocks: BlockSizes, d: int, dtype: str):
    """The flash backward's (dq tile, dkv tile): the ones ``blocks`` sets,
    else each kernel's static tile (the port's dq and dkv tile spaces are
    not the forward's, so the forward pair does not carry over)."""
    from repro_torch.tune.autotune import static_tile

    dq = ((blocks.block_q_dq, blocks.block_k_dq) if blocks.block_q_dq is not None
          else static_tile("flash_dq", d=d, dtype=dtype))
    dkv = ((blocks.block_q_dkv, blocks.block_k_dkv) if blocks.block_q_dkv is not None
           else static_tile("flash_dkv", d=d, dtype=dtype))
    return dq, dkv


class _FlashAttention(torch.autograd.Function):
    """Exact FA-2 with a kernel backward (``ops._flash_vjp_fwd/_bwd`` of the
    reference).  The kernels mask ragged tiles themselves, so nothing is
    padded; rows past N inside a kernel tile take LSE = ``bwd.LSE_PAD``.
    ``blocks`` is the resolved forward tile; the backward's resolve when it
    runs (``_resolve_bwd_blocks``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, blocks: BlockSizes):
        b, hq, n, d = q.shape
        hkv = k.shape[1]
        qf, kf, vf = _flatten_heads(q), _flatten_heads(k), _flatten_heads(v)
        o, lse = flash_attention_kernel_call(
            qf, kf, vf, q_per_kv=hq // hkv, scale=scale, causal=causal,
            kv_len=k.shape[2], return_lse=True, block_q=blocks.block_q, block_k=blocks.block_k,
        )
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.meta = (b, hq, hkv, causal, scale, blocks)
        return o.reshape(b, hq, n, d)

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, o, lse = ctx.saved_tensors
        b, hq, hkv, causal, scale, blocks = ctx.meta
        blocks = _resolve_bwd_blocks(blocks, qf, kf, causal)
        (bq_dq, bk_dq), (bq_dkv, bk_dkv) = bwd_tiles(blocks, qf.shape[-1], dtype_str(qf))
        dof = _flatten_heads(do.to(qf.dtype))
        kw = dict(q_per_kv=hq // hkv, scale=scale, causal=causal, kv_len=kf.shape[1])
        delta = bwd.delta_kernel_call(o, dof)
        dq = bwd.flash_dq_kernel_call(qf, kf, vf, dof, lse, delta, block_q=bq_dq,
                                      block_k=bk_dq, **kw)
        dk_h, dv_h = bwd.flash_dkv_kernel_call(qf, kf, vf, dof, lse, delta, block_q=bq_dkv,
                                               block_k=bk_dkv, **kw)
        dq = dq.reshape(b, hq, *qf.shape[1:]).to(qf.dtype)
        dk = _gqa_sum(dk_h, b, hkv).to(kf.dtype)
        dv = _gqa_sum(dv_h, b, hkv).to(vf.dtype)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, scale: float | None = None,
                    block_q: int | None = None, block_k: int | None = None,
                    blocks: BlockSizes | None = None) -> torch.Tensor:
    """Exact FA-2, differentiable.  q: (B, Hq, N, d); k, v: (B, Hkv, Nk, d)
    → (B, Hq, N, d).  The kernel masks the ragged KV tail itself, so nothing
    is padded.  The tile: ``blocks`` (a whole ``BlockSizes``, the backward's
    tiles too), or ``block_q`` / ``block_k`` (``_resolve_flash_blocks``);
    None resolves through the tuner (``REPRO_TUNE``)."""
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    if blocks is None:
        blocks = _resolve_flash_blocks(q, k, causal, block_q, block_k)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale, blocks)
    out = flash_attention_kernel_call(
        _flatten_heads(q), _flatten_heads(k), _flatten_heads(v),
        q_per_kv=hq // hkv, scale=scale, causal=causal, kv_len=k.shape[2],
        block_q=blocks.block_q, block_k=blocks.block_k,
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
        block_q=cfg.block_q, kv_len=k.shape[2], return_lse=return_lse, block_k=cfg.block_k,
    )
    out, lse = res if return_lse else (res, None)
    return out.reshape(b, hq, n_pad, v.shape[-1]), lse, q_hat, perms


def resolve_distr_bwd_blocks(cfg: DistrConfig, *, d: int, n: int, dtype: str, causal: bool,
                             device="cuda") -> tuple[int, int]:
    """The DistrAttention backward kernels' key tiles ``(keys_dq,
    keys_dkv)`` (the reference's, mirroring ``_resolve_bwd_blocks``).
    ``block_q`` never resolves here: it is the LSH grouping granularity the
    forward's permutations were drawn at, and stays pinned
    (``Autotuner.resolve_distr_bwd`` asserts it).  An explicit
    ``cfg.block_k_bwd`` wins; else the tuner: outside ``measure`` the
    forward's ``block_k`` where the kernel compiles it, under it a sweep of
    each kernel's own.  The one resolver of the single-device backward
    (when it runs) and the ring's (at dispatch, ``n`` the shard one rank
    streams)."""
    if cfg.block_k_bwd is not None:
        return cfg.block_k_bwd, cfg.block_k_bwd
    from repro_torch.tune.autotune import get_autotuner

    tuner = get_autotuner()
    kw = dict(block_q=cfg.block_q, d=d, n=n, dtype=dtype, group_size=cfg.group_size,
              causal=causal, device=device, fwd_block_k=cfg.block_k)
    return (tuner.resolve_distr_bwd("distr_dq", **kw)[1],
            tuner.resolve_distr_bwd("distr_dkv", **kw)[1])


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
        bk_dq, bk_dkv = resolve_distr_bwd_blocks(
            cfg, d=d, n=max(n, kf.shape[1]), dtype=dtype_str(kf), causal=causal,
            device=kf.device)
        kw = dict(q_per_kv=hq // hkv, causal=causal, group_size=cfg.group_size,
                  block_q=cfg.block_q, kv_len=kf.shape[1])
        delta = bwd.delta_kernel_call(o, dof)
        dq_hat = bwd.distr_dq_kernel_call(qf, kf, vf, perm_f, dof, lse, delta, block_k=bk_dq,
                                          **kw)
        dk_h, dv_h = bwd.distr_dkv_kernel_call(qf, kf, vf, perm_f, dof, lse, delta,
                                               block_k=bk_dkv, **kw)
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
    cfg, proj = resolve_at(cfg, q, k, proj, causal=causal, xla=False)
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
                     block_k: int | None = None, return_stats: bool = False):
    """Split-K flash-decoding over a KV cache.

    q: (B, Hq, q_len, d); k, v: (B, Hkv, S, d); ``lengths`` (B,) live token
    counts (None ⇒ all S live; clamped to S).  The fused-K̂ variant takes
    ``k_fused`` (B, Hkv, S, d/G*), the static ``perm`` (Hkv, d) and
    ``group_size``; ``k`` may then be None.  ``scale`` refers to the full
    head dim.  ``block_k`` is the split length; None takes the tuner's
    (``REPRO_TUNE``; unset: DEFAULT_DECODE_BLOCK), capped at S.  Returns
    (B, Hq, q_len, d) in q's dtype; with ``return_stats`` the splits folded
    unnormalised instead (``decode.reduce_splits``): o (B, Hq, q_len, d), m
    and l (B, Hq, q_len), f32, for a merge with other ranks' positions.
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
    if block_k is None:
        from repro_torch.tune.autotune import resolve_decode_block
        from repro_torch.tune.cache import dtype_str

        block_k = resolve_decode_block(d=d, n=s_len, dtype=dtype_str(q), group_size=group_size,
                                       device=q.device)
    block_k = min(block_k, s_len)
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
    if return_stats:
        o, m, l = decode_kernels.reduce_splits(o, m, l)  # (B, Hkv, rows, ·)
        return (o.reshape(b, hq, q_len, d), m.reshape(b, hq, q_len),
                l.reshape(b, hq, q_len))
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


class _SSD(torch.autograd.Function):
    """The SSD with a gradient: the kernel forward (its plain version on CPU
    tensors); the backward recomputes the chunked SSD of the model's layout
    (``models/mamba.py::ssd_chunked``, the reference's ``ssd_xla``) under
    autograd and returns its vector-Jacobian product, the reference's own
    route to a gradient (autodiff of ``ssd_xla``).  With ``return_state``
    the state's gradient is carried into the product too."""

    @staticmethod
    def forward(ctx, x, a, b, c, chunk: int, return_state: bool):
        ctx.save_for_backward(x, a, b, c)
        ctx.meta = (chunk, return_state)
        return _ssd_fwd(x, a, b, c, chunk, return_state)

    @staticmethod
    def backward(ctx, dy, dstate=None):
        # Imported here: the model module imports this one.
        from repro_torch.models.mamba import ssd_chunked

        chunk, return_state = ctx.meta
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = ssd_chunked(*inputs, chunk=chunk, return_state=return_state)
            outs, cots = (out, (dy, dstate)) if return_state else ((out,), (dy,))
            grads = iter(torch.autograd.grad(outs, wanted, cots))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None)


def _ssd_fwd(x, a, b, c, chunk: int, return_state: bool):
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


def ssd(x, a, b, c, *, chunk: int = 64, return_state: bool = False):
    """Mamba-2 SSD.  x: (B, N, H, P); a: (B, N, H) log-decays; b, c: (B, N,
    G, S) → y (B, N, H, P) in x's dtype, and with ``return_state`` also the
    state at position N, (B, H, S, P) f32 (``ssd_xla(return_state=True)``).

    Flattens to (B·H, N, P) / (B·G, N, S) for the kernel, as the reference's
    ``_ssd_jit`` does; the kernel masks a ragged tail itself.  When an input
    wants a gradient, on either device, ``_SSD`` runs the same forward and
    gives it a backward."""
    if _wants_grad(x, a, b, c):
        return _SSD.apply(x, a, b, c, chunk, return_state)
    return _ssd_fwd(x, a, b, c, chunk, return_state)


# ---------------------------------------------------------------------------
# Analytic cost models (the roofline bounds of chip_smoke.py).
# ---------------------------------------------------------------------------


def attention_cost(
    b: int,
    hq: int,
    n: int,
    nk: int,
    d: int,
    *,
    causal: bool = False,
    group_size: int = 1,
    block_q: int = 128,
) -> dict:
    """FLOPs / bytes model of (Distr)FlashAttention, forward and backward
    (the reference's ``ops.attention_cost``, counted alike).

    Forward keys model one fused forward pass: matmul FLOPs, the K-fusion
    adds, the LSH stage, and HBM bytes (bf16 in and out; S and P never
    reach memory).  ``bwd_*`` keys model the backward: the dQ kernel
    recomputes S and runs dP, dQ; the dK/dV kernel recomputes S and runs
    dP, dV, dK; plus the D = rowsum(dO ∘ O) precompute.  Score-space
    matmuls (S, dQ, dK) contract over d/G*, the paper's work for the
    mechanism, whatever implements it (the port's bf16 kernels run them at
    full width over Q̃); context-space ones (dP, dV) over the full d.
    ``group_size=1`` is exact FA-2.  The ``bwd_*`` keys price the whole
    backward (delta, dq and dkv together) and split into no per-kernel
    share: a kernel's own bound is ``attention_work``'s.
    """
    frac = 0.5 * (1 + 1 / max(nk // max(block_q, 1), 1)) if causal else 1.0
    d_eff = d // group_size
    score_mm = 2 * b * hq * n * nk * d_eff * frac  # one reduced-d matmul
    full_mm = 2 * b * hq * n * nk * d * frac  # one full-d matmul
    qk_flops = score_mm
    pv_flops = full_mm
    softmax_flops = 4 * b * hq * n * nk * frac  # exp, max, sum, scale
    # K fusion: for each (q-block, kv element) a d-length permuted add chain.
    fusion_adds = (
        b * hq * (n // max(block_q, 1)) * nk * d * frac if group_size > 1 else 0
    )
    lsh_flops = (
        2 * b * hq * (n // max(block_q, 1)) * lsh.N_PRIME * block_q * d
        if group_size > 1
        else 0
    )
    w = 2  # bf16
    io_bytes = w * (
        b * hq * n * ((d + d // group_size) if group_size > 1 else d)  # Q (+Q̂)
        # K̂ is built inside the kernel and never reaches memory: 0 bytes.
        + 2 * b * hq * nk * d  # K, V read (per-head upper bound)
        + b * hq * n * d  # O write
    )

    # dq kernel: S recompute (d_eff) + dP (d) + dQ (d_eff)
    # dkv kernel: S recompute (d_eff) + dP (d) + dV (d) + dK (d_eff)
    bwd_mxu_flops = 4 * score_mm + 3 * full_mm
    # P from the saved LSE (exp) twice + dS = P∘(dP−D) twice + D precompute.
    bwd_vpu_flops = 6 * b * hq * n * nk * frac + 2 * b * hq * n * d
    # K̂ re-fused in both backward kernels; dK̂ replication adds back to d.
    bwd_fusion_adds = 3 * fusion_adds
    bwd_io_bytes = w * (
        2 * b * hq * n * ((d + d // group_size) if group_size > 1 else d)  # Q(+Q̂) ×2 kernels
        + 4 * b * hq * nk * d  # K, V read in both kernels
        + 4 * b * hq * n * d  # dO read ×2 kernels + O + dO reads (delta)
    ) + 4 * (
        # LSE and D are per-row f32 scalars: one write each (forward
        # kernel / delta kernel) and one read each in both backward kernels.
        6 * b * hq * n
        + b * hq * n * d  # dQ write, f32
        + 2 * b * hq * nk * d  # per-q-head dK, dV writes, f32
    )

    return {
        "qk_flops": qk_flops,
        "pv_flops": pv_flops,
        "softmax_flops": softmax_flops,
        "fusion_adds": fusion_adds,
        "lsh_flops": lsh_flops,
        "mxu_flops": qk_flops + pv_flops,
        "total_flops": qk_flops + pv_flops + softmax_flops + fusion_adds + lsh_flops,
        "hbm_bytes": io_bytes,
        "bwd_mxu_flops": bwd_mxu_flops,
        "bwd_total_flops": bwd_mxu_flops + bwd_vpu_flops + bwd_fusion_adds,
        "bwd_hbm_bytes": bwd_io_bytes,
        "fwd_bwd_mxu_flops": qk_flops + pv_flops + bwd_mxu_flops,
        "fwd_bwd_hbm_bytes": io_bytes + bwd_io_bytes,
    }


def attention_pairs(n: int, nk: int, *, causal: bool) -> int:
    """(query row, key) pairs of one head's scores: all ``n·nk``, or under
    the kernels' causal mask (row i sees keys 0..i) the band."""
    if not causal:
        return n * nk
    m = min(n, nk)
    return m * (m + 1) // 2 + (n - m) * nk


def attention_work(
    b: int,
    hq: int,
    hkv: int,
    n: int,
    nk: int,
    d: int,
    *,
    causal: bool = False,
    group_size: int = 1,
    block_q: int = 128,
    lse: bool = False,
) -> dict:
    """The least work of each attention kernel on its own inputs: the
    roofline bound of a kernel row (``obs.utilization.kernel_bound``).

    Unlike ``attention_cost`` (the reference's model of the mechanism,
    which counts whole diagonal blocks and K/V once per query head), this
    counts what the function needs: the (row, key) pairs of the causal band
    exactly, each input read once (K and V at their ``hkv`` heads) and each
    output written once.  ``fwd`` is the forward kernel (O, plus the f32
    LSE when ``lse``); ``dq`` and ``dkv`` the backward kernels, which read
    Q (or Q̂), K, V, dO, the LSE and D and write f32 dQ (dQ̂) or per-query-
    head f32 dK and dV.  Tensor-core products: the score products (S, dQ,
    dK) at the score width d/G*, the context ones (O, dP, dV) at d.  f32
    work: the softmax (4 a pair, as ``attention_cost``), P and dS in each
    backward kernel (4 a pair), and for DistrAttention the K̂ fusion, d − d/G*
    adds for each (q-block, key) a block sees, in every kernel that
    builds K̂.  The LSH stage that makes Q̂ and the permutation is not
    these kernels' work: they take both as inputs.
    """
    pairs = b * hq * attention_pairs(n, nk, causal=causal)
    ds = d // group_size
    distr = group_size > 1
    blocks = -(-n // block_q)
    fusion = 0
    if distr:
        keys = sum(min(min((j + 1) * block_q, n), nk) if causal else nk for j in range(blocks))
        fusion = b * hq * keys * (d - ds)
    perm = 4 * b * hq * blocks * d if distr else 0  # int32 permutation a q-block
    ins = 2 * b * hq * n * ds + 2 * 2 * b * hkv * nk * d + perm  # Q or Q̂, K, V
    bwd_ins = ins + 2 * b * hq * n * d + 2 * 4 * b * hq * n  # + dO, LSE, D
    return {
        "fwd": {"tensor_flops": 2 * (ds + d) * pairs, "f32_flops": 4 * pairs + fusion,
                "hbm_bytes": ins + 2 * b * hq * n * d + (4 * b * hq * n if lse else 0)},
        "dq": {"tensor_flops": 2 * (2 * ds + d) * pairs, "f32_flops": 4 * pairs + fusion,
               "hbm_bytes": bwd_ins + 4 * b * hq * n * ds},
        "dkv": {"tensor_flops": 2 * (2 * ds + 2 * d) * pairs, "f32_flops": 4 * pairs + fusion,
                "hbm_bytes": bwd_ins + 2 * 4 * b * hq * nk * d},
    }


def delta_work(rows: int, d: int, itemsize: int) -> dict:
    """The least work of D = rowsum(dO ∘ O): O and dO read once, D written
    once in f32, a multiply and an add an element."""
    return {"tensor_flops": 0, "f32_flops": 2 * rows * d,
            "hbm_bytes": 2 * itemsize * rows * d + 4 * rows}


def decode_attention_work(
    lengths,
    hq: int,
    hkv: int,
    d: int,
    capacity: int,
    *,
    group_size: int = 1,
    q_len: int = 1,
    table_entries: int = 0,
) -> dict:
    """The least work of one decode kernel call over a batch of requests
    with live ``lengths`` (contiguous or paged): the roofline bound of a
    kernel row (``obs.utilization.kernel_bound``).

    Unlike ``decode_attention_cost`` and ``paged_decode_attention_cost``
    (the reference's models, which round live keys up to whole splits or
    blocks, give every query row every live key and price the f32 split
    partials written and read for every split), this counts what the
    function needs: each request's live keys, at most ``capacity``, read
    once for K (or K̂, ``d/G*`` wide) and V at their ``hkv`` heads; the
    ``q_len`` query rows of a request see the causal band (row i of
    ``q_len`` the keys before ``length − (q_len − 1 − i)``); q, the
    lengths and ``table_entries`` block-table entries a request (int32)
    read once; one merged f32 o, m and l a row written once.
    """
    d_score = d // group_size
    live = sum(min(max(n, 0), capacity) for n in lengths)
    pairs = hq * sum(max(0, min(n - (q_len - 1 - i), capacity))
                     for n in lengths for i in range(q_len))
    b = len(lengths)
    rows = b * hq * q_len
    return {
        "tensor_flops": 2 * (d_score + d) * pairs,
        "f32_flops": 4 * pairs,
        "hbm_bytes": 2 * hkv * live * (d_score + d) + 2 * rows * d_score
        + 4 * b * (1 + table_entries) + 4 * rows * (d + 2),
    }


def ssd_cost(b: int, n: int, h: int, p: int, s: int, *, chunk: int = 64) -> dict:
    """FLOPs model of the chunked SSD forward (no bytes: the caller counts
    them)."""
    nc = n // chunk
    intra = 2 * b * h * nc * (chunk * chunk * s + chunk * chunk * p)
    inter = 2 * b * h * nc * (chunk * s * p * 2)
    return {"total_flops": intra + inter, "mxu_flops": intra + inter}


def ssd_work(b: int, n: int, h: int, p: int, g: int, s: int, *, chunk: int = 64) -> dict:
    """The least work of the chunked SSD scan on its inputs (x, y: bf16
    (B·H, N, P); a: f32 (B·H, N); b, c: bf16 (B·G, N, S); the f32 final
    state (B·H, S, P)).  Unlike ``ssd_cost``, a chunk's Q × Q products
    count only their causal triangle, and a ragged last chunk its own
    length.  f32 work: a decay factor (an exp and a multiply) a pair."""
    tensor = f32 = 0
    for length in [chunk] * (n // chunk) + ([n % chunk] if n % chunk else []):
        tri = length * (length + 1) // 2
        tensor += 2 * tri * (s + p) + 4 * length * s * p  # C·Bᵀ, G·X; C·H, (B∘w)ᵀ·X
        f32 += 2 * tri
    return {"tensor_flops": b * h * tensor, "f32_flops": b * h * f32,
            "hbm_bytes": 2 * 2 * b * h * n * p + 4 * b * h * n + 2 * 2 * b * g * n * s
            + 4 * b * h * s * p}
