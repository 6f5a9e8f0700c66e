"""Ring sequence-parallel ("context parallel") attention over the kernels
(``repro/distributed/ring_attention.py``).

The online-softmax merge that makes FlashAttention-2 associative over KV
tiles is as associative over KV shards held by different ranks: partial
``(O, LSE)`` pairs merge as

    LSE = logaddexp(LSE_a, LSE_b)
    O   = O_a · exp(LSE_a − LSE) + O_b · exp(LSE_b − LSE)

so Q, K and V are sharded on the sequence axis over the ranks of a context
axis, each rank runs the port's kernels (flash or DistrAttention, with
their LSE) on its own Q shard against whichever KV shard it holds, and KV
rotates one hop around the ring between launches: rank ``i`` sends to
``i + 1`` and receives from ``i − 1``.  Sequence length then scales with
the ring's size instead of one device's memory.

Schedule (P = ring size, rank ``i`` owns Q/KV shard ``i``):

  hop 0:  every rank attends its own shard, the causal diagonal, so this
          is the only hop that runs the causal kernel variant;
  hop h:  rank ``i`` holds KV shard ``src = (i − h) mod P``.  Causal rings
          skip the hop when ``src > i`` (the shard lies in the future);
          both modes skip hops whose KV shard holds no live token, and
          ranks whose Q shard is all padding.  A skipped hop launches no
          kernel; ``return_hops=True`` also returns the count of hops that
          launch, summed over the ring (every rank counts it from the
          schedule).

DistrAttention keeps the paper's grouping shard-local: shards are a
multiple of ``block_q``, so no permutation block crosses a shard, and K̂ is
fused inside the kernel from the raw rotating K under the local Q blocks'
permutations (it cannot rotate as state: each rank fuses under its own).

The backward runs the same ring over the backward kernels: dQ accumulates
locally while (K, V, dK, dV) rotate together; after P rotations dK and dV
are back on their owner.  The merged LSE and the local D = rowsum(dO ∘ O)
are row statistics of the local Q shard, so no statistic crosses the ring.

The calling contract is the reference's: global (B, H, N, d) tensors go in
on every rank and the global output comes out, unpadded to N, on every
rank; the gradients of the global q, k and v are equal on every rank.  The
context group must be a ``gloo`` group, which moves host tensors only
(and is the backend that can put several ranks on one card): CUDA tensors
are staged through pinned host buffers.  Other backends (NCCL across
cards) are refused.  On CPU tensors the kernel calls take their plain
versions.  Meshes with a data or model axis larger than 1 (batch or heads
sharded beside the ring) are refused.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from math import lcm

import torch
import torch.distributed as dist

from repro_torch.core.distr_attention import DistrConfig, pad_to_multiple
from repro_torch.core.flash_reference import NEG_INF
from repro_torch.kernels import backward as bwd
from repro_torch.kernels import ops
from repro_torch.kernels.distr_attention import distr_attention_kernel_call
from repro_torch.kernels.flash_attention import flash_attention_kernel_call

# A ring shard is only worth its hop once it holds a full 128-row tile;
# below this the dispatch keeps the call on one device (short prompts).
MIN_RING_SHARD = 128


def context_shard_len(n: int, p: int, *, multiple: int = 128) -> int:
    """Per-rank sequence shard for a ring of size ``p``: ceil(n/p) rounded up
    to ``multiple`` (the kernels' 128-row tile / the LSH block)."""
    per = -(-int(n) // int(p))
    return max(multiple, -(-per // multiple) * multiple)


def _fit_block(block: int, shard: int) -> int:
    """Clamp a block size to one that tiles the shard exactly."""
    b = min(int(block), shard)
    return b if shard % b == 0 else 128


def _merge_partial(o, lse, o_h, lse_h):
    """Associative online-softmax merge of two (O, LSE) partials, in f32."""
    lse_new = torch.logaddexp(lse, lse_h)
    w = torch.exp(lse - lse_new)[..., None]
    w_h = torch.exp(lse_h - lse_new)[..., None]
    return o * w + o_h.float() * w_h, lse_new


class _Ring:
    """This rank's place on the context axis and the axis's collectives.
    ``rotate`` is one KV hop: send to the next rank, receive from the one
    before."""

    def __init__(self, mesh, axis: str):
        self.size = int(mesh.shape[axis])
        self.idx = int(mesh.coords[axis])
        self.group = mesh.groups[axis]
        ranks = mesh.ranks[axis]
        self.next = ranks[(self.idx + 1) % self.size]
        self.prev = ranks[(self.idx - 1) % self.size]
        backend = dist.get_backend(self.group)
        if backend != "gloo":
            raise NotImplementedError(
                f"the ring runs on a gloo context group only (it stages CUDA tensors "
                f"through host memory); this group's backend is {backend!r}")

    @staticmethod
    def _to_wire(x: torch.Tensor) -> torch.Tensor:
        """x on the host (gloo moves host tensors only), pinned when staged
        from the card."""
        if not x.is_cuda:
            return x
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
        return host

    def rotate(self, tensors):
        """Every rank sends ``tensors`` to the next ring position; returns
        the ones received from the previous position (same shapes)."""
        flat = torch.cat([t.contiguous().view(-1).view(torch.uint8) for t in tensors])
        send = self._to_wire(flat)
        recv = torch.empty(send.shape, dtype=send.dtype, pin_memory=send.is_pinned())
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, self.next, self.group),
                                       dist.P2POp(dist.irecv, recv, self.prev, self.group)])
        for req in reqs:
            req.wait()
        recv = recv.to(flat.device, non_blocking=True)
        out, at = [], 0
        for t in tensors:
            nbytes = t.numel() * t.element_size()
            out.append(recv[at:at + nbytes].view(t.dtype).view(t.shape))
            at += nbytes
        return tuple(out)

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The ring's shards of x (B, H, n_shard, ·) concatenated in ring
        order on the sequence axis, on every rank."""
        wire = self._to_wire(x.contiguous())
        parts = torch.empty((self.size, *wire.shape), dtype=wire.dtype,
                            pin_memory=wire.is_pinned())
        dist.all_gather(list(parts.unbind(0)), wire, group=self.group)
        b, h, n, d = x.shape
        return parts.to(x.device).permute(1, 2, 0, 3, 4).reshape(b, h, self.size * n, d)


@dataclass(frozen=True)
class _RingMeta:
    """The ring's static configuration."""

    size: int
    causal: bool
    scale: float
    n_live: int  # global live sequence length (before padding)
    shard: int  # per-rank padded shard length
    dcfg: DistrConfig | None = None  # DistrAttention when set (block_q resolved)
    # The dead shards (dead_shard_fault) in force when the ring call began:
    # its backward skips the hops its forward skipped, wherever it runs.
    dead: frozenset[int] = field(default_factory=lambda: _DEAD_SHARDS)

    @property
    def tail_idx(self) -> int:
        """Index of the partly live shard (−1 when the live length ends on a
        shard boundary)."""
        return self.n_live // self.shard if self.n_live % self.shard else -1

    @property
    def tail_len(self) -> int:
        return self.n_live % self.shard


# -- fault injection (the serve.faults catalog point "dead_ring_shard") ----
#
# Shards listed here model a dead host mid-ring: its KV shard never arrives
# at the other ranks, so every hop h > 0 whose source is a dead shard is
# skipped and the ring serves a degraded but finite result instead of
# hanging.  Hop 0 (a rank's own KV) always runs: it is resident, not
# rotated, so no Q row loses its softmax diagonal.
_DEAD_SHARDS: frozenset[int] = frozenset()


@contextlib.contextmanager
def dead_shard_fault(shards):
    """Treat the KV shards in ``shards`` as dead for ring calls made inside
    the context (their backward too, wherever it runs).  ``shards`` is an
    iterable of shard ids or a ``faults.FaultInjector``, whose
    ``dead_ring_shard`` specs name them."""
    global _DEAD_SHARDS
    if hasattr(shards, "dead_shards"):
        shards = shards.dead_shards()
    prev = _DEAD_SHARDS
    _DEAD_SHARDS = frozenset(int(s) for s in shards)
    try:
        yield
    finally:
        _DEAD_SHARDS = prev


def _hop_schedule(meta: _RingMeta, idx: int, h: int):
    """(src, run, kernel_causal) for hop ``h`` on rank ``idx``: the KV shard
    held, whether the hop launches its kernels (the KV shard holds a live
    token, the rank's own Q shard is not all padding, and, causal, the
    shard is not in the future: ``src < idx``; the diagonal ``src == idx``
    is always hop 0 in this rotation), and whether it runs the causal
    variant (hop 0 of a causal ring only)."""
    p = meta.size
    src = (idx - h) % p if h else idx
    run = src * meta.shard < meta.n_live and idx * meta.shard < meta.n_live
    if meta.causal and h > 0:
        run = run and src < idx
    if meta.dead and h > 0:
        # Injected dead shards (dead_shard_fault): the rotated KV from a
        # dead source never arrives; skip the hop, keep serving.
        run = run and src not in meta.dead
    return src, run, (meta.causal and h == 0)


def _count_hops(meta: _RingMeta) -> int:
    """The hops that launch kernels, summed over the ring."""
    return sum(_hop_schedule(meta, i, h)[1] for i in range(meta.size) for h in range(meta.size))


def _hop_kv_variants(meta: _RingMeta, src: int, call):
    """``call(kv_len)`` with the live length of the held KV shard: a full
    shard streams ``shard`` keys, the one partly live (tail) shard masks
    past ``tail_len``."""
    return call(meta.tail_len if src == meta.tail_idx else meta.shard)


def _live_row_mask(meta: _RingMeta, idx: int, n_rows: int, device=None) -> torch.Tensor:
    """(n_rows,) bool: the rows of the local Q shard that are real tokens."""
    live = min(max(meta.n_live - idx * meta.shard, 0), meta.shard)
    return torch.arange(n_rows, device=device) < live


def _ring_hops(meta: _RingMeta, ring: _Ring, kv, carry, hop_body, *, post_hop=None):
    """The ring loop the four sweeps (flash / distr × forward / backward)
    share: per hop, take the schedule, run ``hop_body(src, kernel_causal,
    k_c, v_c, carry)`` when the hop runs (a skipped hop launches nothing),
    apply ``post_hop`` to the carry on every hop, run or skipped (the
    backwards rotate their dK / dV accumulators every hop, so they land on
    the owner after P rotations), then rotate KV, except after the last
    hop.  The skip and rotation order lives here alone so that it cannot
    drift between the sweeps."""
    for h in range(meta.size):
        src, run, kernel_causal = _hop_schedule(meta, ring.idx, h)
        k_c, v_c = kv
        if run:
            carry = hop_body(src, kernel_causal, k_c, v_c, carry)
        if post_hop is not None:
            carry = post_hop(carry)
        if h < meta.size - 1:
            kv = ring.rotate(kv)
    return carry


def _local_shard(x: torch.Tensor, meta: _RingMeta, idx: int) -> torch.Tensor:
    """Rank ``idx``'s shard of a global (B, H, N, d) tensor, zero-padded to
    ``meta.shard`` rows."""
    lo = idx * meta.shard
    part = x[:, :, lo:lo + meta.shard]
    if part.shape[2] < meta.shard:
        part = torch.cat([part, part.new_zeros(*part.shape[:2], meta.shard - part.shape[2],
                                               part.shape[3])], dim=2)
    return part.contiguous()


def _rotate_dkv(ring: _Ring):
    def post_hop(c):
        # dK / dV rotate with their KV shard every hop (P rotations in all),
        # landing back on the owner; dQ stays local.
        dq, dk, dv = c
        dk, dv = ring.rotate((dk, dv))
        return dq, dk, dv
    return post_hop


# ---------------------------------------------------------------------------
# Exact flash ring
# ---------------------------------------------------------------------------


def _ring_flash_fwd_impl(meta: _RingMeta, ring: _Ring, q, k, v):
    b, hq, n_sh, d = q.shape
    hkv = k.shape[1]
    qf = q.reshape(b * hq, n_sh, d)
    kv = (k.reshape(b * hkv, n_sh, d), v.reshape(b * hkv, n_sh, d))
    o0 = torch.zeros((b * hq, n_sh, d), dtype=torch.float32, device=q.device)
    lse0 = torch.full((b * hq, n_sh), NEG_INF, dtype=torch.float32, device=q.device)

    def hop_body(src, kernel_causal, k_c, v_c, c):
        o_h, lse_h = _hop_kv_variants(meta, src, lambda kv_len: flash_attention_kernel_call(
            qf, k_c, v_c, q_per_kv=hq // hkv, scale=meta.scale, causal=kernel_causal,
            kv_len=kv_len, return_lse=True))
        return _merge_partial(*c, o_h, lse_h)

    o, lse = _ring_hops(meta, ring, kv, (o0, lse0), hop_body)
    return o.reshape(b, hq, n_sh, d).to(q.dtype), lse


def _ring_flash_local_bwd(meta: _RingMeta, ring: _Ring, q, k, v, o, lse, do):
    b, hq, n_sh, d = q.shape
    hkv = k.shape[1]
    qf = q.reshape(b * hq, n_sh, d)
    dof = do.to(q.dtype).reshape(b * hq, n_sh, d)
    delta = bwd.delta_kernel_call(o.reshape(b * hq, n_sh, d), dof)
    # Padded Q rows carry no cotangent (dO is zero-padded), but their LSE
    # comes from unmasked forward rows; pin it to +big so P ≡ 0 and they
    # add nothing to dK / dV.
    row_live = _live_row_mask(meta, ring.idx, n_sh, q.device)[None, :]
    lse_b = torch.where(row_live, lse, bwd.LSE_PAD)
    kv = (k.reshape(b * hkv, n_sh, d), v.reshape(b * hkv, n_sh, d))
    state = (torch.zeros((b * hq, n_sh, d), dtype=torch.float32, device=q.device),
             torch.zeros((b, hkv, n_sh, d), dtype=torch.float32, device=q.device),
             torch.zeros((b, hkv, n_sh, d), dtype=torch.float32, device=q.device))

    def hop_body(src, kernel_causal, k_c, v_c, c):
        dq, dk, dv = c

        def call(kv_len):
            kw = dict(q_per_kv=hq // hkv, scale=meta.scale, causal=kernel_causal,
                      kv_len=kv_len)
            dq_h = bwd.flash_dq_kernel_call(qf, k_c, v_c, dof, lse_b, delta, **kw)
            dk_h, dv_h = bwd.flash_dkv_kernel_call(qf, k_c, v_c, dof, lse_b, delta, **kw)
            return dq_h, dk_h, dv_h

        dq_h, dk_h, dv_h = _hop_kv_variants(meta, src, call)
        # GQA group-sum per hop: the rotating accumulator carries the
        # per-KV-head layout (q_per_kv times less ring traffic).
        return dq + dq_h, dk + ops._gqa_sum(dk_h, b, hkv), dv + ops._gqa_sum(dv_h, b, hkv)

    dq, dk, dv = _ring_hops(meta, ring, kv, state, hop_body, post_hop=_rotate_dkv(ring))
    return dq.reshape(b, hq, n_sh, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """Global q, k, v in, the global output out; the backward runs the
    reverse ring and gathers the global gradients."""

    @staticmethod
    def forward(ctx, q, k, v, meta: _RingMeta, ring: _Ring):
        ql, kl, vl = (_local_shard(x, meta, ring.idx) for x in (q, k, v))
        out, lse = _ring_flash_fwd_impl(meta, ring, ql, kl, vl)
        ctx.save_for_backward(ql, kl, vl, out, lse)
        ctx.meta, ctx.ring = meta, ring
        return ring.gather_seq(out)[:, :, :meta.n_live]

    @staticmethod
    def backward(ctx, do):
        meta, ring = ctx.meta, ctx.ring
        dq, dk, dv = _ring_flash_local_bwd(meta, ring, *ctx.saved_tensors,
                                           _local_shard(do, meta, ring.idx))
        n = meta.n_live
        return (ring.gather_seq(dq)[:, :, :n], ring.gather_seq(dk)[:, :, :n],
                ring.gather_seq(dv)[:, :, :n], None, None)


# ---------------------------------------------------------------------------
# DistrAttention ring (shard-local LSH grouping)
# ---------------------------------------------------------------------------


def _distr_stage1(meta: _RingMeta, q: torch.Tensor, hkv: int, proj):
    """The LSH stage (per-Q-block permutations and the sampled, pre-scaled
    Q̂) over the global q padded to the ring's P · shard rows, through
    ``ops.distr_stage1``, the single-device op's own, so the grouping
    cannot diverge from it.  No block crosses a shard boundary, so the
    grouping is shard-local, and each rank runs it over the whole q (as
    the reference runs it on the global array): every rank then holds the
    same permutations.  The blocks the single-device op pads Q to are
    hashed in one call with its shapes; the all-zero blocks past them, in
    a second."""
    cfg = meta.dcfg
    qp = pad_to_multiple(q, cfg.block_q, dim=2)
    q_hat, perms = ops.distr_stage1(cfg, qp, meta.scale, proj=proj, hkv=hkv)
    extra = meta.size * meta.shard - qp.shape[2]
    if extra:
        zeros = q.new_zeros(q.shape[0], q.shape[1], extra, q.shape[3])
        z_hat, z_perms = ops.distr_stage1(cfg, zeros, meta.scale, proj=proj, hkv=hkv)
        q_hat, perms = torch.cat([q_hat, z_hat], dim=2), torch.cat([perms, z_perms], dim=2)
    return q_hat, perms


def _ring_distr_local_fwd(meta: _RingMeta, ring: _Ring, q_hat, perms, k, v):
    """Shard-local ring forward: q_hat (B, Hq, n_sh, d/G*), perms
    (B, Hq, nq_local, d), k, v (B, Hkv, n_sh, d)."""
    cfg = meta.dcfg
    b, hq, n_sh, dg = q_hat.shape
    hkv, d = k.shape[1], k.shape[-1]
    qf = q_hat.reshape(b * hq, n_sh, dg)
    perm_f = perms.reshape(b * hq, n_sh // cfg.block_q, d)
    kv = (k.reshape(b * hkv, n_sh, d), v.reshape(b * hkv, n_sh, d))
    o0 = torch.zeros((b * hq, n_sh, d), dtype=torch.float32, device=k.device)
    lse0 = torch.full((b * hq, n_sh), NEG_INF, dtype=torch.float32, device=k.device)

    def hop_body(src, kernel_causal, k_c, v_c, c):
        # K̂ is fused inside the kernel from the rotating raw K under the
        # local permutations: it never rides the ring.
        o_h, lse_h = _hop_kv_variants(meta, src, lambda kv_len: distr_attention_kernel_call(
            qf, k_c, v_c, perm_f, q_per_kv=hq // hkv, causal=kernel_causal,
            group_size=cfg.group_size, block_q=cfg.block_q, kv_len=kv_len, return_lse=True))
        return _merge_partial(*c, o_h, lse_h)

    o, lse = _ring_hops(meta, ring, kv, (o0, lse0), hop_body)
    return o.reshape(b, hq, n_sh, d).to(k.dtype), lse


def _ring_distr_local_bwd(meta: _RingMeta, ring: _Ring, q_hat, perms, k, v, o, lse, do):
    """Shard-local ring backward; ``lse`` is the merged LSE of the local Q
    rows.  Returns (dq_hat, dk, dv), dq_hat still in the sampled space."""
    cfg = meta.dcfg
    b, hq, n_sh, dg = q_hat.shape
    hkv, d = k.shape[1], k.shape[-1]
    qf = q_hat.reshape(b * hq, n_sh, dg)
    perm_f = perms.reshape(b * hq, n_sh // cfg.block_q, d)
    dof = do.to(k.dtype).reshape(b * hq, n_sh, d)
    delta = bwd.delta_kernel_call(o.reshape(b * hq, n_sh, d), dof)
    row_live = _live_row_mask(meta, ring.idx, n_sh, k.device)[None, :]
    lse_b = torch.where(row_live, lse, bwd.LSE_PAD)
    kv = (k.reshape(b * hkv, n_sh, d), v.reshape(b * hkv, n_sh, d))
    state = (torch.zeros((b * hq, n_sh, dg), dtype=torch.float32, device=k.device),
             torch.zeros((b, hkv, n_sh, d), dtype=torch.float32, device=k.device),
             torch.zeros((b, hkv, n_sh, d), dtype=torch.float32, device=k.device))

    def hop_body(src, kernel_causal, k_c, v_c, c):
        dq_hat, dk, dv = c

        def call(kv_len):
            kw = dict(q_per_kv=hq // hkv, causal=kernel_causal, group_size=cfg.group_size,
                      block_q=cfg.block_q, kv_len=kv_len)
            dq_h = bwd.distr_dq_kernel_call(qf, k_c, v_c, perm_f, dof, lse_b, delta, **kw)
            dk_h, dv_h = bwd.distr_dkv_kernel_call(qf, k_c, v_c, perm_f, dof, lse_b, delta,
                                                   **kw)
            return dq_h, dk_h, dv_h

        dq_h, dk_h, dv_h = _hop_kv_variants(meta, src, call)
        return (dq_hat + dq_h, dk + ops._gqa_sum(dk_h, b, hkv),
                dv + ops._gqa_sum(dv_h, b, hkv))

    dq_hat, dk, dv = _ring_hops(meta, ring, kv, state, hop_body, post_hop=_rotate_dkv(ring))
    return dq_hat.reshape(b, hq, n_sh, dg), dk.to(k.dtype), dv.to(v.dtype)


class _RingDistr(torch.autograd.Function):
    """Stage 1 and its transpose on the global arrays, the hops on the local
    shards.  The permutations get no gradient (straight-through), as in
    the single-device op."""

    @staticmethod
    def forward(ctx, q, k, v, meta: _RingMeta, ring: _Ring, proj):
        cfg = meta.dcfg
        q_hat, perms = _distr_stage1(meta, q, k.shape[1], proj)
        nb = meta.shard // cfg.block_q
        i = ring.idx
        qh_l = q_hat[:, :, i * meta.shard:(i + 1) * meta.shard].contiguous()
        perms_l = perms[:, :, i * nb:(i + 1) * nb].contiguous()
        kl, vl = (_local_shard(x, meta, i) for x in (k, v))
        out, lse = _ring_distr_local_fwd(meta, ring, qh_l, perms_l, kl, vl)
        ctx.save_for_backward(qh_l, perms_l, kl, vl, out, lse, perms)
        ctx.meta, ctx.ring, ctx.q_dtype = meta, ring, q.dtype
        return ring.gather_seq(out)[:, :, :meta.n_live]

    @staticmethod
    def backward(ctx, do):
        meta, ring = ctx.meta, ctx.ring
        cfg = meta.dcfg
        qh_l, perms_l, kl, vl, out, lse, perms = ctx.saved_tensors
        dq_hat, dk, dv = _ring_distr_local_bwd(meta, ring, qh_l, perms_l, kl, vl, out, lse,
                                               _local_shard(do, meta, ring.idx))
        n = meta.n_live
        dq = ops.distr_dq_from_dq_hat(cfg.estimator, ring.gather_seq(dq_hat), perms,
                                      block_q=cfg.block_q, group_size=cfg.group_size,
                                      scale=meta.scale)
        return (dq[:, :, :n].to(ctx.q_dtype), ring.gather_seq(dk)[:, :, :n],
                ring.gather_seq(dv)[:, :, :n], None, None, None)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _ring_size(q, k, mesh, axis: str) -> int:
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"ring attention is self-attention only: N_q={q.shape[2]} != "
                         f"N_k={k.shape[2]}")
    p = int(mesh.shape[axis]) if axis in mesh.axis_names else 1
    if p > 1:
        wide = {a: int(mesh.shape[a]) for a in mesh.axis_names
                if a != axis and int(mesh.shape[a]) > 1}
        if wide:
            raise NotImplementedError(
                f"the ring shards the sequence over {axis!r} only; this mesh also has "
                f"{wide} (batch over data axes and heads over 'model' beside the ring "
                "are not ported)")
    return p


def ring_flash_attention(q, k, v, mesh, *, axis: str = "context", causal: bool = False,
                         scale: float | None = None, return_hops: bool = False):
    """Exact FA-2 ring attention.  q: (B, Hq, N, d); k, v: (B, Hkv, N, d)
    with N the global sequence length, sharded over the ``mesh.shape[axis]``
    ranks inside; the same global tensors on every rank.  Differentiable
    (the reverse ring over the backward kernels).  ``return_hops=True``
    also returns the count of ring hops that launch kernels, summed over
    the ring."""
    p = _ring_size(q, k, mesh, axis)
    scale = float(scale) if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if p == 1:
        out = ops.flash_attention(q, k, v, causal=causal, scale=scale)
        return (out, 1) if return_hops else out
    meta = _RingMeta(size=p, causal=causal, scale=scale, n_live=q.shape[2],
                     shard=context_shard_len(q.shape[2], p))
    out = _RingFlash.apply(q, k, v, meta, _Ring(mesh, axis))
    return (out, _count_hops(meta)) if return_hops else out


def ring_distr_attention(q, k, v, cfg: DistrConfig, mesh, *, axis: str = "context",
                         causal: bool = False, scale: float | None = None,
                         proj: torch.Tensor | None = None, return_hops: bool = False):
    """DistrAttention ring with shard-local LSH grouping: the permutations
    and Q̂ of each rank's Q blocks, raw K and V rotating, K̂ fused in the
    kernel at each hop under the local permutations.  ``proj`` is the LSH
    projection (None draws it from ``cfg.proj_seed``, the same on every
    rank)."""
    p = _ring_size(q, k, mesh, axis)
    scale = float(scale) if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if p == 1:
        out = ops.distr_attention(q, k, v, cfg, causal=causal, scale=scale, proj=proj)
        return (out, 1) if return_hops else out
    from repro_torch.tune.cache import dtype_str

    n = q.shape[2]
    tuned = cfg.block_q is None
    # The tuner's key is the length one rank streams, not the global N.
    cfg = cfg.resolved(q.shape[-1], context_shard_len(n, p), dtype=dtype_str(q),
                       causal=causal, xla=False, device=q.device)
    if proj is not None and proj.shape[-1] != cfg.block_q:
        if not tuned:
            raise ValueError(f"LSH projection over {proj.shape[-1]} rows given for "
                             f"block_q={cfg.block_q}")
        proj = None
    # The grouping grain does not move: shards are a multiple of
    # lcm(block_q, 128), so block_q tiles every shard and the ring groups
    # exactly as the single-device op does.
    shard = context_shard_len(n, p, multiple=lcm(128, cfg.block_q))
    meta = _RingMeta(size=p, causal=causal, scale=scale, n_live=n, shard=shard, dcfg=cfg)
    out = _RingDistr.apply(q, k, v, meta, _Ring(mesh, axis), proj)
    return (out, _count_hops(meta)) if return_hops else out


def _resolve_distr_bwd_pair(q, shard: int):
    """The backward kernels' KV tiles (dq, dkv) at the shard one rank
    streams (the reference's name).  The port's backward kernels run the
    tiles they compile (``tune.autotune.compiled_tile``) at every length,
    so the ring passes none: this reports them rather than choosing."""
    from repro_torch.tune.autotune import compiled_tile
    from repro_torch.tune.cache import dtype_str

    dtype = dtype_str(q)
    return (_fit_block(compiled_tile("distr_dq", d=q.shape[-1], dtype=dtype)[1], shard),
            _fit_block(compiled_tile("distr_dkv", d=q.shape[-1], dtype=dtype)[1], shard))
