"""Unified attention dispatch — the framework-facing entry point.

``AttentionConfig.impl`` selects the implementation:

  reference    — naive exact softmax oracle
  xla_flash    — FA-2 blockwise exact, plain PyTorch (name kept from the
                 reference so configs carry over)
  distr        — DistrAttention, plain PyTorch
  pallas_flash — hand-written FA-2 CUDA kernel (plain version on the CPU)
  pallas_distr — hand-written DistrAttention CUDA kernel (plain version on
                 the CPU)

Block sizes resolve through the tuner (``repro_torch.tune``) under
``REPRO_TUNE=off|analytic|measure`` (``resolve_attention_blocks``): the
decode split (``block_k_decode=None``), DistrAttention's ``block_q``
(``DistrConfig.block_q=None``) and the paged pool's block size (chosen by
``PagedServeEngine``; the paged decode path splits once per pool block).
Unset (``off``) they are the static values: 128, and the decode split
``min(128, cache length)``.  The flash kernel's tiles and the backward
kernels' are compiled into the kernels, and ``xla_flash`` keeps 128.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from repro_torch.core import grouping
from repro_torch.core.distr_attention import DEFAULT_BLOCK, DistrConfig, distr_attention
from repro_torch.core.flash_reference import blockwise_flash_reference, reference_attention
from repro_torch.tune.block_sizes import BlockSizes

IMPLS = ("reference", "xla_flash", "distr", "pallas_flash", "pallas_distr")


@dataclass(frozen=True)
class AttentionConfig:
    impl: str = "xla_flash"
    distr: DistrConfig = field(default_factory=DistrConfig)
    # Tiles of the exact blockwise path; None → 128.
    block_q: int | None = None
    block_k: int | None = None
    # Decode split-K length; None → the tuner's (REPRO_TUNE; off:
    # min(128, cache length)).
    block_k_decode: int | None = None
    # Context parallelism: the mesh axis the sequence is ring-sharded over.
    # When set and the active mesh (``launch.mesh.set_mesh``) has that axis
    # at size > 1, the kernel impls dispatch to distributed.ring_attention:
    # Q/K/V shard on the sequence, KV rotates rank to rank, partial
    # (O, LSE) merge online.  Sequences shorter than ring size × 128 stay on
    # one device.
    context_axis: str | None = None
    # Serve-side fused-K̂ decode cache under a static permutation
    # (serve.kv_cache): the paged pool keeps K̂ (d/G* wide) and no raw K.
    distr_decode: bool = False

    def with_impl(self, impl: str) -> "AttentionConfig":
        return replace(self, impl=impl)

    def degraded(self, group_size: int) -> "AttentionConfig":
        """The overload-degradation dial (serve.degrade): this config with
        prefill switched onto DistrAttention at G* = ``group_size``.
        ``group_size <= 1`` returns the config unchanged.  The kernel impls
        degrade to the DistrAttention kernel, the plain ones to plain
        DistrAttention; every other field rides along."""
        if group_size <= 1:
            return self
        impl = "pallas_distr" if self.impl.startswith("pallas") else "distr"
        return replace(self, impl=impl, distr=replace(self.distr, group_size=group_size))


def _active_context_mesh(context_axis: str | None):
    """The active mesh when it carries ``context_axis`` at a size > 1, else
    None (no mesh, no such axis, or one of size 1: the single-device paths
    apply)."""
    if not context_axis:
        return None
    from repro_torch.launch.mesh import active_mesh

    mesh = active_mesh()
    if mesh is None or context_axis not in mesh.axis_names:
        return None
    return mesh if int(mesh.shape[context_axis]) > 1 else None


def _ring_dispatch(cfg: AttentionConfig, q, k, v, *, causal: bool, scale, proj):
    """The ring's output when context parallelism applies (a kernel impl,
    self-attention, an active context mesh, N ≥ ring size × 128), else None
    to fall through to the single-device paths."""
    if cfg.impl not in ("pallas_flash", "pallas_distr") or q.shape[2] != k.shape[2]:
        return None
    mesh = _active_context_mesh(cfg.context_axis)
    if mesh is None:
        return None
    from repro_torch.distributed import ring_attention as ring

    if q.shape[2] < int(mesh.shape[cfg.context_axis]) * ring.MIN_RING_SHARD:
        return None
    if cfg.impl == "pallas_flash":
        return ring.ring_flash_attention(q, k, v, mesh, axis=cfg.context_axis, causal=causal,
                                         scale=scale)
    return ring.ring_distr_attention(q, k, v, cfg.distr, mesh, axis=cfg.context_axis,
                                     causal=causal, scale=scale, proj=proj)


def resolve_attention_blocks(cfg: AttentionConfig, *, d: int, n_q: int, n_k: int | None = None,
                             dtype: str = "float32", causal: bool = False, bwd: bool = False,
                             device="cuda") -> BlockSizes:
    """The ``BlockSizes`` one dispatch site runs.

    ``pallas_flash``: the kernels' compiled tiles (the config's ints do not
    reach the kernel).  ``xla_flash``: the config's ints, a free one 128.
    The distr impls: ``DistrConfig.block_q`` if set, else the tuner's
    under (impl kind, backend, dtype, d, G*, seq-bucket, causal), with the
    kernel's KV tile.  ``bwd=True`` (training's warm-up) also fills the
    backward kernels' tiles.  Under ``REPRO_TUNE=measure`` a key not yet
    cached is swept on ``device`` here.

    Under context parallelism (``cfg.context_axis`` naming an axis of the
    active mesh, a kernel impl, self-attention long enough for the ring)
    the sequence bucket is the length one rank streams,
    ``context_shard_len(n, P)``, as ``distributed.ring_attention`` resolves
    it at dispatch.
    """
    from repro_torch.tune.autotune import resolve_block_sizes

    n_k = n_k if n_k is not None else n_q
    n = max(n_q, n_k)
    mesh = _active_context_mesh(cfg.context_axis)
    if mesh is not None and cfg.impl.startswith("pallas") and n_q == n_k:
        from repro_torch.distributed.ring_attention import MIN_RING_SHARD, context_shard_len

        p = int(mesh.shape[cfg.context_axis])
        if n_q >= p * MIN_RING_SHARD:
            n = context_shard_len(n_q, p)
    kw = dict(d=d, n=n, dtype=dtype, causal=causal, bwd=bwd, device=device)
    if cfg.impl in ("distr", "pallas_distr"):
        return resolve_block_sizes("distr" if cfg.impl == "pallas_distr" else "xla_distr",
                                   group_size=cfg.distr.group_size,
                                   block_q=cfg.distr.block_q, **kw)
    if cfg.impl == "pallas_flash":
        return resolve_block_sizes("flash", **kw)
    return BlockSizes.from_pair(cfg.block_q or DEFAULT_BLOCK, cfg.block_k or DEFAULT_BLOCK)


def attend(q, k, v, cfg: AttentionConfig, *, causal: bool = False,
           scale: float | None = None,
           proj: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head attention with the configured implementation.

    q: (B, Hq, N, d); k, v: (B, Hkv, Nk, d).  ``proj`` is the LSH projection
    of the distr impls (None draws it from ``cfg.distr.proj_seed``).

    When ``cfg.context_axis`` names an axis of the active mesh, the kernel
    impls run ring sequence-parallel (``distributed.ring_attention``): the
    same kernels, one sequence shard a rank, KV rotating around the ring.
    """
    ring_out = _ring_dispatch(cfg, q, k, v, causal=causal, scale=scale, proj=proj)
    if ring_out is not None:
        return ring_out
    if cfg.impl == "reference":
        return reference_attention(q, k, v, causal=causal, scale=scale)
    if cfg.impl == "xla_flash":
        return blockwise_flash_reference(
            q, k, v, block_q=cfg.block_q or DEFAULT_BLOCK,
            block_k=cfg.block_k or DEFAULT_BLOCK, causal=causal, scale=scale,
        )
    if cfg.impl == "distr":
        return distr_attention(q, k, v, cfg.distr, causal=causal, scale=scale, proj=proj)
    if cfg.impl in ("pallas_flash", "pallas_distr"):
        from repro_torch.kernels import ops

        if cfg.impl == "pallas_flash":
            return ops.flash_attention(q, k, v, causal=causal, scale=scale)
        return ops.distr_attention(q, k, v, cfg.distr, causal=causal,
                                   scale=scale, proj=proj)
    raise ValueError(f"unknown attention impl {cfg.impl!r}; choose from {IMPLS}")


def attend_decode(q, k, v, cfg: AttentionConfig, *,
                  lengths: torch.Tensor | None = None,
                  k_fused: torch.Tensor | None = None,
                  perm: torch.Tensor | None = None, group_size: int = 1,
                  scale: float | None = None,
                  block_tables: torch.Tensor | None = None) -> torch.Tensor:
    """Decode-path attention with per-slot live ``lengths``: every impl
    except ``reference`` runs a split-K decode kernel.

    Contiguous caches (``block_tables=None``): k, v are (B, Hkv, S, d) and
    the op is ``kernels.ops.decode_attention``.  Paged caches
    (``block_tables`` (B, max_blocks)): k, v are shared (P, Hkv, bs, d)
    pools read through the table (``kernels.ops.paged_decode_attention``),
    and a multi-token q is banded — query token i sees positions
    < length − (q_len − 1 − i) — which is what chunked prefill rides.

    q: (B, Hq, q_len, d).  The fused-K̂ variant takes ``k_fused`` (the
    d/G*-wide cache or pool) + ``perm`` (Hkv, d) + ``group_size``; ``k``
    may then be None.  ``scale`` refers to the full head dim (default 1/√d
    from V).
    """
    if cfg.impl not in IMPLS:
        raise ValueError(f"unknown attention impl {cfg.impl!r}; choose from {IMPLS}")
    scale = float(scale) if scale is not None else 1.0 / (v.shape[-1] ** 0.5)
    if block_tables is not None:
        return _attend_decode_paged(q, k, v, cfg, lengths=lengths, k_fused=k_fused,
                                    perm=perm, group_size=group_size, scale=scale,
                                    block_tables=block_tables)
    if cfg.impl == "reference":
        nk = (k_fused if k_fused is not None else k).shape[2]
        kv_mask = (
            torch.arange(nk, device=q.device)[None, :] < lengths[:, None]
            if lengths is not None else None
        )
        if k_fused is not None:
            q_s = grouping.sample_q_heads(q, perm, group_size)
            return reference_attention(q_s, k_fused.to(q_s.dtype), v.to(q_s.dtype),
                                       scale=scale, kv_mask=kv_mask)
        return reference_attention(q, k.to(q.dtype), v.to(q.dtype),
                                   scale=scale, kv_mask=kv_mask)
    from repro_torch.kernels import ops

    return ops.decode_attention(
        q, k, v, lengths=lengths, k_fused=k_fused, perm=perm,
        group_size=group_size, scale=scale, block_k=cfg.block_k_decode,
    )


def _attend_decode_paged(q, k, v, cfg, *, lengths, k_fused, perm, group_size, scale,
                         block_tables):
    if cfg.impl == "reference":
        # The banded oracle over the pools gathered into contiguous caches
        # (the materialisation the kernel path avoids).
        from repro_torch.kernels.paged_decode import gather_blocks

        capacity = block_tables.shape[1] * v.shape[2]
        # Like the kernel op, lengths are not clamped to capacity.
        lengths = (lengths.to(torch.int64) if lengths is not None else
                   torch.full((q.shape[0],), capacity, dtype=torch.int64, device=q.device))
        q_len = q.shape[2]
        col = torch.arange(capacity, device=q.device)[None, None, :]
        row = torch.arange(q_len, device=q.device)[None, :, None]
        band = col < (lengths[:, None, None] - (q_len - 1 - row))  # (B, q_len, Nk)
        v_c = gather_blocks(v, block_tables).to(q.dtype)
        if k_fused is not None:
            q_r = grouping.sample_q_heads(q, perm, group_size)
            k_c = gather_blocks(k_fused, block_tables).to(q.dtype)
        else:
            q_r = q
            k_c = gather_blocks(k, block_tables).to(q.dtype)
        outs = [reference_attention(q_r[:, :, i:i + 1], k_c, v_c, scale=scale,
                                    kv_mask=band[:, i]) for i in range(q_len)]
        return torch.cat(outs, dim=2)
    from repro_torch.kernels import ops

    return ops.paged_decode_attention(
        q, k, v, block_tables=block_tables, lengths=lengths, k_fused_pool=k_fused,
        perm=perm, group_size=group_size, scale=scale,
    )
