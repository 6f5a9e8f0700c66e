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
decode split (``block_k_decode=None``), DistrAttention's ``block_q`` and
key tile (``DistrConfig.block_q`` / ``block_k`` = None), the flash
kernel's tile and ``xla_flash``'s blocks (``AttentionConfig.block_q`` /
``block_k`` = None), the backward kernels' tiles (when the backward runs)
and the paged pool's block size (chosen by ``PagedServeEngine``; the paged
decode path splits once per pool block).  Unset (``off``) they are the
static values: 128, the decode split ``min(128, cache length)``, and each
kernel's static tile (``tune.autotune.static_tile``).
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
    # Tiles of the exact paths: xla_flash's blocks, or the flash kernel's
    # tile (one it compiles).  None → the tuner's (REPRO_TUNE; off: 128, or
    # the kernel's static tile); a partial pin takes the static value for
    # the free one.
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


def ring_mesh(cfg: AttentionConfig, n: int):
    """The active context mesh when self-attention over ``n`` positions takes
    the ring (a kernel impl, an active context mesh, N ≥ ring size ×
    128), else None."""
    if cfg.impl not in ("pallas_flash", "pallas_distr"):
        return None
    mesh = _active_context_mesh(cfg.context_axis)
    if mesh is None:
        return None
    from repro_torch.distributed.ring_attention import MIN_RING_SHARD

    return mesh if n >= int(mesh.shape[cfg.context_axis]) * MIN_RING_SHARD else None


def _ring_dispatch(cfg: AttentionConfig, q, k, v, *, causal: bool, scale, proj):
    """The ring's output when context parallelism applies (``ring_mesh``
    over self-attention), else None to fall through to the single-device
    paths."""
    if q.shape[2] != k.shape[2]:
        return None
    mesh = ring_mesh(cfg, q.shape[2])
    if mesh is None:
        return None
    from repro_torch.distributed import ring_attention as ring

    if cfg.impl == "pallas_flash":
        return ring.ring_flash_attention(q, k, v, mesh, axis=cfg.context_axis, causal=causal,
                                         scale=scale, blocks=_pinned_blocks(cfg, q))
    return ring.ring_distr_attention(q, k, v, cfg.distr, mesh, axis=cfg.context_axis,
                                     causal=causal, scale=scale, proj=proj)


def _pinned_blocks(cfg: AttentionConfig, q) -> BlockSizes | None:
    """The flash kernel's tile the config pins (a partial pin with the
    static tile for the free one), or None for the tuner's."""
    if cfg.block_q is None and cfg.block_k is None:
        return None
    from repro_torch.tune.autotune import static_tile
    from repro_torch.tune.cache import dtype_str

    static = static_tile("flash_fwd", d=q.shape[-1], dtype=dtype_str(q))
    return BlockSizes.from_pair(cfg.block_q or static[0], cfg.block_k or static[1])


def resolve_attention_blocks(cfg: AttentionConfig, *, d: int, n_q: int, n_k: int | None = None,
                             dtype: str = "float32", causal: bool = False, bwd: bool = False,
                             device="cuda", heads: tuple[int, int] = (1, 1)) -> BlockSizes:
    """The ``BlockSizes`` one dispatch site runs.

    Explicit ints in the config win; a partial pin takes the static value
    for the free one (``pallas_flash``: the kernel's static tile;
    ``xla_flash``: 128); both None resolve through the tuner under (impl
    kind, backend, dtype, d, G*, seq-bucket, causal).  The distr impls:
    ``DistrConfig``'s blocks, resolved alike (``DistrConfig.resolved``).
    ``bwd=True`` (training's warm-up) also fills the backward kernels'
    tiles, those the backward will run: swept under ``measure`` (the distr
    keys with block_q pinned), else the static ones.  Under
    ``REPRO_TUNE=measure`` a key not yet cached is swept on ``device``
    here, its inputs of ``heads`` (hq, hkv).

    Under context parallelism (``cfg.context_axis`` naming an axis of the
    active mesh, a kernel impl, self-attention long enough for the ring)
    the sequence bucket is the length one rank streams,
    ``context_shard_len(n, P)``, as ``distributed.ring_attention`` resolves
    it at dispatch.
    """
    from repro_torch.tune.autotune import resolve_block_sizes

    n_k = n_k if n_k is not None else n_q
    n = max(n_q, n_k)
    mesh = ring_mesh(cfg, n_q) if n_q == n_k else None
    if mesh is not None:
        from repro_torch.distributed.ring_attention import context_shard_len

        n = context_shard_len(n_q, int(mesh.shape[cfg.context_axis]))
    kw = dict(d=d, n=n, dtype=dtype, causal=causal, bwd=bwd, device=device, heads=heads)
    if cfg.impl in ("distr", "pallas_distr"):
        dcfg = cfg.distr
        return resolve_block_sizes("distr" if cfg.impl == "pallas_distr" else "xla_distr",
                                   group_size=dcfg.group_size, block_q=dcfg.block_q,
                                   block_k=dcfg.block_k if cfg.impl == "pallas_distr" else None,
                                   **kw)
    if cfg.impl == "reference":  # the oracle: blocks unused
        return BlockSizes.from_pair(DEFAULT_BLOCK, DEFAULT_BLOCK)
    return resolve_block_sizes("flash" if cfg.impl == "pallas_flash" else "xla_flash",
                               block_q=cfg.block_q, block_k=cfg.block_k, **kw)


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
        from repro_torch.tune.cache import dtype_str

        bs = resolve_attention_blocks(cfg, d=q.shape[-1], n_q=q.shape[2], n_k=k.shape[2],
                                      dtype=dtype_str(q), causal=causal, device=q.device)
        return blockwise_flash_reference(q, k, v, block_q=bs.block_q, block_k=bs.block_k,
                                         causal=causal, scale=scale)
    if cfg.impl == "distr":
        return distr_attention(q, k, v, cfg.distr, causal=causal, scale=scale, proj=proj)
    if cfg.impl in ("pallas_flash", "pallas_distr"):
        from repro_torch.kernels import ops

        if cfg.impl == "pallas_flash":
            return ops.flash_attention(q, k, v, causal=causal, scale=scale,
                                       blocks=_pinned_blocks(cfg, q))
        return ops.distr_attention(q, k, v, cfg.distr, causal=causal,
                                   scale=scale, proj=proj)
    raise ValueError(f"unknown attention impl {cfg.impl!r}; choose from {IMPLS}")


def attend_decode(q, k, v, cfg: AttentionConfig, *,
                  lengths: torch.Tensor | None = None,
                  k_fused: torch.Tensor | None = None,
                  perm: torch.Tensor | None = None, group_size: int = 1,
                  scale: float | None = None,
                  block_tables: torch.Tensor | None = None, return_stats: bool = False):
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
    from V).  ``return_stats`` (contiguous caches) returns the unnormalised
    (o, m, l) of ``ops.decode_attention(return_stats=True)`` for a merge
    across ranks that hold other positions (``kernels.decode.merge_splits``).
    """
    if cfg.impl not in IMPLS:
        raise ValueError(f"unknown attention impl {cfg.impl!r}; choose from {IMPLS}")
    scale = float(scale) if scale is not None else 1.0 / (v.shape[-1] ** 0.5)
    if block_tables is not None:
        return _attend_decode_paged(q, k, v, cfg, lengths=lengths, k_fused=k_fused,
                                    perm=perm, group_size=group_size, scale=scale,
                                    block_tables=block_tables)
    if cfg.impl == "reference" and return_stats:
        return _decode_stats_plain(q, k, v, lengths, k_fused, perm, group_size, scale)
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
        return_stats=return_stats,
    )


def _decode_stats_plain(q, k, v, lengths, k_fused, perm, group_size, scale):
    """The reference impl's (o, m, l) over a contiguous cache: the decode
    kernel's plain version with the whole cache one split
    (``kernels.decode.decode_plain``, then ``reduce_splits``)."""
    from repro_torch.kernels import decode as decode_kernels
    from repro_torch.kernels.ops import _pack_gqa_rows

    if k_fused is not None:
        q, k = grouping.sample_q_heads(q, perm, group_size), k_fused
    b, hq, q_len, _ = q.shape
    nk, d = k.shape[2], v.shape[-1]
    if lengths is None:
        lengths = torch.full((b,), nk, dtype=torch.int32, device=q.device)
    o, m, l = decode_kernels.reduce_splits(*decode_kernels.decode_plain(
        _pack_gqa_rows(q, k.shape[1]), k, v, lengths, scale=scale, block_k=nk, q_len=q_len))
    return o.reshape(b, hq, q_len, d), m.reshape(b, hq, q_len), l.reshape(b, hq, q_len)


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
