"""DistrAttention — block-wise grouped-dimension attention (paper §3).

Plain PyTorch; the CUDA kernel (``repro_torch.kernels.distr_attention``)
computes the same math fused.

Q is split into row blocks of ``block_q``.  Each block hashes its d columns
with LSH (over R^block_q), sorts, and derives one permutation; the
permutation samples the block's Q columns and fuses (sums) every K row it
meets.  Scores contract over d/G*; softmax and the PV product keep the full
context and the full value width.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.core import grouping, lsh
from repro_torch.core.flash_reference import NEG_INF

DEFAULT_BLOCK = 128


@dataclass(frozen=True)
class DistrConfig:
    """The paper's tunables.

    group_size: the sampling rate G* (2, 4, 8, 16); d_eff = d / G*.
    block_q / block_k: the (l, m) blocks of §3.3.1: block_q is also the
      LSH permutation granularity, block_k the kernel's key tile (one it
      compiles, ``tune.autotune.compiled_tiles``; the plain impl has none).
      ``None`` is "auto": resolved by the block-size tuner
      (``repro_torch.tune``, ``REPRO_TUNE``) where the shape is known, a
      partial pin taking the static value for the free one; with no shape
      block_q is 128 and block_k stays None (the kernel's static tile).
    block_k_bwd: key tile of the backward dQ̂ and dK/dV kernels.  ``None``
      is "auto": the forward's block_k (where the kernel compiles it), or
      under ``REPRO_TUNE=measure`` each kernel's own pick.  block_q has no
      backward override: it is the grouping, and stays pinned.
    estimator: "sample" (paper) | "mean" (beyond-paper).
    shared_kv_perm: one permutation per KV group, hashed from the group's
      mean query block (beyond-paper).
    proj_seed: seed of the fixed LSH projection.
    hash_method: "sign_gray" (paper) | "proj_morton".
    """

    group_size: int = 2
    block_q: int | None = 128
    block_k: int | None = None
    block_k_bwd: int | None = None
    estimator: str = "sample"
    shared_kv_perm: bool = False
    proj_seed: int = 0
    hash_method: str = "sign_gray"

    def d_eff(self, d: int) -> int:
        return d // self.group_size

    def resolved(self, d: int | None = None, n: int | None = None, *,
                 dtype: str = "float32", causal: bool = False, xla: bool = True,
                 device="cuda") -> "DistrConfig":
        """Fill ``None`` blocks; explicit ints pass through.  With no shape
        block_q becomes 128 (block_k stays as it is).  With one (head dim
        ``d``, sequence length ``n``, ``dtype``): a partial pin takes the
        static value for the free one (128, or the kernel's static keys),
        and both None go through the tuner, kernel ``xla_distr`` for the
        plain impl (``xla``: no KV tile, block_k stays None) or the pair
        ``distr_fwd`` for the kernel, timed on ``device`` under
        ``REPRO_TUNE=measure``."""
        if self.block_q is not None and (self.block_k is not None or xla or d is None):
            return self
        if d is None or n is None:
            return replace(self, block_q=self.block_q or DEFAULT_BLOCK)
        from repro_torch.tune.autotune import resolve_block_sizes

        bs = resolve_block_sizes("xla_distr" if xla else "distr", d=d, n=n, dtype=dtype,
                                 group_size=self.group_size, causal=causal, device=device,
                                 block_q=self.block_q, block_k=self.block_k)
        return replace(self, block_q=bs.block_q, block_k=None if xla else bs.block_k)


def default_projection(cfg: DistrConfig, device=None) -> torch.Tensor:
    """The fixed LSH projection drawn from ``cfg.proj_seed``."""
    gen = torch.Generator().manual_seed(cfg.proj_seed)
    proj = lsh.make_projection(gen, cfg.resolved().block_q)
    return proj.to(device) if device is not None else proj


def resolve_at(cfg: DistrConfig, q: torch.Tensor, k: torch.Tensor, proj, *, causal: bool,
               xla: bool):
    """(cfg with ``block_q`` resolved at this call's shape, the projection
    to hash with).  A tuned ``block_q`` redraws a given projection of
    another length from ``proj_seed`` (the models hold the one drawn at
    128); a pinned ``block_q`` must match the projection it is given."""
    from repro_torch.tune.cache import dtype_str

    tuned = cfg.block_q is None
    cfg = cfg.resolved(q.shape[-1], max(q.shape[2], k.shape[2]), dtype=dtype_str(q),
                       causal=causal, xla=xla, device=q.device)
    if proj is not None and proj.shape[-1] != cfg.block_q:
        if not tuned:
            raise ValueError(f"LSH projection over {proj.shape[-1]} rows given for "
                             f"block_q={cfg.block_q}")
        proj = None
    return cfg, proj


def pad_to_multiple(x: torch.Tensor, block: int, dim: int) -> torch.Tensor:
    """Zero-pad ``dim`` of x up to a multiple of ``block``."""
    pad = (-x.shape[dim]) % block
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def compute_block_permutations(q: torch.Tensor, cfg: DistrConfig,
                               proj: torch.Tensor | None = None) -> torch.Tensor:
    """Per-Q-block LSH permutations.

    q: (B, H, N, d) with N divisible by block_q → perms (B, H, nq, d) int64.
    """
    cfg = cfg.resolved()
    b, h, n, d = q.shape
    nq = n // cfg.block_q
    if proj is None:
        proj = default_projection(cfg, q.device)
    blocks = q.reshape(b, h, nq, cfg.block_q, d)
    return lsh.lsh_permutation(blocks, proj, cfg.hash_method)


def block_permutations(qp: torch.Tensor, cfg: DistrConfig, proj, hkv: int):
    """Permutations for a block_q-padded q, honouring ``shared_kv_perm``."""
    b, hq, n_pad, d = qp.shape
    if not cfg.shared_kv_perm:
        return compute_block_permutations(qp, cfg, proj)
    r = hq // hkv
    q_mean = qp.reshape(b, hkv, r, n_pad, d).mean(dim=2)
    perms = compute_block_permutations(q_mean, cfg, proj)  # (b, hkv, nq, d)
    nq = perms.shape[2]
    return perms[:, :, None].expand(b, hkv, r, nq, d).reshape(b, hq, nq, d)


def sample_q(q_blocks: torch.Tensor, perms: torch.Tensor,
             cfg: DistrConfig) -> torch.Tensor:
    """Q̂ from q blocks (..., nq, block_q, d) under per-block perms."""
    if cfg.estimator == "sample":
        return grouping.sample_columns(q_blocks, perms, cfg.group_size)
    if cfg.estimator == "mean":
        return grouping.mean_columns(q_blocks, perms, cfg.group_size)
    raise ValueError(f"unknown estimator {cfg.estimator!r}")


def distr_attention(q, k, v, cfg: DistrConfig = DistrConfig(), *,
                    causal: bool = False, scale: float | None = None,
                    proj: torch.Tensor | None = None,
                    q_exact: torch.Tensor | None = None,
                    k_exact: torch.Tensor | None = None) -> torch.Tensor:
    """Block-wise DistrAttention, GQA-aware.

    q: (B, Hq, N, d); k: (B, Hkv, Nk, d); v: (B, Hkv, Nk, d_v) with
    Hq % Hkv == 0; d_v may differ from d (MLA).

    ``q_exact`` (B, Hq, N, d_e) / ``k_exact`` (B, Hkv, Nk, d_e): an extra
    feature slice whose scores are computed exactly, not grouped, and added
    before the scale, the masks and the softmax: MLA's RoPE dimensions,
    whose rotation pairs a fusion of columns would break.
    """
    cfg, proj = resolve_at(cfg, q, k, proj, causal=causal, xla=True)
    b, hq, n, d = q.shape
    dv = v.shape[-1]
    n_kv, nk = k.shape[1], k.shape[2]
    r = hq // n_kv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    g, dg = cfg.group_size, cfg.d_eff(d)

    qp = pad_to_multiple(q, cfg.block_q, dim=2)
    n_pad = qp.shape[2]
    nq = n_pad // cfg.block_q
    if proj is None:
        proj = default_projection(cfg, q.device)
    perms = block_permutations(qp, cfg, proj, n_kv)  # (b, hq, nq, d)
    q_hat = sample_q(qp.reshape(b, hq, nq, cfg.block_q, d), perms, cfg)
    if q_exact is not None:
        de = q_exact.shape[-1]
        qe = pad_to_multiple(q_exact, cfg.block_q, dim=2).reshape(b, hq, nq, cfg.block_q, de)

    kj = torch.arange(nk, device=q.device)[None, :]
    outs = []
    for iq in range(nq):
        perm_g = perms[:, :, iq].reshape(b, n_kv, r, d)
        k_hat = grouping.fuse_columns(k[:, :, None], perm_g, g)  # (b,hkv,r,nk,dg)
        qg = q_hat[:, :, iq].reshape(b, n_kv, r, cfg.block_q, dg)
        s = torch.einsum("bgrld,bgrnd->bgrln", qg.float(), k_hat.float())
        if q_exact is not None:
            qe_g = qe[:, :, iq].reshape(b, n_kv, r, cfg.block_q, de)
            s = s + torch.einsum("bgrld,bgnd->bgrln", qe_g.float(), k_exact.float())
        s = s * scale
        if causal:
            qi = iq * cfg.block_q + torch.arange(cfg.block_q, device=q.device)[:, None]
            s = torch.where(kj <= qi, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrln,bgnd->bgrld", p.to(q.dtype).float(), v.float())
        outs.append(o.reshape(b, hq, cfg.block_q, dv).to(q.dtype))
    return torch.cat(outs, dim=2)[:, :, :n]


def distr_scores(q: torch.Tensor, k: torch.Tensor, cfg: DistrConfig = DistrConfig(), *,
                 scale: float = 1.0, proj: torch.Tensor | None = None) -> torch.Tensor:
    """The approximate score matrix Ŝ alone (the paper's error study,
    Tables 3-4).  q: (B, H, N, d); k: (B, Hkv, Nk, d), its heads repeated
    over the query heads when Hkv < H → (B, H, N, Nk) f32.  One fused K̂
    per Q-block permutation; padded Q rows are cut off."""
    cfg = cfg.resolved()
    b, h, n, d = q.shape
    if k.shape[1] != h:
        k = k.repeat_interleave(h // k.shape[1], dim=1)
    qp = pad_to_multiple(q, cfg.block_q, dim=2)
    nq = qp.shape[2] // cfg.block_q
    if proj is None:
        proj = default_projection(cfg, q.device)
    perms = compute_block_permutations(qp, cfg, proj)  # (b, h, nq, d)
    q_hat, k_hat = grouping.reduce_qk(qp.reshape(b, h, nq, cfg.block_q, d),
                                      k[:, :, None].float(), perms, cfg.group_size,
                                      cfg.estimator)
    s = torch.einsum("bhqld,bhqnd->bhqln", q_hat.float(), k_hat) * scale
    return s.reshape(b, h, nq * cfg.block_q, k.shape[2])[:, :, :n]
