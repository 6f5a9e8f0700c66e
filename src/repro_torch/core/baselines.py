"""Approximate-attention baselines the paper evaluates against (§4.1), as
plain PyTorch functions on tensors (the reference runs them as plain JAX).

* ``hydra_attention`` — Hydra Attention (Bolya et al. 2022): cosine
  kernel, one global (or causal cumulative) context, O(N·d).
* ``focused_linear_attention`` — Flatten Transformer (Han et al. 2023):
  focused (power-normalised) feature map and linear attention, O(N·d²).
* ``lowrank_attention`` — Primal/Linformer-style: K and V projected over
  the sequence to a fixed rank r, softmax over r, O(N·r·d).
* ``sampled_attention`` — HyperAttention-flavoured: softmax over a uniform
  sample of key positions.

q: (B, Hq, N, d); k, v: (B, Hkv, N, d), K and V heads repeated over the
query heads under GQA.  The two random baselines draw their projection or
sample from ``generator`` (None: a CPU generator seeded 0, so a CPU and a
CUDA call draw alike); ``proj=`` / ``idx=`` pass a draw in instead, as the
tests pass the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import torch


def _expand_kv(q, k, v):
    hq, hkv = q.shape[1], k.shape[1]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    return k, v


def _generator(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def hydra_attention(q, k, v, *, causal: bool = False, scale=None):
    """O(N·d): normalise, aggregate k ⊙ v globally (or causally by cumsum)."""
    k, v = _expand_kv(q, k, v)
    qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
    kn = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)
    kv = kn * v
    ctx = torch.cumsum(kv, dim=2) if causal else kv.sum(dim=2, keepdim=True)
    return (qn * ctx).to(q.dtype)


def focused_linear_attention(q, k, v, *, causal: bool = False, scale=None,
                             focus_p: float = 3.0):
    """Flatten-style focused linear attention."""
    k, v = _expand_kv(q, k, v)

    def feat(x):
        x = torch.relu(x) + 1e-6
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        xp = x ** focus_p
        return xp / (torch.linalg.vector_norm(xp, dim=-1, keepdim=True) + 1e-6) * norm

    qf, kf, vf = feat(q.float()), feat(k.float()), v.float()
    if causal:
        kv = torch.cumsum(kf[..., :, None] * vf[..., None, :], dim=2)
        z = torch.cumsum(kf, dim=2)
        num = torch.einsum("bhnd,bhndp->bhnp", qf, kv)
        den = torch.einsum("bhnd,bhnd->bhn", qf, z)[..., None]
    else:
        kv = torch.einsum("bhnd,bhnp->bhdp", kf, vf)
        z = kf.sum(dim=2)
        num = torch.einsum("bhnd,bhdp->bhnp", qf, kv)
        den = torch.einsum("bhnd,bhd->bhn", qf, z)[..., None]
    return (num / den.clamp(min=1e-6)).to(q.dtype)


def lowrank_attention(q, k, v, *, rank: int = 64, causal: bool = False, scale=None,
                      generator: torch.Generator | None = None,
                      proj: torch.Tensor | None = None):
    """Linformer/Primal-style: K and V projected over the sequence to rank
    r = min(rank, N) by ``proj`` (N, r), by default N(0, 1) / sqrt(N / r)
    drawn from ``generator``.  Sequence projection cannot be causal; as in
    the reference, ``causal`` leaves the projected scores unmasked."""
    k, v = _expand_kv(q, k, v)
    n, d = q.shape[2], q.shape[3]
    r = min(rank, n)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if proj is None:
        proj = torch.randn((n, r), generator=_generator(generator)) / (n / r) ** 0.5
    proj = proj.to(device=q.device, dtype=torch.float32)
    kp = torch.einsum("bhnd,nr->bhrd", k.float(), proj)
    vp = torch.einsum("bhnd,nr->bhrd", v.float(), proj)
    s = torch.einsum("bhnd,bhrd->bhnr", q.float(), kp) * scale
    return torch.einsum("bhnr,bhrd->bhnd", torch.softmax(s, dim=-1), vp).to(q.dtype)


def sampled_attention(q, k, v, *, keep: int = 256, causal: bool = False, scale=None,
                      generator: torch.Generator | None = None,
                      idx: torch.Tensor | None = None):
    """HyperAttention-flavoured: softmax over ``idx``, m = min(keep, N)
    sorted key positions, by default drawn without replacement from
    ``generator``.  Causal: a row sees the sampled keys at or before it; a
    row that sees none attends uniformly over the sample."""
    k, v = _expand_kv(q, k, v)
    n, d = q.shape[2], q.shape[3]
    m = min(keep, n)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if idx is None:
        idx = torch.randperm(n, generator=_generator(generator))[:m]
    idx = torch.sort(torch.as_tensor(idx, dtype=torch.int64).to(q.device)).values
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k[:, :, idx].float()) * scale
    if causal:
        mask = idx[None, :] <= torch.arange(n, device=q.device)[:, None]
        s = torch.where(mask, s, -1e30)
        s = torch.where(mask.any(-1, keepdim=True), s, 0.0)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p, v[:, :, idx].float()).to(q.dtype)


BASELINES = {
    "hydra": hydra_attention,
    "flatten": focused_linear_attention,
    "primal_lowrank": lowrank_attention,
    "hyper_sampled": sampled_attention,
}
