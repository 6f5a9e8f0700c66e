"""DistrAttention forward (paper §3.3 fused into FA-2): the CUDA kernel's
wrapper and its plain PyTorch version.

The kernel (``csrc/distr_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/distr_attention.py::_distr_kernel``.  Q̂ arrives sampled
and pre-scaled, with one permutation per block_q rows.  In bf16 it runs on
the tensor cores (``csrc/distr_fwd_tc.cuh``) as the exact product Q̃·Kᵀ,
Q̂ scattered through the permutation (``scatter_q_hat``), so its scores
and LSE agree with the f32 K̂ the plain version and the backward use.  f32
runs an FMA tile that fuses K̂ in f32.  A CTA holds ROW_TILE rows and
walks the keys in tiles of ``block_k``, one the sources compile
(``tune.autotune.compiled_tiles``), the static one when None.
``launches`` counts the wrapper's kernel launches, ``tile_launches`` them
by (d, ROW_TILE, block_k).
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.core.flash_reference import NEG_INF
from repro_torch.kernels import build
from repro_torch.tune.autotune import check_tile
from repro_torch.tune.cache import dtype_str
from repro_torch.utils.counting import charged

launches = 0
tile_launches: Counter = Counter()
ROW_TILE = 64  # query rows per CUDA block; must divide block_q


def fuse_k_columns(k: torch.Tensor, perm: torch.Tensor, group_size: int) -> torch.Tensor:
    """The paper's fusion in f32: k (..., m, d), perm (..., d) → (..., m, d/G*)."""
    d = k.shape[-1]
    idx = perm.to(torch.int64).unsqueeze(-2).expand(*k.shape[:-1], d)
    permuted = torch.gather(k.float(), -1, idx)
    return permuted.reshape(*k.shape[:-1], d // group_size, group_size).sum(dim=-1)


def scatter_q_hat(q_hat: torch.Tensor, perm: torch.Tensor, group_size: int,
                  block_q: int) -> torch.Tensor:
    """Q̃ with Q̃[..., perm[g·G* + u]] = Q̂[..., g] for u < G*, in each
    permutation block: Q̃·Kᵀ = Q̂·K̂ᵀ term for term, since every column of K
    lies in one group.  The bf16 forward kernel builds Q̃ in shared memory,
    the bf16 backward in device memory (``distr_expand_q_kernel``); this
    plain version is for the tests.  q_hat (BHq, N, d/G*),
    perm (BHq, N/block_q, d) → (BHq, N, d), q_hat's dtype."""
    bhq, n, _ = q_hat.shape
    d = perm.shape[-1]
    src = q_hat.repeat_interleave(group_size, dim=-1).reshape(bhq, n // block_q, block_q, d)
    idx = perm.to(torch.int64)[:, :, None, :].expand_as(src)
    return torch.zeros_like(src).scatter_(-1, idx, src).reshape(bhq, n, d)


def distr_attention_plain(q_hat, k, v, perm, *, q_per_kv: int, causal: bool,
                          group_size: int, block_q: int, kv_len: int,
                          return_lse: bool = False, block_k: int | None = None):
    """Plain version of the kernel (the key tile ``block_k`` is ignored).

    q_hat: (BHq, N, d/G*) sampled, pre-scaled; k, v: (BHkv, Nk, d);
    perm: (BHq, N/block_q, d) int.  Returns ``o`` (BHq, N, d) or ``(o, lse)``.
    """
    bhq, n, dg = q_hat.shape
    bhkv, nk, d = k.shape
    nq = n // block_q
    kg = k.float()[:, None, None].expand(bhkv, q_per_kv, nq, nk, d)
    k_hat = fuse_k_columns(kg, perm.reshape(bhkv, q_per_kv, nq, d), group_size)
    qb = q_hat.float().reshape(bhkv, q_per_kv, nq, block_q, dg)
    s = torch.einsum("grqld,grqmd->grqlm", qb, k_hat)
    col = torch.arange(nk, device=q_hat.device)
    mask = (col < kv_len)[None, :]
    if causal:
        row = torch.arange(n, device=q_hat.device).reshape(nq, block_q, 1)
        mask = mask & (col <= row)
    else:
        mask = mask.expand(nq, block_q, nk)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l == 0, 1.0, l)
    o = torch.einsum("grqlm,gmd->grqld", p, v.float()) / denom
    o = o.reshape(bhq, n, v.shape[-1]).to(q_hat.dtype)
    if not return_lse:
        return o
    lse = torch.where(l == 0, NEG_INF, m + torch.log(denom))
    return o, lse.reshape(bhq, n)


def _fwd_work(q_hat, k, v, perm, *, q_per_kv: int, causal: bool, group_size: int,
              block_q: int, kv_len: int, return_lse: bool = False,
              block_k: int | None = None) -> dict:
    from repro_torch.kernels.ops import attention_work

    bhq, n, _ = q_hat.shape
    return attention_work(1, bhq, k.shape[0], n, kv_len, k.shape[-1], causal=causal,
                          group_size=group_size, block_q=block_q, lse=return_lse)["fwd"]


@charged("distr_fwd", _fwd_work)
def distr_attention_kernel_call(q_hat, k, v, perm, *, q_per_kv: int,
                                causal: bool, group_size: int, block_q: int,
                                kv_len: int, return_lse: bool = False,
                                block_k: int | None = None):
    """Launch the DistrAttention kernel.  Shapes as for the plain version;
    N is a multiple of block_q, ROW_TILE divides block_q, and each row of
    ``perm`` is a permutation of range(d); ``block_k`` a compiled key tile
    (None: the static one), checked on every device.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    global launches
    rows, bk = check_tile("distr_fwd", (None, block_k), d=k.shape[-1], dtype=dtype_str(q_hat))
    if q_hat.device.type == "cpu":
        return distr_attention_plain(
            q_hat, k, v, perm, q_per_kv=q_per_kv, causal=causal,
            group_size=group_size, block_q=block_q, kv_len=kv_len,
            return_lse=return_lse,
        )
    if q_hat.device.type == "meta":  # the dry run: shapes, no launch
        bhq, n, _ = q_hat.shape
        o = torch.empty((bhq, n, k.shape[-1]), device=q_hat.device, dtype=q_hat.dtype)
        lse = torch.empty((bhq, n), device=q_hat.device, dtype=torch.float32)
        return (o, lse) if return_lse else o
    perm = perm.to(torch.int32).contiguous()
    build.require_cuda(q_hat, k, v, perm)
    bhq, n, dg = q_hat.shape
    bhkv, nk, d = k.shape
    if (bhq != bhkv * q_per_kv or k.shape != v.shape or dg * group_size != d
            or d not in build.HEAD_DIMS or n % block_q or block_q % ROW_TILE
            or perm.shape != (bhq, n // block_q, d)):
        raise ValueError(
            f"distr kernel shapes q_hat={tuple(q_hat.shape)} k={tuple(k.shape)} "
            f"perm={tuple(perm.shape)} block_q={block_q} (needs {ROW_TILE} | block_q)"
        )
    if not (k.dtype == v.dtype == q_hat.dtype):
        raise TypeError("distr kernel wants q_hat, k, v of one dtype")
    if not 0 <= kv_len <= nk:
        raise ValueError(f"kv_len={kv_len} outside [0, {nk}]")
    o = torch.empty((bhq, n, d), device=q_hat.device, dtype=q_hat.dtype)
    lse = (torch.empty((bhq, n), device=q_hat.device, dtype=torch.float32)
           if return_lse else None)
    if n:
        err = build.lib().repro_distr_fwd(
            q_hat.data_ptr(), k.data_ptr(), v.data_ptr(), perm.data_ptr(),
            o.data_ptr(), lse.data_ptr() if lse is not None else None,
            build.dtype_code(q_hat), bhq, n, nk, kv_len, d, group_size, block_q,
            n // block_q, q_per_kv, int(causal), rows, bk, build.stream_handle(q_hat),
        )
        build.check(err, "repro_distr_fwd")
        launches += 1
        tile_launches[(d, rows, bk)] += 1
    return (o, lse) if return_lse else o
