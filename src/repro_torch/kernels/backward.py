"""FA-2-style attention backward: the CUDA kernels' wrappers and their plain
PyTorch versions.

The forward saves only the per-row logsumexp ``LSE``; every backward kernel
recomputes its score tiles from (Q, K) and masks P directly,
``P = where(mask, exp(S - LSE), 0)`` and ``dS = P ∘ (dO·Vᵀ − D)``, so a
fully masked row (LSE = -1e30) and a padded row (LSE = ``LSE_PAD``) get
exactly zero gradient.  Five kernels, each replacing the Pallas TPU kernel
of the same name in ``repro/kernels/backward.py``:

* ``delta``      — D = rowsum(dO ∘ O)                (``csrc/delta.cu``)
* ``flash_dq``   — dQ = Σ dS K · scale                (``csrc/flash_backward.cu``)
* ``flash_dkv``  — dV = Σ Pᵀ dO, dK = Σ dSᵀ Q · scale  (``csrc/flash_backward.cu``)
* ``distr_dq``   — dQ̂ = Σ dS K̂ in the sampled space   (``csrc/distr_backward.cu``)
* ``distr_dkv``  — dV, and dK̂ = dSᵀ Q̂ taken back to full-width dK
                   through each Q block's permutation (``csrc/distr_backward.cu``)

In bf16 the two distr wrappers hand their kernels a scratch Q̃, Q̂ expanded
to full width through each block's permutation (``scatter_q_hat`` is its
plain version): the kernels write it, then run the flash walks over it.

dK / dV come out per query head; ``ops._gqa_sum`` reduces each GQA group.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``launches[name]`` counts each wrapper's kernel launches,
``tile_launches[name]`` them by (d, rows, keys).

The dq and dkv kernels take their tile: the flash ones (block_q, block_k)
= (rows, keys) (dq: a CTA's query rows × a K/V tile's keys; dkv: a Q
tile's rows × a CTA's keys), the distr ones ``block_k`` alone (their rows
are fixed: 64 for dq, ``tune.autotune._dkv_rows(d)`` for dkv).  A tile is
one the sources compile (``tune.autotune.compiled_tiles``), the static one
when None, checked on every device; the plain versions ignore it.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build
from repro_torch.kernels.distr_attention import ROW_TILE, fuse_k_columns
from repro_torch.tune.autotune import check_tile
from repro_torch.tune.cache import dtype_str
from repro_torch.utils.counting import charged

# LSE of a padded query row: exp(s − LSE_PAD) ≡ 0, so the row adds nothing
# to dK / dV.  The kernels load it for rows at or past N.
LSE_PAD = 1e30

launches = {"delta": 0, "flash_dq": 0, "flash_dkv": 0, "distr_dq": 0, "distr_dkv": 0}
tile_launches = {name: Counter() for name in ("flash_dq", "flash_dkv", "distr_dq", "distr_dkv")}


def _mask(n: int, nk: int, kv_len: int, causal: bool, device) -> torch.Tensor:
    """(n, nk): key < kv_len, and key <= row when causal."""
    col = torch.arange(nk, device=device)[None, :]
    mask = (col < kv_len).expand(n, nk)
    if causal:
        mask = mask & (col <= torch.arange(n, device=device)[:, None])
    return mask


def _p_and_ds(s, mask, lse, delta, dp):
    """P from the saved LSE, then dS = P ∘ (dP − D).  All f32; ``lse`` and
    ``delta`` carry the row axis last but one of ``s``."""
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    return p, p * (dp - delta[..., None])


# ---------------------------------------------------------------------------
# D = rowsum(dO ∘ O)
# ---------------------------------------------------------------------------


def delta_plain(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """o, do: (BHq, N, d) → (BHq, N) f32."""
    return (o.float() * do.float()).sum(dim=-1)


def _delta_work(o, do) -> dict:
    from repro_torch.kernels.ops import delta_work

    return delta_work(o.shape[0] * o.shape[1], o.shape[2], o.element_size())


def _flash_work(part: str):
    def work(q, k, v, do, lse, delta, *, q_per_kv: int, scale: float, causal: bool,
             kv_len: int, block_q=None, block_k=None) -> dict:
        from repro_torch.kernels.ops import attention_work

        bhq, n, d = q.shape
        return attention_work(1, bhq, k.shape[0], n, kv_len, d, causal=causal)[part]
    return work


def _distr_work(part: str):
    def work(q_hat, k, v, perm, do, lse, delta, *, q_per_kv: int, causal: bool,
             group_size: int, block_q: int, kv_len: int, block_k=None) -> dict:
        from repro_torch.kernels.ops import attention_work

        bhq, n, _ = q_hat.shape
        return attention_work(1, bhq, k.shape[0], n, kv_len, k.shape[2], causal=causal,
                              group_size=group_size, block_q=block_q)[part]
    return work


@charged("delta", _delta_work)
def delta_kernel_call(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO ∘ O): o, do (BHq, N, d) of one dtype → (BHq, N) f32."""
    if o.device.type == "cpu":
        return delta_plain(o, do)
    if o.device.type == "meta":  # the dry run: shapes, no launch
        return o.new_empty(o.shape[:2], dtype=torch.float32)
    build.require_cuda(o, do)
    if o.shape != do.shape or o.dtype != do.dtype or o.shape[-1] % 8:
        raise ValueError(f"delta kernel shapes o={tuple(o.shape)} do={tuple(do.shape)} "
                         f"(one dtype, d a multiple of 8)")
    bhq, n, d = o.shape
    out = torch.empty((bhq, n), device=o.device, dtype=torch.float32)
    if bhq * n:
        err = build.lib().repro_delta(o.data_ptr(), do.data_ptr(), out.data_ptr(),
                                      build.dtype_code(o), bhq * n, d, build.stream_handle(o))
        build.check(err, "repro_delta")
        launches["delta"] += 1
    return out


# ---------------------------------------------------------------------------
# Exact flash backward
# ---------------------------------------------------------------------------


def _flash_p_and_ds(q, k, v, do, lse, delta, q_per_kv, scale, causal, kv_len):
    bhq, n, d = q.shape
    bhkv, nk, _ = k.shape
    qg = q.float().reshape(bhkv, q_per_kv, n, d)
    dog = do.float().reshape(bhkv, q_per_kv, n, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("grnd,gmd->grnm", qg, kf) * scale
    dp = torch.einsum("grnd,gmd->grnm", dog, vf)
    p, ds = _p_and_ds(s, _mask(n, nk, kv_len, causal, q.device),
                      lse.reshape(bhkv, q_per_kv, n), delta.reshape(bhkv, q_per_kv, n), dp)
    return qg, dog, kf, p, ds


def flash_dq_plain(q, k, v, do, lse, delta, *, q_per_kv: int, scale: float,
                   causal: bool, kv_len: int, block_q=None, block_k=None) -> torch.Tensor:
    """Plain version of the dq kernel.  q, do: (BHq, N, d); k, v:
    (BHkv, Nk, d); lse, delta: (BHq, N) f32 → dQ (BHq, N, d) f32."""
    _, _, kf, _, ds = _flash_p_and_ds(q, k, v, do, lse, delta, q_per_kv, scale, causal, kv_len)
    return (torch.einsum("grnm,gmd->grnd", ds, kf) * scale).reshape(q.shape)


def flash_dkv_plain(q, k, v, do, lse, delta, *, q_per_kv: int, scale: float,
                    causal: bool, kv_len: int, block_q=None, block_k=None):
    """Plain version of the dkv kernel → (dK, dV), each (BHq, Nk, d) f32,
    per query head."""
    qg, dog, _, p, ds = _flash_p_and_ds(q, k, v, do, lse, delta, q_per_kv, scale, causal,
                                        kv_len)
    bhq, nk, d = q.shape[0], k.shape[1], k.shape[2]
    dv = torch.einsum("grnm,grnd->grmd", p, dog).reshape(bhq, nk, d)
    dk = (torch.einsum("grnm,grnd->grmd", ds, qg) * scale).reshape(bhq, nk, d)
    return dk, dv


def _check_flash(q, k, v, do, lse, delta, q_per_kv, kv_len):
    build.require_cuda(q, k, v, do, lse, delta)
    bhq, n, d = q.shape
    bhkv, nk, dv = v.shape
    if (bhq != bhkv * q_per_kv or k.shape != v.shape or dv != d or d not in (64, 112, 128)
            or do.shape != q.shape or lse.shape != (bhq, n) or delta.shape != (bhq, n)):
        raise ValueError(f"flash backward shapes q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"do={tuple(do.shape)} lse={tuple(lse.shape)}")
    if not (k.dtype == v.dtype == do.dtype == q.dtype) or not (
            lse.dtype == delta.dtype == torch.float32):
        raise TypeError("flash backward wants q, k, v, do of one dtype and f32 lse, delta")
    if not 0 <= kv_len <= nk:
        raise ValueError(f"kv_len={kv_len} outside [0, {nk}]")


@charged("flash_dq", _flash_work("dq"))
def flash_dq_kernel_call(q, k, v, do, lse, delta, *, q_per_kv: int, scale: float,
                         causal: bool, kv_len: int, block_q: int | None = None,
                         block_k: int | None = None) -> torch.Tensor:
    """Launch the flash dq kernel at a compiled tile (rows, keys); shapes
    as for the plain version."""
    bq, bk = check_tile("flash_dq", (block_q, block_k), d=q.shape[-1], dtype=dtype_str(q))
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, q_per_kv=q_per_kv, scale=scale,
                              causal=causal, kv_len=kv_len)
    if q.device.type == "meta":  # the dry run: shapes, no launch
        return q.new_empty(q.shape, dtype=torch.float32)
    _check_flash(q, k, v, do, lse, delta, q_per_kv, kv_len)
    bhq, n, d = q.shape
    dq = torch.empty((bhq, n, d), device=q.device, dtype=torch.float32)
    if n:
        err = build.lib().repro_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), build.dtype_code(q), bhq, n, k.shape[1], kv_len,
            d, q_per_kv, float(scale), int(causal), bq, bk, build.stream_handle(q),
        )
        build.check(err, "repro_flash_dq")
        launches["flash_dq"] += 1
        tile_launches["flash_dq"][(d, bq, bk)] += 1
    return dq


@charged("flash_dkv", _flash_work("dkv"))
def flash_dkv_kernel_call(q, k, v, do, lse, delta, *, q_per_kv: int, scale: float,
                          causal: bool, kv_len: int, block_q: int | None = None,
                          block_k: int | None = None):
    """Launch the flash dkv kernel at a compiled tile (Q tile rows, keys a
    CTA) → (dK, dV) per query head, f32."""
    bq, bk = check_tile("flash_dkv", (block_q, block_k), d=q.shape[-1], dtype=dtype_str(q))
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, q_per_kv=q_per_kv, scale=scale,
                               causal=causal, kv_len=kv_len)
    if q.device.type == "meta":  # the dry run: shapes, no launch
        dk = q.new_empty((q.shape[0], k.shape[1], q.shape[2]), dtype=torch.float32)
        return dk, torch.empty_like(dk)
    _check_flash(q, k, v, do, lse, delta, q_per_kv, kv_len)
    bhq, n, d = q.shape
    nk = k.shape[1]
    dk = torch.empty((bhq, nk, d), device=q.device, dtype=torch.float32)
    dv = torch.empty_like(dk)
    if nk:
        err = build.lib().repro_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), build.dtype_code(q), bhq, n, nk,
            kv_len, d, q_per_kv, float(scale), int(causal), bq, bk, build.stream_handle(q),
        )
        build.check(err, "repro_flash_dkv")
        launches["flash_dkv"] += 1
        tile_launches["flash_dkv"][(d, bq, bk)] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# DistrAttention backward
# ---------------------------------------------------------------------------


def _distr_p_and_ds(q_hat, k, v, perm, do, lse, delta, q_per_kv, causal, group_size, block_q,
                    kv_len):
    """Re-fuse K̂ per Q block (as the forward's plain version does) and
    recompute P and dS.  Shapes carry (g, r, q) = (KV head, query head of
    the group, Q block)."""
    bhq, n, dg = q_hat.shape
    bhkv, nk, d = k.shape
    nq = n // block_q
    kg = k.float()[:, None, None].expand(bhkv, q_per_kv, nq, nk, d)
    k_hat = fuse_k_columns(kg, perm.reshape(bhkv, q_per_kv, nq, d), group_size)
    qb = q_hat.float().reshape(bhkv, q_per_kv, nq, block_q, dg)
    dob = do.float().reshape(bhkv, q_per_kv, nq, block_q, d)
    s = torch.einsum("grqld,grqmd->grqlm", qb, k_hat)
    dp = torch.einsum("grqld,gmd->grqlm", dob, v.float())
    mask = _mask(n, nk, kv_len, causal, q_hat.device).reshape(nq, block_q, nk)
    shape = (bhkv, q_per_kv, nq, block_q)
    p, ds = _p_and_ds(s, mask, lse.reshape(shape), delta.reshape(shape), dp)
    return qb, dob, k_hat, p, ds


def distr_dq_plain(q_hat, k, v, perm, do, lse, delta, *, q_per_kv: int, causal: bool,
                   group_size: int, block_q: int, kv_len: int, block_k=None) -> torch.Tensor:
    """Plain version of the distr dq kernel.  q_hat: (BHq, N, d/G*)
    sampled and pre-scaled; k, v: (BHkv, Nk, d); perm: (BHq, N/block_q, d);
    do: (BHq, N, d); lse, delta: (BHq, N) → dQ̂ (BHq, N, d/G*) f32 (no
    scale: Q̂ carries it)."""
    _, _, k_hat, _, ds = _distr_p_and_ds(q_hat, k, v, perm, do, lse, delta, q_per_kv, causal,
                                         group_size, block_q, kv_len)
    return torch.einsum("grqlm,grqmd->grqld", ds, k_hat).reshape(q_hat.shape)


def distr_dkv_plain(q_hat, k, v, perm, do, lse, delta, *, q_per_kv: int, causal: bool,
                    group_size: int, block_q: int, kv_len: int, block_k=None):
    """Plain version of the distr dkv kernel → (dK, dV), each (BHq, Nk, d)
    f32 per query head.  Keeps the reference's formula: dK̂ = dSᵀ Q̂ per Q
    block, replicated to each fused column's G* members and gathered back
    to column order by the inverse permutation."""
    qb, dob, _, p, ds = _distr_p_and_ds(q_hat, k, v, perm, do, lse, delta, q_per_kv, causal,
                                        group_size, block_q, kv_len)
    bhq = q_hat.shape[0]
    bhkv, nk, d = k.shape
    nq = q_hat.shape[1] // block_q
    dv = torch.einsum("grqlm,grqld->grmd", p, dob).reshape(bhq, nk, d)
    dk_hat = torch.einsum("grqlm,grqld->grqmd", ds, qb)  # (g, r, q, Nk, d/G*)
    dk_rep = dk_hat.repeat_interleave(group_size, dim=-1)
    inv_perm = torch.argsort(perm.to(torch.int64), dim=-1)
    inv_perm = inv_perm.reshape(bhkv, q_per_kv, nq, 1, d).expand(bhkv, q_per_kv, nq, nk, d)
    dk = torch.gather(dk_rep, -1, inv_perm).sum(dim=2).reshape(bhq, nk, d)
    return dk, dv


def _check_distr(q_hat, k, v, perm, do, lse, delta, q_per_kv, group_size, block_q, kv_len):
    build.require_cuda(q_hat, k, v, perm, do, lse, delta)
    bhq, n, dg = q_hat.shape
    bhkv, nk, d = k.shape
    if (bhq != bhkv * q_per_kv or k.shape != v.shape or dg * group_size != d or dg % 4
            or group_size < 2 or d not in (64, 112, 128) or n % block_q or block_q % ROW_TILE
            or perm.shape != (bhq, n // block_q, d) or do.shape != (bhq, n, d)
            or lse.shape != (bhq, n) or delta.shape != (bhq, n)):
        raise ValueError(
            f"distr backward shapes q_hat={tuple(q_hat.shape)} k={tuple(k.shape)} "
            f"perm={tuple(perm.shape)} do={tuple(do.shape)} block_q={block_q} "
            f"(needs {ROW_TILE} | block_q, G* >= 2 and 4 | d/G*)"
        )
    if not (k.dtype == v.dtype == do.dtype == q_hat.dtype) or not (
            lse.dtype == delta.dtype == torch.float32):
        raise TypeError("distr backward wants q_hat, k, v, do of one dtype and f32 lse, delta")
    if not 0 <= kv_len <= nk:
        raise ValueError(f"kv_len={kv_len} outside [0, {nk}]")


def _q_tilde_scratch(q_hat: torch.Tensor, d: int) -> torch.Tensor:
    """The bf16 kernels' Q̃ (BHq, N, d), written by the kernel itself; f32
    takes none (an empty tensor)."""
    bhq, n, _ = q_hat.shape
    shape = (bhq, n, d) if q_hat.dtype == torch.bfloat16 else (0,)
    return torch.empty(shape, device=q_hat.device, dtype=q_hat.dtype)


@charged("distr_dq", _distr_work("dq"))
def distr_dq_kernel_call(q_hat, k, v, perm, do, lse, delta, *, q_per_kv: int, causal: bool,
                         group_size: int, block_q: int, kv_len: int,
                         block_k: int | None = None) -> torch.Tensor:
    """Launch the distr dq kernel at a compiled key tile; shapes as for the
    plain version."""
    rows, bk = check_tile("distr_dq", (None, block_k), d=k.shape[-1], dtype=dtype_str(q_hat))
    if q_hat.device.type == "cpu":
        return distr_dq_plain(q_hat, k, v, perm, do, lse, delta, q_per_kv=q_per_kv,
                              causal=causal, group_size=group_size, block_q=block_q,
                              kv_len=kv_len)
    if q_hat.device.type == "meta":  # the dry run: shapes, no launch
        return q_hat.new_empty(q_hat.shape, dtype=torch.float32)
    perm = perm.to(torch.int32).contiguous()
    _check_distr(q_hat, k, v, perm, do, lse, delta, q_per_kv, group_size, block_q, kv_len)
    bhq, n, dg = q_hat.shape
    d = k.shape[2]
    dq_hat = torch.empty((bhq, n, dg), device=q_hat.device, dtype=torch.float32)
    if n:
        q_tilde = _q_tilde_scratch(q_hat, d)
        err = build.lib().repro_distr_dq(
            q_hat.data_ptr(), k.data_ptr(), v.data_ptr(), perm.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq_hat.data_ptr(), q_tilde.data_ptr(),
            build.dtype_code(q_hat), bhq, n, k.shape[1], kv_len, d, group_size, block_q,
            n // block_q, q_per_kv, int(causal), rows, bk, build.stream_handle(q_hat),
        )
        build.check(err, "repro_distr_dq")
        launches["distr_dq"] += 1
        tile_launches["distr_dq"][(d, rows, bk)] += 1
    return dq_hat


@charged("distr_dkv", _distr_work("dkv"))
def distr_dkv_kernel_call(q_hat, k, v, perm, do, lse, delta, *, q_per_kv: int, causal: bool,
                          group_size: int, block_q: int, kv_len: int,
                          block_k: int | None = None):
    """Launch the distr dkv kernel at a compiled key tile → (dK, dV) per
    query head, f32.  The kernel takes dK back through ``perm`` itself, so
    it takes no inverse permutation."""
    rows, bk = check_tile("distr_dkv", (None, block_k), d=k.shape[-1], dtype=dtype_str(q_hat))
    if q_hat.device.type == "cpu":
        return distr_dkv_plain(q_hat, k, v, perm, do, lse, delta, q_per_kv=q_per_kv,
                               causal=causal, group_size=group_size, block_q=block_q,
                               kv_len=kv_len)
    if q_hat.device.type == "meta":  # the dry run: shapes, no launch
        dk = q_hat.new_empty((q_hat.shape[0],) + tuple(k.shape[1:]), dtype=torch.float32)
        return dk, torch.empty_like(dk)
    perm = perm.to(torch.int32).contiguous()
    _check_distr(q_hat, k, v, perm, do, lse, delta, q_per_kv, group_size, block_q, kv_len)
    bhq, n, _ = q_hat.shape
    nk, d = k.shape[1], k.shape[2]
    dk = torch.empty((bhq, nk, d), device=q_hat.device, dtype=torch.float32)
    dv = torch.empty_like(dk)
    if nk:
        q_tilde = _q_tilde_scratch(q_hat, d)
        err = build.lib().repro_distr_dkv(
            q_hat.data_ptr(), k.data_ptr(), v.data_ptr(), perm.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), q_tilde.data_ptr(),
            build.dtype_code(q_hat), bhq, n, nk, kv_len, d, group_size, block_q,
            n // block_q, q_per_kv, int(causal), rows, bk, build.stream_handle(q_hat),
        )
        build.check(err, "repro_distr_dkv")
        launches["distr_dkv"] += 1
        tile_launches["distr_dkv"][(d, rows, bk)] += 1
    return dk, dv
