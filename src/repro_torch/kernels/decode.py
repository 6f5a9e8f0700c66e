"""Split-K flash-decoding: the CUDA kernel's wrapper, its plain PyTorch
version and the cross-split merge.

The kernel (``csrc/decode.cu``; bf16 on the tensor-core tile
``csrc/decode_tc.cuh``, f32 on FMA loops) replaces the Pallas TPU kernel
``repro/kernels/decode.py::_decode_kernel``.  Each split of ``block_k``
cache positions emits unnormalised partials

    o_j = Σ exp(s_j − m_j) · V_j,   m_j = rowmax s_j,   l_j = Σ exp(s_j − m_j)

and ``merge_splits`` combines them.  A split past a slot's length emits the
identity (o = 0, m = -1e30, l = 0).  ``launches`` counts the wrapper's
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.flash_reference import NEG_INF
from repro_torch.kernels import build
from repro_torch.utils.counting import charged

launches = 0
MAX_ROWS = 32  # packed query rows (q_per_kv · q_len) one CUDA block holds


def decode_plain(q, k, v, lengths, *, scale: float, block_k: int, q_len: int):
    """Plain version of the kernel.

    q: (B, Hkv, rows, d_score) packed (row r is query token r % q_len);
    k: (B, Hkv, S, d_score); v: (B, Hkv, S, d); lengths: (B,) ≤ S.
    Returns o (B, Hkv, splits, rows, d) and m, l (B, Hkv, splits, rows), f32.
    """
    b, hkv, rows, ds = q.shape
    s_len, d = k.shape[2], v.shape[3]
    splits = -(-s_len // block_k)
    pad = splits * block_k - s_len
    kf, vf = k.float(), v.float()
    if pad:
        kf = torch.cat([kf, kf.new_zeros((b, hkv, pad, ds))], dim=2)
        vf = torch.cat([vf, vf.new_zeros((b, hkv, pad, d))], dim=2)
    kf = kf.reshape(b, hkv, splits, block_k, ds)
    vf = vf.reshape(b, hkv, splits, block_k, d)
    s = torch.einsum("bhrd,bhjkd->bhjrk", q.float(), kf) * scale
    col = torch.arange(splits * block_k, device=q.device).reshape(splits, 1, block_k)
    tok = torch.arange(rows, device=q.device) % q_len
    row_len = lengths.to(torch.int64)[:, None] - (q_len - 1 - tok)[None, :]  # (B, rows)
    mask = col[None] < row_len[:, None, :, None]  # (B, splits, rows, block_k)
    mask = mask[:, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhjrk,bhjkd->bhjrd", p, vf)
    return o, m, l


def _work(q, k, v, lengths, *, scale: float, block_k: int, q_len: int) -> dict:
    """The call's least work with every cache position live: the counter
    prices static shapes (the dry run cannot read the lengths)."""
    from repro_torch.kernels.ops import decode_attention_work

    b, hkv, rows, ds = q.shape
    s_len, d = k.shape[2], v.shape[3]
    return decode_attention_work([s_len] * b, hkv * rows // q_len, hkv, d, s_len,
                                 group_size=d // ds, q_len=q_len)


@charged("decode", _work)
def decode_kernel_call(q, k, v, lengths, *, scale: float, block_k: int, q_len: int):
    """Launch the split-K decode kernel; shapes as for ``decode_plain``.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    global launches
    if q.device.type == "cpu":
        return decode_plain(q, k, v, lengths, scale=scale, block_k=block_k, q_len=q_len)
    if q.device.type == "meta":  # the dry run: shapes, no launch
        b, hkv, rows, _ = q.shape
        splits = -(-k.shape[2] // block_k)
        m = torch.empty((b, hkv, splits, rows), device=q.device, dtype=torch.float32)
        return m.new_empty((b, hkv, splits, rows, v.shape[3])), m, torch.empty_like(m)
    lengths = lengths.to(torch.int32).contiguous()
    build.require_cuda(q, k, v, lengths)
    b, hkv, rows, ds = q.shape
    s_len, d = k.shape[2], v.shape[3]
    if (k.shape[:2] != (b, hkv) or k.shape[3] != ds or v.shape[:3] != k.shape[:3]
            or rows > MAX_ROWS or ds % 8 or d not in build.HEAD_DIMS or lengths.shape != (b,)):
        raise ValueError(
            f"decode kernel shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}"
        )
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError("decode kernel wants q, k, v of one dtype")
    splits = -(-s_len // block_k)
    o = torch.empty((b, hkv, splits, rows, d), device=q.device, dtype=torch.float32)
    m = torch.empty((b, hkv, splits, rows), device=q.device, dtype=torch.float32)
    l = torch.empty_like(m)
    err = build.lib().repro_decode_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), build.dtype_code(q),
        b, hkv, rows, s_len, ds, d, block_k, q_len, float(scale),
        build.stream_handle(q),
    )
    build.check(err, "repro_decode_fwd")
    launches += 1
    return o, m, l


def reduce_splits(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor):
    """The splits' partials folded into one, still unnormalised: (o (...,
    rows, d), m, l (..., rows)), the split dim gone.  Every split dead
    gives the identity (0, -1e30, 0), never NaN; ``merge_splits`` of such
    folds (a split dim stacked back) merges across ranks as across splits."""
    m_star = m.amax(dim=-2)
    alpha = torch.exp(m - m_star[..., None, :])
    return (o * alpha[..., None]).sum(dim=-3), m_star, (l * alpha).sum(dim=-2)


def merge_splits(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Cross-split LSE merge → normalised (..., rows, d) f32.  Rows whose
    every split is dead come out exactly zero."""
    m_star = m.amax(dim=-2)
    alpha = torch.exp(m - m_star[..., None, :])
    l_star = (l * alpha).sum(dim=-2)
    o_sum = (o * alpha[..., None]).sum(dim=-3)
    denom = torch.where(l_star == 0, 1.0, l_star)
    return o_sum / denom[..., None]
