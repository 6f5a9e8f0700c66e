"""Exact FlashAttention-2 forward: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``.  Its tile, (block_q,
block_k) = (query rows a CTA, keys a K/V tile), is one the sources compile
(``tune.autotune.compiled_tiles``), the static one when None.
``launches`` counts the wrapper's kernel launches, ``tile_launches`` them
by (d, block_q, block_k).
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


def flash_attention_plain(q, k, v, *, q_per_kv: int, scale: float, causal: bool,
                          kv_len: int, return_lse: bool = False, block_q=None, block_k=None):
    """Plain version of the kernel.  q: (BHq, N, d); k, v: (BHkv, Nk, d).
    Keys at or past ``kv_len`` are masked; a row that sees no key gives
    O = 0 and LSE = -1e30.  Returns ``o`` or ``(o, lse)``.  The tile has
    no meaning here and is ignored."""
    bhq, n, d = q.shape
    bhkv, nk, dv = v.shape
    qg = q.float().reshape(bhkv, q_per_kv, n, d)
    s = torch.einsum("grnd,gmd->grnm", qg, k.float()) * scale
    col = torch.arange(nk, device=q.device)[None, :]
    mask = col < kv_len
    if causal:
        mask = mask & (col <= torch.arange(n, device=q.device)[:, None])
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l == 0, 1.0, l)
    o = torch.einsum("grnm,gmd->grnd", p, v.float()) / denom
    o = o.reshape(bhq, n, dv).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l == 0, NEG_INF, m + torch.log(denom))
    return o, lse.reshape(bhq, n)


def _fwd_work(q, k, v, *, q_per_kv: int, scale: float, causal: bool, kv_len: int,
              return_lse: bool = False, block_q=None, block_k=None) -> dict:
    from repro_torch.kernels.ops import attention_work

    bhq, n, d = q.shape
    return attention_work(1, bhq, k.shape[0], n, kv_len, d, causal=causal,
                          lse=return_lse)["fwd"]


@charged("flash_fwd", _fwd_work)
def flash_attention_kernel_call(q, k, v, *, q_per_kv: int, scale: float,
                                causal: bool, kv_len: int,
                                return_lse: bool = False, block_q: int | None = None,
                                block_k: int | None = None):
    """Launch the exact FA-2 kernel.  q: (BHq, N, d); k, v: (BHkv, Nk, d)
    with BHq = BHkv · q_per_kv; (block_q, block_k) a compiled tile (None:
    the static one), checked on every device.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises.  Returns
    ``o`` (q's dtype) or ``(o, lse)`` with lse ``(BHq, N)`` f32."""
    global launches
    bq, bk = check_tile("flash_fwd", (block_q, block_k), d=q.shape[-1], dtype=dtype_str(q))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_per_kv=q_per_kv, scale=scale,
                                     causal=causal, kv_len=kv_len,
                                     return_lse=return_lse)
    if q.device.type == "meta":  # the dry run: shapes, no launch
        o = torch.empty_like(q)
        lse = torch.empty((q.shape[0], q.shape[1]), device=q.device, dtype=torch.float32)
        return (o, lse) if return_lse else o
    build.require_cuda(q, k, v)
    bhq, n, d = q.shape
    bhkv, nk, dv = v.shape
    if bhq != bhkv * q_per_kv or k.shape != v.shape or dv != d or d not in build.HEAD_DIMS:
        raise ValueError(f"flash kernel shapes q={tuple(q.shape)} k={tuple(k.shape)}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError("flash kernel wants q, k, v of one dtype")
    if not 0 <= kv_len <= nk:
        raise ValueError(f"kv_len={kv_len} outside [0, {nk}]")
    o = torch.empty_like(q)
    lse = torch.empty((bhq, n), device=q.device, dtype=torch.float32) if return_lse else None
    if n:
        err = build.lib().repro_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            build.dtype_code(q), bhq, n, nk, kv_len, d, q_per_kv, float(scale),
            int(causal), bq, bk, build.stream_handle(q),
        )
        build.check(err, "repro_flash_fwd")
        launches += 1
        tile_launches[(d, bq, bk)] += 1
    return (o, lse) if return_lse else o
