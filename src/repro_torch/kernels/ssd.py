"""Mamba-2 chunked SSD (state-space duality): the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/ssd.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssd.py::_ssd_kernel``: bf16 inputs run on the tensor cores
(``csrc/ssd_tc.cuh``, one CTA per head and slice of P, the slice width
chosen from the grid), f32 inputs on an FMA kernel.  Per head, with the sequence cut into
chunks of ``chunk`` steps and ``a_cum`` the inclusive cumsum of the
log-decays inside a chunk:

    y_i   = Σ_{j≤i} (c_i·b_j) exp(a_cum_i − a_cum_j) x_j + exp(a_cum_i) c_iᵀ H
    H'    = exp(a_cum_last) H + Σ_j exp(a_cum_last − a_cum_j) b_j x_jᵀ

with the (S × P) f32 state H carried from chunk to chunk.  Heads share
b / c in groups (head ``h`` reads group ``h // heads_per_group``).  A
ragged tail acts as zero-padded steps (a = 0, b = c = x = 0), so the final
state is the state at N.  ``launches`` counts the wrapper's kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.utils.counting import charged

launches = 0
MAX_CHUNK = 128  # the kernel's shared-memory tiles hold at most 128 steps
MAX_WIDTH = 128  # largest state width S and head width P


def ssd_plain(x, a, b, c, *, heads_per_group: int, chunk: int,
              return_state: bool = False):
    """Plain version of the kernel, chunked like the reference's ``ssd_xla``.

    x: (BH, N, P); a: (BH, N) log-decays; b, c: (BG, N, S) with
    BH = BG · heads_per_group (batch-major, head-minor).  Computes in f32.
    Returns y (BH, N, P) in x's dtype, and with ``return_state`` also the
    final state (BH, S, P) f32.
    """
    bh, n, p = x.shape
    s = b.shape[2]
    pad = (-n) % chunk

    def padded(t):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], dim=1)
        return t

    nc = (n + pad) // chunk
    xs = padded(x).reshape(bh, nc, chunk, p)
    as_ = padded(a).reshape(bh, nc, chunk)
    bs = padded(b).reshape(-1, nc, chunk, s).repeat_interleave(heads_per_group, dim=0)
    cs = padded(c).reshape(-1, nc, chunk, s).repeat_interleave(heads_per_group, dim=0)
    idx = torch.arange(chunk, device=x.device)
    tril = idx[None, :] <= idx[:, None]
    state = torch.zeros((bh, s, p), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        x_c, c_c, b_c = xs[:, i], cs[:, i], bs[:, i]
        a_cum = torch.cumsum(as_[:, i], dim=-1)  # (BH, Q) inclusive
        # L[i, j] overflows for j > i under strong decays: select the
        # exponent away before the exp, never mask-multiply, so neither the
        # value nor an autograd gradient meets exp's overflow (0 · inf).
        decay = torch.exp(torch.where(tril, a_cum[:, :, None] - a_cum[:, None, :], -torch.inf))
        scores = torch.einsum("bis,bjs->bij", c_c, b_c) * decay
        y = torch.einsum("bij,bjp->bip", scores, x_c)
        y = y + torch.exp(a_cum)[..., None] * torch.einsum("bis,bsp->bip", c_c, state)
        a_tot = a_cum[:, -1]
        w = torch.exp(a_tot[:, None] - a_cum)  # (BH, Q)
        state = (torch.exp(a_tot)[:, None, None] * state
                 + torch.einsum("bjs,bjp->bsp", b_c * w[..., None], x_c))
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :n]
    return (y, state) if return_state else y


def _work(x, a, b, c, *, heads_per_group: int, chunk: int, return_state: bool = False) -> dict:
    from repro_torch.kernels.ops import ssd_work

    bh, n, p = x.shape
    return ssd_work(1, n, bh, p, b.shape[0], b.shape[2], chunk=chunk)


@charged("ssd", _work)
def ssd_kernel_call(x, a, b, c, *, heads_per_group: int, chunk: int,
                    return_state: bool = False):
    """Launch the SSD kernel; shapes as for ``ssd_plain`` (x, b, c of one
    dtype; a is read as f32).  The ragged tail is masked in the kernel, so
    N need not divide by ``chunk``.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises."""
    global launches
    if x.device.type == "cpu":
        return ssd_plain(x, a, b, c, heads_per_group=heads_per_group, chunk=chunk,
                         return_state=return_state)
    if x.device.type == "meta":  # the dry run: shapes, no launch
        state = x.new_empty((x.shape[0], b.shape[2], x.shape[2]), dtype=torch.float32)
        return (torch.empty_like(x), state) if return_state else torch.empty_like(x)
    a = a.to(torch.float32).contiguous()
    build.require_cuda(x, a, b, c)
    bh, n, p = x.shape
    bg, nb, s = b.shape
    if (a.shape != (bh, n) or c.shape != b.shape or nb != n
            or bh != bg * heads_per_group or p % 4 or s % 4 or chunk % 4
            or not 4 <= chunk <= MAX_CHUNK or p > MAX_WIDTH or s > MAX_WIDTH):
        raise ValueError(
            f"ssd kernel shapes x={tuple(x.shape)} a={tuple(a.shape)} b={tuple(b.shape)} "
            f"c={tuple(c.shape)} heads_per_group={heads_per_group} chunk={chunk}"
        )
    if not (b.dtype == c.dtype == x.dtype):
        raise TypeError("ssd kernel wants x, b, c of one dtype")
    y = torch.empty_like(x)
    state = (torch.zeros((bh, s, p), device=x.device, dtype=torch.float32)
             if return_state else None)
    if n:
        err = build.lib().repro_ssd_fwd(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            state.data_ptr() if state is not None else None, build.dtype_code(x),
            bh, n, p, s, heads_per_group, chunk, build.stream_handle(x),
        )
        build.check(err, "repro_ssd_fwd")
        launches += 1
    return (y, state) if return_state else y
