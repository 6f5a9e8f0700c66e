"""Mamba-2 (SSD) block: the attention-free family (mamba2-130m) and the
backbone of the hybrid (zamba2-7b).

``mamba_apply`` runs the chunked SSD through ``kernels.ops.ssd``: the
hand-written kernel on the card, its plain version on the CPU.  (The
reference's block calls ``ssd_xla``, which computes the same function as its
Pallas kernel; both share the oracle ``kernels/ref.py::ssd_ref``.)
``ssd_chunked`` is the counterpart of ``ssd_xla``, plain PyTorch in the
model's layout: the reference differentiates the block through it, and
``ops.ssd``'s backward does the same.  ``ssd_step`` is the O(1)-per-token
decode recurrence, plain PyTorch as in the reference.  Dtypes follow the
reference: ``dt`` and its softplus in f32, the SSD input in the compute
dtype, the SSM state in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                chunk: int = 128, return_state: bool = False):
    """Chunked SSD (the reference's ``ssd_xla``).  x: (B, N, H, P); a: (B,
    N, H) log-decays (≤ 0); b, c: (B, N, G, S) → y (B, N, H, P) in x's
    dtype, and with ``return_state`` also the state at N, (B, H, S, P) f32.

    Computes in f32.  A ragged tail is zero-padded (a = 0, b = c = x = 0),
    so the state at N is the padded sequence's final state.  Inside a chunk
    the decay exp(a_cum_i − a_cum_j) exists only for j ≤ i; above the
    diagonal the exponent is selected away to −inf before the exp, so
    neither the value nor its gradient meets an overflowed exp."""
    bsz, n, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    r = h // g
    pad = (-n) % chunk
    nc = (n + pad) // chunk

    def chunked(t, feat):  # (B, N, ...) f32, zero-padded → (B, nc, chunk, *feat)
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(bsz, nc, chunk, *feat)

    xs = chunked(x, (g, r, p)).permute(0, 1, 3, 4, 2, 5)  # (B, nc, G, r, Q, P)
    a_cum = torch.cumsum(chunked(a, (g, r)).permute(0, 1, 3, 4, 2), dim=-1)  # (B, nc, G, r, Q)
    bs = chunked(b, (g, s)).transpose(2, 3)  # (B, nc, G, Q, S)
    cs = chunked(c, (g, s)).transpose(2, 3)

    idx = torch.arange(chunk, device=x.device)
    tril = idx[None, :] <= idx[:, None]
    seg = torch.where(tril, a_cum[..., :, None] - a_cum[..., None, :], float("-inf"))
    cb = (cs @ bs.transpose(-1, -2))[:, :, :, None]  # (B, nc, G, 1, Q, Q)
    y = (cb * torch.exp(seg)) @ xs  # intra-chunk

    # Each chunk's own contribution to the state at its end, then the
    # carry across chunks.
    a_tot = a_cum[..., -1]  # (B, nc, G, r)
    w = torch.exp(a_tot[..., None] - a_cum)  # (B, nc, G, r, Q)
    own = (bs[:, :, :, None] * w[..., None]).transpose(-1, -2) @ xs  # (B, nc, G, r, S, P)
    state = x.new_zeros((bsz, g, r, s, p), dtype=torch.float32)
    carried = []
    for i in range(nc):
        carried.append(state)
        state = torch.exp(a_tot[:, i])[..., None, None] * state + own[:, i]
    h_in = torch.stack(carried, dim=1)  # (B, nc, G, r, S, P): the state entering each chunk
    y = y + torch.exp(a_cum)[..., None] * (cs[:, :, :, None] @ h_in)  # inter-chunk

    y = y.permute(0, 1, 4, 2, 3, 5).reshape(bsz, nc * chunk, h, p)[:, :n].to(x.dtype)
    return (y, state.reshape(bsz, h, s, p)) if return_state else y


def ssd_step(x_t: torch.Tensor, a_t: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
             state: torch.Tensor):
    """One decode step of the SSD recurrence.  x_t: (B, H, P); a_t: (B, H);
    b_t, c_t: (B, G, S); state: (B, H, S, P) f32 → (y_t (B, H, P) in x_t's
    dtype, new state)."""
    r = x_t.shape[1] // b_t.shape[1]
    bt = b_t.repeat_interleave(r, dim=1)  # (B, H, S)
    ct = c_t.repeat_interleave(r, dim=1)
    decay = torch.exp(a_t.float())[..., None, None]
    state = state * decay + bt[..., None].float() * x_t[:, :, None, :].float()
    y = torch.einsum("bhs,bhsp->bhp", ct.float(), state)
    return y.to(x_t.dtype), state


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def mamba_init(generator, cfg, dtype=torch.float32) -> dict:
    """The reference's distributions: ``in_proj`` / ``out_proj`` linear,
    ``conv_w`` normal · k^-0.5, ``a_log`` 0 (A = −1), ``dt_bias`` 0.5,
    ``d_skip`` 1.  Matmul weights take ``dtype``; the conv taps, the
    per-head SSM parameters and the norm stay f32."""
    dev = generator.device
    d_in, h = cfg.d_inner, cfg.ssm_heads
    gs = cfg.ssm_groups * cfg.ssm_state
    proj_out = 2 * d_in + 2 * gs + h  # z, x, B, C, dt
    return {
        "in_proj": layers.linear_init(generator, cfg.d_model, proj_out, dtype=dtype),
        "conv_w": layers._normal(generator, (cfg.ssm_conv, conv_dim(cfg)),
                                 cfg.ssm_conv ** -0.5, torch.float32),
        "conv_b": torch.zeros((conv_dim(cfg),), dtype=torch.float32, device=dev),
        "a_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((h,), 0.5, dtype=torch.float32, device=dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "out_norm": layers.rmsnorm_init(d_in, dev),
        "out_proj": layers.linear_init(generator, d_in, cfg.d_model, dtype=dtype),
    }


def mamba_axes(cfg) -> dict:
    return {
        "in_proj": layers.linear_axes(None, "mlp"),
        "conv_w": (None, "mlp"),
        "conv_b": ("mlp",),
        "a_log": (None,),
        "dt_bias": (None,),
        "d_skip": (None,),
        "out_norm": layers.rmsnorm_axes(),
        "out_proj": layers.linear_axes("mlp", None),
    }


def _split_proj(proj: torch.Tensor, cfg):
    d_in = cfg.d_inner
    gs = cfg.ssm_groups * cfg.ssm_state
    return proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * gs], proj[..., 2 * d_in + 2 * gs:]


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence (kernel taps via shifts)."""
    k, n = conv_w.shape[0], xbc.shape[1]
    y = xbc * conv_w[k - 1].to(xbc.dtype)
    for i in range(1, k):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :n]
        y = y + shifted * conv_w[k - 1 - i].to(xbc.dtype)
    return F.silu(y + conv_b.to(xbc.dtype))


def mamba_apply(params: dict, x: torch.Tensor, cfg, *, return_state: bool = False):
    """Full-sequence Mamba-2 block.  x: (B, N, D) → (B, N, D).  With
    ``return_state`` also returns (conv_state (B, k−1, conv_dim) in x's
    dtype, ssm_state (B, H, S, P) f32) at position N, for decode."""
    bsz, n, _ = x.shape
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    g, s = cfg.ssm_groups, cfg.ssm_state

    proj = layers.linear_apply(params["in_proj"], x)
    z, xbc_raw, dt = _split_proj(proj, cfg)
    xbc_raw = layers.constrain(xbc_raw, "data", None, "model")
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs = xbc[..., :cfg.d_inner]
    b = xbc[..., cfg.d_inner:cfg.d_inner + g * s].reshape(bsz, n, g, s)
    c = xbc[..., cfg.d_inner + g * s:].reshape(bsz, n, g, s)

    dt = _softplus(dt.float() + params["dt_bias"])  # (B, N, H)
    a_t = dt * -torch.exp(params["a_log"])  # log-decay per step
    x_heads = xs.reshape(bsz, n, h, p)
    x_in = x_heads * dt[..., None].to(x_heads.dtype)

    res = ops.ssd(x_in, a_t, b, c, chunk=cfg.ssm_chunk, return_state=return_state)
    y, ssm_state = res if return_state else (res, None)
    y = y + x_heads * params["d_skip"][None, None, :, None].to(x_heads.dtype)
    y = y.reshape(bsz, n, cfg.d_inner)
    y = y * F.silu(z)
    y = layers.rmsnorm_apply(params["out_norm"], y, cfg.norm_eps)
    out = layers.linear_apply(params["out_proj"], y)
    if return_state:
        # The last k−1 pre-conv inputs, copied: a view would keep the layer's
        # whole in_proj output alive for as long as the state is held.
        conv_state = xbc_raw[:, n - (cfg.ssm_conv - 1):, :].to(x.dtype, copy=True)
        return out, (conv_state, ssm_state)
    return out


def mamba_decode_apply(params: dict, x: torch.Tensor, cfg, *, conv_state: torch.Tensor,
                       ssm_state: torch.Tensor):
    """One-token step.  x: (B, 1, D); conv_state: (B, k−1, conv_dim);
    ssm_state: (B, H, S, P) f32.  Returns (y, (conv_state, ssm_state))."""
    bsz = x.shape[0]
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    g, s = cfg.ssm_groups, cfg.ssm_state

    proj = layers.linear_apply(params["in_proj"], x)
    z, xbc, dt = _split_proj(proj, cfg)
    # The window takes the wider of the two dtypes, as the reference's
    # concatenate promotes: a bf16 cache slot with f32 activations turns f32.
    wdtype = torch.promote_types(conv_state.dtype, xbc.dtype)
    window = torch.cat([conv_state.to(wdtype), xbc[:, :1].to(wdtype)], dim=1)  # (B, k, C)
    conv_out = torch.einsum("bkc,kc->bc", window.float(), params["conv_w"].float())
    conv_out = F.silu(conv_out + params["conv_b"].float())
    new_conv_state = window[:, 1:]

    xs = conv_out[:, :cfg.d_inner]
    b = conv_out[:, cfg.d_inner:cfg.d_inner + g * s].reshape(bsz, g, s)
    c = conv_out[:, cfg.d_inner + g * s:].reshape(bsz, g, s)

    dt_t = _softplus(dt[:, 0].float() + params["dt_bias"])
    a_t = dt_t * -torch.exp(params["a_log"])  # (B, H)
    x_heads = xs.reshape(bsz, h, p)
    x_in = (x_heads * dt_t[..., None]).to(x.dtype)

    y, new_ssm_state = ssd_step(x_in, a_t, b.to(x.dtype), c.to(x.dtype), ssm_state)
    y = y + x_heads.to(y.dtype) * params["d_skip"][None, :, None].to(y.dtype)
    y = y.reshape(bsz, 1, cfg.d_inner)
    y = y * F.silu(z)
    y = layers.rmsnorm_apply(params["out_norm"], y, cfg.norm_eps)
    return layers.linear_apply(params["out_proj"], y), (new_conv_state, new_ssm_state)
