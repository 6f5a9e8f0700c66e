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

Tensor parallelism.  The sharding rules slice ``in_proj``'s columns, the
conv's channels and ``out_proj``'s rows over "model" in contiguous blocks
(``mamba_axes``: "mlp"), as the reference's do; the checkpoints keep that
layout.  ``in_proj``'s columns are ``[z | x | B | C | dt]``, so its blocks
do not fall on SSM heads, and every head reads the whole B and C of its
group.  When all three are sliced and the heads divide "model", each rank
runs its own heads (``_mamba_apply_tp``): the in_proj output and the conv
parameters are all-gathered over "model" (``collectives.gather_dim``, whose
backward sums the ranks' cotangents and scatters each rank its block), the
rank takes its heads' z, x and dt and its groups' B and C, runs the conv and
the SSD kernel on them, slices the per-head parameters and ``out_norm``'s
scale with ``collectives.take_slice`` (so every rank ends with their whole
gradient), sums ``out_norm``'s squares over "model" forward and backward
(``collectives.sum_dp``) and applies ``out_proj`` row-parallel.  Per layer
that moves the in_proj output, B·N·(2·d_inner + 2·G·S + H) values, once
gathered and once reduce-scattered, two B·N sums of squares, and the
B·N·d_model output reduced (and its cotangent, through ``tp_enter``).
Otherwise (heads that do not divide "model", rules that dropped some of the
three and not others, or a prefill that returns its state) the sliced leaves
are gathered on use (``collectives.gather_slices``) and every rank runs the
whole layer.

A decode step on a mesh takes its rank's block of the serving cache
(``serve.kv_cache.cache_pspecs``): the conv state cut into contiguous
channel blocks over "model", which fall on no head, and the SSM state by
heads where "model" divides them.  The rank all-gathers the conv state
over "model", steps its own heads' recurrence where the SSM state is
sliced (as ``_mamba_apply_tp`` runs them) or the whole layer where it is
not, and keeps its channel block of the new conv state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
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


def proj_dim(cfg) -> int:
    """``in_proj``'s output width: z, x, B, C and dt."""
    return 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads


def mamba_init(generator, cfg, dtype=torch.float32) -> dict:
    """The reference's distributions: ``in_proj`` / ``out_proj`` linear,
    ``conv_w`` normal · k^-0.5, ``a_log`` 0 (A = −1), ``dt_bias`` 0.5,
    ``d_skip`` 1.  Matmul weights take ``dtype``; the conv taps, the
    per-head SSM parameters and the norm stay f32."""
    dev = generator.device
    d_in, h = cfg.d_inner, cfg.ssm_heads
    return {
        "in_proj": layers.linear_init(generator, cfg.d_model, proj_dim(cfg), dtype=dtype),
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


# The leaves the rules slice over "model": (path, the sliced dim, its full
# size).
def _model_leaves(cfg) -> tuple:
    return ((("in_proj", "w"), 1, proj_dim(cfg)), (("conv_w",), 1, conv_dim(cfg)),
            (("conv_b",), 0, conv_dim(cfg)), (("out_proj", "w"), 0, cfg.d_inner))


def _leaf(params: dict, path: tuple) -> torch.Tensor:
    for key in path:
        params = params[key]
    return params


def _tp_meshes(params: dict, cfg) -> list:
    """For each of ``_model_leaves``, the "model" mesh it is sliced over,
    or None when ``params`` holds it whole."""
    return [layers.tp_mesh(_leaf(params, path).shape[dim], full)
            for path, dim, full in _model_leaves(cfg)]


def _head_groups(cfg, mesh) -> tuple[int, int] | None:
    """(first group, groups) of B and C that this rank's heads read when
    each rank of "model" runs its own heads, or None when the heads do not
    split so (they do not divide "model", or a rank's heads straddle
    groups unevenly)."""
    m = coll.axis_size(mesh, "model")
    h, g = cfg.ssm_heads, cfg.ssm_groups
    if h % m:
        return None
    h_loc, per_group = h // m, h // g
    h0 = int(mesh.coords["model"]) * h_loc
    if h_loc % per_group == 0:
        return h0 // per_group, h_loc // per_group
    if per_group % h_loc == 0:
        return h0 // per_group, 1
    return None


def _gathered(params: dict, cfg, meshes: list) -> dict:
    """``params`` with every sliced leaf put back together over "model"
    (the backward takes this rank's slice of the replicated cotangent):
    every rank then runs the whole layer."""
    out = {**params, "in_proj": dict(params["in_proj"]), "out_proj": dict(params["out_proj"])}
    for (path, dim, _), mesh in zip(_model_leaves(cfg), meshes):
        if mesh is not None:
            parent = out if len(path) == 1 else out[path[0]]
            parent[path[-1]] = coll.gather_slices(_leaf(params, path), mesh, "model", dim)
    return out


def _mamba_apply_tp(params: dict, x: torch.Tensor, cfg, mesh, groups: tuple[int, int]):
    """``mamba_apply`` on this rank's heads of "model" (see the module
    docstring); x replicated over "model" → this rank's partial output,
    summed over "model"."""
    bsz, n, _ = x.shape
    m = coll.axis_size(mesh, "model")
    p, s = cfg.ssm_head_dim, cfg.ssm_state
    h_loc = cfg.ssm_heads // m
    h0 = int(mesh.coords["model"]) * h_loc
    d_in, gs = cfg.d_inner, cfg.ssm_groups * s
    g0, g_loc = groups

    x = coll.tp_enter(x, mesh)
    proj = layers.linear_apply(params["in_proj"], x)
    proj = coll.gather_dim(proj, mesh, "model", proj.ndim - 1)
    z = proj[..., h0 * p:(h0 + h_loc) * p]
    dt = proj[..., 2 * d_in + 2 * gs + h0:2 * d_in + 2 * gs + h0 + h_loc]

    def channels(t: torch.Tensor, dim: int) -> torch.Tensor:
        # This rank's conv channels of t (the x, B, C block at ``off``):
        # its heads' x, its groups' B and C.
        off = d_in if t is proj else 0
        spans = ((off + h0 * p, h_loc * p), (off + d_in + g0 * s, g_loc * s),
                 (off + d_in + gs + g0 * s, g_loc * s))
        return torch.cat([t.narrow(dim, a, w) for a, w in spans], dim=dim)

    conv_w = coll.gather_dim(params["conv_w"], mesh, "model", 1)
    conv_b = coll.gather_dim(params["conv_b"], mesh, "model", 0)
    xbc = _causal_conv(channels(proj, proj.ndim - 1), channels(conv_w, 1), channels(conv_b, 0))
    xs = xbc[..., :h_loc * p]
    b = xbc[..., h_loc * p:h_loc * p + g_loc * s].reshape(bsz, n, g_loc, s)
    c = xbc[..., h_loc * p + g_loc * s:].reshape(bsz, n, g_loc, s)

    def own(t: torch.Tensor) -> torch.Tensor:
        return coll.take_slice(t, mesh, "model", 0)

    dt = _softplus(dt.float() + own(params["dt_bias"]))
    a_t = dt * -torch.exp(own(params["a_log"]))
    x_heads = xs.reshape(bsz, n, h_loc, p)
    x_in = x_heads * dt[..., None].to(x_heads.dtype)
    y = ops.ssd(x_in, a_t, b, c, chunk=cfg.ssm_chunk)
    y = y + x_heads * own(params["d_skip"])[None, None, :, None].to(x_heads.dtype)
    y = y.reshape(bsz, n, h_loc * p) * F.silu(z)
    # out_norm: one RMSNorm over all of d_inner, its squares summed over
    # the ranks' heads (and their cotangents summed back in the backward).
    yf = y.float()
    sq = coll.sum_dp(yf.square().sum(dim=-1, keepdim=True), mesh, "model")
    yf = yf * torch.rsqrt(sq / d_in + cfg.norm_eps)
    y = (yf * own(params["out_norm"]["scale"]).float()).to(y.dtype)
    return coll.tp_reduce(layers.linear_apply(params["out_proj"], y), mesh)


def mamba_apply(params: dict, x: torch.Tensor, cfg, *, return_state: bool = False):
    """Full-sequence Mamba-2 block.  x: (B, N, D) → (B, N, D).  With
    ``return_state`` also returns (conv_state (B, k−1, conv_dim) in x's
    dtype, ssm_state (B, H, S, P) f32) at position N, for decode.  Leaves
    held as their slices over "model" run tensor parallel (the module
    docstring)."""
    meshes = _tp_meshes(params, cfg)
    mesh = next((mm for mm in meshes if mm is not None), None)
    if mesh is not None:
        groups = _head_groups(cfg, mesh)
        if groups is not None and not return_state and all(mm is not None for mm in meshes):
            return _mamba_apply_tp(params, x, cfg, mesh, groups)
        params = _gathered(params, cfg, meshes)
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


def _mamba_decode_tp(params: dict, x: torch.Tensor, cfg, mesh, groups: tuple[int, int],
                     conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One token through this rank's heads of "model" (``_mamba_apply_tp``'s
    split): ``conv_state`` (B, k−1, conv_dim) the whole conv state,
    ``ssm_state`` (B, H/model, S, P) the rank's heads' state → (the output
    summed over "model", (the whole new conv state, the heads' new SSM
    state))."""
    bsz = x.shape[0]
    m = coll.axis_size(mesh, "model")
    p, s = cfg.ssm_head_dim, cfg.ssm_state
    h_loc = cfg.ssm_heads // m
    h0 = int(mesh.coords["model"]) * h_loc
    d_in, gs = cfg.d_inner, cfg.ssm_groups * s
    g0, g_loc = groups
    proj = coll.all_gather(layers.linear_apply(params["in_proj"], x), mesh, "model", 2)
    z = proj[..., h0 * p:(h0 + h_loc) * p]
    xbc = proj[:, :1, d_in:2 * d_in + 2 * gs]
    dt = proj[:, 0, 2 * d_in + 2 * gs + h0:2 * d_in + 2 * gs + h0 + h_loc]
    wdtype = torch.promote_types(conv_state.dtype, xbc.dtype)
    window = torch.cat([conv_state.to(wdtype), xbc.to(wdtype)], dim=1)  # (B, k, C)
    conv_w = coll.all_gather(params["conv_w"], mesh, "model", 1)
    conv_b = coll.all_gather(params["conv_b"], mesh, "model", 0)

    def channels(t: torch.Tensor) -> torch.Tensor:
        spans = ((h0 * p, h_loc * p), (d_in + g0 * s, g_loc * s), (d_in + gs + g0 * s, g_loc * s))
        return torch.cat([t.narrow(t.ndim - 1, a, w) for a, w in spans], dim=-1)

    conv_out = torch.einsum("bkc,kc->bc", channels(window).float(), channels(conv_w).float())
    conv_out = F.silu(conv_out + channels(conv_b).float())
    xs = conv_out[:, :h_loc * p]
    b = conv_out[:, h_loc * p:h_loc * p + g_loc * s].reshape(bsz, g_loc, s)
    c = conv_out[:, h_loc * p + g_loc * s:].reshape(bsz, g_loc, s)
    heads = slice(h0, h0 + h_loc)
    dt_t = _softplus(dt.float() + params["dt_bias"][heads])
    a_t = dt_t * -torch.exp(params["a_log"][heads])
    x_heads = xs.reshape(bsz, h_loc, p)
    x_in = (x_heads * dt_t[..., None]).to(x.dtype)
    y, new_ssm = ssd_step(x_in, a_t, b.to(x.dtype), c.to(x.dtype), ssm_state)
    y = y + x_heads.to(y.dtype) * params["d_skip"][heads][None, :, None].to(y.dtype)
    y = y.reshape(bsz, 1, h_loc * p) * F.silu(z)
    # out_norm: one RMSNorm over all of d_inner, its squares summed over
    # the ranks' heads.
    yf = y.float()
    sq = coll.all_reduce(yf.square().sum(dim=-1, keepdim=True), mesh, "model")
    yf = yf * torch.rsqrt(sq / d_in + cfg.norm_eps)
    scale = params["out_norm"]["scale"].narrow(0, h0 * p, h_loc * p)
    y = (yf * scale.float()).to(y.dtype)
    out = coll.all_reduce(layers.linear_apply(params["out_proj"], y), mesh, "model")
    return out, (window[:, 1:], new_ssm)


def mamba_decode_apply(params: dict, x: torch.Tensor, cfg, *, conv_state: torch.Tensor,
                       ssm_state: torch.Tensor):
    """One-token step.  x: (B, 1, D); conv_state: (B, k−1, conv_dim);
    ssm_state: (B, H, S, P) f32.  Returns (y, (conv_state, ssm_state)).
    On a mesh ``conv_state`` may be this rank's channel block and
    ``ssm_state`` its heads' state (the module docstring); the new states
    come back in the same blocks."""
    conv_cut = conv_state.shape[-1] != conv_dim(cfg)
    heads_cut = ssm_state.shape[1] != cfg.ssm_heads
    meshes = _tp_meshes(params, cfg)
    if conv_cut or heads_cut or any(mm is not None for mm in meshes):
        from repro_torch.launch.mesh import active_mesh

        mesh = active_mesh()
        conv_full = coll.all_gather(conv_state, mesh, "model", 2) if conv_cut else conv_state
        if heads_cut:
            groups = _head_groups(cfg, mesh)
            if groups is None or any(mm is None for mm in meshes):
                raise NotImplementedError(
                    f"{cfg.name}: an SSM state sliced by heads needs in_proj, the conv and "
                    "out_proj sliced over 'model' by them")
            y, (new_conv, new_ssm) = _mamba_decode_tp(params, x, cfg, mesh, groups,
                                                      conv_full, ssm_state)
        else:
            y, (new_conv, new_ssm) = mamba_decode_apply(
                _gathered(params, cfg, meshes), x, cfg, conv_state=conv_full,
                ssm_state=ssm_state)
        if conv_cut:
            new_conv = coll._own_slice(new_conv, mesh, "model", 2)
        return y, (new_conv, new_ssm)
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
