"""GQA/MHA self- and cross-attention with a ring KV cache or a paged block
pool, and DeepSeek-style MLA with its compressed cache.

Every GQA score stage dispatches through ``repro_torch.core.api`` so
DistrAttention drops in via config.  MLA runs no kernel: its prefill takes
plain DistrAttention with the RoPE dimensions as an exact side channel, or
``attend`` on the concatenated q/k, and its decode attends in the
compressed c_kv space in plain PyTorch, as the reference does.  Caches and
pools are updated in place.

Tensor parallelism: when ``wq`` holds a slice of the heads over "model"
(``distributed.sharding``: column-parallel Q, K and V, row-parallel ``wo``),
``attention_apply`` runs its local heads through the same ``attend`` (the
kernels, or the ring over "context" beside it) and sums ``wo``'s partial
products over "model".  When "model" does not divide the heads the rules
still slice every weight whose columns it divides, cutting heads: those
slices are gathered on use (``collectives.gather_slices``) and every rank
runs the whole layer (``tp_layout``: "gather"); a decode step gathers the
new token's projected columns instead.  A weight held whole although
"model" divides its columns is not a layout the rules give, and raises.

The "seq" layout (``cfg.attn_shard == "seq"``, the reference's
``_constrain_bhnd(x, "seq")``): a training or prefill self-attention on a
"model" axis greater than 1 (and "context" 1), GQA under a kernel impl,
over N ≥ model × ``MIN_RING_SHARD`` positions (``seq_mesh``), shards the
sequence over "model" whether or not "model" divides the heads.  Rank r
owns rows [r·s, (r+1)·s) of the sequence zero-padded to model · s (s =
``ring_attention.shard_len``).  A weight sliced over "model" (by heads or
through them) projects every row (``tp_enter``) and one all-to-all
(``collectives.exchange``) takes its columns to the ranks' positions; a
weight held whole projects the rank's rows alone (its gradient summed over
"model" by ``tp_enter``).  RoPE rotates the rank's absolute positions, the
ring over "model" attends them shard in, shard out
(``ring_attention.ring_attention_shard``: kernels 1 or 2 a hop, the
backward kernels in reverse), and ``wo`` either takes the output back to
its column slices by a second all-to-all and sums the partial products
(``tp_reduce``), or, held whole, multiplies the rank's rows and all-gathers
them.  No weight is gathered; the output is (B, N, D), replicated over
"model", and the returned (k, v) are the rank's positions.  Below the guard,
or off those conditions, the layer runs "heads" or "gather" as above.
Cross-attention runs the same way: Q from the decoder's input and K,
V from the encoder output, each entering the region through ``tp_enter``, so
the encoder output's gradient sums over "model".  MLA's ``wq_b``, ``wk_b``
and ``wv_b`` are sliced by heads and ``wo`` row-parallel; its
down-projections and norms are replicated, so the region starts at their
outputs (the latent q, c_kv and the shared rope key), where each rank's
cotangent is partial.

Serving on a mesh: the decode step's cache lies over "model" as
``serve.kv_cache.cache_pspecs`` says (``cache_layout``).  "heads": the rank
decodes its own KV heads.  "seq": the rank holds every KV head for its
S/model positions.  The columns of the new token's q, k and v that the
rank projects are all-gathered over "model" wherever the weights are
sliced (by heads or through them), so every rank holds every head; the
rank that owns ``pos mod S`` writes the token, every rank runs the decode
kernel over its positions (lengths shifted by its offset) and the ranks'
unnormalised (o, m, l) are all-gathered and merged
(``kernels.decode.merge_splits``): flash decoding across ranks.  ``wo``
then takes the rank's columns of the output and sums over "model".
"whole": the cache is replicated and every rank attends over all of it.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import attend, attend_decode
from repro_torch.core.distr_attention import distr_attention
from repro_torch.distributed import collectives as coll
from repro_torch.kernels import decode as decode_kernels
from repro_torch.kernels.paged_decode import GARBAGE_BLOCK
from repro_torch.models import layers


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, n, _ = x.shape
    return x.reshape(b, n, n_heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _constrain_bhnd(x: torch.Tensor) -> torch.Tensor:
    """The reference's "heads" layout hint for (B, H, N, d)
    (``layers.constrain``).  Its "seq" hint is the "seq" layout
    (``_attention_seq``)."""
    return layers.constrain(x, "data", "model", "seq", None)


def attention_init(generator, cfg, dtype=torch.float32) -> dict:
    dh = cfg.head_dim_
    return {
        "wq": layers.linear_init(generator, cfg.d_model, cfg.n_heads * dh,
                                 bias=cfg.qkv_bias, dtype=dtype),
        "wk": layers.linear_init(generator, cfg.d_model, cfg.n_kv_heads * dh,
                                 bias=cfg.qkv_bias, dtype=dtype),
        "wv": layers.linear_init(generator, cfg.d_model, cfg.n_kv_heads * dh,
                                 bias=cfg.qkv_bias, dtype=dtype),
        "wo": layers.linear_init(generator, cfg.n_heads * dh, cfg.d_model, dtype=dtype),
    }


def attention_axes(cfg) -> dict:
    return {
        "wq": layers.linear_axes(None, "heads", bias=cfg.qkv_bias),
        "wk": layers.linear_axes(None, "kv_heads", bias=cfg.qkv_bias),
        "wv": layers.linear_axes(None, "kv_heads", bias=cfg.qkv_bias),
        "wo": layers.linear_axes("heads", None),
    }


# (weight, its dim the rules slice over "model", whose heads it holds)
_ATTN_WEIGHTS = (("wq", 1, "q"), ("wk", 1, "kv"), ("wv", 1, "kv"), ("wo", 0, "q"))


def tp_layout(params: dict, cfg) -> tuple[str, object]:
    """How ``params`` lie over "model" → (layout, the active mesh or None):
    "whole" (every weight whole), "heads" (every weight sliced by whole
    heads: the rank runs its heads) or "gather" (weights sliced through
    heads, "model" not dividing the head counts: gathered on use, the layer
    runs whole).  Raises for a tree the sharding rules do not give: a slice
    that is not one over the active "model" axis, or a weight held whole
    beside a sliced one although "model" divides its columns."""
    from repro_torch.launch.mesh import active_mesh

    dh = cfg.head_dim_
    full = {"q": cfg.n_heads * dh, "kv": cfg.n_kv_heads * dh}
    held = {name: params[name]["w"].shape[dim] for name, dim, _ in _ATTN_WEIGHTS}
    sliced = {name: held[name] != full[kind] for name, _, kind in _ATTN_WEIGHTS}
    if not any(sliced.values()):
        return "whole", None
    mesh = active_mesh()
    m = coll.axis_size(mesh, "model") if mesh is not None else 1
    for name, _, kind in _ATTN_WEIGHTS:
        if sliced[name] and held[name] * m != full[kind]:
            raise ValueError(f"attention's {name} holds {held[name]} of {full[kind]} columns, "
                             f"which is not its slice over a 'model' axis of {m}")
        if not sliced[name] and full[kind] % m == 0:
            raise NotImplementedError(
                f"attention with {held['wq'] // dh} of {cfg.n_heads} query heads' columns and "
                f"{held['wk'] // dh} of {cfg.n_kv_heads} KV heads': a tensor-parallel split must "
                "slice both (the rules slice every weight whose columns 'model' divides)")
    if cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0:
        return "heads", mesh
    return "gather", mesh


def gathered(params: dict, cfg, mesh) -> dict:
    """``params`` with every weight sliced over "model" put back together
    (``collectives.gather_slices``: the backward takes this rank's slice of
    the replicated cotangent), so every rank runs the whole layer."""
    out = dict(params)
    for name, dim, kind in _ATTN_WEIGHTS:
        full = (cfg.n_heads if kind == "q" else cfg.n_kv_heads) * cfg.head_dim_
        if params[name]["w"].shape[dim] != full:
            out[name] = {key: coll.gather_slices(t, mesh, "model", t.ndim - 1 if key == "b"
                                                 else dim)
                         for key, t in params[name].items()}
    return out


def local_heads(params: dict, cfg) -> tuple[int, int, object]:
    """(query heads, KV heads, the tensor-parallel mesh or None) that
    ``params`` run: their slices over "model" under ``tp_layout`` "heads",
    else the config's (a "gather" layout's weights are gathered first)."""
    layout, mesh = tp_layout(params, cfg)
    if layout != "heads":
        return cfg.n_heads, cfg.n_kv_heads, None
    m = coll.axis_size(mesh, "model")
    return cfg.n_heads // m, cfg.n_kv_heads // m, mesh


def cache_layout(cfg, mesh, key: str = "k", max_len: int | None = None) -> str:
    """How a decode cache of ``key`` lies over "model" under
    ``serve.kv_cache.cache_pspecs``: "seq", "heads" or "whole" (no mesh, a
    "model" of 1, or heads or a ``max_len`` that "model" does not divide).
    The hybrid's ``shared_k`` lies by heads whatever ``cfg.attn_shard``
    says; MLA's ``ckv`` by positions."""
    m = coll.axis_size(mesh, "model") if mesh is not None else 1
    if m == 1:
        return "whole"
    if key == "ckv" or (cfg.attn_shard == "seq" and key != "shared_k"):
        return "seq" if not max_len or max_len % m == 0 else "whole"
    return "heads" if cfg.n_kv_heads % m == 0 else "whole"


def seq_layout(cfg, mesh, n: int) -> bool:
    """Whether a self-attention over ``n`` positions on ``mesh`` takes the
    "seq" layout (see the module docstring).  The hybrid's shared blocks
    keep theirs (their cache lies by heads, ``cache_layout``)."""
    from repro_torch.distributed.ring_attention import MIN_RING_SHARD

    if (mesh is None or cfg.attn_shard != "seq" or cfg.use_mla or cfg.family == "hybrid"
            or cfg.attention.impl not in ("pallas_flash", "pallas_distr")):
        return False
    m = coll.axis_size(mesh, "model")
    return m > 1 and coll.axis_size(mesh, "context") == 1 and n >= m * MIN_RING_SHARD


def seq_mesh(cfg, n: int):
    """The active mesh when a self-attention over ``n`` positions takes the
    "seq" layout (``seq_layout``), else None."""
    from repro_torch.launch.mesh import active_mesh

    mesh = active_mesh()
    return mesh if seq_layout(cfg, mesh, n) else None


def _own_rows(t: torch.Tensor, mesh, shard: int) -> torch.Tensor:
    """This rank's rows [r·shard, (r+1)·shard) of ``t`` (B, N, ...) along
    dim 1, zero-padded past N."""
    lo = int(mesh.coords["model"]) * shard
    part = t[:, lo:lo + shard]
    if part.shape[1] < shard:
        pad = part.new_zeros((part.shape[0], shard - part.shape[1], *part.shape[2:]))
        part = torch.cat([part, pad], dim=1)
    return part


def _cols_to_rows(t: torch.Tensor, mesh, shard: int) -> torch.Tensor:
    """(B, N, C/m) this rank's column slice at every position → (B, s, C)
    every column at this rank's positions: one all-to-all over "model"."""
    b, n, c = t.shape
    m = coll.axis_size(mesh, "model")
    if m * shard > n:
        t = torch.cat([t, t.new_zeros((b, m * shard - n, c))], dim=1)
    parts = t.reshape(b, m, shard, c).transpose(0, 1).contiguous()  # chunk j: rank j's rows
    got = coll.exchange(parts, mesh, "model")  # chunk i: rank i's columns
    return got.permute(1, 2, 0, 3).reshape(b, shard, m * c)


def _rows_to_cols(t: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """``_cols_to_rows``' inverse: (B, s, C) at this rank's positions →
    (B, N, C/m) this rank's column slice at every position (the padding
    dropped)."""
    b, shard, c = t.shape
    m = coll.axis_size(mesh, "model")
    parts = t.reshape(b, shard, m, c // m).permute(2, 0, 1, 3).contiguous()  # chunk j: cols j
    got = coll.exchange(parts, mesh, "model")  # chunk i: rank i's rows
    return got.transpose(0, 1).reshape(b, m * shard, c // m)[:, :n]


def _entered(p: dict, mesh) -> dict:
    """A weight held whole, entering the region: each rank's gradient
    (from its rows alone) is summed over "model" (``tp_enter``)."""
    return {key: coll.tp_enter(t, mesh) for key, t in p.items()}


def _attention_seq(params: dict, x: torch.Tensor, cfg, mesh, *, positions, causal: bool,
                   proj, use_rope: bool):
    """The "seq" layout of ``attention_apply`` (see the module docstring)
    → (out (B, N, D) replicated over "model", (k, v) (B, Hkv, s, dh) at this
    rank's positions)."""
    from repro_torch.distributed import ring_attention as ring

    b, n, _ = x.shape
    dh = cfg.head_dim_
    shard = ring.shard_len(cfg.attention, n, coll.axis_size(mesh, "model"), d=dh,
                           dtype=x.dtype, causal=causal, device=x.device)
    x = coll.tp_enter(x, mesh)
    x_own = None

    def project(name: str, heads: int) -> torch.Tensor:
        nonlocal x_own
        p = params[name]
        if p["w"].shape[1] == heads * dh:  # whole: this rank's rows alone
            if x_own is None:
                x_own = _own_rows(x, mesh, shard)
            t = layers.linear_apply(_entered(p, mesh), x_own)
        else:  # a column slice: every row, then to this rank's positions
            t = _cols_to_rows(layers.linear_apply(p, x), mesh, shard)
        return _split_heads(t, heads)

    q, k, v = (project(name, h) for name, h in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                                                  ("wv", cfg.n_kv_heads)))
    if use_rope:
        if positions is None:
            positions = torch.arange(n, device=x.device).expand(b, n)
        pos = _own_rows(positions, mesh, shard)
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
    o = _merge_heads(ring.ring_attention_shard(q, k, v, cfg.attention, mesh, n_live=n,
                                               axis="model", causal=causal, proj=proj))
    wo = params["wo"]
    if wo["w"].shape[0] == cfg.n_heads * dh:  # whole: this rank's rows, gathered
        out = layers.linear_apply(_entered(wo, mesh), o)
        return coll.gather_slices(out, mesh, "model", 1)[:, :n], (k, v)
    out = layers.linear_apply(wo, _rows_to_cols(o, mesh, n))
    return coll.tp_reduce(out, mesh), (k, v)


def attention_apply(params: dict, x: torch.Tensor, cfg, *,
                    positions: torch.Tensor | None = None, causal: bool = True,
                    proj: torch.Tensor | None = None, x_kv: torch.Tensor | None = None,
                    use_rope: bool | None = None):
    """Self-attention for prefill and training, or cross-attention when
    ``x_kv`` (B, Nk, D) is given: Q from ``x``, K and V projected from
    ``x_kv``.  RoPE (``use_rope``, default ``cfg.pos == "rope"``) rotates Q
    at ``positions`` and K at ``positions`` (self) or 0..Nk-1 (cross).
    Returns ``(out, (k, v))`` with the raw per-head K/V (B, Hkv, Nk, dh) so
    the serve layer can build caches; under the "seq" layout (``seq_mesh``)
    they are this rank's positions (B, Hkv, s, dh)."""
    b, n, _ = x.shape
    use_rope = cfg.pos == "rope" if use_rope is None else use_rope
    mesh = seq_mesh(cfg, n) if x_kv is None else None
    if mesh is not None:
        return _attention_seq(params, x, cfg, mesh, positions=positions, causal=causal,
                              proj=proj, use_rope=use_rope)
    params, hq, hkv, mesh = heads_to_run(params, cfg)
    if mesh is not None:
        x = coll.tp_enter(x, mesh)
        if x_kv is not None:
            x_kv = coll.tp_enter(x_kv, mesh)
    src = x if x_kv is None else x_kv
    q = _split_heads(layers.linear_apply(params["wq"], x), hq)
    k = _split_heads(layers.linear_apply(params["wk"], src), hkv)
    v = _split_heads(layers.linear_apply(params["wv"], src), hkv)
    if use_rope:
        if positions is None:
            positions = torch.arange(n, device=x.device).expand(b, n)
        kv_positions = (positions if x_kv is None else
                        torch.arange(src.shape[1], device=x.device).expand(b, src.shape[1]))
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, kv_positions, cfg.rope_theta)
    q, k, v = (_constrain_bhnd(t) for t in (q, k, v))
    o = _constrain_bhnd(attend(q, k, v, cfg.attention, causal=causal, proj=proj))
    out = layers.linear_apply(params["wo"], _merge_heads(o))
    return (out if mesh is None else coll.tp_reduce(out, mesh)), (k, v)


def _as_pos_vector(cache_index, b: int, device) -> torch.Tensor:
    idx = torch.as_tensor(cache_index, dtype=torch.int64, device=device)
    return idx.expand(b) if idx.ndim == 0 else idx


def cache_insert(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write per-batch rows at per-batch positions, in place (ring layout).

    cache: (B, H, S, d); new: (B, H, 1, d); pos: (B,) absolute positions —
    the write slot is ``pos mod S``.  Returns ``cache``.
    """
    b, _, s, _ = cache.shape
    rows = torch.arange(b, device=cache.device)
    cache[rows, :, pos.to(torch.int64) % s] = new[:, :, 0].to(cache.dtype)
    return cache


def _live_lengths(length, pos: torch.Tensor, max_len: int) -> torch.Tensor:
    total = length if length is not None else pos + 1
    return torch.clamp(torch.as_tensor(total, dtype=torch.int32, device=pos.device),
                       max=max_len)


def _heads_of(params: dict, name: str, x: torch.Tensor, cfg, mesh=None) -> torch.Tensor:
    """``x`` through ``params[name]`` (``wq``, ``wk`` or ``wv``) split into
    heads: this rank's heads where the weight is sliced over "model", or,
    given the ``mesh``, every head, the rank's columns all-gathered over
    "model" (B × N × C: a slice that cuts a head is whole again)."""
    t = layers.linear_apply(params[name], x)
    heads = cfg.n_heads if name == "wq" else cfg.n_kv_heads
    if mesh is not None and t.shape[-1] != heads * cfg.head_dim_:
        t = coll.all_gather(t, mesh, "model", t.ndim - 1)
    return _split_heads(t, t.shape[-1] // cfg.head_dim_)


def _rope_at(t: torch.Tensor, pos: torch.Tensor, cfg) -> torch.Tensor:
    """``t`` (B, H, 1, dh) rotated to the token's absolute position ``pos``
    (B,) when ``cfg.pos == "rope"``."""
    return layers.apply_rope(t, pos[:, None], cfg.rope_theta) if cfg.pos == "rope" else t


def _decode_mesh(params: dict, cfg, layout: str):
    """The mesh the decode's weights are sliced over (``tp_layout``), or
    None.  A cache sliced by heads (``layout`` "heads") needs weights
    sliced by heads."""
    tp, mesh = tp_layout(params, cfg)
    if layout == "heads" and tp != "heads":
        raise NotImplementedError(f"{cfg.name}: a cache sliced by heads needs weights sliced "
                                  "by heads")
    return mesh


def _seq_insert(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor, mesh) -> None:
    """Write the new token into a cache whose positions lie over "model"
    (this rank's S_loc of S = S_loc · model), in place: only on the rank that
    owns ``pos mod S``; the others write back what they hold."""
    b, _, s_loc, _ = cache.shape
    m = coll.axis_size(mesh, "model")
    local = pos.to(torch.int64) % (s_loc * m) - int(mesh.coords["model"]) * s_loc
    mine = (local >= 0) & (local < s_loc)
    rows = torch.arange(b, device=cache.device)
    at = local.clamp(0, s_loc - 1)
    cache[rows, :, at] = torch.where(mine[:, None, None], new[:, :, 0].to(cache.dtype),
                                     cache[rows, :, at])


def _attend_seq(q, cache_k, cache_v, cfg, lengths: torch.Tensor, mesh, **kw) -> torch.Tensor:
    """Decode over every rank's positions of a sequence-sharded cache: the
    rank's (o, m, l) over its positions (``lengths`` the global live
    counts, shifted by its offset; a rank with none gives the identity),
    all-gathered over "model" and merged.  → (B, Hq, q_len, d) f32."""
    s_loc = cache_v.shape[2]
    off = int(mesh.coords["model"]) * s_loc
    local = torch.clamp(lengths.to(torch.int32) - off, min=0, max=s_loc)
    o, m, l = attend_decode(q, cache_k, cache_v, cfg.attention, lengths=local,
                            return_stats=True, **kw)
    o, m, l = (coll.all_gather(t.unsqueeze(2), mesh, "model", 2) for t in (o, m, l))
    return decode_kernels.merge_splits(o, m, l)


def _decode_self(params: dict, x: torch.Tensor, cfg, *, pos: torch.Tensor, cache_v,
                 cache_k=None, cache_k_fused=None, perm=None, length=None,
                 layout: str = "whole") -> torch.Tensor:
    """One-token self-attention against a ring cache lying over "model" as
    ``layout`` says (``cache_layout``; see the module docstring), raw K or
    the fused K̂ under the layer's static ``perm`` (Hkv, dh).  Writes the
    token's K (or K̂) and V in place; returns the block's attention output."""
    from repro_torch.launch.mesh import active_mesh
    from repro_torch.serve import kv_cache as kvc

    mesh = _decode_mesh(params, cfg, layout)
    every = mesh if layout != "heads" else None
    q, k, v = (_heads_of(params, name, x, cfg, every) for name in ("wq", "wk", "wv"))
    q, k = _rope_at(q, pos, cfg), _rope_at(k, pos, cfg)
    fused = cache_k_fused is not None
    cache_s = cache_k_fused if fused else cache_k
    if fused and layout == "heads":
        r, hkv = int(mesh.coords["model"]), k.shape[1]
        perm = perm[r * hkv:(r + 1) * hkv]
    kw = {}
    if fused:
        g = cfg.attention.distr.group_size
        k = kvc.fuse_new_k(k, perm, g)
        kw = dict(k_fused=cache_k_fused, perm=perm, group_size=g,
                  scale=1.0 / (cfg.head_dim_ ** 0.5))
    k_in = None if fused else cache_k
    if layout == "seq":
        kv_mesh = active_mesh()
        _seq_insert(cache_v, v, pos, kv_mesh)
        _seq_insert(cache_s, k, pos, kv_mesh)
        capacity = cache_v.shape[2] * coll.axis_size(kv_mesh, "model")
        o = _attend_seq(q, k_in, cache_v, cfg, _live_lengths(length, pos, capacity), kv_mesh,
                        **kw)
    else:
        cache_insert(cache_v, v, pos)
        cache_insert(cache_s, k, pos)
        o = attend_decode(q, k_in, cache_v, cfg.attention,
                          lengths=_live_lengths(length, pos, cache_v.shape[2]), **kw)
    return _decode_out(params, o, x, cfg, mesh)


def heads_to_run(params: dict, cfg):
    """(params to run — a "gather" layout's weights gathered —, their query
    heads, KV heads, the heads-parallel mesh or None)."""
    tp, mesh = tp_layout(params, cfg)
    if tp == "gather":
        params = gathered(params, cfg, mesh)
    hq, hkv, mesh = local_heads(params, cfg)
    return params, hq, hkv, mesh


def _decode_out(params: dict, o: torch.Tensor, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``wo`` over the attention's output (B, H, 1, dh).  Where ``wo`` holds
    a slice of its rows over "model", the rank multiplies its columns of
    the output (all of them unless it attended its own heads alone) and the
    partial products are summed over "model"."""
    o = _merge_heads(o.to(x.dtype))
    rows = params["wo"]["w"].shape[0]
    if o.shape[-1] != rows:
        o = o.narrow(-1, int(mesh.coords["model"]) * rows, rows)
    out = layers.linear_apply(params["wo"], o)
    return out if rows == cfg.n_heads * cfg.head_dim_ else coll.tp_reduce(out, mesh)


def _decode_cross(params: dict, x: torch.Tensor, cfg, *, pos: torch.Tensor, cache_k, cache_v,
                  cross_len: torch.Tensor, layout: str) -> torch.Tensor:
    """Cross-attention of one token over the encoder cache lying over
    "model" as ``layout`` says; writes nothing."""
    from repro_torch.launch.mesh import active_mesh

    mesh = _decode_mesh(params, cfg, layout)
    q = _rope_at(_heads_of(params, "wq", x, cfg, mesh if layout != "heads" else None), pos, cfg)
    if layout == "seq":
        kv_mesh = active_mesh()
        capacity = cache_k.shape[2] * coll.axis_size(kv_mesh, "model")
        o = _attend_seq(q, cache_k, cache_v, cfg,
                        torch.clamp(cross_len.to(torch.int32), max=capacity), kv_mesh)
    else:
        o = attend_decode(q, cache_k, cache_v, cfg.attention,
                          lengths=torch.clamp(cross_len.to(torch.int32), max=cache_k.shape[2]))
    return _decode_out(params, o, x, cfg, mesh)


def attention_decode_apply(params: dict, x: torch.Tensor, cfg, *,
                           cache_k: torch.Tensor, cache_v: torch.Tensor,
                           cache_index, length: torch.Tensor | None = None,
                           is_cross: bool = False, cross_len: torch.Tensor | None = None,
                           layout: str = "whole"):
    """One-token decode against a (B, Hkv, S, dh) ring cache: inserts the
    new K/V at ``cache_index`` (in place) and attends over the live window
    through the split-K decode kernel.  Cross-attention (``is_cross``)
    reads the prefilled encoder cache and inserts nothing: each slot
    attends over its first ``min(cross_len, S)`` positions (``cross_len``
    (B,) is required).  ``layout`` is how the cache lies over "model"
    (``cache_layout``).  Returns ``(out, (cache_k, cache_v))``."""
    pos = _as_pos_vector(cache_index, x.shape[0], x.device)
    if is_cross:
        if cross_len is None:
            raise ValueError("cross-attention decode needs the slots' cross_len")
        out = _decode_cross(params, x, cfg, pos=pos, cache_k=cache_k, cache_v=cache_v,
                            cross_len=cross_len, layout=layout)
    else:
        out = _decode_self(params, x, cfg, pos=pos, cache_v=cache_v, cache_k=cache_k,
                           length=length, layout=layout)
    return out, (cache_k, cache_v)


def attention_decode_fused(params: dict, x: torch.Tensor, cfg, *,
                           cache_v: torch.Tensor, cache_k_fused: torch.Tensor,
                           perm: torch.Tensor, cache_index,
                           length: torch.Tensor | None = None, layout: str = "whole"):
    """One-token decode against the fused-K̂ ring cache: scores read K̂
    (B, Hkv, S, dh/G*) under the layer's static ``perm`` (Hkv, dh) in place
    of K, so the split-K decode kernel streams d/G* score columns a token.
    Writes V and the newly fused K̂ row in place at ``cache_index``; raw K
    is neither read nor written (it stays as the prefill left it).
    ``layout`` as ``attention_decode_apply``'s.  Returns ``(out, (cache_v,
    cache_k_fused))``."""
    pos = _as_pos_vector(cache_index, x.shape[0], x.device)
    out = _decode_self(params, x, cfg, pos=pos, cache_v=cache_v, cache_k_fused=cache_k_fused,
                       perm=perm, length=length, layout=layout)
    return out, (cache_v, cache_k_fused)


def paged_insert(pool: torch.Tensor, new: torch.Tensor, block_tables: torch.Tensor,
                 pos: torch.Tensor, count: torch.Tensor | None = None) -> torch.Tensor:
    """Write a token window into a paged pool through the block table, in
    place.

    pool: (P, Hkv, bs, d); new: (B, Hkv, w, d); block_tables: (B,
    max_blocks); pos: (B,) start positions.  Token t of request b lands in
    block ``bt[b, (pos + t) // bs]`` at offset ``(pos + t) % bs``.  Rows
    ``t ≥ count[b]`` (chunk padding, idle lanes) and positions past the
    table's capacity go to the garbage block, whose content is never read.
    Returns ``pool``.
    """
    bs = pool.shape[2]
    b, hkv, w, d = new.shape
    max_blocks = block_tables.shape[1]
    p = pos.to(torch.int64)[:, None] + torch.arange(w, device=pool.device)[None, :]
    blk_idx = torch.clamp(p // bs, max=max_blocks - 1)
    blk = torch.gather(block_tables.to(torch.int64), 1, blk_idx)  # (B, w)
    live = torch.arange(w, device=pool.device)[None, :] < (
        count.to(torch.int64)[:, None] if count is not None else w)
    # Past capacity a clamped index would overwrite the last live block.
    live = live & (p < max_blocks * bs)
    blk = torch.where(live, blk, GARBAGE_BLOCK)
    vals = new.to(pool.dtype).transpose(1, 2).reshape(b * w, hkv, d)
    pool[blk.reshape(-1), :, (p % bs).reshape(-1)] = vals
    return pool


def attention_decode_paged(params: dict, x: torch.Tensor, cfg, *,
                           pool_k: torch.Tensor | None, pool_v: torch.Tensor,
                           block_tables: torch.Tensor, cache_index,
                           count: torch.Tensor | None = None,
                           pool_k_fused: torch.Tensor | None = None,
                           perm: torch.Tensor | None = None):
    """Windowed decode against the paged pool (w = 1: a decode tick; w = the
    chunk width: chunked prefill).

    x: (B, w, d_model); ``cache_index`` (B,) start positions; ``count`` (B,)
    live tokens of the window (padded rows write to the garbage block and
    the caller ignores their outputs).  Token t sees positions ≤ pos + t,
    so a chunk reproduces causal prefill exactly.  The fused-K̂ variant
    takes ``pool_k_fused`` and the layer's static ``perm``; raw K is then
    neither read nor written.

    Decode slides past the table's capacity: the write position wraps
    (``pos % capacity``), recycling the request's head blocks, and the
    kernel attends ``min(pos + w, capacity)`` positions; RoPE stays at the
    absolute position, as in the slot engine's ring.  Pools are updated in
    place; returns ``(out, (pool_k, pool_v, pool_k_fused))``.
    """
    from repro_torch.serve import kv_cache as kvc

    b, w, _ = x.shape
    pos = _as_pos_vector(cache_index, b, x.device)
    positions = pos[:, None] + torch.arange(w, device=x.device)[None, :]
    q = _split_heads(layers.linear_apply(params["wq"], x), cfg.n_heads)
    k = _split_heads(layers.linear_apply(params["wk"], x), cfg.n_kv_heads)
    v = _split_heads(layers.linear_apply(params["wv"], x), cfg.n_kv_heads)
    if cfg.pos == "rope":
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)

    capacity = block_tables.shape[1] * pool_v.shape[2]
    wpos = pos % capacity
    paged_insert(pool_v, v, block_tables, wpos, count)
    scale = 1.0 / (cfg.head_dim_ ** 0.5)
    # The kernel's lengths include the whole window: live row t's band
    # col < pos + t + 1 lands on its own position; padded rows widen only
    # their own (discarded) reads.  Past capacity every position is live.
    lengths = torch.clamp(pos + w, max=capacity).to(torch.int32)
    if pool_k_fused is not None:
        g = cfg.attention.distr.group_size
        paged_insert(pool_k_fused, kvc.fuse_new_k(k, perm, g), block_tables, wpos, count)
        o = attend_decode(q, None, pool_v, cfg.attention, lengths=lengths,
                          k_fused=pool_k_fused, perm=perm, group_size=g, scale=scale,
                          block_tables=block_tables)
    else:
        paged_insert(pool_k, k, block_tables, wpos, count)
        o = attend_decode(q, pool_k, pool_v, cfg.attention, lengths=lengths, scale=scale,
                          block_tables=block_tables)
    out = layers.linear_apply(params["wo"], _merge_heads(o.to(x.dtype)))
    return out, (pool_k, pool_v, pool_k_fused)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank Q, compressed KV cache, decoupled RoPE
# ---------------------------------------------------------------------------


def mla_init(generator, cfg, dtype=torch.float32) -> dict:
    h = cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dev = generator.device
    return {
        "wq_a": layers.linear_init(generator, cfg.d_model, cfg.q_lora_rank, dtype=dtype),
        "q_norm": layers.rmsnorm_init(cfg.q_lora_rank, dev),
        "wq_b": layers.linear_init(generator, cfg.q_lora_rank, h * (nope + rope_d), dtype=dtype),
        "wkv_a": layers.linear_init(generator, cfg.d_model, cfg.kv_lora_rank + rope_d,
                                    dtype=dtype),
        "kv_norm": layers.rmsnorm_init(cfg.kv_lora_rank, dev),
        "wk_b": layers.linear_init(generator, cfg.kv_lora_rank, h * nope, dtype=dtype),
        "wv_b": layers.linear_init(generator, cfg.kv_lora_rank, h * vd, dtype=dtype),
        "wo": layers.linear_init(generator, h * vd, cfg.d_model, dtype=dtype),
    }


def mla_axes(cfg) -> dict:
    return {
        "wq_a": layers.linear_axes(None, None),
        "q_norm": layers.rmsnorm_axes(),
        "wq_b": layers.linear_axes(None, "heads"),
        "wkv_a": layers.linear_axes(None, None),
        "kv_norm": layers.rmsnorm_axes(),
        "wk_b": layers.linear_axes(None, "heads"),
        "wv_b": layers.linear_axes(None, "heads"),
        "wo": layers.linear_axes("heads", None),
    }


def mla_local_heads(params: dict, cfg):
    """(the heads ``params`` holds, the tensor-parallel mesh or None): all
    of them, or their slice over "model" in ``wq_b``, ``wk_b`` and ``wv_b``
    alike (a slice of one without the others raises)."""
    h = params["wq_b"]["w"].shape[1] // (cfg.qk_nope_dim + cfg.qk_rope_dim)
    mesh = layers.tp_mesh(h, cfg.n_heads)
    if (params["wk_b"]["w"].shape[1] != h * cfg.qk_nope_dim
            or params["wv_b"]["w"].shape[1] != h * cfg.v_head_dim):
        raise NotImplementedError(
            f"MLA with {h} of {cfg.n_heads} heads in wq_b and wk_b / wv_b of other widths: "
            "a tensor-parallel split must slice all three by heads")
    return h, mesh


def _mla_qkv(params: dict, x: torch.Tensor, cfg, positions: torch.Tensor | None,
             h: int | None = None, mesh=None):
    """The shared projections → q_nope, q_rope (B, h, N, ·), c_kv (B, N,
    kv_lora) and k_rope (B, 1, N, rope_d), q_rope and k_rope rotated; h
    heads (default all).  With a tensor-parallel ``mesh`` the latent q,
    c_kv and k_rope enter the region (``tp_enter``)."""
    b, n, _ = x.shape
    nope = cfg.qk_nope_dim
    q_l = layers.rmsnorm_apply(params["q_norm"], layers.linear_apply(params["wq_a"], x))
    kv_a = layers.linear_apply(params["wkv_a"], x)
    c_kv = layers.rmsnorm_apply(params["kv_norm"], kv_a[..., :cfg.kv_lora_rank])
    k_rope = kv_a[..., cfg.kv_lora_rank:][:, None]  # (B, 1, N, rope_d)
    if mesh is not None:
        q_l, c_kv, k_rope = (coll.tp_enter(t, mesh) for t in (q_l, c_kv, k_rope))
    q = _split_heads(layers.linear_apply(params["wq_b"], q_l), h or cfg.n_heads)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    if positions is None:
        positions = torch.arange(n, device=x.device).expand(b, n)
    return (q_nope, layers.apply_rope(q_rope, positions, cfg.rope_theta), c_kv,
            layers.apply_rope(k_rope, positions, cfg.rope_theta))


def mla_apply(params: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor | None = None,
              causal: bool = True, proj: torch.Tensor | None = None):
    """MLA for prefill and training, K and V up-projected from c_kv.

    Under ``distr`` and ``pallas_distr`` the scores group the nope
    dimensions (plain DistrAttention under the LSH projection ``proj``) and
    take the RoPE dimensions exactly; the other impls attend over the
    concatenated q/k.  ``pallas_flash`` raises: the flash kernel needs V as
    wide as Q, and MLA's V is narrower.  Returns ``(out, (c_kv, k_rope))``,
    the cache parts.  ``wq_b``, ``wk_b`` and ``wv_b`` sliced by heads over
    "model" run this rank's heads and sum ``wo``'s partial products."""
    b, n, _ = x.shape
    h, mesh = mla_local_heads(params, cfg)
    rope_d = cfg.qk_rope_dim
    impl = cfg.attention.impl
    if impl == "pallas_flash":
        raise ValueError(
            f"MLA under pallas_flash: the flash kernel needs V as wide as Q, and MLA's "
            f"V has {cfg.v_head_dim} columns against {cfg.qk_head_dim}; "
            "use distr, pallas_distr, xla_flash or reference")
    scale = 1.0 / (cfg.qk_head_dim ** 0.5)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, cfg, positions, h, mesh)
    k_nope = _split_heads(layers.linear_apply(params["wk_b"], c_kv), h)
    v = _split_heads(layers.linear_apply(params["wv_b"], c_kv), h)
    k_rope_h = k_rope.expand(b, h, n, rope_d)
    if impl in ("distr", "pallas_distr"):
        o = distr_attention(q_nope, k_nope, v, cfg.attention.distr, causal=causal,
                            scale=scale, proj=proj, q_exact=q_rope, k_exact=k_rope_h)
    else:
        o = attend(torch.cat([q_nope, q_rope], dim=-1), torch.cat([k_nope, k_rope_h], dim=-1),
                   v, cfg.attention, causal=causal, scale=scale)
    out = layers.linear_apply(params["wo"], _merge_heads(o))
    return (out if mesh is None else coll.tp_reduce(out, mesh)), (c_kv, k_rope)


def mla_decode_apply(params: dict, x: torch.Tensor, cfg, *, cache_ckv: torch.Tensor,
                     cache_krope: torch.Tensor, cache_index, layout: str = "whole"):
    """Absorbed-matrix MLA decode, attending in the compressed c_kv space.

    Scores are q_nope·W_ukᵀ·c_kv + q_rope·k_rope and the output (P·c_kv)·W_uv,
    so the cache holds kv_lora + rope_d values a token and nothing is
    up-projected.  Writes the new token's c_kv and k_rope at ``cache_index``
    (B,), clamped to the last position as a ``dynamic_update_slice`` clamps,
    into ``cache_ckv`` (B, S, kv_lora) and ``cache_krope`` (B, S, rope_d) in
    place; the slot attends over positions ≤ its index.  Cache reads
    accumulate in f32; the softmax weights are rounded to the cache's dtype
    before the context product, as the reference's are.

    On a mesh: ``wq_b``, ``wk_b`` and ``wv_b`` sliced by heads run this
    rank's heads and sum ``wo``'s partial products over "model".  Under
    ``layout`` "seq" the cache holds this rank's S/model positions: the
    token lands on the rank that owns its position, every head's absorbed q
    (all-gathered over "model") meets the rank's positions, the softmax's
    max and sum are reduced over "model" so that each rank rounds the
    weights one device would, and the ranks' contexts are summed.  Returns
    ``(out, (cache_ckv, cache_krope))``."""
    from repro_torch.launch.mesh import active_mesh

    b = x.shape[0]
    h, mesh = mla_local_heads(params, cfg)
    nope, vd, c = cfg.qk_nope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    scale = 1.0 / (cfg.qk_head_dim ** 0.5)
    pos = _as_pos_vector(cache_index, b, x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(params, x, cfg, pos[:, None], h)
    s_loc = cache_ckv.shape[1]
    kv_mesh = active_mesh() if layout == "seq" else None
    m = coll.axis_size(kv_mesh, "model") if kv_mesh is not None else 1
    off = int(kv_mesh.coords["model"]) * s_loc if m > 1 else 0
    local = torch.clamp(pos.to(torch.int64), max=s_loc * m - 1) - off
    mine = (local >= 0) & (local < s_loc)
    rows = torch.arange(b, device=x.device)
    at = local.clamp(0, s_loc - 1)
    cache_ckv[rows, at] = torch.where(mine[:, None], c_kv_new[:, 0].to(cache_ckv.dtype),
                                      cache_ckv[rows, at])
    cache_krope[rows, at] = torch.where(mine[:, None],
                                        k_rope_new[:, 0, 0].to(cache_krope.dtype),
                                        cache_krope[rows, at])
    w_uk = params["wk_b"]["w"].reshape(c, h, nope)
    q_abs = torch.einsum("bhnd,chd->bhnc", q_nope.float(), w_uk.float())
    if mesh is not None and m > 1:
        q_abs, q_rope = (coll.all_gather(t, mesh, "model", 1) for t in (q_abs, q_rope))
    ckv = cache_ckv.float()
    s = torch.einsum("bhnc,bsc->bhns", q_abs.to(cache_ckv.dtype).float(), ckv)
    s = s + torch.einsum("bhnr,bsr->bhns", q_rope.to(cache_krope.dtype).float(),
                         cache_krope.float())
    s = s * scale
    live = (off + torch.arange(s_loc, device=x.device))[None, :] <= pos[:, None]
    s = torch.where(live[:, None, None, :], s, -1e30)
    mx = s.amax(dim=-1, keepdim=True)
    if m > 1:
        mx = coll.all_reduce(mx, kv_mesh, "model", op="max")
    p = torch.exp(s - mx)
    total = p.sum(dim=-1, keepdim=True)
    if m > 1:
        total = coll.all_reduce(total, kv_mesh, "model")
    ctx = torch.einsum("bhns,bsc->bhnc", (p / total).to(cache_ckv.dtype).float(), ckv)
    if m > 1:
        ctx = coll.all_reduce(ctx, kv_mesh, "model")
        if mesh is not None:
            ctx = ctx.narrow(1, int(mesh.coords["model"]) * h, h)
    w_uv = params["wv_b"]["w"].reshape(c, h, vd)
    o = torch.einsum("bhnc,chd->bhnd", ctx, w_uv.float())
    out = layers.linear_apply(params["wo"], _merge_heads(o.to(x.dtype)))
    return (out if mesh is None else coll.tp_reduce(out, mesh)), (cache_ckv, cache_krope)
