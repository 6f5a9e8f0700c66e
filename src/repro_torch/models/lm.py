"""Decoder LMs of the dense, moe, ssm and hybrid families and the enc-dec
family: init, trunk, logits, loss.

Parameters are a dict: ``embed``, ``pos_embed`` (the learned position
table, when ``cfg.pos == "learned"``), the family's layers, ``final_norm``,
``lm_head`` (absent under tied embeddings, where the LM head reads the
embedding table) and ``lsh_proj`` — the fixed LSH projection of the
DistrAttention impls, model state drawn once at init and never trained.
The layers: ``blocks`` (one dict per layer) for dense and ssm; for moe
``dense_blocks`` (the first ``first_dense_layers`` layers, dense FFN; absent
when there are none) and ``blocks`` (the MoE layers), GQA or MLA attention
in both; for hybrid
``groups`` (n_groups lists of ``attn_every`` Mamba layers), ``tail`` (the
Mamba layers past the last group, when there are any) and ``shared`` (the
``n_shared_attn_blocks`` shared attention blocks; group ``gi`` is followed
by block ``gi % n_shared_attn_blocks``); for encdec ``enc_blocks`` (the
encoder's non-causal layers), ``enc_norm`` and ``blocks`` (decoder layers
with cross-attention to the encoder output).  Per-layer Python loops stand
in for the reference's ``lax.scan``, and ``param_axes`` gives the logical
axes of every trained leaf at its path (a layer list's entries each get
their layer's axes, where the reference prepends a stack dim).

On a mesh (``launch.mesh.set_mesh``, ``train.train_step``): under FSDP a
block's ``"data"``-sharded parameters are gathered on use, inside its remat
checkpoint (``distributed.sharding.gather_on_use``), and the other
parameters once a step; the dense family runs tensor parallel over "model"
(``models.layers``, ``models.attention``), its embedding vocab-parallel and
its loss a vocab-parallel cross-entropy; ``loss_fn`` normalises by the
labels of the whole batch the data-parallel ranks split, so the ranks'
losses sum to the single device's.

The stub frontends: an enc-dec model encodes ``frames`` (B, N_enc,
d_model), precomputed frame embeddings; a ``patch_stub`` model prepends
``patches`` (B, P, d_model) to the embedded tokens, positions running over
prefix and text, and its logits drop the P prefix rows.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import lsh
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.models import layers, transformer
from repro_torch.utils.device import resolve_device

PAD_LOGIT = -1e30
Z_LOSS_WEIGHT = 1e-4
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
# The parameter subtrees that are lists of layers (the reference's stacked
# ``STACKED_KEYS``); ``groups`` is a list of lists.
LAYER_KEYS = ("blocks", "dense_blocks", "enc_blocks", "groups", "tail")


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def compute_dtype(cfg) -> torch.dtype:
    return _dtype(cfg.compute_dtype)


def param_dtype(cfg) -> torch.dtype:
    """The dtype training holds its master weights in."""
    return _dtype(cfg.param_dtype)


def init_lsh_projection(cfg, device) -> torch.Tensor:
    """The LSH projection drawn from ``proj_seed`` on a CPU generator."""
    dcfg = cfg.attention.distr.resolved()
    gen = torch.Generator().manual_seed(dcfg.proj_seed)
    return lsh.make_projection(gen, dcfg.block_q).to(device)


def hybrid_layout(cfg) -> tuple[int, int]:
    """(n_groups, n_tail) of the hybrid's Mamba / shared-attention interleave."""
    n_groups = cfg.n_layers // cfg.attn_every
    return n_groups, cfg.n_layers - n_groups * cfg.attn_every


def n_encoder_layers(cfg) -> int:
    return cfg.n_encoder_layers or cfg.n_layers


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves the {', '.join(FAMILIES)} families")


def init_params(cfg, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda", dtype: torch.dtype | None = None) -> dict:
    """Random weights with the reference's distributions, drawn on
    ``device``: linear ``normal · d_in^-0.5`` with zero biases, embedding
    ``normal · 0.02``, norms ones/zeros.  Matmul weights, embeddings and
    biases are held in ``dtype`` — by default the compute dtype, as serving
    holds them; training passes ``param_dtype(cfg)`` — and norm parameters in
    f32.  Raises when ``device`` is CUDA and CUDA is absent."""
    check_family(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = (_MetaGenerator() if dev.type == "meta" else
                     torch.Generator(device=dev).manual_seed(0))
    dtype = dtype or compute_dtype(cfg)
    params = {"embed": layers.embedding_init(generator, cfg.padded_vocab, cfg.d_model, dtype)}
    if cfg.pos == "learned":
        params["pos_embed"] = layers.embedding_init(generator, cfg.learned_pos_len,
                                                    cfg.d_model, dtype)

    def mamba_layers(n: int) -> list:
        return [transformer.block_init(generator, cfg, dtype, "mamba") for _ in range(n)]

    if cfg.family == "dense":
        params["blocks"] = [transformer.block_init(generator, cfg, dtype)
                            for _ in range(cfg.n_layers)]
    elif cfg.family == "moe":
        if cfg.first_dense_layers:
            params["dense_blocks"] = [transformer.block_init(generator, cfg, dtype)
                                      for _ in range(cfg.first_dense_layers)]
        params["blocks"] = [transformer.block_init(generator, cfg, dtype, "moe")
                            for _ in range(cfg.n_layers - cfg.first_dense_layers)]
    elif cfg.family == "ssm":
        params["blocks"] = mamba_layers(cfg.n_layers)
    elif cfg.family == "encdec":
        params["enc_blocks"] = [transformer.block_init(generator, cfg, dtype)
                                for _ in range(n_encoder_layers(cfg))]
        params["enc_norm"] = transformer.norm_init(cfg, dev)
        params["blocks"] = [transformer.block_init(generator, cfg, dtype, cross=True)
                            for _ in range(cfg.n_layers)]
    else:
        n_groups, n_tail = hybrid_layout(cfg)
        params["groups"] = [mamba_layers(cfg.attn_every) for _ in range(n_groups)]
        if n_tail:
            params["tail"] = mamba_layers(n_tail)
        params["shared"] = [transformer.shared_block_init(generator, cfg, dtype)
                            for _ in range(cfg.n_shared_attn_blocks)]
    params["final_norm"] = transformer.norm_init(cfg, dev)
    params["lsh_proj"] = init_lsh_projection(cfg, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.linear_init(generator, cfg.d_model, cfg.padded_vocab,
                                               dtype=dtype)
    return params


class _MetaGenerator:
    """Stands in for a generator when parameters are drawn on the meta
    device (shapes only)."""

    device = torch.device("meta")


def param_shapes(cfg, dtype: torch.dtype | None = None) -> dict:
    """``init_params``'s tree on the meta device: every shape, no storage."""
    return init_params(cfg, _MetaGenerator(), "meta", dtype=dtype)


def param_axes(cfg) -> dict:
    """The logical axes of every trained leaf, at ``init_params``'s paths
    (no ``lsh_proj``: it is replicated model state)."""
    check_family(cfg)
    norm = transformer.norm_axes(cfg)
    axes: dict = {"embed": layers.embedding_axes()}
    if cfg.pos == "learned":
        axes["pos_embed"] = layers.embedding_axes()

    def stack(n: int, layer_type: str = "dense", **kw) -> list:
        return [transformer.block_axes(cfg, layer_type, **kw) for _ in range(n)]

    if cfg.family == "dense":
        axes["blocks"] = stack(cfg.n_layers)
    elif cfg.family == "moe":
        if cfg.first_dense_layers:
            axes["dense_blocks"] = stack(cfg.first_dense_layers)
        axes["blocks"] = stack(cfg.n_layers - cfg.first_dense_layers, "moe")
    elif cfg.family == "ssm":
        axes["blocks"] = stack(cfg.n_layers, "mamba")
    elif cfg.family == "hybrid":
        n_groups, n_tail = hybrid_layout(cfg)
        axes["groups"] = [stack(cfg.attn_every, "mamba") for _ in range(n_groups)]
        if n_tail:
            axes["tail"] = stack(n_tail, "mamba")
        axes["shared"] = [transformer.shared_block_axes(cfg)
                          for _ in range(cfg.n_shared_attn_blocks)]
    else:
        axes["enc_blocks"] = stack(n_encoder_layers(cfg))
        axes["enc_norm"] = norm
        axes["blocks"] = stack(cfg.n_layers, cross=True)
    axes["final_norm"] = norm
    if not cfg.tie_embeddings:
        axes["lm_head"] = layers.linear_axes(None, "vocab")
    return axes


def named_trainable(params: dict) -> list[tuple[str, torch.Tensor]]:
    """``(key path, tensor)`` of the trained leaves of ``params`` in a fixed
    order (dict keys sorted, lists by index, paths like
    ``blocks/0/attn/wq/w``): every tensor but the LSH projection."""
    leaves: list[tuple[str, torch.Tensor]] = []
    _walk_leaves({k: v for k, v in params.items() if k != "lsh_proj"}, "", leaves)
    return leaves


def _walk_leaves(tree, path: str, leaves: list) -> None:
    # A module function, not a closure: a closure that calls itself is a
    # reference cycle, which would keep the leaves (the weights, on the card)
    # alive after the caller drops them, until the cycle collector runs.
    if isinstance(tree, dict):
        for key in sorted(tree):
            _walk_leaves(tree[key], f"{path}/{key}" if path else str(key), leaves)
    elif isinstance(tree, list):
        for i, item in enumerate(tree):
            _walk_leaves(item, f"{path}/{i}", leaves)
    else:
        leaves.append((path, tree))


def trainable(params: dict) -> list[torch.Tensor]:
    """The trained leaves of ``params`` in ``named_trainable``'s order."""
    return [t for _, t in named_trainable(params)]


def embed(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return layers.embedding_apply(params["embed"], tokens,
                                  cfg.padded_vocab).to(compute_dtype(cfg))


def embed_inputs(params: dict, cfg, tokens: torch.Tensor,
                 patches: torch.Tensor | None = None):
    """The decoder's input → (x (B, P + N, D), positions (B, P + N)): the
    patch prefix (``patches`` (B, P, D), none for enc-dec, which encodes its
    frames apart) before the embedded tokens, and under learned positions
    ``pos_embed`` rows 0.. added to both."""
    x = embed(params, cfg, tokens)
    if patches is not None and cfg.family != "encdec":
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    b, n = x.shape[:2]
    positions = torch.arange(n, device=x.device).expand(b, n)
    x = layers.constrain(add_learned_pos(params, cfg, x, positions), "data", None, None)
    return x, positions


def add_learned_pos(params: dict, cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``x`` plus the ``pos_embed`` rows at ``positions`` under learned
    positions; ``x`` itself otherwise."""
    if cfg.pos != "learned":
        return x
    return x + layers.embedding_apply(params["pos_embed"], positions,
                                      cfg.learned_pos_len).to(x.dtype)


def n_prefix(cfg, patches: torch.Tensor | None) -> int:
    """Rows of the decoder's input that come before the tokens."""
    return 0 if patches is None or cfg.family == "encdec" else patches.shape[1]


def decoder_layers(params: dict, cfg) -> list[tuple[str, dict]]:
    """A dense or moe model's transformer layers in order, as (layer_type,
    layer params): the moe family's ``dense_blocks`` first."""
    if cfg.family == "moe":
        return ([("dense", lp) for lp in params.get("dense_blocks", [])]
                + [("moe", lp) for lp in params["blocks"]])
    return [("dense", lp) for lp in params["blocks"]]


def _block_hidden(lp: dict, x: torch.Tensor, cfg, positions, proj, layer_type: str,
                  causal: bool = True, enc_out: torch.Tensor | None = None):
    lp = sharding.gather_on_use(lp)
    x, aux, _ = transformer.block_apply_aux(lp, x, cfg, positions=positions, proj=proj,
                                            layer_type=layer_type, causal=causal,
                                            enc_out=enc_out)
    return x if aux is None else (x, aux)


def _mamba_hidden(lp: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    return transformer.block_apply(sharding.gather_on_use(lp), x, cfg, layer_type="mamba")[0]


def _remat(cfg, collect_cache: bool) -> bool:
    return cfg.remat == "full" and torch.is_grad_enabled() and not collect_cache


def _mamba_layers(layer_params: list, x: torch.Tensor, cfg, collect_cache: bool):
    remat = _remat(cfg, collect_cache)
    states = []
    for lp in layer_params:
        if remat:
            x = checkpoint(_mamba_hidden, lp, x, cfg, use_reentrant=False)
            continue
        x, st = transformer.block_apply(sharding.gather_on_use(lp), x, cfg,
                                        layer_type="mamba", collect_cache=collect_cache)
        states.append(st)
    return x, states


def encode(params: dict, cfg, frames: torch.Tensor, proj: torch.Tensor | None = None):
    """The enc-dec encoder over the stub frontend's frame embeddings (B,
    N_enc, D): the rows 0..N_enc-1 of the learned position table added (the
    decoder's own ``pos_embed``, as the reference's ``_encode`` does), then
    the non-causal ``enc_blocks`` (remat as the decoder's) and ``enc_norm``."""
    x = frames.to(compute_dtype(cfg))
    b, n = x.shape[:2]
    positions = torch.arange(n, device=x.device).expand(b, n)
    x = add_learned_pos(params, cfg, x, positions)
    x, _, _ = _transformer_layers([("dense", lp) for lp in params["enc_blocks"]], x, cfg,
                                  positions, proj, False, causal=False)
    return transformer.norm_apply(params["enc_norm"], x, cfg)


def _transformer_layers(stack: list, x: torch.Tensor, cfg, positions, proj,
                        collect_cache: bool, *, causal: bool = True,
                        enc_out: torch.Tensor | None = None):
    """Run ``stack`` ((layer_type, layer params) in order) → (x, the MoE
    layers' summed aux loss or None, the per-layer cache parts when
    ``collect_cache``); each block one ``checkpoint`` under full remat."""
    remat = _remat(cfg, collect_cache)
    aux, kvs = None, []
    for layer_type, lp in stack:
        if remat:
            out = checkpoint(_block_hidden, lp, x, cfg, positions, proj, layer_type, causal,
                             enc_out, use_reentrant=False)
            x, a = out if isinstance(out, tuple) else (out, None)
        else:
            x, a, kv = transformer.block_apply_aux(sharding.gather_on_use(lp), x, cfg,
                                                   positions=positions,
                                                   proj=proj, layer_type=layer_type,
                                                   causal=causal, enc_out=enc_out)
            if collect_cache:
                kvs.append(kv)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux, kvs


def backbone(params: dict, cfg, tokens: torch.Tensor, *, patches: torch.Tensor | None = None,
             frames: torch.Tensor | None = None, collect_cache: bool = False):
    """Trunk → (hidden (B, N, D) after the final norm, cache parts), the
    parts None unless ``collect_cache``.  Dense and moe: a list of
    per-layer parts in layer order, (k, v) (B, Hkv, N, dh) for GQA and
    (c_kv (B, N, kv_lora), k_rope (B, 1, N, rope_d)) for MLA.  ssm: a list
    of per-layer (conv_state, ssm_state).  hybrid: ``{"groups": [[(conv,
    ssm)] per Mamba layer] per group, "shared_kv": [(k, v)] per group site,
    "tail": [(conv, ssm)]}``; the shared blocks read the embedded tokens
    ``x0`` through their concat skip.  encdec: ``{"kv": [(k, v)] per
    decoder layer, "enc_out": the encoder output (B, N_enc, D)}``.  A
    ``patch_stub`` model's hidden rows and parts include its P prefix rows
    (N = P + tokens).

    Under autograd with ``cfg.remat == "full"`` each transformer block and
    each Mamba layer is one ``checkpoint``: only its input is kept, and the
    backward recomputes it (the reference's ``_remat``, which wraps the
    hybrid's Mamba layers but not its shared attention blocks)."""
    x, _, parts = trunk(params, cfg, tokens, patches=patches, frames=frames,
                        collect_cache=collect_cache)
    return x, parts


def trunk(params: dict, cfg, tokens: torch.Tensor, *, patches: torch.Tensor | None = None,
          frames: torch.Tensor | None = None, collect_cache: bool = False):
    """``backbone`` with the MoE layers' summed aux loss: (hidden, aux (f32
    scalar; 0 without MoE layers), cache parts)."""
    params = {**params, **sharding.gather_on_use(
        {k: v for k, v in params.items() if k not in LAYER_KEYS + ("lm_head",)})}
    x, positions = embed_inputs(params, cfg, tokens, patches)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    proj = params.get("lsh_proj")
    if cfg.family == "ssm":
        x, states = _mamba_layers(params["blocks"], x, cfg, collect_cache)
        x = transformer.norm_apply(params["final_norm"], x, cfg)
        return x, aux, (states if collect_cache else None)
    if cfg.family == "hybrid":
        x0 = x
        groups, shared_kv = [], []
        for gi, group in enumerate(params["groups"]):
            x, states = _mamba_layers(group, x, cfg, collect_cache)
            sp = params["shared"][gi % cfg.n_shared_attn_blocks]
            x, kv = transformer.shared_block_apply(sp, x, x0, cfg, positions=positions,
                                                   proj=proj)
            groups.append(states)
            shared_kv.append(kv)
        x, tail = _mamba_layers(params.get("tail", []), x, cfg, collect_cache)
        x = transformer.norm_apply(params["final_norm"], x, cfg)
        parts = {"groups": groups, "shared_kv": shared_kv, "tail": tail}
        return x, aux, (parts if collect_cache else None)
    enc_out = None
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError("an enc-dec model needs its encoder input: frames=")
        enc_out = encode(params, cfg, frames, proj)
    x, moe_aux, kvs = _transformer_layers(decoder_layers(params, cfg), x, cfg, positions, proj,
                                          collect_cache, enc_out=enc_out)
    if moe_aux is not None:
        aux = aux + moe_aux
    x = transformer.norm_apply(params["final_norm"], x, cfg)
    if not collect_cache:
        return x, aux, None
    return x, aux, ({"kv": kvs, "enc_out": enc_out} if enc_out is not None else kvs)


def _head(params: dict, cfg) -> tuple[dict, int]:
    """(the LM head's params, gathered on use; the vocab columns it holds)."""
    if cfg.tie_embeddings:
        head = sharding.gather_on_use(params["embed"])
        return head, head["table"].shape[0]
    head = sharding.gather_on_use(params["lm_head"])
    return head, head["w"].shape[1]


def logits_fn(params: dict, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """Logits (B, N, padded_vocab), the pad columns at ``PAD_LOGIT``; a head
    that holds a slice of the vocab over "model" gives this rank's columns
    (column-parallel)."""
    head, cols = _head(params, cfg)
    mesh = layers.tp_mesh(cols, cfg.padded_vocab)
    if mesh is not None:
        hidden = coll.tp_enter(hidden, mesh)
    if cfg.tie_embeddings:
        logits = layers.embedding_logits(head, hidden)
    else:
        logits = layers.linear_apply(head, hidden)
    if cfg.padded_vocab != cfg.vocab:
        first = 0 if mesh is None else int(mesh.coords["model"]) * cols
        pad = torch.arange(first, first + cols, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, PAD_LOGIT)
    return layers.constrain(logits, "data", None, "model")


def _lse_and_label_logit(logits: torch.Tensor, labels: torch.Tensor, cfg):
    """(logsumexp over the vocab, the label's logit) of f32 logits; over the
    ranks' vocab slices when the logits hold one (the max, the sum of
    exponentials and the label's logit each summed over "model")."""
    cols = logits.shape[-1]
    mesh = layers.tp_mesh(cols, cfg.padded_vocab)
    if mesh is None:
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0])
    top = coll.all_reduce(logits.detach().amax(dim=-1), mesh, "model", op="max")
    sum_exp = coll.tp_reduce((logits - top[..., None]).exp().sum(dim=-1), mesh)
    local = labels - int(mesh.coords["model"]) * cols
    inside = (local >= 0) & (local < cols)
    picked = logits.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0]
    return top + torch.log(sum_exp), coll.tp_reduce(picked * inside, mesh)


def forward(params: dict, cfg, tokens: torch.Tensor, *, patches: torch.Tensor | None = None,
            frames: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence logits (B, N, padded_vocab) of the N tokens (a patch
    prefix's rows dropped before the head)."""
    hidden, _ = backbone(params, cfg, tokens, patches=patches, frames=frames)
    return logits_fn(params, cfg, hidden[:, n_prefix(cfg, patches):])


def loss_fn(params: dict, cfg, batch: dict):
    """Next-token cross-entropy over f32 logits, plus ``router_aux_weight``
    times the MoE layers' summed aux loss, plus the 1e-4 z-loss → (loss,
    metrics).  Labels below 0 are masked out.  A model without MoE layers
    has no aux loss, so its ``aux`` is 0.  ``batch`` holds ``tokens`` and
    ``labels``, and ``patches`` or ``frames`` for the stub frontends."""
    patches = batch.get("patches")
    # Gathered once for the trunk and the head (a tied table serves both).
    params = {**params, **sharding.gather_on_use(
        {k: v for k, v in params.items() if k not in LAYER_KEYS})}
    hidden, aux, _ = trunk(params, cfg, batch["tokens"], patches=patches,
                           frames=batch.get("frames"))
    logits = logits_fn(params, cfg, hidden[:, n_prefix(cfg, patches):]).float()
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    lse, label_logit = _lse_and_label_logit(logits, labels, cfg)
    nll = lse - label_logit
    denom = mask.sum()
    dp = sharding.active_dp()
    if dp is not None:
        # This rank's share of the whole batch's mean: the ranks' losses sum
        # to it, and the aux loss (already the whole batch's) is split evenly.
        denom = coll.all_reduce(denom, *dp)
        aux = aux / sharding.dp_size(dp[0])
    denom = denom.clamp(min=1.0)
    ce = (nll * mask).sum() / denom
    zloss = (lse.square() * mask).sum() / denom
    total = ce + cfg.router_aux_weight * aux + Z_LOSS_WEIGHT * zloss
    return total, {"ce": ce, "aux": aux, "zloss": zloss}
