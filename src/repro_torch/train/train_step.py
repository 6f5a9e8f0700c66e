"""The train step: loss → grads → clip → AdamW, with optional microbatch
gradient accumulation and the NaN guard (``repro.train.train_step``).

On a mesh (``make_train_step(mesh=)``, a ``launch.mesh.HostMesh``) the
reference jits the same function with shardings and lets GSPMD place the
collectives; here they are explicit.  The params and AdamW moments are this
rank's shards under ``mesh_specs`` (``distributed.sharding``), the batch is
the global batch, of which the step takes this rank's rows (the batch
shards over the data-parallel axes), and:

* under FSDP a block's ``"data"``-sharded leaves are gathered on use inside
  its remat checkpoint, and their gradients reduce-scattered back;
* every family runs tensor parallel over "model": attention (GQA, MLA and
  the enc-dec cross-attention) by heads, or a GQA layer under
  ``attn_shard="seq"`` by positions over a ring on "model"
  (``models.attention``), the MLP and the vocab Megatron style, Mamba-2
  by SSM heads (``models.mamba``), the MoE expert parallel
  (``models.moe``); and the ring over "context" where the config names it;
* ``lm.loss_fn`` normalises by the whole batch's labels, so the ranks'
  losses sum to the single device's mean; the gradients are summed over the
  data-parallel axes (reduce-scattered where FSDP shards them), which is
  the gradient of that mean;
* the global grad norm sums squares over unique shards: a leaf's squares
  are summed over the axes its spec shards it over, never over the ranks
  that hold replicas of it;
* the loss, the norm and so the NaN guard's skip are the same on every rank.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import set_mesh
from repro_torch.models import lm
from repro_torch.train import optimizer as opt_mod


def mesh_specs(cfg, mesh):
    """The param specs of ``cfg`` on ``mesh``: ``sharding.param_pspecs`` over
    ``lm.param_axes`` and the shapes on the meta device."""
    return sharding.param_pspecs(lm.param_axes(cfg), lm.param_shapes(cfg), mesh,
                                 fsdp=cfg.fsdp)


def _attention_heads(cfg) -> tuple:
    """(heads, columns) of each attention weight the rules slice by heads
    over "model" (none for the attention-free ssm family)."""
    if cfg.family == "ssm":
        return ()
    h = cfg.n_heads
    if cfg.use_mla:
        return ((h, h * (cfg.qk_nope_dim + cfg.qk_rope_dim)), (h, h * cfg.qk_nope_dim),
                (h, h * cfg.v_head_dim))
    dh = cfg.head_dim_
    return ((h, h * dh), (cfg.n_kv_heads, cfg.n_kv_heads * dh))


def check_mesh(cfg, mesh) -> None:
    """Raise for what the port does not train on ``mesh``: under
    ``attn_shard="heads"`` a "model" axis that the rules would cut through
    an attention head, or that would slice some of a layer's head-split
    weights and leave others whole (the rules drop an assignment that does
    not divide its dim).  The port's attention runs whole heads on a rank,
    and the kernels map query heads onto KV heads by q_per_kv.  Under
    ``attn_shard="seq"`` (the reference's layout for heads that "model"
    does not divide) a GQA layer trains on any "model" axis: over N ≥
    model × 128 positions under a kernel impl it shards the sequence over
    "model" and attends over a ring on that axis
    (``models.attention.seq_mesh``), below that it gathers its sliced
    weights and runs whole (``tp_layout``).  Every family trains on any
    other mesh."""
    m = coll.axis_size(mesh, "model")
    if m == 1 or (cfg.attn_shard == "seq" and not cfg.use_mla):
        return
    weights = _attention_heads(cfg)
    sliced = [cols % m == 0 for _, cols in weights]
    if any(sliced) and not (all(sliced) and all(h % m == 0 for h, _ in weights)):
        raise NotImplementedError(
            f"{cfg.name}: a 'model' axis of {m} over attention weights of "
            f"{[h for h, _ in weights]} heads ({[c for _, c in weights]} columns) would cut "
            "a head or slice one weight beside another held whole; the port's tensor "
            "parallelism runs whole heads on a rank (a 'model' axis that divides every head "
            "count trains, and one that divides none of the columns runs attention whole)")


def local_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch: dim 0 split over the
    data-parallel axes, which must divide it."""
    axes = sharding.dp_axes(mesh)
    idx, n = coll.axes_index(mesh, axes)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"a batch of {v.shape[0]} rows does not split over the {n} "
                             f"data-parallel ranks of {dict(mesh.shape)}")
        rows = v.shape[0] // n
        out[k] = v[idx * rows:(idx + 1) * rows]
    return out


def _walk_specs(tree, spec, out: list) -> None:
    if isinstance(tree, dict):
        for key in sorted(tree):
            _walk_specs(tree[key], (spec or {}).get(key), out)
    elif isinstance(tree, list):
        for i, item in enumerate(tree):
            _walk_specs(item, spec[i] if spec else None, out)
    else:
        out.append(spec)


def leaf_specs(params: dict, specs) -> list:
    """The spec of each ``lm.trainable`` leaf of ``params``, in its order
    (which is also the AdamW moments' order)."""
    out: list = []
    _walk_specs({k: v for k, v in params.items() if k != "lsh_proj"}, specs, out)
    return out


class _MeshStep:
    """The collectives of one step on a mesh, for the leaves in
    ``lm.trainable`` order."""

    def __init__(self, mesh, leaf_specs: list):
        self.mesh = mesh
        live = {a for a in mesh.axis_names if coll.axis_size(mesh, a) > 1}
        self.dp = tuple(a for a in sharding.dp_axes(mesh) if a in live)
        # The data-parallel axes each leaf's gradient still sums over (FSDP's
        # gather already reduce-scattered "data"), and the axes its squares
        # sum over in the global norm (those its spec shards it over).
        self.reduce_axes = [tuple(a for a in self.dp if a not in sharding.spec_axes(s))
                            for s in leaf_specs]
        self.norm_axes = [tuple(a for a in mesh.axis_names
                                if a in live and a in sharding.spec_axes(s))
                          for s in leaf_specs]

    def reduce_grads(self, grads: list) -> None:
        """Sum each gradient over its data-parallel axes, in place: one
        flat f32 buffer a set of axes."""
        buckets: dict = {}
        for i, axes in enumerate(self.reduce_axes):
            if axes:
                buckets.setdefault(axes, []).append(i)
        for axes, idx in buckets.items():
            flat = torch.cat([grads[i].float().reshape(-1) for i in idx])
            flat = coll.all_reduce(flat, self.mesh, axes)
            at = 0
            for i in idx:
                n = grads[i].numel()
                grads[i].copy_(flat[at:at + n].view(grads[i].shape))
                at += n

    def total_sq(self, sq: list) -> torch.Tensor:
        """The global sum of squares from each leaf's local one."""
        groups: dict = {}
        for s, axes in zip(sq, self.norm_axes):
            groups[axes] = groups.get(axes, 0) + s
        return sum(coll.all_reduce(v.reshape(1), self.mesh, axes)[0]
                   for axes, v in groups.items())

    def sum_dp(self, x: torch.Tensor) -> torch.Tensor:
        return coll.all_reduce(x, self.mesh, self.dp)

    def all_ok(self, ok: bool, meta: bool = False) -> bool:
        """Whether every rank's step is ``ok``; a ``meta`` step (the dry
        run) reduces a meta flag and takes the update."""
        bad = torch.tensor([0.0 if ok else 1.0], device="meta" if meta else "cpu")
        flag = coll.all_reduce(bad, self.mesh, self.mesh.axis_names, op="max")
        return meta or not bool(flag[0])


def make_train_step(cfg, opt_cfg: opt_mod.OptimizerConfig, mesh=None):
    """→ train_step(params, opt_state, batch, step, inject=0.0) → (params,
    opt_state, metrics).  ``params`` is the model's dict (its
    ``lm.trainable`` leaves are updated in place), ``opt_state`` comes from
    ``adamw_init(lm.trainable(params))``, ``batch`` holds int ``tokens`` and
    ``labels`` tensors on the params' device, ``step`` is the int step the
    LR schedule reads.  ``inject`` is the ``nan_grad`` fault's hook: the
    trainer passes NaN, which poisons the loss inside the step (``loss +
    inject * 0.0``), so the fault takes the real NaN guard below.  Metrics
    are 0-dim tensors (``lr`` a float).

    With ``mesh``: ``params`` and ``opt_state`` hold this rank's shards
    under ``mesh_specs(cfg, mesh)`` (``sharding.shard_params``), ``batch``
    is the global batch, and the metrics are the global ones, equal on
    every rank."""
    plan = None
    if mesh is not None:
        check_mesh(cfg, mesh)
        specs = mesh_specs(cfg, mesh)

    def scope(params):
        if mesh is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(set_mesh(mesh))
        stack.enter_context(sharding.fsdp_gathering(mesh, params, specs))
        return stack

    def train_step(params: dict, opt_state: dict, batch: dict, step: int,
                   inject: float = 0.0):
        nonlocal plan
        leaves = lm.trainable(params)
        if mesh is not None:
            batch = local_batch(batch, mesh)
            if plan is None:
                plan = _MeshStep(mesh, leaf_specs(params, specs))
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        with scope(params):
            if opt_cfg.grad_accum > 1:
                # Split the leading batch dim into microbatches; backward()
                # sums their grads into .grad.
                micro = {k: v.chunk(opt_cfg.grad_accum) for k, v in batch.items()}
                loss = torch.zeros((), device=leaves[0].device)
                for i in range(opt_cfg.grad_accum):
                    mb_loss, _ = lm.loss_fn(params, cfg, {k: v[i] for k, v in micro.items()})
                    mb_loss.backward()
                    loss = loss + mb_loss.detach()
                loss = loss / opt_cfg.grad_accum
                metrics = {}
                for p in leaves:
                    p.grad.div_(opt_cfg.grad_accum)
            else:
                loss, metrics = lm.loss_fn(params, cfg, batch)
                loss.backward()
                loss = loss.detach()
                metrics = {k: v.detach() for k, v in metrics.items()}
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        total_sq = None
        if plan is not None:
            plan.reduce_grads(grads)
            loss = plan.sum_dp(loss)
            metrics = {k: plan.sum_dp(v) for k, v in metrics.items()}
            total_sq = plan.total_sq
        loss = loss + inject * 0.0
        grads, gnorm = opt_mod.clip_by_global_norm(grads, opt_cfg.grad_clip, total_sq=total_sq)
        lr = opt_mod.schedule(opt_cfg, step)
        # NaN guard: a non-finite loss or grad norm skips the update.  The
        # reference computes the update and selects where(ok, new, old)
        # inside jit; skipping it gives the same params and state without a
        # second copy of the params on the card.
        # A meta step (the dry run) has no values to read: it takes the update.
        ok = loss.is_meta or bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        if plan is not None:
            ok = plan.all_ok(ok, meta=loss.is_meta)
        if ok:
            opt_mod.adamw_update(leaves, grads, opt_state, opt_cfg, lr)
        for p in leaves:
            p.grad = None
        out = {"loss": loss.float(), "grad_norm": gnorm, "lr": lr,
               "skipped": torch.tensor(0.0 if ok else 1.0), **metrics}
        return params, opt_state, out

    return train_step


def make_eval_step(cfg):
    @torch.no_grad()
    def eval_step(params: dict, batch: dict) -> dict:
        loss, metrics = lm.loss_fn(params, cfg, batch)
        return {"loss": loss, **metrics}

    return eval_step
