"""The dry run on the production mesh: trace one rank's step of every
(arch × shape × mesh) cell on the meta device and price it
(``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's jitted step over 512
placeholder devices and reads XLA's partitioned module.  The port traces
the step it runs on the card, for one rank of the mesh: rank 0's params
(``sharding.shard_params`` under ``train_step.mesh_specs``), AdamW state,
batch rows (``input_specs``) and cache block (``kv_cache.cache_pspecs``) are
built on ``torch.device("meta")``, and ``make_train_step(cfg, opt, mesh=)``,
``make_prefill(mesh=)`` or ``make_decode_step(mesh=)`` runs under
``set_mesh`` of a ``launch.mesh.DryMesh`` inside a
``roofline.analysis.CostCounter``.  Meta tensors have shapes and no data,
so nothing is computed and no kernel is launched (each kernel wrapper's
meta branch returns its outputs' shapes and is charged its least work);
the collectives take their dry path and charge their wire bytes.  The
count is the rank's FLOPs, HBM bytes (the counter's eager model, not
comparable with the reference's count of a fused module), collective bytes
by kind, and the peak of the storages the step allocates.

Attention runs the port's kernels: a config's own impl is taken to its
kernel counterpart (``distr`` → ``pallas_distr``, ``xla_flash`` →
``pallas_flash``; MLA under ``pallas_distr`` runs plain DistrAttention, as
on the card), unless ``--impl`` names one.  Serving steps run in
the compute dtype (bf16 weights and caches), as the port serves; the train
step holds f32 master weights.  A decode kernel is priced with every cache
position live.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--impl pallas_flash]
  python -m repro_torch.launch.dryrun --table  # the records as a markdown table

Records go as JSON to ``--results-dir`` (default
``<tempfile.gettempdir()>/repro_torch_dryrun``; ``dryrun_results`` inside
the checkout is ignored by git).  A cell the reference skips is
``skipped``; one whose layout the port refuses (a ``NotImplementedError``:
``--override attn_shard=heads`` over heads that "model" cuts, say) is
``refused`` with the error; any other failure ends the run non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile
import time
import traceback

import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, input_specs
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_production_mesh, set_mesh
from repro_torch.models import lm
from repro_torch.models.attention import seq_layout
from repro_torch.roofline import analysis as roof
from repro_torch.serve import kv_cache
from repro_torch.serve.serve_step import make_decode_step, make_prefill
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptimizerConfig, adamw_init
from repro_torch.utils.tree import tree_bytes, tree_leaves

RESULTS_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_dryrun")
# One H100 SXM's HBM (80 GB), the budget ``memory_estimate`` is held to.
HBM_BYTES = 80e9
META = torch.device("meta")


def mesh_devices(mesh) -> int:
    return math.prod(int(mesh.shape[a]) for a in mesh.axis_names)


def master_shapes(cfg) -> dict:
    """The trained parameters at their f32 master dtype on meta (no LSH
    projection: it is model state, not a parameter)."""
    shapes = lm.param_shapes(cfg, lm.param_dtype(cfg))
    return {k: v for k, v in shapes.items() if k != "lsh_proj"}


def memory_estimate(cfg, shape, mesh, p_shapes) -> dict:
    """The reference's analytic per-card budget (``tpu_memory_estimate``),
    term for term, with ``fits`` against one H100's 80 GB.  ``p_shapes``
    are the f32 master parameters (``master_shapes``)."""
    devs = mesh_devices(mesh)
    model_par = int(mesh.shape.get("model", 1))
    dp = devs // model_par
    param_b = tree_bytes(p_shapes)
    out = {"params": param_b / devs}
    if shape.kind == "train":
        out["opt_state"] = 2 * param_b / devs
        tokens = shape.global_batch * shape.seq_len
        out["saved_carries"] = cfg.n_layers * tokens * cfg.d_model * 2 / devs
        out["logits"] = tokens / dp * cfg.padded_vocab / model_par * 6
        out["transient"] = 2 * 2**30
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        out["activations"] = 4 * tokens * cfg.d_model * 2 / devs
        out["kv_cache"] = (
            2 * cfg.n_layers * tokens * cfg.n_kv_heads * cfg.head_dim_ * 2 / devs
            if not cfg.is_attention_free else 0)
        out["transient"] = 2 * 2**30
    else:
        cache_b = tree_bytes(kv_cache.cache_struct(cfg, shape.global_batch, shape.seq_len))
        out["kv_cache"] = cache_b / devs
        out["transient"] = 1 * 2**30
    out["total"] = sum(out.values())
    est = {k: int(v) for k, v in out.items()}
    est["fits"] = est["total"] <= HBM_BYTES
    return est


def _meta_batch(cfg, shape, rows: int) -> dict:
    specs = input_specs(cfg, dataclasses.replace(shape, global_batch=rows))
    return {k: torch.empty(s, dtype=dt, device=META) for k, (s, dt) in specs.items()}


def rank_params(cfg, mesh, dtype: torch.dtype) -> dict:
    """This rank's parameter shards on meta, in ``dtype`` (norms f32)."""
    return sharding.shard_params(lm.param_shapes(cfg, dtype), mesh, ts.mesh_specs(cfg, mesh))


def batch_rows(mesh, batch: int) -> int:
    """This rank's rows of a batch of ``batch``: split over the data-parallel
    axes when they divide it (``kv_cache.cache_pspecs``' rule), else all."""
    n = sharding.dp_size(mesh)
    return batch // n if batch % n == 0 else batch


def run_step(cfg, kind: str, mesh, params: dict, *, batch: dict | None = None,
             cache: dict | None = None, tokens=None, pos=None, max_len: int = 0,
             opt_cfg: OptimizerConfig | None = None, opt_state: dict | None = None,
             perms: torch.Tensor | None = None, step_fn=None):
    """Run one rank's ``kind`` step ("train", "prefill" or "decode") on the
    given tensors under a ``CostCounter`` → (the step's outputs, the
    counter, seconds).  The dry run passes meta tensors and a dry mesh; the
    card's check passes its own and its live mesh, so both count the same
    step.  ``step_fn`` reuses a step the caller built."""
    t0 = time.perf_counter()
    if kind == "train":
        fn = step_fn or ts.make_train_step(cfg, opt_cfg or OptimizerConfig(), mesh=mesh)
        args = (params, opt_state, batch, 1)
    elif kind == "prefill":
        fn = step_fn or make_prefill(cfg, max_len, perms=perms, mesh=mesh)
        args = (params, batch["tokens"])
    else:
        dev = next(iter(cache.values())).device
        fn = step_fn or make_decode_step(cfg, perms, max_len=max_len, device=dev, mesh=mesh)
        args = (params, tokens, cache, pos)
    kw = {k: v for k, v in batch.items() if k != "tokens"} if kind == "prefill" else {}
    counter = roof.CostCounter(track_memory=True)
    with counter:
        out = fn(*args, **kw)
    return out, counter, time.perf_counter() - t0


def argument_bytes(*trees) -> int:
    """Bytes of a step's arguments: the same count on meta and on the
    card."""
    return tree_bytes(trees)


def _output_bytes(out, args) -> tuple[int, int]:
    """(bytes of the step's output tensors, those among them that are
    arguments updated in place), each storage once."""
    arg_keys = {t.untyped_storage()._cdata for t in tree_leaves(args)}
    total = alias = 0
    seen = set()
    for t in tree_leaves(out):
        key = t.untyped_storage()._cdata
        if key in seen:
            continue
        seen.add(key)
        n = t.numel() * t.element_size()
        total += n
        alias += n if key in arg_keys else 0
    return total, alias


def trace_cell(cfg, shape, mesh, *, opt_cfg: OptimizerConfig | None = None) -> dict:
    """One rank's step of ``shape`` on ``mesh`` (rank 0 of a dry mesh),
    traced on meta → the record's measured fields."""
    dtype = lm.param_dtype(cfg) if shape.kind == "train" else lm.compute_dtype(cfg)
    params = rank_params(cfg, mesh, dtype)
    rows = batch_rows(mesh, shape.global_batch)
    extra: dict = {}
    with set_mesh(mesh):
        if shape.kind == "train":
            opt_state = adamw_init(lm.trainable(params))
            batch = _meta_batch(cfg, shape, shape.global_batch)
            args = (params, opt_state, _meta_batch(cfg, shape, rows))
            out, counter, secs = run_step(cfg, "train", mesh, params, batch=batch,
                                          opt_cfg=opt_cfg, opt_state=opt_state)
        elif shape.kind == "prefill":
            batch = _meta_batch(cfg, shape, rows)
            args = (params, batch)
            out, counter, secs = run_step(cfg, "prefill", mesh, params, batch=batch,
                                          max_len=shape.seq_len)
        else:
            cache = rank_cache(cfg, mesh, shape.global_batch, shape.seq_len,
                               lm.compute_dtype(cfg))
            tokens = torch.empty((rows, 1), dtype=torch.int32, device=META)
            pos = torch.empty((rows,), dtype=torch.int32, device=META)
            args = (params, cache, tokens, pos)
            out, counter, secs = run_step(cfg, "decode", mesh, params, cache=cache,
                                          tokens=tokens, pos=pos, max_len=shape.seq_len)
            extra["cache_bytes"] = tree_bytes(cache)
    arg_b = argument_bytes(*args)
    out_b, alias_b = _output_bytes(out, args)
    return {"trace_s": round(secs, 2), "counter": counter, "argument_bytes": arg_b,
            "output_bytes": out_b, "alias_bytes": alias_b, **extra}


def rank_cache(cfg, mesh, batch: int, max_len: int, dtype: torch.dtype) -> dict:
    """This rank's block of the serving cache on meta, under
    ``cache_pspecs`` (each block its own storage)."""
    whole = kv_cache.cache_struct(cfg, batch, max_len, dtype)
    local = kv_cache.local_cache(whole, cfg, mesh, batch=batch, max_len=max_len)
    return {k: torch.empty(v.shape, dtype=v.dtype, device=META) for k, v in local.items()}


# The kernel counterpart of each plain impl.
KERNEL_IMPL = {"distr": "pallas_distr", "xla_flash": "pallas_flash"}


def _configure(arch: str, impl: str | None, overrides: dict | None):
    cfg = get_config(arch)
    impl = impl or KERNEL_IMPL.get(cfg.attention.impl, cfg.attention.impl)
    cfg = cfg.replace(attention=cfg.attention.with_impl(impl))
    if overrides:
        overrides = dict(overrides)
        if overrides.pop("distr_decode", False):
            cfg = cfg.replace(attention=dataclasses.replace(cfg.attention, distr_decode=True))
        if overrides:
            cfg = cfg.replace(**overrides)
    return cfg


def attention_layout(cfg, mesh, shape=None) -> str:
    """How the port runs attention over "model" in a cell of ``shape``
    (None: a long training sequence): "seq" (``models.attention.
    seq_layout``: each rank projects and attends its own positions, over a
    ring on "model" in training and prefill; a decode cell's cache lies by
    positions too), "heads" ("model" divides the query and KV heads: each
    rank runs its own), "gather" (it cuts them: the layer gathers the sliced
    weights and runs every head) or "none" (no attention)."""
    if cfg.family == "ssm":
        return "none"
    if seq_layout(cfg, mesh, shape.seq_len if shape is not None else 1 << 30):
        return "seq"
    m = int(mesh.shape.get("model", 1))
    return "heads" if cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0 else "gather"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, impl: str | None = None,
             save: bool = True, tag: str = "", overrides: dict | None = None,
             results_dir: str = RESULTS_DIR) -> dict:
    cfg = _configure(arch, impl, overrides)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "16x16"
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    reason = cfg.skip_reason(shape)
    if reason:
        rec = {**head, "status": "skipped", "reason": reason}
        print(f"[dryrun] SKIP {arch} × {shape_name}: {reason}")
        if save:
            _save(rec, tag, results_dir)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    p_shapes = master_shapes(cfg)
    total, active = roof.active_params(cfg, p_shapes)
    meta = {**head, "devices": mesh_devices(mesh), "impl": cfg.attention.impl,
            "attention_layout": attention_layout(cfg, mesh, shape),
            "total_params": total, "active_params": active,
            "model_flops": roof.model_flops(cfg, shape, active),
            "memory_estimate": memory_estimate(cfg, shape, mesh, p_shapes)}
    try:
        got = trace_cell(cfg, shape, mesh)
    except NotImplementedError as e:
        rec = {**meta, "status": "refused", "reason": str(e)}
        print(f"[dryrun] REFUSED {arch} × {shape_name} × {mesh_name}: {e}")
        if save:
            _save(rec, tag, results_dir)
        return rec
    counter = got["counter"]
    terms = roof.roofline(counter)
    temp = counter.peak_bytes
    rec = {
        **meta,
        "status": "ok",
        "trace_s": got["trace_s"],
        "memory": {
            "argument_bytes": got["argument_bytes"],
            "output_bytes": got["output_bytes"],
            "temp_bytes": temp,
            "alias_bytes": got["alias_bytes"],
            "per_device_total": got["argument_bytes"] + temp + got["output_bytes"]
            - got["alias_bytes"],
        },
        "roofline": terms.as_dict(),
        "kernels": counter.as_dict()["kernels"],
        "useful_flops_ratio": (meta["model_flops"] / meta["devices"] / terms.flops_per_dev
                               if terms.flops_per_dev else None),
    }
    mem = rec["memory"]
    print(
        f"[dryrun] OK {arch} × {shape_name} × {mesh_name} (trace {got['trace_s']:.1f}s; "
        f"attention {meta['attention_layout']})\n"
        f"  mem/device: {mem['per_device_total'] / 2**30:.2f} GiB (args "
        f"{mem['argument_bytes'] / 2**30:.2f} + temp {temp / 2**30:.2f} GiB; estimate "
        f"{meta['memory_estimate']['total'] / 2**30:.2f} GiB, fits 80 GB: "
        f"{meta['memory_estimate']['fits']})\n"
        f"  roofline: compute {terms.compute_s * 1e3:.2f} ms | memory "
        f"{terms.memory_s * 1e3:.2f} ms | collective {terms.collective_s * 1e3:.2f} ms "
        f"→ {terms.dominant}-bound; useful-FLOPs ratio "
        f"{rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)}")
    if save:
        _save(rec, tag, results_dir)
    return rec


def _save(rec: dict, tag: str, results_dir: str) -> None:
    os.makedirs(results_dir, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}"
    if rec.get("impl") and rec["impl"] != _configure(rec["arch"], None, None).attention.impl:
        name += f"_{rec['impl']}"
    if tag:
        name += f"_{tag}"
    with open(os.path.join(results_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def parse_overrides(items) -> dict:
    out = {}
    for ov in items:
        k, v = ov.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        elif v.isdigit():
            v = int(v)
        out[k] = v
    return out


def _sig(x: float) -> str:
    return f"{float(f'{x:.3g}'):g}"


def table(results_dir: str, mesh: str = "16x16") -> str:
    """The records of ``mesh`` in ``results_dir`` as a markdown table, a
    row an arch (its ``attention_layout`` beside it) and a column a shape;
    a cell: traced / budgeted GiB a card; compute / memory / collective
    ms; the useful-FLOPs ratio."""
    recs = {}
    for name in os.listdir(results_dir):
        with open(os.path.join(results_dir, name)) as f:
            rec = json.load(f)
        if rec["mesh"] == mesh:
            recs[rec["arch"], rec["shape"]] = rec
    lines = ["| arch (attention) | " + " | ".join(SHAPES) + " |",
             "| --- |" + " --- |" * len(SHAPES)]
    for arch in ARCH_NAMES:
        row, layout = [], ""
        for shape in SHAPES:
            rec = recs.get((arch, shape))
            if rec is None or rec["status"] != "ok":
                row.append(rec["status"] if rec else "not run")
                continue
            layout = rec["attention_layout"]
            r, mem = rec["roofline"], rec["memory"]
            row.append(f"{mem['per_device_total'] / 2**30:.2f} / "
                       f"{rec['memory_estimate']['total'] / 2**30:.2f}; "
                       f"{_sig(r['compute_s'] * 1e3)} / {_sig(r['memory_s'] * 1e3)} / "
                       f"{_sig(r['collective_s'] * 1e3)}; {rec['useful_flops_ratio']:.3f}")
        lines.append(f"| {arch} ({layout}) | " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--impl", default=None,
                    help="attention impl override (e.g. pallas_flash)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (e.g. attn_shard=heads, distr_decode=True)")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    ap.add_argument("--table", action="store_true",
                    help="print the records in --results-dir as a markdown table and exit")
    args = ap.parse_args(argv)
    if args.table:
        for mesh in ("16x16", "pod2x16x16"):
            print(f"{mesh}:\n{table(args.results_dir, mesh)}\n")
        return
    overrides = parse_overrides(args.override)
    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                run_cell(arch, shape, multi_pod=mp, impl=args.impl, tag=args.tag,
                         overrides=overrides or None, results_dir=args.results_dir)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((arch, shape, mp, repr(e)))
                print(f"[dryrun] FAIL {arch} × {shape} multi_pod={mp}: {e}")
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: {failures}")


if __name__ == "__main__":
    main()
