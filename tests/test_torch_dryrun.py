"""Port parity of the dry run on the production mesh
(``launch/dryrun.py``, ``launch/mesh.py``'s production and dry meshes,
``serve/kv_cache.py::cache_pspecs``) and of the per-rank cost counter that
stands in for the reference's HLO walker (``roofline/analysis.py``):

* ``cache_pspecs`` of all ten configs × four shapes × both production
  meshes against the reference's, called with a stand-in mesh (it reads
  only ``axis_names`` and ``shape``);
* one subprocess with 512 forced host devices prints, for every cell, the
  reference's ``make_production_mesh``, ``cache_pspecs``, ``param_pspecs``,
  ``tpu_memory_estimate``, ``model_flops`` and ``active_params`` (it lowers
  nothing, and ``repro.launch.dryrun``, which sets ``XLA_FLAGS`` at import,
  is imported there only); the port's values must equal them;
* the counter's FLOPs against the reference's ``hlo_cost`` within its 2% on
  ``tests/test_roofline.py``'s three functions;
* one 4-rank gloo world at (data 2, model 2): each rank counts the
  minicpm-2b ``reduced()`` train step and the starcoder2-7b ``reduced()``
  prefill and two decode steps it runs, and the same train step and
  prefill at N_SEQ positions under the kernel impls (the "seq" layout: a
  ring on "model"), and the dry run of the same steps on meta over a dry
  mesh at its coordinates must count the same FLOPs, collective bytes by
  kind and argument bytes; the dry mesh's coordinates and the collectives'
  dry shapes equal the live world's;
* ``attention_layout`` on the production mesh: "seq" for the seven
  ``attn_shard="seq"`` configs.

The world's ranks import this module, which imports no JAX at its top.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import one_intra_op_thread  # noqa: E402,F401

ARCHS = ("minicpm-2b", "starcoder2-7b", "qwen2.5-32b", "qwen1.5-4b", "whisper-small",
         "internvl2-2b", "llama4-scout-17b-a16e", "deepseek-v2-236b", "mamba2-130m",
         "zamba2-7b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
WORLD = 4
B, N, S = 4, 32, 64
# A sequence long enough for the "seq" layout on a "model" axis of 2
# (model × 128 positions), and its prefill's cache.
N_SEQ, S_SEQ = 256, 512


class StandIn:
    """A mesh as ``cache_pspecs`` reads one: axis names and sizes."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)

    def __repr__(self):
        return "×".join(f"{a}{s}" for a, s in self.shape.items())


MESHES = (StandIn(data=16, model=16), StandIn(pod=2, data=16, model=16))


def _norm(spec):
    """A partition spec as a tuple of entries: None, an axis, or a tuple of
    axes (one axis bare)."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = None if not e else e[0] if len(e) == 1 else tuple(e)
        out.append(e)
    return tuple(out)


def test_arch_names_cover_the_ten_configs():
    from repro_torch.configs import ARCH_NAMES

    assert sorted(ARCH_NAMES) == sorted(ARCHS)


@pytest.mark.parametrize("mesh", MESHES, ids=repr)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_reference(arch, shape, mesh):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_get_config
    from repro.serve import kv_cache as ref_kvc
    from repro_torch.configs import get_config
    from repro_torch.serve import kv_cache

    sh = REF_SHAPES[shape]
    want = ref_kvc.cache_pspecs(ref_get_config(arch), mesh, batch=sh.global_batch,
                                max_len=sh.seq_len)
    got = kv_cache.cache_pspecs(get_config(arch), mesh, batch=sh.global_batch,
                                max_len=sh.seq_len)
    assert set(got) == set(want)
    for key in want:
        assert _norm(got[key]) == _norm(want[key]), key


# ---------------------------------------------------------------------------
# The reference's production-mesh values, printed by one subprocess
# ---------------------------------------------------------------------------

REFERENCE_SCRIPT = textwrap.dedent('''
    import json
    import repro.launch.dryrun as dr  # sets XLA_FLAGS first: 512 host devices
    import jax
    from repro.configs import ARCH_NAMES, SHAPES, get_config
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_production_mesh
    from repro.models import lm
    from repro.roofline import analysis as roof
    from repro.serve import kv_cache

    def spec(p):
        return [list(e) if isinstance(e, tuple) else e for e in p]

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [tree(v) for v in t]
        return spec(t)

    out = {"meshes": {}, "cells": {}, "params": {}}
    meshes = {mp: make_production_mesh(multi_pod=mp) for mp in (False, True)}
    for mp, mesh in meshes.items():
        out["meshes"][str(mp)] = [list(mesh.axis_names), dict(mesh.shape), int(mesh.size)]
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        p_shapes = jax.eval_shape(lambda k: lm.init_params(k, cfg), jax.random.PRNGKey(0))
        total, active = roof.active_params(cfg, p_shapes)
        for mp, mesh in meshes.items():
            out["params"][f"{arch}|{mp}"] = tree(shd.param_pspecs(
                lm.param_axes(cfg), p_shapes, mesh, fsdp=cfg.fsdp))
            for name, shape in SHAPES.items():
                out["cells"][f"{arch}|{name}|{mp}"] = {
                    "total_params": total, "active_params": active,
                    "model_flops": roof.model_flops(cfg, shape, active),
                    "estimate": dr.tpu_memory_estimate(cfg, shape, mesh, p_shapes),
                    "cache": {k: spec(v) for k, v in kv_cache.cache_pspecs(
                        cfg, mesh, batch=shape.global_batch, max_len=shape.seq_len).items()}}
    print(json.dumps(out))
''')


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    done = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=60)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_production_meshes_match_reference(reference):
    from repro_torch.launch.dryrun import mesh_devices
    from repro_torch.launch.mesh import DryMesh, make_production_mesh

    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        assert isinstance(mesh, DryMesh)
        names, shape, size = reference["meshes"][str(mp)]
        assert list(mesh.axis_names) == names and dict(mesh.shape) == shape
        assert mesh_devices(mesh) == size
        assert all(c == 0 for c in mesh.coords.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_cells_match_reference(reference, arch):
    """Per cell of ``arch``: the production mesh's cache specs, the memory
    budget (``memory_estimate`` beside the reference's
    ``tpu_memory_estimate``, with its ``fits`` flag), MODEL_FLOPS, the
    parameter counts and the parameter specs (layer stacks dropped)."""
    from test_torch_sharding import _unstack

    from repro_torch.configs import SHAPES as PORT_SHAPES
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import lm
    from repro_torch.roofline import analysis as roof
    from repro_torch.serve import kv_cache
    from repro_torch.train.train_step import mesh_specs

    cfg = get_config(arch)
    p_shapes = dryrun.master_shapes(cfg)
    total, active = roof.active_params(cfg, p_shapes)
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        want_specs = reference["params"][f"{arch}|{mp}"]
        pairs = list(_unstack(want_specs, mesh_specs(cfg, mesh)))
        assert len(pairs) == len(lm.trainable(p_shapes))
        for port_spec, ref_spec, path in pairs:
            assert isinstance(port_spec, sharding.P), path
            assert _norm(port_spec) == _norm(ref_spec), path
        for name, shape in PORT_SHAPES.items():
            want = reference["cells"][f"{arch}|{name}|{mp}"]
            assert (total, active) == (want["total_params"], want["active_params"])
            assert roof.model_flops(cfg, shape, active) == want["model_flops"]
            est = dryrun.memory_estimate(cfg, shape, mesh, p_shapes)
            assert est.pop("fits") == (est["total"] <= dryrun.HBM_BYTES)
            assert est == want["estimate"], name
            cache = kv_cache.cache_pspecs(cfg, mesh, batch=shape.global_batch,
                                          max_len=shape.seq_len)
            assert {k: _norm(v) for k, v in cache.items()} == {
                k: _norm(v) for k, v in want["cache"].items()}, name


# ---------------------------------------------------------------------------
# The counter against the reference's HLO walker
# ---------------------------------------------------------------------------


def _chained():
    w, x = torch.randn(128, 128), torch.randn(128, 128)
    y = x
    for _ in range(7):
        y = y @ w
    return y.sum()


def _nested():
    w, x = torch.randn(64, 64), torch.randn(64, 64)
    y = x
    for _ in range(5):
        for _ in range(3):
            y = y @ w
    return y.sum()


def _einsum():
    a, b = torch.randn(4, 32, 64), torch.randn(4, 64, 16)
    return torch.einsum("bij,bjk->bik", a, b).sum()


def _ref_fns():
    import jax
    import jax.numpy as jnp

    def chained(w, x):
        def body(c, _):
            return c @ w, None
        y, _ = jax.lax.scan(body, x, None, length=7)
        return y.sum()

    def nested(w, x):
        def outer(c, _):
            def inner(ci, _):
                return ci @ w, None
            c2, _ = jax.lax.scan(inner, c, None, length=3)
            return c2, None
        y, _ = jax.lax.scan(outer, x, None, length=5)
        return y.sum()

    def einsum(a, b):
        return jnp.einsum("bij,bjk->bik", a, b).sum()

    f32 = jnp.float32
    return {"chained": (chained, ((128, 128), (128, 128))),
            "nested": (nested, ((64, 64), (64, 64))),
            "einsum": (einsum, ((4, 32, 64), (4, 64, 16)))}, f32


@pytest.mark.parametrize("name,fn", [("chained", _chained), ("nested", _nested),
                                     ("einsum", _einsum)])
def test_counter_flops_match_reference_hlo_cost(name, fn):
    import jax

    from repro.roofline import analysis as ref_roof
    from repro_torch.roofline.analysis import CostCounter

    fns, f32 = _ref_fns()
    ref_fn, shapes = fns[name]
    args = [jax.ShapeDtypeStruct(s, f32) for s in shapes]
    want = ref_roof.hlo_cost(jax.jit(ref_fn).lower(*args).compile().as_text())["flops"]
    with CostCounter() as c:
        fn()
    assert c.flops == pytest.approx(want, rel=0.02)


def test_roofline_of_a_count_uses_the_h100_rates():
    from repro_torch.roofline import analysis as roof

    cost = {"flops": 989e12, "bytes": 3.35e12,
            "coll": {"all-reduce": 450e9, "all-gather": 0, "collective-permute": 450e9}}
    t = roof.roofline(cost)
    assert (t.compute_s, t.memory_s, t.collective_s) == pytest.approx((1.0, 1.0, 2.0))
    assert t.dominant == "collective"
    assert roof.collective_bytes(cost) == {"all-reduce": int(450e9), "all-gather": 0,
                                           "reduce-scatter": 0, "all-to-all": 0,
                                           "collective-permute": int(450e9)}
    assert roof.COLLECTIVE_OPS == ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                   "collective-permute")


def test_kernel_calls_charge_their_least_work_on_every_device():
    """A kernel wrapper charges its least work whether it takes its plain
    version (CPU) or its meta branch, and the aten ops inside count
    nothing."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels.ops import attention_work
    from repro_torch.roofline.analysis import CostCounter

    counts = []
    for dev in ("cpu", "meta"):
        q = torch.randn(6, 100, 64, device=dev)
        k, v = torch.randn(2, 100, 64, device=dev), torch.randn(2, 100, 64, device=dev)
        with CostCounter() as c:
            o, lse = fk.flash_attention_kernel_call(q, k, v, q_per_kv=3, scale=0.125,
                                                    causal=True, kv_len=100, return_lse=True)
        assert o.shape == q.shape and lse.shape == (6, 100) and lse.dtype == torch.float32
        counts.append((c.flops, c.hbm_bytes, dict(c.kernels)))
    work = attention_work(1, 6, 2, 100, 100, 64, causal=True, lse=True)["fwd"]
    assert counts[0] == counts[1]
    assert counts[0][0] == work["tensor_flops"] + work["f32_flops"]
    assert counts[0][1] == work["hbm_bytes"]


def test_a_live_mesh_without_its_group_raises():
    """Only a ``DryMesh`` takes the dry path, and only for meta tensors: a
    live mesh whose group is absent raises, a tensor with values on a dry
    mesh raises, and ``compat_make_mesh`` with no world running raises
    rather than give a dry mesh."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import HostMesh, compat_make_mesh, dry_mesh

    live = HostMesh(("model",), {"model": 2}, {"model": 0}, {"model": (0, 1)},
                    {"model": None})
    x = torch.ones(4, 3)
    with pytest.raises((RuntimeError, ValueError)):
        coll.all_reduce(x, live, "model")
    dry = dry_mesh((2,), ("model",))
    assert coll.all_gather(x.to("meta"), dry, "model", 1).shape == (4, 6)
    for wire in (lambda: coll.all_reduce(x, dry, "model"),
                 lambda: coll.all_gather(x, dry, "model", 1),
                 lambda: coll.reduce_scatter(x, dry, "model", 0),
                 lambda: coll.all_to_all(x, dry, "model"),
                 lambda: coll.permute(x, dry, "model", 1)):
        with pytest.raises(RuntimeError, match="meta tensors"):
            wire()
    with pytest.raises(ValueError):
        compat_make_mesh((2, 2), ("data", "model"))


def test_attention_layout_follows_the_seq_layout():
    """The seven ``attn_shard="seq"`` configs shard attention's positions
    over "model" on the production mesh (every cell's sequence is past the
    guard); zamba2-7b and deepseek-v2-236b run by heads, mamba2-130m has
    none; a sequence below model × 128, "context" beside "model" and a plain
    impl keep the heads' layout or gather."""
    from repro_torch.configs import SHAPES as PORT_SHAPES
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dry_mesh, make_production_mesh

    mesh = make_production_mesh()
    want = {"deepseek-v2-236b": "heads", "zamba2-7b": "heads", "mamba2-130m": "none"}
    for arch in ARCHS:
        cfg = dryrun._configure(arch, None, None)
        for shape in PORT_SHAPES.values():
            assert dryrun.attention_layout(cfg, mesh, shape) == want.get(arch, "seq"), arch
    cfg = dryrun._configure("qwen2.5-32b", None, None)
    assert dryrun.attention_layout(cfg, mesh, ShapeSpec("short", "train", 2047, 256)) == "gather"
    assert dryrun.attention_layout(cfg, mesh, ShapeSpec("at", "train", 2048, 256)) == "seq"
    ctx = dry_mesh((4, 2, 2), ("data", "context", "model"))
    assert dryrun.attention_layout(cfg, ctx, PORT_SHAPES["train_4k"]) == "heads"
    plain = cfg.replace(attention=cfg.attention.with_impl("distr"))
    assert dryrun.attention_layout(plain, mesh, PORT_SHAPES["train_4k"]) == "gather"


def test_dry_run_prices_a_cell_on_meta():
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("mamba2-130m", "decode_32k", multi_pod=False, save=False)
    assert rec["status"] == "ok"
    assert rec["memory"]["argument_bytes"] > 0 and rec["roofline"]["flops_per_dev"] > 0
    assert rec["roofline"]["coll_by_op"]["all-gather"] > 0
    skipped = dryrun.run_cell("minicpm-2b", "long_500k", multi_pod=False, save=False)
    assert skipped["status"] == "skipped"


def test_dry_run_cli_writes_its_records(tmp_path):
    from repro_torch.launch import dryrun

    dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--results-dir",
                 str(tmp_path), "--override", "attn_shard=heads"])
    (path,) = tmp_path.iterdir()
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                                  "per_device_total"}


# ---------------------------------------------------------------------------
# The dry run against a live 4-rank world's own count
# ---------------------------------------------------------------------------


def _world_cases(rank, world, _):
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dry_mesh, make_mesh
    from repro_torch.launch.train import init_train_params
    from repro_torch.models import lm
    from repro_torch.roofline.analysis import CostCounter
    from repro_torch.serve.serve_step import make_decode_step, make_prefill
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import local_batch, make_train_step, mesh_specs

    mesh = make_mesh((2, 2), ("data", "model"))
    dmesh = dry_mesh((2, 2), ("data", "model"), rank)
    out = {"coords": (mesh.coords == dmesh.coords, mesh.ranks == dmesh.ranks)}
    shapes = []
    for m in (mesh, dmesh):
        x = torch.arange(24, dtype=torch.float32, device="meta" if m is dmesh else "cpu")
        x = x.reshape(4, 6)
        shapes.append([tuple(coll.all_reduce(x, m, ("data", "model")).shape),
                       tuple(coll.all_gather(x, m, "model", 1).shape),
                       tuple(coll.reduce_scatter(x, m, "data", 0).shape),
                       tuple(coll.all_to_all(x, m, "model").shape),
                       tuple(coll.permute(x, m, "model", 1).shape)])
    out["shapes"] = shapes

    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def compare(card, card_args, dry, dry_args):
        return {"flops": (card.flops, dry.flops), "coll": (dict(card.coll), dict(dry.coll)),
                "args": (card_args, dry_args)}

    # minicpm-2b's train step.
    cfg = get_config("minicpm-2b", reduced=True)
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, N + 1)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params = sharding.shard_params(init_train_params(cfg, seed=0, device="cpu"), mesh,
                                   mesh_specs(cfg, mesh))
    state = adamw_init(lm.trainable(params))
    card_args = dryrun.argument_bytes(params, state, local_batch(batch, mesh))
    step = make_train_step(cfg, ocfg, mesh)
    with CostCounter() as card:
        step(params, state, batch, 0)
    mparams = dryrun.rank_params(cfg, dmesh, lm.param_dtype(cfg))
    mstate = adamw_init(lm.trainable(mparams))
    mbatch = {k: meta(v) for k, v in batch.items()}
    _, dry, _ = dryrun.run_step(cfg, "train", dmesh, mparams, batch=mbatch, opt_cfg=ocfg,
                                opt_state=mstate)
    out["train"] = compare(card, card_args, dry, dryrun.argument_bytes(
        mparams, mstate, local_batch(mbatch, dmesh)))

    # starcoder2-7b's prefill and two decode steps on this rank's rows.
    cfg = get_config("starcoder2-7b", reduced=True)
    full = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = sharding.shard_params(full, mesh, mesh_specs(cfg, mesh))
    rows = B // 2
    idx = int(mesh.coords["data"])
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, N)).astype(np.int32))
    tokens = tokens[idx * rows:(idx + 1) * rows]
    with CostCounter() as card:
        _, cache = make_prefill(cfg, S, mesh=mesh)(params, tokens)
    out["cache_shapes"] = {"starcoder2-7b": _shapes_beside(cache, dryrun.rank_cache(
        cfg, dmesh, B, S, lm.compute_dtype(cfg)))}
    mparams = dryrun.rank_params(cfg, dmesh, lm.compute_dtype(cfg))
    mtok = {"tokens": meta(tokens)}
    _, dry, _ = dryrun.run_step(cfg, "prefill", dmesh, mparams, batch=mtok, max_len=S)
    out["prefill"] = compare(card, dryrun.argument_bytes(params, {"tokens": tokens}), dry,
                             dryrun.argument_bytes(mparams, mtok))
    decode = make_decode_step(cfg, max_len=S, device="cpu", mesh=mesh)
    pos = torch.full((rows,), N, dtype=torch.int32)
    nxt = tokens[:, :1]
    mcache = dryrun.rank_cache(cfg, dmesh, B, S, lm.compute_dtype(cfg))
    for i in range(2):
        card_args = dryrun.argument_bytes(params, cache, nxt, pos)
        with CostCounter() as card:
            logits, cache = decode(params, nxt, cache, pos)
        _, dry, _ = dryrun.run_step(cfg, "decode", dmesh, mparams, cache=mcache,
                                    tokens=meta(nxt), pos=meta(pos), max_len=S)
        out[f"decode{i}"] = compare(card, card_args, dry, dryrun.argument_bytes(
            mparams, mcache, meta(nxt), meta(pos)))
        nxt = logits.argmax(-1).to(torch.int32)
        pos = pos + 1

    # The "seq" layout (attention's positions over "model", a ring on that
    # axis): minicpm-2b's train step and starcoder2-7b's prefill at N_SEQ
    # positions under the kernel impls.
    rng_seq = np.random.default_rng(1)
    for key, arch, impl in (("train_seq", "minicpm-2b", "pallas_distr"),
                            ("prefill_seq", "starcoder2-7b", "pallas_flash")):
        cfg = get_config(arch, reduced=True)
        cfg = cfg.replace(attention=cfg.attention.with_impl(impl))
        toks = torch.from_numpy(rng_seq.integers(0, cfg.vocab, (B, N_SEQ + 1)).astype(np.int32))
        if key == "train_seq":
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            params = sharding.shard_params(init_train_params(cfg, seed=0, device="cpu"), mesh,
                                           mesh_specs(cfg, mesh))
            state = adamw_init(lm.trainable(params))
            card_args = dryrun.argument_bytes(params, state, local_batch(batch, mesh))
            with CostCounter() as card:
                make_train_step(cfg, ocfg, mesh)(params, state, batch, 0)
            mparams = dryrun.rank_params(cfg, dmesh, lm.param_dtype(cfg))
            mstate = adamw_init(lm.trainable(mparams))
            mbatch = {k: meta(v) for k, v in batch.items()}
            _, dry, _ = dryrun.run_step(cfg, "train", dmesh, mparams, batch=mbatch, opt_cfg=ocfg,
                                        opt_state=mstate)
            out[key] = compare(card, card_args, dry, dryrun.argument_bytes(
                mparams, mstate, local_batch(mbatch, dmesh)))
        else:
            full = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            params = sharding.shard_params(full, mesh, mesh_specs(cfg, mesh))
            own = toks[idx * rows:(idx + 1) * rows, :-1]
            with CostCounter() as card:
                make_prefill(cfg, S_SEQ, mesh=mesh)(params, own)
            mparams = dryrun.rank_params(cfg, dmesh, lm.compute_dtype(cfg))
            mtok = {"tokens": meta(own)}
            _, dry, _ = dryrun.run_step(cfg, "prefill", dmesh, mparams, batch=mtok, max_len=S_SEQ)
            out[key] = compare(card, dryrun.argument_bytes(params, {"tokens": own}), dry,
                               dryrun.argument_bytes(mparams, mtok))

    # A prefill cache replicated over "model" (the SSM states, MLA's c_kv)
    # is cut into its "model" blocks only: its rows are this rank's already.
    for arch in ("mamba2-130m", "deepseek-v2-236b"):
        cfg = get_config(arch, reduced=True)
        full = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        params = sharding.shard_params(full, mesh, mesh_specs(cfg, mesh))
        _, cache = make_prefill(cfg, S, mesh=mesh)(params, tokens)
        out["cache_shapes"][arch] = _shapes_beside(cache, dryrun.rank_cache(
            cfg, dmesh, B, S, lm.compute_dtype(cfg)))
    return out


def _shapes_beside(cache, want):
    """{key: (the prefill's block shape, ``cache_pspecs``' block shape)}."""
    return {k: (tuple(cache[k].shape), tuple(want[k].shape)) for k in want}


@pytest.fixture(scope="module")
def world():
    from repro_torch.launch.mesh import run_world

    return run_world(_world_cases, WORLD, None, timeout_s=600)


def test_dry_mesh_and_dry_collectives_match_the_live_world(world):
    for r in world:
        assert r["coords"] == (True, True)
        live, dry = r["shapes"]
        assert live == dry


@pytest.mark.parametrize("arch", ["starcoder2-7b", "mamba2-130m", "deepseek-v2-236b"])
def test_prefill_cache_blocks_have_the_dry_run_shapes(world, arch):
    """Each rank's prefill cache on (data 2, model 2) from its own rows has
    the shapes of its ``cache_pspecs`` block, the dry run's cache."""
    for r in world:
        for key, (got, want) in r["cache_shapes"][arch].items():
            assert got == want, (arch, key)


@pytest.mark.parametrize("step", ["train", "prefill", "decode0", "decode1", "train_seq",
                                  "prefill_seq"])
def test_dry_run_counts_what_each_rank_counts(world, step):
    for rank, r in enumerate(world):
        got = r[step]
        assert got["flops"][0] == got["flops"][1] > 0, (rank, got["flops"])
        assert got["coll"][0] == got["coll"][1], (rank, got["coll"])
        assert got["args"][0] == got["args"][1], (rank, got["args"])
    assert any(v for v in world[0][step]["coll"][0].values())
