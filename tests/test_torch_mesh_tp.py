"""Port parity of tensor parallelism ("model" > 1) for the ssm, hybrid and
enc-dec families and MLA (``models/mamba.py``, ``models/attention.py``'s
cross-attention and MLA, ``train/train_step.py``) across one 4-rank gloo
world on the CPU (``launch.mesh.run_world``); the test process holds rank
0's results against the reference and the port on one device.

* mamba2-130m, zamba2-7b, whisper-small (frames) and deepseek-v2-236b
  ``reduced()`` on (data 2, model 2), from the reference's
  ``init_params(PRNGKey(0))`` weights (``from_jax_params`` into
  ``shard_params``): one AdamW step against the reference's single-device
  jitted ``make_train_step`` at its tolerances (loss 1e-3, every gathered
  parameter 5e-3, ``tests/test_distributed.py``), and against the port's
  single-device step: loss and grad norm within 1e-5, and the clipped
  gradient (one step with AdamW swapped for ``p -= g``) within 1e-5.  The
  AdamW parameters are held to the port's at the reference's 5e-3, as the
  context-parallel case of ``tests/test_torch_mesh_train.py`` holds them:
  the first AdamW update is g / (|g| + 1e-8), which turns f32
  summation-order differences in gradients near 1e-8 into up to 1.7e-4 of
  parameter (mamba2-130m's ``in_proj``, one CPU run), while the gradients
  agree within 1e-5.
  deepseek-v2-236b runs at a capacity factor where no expert drops and
  with ``router_aux_weight`` 0: its MoE layers run expert parallel, whose
  aux loss is the shards' own (the reference's), not the single device's.
* mamba2-130m ``reduced()`` at d_model 96 on (model 4): 6 SSM heads over 4
  ranks, ``in_proj`` left whole by the rules (422 columns) and the conv and
  ``out_proj`` sliced, so every rank runs the layer whole; against the
  port's single-device step within 1e-5.
* the Mamba-2 layer's three traps, each planted in one more step of
  mamba2-130m on (data 2, model 2), must move the clipped gradient past
  1e-5: ``out_norm``'s sum of squares left unsummed over "model", the
  per-head parameters taken without ``take_slice``'s gather, and the
  squares' cotangent left unsummed (``tp_reduce``'s identity backward).
* ``launch.train.main --arch zamba2-7b --reduced --model-parallel 2``
  inside the world.
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 4
B, N = 4, 32
ARCHS = ("mamba2-130m", "zamba2-7b", "whisper-small", "deepseek-v2-236b")
WHOLE_D_MODEL = 96
TOL_REF = {"loss": 1e-3, "params": 5e-3}
TOL_PORT = 1e-5
FAULTS = ("norm_squares_unsummed", "per_head_without_take_slice", "norm_cotangent_unsummed")


def cfg_of(arch, d_model=None):
    from repro_torch.configs import get_config

    cfg = get_config(arch, reduced=True)
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=8.0, router_aux_weight=0.0)
    return cfg.replace(d_model=d_model) if d_model else cfg


def port_params(arch, arrays=None, d_model=None):
    """The port's f32 training params: converted from the reference's
    weights when ``arrays`` carries them, else drawn from seed 0."""
    from repro_torch.launch.train import init_train_params
    from repro_torch.models import lm
    from repro_torch.models.convert import from_jax_params

    cfg = cfg_of(arch, d_model)
    if arrays is not None:
        return cfg, from_jax_params(arrays["ref_params"][arch], cfg, proj=arrays["proj"][arch],
                                    device="cpu", dtype=lm.param_dtype(cfg))
    return cfg, init_train_params(cfg, seed=0, device="cpu")


def _sgd(params, grads, state, opt_cfg, lr):
    """AdamW swapped for p -= g: the parameters then carry the clipped
    gradient."""
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(g.float())
    state["count"] += 1
    return params, state


def _ocfg():
    from repro_torch.train.optimizer import OptimizerConfig

    return OptimizerConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10)


def _batch(arrays, key):
    return {k: torch.from_numpy(v) for k, v in arrays[key].items()}


def one_step(cfg, params, batch, *, mesh=None, sgd=False):
    """One train step (on ``mesh``: from the full ``params``, sharded here)
    → (loss, grad norm, the full trainable params after it as numpy)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    real = opt.adamw_update
    if sgd:
        opt.adamw_update = _sgd
    try:
        if mesh is not None:
            specs = ts.mesh_specs(cfg, mesh)
            params = sharding.shard_params(params, mesh, specs)
        state = opt.adamw_init(lm.trainable(params))
        params, _, m = ts.make_train_step(cfg, _ocfg(), mesh)(params, state, batch, 0)
    finally:
        opt.adamw_update = real
    if mesh is not None:
        params = sharding.gather_params(params, mesh, specs)
    return (float(m["loss"]), float(m["grad_norm"]),
            {n: t.detach().numpy().copy() for n, t in lm.named_trainable(params)})


def _planted(fault):
    """A context that plants one of FAULTS in ``models.mamba``'s
    tensor-parallel layer."""
    import contextlib

    from repro_torch.distributed import collectives as coll
    from repro_torch.models import mamba

    @contextlib.contextmanager
    def swap(obj, name, value):
        real = getattr(obj, name)
        setattr(obj, name, value)
        try:
            yield
        finally:
            setattr(obj, name, real)

    if fault == "norm_squares_unsummed":
        return swap(mamba.coll, "sum_dp", lambda x, mesh, axes: x)
    if fault == "per_head_without_take_slice":
        return swap(mamba.coll, "take_slice", lambda x, mesh, axis, dim: coll._own_slice(
            x, mesh, axis, dim))
    return swap(mamba.coll, "sum_dp", lambda x, mesh, axes: coll.tp_reduce(x, mesh, axes))


def _world_cases(rank, world, arrays):
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as hm
    from repro_torch.launch import train as launch_train

    out = {}
    dm = hm.make_host_mesh(model_parallel=2)
    for arch in ARCHS:
        for sgd in (False, True):
            cfg, params = port_params(arch, arrays)
            out[arch, sgd] = one_step(cfg, params, _batch(arrays, arch), mesh=dm, sgd=sgd)
    for fault in FAULTS:
        cfg, params = port_params("mamba2-130m", arrays)
        with _planted(fault):
            out[fault] = one_step(cfg, params, _batch(arrays, "mamba2-130m"), mesh=dm, sgd=True)

    m4 = hm.make_mesh((world,), ("model",))
    cfg, params = port_params("mamba2-130m", d_model=WHOLE_D_MODEL)
    out["whole"] = one_step(cfg, params, _batch(arrays, "whole"), mesh=m4, sgd=True)

    res = launch_train.main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                             "--steps", "2", "--batch", str(B), "--seq", str(N),
                             "--model-parallel", "2", "--workdir", arrays["launch_dir"],
                             "--anomaly-z", "0"])
    out["launch"] = {"mesh": dict(res["mesh"].shape),
                     "losses": [r["loss"] for r in res["history"]]}
    return {k: v for k, v in out.items() if rank == 0 or k == "launch"}


def _tokens(rng, b, n, vocab):
    toks = rng.integers(0, vocab, (b, n + 1)).astype(np.int64)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def world():
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.core import lsh as ref_lsh
    from repro.models import lm as ref_lm
    from repro_torch.launch.mesh import run_world

    rng = np.random.default_rng(0)
    arrays = {"ref_params": {}, "proj": {}}
    for arch in ARCHS:
        cfg = cfg_of(arch)
        rcfg = ref_get_config(arch, reduced=True)
        arrays["ref_params"][arch] = jax.tree_util.tree_map(
            np.asarray, ref_lm.init_params(jax.random.PRNGKey(0), rcfg))
        dcfg = rcfg.attention.distr
        arrays["proj"][arch] = np.array(ref_lsh.make_projection(
            jax.random.PRNGKey(dcfg.proj_seed), dcfg.block_q))
        arrays[arch] = _tokens(rng, B, N, cfg.vocab)
        if cfg.family == "encdec":
            arrays[arch]["frames"] = rng.standard_normal((B, cfg.cross_len, cfg.d_model)
                                                         ).astype(np.float32)
    arrays["whole"] = _tokens(rng, B, N, cfg_of("mamba2-130m").vocab)
    with tempfile.TemporaryDirectory() as tmp:
        arrays["launch_dir"] = os.path.join(tmp, "launch")
        yield arrays, run_world(_world_cases, WORLD, arrays, timeout_s=600)


def _ref_step(arrays, arch):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.train.optimizer import OptimizerConfig, adamw_init
    from repro.train.train_step import make_train_step

    cfg = cfg_of(arch)
    rcfg = ref_get_config(arch, reduced=True).replace(
        capacity_factor=cfg.capacity_factor, router_aux_weight=cfg.router_aux_weight)
    params = jax.tree_util.tree_map(jnp.asarray, arrays["ref_params"][arch])
    batch = {k: jnp.asarray(v, jnp.float32 if k == "frames" else jnp.int32)
             for k, v in arrays[arch].items()}
    step = make_train_step(rcfg, OptimizerConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10))
    p1, _, m1 = jax.jit(step)(params, adamw_init(params), batch, jnp.asarray(0))
    return float(m1["loss"]), p1


def _ref_leaf(tree, name: str) -> np.ndarray:
    """The reference leaf at a port key path: a digit indexes the stacked
    layers of the key before it (``groups/1/0/mixer/...`` reads group 1,
    layer 0), except under ``shared``, a list of unstacked blocks."""
    node, index = tree, []
    for part in name.split("/"):
        if part.isdigit():
            if isinstance(node, (list, tuple)):
                node = node[int(part)]
            else:
                index.append(int(part))
            continue
        node = node[part]
    node = np.asarray(node)
    return node[tuple(index)] if index else node


def _worst(got: dict, want) -> float:
    if isinstance(want, dict) and set(want) == set(got):
        return max(float(np.abs(got[n] - want[n]).max()) for n in got)
    return max(float(np.abs(got[n] - _ref_leaf(want, n)).max()) for n in got)


def test_check_mesh_accepts_every_family_on_model():
    from types import SimpleNamespace

    from repro_torch.train.train_step import check_mesh

    mesh = SimpleNamespace(axis_names=("data", "model"), shape={"data": 2, "model": 2})
    for arch in ARCHS:
        check_mesh(cfg_of(arch), mesh)


def test_whole_case_slices_the_conv_and_out_proj_but_not_in_proj():
    from types import SimpleNamespace

    from repro_torch.train.train_step import mesh_specs

    cfg = cfg_of("mamba2-130m", WHOLE_D_MODEL)
    assert cfg.ssm_heads % WORLD != 0
    specs = mesh_specs(cfg, SimpleNamespace(axis_names=("model",), shape={"model": WORLD}))
    mixer = specs["blocks"][0]["mixer"]
    assert tuple(mixer["in_proj"]["w"]) == (None, None)
    assert tuple(mixer["conv_w"]) == (None, "model") and tuple(mixer["conv_b"]) == ("model",)
    assert tuple(mixer["out_proj"]["w"]) == ("model", None)


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_step_matches_the_reference_single_device(world, arch):
    arrays, results = world
    loss, _, params = results[0][arch, False]
    ref_loss, ref_params = _ref_step(arrays, arch)
    assert abs(loss - ref_loss) < TOL_REF["loss"], (loss, ref_loss)
    assert _worst(params, ref_params) < TOL_REF["params"]


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_step_matches_the_port_single_device(world, arch):
    arrays, results = world
    for sgd, tol in ((False, TOL_REF["params"]), (True, TOL_PORT)):
        loss, gnorm, params = results[0][arch, sgd]
        cfg, full = port_params(arch, arrays)
        want_loss, want_gnorm, want = one_step(cfg, full, _batch(arrays, arch), sgd=sgd)
        assert abs(loss - want_loss) < TOL_PORT * max(1.0, abs(want_loss))
        assert abs(gnorm - want_gnorm) < TOL_PORT * want_gnorm
        assert _worst(params, want) < tol, sgd


def test_heads_that_do_not_divide_model_run_the_layer_whole(world):
    arrays, results = world
    loss, gnorm, params = results[0]["whole"]
    cfg, full = port_params("mamba2-130m", d_model=WHOLE_D_MODEL)
    want_loss, want_gnorm, want = one_step(cfg, full, _batch(arrays, "whole"), sgd=True)
    assert abs(loss - want_loss) < TOL_PORT * max(1.0, abs(want_loss))
    assert abs(gnorm - want_gnorm) < TOL_PORT * want_gnorm
    assert _worst(params, want) < TOL_PORT


@pytest.mark.parametrize("fault", FAULTS)
def test_each_planted_mamba_fault_moves_the_gradient(world, fault):
    arrays, results = world
    _, _, sound = results[0]["mamba2-130m", True]
    _, _, planted = results[0][fault]
    assert _worst(planted, sound) > 100 * TOL_PORT


def test_launcher_trains_zamba2_on_the_model_axis_inside_a_world(world):
    _, results = world
    runs = [r["launch"] for r in results]
    assert all(r["mesh"] == {"data": 2, "model": 2} for r in runs)
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    assert len(runs[0]["losses"]) == 2 and all(np.isfinite(runs[0]["losses"]))
