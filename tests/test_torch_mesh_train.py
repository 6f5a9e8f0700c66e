"""Port parity of training on a mesh (``train/train_step.py`` with
``mesh=``, the tensor-parallel dense family, FSDP, ``train/trainer.py``'s
mesh-agnostic checkpoints and the launcher's mesh flags) across one 4-rank
gloo world on the CPU (``launch.mesh.run_world``); the test process holds
rank 0's results against the reference and the port on one device.

* qwen1.5-4b and minicpm-2b ``reduced()`` on (data 2, model 2), from the
  reference's ``init_params(PRNGKey(0))`` weights (``from_jax_params`` into
  ``shard_params``): one AdamW step against the reference's single-device
  jitted ``make_train_step`` at its tolerances (loss 1e-3, every gathered
  parameter 5e-3, ``tests/test_distributed.py``), and against the port's
  single-device step: loss and grad norm within 1e-5, and the clipped
  gradient (one step with AdamW swapped for ``p -= g``) within 1e-5.  The
  AdamW parameters themselves are held to 1e-4 of the port's: the first
  AdamW update is g / (|g| + 1e-8), which turns f32 summation-order
  differences in gradients near 1e-8 into up to 8.9e-5 of parameter (one
  CPU run), while the gradients agree to 1.2e-7.
* the context case of the reference's
  ``test_context_parallel_train_step_matches_single_device`` (qwen1.5-4b,
  pallas_flash, seq 512, the ring through ``_ring_dispatch``) on (data 2,
  context 2) and on (context 2, model 2), against the port's single-device
  step at the same tolerances;
* one data-parallel step (data 4, FSDP) of each other family: the MoE
  configs (llama4-scout-17b-a16e, deepseek-v2-236b with MLA), mamba2-130m,
  zamba2-7b, whisper-small (frames) and internvl2-2b (patches), loss and
  gradient against the port's single-device step within 1e-5;
* the refusals that stand: MLA under ``pallas_flash`` on (data 2, model 2)
  (deepseek-v2-236b: the flash kernel needs V as wide as Q; MLA itself
  trains on "model", ``tests/test_torch_mesh_tp.py``), a ``wq`` sliced over
  "model" beside a whole ``wk``;
* a checkpoint written on one device resumed on the mesh and the mesh's
  resumed on one device, bit for bit;
* ``launch.train.main`` with ``--model-parallel 2`` inside the world.
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 4
B, N = 4, 32
CTX_B, CTX_N = 2, 512
FAMILIES = ("llama4-scout-17b-a16e", "deepseek-v2-236b", "mamba2-130m", "zamba2-7b",
            "whisper-small", "internvl2-2b")
TOL_REF = {"loss": 1e-3, "params": 5e-3}
TOL_PORT = 1e-5
TOL_PORT_ADAMW = 1e-4


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


def port_params(arch, arrays=None):
    """The port's f32 training params: converted from the reference's
    weights when ``arrays`` carries them, else drawn from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import init_train_params
    from repro_torch.models import lm
    from repro_torch.models.convert import from_jax_params

    cfg = get_config(arch, reduced=True)
    if arrays is not None and arch in arrays["ref_params"]:
        return cfg, from_jax_params(arrays["ref_params"][arch], cfg, proj=arrays["proj"][arch],
                                    device="cpu", dtype=lm.param_dtype(cfg))
    return cfg, init_train_params(cfg, seed=0, device="cpu")


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


def _world_cases(rank, world, arrays):
    torch.set_num_threads(1)
    from dataclasses import replace

    from repro_torch.launch import mesh as hm
    from repro_torch.launch import train as launch_train
    from repro_torch.models import attention
    from repro_torch.train.data import SyntheticLMData
    from repro_torch.train.trainer import Trainer

    out = {}
    dm = hm.make_host_mesh(model_parallel=2)
    for arch in ("qwen1.5-4b", "minicpm-2b"):
        for sgd in (False, True):
            cfg, params = port_params(arch, arrays)
            out[arch, sgd] = one_step(cfg, params, _batch(arrays, "batch"), mesh=dm, sgd=sgd)

    # The context cases: the ring over "context" beside data, and beside model.
    meshes = {"data 2 × context 2": hm.make_host_mesh(context_parallel=2),
              "context 2 × model 2": hm.make_host_mesh(model_parallel=2, context_parallel=2)}
    for name, mesh in meshes.items():
        for sgd in (False, True):
            cfg, params = port_params("qwen1.5-4b")
            cfg = cfg.replace(attention=replace(cfg.attention, impl="pallas_flash",
                                                context_axis="context"))
            out[name, sgd] = one_step(cfg, params, _batch(arrays, "ctx_batch"), mesh=mesh,
                                      sgd=sgd)

    d4 = hm.make_mesh((world,), ("data",))
    for arch in FAMILIES:
        cfg, params = port_params(arch)
        out[arch, True] = one_step(cfg, params, _batch(arrays, arch), mesh=d4, sgd=True)

    # The refusals that stand (every family trains on "model").
    cfg, params = port_params("deepseek-v2-236b")
    cfg = cfg.replace(attention=replace(cfg.attention, impl="pallas_flash"))
    try:
        one_step(cfg, params, _batch(arrays, "deepseek-v2-236b"), mesh=dm, sgd=True)
        out["mla_flash_refused"] = None
    except ValueError as e:
        out["mla_flash_refused"] = str(e)
    cfg, params = port_params("minicpm-2b")
    lp = dict(params["blocks"][0]["attn"])
    lp["wq"] = {"w": lp["wq"]["w"][:, :lp["wq"]["w"].shape[1] // 2]}
    try:
        with hm.set_mesh(dm):
            attention.attention_apply(lp, torch.zeros(1, 8, cfg.d_model), cfg)
        out["heads_refused"] = None
    except NotImplementedError as e:
        out["heads_refused"] = str(e)

    # Checkpoints: resume the single device's on the mesh, train a step, save.
    cfg, params = port_params("minicpm-2b")
    data = SyntheticLMData(cfg.vocab, B, N, seed=3)
    trainer = Trainer(cfg, _ocfg(), data, params, workdir=arrays["ckpt_dir"], mesh=dm,
                      log_every=1000)
    from repro_torch.distributed import sharding
    from repro_torch.models import lm

    def full():
        return {n: t.detach().numpy().copy() for n, t in lm.named_trainable(
            sharding.gather_params(trainer.params, dm, trainer.specs))}

    out["resumed_step"] = trainer.step
    out["resumed"] = full()
    trainer.run(1)
    out["after"] = full()
    out["after_step"] = trainer.step

    # The launcher inside the world.
    res = launch_train.main(["--arch", "minicpm-2b", "--reduced", "--device", "cpu",
                             "--steps", "2", "--batch", str(B), "--seq", str(N),
                             "--model-parallel", "2", "--workdir", arrays["launch_dir"],
                             "--anomaly-z", "0"])
    out["launch"] = {"mesh": dict(res["mesh"].shape),
                     "losses": [r["loss"] for r in res["history"]]}
    keep = ("launch", "resumed_step", "after_step")
    return {k: v for k, v in out.items() if rank == 0 or k in keep}


def _tokens(rng, b, n, vocab):
    toks = rng.integers(0, vocab, (b, n + 1)).astype(np.int64)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def world():
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.core import lsh as ref_lsh
    from repro.models import lm as ref_lm
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_world
    from repro_torch.train.data import SyntheticLMData
    from repro_torch.train.trainer import Trainer

    rng = np.random.default_rng(0)
    arrays = {"ref_params": {}, "proj": {}, "batch": _tokens(rng, B, N, 512),
              "ctx_batch": _tokens(rng, CTX_B, CTX_N, 512)}
    for arch in ("qwen1.5-4b", "minicpm-2b"):
        rcfg = ref_get_config(arch, reduced=True)
        arrays["ref_params"][arch] = jax.tree_util.tree_map(
            np.asarray, ref_lm.init_params(jax.random.PRNGKey(0), rcfg))
        dcfg = rcfg.attention.distr
        arrays["proj"][arch] = np.array(ref_lsh.make_projection(
            jax.random.PRNGKey(dcfg.proj_seed), dcfg.block_q))
    for arch in FAMILIES:
        cfg = get_config(arch, reduced=True)
        arrays[arch] = _tokens(rng, B, N, cfg.vocab)
        if cfg.family == "encdec":
            arrays[arch]["frames"] = rng.standard_normal((B, cfg.cross_len, cfg.d_model)
                                                         ).astype(np.float32)
        elif cfg.frontend == "patch_stub":
            arrays[arch]["patches"] = rng.standard_normal(
                (B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        arrays["ckpt_dir"] = os.path.join(tmp, "ckpt")
        arrays["launch_dir"] = os.path.join(tmp, "launch")
        cfg, params = port_params("minicpm-2b")
        one = Trainer(cfg, _ocfg(), SyntheticLMData(cfg.vocab, B, N, seed=3), params,
                      workdir=arrays["ckpt_dir"], log_every=1000)
        one.run(1)
        from repro_torch.models import lm

        saved = {n: t.detach().numpy().copy() for n, t in lm.named_trainable(one.params)}
        results = run_world(_world_cases, WORLD, arrays, timeout_s=600)
        cfg, params = port_params("minicpm-2b")
        back = Trainer(cfg, _ocfg(), SyntheticLMData(cfg.vocab, B, N, seed=3), params,
                       workdir=arrays["ckpt_dir"], log_every=1000)
        back_params = {n: t.detach().numpy().copy() for n, t in lm.named_trainable(back.params)}
        yield arrays, results, {"saved": saved, "back_step": back.step, "back": back_params}


def _ref_step(arrays, arch):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.train.optimizer import OptimizerConfig, adamw_init
    from repro.train.train_step import make_train_step

    rcfg = ref_get_config(arch, reduced=True)
    params = jax.tree_util.tree_map(jnp.asarray, arrays["ref_params"][arch])
    batch = {k: jnp.asarray(v, jnp.int32) for k, v in arrays["batch"].items()}
    step = make_train_step(rcfg, OptimizerConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10))
    p1, _, m1 = jax.jit(step)(params, adamw_init(params), batch, jnp.asarray(0))
    return float(m1["loss"]), p1


def _ref_leaf(tree, name: str) -> np.ndarray:
    """The reference leaf at a port key path (``blocks/1/attn/wq/w`` reads
    layer 1 of the stacked ``blocks/attn/wq/w``)."""
    parts = name.split("/")
    node, layer = tree, None
    for part in parts:
        if part.isdigit():
            layer = int(part)
            continue
        node = node[part]
    node = np.asarray(node)
    return node[layer] if layer is not None else node


def _worst(got: dict, want) -> float:
    if isinstance(want, dict) and set(want) == set(got):
        return max(float(np.abs(got[n] - want[n]).max()) for n in got)
    return max(float(np.abs(got[n] - _ref_leaf(want, n)).max()) for n in got)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "minicpm-2b"])
def test_sharded_step_matches_the_reference_single_device(world, arch):
    arrays, results, _ = world
    loss, _, params = results[0][arch, False]
    ref_loss, ref_params = _ref_step(arrays, arch)
    assert abs(loss - ref_loss) < TOL_REF["loss"], (loss, ref_loss)
    assert _worst(params, ref_params) < TOL_REF["params"]


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "minicpm-2b"])
def test_sharded_step_matches_the_port_single_device(world, arch):
    arrays, results, _ = world
    for sgd, tol in ((False, TOL_PORT_ADAMW), (True, TOL_PORT)):
        loss, gnorm, params = results[0][arch, sgd]
        cfg, full = port_params(arch, arrays)
        want_loss, want_gnorm, want = one_step(cfg, full, _batch(arrays, "batch"), sgd=sgd)
        assert abs(loss - want_loss) < TOL_PORT and abs(gnorm - want_gnorm) < TOL_PORT * want_gnorm
        assert _worst(params, want) < tol, sgd


@pytest.mark.parametrize("name", ["data 2 × context 2", "context 2 × model 2"])
def test_context_parallel_step_matches_single_device(world, name):
    from dataclasses import replace

    arrays, results, _ = world
    cfg, full = port_params("qwen1.5-4b")
    cfg = cfg.replace(attention=replace(cfg.attention, impl="pallas_flash"))
    for sgd in (False, True):
        loss, gnorm, params = results[0][name, sgd]
        want_loss, want_gnorm, want = one_step(cfg, port_params("qwen1.5-4b")[1],
                                               _batch(arrays, "ctx_batch"), sgd=sgd)
        assert abs(loss - want_loss) < TOL_REF["loss"]
        assert _worst(params, want) < (TOL_PORT if sgd else TOL_REF["params"])
        assert abs(gnorm - want_gnorm) < TOL_PORT * want_gnorm


@pytest.mark.parametrize("arch", FAMILIES)
def test_data_parallel_step_of_every_family(world, arch):
    arrays, results, _ = world
    loss, gnorm, params = results[0][arch, True]
    cfg, full = port_params(arch)
    want_loss, want_gnorm, want = one_step(cfg, full, _batch(arrays, arch), sgd=True)
    assert abs(loss - want_loss) < TOL_PORT * max(1.0, abs(want_loss))
    assert abs(gnorm - want_gnorm) < TOL_PORT * want_gnorm
    assert _worst(params, want) < TOL_PORT


def test_refusals(world):
    _, results, _ = world
    assert "MLA under pallas_flash" in results[0]["mla_flash_refused"]
    assert "slice both" in results[0]["heads_refused"]


def test_checkpoints_cross_between_mesh_and_one_device(world):
    _, results, ckpt = world
    lead = results[0]
    assert lead["resumed_step"] == 1 and lead["after_step"] == 2
    for name, arr in ckpt["saved"].items():
        np.testing.assert_array_equal(lead["resumed"][name], arr)
    assert ckpt["back_step"] == 2
    for name, arr in lead["after"].items():
        np.testing.assert_array_equal(ckpt["back"][name], arr)


def test_launcher_trains_on_the_mesh_inside_a_world(world):
    _, results, _ = world
    runs = [r["launch"] for r in results]
    assert all(r["mesh"] == {"data": 2, "model": 2} for r in runs)
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    assert len(runs[0]["losses"]) == 2 and all(np.isfinite(runs[0]["losses"]))
