"""Port parity of MoE expert parallelism (``models/moe.py``: ``_moe_ep_a2a``,
``_moe_ep_psum``, ``moe_apply``'s choice) and of the moe family's training
on a (data 2, model 2) mesh, across one 4-rank gloo world on the CPU
(``launch.mesh.run_world``).

The reference's ``_moe_ep_a2a`` and ``_moe_ep_psum`` run in a subprocess
with 4 forced host devices on the same mesh, as its
``tests/test_distributed.py`` runs them, and hand their outputs over as
arrays.  llama4-scout-17b-a16e ``reduced()`` (4 experts, top-1), f32, the
layer's weights and x (4 × 32 tokens) drawn with numpy from a seed:

* at ``capacity_factor`` 1.0, where ``ep_a2a`` drops assignments: the
  port's kept / dropped pattern equals the reference's exactly (top-1: a
  token whose assignment dropped has a zero output row) and y and the aux
  loss agree within 1e-5; the gradients of ``sum(y · c) + aux`` with
  respect to x, the router and the experts against ``jax.grad`` of the
  same, within 1e-5;
* at ``capacity_factor`` 8.0 both ports' paths match the reference's
  single-device ``_moe_dense_onehot`` within its 1e-3;
* ``moe_apply`` takes ``ep_a2a``, and ``ep_psum`` with ``decode=True``,
  under the mesh, and the single-device dispatch with none.

A training step of llama4-scout-17b-a16e ``reduced()`` on (data 2, model 2),
from the same state and batch as the port's single-device step, with AdamW
swapped for ``p -= g``: loss, grad norm and every clipped gradient within
1e-5.  At a capacity factor where nothing drops and with
``router_aux_weight`` 0: the expert-parallel aux loss is the shards' own,
meaned (the reference's), not the single device's whole-batch loss, and
its value is held to the reference above.  ``launch.train --model-parallel
2`` trains llama4 in the world; ``check_mesh`` accepts every family under
"model" > 1 and refuses a "model" axis that would cut an attention head.
"""
import os
import subprocess
import sys
import tempfile
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import one_intra_op_thread  # noqa: E402,F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
ARCH = "llama4-scout-17b-a16e"
B, S = 4, 32
CF_DROP, CF_FULL = 1.0, 8.0
TOL = 1e-5
TOL_DENSE = 1e-3  # the reference's own (tests/test_distributed.py)
STEP_B, STEP_N = 4, 32


def _cfg(cf: float, impl: str = "auto"):
    from repro_torch.configs import get_config

    return get_config(ARCH, reduced=True).replace(capacity_factor=cf, moe_impl=impl)


def _draw(cfg, seed: int = 0) -> dict:
    """The layer's weights (the reference's scales), x and the cotangent c,
    as numpy f32."""
    rng = np.random.default_rng(seed)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"router": normal((d, e), d ** -0.5), "gate": normal((e, d, f), d ** -0.5),
            "up": normal((e, d, f), d ** -0.5), "down": normal((e, f, d), f ** -0.5),
            "x": normal((B, S, d), 1.0), "c": normal((B, S, d), 1.0)}


def _port_params(arrays: dict, grad: bool = False) -> dict:
    def t(name):
        return torch.from_numpy(arrays[name].copy()).requires_grad_(grad)

    return {"router": {"w": t("router")},
            "experts": {"gate": t("gate"), "up": t("up"), "down": t("down")}}


_REF_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.launch.mesh import compat_make_mesh
from repro.models import moe
from repro.utils.jax_compat import get_abstract_mesh, set_mesh

a = dict(np.load({inp!r}))
mesh = compat_make_mesh((2, 2), ("data", "model"))
params = {{"router": {{"w": jnp.asarray(a["router"])}},
          "experts": {{k: jnp.asarray(a[k]) for k in ("gate", "up", "down")}}}}
x, c = jnp.asarray(a["x"]), jnp.asarray(a["c"])
out = {{}}
for cf in ({cf_drop!r}, {cf_full!r}):
    cfg = get_config({arch!r}, reduced=True).replace(capacity_factor=cf)
    y, aux = moe._moe_dense_onehot(params, x, cfg)
    out[f"dense/{{cf}}/y"], out[f"dense/{{cf}}/aux"] = np.asarray(y), np.asarray(aux)
    with set_mesh(mesh):
        am = get_abstract_mesh()
        for impl, fn in (("ep_a2a", moe._moe_ep_a2a), ("ep_psum", moe._moe_ep_psum)):
            def loss(p, xx, fn=fn, cfg=cfg):
                y, aux = fn(p, xx, cfg, am)
                return jnp.sum(y * c) + aux, (y, aux)
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(params, x)
            key = f"{{impl}}/{{cf}}"
            out[key + "/y"], out[key + "/aux"] = np.asarray(y), np.asarray(aux)
            out[key + "/gx"], out[key + "/grouter"] = np.asarray(gx), np.asarray(gp["router"]["w"])
            for k in ("gate", "up", "down"):
                out[key + "/g" + k] = np.asarray(gp["experts"][k])
np.savez({out!r}, **out)
"""


def _reference(arrays: dict, tmp: str) -> dict:
    inp, out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "ref.npz")
    np.savez(inp, **arrays)
    script = _REF_SCRIPT.format(src=SRC, inp=inp, out=out, arch=ARCH, cf_drop=CF_DROP,
                                cf_full=CF_FULL)
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(script)], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    return dict(np.load(out))


def _sgd(params, grads, state, opt_cfg, lr):
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(g.float())
    state["count"] += 1
    return params, state


def one_step(cfg, params, batch, mesh=None):
    """One train step with AdamW swapped for ``p -= g`` (the parameters then
    carry the clipped gradient) → (loss, grad norm, aux, the full trainable
    params after it as numpy)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    real = opt.adamw_update
    opt.adamw_update = _sgd
    try:
        if mesh is not None:
            specs = ts.mesh_specs(cfg, mesh)
            params = sharding.shard_params(params, mesh, specs)
        state = opt.adamw_init(lm.trainable(params))
        ocfg = opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10)
        params, _, m = ts.make_train_step(cfg, ocfg, mesh)(params, state, batch, 0)
    finally:
        opt.adamw_update = real
    if mesh is not None:
        params = sharding.gather_params(params, mesh, specs)
    return (float(m["loss"]), float(m["grad_norm"]), float(m["aux"]),
            {n: t.detach().numpy().copy() for n, t in lm.named_trainable(params)})


def step_cfg():
    return _cfg(CF_FULL).replace(router_aux_weight=0.0)


def step_params(cfg):
    from repro_torch.launch.train import init_train_params

    return init_train_params(cfg, seed=0, device="cpu")


def _world_cases(rank, world, arrays, batch, launch_dir):
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as hm
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe

    mesh = hm.make_host_mesh(model_parallel=2)
    dp = int(mesh.coords["data"])
    rows = slice(dp * B // 2, (dp + 1) * B // 2)
    x_all = torch.from_numpy(arrays["x"])
    c = torch.from_numpy(arrays["c"][rows])
    out = {}
    for cf in (CF_DROP, CF_FULL):
        for impl, fn in moe.EP_IMPLS.items():
            params = _port_params(arrays, grad=True)
            x = x_all[rows].clone().requires_grad_(True)
            with hm.set_mesh(mesh):
                y, aux = fn(params, x, _cfg(cf), mesh)
                # This rank's share of sum(y · c) + aux: the ranks' losses
                # sum to the reference's (aux counted once over the data axis).
                (torch.sum(y * c) + aux / 2).backward()
            g = {"x": x.grad, "router": params["router"]["w"].grad,
                 **{k: params["experts"][k].grad for k in ("gate", "up", "down")}}
            out[impl, cf] = {"y": y.detach().numpy(), "aux": float(aux), "rows": rows,
                             "grads": {k: v.numpy().copy() for k, v in g.items()}}
    # moe_apply's choice: ep_a2a, ep_psum when decoding, none without a mesh.
    params = _port_params(arrays)
    cfg = _cfg(CF_DROP)
    x = x_all[rows]
    with torch.no_grad():
        with hm.set_mesh(mesh):
            picks = {"auto": moe.moe_apply(params, x, cfg)[0],
                     "decode": moe.moe_apply(params, x, cfg, decode=True)[0],
                     "dense_onehot": moe.moe_apply(params, x, cfg.replace(
                         moe_impl="dense_onehot"))[0]}
            want = {"auto": moe._moe_ep_a2a(params, x, cfg, mesh)[0],
                    "decode": moe._moe_ep_psum(params, x, cfg, mesh)[0]}
        want["dense_onehot"] = moe.moe_apply(params, x, cfg)[0]
    out["picks"] = {k: bool(torch.equal(picks[k], want[k])) for k in picks}

    cfg = step_cfg()
    out["step"] = one_step(cfg, step_params(cfg), {k: torch.from_numpy(v)
                                                   for k, v in batch.items()}, mesh)
    res = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                             "--batch", str(STEP_B), "--seq", str(STEP_N),
                             "--model-parallel", "2", "--workdir", launch_dir,
                             "--anomaly-z", "0"])
    out["launch"] = {"mesh": dict(res["mesh"].shape),
                     "losses": [r["loss"] for r in res["history"]]}
    return out


@pytest.fixture(scope="module")
def world():
    from repro_torch.launch.mesh import run_world

    arrays = _draw(_cfg(CF_DROP))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, _cfg(CF_FULL).vocab, (STEP_B, STEP_N + 1)).astype(np.int64)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with tempfile.TemporaryDirectory() as tmp:
        ref = _reference(arrays, tmp)
        results = run_world(_world_cases, WORLD, arrays, batch, os.path.join(tmp, "launch"),
                            timeout_s=600)
    yield arrays, ref, results, batch


def _assembled(results, key, field):
    """The global (B, S, ·) array from the data ranks' rows (model rank 0)."""
    return np.concatenate([results[r][key][field] for r in (0, 2)])


def _kept(y: np.ndarray) -> np.ndarray:
    """Top-1: the tokens whose routed assignment was kept (a dropped one's
    output row is exactly zero)."""
    return np.abs(y).max(axis=-1) > 0


@pytest.mark.parametrize("impl", ["ep_a2a", "ep_psum"])
def test_ep_matches_the_reference_where_assignments_drop(world, impl):
    _, ref, results, _ = world
    key = f"{impl}/{CF_DROP}"
    y = _assembled(results, (impl, CF_DROP), "y")
    want = ref[key + "/y"]
    kept, want_kept = _kept(y), _kept(want)
    if impl == "ep_a2a":
        assert (~want_kept).sum() > 0, "no assignment dropped: the case tests nothing"
    np.testing.assert_array_equal(kept, want_kept)
    assert float(np.abs(y - want).max()) < TOL
    for r in range(WORLD):  # the aux loss is replicated over the whole mesh
        assert abs(results[r][impl, CF_DROP]["aux"] - float(ref[key + "/aux"])) < TOL
    # Model ranks hold the same replicated y.
    np.testing.assert_array_equal(results[0][impl, CF_DROP]["y"],
                                  results[1][impl, CF_DROP]["y"])


@pytest.mark.parametrize("impl", ["ep_a2a", "ep_psum"])
def test_ep_gradients_match_the_reference(world, impl):
    _, ref, results, _ = world
    key = f"{impl}/{CF_DROP}"
    gx = np.concatenate([results[r][impl, CF_DROP]["grads"]["x"] for r in (0, 2)])
    assert float(np.abs(gx - ref[key + "/gx"]).max()) < TOL
    for name in ("router", "gate", "up", "down"):
        # Each rank's weight gradient is its rows' share: summed over the
        # data ranks (and, for experts each model rank holds a slice of,
        # over those too: the other slices' rows are zero).
        got = sum(results[r][impl, CF_DROP]["grads"][name] for r in (0, 2))
        if name != "router":
            got = got + sum(results[r][impl, CF_DROP]["grads"][name] for r in (1, 3))
        else:
            np.testing.assert_allclose(
                sum(results[r][impl, CF_DROP]["grads"][name] for r in (1, 3)), got,
                atol=TOL, err_msg="the router's gradient differs between model ranks")
        want = ref[f"{key}/g{name}"]
        assert float(np.abs(got - want).max()) < TOL * max(1.0, float(np.abs(want).max())), name


@pytest.mark.parametrize("impl", ["ep_a2a", "ep_psum"])
def test_ep_matches_the_reference_dense_path_where_nothing_drops(world, impl):
    _, ref, results, _ = world
    y = _assembled(results, (impl, CF_FULL), "y")
    assert float(np.abs(y - ref[f"dense/{CF_FULL}/y"]).max()) < TOL_DENSE
    assert float(np.abs(y - ref[f"{impl}/{CF_FULL}/y"]).max()) < TOL


def test_moe_apply_chooses_the_reference_impl(world):
    _, _, results, _ = world
    for r in range(WORLD):
        assert results[r]["picks"] == {"auto": True, "decode": True, "dense_onehot": True}


def test_train_step_on_the_mesh_matches_single_device(world):
    _, _, results, batch = world
    loss, gnorm, _, params = results[0]["step"]
    cfg = step_cfg()
    want_loss, want_gnorm, _, want = one_step(cfg, step_params(cfg),
                                              {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(loss - want_loss) < TOL * max(1.0, abs(want_loss))
    assert abs(gnorm - want_gnorm) < TOL * want_gnorm
    assert max(float(np.abs(params[n] - want[n]).max()) for n in want) < TOL
    assert all(r["step"][0] == loss for r in results)


def test_launcher_trains_llama4_on_the_mesh_inside_a_world(world):
    _, _, results, _ = world
    runs = [r["launch"] for r in results]
    assert all(r["mesh"] == {"data": 2, "model": 2} for r in runs)
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    assert len(runs[0]["losses"]) == 2 and all(np.isfinite(runs[0]["losses"]))


@pytest.mark.parametrize("arch,model,ok", [
    ("llama4-scout-17b-a16e", 2, True), ("qwen1.5-4b", 2, True), ("deepseek-v2-236b", 2, True),
    ("mamba2-130m", 2, True), ("zamba2-7b", 2, True), ("whisper-small", 2, True),
    # 4 heads over 8 ranks: each rank's columns would be half a head.  Under
    # attn_shard="seq" (qwen1.5-4b) the layer gathers its slices and runs
    # whole; MLA under "heads" (deepseek) is refused.
    ("qwen1.5-4b", 8, True), ("deepseek-v2-236b", 8, False), ("mamba2-130m", 8, True)])
def test_check_mesh_under_model_parallelism(arch, model, ok):
    from repro_torch.configs import get_config
    from repro_torch.train.train_step import check_mesh

    cfg = get_config(arch, reduced=True)
    mesh = SimpleNamespace(axis_names=("data", "model"), shape={"data": 2, "model": model})
    if ok:
        check_mesh(cfg, mesh)
    else:
        with pytest.raises(NotImplementedError, match="would cut"):
            check_mesh(cfg, mesh)
    check_mesh(cfg, SimpleNamespace(axis_names=("data",), shape={"data": 4}))
