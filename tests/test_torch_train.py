"""Port parity on the training path: the optimizer, the LR schedules and the
synthetic data against ``repro.train``, and three train steps of
minicpm-2b ``reduced()`` (2 layers, f32, tied embeddings) from the
reference's ``lm.init_params(PRNGKey(0))`` weights, carried over by
``models.convert.from_jax_params``, against the reference
``make_train_step`` under both kernel impls: loss, grad norm and every
parameter at 1e-4."""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import lsh as ref_lsh  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.train import data as ref_data  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.train_step import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.data import SyntheticLMData  # noqa: E402
from repro_torch.train.train_step import make_eval_step, make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from _torch_helpers import one_intra_op_thread  # noqa: E402,F401

ARCH = "minicpm-2b"
TOL = 1e-4


@pytest.fixture(scope="module")
def ref_model():
    rcfg = ref_get_config(ARCH, reduced=True)
    rparams = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    dcfg = rcfg.attention.distr
    proj = np.array(ref_lsh.make_projection(jax.random.PRNGKey(dcfg.proj_seed), dcfg.block_q))
    return rcfg, rparams, proj


def _port_params(rparams, tcfg, proj):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, rparams), tcfg, proj=proj,
                           device="cpu", dtype=lm.param_dtype(tcfg))


def _with_impl(cfg, impl):
    return cfg.replace(attention=cfg.attention.with_impl(impl))


def _batch(rng, b, n, vocab):
    toks = rng.integers(0, vocab, (b, n + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long()})


# ---------------------------------------------------------------------------
# Optimizer, schedules, data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
def test_schedule_matches_reference(name):
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1, schedule=name,
              wsd_decay_frac=0.2)
    rcfg, tcfg = ref_opt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    for step in range(0, 111, 3):
        assert opt.schedule(tcfg, step) == pytest.approx(
            float(ref_opt.schedule(rcfg, jnp.asarray(step))), rel=1e-6, abs=1e-7)


def test_clip_and_adamw_match_reference():
    _clip_and_adamw_against_reference()


def test_clip_and_adamw_in_pieces_match_reference(monkeypatch):
    """With pieces of 4 elements every tensor is walked piece by piece
    (in place through flat views, as a 4 GiB embedding is on the card):
    the same steps as the reference's, at the same tolerances."""
    monkeypatch.setattr(opt, "CHUNK_ELEMS", 4)
    assert len(list(opt._pieces(torch.zeros(3, 5)))) == 4
    _clip_and_adamw_against_reference()


def _clip_and_adamw_against_reference():
    rng = np.random.default_rng(0)
    shapes = [(3, 5), (7,), (2, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ocfg_kw = dict(peak_lr=1e-2, warmup_steps=0, total_steps=10, schedule="constant")
    rcfg, tcfg = ref_opt.OptimizerConfig(**ocfg_kw), opt.OptimizerConfig(**ocfg_kw)
    rp, rstate = list(map(jnp.asarray, params)), None
    tp = [torch.from_numpy(p.copy()) for p in params]
    rstate, tstate = ref_opt.adamw_init(rp), opt.adamw_init(tp)
    for _ in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) * 3 for s in shapes]
        rg, rnorm = ref_opt.clip_by_global_norm(list(map(jnp.asarray, grads)), 1.0)
        tg, tnorm = opt.clip_by_global_norm([torch.from_numpy(g) for g in grads], 1.0)
        assert float(tnorm) == pytest.approx(float(rnorm), rel=1e-6)
        for a, b in zip(tg, rg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        rp, rstate = ref_opt.adamw_update(rp, rg, rstate, rcfg, 1e-2)
        tp, tstate = opt.adamw_update(tp, tg, tstate, tcfg, 1e-2)
    for a, b in zip(tp, rp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    for a, b in zip(tstate["m"] + tstate["v"], list(rstate["m"]) + list(rstate["v"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    assert tstate["count"] == int(rstate["count"]) == 3


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_data_matches_reference(seed):
    ref = ref_data.SyntheticLMData(512, 3, 33, seed=seed)
    port = SyntheticLMData(512, 3, 33, seed=seed)
    for _ in range(3):
        a, b = port.next_batch(), ref.next_batch()
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# Train steps against the reference
# ---------------------------------------------------------------------------


def test_tied_params_convert_without_lm_head(ref_model):
    rcfg, rparams, proj = ref_model
    tcfg = get_config(ARCH, reduced=True)
    params = _port_params(rparams, tcfg, proj)
    assert "lm_head" not in rparams and "lm_head" not in params
    assert params["blocks"][0]["attn"]["wq"]["w"].dtype == torch.float32
    n_ref = sum(x.size for x in jax.tree_util.tree_leaves(rparams))
    assert sum(p.numel() for p in lm.trainable(params)) == n_ref
    init = lm.init_params(tcfg, device="cpu", dtype=torch.float32)
    assert "lm_head" not in init and init["embed"]["table"].dtype == torch.float32


@pytest.mark.parametrize("impl,grad_accum", [("pallas_distr", 1), ("pallas_flash", 1),
                                             ("pallas_distr", 2)])
def test_train_steps_match_reference(ref_model, impl, grad_accum):
    rcfg, rparams, proj = ref_model
    tcfg = _with_impl(get_config(ARCH, reduced=True), impl)
    rcfg = _with_impl(rcfg, impl)
    okw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=3, schedule="wsd",
               grad_accum=grad_accum)
    rstep = jax.jit(ref_make_train_step(rcfg, ref_opt.OptimizerConfig(**okw)))
    tstep = make_train_step(tcfg, opt.OptimizerConfig(**okw))
    tparams = _port_params(rparams, tcfg, proj)
    rstate, tstate = ref_opt.adamw_init(rparams), opt.adamw_init(lm.trainable(tparams))
    rng = np.random.default_rng(1)
    for step in range(3):
        rb, tb = _batch(rng, 2, 64, rcfg.vocab)
        rparams, rstate, rm = rstep(rparams, rstate, rb, jnp.asarray(step, jnp.int32))
        tparams, tstate, tm = tstep(tparams, tstate, tb, step)
        assert float(tm["skipped"]) == float(rm["skipped"]) == 0.0
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]), rel=TOL, abs=TOL)
        assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=TOL, abs=TOL)
        assert tm["lr"] == pytest.approx(float(rm["lr"]), rel=1e-6)
    want = _port_params(rparams, tcfg, proj)
    for got, ref in zip(lm.trainable(tparams), lm.trainable(want)):
        np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), atol=TOL, rtol=TOL)


def test_nan_guard_skips_update(ref_model):
    rcfg, rparams, proj = ref_model
    tcfg = get_config(ARCH, reduced=True)
    params = _port_params(rparams, tcfg, proj)
    params["final_norm"]["scale"].mul_(float("nan"))
    before = [p.clone() for p in lm.trainable(params)]
    state = opt.adamw_init(lm.trainable(params))
    step = make_train_step(tcfg, opt.OptimizerConfig(peak_lr=1e-2, warmup_steps=0,
                                                     total_steps=10))
    _, tb = _batch(np.random.default_rng(2), 2, 16, tcfg.vocab)
    params, state, metrics = step(params, state, tb, 0)
    assert float(metrics["skipped"]) == 1.0 and state["count"] == 0
    for a, b in zip(lm.trainable(params), before):
        assert torch.equal(a.detach(), b) or bool((a.isnan() & b.isnan()).any())
    assert all(not m.any() for m in state["m"])


def test_remat_gives_the_same_grads(ref_model):
    rcfg, rparams, proj = ref_model
    _, tb = _batch(np.random.default_rng(3), 2, 32, rcfg.vocab)
    grads = {}
    for remat in ("full", "none"):
        tcfg = _with_impl(get_config(ARCH, reduced=True), "pallas_distr").replace(remat=remat)
        params = _port_params(rparams, tcfg, proj)
        leaves = [p.requires_grad_(True) for p in lm.trainable(params)]
        loss, _ = lm.loss_fn(params, tcfg, tb)
        grads[remat] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads["full"], grads["none"]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_eval_step_matches_reference_loss(ref_model):
    rcfg, rparams, proj = ref_model
    tcfg = get_config(ARCH, reduced=True)
    rb, tb = _batch(np.random.default_rng(4), 2, 32, rcfg.vocab)
    want, wmetrics = ref_lm.loss_fn(rparams, rcfg, rb)
    got = make_eval_step(tcfg)(_port_params(rparams, tcfg, proj), tb)
    assert float(got["loss"]) == pytest.approx(float(want), rel=TOL, abs=TOL)
    assert float(got["zloss"]) == pytest.approx(float(wmetrics["zloss"]), rel=TOL, abs=TOL)


# ---------------------------------------------------------------------------
# Trainer and launcher
# ---------------------------------------------------------------------------


def test_trainer_loss_falls():
    cfg = get_config(ARCH, reduced=True)
    params = launch_train.init_train_params(cfg, seed=0, device="cpu")
    ocfg = opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=40)
    trainer = Trainer(cfg, ocfg, SyntheticLMData(cfg.vocab, 4, 32, seed=0), params)
    hist = trainer.run(20)
    assert [r["step"] for r in hist] == list(range(1, 21))
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert trainer.counters["nan_skips"] == 0
    assert all(np.isfinite(r["grad_norm"]) and r["sec"] > 0 for r in hist)


def test_launch_train_runs_on_cpu(capsys, tmp_path):
    out = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--impl",
                             "pallas_distr", "--steps", "3", "--batch", "2", "--seq", "32",
                             "--workdir", str(tmp_path)])
    assert len(out["history"]) == 3 and len(out["step_times"]) == 3
    assert out["tok_per_s"] > 0 and out["nan_skips"] == 0
    assert out["max_memory_allocated"] is None
    assert "[train] loss" in capsys.readouterr().out


def test_launch_train_defaults_checkpoint_resume_and_guard(tmp_path, monkeypatch):
    """With its default arguments the launcher checkpoints into its default
    workdir (a baseline at step 0 and a final save), resumes from it, and
    runs with the anomaly guard on: a loss spike past the detector's warmup
    is rolled back, as the reference's launcher does."""
    from repro_torch.faults import FaultInjector, FaultSpec
    from repro_torch.train import checkpoint as ckpt

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    workdir = launch_train.default_workdir(ARCH, reduced=True)
    assert workdir.startswith(str(tmp_path))
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16"]
    out = launch_train.main(argv)
    names = ckpt.list_checkpoint_names(os.path.join(workdir, "checkpoints"))
    assert names[0] == "step_00000000" and names[-1] == "step_00000003-final"
    trainer = out["trainer"]
    assert trainer.workdir == workdir and trainer.anomaly.enabled

    resumed = launch_train.main(argv)["trainer"]
    assert [r["step"] for r in resumed.history] == [4, 5, 6]
    warmup = resumed.anomaly.warmup
    resumed.faults = FaultInjector([FaultSpec("loss_spike", after=warmup)])
    resumed.run(warmup + 2)
    snap = resumed.counters_snapshot()
    assert snap["rollbacks"] == 1 and snap["anomaly_halts"] == 0 and snap["nan_skips"] == 0


def test_launch_train_defaults_keep_one_workdir_a_config(tmp_path, monkeypatch):
    """Two configs trained one after the other with the launcher's defaults
    each start from their own baseline in their own directory, under the
    temporary directory: the second never resumes the first's checkpoints."""
    from repro_torch.train import checkpoint as ckpt

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert launch_train.default_workdir(ARCH) != launch_train.default_workdir(ARCH, reduced=True)
    for arch in (ARCH, "mamba2-130m"):
        out = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                                 "--batch", "2", "--seq", "16"])
        workdir = launch_train.default_workdir(arch, reduced=True)
        assert out["trainer"].workdir == workdir and workdir.startswith(str(tmp_path))
        assert [r["step"] for r in out["history"]] == [1, 2]
        names = ckpt.list_checkpoint_names(os.path.join(workdir, "checkpoints"))
        assert names[0] == "step_00000000" and names[-1] == "step_00000002-final"
