"""Port parity on SSM training: ``ops.ssd``'s gradient (the ``_SSD``
autograd Function: the SSD kernel's plain version forward, the chunked
``models/mamba.py::ssd_chunked`` recomputed for the backward) against
``jax.grad`` through the reference's ``ssd_xla`` and ``mamba_apply``, and
three train steps of mamba2-130m and zamba2-7b ``reduced()`` from the
reference's ``lm.init_params(PRNGKey(0))`` weights against the reference's
``make_train_step``.  f32; inputs are numpy arrays from a seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import lsh as ref_lsh  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.train_step import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd as ssd_kernels  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mamba as port_mamba  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from _torch_helpers import one_intra_op_thread  # noqa: E402,F401

TOL = 1e-4
LOSS_TOL = 1e-5


def _ssd_inputs(b, n, h, p, g, s, *, seed, decay=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, h, p)).astype(np.float32)
    a = (-decay * np.logaddexp(rng.standard_normal((b, n, h)), 0)).astype(np.float32)
    bm = rng.standard_normal((b, n, g, s)).astype(np.float32)
    c = rng.standard_normal((b, n, g, s)).astype(np.float32)
    return x, a, bm, c


# ---------------------------------------------------------------------------
# The op and the block
# ---------------------------------------------------------------------------


# (b, n, h, p, g, s, chunk), return_state: a whole number of chunks with y
# alone; a ragged tail and two heads a group with the state's gradient too.
SSD_GRAD_CASES = [pytest.param((1, 64, 2, 16, 1, 8, 32), False, id="whole-y"),
                  pytest.param((2, 70, 4, 16, 2, 8, 32), True, id="ragged-y_and_state")]


@pytest.mark.parametrize("case,return_state", SSD_GRAD_CASES)
def test_ssd_grads_match_jax_grad_of_ssd_xla(case, return_state):
    b, n, h, p, g, s, chunk = case
    arrays = _ssd_inputs(b, n, h, p, g, s, seed=11)
    rng = np.random.default_rng(12)
    wy = rng.standard_normal((b, n, h, p)).astype(np.float32)
    ws = rng.standard_normal((b, h, s, p)).astype(np.float32)

    def ref_obj(*args):
        out = ref_mamba.ssd_xla(*args, chunk=chunk, return_state=return_state)
        if not return_state:
            return jnp.sum(out * wy)
        return jnp.sum(out[0] * wy) + jnp.sum(out[1] * ws)

    want = jax.jit(jax.grad(ref_obj, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, arrays))
    ts = [torch.from_numpy(t.copy()).requires_grad_(True) for t in arrays]
    before = ssd_kernels.launches
    out = ops.ssd(*ts, chunk=chunk, return_state=return_state)
    obj = ((out[0] * torch.from_numpy(wy)).sum() + (out[1] * torch.from_numpy(ws)).sum()
           if return_state else (out * torch.from_numpy(wy)).sum())
    obj.backward()
    assert ssd_kernels.launches == before  # CPU tensors: the plain version, uncounted
    for name, t, w in zip("xabc", ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=f"d{name}")


def test_ssd_chunked_matches_ssd_xla_and_the_plain_version():
    b, n, h, p, g, s, chunk = 2, 70, 4, 16, 2, 8, 32
    arrays = _ssd_inputs(b, n, h, p, g, s, seed=13)
    want_y, want_state = ref_mamba.ssd_xla(*map(jnp.asarray, arrays), chunk=chunk,
                                           return_state=True)
    x, a, bm, c = map(torch.from_numpy, arrays)
    y, state = port_mamba.ssd_chunked(x, a, bm, c, chunk=chunk, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), atol=TOL, rtol=TOL)
    plain = ssd_kernels.ssd_plain(
        x.transpose(1, 2).reshape(b * h, n, p), a.transpose(1, 2).reshape(b * h, n),
        bm.transpose(1, 2).reshape(b * g, n, s), c.transpose(1, 2).reshape(b * g, n, s),
        heads_per_group=h // g, chunk=chunk)
    np.testing.assert_allclose(y.transpose(1, 2).reshape(b * h, n, p).numpy(), plain.numpy(),
                               atol=TOL, rtol=TOL)


def test_ssd_grads_stay_finite_under_strong_decay():
    """Decays whose cumulative sums overflow exp() above the diagonal: the
    op's backward and autograd through the plain version (the card's
    yardstick for that backward) select the exponent away before the exp,
    so no 0 · inf, and agree."""
    b, n, h, p, g, s, chunk = 1, 64, 2, 8, 1, 8, 32
    arrays = _ssd_inputs(b, n, h, p, g, s, seed=14, decay=400.0)
    grads = []
    for fn in (lambda *t: ops.ssd(*t, chunk=chunk),
               lambda x, a, bm, c: ssd_kernels.ssd_plain(
                   x[0].transpose(0, 1), a[0].transpose(0, 1), bm[0].transpose(0, 1),
                   c[0].transpose(0, 1), heads_per_group=h // g, chunk=chunk
               ).transpose(0, 1)[None]):
        ts = [torch.from_numpy(t.copy()).requires_grad_(True) for t in arrays]
        y = fn(*ts)
        y.square().sum().backward()
        assert torch.isfinite(y).all()
        assert all(torch.isfinite(t.grad).all() for t in ts)
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n", [64, 45], ids=["whole", "ragged"])
def test_mamba_block_grads_match_reference(ssm_models, n):
    """Gradients of the mamba2-130m ``reduced()`` block, its input and every
    parameter, through ``ops.ssd``'s Function, against ``jax.grad`` through
    the reference's ``mamba_apply`` (``ssd_xla``).  The gradients reach
    ~200 and sum over the tokens, so an element that cancels keeps an f32
    rounding of ~1e-6 of its tensor's largest element: the allowance is
    1e-4 of that scale (at least 1e-4) plus 1e-4 of the element."""
    rcfg, rparams, tcfg, proj = ssm_models("mamba2-130m")
    rp = jax.tree_util.tree_map(lambda t: t[0], rparams["blocks"]["mixer"])
    tp = _port(rparams, tcfg, proj)["blocks"][0]["mixer"]
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, n, tcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, n, tcfg.d_model)).astype(np.float32)

    def ref_obj(p, xx):
        return jnp.sum(ref_mamba.mamba_apply(p, xx, rcfg) * w)

    g_params, g_x = jax.jit(jax.grad(ref_obj, argnums=(0, 1)))(rp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: t.requires_grad_(True) for k, t in _flat(tp).items()}
    obj = (port_mamba.mamba_apply(tp, xt, tcfg) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(obj, [xt, *leaves.values()])
    want = {"x": g_x, **_flat(g_params)}
    assert set(want) == {"x", *leaves}
    for key, got in zip(["x", *leaves], grads):
        ref = np.asarray(want[key])
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL,
                                   atol=TOL * max(1.0, float(np.abs(ref).max())), err_msg=key)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ssm_models():
    """arch → the reference's reduced() config, weights and LSH projection,
    and the port's config; built on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg = ref_get_config(arch, reduced=True)
            rparams = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
            dcfg = rcfg.attention.distr
            proj = np.array(ref_lsh.make_projection(jax.random.PRNGKey(dcfg.proj_seed),
                                                    dcfg.block_q))
            cache[arch] = (rcfg, rparams, get_config(arch, reduced=True), proj)
        return cache[arch]

    return get


def _port(rparams, tcfg, proj):
    """A fresh port copy of reference weights in the training dtype (f32)."""
    return from_jax_params(jax.tree_util.tree_map(np.asarray, rparams), tcfg, proj=proj,
                           device="cpu", dtype=lm.param_dtype(tcfg))


def _batch(rng, b, n, vocab):
    toks = rng.integers(0, vocab, (b, n + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long()})


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_train_steps_match_reference(ssm_models, arch):
    """Three steps (a ragged last chunk: 40 tokens over chunks of 32) under
    full remat: losses within 1e-5, grad norms and every parameter after
    the steps within 1e-4."""
    rcfg, rparams, tcfg, proj = ssm_models(arch)
    okw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=3)
    rstep = jax.jit(ref_make_train_step(rcfg, ref_opt.OptimizerConfig(**okw)))
    tstep = make_train_step(tcfg, opt.OptimizerConfig(**okw))
    tparams = _port(rparams, tcfg, proj)
    rstate, tstate = ref_opt.adamw_init(rparams), opt.adamw_init(lm.trainable(tparams))
    rng = np.random.default_rng(16)
    for step in range(3):
        rb, tb = _batch(rng, 2, 40, rcfg.vocab)
        rparams, rstate, rm = rstep(rparams, rstate, rb, jnp.asarray(step, jnp.int32))
        tparams, tstate, tm = tstep(tparams, tstate, tb, step)
        assert float(tm["skipped"]) == float(rm["skipped"]) == 0.0
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]), rel=LOSS_TOL,
                                                  abs=LOSS_TOL)
        assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=TOL, abs=TOL)
    for got, ref in zip(lm.trainable(tparams), lm.trainable(_port(rparams, tcfg, proj))):
        np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), atol=TOL, rtol=TOL)


def test_remat_recomputes_the_ssd_and_keeps_the_grads(ssm_models):
    """Full remat checkpoints every Mamba layer (as the reference's
    ``_remat`` does): the same grads as without it."""
    _, rparams, tcfg, proj = ssm_models("zamba2-7b")
    _, tb = _batch(np.random.default_rng(17), 2, 40, tcfg.vocab)
    grads = {}
    for remat in ("full", "none"):
        cfg = tcfg.replace(remat=remat)
        params = _port(rparams, cfg, proj)
        leaves = [p.requires_grad_(True) for p in lm.trainable(params)]
        loss, _ = lm.loss_fn(params, cfg, tb)
        grads[remat] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads["full"], grads["none"]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_launch_train_runs_the_ssm_families_on_cpu(arch, tmp_path):
    out = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                             "--batch", "2", "--seq", "40", "--workdir", str(tmp_path)])
    hist = out["history"]
    assert [r["step"] for r in hist] == [1, 2, 3] and out["nan_skips"] == 0
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in hist)
