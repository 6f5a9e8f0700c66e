"""Port parity of the error-study functions and the approximate baselines:
``grouping.reduce_qk`` and ``distr_scores`` (the paper's Ŝ, Tables 3-4)
against the reference at its own test tolerance, 1e-4, under both
estimators, MHA and GQA, with a ragged N and the reference's LSH projection
passed in; and the four baselines of ``core/baselines.py`` against the
reference's, causal and not, in f32 at 1e-5, the random ones fed the
reference's ``jax.random`` draws.  Inputs are numpy arrays from a seed."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as ref_baselines  # noqa: E402
from repro.core import grouping as ref_grouping  # noqa: E402
from repro.core import lsh as ref_lsh  # noqa: E402
from repro.core.distr_attention import DistrConfig as RefDistrConfig  # noqa: E402
from repro.core.distr_attention import distr_scores as ref_distr_scores  # noqa: E402
from repro_torch.core import baselines, distr_scores, grouping  # noqa: E402
from repro_torch.core.distr_attention import DistrConfig  # noqa: E402
from _torch_helpers import one_intra_op_thread  # noqa: E402,F401

TOL = 1e-4
BASELINE_TOL = 1e-5


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _proj(block_q, seed=0):
    return np.array(ref_lsh.make_projection(jax.random.PRNGKey(seed), block_q))


@pytest.mark.parametrize("estimator", ["sample", "mean"])
@pytest.mark.parametrize("g", [2, 4])
def test_reduce_qk_matches_reference(estimator, g):
    d = 32
    q, k = _normal(0, 2, 3, 16, d), _normal(1, 2, 3, 24, d)
    perm = np.stack([np.random.default_rng(i).permutation(d) for i in range(6)]).reshape(2, 3, d)
    want = ref_grouping.reduce_qk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(perm), g,
                                  estimator)
    got = grouping.reduce_qk(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(perm), g, estimator)
    for t, w in zip(got, want):
        assert t.shape == w.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="estimator"):
        grouping.reduce_qk(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(perm),
                           g, "median")


# (b, h, hkv, n, d, block_q, G*): MHA, GQA, a ragged N (50 = 3·16 + 2), MQA.
SCORE_CASES = [(1, 2, 2, 64, 64, 16, 2), (2, 4, 2, 48, 32, 16, 4),
               (1, 2, 2, 50, 64, 16, 2), (1, 4, 1, 40, 32, 8, 8)]


@pytest.mark.parametrize("estimator", ["sample", "mean"])
@pytest.mark.parametrize("case", SCORE_CASES, ids=["mha", "gqa", "ragged", "mqa"])
def test_distr_scores_matches_reference(case, estimator):
    """The reference's Ŝ takes K at the query heads: under GQA it is fed K
    repeated over the group, the port the KV heads themselves."""
    b, h, hkv, n, d, block_q, g = case
    q, k = _normal(2, b, h, n, d), _normal(3, b, hkv, n, d)
    proj = _proj(block_q)
    rcfg = RefDistrConfig(group_size=g, block_q=block_q, block_k=block_q, estimator=estimator)
    want = ref_distr_scores(jnp.asarray(q), jnp.repeat(jnp.asarray(k), h // hkv, axis=1), rcfg,
                            scale=0.5, proj=jnp.asarray(proj))
    cfg = DistrConfig(group_size=g, block_q=block_q, estimator=estimator)
    got = distr_scores(torch.from_numpy(q), torch.from_numpy(k), cfg, scale=0.5,
                       proj=torch.from_numpy(proj))
    assert got.shape == want.shape == (b, h, n, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_distr_scores_exact_at_g1_and_error_grows_with_sampling_rate():
    """G* = 1 is a permutation of the columns: Ŝ = S.  On Gaussian data the
    mean |Ŝ − S| grows with G* (the reference's test and the paper's
    Table 4)."""
    q, k = torch.from_numpy(_normal(4, 1, 1, 64, 64)), torch.from_numpy(_normal(5, 1, 1, 64, 64))
    s = q @ k.transpose(-1, -2)
    errs = [float((distr_scores(q, k, DistrConfig(group_size=g, block_q=16)) - s).abs().mean())
            for g in (1, 2, 4, 8)]
    assert errs[0] < 1e-5 and errs[1] < errs[2] < errs[3]


def test_distr_scores_default_projection_is_seeded():
    q, k = torch.from_numpy(_normal(6, 1, 2, 32, 32)), torch.from_numpy(_normal(7, 1, 2, 32, 32))
    cfg = DistrConfig(group_size=2, block_q=16)
    a, b = distr_scores(q, k, cfg), distr_scores(q, k, cfg)
    assert torch.equal(a, b) and torch.isfinite(a).all()


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------


def _qkv(hq, hkv, n=48, d=16, b=2):
    return _normal(8, b, hq, n, d), _normal(9, b, hkv, n, d), _normal(10, b, hkv, n, d)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("name", sorted(ref_baselines.BASELINES))
def test_baseline_matches_reference(name, heads, causal):
    q, k, v = _qkv(*heads)
    n = q.shape[2]
    kw, tkw = {}, {}
    if name == "primal_lowrank":
        kw = dict(rank=16)
        draw = jax.random.normal(jax.random.PRNGKey(0), (n, 16)) / (n / 16) ** 0.5
        tkw = dict(rank=16, proj=torch.from_numpy(np.array(draw)))
    elif name == "hyper_sampled":
        kw = dict(keep=20)
        draw = jax.random.choice(jax.random.PRNGKey(0), n, (20,), replace=False)
        tkw = dict(keep=20, idx=torch.from_numpy(np.array(draw)))
    want = ref_baselines.BASELINES[name](jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=causal, **kw)
    got = baselines.BASELINES[name](torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal, **tkw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BASELINE_TOL,
                               rtol=BASELINE_TOL)


@pytest.mark.parametrize("name", ["primal_lowrank", "hyper_sampled"])
def test_random_baselines_draw_from_their_generator(name):
    q, k, v = (torch.from_numpy(t) for t in _qkv(2, 2))
    size = {"primal_lowrank": dict(rank=16), "hyper_sampled": dict(keep=20)}[name]
    fn = functools.partial(baselines.BASELINES[name], **size)
    a = fn(q, k, v, generator=torch.Generator().manual_seed(3))
    b = fn(q, k, v, generator=torch.Generator().manual_seed(3))
    c = fn(q, k, v, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(fn(q, k, v), fn(q, k, v))
