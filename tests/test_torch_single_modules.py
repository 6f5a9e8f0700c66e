"""Port parity on the single modules that need no mesh: ``kernels/ref.py``'s
four oracles, ``utils/tree.py`` over converted params, the configs'
``supports_shape`` / ``skip_reason``, ``serve/kv_cache.py::cache_struct``,
all against the reference's own functions on the same numpy inputs, and
the ``examples_torch/`` scripts run on the CPU."""
import re
import runpy
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import load_reduced_models  # noqa: E402
from repro.configs import ARCH_NAMES as REF_ARCH_NAMES  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import lsh as rl  # noqa: E402
from repro.core.distr_attention import DistrConfig as RefDistrConfig  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.serve import kv_cache as rkv  # noqa: E402
from repro.utils import tree as rtree  # noqa: E402
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config  # noqa: E402
from repro_torch.core.distr_attention import DistrConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402
from repro_torch.utils import tree  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# kernels/ref.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_ref_matches_reference(causal):
    rng = np.random.default_rng(0)
    q, k, v = _randn(rng, 1, 4, 64, 32), _randn(rng, 1, 2, 64, 32), _randn(rng, 1, 2, 64, 32)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal, scale=0.3)
    _close(got, rref.flash_attention_ref(q, k, v, causal=causal, scale=0.3), 1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("group_size", [2, 4])
def test_distr_attention_ref_matches_reference(causal, group_size):
    """The reference's projection passed in (it is drawn from JAX
    randomness)."""
    rng = np.random.default_rng(1)
    q, k, v = _randn(rng, 1, 4, 80, 32), _randn(rng, 1, 2, 80, 32), _randn(rng, 1, 2, 80, 32)
    rcfg = RefDistrConfig(group_size=group_size, block_q=32)
    proj = torch.from_numpy(np.array(rl.make_projection(jax.random.PRNGKey(rcfg.proj_seed), 32)))
    got = ref.distr_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                  DistrConfig(group_size=group_size, block_q=32), causal=causal,
                                  proj=proj)
    _close(got, rref.distr_attention_ref(q, k, v, rcfg, causal=causal), 1e-5)


@pytest.mark.parametrize("lengths", [None, (17, 40)])
def test_decode_attention_ref_matches_reference(lengths):
    rng = np.random.default_rng(2)
    q, k, v = _randn(rng, 2, 4, 1, 32), _randn(rng, 2, 2, 40, 32), _randn(rng, 2, 2, 40, 32)
    lt = None if lengths is None else torch.tensor(lengths)
    lj = None if lengths is None else jnp.asarray(lengths)
    got = ref.decode_attention_ref(*map(torch.from_numpy, (q, k, v)), lt)
    _close(got, rref.decode_attention_ref(q, k, v, lj), 1e-5)


@pytest.mark.parametrize("n,chunk", [(64, 16), (50, 16), (37, 64)])
def test_ssd_ref_matches_reference(n, chunk):
    """The chunked plain version against the reference's sequential scan
    (f32; summation orders differ)."""
    rng = np.random.default_rng(3)
    x = _randn(rng, 2, n, 4, 8)
    a = -np.abs(_randn(rng, 2, n, 4)) * 0.3
    b, c = _randn(rng, 2, n, 2, 8), _randn(rng, 2, n, 2, 8)
    got = ref.ssd_ref(*map(torch.from_numpy, (x, a, b, c)), chunk=chunk)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, rref.ssd_ref(x, a, b, c, chunk=chunk), 1e-4)


# ---------------------------------------------------------------------------
# utils/tree.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reduced_params():
    rcfg, rparams, tcfg, tparams = load_reduced_models("minicpm-2b", draw_qkv_bias=False)
    # The port's tree also holds the LSH projection, which the reference
    # draws from its seed where it is used.
    tparams = {k: v for k, v in tparams.items() if k != "lsh_proj"}
    return rparams, tparams


def test_tree_count_bytes_and_cast_match_reference(reduced_params):
    rparams, tparams = reduced_params
    assert tree.tree_count(tparams) == rtree.tree_count(rparams)
    assert tree.tree_bytes(tparams) == rtree.tree_bytes(rparams)
    cast = tree.tree_cast(tparams, torch.bfloat16)
    assert tree.tree_bytes(cast) == rtree.tree_bytes(rtree.tree_cast(rparams, jnp.bfloat16))
    assert {x.dtype for x in tree.tree_leaves(cast)} == {torch.bfloat16}
    ints = {"ids": torch.arange(4), "w": torch.ones(2)}
    assert tree.tree_cast(ints, torch.bfloat16)["ids"].dtype == torch.int64


def test_tree_arithmetic_and_norm_match_reference(reduced_params):
    rparams, tparams = reduced_params
    want = float(rtree.tree_norm(rparams))
    np.testing.assert_allclose(float(tree.tree_norm(tparams)), want, rtol=1e-5)
    doubled = tree.tree_add(tparams, tree.tree_scale(tparams, 1.0))
    np.testing.assert_allclose(float(tree.tree_norm(doubled)),
                               float(rtree.tree_norm(rtree.tree_add(rparams, rparams))),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tree.tree_norm(tree.tree_scale(tparams, -0.5))),
                               float(rtree.tree_norm(rtree.tree_scale(rparams, -0.5))),
                               rtol=1e-5)
    zeros = tree.tree_zeros_like(tparams)
    assert float(tree.tree_norm(zeros)) == 0.0
    assert tree.tree_count(zeros) == tree.tree_count(tparams)
    assert float(tree.tree_norm({})) == 0.0


# ---------------------------------------------------------------------------
# configs: shape applicability
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_supports_shape_and_skip_reason_match_reference(arch):
    """Every registered config over every named shape: long_500k only for
    the ssm and hybrid families, and the reason word for word."""
    assert tuple(ARCH_NAMES) == tuple(REF_ARCH_NAMES)
    assert list(SHAPES) == list(REF_SHAPES)
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name in SHAPES:
        assert cfg.supports_shape(SHAPES[name]) == rcfg.supports_shape(REF_SHAPES[name])
        assert cfg.skip_reason(SHAPES[name]) == rcfg.skip_reason(REF_SHAPES[name])
    assert cfg.supports_shape(SHAPES["long_500k"]) == (cfg.family in ("ssm", "hybrid"))


# ---------------------------------------------------------------------------
# serve/kv_cache.py::cache_struct
# ---------------------------------------------------------------------------


def _struct_variants(arch):
    cfg, rcfg = get_config(arch, reduced=True), ref_get_config(arch, reduced=True)
    out = [(cfg, rcfg)]
    if cfg.family == "dense":
        out.append((cfg.replace(attention=replace(cfg.attention, distr_decode=True)),
                    rcfg.replace(attention=replace(rcfg.attention, distr_decode=True))))
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_struct_matches_reference_and_init_cache(arch):
    """Each family's cache tree (and the dense fused-K̂ one) as meta tensors:
    the reference's ``cache_struct`` shapes and dtypes, and those of the
    port's ``init_cache``, without an allocation."""
    for cfg, rcfg in _struct_variants(arch):
        for dtype, rdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            got = kv_cache.cache_struct(cfg, 3, 48, dtype)
            want = rkv.cache_struct(rcfg, 3, 48, rdtype)
            assert set(got) == set(want)
            for name, spec in want.items():
                assert got[name].device.type == "meta"
                assert tuple(got[name].shape) == tuple(spec.shape), name
                assert str(got[name].dtype).removeprefix("torch.") == str(spec.dtype), name
            zeros = kv_cache.init_cache(cfg, 3, 48, dtype, device="cpu")
            assert {k: (tuple(t.shape), t.dtype) for k, t in zeros.items()} == {
                k: (tuple(t.shape), t.dtype) for k, t in got.items()}
            assert all(int(t.count_nonzero()) == 0 for t in zeros.values())


# ---------------------------------------------------------------------------
# examples_torch/
# ---------------------------------------------------------------------------

# The reference examples' print formats (examples/*.py), a float a ``F``.
F = r"-?\d+\.\d+"
EXAMPLES = {
    "quickstart": ([r"G\*=2: score-dim 64→32, output rel err " + F,
                    r"G\*=4: score-dim 64→16, output rel err " + F,
                    r"pallas kernel output: \(2, 8, 512, 64\) float32 finite: True"], []),
    "attention_showcase": ([r"method\s+rel_err\s+cosine\s+ms"]
                           + [rf"{re.escape(m)}\s+{F}\s+{F}\s+{F}" for m in (
                               "exact_flash(xla)", "distr_g2(xla)", "distr_g2(pallas)",
                               "hydra", "flatten", "primal_lowrank", "hyper_sampled")], []),
    "serve_lm": ([rf"served 10 requests / \d+ tokens in {F}s \({F} tok/s, 4 slots, "
                  r"continuous batching\)"]
                 + [r"  req +\d+ prompt_len=[ \d]\d → \[[\d, ]+\]"] * 5, []),
    "train_lm": ([r"", rf"done: loss {F} → {F} \(12 steps, attention=distr\); checkpoints in "
                  r".+/checkpoints"], ["--steps", "12", "--batch", "2", "--seq", "32"]),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name, capsys, monkeypatch, tmp_path):
    """Each ``examples_torch/`` script with ``--device cpu`` prints the lines
    its reference counterpart prints (the train driver's per-step log
    aside)."""
    patterns, extra = EXAMPLES[name]
    argv = ["--device", "cpu", *extra]
    if name == "train_lm":
        argv += ["--workdir", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(str(ROOT / "examples_torch" / f"{name}.py"), run_name="__main__")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if not ln.startswith("[trainer]")]
    assert len(lines) == len(patterns), lines
    for line, pattern in zip(lines, patterns):
        assert re.fullmatch(pattern, line), (pattern, line)
