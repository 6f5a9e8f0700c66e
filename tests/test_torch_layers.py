"""Port parity: the primitive layers (repro_torch.models.layers) and the
sampler (repro_torch.serve.sampler) against the JAX reference."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as rl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.serve.sampler import sample  # noqa: E402


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(tree):
    as_j = jax.tree_util.tree_map(jnp.asarray, tree)
    as_t = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    return as_j, as_t


def test_norms_match_reference():
    x = _x(0, (2, 5, 64))
    p = {"scale": _x(1, (64,)), "bias": _x(2, (64,))}
    (pj, pt), (xj, xt) = _both(p), _both(x)
    np.testing.assert_allclose(tl.layernorm_apply(pt, xt, 1e-6).numpy(),
                               np.asarray(rl.layernorm_apply(pj, xj, 1e-6)), atol=1e-5, rtol=1e-5)
    rms = {"scale": p["scale"]}
    (rj, rt) = _both(rms)
    np.testing.assert_allclose(tl.rmsnorm_apply(rt, xt, 1e-6).numpy(),
                               np.asarray(rl.rmsnorm_apply(rj, xj, 1e-6)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_pairs_interleaved_features(theta):
    x = _x(3, (2, 3, 7, 32))
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    want = rl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp_and_linear_match_reference(act):
    x = _x(4, (2, 3, 16))
    p = {"up": {"w": _x(5, (16, 32))}, "down": {"w": _x(6, (32, 16))}}
    if act == "silu":
        p["gate"] = {"w": _x(7, (16, 32))}
    (pj, pt), (xj, xt) = _both(p), _both(x)
    np.testing.assert_allclose(tl.mlp_apply(pt, xt, act=act).numpy(),
                               np.asarray(rl.mlp_apply(pj, xj, act=act)), atol=1e-4, rtol=1e-4)
    lin = {"w": _x(8, (16, 8)), "b": _x(9, (8,))}
    (lj, lt) = _both(lin)
    np.testing.assert_allclose(tl.linear_apply(lt, xt).numpy(),
                               np.asarray(rl.linear_apply(lj, xj)), atol=1e-5, rtol=1e-5)


def test_sampler_modes():
    logits = torch.tensor([[0.1, 2.0, -1.0, 0.5]])
    assert int(sample(logits)[0]) == 1  # greedy
    assert int(sample(logits, temperature=0.0, top_k=2, top_p=0.3)[0]) == 1
    g = torch.Generator().manual_seed(0)
    draws = {int(sample(logits, generator=g, temperature=1.0, top_k=2)[0]) for _ in range(50)}
    assert draws <= {1, 3} and len(draws) == 2
    draws = {int(sample(logits, generator=g, temperature=1.0, top_p=0.5)[0]) for _ in range(20)}
    assert draws == {1}  # the top token alone holds more than half the mass
    with pytest.raises(ValueError):
        sample(logits, temperature=1.0)
