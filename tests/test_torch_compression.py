"""Port parity of int8 error-feedback compression (``train/compression.py``):
``compress``, ``decompress`` and ``ef_step`` bit for bit against the
reference's on seeded numpy inputs (rounding half to even in both), ties
included; the error-feedback contract; ``init_residuals``.  The mean over
a mesh axis (``ef_pmean``) runs in ``tests/test_torch_collectives.py``'s
world."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.train import compression as ref  # noqa: E402
from repro_torch.train import compression as port  # noqa: E402

CASES = [((128,), 3.0, "f32", 0), ((64, 33), 1e-3, "f32", 1), ((7, 5, 3), 50.0, "f32", 2),
         ((256,), 1.0, "bf16", 3), ((1,), 0.0, "f32", 4), ((4, 4), 1.0, "ties", 5)]


def _draw(shape, scale, kind, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    if kind == "ties":
        # amax 127 → scale 1: every x.5 is a tie, which both round to even.
        g = np.array([127.0, -0.5, 0.5, 1.5, 2.5, -2.5, 3.5, 126.5, -126.5, 4.0, 0.0, -1.5,
                      5.5, 6.5, -7.5, 8.5], np.float32).reshape(shape)
    return g


def _pair(g, kind):
    if kind == "bf16":
        return jnp.asarray(g, jnp.bfloat16), torch.from_numpy(g).to(torch.bfloat16)
    return jnp.asarray(g), torch.from_numpy(g)


@pytest.mark.parametrize("shape,scale,kind,seed", CASES)
def test_compress_is_bit_equal_to_the_reference(shape, scale, kind, seed):
    g = _draw(shape, scale, kind, seed)
    rg, tg = _pair(g, kind)
    rq, rs = ref.compress(rg)
    q, s = port.compress(tg)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(port.decompress(q, s).numpy(),
                                  np.asarray(ref.decompress(rq, rs)))


@pytest.mark.parametrize("shape,scale,kind,seed", CASES)
def test_ef_step_is_bit_equal_to_the_reference(shape, scale, kind, seed):
    g = _draw(shape, scale, kind, seed)
    r = (np.random.default_rng(seed + 100).standard_normal(shape) * 0.1).astype(np.float32)
    rg, tg = _pair(g, kind)
    (rq, rs), rnew = ref.ef_step(rg, jnp.asarray(r))
    (q, s), new = port.ef_step(tg, torch.from_numpy(r))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(new.numpy(), np.asarray(rnew))
    # Nothing is lost: the payload plus the new residual is g + the old one.
    np.testing.assert_allclose((port.decompress(q, s) + new).numpy(),
                               tg.float().numpy() + r, rtol=1e-5, atol=1e-6)


def test_ef_sgd_converges_like_exact():
    """EF-compressed SGD on a quadratic tracks exact SGD (the reference's
    contract test)."""
    w = torch.tensor([4.0, -2.0, 1.0])
    residual = torch.zeros(3)
    for _ in range(300):
        (q, s), residual = port.ef_step(2 * w, residual)
        w = w - 0.05 * port.decompress(q, s)
    assert float(w.abs().max()) < 5e-2


def test_init_residuals_structure():
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "b": {"c": torch.ones(2, 2)},
              "l": [torch.ones(4)]}
    res = port.init_residuals(params)
    assert res["a"].dtype == torch.float32 and res["b"]["c"].shape == (2, 2)
    assert res["l"][0].shape == (4,) and float(res["l"][0].abs().sum()) == 0.0
