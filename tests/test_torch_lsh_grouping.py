"""Port parity: LSH hashing and column grouping (repro_torch.core.lsh /
grouping) against the JAX reference on the same numpy inputs.  Hashes and
permutations must be exactly equal given the reference's projection."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import grouping as rg  # noqa: E402
from repro.core import lsh as rl  # noqa: E402
from repro_torch.core import grouping as tg  # noqa: E402
from repro_torch.core import lsh as tl  # noqa: E402


def _proj(block_len: int, seed: int = 0) -> np.ndarray:
    return np.array(rl.make_projection(jax.random.PRNGKey(seed), block_len))


def _data(seed, shape, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("method", ["sign_gray", "proj_morton"])
@pytest.mark.parametrize("shape,kind", [
    ((2, 3, 32, 64), "normal"),
    ((1, 4, 128, 128), "normal"),
    ((2, 2, 64, 32), "uniform"),
])
def test_hash_columns_exact(method, shape, kind):
    x = _data(0, shape, kind)
    proj = _proj(shape[-2])
    want = np.asarray(rl.hash_columns(jnp.asarray(x), jnp.asarray(proj), method))
    got = tl.hash_columns(torch.from_numpy(x), torch.from_numpy(proj), method).numpy()
    np.testing.assert_array_equal(got, want)


def test_inverse_gray_exact():
    codes = np.random.default_rng(1).integers(0, 2 ** 16, size=4096).astype(np.int32)
    want = np.asarray(rl.inverse_gray(jnp.asarray(codes)))
    got = tl.inverse_gray(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, want)


def test_permutation_from_hashes_is_stable_and_exact():
    # A narrow hash range forces many ties: only a stable sort agrees.
    hashes = np.random.default_rng(2).integers(0, 8, size=(6, 64)).astype(np.int32)
    want = np.asarray(rl.permutation_from_hashes(jnp.asarray(hashes)))
    got = tl.permutation_from_hashes(torch.from_numpy(hashes)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["sign_gray", "proj_morton"])
def test_lsh_permutation_exact(method):
    x = _data(3, (2, 4, 2, 64, 128))
    proj = _proj(64, seed=5)
    want = np.asarray(rl.lsh_permutation(jnp.asarray(x), jnp.asarray(proj), method))
    got = tl.lsh_permutation(torch.from_numpy(x), torch.from_numpy(proj), method).numpy()
    np.testing.assert_array_equal(got, want)


def test_make_projection_is_signed_and_seeded():
    a = tl.make_projection(torch.Generator().manual_seed(7), 128)
    b = tl.make_projection(torch.Generator().manual_seed(7), 128)
    assert a.shape == (tl.N_PRIME, 128) and a.dtype == torch.float32
    assert set(a.unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(a, b)


def _perm(seed, lead, d):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(d) for _ in range(int(np.prod(lead)))]).reshape(
        *lead, d).astype(np.int32)


@pytest.mark.parametrize("g", [2, 4])
def test_sample_and_fuse_columns(g):
    x = _data(4, (2, 3, 16, 32))
    perm = _perm(5, (2, 3), 32)
    for rfn, tfn in ((rg.sample_columns, tg.sample_columns),
                     (rg.fuse_columns, tg.fuse_columns),
                     (rg.mean_columns, tg.mean_columns)):
        want = np.asarray(rfn(jnp.asarray(x), jnp.asarray(perm), g))
        got = tfn(torch.from_numpy(x), torch.from_numpy(perm), g).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_fuse_columns_broadcasts_like_the_reference():
    # K (b, hkv, 1, n, d) fused under per-query-head perms (b, hkv, r, d).
    k = _data(6, (2, 2, 1, 24, 32))
    perm = _perm(7, (2, 2, 3), 32)
    want = np.asarray(rg.fuse_columns(jnp.asarray(k), jnp.asarray(perm), 2))
    got = tg.fuse_columns(torch.from_numpy(k), torch.from_numpy(perm), 2).numpy()
    assert got.shape == want.shape == (2, 2, 3, 24, 16)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("g", [2, 4])
def test_sample_q_heads(g):
    q = _data(8, (2, 8, 3, 64))
    perm = _perm(9, (2,), 64)
    want = np.asarray(rg.sample_q_heads(jnp.asarray(q), jnp.asarray(perm), g))
    got = tg.sample_q_heads(torch.from_numpy(q), torch.from_numpy(perm), g).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
