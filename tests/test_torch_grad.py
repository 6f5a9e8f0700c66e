"""Port parity on the training path's attention: the backward kernels' plain
versions (``repro_torch.kernels.backward``) against the reference's Pallas
backward kernels in interpret mode, and gradients through
``repro_torch.kernels.ops`` against ``jax.grad`` of the reference ops, on
the same numpy inputs.  Tolerances are the reference's own
(tests/test_kernels_grad.py): 1e-4 in f32, 1e-2 in bf16."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DistrConfig as RefDistrConfig  # noqa: E402
from repro.core import lsh as rl  # noqa: E402
from repro.kernels import backward as rbwd  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core.distr_attention import DistrConfig  # noqa: E402
from repro_torch.kernels import backward as bwd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.distr_attention import distr_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402

BLOCK = 32
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-4, "bf16": 1e-2}


def _randn(rng, *shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# The plain versions against the reference kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,dtype,tol", [
    (32, "f32", 1e-5),
    # The head dims whose lanes a row the card's kernel sets apart (8 at
    # d <= 64, 16 at 112 and 128, two of them dead at 112).
    (64, "f32", 1e-5), (112, "f32", 1e-5), (128, "f32", 1e-5),
    # bf16 in, f32 out on both sides (the reference kernel in interpret mode).
    (64, "bf16", 1e-4),
])
def test_delta_matches_reference(d, dtype, tol):
    rng = np.random.default_rng(0)
    o, do = _randn(rng, 4, 64, d), _randn(rng, 4, 64, d)
    jdt, tdt = DTYPES[dtype]
    want = rbwd.delta_kernel_call(jnp.asarray(o, jdt), jnp.asarray(do, jdt), block_q=BLOCK)
    got = bwd.delta_kernel_call(_t(o).to(tdt), _t(do).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (4, 64)
    _close(got, want, tol)


@pytest.mark.parametrize("causal,kv_len", [(True, 64), (False, 50)])
def test_flash_backward_plain_matches_reference(causal, kv_len):
    rng = np.random.default_rng(1)
    q, k, v, do = (_randn(rng, 4, 64, 32), _randn(rng, 2, 64, 32), _randn(rng, 2, 64, 32),
                   _randn(rng, 4, 64, 32))
    kw = dict(q_per_kv=2, scale=32 ** -0.5, causal=causal, kv_len=kv_len)
    o, lse = flash_attention_plain(_t(q), _t(k), _t(v), return_lse=True, **kw)
    delta = bwd.delta_plain(o, _t(do))
    args_t = (_t(q), _t(k), _t(v), _t(do), lse, delta)
    args_j = tuple(jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
                   for x in (q, k, v, do, lse, delta))
    rkw = dict(kw, block_q=BLOCK, block_k=BLOCK)
    _close(bwd.flash_dq_kernel_call(*args_t, **kw), rbwd.flash_dq_kernel_call(*args_j, **rkw),
           1e-4, "dq")
    for got, want, name in zip(bwd.flash_dkv_kernel_call(*args_t, **kw),
                               rbwd.flash_dkv_kernel_call(*args_j, **rkw), "kv"):
        _close(got, want, 1e-4, f"d{name}")


def _split_bf16(x: torch.Tensor):
    """x ≈ hi + lo with hi = bf16(x) and lo = bf16(x − hi), as f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _bf16_only(x: torch.Tensor):
    return (x.to(torch.bfloat16).float(),)


def test_flash_backward_split_operands_hold_1e4():
    """The arithmetic of the bf16 tensor-core backward kernels
    (``csrc/flash_bwd_tc.cuh``), emulated on the CPU: the products that take
    P or dS get each as bf16 hi + lo parts, each part's product summed into
    one f32 accumulator, while S, dP and the other operands are exact
    (bf16 inputs).  dQ, dK and dV then stay within the 1e-4 the card holds
    the kernels to against ``flash_dq_plain`` / ``flash_dkv_plain``.
    Rounding P and dS to bf16 alone (FA-2's choice) is logged, not
    asserted: it is the reason for the split."""
    rng = np.random.default_rng(7)
    hq, hkv, n, d = 4, 2, 256, 64
    q, k, v, do = (_t(_randn(rng, h, n, d)).to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    scale = d ** -0.5
    kw = dict(q_per_kv=hq // hkv, scale=scale, causal=True, kv_len=n)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = bwd.delta_plain(o, do)
    want = (bwd.flash_dq_plain(q, k, v, do, lse, delta, **kw),
            *bwd.flash_dkv_plain(q, k, v, do, lse, delta, **kw))
    qg, dog, kf, p, ds = bwd._flash_p_and_ds(q, k, v, do, lse, delta, hq // hkv, scale, True, n)

    def grads(split):
        dq = sum(torch.einsum("grnm,gmd->grnd", part, kf) for part in split(ds)) * scale
        dv = sum(torch.einsum("grnm,grnd->grmd", part, dog) for part in split(p))
        dk = sum(torch.einsum("grnm,grnd->grmd", part, qg) for part in split(ds)) * scale
        return tuple(x.reshape(hq, n, d) for x in (dq, dk, dv))

    tol = 1e-4
    shares = {}
    for name, split in (("hi + lo", _split_bf16), ("bf16 only", _bf16_only)):
        shares[name] = [float(((g_ - w_).abs() / (tol + tol * w_.abs())).max())
                        for g_, w_ in zip(grads(split), want)]
    print(f"largest error as a share of the 1e-4 allowance (dq, dk, dv): {shares}")
    for g_, w_, what in zip(grads(_split_bf16), want, ("dq", "dk", "dv")):
        torch.testing.assert_close(g_, w_, atol=tol, rtol=tol, msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("causal", [True, False])
def test_distr_backward_plain_matches_reference(causal):
    """The dkv plain version keeps the reference's inverse-permutation
    gather; the reference kernel is handed argsort(perm) as its inv_perm."""
    rng = np.random.default_rng(2)
    g, d, n = 2, 32, 64
    q_hat, k, v, do = (_randn(rng, 4, n, d // g), _randn(rng, 2, n, d), _randn(rng, 2, n, d),
                       _randn(rng, 4, n, d))
    perm = np.stack([rng.permutation(d) for _ in range(4 * n // BLOCK)]).astype(np.int32)
    perm = perm.reshape(4, n // BLOCK, d)
    kw = dict(q_per_kv=2, causal=causal, group_size=g, block_q=BLOCK, kv_len=n)
    o, lse = distr_attention_plain(_t(q_hat), _t(k), _t(v), _t(perm), return_lse=True, **kw)
    delta = bwd.delta_plain(o, _t(do))
    args_t = (_t(q_hat), _t(k), _t(v), _t(perm), _t(do), lse, delta)
    jx = {name: jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
          for name, x in dict(q_hat=q_hat, k=k, v=v, perm=perm, do=do, lse=lse,
                              delta=delta).items()}
    rkw = dict(kw, block_k=BLOCK)
    want_dq = rbwd.distr_dq_kernel_call(jx["q_hat"], jx["k"], jx["v"], jx["perm"], jx["do"],
                                        jx["lse"], jx["delta"], **rkw)
    _close(bwd.distr_dq_kernel_call(*args_t, **kw), want_dq, 1e-4, "dq_hat")
    inv_perm = jnp.argsort(jx["perm"], axis=-1).astype(jnp.int32)
    want_dkv = rbwd.distr_dkv_kernel_call(jx["q_hat"], jx["k"], jx["v"], jx["perm"], inv_perm,
                                          jx["do"], jx["lse"], jx["delta"], **rkw)
    for got, want, name in zip(bwd.distr_dkv_kernel_call(*args_t, **kw), want_dkv, "kv"):
        _close(got, want, 1e-4, f"d{name}")


def _gather_sum(dq_tilde, perm, group_size, block_q):
    """dQ̂[:, g] = Σ_u dQ̃[:, perm[g·G* + u]] in each permutation block: the
    bf16 dq kernel's store.  dq_tilde (BHq, N, d), perm (BHq, N/block_q, d)
    → (BHq, N, d/G*)."""
    bhq, n, d = dq_tilde.shape
    idx = perm.to(torch.int64).repeat_interleave(block_q, dim=1)
    return torch.gather(dq_tilde, -1, idx).reshape(bhq, n, d // group_size, group_size).sum(-1)


@pytest.mark.parametrize("g", [2, 4, 8, 16])
@pytest.mark.parametrize("d", [64, 112, 128])
def test_q_tilde_backward_is_the_fused_k_backward(d, g):
    """What the bf16 backward kernels compute through Q̃ (Q̂ expanded by
    ``scatter_q_hat``): the gather-sum of dS·K equals dS·K̂ with K̂ from the
    reference's ``fuse_k_columns``, and dSᵀ·Q̃ equals the reference's dK,
    dK̂ = dSᵀ·Q̂ replicated to each group's G* members and gathered back by
    the inverse permutation, summed over Q blocks; in f32, where sums of 96
    products reach |40|, so summation order alone moves them by ~2e-5:
    atol 1e-4, rtol 1e-5."""
    from repro.kernels.distr_attention import fuse_k_columns as ref_fuse
    from repro_torch.kernels.distr_attention import scatter_q_hat

    rng = np.random.default_rng(13)
    bhq, n, m, block_q = 2, 128, 96, 64
    nb = n // block_q
    q_hat = _randn(rng, bhq, n, d // g)
    k = _randn(rng, m, d)
    ds = _randn(rng, bhq, n, m)
    perm = np.stack([[rng.permutation(d) for _ in range(nb)] for _ in range(bhq)])
    perm = perm.astype(np.int32)
    q_t = scatter_q_hat(_t(q_hat), _t(perm), g, block_q)
    got_dq = _gather_sum(_t(ds) @ _t(k), _t(perm), g, block_q).numpy()
    got_dk = (_t(ds).transpose(1, 2) @ q_t).numpy()
    for h in range(bhq):
        want_dk = jnp.zeros((m, d), jnp.float32)
        for blk in range(nb):
            rows = slice(blk * block_q, (blk + 1) * block_q)
            pj = jnp.asarray(perm[h, blk])
            k_hat = ref_fuse(jnp.asarray(k), pj, g)
            np.testing.assert_allclose(got_dq[h, rows], ds[h, rows] @ np.asarray(k_hat),
                                       atol=1e-4, rtol=1e-5)
            dk_hat = jnp.asarray(ds[h, rows]).T @ jnp.asarray(q_hat[h, rows])
            dk_rep = jnp.broadcast_to(dk_hat[:, :, None], (m, d // g, g)).reshape(m, d)
            want_dk = want_dk + jnp.take(dk_rep, jnp.argsort(pj), axis=1)
        np.testing.assert_allclose(got_dk[h], np.asarray(want_dk), atol=1e-4, rtol=1e-5)


def _distr_bwd_tc_emulation(q_hat, k, v, perm, do, lse, delta, *, q_per_kv, causal, group_size,
                            block_q, kv_len, split=_split_bf16):
    """The arithmetic of the bf16 tensor-core DistrAttention backward
    (``csrc/distr_bwd_tc.cuh``) on the CPU: Q̃ = Q̂ expanded through the
    permutation (bf16 values, so exact); S = Q̃·Kᵀ and dP = dO·Vᵀ in f32 from
    bf16 inputs; P and dS split into bf16 hi + lo as the A operands of
    dQ̃ = dS·K, dV = Pᵀ·dO and dK = dSᵀ·Q̃, every part summed into one f32
    accumulator; then dQ̂ by the gather-sum of dQ̃'s columns."""
    from repro_torch.kernels.distr_attention import scatter_q_hat

    bhq, n, _ = q_hat.shape
    nk = k.shape[1]
    kv = torch.arange(bhq) // q_per_kv
    kf, vf = k.float()[kv], v.float()[kv]  # (BHq, Nk, d)
    q_t = scatter_q_hat(q_hat, perm, group_size, block_q).float()
    s = q_t @ kf.transpose(1, 2)
    dp = do.float() @ vf.transpose(1, 2)
    p, ds = bwd._p_and_ds(s, bwd._mask(n, nk, kv_len, causal, "cpu"), lse, delta, dp)
    dq_t = sum(part @ kf for part in split(ds))
    dv = sum(part.transpose(1, 2) @ do.float() for part in split(p))
    dk = sum(part.transpose(1, 2) @ q_t for part in split(ds))
    return _gather_sum(dq_t, perm, group_size, block_q), dk, dv


@pytest.mark.parametrize("d,g,causal,kv_len", [
    (64, 2, True, 128), (128, 4, True, 121), (64, 16, False, 100), (128, 8, True, 128),
    (112, 2, True, 128), (112, 4, False, 121),  # zamba2-7b's head dim: d/G* = 56, 28
])
def test_distr_backward_tc_emulation_holds_1e4(d, g, causal, kv_len):
    """The bf16 kernels' arithmetic (``_distr_bwd_tc_emulation``) against the
    reference's Pallas kernels in interpret mode on the same bf16-valued
    inputs, at the 1e-4 the card holds the kernels to.  Rounding P and dS
    to bf16 alone is logged, not asserted."""
    rng = np.random.default_rng(8)
    hq, hkv, n, block_q = 4, 2, 128, 64
    nk = 128

    def bf16(x):
        return _t(x).to(torch.bfloat16)

    q_hat = bf16(_randn(rng, hq, n, d // g) * d ** -0.5)
    k, v, do = bf16(_randn(rng, hkv, nk, d)), bf16(_randn(rng, hkv, nk, d)), bf16(
        _randn(rng, hq, n, d))
    perm = _t(np.stack([[rng.permutation(d) for _ in range(n // block_q)]
                        for _ in range(hq)]).astype(np.int32))
    kw = dict(q_per_kv=hq // hkv, causal=causal, group_size=g, block_q=block_q, kv_len=kv_len)
    o, lse = distr_attention_plain(q_hat, k, v, perm, return_lse=True, **kw)
    delta = bwd.delta_plain(o, do)
    jx = [jnp.asarray(x.float().numpy()) for x in (q_hat, k, v, perm, do, lse, delta)]
    jx[3] = jx[3].astype(jnp.int32)
    rkw = dict(kw, block_k=64)
    want = (rbwd.distr_dq_kernel_call(*jx, **rkw),
            *rbwd.distr_dkv_kernel_call(*jx[:4], jnp.argsort(jx[3], axis=-1).astype(jnp.int32),
                                        *jx[4:], **rkw))
    tol = 1e-4
    shares = {}
    for name, split in (("hi + lo", _split_bf16), ("bf16 only", _bf16_only)):
        got = _distr_bwd_tc_emulation(q_hat, k, v, perm, do, lse, delta, split=split, **kw)
        shares[name] = [float((np.abs(g_.numpy() - np.asarray(w_)) /
                               (tol + tol * np.abs(np.asarray(w_)))).max())
                        for g_, w_ in zip(got, want)]
    print(f"largest error as a share of the 1e-4 allowance (dq_hat, dk, dv): {shares}")
    got = _distr_bwd_tc_emulation(q_hat, k, v, perm, do, lse, delta, **kw)
    for g_, w_, what in zip(got, want, ("dq_hat", "dk", "dv")):
        _close(g_, w_, tol, what)


# ---------------------------------------------------------------------------
# Gradients through the ops against jax.grad of the reference ops
# ---------------------------------------------------------------------------


def _inputs(seed, b, hq, hkv, n, d, dtype):
    rng = np.random.default_rng(seed)
    arrays = (_randn(rng, b, hq, n, d), _randn(rng, b, hkv, n, d), _randn(rng, b, hkv, n, d))
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(x).astype(jd) for x in arrays],
            [torch.from_numpy(x).to(td).requires_grad_(True) for x in arrays])


def _weights(d):
    """Non-uniform cotangent so dO varies per output column."""
    return np.cos(np.arange(d)).astype(np.float32)


def _grads_match(port_fn, ref_fn, seed, b, hq, hkv, n, d, dtype):
    (qj, kj, vj), (qt, kt, vt) = _inputs(seed, b, hq, hkv, n, d, dtype)
    w = _weights(d)
    want = jax.grad(lambda q, k, v: (ref_fn(q, k, v).astype(jnp.float32) * w).sum(),
                    argnums=(0, 1, 2))(qj, kj, vj)
    (port_fn(qt, kt, vt).float() * torch.from_numpy(w)).sum().backward()
    for t, j, name in zip((qt, kt, vt), want, "qkv"):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
        _close(t.grad, j, TOL[dtype], f"d{name}")


FLASH_CASES = [
    # (b, hq, hkv, n, d, dtype, causal)
    (1, 2, 2, 64, 32, "f32", False),
    (2, 4, 2, 64, 32, "f32", True),    # GQA 4 over 2
    (1, 4, 2, 50, 32, "f32", True),    # ragged N
    (1, 4, 2, 50, 32, "f32", False),
    (2, 4, 2, 64, 32, "bf16", True),
    (1, 2, 2, 64, 112, "f32", True),   # zamba2-7b's head dim
    (1, 2, 2, 50, 112, "bf16", False),
]


@pytest.mark.parametrize("b,hq,hkv,n,d,dtype,causal", FLASH_CASES)
def test_flash_grad_matches_jax_grad(b, hq, hkv, n, d, dtype, causal):
    _grads_match(
        lambda q, k, v: tops.flash_attention(q, k, v, causal=causal),
        lambda q, k, v: rops.flash_attention(q, k, v, causal=causal, block_q=BLOCK,
                                             block_k=BLOCK),
        0, b, hq, hkv, n, d, dtype,
    )


DISTR_CASES = [
    # (b, hq, hkv, n, d, dtype, causal, cfg_kw)
    (1, 2, 2, 64, 32, "f32", False, {}),
    (2, 4, 2, 64, 32, "f32", True, {}),                       # GQA 4 over 2
    (1, 4, 2, 50, 32, "f32", True, {}),                       # ragged N: Q padded
    (2, 4, 2, 64, 32, "f32", True, {"estimator": "mean"}),
    (1, 4, 2, 50, 32, "f32", False, {"estimator": "mean"}),
    (2, 4, 2, 64, 32, "f32", True, {"shared_kv_perm": True}),
    (2, 4, 2, 64, 32, "bf16", True, {}),
    (1, 2, 2, 64, 112, "f32", True, {}),                      # zamba2-7b's head dim
    (1, 2, 2, 50, 112, "bf16", False, {}),
]


@pytest.mark.parametrize("b,hq,hkv,n,d,dtype,causal,cfg_kw", DISTR_CASES)
def test_distr_grad_matches_jax_grad(b, hq, hkv, n, d, dtype, causal, cfg_kw):
    rcfg = RefDistrConfig(group_size=2, block_q=BLOCK, block_k=BLOCK, **cfg_kw)
    tcfg = DistrConfig(group_size=2, block_q=BLOCK, **cfg_kw)
    proj = _t(rl.make_projection(jax.random.PRNGKey(rcfg.proj_seed), BLOCK))
    _grads_match(
        lambda q, k, v: tops.distr_attention(q, k, v, tcfg, causal=causal, proj=proj),
        lambda q, k, v: rops.distr_attention(q, k, v, rcfg, causal=causal),
        1, b, hq, hkv, n, d, dtype,
    )


def test_distr_grad_straight_through_column_count():
    """No gradient flows into the LSH stage: under ``sample`` exactly d/G*
    columns of each Q block get gradient, the block's sampled ones."""
    g, d, n = 2, 32, 64
    _, (q, k, v) = _inputs(3, 1, 2, 2, n, d, "f32")
    cfg = DistrConfig(group_size=g, block_q=BLOCK)
    (tops.distr_attention(q, k, v, cfg, causal=False) * torch.from_numpy(_weights(d))).sum() \
        .backward()
    live = q.grad.abs().reshape(1, 2, n // BLOCK, BLOCK, d).sum(dim=3) > 0
    assert (live.sum(dim=-1) == d // g).all()


def test_fully_masked_rows_get_zero_gradient():
    """A row that sees no key (forward LSE = -1e30) gets exactly zero dQ,
    and adds nothing to dK / dV: no NaN anywhere."""
    rng = np.random.default_rng(4)
    q, k, do = _t(_randn(rng, 4, 32, 32)), _t(_randn(rng, 2, 32, 32)), _t(_randn(rng, 4, 32, 32))
    kw = dict(q_per_kv=2, scale=0.125, causal=True, kv_len=0)
    o, lse = flash_attention_plain(q, k, k, return_lse=True, **kw)
    assert bool((lse == -1e30).all())
    delta = bwd.delta_kernel_call(o, do)
    dq = bwd.flash_dq_kernel_call(q, k, k, do, lse, delta, **kw)
    dk, dv = bwd.flash_dkv_kernel_call(q, k, k, do, lse, delta, **kw)
    for x in (dq, dk, dv):
        assert torch.equal(x, torch.zeros_like(x))

    perm = torch.stack([torch.randperm(32) for _ in range(4)]).reshape(4, 1, 32)
    dkw = dict(q_per_kv=2, causal=True, group_size=2, block_q=32, kv_len=0)
    q_hat = q[..., :16].contiguous()
    o, lse = distr_attention_plain(q_hat, k, k, perm, return_lse=True, **dkw)
    delta = bwd.delta_kernel_call(o, do)
    dq_hat = bwd.distr_dq_kernel_call(q_hat, k, k, perm, do, lse, delta, **dkw)
    dk, dv = bwd.distr_dkv_kernel_call(q_hat, k, k, perm, do, lse, delta, **dkw)
    for x in (dq_hat, dk, dv):
        assert torch.equal(x, torch.zeros_like(x))


def test_padded_rows_with_lse_pad_add_nothing():
    """The LSE_PAD rule: query rows past N, with LSE = LSE_PAD, dO = 0 and
    D = 0, leave dK / dV exactly as without them."""
    rng = np.random.default_rng(5)
    q, k, v, do = (_t(_randn(rng, 2, 40, 32)), _t(_randn(rng, 2, 40, 32)),
                   _t(_randn(rng, 2, 40, 32)), _t(_randn(rng, 2, 40, 32)))
    kw = dict(q_per_kv=1, scale=32 ** -0.5, causal=False, kv_len=40)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = bwd.delta_plain(o, do)
    want = bwd.flash_dkv_plain(q, k, v, do, lse, delta, **kw)

    def pad(x, value=0.0):
        return torch.cat([x, torch.full((2, 24, *x.shape[2:]), value)], dim=1)

    got = bwd.flash_dkv_plain(pad(q, 3.0), k, v, pad(do), pad(lse, bwd.LSE_PAD), pad(delta),
                              **kw)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


def test_primal_path_asks_for_no_lse(monkeypatch):
    """Without grad the op runs the forward kernel alone, with no LSE;
    with grad it asks for the LSE residual."""
    calls = []
    real = tops.flash_attention_kernel_call

    def spy(*args, **kw):
        calls.append(kw.get("return_lse", False))
        return real(*args, **kw)

    monkeypatch.setattr(tops, "flash_attention_kernel_call", spy)
    _, (q, k, v) = _inputs(6, 1, 2, 2, 32, 32, "f32")
    with torch.no_grad():
        out = tops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    tops.flash_attention(q, k, v, causal=True).sum().backward()
    assert calls == [False, True]
