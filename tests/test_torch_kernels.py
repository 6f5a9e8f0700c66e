"""Port parity: repro_torch.kernels.ops (the kernels' plain versions on the
CPU) against the JAX reference's repro.kernels.ops (Pallas in interpret
mode) on the same numpy inputs, at the reference tests' tolerances:
flash 2e-5 f32 / 2e-2 bf16, distr 2e-5 / 3e-2, decode 1e-4 / 1e-2."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DistrConfig as RefDistrConfig  # noqa: E402
from repro.core import grouping as rg  # noqa: E402
from repro.core import lsh as rl  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core.distr_attention import DistrConfig, pad_to_multiple  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels.decode import decode_plain  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    """The same values in both packages (bf16 rounds identically from f32)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(np.array(x)).to(td)


def _qkv(seed, b, hq, hkv, n, nk, d, dtype, q_len=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, q_len or n, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, nk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, nk, d)).astype(np.float32)
    return _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


FLASH_CASES = [
    # (b, hq, hkv, n, nk, d, dtype, causal)
    (1, 1, 1, 128, 128, 64, "f32", False),
    (2, 4, 4, 128, 128, 64, "f32", True),
    (2, 8, 2, 128, 128, 64, "f32", True),   # GQA
    (1, 2, 2, 192, 192, 32, "f32", True),   # ragged N
    (1, 2, 2, 128, 256, 64, "f32", False),  # rectangular
    (2, 4, 4, 128, 128, 64, "bf16", True),
]


@pytest.mark.parametrize("b,hq,hkv,n,nk,d,dtype,causal", FLASH_CASES)
def test_flash_attention_matches_reference(b, hq, hkv, n, nk, d, dtype, causal):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(0, b, hq, hkv, n, nk, d, dtype)
    want = rops.flash_attention(qj, kj, vj, causal=causal, block_q=64, block_k=64)
    got = tops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, 2e-2 if dtype == "bf16" else 2e-5)


DISTR_CASES = [
    # (b, hq, hkv, n, d, g, dtype, causal)
    (1, 1, 1, 128, 64, 2, "f32", False),
    (2, 4, 4, 128, 64, 2, "f32", True),
    (2, 8, 2, 128, 64, 4, "f32", True),   # GQA + G*=4
    (1, 2, 2, 192, 32, 2, "f32", True),   # Q padded to block_q
    (2, 4, 4, 128, 64, 2, "bf16", True),
]


@pytest.mark.parametrize("b,hq,hkv,n,d,g,dtype,causal", DISTR_CASES)
def test_distr_attention_matches_reference(b, hq, hkv, n, d, g, dtype, causal):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(1, b, hq, hkv, n, n, d, dtype)
    rcfg = RefDistrConfig(group_size=g, block_q=64)
    tcfg = DistrConfig(group_size=g, block_q=64)
    proj = np.array(rl.make_projection(jax.random.PRNGKey(rcfg.proj_seed), 64))
    proj_t = torch.from_numpy(proj)
    scale = 1.0 / d ** 0.5

    # Stage 1: the permutations are exactly the reference's, Q̂ matches.
    qp_j, _ = rops._pad_seq(qj, 64)
    qhat_j, perms_j = rops.distr_stage1(rcfg, qp_j, scale, hkv=hkv)
    qhat_t, perms_t = tops.distr_stage1(tcfg, pad_to_multiple(qt, 64, 2), scale,
                                        proj=proj_t, hkv=hkv)
    np.testing.assert_array_equal(perms_t.numpy(), np.asarray(perms_j))
    _close(qhat_t, qhat_j, 1e-6 if dtype == "f32" else 1e-2)

    want = rops.distr_attention(qj, kj, vj, rcfg, causal=causal)
    got = tops.distr_attention(qt, kt, vt, tcfg, causal=causal, proj=proj_t)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, 3e-2 if dtype == "bf16" else 2e-5)


DECODE_CASES = [
    # (b, hq, hkv, s, d, lengths, block_k, dtype, q_len)
    (1, 1, 1, 128, 64, (5,), 64, "f32", 1),            # < one block
    (2, 4, 4, 256, 64, (37, 256), 64, "f32", 1),       # partial and full
    (2, 8, 2, 256, 64, (64, 129), 64, "f32", 1),       # GQA, split edge
    (2, 8, 1, 512, 32, (1, 511), 128, "f32", 1),       # extremes
    (2, 4, 2, 192, 32, (100, 192), 64, "f32", 1),      # S not a multiple of block_k
    (2, 8, 2, 256, 64, (64, 200), 64, "bf16", 1),
    (2, 4, 2, 256, 64, (9, 200), 64, "f32", 2),        # q_len 2 band
    (3, 8, 2, 256, 64, (0, 130, 256), 128, "bf16", 2),  # length 0, q_len 2
]


@pytest.mark.parametrize("b,hq,hkv,s,d,lengths,block_k,dtype,q_len", DECODE_CASES)
def test_decode_attention_matches_reference(b, hq, hkv, s, d, lengths, block_k, dtype, q_len):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, b, hq, hkv, s, s, d, dtype, q_len=q_len)
    lens = np.asarray(lengths, np.int32)
    want = rops.decode_attention(qj, kj, vj, lengths=jnp.asarray(lens), block_k=block_k)
    got = tops.decode_attention(qt, kt, vt, lengths=torch.from_numpy(lens), block_k=block_k)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, 1e-2 if dtype == "bf16" else 1e-4)


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_fused_score_width(g, dtype):
    """d_score = d/G*: sampled Q against a fused K̂ cache, full-width V."""
    b, hq, hkv, s, d = 2, 8, 2, 256, 64
    (qj, qt), (kj, kt), (vj, vt) = _qkv(3, b, hq, hkv, s, s, d, "f32", q_len=1)
    rng = np.random.default_rng(4)
    perm = np.stack([rng.permutation(d) for _ in range(hkv)]).astype(np.int32)
    kf = np.asarray(rg.fuse_columns(kj, jnp.asarray(perm)[None], g))
    (qj, qt), (kfj, kft), (vj, vt) = (
        _pair(np.asarray(qj), dtype), _pair(kf, dtype), _pair(np.asarray(vj), dtype))
    lens = np.asarray([50, 222], np.int32)
    scale = 1.0 / d ** 0.5
    want = rops.decode_attention(qj, None, vj, lengths=jnp.asarray(lens), k_fused=kfj,
                                 perm=jnp.asarray(perm), group_size=g, scale=scale, block_k=64)
    got = tops.decode_attention(qt, None, vt, lengths=torch.from_numpy(lens), k_fused=kft,
                                perm=torch.from_numpy(perm), group_size=g, scale=scale,
                                block_k=64)
    _close(got, want, 1e-2 if dtype == "bf16" else 1e-4)


def _decode_split_p(q, k, v, lengths, *, scale, block_k, q_len, parts, tile=64):
    """The bf16 tensor-core decode tile's arithmetic (``csrc/decode_tc.cuh``)
    on the CPU: per split, 64-key tiles with an online softmax in raw-score
    units (exp2 of (s − m)·scale·log2 e), S in f32 from the bf16 q and k,
    and P·V as the sum of each part of P (``parts``) times V in f32."""
    b, hkv, rows, _ = q.shape
    s_len, d = k.shape[2], v.shape[3]
    splits = -(-s_len // block_k)
    qf, kf, vf = q.float(), k.float(), v.float()
    sl2 = scale * math.log2(math.e)
    tok = torch.arange(rows) % q_len
    row_len = lengths.long()[:, None] - (q_len - 1 - tok)[None, :]  # (B, rows)
    o = torch.zeros((b, hkv, splits, rows, d))
    m = torch.full((b, hkv, splits, rows), -1e30)
    l = torch.zeros((b, hkv, splits, rows))
    for j in range(splits):
        kv0 = j * block_k
        acc = torch.zeros((b, hkv, rows, d))
        m_i = torch.full((b, hkv, rows), -1e30)
        l_i = torch.zeros((b, hkv, rows))
        for t0 in range(0, min(block_k, s_len - kv0), tile):
            keys = torch.arange(kv0 + t0, min(kv0 + t0 + tile, kv0 + block_k, s_len))
            s = torch.einsum("bhrd,bhkd->bhrk", qf, kf[:, :, keys])
            live = (keys[None, None, :] < row_len[:, :, None])[:, None]
            s = torch.where(live, s, -1e30)
            m_new = torch.maximum(m_i, s.amax(-1))
            alpha = torch.exp2((m_i - m_new) * sl2)
            p = torch.where(live, torch.exp2(s * sl2 - (m_new * sl2)[..., None]), 0.0)
            l_i = l_i * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + sum(
                torch.einsum("bhrk,bhkd->bhrd", part, vf[:, :, keys]) for part in parts(p))
            m_i = m_new
        o[:, :, j], l[:, :, j] = acc, l_i
        m[:, :, j] = torch.where(m_i == -1e30, -1e30, m_i * scale)
    return o, m, l


def _split_bf16(x):
    """x ≈ hi + lo with hi = bf16(x) and lo = bf16(x − hi), as f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _bf16_only(x):
    return (x.to(torch.bfloat16).float(),)


@pytest.mark.parametrize("rows,q_len", [(9, 1), (288, 32)], ids=["tick", "chunk"])
def test_decode_split_p_holds_1e4(rows, q_len):
    """The bf16 decode and paged-decode kernels' arithmetic, emulated on the
    CPU at a tick (9 packed rows) and a 32-token chunk (288 rows): with P
    split into bf16 hi + lo, o, m and l stay within the 1e-4 the card holds
    the kernels to against ``decode_plain``.  Rounding P to bf16 alone is
    logged, not asserted: it is the reason for the split."""
    rng = np.random.default_rng(11)
    b, hkv, s_len, d, block_k = 2, 2, 300, 64, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(torch.bfloat16)
               for shape in ((b, hkv, rows, d), (b, hkv, s_len, d), (b, hkv, s_len, d)))
    lengths = torch.tensor([37, 300], dtype=torch.int32)
    kw = dict(scale=d ** -0.5, block_k=block_k, q_len=q_len)
    want = decode_plain(q, k, v, lengths, **kw)
    tol = 1e-4
    got = {name: _decode_split_p(q, k, v, lengths, parts=parts, **kw)
           for name, parts in (("hi + lo", _split_bf16), ("bf16 only", _bf16_only))}
    shares = {name: [float(((g_ - w_).abs() / (tol + tol * w_.abs())).max())
                     for g_, w_ in zip(outs, want)] for name, outs in got.items()}
    print(f"largest error as a share of the 1e-4 allowance (o, m, l): {shares}")
    for g_, w_, what in zip(got["hi + lo"], want, "oml"):
        torch.testing.assert_close(g_, w_, atol=tol, rtol=tol, msg=lambda msg: f"{what}: {msg}")


def test_decode_attention_no_lengths_means_all_live():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(5, 2, 4, 4, 128, 128, 32, "f32", q_len=1)
    want = rops.decode_attention(qj, kj, vj, block_k=64)
    got = tops.decode_attention(qt, kt, vt, block_k=64)
    _close(got, want, 1e-4)


def test_fully_masked_rows_are_zero_not_nan():
    """Length 0 masks every key; under q_len = 2 at length 1 the first
    query token sees nothing.  Both rows come out exactly 0."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(6, 2, 4, 2, 128, 128, 64, "f32", q_len=2)
    lens = np.asarray([0, 1], np.int32)
    got = tops.decode_attention(qt, kt, vt, lengths=torch.from_numpy(lens), block_k=64)
    want = rops.decode_attention(qj, kj, vj, lengths=jnp.asarray(lens), block_k=64)
    assert torch.isfinite(got).all()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(got[1, :, 0], torch.zeros_like(got[1, :, 0]))
    _close(got, want, 1e-4)
    # The flash kernel's contract for a row with no visible key: O = 0,
    # LSE = -1e30.
    q = torch.randn(4, 16, 64)
    k = torch.randn(2, 16, 64)
    o, lse = tflash.flash_attention_kernel_call(q, k, k, q_per_kv=2, scale=0.125,
                                                causal=True, kv_len=0, return_lse=True)
    assert torch.equal(o, torch.zeros_like(o)) and bool((lse == -1e30).all())


@pytest.mark.parametrize("kw", [dict(estimator="mean"), dict(shared_kv_perm=True),
                                dict(hash_method="proj_morton")])
def test_distr_attention_variants_match_reference(kw):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(7, 2, 4, 2, 128, 128, 64, "f32")
    rcfg = RefDistrConfig(group_size=2, block_q=64, block_k=64, **kw)
    proj = np.array(rl.make_projection(jax.random.PRNGKey(rcfg.proj_seed), 64))
    want = rops.distr_attention(qj, kj, vj, rcfg, causal=True)
    got = tops.distr_attention(qt, kt, vt, DistrConfig(group_size=2, block_q=64, **kw),
                               causal=True, proj=torch.from_numpy(proj))
    _close(got, want, 2e-5)


@pytest.mark.parametrize("impl", ["reference", "xla_flash", "distr", "pallas_flash",
                                  "pallas_distr"])
def test_attend_every_impl_matches_reference(impl):
    from repro.core.api import AttentionConfig as RefAttentionConfig
    from repro.core.api import attend as ref_attend
    from repro_torch.core.api import AttentionConfig, attend

    (qj, qt), (kj, kt), (vj, vt) = _qkv(8, 2, 8, 2, 160, 160, 32, "f32")
    rcfg = RefAttentionConfig(impl=impl, distr=RefDistrConfig(group_size=2, block_q=32))
    tcfg = AttentionConfig(impl=impl, distr=DistrConfig(group_size=2, block_q=32))
    proj = np.array(rl.make_projection(jax.random.PRNGKey(0), 32))
    want = ref_attend(qj, kj, vj, rcfg, causal=True)
    got = attend(qt, kt, vt, tcfg, causal=True, proj=torch.from_numpy(proj))
    _close(got, want, 2e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_attend_decode_reference_impl_matches_reference(fused):
    from repro.core.api import AttentionConfig as RefAttentionConfig
    from repro.core.api import attend_decode as ref_attend_decode
    from repro_torch.core.api import AttentionConfig, attend_decode

    (qj, qt), (kj, kt), (vj, vt) = _qkv(9, 2, 4, 2, 96, 96, 32, "f32", q_len=1)
    lens = np.asarray([17, 96], np.int32)
    kw_j, kw_t = {}, {}
    if fused:
        perm = np.stack([np.random.default_rng(h).permutation(32) for h in range(2)])
        perm = perm.astype(np.int32)
        kf = np.asarray(rg.fuse_columns(kj, jnp.asarray(perm)[None], 2))
        kw_j = dict(k_fused=jnp.asarray(kf), perm=jnp.asarray(perm), group_size=2)
        kw_t = dict(k_fused=torch.from_numpy(kf), perm=torch.from_numpy(perm), group_size=2)
    want = ref_attend_decode(qj, kj, vj, RefAttentionConfig(impl="reference"),
                             lengths=jnp.asarray(lens), **kw_j)
    got = attend_decode(qt, kt, vt, AttentionConfig(impl="reference"),
                        lengths=torch.from_numpy(lens), **kw_t)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("d", [64, 112, 128])
def test_scattered_q_times_k_is_q_hat_times_fused_k(d, g):
    """What the bf16 kernel computes: Q̃·Kᵀ, with Q̂ scattered through each
    block's permutation (``scatter_q_hat``), equals Q̂ · K̂ᵀ with K̂ from the
    reference's ``fuse_k_columns``, in f32."""
    from repro.kernels.distr_attention import fuse_k_columns as ref_fuse
    from repro_torch.kernels.distr_attention import scatter_q_hat

    rng = np.random.default_rng(12)
    bhq, n, m, block_q = 2, 128, 96, 64
    q_hat = rng.standard_normal((bhq, n, d // g)).astype(np.float32)
    k = rng.standard_normal((m, d)).astype(np.float32)
    perm = np.stack([[rng.permutation(d) for _ in range(n // block_q)]
                     for _ in range(bhq)]).astype(np.int32)
    q_t = scatter_q_hat(torch.from_numpy(q_hat), torch.from_numpy(perm), g, block_q)
    got = (q_t @ torch.from_numpy(k).T).numpy()
    for h in range(bhq):
        for blk in range(n // block_q):
            k_hat = np.asarray(ref_fuse(jnp.asarray(k), jnp.asarray(perm[h, blk]), g))
            rows = slice(blk * block_q, (blk + 1) * block_q)
            np.testing.assert_allclose(got[h, rows], q_hat[h, rows] @ k_hat.T,
                                       atol=1e-5, rtol=1e-5)


def _distr_tile_emulation(q_hat, k, v, perm, *, q_per_kv, causal, group_size, block_q,
                          kv_len, mode, tile=64):
    """A tensor-core DistrAttention forward's arithmetic on the CPU, 64-key
    tiles with an online softmax in log2 units.  Scores in f32: ``exact``,
    Q̃·Kᵀ (Q̂ scattered through the permutation, raw K), what
    ``csrc/distr_fwd_tc.cuh`` computes; ``fused``, the paper's reduced-width
    product Q̂ · K̂ᵀ with K̂ summed in f32 and rounded to bf16 for the tensor
    cores.  P is rounded to bf16 for P·V, O to bf16 at the end; LSE f32."""
    from repro_torch.kernels.distr_attention import fuse_k_columns, scatter_q_hat

    bhq, n, _ = q_hat.shape
    nk, d = k.shape[1], k.shape[2]
    kv = torch.arange(bhq) // q_per_kv
    kf, vf = k.float()[kv], v.float()[kv]  # (BHq, Nk, d)
    blk = torch.arange(n) // block_q
    if mode == "exact":
        s_all = scatter_q_hat(q_hat, perm, group_size, block_q).float() @ kf.transpose(1, 2)
    else:
        kb = kf[:, None].expand(bhq, perm.shape[1], nk, d)
        k_hat = fuse_k_columns(kb, perm, group_size).to(torch.bfloat16).float()
        s_all = torch.einsum("hnc,hnmc->hnm", q_hat.float(), k_hat[:, blk])
    rows = torch.arange(n)[:, None]
    l2e = math.log2(math.e)
    m_i = torch.full((bhq, n), -1e30)
    l_i = torch.zeros((bhq, n))
    acc = torch.zeros((bhq, n, d))
    for t0 in range(0, nk, tile):
        keys = torch.arange(t0, min(t0 + tile, nk))
        live = (keys[None, :] < kv_len) & ((keys[None, :] <= rows) if causal else True)
        s = torch.where(live, s_all[:, :, keys], -1e30)
        m_new = torch.maximum(m_i, s.amax(-1))
        alpha = torch.exp2((m_i - m_new) * l2e)
        p = torch.where(live, torch.exp2((s - m_new[..., None]) * l2e), 0.0)
        l_i = l_i * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, keys]
        m_i = m_new
    denom = torch.where(l_i == 0, 1.0, l_i)
    o = (acc / denom[..., None]).to(q_hat.dtype)
    return o, torch.where(l_i == 0, -1e30, m_i + torch.log(denom))


@pytest.mark.parametrize("mode", ["exact", "fused"])
@pytest.mark.parametrize("d,g", [(128, 2), (128, 4), (112, 2), (64, 2)])
def test_distr_tile_modes_hold_their_tolerances(d, g, mode):
    """Two designs of a tensor-core DistrAttention forward, emulated on the
    CPU (GQA 4 over 2, N = 256, causal, a ragged kv_len, bf16 inputs): O
    holds the 3e-2 the card holds the kernel to against
    ``distr_attention_plain`` in both; the exact product's LSE, the one
    the kernel computes, holds 1e-4.  How far a bf16 K̂ moves the LSE past
    1e-4 is logged, not asserted: it is one reason the kernel does not
    round K̂ (the training path saves the LSE for the backward)."""
    from repro_torch.kernels.distr_attention import distr_attention_plain

    rng = np.random.default_rng(13)
    bhq, hkv, n, block_q, kv_len = 4, 2, 256, 128, 250
    q_hat, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(torch.bfloat16)
                   for s in ((bhq, n, d // g), (hkv, n, d), (hkv, n, d)))
    q_hat = (q_hat.float() * d ** -0.5).to(torch.bfloat16)  # Q̂ carries the scale
    perm = torch.from_numpy(np.stack([[rng.permutation(d) for _ in range(n // block_q)]
                                      for _ in range(bhq)]).astype(np.int32))
    kw = dict(q_per_kv=bhq // hkv, causal=True, group_size=g, block_q=block_q, kv_len=kv_len)
    o_p, lse_p = distr_attention_plain(q_hat, k, v, perm, return_lse=True, **kw)
    o, lse = _distr_tile_emulation(q_hat, k, v, perm, mode=mode, **kw)
    shares = {name: float(((a.float() - b.float()).abs() / (tol + tol * b.float().abs())).max())
              for name, a, b, tol in (("o", o, o_p, 3e-2), ("lse", lse, lse_p, 1e-4))}
    print(f"{mode} d={d} G*={g}: largest error as a share of its allowance {shares}")
    torch.testing.assert_close(o.float(), o_p.float(), atol=3e-2, rtol=3e-2)
    if mode == "exact":
        torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)
