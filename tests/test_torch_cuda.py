"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes and edge cases (ragged tiles, kv_len below the buffer,
length 0, 32 packed rows, f32 and bf16; for the bf16 tensor-core flash
forward rows one short of and one past its 64-row CTA, a ragged last key
tile, kv_len = 0, GQA 36 over 4 and MHA, and its LSE fed to the backward
kernels; the same edges for the bf16 tensor-core backward kernels; for the
paged kernel dead blocks, a
NaN-filled garbage block and NaN past the last live key of a live block,
lengths past the table and more than 32 rows; for the bf16 tensor-core
decode tile one and two m-tiles, ragged and streamed key tiles, d_score 56
and NaN past a slot's length; for the bf16 tensor-core DistrAttention
kernel, with and without the LSE, kv_len = 0, a ragged kv_len, fewer rows
than keys, GQA 36 over 4, ds 56, 28, 16 and 14 and G* 1, 8 and 16, and its
launch count and range; for the bf16 tensor-core DistrAttention backward
G* 2 to 16, a 128-row permutation block over four 32-row dkv Q tiles, and
which kernels a bf16 and an f32 call launch; for the delta kernel each
width of lanes a row, dead lanes, the column loop past d = 256, ragged row
counts and its range; head dim 112 for the forward, decode and paged
kernels; for the SSD kernel short and
ragged sequences, strong decays, grouped heads and state width 128, and
for its bf16 tensor-core kernel each P-slice width, 8-byte copies, a
padded chunk and state width and which kernel each dtype runs),
forward and backward, and the
differentiable ops on the card against the same ops on the CPU (the SSD op's
gradient against autograd through its plain version, and one zamba2-7b
training step, SSD and attention kernels together, against the CPU's); and the
serving steps captured as CUDA graphs against the same step functions
driven eagerly (greedy tokens and launch counts, the slot engine for each
family and over the fused-K̂ cache, and the paged engine over a raw-K and a
fused-K̂ pool through preemption; the MoE configs, llama4 on both engines
and deepseek's MLA on the slot engine), the MoE layer's index dispatch
against its one-hot plain version and the CPU's, and injected NaN rows and
stuck steps under graph replay leaving the other requests' tokens as a
clean run's; for the enc-dec and VLM slice the forward and backward
kernels non-causal over 1500 keys at 33, 448 and 1500 rows, the decode
kernel over whisper-small's 1500-position cross cache and its self cache
and at internvl2-2b's 2 rows a KV head, and a train
step and prefill + decode of whisper-small and internvl2-2b (reduced() at
head dim 64) against the CPU's; a train step of both MoE configs
(reduced(), llama4 at head dim 64) against the CPU's, and the tuner's
measure-mode sweeps of the decode, paged and DistrAttention keys at
starcoder2-7b's serving shapes with the kernels at the picks against
their plain versions.  Marked
``cuda``; skips without a GPU.  This file imports neither JAX nor the JAX package, so on a machine
without JAX it runs alone:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.distr_attention import DistrConfig  # noqa: E402
from repro_torch.kernels import backward as bwd  # noqa: E402
from repro_torch.kernels import decode as dec  # noqa: E402
from repro_torch.kernels import distr_attention as dk  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode as pd  # noqa: E402
from repro_torch.kernels import ssd as ssd_kernels  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Backward outputs are f32 on both sides, computed in f32 from the same
# inputs; they differ only in summation order and exp.
BWD_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,q_per_kv,n,nk,kv_len,d,causal", [
    (2, 3, 1, 1, 1, 64, True),
    (2, 3, 100, 100, 100, 128, True),   # ragged row and key tiles
    (2, 3, 64, 200, 150, 64, False),    # kv_len below the buffer
    (2, 3, 130, 130, 130, 128, False),
    # Edges of the bf16 tensor-core kernel (64-row CTAs, 64-key tiles).
    (2, 3, 100, 100, 100, 112, True),   # d = 112: seven k-steps of 16
    (2, 3, 65, 65, 0, 128, False),      # kv_len = 0: O = 0, LSE = -1e30
    (2, 3, 65, 65, 0, 64, True),
    (2, 3, 1, 130, 130, 128, False),    # one row against three key tiles
    (2, 3, 63, 63, 63, 64, True),       # one row short of a CTA
    (2, 3, 65, 65, 65, 112, True),      # one row past a CTA
    (2, 3, 96, 200, 130, 128, False),   # last key tile ragged inside the buffer
    (2, 3, 150, 200, 130, 64, True),
    (2, 3, 100, 200, 200, 128, True),   # causal with fewer rows than keys
    (4, 9, 130, 130, 130, 128, True),   # GQA 36 over 4 (starcoder2-7b)
    (4, 1, 100, 100, 100, 64, True),    # MHA (minicpm-2b)
])
def test_flash_kernel_matches_plain(cuda, dtype, hkv, q_per_kv, n, nk, kv_len, d, causal):
    q = _randn((hkv * q_per_kv, n, d), dtype, 0)
    k, v = _randn((hkv, nk, d), dtype, 1), _randn((hkv, nk, d), dtype, 2)
    kw = dict(q_per_kv=q_per_kv, scale=d ** -0.5, causal=causal, kv_len=kv_len, return_lse=True)
    before = fk.launches
    o, lse = fk.flash_attention_kernel_call(q, k, v, **kw)
    o_p, lse_p = fk.flash_attention_plain(q, k, v, **kw)
    assert fk.launches == before + 1
    _close(o, o_p, dtype)
    torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=1e-3)
    if kv_len == 0:
        assert torch.equal(o, torch.zeros_like(o))
        assert torch.equal(lse, torch.full_like(lse, -1e30))


@pytest.mark.parametrize("hkv,q_per_kv,n,d", [(4, 9, 130, 128), (4, 1, 100, 64)])
def test_flash_forward_lse_feeds_backward_like_plain_lse(cuda, hkv, q_per_kv, n, d):
    """The bf16 forward kernel's LSE gives the backward kernels the same dQ,
    dK and dV as the plain version's LSE (both f32; 1e-4 as the backward
    kernels are held against their plain versions on the card)."""
    dtype, tol = torch.bfloat16, 1e-4
    q, do = _randn((hkv * q_per_kv, n, d), dtype, 40), _randn((hkv * q_per_kv, n, d), dtype, 41)
    k, v = _randn((hkv, n, d), dtype, 42), _randn((hkv, n, d), dtype, 43)
    kw = dict(q_per_kv=q_per_kv, scale=d ** -0.5, causal=True, kv_len=n)
    o, lse = fk.flash_attention_kernel_call(q, k, v, return_lse=True, **kw)
    _, lse_p = fk.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = bwd.delta_kernel_call(o, do)
    got = [bwd.flash_dq_kernel_call(q, k, v, do, lse, delta, **kw),
           *bwd.flash_dkv_kernel_call(q, k, v, do, lse, delta, **kw)]
    want = [bwd.flash_dq_kernel_call(q, k, v, do, lse_p, delta, **kw),
            *bwd.flash_dkv_kernel_call(q, k, v, do, lse_p, delta, **kw)]
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert torch.isfinite(g_).all()
        torch.testing.assert_close(g_, w_, atol=tol, rtol=tol)


def _perms(bhq, n, block_q, d):
    perm = torch.stack([torch.randperm(d, device="cuda") for _ in range(bhq * (n // block_q))])
    return perm.reshape(bhq, n // block_q, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,g,block_q,causal,d", [
    (128, 2, 64, True, 128), (256, 4, 128, False, 128),
    (256, 2, 128, True, 64),  # the training path's head: d = 64, d/G* = 32
])
def test_distr_kernel_matches_plain(cuda, dtype, n, g, block_q, causal, d):
    q_hat = _randn((4, n, d // g), dtype, 3)
    k, v = _randn((2, n - 7, d), dtype, 4), _randn((2, n - 7, d), dtype, 5)
    perm = _perms(4, n, block_q, d)
    kw = dict(q_per_kv=2, causal=causal, group_size=g, block_q=block_q, kv_len=n - 7,
              return_lse=True)
    o, lse = dk.distr_attention_kernel_call(q_hat, k, v, perm, **kw)
    o_p, lse_p = dk.distr_attention_plain(q_hat, k, v, perm, **kw)
    _close(o, o_p, dtype)
    torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=1e-3)


# Edges of the bf16 tensor-core DistrAttention kernel:
# (hkv, q_per_kv, n, nk, kv_len, d, G*, block_q, causal).  ds = d/G*.
DISTR_TC_CASES = [
    (2, 2, 128, 128, 0, 128, 2, 64, False),    # kv_len = 0: O = 0, LSE = -1e30
    (2, 2, 128, 128, 0, 64, 4, 64, True),
    (2, 2, 192, 200, 130, 128, 2, 64, False),  # kv_len ragged inside the buffer
    (2, 2, 128, 200, 200, 64, 2, 64, True),    # causal with fewer rows than keys
    (4, 9, 128, 130, 130, 128, 2, 128, True),  # GQA 36 over 4 (starcoder2-7b)
    (2, 2, 128, 150, 150, 112, 2, 64, True),   # ds = 56 (zamba2-7b)
    (2, 2, 128, 150, 140, 112, 4, 64, True),   # ds = 28
    (2, 2, 128, 150, 150, 64, 4, 64, False),   # ds = 16
    (2, 2, 128, 130, 130, 128, 8, 64, True),   # G* = 8 (ds = 16)
    (2, 2, 64, 100, 100, 112, 8, 64, True),    # G* = 8 (ds = 14)
    (2, 2, 128, 130, 130, 128, 1, 64, True),   # G* = 1 (ds = d)
    (2, 2, 128, 130, 130, 128, 16, 64, True),  # G* = 16 (ds = 8)
]


@pytest.mark.parametrize("return_lse", [True, False])
@pytest.mark.parametrize("hkv,q_per_kv,n,nk,kv_len,d,g,block_q,causal", DISTR_TC_CASES)
def test_distr_tc_kernel_matches_plain(cuda, return_lse, hkv, q_per_kv, n, nk, kv_len, d, g,
                                       block_q, causal):
    """The bf16 DistrAttention kernel against its plain version, O (and
    the LSE when asked for) at the bf16 tolerance and 1e-3 for the LSE."""
    dtype, bhq = torch.bfloat16, hkv * q_per_kv
    q_hat = _randn((bhq, n, d // g), torch.float32, 80) * d ** -0.5
    q_hat = q_hat.to(dtype)
    k, v = _randn((hkv, nk, d), dtype, 81), _randn((hkv, nk, d), dtype, 82)
    perm = _perms(bhq, n, block_q, d)
    kw = dict(q_per_kv=q_per_kv, causal=causal, group_size=g, block_q=block_q, kv_len=kv_len)
    before = dk.launches
    if return_lse:
        o, lse = dk.distr_attention_kernel_call(q_hat, k, v, perm, return_lse=True, **kw)
        o_p, lse_p = dk.distr_attention_plain(q_hat, k, v, perm, return_lse=True, **kw)
        torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=1e-3)
        if kv_len == 0:
            assert torch.equal(lse, torch.full_like(lse, -1e30))
    else:
        o = dk.distr_attention_kernel_call(q_hat, k, v, perm, **kw)
        o_p = dk.distr_attention_plain(q_hat, k, v, perm, **kw)
    assert dk.launches == before + 1
    _close(o, o_p, dtype)
    if kv_len == 0:
        assert torch.equal(o, torch.zeros_like(o))


def test_distr_kernel_launch_count_and_range(cuda):
    """A bf16 call adds one launch, with or without the LSE; a head dim outside
    ``build.HEAD_DIMS``, a block_q that 64 does not divide, or mixed dtypes
    raise before any launch."""
    bhq, n, d = 4, 128, 128
    q_hat = _randn((bhq, n, d // 2), torch.bfloat16, 83)
    k, v = _randn((2, n, d), torch.bfloat16, 84), _randn((2, n, d), torch.bfloat16, 85)
    kw = dict(q_per_kv=2, causal=True, group_size=2, block_q=64, kv_len=n)
    for lse in (False, True):
        before = dk.launches
        dk.distr_attention_kernel_call(q_hat, k, v, _perms(bhq, n, 64, d), return_lse=lse, **kw)
        assert dk.launches == before + 1
    before = dk.launches
    d96 = [_randn(s, torch.bfloat16, 86) for s in ((bhq, n, 48), (2, n, 96), (2, n, 96))]
    with pytest.raises(ValueError, match="distr kernel shapes"):
        dk.distr_attention_kernel_call(*d96, _perms(bhq, n, 64, 96), **kw)
    with pytest.raises(ValueError, match="distr kernel shapes"):
        dk.distr_attention_kernel_call(q_hat, k, v, _perms(bhq, n, 32, d),
                                       **{**kw, "block_q": 32})
    with pytest.raises(TypeError, match="one dtype"):
        dk.distr_attention_kernel_call(q_hat, k.float(), v, _perms(bhq, n, 64, d), **kw)
    assert dk.launches == before


def _bwd_close(got, want):
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=BWD_TOL, rtol=BWD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bhq,n", [(1, 1), (3, 1), (1, 31), (8, 125), (1, 73729)])
@pytest.mark.parametrize("d", [8, 24, 64, 112, 128, 256, 264])
def test_delta_kernel_matches_plain(cuda, dtype, bhq, n, d):
    """D = rowsum(dO ∘ O) at 1e-4: 8, 16 and 32 lanes a row (d <= 64, <= 128,
    above), dead lanes (d = 8, 24, 112), the column loop past 256 (264), and
    row counts that leave a warp's last tile ragged (1, 3, 31, 1000, 73,729)."""
    o, do = _randn((bhq, n, d), dtype, 50), _randn((bhq, n, d), dtype, 51)
    before = bwd.launches["delta"]
    got = bwd.delta_kernel_call(o, do)
    assert bwd.launches["delta"] == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (bhq, n)
    torch.testing.assert_close(got, bwd.delta_plain(o, do), atol=1e-4, rtol=1e-4)


def test_delta_kernel_range(cuda):
    """No rows: an empty result and no launch.  d not a multiple of 8, or O
    and dO of other shapes or dtypes: the wrapper raises before a launch."""
    before = bwd.launches["delta"]
    empty = torch.empty((4, 0, 64), device="cuda", dtype=torch.bfloat16)
    assert bwd.delta_kernel_call(empty, empty).shape == (4, 0)
    o = _randn((2, 16, 64), torch.bfloat16, 52)
    bad = [(_randn((2, 16, 60), torch.bfloat16, 53),) * 2,
           (o, _randn((2, 15, 64), torch.bfloat16, 54)),
           (o, o.float())]
    for args in bad:
        with pytest.raises(ValueError, match="delta kernel shapes"):
            bwd.delta_kernel_call(*args)
    assert bwd.launches["delta"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,q_per_kv,n,nk,kv_len,d,causal", [
    (2, 3, 1, 1, 1, 64, True),
    (2, 3, 100, 100, 100, 64, True),    # ragged row and key tiles: rows past N take LSE_PAD
    (2, 3, 64, 200, 150, 128, False),   # kv_len below the buffer
    (2, 3, 130, 130, 130, 128, True),
    (2, 3, 64, 64, 0, 64, False),       # every row fully masked: exactly zero
    # Edges of the bf16 tensor-core kernels (dq: 64-row CTAs, 64-key tiles;
    # dkv: 64-key CTAs, Q tiles of 64 rows at d = 64 and 32 at d = 128).
    (2, 3, 63, 63, 63, 64, True),       # one row short of a 64 tile
    (2, 3, 65, 65, 65, 128, True),      # one row past a 64 (and a 32) tile
    (2, 3, 96, 200, 130, 128, False),   # last key tile ragged inside the buffer
    (2, 3, 100, 200, 200, 64, True),    # causal with fewer rows than keys
    (2, 3, 65, 65, 0, 128, True),       # kv_len = 0 at d = 128
    (4, 9, 130, 130, 130, 128, True),   # GQA 36 over 4 (starcoder2-7b)
    (4, 1, 100, 100, 100, 64, True),    # MHA (minicpm-2b)
])
def test_flash_backward_kernels_match_plain(cuda, dtype, hkv, q_per_kv, n, nk, kv_len, d, causal):
    bhq = hkv * q_per_kv
    q, k, v = _randn((bhq, n, d), dtype, 10), _randn((hkv, nk, d), dtype, 11), _randn((hkv, nk, d), dtype, 12)
    do = _randn((bhq, n, d), dtype, 13)
    kw = dict(q_per_kv=q_per_kv, scale=d ** -0.5, causal=causal, kv_len=kv_len)
    o, lse = fk.flash_attention_kernel_call(q, k, v, return_lse=True, **kw)
    before = dict(bwd.launches)
    delta = bwd.delta_kernel_call(o, do)
    _bwd_close(delta, bwd.delta_plain(o, do))
    dq = bwd.flash_dq_kernel_call(q, k, v, do, lse, delta, **kw)
    _bwd_close(dq, bwd.flash_dq_plain(q, k, v, do, lse, delta, **kw))
    got = bwd.flash_dkv_kernel_call(q, k, v, do, lse, delta, **kw)
    for g_, w_ in zip(got, bwd.flash_dkv_plain(q, k, v, do, lse, delta, **kw)):
        _bwd_close(g_, w_)
    if kv_len == 0:
        for g_ in (dq, *got):
            assert torch.equal(g_, torch.zeros_like(g_))
    assert {k_: bwd.launches[k_] - before[k_] for k_ in before} == {
        "delta": 1, "flash_dq": 1, "flash_dkv": 1, "distr_dq": 0, "distr_dkv": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,g,block_q,causal,d", [
    (128, 2, 64, True, 128), (256, 4, 128, False, 128), (256, 2, 128, True, 64),
    (192, 4, 64, True, 64),  # d/G* = 16: half a thread row of score columns
    # The bf16 tensor-core kernels (Q̂ expanded to Q̃, the flash walks, dQ̂ by
    # a gather-sum of G* columns): G* up to 16, d/G* down to 4.
    (128, 8, 64, False, 64),
    (128, 16, 64, True, 64),
    (192, 16, 64, False, 128),
    (256, 8, 128, True, 128),  # one block_q spans four 32-row dkv Q tiles; kv_len ragged
])
def test_distr_backward_kernels_match_plain(cuda, dtype, n, g, block_q, causal, d):
    q_hat = _randn((4, n, d // g), dtype, 14)
    k, v = _randn((2, n - 7, d), dtype, 15), _randn((2, n - 7, d), dtype, 16)
    do = _randn((4, n, d), dtype, 17)
    perm = _perms(4, n, block_q, d)
    kw = dict(q_per_kv=2, causal=causal, group_size=g, block_q=block_q, kv_len=n - 7)
    o, lse = dk.distr_attention_kernel_call(q_hat, k, v, perm, return_lse=True, **kw)
    delta = bwd.delta_kernel_call(o, do)
    _bwd_close(bwd.distr_dq_kernel_call(q_hat, k, v, perm, do, lse, delta, **kw),
               bwd.distr_dq_plain(q_hat, k, v, perm, do, lse, delta, **kw))
    got = bwd.distr_dkv_kernel_call(q_hat, k, v, perm, do, lse, delta, **kw)
    for g_, w_ in zip(got, bwd.distr_dkv_plain(q_hat, k, v, perm, do, lse, delta, **kw)):
        _bwd_close(g_, w_)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_distr_backward_launches_its_dtype_route(cuda, dtype):
    """A bf16 call runs the expansion and the tensor-core instantiations
    (``distr_bwd_tc.cuh``) and never the FMA tile; an f32 call runs the FMA
    tile only.  Kernel names from the profiler's device events."""
    from torch.profiler import ProfilerActivity, profile

    n, d, g = 128, 64, 2
    q_hat = _randn((2, n, d // g), dtype, 40)
    k, v, do = (_randn((2, n, d), dtype, 41 + i) for i in range(3))
    lse = torch.full((2, n), 5.0, device="cuda")
    delta = torch.zeros((2, n), device="cuda")
    kw = dict(q_per_kv=1, causal=True, group_size=g, block_q=64, kv_len=n)
    perm = _perms(2, n, 64, d)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bwd.distr_dq_kernel_call(q_hat, k, v, perm, do, lse, delta, **kw)
        bwd.distr_dkv_kernel_call(q_hat, k, v, perm, do, lse, delta, **kw)
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages())
    tc = ("distr_expand_q_kernel", "distr_bwd_dq_mma_kernel", "distr_bwd_dkv_mma_kernel")
    fma = ("attn_bwd_dq_kernel", "attn_bwd_dkv_kernel")
    want, never = (tc, fma) if dtype == torch.bfloat16 else (fma, tc)
    assert all(name in names for name in want), names
    assert not any(name in names for name in never), names
    assert "attn_bwd_dq_mma_kernel" not in names and "attn_bwd_dkv_mma_kernel" not in names


@pytest.mark.parametrize("call", [bwd.distr_dq_kernel_call, bwd.distr_dkv_kernel_call])
def test_distr_backward_rejects_group_size_one(cuda, call):
    """The backward kernels hold at most d/2 score columns per row."""
    n, d = 64, 64
    q_hat, k, v, do = (_randn(s, torch.float32, 30 + i) for i, s in
                       enumerate([(2, n, d), (2, n, d), (2, n, d), (2, n, d)]))
    lse = delta = torch.zeros((2, n), device="cuda")
    before = dict(bwd.launches)
    with pytest.raises(ValueError, match="G\\* >= 2"):
        call(q_hat, k, v, _perms(2, n, 64, d), do, lse, delta, q_per_kv=1, causal=True,
             group_size=1, block_q=64, kv_len=n)
    assert bwd.launches == before


@pytest.mark.parametrize("impl,dtype", [("flash", torch.float32), ("distr", torch.float32),
                                        ("flash", torch.bfloat16)])
def test_op_gradients_on_card_match_cpu(cuda, impl, dtype):
    """The autograd ops on CUDA tensors (kernels) against the same ops on
    CPU tensors (plain versions), GQA 4 over 2, ragged N = 100: f32 at
    ``BWD_TOL``, and bf16 (the tensor-core forward and backward) at the
    bf16 tolerance, since both sides round O and the gradients to bf16."""
    b, hq, hkv, n, d = 2, 4, 2, 100, 64
    cfg = DistrConfig(group_size=2, block_q=64)
    fn = ((lambda q, k, v: ops.flash_attention(q, k, v, causal=True)) if impl == "flash" else
          (lambda q, k, v: ops.distr_attention(q, k, v, cfg, causal=True)))
    ins = [_randn(s, dtype, 20 + i)
           for i, s in enumerate([(b, hq, n, d), (b, hkv, n, d), (b, hkv, n, d)])]
    w = torch.cos(torch.arange(d, dtype=torch.float32)).to(dtype)
    grads = {}
    before = dict(bwd.launches)
    for dev in ("cuda", "cpu"):
        xs = [x.detach().to(dev).requires_grad_(True) for x in ins]
        (fn(*xs) * w.to(dev)).sum().backward()
        grads[dev] = [x.grad for x in xs]
    assert bwd.launches[f"{impl}_dq"] == before[f"{impl}_dq"] + 1
    assert bwd.launches[f"{impl}_dkv"] == before[f"{impl}_dkv"] + 1
    tol = BWD_TOL if dtype == torch.float32 else TOL[torch.bfloat16]
    for g_cuda, g_cpu in zip(grads["cuda"], grads["cpu"]):
        assert g_cuda.dtype == dtype
        torch.testing.assert_close(g_cuda.cpu().float(), g_cpu.float(), atol=tol, rtol=tol)


# (rows, q_len, d_score, d, block_k).  The bf16 tile takes keys in tiles of
# 64 and rows in m-tiles of 16: one m-tile (keys over 4 warps), two (2 warps
# each), a split of 100 or 200 keys (a ragged tile; three or four tiles
# stream through its 2-stage ring), and d_score 56 against d = 112 (a half
# k-step padded with zero columns).
DECODE_KERNEL_CASES = [
    (9, 1, 128, 128, 128), (32, 2, 64, 128, 64), (1, 1, 64, 128, 128),
    (1, 1, 56, 112, 128), (9, 1, 128, 128, 100), (18, 2, 56, 112, 200), (16, 1, 64, 64, 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,q_len,ds,d,block_k", DECODE_KERNEL_CASES)
def test_decode_kernel_matches_plain(cuda, dtype, rows, q_len, ds, d, block_k):
    b, hkv, s = 3, 2, 300
    q = _randn((b, hkv, rows, ds), dtype, 6)
    k, v = _randn((b, hkv, s, ds), dtype, 7), _randn((b, hkv, s, d), dtype, 8)
    lengths = torch.tensor([0, 1, 300], dtype=torch.int32, device="cuda")
    kw = dict(scale=d ** -0.5, block_k=block_k, q_len=q_len)
    got = dec.decode_kernel_call(q, k, v, lengths, **kw)
    want = dec.decode_plain(q, k, v, lengths, **kw)
    _close(dec.merge_splits(*got), dec.merge_splits(*want), dtype)
    assert bool((got[1][0] == -1e30).all()) and bool((got[2][0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,q_len,ds,d,block_k", [(9, 1, 128, 128, 128), (32, 2, 56, 112, 100)])
def test_decode_kernel_ignores_cache_past_lengths(cuda, dtype, rows, q_len, ds, d, block_k):
    """NaN in every cache position at or past a slot's length, inside live
    splits too: the partials must equal the plain version's over a cache
    whose tail is zero (a tensor-core P·V reads whole key tiles, and
    0 · NaN = NaN)."""
    b, hkv, s = 3, 2, 300
    q = _randn((b, hkv, rows, ds), dtype, 9)
    k, v = _randn((b, hkv, s, ds), dtype, 10), _randn((b, hkv, s, d), dtype, 11)
    lengths = torch.tensor([5, 170, 299], dtype=torch.int32, device="cuda")
    tail = (torch.arange(s, device="cuda")[None, :] >= lengths[:, None])[:, None, :, None]
    kw = dict(scale=d ** -0.5, block_k=block_k, q_len=q_len)
    want = dec.decode_plain(q, k.masked_fill(tail, 0), v.masked_fill(tail, 0), lengths, **kw)
    got = dec.decode_kernel_call(q, k.masked_fill(tail, float("nan")),
                                 v.masked_fill(tail, float("nan")), lengths, **kw)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert torch.isfinite(g_).all()
        torch.testing.assert_close(g_, w_, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,q_len,ds,d,bs", [
    (9, 1, 128, 128, 16),     # a decode tick at starcoder2-7b's packing
    (72, 8, 64, 128, 16),     # a fused-K̂ chunk: three row tiles
    (40, 4, 64, 64, 16),      # a ragged last row tile, d = 64
    (288, 32, 128, 128, 128),  # a 32-token chunk at the serving block size
    (9, 1, 112, 112, 16),     # head dim 112 (zamba2-7b's)
    (72, 8, 56, 112, 100),    # d = 112, fused K̂ (56), a ragged key tile
    (72, 8, 64, 128, 160),    # blocks of three key tiles: the ring streams
    (24, 2, 128, 128, 16),    # two m-tiles
])
def test_paged_decode_kernel_matches_plain(cuda, dtype, rows, q_len, ds, d, bs):
    """Request 0 has length 0 (every block dead), request 1 ends mid-block
    with garbage entries past it, request 2 overhangs the table by 6; block 0
    (the garbage block) and the slots past request 1's last live key hold
    NaN and must never reach the output."""
    b, hkv, mb = 3, 2, 5
    p = 1 + b * mb
    q = _randn((b, hkv, rows, ds), dtype, 40)
    k_pool, v_pool = _randn((p, hkv, bs, ds), dtype, 41), _randn((p, hkv, bs, d), dtype, 42)
    k_pool[0], v_pool[0] = float("nan"), float("nan")
    g = torch.Generator(device="cuda").manual_seed(43)
    bt = (torch.randperm(p - 1, generator=g, device="cuda") + 1).reshape(b, mb).to(torch.int32)
    length_1 = 2 * bs + 5
    bt[0] = pd.GARBAGE_BLOCK
    bt[1, 3:] = pd.GARBAGE_BLOCK
    k_pool[bt[1, 2].long(), :, 5:] = float("nan")  # request 1's live block past its 5 keys
    v_pool[bt[1, 2].long(), :, 5:] = float("nan")
    lengths = torch.tensor([0, length_1, mb * bs + 6], dtype=torch.int32, device="cuda")
    kw = dict(scale=d ** -0.5, q_len=q_len)
    before = pd.launches
    got = pd.paged_decode_kernel_call(q, k_pool, v_pool, bt, lengths, **kw)
    assert pd.launches == before + 1
    want = pd.paged_decode_plain(q, k_pool, v_pool, bt, lengths, **kw)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32 and torch.isfinite(g_).all()
        torch.testing.assert_close(g_, w_, atol=1e-4, rtol=1e-4)
    o, m, l = got
    for dead in (o[0], o[1, :, 3:]):
        assert bool((dead == 0).all())
    for dead in (m[0], m[1, :, 3:]):
        assert bool((dead == -1e30).all())
    for dead in (l[0], l[1, :, 3:]):
        assert bool((dead == 0).all())


def test_paged_decode_kernel_rejects_mixed_dtypes(cuda):
    q = _randn((1, 2, 9, 128), torch.float32, 44)
    pool = _randn((3, 2, 16, 128), torch.bfloat16, 45)
    bt = torch.tensor([[1, 2]], dtype=torch.int32, device="cuda")
    lengths = torch.tensor([20], dtype=torch.int32, device="cuda")
    before = pd.launches
    with pytest.raises(TypeError, match="one dtype"):
        pd.paged_decode_kernel_call(q, pool, pool, bt, lengths, scale=0.1, q_len=1)
    assert pd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["flash", "distr"])
def test_forward_kernels_at_head_dim_112(cuda, dtype, impl):
    """zamba2-7b's head: d = 112 (a float4 chunk past the last 32 columns),
    the distr score width 56, a ragged kv_len below the buffer."""
    d, n, kv_len = 112, 192, 150
    q, k, v = _randn((4, n, d), dtype, 50), _randn((2, n, d), dtype, 51), _randn((2, n, d), dtype, 52)
    if impl == "flash":
        kw = dict(q_per_kv=2, scale=d ** -0.5, causal=True, kv_len=kv_len, return_lse=True)
        o, lse = fk.flash_attention_kernel_call(q, k, v, **kw)
        o_p, lse_p = fk.flash_attention_plain(q, k, v, **kw)
    else:
        perm = _perms(4, n, 64, d)
        q_hat = _randn((4, n, d // 2), dtype, 53)
        kw = dict(q_per_kv=2, causal=False, group_size=2, block_q=64, kv_len=kv_len,
                  return_lse=True)
        o, lse = dk.distr_attention_kernel_call(q_hat, k, v, perm, **kw)
        o_p, lse_p = dk.distr_attention_plain(q_hat, k, v, perm, **kw)
    _close(o, o_p, dtype)
    torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_head_dim_112(cuda, dtype):
    b, hkv, s, d = 3, 2, 300, 112
    q = _randn((b, hkv, 1, d), dtype, 54)
    k, v = _randn((b, hkv, s, d), dtype, 55), _randn((b, hkv, s, d), dtype, 56)
    lengths = torch.tensor([1, 137, 300], dtype=torch.int32, device="cuda")
    kw = dict(scale=d ** -0.5, block_k=128, q_len=1)
    got = dec.decode_kernel_call(q, k, v, lengths, **kw)
    want = dec.decode_plain(q, k, v, lengths, **kw)
    for g_, w_ in zip(got, want):
        torch.cuda.synchronize()
        assert torch.isfinite(g_).all()
        torch.testing.assert_close(g_, w_, atol=1e-4, rtol=1e-4)


SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


def _ssd_inputs(bh, bg, n, p, s, dtype, seed, decay=1.0):
    x = _randn((bh, n, p), dtype, seed)
    a = -torch.nn.functional.softplus(_randn((bh, n), torch.float32, seed + 1)) * decay
    return x, a, _randn((bg, n, s), dtype, seed + 2), _randn((bg, n, s), dtype, seed + 3)


def _ssd_close(got, want, dtype):
    """y at its dtype's tolerance, the f32 state at 1e-3."""
    torch.cuda.synchronize()
    (y, state), (y_p, state_p) = got, want
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), y_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, state_p, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,bg,n,p,s,chunk,decay", [
    (2, 2, 1, 16, 8, 32, 1.0),       # N = 1
    (2, 2, 20, 16, 8, 32, 1.0),      # N < chunk
    (4, 2, 200, 32, 16, 64, 1.0),    # ragged tail, G > 1 with 2 heads a group
    (3, 1, 300, 64, 64, 128, 1.0),   # zamba2's widths, 3 heads on one group
    (2, 1, 260, 64, 128, 128, 1.0),  # mamba2-130m's S = 128 (score rows in bands of 32)
    (2, 2, 256, 16, 8, 128, 300.0),  # strong decays: exp overflows above the diagonal
    # Edges of the bf16 tensor-core kernel (16-row blocks, S padded to 64).
    (2, 1, 300, 20, 12, 36, 1.0),    # 8-byte copies; chunk padded to 48; a P slice past P
    (3, 3, 77, 64, 8, 100, 1.0),     # N inside the first chunk, padded to 112 rows
    (2, 2, 129, 16, 128, 128, 1.0),  # one live step in the last chunk; S = 128
])
def test_ssd_kernel_matches_plain(cuda, dtype, bh, bg, n, p, s, chunk, decay):
    x, a, b, c = _ssd_inputs(bh, bg, n, p, s, dtype, 60, decay)
    kw = dict(heads_per_group=bh // bg, chunk=chunk, return_state=True)
    before = ssd_kernels.launches
    got = ssd_kernels.ssd_kernel_call(x, a, b, c, **kw)
    assert ssd_kernels.launches == before + 1
    _ssd_close(got, ssd_kernels.ssd_plain(x, a, b, c, **kw), dtype)


def _ssd_kernel_names(call):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return " ".join(e.key for e in prof.key_averages())


@pytest.mark.parametrize("width", [16, 32])
def test_ssd_tc_kernel_at_each_slice_width(cuda, width):
    """The bf16 kernel takes a slice of P per CTA: 32 columns where that
    grid covers the card's SMs, else 16.  P = 64 over as many heads as give
    each width, N = 300 so the last chunk of 128 holds 44 steps.  The
    profiler names the width."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bh = {32: -(-sms // 2), 16: 2}[width]
    x, a, b, c = _ssd_inputs(bh, 1, 300, 64, 64, torch.bfloat16, 80)
    kw = dict(heads_per_group=bh, chunk=128, return_state=True)
    got = []
    names = _ssd_kernel_names(lambda: got.append(ssd_kernels.ssd_kernel_call(x, a, b, c, **kw)))
    assert f"ssd_mma_kernel<{width}," in names, names
    _ssd_close(got[0], ssd_kernels.ssd_plain(x, a, b, c, **kw), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_launches_its_dtype_route(cuda, dtype):
    """bf16 runs the tensor-core kernel (``ssd_tc.cuh``) and never the FMA
    kernel ``ssd_kernel``; f32 runs the FMA kernel only.  Kernel names
    from the profiler's device events."""
    x, a, b, c = _ssd_inputs(2, 1, 200, 64, 64, dtype, 82)
    names = _ssd_kernel_names(lambda: ssd_kernels.ssd_kernel_call(
        x, a, b, c, heads_per_group=2, chunk=128, return_state=True))
    tc, fma = "ssd_mma_kernel", "ssd_kernel<"
    want, never = (tc, fma) if dtype == torch.bfloat16 else (fma, tc)
    assert want in names and never not in names, names


def test_ssd_op_on_card_matches_cpu(cuda):
    """``ops.ssd`` in its (B, N, H, P) layout: the kernel on the card against
    the plain version on the CPU, f32, with the state."""
    bsz, n, h, p, g, s = 2, 150, 4, 32, 2, 16
    ins = [_randn(shape, torch.float32, 70 + i) for i, shape in
           enumerate([(bsz, n, h, p), (bsz, n, h), (bsz, n, g, s), (bsz, n, g, s)])]
    ins[1] = -torch.nn.functional.softplus(ins[1])
    y, state = ops.ssd(*ins, chunk=64, return_state=True)
    y_c, state_c = ops.ssd(*(t.cpu() for t in ins), chunk=64, return_state=True)
    torch.testing.assert_close(y.cpu(), y_c, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(state.cpu(), state_c, atol=1e-3, rtol=1e-3)


def _grads_close(got, want, tol):
    """Element-wise within ``tol`` of the element plus ``tol`` of the
    tensor's largest |element| (at least 1): the gradients sum over the
    sequence, so an element that cancels keeps the rounding of its sum."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.isfinite(g.float()).all()
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(g.float(), w.float(), atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_grads_on_card_match_plain_autograd(cuda, dtype):
    """``ops.ssd`` with a gradient on the card: the kernel forward (one
    launch, none in the backward) and the chunked backward, against
    autograd through the plain version ``ssd_plain`` on the same card, with
    the state's gradient, a ragged tail and two heads a group."""
    bsz, n, h, p, g, s, chunk = 2, 150, 4, 32, 2, 16, 64
    ins = [_randn(shape, dt, 90 + i) for i, (shape, dt) in enumerate(
        [((bsz, n, h, p), dtype), ((bsz, n, h), torch.float32), ((bsz, n, g, s), dtype),
         ((bsz, n, g, s), dtype)])]
    ins[1] = -torch.nn.functional.softplus(ins[1])
    wy, ws = _randn((bsz, n, h, p), torch.float32, 95), _randn((bsz, h, s, p), torch.float32, 96)

    def plain(x, a, b, c):
        y, state = ssd_kernels.ssd_plain(
            x.transpose(1, 2).reshape(bsz * h, n, p), a.transpose(1, 2).reshape(bsz * h, n),
            b.transpose(1, 2).reshape(bsz * g, n, s), c.transpose(1, 2).reshape(bsz * g, n, s),
            heads_per_group=h // g, chunk=chunk, return_state=True)
        return y.reshape(bsz, h, n, p).transpose(1, 2), state.reshape(bsz, h, s, p)

    grads = {}
    for name, fn in (("op", lambda *t: ops.ssd(*t, chunk=chunk, return_state=True)),
                     ("plain", plain)):
        xs = [t.detach().clone().requires_grad_(True) for t in ins]
        before = ssd_kernels.launches
        y, state = fn(*xs)
        assert ssd_kernels.launches == before + (name == "op")
        ((y.float() * wy).sum() + (state * ws).sum()).backward()
        assert ssd_kernels.launches == before + (name == "op")
        grads[name] = [t.grad for t in xs]
    _grads_close(grads["op"], grads["plain"], TOL[dtype])


def test_hybrid_train_step_on_card_matches_cpu(cuda):
    """One train step of zamba2-7b ``reduced()`` at head dim 64 and Q
    blocks of 64 (the kernels' range) under ``pallas_distr``, f32: the SSD
    Function and the DistrAttention forward and backward kernels in one
    step, its loss and grad norm against the same step on the CPU's plain
    versions, and every parameter's gradient at ``BWD_TOL``.  (Not the
    parameters after the update: AdamW's first step moves each by ±lr
    with its gradient's sign, which rounding flips where a gradient is
    near 0.)"""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = get_config("zamba2-7b", reduced=True).replace(head_dim=64)
    # The DistrAttention kernel takes Q blocks of a multiple of 64 rows.
    cfg = cfg.replace(attention=replace(cfg.attention, impl="pallas_distr",
                                        distr=replace(cfg.attention.distr, block_q=64)))
    base = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    ocfg = opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=2)
    toks = torch.randint(0, cfg.vocab, (2, 201), generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cuda", "cpu"):
        params = {k: _tree_to(v, dev) for k, v in base.items()}
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        leaves = [p.requires_grad_(True) for p in lm.trainable(params)]
        grads = torch.autograd.grad(lm.loss_fn(params, cfg, batch)[0], leaves)
        state = opt.adamw_init(leaves)
        before = (ssd_kernels.launches, dk.launches, dict(bwd.launches))
        _, _, metrics = make_train_step(cfg, ocfg)(params, state, batch, 1)
        counts = (ssd_kernels.launches - before[0], dk.launches - before[1],
                  {k: bwd.launches[k] - before[2][k] for k in bwd.launches})
        out[dev] = ([g.cpu() for g in grads], metrics, counts)
    (grads, metrics, counts), (grads_c, metrics_c, counts_c) = out["cuda"], out["cpu"]
    n_groups, n_tail = lm.hybrid_layout(cfg)
    # Full remat: each Mamba layer's forward runs again in the backward.
    assert counts[0] == 2 * cfg.n_layers and counts[1] == n_groups
    assert counts[2]["distr_dq"] == counts[2]["distr_dkv"] == n_groups
    assert counts_c == (0, 0, dict.fromkeys(bwd.launches, 0))
    assert float(metrics["skipped"]) == 0.0
    for key in ("loss", "grad_norm"):
        assert float(metrics[key]) == pytest.approx(float(metrics_c[key]), rel=1e-4, abs=1e-4)
    _grads_close(grads, grads_c, BWD_TOL)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "deepseek-v2-236b"])
def test_moe_train_step_on_card_matches_cpu(cuda, arch):
    """One train step of each MoE config ``reduced()`` under
    ``pallas_distr``, f32, against the same step on the CPU's plain
    versions: its loss and grad norm, and every parameter's gradient at
    ``BWD_TOL`` (as the hybrid's test).  llama4-scout-17b-a16e at head dim
    64 and Q blocks of 64 (the kernels' range) runs the DistrAttention
    forward twice a layer (the forward and its full-remat recompute) and
    delta, dq and dkv once; deepseek-v2-236b's MLA runs no kernel at all,
    as in the reference."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.graphs import LaunchCounters
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(arch, reduced=True)
    if not cfg.use_mla:
        cfg = cfg.replace(head_dim=64)
    cfg = cfg.replace(attention=replace(cfg.attention, impl="pallas_distr",
                                        distr=replace(cfg.attention.distr, block_q=64)))
    base = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    ocfg = opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=2)
    toks = torch.randint(0, cfg.vocab, (2, 201), generator=torch.Generator().manual_seed(1))
    counters = LaunchCounters()
    out = {}
    for dev in ("cuda", "cpu"):
        params = {k: _tree_to(v, dev) for k, v in base.items()}
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        leaves = [p.requires_grad_(True) for p in lm.trainable(params)]
        grads = torch.autograd.grad(lm.loss_fn(params, cfg, batch)[0], leaves)
        state = opt.adamw_init(leaves)
        before = counters.read()
        _, _, metrics = make_train_step(cfg, ocfg)(params, state, batch, 1)
        after = counters.read()
        out[dev] = ([g.cpu() for g in grads], metrics,
                    {k: after[k] - before[k] for k in after})
    (grads, metrics, counts), (grads_c, metrics_c, counts_c) = out["cuda"], out["cpu"]
    want = dict.fromkeys(counts, 0)
    if not cfg.use_mla:
        n = cfg.n_layers
        want.update({"distr_attention": 2 * n, "backward.delta": n, "backward.distr_dq": n,
                     "backward.distr_dkv": n})
    assert counts == want
    assert counts_c == dict.fromkeys(counts_c, 0)
    assert float(metrics["skipped"]) == 0.0
    for key in ("loss", "grad_norm"):
        assert float(metrics[key]) == pytest.approx(float(metrics_c[key]), rel=1e-4, abs=1e-4)
    _grads_close(grads, grads_c, BWD_TOL)


def test_tuner_sweeps_the_decode_and_paged_keys_on_card(cuda, monkeypatch, tmp_path):
    """``REPRO_TUNE=measure`` with a fresh cache at starcoder2-7b's serving
    shapes (4 slots, 36 over 4 heads of 128, capacity 2048, bf16): the
    decode split, the paged pool block and DistrAttention's block_q (N =
    2048, G* = 2, causal) are swept with CUDA events, every candidate
    timed with its spread beside the static 128, the decode and paged
    sweeps over several K/V copies (their live bytes over twice the L2),
    under an ``sm_`` backend key, one ``tune/measure`` span each; a
    second tuner on the file resolves by lookup with no timing; the decode
    and paged kernels at the picks match their plain versions (1e-4, as
    the paged tests), and the DistrAttention op at its pick (f32, the FMA
    tile) the plain DistrAttention on the same card (the same
    permutations)."""
    import json

    from repro_torch.obs.trace import TraceRecorder, set_recorder
    from repro_torch.tune import (Autotuner, TuneCache, decode_candidates,
                                  paged_block_candidates)
    from repro_torch.tune.autotune import distr_candidates

    def no_timing(run_fn, cand):
        raise AssertionError("a cached key must not be timed")

    monkeypatch.setenv("REPRO_TUNE", "measure")
    path = str(tmp_path / "tune.json")
    kw = dict(d=128, n=2048, dtype="bfloat16", device=cuda, batch=4, heads=(36, 4))
    dkw = dict(d=128, n=2048, dtype="bfloat16", group_size=2, causal=True, device=cuda)
    rec = TraceRecorder()
    set_recorder(rec)
    try:
        tuner = Autotuner(cache=TuneCache(path))
        bk, bs = tuner.resolve_decode(**kw), tuner.resolve_paged_decode(**kw)
        bq = tuner.resolve_distr(**dkw)
        again = Autotuner(cache=TuneCache(path), timer=no_timing)
        assert (again.resolve_decode(**kw), again.resolve_paged_decode(**kw),
                again.resolve_distr(**dkw)) == (bk, bs, bq)
    finally:
        set_recorder(None)
    assert sum(e["name"] == "tune/measure" for e in rec.events) == 3
    entries = json.load(open(path))
    assert all("|backend=sm_" in key for key in entries)
    swept = {e["kernel"]: e for e in entries.values()}
    for kernel, cands in (("decode", decode_candidates(2048)),
                          ("paged_decode", paged_block_candidates(2048)),
                          ("distr_fwd", distr_candidates(128, n=2048, group_size=2))):
        table = swept[kernel]["table"]
        assert sorted(r["candidate"] for r in table) == sorted(cands)
        assert all(0 < r["seconds"] < 1 and 0 <= r["spread"] < 1 for r in table)
        assert swept[kernel]["default"] == 128
    assert swept["decode"]["calls"] > 1 and swept["paged_decode"]["calls"] > 1  # over L2

    lengths = torch.tensor([1, 200, 1537, 2048], dtype=torch.int32, device="cuda")
    q = _randn((4, 4, 9, 128), torch.bfloat16, 70)
    k, v = _randn((4, 4, 2048, 128), torch.bfloat16, 71), _randn((4, 4, 2048, 128),
                                                                  torch.bfloat16, 72)
    dkw2 = dict(scale=128 ** -0.5, block_k=bk, q_len=1)
    got = dec.merge_splits(*dec.decode_kernel_call(q, k, v, lengths, **dkw2))
    want = dec.merge_splits(*dec.decode_plain(q, k, v, lengths, **dkw2))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    mb = 2048 // bs
    k_pool, v_pool = (_randn((1 + 4 * mb, 4, bs, 128), torch.bfloat16, seed)
                      for seed in (73, 74))
    g = torch.Generator(device="cuda").manual_seed(75)
    bt = (torch.randperm(4 * mb, generator=g, device="cuda") + 1).reshape(4, mb).to(torch.int32)
    pkw = dict(scale=128 ** -0.5, q_len=1)
    got = dec.merge_splits(*pd.paged_decode_kernel_call(q, k_pool, v_pool, bt, lengths, **pkw))
    want = dec.merge_splits(*pd.paged_decode_plain(q, k_pool, v_pool, bt, lengths, **pkw))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    from repro_torch.core.distr_attention import distr_attention

    qd, kd, vd = (_randn(shape, torch.float32, 76 + i)
                  for i, shape in enumerate([(1, 8, 1000, 128), (1, 2, 1000, 128),
                                             (1, 2, 1000, 128)]))
    dcfg = DistrConfig(group_size=2, block_q=bq)
    before = dk.launches
    got = ops.distr_attention(qd, kd, vd, dcfg, causal=True)
    assert dk.launches == before + 1
    _close(got, distr_attention(qd, kd, vd, dcfg, causal=True), torch.float32)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev).clone()


# ---------------------------------------------------------------------------
# The enc-dec and VLM slice: non-causal kernels at Nq ≠ Nk, and whisper-small
# and internvl2-2b on the card against the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq", [33, 448, 1500])
@pytest.mark.parametrize("impl,block_q", [("flash", None), ("distr", 128), ("distr", 64)])
def test_noncausal_kernels_at_whisper_shapes_match_plain(cuda, dtype, impl, block_q, nq):
    """The forward (O and LSE) and the three backward kernels non-causal
    over 1500 keys (whisper-small's frames: the last 64-key tile ragged)
    at d = 64 and 4 heads, MHA: rows fewer than keys (cross-attention:
    33 and 448 decoder rows) and as many (the encoder).  DistrAttention
    at G* = 2 over Q̂ padded to its block, as ``ops.distr_attention``
    pads it; the pad rows' dO is 0."""
    bh, nk, d, g = 4, 1500, 64, 2
    k, v = _randn((bh, nk, d), dtype, 51), _randn((bh, nk, d), dtype, 52)
    before = dict(bwd.launches)
    if impl == "flash":
        q, do = _randn((bh, nq, d), dtype, 50), _randn((bh, nq, d), dtype, 53)
        kw = dict(q_per_kv=1, scale=d ** -0.5, causal=False, kv_len=nk)
        o, lse = fk.flash_attention_kernel_call(q, k, v, return_lse=True, **kw)
        o_p, lse_p = fk.flash_attention_plain(q, k, v, return_lse=True, **kw)
        args = (q, k, v)
        dq_call, dkv_call = bwd.flash_dq_kernel_call, bwd.flash_dkv_kernel_call
        dq_plain, dkv_plain = bwd.flash_dq_plain, bwd.flash_dkv_plain
    else:
        n_pad = -(-nq // block_q) * block_q
        q = torch.nn.functional.pad(_randn((bh, nq, d // g), dtype, 50), (0, 0, 0, n_pad - nq))
        do = torch.nn.functional.pad(_randn((bh, nq, d), dtype, 53), (0, 0, 0, n_pad - nq))
        kw = dict(q_per_kv=1, causal=False, group_size=g, block_q=block_q, kv_len=nk)
        args = (q, k, v, _perms(bh, n_pad, block_q, d))
        o, lse = dk.distr_attention_kernel_call(*args, return_lse=True, **kw)
        o_p, lse_p = dk.distr_attention_plain(*args, return_lse=True, **kw)
        dq_call, dkv_call = bwd.distr_dq_kernel_call, bwd.distr_dkv_kernel_call
        dq_plain, dkv_plain = bwd.distr_dq_plain, bwd.distr_dkv_plain
    _close(o, o_p, dtype)
    torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=1e-3)
    delta = bwd.delta_kernel_call(o, do)
    _bwd_close(delta, bwd.delta_plain(o, do))
    _bwd_close(dq_call(*args, do, lse, delta, **kw), dq_plain(*args, do, lse, delta, **kw))
    got = dkv_call(*args, do, lse, delta, **kw)
    for g_, w_ in zip(got, dkv_plain(*args, do, lse, delta, **kw)):
        _bwd_close(g_, w_)
    assert {k_: bwd.launches[k_] - before[k_] for k_ in ("delta", f"{impl}_dq", f"{impl}_dkv")} \
        == {"delta": 1, f"{impl}_dq": 1, f"{impl}_dkv": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,rows,d,s,lengths", [
    pytest.param(12, 1, 64, 1500, (1500, 77, 1437, 1500), id="encdec-cross-1500"),
    pytest.param(12, 1, 64, 128, (5, 18, 41, 65), id="encdec-self"),
    pytest.param(8, 2, 128, 2048, (353, 457, 774, 1257), id="vlm-16-over-8"),
])
def test_encdec_vlm_decode_kernel_at_serving_shapes_matches_plain(cuda, dtype, hkv, rows, d,
                                                                  s, lengths):
    """The split-K decode kernel at the shapes the enc-dec and VLM decode
    steps give it: whisper-small's 1500-position cross cache (12 splits of
    128, the last 92 keys ragged; lengths cross_len and two ragged ones)
    and its self cache, one row a KV head at d = 64, and internvl2-2b's 2
    rows a KV head at d = 128.  NaN in every cache position at or past a
    slot's length: the partials must equal the plain version's over a zero
    tail."""
    b = len(lengths)
    q = _randn((b, hkv, rows, d), dtype, 57)
    k, v = _randn((b, hkv, s, d), dtype, 58), _randn((b, hkv, s, d), dtype, 59)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    tail = (torch.arange(s, device="cuda")[None, :] >= lens[:, None])[:, None, :, None]
    kw = dict(scale=d ** -0.5, block_k=min(128, s), q_len=1)
    before = dec.launches
    got = dec.decode_kernel_call(q, k.masked_fill(tail, float("nan")),
                                 v.masked_fill(tail, float("nan")), lens, **kw)
    want = dec.decode_plain(q, k.masked_fill(tail, 0), v.masked_fill(tail, 0), lens, **kw)
    torch.cuda.synchronize()
    assert dec.launches - before == 1
    for g_, w_ in zip(got, want):
        assert torch.isfinite(g_).all()
        torch.testing.assert_close(g_, w_, atol=1e-4, rtol=1e-4)


def _card_config(arch: str, impl: str):
    """``arch``'s ``reduced()`` at head dim 64 (the kernels' range) and Q
    blocks of 64 (the DistrAttention kernel's multiple), under ``impl``."""
    from dataclasses import replace

    from repro_torch.configs import get_config

    cfg = get_config(arch, reduced=True).replace(head_dim=64)
    return cfg.replace(attention=replace(cfg.attention, impl=impl,
                                         distr=replace(cfg.attention.distr, block_q=64)))


def _frontend(cfg, b: int, n: int):
    """The stub frontend's batch entry: (key, (b, n, d_model) f32 on the CPU)."""
    key = "frames" if cfg.family == "encdec" else "patches"
    return key, torch.randn((b, n, cfg.d_model), generator=torch.Generator().manual_seed(2))


ENCDEC_VLM = [pytest.param("whisper-small", id="encdec-whisper-small"),
              pytest.param("internvl2-2b", id="vlm-internvl2-2b")]


@pytest.mark.parametrize("impl", ["pallas_distr", "pallas_flash"])
@pytest.mark.parametrize("arch", ENCDEC_VLM)
def test_encdec_vlm_train_step_on_card_matches_cpu(cuda, arch, impl):
    """One train step of whisper-small (100 frames: the encoder's and the
    cross-attention's key tile ragged, 40 tokens) and internvl2-2b (16
    patches before 40 tokens) ``reduced()`` at head dim 64, f32: the
    forward and backward kernels of every attention (whisper: encoder,
    decoder self- and cross-attention), the loss and grad norm against the
    same step on the CPU's plain versions, every gradient at ``BWD_TOL``."""
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = _card_config(arch, impl)
    base = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    ocfg = opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=2)
    toks = torch.randint(0, cfg.vocab, (2, 41), generator=torch.Generator().manual_seed(1))
    key, emb = _frontend(cfg, 2, 100 if cfg.family == "encdec" else cfg.num_patch_tokens)
    kernel = impl.split("_")[1]
    out = {}
    for dev in ("cuda", "cpu"):
        params = {k: _tree_to(v, dev) for k, v in base.items()}
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev),
                 key: emb.to(dev)}
        leaves = [p.requires_grad_(True) for p in lm.trainable(params)]
        grads = torch.autograd.grad(lm.loss_fn(params, cfg, batch)[0], leaves)
        before = dict(bwd.launches)
        _, _, metrics = make_train_step(cfg, ocfg)(params, opt.adamw_init(leaves), batch, 1)
        counts = {k: bwd.launches[k] - before[k] for k in bwd.launches}
        out[dev] = ([g.cpu() for g in grads], metrics, counts)
    (grads, metrics, counts), (grads_c, metrics_c, counts_c) = out["cuda"], out["cpu"]
    calls = 3 * cfg.n_layers if cfg.family == "encdec" else cfg.n_layers
    assert counts["delta"] == counts[f"{kernel}_dq"] == counts[f"{kernel}_dkv"] == calls
    assert counts_c == dict.fromkeys(bwd.launches, 0)
    assert float(metrics["skipped"]) == 0.0
    for name in ("loss", "grad_norm"):
        assert float(metrics[name]) == pytest.approx(float(metrics_c[name]), rel=1e-4, abs=1e-4)
    _grads_close(grads, grads_c, BWD_TOL)


@pytest.mark.parametrize("impl", ["pallas_distr", "pallas_flash"])
@pytest.mark.parametrize("arch", ENCDEC_VLM)
def test_encdec_vlm_prefill_and_decode_on_card_match_cpu(cuda, arch, impl):
    """``make_prefill`` with frames (100: the cross cache cut to cross_len
    64) or 16 patches, then 4 greedy ``make_decode_step`` steps, on the
    card (forward kernels in the prefill, the decode kernel over the self
    cache and, for whisper, the cross cache) against the CPU, f32: logits
    at 1e-4 and the same tokens."""
    from repro_torch.models import lm
    from repro_torch.serve.serve_step import make_decode_step, make_prefill

    cfg = _card_config(arch, impl).replace(compute_dtype="float32")
    base = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(3))
    key, emb = _frontend(cfg, 2, 100 if cfg.family == "encdec" else cfg.num_patch_tokens)
    start = 24 + (0 if cfg.family == "encdec" else cfg.num_patch_tokens)
    runs = {}
    for dev in ("cuda", "cpu"):
        params = {k: _tree_to(v, dev) for k, v in base.items()}
        before = (dec.launches, fk.launches + dk.launches)
        logits, cache = make_prefill(cfg, 64)(params, toks.to(dev), **{key: emb.to(dev)})
        seen = [logits[:, -1].cpu()]
        nxt = logits[:, -1].argmax(-1)[:, None]
        step = make_decode_step(cfg)
        for i in range(4):
            pos = torch.full((2,), start + i, dtype=torch.int32, device=dev)
            logits, cache = step(params, nxt, cache, pos)
            seen.append(logits[:, -1].cpu())
            nxt = logits[:, -1].argmax(-1)[:, None]
        runs[dev] = (seen, (dec.launches - before[0], fk.launches + dk.launches - before[1]))
    (got, counts), (want, counts_c) = runs["cuda"], runs["cpu"]
    per_layer = 2 if cfg.family == "encdec" else 1
    assert counts == (4 * per_layer * cfg.n_layers,
                      (3 if cfg.family == "encdec" else 1) * cfg.n_layers)
    assert counts_c == (0, 0)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=1e-4, rtol=1e-4)
        assert torch.equal(g_.argmax(-1), w_.argmax(-1))


# ---------------------------------------------------------------------------
# Serving steps as CUDA graphs (serve/graphs.py) against eager steps
# ---------------------------------------------------------------------------


def _served_both_ways(make_engine, graphs: tuple, prompts, max_new):
    """Serve ``prompts`` on one engine through its StepGraphs and on an
    identical one whose step functions run eagerly → (tokens, launch-count
    advance, the graphed engine) of each way."""
    from repro_torch.serve.graphs import LaunchCounters

    counters = LaunchCounters()
    out = {}
    for mode in ("eager", "graph"):
        eng = make_engine()
        if mode == "eager":
            for name in graphs:
                setattr(eng, name, getattr(eng, name).fn)
        before = counters.read()
        for p in prompts:
            eng.add_request(p, max_new_tokens=max_new)
        done = eng.run_to_completion(max_steps=500)
        torch.cuda.synchronize()
        after = counters.read()
        assert all(r.status == "done" for r in done), [r.status for r in done]
        out[mode] = ({r.uid: r.generated for r in done},
                     {k: after[k] - before[k] for k in after}, eng)
    return out


def _graph_config(arch: str):
    from repro_torch.configs import get_config

    cfg = get_config(arch, reduced=True)
    # The card's attention kernels take head dims 64, 112 and 128.
    return cfg if cfg.family == "ssm" else cfg.replace(head_dim=64)


@pytest.mark.parametrize("arch,fused", [
    pytest.param("starcoder2-7b", False, id="starcoder2-7b"),
    pytest.param("starcoder2-7b", True, id="starcoder2-7b-fused_k"),
    pytest.param("mamba2-130m", False, id="mamba2-130m"),
    pytest.param("zamba2-7b", False, id="zamba2-7b"),
    pytest.param("internvl2-2b", False, id="vlm-internvl2-2b"),
])
def test_slot_decode_graph_replay_matches_eager_steps(cuda, arch, fused):
    """The slot decode step as a graph, for each family and over the
    fused-K̂ cache (G* = 2: the decode kernel at score width 32)."""
    from dataclasses import replace

    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    cfg = _graph_config(arch)
    if fused:  # the config's plain distr prefill; decode runs the kernel
        cfg = cfg.replace(attention=replace(cfg.attention, distr_decode=True))
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12], [13] * 40]
    out = _served_both_ways(
        lambda: ServeEngine(cfg, params, max_slots=2, max_len=64, device="cuda"),
        ("_decode",), prompts, 6)
    (eager_tokens, eager_counts, _), (tokens, counts, eng) = out["eager"], out["graph"]
    assert tokens == eager_tokens
    assert counts == eager_counts
    if cfg.family != "ssm":
        assert counts["decode"] > 0
    assert len(eng._decode._captured) == 1  # the decode step ran as a graph
    assert ("k_fused" in eng.cache) == fused


@pytest.mark.parametrize("kind", ["slot", "paged"])
@pytest.mark.parametrize("point", ["nan_logits", "stuck_step"])
def test_faults_under_graph_replay_leave_the_others_tokens(cuda, kind, point):
    """A NaN row poisoned out of place after a replay, or a decode step
    that raises before its replay: uid 1 fails alone, and the other
    requests' tokens equal a fault-free run's."""
    from dataclasses import replace

    from repro_torch.faults import FaultInjector, FaultSpec
    from repro_torch.models import lm
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine

    cfg = _graph_config("starcoder2-7b")
    cfg = cfg.replace(attention=replace(cfg.attention, impl="pallas_flash"))
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12]]
    runs = {}
    for mode in ("clean", "fault"):
        # uid 1's third hit is its second decode step on either engine.
        specs = [FaultSpec(point, uid=1, after=2, times=-1)] if mode == "fault" else []
        kw = dict(max_len=64, device="cuda", faults=FaultInjector(specs))
        eng = (ServeEngine(cfg, params, max_slots=3, **kw) if kind == "slot" else
               PagedServeEngine(cfg, params, max_batch=3, block_size=16, prefill_chunk=8,
                                cache_dtype=torch.float32, **kw))
        for p in prompts:
            eng.add_request(p, max_new_tokens=8)
        done = eng.run_to_completion(max_steps=200)
        runs[mode] = ({r.uid: (r.status, r.generated) for r in done}, eng)
    (clean, _), (got, eng) = runs["clean"], runs["fault"]
    assert got[1][0] == "failed" and 0 < len(got[1][1]) < 8
    assert got[0] == clean[0] and got[2] == clean[2]
    assert {s for s, _ in clean.values()} == {"done"}
    counters = {k: v for k, v in eng.counters_snapshot().items() if v}
    assert counters == ({"failed_numeric": 1} if point == "nan_logits"
                        else {"failed_fault": 1, "step_retries": 3})
    assert len(eng._decode._captured) == 1


@pytest.mark.parametrize("fused", [False, True], ids=["raw_k", "fused_k"])
def test_paged_steps_graph_replay_matches_eager_steps_through_preemption(cuda, fused):
    """The decode tick and the chunk window as graphs: a 3-block pool of 16
    (two usable blocks for three lanes) preempts; tokens, preemptions and
    launch counts equal the eager steps'."""
    from dataclasses import replace

    from repro_torch.models import lm
    from repro_torch.serve.engine import PagedServeEngine

    cfg = _graph_config("starcoder2-7b")
    cfg = cfg.replace(attention=replace(cfg.attention, impl="pallas_flash", distr_decode=fused))
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = [list(range(1 + i, 4 + 2 * i)) for i in range(5)] + [[9, 9, 9]]
    out = _served_both_ways(
        lambda: PagedServeEngine(cfg, params, max_batch=3, max_len=32, block_size=16,
                                 prefill_chunk=8, num_blocks=3, cache_dtype=torch.float32,
                                 device="cuda"),
        ("_decode", "_chunk"), prompts, 16)
    (eager_tokens, eager_counts, eager_eng), (tokens, counts, eng) = out["eager"], out["graph"]
    assert tokens == eager_tokens
    assert counts == eager_counts and counts["paged_decode"] > 0
    pre = [m["n_preemptions"] for m in eng.metrics()]
    assert pre == [m["n_preemptions"] for m in eager_eng.metrics()] and sum(pre) > 0
    assert len(eng._decode._captured) == 1 and len(eng._chunk._captured) == 1
    assert eng.cache.pool.num_free == eng.cache.pool.num_blocks - 1


# ---------------------------------------------------------------------------
# The MoE family on the card: the dispatch, and its decode steps as graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "deepseek-v2-236b"])
@pytest.mark.parametrize("b,s", [(2, 16), (4, 1)], ids=["prefill", "decode"])
def test_moe_index_dispatch_on_card_matches_onehot_and_cpu(cuda, arch, b, s):
    """``moe_apply`` on the card against its one-hot plain version there
    and against itself on the CPU (reduced widths, f32, capacity factor 1,
    which drops assignments at T = 32): the same expert ids, y within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(arch, reduced=True).replace(capacity_factor=1.0)
    params = moe.moe_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    x = _randn((b, s, cfg.d_model), torch.float32, 1)
    got, aux, ids = moe.moe_routed(params, x, cfg)
    want, aux_plain, ids_plain = moe.moe_routed(params, x, cfg, onehot=True)
    cpu, aux_cpu, ids_cpu = moe.moe_routed(_tree_to(params, "cpu"), x.cpu(), cfg)
    assert torch.equal(ids, ids_plain) and torch.equal(ids.cpu(), ids_cpu)
    _close(got, want, torch.float32)
    _close(got.cpu(), cpu, torch.float32)
    torch.testing.assert_close(aux, aux_plain, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(aux.cpu(), aux_cpu, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "deepseek-v2-236b"])
def test_moe_slot_decode_graph_replay_matches_eager_steps(cuda, arch):
    """The slot decode step of a MoE model as a graph (llama4: GQA, the
    decode kernel; deepseek: MLA's plain decode and its dense first
    layer): greedy tokens and launch counts equal the eager steps'."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    cfg = _graph_config(arch)
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12], [13] * 40]
    out = _served_both_ways(
        lambda: ServeEngine(cfg, params, max_slots=2, max_len=64, device="cuda"),
        ("_decode",), prompts, 6)
    (eager_tokens, eager_counts, _), (tokens, counts, eng) = out["eager"], out["graph"]
    assert tokens == eager_tokens
    assert counts == eager_counts
    assert (counts["decode"] > 0) == (not cfg.use_mla)
    assert len(eng._decode._captured) == 1


def test_moe_paged_steps_graph_replay_matches_eager_steps(cuda):
    """llama4's paged decode tick and chunk window as graphs, through
    preemption: tokens, preemptions and launch counts equal the eager
    steps'."""
    from dataclasses import replace

    from repro_torch.models import lm
    from repro_torch.serve.engine import PagedServeEngine

    cfg = _graph_config("llama4-scout-17b-a16e")
    cfg = cfg.replace(attention=replace(cfg.attention, impl="pallas_flash"))
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = [list(range(1 + i, 4 + 2 * i)) for i in range(5)] + [[9, 9, 9]]
    out = _served_both_ways(
        lambda: PagedServeEngine(cfg, params, max_batch=3, max_len=32, block_size=16,
                                 prefill_chunk=8, num_blocks=3, cache_dtype=torch.float32,
                                 device="cuda"),
        ("_decode", "_chunk"), prompts, 16)
    (eager_tokens, eager_counts, eager_eng), (tokens, counts, eng) = out["eager"], out["graph"]
    assert tokens == eager_tokens
    assert counts == eager_counts and counts["paged_decode"] > 0
    pre = [m["n_preemptions"] for m in eng.metrics()]
    assert pre == [m["n_preemptions"] for m in eager_eng.metrics()] and sum(pre) > 0
    assert len(eng._decode._captured) == 1 and len(eng._chunk._captured) == 1


def _cluster_engines(cfg, params, clock, faults=None):
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine

    faults = faults or {}
    return [ServeEngine(cfg, params, max_slots=2, max_len=64, clock=clock, device="cuda",
                        faults=faults.get(0)),
            PagedServeEngine(cfg, params, max_batch=2, max_len=64, block_size=16,
                             prefill_chunk=8, clock=clock, device="cuda", faults=faults.get(1))]


def _cluster_run(cfg, params, specs, prompts):
    """A slot and a paged replica behind a round-robin router on the card,
    a tick clock, ``specs`` at the router's fault points → (router, the
    requests by uid, launch-count advance, paged pool free at start and
    end)."""
    from repro_torch.faults import FaultInjector, FaultSpec
    from repro_torch.serve.cluster import ClusterRouter
    from repro_torch.serve.graphs import LaunchCounters

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clock, counters = Clock(), LaunchCounters()
    engines = _cluster_engines(cfg, params, clock)
    router = ClusterRouter(engines, policy="round_robin", clock=clock,
                           faults=FaultInjector([FaultSpec(**s) for s in specs]))
    free0 = engines[1].cache.pool.num_free
    before = counters.read()
    uids = [router.add_request(p, max_new_tokens=8) for p in prompts]
    for _ in range(300):
        router.tick()
        clock.t += 1
        if not router.has_work():
            break
    torch.cuda.synchronize()
    after = counters.read()
    assert not router.has_work()
    return (router, {u: router.request(u) for u in uids},
            {k: after[k] - before[k] for k in after}, (free0, engines[1].cache.pool.num_free))


@pytest.mark.parametrize("crash", [0, 1], ids=["slot_dies", "paged_dies"])
def test_cluster_router_on_card_survives_a_replica_kill(cuda, crash):
    """starcoder2-7b ``reduced()`` at head dim 64 under pallas_distr, a slot
    and a paged replica on the card behind the router, replica ``crash``
    killed after three ticks: every request done with its budget, the
    survivor's own requests equal to a healthy run's token for token, the
    redelivered ones keep their emitted prefix, the paged pool (when it
    survives) back at its free count, and the DistrAttention forward,
    decode and paged decode kernels launched; the healthy run records no
    replica death."""
    from repro_torch.models import lm

    cfg = _card_config("starcoder2-7b", "pallas_distr")
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = [list(range(3, 11)), list(range(5, 17)), list(range(2, 8)), list(range(20, 29))]
    healthy, want, counts, pool = _cluster_run(cfg, params, [], prompts)
    assert healthy.counters_snapshot()["replica_deaths"] == 0
    assert pool[0] == pool[1]
    assert counts["distr_attention"] > 0 and counts["decode"] > 0 and counts["paged_decode"] > 0
    router, got, _, pool = _cluster_run(
        cfg, params, [dict(point="replica_crash", uid=crash, after=3)], prompts)
    assert router.counters_snapshot()["replica_deaths"] == 1
    moved = [u for u, c in got.items() if c.redeliveries]
    assert moved
    for u, c in got.items():
        assert c.status == "done" and len(c.emitted) == 8
        if u in moved:
            assert c.emitted[:c.base] == want[u].emitted[:c.base]
        else:
            assert c.emitted == want[u].emitted
    if crash == 0:
        assert pool[0] == pool[1]


def _card_trainer(workdir, cfg, params, seq=64):
    from repro_torch.train.data import SyntheticLMData
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer

    opt = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    return Trainer(cfg, opt, SyntheticLMData(cfg.vocab, 2, seq, seed=0), params,
                   workdir=workdir, ckpt_every=3, log_every=1000)


def test_supervisor_on_card_recovers_to_the_uninterrupted_losses(cuda, tmp_path):
    """minicpm-2b ``reduced()`` at head dim 64 under pallas_distr, f32, on
    the card: a ``TrainSupervisor`` of 4 workers loses worker 2 at tick 5,
    remeshes to 3 and restores the step-3 checkpoint; the losses equal an
    uninterrupted run's (to 1e-6 relative: the smoke checks bit identity)
    and the DistrAttention forward, delta and distr backward kernels
    launched."""
    from repro_torch.faults import FaultInjector, FaultSpec
    from repro_torch.launch.train import init_train_params
    from repro_torch.train.supervisor import TrainSupervisor

    cfg = _card_config("minicpm-2b", "pallas_distr")
    before = dict(bwd.launches), dk.launches
    tr = _card_trainer(str(tmp_path / "w"), cfg, init_train_params(cfg, seed=0, device="cuda"))
    sup = TrainSupervisor(tr, num_workers=4, max_missed=2, faults=FaultInjector(
        [FaultSpec("worker_loss", uid=2, after=4, times=-1)]))
    hist = sup.run(6)
    snap = sup.counters_snapshot()
    assert snap["worker_deaths"] == snap["remesh_events"] == 1 and sup.alive == [0, 1, 3]
    assert [e["restored_step"] for e in sup.events if e["kind"] == "remesh"] == [3]
    plain = _card_trainer(None, cfg, init_train_params(cfg, seed=0, device="cuda"))
    want = [plain.step_once() for _ in range(6)]
    assert [r["step"] for r in hist] == [r["step"] for r in want] == list(range(1, 7))
    for a, b in zip(hist, want):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
    assert dk.launches > before[1]
    for name in ("delta", "distr_dq", "distr_dkv"):
        assert bwd.launches[name] > before[0][name]


def test_grad_accum_on_card_matches_the_whole_batch(cuda):
    """One train step of minicpm-2b ``reduced()`` at head dim 64 under
    pallas_distr on the card at grad_accum 2 against grad_accum 1 on the
    same 4 x 32 batch: the loss within the reference's rtol 1e-5, every
    param within 2e-2 after the update, and the backward kernels launched
    twice as often."""
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = _card_config("minicpm-2b", "pallas_distr")
    base = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                          dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (4, 32), generator=gen, device="cuda")
             for k in ("tokens", "labels")}
    out = {}
    for accum in (1, 2):
        params = {k: _tree_to(v, "cuda") for k, v in base.items()}
        ocfg = opt.OptimizerConfig(peak_lr=1e-2, warmup_steps=0, total_steps=10,
                                   schedule="constant", grad_accum=accum)
        before = dict(bwd.launches)
        _, _, metrics = make_train_step(cfg, ocfg)(
            params, opt.adamw_init(lm.trainable(params)), batch, 0)
        out[accum] = (float(metrics["loss"]), params,
                      {k: bwd.launches[k] - before[k] for k in bwd.launches})
    assert out[2][0] == pytest.approx(out[1][0], rel=1e-5)
    for a, b in zip(lm.trainable(out[1][1]), lm.trainable(out[2][1])):
        assert float((a - b).detach().abs().max()) < 2e-2
    assert out[1][2]["distr_dq"] > 0
    assert out[2][2] == {k: 2 * n for k, n in out[1][2].items()}


def test_step_graphs_share_one_side_stream_and_leave_no_workspace_behind(cuda):
    """Every StepGraph warms up and captures on the device's one side
    stream, so building engine after engine adds no cuBLAS workspace: after
    ten slot engines have each captured a decode step and been dropped,
    the card's allocated memory is back within 64 MiB of where it was after
    the first."""
    import gc

    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.graphs import StepGraph

    x = torch.zeros(2, device="cuda")
    assert StepGraph._side_stream((x,)) is StepGraph._side_stream((x, x))
    cfg = _graph_config("starcoder2-7b")
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    marks = []
    for _ in range(10):
        eng = ServeEngine(cfg, params, max_slots=2, max_len=64, device="cuda")
        eng.add_request([1, 2, 3], max_new_tokens=4)
        eng.run_to_completion()
        assert len(eng._decode._captured) == 1
        del eng
        gc.collect()
        torch.cuda.synchronize()
        marks.append(torch.cuda.memory_allocated())
    assert marks[-1] - marks[0] <= 64 * 2**20, marks
