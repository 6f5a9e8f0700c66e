"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes and edge cases (ragged tiles, kv_len below the buffer,
length 0, 32 packed rows, f32 and bf16).  Marked ``cuda``; skips without a
GPU.  This file imports neither JAX nor the JAX package, so on a machine
without JAX it runs alone:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode as dec  # noqa: E402
from repro_torch.kernels import distr_attention as dk  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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
@pytest.mark.parametrize("n,nk,kv_len,d,causal", [
    (1, 1, 1, 64, True),
    (100, 100, 100, 128, True),   # ragged row and key tiles
    (64, 200, 150, 64, False),    # kv_len below the buffer
    (130, 130, 130, 128, False),
])
def test_flash_kernel_matches_plain(cuda, dtype, n, nk, kv_len, d, causal):
    q, k, v = _randn((6, n, d), dtype, 0), _randn((2, nk, d), dtype, 1), _randn((2, nk, d), dtype, 2)
    kw = dict(q_per_kv=3, scale=d ** -0.5, causal=causal, kv_len=kv_len, return_lse=True)
    before = fk.launches
    o, lse = fk.flash_attention_kernel_call(q, k, v, **kw)
    o_p, lse_p = fk.flash_attention_plain(q, k, v, **kw)
    assert fk.launches == before + 1
    _close(o, o_p, dtype)
    torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,g,block_q,causal", [(128, 2, 64, True), (256, 4, 128, False)])
def test_distr_kernel_matches_plain(cuda, dtype, n, g, block_q, causal):
    d = 128
    q_hat = _randn((4, n, d // g), dtype, 3)
    k, v = _randn((2, n - 7, d), dtype, 4), _randn((2, n - 7, d), dtype, 5)
    perm = torch.stack([torch.randperm(d, device="cuda") for _ in range(4 * (n // block_q))])
    perm = perm.reshape(4, n // block_q, d)
    kw = dict(q_per_kv=2, causal=causal, group_size=g, block_q=block_q, kv_len=n - 7)
    _close(dk.distr_attention_kernel_call(q_hat, k, v, perm, **kw),
           dk.distr_attention_plain(q_hat, k, v, perm, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,q_len,ds,block_k", [(9, 1, 128, 128), (32, 2, 64, 64), (1, 1, 64, 128)])
def test_decode_kernel_matches_plain(cuda, dtype, rows, q_len, ds, block_k):
    b, hkv, s, d = 3, 2, 300, 128
    q = _randn((b, hkv, rows, ds), dtype, 6)
    k, v = _randn((b, hkv, s, ds), dtype, 7), _randn((b, hkv, s, d), dtype, 8)
    lengths = torch.tensor([0, 1, 300], dtype=torch.int32, device="cuda")
    kw = dict(scale=d ** -0.5, block_k=block_k, q_len=q_len)
    got = dec.decode_kernel_call(q, k, v, lengths, **kw)
    want = dec.decode_plain(q, k, v, lengths, **kw)
    _close(dec.merge_splits(*got), dec.merge_splits(*want), dtype)
    assert bool((got[1][0] == -1e30).all()) and bool((got[2][0] == 0).all())
