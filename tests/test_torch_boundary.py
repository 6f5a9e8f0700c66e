"""Package boundary of the port: repro_torch and chip_smoke.py import
neither JAX nor the JAX package, repro_torch calls no library attention and
no torch.compile, entry points refuse to fall back to the CPU (for the
dense, ssm and hybrid families alike), a CPU tensor given to a kernel
wrapper takes the plain path without counting a launch, and a meta tensor
(the dry run's) its meta branch: shapes, no launch, no plain version."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import backward as bwd  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode as dec  # noqa: E402
from repro_torch.kernels import distr_attention as dk  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode as pd  # noqa: E402
from repro_torch.kernels import ssd as ssd_kernels  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.serve import run  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.serve.engine import PagedServeEngine, ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN_CALLS = ("scaled_dot_product_attention", "torch.compile", "cudnn",
                   "flash_attn", "flashinfer")


def _port_files():
    return sorted(PORT.rglob("*.py"))


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", _port_files() + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax"), f"{path}: imports {name}"
        assert top != "repro", f"{path}: imports the JAX package ({name})"


def test_port_calls_no_library_attention_or_compile():
    for path in _port_files() + sorted((PORT / "kernels" / "csrc").iterdir()):
        text = path.read_text()
        for word in FORBIDDEN_CALLS:
            assert word not in text, f"{path}: mentions {word}"


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg = get_config("starcoder2-7b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg)
    params = lm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(cfg, params, requests=1)
    train_cfg = get_config("minicpm-2b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.init_train_params(train_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.run(train_cfg, launch_train.init_train_params(train_cfg, device="cpu"),
                         steps=1)


# Two separate f32 evaluations of a plain version on the CPU (einsums and
# sums through MKL and OpenMP) are not promised to agree bit for bit; the
# wrapper's result is held to the spy's own result exactly, and a second
# evaluation to this tolerance (≈ 80 f32 ulps: summation order only).
PLAIN_AGAIN_TOL = 1e-5


def test_cpu_tensors_take_the_plain_path_without_counting(monkeypatch):
    """Each ``*_kernel_call`` given CPU tensors runs its ``*_plain`` once and
    returns that call's own result (a spy passes it through), counts no
    launch, and agrees with the plain version evaluated again."""
    plains = [(fk, "flash_attention_plain"), (dk, "distr_attention_plain"),
              (dec, "decode_plain"), (bwd, "delta_plain"), (bwd, "flash_dq_plain"),
              (bwd, "flash_dkv_plain"), (bwd, "distr_dq_plain"), (bwd, "distr_dkv_plain")]
    real, seen = {}, {}
    for module, name in plains:
        real[name] = getattr(module, name)

        def spy(*args, _name=name, **kw):
            out = real[_name](*args, **kw)
            seen.setdefault(_name, []).append(out)
            return out

        monkeypatch.setattr(module, name, spy)

    def check(name, got, *args, **kw):
        assert len(seen.get(name, [])) == 1, f"{name} ran {len(seen.get(name, []))} times"
        ran = seen[name][0]
        got, ran = (got, ran) if isinstance(got, tuple) else ((got,), (ran,))
        assert len(got) == len(ran) and all(a is b for a, b in zip(got, ran)), name
        again = real[name](*args, **kw)
        again = again if isinstance(again, tuple) else (again,)
        for a, b in zip(got, again):
            torch.testing.assert_close(a, b, atol=PLAIN_AGAIN_TOL, rtol=PLAIN_AGAIN_TOL)

    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 64, 64, generator=g)
    k = torch.randn(2, 64, 64, generator=g)
    before = (fk.launches, dk.launches, dec.launches, dict(bwd.launches))

    fkw = dict(q_per_kv=2, scale=0.125, causal=True, kv_len=64)
    check("flash_attention_plain", fk.flash_attention_kernel_call(q, k, k, **fkw), q, k, k,
          **fkw)
    perm = torch.stack([torch.randperm(64, generator=g) for _ in range(4)])[:, None]
    kw = dict(q_per_kv=2, causal=True, group_size=2, block_q=64, kv_len=64)
    check("distr_attention_plain", dk.distr_attention_kernel_call(q[..., :32], k, k, perm, **kw),
          q[..., :32], k, k, perm, **kw)
    lengths = torch.tensor([5, 64])
    qd, kd = torch.randn(2, 2, 3, 64, generator=g), torch.randn(2, 2, 64, 64, generator=g)
    dkw = dict(scale=0.125, block_k=32, q_len=1)
    check("decode_plain", dec.decode_kernel_call(qd, kd, kd, lengths, **dkw), qd, kd, kd,
          lengths, **dkw)

    lse = torch.zeros(4, 64)
    check("delta_plain", bwd.delta_kernel_call(q, q), q, q)
    check("flash_dq_plain", bwd.flash_dq_kernel_call(q, k, k, q, lse, lse, **fkw),
          q, k, k, q, lse, lse, **fkw)
    check("flash_dkv_plain", bwd.flash_dkv_kernel_call(q, k, k, q, lse, lse, **fkw),
          q, k, k, q, lse, lse, **fkw)
    check("distr_dq_plain", bwd.distr_dq_kernel_call(q[..., :32], k, k, perm, q, lse, lse, **kw),
          q[..., :32], k, k, perm, q, lse, lse, **kw)
    check("distr_dkv_plain",
          bwd.distr_dkv_kernel_call(q[..., :32], k, k, perm, q, lse, lse, **kw),
          q[..., :32], k, k, perm, q, lse, lse, **kw)

    assert set(seen) == set(real)
    assert (fk.launches, dk.launches, dec.launches, bwd.launches) == before


def test_paged_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg = get_config("starcoder2-7b", reduced=True)
    params = lm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedServeEngine(cfg, params)


def test_paged_cpu_tensors_take_the_plain_path_without_counting():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 2, 8, 64, generator=g)
    pool = torch.randn(5, 2, 16, 64, generator=g)
    bt = torch.tensor([[1, 2], [3, 0]])
    lengths = torch.tensor([20, 40])  # the second overhangs its table
    before = pd.launches
    kw = dict(scale=0.125, q_len=4)
    got = pd.paged_decode_kernel_call(q, pool, pool, bt, lengths, **kw)
    want = pd.paged_decode_plain(q, pool, pool, bt, lengths, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pd.launches == before


def _refuse(*args, **kwargs):
    raise AssertionError("a plain version ran")


def test_non_cpu_non_cuda_tensor_raises_instead_of_falling_back(monkeypatch):
    """Only a CPU tensor takes a kernel's plain version.  A meta tensor (the
    dry run's, ``launch/dryrun.py``) takes the wrapper's meta branch:
    outputs of the right shapes and dtypes, no launch counted and no plain
    version run; any other tensor off the card meets the launch path's
    guard and raises."""
    monkeypatch.setattr(fk, "flash_attention_plain", _refuse)
    q = torch.empty(4, 64, 64, device="meta")
    before = fk.launches
    o, lse = fk.flash_attention_kernel_call(q, q[:2], q[:2], q_per_kv=2, scale=0.125,
                                            causal=True, kv_len=64, return_lse=True)
    assert o.is_meta and o.shape == q.shape and o.dtype == q.dtype
    assert lse.shape == (4, 64) and lse.dtype == torch.float32
    assert fk.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        build.require_cuda(torch.empty(4, 64, 64))


def test_kernel_sources_are_found_without_building():
    names = [p.name for p in build.sources()]
    assert names == ["decode.cu", "delta.cu", "distr_attention.cu", "distr_backward.cu",
                     "distr_dkv.cu", "distr_dq_r64.cu", "distr_fwd_r64.cu",
                     "flash_attention.cu", "flash_backward.cu", "flash_dkv_r32.cu",
                     "flash_dkv_r64.cu", "flash_dq_r128.cu", "flash_dq_r64.cu",
                     "flash_fwd_r128.cu", "flash_fwd_r64.cu", "paged_decode.cu", "ssd.cu"]
    assert set(build.SIGNATURES) == {
        "repro_flash_fwd", "repro_distr_fwd", "repro_decode_fwd", "repro_delta",
        "repro_flash_dq", "repro_flash_dkv", "repro_distr_dq", "repro_distr_dkv",
        "repro_paged_decode_fwd", "repro_ssd_fwd"}
    assert len(build.source_hash()) == 16


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m"])
def test_mamba_families_refuse_the_cpu_unless_asked(arch):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg = get_config(arch, reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg)
    params = lm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(cfg, params, requests=1)
    eng = ServeEngine(cfg, params, max_slots=1, max_len=64, device="cpu")
    eng.add_request([1, 2, 3], max_new_tokens=2)
    assert [r.status for r in eng.run_to_completion()] == ["done"]


def test_ssd_cpu_tensors_take_the_plain_path_without_counting():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(4, 40, 8, generator=g)
    a = -torch.rand(4, 40, generator=g)
    b, c = torch.randn(2, 40, 4, generator=g), torch.randn(2, 40, 4, generator=g)
    before = ssd_kernels.launches
    kw = dict(heads_per_group=2, chunk=16, return_state=True)
    got = ssd_kernels.ssd_kernel_call(x, a, b, c, **kw)
    want = ssd_kernels.ssd_plain(x, a, b, c, **kw)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert ssd_kernels.launches == before
    assert mamba.conv_dim(get_config("zamba2-7b")) == 7168 + 2 * 64


def test_ssd_on_a_device_without_a_backward_raises_for_grad(monkeypatch):
    """``ops.ssd`` has a backward on every device; a meta tensor (the dry
    run's) reaches the kernel wrapper's meta branch through the autograd
    Function's forward, with and without a gradient, and gets shapes, never
    the plain version; its backward runs on meta too (the dry run's train
    step).  A tensor off the card elsewhere meets ``build.require_cuda``
    (``test_non_cpu_non_cuda_tensor_raises_instead_of_falling_back``)."""
    monkeypatch.setattr(ssd_kernels, "ssd_plain", _refuse)
    x = torch.empty(1, 8, 2, 4, device="meta", requires_grad=True)
    a = torch.empty(1, 8, 2, device="meta")
    b = torch.empty(1, 8, 1, 4, device="meta")
    for xx in (x, x.detach()):
        y = ops.ssd(xx, a, b, b, chunk=4)
        assert y.is_meta and y.shape == xx.shape
    ops.ssd(x, a, b, b, chunk=4).sum().backward()
    assert x.grad.is_meta and x.grad.shape == x.shape
