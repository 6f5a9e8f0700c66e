"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``.  The build runs at the
first CUDA launch, never at import (the CPU tests import every module and
have no ``nvcc``), one ``nvcc`` process per source in parallel followed by
one link.  Output goes to ``build/kernels/<hash>/`` at the repository root,
keyed by a hash of the sources and flags, so a changed source rebuilds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "librepro_torch_kernels.so"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Value widths the forward and decode kernels are instantiated for.
HEAD_DIMS = (64, 112, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (see csrc/*.cu).  The attention
# entry points end in the tile, (rows, keys), before the stream.
SIGNATURES = {
    "repro_flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "repro_distr_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P),
    "repro_decode_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _P),
    "repro_paged_decode_fwd": (_P,) * 8 + (_I,) * 9 + (_F, _P),
    "repro_delta": (_P, _P, _P, _I, _I, _I, _P),
    "repro_flash_dq": (_P,) * 7 + (_I,) * 7 + (_F, _I, _I, _I, _P),
    "repro_flash_dkv": (_P,) * 8 + (_I,) * 7 + (_F, _I, _I, _I, _P),
    "repro_distr_dq": (_P,) * 9 + (_I,) * 13 + (_P,),
    "repro_distr_dkv": (_P,) * 10 + (_I,) * 13 + (_P,),
    "repro_ssd_fwd": (_P,) * 6 + (_I,) * 7 + (_P,),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if its hash has no build yet; returns its path.
    nvcc's output (``-Xptxas -v``: registers, shared memory, spills) is kept
    in ``build.log`` beside it."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if not failed:
            tmp_lib = Path(tmp) / LIB_NAME
            link = subprocess.run(
                [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                 *(str(o) for _, o, _ in procs), "-o", str(tmp_lib)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            log.append(f"== link (exit {link.returncode})\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
            else:
                os.replace(tmp_lib, lib_path)
        (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"CUDA kernel build failed ({', '.join(failed)}); see "
            f"{out_dir / 'build.log'}:\n" + "\n".join(log)[-6000:]
        )
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def build_log() -> str:
    path = BUILD_ROOT / source_hash() / "build.log"
    return path.read_text() if path.exists() else ""


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def require_cuda(*tensors: torch.Tensor) -> None:
    """Wrappers launch only on contiguous CUDA tensors of one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kernel wants CUDA tensors on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel wants contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("kernel wants 16-byte aligned tensors")
