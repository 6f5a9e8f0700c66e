"""Persistent JSON cache of measured block sizes (``repro.tune.cache``).

Keyed by ``(kernel, backend, dtype, d, G*, seq-bucket, causal)``: the
parameters the optimum shifts with.  Batch and head counts only scale the
grid, not the per-instance working set, so they are not part of the key:
one warm-up covers every batch size.  The backend is the card's compute
capability (``sm_90``) or ``cpu`` for the kernels' plain versions.

The file is a flat ``{key: entry}`` JSON object; an entry stores the
winning blocks and the measured table.  ``REPRO_TUNE_CACHE`` overrides the
location; the default is the port's own file, never the JAX package's.
"""
from __future__ import annotations

import json
import os
import tempfile


def default_cache_path() -> str:
    env = os.environ.get("REPRO_TUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "blocksizes.json")


def dtype_str(x) -> str:
    """Canonical dtype label for cache keys ("bfloat16" | "float32").
    Accepts a tensor or a dtype; anything not bf16 keys as float32 (the
    kernels accumulate in f32 either way)."""
    dt = getattr(x, "dtype", x)
    return "bfloat16" if str(dt).rsplit(".", 1)[-1] == "bfloat16" else "float32"


def seq_bucket(n: int) -> int:
    """Power-of-two sequence bucket (floor 128): nearby lengths share a
    tuning entry, as the serve engines' prefill buckets do."""
    b = 128
    while b < n:
        b *= 2
    return b


def cache_key(kernel: str, *, backend: str, dtype: str, d: int, group_size: int = 1,
              n: int, causal: bool = False) -> str:
    return (
        f"{kernel}|backend={backend}|dtype={dtype}|d={int(d)}"
        f"|g={int(group_size)}|nb={seq_bucket(int(n))}|causal={bool(causal)}"
    )


class TuneCache:
    """In-memory view of one JSON cache file (lazy load, atomic save)."""

    def __init__(self, path: str | None = None):
        self._explicit_path = path
        self._data: dict | None = None
        self._loaded_from: str | None = None

    @property
    def path(self) -> str:
        return self._explicit_path or default_cache_path()

    def _load(self) -> dict:
        path = self.path
        if self._data is None or self._loaded_from != path:
            self._loaded_from = path
            self._data = {}
            try:
                with open(path, encoding="utf-8") as f:
                    self._data = json.load(f)
            except (json.JSONDecodeError, UnicodeDecodeError):
                # A torn or non-UTF-8 file: quarantine it rather than fail
                # the caller (engine construction warms through here).
                self._quarantine(path)
            except (OSError, ValueError):
                pass
        return self._data

    @staticmethod
    def _quarantine(path: str) -> None:
        """Move an unparseable cache aside (``path + '.corrupt'``), so its
        bytes stay inspectable and later saves start clean.  Never raises."""
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass

    def get(self, key: str) -> dict | None:
        return self._load().get(key)

    def put(self, key: str, entry: dict, *, save: bool = True) -> None:
        self._load()[key] = entry
        if save:
            self.save()

    def save(self) -> None:
        path = self.path
        data = self._load()
        # Merge on save: another process may share the path (warm once,
        # look up after), so fold in what it wrote since our load; our own
        # keys win.
        try:
            with open(path, encoding="utf-8") as f:
                on_disk = json.load(f)
        except (OSError, ValueError):
            on_disk = {}
        data = {**on_disk, **data}
        self._data = data
        directory = os.path.dirname(path) or "."
        os.makedirs(directory, exist_ok=True)
        # Atomic publish: a crashed or parallel writer never leaves a torn file.
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def clear_memory(self) -> None:
        """Drop the in-memory view (a changed env path reloads too)."""
        self._data = None
        self._loaded_from = None
