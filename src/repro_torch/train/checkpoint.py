"""Verified checkpoints with keep-k and resume: the contract of
``repro.train.checkpoint`` over the port's tensors.

A checkpoint directory ``step_<N>[-<tag>]`` holds ``params.npz``,
``opt_state.npz``, ``meta.json`` and ``manifest.json``.

* **Tensors to files.** Params are flattened by their key paths
  (``lm.named_trainable``: ``blocks/0/attn/wq/w``), so a tied embedding
  is stored once; the AdamW state as ``m/<path>``, ``v/<path>`` and
  ``count``.  Tensors reach the host with one device synchronisation and
  plain ``.cpu()``.  numpy has no bf16, so a bf16 tensor is stored as its
  ``uint16`` bits; the manifest records every array's torch dtype.
* **Loading in place.** :func:`load_checkpoint` copies each array into the
  tensor already at its path (``copy_``), so the live tensors keep their
  storage: a tied head, a cached view or a reference held elsewhere stays
  valid across a resume or a rollback.
* **Atomic, durable publish.** Writes go to ``<dir>/tmp.<name>``, every
  file is fsync'd, then ``os.replace`` publishes and the parent directory
  is fsync'd: a crash mid-save never tears the latest checkpoint.
* **Per-array checksum manifest.** ``manifest.json`` records a sha256 over
  (dtype, shape, bytes) of every saved array; :func:`verify_checkpoint`
  re-hashes on load, so torn or rotted bytes are detected.
* **Verified fallback.** With no explicit step, :func:`load_checkpoint`
  walks checkpoints newest → oldest and loads the newest that verifies,
  reporting the skipped ones as ``meta["_fallback_skipped"]``; at an equal
  step the untagged checkpoint is preferred.
* **GC never orphans the last verified checkpoint.** keep-k always keeps
  the newest checkpoint that verifies, even when every newer one is torn.

Fault injection: ``save_checkpoint(..., faults=...)`` consults
``ckpt_torn_write`` (``uid`` = the step) once per save and, when it fires,
truncates ``params.npz`` before publishing: the checkpoint looks complete
on disk but fails verification.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.faults import NULL_INJECTOR
from repro_torch.models.lm import named_trainable

MANIFEST_NAME = "manifest.json"

_NAME_RE = re.compile(r"step_(\d+)(?:-([A-Za-z0-9_.\-]+))?")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed integrity verification (missing files, torn
    archive bytes, or a per-array checksum mismatch)."""


def _opt_leaves(params: dict, opt_state: dict) -> list[tuple[str, torch.Tensor]]:
    names = [name for name, _ in named_trainable(params)]
    return ([(f"m/{n}", t) for n, t in zip(names, opt_state["m"])]
            + [(f"v/{n}", t) for n, t in zip(names, opt_state["v"])])


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _array_digest(arr: np.ndarray) -> str:
    """sha256 over (dtype, shape, bytes): a reshape or dtype flip with the
    same byte stream must not verify."""
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(tuple(arr.shape)).encode())
    h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))  # the bytes, not a copy
    return h.hexdigest()


def _fsync_file(path: str) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - non-POSIX
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def checkpoint_name(step: int, tag: str = "") -> str:
    if tag and not re.fullmatch(r"[A-Za-z0-9_.\-]+", tag):
        raise ValueError(f"checkpoint tag {tag!r} must be filename-safe")
    return f"step_{step:08d}" + (f"-{tag}" if tag else "")


def step_of(name: str) -> int:
    m = _NAME_RE.fullmatch(name)
    if not m:
        raise ValueError(f"not a checkpoint name: {name!r}")
    return int(m.group(1))


def _write_npz(tmp: str, fname: str, leaves, manifest: dict) -> None:
    flat = {name: _to_numpy(t) for name, t in leaves}
    np.savez(os.path.join(tmp, fname), **flat)
    manifest["arrays"][fname] = {k: _array_digest(v) for k, v in flat.items()}
    manifest["dtypes"][fname] = {name: _dtype_name(t) for name, t in leaves}


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    params: dict,
    opt_state: dict | None = None,
    data_state: dict | None = None,
    *,
    extra_meta: dict | None = None,
    keep: int = 3,
    tag: str = "",
    faults=None,
) -> str:
    """Publish ``params`` (and ``opt_state``, ``data_state``) as checkpoint
    ``step`` in ``ckpt_dir``, then trim to the newest ``keep`` (the newest
    verified one always kept) → the published directory."""
    faults = faults or NULL_INJECTOR
    os.makedirs(ckpt_dir, exist_ok=True)
    name = checkpoint_name(step, tag)
    tmp = os.path.join(ckpt_dir, f"tmp.{name}")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = named_trainable(params)
    if any(t.is_cuda for _, t in leaves):
        torch.cuda.synchronize()  # once; every .cpu() below is then a plain copy
    manifest: dict = {"format": 1, "arrays": {}, "dtypes": {}}
    _write_npz(tmp, "params.npz", leaves, manifest)
    if opt_state is not None:
        count = ("count", torch.tensor(opt_state["count"], dtype=torch.int32))
        _write_npz(tmp, "opt_state.npz", [count, *_opt_leaves(params, opt_state)], manifest)
    meta = {"step": step, "data_state": data_state or {}, "tag": tag}
    meta.update(extra_meta or {})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f)

    # Durability before publish: fsync every file, then the tmp directory.
    for fname in os.listdir(tmp):
        _fsync_file(os.path.join(tmp, fname))
    _fsync_dir(tmp)

    if faults.fires("ckpt_torn_write", uid=step) is not None:
        # A torn write: complete-looking on disk, caught only by verification.
        ppath = os.path.join(tmp, "params.npz")
        size = os.path.getsize(ppath)
        with open(ppath, "r+b") as f:
            f.truncate(max(size // 2, 1))

    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    _fsync_dir(ckpt_dir)
    _gc(ckpt_dir, keep)
    return final


def list_checkpoint_names(ckpt_dir: str) -> list[str]:
    """Every checkpoint directory name, sorted so the LAST is the preferred
    resume candidate: ascending by step, and at an equal step the untagged
    checkpoint after the tagged ones."""
    if not os.path.isdir(ckpt_dir):
        return []
    names = []
    for name in os.listdir(ckpt_dir):
        m = _NAME_RE.fullmatch(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            names.append(name)
    return sorted(names, key=lambda n: (step_of(n), _NAME_RE.fullmatch(n).group(2) is None))


def list_checkpoints(ckpt_dir: str) -> list[int]:
    """Distinct checkpoint steps, ascending."""
    return sorted({step_of(n) for n in list_checkpoint_names(ckpt_dir)})


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def verify_checkpoint(path: str) -> list[str]:
    """Integrity problems of one checkpoint directory ([] = verified):
    meta.json parses, the manifest parses, every file it names loads, and
    every array matches its sha256."""
    problems: list[str] = []
    try:
        with open(os.path.join(path, "meta.json")) as f:
            json.load(f)
    except (OSError, ValueError) as e:
        return [f"meta.json unreadable: {e}"]
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        arrays = manifest["arrays"]
    except (OSError, ValueError, KeyError, TypeError) as e:
        return [f"{MANIFEST_NAME} unreadable: {e}"]
    for fname, digests in arrays.items():
        fpath = os.path.join(path, fname)
        try:
            with np.load(fpath) as npz:
                keys = set(npz.files)
                missing = set(digests) - keys
                if missing:
                    problems.append(f"{fname}: missing arrays {sorted(missing)}")
                for key in sorted(set(digests) & keys):
                    if _array_digest(npz[key]) != digests[key]:
                        problems.append(f"{fname}: checksum mismatch for {key!r}")
        except Exception as e:  # noqa: BLE001 - torn zip bytes raise many kinds
            problems.append(f"{fname}: unreadable ({e!r})")
    return problems


def is_verified(path: str) -> bool:
    return not verify_checkpoint(path)


def latest_verified_name(ckpt_dir: str) -> str | None:
    """The newest checkpoint directory that verifies (None if none does)."""
    for name in reversed(list_checkpoint_names(ckpt_dir)):
        if is_verified(os.path.join(ckpt_dir, name)):
            return name
    return None


def _gc(ckpt_dir: str, keep: int) -> None:
    """Keep-k trim that never deletes the newest verified checkpoint.
    Verification runs newest first and stops at the first that verifies."""
    names = list_checkpoint_names(ckpt_dir)
    keep_names = set(names[-keep:]) if keep > 0 else set()
    protected = latest_verified_name(ckpt_dir)
    if protected is not None:
        keep_names.add(protected)
    for name in names:
        if name not in keep_names:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


@torch.no_grad()
def _copy_into(leaves, npz, dtypes: dict) -> None:
    for key, target in leaves:
        if key not in npz.files:
            raise KeyError(f"checkpoint missing tensor {key!r}")
        arr = npz[key]
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs model "
                             f"{tuple(target.shape)}")
        target.copy_(_from_numpy(arr, dtypes.get(key, "")))


def _load_dir(path: str, params: dict, opt_state: dict | None) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            dtypes = json.load(f).get("dtypes", {})
    except OSError:  # a checkpoint without a manifest, loaded with verify=False
        dtypes = {}
    with np.load(os.path.join(path, "params.npz")) as npz:
        _copy_into(named_trainable(params), npz, dtypes.get("params.npz", {}))
    opath = os.path.join(path, "opt_state.npz")
    if opt_state is not None and os.path.exists(opath):
        with np.load(opath) as npz:
            _copy_into(_opt_leaves(params, opt_state), npz, dtypes.get("opt_state.npz", {}))
            opt_state["count"] = int(npz["count"])
    return meta


def load_checkpoint(
    ckpt_dir: str,
    params: dict,
    opt_state: dict | None = None,
    *,
    step: int | None = None,
    verify: bool = True,
):
    """→ (step, params, opt_state, meta), with ``params`` and ``opt_state``
    (when given) filled in place from the checkpoint: each array is copied
    into the tensor at its path, on that tensor's device and in its dtype.

    With ``step=None`` (resume) checkpoints are tried newest → oldest and the
    newest that verifies wins; ``meta["_fallback_skipped"]`` counts the
    corrupt ones skipped and ``meta["_name"]`` names the one loaded.  With
    an explicit ``step`` only that step is tried (untagged first) and a
    corrupt checkpoint raises :class:`CheckpointCorrupt`.  ``verify=False``
    trusts the bytes (the only way to load one without a manifest).
    """
    names = list_checkpoint_names(ckpt_dir)
    if step is not None:
        names = [n for n in names if step_of(n) == step]
    if not names:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}"
                                + (f" at step {step}" if step is not None else ""))
    skipped = 0
    last_problems: list[str] = []
    for name in reversed(names):
        path = os.path.join(ckpt_dir, name)
        if verify:
            problems = verify_checkpoint(path)
            if problems:
                if step is not None:
                    raise CheckpointCorrupt(f"{path}: {problems}")
                skipped += 1
                last_problems = problems
                continue
        meta = _load_dir(path, params, opt_state)
        meta["_fallback_skipped"] = skipped
        meta["_name"] = name
        return int(meta["step"]), params, opt_state, meta
    raise CheckpointCorrupt(f"no verified checkpoint in {ckpt_dir}: skipped {skipped}, "
                            f"last problems {last_problems}")
