"""Atomic, restart-safe checkpointing with async writes.

Layout:  <dir>/step_<k>/ {manifest.json, arrays.npz}  +  <dir>/LATEST

The reference's contract (tests/test_torch_train_ckpt.py runs its cases
on the port):
  * writes go to `step_<k>.tmp/` and are renamed into place only after the
    manifest (with a crc32 per array) is fully written, so a crash
    mid-save never corrupts the restore path;
  * `restore_latest` walks checkpoints newest-first and skips any whose
    manifest or checksums fail;
  * `AsyncSaver` copies the tree to host memory first, then writes on a
    background thread, overlapping the next training steps;
  * keep_last bounds disk usage.

A tree is dicts, lists and NamedTuples of tensors; a leaf's key is its
path joined by "/" (a NamedTuple's field names, dict keys, list indices).
numpy has no bfloat16 of its own (only through the optional ml_dtypes
package), so a bfloat16 tensor is stored as its uint16 bits with
"bfloat16" as its manifest dtype, and restored through ``Tensor.view``:
bit for bit, with or without ml_dtypes installed.
`restore_latest` writes each array INTO its template leaf (``copy_``: the
leaf's device and type, one array on the host at a time) and returns the
template: the reference builds a new tree, but two llama3.2-3b training
states (32.1 GB each) do not fit one 80 GB card beside a step.
Restoring onto another mesh (the reference's ``shardings``) is
multi-device (ROADMAP A9) and raises.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._util import tree_leaves

SEP = "/"
BF16 = "bfloat16"


def _key(path: tuple) -> str:
    return SEP.join(str(p) for p in path)


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array (a copy, never a view of the live
    tensor) and its manifest dtype."""
    t = torch.as_tensor(leaf).detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    a = t.numpy()
    return a, str(a.dtype)


def _flatten(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
    return {_key(path): _host(leaf) for path, leaf in tree_leaves(tree)}


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def _save_flat(ckpt_dir: str, step: int, flat: dict, keep_last: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: a for k, (a, _) in flat.items()})
    manifest = {
        "step": step,
        "arrays": {
            k: {"shape": list(a.shape), "dtype": dt, "crc32": _crc(a)}
            for k, (a, dt) in flat.items()
        },
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep_last)
    return final


def save(ckpt_dir: str, step: int, tree: Any, *, keep_last: int = 3) -> str:
    """Blocking atomic save. Returns the final checkpoint path."""
    return _save_flat(ckpt_dir, step, _flatten(tree), keep_last)


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


class AsyncSaver:
    """One in-flight background save; `wait()` before the next snapshot."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, ckpt_dir: str, step: int, tree: Any, *,
             keep_last: int = 3):
        self.wait()
        flat = _flatten(tree)   # the host snapshot, before the next step

        def run():
            self.last_path = _save_flat(ckpt_dir, step, flat, keep_last)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _validate(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            for k, meta in manifest["arrays"].items():
                v = z[k]
                if list(v.shape) != meta["shape"]:
                    return None
                if _crc(v) != meta["crc32"]:
                    return None
        return manifest
    except Exception:
        return None


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def restore_latest(
    ckpt_dir: str, template: Any, *, shardings: Any = None
) -> Optional[tuple[int, Any]]:
    """Restore the newest valid checkpoint into ``template``, a tree of
    tensors, in place: each leaf keeps its device and type and is
    overwritten with the saved array (``copy_``); returns (step,
    template).  Corrupt or partial checkpoints, and those whose keys or
    shapes do not fit the template, are skipped (newest-first scan)
    before any leaf is written."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto another mesh is multi-device (ROADMAP queue A, "
            "A9)")
    if not os.path.isdir(ckpt_dir):
        return None
    candidates = sorted(
        (d for d in os.listdir(ckpt_dir)
         if d.startswith("step_") and not d.endswith(".tmp")),
        reverse=True,
    )
    leaves = {_key(path): leaf for path, leaf in tree_leaves(template)}
    for cand in candidates:
        path = os.path.join(ckpt_dir, cand)
        manifest = _validate(path)
        if manifest is None:
            continue
        meta = manifest["arrays"]
        if any(k not in meta or meta[k]["shape"] != list(leaf.shape)
               for k, leaf in leaves.items()):
            continue
        with np.load(os.path.join(path, "arrays.npz")) as z, \
                torch.no_grad():
            for k, leaf in leaves.items():
                leaf.copy_(_tensor(z[k], meta[k]["dtype"]))
        return int(manifest["step"]), template
    return None
