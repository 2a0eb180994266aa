"""Checkpointing and restart: one ``.npy`` per leaf plus a JSON manifest.

Port of the reference's ``checkpoint/manager.py`` over nested dicts of
tensors:

* **Atomicity**: a checkpoint is written to ``step_N.tmp``, every leaf
  and the manifest are fsynced, and only then is it renamed to
  ``step_N``, so a failure mid-write never corrupts the latest valid
  checkpoint.
* **Async**: ``save_async`` copies the state to host memory (the only
  part that blocks the caller) and writes it on a thread, overlapping
  the write with the next training steps; at most one save is in
  flight, and a failed write raises on the next ``wait()``.
* **Restart**: ``restore_latest`` restores the newest complete
  checkpoint, with the tensors on the devices and in the dtypes of a
  ``like`` tree.
* **Loader state**: the loader's iterator state (epoch, cursor, skips)
  rides in the manifest's extras, so the input pipeline resumes where
  it stopped.

Leaf names, file names, shapes, dtypes and array bytes are the
reference's. The manifest is ``manifest.json`` where the reference
writes ``manifest.msgpack``: the same keys (``leaves`` and ``extra``)
in JSON, since msgpack is not among the port's dependencies. A
bfloat16 leaf is stored as the reference stores it, as 2-byte void
records holding the bits, and read back bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree

MANIFEST = "manifest.json"


def _json_default(obj):
    """Manifest extras carry iterator and sampler state (loader cursors)
    that often arrives as numpy scalars, which ``json`` refuses: coerce
    them to plain Python here instead of making every producer
    sanitise."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"cannot write {type(obj).__name__} into checkpoint "
                    "extras")


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array with the reference's bytes; bfloat16 as
    2-byte void records (what ``np.save`` of an ml_dtypes array
    writes)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _fsync_write(path: str, arr: Optional[np.ndarray] = None,
                 data: bytes = b"") -> None:
    """Write an array as ``.npy`` (or raw ``data``) and fsync it."""
    with open(path, "wb") as f:
        if arr is not None:
            np.save(f, arr)
        else:
            f.write(data)
        f.flush()
        os.fsync(f.fileno())


def save_pytree(state, directory: str, *,
                extra: Optional[dict] = None) -> None:
    """Write ``state`` (a nested dict of tensors or arrays) to
    ``directory`` atomically."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = tree.flatten_with_names(state)
    manifest = {"leaves": {}, "extra": extra or {}}
    for i, (name, leaf) in enumerate(sorted(flat.items())):
        arr = _to_host(leaf)
        fn = f"leaf_{i:05d}.npy"
        _fsync_write(os.path.join(tmp, fn), arr)
        manifest["leaves"][name] = {
            "file": fn, "shape": list(arr.shape),
            "dtype": _dtype_name(leaf, arr)}
    _fsync_write(os.path.join(tmp, MANIFEST),
                 data=json.dumps(manifest, default=_json_default).encode())
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def _as_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    # np.array, not np.ascontiguousarray, which makes a 0-d leaf 1-d
    if dtype_name == "bfloat16":
        bits = np.array(arr, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    if str(arr.dtype) != dtype_name:
        arr = arr.astype(dtype_name)
    return torch.from_numpy(np.array(arr, order="C"))


def restore_pytree(directory: str, like=None) -> Tuple[Any, dict]:
    """(state, extra). Without ``like``: name -> numpy array as stored
    (a bfloat16 leaf as its 2-byte records). With ``like``: a tree of
    its structure, each leaf a tensor on the device and in the dtype of
    ``like``'s leaf of that name."""
    with open(os.path.join(directory, MANIFEST)) as f:
        manifest = json.load(f)
    flat = {name: np.load(os.path.join(directory, meta["file"]))
            for name, meta in manifest["leaves"].items()}
    extra = manifest.get("extra", {})
    if like is None:
        return flat, extra

    def place(name: str, want: torch.Tensor) -> torch.Tensor:
        t = _as_tensor(flat[name], manifest["leaves"][name]["dtype"])
        return t.to(device=want.device, dtype=want.dtype)
    like_flat = tree.flatten_with_names(like)
    return tree.unflatten_like(like, {n: place(n, t)
                                      for n, t in like_flat.items()}), extra


class CheckpointManager:
    """Rolling async checkpoints with restart from the latest."""

    _STEP_RE = re.compile(r"^step_(\d+)$")

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------
    def save(self, step: int, state, *, extra: Optional[dict] = None,
             blocking: bool = True) -> None:
        """Write ``state`` as ``step_<step>``, after any save in flight
        (whose error, if it failed, raises here). A blocking save raises
        its own error at once; a non-blocking one on the next
        ``wait()``."""
        self.wait()                              # one in-flight save max
        host_state = tree.tree_map(_host_copy, state)  # device -> host
        if blocking:
            self._write(step, host_state, extra)
            self._raise_pending()
        else:
            self._thread = threading.Thread(
                # it gets host copies (_host_copy above): its torch calls
                # are isinstance tests and host reads, on no device
                # repro: ignore[torch-thread-no-device] -- host copies only
                target=self._write, args=(step, host_state, extra),
                daemon=True, name=f"checkpoint-step-{step}")
            self._thread.start()

    def save_async(self, step: int, state, *,
                   extra: Optional[dict] = None) -> None:
        self.save(step, state, extra=extra, blocking=False)

    def _write(self, step: int, host_state, extra) -> None:
        try:
            save_pytree(host_state, os.path.join(self.root, f"step_{step}"),
                        extra=dict(extra or {}, step=step,
                                   time=time.time()))
            self._gc()
        except Exception as e:  # raised by the next wait()
            self._last_error = e

    def _raise_pending(self) -> None:
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    # -- restore ------------------------------------------------------
    def steps(self):
        out = []
        for d in os.listdir(self.root):
            m = self._STEP_RE.match(d)
            if m and os.path.exists(os.path.join(self.root, d, MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def restore_latest(self, like=None):
        """(step, state, extra) of the newest complete checkpoint, or
        (None, None, {}) when there is none."""
        steps = self.steps()
        if not steps:
            return None, None, {}
        step = steps[-1]
        state, extra = restore_pytree(
            os.path.join(self.root, f"step_{step}"), like=like)
        return step, state, extra

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)


def _host_copy(leaf):
    """A host snapshot of one leaf that later steps cannot change."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)
