"""The ``ByteSource`` protocol: what every corpus consumer reads from.

The paper's harness decodes a Python list of bytes; real DataLoader
deployments read sharded storage. ``ByteSource`` is the seam between the
two: the loader, the online service, and the bench harness all consume
this four-method contract instead of ``Sequence[bytes]``:

* ``len(src)`` / ``src[i]`` — record count and record payload. Shard
  sources return zero-copy ``memoryview``s into an mmap; in-memory
  sources return the original ``bytes``.
* ``src.label(i)`` and the vectorized ``src.labels`` — supervision.
* ``src.open_in_worker()`` — a small picklable handle a pool worker uses
  to (re)open the source on its side of a fork/spawn boundary. For a
  ``ShardSource`` the handle carries only the shard directory path, so
  workers mmap the corpus by path instead of inheriting (or pickling)
  every record — the storage analogue of "don't ship the dataset
  through ``initargs``".

``MemorySource`` is the trivial implementation that preserves the
paper's from-memory protocol; ``as_byte_source`` lifts a plain sequence
into one, so every existing call site keeps working.
"""
from __future__ import annotations

import bisect
import threading
from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.store.format import (ShardReader, load_manifest,
                                      manifest_path, shard_paths)


@runtime_checkable
class ByteSource(Protocol):
    """Indexable record store with labels and a worker-side reopen.

    ``labels`` (the vectorized view of ``label``) is part of the
    contract: the loader materializes it once per epoch instead of
    calling ``label(i)`` per item.
    """

    def __len__(self) -> int: ...

    def __getitem__(self, i: int): ...          # bytes-like payload

    def label(self, i: int) -> int: ...

    @property
    def labels(self) -> np.ndarray: ...         # int32 [n]

    def open_in_worker(self): ...               # picklable WorkerHandle


class WorkerHandle(Protocol):
    """Picklable capability to reopen a ByteSource inside a worker."""

    def open(self) -> ByteSource: ...


# ------------------------------------------------------------------ memory
class _MemoryHandle:
    """Worker handle for in-memory corpora. Under a fork pool the lists
    travel by copy-on-write page sharing; under spawn they would be
    pickled wholesale — which is exactly the cost the shard handle
    avoids, and why process-mode shard loaders scale where this cannot."""

    def __init__(self, files, labels):
        self._files = files
        self._labels = labels

    def open(self) -> "MemorySource":
        return MemorySource(self._files, self._labels)


class MemorySource:
    """The paper's protocol as a ByteSource: a list of bytes in RAM."""

    def __init__(self, files: Sequence[bytes],
                 labels: Optional[Sequence[int]] = None):
        self._files = files
        if labels is None:
            self._labels = np.zeros(len(files), np.int32)
        else:
            self._labels = np.asarray(labels, np.int32)
        if len(self._labels) != len(self._files):
            raise ValueError(
                f"{len(self._files)} records but {len(self._labels)} labels")

    def __len__(self) -> int:
        return len(self._files)

    def __getitem__(self, i: int):
        return self._files[i]

    def label(self, i: int) -> int:
        return int(self._labels[i])

    @property
    def labels(self) -> np.ndarray:
        return self._labels

    def open_in_worker(self) -> _MemoryHandle:
        return _MemoryHandle(self._files, self._labels)


# ------------------------------------------------------------------- shard
class _ShardHandle:
    """Worker handle for shard-backed corpora: the directory path only.
    Pickles to a few dozen bytes regardless of corpus size; each worker
    opens its own mmaps (page cache makes the maps shared anyway)."""

    def __init__(self, root: str):
        self.root = root

    def open(self) -> "ShardSource":
        return ShardSource(self.root)


class ShardSource:
    """mmap-backed ByteSource over a shard directory (see format.py).

    Records come back as zero-copy ``memoryview``s; shard files are
    opened lazily on first touch, so ``open_in_worker``-spawned copies
    in a large pool only map the shards their indices actually hit.
    """

    def __init__(self, root: str):
        self.root = root
        self.manifest = load_manifest(root)
        self._labels = np.asarray(self.manifest["labels"], np.int32)
        self._paths = shard_paths(root, self.manifest)
        counts = [s["records"] for s in self.manifest["shards"]]
        if sum(counts) != self.manifest["record_count"] or \
                len(self._labels) != self.manifest["record_count"]:
            raise ValueError(
                f"{manifest_path(root)}: shard record counts disagree "
                "with record_count")
        self._starts: List[int] = []
        acc = 0
        for c in counts:
            self._starts.append(acc)
            acc += c
        self._n = acc
        self._readers: List[Optional[ShardReader]] = [None] * len(counts)
        # guards lazy reader creation: thread-pool loaders touch a shard
        # concurrently and a lost race would leak an fd + duplicate mmap
        self._open_lock = threading.Lock()

    # -- ByteSource ----------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> memoryview:
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        s = bisect.bisect_right(self._starts, i) - 1
        reader = self._readers[s]
        if reader is None:
            with self._open_lock:
                reader = self._readers[s]
                if reader is None:
                    reader = self._readers[s] = ShardReader(self._paths[s])
        return reader.get(i - self._starts[s])

    def label(self, i: int) -> int:
        return int(self._labels[i])

    @property
    def labels(self) -> np.ndarray:
        return self._labels

    def open_in_worker(self) -> _ShardHandle:
        return _ShardHandle(self.root)

    # -- extras --------------------------------------------------------
    @property
    def fingerprint(self) -> str:
        return self.manifest["fingerprint"]

    @property
    def meta(self) -> dict:
        return self.manifest.get("meta", {})

    def close(self) -> None:
        with self._open_lock:
            for k, r in enumerate(self._readers):
                if r is not None:
                    r.close()
                    self._readers[k] = None

    def __enter__(self) -> "ShardSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def as_byte_source(files, labels=None) -> ByteSource:
    """Lift ``files`` into a ByteSource. An object already speaking the
    protocol passes through (``labels`` must then be None — the source
    owns its labels); a plain sequence wraps into a ``MemorySource``."""
    if hasattr(files, "open_in_worker"):
        if labels is not None:
            raise ValueError(
                "labels= conflicts with a ByteSource, which carries its "
                "own labels")
        return files
    return MemorySource(files, labels)
