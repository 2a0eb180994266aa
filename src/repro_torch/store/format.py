"""Shard container format: fixed binary header, crc32'd record index,
JSON manifest — the on-disk shape of a decode corpus.

One shard file (all integers little-endian):

    [0:8)     magic ``b"RPSHRD01"``
    [8:12)    u32 format version (currently 1)
    [12:16)   u32 record count
    [16:24)   u64 index offset (end of the data region)
    [24:32)   u64 reserved (zero)
    [32:idx)  record payloads, back to back, in index order
    [idx:..)  index: per record ``(u64 offset, u64 length, u32 crc32)``
    [..:+4)   u32 crc32 of the raw index block

The index (and its own crc) is validated eagerly when a shard is opened,
so truncation — the classic interrupted-copy failure — surfaces as a
typed ``ShardCorruption`` at open, not as garbage pixels three stages
later. Record payload crc32s are verified lazily, once per record on
first access; after that a record read is a zero-copy ``memoryview``
into the shard's mmap.

Beside the shard files sits ``manifest.json``: per-record labels and
content hashes, the shard list, free-form corpus metadata, and the
**corpus fingerprint** (an order-sensitive digest over record hashes and
labels). Two corpora with equal fingerprints hold byte-identical records
in the same order — the invariant the bench harness checks before it
compares a storage-backed cell against its in-memory twin.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import mmap
import os
import struct
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs import trace

MAGIC = b"RPSHRD01"
FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = "repro-shard"

_HEADER = struct.Struct("<8sIIQQ")           # magic, ver, n, index_off, rsvd
_ENTRY = struct.Struct("<QQI")               # offset, length, crc32
HEADER_SIZE = _HEADER.size
ENTRY_SIZE = _ENTRY.size


class ShardError(Exception):
    """Structural problem with a shard directory (missing manifest,
    unknown format, fingerprint mismatch)."""


class ShardCorruption(ShardError):
    """A shard file fails validation: bad magic, truncation, index or
    record crc32 mismatch."""


def content_hash(data) -> str:
    """Stable per-record content hash (blake2b-128 hex) of the raw
    compressed bytes; accepts any buffer object."""
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def corpus_fingerprint(hashes: Iterable[str],
                       labels: Iterable[int]) -> str:
    """Order-sensitive corpus identity over (record hash, label) pairs."""
    h = hashlib.blake2b(digest_size=16)
    for rec_hash, label in zip(hashes, labels):
        h.update(rec_hash.encode())
        h.update(str(int(label)).encode())
    return h.hexdigest()


def manifest_path(root: str) -> str:
    return os.path.join(root, MANIFEST_NAME)


def load_manifest(root: str) -> dict:
    path = manifest_path(root)
    if not os.path.exists(path):
        raise ShardError(f"no shard manifest at {path}")
    with open(path) as f:
        man = json.load(f)
    if man.get("format") != MANIFEST_FORMAT:
        raise ShardError(
            f"{path}: format {man.get('format')!r} is not "
            f"{MANIFEST_FORMAT!r}")
    if man.get("version") != FORMAT_VERSION:
        raise ShardError(
            f"{path}: version {man.get('version')!r} is not "
            f"{FORMAT_VERSION}")
    for key in ("record_count", "shards", "labels", "content_hashes",
                "fingerprint"):
        if key not in man:
            raise ShardError(f"{path}: manifest missing {key!r}")
    return man


# ------------------------------------------------------------------ writer
class ShardWriter:
    """Stream records into rolling shard files + one manifest.

    ::

        with ShardWriter(out_dir, shard_size=64) as w:
            for data, label in records:
                w.add(data, label)
        print(w.manifest_path)

    ``finalize()`` (implicit on clean ``with``-exit) writes the manifest
    last, via tmp-file + atomic rename: a directory with a manifest is a
    complete corpus, one without is an aborted ingest.
    """

    def __init__(self, root: str, *, shard_size: int = 64,
                 meta: Optional[dict] = None):
        if shard_size < 1:
            raise ValueError(f"shard_size must be >= 1, got {shard_size}")
        self.root = root
        self.shard_size = shard_size
        self.meta = dict(meta or {})
        os.makedirs(root, exist_ok=True)
        self._labels: List[int] = []
        self._hashes: List[str] = []
        self._shards: List[dict] = []
        self._file = None
        self._entries: List[Tuple[int, int, int]] = []
        self._offset = 0
        self._finalized = False

    # -- one shard file ------------------------------------------------
    def _shard_name(self) -> str:
        return f"shard_{len(self._shards):05d}.bin"

    def _open_shard(self) -> None:
        self._entries = []
        self._offset = HEADER_SIZE
        path = os.path.join(self.root, self._shard_name())
        self._file = open(path, "wb")
        self._file.write(b"\x00" * HEADER_SIZE)     # backpatched on close

    def _close_shard(self) -> None:
        if self._file is None:
            return
        index = b"".join(_ENTRY.pack(*e) for e in self._entries)
        self._file.write(index)
        self._file.write(struct.pack("<I", zlib.crc32(index)))
        self._file.seek(0)
        self._file.write(_HEADER.pack(MAGIC, FORMAT_VERSION,
                                      len(self._entries), self._offset, 0))
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        self._shards.append({"file": self._shard_name(),
                             "records": len(self._entries),
                             "bytes": self._offset + len(index) + 4})
        self._file = None

    # -- public --------------------------------------------------------
    def add(self, data, label: int = 0) -> int:
        """Append one record; returns its global index."""
        if self._finalized:
            raise ShardError("ShardWriter is finalized")
        if self._file is None:
            self._open_shard()
        buf = bytes(data)
        self._file.write(buf)
        self._entries.append((self._offset, len(buf), zlib.crc32(buf)))
        self._offset += len(buf)
        self._labels.append(int(label))
        self._hashes.append(content_hash(buf))
        if len(self._entries) >= self.shard_size:
            self._close_shard()
        return len(self._labels) - 1

    @property
    def manifest_path(self) -> str:
        return manifest_path(self.root)

    def finalize(self) -> str:
        if self._finalized:
            return self.manifest_path
        self._close_shard()
        man = {
            "format": MANIFEST_FORMAT,
            "version": FORMAT_VERSION,
            "record_count": len(self._labels),
            "shards": self._shards,
            "labels": self._labels,
            "content_hashes": self._hashes,
            "fingerprint": corpus_fingerprint(self._hashes, self._labels),
            "meta": self.meta,
        }
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(man, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.manifest_path)
        self._finalized = True
        return self.manifest_path

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.finalize()
        elif self._file is not None:        # aborted ingest: no manifest
            self._file.close()
            self._file = None


# ------------------------------------------------------------------ reader
@dataclasses.dataclass(frozen=True)
class _IndexEntry:
    offset: int
    length: int
    crc32: int


class ShardReader:
    """mmap one shard file; serve records as zero-copy ``memoryview``s.

    Header + index (+ index crc) are validated at open; per-record
    payload crc32 is checked on first access only, so steady-state reads
    touch no checksum arithmetic and copy no bytes.
    """

    def __init__(self, path: str):
        self.path = path
        try:
            size = os.path.getsize(path)
        except OSError as e:
            raise ShardError(f"cannot stat shard {path}: {e}") from None
        if size < HEADER_SIZE:
            raise ShardCorruption(f"{path}: truncated header "
                                  f"({size} < {HEADER_SIZE} bytes)")
        # the open span covers mmap + eager index validation — the page
        # faults and checksum work a traced timeline should attribute to
        # storage, not to the first decode that touches the shard
        with trace.span("store.shard_open", file=os.path.basename(path)):
            self._f = open(path, "rb")
            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 access=mmap.ACCESS_READ)
            self._view = memoryview(self._mm)
            try:
                magic, version, n, index_off, _ = \
                    _HEADER.unpack_from(self._mm)
                if magic != MAGIC:
                    raise ShardCorruption(f"{path}: bad magic {magic!r}")
                if version != FORMAT_VERSION:
                    raise ShardCorruption(
                        f"{path}: unsupported shard version {version}")
                index_end = index_off + n * ENTRY_SIZE
                if index_end + 4 > size:
                    raise ShardCorruption(
                        f"{path}: truncated shard — index needs "
                        f"{index_end + 4} bytes, file has {size}")
                index = bytes(self._view[index_off:index_end])
                (want_crc,) = struct.unpack_from("<I", self._mm, index_end)
                if zlib.crc32(index) != want_crc:
                    raise ShardCorruption(f"{path}: index crc32 mismatch")
                self.entries = [
                    _IndexEntry(*_ENTRY.unpack_from(index, k * ENTRY_SIZE))
                    for k in range(n)]
                for k, e in enumerate(self.entries):
                    if e.offset < HEADER_SIZE or \
                            e.offset + e.length > index_off:
                        raise ShardCorruption(
                            f"{path}: record {k} spans outside the data "
                            "region")
            except ShardError:
                self.close()
                raise
            self._verified = [False] * n

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, i: int) -> memoryview:
        with trace.span("store.record_read"):
            e = self.entries[i]
            view = self._view[e.offset:e.offset + e.length]
            if not self._verified[i]:
                # first touch only: steady-state reads skip the span too
                with trace.span("store.crc_verify", record=i):
                    if zlib.crc32(view) != e.crc32:
                        raise ShardCorruption(
                            f"{self.path}: record {i} crc32 mismatch "
                            "(corrupt payload)")
                self._verified[i] = True
            return view

    def close(self) -> None:
        view, self._view = getattr(self, "_view", None), None
        if view is not None:
            view.release()
        mm = getattr(self, "_mm", None)
        if mm is not None:
            self._mm = None
            try:
                mm.close()
            except BufferError:
                # a caller still holds a record memoryview; dropping our
                # reference lets refcounting unmap once the views die —
                # never invalidate live zero-copy views under a reader
                pass
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "ShardReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_shards(records: Iterable[Tuple[bytes, int]], root: str, *,
                 shard_size: int = 64,
                 meta: Optional[dict] = None) -> str:
    """Convenience: ingest an iterable of (data, label) pairs; returns
    the manifest path."""
    with ShardWriter(root, shard_size=shard_size, meta=meta) as w:
        for data, label in records:
            w.add(data, label)
    return w.manifest_path


def shard_paths(root: str, man: Optional[Dict] = None) -> List[str]:
    man = man or load_manifest(root)
    return [os.path.join(root, s["file"]) for s in man["shards"]]
