"""Content-hash decode result cache with an LRU byte budget.

Online decode traffic is heavy-tailed: a small set of hot images accounts
for a large share of requests (thumbnails, avatars, recently-published
items). Caching decoded RGB by content hash converts repeat requests into
memory reads, independent of which decode path the router currently
favours. The budget is expressed in *bytes of decoded output* (the large
side of the transform), not entry count, so mixed-resolution corpora
cannot blow the budget.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np


def content_key(data: bytes) -> bytes:
    """Stable 16-byte content hash of the compressed input."""
    return hashlib.blake2b(data, digest_size=16).digest()


class DecodeCache:
    """Thread-safe LRU keyed by content hash, bounded by decoded bytes."""

    def __init__(self, capacity_bytes: int = 64 << 20):
        self.capacity_bytes = int(capacity_bytes)
        self._entries: "OrderedDict[bytes, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def size_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def get(self, key: bytes) -> Optional[np.ndarray]:
        with self._lock:
            img = self._entries.get(key)
            if img is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
        # private writable copy: hits behave exactly like fresh decodes
        # (callers may mutate in place) and can never poison the cache
        return img.copy()

    def put(self, key: bytes, img: np.ndarray) -> None:
        nb = int(img.nbytes)
        if nb > self.capacity_bytes:
            return                      # single item larger than the budget
        # store a private read-only copy, decoupled from the array the
        # first caller received (which stays writable)
        img = img.copy()
        img.setflags(write=False)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = img
            self._bytes += nb
            while self._bytes > self.capacity_bytes and self._entries:
                _, ev = self._entries.popitem(last=False)
                self._bytes -= ev.nbytes
                self.evictions += 1

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "capacity_bytes": self.capacity_bytes, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}
