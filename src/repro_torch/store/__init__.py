"""Sharded corpus store (see DESIGN.md §7).

Three layers:

* **format** — the on-disk shard container (fixed header, per-record
  offset/length/crc32 index, JSON manifest with labels, content hashes,
  and the corpus fingerprint): ``ShardWriter`` to ingest,
  ``ShardReader`` to mmap one shard and serve zero-copy records.
* **source** — the ``ByteSource`` protocol every corpus consumer reads
  from (loader, service, bench): ``MemorySource`` (the paper's
  from-memory protocol), ``ShardSource`` (storage-backed), and
  ``open_in_worker()`` handles so pool workers reopen shards by path.
* **sampler** — ``WindowShuffleSampler`` / ``window_shuffle_order``:
  streaming window shuffle whose order is a pure function of
  (seed, epoch) and whose state checkpoints as three integers.
"""
from repro_torch.store.format import (ShardCorruption, ShardError,
                                      ShardReader, ShardWriter,
                                      content_hash, corpus_fingerprint,
                                      load_manifest, manifest_path,
                                      write_shards)
from repro_torch.store.sampler import WindowShuffleSampler, window_shuffle_order
from repro_torch.store.source import (ByteSource, MemorySource,
                                      ShardSource, as_byte_source)

__all__ = [
    "ShardCorruption", "ShardError", "ShardReader", "ShardWriter",
    "content_hash", "corpus_fingerprint", "load_manifest", "manifest_path",
    "write_shards",
    "WindowShuffleSampler", "window_shuffle_order",
    "ByteSource", "MemorySource", "ShardSource", "as_byte_source",
]
