"""The port's shard store, on the CPU.

The first part mirrors tests/test_store.py function by function on the
port's modules (``numpy-fast`` from the port's registry, loaders and
services built under ``use_device("cpu")``). The sampler's checkpoint
round trip goes through JSON: the port has no ``CheckpointManager`` yet.

The second part holds the port's copies to the reference's on the same
inputs: shard directories written by each package are equal byte for
byte and each package reads the other's, and the window-shuffle orders,
sampler states, content hashes and fingerprints are equal.
"""
import filecmp
import glob
import json
import os
import pickle

import numpy as np
import pytest

from repro.jpeg import corpus as jcorpus
from repro.store import ShardSource as JShardSource
from repro.store import WindowShuffleSampler as JSampler
from repro.store import format as jformat
from repro.store import window_shuffle_order as jwindow_shuffle_order
from repro_torch import device
from repro_torch.data.loader import DataLoader, LoaderConfig
from repro_torch.jpeg.corpus import (corpus_fingerprint, load_corpus_shards,
                                     write_corpus_shards)
from repro_torch.store import (MemorySource, ShardCorruption, ShardError,
                               ShardReader, ShardSource, WindowShuffleSampler,
                               as_byte_source, content_hash,
                               window_shuffle_order)

DECODE = "numpy-fast"


@pytest.fixture(autouse=True)
def _on_cpu():
    with device.use_device("cpu"):
        yield


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory, corpus):
    root = str(tmp_path_factory.mktemp("shards"))
    write_corpus_shards(corpus, root, shard_size=5)
    return root


def mkloader(files, labels=None, **kw):
    kw.setdefault("batch_size", 4)
    return DataLoader(files, labels, cfg=LoaderConfig(**kw),
                      path_name=DECODE)


# ------------------------------------------------------------- round trip
def test_writer_reader_round_trip_byte_identical(corpus, shard_dir):
    """Every record — including the rare YCCK member — comes back as a
    zero-copy memoryview over the exact ingested bytes, with its label;
    the manifest fingerprint matches the source corpus."""
    src = load_corpus_shards(shard_dir)
    assert len(src) == len(corpus.files)
    for i in range(len(src)):
        view = src[i]
        assert isinstance(view, memoryview)
        assert bytes(view) == corpus.files[i], i
        assert src.label(i) == int(corpus.labels[i])
    assert bytes(src[corpus.rare_index]) == corpus.files[corpus.rare_index]
    assert src.fingerprint == corpus_fingerprint(corpus)
    assert src.meta["rare_index"] == corpus.rare_index
    assert len(glob.glob(os.path.join(shard_dir, "shard_*.bin"))) > 1
    src.close()


def test_record_corruption_raises_typed_error(corpus, tmp_path):
    root = str(tmp_path / "shards")
    write_corpus_shards(corpus, root, shard_size=100)
    shard = glob.glob(os.path.join(root, "shard_*.bin"))[0]
    with open(shard, "r+b") as f:
        f.seek(40)                        # inside record 0's payload
        byte = f.read(1)
        f.seek(40)
        f.write(bytes([byte[0] ^ 0xFF]))
    src = ShardSource(root)
    with pytest.raises(ShardCorruption, match="crc32"):
        src[0]
    # a different record in the same shard still verifies
    assert bytes(src[len(src) - 1]) == corpus.files[len(src) - 1]
    src.close()


def test_truncated_shard_raises_at_open(corpus, tmp_path):
    root = str(tmp_path / "shards")
    write_corpus_shards(corpus, root, shard_size=100)
    shard = glob.glob(os.path.join(root, "shard_*.bin"))[0]
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) - 7)
    with pytest.raises(ShardCorruption, match="truncated"):
        ShardReader(shard)


def test_missing_manifest_is_shard_error(tmp_path):
    with pytest.raises(ShardError, match="manifest"):
        ShardSource(str(tmp_path))


# ---------------------------------------------------------------- sampler
def test_window_shuffle_is_pure_function_of_seed_epoch():
    a = window_shuffle_order(40, seed=3, epoch=1, window=8)
    b = window_shuffle_order(40, seed=3, epoch=1, window=8)
    assert (a == b).all()
    assert sorted(a) == list(range(40))           # a permutation
    assert list(a) != list(window_shuffle_order(40, 3, 2, 8))
    assert list(a) != list(window_shuffle_order(40, 4, 1, 8))
    # window=1 is sequential; window>=n is a full shuffle's support
    assert list(window_shuffle_order(10, 0, 0, 1)) == list(range(10))


def test_sampler_stream_matches_order_and_restores_mid_epoch():
    s = WindowShuffleSampler(30, seed=9, window=5)
    want = list(window_shuffle_order(30, 9, 0, 5))
    assert [next(s) for _ in range(30)] == want
    # epoch auto-advance draws the next epoch's permutation
    assert [next(s) for _ in range(30)] == \
        list(window_shuffle_order(30, 9, 1, 5))

    s2 = WindowShuffleSampler(30, seed=9, window=5)
    head = [next(s2) for _ in range(11)]
    state = s2.state()
    assert all(isinstance(v, int) for v in state.values())
    s3 = WindowShuffleSampler(30, seed=1, window=5)
    s3.restore(state)
    rest = [next(s3) for _ in range(19)]
    assert [next(s2) for _ in range(19)] == rest
    assert sorted(head + rest) == list(range(30))   # exactly one epoch


def test_sampler_state_round_trips_through_json(tmp_path):
    s = WindowShuffleSampler(25, seed=4, window=6)
    for _ in range(13):
        next(s)
    path = tmp_path / "sampler.json"
    path.write_text(json.dumps({"sampler": s.state()}))
    back = json.loads(path.read_text())
    s2 = WindowShuffleSampler(25, seed=0, window=6)
    s2.restore(back["sampler"])
    assert [next(s) for _ in range(12)] == [next(s2) for _ in range(12)]


# ----------------------------------------------------- loader integration
def test_shard_loader_batches_byte_identical_to_memory(corpus, shard_dir):
    mem = mkloader(corpus.files, corpus.labels)
    shard = mkloader(load_corpus_shards(shard_dir))
    batches = list(zip(mem, shard))
    assert batches
    for bm, bs in batches:
        np.testing.assert_array_equal(bm["image"], bs["image"])
        np.testing.assert_array_equal(bm["label"], bs["label"])


def test_shard_loader_thread_pool_delivers_everything(corpus, shard_dir):
    dl = mkloader(load_corpus_shards(shard_dir), num_workers=2)
    total = sum(b["image"].shape[0] for b in dl)
    assert total == len(corpus.files)


def test_process_workers_open_shard_by_path(corpus, shard_dir):
    """Process-mode workers reopen the shard via its path handle — the
    initargs that cross the pool boundary contain no corpus bytes and
    pickle to O(100) bytes regardless of corpus size."""
    dl = mkloader(load_corpus_shards(shard_dir), num_workers=2,
                  mode="process")
    handle, path_name, trace_cfg = dl._proc_initargs()
    assert trace_cfg is None                  # tracing off: nothing shipped
    blob = pickle.dumps((handle, path_name, trace_cfg))
    assert len(blob) < 512
    for probe in corpus.files[:3]:
        assert probe[:24] not in blob         # no record payload leaked
    # ...and the pool actually decodes through that handle
    total = sum(b["image"].shape[0] for b in dl)
    assert total == len(corpus.files)
    dl.close()


def test_process_pool_reused_across_epochs(corpus, shard_dir):
    dl = mkloader(load_corpus_shards(shard_dir), num_workers=2,
                  mode="process")
    for _ in dl:
        pass
    pool_first = dl._pool
    assert pool_first is not None             # hoisted, not per-epoch
    for _ in dl:
        pass
    assert dl._pool is pool_first             # same pool on epoch 2
    dl.close()
    assert dl._pool is None


def test_mid_epoch_resume_parity_shard_vs_memory(corpus, shard_dir):
    """Window-shuffled epochs are a pure function of (seed, epoch), so a
    checkpoint taken from a shard-backed loader restores into an
    in-memory loader (and vice versa) with the identical remainder."""
    kw = dict(shuffle=True, shuffle_window=4, seed=11)
    a = mkloader(load_corpus_shards(shard_dir), **kw)
    it = iter(a)
    seen = list(next(it)["label"])
    state = a.state()
    rest_shard = [lab for b in it for lab in b["label"]]

    m = mkloader(corpus.files, corpus.labels, **kw)
    m.restore(state)
    rest_mem = [lab for b in m for lab in b["label"]]
    np.testing.assert_array_equal(rest_shard, rest_mem)
    assert sorted(seen + rest_mem) == sorted(corpus.labels)


# ----------------------------------------------------- service integration
def test_service_submit_source_zero_copy(corpus, shard_dir):
    from repro_torch.service import DecodeService, ServiceConfig
    src = load_corpus_shards(shard_dir)
    assert isinstance(src[0], memoryview)     # what submit_source hands on
    with DecodeService(ServiceConfig(num_workers=0, cache_bytes=0),
                       paths=[DECODE]) as svc:
        img = svc.submit_source(src, 0).result()
    ref = mkloader(corpus.files, corpus.labels)  # reuse registered decode
    np.testing.assert_array_equal(img, ref.decode_fn(corpus.files[0]))
    src.close()


def test_as_byte_source_contract():
    files = [b"aa", b"bb"]
    src = as_byte_source(files, [1, 2])
    assert isinstance(src, MemorySource)
    assert len(src) == 2 and src[1] == b"bb" and src.label(0) == 1
    assert as_byte_source(src) is src
    with pytest.raises(ValueError, match="labels"):
        as_byte_source(src, [1, 2])
    # a plain sequence without labels must fail loudly, not train on the
    # MemorySource zero-fill
    with pytest.raises(ValueError, match="labels are required"):
        DataLoader(files, None, path_name=DECODE)


# ------------------------------------------------ against the reference
@pytest.mark.parametrize("shard_size", [1, 5, 100])
def test_shard_directories_are_equal_and_each_reads_the_other(
        corpus, tmp_path, shard_size):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "reference")
    write_corpus_shards(corpus, mine, shard_size=shard_size)
    jcorpus.write_corpus_shards(corpus, theirs, shard_size=shard_size)
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(theirs))
    assert len(names) == 1 + -(-len(corpus.files) // shard_size)
    match, mismatch, errors = filecmp.cmpfiles(mine, theirs, names,
                                               shallow=False)
    assert (mismatch, errors) == ([], [])
    for src in (ShardSource(theirs), JShardSource(mine)):
        assert len(src) == len(corpus.files)
        assert src.fingerprint == corpus_fingerprint(corpus) == \
            jcorpus.corpus_fingerprint(corpus)
        for i in range(len(src)):
            assert bytes(src[i]) == corpus.files[i]
            assert src.label(i) == int(corpus.labels[i])
        np.testing.assert_array_equal(src.labels, corpus.labels)
        src.close()


def test_store_helpers_equal_the_references(corpus):
    for f in corpus.files:
        assert content_hash(f) == jformat.content_hash(f)
        assert content_hash(memoryview(f)) == jformat.content_hash(f)
    for n, seed, epoch, window in [(0, 0, 0, 1), (1, 2, 3, 4),
                                   (40, 3, 1, 8), (100, 7, 2, 100),
                                   (33, 0, 5, 1)]:
        np.testing.assert_array_equal(
            window_shuffle_order(n, seed, epoch, window),
            jwindow_shuffle_order(n, seed, epoch, window))


def test_sampler_states_carry_between_the_packages():
    mine, theirs = WindowShuffleSampler(30, seed=2, window=7), \
        JSampler(30, seed=2, window=7)
    assert [next(mine) for _ in range(41)] == [next(theirs) for _ in
                                               range(41)]
    assert mine.state() == theirs.state()
    back, fwd = WindowShuffleSampler(30, window=7), JSampler(30, window=7)
    back.restore(theirs.state())
    fwd.restore(mine.state())
    assert [next(back) for _ in range(25)] == [next(theirs) for _ in
                                               range(25)]
    assert [next(fwd) for _ in range(25)] == [next(mine) for _ in range(25)]
