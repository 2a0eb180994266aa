"""The port's data loader, on the CPU.

The first part mirrors tests/test_loader.py function by function on the
port's paths under ``use_device("cpu")``: ``numpy-fast`` and
``strict-fast`` come from the port's registry, ``torch-batch`` takes the
place of ``jnp-batch``, and a ``torch-*`` or ``cuda-*`` path the place
of the jax path in the process-mode rejection.

The second part holds the port's loader to the reference's on the same
seeded corpus: ``numpy-fast`` batches byte for byte, ``torch-batch``
within 1 level of ``jnp-batch`` (the tolerance of
tests/test_torch_paths.py's counterpart test), the same epoch orders
under full and window shuffle, and a port loader restored from a
reference loader's ``state()`` resuming the same order.

The third part is the port's own: the device crosses the loader's
threads and ``prefetch_to_device``'s producer, ``prefetch_to_device``
gives torch tensors, a decode failure that is not a refusal raises
instead of landing in the skip ledger, and first reads of the decoder
registry from several threads at once all find the built-in paths.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.data.loader import DataLoader as JDataLoader
from repro.data.loader import LoaderConfig as JLoaderConfig
from repro_torch import device
from repro_torch.codecs import get_decoder
from repro_torch.data import autotune_workers
from repro_torch.data.loader import (DataLoader, LoaderConfig, SkipLedger,
                                     center_fit, prefetch_to_device)
from repro_torch.jpeg.corpus import build_corpus
from repro_torch.jpeg.parser import UnsupportedJpeg

FAST = "numpy-fast"
STRICT = "strict-fast"


@pytest.fixture(autouse=True)
def _on_cpu():
    with device.use_device("cpu"):
        yield


def mkloader(corpus, path=FAST, **kw):
    kw.setdefault("batch_size", 5)
    cfg = LoaderConfig(**kw)
    return DataLoader(corpus.files, corpus.labels, get_decoder(path).fn,
                      cfg, path_name=path)


def fast_decode(data):
    return get_decoder(FAST).fn(data)


# ------------------------------------------- mirror of tests/test_loader.py
def test_batching_shapes_and_coverage(corpus):
    dl = mkloader(corpus)
    total = 0
    for batch in dl:
        assert batch["image"].dtype == np.uint8
        assert batch["image"].shape[1:] == (64, 64, 3)
        assert batch["image"].shape[0] == batch["label"].shape[0]
        total += batch["image"].shape[0]
    assert total == len(corpus.files)


def test_skip_ledger_strict(corpus):
    dl = mkloader(corpus, path=STRICT)
    total = sum(b["image"].shape[0] for b in dl)
    assert total == len(corpus.files) - 1
    assert dl.ledger.indices() == [corpus.rare_index]


@pytest.mark.parametrize("workers,mode", [(2, "thread"), (2, "process")])
def test_worker_modes_deliver_everything(corpus, workers, mode):
    dl = mkloader(corpus, num_workers=workers, mode=mode)
    total = sum(b["image"].shape[0] for b in dl)
    dl.close()
    assert total == len(corpus.files)


def test_thread_mode_preserves_order(corpus):
    dl0 = mkloader(corpus)
    dl2 = mkloader(corpus, num_workers=2)
    b0 = np.concatenate([b["label"] for b in dl0])
    b2 = np.concatenate([b["label"] for b in dl2])
    np.testing.assert_array_equal(b0, b2)


def test_thread_loader_batched_decode_matches_serial(corpus):
    """decode_batch chunks through the thread pool deliver the same
    ordered stream (images and labels) as the per-item serial loader."""
    serial = mkloader(corpus, path="torch-batch")
    chunked = mkloader(corpus, path="torch-batch", num_workers=2,
                       decode_batch=4)
    for bs, bc in zip(serial, chunked):
        np.testing.assert_array_equal(bs["image"], bc["image"])
        np.testing.assert_array_equal(bs["label"], bc["label"])


def test_thread_loader_batched_decode_skips_to_ledger(corpus):
    """Strict refusals inside a chunk land in the skip ledger per item,
    exactly as in per-item mode."""
    dl = mkloader(corpus, path=STRICT, num_workers=2, decode_batch=4)
    total = sum(b["image"].shape[0] for b in dl)
    assert total == len(corpus.files) - 1
    assert dl.ledger.indices() == [corpus.rare_index]


def test_batched_decode_rejects_straggler_backup(corpus):
    dl = mkloader(corpus, num_workers=2, decode_batch=4,
                  straggler_backup=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        next(iter(dl))


@pytest.mark.parametrize("path", ["torch-fused", "cuda-batch"])
def test_process_mode_rejects_torch_and_cuda_paths(corpus, path):
    dl = mkloader(corpus, path=path, num_workers=2, mode="process")
    with pytest.raises(RuntimeError, match="not process-loader eligible"):
        next(iter(dl))
    assert dl._pool is None                  # refused before any fork


def test_checkpointable_iterator_state(corpus):
    dl = mkloader(corpus, batch_size=4)
    it = iter(dl)
    next(it)
    next(it)
    state = dl.state()
    assert state["cursor"] == 8
    dl2 = mkloader(corpus, batch_size=4)
    dl2.restore(state)
    rest = [b["label"] for b in dl2]
    # remaining items only
    assert sum(len(l) for l in rest) == len(corpus.files) - 8


def test_sharding_partition(corpus):
    a = mkloader(corpus, shard_index=0, shard_count=2)
    b = mkloader(corpus, shard_index=1, shard_count=2)
    la = np.concatenate([x["label"] for x in a])
    lb = np.concatenate([x["label"] for x in b])
    assert len(la) + len(lb) == len(corpus.files)


def test_straggler_backup_mode(corpus):
    dl = mkloader(corpus, num_workers=2, straggler_backup=True,
                  straggler_factor=50.0)
    total = sum(b["image"].shape[0] for b in dl)
    assert total == len(corpus.files)


def test_straggler_backup_recovers_slow_items(corpus):
    calls = {"n": 0}
    slow_once = {"done": False}

    def decode(data):
        calls["n"] += 1
        if not slow_once["done"] and calls["n"] == 10:
            slow_once["done"] = True
            time.sleep(0.5)      # one pathological straggler
        return fast_decode(data)

    cfg = LoaderConfig(batch_size=4, num_workers=2, straggler_backup=True,
                       straggler_factor=2.0)
    dl = DataLoader(corpus.files, corpus.labels, decode, cfg)
    total = sum(b["image"].shape[0] for b in dl)
    assert total == len(corpus.files)


def test_autotuner_returns_member_of_candidates(corpus):
    def factory(w):
        return mkloader(corpus, num_workers=w)
    res = autotune_workers(factory, candidates=(0, 2), max_items=10,
                           repeats=1)
    assert res["best"] in (0, 2)
    assert set(res["sweep"]) == {0, 2}


def test_straggler_backup_dispatch_races_and_wins(corpus):
    """Deterministic cover for the budget-timeout -> backup-race -> cancel
    path: one primary decode stalls past the latency budget; the backup
    dispatch must serve the item (second call) while the primary hangs."""
    stall = threading.Event()
    lock = threading.Lock()
    counts = {}
    target = corpus.files[9]

    def decode(data):
        with lock:
            counts[data] = c = counts.get(data, 0) + 1
        if data == target and c == 1:
            stall.wait(timeout=30)       # primary attempt hangs
        return fast_decode(data)

    cfg = LoaderConfig(batch_size=4, num_workers=2, straggler_backup=True,
                       straggler_factor=2.0)
    dl = DataLoader(corpus.files, corpus.labels, decode, cfg)
    try:
        total = sum(b["image"].shape[0] for b in dl)
    finally:
        stall.set()                      # release the stalled worker
    assert total == len(corpus.files)    # delivered exactly once each
    assert counts[target] == 2           # backup dispatch actually ran


def test_prefetch_to_device_propagates_producer_error(corpus):
    def exploding():
        yield {"image": np.zeros((1, 4, 4, 3), np.uint8)}
        raise RuntimeError("decode pipeline died")

    it = prefetch_to_device(exploding(), size=2)
    next(it)
    with pytest.raises(RuntimeError, match="decode pipeline died"):
        for _ in it:                     # must raise, not block forever
            pass


def test_prefetch_to_device_immediate_producer_error():
    def dead():
        raise ValueError("no data")
        yield                            # pragma: no cover

    with pytest.raises(ValueError, match="no data"):
        list(prefetch_to_device(dead(), size=1))


def _producers_alive():
    return [t for t in threading.enumerate()
            if t.name == "prefetch-producer" and t.is_alive()]


def test_prefetch_to_device_stops_producer_on_abandon():
    def endless():
        while True:
            yield {"x": np.zeros((4,), np.uint8)}

    it = prefetch_to_device(endless(), size=1)
    next(it)
    it.close()                           # abandon with a full queue
    for _ in range(100):                 # producer must notice and exit
        alive = _producers_alive()
        if not alive:
            break
        time.sleep(0.05)
    assert not alive


def test_cursor_advances_past_skips_no_replay(corpus):
    """Checkpoint-cursor drift: skipped items must advance the cursor, so
    restore resumes at the right epoch position instead of replaying."""
    rare = corpus.rare_index
    dl = mkloader(corpus, path=STRICT, batch_size=4)
    it = iter(dl)
    seen = list(next(it)["label"]) + list(next(it)["label"])
    # the batch yields right after the 8th delivered image, so the skip is
    # consumed by then only if it sits among the first 8 epoch positions
    consumed = 8 + (1 if rare < 8 else 0)
    assert dl.state()["cursor"] == consumed
    state = dl.state()
    dl2 = mkloader(corpus, path=STRICT, batch_size=4)
    dl2.restore(state)
    rest = np.concatenate([b["label"] for b in dl2])
    # resumed epoch delivers exactly the remaining non-skipped items
    delivered = len(seen) + len(rest)
    assert delivered == len(corpus.files) - 1
    expect = [corpus.labels[i] for i in range(len(corpus.files))
              if i != rare]
    np.testing.assert_array_equal(np.concatenate([seen, rest]), expect)


def test_shuffled_epoch_resumes_exactly(corpus):
    """The permutation is a pure function of (seed, epoch): restoring
    mid-epoch under shuffle continues the same order — no replayed and no
    dropped items."""
    dl = mkloader(corpus, batch_size=4, shuffle=True, seed=5)
    it = iter(dl)
    seen = list(next(it)["label"])
    state = dl.state()
    rest_original = [lab for b in it for lab in b["label"]]

    dl2 = mkloader(corpus, batch_size=4, shuffle=True, seed=5)
    dl2.restore(state)
    rest_restored = [lab for b in dl2 for lab in b["label"]]
    np.testing.assert_array_equal(rest_restored, rest_original)
    assert sorted(seen + rest_restored) == sorted(corpus.labels)
    # different epochs draw different permutations
    order0 = mkloader(corpus, shuffle=True, seed=5)._epoch_order()
    dl3 = mkloader(corpus, shuffle=True, seed=5)
    dl3.epoch = 1
    assert list(order0) != list(dl3._epoch_order())


def test_straggler_unsupported_item_recorded_once(corpus):
    """A straggler that is also unsupported must hit the ledger exactly
    once, even when the backup dispatch races the stalled primary."""
    release = threading.Event()
    lock = threading.Lock()
    counts = {}
    target = corpus.files[10]

    def decode(data):
        with lock:
            counts[data] = c = counts.get(data, 0) + 1
        if data == target:
            if c == 1:
                release.wait(timeout=30)   # stall primary past the budget
            raise UnsupportedJpeg("rare mode")
        return fast_decode(data)

    cfg = LoaderConfig(batch_size=4, num_workers=2, straggler_backup=True,
                       straggler_factor=2.0)
    dl = DataLoader(corpus.files, corpus.labels, decode, cfg)
    try:
        total = sum(b["image"].shape[0] for b in dl)
    finally:
        release.set()
    assert total == len(corpus.files) - 1
    assert counts[target] == 2                   # backup really dispatched
    time.sleep(0.1)                              # let the primary unwind
    assert dl.ledger.indices() == [10]           # recorded exactly once


def test_skip_ledger_count_thread_safe():
    led = SkipLedger()

    def hammer(k):
        for j in range(200):
            led.record(k * 200 + j, "r")
            assert led.count >= 0

    ts = [threading.Thread(target=hammer, args=(k,)) for k in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert led.count == 800
    assert len(led.indices()) == 800


@pytest.fixture(scope="module")
def mixed_corpus():
    """Half-progressive corpus (plus the rare YCCK image): the skip
    surface a baseline-only decode path sees in a mixed deployment."""
    c = build_corpus(12, seed=7, progressive=0.5)
    assert c.progressive_indices          # the draw actually fired
    return c


def test_mixed_corpus_strict_path_skips_to_ledger(mixed_corpus):
    """A path without Capabilities.progressive skips every progressive
    image (and the rare YCCK one); throughput counts only delivered
    items and every skip is recorded, none double-counted."""
    c = mixed_corpus
    expect = sorted(set(c.progressive_indices) | {c.rare_index})
    dl = mkloader(c, path=STRICT)
    total = sum(b["image"].shape[0] for b in dl)
    assert total == len(c.files) - len(expect)
    assert dl.ledger.indices() == expect


def test_mixed_corpus_progressive_path_delivers_everything(mixed_corpus):
    dl = mkloader(mixed_corpus, num_workers=2)
    total = sum(b["image"].shape[0] for b in dl)
    assert total == len(mixed_corpus.files)
    assert dl.ledger.indices() == []


def test_mixed_corpus_resume_does_not_replay_skips(mixed_corpus):
    """Mid-epoch checkpoint/restore on the mixed corpus: the cursor has
    advanced past consumed skips, so the resumed epoch delivers exactly
    the remaining non-skipped items — no replays, no drops."""
    c = mixed_corpus
    skips = set(c.progressive_indices) | {c.rare_index}
    dl = mkloader(c, path=STRICT, batch_size=3)
    it = iter(dl)
    seen = list(next(it)["label"])
    state = dl.state()
    assert state["cursor"] > len(seen)    # skips advanced the cursor too
    dl2 = mkloader(c, path=STRICT, batch_size=3)
    dl2.restore(state)
    rest = [lab for b in dl2 for lab in b["label"]]
    assert len(seen) + len(rest) == len(c.files) - len(skips)
    expect = [c.labels[i] for i in range(len(c.files)) if i not in skips]
    np.testing.assert_array_equal(np.concatenate([seen, rest]), expect)


def test_center_fit_properties():
    img = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    out = center_fit(img, 8, 4)
    assert out.shape == (8, 4, 3)
    out2 = center_fit(img, 4, 4)
    assert out2.shape == (4, 4, 3)


# ------------------------------------------- against the reference loader
def jloader(corpus, path=FAST, **kw):
    kw.setdefault("batch_size", 5)
    return JDataLoader(corpus.files, corpus.labels, cfg=JLoaderConfig(**kw),
                       path_name=path)


def _max_diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) -
                      np.asarray(b).astype(int)).max())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_workers=2),
    dict(num_workers=2, decode_batch=4, shuffle=True, seed=3),
])
def test_numpy_fast_batches_equal_the_references_byte_for_byte(corpus, kw):
    got = list(mkloader(corpus, **kw))
    want = list(jloader(corpus, **kw))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])


def test_torch_batch_batches_within_one_level_of_jnp_batch(corpus):
    kw = dict(num_workers=2, decode_batch=4)
    got = list(mkloader(corpus, path="torch-batch", **kw))
    want = list(jloader(corpus, path="jnp-batch", **kw))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g["image"].shape == w["image"].shape
        assert _max_diff(g["image"], w["image"]) <= 1
        np.testing.assert_array_equal(g["label"], w["label"])


@pytest.mark.parametrize("window", [0, 1, 4, 64])
def test_epoch_orders_equal_the_references(corpus, window):
    kw = dict(shuffle=True, seed=9, shuffle_window=window, shard_index=1,
              shard_count=2)
    a, b = mkloader(corpus, **kw), jloader(corpus, **kw)
    for epoch in range(3):
        a.epoch = b.epoch = epoch
        np.testing.assert_array_equal(a._epoch_order(), b._epoch_order())


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=True, seed=5),
                                dict(shuffle=True, seed=5, shuffle_window=3)])
def test_state_from_the_references_loader_resumes_the_same_order(corpus, kw):
    ref = jloader(corpus, path=STRICT, batch_size=4, **kw)
    it = iter(ref)
    next(it)
    next(it)
    state = ref.state()
    rest_ref = [lab for b in it for lab in b["label"]]
    port = mkloader(corpus, path=STRICT, batch_size=4, **kw)
    port.restore(state)
    rest = [lab for b in port for lab in b["label"]]
    np.testing.assert_array_equal(rest, rest_ref)
    assert port.ledger.indices() == ref.ledger.indices()
    assert port.state() == ref.state()


# ------------------------------------------------------- the port's own
@pytest.mark.parametrize("kw", [
    dict(num_workers=2),
    dict(num_workers=2, decode_batch=4),
    dict(num_workers=2, straggler_backup=True, straggler_factor=50.0),
])
def test_the_device_crosses_the_loaders_threads(monkeypatch, corpus, kw):
    """A loader built under ``use_device("cpu")`` decodes ``torch-batch``
    in its worker threads on the CPU: the threads do not inherit the
    scope, so the loader re-enters the device it was built under. With
    no card visible, a thread that ran on the default ``cuda:0`` would
    raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dl = mkloader(corpus, path="torch-batch", **kw)
    assert dl.device == torch.device("cpu")
    with device.use_device("cuda:0"):    # the consumer's scope is not it
        total = sum(b["image"].shape[0] for b in dl)
    assert total == len(corpus.files)
    assert dl.ledger.indices() == []


def test_the_device_crosses_into_the_prefetch_producer(monkeypatch, corpus):
    """``prefetch_to_device`` reads the device in the caller's thread
    and re-enters it in its producer, where the iterator's own torch
    decode then runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dec = get_decoder("torch-batch")

    def batches():
        for f in corpus.files[:3]:
            yield {"image": dec.fn(f)[None]}

    out = list(prefetch_to_device(batches(), size=1))
    assert len(out) == 3
    for got, f in zip(out, corpus.files[:3]):
        assert got["image"].device == torch.device("cpu")
        np.testing.assert_array_equal(got["image"][0].numpy(), dec.fn(f))


def test_prefetch_to_device_gives_tensors_equal_to_the_batches(corpus):
    dl = mkloader(corpus, path="cuda-batch", num_workers=2, decode_batch=4)
    want = list(mkloader(corpus, path="cuda-batch"))
    got = list(prefetch_to_device(iter(dl), size=2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == {"image", "label"}
        for key in g:
            assert isinstance(g[key], torch.Tensor)
            assert g[key].device == torch.device("cpu")
            np.testing.assert_array_equal(g[key].numpy(), w[key])


def test_prefetch_to_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with device.use_device("cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            prefetch_to_device(iter([]))


@pytest.mark.parametrize("decode_batch", [0, 4])
def test_a_decode_failure_raises_and_is_not_a_skip(corpus, decode_batch):
    """Only refusals (``UnsupportedJpeg``, ``CorruptJpeg``) are skips: a
    failure such as a kernel launch error fails the batch."""
    target = corpus.files[6]

    def decode(data):
        if data == target:
            raise RuntimeError("kernel launch failed")
        return fast_decode(data)

    def decode_batch_fn(datas):
        out = []
        for d in datas:
            try:
                out.append(decode(d))
            except RuntimeError as e:
                out.append(e)
        return out

    cfg = LoaderConfig(batch_size=4, num_workers=2,
                       decode_batch=decode_batch)
    dl = DataLoader(corpus.files, corpus.labels, decode, cfg,
                    batch_decode_fn=decode_batch_fn)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        for _ in dl:
            pass
    assert dl.ledger.indices() == []


def test_first_registry_reads_from_several_threads_all_find_the_paths():
    """The registry imports its built-in paths at the first read. Reads
    that race it from other threads (a loader's workers are often the
    first to ask) wait for that import instead of finding an empty
    registry. Run in a fresh process, where nothing is imported yet."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    code = (
        "import json, threading\n"
        "from repro_torch.codecs import get_decoder\n"
        "start, out = threading.Barrier(6), []\n"
        "def read():\n"
        "    start.wait()\n"
        "    try:\n"
        "        out.append(get_decoder('numpy-fast').name)\n"
        "    except KeyError as e:\n"
        "        out.append(repr(e))\n"
        "ts = [threading.Thread(target=read) for _ in range(6)]\n"
        "[t.start() for t in ts]\n"
        "[t.join() for t in ts]\n"
        "print(json.dumps(out))\n")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert json.loads(run.stdout.strip().splitlines()[-1]) == \
        ["numpy-fast"] * 6
