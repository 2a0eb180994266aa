"""Storage-backed training input: ingest -> shard loader -> exact resume.

Port of the reference's ``examples/storage_loader.py``. It walks the
full ``repro_torch.store`` loop on a small synthetic corpus:

1. ingest the corpus into crc32'd shards + manifest (``ShardWriter`` via
   ``jpeg.corpus.write_corpus_shards``);
2. stream it through the ``DataLoader`` with forked process workers that
   reopen the shards *by path* (no corpus bytes cross the pool
   boundary) and a window-shuffle sampler, decoding with ``numpy-fast``
   (the reference's path: forked workers hold no CUDA context);
3. checkpoint mid-epoch with ``CheckpointManager`` (the step counter on
   the device, the loader state in the manifest's extras; the port's
   manifest is ``manifest.json`` where the reference writes msgpack) and
   restore into a fresh loader: the rest of the epoch replays exactly;
4. print the memory-vs-shard throughput pair, i.e. the protocol axis the
   bench sweep measures as ``loader/<path>/wN/<mode>[/shard]``.

Run on the card (``--device cpu`` for the CPU):

    PYTHONPATH=src python -m repro_torch.examples.storage_loader
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.loader import DataLoader, LoaderConfig
from repro_torch.device import add_device_flag, on_device
from repro_torch.jpeg.corpus import (build_corpus, corpus_fingerprint,
                                     load_corpus_shards, write_corpus_shards)

PATH = "numpy-fast"


def run_epoch(loader) -> float:
    """One epoch of ``loader``; images per second."""
    t0 = time.perf_counter()
    n = sum(batch["image"].shape[0] for batch in loader)
    return n / (time.perf_counter() - t0)


def main(argv: Optional[Sequence[str]] = None, *,
         corpus_n: int = 32) -> Dict[str, Any]:
    """Run the loop; returns what it printed. ``corpus_n`` is the
    reference's 32, smaller in tests."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_flag(ap)
    args = ap.parse_args(argv)
    with on_device(args.device) as dev:
        return _run(dev, corpus_n)


def _run(dev: torch.device, corpus_n: int) -> Dict[str, Any]:
    corpus = build_corpus(corpus_n, seed=0)
    out: Dict[str, Any] = {}
    with tempfile.TemporaryDirectory(prefix="shard-demo-") as root:
        manifest = write_corpus_shards(corpus, root, shard_size=8)
        source = load_corpus_shards(root)
        print(f"ingested {len(source)} records -> {manifest}")
        print(f"fingerprint {source.fingerprint} "
              f"(corpus: {corpus_fingerprint(corpus)})")
        out.update(records=len(source), fingerprint=source.fingerprint,
                   corpus_fingerprint=corpus_fingerprint(corpus))

        cfg = LoaderConfig(batch_size=8, num_workers=2, mode="process",
                           shuffle=True, shuffle_window=8, seed=3)
        shard_dl = DataLoader(source, None, cfg=cfg, path_name=PATH)
        handle, _, _ = shard_dl._proc_initargs()
        print(f"worker handle: {type(handle).__name__} -> {handle.root} "
              "(workers mmap the shards; no bytes in initargs)")
        out["handle"] = type(handle).__name__

        # -- mid-epoch checkpoint / exact resume ------------------------
        it = iter(shard_dl)
        first = next(it)["label"]
        with tempfile.TemporaryDirectory(prefix="ckpt-") as ck:
            mgr = CheckpointManager(ck)
            mgr.save(1, {"step": torch.ones((), dtype=torch.int32,
                                            device=dev)},
                     extra={"loader": shard_dl.state()})
            rest_live = [int(x) for b in it for x in b["label"]]
            step, state, extra = mgr.restore_latest(
                like={"step": torch.zeros((), dtype=torch.int32,
                                          device=dev)})
            resumed = DataLoader(load_corpus_shards(root), None,
                                 cfg=cfg, path_name=PATH)
            resumed.restore(extra["loader"])
            rest_resumed = [int(x) for b in resumed for x in b["label"]]
            resumed.close()
            if rest_live != rest_resumed:
                raise AssertionError(
                    f"resume replayed {rest_resumed}, the live loader "
                    f"went on with {rest_live}")
            print(f"resume parity ok: {len(first)} consumed, "
                  f"{len(rest_resumed)} replayed identically (step "
                  f"{int(state['step'])} restored on "
                  f"{state['step'].device})")
            out.update(first=[int(x) for x in first], rest=rest_resumed,
                       parity=True, restored_step=step)

        # -- the source axis, measured ----------------------------------
        mem_dl = DataLoader(corpus.files, corpus.labels, cfg=cfg,
                            path_name=PATH)
        out["memory_img_s"] = run_epoch(mem_dl)
        out["shard_img_s"] = run_epoch(shard_dl)
        print(f"memory loader: {out['memory_img_s']:8.1f} img/s")
        print(f"shard  loader: {out['shard_img_s']:8.1f} img/s "
              "(same corpus, mmap-backed)")
        mem_dl.close()
        shard_dl.close()
        source.close()
    return out


if __name__ == "__main__":
    main()
