"""Service load generators: the two standard serving-load models, moved
from the ad-hoc service benchmark into the bench subsystem so the scenario
harness and the thin `benchmarks/service_bench.py` view share one
implementation.

* **closed-loop** — K client threads, each submits its next request only
  after the previous completes (training jobs pulling batches). Reported
  as delivered images/s.
* **open-loop**  — requests arrive on a fixed schedule regardless of
  completion (an ingest endpoint under external traffic). Reported as
  delivered throughput, shed fraction, and p99 latency at an offered rate
  above capacity — overload must surface as explicit shedding with
  bounded latency, not collapse.

The serial baseline is the same request stream decoded inline with one
fixed path — the paper's single-thread protocol applied to service
traffic.

Everything runs on the device selected where these functions are called
(``repro_torch.device``); the closed loop's client threads re-enter it,
since a ``use_device`` scope does not reach a new thread.
"""
from __future__ import annotations

import threading
import time
from typing import List

from repro_torch.codecs import ExecContext, list_decoders, open_decoder
from repro_torch.device import selected_device, use_device
from repro_torch.jpeg.corpus import Corpus, zipf_indices
from repro_torch.service import (DecodeService, ServiceConfig,
                                 ServiceOverloaded)

BASELINE_PATH = "numpy-fast"


def request_stream(source, n_requests: int, seed: int) -> List[bytes]:
    """Zipf-weighted request mix over ``source`` — a ``Corpus`` or any
    ``repro_torch.store.ByteSource``. Shard-backed sources yield zero-copy
    ``memoryview`` payloads, which ``DecodeService.submit`` accepts
    as-is (hashing, probing, and decode all read the buffer in place)."""
    files = source.files if isinstance(source, Corpus) else source
    idx = zipf_indices(len(files), n_requests, seed)
    return [files[i] for i in idx]


def serial_baseline(stream: List[bytes],
                    path_name: str = BASELINE_PATH) -> float:
    with open_decoder(path_name) as dec:    # INLINE: the paper's protocol
        dec.warmup(stream[:1])
        t0 = time.perf_counter()
        for data in stream:
            # unwrap: a refused/corrupt item must fail the baseline loudly,
            # not inflate it with images that were never decoded
            dec.decode(data).unwrap()
        return len(stream) / (time.perf_counter() - t0)


def make_service(workers: int, seed: int = 0,
                 max_inflight: int = 64) -> DecodeService:
    cfg = ServiceConfig(num_workers=workers, max_inflight=max_inflight,
                        max_batch=8, max_wait_ms=2.0, seed=seed)
    # CI-cheap arm set: the fork-safe (numpy) non-strict decoders — the
    # PROCESS_POOL context filter is the resolver-backed spelling of the
    # old list_paths(process_eligible=True)
    return DecodeService(cfg, paths=list_decoders(
        context=ExecContext.PROCESS_POOL, strict=False))


def closed_loop(stream: List[bytes], workers: int,
                clients: int = 4) -> dict:
    dev = selected_device()
    with make_service(workers) as svc:
        chunks = [stream[k::clients] for k in range(clients)]

        def client(cid, chunk):
            with use_device(dev):
                for data in chunk:
                    svc.decode(data, client=cid)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(f"c{k}", ch))
                   for k, ch in enumerate(chunks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        snap = svc.stats()
    return {"throughput_ips": len(stream) / dt,
            "router_best": snap["router_best"],
            "cache_hits": snap["service"]["cache_hits"],
            "p99_s": snap["service"]["latency_s"]["p99"]}


def open_loop(stream: List[bytes], workers: int,
              offered_rps: float) -> dict:
    delivered = 0
    shed = 0
    futs = []
    # small in-flight budget: the sustained-overload regime, where the
    # correct behavior is explicit shedding with bounded queue latency
    with make_service(workers, max_inflight=16) as svc:
        period = 1.0 / offered_rps
        t0 = time.perf_counter()
        for k, data in enumerate(stream):
            target = t0 + k * period
            lag = target - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            try:
                futs.append(svc.submit(data, client=f"c{k % 4}"))
            except ServiceOverloaded:
                shed += 1
        for f in futs:
            f.result(timeout=120)
            delivered += 1
        dt = time.perf_counter() - t0
        snap = svc.stats()
    return {"offered_rps": offered_rps,
            "delivered_ips": delivered / dt,
            "shed_frac": shed / len(stream),
            "p99_s": snap["service"]["latency_s"]["p99"]}


def batched_vs_serial(corpus: Corpus, n_requests: int = 48, seed: int = 3,
                      path_name: str = "cuda-batch") -> dict:
    """Group the request stream by admission bucket and decode each bucket
    with ONE ``decode_batch`` call, vs the same stream through the same
    path one image at a time. Same entropy-decode work on both sides — the
    delta is transform launch count, i.e. exactly what micro-batching buys
    once batches decode as real batches."""
    stream = request_stream(corpus, n_requests, seed)
    with open_decoder(path_name) as dec:
        buckets: dict = {}
        for data in stream:
            buckets.setdefault(dec.probe(data), []).append(data)
        for items in buckets.values():      # warm compile caches both ways
            dec.decode_batch(items)
            for data in items:              # every B=1 grid compiles too:
                dec.decode(data)            # the timed loops must be warm

        t0 = time.perf_counter()
        n_batched = 0
        for items in buckets.values():
            n_batched += sum(out.ok for out in dec.decode_batch(items))
        t_batched = time.perf_counter() - t0

        t0 = time.perf_counter()
        for items in buckets.values():
            for data in items:
                dec.decode(data)
        t_serial = time.perf_counter() - t0

    assert n_batched == len(stream), (n_batched, len(stream))
    return {"path": path_name, "n_requests": len(stream),
            "n_buckets": len(buckets),
            "batched_ips": len(stream) / t_batched,
            "serial_ips": len(stream) / t_serial,
            "ratio": t_serial / t_batched}
