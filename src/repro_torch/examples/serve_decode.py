"""Online JPEG decode service: concurrent clients against the
bandit-routed micro-batching engine.

Port of the reference's ``examples/serve_decode.py``. It builds the
synthetic ImageNet-val-like corpus, starts the service over every
registered decoder (on the card the 14 port paths, ``cuda-batch`` and
``cuda-fused`` among them, plus whichever Pillow/OpenCV plugins import),
runs closed-loop client threads with a zipf-ish request mix (hot images
repeat, so the content-hash cache participates), then prints the live
metrics snapshot: the path the router converged on and the robust tier
computed from in-situ measurements (the paper's Table-4 logic applied
to service telemetry instead of offline benchmarks).

Run on the card (``--device cpu`` for the CPU):

    PYTHONPATH=src python -m repro_torch.examples.serve_decode --workers 2

With ``--metrics-port`` the service also serves its live telemetry over
loopback HTTP while the demo runs, and the demo scrapes ``/metrics``
once before shutdown (``/healthz`` and ``/slo`` are served too);
``--metrics-port 0`` binds an ephemeral port, printed at start.
"""
from __future__ import annotations

import argparse
import json
import threading
import urllib.request
from typing import Any, Dict, Optional, Sequence

from repro_torch.codecs import list_decoders
from repro_torch.device import add_device_flag, on_device
from repro_torch.jpeg.corpus import build_corpus, zipf_indices
from repro_torch.service import DecodeService, ServiceConfig, ServiceOverloaded


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Serve the clients; returns what it printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=60,
                    help="requests per client")
    ap.add_argument("--corpus", type=int, default=24)
    ap.add_argument("--policy", default="ucb", choices=("ucb", "epsilon"))
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics, /healthz, /slo on this "
                         "loopback port while running (0 = ephemeral)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    with on_device(args.device):
        return _run(args)


def _run(args) -> Dict[str, Any]:
    corpus = build_corpus(args.corpus, seed=11)
    cfg = ServiceConfig(num_workers=args.workers, max_batch=8,
                        max_wait_ms=2.0, policy=args.policy,
                        metrics_port=args.metrics_port)
    # every registered decoder is an arm; strict paths fall back on the
    # rare YCCK image instead of failing the request. The service keeps
    # the device selected here for its worker threads.
    svc = DecodeService(cfg, paths=list_decoders())
    clients: Dict[str, Dict[str, int]] = {}
    lock = threading.Lock()

    def client(cid: str, seed: int):
        served = shed = 0
        for i in zipf_indices(len(corpus.files), args.requests, seed):
            try:
                img = svc.decode(corpus.files[i], client=cid)
                assert str(img.dtype) == "uint8"
                served += 1
            except ServiceOverloaded:
                shed += 1
        with lock:
            clients[cid] = {"served": served, "shed": shed}
        print(f"  client {cid}: served={served} shed={shed}")

    out: Dict[str, Any] = {"arms": [s.name for s in list_decoders()]}
    with svc:
        if svc.telemetry is not None:
            print(f"telemetry: {svc.telemetry.url}/metrics  /healthz  /slo")
        threads = [threading.Thread(target=client, args=(f"c{k}", 100 + k))
                   for k in range(args.clients)]
        print(f"serving {args.clients} clients x {args.requests} requests "
              f"({args.workers} workers, policy={args.policy}, "
              f"{len(out['arms'])} arms) ...")
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = svc.stats()
        tier = svc.router.tier()
        if svc.telemetry is not None:
            # one live scrape before shutdown: what an operator's
            # Prometheus job would see
            body = urllib.request.urlopen(
                svc.telemetry.url + "/metrics", timeout=5).read().decode()
            served_lines = [ln for ln in body.splitlines()
                            if ln.startswith("service_") and "{" not in ln]
            print("\n-- /metrics (unlabeled service series) --")
            print("\n".join(served_lines))
            out["metrics_lines"] = served_lines

    print("\n-- service stats --")
    print(json.dumps(stats, indent=1, default=str))
    print("\n-- live robust tier (zero-skip + 90% floor, measured in situ) --")
    for t in tier:
        print(f"  {t.decoder:<14} mean_norm={t.mean_norm:.3f} "
              f"min_norm={t.min_norm:.3f}")
    print(f"\nrouter converged on: {stats['router_best']}")
    out.update(clients=dict(sorted(clients.items())),
               stats=json.loads(json.dumps(stats, default=str)),
               tier=[t.decoder for t in tier],
               router_best=stats["router_best"])
    return out


if __name__ == "__main__":
    main()
