"""Online decode service benchmark — thin view over
``repro_torch.bench.service_load`` (closed/open-loop load models, serial
baseline, batched-vs-serial). The load generators live in the bench
subsystem so the scenario harness and this CSV view share one
implementation; see that module's docstring for the load-model
definitions.

The baseline is the equivalent serial loop: the same request stream
decoded inline with one fixed path — the paper's single-thread protocol
applied to service traffic. The service must beat it (acceptance
criterion); it does so via the bandit router converging on the fastest
measured path plus the content-hash cache absorbing the hot set of a
zipf-ish request mix.
"""
from __future__ import annotations

from repro_torch.bench.service_load import (BASELINE_PATH,
                                            batched_vs_serial, closed_loop,
                                            open_loop, request_stream,
                                            serial_baseline)
from repro_torch.bench.views.common import save_json
from repro_torch.jpeg.corpus import build_corpus


def smoke():
    """CI smoke: tiny corpus, batched-vs-serial ratio printed (ratio < 1
    is possible on a noisy 2-vCPU runner; completeness is the assert)."""
    corpus = build_corpus(10, seed=11)
    r = batched_vs_serial(corpus, n_requests=24, seed=5)
    return [("service.smoke.batched_vs_serial", 1e6 / r["batched_ips"],
             f"batched={r['batched_ips']:.1f}ips "
             f"serial={r['serial_ips']:.1f}ips ratio={r['ratio']:.2f} "
             f"buckets={r['n_buckets']}")]


def run(quick: bool = True):
    rows = []
    corpus = build_corpus(24 if quick else 96, seed=11)
    stream = request_stream(corpus, 96 if quick else 512, seed=5)

    base_ips = serial_baseline(stream)
    rows.append(("service.serial_baseline", 1e6 / base_ips,
                 f"ips={base_ips:.1f} path={BASELINE_PATH}"))

    results = {"serial_baseline_ips": base_ips, "closed": {}, "open": {}}
    sweep = (0, 2) if quick else (0, 2, 4, 8)
    for w in sweep:
        r = closed_loop(stream, w)
        results["closed"][w] = r
        beats = r["throughput_ips"] >= base_ips
        rows.append((f"service.closed.w{w}", 1e6 / r["throughput_ips"],
                     f"ips={r['throughput_ips']:.1f} "
                     f"best={r['router_best']} "
                     f"cache_hits={r['cache_hits']} "
                     f"ge_serial={beats}"))

    # open-loop at ~1.5x measured closed-loop capacity: overload must shed
    peak = max(r["throughput_ips"] for r in results["closed"].values())
    for w in sweep[1:] or sweep:
        r = open_loop(stream, w, offered_rps=1.5 * peak)
        results["open"][w] = r
        rows.append((f"service.open.w{w}", 1e6 / max(r["delivered_ips"],
                                                     1e-9),
                     f"delivered={r['delivered_ips']:.1f} "
                     f"shed={r['shed_frac']:.2f} p99={r['p99_s']*1e3:.1f}ms"))

    bvs = batched_vs_serial(corpus, n_requests=48 if quick else 192, seed=3)
    results["batched_vs_serial"] = bvs
    rows.append(("service.batched_vs_serial", 1e6 / bvs["batched_ips"],
                 f"batched={bvs['batched_ips']:.1f}ips "
                 f"serial={bvs['serial_ips']:.1f}ips "
                 f"ratio={bvs['ratio']:.2f} buckets={bvs['n_buckets']}"))

    best_closed = max(r["throughput_ips"]
                      for r in results["closed"].values())
    results["service_ge_serial"] = bool(best_closed >= base_ips)
    save_json("service_bench.json", results)
    return rows


if __name__ == "__main__":
    import sys

    from repro_torch.bench.views.common import emit
    if "--smoke" in sys.argv:
        emit(smoke())
    else:
        emit(run(quick="--full" not in sys.argv))
