"""The port's decode service, held against the reference's.

Each copied module (``core.stats``, ``core.decision``, ``obs.metrics``,
``obs.slo``, ``obs.http``, ``service.admission``, ``service.batcher``,
``service.cache``, ``service.router``) is fed the same inputs as its
original and must give the same results. The port's ``DecodeService``
must serve ``numpy-fast`` byte for byte as the reference's does, and
``torch-batch`` within 1 level of the reference's ``jnp-batch`` (the
tolerance of tests/test_torch_paths.py's counterpart test). The batched
cases of tests/test_service.py are mirrored over the port's arms.

Everything runs on the CPU: services are built under
``use_device("cpu")``, where the ``cuda-*`` arms run each kernel's plain
version. No test reads the wall clock against a threshold; the router is
driven through ``update()``.
"""
import dataclasses
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import repro.codecs as jcodecs
from repro.core import decision as jdecision
from repro.core import stats as jstats
from repro.core.schema import RunRecord as JRunRecord
from repro.obs import http as jhttp
from repro.obs import metrics as jmetrics
from repro.obs import slo as jslo
from repro.service import (AdmissionController as JAdmission,
                           BanditRouter as JRouter, DecodeCache as JCache,
                           DecodeService as JService, MicroBatcher as JBatcher,
                           ServiceConfig as JConfig, bucket_key as jbucket_key,
                           content_key as jcontent_key)
from repro_torch import device
from repro_torch.codecs import (Capabilities, DecoderSpec, ExecContext,
                                eligible, get_decoder, list_decoders)
from repro_torch.core import decision, stats
from repro_torch.core.schema import RunRecord
from repro_torch.obs import http, metrics, slo, trace
from repro_torch.service import (AdmissionController, BanditRouter,
                                 DecodeCache, DecodeService, MicroBatcher,
                                 ServiceConfig, ServiceOverloaded,
                                 ServiceShutdown, bucket_key, content_key)

ROUTER_ARMS = ["numpy-fast", "numpy-int", "strict-fast"]


@pytest.fixture(autouse=True)
def _on_cpu():
    with device.use_device("cpu"):
        yield


def mksvc(paths, **kw):
    kw.setdefault("num_workers", 2)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 2.0)
    kw.setdefault("seed", 3)
    return DecodeService(ServiceConfig(**kw), paths=paths)


def arm(name, fn=None, *, strict=False, batch_fn=None, delay_s=0.0):
    """A synthetic port arm: ``fn`` (default: an 8x8 black image after
    ``delay_s``) behind a spec the router and sessions take as-is."""
    def blank(data):
        time.sleep(delay_s)
        return np.zeros((8, 8, 3), np.uint8)
    return DecoderSpec(name=name, fn=fn or blank, batch_fn=batch_fn,
                       caps=Capabilities(engine="numpy", strict=strict,
                                         fork_safe=True,
                                         batchable=batch_fn is not None))


def _max_diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) -
                      np.asarray(b).astype(int)).max())


def _serve_all(svc, files, clients=3):
    """Every client submits every file; {client: [image per file]}."""
    results, errors = {}, []

    def client(cid):
        try:
            futs = [svc.submit(f, client=cid) for f in files]
            results[cid] = [f.result(timeout=120) for f in futs]
        except Exception as e:          # pragma: no cover - diagnostics
            errors.append(e)
    threads = [threading.Thread(target=client, args=(f"c{k}",))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    return results


# ------------------------------------------------------ copies vs originals
def test_core_stats_copy_matches_reference():
    rng = np.random.RandomState(0)
    a, b = rng.rand(40) * 100, rng.rand(40) * 100
    ties = np.round(a / 10)
    for p in (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert stats.percentile(list(a), p) == jstats.percentile(list(a), p)
    assert stats.mean_std(a) == jstats.mean_std(a)
    assert stats.coefficient_of_variation(a) == \
        jstats.coefficient_of_variation(a)
    np.testing.assert_array_equal(stats.rankdata(ties),
                                  jstats.rankdata(ties))
    assert stats.spearman_rho(a, b) == jstats.spearman_rho(a, b)
    assert stats.noise_gate(a, b) == jstats.noise_gate(a, b)
    single = {f"d{i}": float(v) for i, v in enumerate(a[:8])}
    loader = {f"d{i}": float(v) for i, v in enumerate(b[:8])}
    assert stats.rank_moves(single, loader) == \
        jstats.rank_moves(single, loader)
    assert stats.largest_rank_move(single, loader) == \
        jstats.largest_rank_move(single, loader)
    for proto in ("single_thread", "dataloader"):
        assert stats.protocol_threshold(proto) == \
            jstats.protocol_threshold(proto)
        th = stats.protocol_threshold(proto)
        for x in (95.0, 101.0, 103.0, 110.0):
            assert stats.comparison_language(x, 100.0, th) == \
                jstats.comparison_language(x, 100.0, th)


def _records(cls, seed):
    """The same matrix of loader and single-thread records, some with
    skips, over three platforms."""
    rng = np.random.RandomState(seed)
    out = []
    for plat in ("p0", "p1", "p2"):
        for d in ("numpy-fast", "numpy-int", "strict-fast", "fft-idct"):
            for proto, workers in (("single_thread", 0), ("dataloader", 2),
                                   ("dataloader", 4)):
                samples = list(rng.uniform(50, 150, 5))
                mean, std = jstats.mean_std(samples)
                skips = [3] if d == "strict-fast" and plat != "p1" else []
                out.append(cls(platform=plat, decoder=d, protocol=proto,
                               workers=workers,
                               mode="thread" if workers else "",
                               throughput_mean=mean, throughput_std=std,
                               samples=samples, num_images=40,
                               skip_indices=skips))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_core_decision_copy_gives_the_same_tiers(seed):
    port, ref = _records(RunRecord, seed), _records(JRunRecord, seed)
    tier = [dataclasses.asdict(t) for t in decision.robust_tier(port)]
    assert tier == [dataclasses.asdict(t)
                    for t in jdecision.robust_tier(ref)]
    rec, jrec = decision.recommend(port), jdecision.recommend(ref)
    assert [dataclasses.asdict(t) for t in rec.pop("tier")] == \
        [dataclasses.asdict(t) for t in jrec.pop("tier")]
    assert rec == jrec
    assert "best_mean" in rec or not tier
    for plat, peaks in decision.peak_loader_throughput(port).items():
        jpeaks = jdecision.peak_loader_throughput(ref)[plat]
        assert decision.normalized(peaks) == jdecision.normalized(jpeaks)
        assert set(decision.zero_skip(peaks)) == \
            set(jdecision.zero_skip(jpeaks))


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("requests_total", help="requests")
    g = reg.gauge("depth", help="queue depth")
    h = reg.histogram("latency_seconds", help="latency", window=64)
    reg.gauge("live", help="callback gauge", fn=lambda: 7)
    rng = np.random.RandomState(4)
    for i in range(50):
        c.inc(path=f"p{i % 3}")
        g.set(float(i % 5))
        h.observe(float(rng.exponential(0.2)), path=f"p{i % 2}")
    c.inc(2.5)
    return reg, h


def test_obs_metrics_copy_gives_the_same_exposition():
    reg, h = _drive_registry(metrics)
    jreg, jh = _drive_registry(jmetrics)
    assert reg.render_prometheus() == jreg.render_prometheus()
    assert reg.snapshot() == jreg.snapshot()
    for p in (0.5, 0.9, 0.99):
        assert h.quantile(p) == jh.quantile(p)
        assert h.quantile(p, path="p1") == jh.quantile(p, path="p1")
    assert h.bucket_counts() == jh.bucket_counts()


def _drive_slo(mod, metrics_mod):
    """(t, bad, total) samples through both objective kinds; returns
    the burn rates and shed verdicts after each sample."""
    reg = metrics_mod.MetricsRegistry()
    total = reg.counter("req_total")
    bad = reg.counter("fail_total")
    lat = reg.histogram("lat_seconds")
    now = [0.0]
    objectives = [
        mod.SLOObjective.latency("latency", metric="lat_seconds",
                                 threshold_s=0.25, objective=0.9),
        mod.SLOObjective.error_ratio("availability", total="req_total",
                                     bad="fail_total", objective=0.99)]
    tracker = mod.SLOTracker(reg, objectives, windows_s=(10.0, 30.0),
                             shed_burn=2.0, min_sample_interval_s=1.0,
                             clock=lambda: now[0])
    rng = np.random.RandomState(9)
    out = []
    for step in range(60):
        now[0] = float(step)
        burst = 20 <= step < 40           # a failure and latency burst
        for _ in range(10):
            total.inc()
            if burst and rng.rand() < 0.3:
                bad.inc()
            lat.observe(0.5 if burst and rng.rand() < 0.5 else 0.01)
        tracker.sample(now[0])
        out.append((tracker.burn_rates("latency"),
                    tracker.burn_rates("availability"),
                    tracker.should_shed()))
    status = tracker.status()
    return out, status


def test_obs_slo_copy_gives_the_same_burn_rates_and_verdicts():
    got, status = _drive_slo(slo, metrics)
    want, jstatus = _drive_slo(jslo, jmetrics)
    assert got == want
    status.pop("t"), jstatus.pop("t")                 # the wall clock
    assert status == jstatus
    assert any(shed for _, _, (shed, _) in got)      # the burst sheds
    assert not got[-1][2][0]                          # and recovers


def _scrape(mod, metrics_mod):
    reg, _ = _drive_registry(metrics_mod)
    with mod.TelemetryServer(reg, port=0) as srv:
        assert srv.host == "127.0.0.1"
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            return r.headers["Content-Type"], r.read().decode()


def test_obs_http_copy_serves_the_same_metrics_page():
    assert _scrape(http, metrics) == _scrape(jhttp, jmetrics)


def _admit_sequence(cls):
    adm = cls(max_inflight=8, congestion=0.5)
    verdicts = []
    for step in range(40):
        client = ("greedy", "polite", "greedy", "burst")[step % 4]
        verdicts.append(adm.try_admit(client))
        if step % 5 == 4:
            adm.release("greedy")
    return verdicts, adm.stats()


def test_service_admission_copy_sheds_the_same_requests():
    got, want = _admit_sequence(AdmissionController), \
        _admit_sequence(JAdmission)
    assert got == want
    assert any(not ok for ok, _ in got[0]) and any(ok for ok, _ in got[0])


def test_service_batcher_copy_gives_the_same_buckets(corpus):
    for gran in (1, 4):
        keys = [bucket_key(f, gran) for f in corpus.files]
        jkeys = [jbucket_key(f, gran) for f in corpus.files]
        assert keys == jkeys
    flushes = []
    for cls in (MicroBatcher, JBatcher):
        b = cls(max_batch=3, max_wait_s=0.5)
        out = []
        for i, f in enumerate(corpus.files):
            full = b.add(bucket_key(f), i, now=0.1 * i)
            if full is not None:
                out.append(("full", full.items))
            out += [("due", d.items) for d in b.take_due(now=0.1 * i)]
        out += [("flush", d.items) for d in b.flush_all()]
        flushes.append((out, b.batches_emitted, b.deadline_flushes))
    assert flushes[0] == flushes[1]


def test_service_cache_copy_evicts_the_same_entries():
    rng = np.random.RandomState(2)
    caches = (DecodeCache(capacity_bytes=4000), JCache(capacity_bytes=4000))
    keys = [content_key(bytes([i])) for i in range(12)]
    assert keys == [jcontent_key(bytes([i])) for i in range(12)]
    trace_ = []
    for step in range(60):
        k = keys[rng.randint(len(keys))]
        if rng.rand() < 0.5:
            side = rng.randint(5, 25)
            img = np.full((side, side, 3), step % 256, np.uint8)
            for c in caches:
                c.put(k, img)
        got = [c.get(k) for c in caches]
        trace_.append(None if got[0] is None else int(got[0][0, 0, 0]))
        assert (got[0] is None) == (got[1] is None)
        if got[0] is not None:
            np.testing.assert_array_equal(got[0], got[1])
    assert caches[0].stats() == caches[1].stats()
    assert caches[0].stats()["evictions"] > 0


@pytest.mark.parametrize("policy", ["ucb", "epsilon"])
def test_router_copy_makes_the_same_picks(policy):
    """Same seed, same arm order, same updates and skips: the same pick
    sequence, snapshot, best arm and tier."""
    port = BanditRouter(ROUTER_ARMS, policy=policy, epsilon=0.3, seed=5)
    ref = JRouter([jcodecs.get_decoder(n) for n in ROUTER_ARMS],
                  policy=policy, epsilon=0.3, seed=5)
    speed = {"numpy-fast": 0.004, "numpy-int": 0.006, "strict-fast": 0.003}
    rng = np.random.RandomState(1)
    picks = []
    for step in range(80):
        a, b = port.pick(), ref.pick()
        assert a.name == b.name, step
        picks.append(a.name)
        secs = speed[a.name] * rng.uniform(0.8, 1.2)
        for r in (port, ref):
            r.update(a.name, 4, secs)
            if a.name == "strict-fast" and step % 7 == 0:
                r.record_skip(a.name)
    assert len(set(picks)) == 3
    assert port.snapshot() == ref.snapshot()
    assert port.best() == ref.best() == "numpy-fast"
    assert [dataclasses.asdict(t) for t in port.tier()] == \
        [dataclasses.asdict(t) for t in ref.tier()]
    assert port.fallback("strict-fast").name == \
        ref.fallback("strict-fast").name


def test_router_defaults_to_the_ports_service_arms():
    names = list(BanditRouter().snapshot())
    assert names == [s.name for s in list_decoders()
                     if eligible(s.caps, ExecContext.SERVICE)]
    assert "cuda-batch" in names and "numpy-fast" in names


def test_router_converges_through_updates():
    r = BanditRouter([arm("fast-arm"), arm("slow-arm")], policy="epsilon",
                     epsilon=0.2, seed=0)
    for _ in range(50):
        p = r.pick()
        r.update(p.name, 4, 0.004 if p.name == "fast-arm" else 0.04)
    assert r.best() == "fast-arm"
    assert r.snapshot()["fast-arm"]["pulls"] > \
        r.snapshot()["slow-arm"]["pulls"]
    r = BanditRouter([arm("strict-quick", strict=True), arm("safe-arm")])
    r.update("strict-quick", 8, 0.004)
    r.record_skip("strict-quick")
    r.update("safe-arm", 8, 0.0042)
    assert r.best() == "safe-arm"
    assert [t.decoder for t in r.tier()] == ["safe-arm"]


# --------------------------------------------------- the service end to end
def test_numpy_fast_service_is_byte_identical_to_the_reference(corpus):
    files = list(corpus.files)
    with mksvc(["numpy-fast"], cache_bytes=0) as svc:
        got = _serve_all(svc, files)
    with JService(JConfig(num_workers=2, max_batch=4, max_wait_ms=2.0,
                          seed=3, cache_bytes=0),
                  paths=[jcodecs.get_decoder("numpy-fast")]) as jsvc:
        want = _serve_all(jsvc, files)
    for cid in want:
        for i, (a, b) in enumerate(zip(got[cid], want[cid])):
            np.testing.assert_array_equal(a, b, err_msg=f"{cid}[{i}]")
    snap = svc.metrics.snapshot()
    assert snap["completed"] == 3 * len(files)
    assert snap["failed"] == 0 and snap["shed"] == 0
    assert snap["path_hits"] == {"numpy-fast": 3 * len(files)}


def test_torch_batch_service_within_one_level_of_reference_jnp_batch(
        corpus):
    files = list(corpus.files)
    want = jcodecs.get_decoder("jnp-batch").decode_batch(files)
    with mksvc(["torch-batch"], cache_bytes=0) as svc:
        got = _serve_all(svc, files, clients=2)
    for cid, imgs in got.items():
        for i, (a, b) in enumerate(zip(imgs, want)):
            assert a.shape == b.shape and a.dtype == np.uint8
            assert _max_diff(a, b) <= 1, (cid, i)


def test_service_built_on_the_cpu_serves_from_its_workers_without_a_card(
        monkeypatch, corpus):
    """A ``use_device`` scope does not reach a new thread: the service
    carries it to its batcher and workers (and to the inline path)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(device, "_PROCESS_DEVICE", None)
    files = list(corpus.files[:6])
    serial = get_decoder("torch-batch").decode_batch(files)
    with mksvc(["torch-batch"], cache_bytes=0) as svc:
        assert svc.device == torch.device("cpu")
        got = _serve_all(svc, files, clients=2)
    for imgs in got.values():
        for a, b in zip(imgs, serial):
            np.testing.assert_array_equal(a, b)
    assert svc.metrics.snapshot()["failed"] == 0
    inline = mksvc(["cuda-batch"], num_workers=0, cache_bytes=0)
    with device.use_device("cuda"):     # the caller's own scope
        with pytest.raises(RuntimeError, match="no CUDA card"):
            device.current_device()
        with inline:
            img = inline.decode(files[0])
    np.testing.assert_array_equal(
        img, get_decoder("cuda-batch").decode(files[0]))


def test_a_service_built_for_the_card_fails_without_one(monkeypatch, corpus):
    """The default stays the card: with none visible the arm's futures
    fail (no silent CPU fallback) and the workers stay alive."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(device, "_PROCESS_DEVICE", None)
    with device.use_device("cuda:0"):
        svc = mksvc(["cuda-batch"], num_workers=1, cache_bytes=0)
    assert svc.device == torch.device("cuda", 0)
    with svc:
        fut = svc.submit(corpus.files[0])
        with pytest.raises(RuntimeError, match="no CUDA card"):
            fut.result(timeout=60)
        assert svc._threads[1].is_alive()
    device.set_device("cpu")
    try:
        assert mksvc(["cuda-batch"]).device == torch.device("cpu")
    finally:
        device.set_device(None)


# ------------------------------------- the batched cases of test_service.py
def test_serve_batch_makes_one_decode_batch_call(corpus):
    calls = []

    def batch_fn(datas):
        calls.append(len(datas))
        return [np.zeros((8, 8, 3), np.uint8) for _ in datas]

    counting = arm("counting", fn=lambda d: batch_fn([d])[0],
                   batch_fn=batch_fn)
    with mksvc([counting], num_workers=1, max_batch=4, max_wait_ms=500.0,
               cache_bytes=0) as svc:
        futs = [svc.submit(corpus.files[0]) for _ in range(4)]
        for f in futs:
            f.result(timeout=30)
    assert calls == [4], calls


@pytest.mark.parametrize("name", ["cuda-batch", "torch-batch"])
def test_a_micro_batch_is_one_transform_and_equals_serial(name):
    """Four same-bucket images in one micro-batch: one ``jpeg.dequant_idct``
    span (``cuda-batch``: one ``decode_batch`` call) or one batched
    transform (``torch-batch``), and images byte-identical to the serial
    decode."""
    from repro.jpeg import encoder
    from repro.jpeg.corpus import natural_image
    from repro_torch.jpeg import pipeline
    files = [encoder.encode_jpeg(
        natural_image(np.random.RandomState(20 + k), 64, 64),
        quality=85, subsampling="420") for k in range(4)]
    path = get_decoder(name)
    serial = [path.decode(f) for f in files]
    before = pipeline.TRANSFORM_BATCH_CALLS
    tracer = trace.Tracer()
    with trace.use_tracer(tracer):
        with mksvc([name], num_workers=1, max_batch=4, max_wait_ms=500.0,
                   cache_bytes=0) as svc:
            futs = [svc.submit(f) for f in files]
            for fut, want in zip(futs, serial):
                np.testing.assert_array_equal(fut.result(timeout=60), want)
    spans = [e for e in tracer.events() if e.get("ph") == "X"]
    batches = [e for e in spans if e["name"] == "service.batch_decode"]
    assert [e["args"]["batch"] for e in batches] == [4]
    if name == "cuda-batch":
        idct = [e for e in spans if e["name"] == "jpeg.dequant_idct"]
        assert [e["args"]["batch"] for e in idct] == [4]
    else:
        assert pipeline.TRANSFORM_BATCH_CALLS == before + 1


def test_batch_level_failure_fails_futures_not_worker(corpus):
    def exploding(datas):
        raise RuntimeError("transform exploded")

    with mksvc([arm("exploding", batch_fn=exploding)], num_workers=1,
               max_batch=2, cache_bytes=0) as svc:
        futs = [svc.submit(corpus.files[0]), svc.submit(corpus.files[1])]
        for f in futs:
            with pytest.raises(RuntimeError, match="transform exploded"):
                f.result(timeout=30)
        assert svc._threads[1].is_alive()
    assert svc.metrics.snapshot()["failed"] == 2


def test_serve_batch_mixed_outcomes_partial_batch(corpus):
    with mksvc(["cuda-batch"], num_workers=1, max_batch=2,
               cache_bytes=0) as svc:
        good = svc.submit(corpus.files[0])
        bad = svc.submit(b"\xff\xd8 broken")
        np.testing.assert_array_equal(
            good.result(timeout=30),
            get_decoder("cuda-batch").decode(corpus.files[0]))
        with pytest.raises(Exception):
            bad.result(timeout=30)
    snap = svc.metrics.snapshot()
    assert snap["completed"] == 1 and snap["failed"] == 1


def test_strict_refusal_is_rerouted_and_recorded_as_a_skip(corpus):
    router = BanditRouter(["strict-cuda", "cuda-batch"], seed=0)
    strict = router._arms["strict-cuda"].path
    router.pick = lambda: strict              # force the strict arm
    rare = corpus.files[corpus.rare_index]
    svc = DecodeService(ServiceConfig(num_workers=1, max_batch=1,
                                      cache_bytes=0), router=router)
    with svc:
        img = svc.decode(rare)
    np.testing.assert_array_equal(img, get_decoder("cuda-batch").decode(rare))
    assert router.snapshot()["strict-cuda"]["skips"] == 1
    snap = svc.metrics.snapshot()
    assert snap["path_skips"] == {"strict-cuda": 1}
    assert snap["path_hits"] == {"cuda-batch": 1}


def test_saturation_sheds_instead_of_deadlocking(corpus):
    with mksvc([arm("slow-arm", delay_s=0.05)], max_inflight=4,
               num_workers=1, cache_bytes=0) as svc:
        futs, shed = [], 0
        for i in range(40):
            try:
                futs.append(svc.submit(corpus.files[i % len(corpus.files)],
                                       client=f"c{i % 2}"))
            except ServiceOverloaded:
                shed += 1
        assert shed > 0
        for f in futs:
            assert f.result(timeout=60) is not None
    assert svc.metrics.snapshot()["shed"] == shed


def test_graceful_shutdown_drains_accepted_work(corpus):
    svc = mksvc([arm("slow-arm", delay_s=0.02)], cache_bytes=0,
                num_workers=1)
    svc.start()
    futs = [svc.submit(f) for f in corpus.files[:8]]
    svc.stop(graceful=True)
    for f in futs:
        assert f.done() and f.result() is not None
    with pytest.raises(ServiceShutdown):
        svc.submit(corpus.files[0])


def test_abort_shutdown_fails_pending_futures(corpus):
    svc = mksvc([arm("slow-arm", delay_s=0.05)], cache_bytes=0,
                num_workers=1, max_batch=1, max_wait_ms=0.0)
    svc.start()
    futs = [svc.submit(f) for f in corpus.files]
    svc.stop(graceful=False)
    outcomes = {"ok": 0, "shutdown": 0}
    for f in futs:
        assert f.done()
        try:
            f.result()
            outcomes["ok"] += 1
        except ServiceShutdown:
            outcomes["shutdown"] += 1
    assert outcomes["ok"] + outcomes["shutdown"] == len(corpus.files)
    assert outcomes["shutdown"] > 0


def test_cache_hit_serves_repeat_requests(corpus):
    with mksvc(["cuda-batch"], cache_bytes=8 << 20) as svc:
        a = svc.decode(corpus.files[0])
        b = svc.decode(corpus.files[0])
    np.testing.assert_array_equal(a, b)
    assert svc.cache.stats()["hits"] == 1
    assert svc.metrics.snapshot()["cache_hits"] == 1
    b[:] = 0                                # a hit cannot poison the cache
    again = svc.cache.get(content_key(corpus.files[0]))
    assert again is not None and again.any()


def test_inline_mode_workers0(corpus):
    with mksvc(["cuda-batch", "torch-batch"], num_workers=0) as svc:
        assert not svc._threads
        for f in corpus.files[:4]:
            img = svc.decode(f)
            assert img.dtype == np.uint8 and img.ndim == 3
    assert svc.metrics.snapshot()["completed"] == 4


def test_metrics_endpoint_and_snapshot(corpus):
    with mksvc(["cuda-batch"], metrics_port=0, cache_bytes=0) as svc:
        for f in corpus.files[:6]:
            svc.decode(f)
        with urllib.request.urlopen(svc.telemetry.url + "/metrics",
                                    timeout=10) as r:
            page = r.read().decode()
        snap = svc.stats()
    assert "service_completed_total 6" in page.splitlines()
    lat = snap["service"]["latency_s"]
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    assert snap["service"]["path_hits"] == {"cuda-batch": 6}
    assert snap["router_best"] == "cuda-batch"
