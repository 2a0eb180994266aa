"""The port's invariant checker (``repro_torch.analysis``) held to the
reference's (``repro.analysis``) on the same inputs, findings compared
by ``Finding.to_json()`` with exact equality: the six copied rules on
``tests/test_analysis.py``'s fixtures, on the live tree and on a
seeded-fault tree; suppressions, baselines and the CLI. Then the three
device-hygiene rules (``rules/device.py``, the counterpart of the
reference's jit rules) on positive fixtures and on near misses shaped
like the live tree's code, the rule catalog, and the port's self-check
(the port's gate)."""
import ast
import json
import os
import pathlib
import textwrap

import pytest

import repro.analysis as ref
import repro_torch.analysis as port
from repro.analysis import baseline as ref_baseline
from repro.analysis.cli import main as ref_cli
from repro.analysis.engine import parse_suppressions as ref_parse
from repro_torch.analysis import baseline as port_baseline
from repro_torch.analysis.cli import main as port_cli
from repro_torch.analysis.engine import DEFAULT_ROOTS
from repro_torch.analysis.engine import parse_suppressions as port_parse
from repro_torch.analysis.rules import RULES, resolve_rules
from repro_torch.core.selectors import SelectorError

REPO = pathlib.Path(__file__).resolve().parents[1]
SHARED = ("fork-initargs-bytes", "fork-initializer-closure",
          "lock-unguarded-write", "except-swallow", "schema-raw-record",
          "trace-span-no-with")
DEVICE_RULES = ("torch-thread-no-device", "torch-cuda-in-fork",
                "torch-host-sync-in-loop")


def as_json(findings):
    return [f.to_json() for f in findings]


def both(source, only, path="<memory>.py"):
    """(reference findings, port findings) as JSON lists."""
    src = textwrap.dedent(source)
    return (as_json(ref.analyze_source(src, path=path, only=only)),
            as_json(port.analyze_source(src, path=path, only=only)))


def run(source, only, path="<memory>.py"):
    return port.analyze_source(textwrap.dedent(source), path=path,
                               only=[only])


def rule_ids(findings):
    return [f.rule for f in findings]


# --------------------------------------- copied rules, both checkers
# Every fixture of tests/test_analysis.py but the jit-* ones, with the
# number of findings the reference's test expects.
COPIED_FIXTURES = [
    ("fork-initargs-bytes", 1, """
        import multiprocessing as mp
        class L:
            def go(self):
                mp.Pool(2, initializer=init,
                        initargs=(list(self.files), 3))
        """),
    ("fork-initargs-bytes", 1, """
        import multiprocessing as mp
        mp.Pool(2, initializer=init, initargs=(corpus, 7))
        """),
    ("fork-initargs-bytes", 1, """
        import multiprocessing as mp
        class L:
            def _proc_initargs(self):
                return (list(self.files), self.name)
            def go(self, ctx):
                ctx.Pool(2, initializer=init,
                         initargs=self._proc_initargs())
        """),
    ("fork-initargs-bytes", 0, """
        import multiprocessing as mp
        class L:
            def go(self, ctx):
                ctx.Pool(2, initializer=init,
                         initargs=(self.source.open_in_worker(),
                                   self.path_name))
        """),
    ("fork-initializer-closure", 2, """
        import multiprocessing as mp
        class L:
            def go(self):
                mp.Pool(2, initializer=lambda: setup(self.files))
                mp.Pool(2, initializer=self._init)
        """),
    ("fork-initializer-closure", 0, """
        import multiprocessing as mp
        mp.Pool(2, initializer=_proc_init, initargs=(1,))
        """),
    ("fork-initargs-bytes", 1, """
        from concurrent.futures import ProcessPoolExecutor
        class C:
            def go(self):
                ProcessPoolExecutor(2, initializer=init,
                                    initargs=(bytes(self.blob),))
        """),
    ("fork-initializer-closure", 1, """
        from concurrent.futures import ProcessPoolExecutor
        class C:
            def go(self):
                ProcessPoolExecutor(2, initializer=self._init)
        """),
    ("fork-initargs-bytes", 0, """
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        def build(n):
            return ProcessPoolExecutor(
                max_workers=n, mp_context=mp.get_context("fork"))
        """),
    ("lock-unguarded-write", 1, """
        class Ledger:
            def __init__(self):
                self.skips = []          # unlocked in __init__: exempt
            def record(self, item):
                with self._lock:
                    self.skips.append(item)
            def restore(self, state):
                self.skips = list(state)
        """),
    ("lock-unguarded-write", 1, """
        class Q:
            def put(self, x):
                with self._q_lock:
                    self.items.append(x)
            def drop_all(self):
                self.items.clear()
        """),
    ("lock-unguarded-write", 0, """
        class B:
            def push(self, x):
                with self._lock:
                    self.buf.append(x)
            def peek(self):
                return len(self.buf)       # read: allowed fast path
            def _pop_locked(self):
                self.buf = []              # caller holds the lock
        """),
    ("lock-unguarded-write", 0, """
        class C:
            def a(self):
                self.n = 1
            def b(self):
                self.n = 2
        """),
    ("except-swallow", 1, """
        try:
            work()
        except Exception:
            pass
        """),
    ("except-swallow", 0, """
        try:
            work()
        except Exception as e:
            log(e)
        try:
            work()
        except BaseException:
            raise
        try:
            work()
        except ValueError:
            pass
        """),
    ("schema-raw-record", 1, "x = RunRecord(**d)\n",
     "src/repro/bench/foo.py"),
    ("schema-raw-record", 0, "x = RunRecord(**d)\n",
     "src/repro/core/schema.py"),
    ("schema-raw-record", 0, "x = RunRecord(platform='p', decoder='d')\n",
     "src/repro/bench/foo.py"),
    ("schema-raw-record", 1, "x = RunRecord(**d)\n",
     "src/repro_torch/bench/foo.py"),
    ("schema-raw-record", 0, "x = RunRecord(**d)\n",
     "src/repro_torch/core/schema.py"),
    ("trace-span-no-with", 1, """
        def f(t):
            t.span("loose")
            with t.span("timed"):
                pass
            return t.span("forwarded")
        """),
]


@pytest.mark.parametrize(
    "fixture", COPIED_FIXTURES,
    ids=[f"{f[0]}-{i}" for i, f in enumerate(COPIED_FIXTURES)])
def test_copied_rules_give_the_reference_findings(fixture):
    rule, count, source = fixture[:3]
    path = fixture[3] if len(fixture) > 3 else "<memory>.py"
    want, got = both(source, [rule], path)
    assert got == want
    assert len(got) == count and {f["rule"] for f in got} <= {rule}
    # every shared rule at once gives the same findings too
    assert both(source, list(SHARED), path)[1] == \
        both(source, list(SHARED), path)[0]


def test_live_tree_parity_on_the_shared_rules():
    paths = ["src", "benchmarks", "examples", "chip_smoke.py", "tools"]
    want = ref.analyze_paths(paths, root=str(REPO), only=list(SHARED))
    got = port.analyze_paths(paths, root=str(REPO), only=list(SHARED))
    assert as_json(got) == as_json(want)


SEEDED = {
    "pkg/pools.py": """
        import multiprocessing as mp
        class Loader:
            def _initargs(self):
                return (list(self.files), self.name)
            def go(self, ctx):
                ctx.Pool(2, initializer=self._init,
                         initargs=self._initargs())
                mp.Pool(2, initializer=lambda: setup(corpus),
                        initargs=(corpus, bytes(self.blob)))
        """,
    "pkg/locks.py": """
        class Ledger:
            def record(self, item):
                with self._lock:
                    self.skips.append(item)
                    self.n += 1
            def restore(self, state):
                self.skips = list(state)
                self.n = 0
        """,
    "pkg/errors.py": """
        def probe():
            try:
                work()
            except Exception:
                pass
            try:
                work()
            except:
                return None
        """,
    "pkg/bench/records.py": """
        def load(d, t):
            t.span("load")
            return RunRecord(**d)
        """,
    "pkg/broken.py": "def broken(:\n",
    "pkg/clean.py": "x = 1\n",
}


def _seed(tmp_path, files):
    for rel, source in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source))
    return str(tmp_path)


def test_seeded_fault_tree_parity(tmp_path):
    root = _seed(tmp_path, SEEDED)
    want = ref.analyze_paths(["pkg"], root=root)
    got = port.analyze_paths(["pkg"], root=root, only=list(SHARED))
    assert as_json(got) == as_json(
        [f for f in want if not f.rule.startswith("jit-")])
    rules = {f["rule"] for f in as_json(got)}
    assert rules == set(SHARED) | {"parse-error"}
    assert len(got) >= 10


# --------------------------------------------- suppressions, both ways
SWALLOW = "try:\n    work()\nexcept Exception:\n    pass\n"


@pytest.mark.parametrize("source", [
    SWALLOW.replace("except Exception:",
                    "except Exception:  # repro: ignore[except-swallow] "
                    "-- probe"),
    SWALLOW.replace("except Exception:",
                    "except Exception:  # repro: ignore[lock-unguarded-"
                    "write] -- other rule"),
    SWALLOW.replace("except Exception:",
                    "# repro: ignore[except-swallow] -- standalone\n"
                    "except Exception:"),
    SWALLOW.replace("except Exception:",
                    "except Exception:  # repro: ignore[torch-host-sync-"
                    "in-loop, except-swallow] -- both checkers read it"),
    SWALLOW.replace("except Exception:",
                    "except Exception:  # repro: ignore[jit-in-loop] -- "
                    "a reference-only id"),
])
def test_suppressions_behave_the_same(source):
    want, got = both(source, None)
    assert got == [f for f in want if not f["rule"].startswith("jit-")]


def test_parse_suppressions_is_the_reference_s():
    lines = ["x = 1  # repro: ignore[a, b] -- both", "# repro: ignore[c]",
             "y = 2", "z  # repro: ignore[] -- empty",
             "  # repro:ignore[torch-cuda-in-fork,d]"]
    assert port_parse(lines) == ref_parse(lines)
    assert port_parse(lines)[3] == {"c"}


# -------------------------------------------------- baselines, both ways
def test_baseline_round_trips_match(tmp_path):
    findings = {p: p.analyze_source(SWALLOW, path="pkg/mod.py")
                for p in (ref, port)}
    files = {}
    for pkg, io in ((ref, ref_baseline), (port, port_baseline)):
        files[pkg] = tmp_path / f"{pkg.__name__}.json"
        io.write_baseline(str(files[pkg]), findings[pkg])
    assert files[ref].read_bytes() == files[port].read_bytes()
    for io in (ref_baseline, port_baseline):
        for pkg in (ref, port):
            known = io.load_baseline(str(files[pkg]))
            assert io.partition(findings[port], known) == []
            moved = port.analyze_source("\n\n" + SWALLOW, path="pkg/mod.py")
            assert io.partition(moved, known) == []
            other = port.analyze_source(SWALLOW, path="pkg/other.py")
            assert io.partition(other, known) == other
    assert port_baseline.load_baseline(str(tmp_path / "absent.json")) == \
        ref_baseline.load_baseline(str(tmp_path / "absent.json")) == set()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 99}))
    for io in (ref_baseline, port_baseline):
        with pytest.raises(ValueError):
            io.load_baseline(str(bad))


# ------------------------------------------------------------ the CLI
def _cli_both(capsys, argv):
    """Each CLI's (exit code, stdout) on the same arguments."""
    out = []
    for main in (ref_cli, port_cli):
        code = main(list(argv))
        out.append((code, capsys.readouterr().out))
    return out


@pytest.mark.parametrize("files, extra, code", [
    ({"src/mod.py": "x = 1\n"}, ["--no-baseline"], 0),
    ({"src/mod.py": SWALLOW}, ["--no-baseline"], 1),
    ({"src/mod.py": "def broken(:\n"}, ["--no-baseline"], 1),
    ({"src/mod.py": SWALLOW}, ["--only", "no-such-rule"], 2),
    ({"src/mod.py": SWALLOW}, ["--baseline", "bad.json"], 2),
    ({"src/mod.py": SWALLOW, "src/b.py": SWALLOW},
     ["--no-baseline", "--format", "json"], 1),
    ({"src/mod.py": "x = 1\n"}, ["--no-baseline", "--format", "json"], 0),
])
def test_cli_exit_codes_and_output_match(tmp_path, capsys, files, extra,
                                         code):
    root = _seed(tmp_path, files)
    bad = tmp_path / "bad.json"         # --baseline is read from the cwd
    bad.write_text(json.dumps({"version": 99}))
    extra = [str(bad) if a == "bad.json" else a for a in extra]
    (want_code, want_out), (got_code, got_out) = _cli_both(
        capsys, ["check", "src", "--root", root] + extra)
    assert got_code == want_code == code
    assert got_out == want_out
    if "json" in extra:
        assert json.loads(got_out) == json.loads(want_out)


def test_cli_baseline_then_check_match(tmp_path, capsys):
    root = _seed(tmp_path, {"src/mod.py": SWALLOW})
    for main, name in ((ref_cli, "ref.json"), (port_cli, "port.json")):
        base = str(tmp_path / name)
        assert main(["baseline", "src", "--root", root,
                     "--baseline", base]) == 0
        assert main(["check", "src", "--root", root,
                     "--baseline", base]) == 0
        assert "1 baselined" in capsys.readouterr().out
    assert (tmp_path / "ref.json").read_bytes() == \
        (tmp_path / "port.json").read_bytes()


def test_port_baseline_default_never_writes_the_reference_s(
        tmp_path, monkeypatch, capsys):
    _seed(tmp_path, {"src/repro_torch/mod.py": SWALLOW,
                     "tools/t.py": "x = 1\n"})
    monkeypatch.chdir(tmp_path)
    assert port_cli(["baseline"]) == 0
    assert (tmp_path / "analysis-baseline-torch.json").exists()
    assert not (tmp_path / "analysis-baseline.json").exists()
    payload = json.loads(
        (tmp_path / "analysis-baseline-torch.json").read_text())
    assert [e["path"] for e in payload["findings"]] == \
        ["src/repro_torch/mod.py"]
    assert port_cli(["check"]) == 0
    assert "1 baselined" in capsys.readouterr().out
    assert DEFAULT_ROOTS == ("src/repro_torch", "chip_smoke.py", "tools")
    assert port_baseline.DEFAULT_BASELINE == "analysis-baseline-torch.json"


# ------------------------------------------- torch-thread-no-device
THREAD_POSITIVES = [
    # a thread target that decodes outside any scope
    """
    import threading
    def work(session, datas):
        return session.decode_batch(datas)
    def start(session, datas):
        with use_device("cpu"):
            threading.Thread(target=work, args=(session, datas)).start()
    """,
    # the service's loop handed to the thread without its wrapper
    """
    import threading
    class Service:
        def start(self):
            threading.Thread(target=self._worker_loop, daemon=True).start()
        def _worker_loop(self):
            while True:
                self._serve_batch(self.q.get())
        def _serve_batch(self, batch):
            return open_decoder(batch.path).decode_batch(batch.items)
    """,
    # an executor task reading the device, through a helper
    """
    from concurrent.futures import ThreadPoolExecutor
    def helper(x):
        return torch.as_tensor(x, device=current_device())
    def run(xs):
        ex = ThreadPoolExecutor(2)
        return [f.result() for f in [ex.submit(helper, x) for x in xs]]
    """,
    # .map of a nested def; a torch name in an item entered before the
    # use_device item is outside its scope
    """
    def run(ex, stream, xs):
        def work(x):
            with torch.cuda.stream(stream), use_device("cpu"):
                return x + 1
        return list(ex.map(work, xs))
    """,
    # a lambda target
    """
    import threading
    t = threading.Thread(target=lambda: torch.zeros(3).sum())
    """,
]


@pytest.mark.parametrize("source", THREAD_POSITIVES)
def test_thread_rule_flags_device_work_outside_use_device(source):
    found = run(source, "torch-thread-no-device")
    assert rule_ids(found) == ["torch-thread-no-device"]
    assert "outside use_device" in found[0].message


def test_thread_rule_names_the_reach_and_the_callee():
    found = run(THREAD_POSITIVES[1], "torch-thread-no-device")
    assert "_worker_loop()" in found[0].message
    assert ".decode_batch() in _serve_batch()" in found[0].message
    assert found[0].line == 5


THREAD_NEAR_MISSES = [
    # service/engine.py: the thread runs the loop through _on_device
    """
    import threading
    class DecodeService:
        def start(self):
            t = threading.Thread(target=self._on_device,
                                 args=(self._worker_loop,),
                                 name="svc-worker-0", daemon=True)
            t.start()
        def _worker_loop(self):
            while True:
                self._serve_batch(self.q.get())
        def _serve_batch(self, batch):
            return open_decoder(batch.path).decode_batch(batch.items)
        def _on_device(self, fn, *args):
            with use_device(self.device):
                fn(*args)
    """,
    # data/loader.py: the multi-item with, per item and per chunk
    """
    from concurrent.futures import ThreadPoolExecutor
    class DataLoader:
        def _decode_quiet(self, i):
            try:
                with trace.span("loader.fetch"):
                    data = self.files[i]
                with trace.span("loader.decode"), use_device(self.device):
                    return self.session.decode_batch([data])[0], None
            except (UnsupportedJpeg, CorruptJpeg) as e:
                return None, f"{type(e).__name__}: {e}"
        def _iter_threads(self, order):
            ex = ThreadPoolExecutor(max_workers=2)
            pending = {p: ex.submit(self._decode_quiet, i)
                       for p, i in enumerate(order)}
            return pending
        def _iter_chunks(self, chunks):
            ex = ThreadPoolExecutor(max_workers=2)
            def work(idxs):
                with trace.span("loader.decode", chunk=len(idxs)), \\
                        use_device(self.device):
                    return self.session.decode_batch(idxs)
            return [ex.submit(work, c) for c in chunks]
    """,
    # data/loader.py: prefetch_to_device's producer
    """
    import queue
    import threading
    from typing import Any, List, Tuple
    def prefetch_to_device(iterator, dev, depth=2):
        buf = queue.Queue(maxsize=depth)
        stop = threading.Event()
        def _put(item):
            while not stop.is_set():
                try:
                    buf.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False
        def producer():
            inflight: List[Tuple[Any, List[torch.Tensor]]] = []
            try:
                with use_device(dev):
                    side = torch.cuda.Stream(dev)
                    for item in iterator:
                        with torch.cuda.stream(side):
                            event = torch.cuda.Event()
                        inflight.append((event, item))
                        _put(item)
            finally:
                for event, _ in inflight:
                    event.synchronize()
                _put(None)
        t = threading.Thread(target=producer, daemon=True,
                             name="prefetch-producer")
        t.start()
        return t
    """,
    # bench/service_load.py: clients re-enter the starter's device
    """
    import threading
    def closed_loop(stream, clients=4):
        dev = selected_device()
        with make_service(2) as svc:
            chunks = [stream[k::clients] for k in range(clients)]
            def client(cid, chunk):
                with use_device(dev):
                    for data in chunk:
                        svc.decode(data, client=cid)
            threads = [threading.Thread(target=client, args=(f"c{k}", ch))
                       for k, ch in enumerate(chunks)]
            for t in threads:
                t.start()
    """,
    # obs/http.py and jpeg/huffman.py: threads that never touch torch
    """
    import asyncio
    import threading
    class TelemetryServer:
        def start(self):
            self._thread = threading.Thread(
                target=self._run, name="obs-telemetry", daemon=True)
            self._thread.start()
        def _run(self):
            self._loop = asyncio.new_event_loop()
            self._loop.run_until_complete(self._serve())
    def _decode_chunk(segs, counts, tables_key, components):
        return [decode_segment(s, tables_key, components, n)
                for s, n in zip(segs, counts)]
    def _decode_parallel(out, segs, counts, tables_key, components, pool):
        return [pool.submit(_decode_chunk, segs, counts, tables_key,
                            components)]
    """,
]


@pytest.mark.parametrize("source", THREAD_NEAR_MISSES)
def test_thread_rule_near_misses_stay_clean(source):
    assert run(source, "torch-thread-no-device") == []


def test_thread_rule_sees_the_near_misses_targets():
    """Each near miss without its ``use_device`` is flagged, so the
    clean result above is the scope's doing, not a missed target (the
    bench client's body, ``svc.decode``, is clean either way: the
    service re-enters its own device)."""
    for source, strip in [
            (THREAD_NEAR_MISSES[0], ("target=self._on_device,",
                                     "target=self._worker_loop,")),
            (THREAD_NEAR_MISSES[1], (", use_device(self.device):", ":")),
            (THREAD_NEAR_MISSES[2], ("with use_device(dev):", "if True:"))]:
        assert strip[0] in source
        found = run(source.replace(strip[0], strip[1]),
                    "torch-thread-no-device")
        assert found and set(rule_ids(found)) == {"torch-thread-no-device"}


# ----------------------------------------------- torch-cuda-in-fork
FORK_TARGET = """
    import multiprocessing as mp
    import torch
    def touch():
        x = torch.ones(4, device="cuda")
        torch.cuda.synchronize()
        return float(x.sum())
    def main():
        torch.ones(1, device="cuda")
        p = mp.get_context("{method}").Process(target=touch)
        p.start()
        p.join(60)
    """

FORK_POSITIVES = [
    FORK_TARGET.replace("{method}", "fork"),
    # a pool initializer (default context) moving state to the card
    """
    import multiprocessing
    def _init(w):
        global W
        W = w.cuda()
    def go(w):
        return multiprocessing.Pool(2, initializer=_init, initargs=(w,))
    """,
    # a fork pool's task, the pool bound to a local name
    """
    import multiprocessing as mp
    def work(x):
        return torch.as_tensor(x, device="cuda:0").sum()
    def go(xs):
        ctx = mp.get_context("fork")
        pool = ctx.Pool(2)
        return pool.map(work, xs)
    """,
    # a default ProcessPoolExecutor's task reading the device, through
    # a helper
    """
    from concurrent.futures import ProcessPoolExecutor
    def helper(x):
        return x.to(current_device())
    def task(x):
        return helper(x)
    def go(xs):
        with ProcessPoolExecutor(2) as ex:
            return [ex.submit(task, x) for x in xs]
    """,
    # the loader's shape, its worker touching CUDA
    """
    import multiprocessing as mp
    def _proc_init(handle):
        global DEV
        DEV = torch.device("cuda", 0)
    def _proc_work(i):
        return torch.cuda.current_device(), i
    class DataLoader:
        def _ensure_pool(self):
            if self._pool is None:
                ctx = mp.get_context("fork")
                self._pool = ctx.Pool(2, initializer=_proc_init,
                                      initargs=(self.handle,))
            return self._pool
        def _iter_process(self, order):
            pool = self._ensure_pool()
            return pool.imap(_proc_work, order, chunksize=4)
    """,
]


@pytest.mark.parametrize("source, count", zip(FORK_POSITIVES,
                                              [1, 1, 1, 1, 2]))
def test_fork_rule_flags_cuda_in_a_forked_child(source, count):
    found = run(source, "torch-cuda-in-fork")
    assert rule_ids(found) == ["torch-cuda-in-fork"] * count
    assert "forked child" in found[0].message


FORK_NEAR_MISSES = [
    FORK_TARGET.replace("{method}", "spawn"),
    FORK_TARGET.replace("{method}", "forkserver"),
    # the same task under a spawn executor
    FORK_POSITIVES[3].replace(
        "ProcessPoolExecutor(2)",
        "ProcessPoolExecutor(2, mp_context=mp.get_context('spawn'))"),
    # data/loader.py: the decoder is picked at run time by name
    """
    import multiprocessing as mp
    _PROC_DECODE = None
    def _proc_init(handle, path_name, trace_cfg=None):
        global _PROC_SOURCE, _PROC_DECODE
        from repro_torch.codecs import get_decoder
        trace.init_worker(trace_cfg)
        _PROC_SOURCE = handle.open()
        _PROC_DECODE = get_decoder(path_name).fn
    def _proc_work(i):
        try:
            with trace.span("loader.decode"):
                out = i, _PROC_DECODE(_PROC_SOURCE[i]), None
        except (UnsupportedJpeg, CorruptJpeg) as e:
            out = i, None, f"{type(e).__name__}: {e}"
        trace.flush()
        return out
    class DataLoader:
        def _proc_initargs(self):
            return (self.source.open_in_worker(), self.path_name,
                    trace.get_tracer().worker_config())
        def _ensure_pool(self):
            if self._pool is None:
                import multiprocessing as mp
                ctx = mp.get_context("fork")
                self._pool = ctx.Pool(self.cfg.num_workers,
                                      initializer=_proc_init,
                                      initargs=self._proc_initargs())
            return self._pool
        def _iter_process(self, order):
            pool = self._ensure_pool()
            return iter(pool.imap(_proc_work, order, chunksize=4))
    """,
    # a thread pool's task is no forked child
    FORK_POSITIVES[2].replace("pool = ctx.Pool(2)",
                              "pool = ThreadPoolExecutor(2)"),
]


@pytest.mark.parametrize("source", FORK_NEAR_MISSES)
def test_fork_rule_near_misses_stay_clean(source):
    assert run(source, "torch-cuda-in-fork") == []


# ----------------------------------------- torch-host-sync-in-loop
HOT = "src/repro_torch/train/steps.py"
SYNC_POSITIVES = [
    """
    def train(state, batches):
        losses = []
        for batch in batches:
            state, loss = step(state, batch)
            losses.append(loss.item())
        return losses
    """,
    """
    import torch
    def drain(q):
        while q:
            launch(q.pop())
            torch.cuda.synchronize()
    """,
    """
    def wait(flag):
        while flag.cpu().numpy()[0] == 0:
            poll()
    """,
    """
    def decode(spec, coef):
        planes = []
        for c in spec.components:
            blocks = ops.idct8x8(coef[c])
            planes.append(blocks.tolist())
        return planes
    """,
]


@pytest.mark.parametrize("source", SYNC_POSITIVES)
@pytest.mark.parametrize("path", [HOT, "src/repro_torch/jpeg/paths.py",
                                  "src/repro_torch/data/loader.py"])
def test_host_sync_rule_flags_a_sync_in_a_hot_loop(source, path):
    found = run(source, "torch-host-sync-in-loop", path=path)
    assert found and set(rule_ids(found)) == {"torch-host-sync-in-loop"}
    assert "every iteration" in found[0].message


SYNC_NEAR_MISSES = [
    # the same call after the loop
    """
    def train(state, batches):
        losses = []
        for batch in batches:
            state, loss = step(state, batch)
            losses.append(loss)
        return torch.stack(losses).cpu().numpy()
    """,
    # in the for's iterable, which runs once
    """
    def each(t):
        for x in t.tolist():
            use(x)
    """,
    # in a def nested in the loop: the loop does not run it
    """
    def make(ts):
        fns = []
        for t in ts:
            def read(t=t):
                return t.item()
            fns.append(read)
        return fns
    """,
]


@pytest.mark.parametrize("source", SYNC_NEAR_MISSES)
def test_host_sync_rule_near_misses_stay_clean(source):
    assert run(source, "torch-host-sync-in-loop", path=HOT) == []


@pytest.mark.parametrize("path", [
    "src/repro_torch/bench/views/common.py", "chip_smoke.py",
    "tools/probe_flash.py", "src/repro/train/steps.py", "<memory>.py"])
def test_host_sync_rule_skips_paths_off_the_hot_path(path):
    # bench/views/common.py's timing loop: a sync is its point
    source = """
    def time_us(fn, reps):
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
    """
    assert run(source, "torch-host-sync-in-loop", path=path) == []
    assert run(source, "torch-host-sync-in-loop", path=HOT) != []


# ------------------------------------------- chip_smoke.py phase 12
def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_phase12", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_phase12_probes_get_the_checker_verdicts_it_expects():
    cs = _chip_smoke()
    fork, spawn = (cs.FORK_PROBE.replace("{method}", m)
                   for m in ("fork", "spawn"))
    found = run(fork, "torch-cuda-in-fork")
    assert len(found) == 1 and "touch_cuda()" in found[0].message
    assert run(spawn, "torch-cuda-in-fork") == []
    assert rule_ids(run(cs.THREAD_PROBE, "torch-thread-no-device")) == \
        ["torch-thread-no-device"]
    assert run(cs.THREAD_PROBE_SCOPED, "torch-thread-no-device") == []
    assert set(cs.DEVICE_RULE_IDS) == set(DEVICE_RULES)


def test_phase12_thread_probes_read_the_devices_it_expects(monkeypatch):
    """(c) without a card: the default device is reported, not used, so
    the bare thread reads ``cuda:0`` once a card is said to be there."""
    import torch
    from repro_torch import device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(device, "_PROCESS_DEVICE", None)
    cs = _chip_smoke()
    for source, want in ((cs.THREAD_PROBE, "cuda:0"),
                         (cs.THREAD_PROBE_SCOPED, "cpu")):
        space, out = {}, []
        exec(compile(source, "probe.py", "exec"), space)
        space["start"](out, 60)
        assert out == [want]


# ---------------------------------------------------------- catalog
def test_every_port_rule_documents_itself():
    for rule_id, cls in RULES.items():
        assert rule_id and rule_id == cls.id
        assert cls.summary and cls.motivation
    for rule_id in DEVICE_RULES:
        assert "cannot" in RULES[rule_id].__doc__


def test_rules_lists_exactly_the_nine_ids(capsys):
    assert port_cli(["rules"]) == 0
    ids = [line for line in capsys.readouterr().out.splitlines()
           if line and not line.startswith(" ")]
    assert ids == sorted(SHARED + DEVICE_RULES)
    assert [c.id for c in resolve_rules(None)] == list(RULES)
    assert {c.id for c in resolve_rules(["except-swallow,"
                                         "torch-cuda-in-fork"])} == \
        {"except-swallow", "torch-cuda-in-fork"}
    for gone in ("jit-in-loop", "nope"):
        with pytest.raises(SelectorError):
            resolve_rules([gone])


def test_no_checker_module_imports_torch():
    pkg = REPO / "src" / "repro_torch" / "analysis"
    files = sorted(pkg.rglob("*.py"))
    assert len(files) == 12
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("torch", "jax", "repro"), (path, name)
                assert top in ("repro_torch", "__future__") or \
                    top in ("argparse", "ast", "dataclasses", "json", "os",
                            "re", "sys", "typing"), (path, name)


# ------------------------------------------------------- self-check
def test_port_tree_is_clean():
    # the port's gate: default roots, and no baseline help (the port's
    # baseline file stays absent)
    findings = port.analyze_paths(root=str(REPO))
    assert findings == [], "\n".join(f.render() for f in findings)
    assert not os.path.exists(REPO / "analysis-baseline-torch.json")
