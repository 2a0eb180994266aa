"""The port's decoder API (its own copy of ``repro.codecs``): eligibility
of the ``torch``/``cuda`` engines, session outcomes, the probe, and the
separation of the two registries. Everything runs on the CPU, where the
``cuda-*`` paths run each kernel's plain PyTorch version."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.codecs as jcodecs
from repro_torch.codecs import (Capabilities, DecodeOutcome, ExecContext,
                                IneligibleDecoder, contrib, decoder_names,
                                eligible, get_decoder, list_decoders,
                                open_decoder, probe_key, register_decoder,
                                resolve_entropy_workers, unregister_decoder)
from repro_torch.device import use_device
from repro_torch.jpeg.parser import CorruptJpeg, UnsupportedJpeg

NUMPY_FAMILY = {"numpy-ref", "numpy-fast", "numpy-int", "numpy-sparse",
                "fft-idct", "strict-fast"}
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def test_engines_are_numpy_torch_cuda():
    """The built-in paths' engines are numpy, torch and cuda; each contrib
    plugin that imports is an engine of its own, named as the plugin."""
    engines = {n: get_decoder(n).engine for n in decoder_names()}
    plugins = set(contrib.available())
    assert set(engines.values()) == {"numpy", "torch", "cuda"} | plugins
    assert {n for n, e in engines.items() if e == "numpy"} == NUMPY_FAMILY
    assert all(n.startswith(e + "-") or n == f"strict-{e}"
               for n, e in engines.items() if e != "numpy"
               and n not in plugins)
    assert all(engines[n] == n for n in plugins)


@pytest.mark.parametrize("context", list(ExecContext))
def test_only_the_forked_pool_vetoes_and_only_torch_and_cuda(context):
    for name in decoder_names():
        caps = get_decoder(name).caps
        verdict = eligible(caps, context)
        if context is ExecContext.PROCESS_POOL and \
                caps.engine in ("torch", "cuda"):
            assert not verdict and not caps.fork_safe, name
            assert "not process-loader eligible" in verdict.reason
            assert "CUDA context" in verdict.reason
            assert "jax" not in verdict.reason
        else:
            assert verdict, (name, context)


def test_fork_safe_derives_from_the_engine():
    assert Capabilities(engine="numpy").fork_safe
    assert not Capabilities(engine="torch").fork_safe
    assert not Capabilities(engine="cuda").fork_safe
    assert Capabilities(engine="cuda", fork_safe=True).fork_safe


def test_open_decoder_enforces_context():
    for name in ("cuda-batch", "torch-batch", "strict-cuda"):
        with pytest.raises(IneligibleDecoder, match=name):
            open_decoder(name, context=ExecContext.PROCESS_POOL)
    open_decoder("numpy-fast", context=ExecContext.PROCESS_POOL).close()
    open_decoder("cuda-batch", context=ExecContext.SERVICE).close()


def test_list_decoders_process_pool_is_the_numpy_family():
    assert {s.name for s in
            list_decoders(context=ExecContext.PROCESS_POOL)} == \
        NUMPY_FAMILY | set(contrib.available())
    assert {s.name for s in list_decoders(batchable=True)} == \
        {"torch-fused", "torch-batch", "cuda-fused", "cuda-batch"}


@pytest.mark.parametrize("name", ["strict-cuda", "strict-torch",
                                  "strict-fast"])
def test_decode_outcome_semantics(name, corpus):
    with open_decoder(name, context=ExecContext.SERVICE) as dec:
        ok = dec.decode(corpus.files[0])
        assert ok.ok and ok.kind == DecodeOutcome.IMAGE
        assert ok.unwrap().dtype == np.uint8

        skip = dec.decode(corpus.files[corpus.rare_index])
        assert skip.kind == DecodeOutcome.SKIP and not skip.ok
        assert isinstance(skip.error, UnsupportedJpeg) and skip.reason
        with pytest.raises(UnsupportedJpeg):
            skip.unwrap()

        err = dec.decode(b"\x00\x01not-a-jpeg")
        assert err.kind == DecodeOutcome.ERROR
        assert isinstance(err.error, CorruptJpeg)


@pytest.mark.parametrize("name, last", [
    ("cuda-batch", DecodeOutcome.IMAGE), ("torch-batch", DecodeOutcome.IMAGE),
    ("strict-cuda", DecodeOutcome.SKIP)])
def test_decode_batch_outcomes_index_aligned(name, last, corpus):
    with open_decoder(name, context=ExecContext.SERVICE) as dec:
        outs = dec.decode_batch([corpus.files[0], b"\xff\xd8 broken",
                                 corpus.files[corpus.rare_index]])
    assert [o.kind for o in outs] == [DecodeOutcome.IMAGE,
                                      DecodeOutcome.ERROR, last]


def test_session_lifecycle_close_and_warmup(corpus):
    dec = open_decoder("cuda-batch", context=ExecContext.THREAD_POOL)
    assert dec.warmup(corpus.files[:2]) == 2
    dec.close()
    with pytest.raises(RuntimeError, match="closed"):
        dec.decode(corpus.files[0])
    with pytest.raises(RuntimeError, match="closed"):
        with dec:
            pass


def test_probe_matches_the_reference_probe(corpus):
    with open_decoder("cuda-batch") as dec:
        for f in corpus.files:
            assert dec.probe(f) == probe_key(f) == jcodecs.probe_key(f)


@pytest.mark.parametrize("context", list(ExecContext))
@pytest.mark.parametrize("requested", [0, 1, 2, 4, 1000])
def test_entropy_worker_resolution_is_the_reference_rule(context, requested):
    for engine in ("numpy", "torch", "cuda"):
        for parallel in (False, True):
            got = resolve_entropy_workers(
                Capabilities(engine=engine, parallel_entropy=parallel),
                context, requested)
            want = jcodecs.resolve_entropy_workers(
                jcodecs.Capabilities(engine=engine,
                                     parallel_entropy=parallel),
                jcodecs.ExecContext(context.value), requested)
            assert got == want


def test_a_port_plugin_stays_in_the_port_registry():
    name = "test-port-plugin"
    register_decoder(name, lambda d: np.zeros((8, 8, 3), np.uint8),
                     engine="cuda")
    try:
        assert name in decoder_names()
        assert name not in jcodecs.decoder_names()
        assert not get_decoder(name).caps.fork_safe
        with pytest.raises(ValueError, match="already registered"):
            register_decoder(name, lambda d: None)
    finally:
        unregister_decoder(name)
    assert name not in decoder_names()


def test_registries_do_not_mix():
    port, ref = set(decoder_names()), set(jcodecs.decoder_names())
    assert not any(n.startswith(("torch-", "cuda-", "strict-torch",
                                 "strict-cuda")) for n in ref)
    assert not any(n.startswith(("jnp-", "pallas-")) for n in port)


def test_importing_the_port_paths_leaves_the_reference_registry_alone():
    """A fresh process: the reference's decoder names are the same before
    and after the port's paths register into the port's registry."""
    code = (
        "import json, repro.codecs as J\n"
        "before = J.decoder_names()\n"
        "import repro_torch.jpeg.paths, repro_torch.codecs as T\n"
        "port = T.decoder_names()\n"
        "print(json.dumps([before, J.decoder_names(), port]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    before, after, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert before == after
    assert "cuda-batch" in port and "cuda-batch" not in after
