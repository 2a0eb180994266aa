"""The port's Pillow/OpenCV plugins (``repro_torch.codecs.contrib``) and
its legacy decode-path shims (``repro_torch.jpeg.paths.DECODE_PATHS``,
``get_path``, ``list_paths``), mirroring tests/test_codecs.py's contrib
and shim tests on the port's registry.

Both packages register ``pillow`` and ``opencv`` under the same names,
each into its own registry, wrapping the same library: the port's output
must equal the reference's byte for byte. Everything runs on the CPU;
the contrib decoders touch no device at all.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.codecs as jcodecs
from repro_torch.codecs import (ExecContext, as_spec, contrib, decoder_names,
                                eligible, get_decoder, list_decoders,
                                register_decoder, unregister_decoder)
from repro_torch.device import use_device
from repro_torch.jpeg.parser import UnsupportedJpeg
from test_torch_paths import PORT_PATHS

CONTRIB = ("pillow", "opencv")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _need(name):
    if name not in contrib.available():
        pytest.skip(f"{name} not importable in this environment")


# ------------------------------------------------------- contrib backends
@pytest.mark.parametrize("name", CONTRIB)
def test_contrib_backend_decodes_corpus(corpus, name):
    """tests/test_codecs.py's contrib check on the port's registry: the
    whole corpus (the rare YCCK member included) to RGB uint8 of the
    shape the built-in decoders give, within 32 levels of ``numpy-ref``
    (real libjpeg pipelines upsample chroma their own way), the rare
    image exempt from the bound."""
    _need(name)
    spec = get_decoder(name)
    assert spec.caps.fork_safe and not spec.caps.strict
    assert spec.caps.progressive and not spec.caps.batchable
    assert spec.engine == name
    assert eligible(spec.caps, ExecContext.PROCESS_POOL)
    ref = get_decoder("numpy-ref")
    for i, f in enumerate(corpus.files):
        img = spec.fn(f)
        assert img.dtype == np.uint8 and img.ndim == 3
        want = ref.fn(f)
        assert img.shape == want.shape, i
        if i == corpus.rare_index:
            continue    # YCCK inversion conventions legitimately diverge
        err = np.abs(img.astype(int) - want.astype(int)).max()
        assert err <= 32, (name, i, err)


@pytest.mark.parametrize("name", CONTRIB)
def test_contrib_output_equals_the_references_byte_for_byte(corpus, name):
    """Both packages wrap the same library: the same bytes in, the same
    array out, on every corpus image."""
    _need(name)
    mine, theirs = get_decoder(name), jcodecs.get_decoder(name)
    assert mine.fn is not theirs.fn
    assert mine.caps.engine == theirs.caps.engine
    for f in corpus.files:
        got, want = mine.fn(f), theirs.fn(f)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_contrib_registers_after_the_port_paths():
    assert decoder_names() == PORT_PATHS + list(contrib.available())
    assert set(contrib.available()) <= set(CONTRIB)


def test_contrib_backends_in_open_full_profile_only():
    """The full profile (selection None = open) sweeps contrib cells;
    smoke/quick select the built-in engine families, so contrib cells
    appear there as explicit skips."""
    if not contrib.available():
        pytest.skip("no contrib backend importable")
    from repro_torch.bench import PROFILES, build_registry
    for name in contrib.available():
        cells = [s for s in build_registry() if s.path == name]
        assert {s.kind for s in cells} >= {"single_thread", "dataloader"}
        assert f"loader/{name}/w2/process" in {s.name for s in cells}
        for s in cells:
            assert PROFILES["full"].wants(s)[0]
            for prof in ("smoke", "quick"):
                run_it, reason = PROFILES[prof].wants(s)
                assert not run_it and reason, (prof, s.name)


def test_contrib_plugins_are_fork_safe_service_arms():
    from repro_torch.service.router import BanditRouter
    forkable = {s.name for s in list_decoders(
        context=ExecContext.PROCESS_POOL, strict=False)}
    assert forkable == {"numpy-ref", "numpy-fast", "numpy-int",
                        "numpy-sparse", "fft-idct"} | set(contrib.available())
    arms = set(BanditRouter().snapshot())
    assert set(contrib.available()) <= arms


def test_missing_libraries_register_nothing():
    """Where neither library imports (as on the card's machine), the
    module imports, registers nothing and says so."""
    code = (
        "import json, sys\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['cv2'] = None\n"
        "from repro_torch.codecs import contrib, decoder_names\n"
        "print(json.dumps([list(contrib.available()), decoder_names()]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    available, names = json.loads(out.stdout.strip().splitlines()[-1])
    assert available == [] and names == PORT_PATHS


def test_contrib_exception_policy():
    from repro_torch.jpeg.parser import CorruptJpeg
    if "pillow" in contrib.available():
        with pytest.raises(CorruptJpeg, match="pillow"):
            get_decoder("pillow").fn(b"not a jpeg at all")
    if "opencv" in contrib.available():
        with pytest.raises(CorruptJpeg, match="empty input"):
            get_decoder("opencv").fn(b"")
        with pytest.raises(UnsupportedJpeg, match="no image"):
            get_decoder("opencv").fn(b"not a jpeg at all")


# ------------------------------------------------------------------ shims
def test_eligibility_matrix_parity_with_legacy_flags():
    """Every registered decoder x every ExecContext: the resolver's
    verdict reproduces the legacy ``process_eligible`` flag; only the
    forked pool vetoes, and only non-fork-safe decoders."""
    from repro_torch.jpeg.paths import DECODE_PATHS
    assert set(DECODE_PATHS) == set(decoder_names())
    assert list(DECODE_PATHS) == decoder_names()
    for name in decoder_names():
        caps = get_decoder(name).caps
        legacy = DECODE_PATHS[name]
        for ctx in ExecContext:
            verdict = eligible(caps, ctx)
            if ctx is ExecContext.PROCESS_POOL:
                assert bool(verdict) == legacy.process_eligible, (name, ctx)
                if not verdict:
                    assert "not process-loader eligible" in verdict.reason
            else:
                assert verdict, (name, ctx)


def test_a_port_plugin_shows_up_in_decode_paths_live():
    from repro_torch.jpeg.paths import DECODE_PATHS
    name = "test-shim-plugin"
    register_decoder(name, lambda d: np.zeros((8, 8, 3), np.uint8),
                     engine="numpy")
    try:
        assert name in DECODE_PATHS and len(DECODE_PATHS) == \
            len(decoder_names())
        assert DECODE_PATHS[name].fn is get_decoder(name).fn
        assert name not in jcodecs.decoder_names()
    finally:
        unregister_decoder(name)
    assert name not in DECODE_PATHS


def test_deprecation_shims_equivalent():
    from repro_torch.jpeg import paths
    with pytest.warns(DeprecationWarning, match="repro_torch.codecs"):
        p = paths.get_path("numpy-fast")
    spec = get_decoder("numpy-fast")
    assert p.fn is spec.fn and p.batch_fn is spec.batch_fn
    assert p.engine == spec.caps.engine
    assert p.process_eligible == spec.caps.fork_safe
    with pytest.warns(DeprecationWarning, match="repro_torch.codecs"):
        legacy = {q.name for q in paths.list_paths(process_eligible=True,
                                                   strict=False)}
    assert legacy == {s.name for s in
                      list_decoders(context=ExecContext.PROCESS_POOL,
                                    strict=False)}
    with pytest.warns(DeprecationWarning):
        strict = {q.name for q in paths.list_paths(strict=True)}
    assert strict == {"strict-fast", "strict-torch", "strict-cuda"}
    # the adapter round-trips through as_spec with identical capabilities
    back = as_spec(p)
    assert back.caps == spec.caps and back.fn is spec.fn
    # and a cached adapter is reused while its spec stays registered
    assert paths.DECODE_PATHS["numpy-fast"] is p


@pytest.mark.parametrize("name", ["numpy-fast", "cuda-batch", "torch-fused"])
def test_decode_path_adapter_decodes(corpus, name):
    from repro_torch.jpeg.paths import DECODE_PATHS
    img = DECODE_PATHS[name].decode(corpus.files[0])
    assert img.dtype == np.uint8
    np.testing.assert_array_equal(img, get_decoder(name).fn(corpus.files[0]))
    out = DECODE_PATHS["strict-fast"].decode_batch(
        [corpus.files[0], corpus.files[corpus.rare_index]])
    assert isinstance(out[1], UnsupportedJpeg)


def test_shims_resolve_lazily_from_the_package():
    """``import repro_torch.jpeg`` stays free of the registrations; the
    names resolve on first use (PEP 562)."""
    code = (
        "import json, sys, warnings\n"
        "import repro_torch.jpeg as J\n"
        "before = 'repro_torch.jpeg.paths' in sys.modules\n"
        "view = J.DECODE_PATHS\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        "    p = J.get_path('cuda-batch')\n"
        "print(json.dumps([before, len(view), p.engine,\n"
        "                  [str(x.category.__name__) for x in w]]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    before, n, engine, warned = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert not before
    assert n == len(PORT_PATHS) + len(contrib.available())
    assert engine == "cuda" and warned == ["DeprecationWarning"]
    import repro_torch.jpeg as J
    with pytest.raises(AttributeError, match="no attribute"):
        J.NO_SUCH_NAME
