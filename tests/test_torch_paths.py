"""The port's decode paths, mirroring tests/test_jpeg.py.

Every port path is held against the reference's ``numpy-ref`` on the
``corpus`` fixture, and each ``cuda-*`` / ``torch-*`` path against its
reference counterpart (``pallas-*`` in interpret mode / ``jnp-*``)
within one level: the port's plain versions and the reference's kernels
sum in different orders, so a rounding tie may land one level apart.
Everything runs on the CPU, where the ``cuda-*`` paths run each kernel's
plain PyTorch version.
"""
import numpy as np
import pytest

import repro.codecs as jcodecs
from repro.jpeg import encoder
from repro.jpeg.corpus import natural_image
from repro_torch.codecs import contrib, decoder_names, get_decoder
from repro_torch.device import use_device
from repro_torch.jpeg import parser as P
from repro_torch.jpeg import pipeline
from repro_torch.jpeg.parser import UnsupportedJpeg
from repro_torch.kernels import ops

PORT_PATHS = ["numpy-ref", "numpy-fast", "numpy-int", "numpy-sparse",
              "fft-idct", "strict-fast", "torch-basic", "torch-fused",
              "torch-batch", "strict-torch", "cuda-idct", "cuda-fused",
              "cuda-batch", "strict-cuda"]
COUNTERPARTS = [("cuda-idct", "pallas-idct"), ("cuda-fused", "pallas-fused"),
                ("cuda-batch", "pallas-batch"), ("strict-cuda", "strict-pallas"),
                ("torch-basic", "jnp-basic"), ("torch-fused", "jnp-fused"),
                ("torch-batch", "jnp-batch"), ("strict-torch", "strict-turbo")]
BATCHED = ("torch-batch", "torch-fused", "cuda-batch", "cuda-fused")


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


@pytest.fixture(scope="module")
def oracle(corpus):
    ref = jcodecs.get_decoder("numpy-ref")
    return [ref.decode(f) for f in corpus.files]


def _img(h=72, w=88, seed=0):
    return natural_image(np.random.RandomState(seed), h, w)


def _max_diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) -
                      np.asarray(b).astype(int)).max())


def test_registry_holds_exactly_the_port_paths():
    """The port's paths, then the contrib plugins that import, as the
    reference's registry orders its built-ins and plugins."""
    assert decoder_names() == PORT_PATHS + list(contrib.available())


@pytest.mark.parametrize("name", PORT_PATHS)
def test_port_path_agrees_with_reference_oracle(name, corpus, oracle):
    path = get_decoder(name)
    skips = []
    for i, f in enumerate(corpus.files):
        try:
            out = path.decode(f)
        except UnsupportedJpeg:
            skips.append(i)
            continue
        assert out.shape == oracle[i].shape and out.dtype == np.uint8
        # the fused cuda paths clamp plane samples in-kernel before the
        # YCCK inversion, which amplifies rounding on the rare image
        tol = 16 if i == corpus.rare_index else 4
        assert _max_diff(out, oracle[i]) <= tol, (name, i)
    assert skips == ([corpus.rare_index] if path.strict else []), skips


@pytest.mark.parametrize("name, counterpart", COUNTERPARTS)
def test_port_path_matches_reference_counterpart(name, counterpart,
                                                 corpus):
    port, ref = get_decoder(name), jcodecs.get_decoder(counterpart)
    assert port.strict == ref.strict
    for i, f in enumerate(corpus.files):
        if port.strict and i == corpus.rare_index:
            with pytest.raises(UnsupportedJpeg):
                port.decode(f)
            continue
        assert _max_diff(port.decode(f), ref.decode(f)) <= 1, (name, i)


@pytest.mark.parametrize("name", BATCHED)
def test_decode_batch_byte_identical_to_serial(name, corpus):
    path = get_decoder(name)
    batch = path.decode_batch(list(corpus.files))
    for i, (res, f) in enumerate(zip(batch, corpus.files)):
        np.testing.assert_array_equal(res, path.decode(f),
                                      err_msg=f"{name}[{i}]")


@pytest.mark.parametrize("name", ["cuda-batch", "torch-batch"])
def test_decode_batch_isolates_bad_items(name, corpus):
    path = get_decoder(name)
    datas = [corpus.files[0], b"\x00\x01not-a-jpeg", corpus.files[1]]
    out = path.decode_batch(datas)
    assert isinstance(out[1], P.CorruptJpeg)
    np.testing.assert_array_equal(out[0], path.decode(corpus.files[0]))
    np.testing.assert_array_equal(out[2], path.decode(corpus.files[1]))
    strict = get_decoder("strict-cuda")
    out = strict.decode_batch([corpus.files[0],
                               corpus.files[corpus.rare_index]])
    assert isinstance(out[1], UnsupportedJpeg)
    assert not isinstance(out[0], BaseException)


def test_torch_batch_one_transform_per_structure_group():
    files = [encoder.encode_jpeg(_img(h=64, w=64, seed=10 + k),
                                 quality=85, subsampling="420")
             for k in range(4)]
    before = pipeline.TRANSFORM_BATCH_CALLS
    out = get_decoder("torch-batch").decode_batch(files)
    assert pipeline.TRANSFORM_BATCH_CALLS == before + 1
    assert all(not isinstance(r, BaseException) for r in out)


def test_cuda_batch_one_decode_batch_call_per_structure_group(
        corpus, monkeypatch):
    """One ``ops.decode_batch`` call per same-structure group (on the
    card, one launch each: tests/test_torch_gpu.py and chip_smoke.py
    count launches), and one ``ops.ycbcr2rgb`` call per 3-component
    image."""
    calls = {"decode_batch": 0, "ycbcr2rgb": 0}

    def counted(name):
        fn = getattr(ops, name)

        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    for name in calls:
        monkeypatch.setattr(ops, name, counted(name))
    specs = [P.parse(f, headers_only=True) for f in corpus.files]
    groups = {(len(s.components), tuple((c.h, c.v) for c in s.components))
              for s in specs}
    out = get_decoder("cuda-batch").decode_batch(list(corpus.files))
    assert all(not isinstance(r, BaseException) for r in out)
    assert calls["decode_batch"] == len(groups) >= 2
    assert calls["ycbcr2rgb"] == sum(len(s.components) == 3 for s in specs)


def test_restart_interval_all_port_paths_agree():
    img = _img(h=48, w=64, seed=6)
    plain = encoder.encode_jpeg(img, quality=90, subsampling="420")
    dri = encoder.encode_jpeg(img, quality=90, subsampling="420",
                              restart_interval=2)
    for name in PORT_PATHS:
        path = get_decoder(name)
        np.testing.assert_array_equal(path.decode(plain), path.decode(dri),
                                      err_msg=name)


def test_progressive_streams_strict_refuse_others_decode():
    img = _img(h=24, w=24, seed=2)
    prog = encoder.encode_jpeg(img, quality=90, subsampling="420",
                               progressive=True, scan_script="spectral")
    base = encoder.encode_jpeg(img, quality=90, subsampling="420")
    for name in PORT_PATHS:
        spec = get_decoder(name)
        if spec.caps.strict:
            with pytest.raises(UnsupportedJpeg, match="progressive"):
                spec.fn(prog)
        else:
            assert spec.caps.progressive
            np.testing.assert_array_equal(spec.fn(prog), spec.fn(base),
                                          err_msg=name)


def _saturated(seed, h=48, w=64):
    """Pure-colour rectangles: their planes overshoot [0, 255] after the
    IDCT, where clamping before colour conversion changes the result."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w, 3), np.uint8)
    for _ in range(12):
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
        img[y:y + rng.randint(4, 16), x:x + rng.randint(4, 16)] = \
            rng.choice([0, 255], 3)
    return img


@pytest.mark.parametrize("seed, sub", [(0, "420"), (5, "420"), (1, "444")])
def test_fused_plane_clamp_parts_from_the_oracle_as_in_the_reference(seed,
                                                                     sub):
    """The fused kernels clamp each plane to [0, 255] before colour
    conversion; ``numpy-ref`` and the jnp/torch paths do not. On
    saturated colour the two semantics differ by more than the oracle's
    4 levels in the reference itself (pallas-fused against jnp-fused and
    numpy-ref), and the port parts by the same amount."""
    data = encoder.encode_jpeg(_saturated(seed), quality=90, subsampling=sub)
    ref_gap = _max_diff(jcodecs.get_decoder("pallas-fused").decode(data),
                        jcodecs.get_decoder("jnp-fused").decode(data))
    port_gap = _max_diff(get_decoder("cuda-fused").decode(data),
                         get_decoder("torch-fused").decode(data))
    assert ref_gap > 4
    assert abs(port_gap - ref_gap) <= 1
    assert _max_diff(get_decoder("cuda-fused").decode(data),
                     jcodecs.get_decoder("pallas-fused").decode(data)) <= 1
    assert _max_diff(get_decoder("torch-fused").decode(data),
                     jcodecs.get_decoder("numpy-ref").decode(data)) <= 4


def test_paths_emit_the_reference_stage_spans(corpus):
    from repro_torch.obs import trace
    tracer = trace.Tracer()
    with trace.use_tracer(tracer):
        get_decoder("cuda-batch").decode_batch(list(corpus.files[:3]))
        get_decoder("torch-fused").decode(corpus.files[0])
        get_decoder("torch-basic").decode(corpus.files[0])
    names = set(trace.stage_seconds(tracer.events()))
    assert {"jpeg.parse", "jpeg.entropy", "jpeg.dequant_idct",
            "jpeg.assemble", "jpeg.transform"} <= names
