"""The port keeps its own copies of the reference's numpy-only modules
(it may not import ``repro``). These tests hold each copy to its
original: same bytes, same fields, same coefficients, same tables."""
import dataclasses

import numpy as np
import pytest

from repro.jpeg import corpus as jcorpus
from repro.jpeg import encoder as jencoder
from repro.jpeg import huffman as jhuffman
from repro.jpeg import parser as JP
from repro.jpeg import tables as JT
from repro_torch.jpeg import corpus, encoder, huffman
from repro_torch.jpeg import parser as P
from repro_torch.jpeg import tables as T


def _img(h, w, seed):
    return jcorpus.natural_image(np.random.RandomState(seed), h, w)


@pytest.mark.parametrize("kw", [
    dict(quality=85, subsampling="420"),
    dict(quality=60, subsampling="444"),
    dict(quality=92, subsampling="420", restart_interval=2),
    dict(quality=90, subsampling="420", progressive=True),
    dict(quality=90, subsampling="444", progressive=True,
         scan_script="spectral"),
])
def test_encode_jpeg_gives_identical_bytes(kw):
    img = _img(50, 67, seed=3)
    assert encoder.encode_jpeg(img, **kw) == jencoder.encode_jpeg(img, **kw)


def test_encode_jpeg_ycck_gives_identical_bytes():
    img = _img(40, 48, seed=4)
    assert encoder.encode_jpeg_ycck(img, quality=88) == \
        jencoder.encode_jpeg_ycck(img, quality=88)


@pytest.mark.parametrize("n, seed, kw", [
    (12, 7, {}),
    (25, 0, {}),
    (8, 3, dict(restart_intervals=[0, 1, 2], qualities=[70, 90],
                subsamplings=["420", "444"])),
    (8, 5, dict(progressive=0.5, size_weights=[1, 2, 3, 4, 5])),
])
def test_build_corpus_gives_identical_corpora(n, seed, kw):
    a = corpus.build_corpus(n, seed=seed, **kw)
    b = jcorpus.build_corpus(n, seed=seed, **kw)
    assert a.files == b.files
    np.testing.assert_array_equal(a.labels, b.labels)
    assert (a.rare_index, a.sizes, a.progressive_indices) == \
        (b.rare_index, b.sizes, b.progressive_indices)


def test_corpus_helpers_are_identical():
    for n in (1, 33, 100, 50000):
        assert corpus.scaled_rare_index(n) == jcorpus.scaled_rare_index(n)
    np.testing.assert_array_equal(corpus.zipf_indices(40, 200, seed=3),
                                  jcorpus.zipf_indices(40, 200, seed=3))
    np.testing.assert_array_equal(
        corpus.natural_image(np.random.RandomState(1), 30, 41),
        jcorpus.natural_image(np.random.RandomState(1), 30, 41))


def _fields(spec):
    d = dataclasses.asdict(spec)
    d["qtables"] = {k: v.tolist() for k, v in d["qtables"].items()}
    return d


def test_parse_gives_identical_fields(corpus):
    for f in corpus.files:
        for headers_only in (False, True):
            assert _fields(P.parse(f, headers_only=headers_only)) == \
                _fields(JP.parse(f, headers_only=headers_only))


def test_parse_errors_are_the_port_types():
    with pytest.raises(P.CorruptJpeg):
        P.parse(b"\x00\x01not a jpeg")
    spec = P.parse(encoder.encode_jpeg_ycck(_img(16, 16, 0), quality=80))
    with pytest.raises(P.UnsupportedJpeg):
        P.check_strict(spec)
    assert issubclass(P.UnsupportedJpeg, P.CorruptJpeg)


def _same_coefficients(files):
    for f in files:
        a = huffman.decode_coefficients(P.parse(f))
        b = jhuffman.decode_coefficients(JP.parse(f))
        assert a.keys() == b.keys()
        for cid in a:
            assert a[cid].dtype == b[cid].dtype
            np.testing.assert_array_equal(a[cid], b[cid])


def test_decode_coefficients_identical_on_corpus(corpus):
    _same_coefficients(corpus.files)


def test_decode_coefficients_identical_on_dri_and_progressive_corpus():
    c = jcorpus.build_corpus(8, seed=11, restart_intervals=[1, 2, 3],
                             progressive=0.5)
    assert c.progressive_indices
    _same_coefficients(c.files)


def test_tables_are_identical():
    np.testing.assert_array_equal(T.idct64_matrix(), JT.idct64_matrix())
    np.testing.assert_array_equal(T.dct_matrix(), JT.dct_matrix())
    for name in ("STD_LUMA_Q", "STD_CHROMA_Q", "ZIGZAG"):
        if hasattr(JT, name):
            np.testing.assert_array_equal(getattr(T, name), getattr(JT, name))


@pytest.mark.parametrize("name", ["qwen2-7b", "qwen2-7b-smoke",
                                  "granite-3-8b", "granite-3-8b-smoke",
                                  "deepseek-coder-33b",
                                  "deepseek-coder-33b-smoke"])
def test_config_copy_matches_the_reference(name):
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    a, b = get_config(name), jget_config(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [(s.repeat, [dataclasses.asdict(x) for x in s.layers])
            for s in a.plan()] == \
        [(s.repeat, [dataclasses.asdict(x) for x in s.layers])
         for s in b.plan()]
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
    assert a.param_count() == b.param_count()
    assert a.padded_vocab_size == b.padded_vocab_size


def test_config_copy_knows_only_what_the_port_runs():
    from repro_torch.configs import get_config, list_configs
    assert list_configs() == ["deepseek-coder-33b", "granite-3-8b",
                              "qwen2-7b"]
    cfg = get_config("qwen2-7b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (28, 3584, 28, 4, 128, 18944, 152064)
    assert 7.5e9 < cfg.param_count() < 7.7e9
    with pytest.raises(KeyError):
        get_config("gemma3-4b")
