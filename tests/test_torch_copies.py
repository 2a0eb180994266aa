"""The port keeps its own copies of the reference's numpy-only modules
(it may not import ``repro``). These tests hold each copy to its
original: same bytes, same fields, same coefficients, same tables."""
import dataclasses
import re

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
                                  "deepseek-coder-33b-smoke",
                                  "deepseek-moe-16b",
                                  "deepseek-moe-16b-smoke",
                                  "mamba2-370m", "mamba2-370m-smoke",
                                  "zamba2-2.7b", "zamba2-2.7b-smoke",
                                  "musicgen-medium",
                                  "musicgen-medium-smoke",
                                  "gemma3-4b", "gemma3-4b-smoke",
                                  "deepseek-v3-671b",
                                  "deepseek-v3-671b-smoke",
                                  "llama-3.2-vision-90b",
                                  "llama-3.2-vision-90b-smoke"])
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
    assert a.active_param_count() == b.active_param_count()
    assert a.padded_vocab_size == b.padded_vocab_size


def test_config_copy_knows_only_what_the_port_runs():
    """The port runs every architecture of the reference: the registries
    hold the same ten names, and an unknown name raises in both."""
    from repro.configs import get_config as jget_config
    from repro.configs import list_configs as jlist_configs
    from repro_torch.configs import get_config, list_configs
    assert list_configs() == jlist_configs() == [
        "deepseek-coder-33b", "deepseek-moe-16b", "deepseek-v3-671b",
        "gemma3-4b", "granite-3-8b", "llama-3.2-vision-90b", "mamba2-370m",
        "musicgen-medium", "qwen2-7b", "zamba2-2.7b"]
    cfg = get_config("qwen2-7b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (28, 3584, 28, 4, 128, 18944, 152064)
    assert 7.5e9 < cfg.param_count() < 7.7e9
    for get in (get_config, jget_config):
        with pytest.raises(KeyError):
            get("llama-3.2-vision-11b")


# ------------------------------------------ the dry-run's copies and rules
_SYNTHETIC_HLO = """
HloModule test

%body (p: (s32[], f32[4,8])) -> (s32[], f32[4,8]) {
  %p = (s32[], f32[4,8]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[4,8]{1,0} get-tuple-element(%p), index=1
  %w = f32[8,8]{1,0} constant({...})
  %dot = f32[4,8]{1,0} dot(%x, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %one = s32[] constant(1)
  %ni = s32[] add(%i, %one)
  ROOT %t = (s32[], f32[4,8]) tuple(%ni, %dot)
}

%cond (p2: (s32[], f32[4,8])) -> pred[] {
  %p2 = (s32[], f32[4,8]) parameter(0)
  %i2 = s32[] get-tuple-element(%p2), index=0
  %n = s32[] constant(10)
  ROOT %lt = pred[] compare(%i2, %n), direction=LT
}

ENTRY %main (a: f32[4,8]) -> f32[4,8] {
  %a = f32[4,8]{1,0} parameter(0)
  %z = s32[] constant(0)
  %tup = (s32[], f32[4,8]) tuple(%z, %a)
  %w2 = (s32[], f32[4,8]) while(%tup), condition=%cond, body=%body
  %ar = f32[4,8]{1,0} all-reduce(%a), replica_groups=[2,4]<=[8], to_apply=%body
  ROOT %out = f32[4,8]{1,0} get-tuple-element(%w2), index=1
}
"""


def _source(module) -> str:
    with open(module.__file__) as f:
        return f.read()


@pytest.mark.parametrize("name", ["hlo", "elastic"])
def test_numpy_only_copies_are_the_same_text(name):
    """``common/hlo.py`` (standard library only) and
    ``distributed/elastic.py`` (numpy only) import nothing of either
    package: their copies are the originals byte for byte."""
    from repro.common import hlo as jhlo
    from repro.distributed import elastic as jelastic
    from repro_torch.common import hlo
    from repro_torch.distributed import elastic
    mods = {"hlo": (hlo, jhlo), "elastic": (elastic, jelastic)}
    ours, theirs = mods[name]
    assert _source(ours) == _source(theirs)


#: inputs no decoder can read: empty, not an image, a JPEG cut short
CORRUPT = [b"", b"not a jpeg at all", b"\xff\xd8\xff\xdb\x00\x43" + bytes(8)]


def _code_lines(module) -> list:
    """The module's lines after its docstring, its import lines left out."""
    body = _source(module).split('"""', 2)[2]
    return [ln for ln in body.splitlines()
            if not ln.startswith(("from repro", "import repro"))]


def test_contrib_copy_is_the_references_code():
    """``codecs/contrib.py`` is the reference's module with its imports
    rewritten to the port's: the same code and the same names."""
    from repro.codecs import contrib as jcontrib
    from repro_torch.codecs import contrib
    assert _code_lines(contrib) == _code_lines(jcontrib)
    assert sorted(n for n in vars(contrib) if not n.startswith("__")) == \
        sorted(n for n in vars(jcontrib) if not n.startswith("__"))
    assert contrib.available() == jcontrib.available()


@pytest.mark.parametrize("name", ["pillow", "opencv"])
def test_contrib_copy_behaves_as_the_reference(name, corpus):
    """Caps, description, the exception raised on each corrupt input
    (type and message) and the output on every corpus image."""
    from repro.codecs import get_decoder as jget_decoder
    from repro_torch.codecs import contrib, get_decoder
    if name not in contrib.available():
        pytest.skip(f"{name} not importable in this environment")
    mine, theirs = get_decoder(name), jget_decoder(name)
    assert dataclasses.asdict(mine.caps) == dataclasses.asdict(theirs.caps)
    assert (mine.description, mine.batch_fn, theirs.batch_fn) == \
        (theirs.description, None, None)
    for bad in CORRUPT:
        with pytest.raises((P.CorruptJpeg, P.UnsupportedJpeg)) as got:
            mine.fn(bad)
        with pytest.raises((JP.CorruptJpeg, JP.UnsupportedJpeg)) as want:
            theirs.fn(bad)
        assert type(got.value).__name__ == type(want.value).__name__
        # Pillow's message names the BytesIO object by its address
        assert re.sub("0x[0-9a-f]+", "0x", str(got.value)) == \
            re.sub("0x[0-9a-f]+", "0x", str(want.value))
    for f in corpus.files:
        assert mine.fn(f).tobytes() == theirs.fn(f).tobytes()


@pytest.mark.parametrize("fused", [(), ("vmem_flash",)])
@pytest.mark.parametrize("n_dev", [1, 8])
def test_hlo_analyze_equals_the_references_on_the_synthetic_module(
        n_dev, fused):
    from repro.common import hlo as jhlo
    from repro_torch.common import hlo
    assert hlo.analyze(_SYNTHETIC_HLO, n_dev, fused) == \
        jhlo.analyze(_SYNTHETIC_HLO, n_dev, fused)
    assert hlo.collective_summary(_SYNTHETIC_HLO, n_dev) == \
        jhlo.collective_summary(_SYNTHETIC_HLO, n_dev)


@pytest.fixture(scope="module")
def decode_cell_hlo():
    """The HLO text of the reference's compiled ``qwen2-7b-smoke`` x
    ``decode_32k`` cell on a 1 x 1 mesh with Auto axes (the reference's
    own dry-run fails on this jax's default Explicit axes, ROADMAP §3)."""
    import jax
    from jax.sharding import AxisType
    from repro.launch import dryrun_lib as jdry
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fn, args = jdry.build_cell("qwen2-7b-smoke", "decode_32k", mesh)
    return fn.lower(*args).compile().as_text()


@pytest.mark.parametrize("fused", [(), ("vmem_flash",)])
def test_hlo_analyze_equals_the_references_on_a_compiled_cell(
        decode_cell_hlo, fused):
    from repro.common import hlo as jhlo
    from repro_torch.common import hlo
    got = hlo.analyze(decode_cell_hlo, 1, fused)
    assert got == jhlo.analyze(decode_cell_hlo, 1, fused)
    assert got["flops_per_chip"] > 0 and got["max_loop_trip"] == 4


_ELASTIC_CASES = [
    (((2, 16, 16), ("pod", "data", "model")), dict(lost_pods=1)),
    (((16, 16), ("data", "model")), dict(lost_data_rows=3)),
    (((2, 4, 4), ("pod", "data", "model")), dict(lost_pods=2)),
    (((2, 16, 16), ("pod", "data", "model")),
     dict(lost_pods=1, keep_global_batch=False)),
    (((2, 8, 4), ("pod", "data", "model")),
     dict(lost_pods=1, lost_data_rows=5)),
    (((4, 4), ("data", "model")), dict(lost_data_rows=4)),
]


@pytest.mark.parametrize("mesh, kw", _ELASTIC_CASES)
def test_elastic_plan_equals_the_references(mesh, kw):
    """``tests/test_elastic.py``'s policy cases, and their neighbours,
    through both copies: the same decision or the same error."""
    from repro.distributed import elastic as jelastic
    from repro_torch.distributed import elastic

    def plan(mod):
        cur = mod.MeshSpec(*mesh)
        try:
            d = mod.plan_after_failure(cur, **kw)
        except ValueError as e:
            return ("ValueError", str(e))
        return (d.mesh.shape, d.mesh.axes, d.mesh.num_devices,
                d.microbatch_scale, d.loader_shard_count, d.note,
                cur.num_devices, cur.axis("model"))
    assert plan(elastic) == plan(jelastic)


def _abstract_mesh(shape, axes):
    import jax
    return jax.sharding.AbstractMesh(shape, axes)


_MESHES = [((16, 16), ("data", "model")),
           ((2, 16, 16), ("pod", "data", "model"))]


@pytest.mark.parametrize("mesh", _MESHES, ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-3-8b",
                                  "deepseek-coder-33b"])
def test_sharding_specs_equal_the_references(arch, mesh):
    """Each of the port's per-layer leaves gets the reference's spec for
    its stacked ``[L, ...]`` leaf without the leading layer axis; the
    top-level leaves, the batches and the caches get the same specs.
    Full-size shapes from ``jax.eval_shape`` and the port's ``meta``
    tensors, on an ``AbstractMesh`` (no devices)."""
    from functools import partial

    import jax
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.distributed import sharding as jsharding
    from repro.launch import specs as jspecs
    from repro.models import model as jmodel
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import specs
    from repro_torch.models import model
    from repro_torch.models.layers import ShapesOnly
    amesh = _abstract_mesh(*mesh)
    sizes = dict(zip(mesh[1], mesh[0]))
    jcfg, cfg = jget_config(arch), get_config(arch)

    jshapes = jax.eval_shape(partial(jmodel.init, cfg=jcfg),
                             jax.random.PRNGKey(0))
    jspec = jsharding.param_specs(jshapes, amesh)
    spec = sharding.param_specs(model.init(ShapesOnly(), cfg), sizes)
    for name in ("embed", "unembed", "final_ln"):
        assert spec[name] == tuple(jspec[name])
    stacked = jspec["stage0"]["layer0"]
    assert len(spec["layers"]) == cfg.num_layers
    for layer in spec["layers"]:
        assert set(layer) == set(stacked)
        for part in layer:
            assert set(layer[part]) == set(stacked[part])
            for leaf, s in layer[part].items():
                assert s == tuple(stacked[part][leaf])[1:], (part, leaf)

    for shape in ("decode_32k", "long_500k"):
        jin = jspecs.decode_inputs(jcfg, JSHAPES[shape])
        pin = specs.decode_inputs(cfg, SHAPES[shape])
        jc = jsharding.cache_specs(jin["caches"], amesh)["stage0"]["layer0"]
        pc = sharding.cache_specs(pin["caches"], sizes)
        for k_spec, v_spec in pc:
            assert (k_spec, v_spec) == (tuple(jc[0])[1:], tuple(jc[1])[1:])
        jb = jsharding.batch_specs(amesh, {"t": jin["token"],
                                           "p": jin["pos"]})
        pb = sharding.batch_specs(sizes, {"t": pin["token"],
                                          "p": pin["pos"]})
        assert pb == {k: tuple(v) for k, v in jb.items()}
    for shape in ("train_4k", "prefill_32k"):
        jb = jsharding.batch_specs(
            amesh, jspecs.train_batch_specs(jcfg, JSHAPES[shape]))
        pb = sharding.batch_specs(
            sizes, specs.train_batch_specs(cfg, SHAPES[shape]))
        assert pb == {k: tuple(v) for k, v in jb.items()}
    assert sharding.batch_axes(sizes) == jsharding.batch_axes(amesh)
