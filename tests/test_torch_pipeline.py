"""The port's transforms against the reference's on the same entropy-
decoded coefficients.

Each image of the ``corpus`` fixture is parsed and entropy-decoded by
the reference, carried into the port's types by
``import_reference_state``, and put through both transforms on the CPU.
Float outputs agree to 1e-3; uint8 outputs may differ by one level,
because a sum taken in another order can land on the other side of a
rounding tie (torch's and XLA's CPU matmuls need not sum alike).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.jpeg import huffman as jhuffman
from repro.jpeg import parser as JP
from repro.jpeg import pipeline as jpipe
from repro_torch.device import use_device
from repro_torch.jpeg import pipeline as pipe
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


@pytest.fixture(scope="module")
def decoded(corpus):
    """[(reference spec, reference coefs, port spec, port coefs)]."""
    out = []
    for f in corpus.files:
        spec = JP.parse(f)
        coef = jhuffman.decode_coefficients(spec)
        out.append((spec, coef) + pipe.import_reference_state(spec, coef))
    return out


def _max_diff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) -
                      np.asarray(b).astype(int)).max())


def test_import_reference_state_keeps_the_transform_inputs(decoded):
    for spec, coef, pspec, pcoef in decoded:
        assert (pspec.height, pspec.width) == (spec.height, spec.width)
        assert [(c.cid, c.h, c.v, c.tq) for c in pspec.components] == \
            [(c.cid, c.h, c.v, c.tq) for c in spec.components]
        assert pspec.adobe_transform == spec.adobe_transform
        assert (pspec.mcu_h, pspec.mcu_w) == (spec.mcu_h, spec.mcu_w)
        for k, q in spec.qtables.items():
            np.testing.assert_array_equal(pspec.qtables[k], q)
        for cid, grid in coef.items():
            np.testing.assert_array_equal(pcoef[cid], grid)
            assert pcoef[cid] is not grid


@pytest.mark.parametrize("fast_idct", [True, False])
def test_transform_np_is_the_reference_copy(decoded, fast_idct):
    for spec, coef, pspec, pcoef in decoded:
        np.testing.assert_array_equal(
            pipe.transform_np(pspec, pcoef, fast_idct=fast_idct),
            jpipe.transform_np(spec, coef, fast_idct=fast_idct))


@pytest.mark.parametrize("separable", [False, True])
def test_transform_torch_matches_transform_jnp(decoded, separable):
    for i, (spec, coef, pspec, pcoef) in enumerate(decoded):
        want = jpipe.transform_jnp(spec, coef, jit=True, separable=separable)
        got = pipe.transform_torch(pspec, pcoef, separable=separable)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert _max_diff(got, want) <= 1, i


def test_staged_transform_matches_unjitted_jnp(decoded):
    for i, (spec, coef, pspec, pcoef) in enumerate(decoded):
        want = jpipe.transform_jnp(spec, coef, jit=False)
        got = pipe.transform_torch(pspec, pcoef, staged=True)
        assert _max_diff(got, want) <= 1, i
        np.testing.assert_array_equal(got, pipe.transform_torch(pspec,
                                                                pcoef))


def _groups(decoded):
    groups = {}
    for i, (spec, *_rest) in enumerate(decoded):
        key = (len(spec.components),
               tuple((c.h, c.v) for c in spec.components))
        groups.setdefault(key, []).append(i)
    return list(groups.values())


@pytest.mark.parametrize("separable", [False, True])
def test_transform_batch_matches_reference_transform_batch(decoded,
                                                           separable):
    for idxs in _groups(decoded):
        specs = [decoded[i][0] for i in idxs]
        coefs = [decoded[i][1] for i in idxs]
        want = jpipe.transform_batch(specs, coefs, separable=separable)
        before = pipe.TRANSFORM_BATCH_CALLS
        got = pipe.transform_batch([decoded[i][2] for i in idxs],
                                   [decoded[i][3] for i in idxs],
                                   separable=separable)
        assert pipe.TRANSFORM_BATCH_CALLS == before + 1
        for i, g, w in zip(idxs, got, want):
            assert g.shape == w.shape and g.dtype == np.uint8
            assert _max_diff(g, w) <= 1, i


def test_transform_batch_equals_serial_transform(decoded):
    for idxs in _groups(decoded):
        got = pipe.transform_batch([decoded[i][2] for i in idxs],
                                   [decoded[i][3] for i in idxs])
        for i, g in zip(idxs, got):
            np.testing.assert_array_equal(
                g, pipe.transform_torch(decoded[i][2], decoded[i][3]))


def test_batch_layout_is_the_reference_copy(decoded):
    for idxs in _groups(decoded):
        want = jpipe.batch_layout([decoded[i][0] for i in idxs],
                                  [decoded[i][1] for i in idxs])
        got = pipe.batch_layout([decoded[i][2] for i in idxs],
                                [decoded[i][3] for i in idxs])
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------- the stages
def _blocks(seed, shape=(3, 5, 8, 8), scale=40.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def test_dequant_torch_matches_jnp():
    c = np.random.RandomState(1).randint(-50, 50, (3, 5, 8, 8)).astype(
        np.int32)
    q = np.random.RandomState(2).randint(1, 99, (8, 8)).astype(np.uint8)
    np.testing.assert_array_equal(
        pipe.dequant_torch(torch.from_numpy(c), torch.from_numpy(q)).numpy(),
        np.asarray(jpipe.dequant_jnp(jnp.asarray(c), jnp.asarray(q))))


@pytest.mark.parametrize("port, want", [
    (pipe.idct_blocks_torch, jpipe.idct_blocks_jnp),
    (pipe.idct_blocks_torch_separable, jpipe.idct_blocks_jnp_separable),
])
def test_idct_blocks_match_jnp(port, want):
    x = _blocks(3)
    np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(),
                               np.asarray(want(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-3)


def test_assemble_plane_torch_matches_jnp_and_batch():
    x = _blocks(4, (2, 3, 5, 8, 8))
    got = pipe.assemble_plane_torch(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jpipe.assemble_plane_batch_jnp(jnp.asarray(x))))
    np.testing.assert_array_equal(
        pipe.assemble_plane_torch(torch.from_numpy(x[1])).numpy(),
        np.asarray(jpipe.assemble_plane_jnp(jnp.asarray(x[1]))))


@pytest.mark.parametrize("fh, fv", [(1, 1), (2, 2), (2, 1), (1, 2)])
def test_upsample_torch_matches_jnp(fh, fv):
    p = _blocks(5, (2, 7, 9))
    np.testing.assert_array_equal(
        pipe.upsample_torch(torch.from_numpy(p[0]), fh, fv).numpy(),
        np.asarray(jpipe.upsample_jnp(jnp.asarray(p[0]), fh, fv)))
    np.testing.assert_array_equal(
        pipe.upsample_torch(torch.from_numpy(p), fh, fv).numpy(),
        np.asarray(jpipe.upsample_batch_jnp(jnp.asarray(p), fh, fv)))


def test_colour_conversions_match_jnp():
    rng = np.random.RandomState(6)
    y, cb, cr, k = (rng.uniform(-20, 280, (9, 11)).astype(np.float32)
                    for _ in range(4))
    tt = [torch.from_numpy(a) for a in (y, cb, cr, k)]
    jj = [jnp.asarray(a) for a in (y, cb, cr, k)]
    np.testing.assert_allclose(pipe.ycbcr_to_rgb_torch(*tt[:3]).numpy(),
                               np.asarray(jpipe.ycbcr_to_rgb_jnp(*jj[:3])),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(pipe.ycck_to_rgb_torch(*tt).numpy(),
                               np.asarray(jpipe.ycck_to_rgb_jnp(*jj)),
                               rtol=1e-6, atol=1e-4)


def test_finalize_torch_rounds_half_to_even_like_jnp():
    rgb = np.array([[[0.5, 1.5, 2.5], [-3.0, 254.5, 300.0]],
                    [[127.49, 127.5, 128.5], [-0.5, 253.5, 255.4]]],
                   np.float32)
    got = pipe.finalize_torch(torch.from_numpy(rgb), 2, 1).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jpipe.finalize_jnp(jnp.asarray(rgb), 2, 1)))
    np.testing.assert_array_equal(got, pipe.finalize_np(rgb, 2, 1))
    assert got.dtype == np.uint8


def test_assemble_image_with_the_colour_wrapper_matches_reference(decoded):
    """The cuda paths' host tail: planes through the port's
    assemble_image with the ycbcr2rgb wrapper (its plain version here)
    equal the reference's assemble_image with its numpy conversion."""
    def ycbcr(y, cb, cr):
        return ops.ycbcr2rgb(*(torch.from_numpy(np.ascontiguousarray(
            p, np.float32)) for p in (y, cb, cr))).numpy()

    for spec, coef, pspec, pcoef in decoded:
        planes = [jpipe.assemble_plane_np(jpipe.idct_blocks_np_fast(
            coef[c.cid] * spec.qtables[c.tq][None, None].astype(np.float32)))
            + 128.0 for c in spec.components]
        want = jpipe.assemble_image(spec, planes)
        got = pipe.assemble_image(pspec, [p.astype(np.float32)
                                          for p in planes], ycbcr_fn=ycbcr)
        assert _max_diff(got, want) <= 1
