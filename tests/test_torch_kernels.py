"""The port's kernel wrappers and plain versions on CPU tensors, held
against the reference's Pallas kernels (interpret mode on the CPU) and
its jnp oracles, at the shapes, seeds and tolerances of
tests/test_kernels.py. On the CPU a port wrapper runs its plain
PyTorch version; the CUDA kernels themselves are checked on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.jpeg import tables as JT
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.jpeg import tables as T
from repro_torch.kernels import ops, ref

IMPLS = {"ops": (ops.idct8x8, ops.dequant_idct, ops.decode_batch),
         "ref": (ref.idct8x8, ref.dequant_idct, ref.decode_batch)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


@pytest.mark.parametrize("impl", ["ops", "ref"])
@pytest.mark.parametrize("n", [64, 512, 1024, 1500])
@pytest.mark.parametrize("scale", [1.0, 100.0])
def test_idct8x8_matches_reference(impl, n, scale):
    rng = np.random.RandomState(n)
    x = (rng.randn(n, 64) * scale).astype(np.float32)
    out = _np(IMPLS[impl][0](_t(x)))
    np.testing.assert_allclose(out, np.asarray(jops.idct8x8(x)),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(out, np.asarray(jref.idct8x8(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-3)


def test_idct8x8_matches_separable_numpy():
    rng = np.random.RandomState(0)
    blocks = rng.randn(37, 8, 8).astype(np.float32) * 50
    c = T.dct_matrix()
    want = np.einsum("ik,nkl,jl->nij", c.T, blocks.astype(np.float64), c.T)
    got = _np(ops.idct8x8(_t(blocks.reshape(-1, 64)))).reshape(-1, 8, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("impl", ["ops", "ref"])
@pytest.mark.parametrize("n", [64, 512, 777])
@pytest.mark.parametrize("qscale", [1, 16, 99])
def test_dequant_idct_matches_reference(impl, n, qscale):
    rng = np.random.RandomState(n + qscale)
    x = rng.randint(-200, 200, size=(n, 64)).astype(np.float32)
    q = np.clip(rng.randint(1, qscale + 1, size=64), 1, 255).astype(
        np.float32)
    out = _np(IMPLS[impl][1](_t(x), _t(q)))
    np.testing.assert_allclose(out, np.asarray(jops.dequant_idct(x, q)),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        out, np.asarray(jref.dequant_idct(jnp.asarray(x), jnp.asarray(q))),
        rtol=1e-5, atol=1e-3)
    assert out.min() >= 0.0 and out.max() <= 255.0


@pytest.mark.parametrize("impl", ["ops", "ref"])
@pytest.mark.parametrize("n", [64, 512, 777])
@pytest.mark.parametrize("ntab", [1, 3, 24])
def test_decode_batch_matches_reference(impl, n, ntab):
    rng = np.random.RandomState(n * 31 + ntab)
    x = rng.randint(-200, 200, size=(n, 64)).astype(np.float32)
    qt = np.clip(rng.randint(1, 99, size=(ntab, 64)), 1, 255).astype(
        np.float32)
    qi = rng.randint(0, ntab, size=n).astype(np.int32)
    out = _np(IMPLS[impl][2](_t(x), _t(qi), _t(qt)))
    np.testing.assert_allclose(out, np.asarray(jops.decode_batch(x, qi, qt)),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        out, np.asarray(jref.decode_batch(jnp.asarray(x), jnp.asarray(qi),
                                          jnp.asarray(qt))),
        rtol=1e-5, atol=1e-3)
    assert out.min() >= 0.0 and out.max() <= 255.0


def test_decode_batch_single_table_matches_dequant_idct():
    rng = np.random.RandomState(9)
    x = rng.randint(-200, 200, size=(640, 64)).astype(np.float32)
    q = rng.randint(1, 64, size=64).astype(np.float32)
    a = _np(ops.decode_batch(_t(x), torch.zeros(640, dtype=torch.int32),
                             _t(q[None])))
    b = _np(ops.dequant_idct(_t(x), _t(q)))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("hw", [(8, 128), (64, 64), (100, 130), (17, 23),
                                (375, 500)])
def test_ycbcr2rgb_matches_reference(hw):
    h, w = hw
    rng = np.random.RandomState(h * w)
    y, cb, cr = (rng.uniform(0, 255, (h, w)).astype(np.float32)
                 for _ in range(3))
    out = _np(ops.ycbcr2rgb(_t(y), _t(cb), _t(cr)))
    assert out.shape == (h, w, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(jops.ycbcr2rgb(y, cb, cr)),
                               rtol=1e-5, atol=1e-3)
    r, g, b = jref.ycbcr2rgb(jnp.asarray(y), jnp.asarray(cb),
                             jnp.asarray(cr))
    want = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], axis=-1)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-3)


def test_idct_roundtrip_with_fdct():
    rng = np.random.RandomState(3)
    blocks = rng.uniform(-128, 127, (16, 8, 8))
    c = T.dct_matrix()
    coefs = np.einsum("ki,nij,lj->nkl", c, blocks, c)
    got = _np(ops.idct8x8(_t(coefs.reshape(-1, 64).astype(np.float32))))
    np.testing.assert_allclose(got.reshape(-1, 8, 8), blocks, atol=5e-3)


def test_plain_idct_matrix_is_the_reference_matrix():
    np.testing.assert_array_equal(ref.IDCT64,
                                  JT.idct64_matrix().astype(np.float32))


def test_cpu_calls_launch_nothing():
    """The launch counter counts kernel launches only: plain-version
    calls on the CPU leave it at zero."""
    ops.reset_launches()
    x = torch.ones(70, 64)
    ops.idct8x8(x)
    ops.dequant_idct(x, torch.ones(64))
    ops.decode_batch(x, torch.zeros(70, dtype=torch.int32),
                     torch.ones(2, 64))
    ops.ycbcr2rgb(torch.ones(3, 5), torch.ones(3, 5), torch.ones(3, 5))
    ops.flash_attention(torch.ones(1, 5, 4, 16), torch.ones(1, 5, 2, 16),
                        torch.ones(1, 5, 2, 16))
    assert ops.LAUNCHES == {"decode_batch": 0, "dequant_idct": 0,
                            "idct8x8": 0, "ycbcr2rgb": 0,
                            "flash_attention": 0,
                            "flash_attention_wgmma": 0}


@pytest.mark.parametrize("dtype, head_dim, kernel", [
    (torch.bfloat16, 64, "flash_attention_wgmma"),
    (torch.bfloat16, 128, "flash_attention_wgmma"),
    (torch.bfloat16, 16, "flash_attention"),
    (torch.bfloat16, 32, "flash_attention"),
    (torch.float32, 16, "flash_attention"),
    (torch.float32, 32, "flash_attention"),
    (torch.float32, 64, "flash_attention"),
    (torch.float32, 128, "flash_attention"),
    (torch.float32, 48, "flash_attention"),
    (torch.bfloat16, 48, "flash_attention"),
    (torch.float32, 80, "flash_attention"),
])
def test_flash_kernel_for_routes_by_dtype_and_head_dim(dtype, head_dim,
                                                       kernel):
    """One rule: bf16 at a head dim the wgmma kernel is built for goes to
    it; float32 (exact FFMA products) and the other bf16 head dims go to
    the FFMA kernel. Each name is a kernel with its own launch count."""
    assert ops.flash_kernel_for(dtype, head_dim) == kernel
    assert kernel in ops.LAUNCHES


@pytest.mark.parametrize("dtype, head_dim, exc", [
    (torch.float16, 128, TypeError),
    (torch.float64, 64, TypeError),
    (torch.bfloat16, 24, ValueError),
    (torch.float32, 256, ValueError),
])
def test_flash_kernel_for_rejects_what_no_kernel_takes(dtype, head_dim, exc):
    with pytest.raises(exc):
        ops.flash_kernel_for(dtype, head_dim)


@pytest.mark.parametrize("model", ["small", "100m"])
def test_every_trainer_model_takes_the_flash_kernel(model):
    """Both of the trainer's ViTs have a head dim the float32 kernel is
    built for, so on the card their attention launches it (the `small`
    one, the trainer's default, has head dim 48)."""
    from repro_torch.train import vision_pipeline as vp
    cfg = vp.MODELS[model]
    assert cfg.head_dim in ops.FLASH_HEAD_DIMS
    assert ops.flash_kernel_for(torch.float32, cfg.head_dim) == \
        "flash_attention"


def test_every_kernel_has_a_launch_count_and_a_c_entry_point():
    """The wgmma kernel is built from its own source with its own entry
    point (no dtype argument: bf16 only), and counts its own launches."""
    from repro_torch.kernels import build
    assert set(ops.LAUNCHES) == set(build.SIGNATURES)
    for name in build.SIGNATURES:
        assert (build.CSRC / f"{name}.cu").is_file(), name
    src = (build.CSRC / "flash_attention_wgmma.cu").read_text()
    assert "repro_flash_attention_wgmma(" in src
    assert len(build.SIGNATURES["flash_attention_wgmma"]) == \
        len(build.SIGNATURES["flash_attention"]) - 1


@pytest.mark.parametrize("call, exc", [
    (lambda: ops.idct8x8(torch.ones(4, 64, dtype=torch.float64)), TypeError),
    (lambda: ops.idct8x8(torch.ones(4, 63)), ValueError),
    (lambda: ops.dequant_idct(torch.ones(4, 64), torch.ones(63)), ValueError),
    (lambda: ops.decode_batch(torch.ones(4, 64),
                              torch.zeros(4, dtype=torch.int64),
                              torch.ones(1, 64)), TypeError),
    (lambda: ops.decode_batch(torch.ones(4, 64),
                              torch.zeros(3, dtype=torch.int32),
                              torch.ones(1, 64)), ValueError),
    (lambda: ops.ycbcr2rgb(torch.ones(3, 5), torch.ones(3, 5),
                           torch.ones(3, 4)), ValueError),
    (lambda: ops.idct8x8(np.ones((4, 64), np.float32)), TypeError),
    (lambda: ops.flash_attention(torch.ones(1, 4, 2, 16, dtype=torch.float16),
                                 torch.ones(1, 4, 2, 16, dtype=torch.float16),
                                 torch.ones(1, 4, 2, 16, dtype=torch.float16)),
     TypeError),
    (lambda: ops.flash_attention(torch.ones(1, 4, 2, 16),
                                 torch.ones(1, 4, 2, 16, dtype=torch.bfloat16),
                                 torch.ones(1, 4, 2, 16)), TypeError),
    (lambda: ops.flash_attention(torch.ones(1, 4, 3, 16),
                                 torch.ones(1, 4, 2, 16),
                                 torch.ones(1, 4, 2, 16)), ValueError),
    (lambda: ops.flash_attention(torch.ones(1, 4, 2, 24),
                                 torch.ones(1, 4, 2, 24),
                                 torch.ones(1, 4, 2, 24)), ValueError),
    (lambda: ops.flash_attention(torch.ones(1, 4, 2, 16),
                                 torch.ones(1, 5, 2, 16),
                                 torch.ones(1, 5, 2, 16)), ValueError),
    (lambda: ops.flash_attention(torch.ones(4, 2, 16), torch.ones(4, 2, 16),
                                 torch.ones(4, 2, 16)), ValueError),
])
def test_wrappers_reject_bad_inputs(call, exc):
    with pytest.raises(exc):
        call()


def test_wrappers_have_no_plain_path_off_the_cpu():
    """A tensor that is not on the CPU reaches a kernel or raises; it
    never runs the plain version (meta tensors stand in for a device
    without a kernel)."""
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.idct8x8(x)
    with pytest.raises(ValueError, match="several devices"):
        ops.dequant_idct(torch.ones(4, 64), torch.empty(64, device="meta"))
    q = torch.empty(1, 8, 4, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])


def _flash_inputs(shape, dtype):
    """tests/test_kernels.py's flash inputs: KV = H / 2, seeded by S."""
    B, S, H, D = shape
    rng = np.random.RandomState(S)
    q = rng.randn(B, S, H, D).astype(dtype) * 0.5
    k = rng.randn(B, S, H // 2, D).astype(dtype) * 0.5
    v = rng.randn(B, S, H // 2, D).astype(dtype) * 0.5
    return q, k, v


@pytest.mark.parametrize("impl", ["ops", "ref"])
@pytest.mark.parametrize("shape", [(2, 64, 4, 16), (1, 128, 8, 32),
                                   (2, 96, 4, 16), (2, 64, 4, 48),
                                   (1, 64, 4, 80)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(impl, shape, dtype, causal):
    """Against the reference's wrapper, which runs the Pallas kernel in
    interpret mode on the CPU, at its own shapes and tolerances."""
    q, k, v = _flash_inputs(shape, dtype)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype)) for a in (jq, jk, jv))
    fn = ops.flash_attention if impl == "ops" else \
        lambda *a, causal: ref.flash_attention(*a, causal)
    got = fn(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("S", [1, 7, 100])
@pytest.mark.parametrize("rep", [1, 7])
def test_plain_flash_attention_matches_the_oracle_on_odd_shapes(S, rep):
    """Sequence lengths no tile divides and the GQA ratio of qwen2
    (7 query heads per KV head), against the reference's jnp oracle on
    the repeated KV heads."""
    B, KV, D = 2, 2, 32
    H = KV * rep
    rng = np.random.RandomState(S * 10 + rep)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, KV, D).astype(np.float32)
    v = rng.randn(B, S, KV, D).astype(np.float32)
    kk, vv = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    flat = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, S, D))
    want = np.asarray(jref.flash_attention(flat(q), flat(kk), flat(vv))
                      ).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    got = ops.flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", [-1, 2])
def test_out_of_range_table_index_raises_on_the_cpu(bad):
    """The CPU counterpart of tests/test_torch_gpu.py's NaN rows: an index
    outside [0, T) (T = 2 here), -1 included, raises and returns nothing."""
    qi = torch.zeros(100, dtype=torch.int32)
    qi[70] = bad
    with pytest.raises(IndexError):
        ops.decode_batch(torch.ones(100, 64), qi, torch.ones(2, 64))
