"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``; without a card every test skips (the ``cuda`` fixture
decides, at run time). On the machine with the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances are those of tests/test_kernels.py (``rtol=1e-5, atol=1e-3``;
``1e-6/1e-4`` for the single-table identity). Where the kernels promise
bit-identity (a row's result does not depend on N or on its position),
the checks are exact.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

RTOL, ATOL = 1e-5, 1e-3
#: rows of one decode_batch.cu ring tile, a consumer warp's unit of work
#: (kTileRows = 4 x kRowsPerLane there)
TILE = 4 * int(re.search(
    r"constexpr int kRowsPerLane = (\d+);",
    (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
     "kernels" / "csrc" / "decode_batch.cu").read_text()).group(1))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False); run with -m gpu on the machine with the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    build.load_all()
    return torch.device("cuda", 0)


def _rows(n, seed, ntab=1):
    """Quantized coefficient rows as a JPEG holds them: the forward DCT
    of random 8-bit blocks, divided by the row's table and rounded.

    (The raw-integer rows of tests/test_kernels.py dequantize to values
    far larger than an 8-bit image can give. With them, a 64-term float32
    sum in another order than cuBLAS's can land outside ``atol=1e-3``
    after cancellation, which says nothing about the kernel.)"""
    from repro_torch.jpeg import tables as T
    rng = np.random.RandomState(seed)
    c = T.dct_matrix()
    blocks = rng.uniform(-128, 127, (n, 8, 8))
    coef = np.einsum("ki,nij,lj->nkl", c, blocks, c).reshape(n, 64)
    qt = rng.randint(1, 99, size=(ntab, 64)).astype(np.float32)
    qi = rng.randint(0, ntab, size=n).astype(np.int32)
    x = np.round(coef / qt[qi]).astype(np.float32)
    return x, qi, qt


def _on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.parametrize("n", [1, 63, 64, 65, 777, 20011])
@pytest.mark.parametrize("scale", [1.0, 100.0])
def test_idct8x8_matches_plain(cuda, n, scale):
    from repro_torch.kernels import ops, ref
    x = torch.from_numpy((np.random.RandomState(n).randn(n, 64) * scale)
                         .astype(np.float32)).to(cuda)
    before = ops.LAUNCHES["idct8x8"]
    got = ops.idct8x8(x)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["idct8x8"] == before + 1
    torch.testing.assert_close(got, ref.idct8x8(x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 65, 777, 20011,
                               200_000])
@pytest.mark.parametrize("ntab", [1, 3, 100, 768])
def test_decode_batch_matches_plain(cuda, n, ntab):
    """One row, the ring tile's edges, and more rows than one pass of the
    persistent grid (132 SMs x 16 warps x 16 rows on an H100)."""
    from repro_torch.kernels import ops, ref
    x, qi, qt = _on(cuda, *_rows(n, n * 31 + ntab, ntab))
    before = ops.LAUNCHES["decode_batch"]
    got = ops.decode_batch(x, qi, qt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_batch"] == before + 1
    torch.testing.assert_close(got, ref.decode_batch(x, qi, qt),
                               rtol=RTOL, atol=ATOL)
    assert got.min().item() >= 0.0 and got.max().item() <= 255.0


@pytest.mark.parametrize("n", [1, 64, 777, 20011])
def test_dequant_idct_matches_plain(cuda, n):
    from repro_torch.kernels import ops, ref
    x, _, qt = _on(cuda, *_rows(n, n + 99))
    q = qt[0].contiguous()
    before = ops.LAUNCHES["dequant_idct"]
    got = ops.dequant_idct(x, q)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dequant_idct"] == before + 1
    torch.testing.assert_close(got, ref.dequant_idct(x, q),
                               rtol=RTOL, atol=ATOL)


def test_decode_batch_single_table_matches_dequant_idct(cuda):
    from repro_torch.kernels import ops
    x, _, qt = _on(cuda, *_rows(640, 9))
    a = ops.decode_batch(x, torch.zeros(640, dtype=torch.int32, device=cuda),
                         qt)
    b = ops.dequant_idct(x, qt[0].contiguous())
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-4)
    assert torch.equal(a, b)        # one device function, one sum order


def test_a_rows_result_does_not_depend_on_n_or_position(cuda):
    """Batched equals serial bit for bit: the kernel's sum order is fixed
    per output element, whatever the launch's row count or offset."""
    from repro_torch.kernels import ops
    x, qi, qt = _on(cuda, *_rows(5000, 17, ntab=6))
    full = ops.decode_batch(x, qi, qt)
    for lo, hi in [(0, 1), (1, 70), (63, 64), (1234, 4321), (4999, 5000)]:
        part = ops.decode_batch(x[lo:hi].contiguous(),
                                qi[lo:hi].contiguous(), qt)
        assert torch.equal(part, full[lo:hi]), (lo, hi)


@pytest.mark.parametrize("ntab", [3, 100, 768])
def test_decode_batch_equals_dequant_idct_table_by_table(cuda, ntab):
    """The two designs share one arithmetic: the rows of table t through
    dequant_idct(x_t, qt[t]) equal decode_batch's rows bit for bit."""
    from repro_torch.kernels import ops
    x, qi, qt = _on(cuda, *_rows(30_000, ntab, ntab))
    got = ops.decode_batch(x, qi, qt)
    for t in range(ntab):
        rows = qi == t
        want = ops.dequant_idct(x[rows].contiguous(), qt[t].contiguous())
        assert torch.equal(got[rows], want), t


def test_decode_batch_takes_rows_16_but_not_256_byte_aligned(cuda):
    """x one float4 into a buffer: 16-byte aligned, not 256; the bulk
    copies take it, and the result is the aligned copy's bit for bit."""
    from repro_torch.kernels import ops, ref
    n = 5 * TILE + 3
    x, qi, qt = _on(cuda, *_rows(n, 23, ntab=4))
    flat = torch.empty(n * 64 + 4, device=cuda)
    shifted = flat[4:].view(n, 64)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 == 0 and shifted.data_ptr() % 256
    got = ops.decode_batch(shifted, qi, qt)
    assert torch.equal(got, ops.decode_batch(x, qi, qt))
    torch.testing.assert_close(got, ref.decode_batch(x, qi, qt),
                               rtol=RTOL, atol=ATOL)


def test_out_of_range_table_index_gives_nan_rows(cuda):
    from repro_torch.kernels import ops
    x, qi, qt = _on(cuda, *_rows(100, 3, ntab=2))
    qi[5], qi[70] = 2, -1
    out = ops.decode_batch(x, qi, qt)
    bad = torch.isnan(out).all(dim=1)
    assert bad[5] and bad[70] and int(bad.sum()) == 2


@pytest.mark.parametrize("hw", [(1, 1), (17, 23), (375, 500), (500, 333)])
def test_ycbcr2rgb_matches_plain(cuda, hw):
    from repro_torch.kernels import ops, ref
    h, w = hw
    rng = np.random.RandomState(h * w)
    y, cb, cr = _on(cuda, *(rng.uniform(-20, 275, (h, w)).astype(np.float32)
                            for _ in range(3)))
    before = ops.LAUNCHES["ycbcr2rgb"]
    got = ops.ycbcr2rgb(y, cb, cr)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ycbcr2rgb"] == before + 1
    assert got.shape == (h, w, 3)
    torch.testing.assert_close(got, torch.stack(ref.ycbcr2rgb(y, cb, cr),
                                                dim=-1),
                               rtol=RTOL, atol=ATOL)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels import ops
    x = torch.zeros(8, 128, device=cuda)[:, ::2]          # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        ops.idct8x8(x)
    with pytest.raises(ValueError, match="several devices"):
        ops.dequant_idct(torch.zeros(4, 64, device=cuda), torch.zeros(64))


def test_cuda_batch_on_the_card_matches_its_plain_run(cuda, corpus):
    from repro_torch.codecs import get_decoder
    from repro_torch.device import use_device
    from repro_torch.kernels import ops
    from repro_torch.jpeg import parser as P
    path = get_decoder("cuda-batch")
    files = list(corpus.files)
    ops.reset_launches()
    got = path.decode_batch(files)
    specs = [P.parse(f, headers_only=True) for f in files]
    groups = {(len(s.components), tuple((c.h, c.v) for c in s.components))
              for s in specs}
    assert ops.LAUNCHES["decode_batch"] == len(groups)
    assert ops.LAUNCHES["ycbcr2rgb"] == sum(len(s.components) == 3
                                            for s in specs)
    with use_device("cpu"):
        plain = path.decode_batch(files)
    for i, (g, p, f) in enumerate(zip(got, plain, files)):
        assert int(np.abs(g.astype(int) - p.astype(int)).max()) <= 1, i
        np.testing.assert_array_equal(g, path.decode(f), err_msg=str(i))



def test_service_over_cuda_batch_on_the_card(cuda, corpus):
    """Two workers serve every file to two clients through ``cuda-batch``:
    images byte-identical to the serial decode, one ``ycbcr2rgb`` launch
    per colour request and one ``decode_batch`` launch per
    ``jpeg.dequant_idct`` span (a structure group of a micro-batch)."""
    import threading
    from repro_torch.codecs import get_decoder
    from repro_torch.jpeg import parser as P
    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    from repro_torch.service import DecodeService, ServiceConfig
    files = list(corpus.files)
    want = get_decoder("cuda-batch").decode_batch(files)
    svc = DecodeService(ServiceConfig(num_workers=2, max_batch=4,
                                      max_wait_ms=5.0, cache_bytes=0,
                                      seed=0), paths=["cuda-batch"])
    assert svc.device == cuda
    results = {}
    tracer = trace.Tracer()
    torch.cuda.synchronize()
    ops.reset_launches()
    with trace.use_tracer(tracer), svc:
        def client(cid):
            futs = [svc.submit(f, client=cid) for f in files]
            results[cid] = [f.result(timeout=120) for f in futs]
        threads = [threading.Thread(target=client, args=(c,))
                   for c in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    launches = dict(ops.LAUNCHES)
    for cid, imgs in results.items():
        for i, (g, w) in enumerate(zip(imgs, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"{cid}[{i}]")
    snap = svc.metrics.snapshot()
    assert snap["completed"] == 2 * len(files)
    assert snap["failed"] == 0 and snap["shed"] == 0
    n_color = sum(len(P.parse(f, headers_only=True).components) == 3
                  for f in files)
    names = [e["name"] for e in tracer.events() if e.get("ph") == "X"]
    assert launches["ycbcr2rgb"] == 2 * n_color
    assert launches["decode_batch"] == names.count("jpeg.dequant_idct")
    assert launches["decode_batch"] >= names.count("service.batch_decode")
    assert sum(launches.values()) == launches["ycbcr2rgb"] + \
        launches["decode_batch"]


def test_service_submit_source_zero_copy_on_the_card(cuda, corpus,
                                                     tmp_path):
    """A shard record reaches the ``cuda-batch`` service as a
    ``memoryview`` into the shard's mmap and decodes as its bytes do."""
    from repro_torch.codecs import get_decoder
    from repro_torch.jpeg.corpus import load_corpus_shards, \
        write_corpus_shards
    from repro_torch.service import DecodeService, ServiceConfig
    write_corpus_shards(corpus, str(tmp_path), shard_size=5)
    src = load_corpus_shards(str(tmp_path))
    assert isinstance(src[0], memoryview)
    with DecodeService(ServiceConfig(num_workers=0, cache_bytes=0),
                       paths=["cuda-batch"]) as svc:
        imgs = [svc.submit_source(src, i).result() for i in range(len(src))]
    want = get_decoder("cuda-batch").decode_batch(list(corpus.files))
    for i, (g, w) in enumerate(zip(imgs, want)):
        np.testing.assert_array_equal(g, w, err_msg=str(i))
    src.close()


def test_chunked_cuda_batch_loader_on_the_card(cuda, corpus):
    """Two loader threads decode chunks of 4 through ``cuda-batch``: the
    batches equal the serial decode, one ``decode_batch`` launch per
    ``jpeg.dequant_idct`` span and one ``ycbcr2rgb`` per colour image."""
    from repro_torch.codecs import get_decoder
    from repro_torch.data.loader import DataLoader, LoaderConfig, center_fit
    from repro_torch.jpeg import parser as P
    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    files = list(corpus.files)
    serial = get_decoder("cuda-batch").decode_batch(files)
    dl = DataLoader(files, corpus.labels, cfg=LoaderConfig(
        batch_size=5, num_workers=2, decode_batch=4, target_hw=(48, 48)),
        path_name="cuda-batch")
    assert dl.device == cuda
    tracer = trace.Tracer()
    torch.cuda.synchronize()
    ops.reset_launches()
    with trace.use_tracer(tracer):
        batches = list(dl)
    launches = dict(ops.LAUNCHES)
    got = np.concatenate([b["image"] for b in batches])
    want = np.stack([center_fit(img, 48, 48) for img in serial])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.concatenate([b["label"] for b in batches]), corpus.labels)
    assert dl.ledger.indices() == []
    names = [e["name"] for e in tracer.events() if e.get("ph") == "X"]
    assert launches["decode_batch"] == names.count("jpeg.dequant_idct") >= \
        -(-len(files) // 4)
    assert launches["ycbcr2rgb"] == sum(
        len(P.parse(f, headers_only=True).components) == 3 for f in files)


def test_prefetch_to_device_on_the_card(cuda):
    """Items arrive as ``cuda:0`` tensors equal to their host arrays,
    read at once (the consumer's stream waits for the side stream's
    copy, which a 256 MiB item keeps in flight) and after a matmul loop
    on the default stream (the allocator does not hand the memory to
    the next copy while that work is queued)."""
    from repro_torch.data.loader import prefetch_to_device
    items = [{"image": np.resize(np.arange(251, dtype=np.uint8), 256 << 20)
              + np.uint8(k), "label": np.arange(4, dtype=np.int32) + k}
             for k in range(3)]
    a = torch.randn(2048, 2048, device=cuda)
    now, later = [], []
    for item in prefetch_to_device(iter(items), size=2):
        assert {t.device for t in item.values()} == {cuda}
        now.append({k: t.clone() for k, t in item.items()})
        for _ in range(20):
            a = a @ a
            a = a / a.norm()
        later.append({k: t.clone() for k, t in item.items()})
    torch.cuda.synchronize()
    assert len(now) == len(later) == len(items)
    for n, l, w in zip(now, later, items):
        for key in w:
            np.testing.assert_array_equal(n[key].cpu().numpy(), w[key])
            np.testing.assert_array_equal(l[key].cpu().numpy(), w[key])

FLASH_SHAPES = [       # (B, S, H, KV, D)
    (1, 1, 4, 2, 16),
    (2, 7, 4, 2, 32),
    (2, 64, 4, 2, 16),
    (1, 100, 28, 4, 128),       # ragged tile, qwen2's GQA rep 7
    (1, 128, 8, 4, 32),
    (2, 257, 8, 8, 64),
    (1, 2048, 28, 4, 128),      # the prefill's shape at B=1
    (1, 1, 4, 2, 64),
    (1, 1, 14, 2, 128),
    (2, 64, 4, 4, 48),          # the `small` ViT's head dim
    (1, 100, 8, 2, 80),         # zamba2's head dim, ragged tile
    (16, 64, 12, 12, 64),       # the ViT-100m attention shape
] + [   # around the wgmma kernel's 128-row tiles, KV rep 1 and 7
    (2, S, 2 * rep, 2, D) for S in (127, 128, 129, 255) for D in (64, 128)
    for rep in (1, 7)
]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain(cuda, shape, dtype, causal):
    """tests/test_kernels.py's tolerances: 2e-2 in bf16, 2e-5 in f32. q and
    k at std 2 give scores of std 4, so each softmax row is peaked and the
    output is of the order of v (std 1), well above the tolerance."""
    from repro_torch.kernels import ops, ref
    B, S, H, KV, D = shape
    g = torch.Generator(device=cuda).manual_seed(S * 31 + D)
    q, k, v = (std * torch.randn(B, S, n, D, generator=g, device=cuda)
               .to(dtype) for n, std in ((H, 2.0), (KV, 2.0), (KV, 1.0)))
    kernel = ops.flash_kernel_for(dtype, D)
    assert kernel == ("flash_attention_wgmma" if dtype == torch.bfloat16
                      and D in (64, 128) else "flash_attention")
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {**before, kernel: before[kernel] + 1}
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    want = ref.flash_attention(q, k, v, causal)
    assert want.float().abs().median().item() > 10 * tol
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_flash_attention_on_the_card_never_runs_the_plain_version(
        cuda, monkeypatch):
    from repro_torch.kernels import ops, ref

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(ref, "flash_attention", refuse)
    q = torch.randn(1, 33, 4, 32, device=cuda)
    k = torch.randn(1, 33, 2, 32, device=cuda)
    out = ops.flash_attention(q, k, k.clone())
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    wide = torch.randn(1, 33, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(wide[:, :, ::2], k, k)     # q not contiguous


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layers_attention_takes_the_kernel_for_prefill(cuda, dtype):
    """The model's causal prefill attention launches the kernel and agrees
    with the plain chunked loop on the card; decode (Sq == 1) does not
    launch it."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 96, n, 64, generator=g, device=cuda).to(dtype)
               for n in (8, 2, 2))
    kernel = ops.flash_kernel_for(dtype, 64)
    ops.reset_launches()
    got = L.attention(q, k, v, q_chunk=32, k_chunk=32)
    assert ops.LAUNCHES[kernel] == 1
    assert sum(ops.LAUNCHES.values()) == 1
    want = L.attention(q, k, v, q_chunk=32, k_chunk=32, use_kernel=False)
    L.attention(q[:, :1], k, v, causal=False, kv_len=50)
    L.attention(q, k, v, window=8, q_chunk=32, k_chunk=32)
    assert ops.LAUNCHES[kernel] == 1
    assert sum(ops.LAUNCHES.values()) == 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_bf16_prefill_attention_launches_the_wgmma_kernel_only(cuda):
    """qwen2's head dim and GQA ratio in bf16: the model's causal prefill
    attention launches the wgmma kernel once and the FFMA kernel never,
    and agrees with the plain chunked loop within the bf16 tolerance."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (std * torch.randn(2, 300, n, 128, generator=g, device=cuda)
               .to(torch.bfloat16) for n, std in ((14, 2.0), (2, 2.0),
                                                  (2, 1.0)))
    ops.reset_launches()
    got = L.attention(q, k, v, q_chunk=128, k_chunk=128)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_wgmma"] == 1
    assert ops.LAUNCHES["flash_attention"] == 0
    want = L.attention(q, k, v, q_chunk=128, k_chunk=128, use_kernel=False)
    assert ops.LAUNCHES["flash_attention_wgmma"] == 1
    assert want.float().abs().median().item() > 0.2
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradient_on_the_card(cuda, dtype, causal):
    """With inputs that require grad the wrapper launches its one kernel
    and returns a result with a ``grad_fn``; dq, dk and dv agree with
    autograd through the plain version on the card (2e-5 in float32, 2e-2
    in bf16, the forward's tolerances)."""
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (std * torch.randn(2, 64, n, 64, generator=g, device=cuda)
               for n, std in ((12, 2.0), (4, 2.0), (4, 1.0)))
    q, k, v = (t.to(dtype).requires_grad_() for t in (q, k, v))
    dout = torch.randn(2, 64, 12, 64, generator=g, device=cuda).to(dtype)
    kernel = ops.flash_kernel_for(dtype, 64)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == 1 and sum(ops.LAUNCHES.values()) == 1
    want = torch.autograd.grad(ref.flash_attention(q, k, v, causal),
                               (q, k, v), dout)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for name, a, b in zip("qkv", got, want):
        assert b.float().abs().max().item() > 10 * tol, name
        torch.testing.assert_close(a, b, rtol=tol, atol=tol,
                                   msg=lambda m: f"d{name}: {m}")


def test_attention_gradient_reaches_wq_on_the_card(cuda):
    """The fault the gradient repairs: a backward through
    ``layers.attention`` on the card must reach ``wq``, ``wk`` and
    ``wv``, and give what the plain loop gives (within 1e-4 of each
    gradient's largest element)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda).manual_seed(3)
    d, H, D, S = 256, 4, 64, 64
    x = torch.randn(2, S, d, generator=g, device=cuda)
    w = {n: (torch.randn(d, H * D, generator=g, device=cuda) / d ** 0.5)
         for n in ("wq", "wk", "wv")}
    grads = {}
    for use_kernel in (True, False):
        p = {n: t.clone().requires_grad_() for n, t in w.items()}
        q, k, v = ((x @ p[n]).reshape(2, S, H, D) for n in ("wq", "wk",
                                                           "wv"))
        ops.reset_launches()
        out = L.attention(q, k, v, causal=False, q_chunk=32, k_chunk=32,
                          use_kernel=use_kernel)
        assert ops.LAUNCHES["flash_attention"] == int(use_kernel)
        (out * torch.linspace(-1, 1, D, device=cuda)).sum().backward()
        grads[use_kernel] = {n: t.grad for n, t in p.items()}
    for n in ("wq", "wk", "wv"):
        got, want = grads[True][n], grads[False][n]
        assert got is not None, f"{n} has no gradient"
        scale = want.abs().max().item()
        assert scale > 0 and got.abs().max().item() > 0, n
        assert (got - want).abs().max().item() <= 1e-4 * scale, n


@pytest.mark.parametrize("model", ["head-dim-64", "small"])
def test_vit_train_step_kernel_route_matches_the_plain_route(cuda, model):
    """One ViT step in float32, at head dim 64 and with the trainer's
    default ``small`` model (head dim 48): the kernel route launches the
    FFMA flash kernel once per layer and nothing else, and agrees with
    the plain loop (loss within 1e-5 relative, every gradient leaf within
    1e-4 of its largest element)."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.models import vision
    from repro_torch.train import vision_pipeline as vp
    cfg = vp.MODELS["small"] if model == "small" else vision.ViTConfig(
        d_model=256, num_heads=4, num_kv_heads=4, head_dim=64, d_ff=512,
        num_layers=3, num_classes=10)
    state = vp.init_state(cfg, 0, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"image": torch.randint(0, 256, (8, 64, 64, 3), generator=g,
                                    device=cuda, dtype=torch.uint8),
             "label": torch.randint(0, 10, (8,), generator=g, device=cuda,
                                    dtype=torch.int32)}
    out = {}
    for route, ctx in (("kernel", vp.CTX),
                       ("plain", dataclasses.replace(vp.CTX,
                                                     flash_kernel=False))):
        ops.reset_launches()
        metrics, grads = vp.loss_and_grads(state["params"], batch, cfg, ctx)
        torch.cuda.synchronize()
        out[route] = (metrics["loss"].item(), grads, dict(ops.LAUNCHES))
    assert out["kernel"][2]["flash_attention"] == cfg.num_layers
    assert sum(out["kernel"][2].values()) == cfg.num_layers
    assert sum(out["plain"][2].values()) == 0
    assert abs(out["kernel"][0] - out["plain"][0]) <= \
        1e-5 * abs(out["plain"][0])
    want = tree.flatten_with_names(out["plain"][1])
    for name, got in tree.flatten_with_names(out["kernel"][1]).items():
        scale = want[name].abs().max().item()
        assert scale > 0, name
        assert (got - want[name]).abs().max().item() <= 1e-4 * scale, name
    new, metrics = vp.train_step(state, batch, cfg, vp.OPT, vp.CTX)
    assert int(new["step"]) == 1 and torch.isfinite(metrics["loss"])


# ------------------------------------------------ the kernel view (tables)
@pytest.mark.parametrize("quick", [True, False])
def test_kernel_view_launches_every_jpeg_kernel_on_the_card(cuda, quick):
    """``python -m repro_torch.bench tables``'s kernel view on the card:
    every kernel row on the CUDA route, each kernel launched, errors
    within atol and the batched launch equal to the serial loop."""
    from repro_torch.bench.views import kernels_bench
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launches()
    rows = kernels_bench.run(quick=quick)
    torch.cuda.synchronize()
    for name in ("decode_batch", "dequant_idct", "idct8x8", "ycbcr2rgb"):
        assert ops.LAUNCHES[name] >= 1, name
    routed = [r for r in rows if "max_abs_err=" in r[2]]
    assert len(routed) == 4 and all(".cuda[" in r[0] for r in routed)
    for name, us, derived in routed:
        assert us > 0
        err = float(derived.split("max_abs_err=")[1].split()[0])
        assert err <= ATOL, (name, err)
    serial = [r for r in rows if "serial_loop" in r[0]]
    assert serial[0][2].endswith("max_abs_diff_vs_batched=0.000e+00")


def test_time_us_times_the_card_with_events(cuda):
    from repro_torch.bench.views import common
    x = torch.randn(4096, 4096, device=cuda)
    us = common.time_us(lambda: x @ x, repeats=3)
    # 2 * 4096^3 FLOPs take at least 2 ms at 67 TFLOP/s (FP32, no TF32)
    assert us >= 2 * 4096 ** 3 / 67e12 * 1e6


# ------------------------------------------------------------- LM training
def _lm_at_full_width(cuda, layers, dtype, seq, seed):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=layers,
                              dtype=dtype)
    params = model.init(torch.Generator(device=cuda).manual_seed(seed), cfg)
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (1, seq + 1)).astype(np.int32)).to(cuda)
    return cfg, params, {"tokens": tokens}


def test_lm_gradients_through_the_float32_kernel_match_the_plain_loop(cuda):
    """chip_smoke.py phase 11 (a) at depth 1 and S 256: qwen2-7b's width
    in float32, ``lm_loss`` and every gradient leaf under remat through
    the FFMA kernel against the plain loop (1e-5 relative; 1e-4 of each
    leaf's largest |g|), 2 launches (forward and recompute) against 0."""
    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.models.layers import ModelContext
    from repro_torch.train.train_step import loss_and_grads
    cfg, params, batch = _lm_at_full_width(cuda, 1, "float32", 256, 4)
    out = {}
    for route, ctx in (("kernel", ModelContext(remat="full")),
                       ("plain", ModelContext(remat="full",
                                              flash_kernel=False))):
        torch.cuda.synchronize()
        ops.reset_launches()
        (loss, _), grads = loss_and_grads(params, batch, cfg, ctx)
        torch.cuda.synchronize()
        out[route] = (loss.item(), tree.flatten_with_names(grads),
                      dict(ops.LAUNCHES))
    assert out["kernel"][2]["flash_attention"] == 2
    assert sum(out["kernel"][2].values()) == 2
    assert sum(out["plain"][2].values()) == 0
    assert abs(out["kernel"][0] - out["plain"][0]) <= \
        1e-5 * abs(out["plain"][0])
    want = out["plain"][1]
    for name, got in out["kernel"][1].items():
        scale = want[name].abs().max().item()
        assert scale > 0, name
        assert (got - want[name]).abs().max().item() <= 1e-4 * scale, name


def test_bf16_lm_backward_launches_wgmma_twice_per_layer_under_remat(cuda):
    """A bf16 ``lm_loss`` backward at qwen2-7b's width (2 layers, S 256):
    the wgmma kernel runs each layer's forward and its recompute, the
    FFMA kernel never; with remat off, once per layer."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import ModelContext
    from repro_torch.train.train_step import loss_and_grads
    cfg, params, batch = _lm_at_full_width(cuda, 2, "bfloat16", 256, 5)
    for remat, want in (("full", 4), ("none", 2)):
        torch.cuda.synchronize()
        ops.reset_launches()
        (loss, _), grads = loss_and_grads(params, batch, cfg,
                                          ModelContext(remat=remat))
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention_wgmma"] == want, remat
        assert sum(ops.LAUNCHES.values()) == want, remat
        assert torch.isfinite(loss)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5),
                                        ("bfloat16", 0.05)])
def test_moe_block_on_the_card_equals_the_cpu_and_repeats_its_bits(
        cuda, dtype, tol):
    """``moe.moe_block`` at ``deepseek-moe-16b-smoke`` on the card against
    its CPU run (the same parameters and input), the same expert choices;
    a second run on the card gives the same bits (the combine uses no
    atomics)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("deepseek-moe-16b-smoke"),
                              dtype=dtype)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy((0.5 * np.random.RandomState(0).randn(
        2, 64, cfg.d_model)).astype(np.float32)).to(getattr(torch, dtype))
    want, want_aux = moe.moe_block(p, x, cfg)
    pc = {k: t.to(cuda) for k, t in p.items()}
    got, aux = moe.moe_block(pc, x.to(cuda), cfg)
    again, aux2 = moe.moe_block(pc, x.to(cuda), cfg)
    assert torch.equal(got, again) and torch.equal(aux, aux2)
    xt = moe.L.rms_norm(x, p["ln"], cfg.norm_eps).reshape(-1, cfg.d_model)
    _, idx, _ = moe.route(xt, p["router"], cfg.experts_per_token)
    _, cidx, _ = moe.route(xt.to(cuda), pc["router"], cfg.experts_per_token)
    assert torch.equal(cidx.cpu(), idx)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5),
                                        ("bfloat16", 0.05)])
def test_routed_ep_on_the_card_equals_the_cpu_and_repeats_its_bits(
        cuda, dtype, tol):
    """``moe.routed_ep`` at ``deepseek-moe-16b-smoke`` over an NCCL world
    of one on the card against its run over a gloo world of one on the
    CPU (the same parameters and input): the same kept pairs, the outputs
    within ``tol``; a second run on the card gives the same bits, and a
    decode step makes no host read. A capacity factor of 1 (each expert
    its even share) makes pairs drop here."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.device import use_device
    from repro_torch.distributed.sharding import make_context
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("deepseek-moe-16b-smoke"),
                              dtype=dtype)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy((0.5 * np.random.RandomState(0).randn(
        2, 64, cfg.d_model)).astype(np.float32)).to(getattr(torch, dtype))

    def run(dev, xs):
        pd = {k: t.to(dev) for k, t in p.items()}
        with use_device(dev):
            ctx = make_context(make_host_mesh(1, 1), capacity_factor=1.0)
        try:
            assert dist.get_backend() == ("nccl" if dev.type == "cuda"
                                          else "gloo")
            outs = [moe.routed_ep(xi.to(dev), pd, cfg, ctx) for xi in xs]
            if dev.type == "cuda":
                step = x[:, :1].to(dev)
                moe.routed_ep(step, pd, cfg, ctx)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    moe.routed_ep(step, pd, cfg, ctx)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
            return outs
        finally:
            dist.destroy_process_group()

    (got, aux), (again, aux2) = run(cuda, [x, x])
    ((want, want_aux),) = run(torch.device("cpu"), [x])
    assert torch.equal(got, again) and torch.equal(aux, aux2)
    xt = x.reshape(-1, cfg.d_model)
    cap = xt.shape[0] * cfg.experts_per_token // cfg.num_experts
    keep = [moe.dispatch_slots(moe.route(t, r, cfg.experts_per_token)[1]
                               .reshape(-1), cfg.num_experts, cap)[1].cpu()
            for t, r in ((xt, p["router"]),
                         (xt.to(cuda), p["router"].to(cuda)))]
    assert torch.equal(keep[0], keep[1]) and not keep[0].all()
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5),
                                        ("bfloat16", 0.05)])
def test_mamba_block_on_the_card_equals_the_cpu(cuda, dtype, tol):
    """``ssm.mamba_block`` at ``mamba2-370m-smoke`` (two SSD chunks) on the
    card against its CPU run, on its chunked path with the prefill state
    and on its one-token decode path from that state."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.layers import ModelContext
    cfg = dataclasses.replace(get_config("mamba2-370m-smoke"), dtype=dtype)
    ctx = ModelContext(ssd_chunk=32)
    p = ssm.init_mamba(torch.Generator().manual_seed(0), cfg)
    pc = {k: t.to(cuda) for k, t in p.items()}
    x = torch.from_numpy((0.5 * np.random.RandomState(0).randn(
        2, 65, cfg.d_model)).astype(np.float32)).to(getattr(torch, dtype))
    want, (tail, state) = ssm.mamba_block(p, x[:, :64], cfg, ctx,
                                          return_state=True)
    got, (ctail, cstate) = ssm.mamba_block(pc, x[:, :64].to(cuda), cfg, ctx,
                                           return_state=True)
    step, _ = ssm.mamba_block(p, x[:, 64:], cfg, ctx, cache=(tail, state))
    cstep, _ = ssm.mamba_block(pc, x[:, 64:].to(cuda), cfg, ctx,
                               cache=(ctail, cstate))
    for a, b in ((got, want), (ctail, tail), (cstate, state),
                 (cstep, step)):
        torch.testing.assert_close(a.cpu().float(), b.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("arch, head_dim, kernel", [
    ("mamba2-370m-smoke", 16, None),
    ("zamba2-2.7b-smoke", 80, "flash_attention"),
    ("musicgen-medium-smoke", 64, "flash_attention_wgmma")])
def test_family_prefill_launches_on_the_card(cuda, arch, head_dim, kernel):
    """A bf16 prefill of each family on the card launches its kernel once
    per attention application (zamba2's shared attention at head dim 80
    on the FFMA kernel, musicgen at 64 on wgmma, mamba2 none), and its
    logits agree with the plain attention loop's within the bf16 serve
    bound (0.02 relative, tests/test_models.py)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    cfg = dataclasses.replace(get_config(arch), head_dim=head_dim)
    n_attn = sum(s.kind == "attn" for s in model.layer_specs(cfg))
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    ctx = ModelContext(ssd_chunk=64)
    torch.cuda.synchronize()
    ops.reset_launches()
    _, got = model.prefill(params, tokens, cfg, ctx, cache_len=260)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    _, want = model.prefill(params, tokens, cfg,
                            dataclasses.replace(ctx, flash_kernel=False),
                            cache_len=260)
    assert launches == {name: (n_attn if name == kernel else 0)
                        for name in launches}
    rel = (got - want).abs().max() / want.abs().max()
    assert rel < 0.02


def _gemma_cut(cuda, dtype):
    """``gemma3-4b-smoke`` at the full config's plan in small (ratio 5, 8
    layers: one block of 5 window layers and a global one, then 2 window
    layers) and its head dim (256, which no kernel takes), its window 8,
    made on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model
    cfg = dataclasses.replace(get_config("gemma3-4b-smoke"), dtype=dtype,
                              local_global_ratio=5, num_layers=8,
                              head_dim=256)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    return cfg, params


def test_local_global_prefill_and_decode_launch_no_kernel(cuda):
    """A bf16 ``gemma3-4b``-plan prefill and decode on the card launch no
    hand-written kernel (window layers and, at full size, head dim 256
    take the plain loop), and the caches keep the window's 8 rows in a
    window layer."""
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    cfg, params = _gemma_cut(cuda, "bfloat16")
    tokens = torch.randint(0, cfg.vocab_size, (2, 21), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    ctx = ModelContext(q_chunk=8, k_chunk=8)
    torch.cuda.synchronize()
    ops.reset_launches()
    caches, logits = model.prefill(params, tokens[:, :20], cfg, ctx,
                                   cache_len=32)
    caches, logits = model.decode_step(params, caches, tokens[:, 20:], 20,
                                       cfg, ctx)
    torch.cuda.synchronize()
    assert not any(ops.LAUNCHES.values()), dict(ops.LAUNCHES)
    assert torch.isfinite(logits).all()
    assert [c[0].shape[1] for c in caches] == [8] * 5 + [32] + [8] * 2


@pytest.mark.parametrize("S", [16, 13])
def test_local_global_decode_on_the_card_equals_its_forward(cuda, S):
    """float32 on the card: a prompt of S tokens (13: not a multiple of
    the window), then 6 teacher-forced decode steps past the ring's wrap,
    each step's logits within 1e-5 of the forward over the same tokens,
    and equal to the same steps on the CPU within 1e-5."""
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    cfg, params = _gemma_cut(cuda, "float32")
    tokens = torch.randint(0, cfg.vocab_size, (2, S + 6), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(2))
    ctx = ModelContext(q_chunk=8, k_chunk=8)
    hid, _ = model.forward(params, tokens, cfg, ctx)
    want = (hid @ params["unembed"]).float()

    def served(p, t, dev):
        caches, logits = model.prefill(p, t[:, :S], cfg, ctx,
                                       cache_len=S + 6)
        out = [logits]
        for pos in range(S, S + 6):
            caches, logits = model.decode_step(p, caches, t[:, pos:pos + 1],
                                               pos, cfg, ctx)
            out.append(logits)
        return torch.stack(out, dim=1)
    got = served(params, tokens, cuda)
    torch.testing.assert_close(got, want[:, S - 1:], rtol=1e-5, atol=1e-5)
    from repro_torch import tree
    from repro_torch.device import use_device
    with use_device("cpu"):
        cpu = served(tree.tree_map(lambda t: t.cpu(), params),
                     tokens.cpu(), torch.device("cpu"))
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-5, atol=1e-5)


# --------------------------------------- MLA with MTP, and the VLM family
def _smoke_on_card(cuda, arch, dtype, **over):
    """``arch``'s smoke config at head dim 64 (a wgmma head dim in bf16)
    and its random parameters on the card; a VLM's cross-layer gates set
    to 1 (0 at init switches the layer off)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model
    cfg = dataclasses.replace(get_config(arch), dtype=dtype, head_dim=64,
                              **over)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    for layer, spec in zip(params["layers"], model.layer_specs(cfg)):
        if spec.kind == "cross_attn":
            layer["attn"]["gate"].fill_(1.0)
    return cfg, params


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_mtp_loss_kernel_route_matches_the_plain_loop(cuda, dtype, tol):
    """``lm_loss`` with the MTP head on the card: the MTP layer's GQA
    attention is the loss's one flash launch (the MLA layers take the
    plain loop), and its ``mtp`` and ``loss`` equal the plain loop's;
    ``ce`` does not move with the route."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    cfg, params = _smoke_on_card(cuda, "deepseek-v3-671b-smoke", dtype)
    tokens = torch.randint(0, cfg.vocab_size, (2, 41), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    ctx = ModelContext(q_chunk=16, k_chunk=16)
    runs = {}
    with torch.no_grad():
        for kernel in (True, False):
            torch.cuda.synchronize()
            ops.reset_launches()
            _, m = model.lm_loss(params, {"tokens": tokens}, cfg,
                                 dataclasses.replace(ctx,
                                                     flash_kernel=kernel))
            torch.cuda.synchronize()
            runs[kernel] = (m, dict(ops.LAUNCHES))
    (got, launched), (want, plain) = runs[True], runs[False]
    name = ops.flash_kernel_for(getattr(torch, dtype), 64)
    assert launched == {**plain, name: 1} and not any(plain.values())
    assert got["ce"].item() == want["ce"].item()
    for key in ("mtp", "loss"):
        assert abs(got[key].item() - want[key].item()) <= \
            tol * abs(want[key].item()), key


def test_mla_decode_on_the_card_equals_its_forward(cuda):
    """float32 on the card: the absorbed latent decode over 6
    teacher-forced steps against the expanded forward within 1e-5, and
    equal to the same steps on the CPU within 1e-5."""
    from repro_torch import tree
    from repro_torch.device import use_device
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    cfg, params = _smoke_on_card(cuda, "deepseek-v3-671b-smoke", "float32")
    S = 16
    tokens = torch.randint(0, cfg.vocab_size, (2, S + 6), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(2))
    ctx = ModelContext(q_chunk=8, k_chunk=8)
    hid, _ = model.forward(params, tokens, cfg, ctx)
    want = (hid @ params["unembed"]).float()

    def served(p, t):
        caches, logits = model.prefill(p, t[:, :S], cfg, ctx,
                                       cache_len=S + 6)
        out = [logits]
        for pos in range(S, S + 6):
            caches, logits = model.decode_step(p, caches, t[:, pos:pos + 1],
                                               pos, cfg, ctx)
            out.append(logits)
        return torch.stack(out, dim=1)
    got = served(params, tokens)
    torch.testing.assert_close(got, want[:, S - 1:], rtol=1e-5, atol=1e-5)
    with use_device("cpu"):
        cpu = served(tree.tree_map(lambda t: t.cpu(), params), tokens.cpu())
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-4),
                                        ("bfloat16", 5e-2)])
def test_vlm_prefill_kernel_route_matches_the_plain_loop(cuda, dtype, tol):
    """A VLM prefill on the card at the full plan's super-block (4
    self-attention layers and a cross-attention one, twice): one flash
    launch a self-attention layer, none for cross-attention (its query
    and image rows differ) and none in decode; the last logits within
    ``tol`` of the plain loop's largest |logit|."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    cfg, params = _smoke_on_card(cuda, "llama-3.2-vision-90b-smoke", dtype,
                                 cross_attn_every=5, num_layers=10)
    n_self = sum(s.kind == "attn" for s in model.layer_specs(cfg))
    g = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), device=cuda,
                           generator=g)
    img = (0.1 * torch.randn(2, cfg.num_image_tokens, cfg.d_model,
                             generator=g, device=cuda)).to(
        getattr(torch, dtype))
    ctx = ModelContext(q_chunk=16, k_chunk=16)
    runs = {}
    for kernel in (True, False):
        c = dataclasses.replace(ctx, flash_kernel=kernel)
        torch.cuda.synchronize()
        ops.reset_launches()
        caches, logits = model.prefill(params, tokens[:, :32], cfg, c,
                                       cache_len=40, image_embeds=img)
        torch.cuda.synchronize()
        runs[kernel] = (logits, dict(ops.LAUNCHES))
        ops.reset_launches()
        _, dec = model.decode_step(params, caches, tokens[:, 32:], 32, cfg,
                                   c, image_embeds=img)
        torch.cuda.synchronize()
        assert not any(ops.LAUNCHES.values()), dict(ops.LAUNCHES)
        assert torch.isfinite(dec).all()
    (got, launched), (want, plain) = runs[True], runs[False]
    name = ops.flash_kernel_for(getattr(torch, dtype), 64)
    assert launched == {**plain, name: n_self} and not any(plain.values())
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel < tol, rel


# ------------------------------------------- non-dense families' training
@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5),
                                        ("bfloat16", 0.05)])
def test_moe_block_gradients_on_the_card_repeat_and_equal_the_cpu(
        cuda, dtype, tol):
    """The backward of ``moe.moe_block`` at ``deepseek-moe-16b-smoke`` on
    the card (the routed rows' gather, the inverse permutation, the
    experts, the router and the shared experts): two runs give the same
    bits in every gradient, and each gradient equals the CPU's within
    ``tol`` of its largest |value|, with the same expert choices."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("deepseek-moe-16b-smoke"),
                              dtype=dtype)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    rng = np.random.RandomState(0)
    x = torch.from_numpy((0.5 * rng.randn(2, 64, cfg.d_model)).astype(
        np.float32)).to(getattr(torch, dtype))
    w = torch.from_numpy(rng.randn(2, 64, cfg.d_model).astype(np.float32))

    def grads(dev):
        leaves = {k: t.to(dev).requires_grad_() for k, t in p.items()}
        xi = x.to(dev).requires_grad_()
        y, aux = moe.moe_block(leaves, xi, cfg)
        loss = (y.float() * w.to(dev)).sum() + aux
        names = sorted(leaves)
        got = torch.autograd.grad(loss, [xi] + [leaves[n] for n in names])
        return dict(zip(["x"] + names, (g.detach() for g in got)))
    want = grads(torch.device("cpu"))
    got, again = grads(cuda), grads(cuda)
    for name, g in want.items():
        assert torch.equal(got[name], again[name]), name
        scale = g.float().abs().max().item()
        assert scale > 0, name
        diff = (got[name].cpu().float() - g.float()).abs().max().item()
        assert diff <= tol * scale, (name, diff / scale)


def _train_launches(cfg):
    """One training step's flash launches under remat (each attention
    layer the kernel takes: forward and recompute; the MTP layer once)."""
    from repro_torch.models import model
    n = sum(s.kind == "attn" and not s.window
            for s in model.layer_specs(cfg))
    return 2 * n + (1 if cfg.mtp_depth else 0)


@pytest.mark.parametrize("arch", [
    "deepseek-moe-16b-smoke", "deepseek-v3-671b-smoke", "mamba2-370m-smoke",
    "zamba2-2.7b-smoke", "musicgen-medium-smoke", "gemma3-4b-smoke",
    "llama-3.2-vision-90b-smoke"])
def test_family_train_step_launches_its_kernels_on_the_card(cuda, arch):
    """One bf16 ``make_train_step`` at each non-dense ``-smoke`` arch on
    the card (the launcher's context and optimizer; the VLM with bf16
    image embeddings): exactly its flash launches (head dim 16: the
    FFMA kernel; windows, MLA and cross-attention on the plain loop),
    finite metrics, the step counted."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_batches
    from repro_torch.models.layers import ModelContext
    from repro_torch.train import OptimizerConfig
    from repro_torch.train.train_step import make_train_state, make_train_step
    cfg = get_config(arch)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=10)
    state = make_train_state(torch.Generator(device=cuda).manual_seed(0),
                             cfg, opt_cfg)
    step = make_train_step(cfg, ModelContext(remat="full", q_chunk=256,
                                             k_chunk=256), opt_cfg)
    batch = {k: v.to(cuda) for k, v in next(train_batches(cfg, 2, 64))
             .items()}
    torch.cuda.synchronize()
    ops.reset_launches()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    name = ops.flash_kernel_for(torch.bfloat16, cfg.head_dim)
    n = _train_launches(cfg)
    assert dict(ops.LAUNCHES) == {k: (n if k == name else 0)
                                  for k in ops.LAUNCHES}
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert int(state["step"]) == 1


def test_vlm_launcher_runs_on_the_card(cuda, tmp_path, capsys):
    """``python -m repro_torch.launch.train`` at the VLM's ``-smoke``
    config on the card (its default device): image batches reach the
    cross-attention layers, the run ends at its step count."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    arch = "llama-3.2-vision-90b-smoke"
    ops.reset_launches()
    assert train.main(["--arch", arch, "--steps", "2", "--ckpt",
                       str(tmp_path)]) == 0
    assert "done: 2 steps" in capsys.readouterr().out
    assert ops.LAUNCHES["flash_attention"] == \
        2 * _train_launches(get_config(arch))


# ------------------------------------------------------ example entry points
def test_quickstart_runs_on_the_card(cuda):
    """No ``--device``: the card. ``cuda-idct`` launches ``idct8x8`` once
    per component of the decoded image; the strict path skips."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launches()
    out = quickstart.main([], corpus_n=12, st_repeats=1, loader_repeats=1)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["idct8x8"] == 3 and sum(ops.LAUNCHES.values()) == 3
    assert out["strict"]["kind"] == "skip"
    assert out["decodes"]["cuda-idct"] == out["decodes"]["numpy-fast"]


def test_serve_lm_on_the_card_equals_a_direct_generate(cuda):
    """bf16 at ``qwen2-7b-smoke`` (head dim 16: the FFMA kernel), one
    launch a layer in the prefill, ids equal to ``engine.generate``'s."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_lm
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.serve import engine
    cfg = get_config("qwen2-7b-smoke")
    torch.cuda.synchronize()
    ops.reset_launches()
    out = serve_lm.main(["--batch", "2", "--prompt-len", "16",
                         "--new-tokens", "6"])
    torch.cuda.synchronize()
    kernel = ops.flash_kernel_for(torch.bfloat16, cfg.head_dim)
    assert ops.LAUNCHES[kernel] == cfg.num_layers
    assert sum(ops.LAUNCHES.values()) == cfg.num_layers
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    prompt, _ = serve_lm.inputs(cfg, 2, 16, cuda)
    want = engine.generate(params, prompt, cfg, serve_lm.CTX,
                           max_new_tokens=6)
    assert out["ids"] == want.cpu().tolist() and out["peak_bytes"] > 0


def test_generate_under_a_bare_cuda_runs_on_the_card(cuda):
    """``use_device("cuda")``, then ``model.init`` and ``generate``: the
    parameters land on ``cuda:0``, which the selected device names."""
    from repro_torch.configs import get_config
    from repro_torch.device import use_device
    from repro_torch.examples import serve_lm
    from repro_torch.models import model
    from repro_torch.serve import engine
    cfg = get_config("qwen2-7b-smoke")
    with use_device("cuda") as dev:
        params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
        prompt, _ = serve_lm.inputs(cfg, 2, 16, dev)
        got = engine.generate(params, prompt, cfg, serve_lm.CTX,
                              max_new_tokens=4)
    assert got.device == cuda and got.shape == (2, 4)


def test_serve_decode_on_the_card_serves_every_request(cuda):
    from repro_torch.examples import serve_decode
    from repro_torch.kernels import ops
    ops.reset_launches()
    out = serve_decode.main(["--clients", "2", "--requests", "30",
                             "--metrics-port", "0"])
    svc = out["stats"]["service"]
    assert svc["failed"] == 0 and svc["completed"] + svc["shed"] == 60
    pulls = {k: v["pulls"] for k, v in out["stats"]["router"].items()}
    if pulls["cuda-batch"] or pulls["cuda-fused"]:
        assert ops.LAUNCHES["decode_batch"] >= 1


def test_storage_loader_and_autotune_run_on_the_card(cuda):
    from repro_torch.examples import autotune_workers, storage_loader
    assert storage_loader.main([], corpus_n=16)["parity"]
    out = autotune_workers.main([], corpus_n=12, candidates=(0, 2),
                                max_items=8)
    assert sorted(out["paths"]) == sorted(autotune_workers.PATHS)
