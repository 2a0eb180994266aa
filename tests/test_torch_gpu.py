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
