#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check exits non-zero
and prints no result line:

1. Card and build: the card's name and power limit, torch/CUDA
   versions, the kernels' build time and ptxas's register and
   shared-memory lines.
2. Kernels: each of the four CUDA kernels against its plain PyTorch
   version on the card, at the main path's shapes (the rows of the
   phase-3 batch; one 375x500 image for ycbcr2rgb), rtol=1e-5,
   atol=1e-3; then its time (CUDA events), the plain version's time,
   one PyTorch library call computing the same function, and the
   least time the card could take (``bound_ms``). ``decode_batch``
   (its own Hopper design) must equal ``dequant_idct`` (the design the
   row kernels share) bit for bit, table by table, on every row of the
   batch; it is timed beside a device copy of its input (what the card
   streams for those bytes) and at the rows of each of phase 3's group
   launches, beside its bound.
3. Path: 33 ImageNet-val-sized images (the port's ``build_corpus``,
   including the rare YCCK image) through
   ``open_decoder("cuda-batch", context=SERVICE).decode_batch``, held
   against the port's ``numpy-ref`` (<=4 levels, <=16 on the rare
   image, unless the same path's plain versions on the host differ
   more) and against those plain versions (<=1 level); batched output
   equals serial output byte for byte; ``strict-cuda`` skips exactly
   the rare image; ``cuda-fused`` decodes the batch as ``cuda-batch``
   does; ``torch-batch`` (the unclamped jnp semantics) agrees with
   ``numpy-ref`` within 4 levels (16 rare) and with its own plain run
   on the host within 1, and sits as far from ``cuda-batch`` as the two
   plain runs do on the host (within 1 level).
   Each path is driven with the launch counters set to 0 just before it
   and read just after; every kernel must have launched on its path.
4. Flash attention, whose two kernels ``ops.flash_kernel_for`` picks by
   dtype: ``flash_attention_wgmma`` (bf16, tensor cores) at the LM
   prefill's shape (B=4, S=2048, 28 query heads over 4 KV heads,
   head_dim 128, causal), ragged S=100 and 129, S=1 and ``causal=False``;
   ``flash_attention`` (FFMA) at the float32 cases. Each against the
   plain PyTorch version on the card, with tests/test_kernels.py's
   tolerances (2e-2 in bf16, 2e-5 in f32), on inputs drawn so that the
   output is of the order of 1 (peaked attention); each call must move
   its own kernel's launch count and no other. Then both kernels' times
   at the prefill's shape (wgmma in bf16, FFMA in float32), beside the
   plain version's, ``scaled_dot_product_attention``'s (a yardstick the
   port never calls) and the bound (bf16 tensor-core rate, FP32 rate).
5. LM serving: ``qwen2-7b`` at full width and depth (28 layers, random
   weights from a seeded generator, made on the card) through
   ``repro_torch.serve.engine.generate``: 4 prompts of 2048 tokens, 32
   greedy new tokens. ``flash_attention_wgmma`` must launch exactly once
   per layer (prefill only) and ``flash_attention`` never. The bf16
   prefill's last-position logits are printed beside those of the plain
   attention loop on the card, and the plain loop at two chunkings
   beside itself (bf16 rounding noise). The check is made in float32 at
   full width and depth (the same seed, the bf16 weights released
   first), where the FFMA kernel must launch once per layer and the
   wgmma kernel never: the kernel path's logits must agree with the
   plain loop's within 1e-4 of the largest logit. Prints prefill and
   decode tokens/s and the phase's peak device memory.
6. The decode service: ``repro_torch.service.DecodeService`` over
   ``cuda-batch`` (two workers, micro-batches of up to 8, a 5 ms wait,
   no cache, ``/metrics`` on an ephemeral loopback port), driven by three
   closed-loop clients that each send phase 3's 33 images once, in an
   order shuffled from the client's seed, with at most 8 requests in
   flight each. Every result must be byte-identical to the serial
   ``cuda-batch`` decode of its file; no request may be shed or fail;
   ``ycbcr2rgb`` must launch once per colour request and
   ``decode_batch`` once per ``jpeg.dequant_idct`` span (a structure
   group of a micro-batch), at least once per micro-batch; a scrape of
   ``/metrics`` during the run must show completions. Prints images/s,
   latency percentiles, micro-batch sizes, stage seconds, the host
   parse+entropy share, peak device memory and path hits. The same
   traffic then goes through a one-worker service and through two
   workers at a 0.5 ms interpreter switch interval, twice each, in the
   order A B C C B A with the main run as the first A (the host's speed
   drifts within a call); results are checked the same way, and
   images/s, latency and stage seconds printed beside the main run's.
   Then a fallback run over ``strict-cuda`` and ``cuda-batch`` serves the rare
   YCCK image twice: ``strict-cuda`` must refuse it exactly once (before
   any launch) and ``cuda-batch`` serve it both times; prints the
   router's snapshot, best arm and tier. The service's launches are
   printed on their own line; the ``kernels`` line keeps each kernel's
   launches on its own path (phases 3 and 5).

7. The data loader and the paper's protocols: phase 3's 33 images
   through ``repro_torch.data.DataLoader`` over ``cuda-batch`` (batches
   of 16, two threads, chunks of 8 decoded by one ``decode_batch`` call
   each, 224x224 collate), from memory and from a shard directory
   (``write_corpus_shards`` / ``load_corpus_shards``): every batch must
   equal ``center_fit`` of the serial ``cuda-batch`` decode byte for
   byte, labels in order, no skips, ``decode_batch`` launches equal to
   the ``jpeg.dequant_idct`` spans (at least one per chunk) and
   ``ycbcr2rgb`` launches equal to the colour images. A ``strict-cuda``
   loader must skip exactly the rare image. ``prefetch_to_device`` must
   give ``cuda:0`` tensors equal to their host batches, read at once
   and after a matmul loop queued on the default stream, and re-raise a
   producer's error. A process-mode (forked) ``numpy-fast`` loader must
   deliver all 33 images byte-identical to the serial decode, and a
   process-mode ``cuda-batch`` loader must be refused. Then the paper's
   protocols over the 33 images, labelled with the card's name: ``SingleThreadProtocol`` (2 repeats,
   before and after the sweeps) and ``WorkerSweep`` in thread and
   process mode at workers 0, 2, 4 and 8 (1 repeat), over
   ``cuda-batch`` and ``numpy-fast``; ``cuda-batch`` must give skip
   records under the fork harness. Prints every record, the reports, each decoder's rank under
   each protocol and ``autotune_workers`` over a ``cuda-batch`` loader.
   A watchdog (``faulthandler``) ends a hung phase with tracebacks.

Before phases 3, 4, 5, 6 and 7 the script releases cuBLAS's per-stream
workspaces and the allocator's free blocks, then prints the device
memory still held and the live CUDA tensors behind it, so that each
phase's peak is its own.

``python3 chip_smoke.py --profile`` adds a ``torch.profiler`` pass over
one prefill and a few decode steps of phase 5 (device time by kernel,
device busy share); the default run does not profile.

The last lines are the service's launches (``{"service_launches":
...}``), the loader's (``{"loader_launches": ...}``), the ``kernels``
JSON object, the card's name and power limit, and ``{"ok": true,
"device": {...}}``.
"""
import gc
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12      # H100 SXM FP32 outside the tensor cores
# H100 SXM dense bf16 on the tensor cores (NVIDIA's data sheet, no
# sparsity): the least time for bf16 attention, whatever a kernel uses
BF16_FLOPS_PER_S = 989e12
DEV = "cuda"                  # phases 4 and 5 run here
SIZES = [(375, 500), (500, 375), (333, 500), (500, 333), (500, 500)]
N_IMAGES = 33
RTOL, ATOL = 1e-5, 1e-3


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3, graph=True):
    """Milliseconds per call of ``fn`` on the card, by CUDA events after
    warm-up. ``graph=True`` captures ``iters`` calls in one CUDA graph
    and times its replay: the card's own time, without the Python and
    launch overhead between calls (which dominates a kernel of a few
    microseconds). ``graph=False`` times eager calls back to back."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(iters):
                fn()
    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, flops_per_s=FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    import torch
    from repro_torch.kernels import build
    print("== phase 1: card and build")
    print("card:", smi_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.load_all()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"(nvcc in parallel: {build.BUILD_SECONDS} s)")
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line for w in ("Used", "spill", "error", "warning",
                                       "Performance Loss")):
                print(f"  {name}: {line.strip()}")


def batch_rows(files):
    """The rows the main path's decode_batch launches see, all groups
    together: every (image, component) block row, one table each."""
    import numpy as np
    from repro_torch.jpeg import huffman
    from repro_torch.jpeg import parser as P
    rows, ridx, qtabs = [], [], []
    for f in files:
        spec = P.parse(f)
        coef = huffman.decode_coefficients(spec)
        for c in spec.components:
            r = coef[c.cid].reshape(-1, 64).astype(np.float32)
            ridx.append(np.full(len(r), len(qtabs), np.int32))
            qtabs.append(spec.qtables[c.tq].astype(np.float32).reshape(64))
            rows.append(r)
    return np.concatenate(rows), np.concatenate(ridx), np.stack(qtabs)


def structure_groups(files):
    """Indices of the files of each same-structure group, in the order
    ``cuda-batch`` launches them (one ``decode_batch`` per group)."""
    from repro_torch.jpeg import parser as P
    groups = {}
    for i, f in enumerate(files):
        spec = P.parse(f, headers_only=True)
        key = (len(spec.components),
               tuple((c.h, c.v) for c in spec.components))
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def decode_batch_work(n, t):
    """Bytes (x, qidx, the tables and M^T read once, out written once) and
    FLOPs (dequant and the 64-term sums) of one decode_batch call."""
    f32 = 4
    return (n * 64 * f32 * 2 + n * 4 + t * 64 * f32 + 64 * 64 * f32,
            n * (64 + 64 * 64 * 2))


def check_decode_batch(files, x, qi, qt):
    """decode_batch against dequant_idct, table by table (bit for bit);
    then decode_batch's time at each phase-3 group launch's rows and
    tables, beside its bound."""
    import torch
    from repro_torch.kernels import ops
    got = ops.decode_batch(x, qi, qt)
    unequal = []
    for t in range(qt.shape[0]):
        rows = qi == t
        want = ops.dequant_idct(x[rows].contiguous(), qt[t].contiguous())
        if not torch.equal(got[rows], want):
            unequal.append(t)
    torch.cuda.synchronize()
    check(not unequal, f"decode_batch differs from dequant_idct for "
                       f"tables {unequal}")
    print(f"decode_batch == dequant_idct bit for bit, table by table: "
          f"{qt.shape[0]} tables, {x.shape[0]} rows")
    for g, idxs in enumerate(structure_groups(files)):
        xg, qig, qtg = (torch.from_numpy(a).to(x.device) for a in
                        batch_rows([files[i] for i in idxs]))
        ms = cuda_ms(lambda: ops.decode_batch(xg, qig, qtg))
        b_ms, b_by = bound_ms(*decode_batch_work(xg.shape[0],
                                                 qtg.shape[0]))
        print(f"decode_batch at group {g} ({len(idxs)} images, "
              f"{xg.shape[0]} rows, {qtg.shape[0]} tables): ms {ms} "
              f"bound_ms {b_ms} ({b_by}), {b_ms / ms} of the bound")


def phase_kernels(files):
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    print("== phase 2: kernels against their plain versions")
    dev = torch.device("cuda", 0)
    x_np, qi_np, qt_np = batch_rows(files)
    x = torch.from_numpy(x_np).to(dev)
    qi = torch.from_numpy(qi_np).to(dev)
    qt = torch.from_numpy(qt_np).to(dev)
    q0 = qt[0].contiguous()
    n, t = x.shape[0], qt.shape[0]
    deq = (x * qt[qi.long()]).contiguous()
    deq0 = (x * q0[None]).contiguous()
    m_t = torch.from_numpy(ref.IDCT64.T.copy()).to(dev)
    bias128 = torch.full((64,), 128.0, device=dev)
    zeros64 = torch.zeros(64, device=dev)
    rng = np.random.RandomState(0)
    h, w = 375, 500
    y, cb, cr = (torch.from_numpy(
        rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
        for _ in range(3))
    ycc = torch.stack([y, cb, cr], dim=-1).reshape(-1, 3)
    a = torch.tensor([[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136],
                      [1.0, 1.772, 0.0]], device=dev)
    a_bias = -128.0 * a[:, 1:].sum(dim=1)
    npix = h * w
    f32 = 4
    cases = [
        ("decode_batch", "src/repro/kernels/decode_batch.py:27",
         lambda: ops.decode_batch(x, qi, qt),
         lambda: ref.decode_batch(x, qi, qt),
         lambda: torch.addmm(bias128, deq, m_t),
         *decode_batch_work(n, t)),
        ("dequant_idct", "src/repro/kernels/dequant_idct.py:19",
         lambda: ops.dequant_idct(x, q0),
         lambda: ref.dequant_idct(x, q0),
         lambda: torch.addmm(bias128, deq0, m_t),
         n * 64 * f32 * 2 + 64 * f32 + 64 * 64 * f32,
         n * (64 + 64 * 64 * 2)),
        ("idct8x8", "src/repro/kernels/idct8x8.py:24",
         lambda: ops.idct8x8(deq),
         lambda: ref.idct8x8(deq),
         lambda: torch.addmm(zeros64, deq, m_t),
         n * 64 * f32 * 2 + 64 * 64 * f32,
         n * 64 * 64 * 2),
        ("ycbcr2rgb", "src/repro/kernels/ycbcr2rgb.py:19",
         lambda: ops.ycbcr2rgb(y, cb, cr),
         lambda: torch.stack(ref.ycbcr2rgb(y, cb, cr), dim=-1),
         lambda: torch.addmm(a_bias, ycc, a.T),
         npix * 3 * f32 * 2,
         npix * 10),
    ]
    print(f"rows: {n} from {len(files)} images, {t} quant tables; "
          f"ycbcr2rgb at {h}x{w}")
    results = {}
    for name, replaces, kern, plain, lib, nbytes, flops in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain)
        library_ms = cuda_ms(lib)
        eager_ms = cuda_ms(kern, graph=False)
        b_ms, b_by = bound_ms(nbytes, flops)
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}
        print(f"{name}: max_abs_err {err} ms {ms} plain_ms {plain_ms} "
              f"library_ms {library_ms} bound_ms {b_ms} ({b_by}); "
              f"eager calls {eager_ms} ms each")
    db = results["decode_batch"]
    copy_out = torch.empty_like(x)
    copy_ms = cuda_ms(lambda: copy_out.copy_(x))
    print(f"decode_batch: {db['ms'] / db['library_ms']} of torch.addmm's "
          f"time, {db['ms'] / results['dequant_idct']['ms']} of "
          f"dequant_idct's (the row kernels' design, same rows), "
          f"{db['bound_ms'] / db['ms']} of its bound; a device copy of x "
          f"into a new tensor (its bytes less qidx and the tables) takes "
          f"{copy_ms} ms, {db['bound_ms'] / copy_ms} of the same bound")
    del copy_out
    check_decode_batch(files, x, qi, qt)
    return results


def held_report(label):
    """Release what is free, then print the device memory still allocated
    and the live CUDA tensors (found through the garbage collector) that
    account for it. Returns the bytes held."""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    # cuBLAS keeps one workspace per (handle, stream) it has run on, in
    # the caching allocator, for the life of the process; every stream
    # that cuda_ms warms up or captures on adds one
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    with warnings.catch_warnings():     # deprecated aliases gc walks past
        warnings.simplefilter("ignore", FutureWarning)
        live = [o for o in gc.get_objects()
                if torch.is_tensor(o) and o.is_cuda]
    live_bytes = sum(t.untyped_storage().nbytes() for t in live)
    top = sorted(((t.untyped_storage().nbytes(), tuple(t.shape),
                   str(t.dtype)) for t in live), reverse=True)[:6]
    print(f"held before {label}: {held} bytes allocated after releasing "
          f"{before - held} bytes of cuBLAS workspaces; {len(live)} live "
          f"CUDA tensors found by gc, {live_bytes} bytes; largest: {top}")
    return held


def drive(name, fn):
    """Run one path with the launch counters zeroed just before and
    read just after; returns (result, launches, seconds)."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"{name}: {dt:.3f} s, launches {launches}")
    return out, launches, dt


def phase_path(corpus):
    import numpy as np
    import torch
    from repro_torch.codecs import ExecContext, open_decoder
    from repro_torch.device import use_device
    from repro_torch.jpeg import parser as P
    from repro_torch.obs import trace
    print("== phase 3: cuda-batch main path")
    files, rare = corpus.files, corpus.rare_index
    groups = structure_groups(files)
    n_color = sum(len(P.parse(f, headers_only=True).components) == 3
                  for f in files)
    svc = ExecContext.SERVICE
    sess = open_decoder("cuda-batch", context=svc)
    sess.warmup(files[:2])

    # what is free goes first, so that the peak is this call's own
    held = held_report("the cuda-batch call")
    torch.cuda.reset_peak_memory_stats()
    tracer = trace.Tracer()
    with trace.use_tracer(tracer):
        outs, launches, dt = drive(
            "cuda-batch decode_batch", lambda: sess.decode_batch(files))
    peak = torch.cuda.max_memory_allocated()
    stages = trace.stage_seconds(tracer.events())
    check(all(o.ok for o in outs),
          f"cuda-batch failed items: {[o.reason for o in outs if not o.ok]}")
    check(launches["decode_batch"] == len(groups),
          f"decode_batch launched {launches['decode_batch']} times for "
          f"{len(groups)} structure groups")
    check(launches["ycbcr2rgb"] == n_color,
          f"ycbcr2rgb launched {launches['ycbcr2rgb']} times for "
          f"{n_color} 3-component images")
    entropy = stages.get("jpeg.entropy", 0.0) + stages.get("jpeg.parse", 0.0)
    device_side = stages.get("jpeg.dequant_idct", 0.0) + \
        stages.get("jpeg.assemble", 0.0)
    print(f"images/s: {len(files) / dt} ({len(files)} images in {dt} s, "
          f"{len(groups)} structure groups)")
    print(f"stage seconds: {json.dumps(stages)}")
    print(f"host parse+entropy {entropy} s ({entropy / dt:.3f} of wall); "
          f"dequant_idct+assemble {device_side} s "
          f"({device_side / dt:.3f} of wall)")
    print(f"peak device memory: {peak} bytes ({held} bytes held before "
          f"the call)")

    # The fused kernels clamp each plane to [0, 255] before colour
    # conversion (the reference's Pallas semantics, libjpeg's range
    # limit); numpy-ref does not. At these sizes that alone can put more
    # than 4 levels between the two, so the card is held to numpy-ref
    # within 4 (16 on the rare image) or, where the same path's plain
    # versions on the host already differ more, within what they differ;
    # and to those plain versions within 1 level everywhere.
    with use_device("cpu"):
        plain_outs = open_decoder("cuda-batch", context=svc).decode_batch(
            files)
    ref_sess = open_decoder("numpy-ref", context=svc)
    refs = [ref_sess.decode(f).unwrap() for f in files]
    worst, worst_plain, over = 0, 0, []
    for i, (o, p, want) in enumerate(zip(outs, plain_outs, refs)):
        check(o.image.shape == want.shape and o.image.dtype == np.uint8,
              f"image {i}: shape {o.image.shape} dtype {o.image.dtype}")
        err = int(np.abs(o.image.astype(int) - want.astype(int)).max())
        plain_err = int(np.abs(p.unwrap().astype(int) -
                               want.astype(int)).max())
        vs_plain = int(np.abs(o.image.astype(int) -
                              p.image.astype(int)).max())
        tol = 16 if i == rare else 4
        check(err <= max(tol, plain_err),
              f"image {i}: {err} levels from numpy-ref (limit {tol}; the "
              f"plain versions on the host: {plain_err})")
        check(vs_plain <= 1, f"image {i}: {vs_plain} levels from the "
                             f"plain versions on the host")
        if plain_err > tol:
            over.append((i, plain_err))
        worst = max(worst, err if i != rare else 0)
        worst_plain = max(worst_plain, vs_plain)
    print(f"numpy-ref agreement: max {worst} levels (non-rare), rare "
          f"image within 16; images where the fused semantics exceed the "
          f"limit on the host too (index, levels): {over}")
    print(f"card vs plain versions on the host: max {worst_plain} levels")
    for i, (o, f) in enumerate(zip(outs, files)):
        one = sess.decode(f)
        check(one.ok and np.array_equal(one.image, o.image),
              f"image {i}: batched output differs from serial")
    print("batched == serial: byte-identical for all images")

    strict = open_decoder("strict-cuda", context=svc)
    s_outs, s_launches, _ = drive("strict-cuda decode_batch",
                                  lambda: strict.decode_batch(files))
    skips = [i for i, o in enumerate(s_outs) if o.kind == "skip"]
    check(skips == [rare], f"strict-cuda skipped {skips}, want [{rare}]")
    print(f"strict-cuda skips: {skips}")

    fused = open_decoder("cuda-fused", context=svc)
    f_outs, f_launches, _ = drive(
        "cuda-fused decode", lambda: [fused.decode(f) for f in files])
    for i, (o, ref_o) in enumerate(zip(f_outs, outs)):
        check(o.ok, f"cuda-fused image {i}: {o.reason}")
        err = int(np.abs(o.image.astype(int) -
                         ref_o.image.astype(int)).max())
        check(err == 0, f"cuda-fused image {i} differs from cuda-batch "
                        f"by {err} levels")

    # torch-batch keeps the reference's jnp semantics (no plane clamp
    # before colour conversion), so it cannot sit within 1 level of
    # cuda-batch where a plane overshoots [0, 255]; the reference's own
    # jnp-batch and pallas-batch part the same way. It is held to
    # numpy-ref, to its own plain run on the host, and its distance from
    # cuda-batch on the card to the same distance between the two plain
    # runs on the host, within 1 level, image by image.
    tb = open_decoder("torch-batch", context=svc)
    t_outs = tb.decode_batch(files)
    with use_device("cpu"):
        t_plain = open_decoder("torch-batch", context=svc).decode_batch(
            files)
    vs_cuda = []
    for i, (o, p, c, cp, want) in enumerate(
            zip(t_outs, t_plain, outs, plain_outs, refs)):
        check(o.ok, f"torch-batch image {i}: {o.reason}")
        err = int(np.abs(o.image.astype(int) - want.astype(int)).max())
        tol = 16 if i == rare else 4
        check(err <= tol, f"torch-batch image {i}: {err} levels from "
                          f"numpy-ref (limit {tol})")
        d = int(np.abs(o.image.astype(int) - p.unwrap().astype(int)).max())
        check(d <= 1, f"torch-batch image {i}: {d} levels from its plain "
                      f"run on the host")
        d = int(np.abs(o.image.astype(int) - c.image.astype(int)).max())
        d_host = int(np.abs(p.image.astype(int) -
                            cp.image.astype(int)).max())
        check(abs(d - d_host) <= 1,
              f"image {i}: torch-batch is {d} levels from cuda-batch on "
              f"the card, {d_host} between their plain runs on the host")
        if d > 1:
            vs_cuda.append((i, d))
    print(f"torch-batch: within 4 levels of numpy-ref (16 rare) and 1 of "
          f"its host run; images more than 1 level from cuda-batch, as on "
          f"the host (index, levels): {vs_cuda}")
    differ = []
    for i, (o, f) in enumerate(zip(t_outs, files)):
        d = np.abs(tb.decode(f).image.astype(int) - o.image.astype(int))
        if d.max():
            differ.append((i, int(d.max()), int((d > 0).sum())))
    print(f"torch-batch batched vs serial (cuBLAS, not a port kernel): "
          f"{len(differ)} images differ; (index, max levels, pixels): "
          f"{differ}")
    return {"decode_batch": launches["decode_batch"],
            "ycbcr2rgb": launches["ycbcr2rgb"],
            "idct8x8": s_launches["idct8x8"],
            "dequant_idct": f_launches["dequant_idct"]}


SERVICE_CLIENTS = 3
SERVICE_WINDOW = 8      # requests in flight per client (closed loop)


def _client(svc, files, cid, seed, results, sheds):
    """Submit every file once, in an order shuffled from ``seed``, keeping
    at most ``SERVICE_WINDOW`` requests in flight; results[(cid, i)]."""
    import numpy as np
    from concurrent.futures import FIRST_COMPLETED, wait
    from repro_torch.service import ServiceOverloaded
    pending = {}
    for i in np.random.RandomState(seed).permutation(len(files)):
        if len(pending) >= SERVICE_WINDOW:
            done, _ = wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                results[(cid, pending.pop(f))] = f
        try:
            pending[svc.submit(files[i], client=cid)] = int(i)
        except ServiceOverloaded:
            sheds.append((cid, int(i)))
    wait(pending)
    for f, i in pending.items():
        results[(cid, i)] = f


def _scrape_completed(url):
    """The service's completion counter as a ``/metrics`` scrape shows it."""
    import urllib.request
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        page = r.read().decode()
    for line in page.splitlines():
        if line.startswith("service_completed_total "):
            return float(line.split()[1])
    return None


def _drive_service(svc, files):
    """Run the clients against a started service; returns the images by
    (client, file index), the shed requests, the completion count a
    ``/metrics`` scrape showed during the run (None: no endpoint) and the
    seconds from the first submit to the last result."""
    import threading
    results, sheds, scraped = {}, [], None
    t0 = time.perf_counter()
    clients = [threading.Thread(
        target=_client, args=(svc, files, f"client{k}", k, results, sheds))
        for k in range(SERVICE_CLIENTS)]
    for c in clients:
        c.start()
    while (svc.telemetry is not None and scraped is None and
           any(c.is_alive() for c in clients)):
        if svc.metrics.snapshot()["completed"] > 0:
            scraped = _scrape_completed(svc.telemetry.url)
        else:
            time.sleep(0.01)
    for c in clients:
        c.join()
    images = {key: f.result() for key, f in results.items()}
    return images, sheds, scraped, time.perf_counter() - t0


def _stage_report(label, events, wall, workers, n_req):
    """Where the workers' time went: stage seconds summed over the
    workers, parse+entropy per request, the workers' share of time
    inside ``decode_batch``, and the part of it outside the jpeg spans."""
    from repro_torch.obs import trace
    stages = trace.stage_seconds(events)
    entropy = stages.get("jpeg.entropy", 0.0) + stages.get("jpeg.parse", 0.0)
    busy = stages.get("service.batch_decode", 0.0)
    outside = busy - entropy - stages.get("jpeg.dequant_idct", 0.0) - \
        stages.get("jpeg.assemble", 0.0)
    print(f"{label}: stage seconds summed over {workers} worker(s) "
          f"{json.dumps(stages)}")
    print(f"{label}: host parse+entropy {entropy} s, {entropy / n_req} s "
          f"per request ({entropy / wall:.3f} of wall, which {workers} "
          f"worker(s) can pass); workers in decode_batch "
          f"{busy / (workers * wall):.3f} of their time, {outside} s of "
          f"it outside the jpeg spans")


def phase_service(corpus):
    import numpy as np
    import torch
    from repro_torch.codecs import open_decoder
    from repro_torch.jpeg import parser as P
    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    from repro_torch.service import DecodeService, ServiceConfig
    print("== phase 6: the decode service over cuda-batch")
    files, rare = corpus.files, corpus.rare_index
    serial = open_decoder("cuda-batch").decode_batch(files)
    check(all(o.ok for o in serial), "serial cuda-batch failed items")
    want = [o.image for o in serial]
    n_color = sum(len(P.parse(f, headers_only=True).components) == 3
                  for f in files)
    held = held_report("phase 6")
    torch.cuda.reset_peak_memory_stats()
    svc = DecodeService(ServiceConfig(
        num_workers=2, max_batch=8, max_wait_ms=5.0, cache_bytes=0,
        metrics_port=0, seed=0), paths=["cuda-batch"])
    n_req = SERVICE_CLIENTS * len(files)
    tracer = trace.Tracer()
    torch.cuda.synchronize()
    ops.reset_launches()
    with trace.use_tracer(tracer), svc:
        images, sheds, scraped, wall = _drive_service(svc, files)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    snap = svc.stats()
    events = tracer.events()
    spans = [e for e in events if e.get("ph") == "X"]
    batches = [e["args"]["batch"] for e in spans
               if e["name"] == "service.batch_decode"]
    n_idct = sum(e["name"] == "jpeg.dequant_idct" for e in spans)
    check(not sheds, f"{len(sheds)} requests shed: {sheds[:5]}")
    check(len(images) == n_req, f"{len(images)} results for {n_req} "
                                f"requests")
    for (cid, i), img in sorted(images.items()):
        check(np.array_equal(img, want[i]), f"{cid} image {i} differs "
                                            f"from the serial decode")
    print(f"{n_req} results byte-identical to the serial cuda-batch decode")
    svc_snap = snap["service"]
    check(svc_snap["failed"] == 0 and svc_snap["shed"] == 0 and
          svc_snap["completed"] == n_req, f"service counters {svc_snap}")
    check(launches["ycbcr2rgb"] == SERVICE_CLIENTS * n_color,
          f"ycbcr2rgb launched {launches['ycbcr2rgb']} times for "
          f"{SERVICE_CLIENTS * n_color} 3-component requests")
    check(launches["decode_batch"] == n_idct,
          f"decode_batch launched {launches['decode_batch']} times for "
          f"{n_idct} jpeg.dequant_idct spans")
    check(launches["decode_batch"] >= len(batches) > 0,
          f"decode_batch launched {launches['decode_batch']} times for "
          f"{len(batches)} micro-batches")
    check(sum(launches.values()) == launches["ycbcr2rgb"] +
          launches["decode_batch"], f"other kernels launched: {launches}")
    check(bool(scraped), f"/metrics showed service_completed_total "
                         f"{scraped} during the run")
    print(f"/metrics during the run: service_completed_total {scraped}")
    lat = svc.metrics.registry.get("service_latency_seconds")
    print(f"images/s: {n_req / wall} ({n_req} requests from "
          f"{SERVICE_CLIENTS} clients in {wall} s, first submit to last "
          f"result)")
    print(f"latency s: p50 {lat.quantile(0.5)} p90 {lat.quantile(0.9)} "
          f"p99 {lat.quantile(0.99)} (stats(): {svc_snap['latency_s']})")
    print(f"micro-batches: {len(batches)}, mean size "
          f"{sum(batches) / len(batches)}, largest {max(batches)}; "
          f"decode_batch launches {launches['decode_batch']}, ycbcr2rgb "
          f"{launches['ycbcr2rgb']}")
    _stage_report("two workers", events, wall, 2, n_req)
    print(f"peak device memory: {peak} bytes ({held} bytes held before "
          f"the phase)")
    print(f"path_hits {svc_snap['path_hits']} path_skips "
          f"{svc_snap['path_skips']}; router {snap['router']}")

    # The same traffic through one worker, and through two at a 0.5 ms
    # switch interval: what the second worker costs while the other
    # holds the interpreter lock in entropy decode (each torch call
    # releases the lock and may wait up to the interval to get it back).
    # The host's speed drifts within a call, so the variants run in the
    # order A B C C B A, the main run being the first A.
    two, one, fast = ("two workers", 2, None), ("one worker", 1, None), \
        ("two workers, switch interval 0.5 ms", 2, 0.0005)
    rates = {two[0]: [n_req / wall]}
    default_interval = sys.getswitchinterval()
    for label, workers, interval in (one, fast, fast, one, two):
        other = DecodeService(ServiceConfig(
            num_workers=workers, max_batch=8, max_wait_ms=5.0,
            cache_bytes=0, seed=0), paths=["cuda-batch"])
        tracer = trace.Tracer()
        sys.setswitchinterval(interval or default_interval)
        try:
            with trace.use_tracer(tracer), other:
                images_o, sheds_o, _, wall_o = _drive_service(other, files)
        finally:
            sys.setswitchinterval(default_interval)
        check(not sheds_o and len(images_o) == n_req and
              all(np.array_equal(img, want[i])
                  for (_, i), img in images_o.items()),
              f"{label}: shed requests or results unlike the serial decode")
        rates.setdefault(label, []).append(n_req / wall_o)
        lat_o = other.metrics.registry.get("service_latency_seconds")
        print(f"{label}, same traffic: images/s {n_req / wall_o} ({wall_o} "
              f"s); latency s p50 {lat_o.quantile(0.5)} p90 "
              f"{lat_o.quantile(0.9)} p99 {lat_o.quantile(0.99)}; "
              f"{other.batcher.batches_emitted} micro-batches")
        _stage_report(label, tracer.events(), wall_o, workers, n_req)
    for label, r in rates.items():
        print(f"{label}: images/s {r}, mean {sum(r) / len(r)}")

    # the rare image, once through each arm: cold arms are pulled first
    fb = DecodeService(ServiceConfig(num_workers=1, max_batch=1,
                                     cache_bytes=0, seed=0),
                       paths=["strict-cuda", "cuda-batch"])
    ops.reset_launches()
    with fb:
        got = [fb.decode(files[rare]) for _ in range(2)]
    fb_snap = fb.metrics.snapshot()
    check(fb_snap["path_skips"] == {"strict-cuda": 1},
          f"fallback run path_skips {fb_snap['path_skips']}")
    check(fb_snap["path_hits"] == {"cuda-batch": 2},
          f"fallback run path_hits {fb_snap['path_hits']}")
    check(all(np.array_equal(g, want[rare]) for g in got),
          "the rare image served by the fallback differs from cuda-batch's")
    check(ops.LAUNCHES["idct8x8"] == 0, "strict-cuda launched idct8x8 "
                                        "before refusing the rare image")
    print(f"fallback run: path_skips {fb_snap['path_skips']} path_hits "
          f"{fb_snap['path_hits']}, both byte-identical to cuda-batch; "
          f"router snapshot {fb.router.snapshot()} best "
          f"{fb.router.best()} tier {fb.router.tier()}")
    return {"decode_batch": launches["decode_batch"],
            "ycbcr2rgb": launches["ycbcr2rgb"]}


LOADER_BATCH = 16
LOADER_CHUNK = 8
LOADER_HW = (224, 224)
PROTOCOL_WORKERS = (0, 2, 4, 8)
PHASE7_WATCHDOG_S = 900


def _loader_cfg(**kw):
    from repro_torch.data.loader import LoaderConfig
    base = dict(batch_size=LOADER_BATCH, num_workers=2, mode="thread",
                decode_batch=LOADER_CHUNK, target_hw=LOADER_HW)
    base.update(kw)
    return LoaderConfig(**base)


def _want_batches(images, labels, keep):
    """The batches a loader must deliver: ``center_fit`` of each kept
    image, in order, ``LOADER_BATCH`` at a time."""
    import numpy as np
    from repro_torch.data.loader import center_fit
    th, tw = LOADER_HW
    idx = [i for i in range(len(images)) if keep(i)]
    out = []
    for k in range(0, len(idx), LOADER_BATCH):
        part = idx[k:k + LOADER_BATCH]
        out.append({"image": np.stack([center_fit(images[i], th, tw)
                                       for i in part]),
                    "label": np.asarray([labels[i] for i in part],
                                        np.int32)})
    return out


def _check_batches(label, got, want):
    import numpy as np
    check(len(got) == len(want), f"{label}: {len(got)} batches, want "
                                 f"{len(want)}")
    for b, (g, w) in enumerate(zip(got, want)):
        check(g["image"].shape == w["image"].shape and
              np.array_equal(g["image"], w["image"]),
              f"{label}: batch {b} images differ from the serial decode")
        check(np.array_equal(g["label"], w["label"]),
              f"{label}: batch {b} labels {g['label']} want {w['label']}")


def _drive_loader(label, make):
    """One epoch of the loader ``make()`` builds, with the launch
    counters zeroed just before and a tracer installed; returns
    (loader, batches, launches, spans by name, seconds)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    tracer = trace.Tracer()
    loader = make()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with trace.use_tracer(tracer):
        batches = list(loader)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    events = tracer.events()
    spans = {}
    for e in events:
        if e.get("ph") == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    n = sum(b["image"].shape[0] for b in batches)
    print(f"{label}: {n} images in {dt} s, {n / dt} images/s; launches "
          f"{launches}; jpeg.dequant_idct spans "
          f"{spans.get('jpeg.dequant_idct', 0)}; stage seconds "
          f"{json.dumps(trace.stage_seconds(events))}")
    return loader, batches, launches, spans, dt


def _check_loader_launches(label, launches, spans, n_chunks, n_color):
    check(launches["decode_batch"] == spans.get("jpeg.dequant_idct", 0),
          f"{label}: decode_batch launched {launches['decode_batch']} "
          f"times for {spans.get('jpeg.dequant_idct', 0)} "
          f"jpeg.dequant_idct spans")
    check(launches["decode_batch"] >= n_chunks,
          f"{label}: decode_batch launched {launches['decode_batch']} "
          f"times for {n_chunks} chunks")
    check(launches["ycbcr2rgb"] == n_color,
          f"{label}: ycbcr2rgb launched {launches['ycbcr2rgb']} times for "
          f"{n_color} colour images")
    check(sum(launches.values()) == launches["decode_batch"] +
          launches["ycbcr2rgb"], f"{label}: other kernels launched: "
                                 f"{launches}")


def _check_prefetch(batches):
    """``prefetch_to_device`` over the loader's batches: every item a
    ``cuda:0`` tensor equal to its host batch, read twice: at once (a
    missing stream wait reads a copy still in flight, which two 256 MiB
    items make likely) and after a long matmul loop queued on the
    default stream, when the producer has gone on to the next copies (a
    missing ``record_stream`` lets them reuse the memory first)."""
    import numpy as np
    import torch
    from repro_torch.data.loader import prefetch_to_device
    dev = torch.device("cuda", 0)
    a = torch.randn(4096, 4096, device=dev)
    big = [{"image": np.resize(np.arange(251, dtype=np.uint8), 256 << 20)
            + np.uint8(7 * k + 1)} for k in range(2)]
    for label, items in (("loader batches", batches), ("256 MiB items",
                                                       big)):
        now, later = [], []
        for item in prefetch_to_device(iter(items), size=2):
            kinds = [(type(t).__name__, getattr(t, "device", None))
                     for t in item.values()]
            check(all(torch.is_tensor(t) and t.device == dev
                      for t in item.values()),
                  f"prefetch_to_device gave {kinds}")
            now.append({k: t.clone() for k, t in item.items()})
            for _ in range(30):
                a = a @ a
                a = a / a.norm()
            later.append({k: t.clone() for k, t in item.items()})
        torch.cuda.synchronize()
        check(len(now) == len(items), f"prefetch gave {len(now)} of "
                                      f"{len(items)} {label}")
        for k, (n, l, want) in enumerate(zip(now, later, items)):
            for key in want:
                for when, got in (("at once", n), ("after the loop", l)):
                    check(np.array_equal(got[key].cpu().numpy(), want[key]),
                          f"prefetch_to_device {label} item {k} {key} "
                          f"differs from its host copy, read {when}")
        print(f"prefetch_to_device: {len(items)} {label} on {dev}, equal "
              f"to their host copies at once and after a matmul loop")
    del big

    def exploding():
        yield batches[0]
        raise RuntimeError("producer failed on purpose")
    raised = None
    try:
        for _ in prefetch_to_device(exploding(), size=1):
            pass
    except RuntimeError as e:
        raised = e
    check(raised is not None and "on purpose" in str(raised),
          f"a producer error reached the consumer as {raised!r}")
    print("prefetch_to_device: a producer error re-raised in the consumer")


def _ranks(records, protocol, mode=None):
    """decoder -> (rank, images/s, workers) under one protocol: the
    single-thread mean, or the peak over the sweep's measured cells."""
    from repro_torch.core import stats
    best = {}
    for r in records:
        if r.protocol != protocol or not r.ok or \
                (mode is not None and r.mode != mode):
            continue
        if r.decoder not in best or \
                r.throughput_mean > best[r.decoder].throughput_mean:
            best[r.decoder] = r
    names = sorted(best)
    ranks = stats.rankdata([best[d].throughput_mean for d in names])
    return {d: (float(ranks[k]), best[d].throughput_mean,
                best[d].workers) for k, d in enumerate(names)}


def phase_loader(corpus):
    import faulthandler
    print("== phase 7: the data loader and the paper's protocols over "
          "cuda-batch")
    held_report("phase 7")
    print(f"host CPUs: os.cpu_count() {os.cpu_count()}, "
          f"sched_getaffinity {len(os.sched_getaffinity(0))}")
    # a hang (a forked worker stuck on a lock held at fork) fails the run
    # with every thread's traceback instead of running out the clock
    faulthandler.dump_traceback_later(PHASE7_WATCHDOG_S, exit=True)
    try:
        return _loader_checks(corpus)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _loader_checks(corpus):
    import tempfile
    import numpy as np
    import torch
    from repro_torch.codecs import open_decoder
    from repro_torch.core import decision, protocols, report
    from repro_torch.data import autotune_workers
    from repro_torch.data.loader import DataLoader
    from repro_torch.jpeg import parser as P
    from repro_torch.jpeg.corpus import (corpus_fingerprint,
                                         load_corpus_shards,
                                         write_corpus_shards)
    t_phase = time.perf_counter()
    files, labels, rare = corpus.files, corpus.labels, corpus.rare_index
    n_chunks = -(-len(files) // LOADER_CHUNK)
    comps = [len(P.parse(f, headers_only=True).components) for f in files]
    n_color = sum(c == 3 for c in comps)
    serial = open_decoder("cuda-batch").decode_batch(files)
    check(all(o.ok for o in serial), "serial cuda-batch failed items")
    want = _want_batches([o.image for o in serial], labels, lambda i: True)

    # the main path: a chunked thread-mode loader over cuda-batch, one
    # decode_batch call per chunk of 8 (a launch per structure group)
    loader, got, launches, spans, dt = _drive_loader(
        "cuda-batch loader (memory, 2 threads, chunks of 8)",
        lambda: DataLoader(files, labels, cfg=_loader_cfg(),
                           path_name="cuda-batch"))
    _check_batches("cuda-batch loader", got, want)
    check(loader.ledger.indices() == [], f"cuda-batch loader skipped "
                                         f"{loader.ledger.state()}")
    _check_loader_launches("cuda-batch loader", launches, spans, n_chunks,
                           n_color)
    check(launches["decode_batch"] >= 1 and launches["ycbcr2rgb"] >= 1,
          f"the loader's path launched {launches}")
    print(f"cuda-batch loader: {len(got)} batches byte-identical to the "
          f"serial decode, labels in order, no skips; decode_batch "
          f"{launches['decode_batch']} = jpeg.dequant_idct spans "
          f"(>= {n_chunks} chunks), ycbcr2rgb {launches['ycbcr2rgb']} = "
          f"colour images; {loader.stats()}")
    loader_launches = {"decode_batch": launches["decode_batch"],
                       "ycbcr2rgb": launches["ycbcr2rgb"]}

    with tempfile.TemporaryDirectory() as tmp:
        write_corpus_shards(corpus, tmp, shard_size=8)
        src = load_corpus_shards(tmp)
        check(src.fingerprint == corpus_fingerprint(corpus),
              "shard fingerprint differs from the corpus's")
        sloader, sgot, slaunches, sspans, _ = _drive_loader(
            "cuda-batch loader (shards, 2 threads, chunks of 8)",
            lambda: DataLoader(src, None, cfg=_loader_cfg(),
                               path_name="cuda-batch"))
        _check_batches("cuda-batch shard loader", sgot, got)
        check(sloader.ledger.indices() == [], "the shard loader skipped")
        _check_loader_launches("cuda-batch shard loader", slaunches,
                               sspans, n_chunks, n_color)
        src.close()
    print(f"cuda-batch over {-(-len(files) // 8)} shards: batches "
          f"byte-identical to the in-memory loader's")

    strict, sgot, slaunches, _, _ = _drive_loader(
        "strict-cuda loader (memory, 2 threads, chunks of 8)",
        lambda: DataLoader(files, labels, cfg=_loader_cfg(),
                           path_name="strict-cuda"))
    check(strict.ledger.indices() == [rare],
          f"strict-cuda skipped {strict.ledger.indices()}, want [{rare}]")
    want_idct = sum(c for i, c in enumerate(comps) if i != rare)
    check(slaunches["idct8x8"] == want_idct and
          sum(slaunches.values()) == want_idct,
          f"strict-cuda launches {slaunches}, want idct8x8 {want_idct}")
    check(sum(b["image"].shape[0] for b in sgot) == len(files) - 1,
          "strict-cuda delivered the wrong count")
    print(f"strict-cuda loader skips {strict.ledger.indices()}; idct8x8 "
          f"launched {slaunches['idct8x8']} times (a component each)")

    _check_prefetch(got)

    # process mode: the fork harness, numpy-fast only
    np_serial = [open_decoder("numpy-fast").decode(f).unwrap()
                 for f in files]
    ploader = DataLoader(files, labels, cfg=_loader_cfg(mode="process",
                                                        decode_batch=0),
                         path_name="numpy-fast")
    t0 = time.perf_counter()
    pgot = list(ploader)
    pdt = time.perf_counter() - t0
    ploader.close()
    _check_batches("numpy-fast process loader", pgot,
                   _want_batches(np_serial, labels, lambda i: True))
    check(sum(b["image"].shape[0] for b in pgot) == len(files),
          "process loader lost images")
    print(f"numpy-fast process loader (2 forked workers): {len(files)} "
          f"images byte-identical to the serial decode in {pdt} s")
    refused = None
    try:
        next(iter(DataLoader(files, labels, cfg=_loader_cfg(
            mode="process", decode_batch=0), path_name="cuda-batch")))
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and "not process-loader eligible" in refused,
          f"a cuda-batch process loader was not refused: {refused}")
    print(f"cuda-batch process loader refused: {refused}")

    # the paper's protocols, labelled with the card's name; the
    # single-thread protocol runs again after the sweeps, because the
    # host's speed drifts within a call (PERF.md §6)
    platform = torch.cuda.get_device_name(0)
    paths = ["cuda-batch", "numpy-fast"]
    seconds = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[label] = time.perf_counter() - t0
        return out
    single = timed("single-thread", lambda: protocols.SingleThreadProtocol(
        corpus, repeats=2, platform=platform).run(paths))
    thread = timed("thread sweep", lambda: protocols.WorkerSweep(
        corpus, repeats=1, mode="thread", platform=platform).run(
            paths, workers=PROTOCOL_WORKERS))
    process = timed("process sweep", lambda: protocols.WorkerSweep(
        corpus, repeats=1, mode="process", platform=platform).run(
            paths, workers=PROTOCOL_WORKERS))
    again = timed("single-thread again",
                  lambda: protocols.SingleThreadProtocol(
                      corpus, repeats=2, platform=platform).run(paths))
    print(f"protocol seconds: {seconds}")
    for first, second in zip(single, again):
        print(f"single-thread {first.decoder}: {first.samples} before the "
              f"sweeps, {second.samples} after")
    records = single + thread + process
    for r in records:
        check(r.platform == platform, f"record platform {r.platform}")
        if r.ok:
            check(r.throughput_mean > 0 and len(r.samples) >= 1 and
                  r.skip_indices == [] and r.num_images == len(files) and
                  r.meta["delivered"] == len(files),
                  f"record {r.scenario}: {r.to_json()}")
    check(all(r.ok for r in single + thread + again),
          "a single-thread or thread cell did not run")
    for r in process:
        if r.decoder == "cuda-batch" and r.workers > 0:
            check(r.status == "skipped" and r.samples == [] and
                  "CUDA" in r.meta["reason"],
                  f"process cuda-batch w={r.workers}: {r.to_json()}")
        else:
            check(r.ok, f"process {r.decoder} w={r.workers} did not run: "
                        f"{r.meta}")
    for r in records:
        print(json.dumps({"record": r.scenario, "images_s": r.samples,
                          "mean": r.throughput_mean, "status": r.status,
                          "skips": r.skip_indices}))
    print(report.single_thread_report(records))
    print(report.loader_report(records))
    print(report.status_report(records))
    for label, ranks in (("single-thread", _ranks(records, "single_thread")),
                         ("thread sweep peak",
                          _ranks(records, "dataloader", "thread")),
                         ("process sweep peak",
                          _ranks(records, "dataloader", "process")),
                         ("loader peak, either mode",
                          _ranks(records, "dataloader"))):
        print(f"rank under {label}: " + ", ".join(
            f"{d} {rank:g} ({rate} images/s at w={w})"
            for d, (rank, rate, w) in sorted(ranks.items(),
                                             key=lambda kv: kv[1][0])))
    rec = decision.recommend(records)
    print(report.flip_report(rec["protocol_disagreement"]))

    def factory(w):
        return DataLoader(files, labels, cfg=_loader_cfg(num_workers=w),
                          path_name="cuda-batch")
    tuned = autotune_workers(factory, candidates=PROTOCOL_WORKERS,
                             max_items=16, repeats=1)
    print(f"autotune_workers (cuda-batch, thread mode, 16 items): best "
          f"{tuned['best']} peak {tuned['peak_workers']} sweep "
          f"{tuned['sweep']}")
    print(f"phase 7: {time.perf_counter() - t_phase} s")
    return loader_launches


LM_ARCH = "qwen2-7b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
# the kernel path's float32 prefill logits against the plain loop's, as
# max abs diff / max |logit|: the port's CPU tests hold float32 logits to
# 1e-4, far inside tests/test_models.py's bf16 bound for qwen2 (0.02)
LM_F32_REL_TOL = 1e-4
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # tests/test_kernels.py


def _flash_inputs(shape, dtype, seed):
    """q and k at std 2, v at std 1: the scores q.k/sqrt(D) then have std
    4, so each row's softmax is peaked and the output is of the order of
    v. With flatter scores the output is a mean over many rows of v,
    far below the absolute tolerance, and the check would have no power."""
    import torch
    B, S, H, KV, D = shape
    g = torch.Generator(device=DEV).manual_seed(seed)
    return [(std * torch.randn(B, S, n, D, generator=g, device=DEV))
            .to(dtype) for n, std in ((H, 2.0), (KV, 2.0), (KV, 1.0))]


def flash_work(B, S, H, KV, D, causal, itemsize):
    """Bytes (q, k, v read once, out written once) and the FLOPs of the
    two products over the (query, key) pairs this call needs."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return B * S * (2 * H + 2 * KV) * D * itemsize, 4 * B * H * D * pairs


def phase_flash():
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    print("== phase 4: the flash-attention kernels against their plain "
          "version")
    held_report("phase 4")
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config(LM_ARCH)
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    path = (LM_BATCH, LM_PROMPT, *heads)
    cases = [(path, bf16, True), ((LM_BATCH, 100, *heads), bf16, True),
             ((LM_BATCH, 129, *heads), bf16, True),
             ((LM_BATCH, 1, *heads), bf16, True),
             ((1, LM_PROMPT, *heads), bf16, False),
             ((1, 512, *heads), f32, True),
             ((2, 100, *heads), f32, False)]
    worst = {}
    for i, (shape, dtype, causal) in enumerate(cases):
        q, k, v = _flash_inputs(shape, dtype, seed=i)
        kernel = ops.flash_kernel_for(dtype, shape[-1])
        before = dict(ops.LAUNCHES)
        got = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(ops.LAUNCHES == {**before, kernel: before[kernel] + 1},
              f"flash_attention {shape} {dtype} launched "
              f"{ {n: ops.LAUNCHES[n] - before[n] for n in before} }, "
              f"want one {kernel}")
        want = ref.flash_attention(q, k, v, causal)
        tol = FLASH_TOL[str(dtype).split(".")[-1]]
        diff = (got.float() - want.float()).abs()
        bad = int((diff > tol + tol * want.float().abs()).sum())
        err = diff.max().item()
        typical = want.float().abs().median().item()
        print(f"{kernel} {shape} {dtype} causal={causal}: "
              f"max_abs_err {err} (rtol=atol={tol}; median |out| "
              f"{typical}), {bad} elements over")
        check(typical > 10 * tol, f"median |out| {typical} is not well "
                                  f"above the tolerance {tol}")
        check(bad == 0 and torch.isfinite(got).all().item(),
              f"{kernel} {shape} {dtype} causal={causal}: {bad} "
              f"elements outside rtol=atol={tol} of the plain version")
        if shape == path or dtype == f32:
            worst[kernel] = max(worst.get(kernel, 0.0), err)
        del q, k, v, got, want, diff

    results = {}
    for dtype, flops_per_s in ((bf16, BF16_FLOPS_PER_S),
                               (f32, FP32_FLOPS_PER_S)):
        name = ops.flash_kernel_for(dtype, cfg.head_dim)
        q, k, v = _flash_inputs(path, dtype, seed=0)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kern = lambda: ops.flash_attention(q, k, v, causal=True)
        plain = lambda: ref.flash_attention(q, k, v, True)
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_err = (lib().transpose(1, 2).float() -
                   kern().float()).abs().max()
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain, iters=5)
        library_ms = cuda_ms(lib)
        eager_ms = cuda_ms(kern, graph=False)
        nbytes, flops = flash_work(*path, True, q.element_size())
        b_ms, b_by = bound_ms(nbytes, flops, flops_per_s)
        print(f"{name} at {path} {dtype} causal: ms {ms} plain_ms "
              f"{plain_ms} library_ms {library_ms} (SDPA, max diff to the "
              f"kernel {lib_err.item()}) bound_ms {b_ms} ({b_by}: {nbytes} "
              f"B, {flops} FLOP at {flops_per_s:.3g} FLOP/s); "
              f"{flops / ms / 1e9} TFLOP/s; eager calls {eager_ms} ms each")
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": "src/repro/kernels/flash_attention.py:30",
            "launches": 0, "max_abs_err": worst[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}
        del q, k, v, qt, kt, vt
    return results


def _profile(label, fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, launch_calls = [], 0
    for e in prof.key_averages():
        if "LaunchKernel" in e.key:
            launch_calls += e.count
        if e.device_type != DeviceType.CUDA:
            continue        # an operator's row repeats its kernels' time
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    groups = {"flash_attention": 0.0, "GEMM/GEMV": 0.0, "other": 0.0}
    for dev_us, _, key in rows:
        name = key.lower()
        group = "flash_attention" if "flash_attention" in name else \
            "GEMM/GEMV" if any(w in name for w in ("gemm", "gemv", "nvjet",
                                                    "xmma")) else "other"
        groups[group] += dev_us / 1e3
    print(f"profile {label}: wall {wall} s, device busy {busy} s "
          f"(idle share {1 - busy / wall}); {sum(r[1] for r in rows)} "
          f"kernels, {launch_calls} launch calls; device ms by group "
          f"{groups}")
    for dev_us, count, key in rows[:12]:
        print(f"  {dev_us / 1e3:.3f} ms  x{count}  {key[:90]}")
    out_dir = os.path.join(ROOT, "artifacts", "lm_profile")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        out_dir, f"{label.replace(' ', '_')}.json"))


def phase_lm(profile):
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.serve import engine
    print(f"== phase 5: {LM_ARCH} serving at full width and depth")
    held = held_report("phase 5")
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device(DEV)
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in (
        [params["embed"], params["unembed"], params["final_ln"]] +
        [t for layer in params["layers"] for part in layer.values()
         for t in part.values()]))
    print(f"{LM_ARCH}: {len(params['layers'])} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads, "
          f"{n_params} parameters ({cfg.param_count()} by param_count, "
          f"which leaves out biases and the final norm), "
          f"{torch.cuda.memory_allocated() - held} bytes, made on the card "
          f"in {time.perf_counter() - t0:.3f} s")
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=g, device=dev)
    cache_len = LM_PROMPT + LM_NEW
    ctx = ModelContext()
    # first calls build cuBLAS handles and load kernels: not measured
    engine.generate(params, prompt, cfg, ctx, max_new_tokens=2,
                    cache_len=cache_len)
    timings = {}
    out, launches, dt = drive(
        f"{LM_ARCH} generate", lambda: engine.generate(
            params, prompt, cfg, ctx, max_new_tokens=LM_NEW,
            cache_len=cache_len, timings=timings))
    serve_peak = torch.cuda.max_memory_allocated()
    n_layers = len(params["layers"])
    check(launches["flash_attention_wgmma"] == n_layers,
          f"flash_attention_wgmma launched "
          f"{launches['flash_attention_wgmma']} times for {n_layers} "
          f"layers: the bf16 prefill bypassed it")
    check(sum(launches.values()) == launches["flash_attention_wgmma"],
          f"other kernels launched on the bf16 LM path: {launches}")
    check(tuple(out.shape) == (LM_BATCH, LM_NEW) and
          out.dtype == prompt.dtype, f"generated {tuple(out.shape)} "
          f"{out.dtype}")
    check(0 <= out.min().item() and
          out.max().item() < cfg.padded_vocab_size, "ids out of range")
    pre_s, dec_s = timings["prefill_s"], timings["decode_s"]
    n_dec = LM_BATCH * (LM_NEW - 1)
    print(f"prefill: {LM_BATCH * LM_PROMPT} tokens in {pre_s} s, "
          f"{LM_BATCH * LM_PROMPT / pre_s} tokens/s")
    print(f"decode: {n_dec} tokens in {dec_s} s ({LM_NEW - 1} steps of "
          f"{LM_BATCH}), {n_dec / dec_s} tokens/s, "
          f"{dec_s / (LM_NEW - 1) * 1e3} ms per step")
    print(f"first generated ids: {out[:, :8].tolist()}")

    prefill = engine.make_prefill_step(cfg, ctx, cache_len)
    plain_prefill = engine.make_prefill_step(
        cfg, dataclasses.replace(ctx, flash_kernel=False), cache_len)
    (_, got), k_launches, k_s = drive(
        "prefill, kernel path", lambda: prefill(params, prompt))
    (_, want), p_launches, p_s = drive(
        "prefill, plain attention", lambda: plain_prefill(params, prompt))
    check(k_launches["flash_attention_wgmma"] == n_layers and
          k_launches["flash_attention"] == 0 and
          sum(p_launches.values()) == 0,
          f"launches {k_launches} / {p_launches}")
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "non-finite logits")
    scale = want.abs().max().item()
    rel = (got - want).abs().max().item() / scale
    print(f"bf16 last-position logits [{LM_BATCH}, {got.shape[1]}]: kernel "
          f"path vs plain attention max abs diff / max |logit| = {rel} "
          f"(max |logit| {scale}); kernel-path prefill {k_s} s, "
          f"plain-attention prefill {p_s} s")
    print(f"  kernel path logits[0, :4] {got[0, :4].tolist()}; plain "
          f"{want[0, :4].tolist()}")
    # the plain loop's own spread: the same attention in 512-row chunks
    # (another rounding point for the bf16 probabilities) against 1024
    (_, other), _, _ = drive("prefill, plain attention in 512-row chunks",
                             lambda: engine.make_prefill_step(
                                 cfg, dataclasses.replace(
                                     ctx, flash_kernel=False, q_chunk=512,
                                     k_chunk=512), cache_len)(params, prompt))
    print(f"bf16 plain attention, 512-row vs 1024-row chunks: max abs diff / "
          f"max |logit| = {(other - want).abs().max().item() / scale} (the "
          f"rounding noise of {len(params['layers'])} bf16 layers, beside "
          f"the kernel's {rel})")
    check(torch.equal(out[:, 0], got.argmax(dim=-1)),
          "generate's first token is not the prefill's argmax")
    del got, want, other
    if profile:
        _profile("prefill", lambda: prefill(params, prompt))
        caches, logits = prefill(params, prompt)
        tok = logits.argmax(dim=-1)[:, None]
        decode = engine.make_decode_step(cfg, ctx)

        def steps():
            c, t = caches, tok
            for i in range(8):
                c, lg = decode(params, c, t, LM_PROMPT + i)
                t = lg.argmax(dim=-1)[:, None]
        _profile("decode 8 steps", steps)
        del caches, logits, tok
    bf16_peak = torch.cuda.max_memory_allocated()

    # The logits check: the same model in float32 at full width and depth,
    # where the kernel path and the plain loop part by summation order
    # alone. In bf16 both round every layer's activations and the
    # probabilities at different points, and two chunkings of the plain
    # loop already part by about tests/test_models.py's bound, so a bf16
    # comparison could not tell a kernel fault from rounding.
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg32)
    (_, got), k_launches, k_s = drive(
        "float32 prefill, kernel path", lambda: engine.make_prefill_step(
            cfg32, ctx, cache_len)(params, prompt))
    (_, want), p_launches, p_s = drive(
        "float32 prefill, plain attention", lambda: engine.make_prefill_step(
            cfg32, dataclasses.replace(ctx, flash_kernel=False),
            cache_len)(params, prompt))
    check(k_launches["flash_attention"] == n_layers and
          k_launches["flash_attention_wgmma"] == 0 and
          sum(p_launches.values()) == 0,
          f"float32 launches {k_launches} / {p_launches}")
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "non-finite float32 logits")
    scale = want.abs().max().item()
    rel = (got - want).abs().max().item() / scale
    print(f"float32 last-position logits: kernel path vs plain attention "
          f"max abs diff / max |logit| = {rel} (limit {LM_F32_REL_TOL}; "
          f"max |logit| {scale}); kernel-path prefill {k_s} s, "
          f"plain-attention prefill {p_s} s")
    check(rel < LM_F32_REL_TOL,
          f"float32 prefill logits differ by {rel} relative")
    print(f"peak device memory: {serve_peak} bytes over generate, "
          f"{bf16_peak} over the bf16 part of the phase, "
          f"{torch.cuda.max_memory_allocated()} with the float32 check "
          f"({held} bytes held before the phase)")
    return {"flash_attention_wgmma": launches["flash_attention_wgmma"],
            "flash_attention": k_launches["flash_attention"]}


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.jpeg.corpus import build_corpus
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        phase_build()
        t0 = time.perf_counter()
        corpus = build_corpus(N_IMAGES, seed=0, sizes=SIZES)
        print(f"corpus: {N_IMAGES} images, rare index "
              f"{corpus.rare_index}, built in "
              f"{time.perf_counter() - t0:.1f} s")
        kernels = phase_kernels(corpus.files)
        launches = phase_path(corpus)
        kernels.update(phase_flash())
        launches.update(phase_lm(profile="--profile" in sys.argv[1:]))
        service_launches = phase_service(corpus)
        loader_launches = phase_loader(corpus)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for name, count in launches.items():
        if count < 1:
            print(f"chip_smoke: FAILED: {name} never launched on its path",
                  file=sys.stderr)
            return 1
        kernels[name]["launches"] = count
    print(json.dumps({"service_launches": service_launches}))
    print(json.dumps({"loader_launches": loader_launches}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
