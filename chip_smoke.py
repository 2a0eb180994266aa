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
   ``flash_attention`` (FFMA) at the float32 cases, head dims 48 and 80
   included, and bf16 at head dim 48. Each against the
   plain PyTorch version on the card, with tests/test_kernels.py's
   tolerances (2e-2 in bf16, 2e-5 in f32), on inputs drawn so that the
   output is of the order of 1 (peaked attention); each call must move
   its own kernel's launch count and no other. Then both kernels' times
   at the prefill's shape (wgmma in bf16, FFMA in float32), beside the
   plain version's, ``scaled_dot_product_attention``'s (a yardstick the
   port never calls) and the bound (bf16 tensor-core rate, FP32 rate).
   With ``--parent DIR`` (a checkout of another commit, such as an
   unpacked ``git archive`` of the parent), that checkout's
   ``flash_attention.cu`` is built too and timed in turns with this one
   at the float32 prefill shape and the ViT-100m shape (phase 8), on
   lines of their own.
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
8. ViT training fed by the loader (``repro_torch.train.vision_pipeline``):
   the example's ViT-100m at full width and depth (12 layers, d_model
   768, 12 heads of 64, d_ff 3072, 10 classes, 113.5 M parameters, random
   weights from a seed) in float32, on 64x64 images (64 patches of 8x8),
   batches of 16. First the float32 flash kernel at the ViT's attention
   shape (B 16, S 64, H = KV = 12, D 64, not causal): its forward, and
   the dq, dk and dv of its autograd Function, against the plain version
   (rtol=atol=2e-5); then its time beside the plain version's, SDPA's in
   float32, the backward's and the bound. One step's loss and every
   gradient leaf through the kernel route must agree with the plain
   attention loop's (1e-5 relative; 1e-4 of each leaf's largest |g|),
   with 12 ``flash_attention`` launches against 0. The trainer's default
   ``small`` ViT (6 layers, 4 heads of 48) gets the same: the kernel at
   its attention shape (B 16, S 64, H 4, D 48) against the plain version
   and timed beside SDPA and the bound, one step's loss and every
   gradient leaf against the plain loop with 6 launches against 0, and 3
   train steps on one batch with 6 launches each. 20 steps on one batch
   on the card must bring the mean of the last 5 losses below 0.8x the
   first 5's (tests/test_system.py's bar). Then the pipeline: phase 3's
   33 images through ``cuda-batch`` in two loader threads (chunks of 8,
   shuffled, whole batches) and ``prefetch_to_device`` into
   ``train`` for 6 steps, with an async save at step 3 and a final one:
   finite losses, 12 ``flash_attention`` launches a step,
   ``decode_batch`` launches equal to the ``jpeg.dequant_idct`` spans
   and ``ycbcr2rgb`` launches equal to the colour images decoded (the
   loader decodes ahead of the trainer). A restart builds a new loader
   and state from the latest checkpoint and trains to step 8; every
   batch's labels must be those of a loader never stopped. Then 4 steps
   of the same pipeline at a 0.5 ms interpreter switch interval, and 4
   over ``numpy-fast`` with autotuned workers. Prints the step ms, the
   data wait and the input-pipeline share of each run. A watchdog ends
   a hung phase with tracebacks.
9. The bench harness: ``repro_torch.bench.run_sweep("smoke", trace=True)``
   on the card, the paper's protocol matrix over the port's 14 decoders
   (8 images from the profile's seed; single-thread over every path,
   ``numpy-fast`` and ``cuda-batch`` loaders at 0 and 2 threads,
   ``numpy-fast`` forked from memory and from shards, ``cuda-batch``
   forked, ``batched/cuda-batch``, the service at 2 workers, the entropy
   and corpus twins). No record may be an error; every ``cuda-*``
   single-thread cell of the profile runs or is a capability skip with
   its reason; the forked ``cuda-batch`` cell is the resolver's skip
   record naming the fork; the shard cell and its memory twin both run
   over the same images; ``batched/cuda-batch`` runs; each of the four
   JPEG kernels launches during the sweep; every measured record is
   labelled with the card's name and carries its stage seconds; the
   summary's host names the card and its power limit. Then, through
   ``repro_torch.bench.cli.main``, ``compare`` of the record set against
   itself, ``history append`` and ``show`` on a temporary store and
   ``compare --attribute --history`` must each exit 0. Then the sweep's
   kernels at the sweep's own sizes: the smoke corpus and its mixed and
   all-progressive variants go through ``cuda-batch``, ``cuda-fused``,
   ``cuda-idct`` and ``strict-cuda`` on the card, in one batched call
   and image by image (byte-identical), and must skip the same images
   as each path's plain versions on the host and come within 1 level of
   them (and of ``numpy-ref`` as in phase 3); every input those decodes
   gave a JPEG kernel is then held to the plain version (phase 2's
   tolerance), so each kernel is checked at those rows and planes. Prints every
   measured record, the batched/serial ratio, the single-thread and
   loader reports and the protocol disagreement. A watchdog ends a hung
   phase with tracebacks.
10. The paper-table views: ``python -m repro_torch.bench tables``
   (through ``repro_torch.bench.cli.main``) on the card, every line
   kept. It must exit 0; each of the reference's nine views (table1-5,
   fig3, kernels, roofline, service) must print a row and none an
   ``.ERROR`` row; the live views must read the quick sweep's records,
   labelled with the card's name, and ``table2`` and ``table5`` give
   live rows; ``roofline`` reports zero cells, and an audit hook shows
   that nothing under the reference's ``artifacts/dryrun/`` was opened.
   The kernel view runs with the launch counters zeroed just before it
   and read just after: each of the four JPEG kernels must launch, every
   kernel row must be on the card's route within ``ATOL`` of its plain
   version, and ``decode_batch`` must equal the serial ``dequant_idct``
   loop bit for bit. Then ``tables --full --only kernels`` holds the same
   at 8192 rows and 8 x 2048 blocks. Prints every row and the phase's
   seconds. A watchdog ends a hung phase with tracebacks (the quick sweep
   forks loader workers beside the CUDA context).
11. LM training at full width: (a) ``qwen2-7b`` cut to 2 layers in
   float32 (~1.56 B parameters), one seeded batch of 1 x 512 tokens,
   ``lm_loss`` and its backward under ``remat="full"`` through the FFMA
   flash kernel and through the plain attention loop: losses within
   1e-5 relative, every gradient leaf within 1e-4 of its largest |g|,
   exactly 2 x 2 ``flash_attention`` launches (each layer's forward and
   its recompute) against 0. (b) ``qwen2-7b`` cut to 4 layers in bf16
   (~2.02 B parameters) from ``train_step.make_train_state``, 6 steps
   of ``make_train_step`` at B 2 x S 2048 on the launcher's batches:
   4 x 2 x 6 ``flash_attention_wgmma`` launches and no other, finite
   losses and gradient norms, parameters moved, ``step`` 6; prints the
   step ms (median of steps 2-6), tokens/s and the peak device memory.
   Then one step with int8 gradient compression and one with
   ``microbatch=1`` (2 slices, twice the launches). (c) ``python -m
   repro_torch.launch.train --arch qwen2-7b-smoke`` in a subprocess for
   6 steps with a checkpoint every 3, then again to 9: it must print
   ``resumed from step 6``, and the step-6 checkpoint restored on the
   card must equal its stored leaves bit for bit. Prints the phase's
   seconds.

Before phases 3 to 11 the script releases cuBLAS's per-stream
workspaces and the allocator's free blocks, then prints the device
memory still held and the live CUDA tensors behind it, so that each
phase's peak is its own.

``python3 chip_smoke.py --profile`` adds a ``torch.profiler`` pass over
one prefill and a few decode steps of phase 5 (device time by kernel,
device busy share); the default run does not profile.

The last lines are the service's launches (``{"service_launches":
...}``), the loader's (``{"loader_launches": ...}``), the training
pipeline's (``{"training_launches": ...}``), the bench sweep's
(``{"bench_launches": ...}``), the table views' kernel view, quick and
``--full`` (``{"tables_launches": ...}``), LM training's
(``{"lm_training_launches": ...}``), the ``kernels`` JSON object
(``flash_attention``'s launches: phase 5's float32 check, phase 8's
pipeline and phase 11's check; ``flash_attention_wgmma``'s: phase 5's
prefill and phase 11's steps), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

DEV = "cuda"                  # phases 4, 5 and 8 run here
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


def chip_spec():
    """The card's published rates (``repro_torch.common.hw.H100_SXM``,
    NVIDIA's data sheet for the SXM part): HBM bytes/s, FP32 FLOP/s
    outside the tensor cores, dense bf16 FLOP/s on them (the least time
    for bf16 attention, whatever a kernel uses)."""
    from repro_torch.common.hw import H100_SXM
    return H100_SXM


def bound_ms(nbytes, flops, flops_per_s=None):
    """The least time the card could take: bytes over the HBM rate or
    FLOPs over ``flops_per_s`` (default: the FP32 rate), the card's
    roofline with no collective term."""
    from repro_torch.common.hw import roofline_terms
    spec = chip_spec()
    terms = roofline_terms(flops, nbytes, 0.0, chip=spec,
                           flops_per_s=flops_per_s or spec.peak_fp32_flops)
    return terms["bound_s"] * 1e3, \
        ("bytes" if terms["memory_s"] >= terms["compute_s"]
         else "operations")


#: the parent commit's float32 flash kernel (``--parent DIR``), or None
PARENT_FLASH = None


def load_parent_flash(checkout):
    """Build ``flash_attention.cu`` of another checkout (for example an
    unpacked ``git archive`` of the parent commit) into this checkout's
    build directory and return a function that runs it on the float32
    route: the "before" kernel, timed in the same process and on the same
    card as this one. Its C entry point must have this one's signature."""
    import ctypes
    from repro_torch.kernels import build
    src = os.path.join(os.path.abspath(checkout), "src", "repro_torch",
                       "kernels", "csrc", "flash_attention.cu")
    out_dir = build.BUILD_ROOT / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = str(out_dir / "libflash_attention_parent.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(lib).repro_flash_attention
    fn.argtypes = build.SIGNATURES["flash_attention"]
    fn.restype = ctypes.c_int

    def run(q, k, v, causal):
        import torch
        B, S, H, D = q.shape
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, k.shape[2], D, int(causal), 0,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the parent's flash kernel: cudaError {err}")
        return out
    return run


def parent_lines(label, kern, q, k, v, causal):
    """The parent's kernel against this one on the same inputs, timed in
    turns (parent, this, this, parent), on lines of their own."""
    import torch
    if PARENT_FLASH is None:
        return
    old = lambda: PARENT_FLASH(q, k, v, causal)
    diff = (old() - kern()).abs().max().item()
    times = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        times[who].append(cuda_ms(old if who == "parent" else kern))
    torch.cuda.synchronize()
    print(f"parent kernel at {label}: parent {times['parent']} ms, this "
          f"kernel {times['this']} ms (interleaved; max diff {diff}); "
          f"speedup {min(times['parent']) / min(times['this'])}")


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
             ((2, 100, *heads), f32, False),
             # head dims 48 (the `small` ViT's) and 80 (zamba2's)
             ((2, 256, 8, 2, 48), f32, True),
             ((2, 100, 8, 2, 80), f32, False),
             ((2, 130, 4, 4, 48), bf16, True)]
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
    spec = chip_spec()
    for dtype, flops_per_s in ((bf16, spec.peak_bf16_flops),
                               (f32, spec.peak_fp32_flops)):
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
        if dtype == f32:
            parent_lines(f"{path} float32 causal", kern, q, k, v, True)
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


VIT_MODEL = "100m"            # the example's ViT-100m, full width and depth
VIT_BATCH = 16
VIT_HW = (64, 64)
VIT_STEPS = 6                 # the pipeline run: async save after step 3
VIT_SAVE_EVERY = 3
VIT_RESTART_STEPS = 2
VIT_LEARN_STEPS = 20
VIT_SHARE_STEPS = 4
VIT_WORKERS = 2
VIT_SWITCH_INTERVAL_S = 5e-4
VIT_LOSS_RTOL = 1e-5          # kernel route against the plain route
# the learn check's learning rate: the reference's default (3e-4), with
# the example's warmup; at the example's 1e-3 ViT-100m's loss on one
# batch falls in the first steps and then oscillates (PERF.md §6)
VIT_LEARN_LR = 3e-4
VIT_GRAD_TOL = 1e-4           # of each gradient leaf's largest |element|
VIT_SMALL_MODEL = "small"     # the trainer's default: 6 layers, head dim 48
VIT_SMALL_STEPS = 3
PHASE8_WATCHDOG_S = 600


def phase_training(corpus):
    import faulthandler
    print("== phase 8: ViT training fed by the loader")
    held_report("phase 8")
    # a hang (a loader or prefetch thread that never ends) fails the run
    # with every thread's traceback instead of running out the clock
    faulthandler.dump_traceback_later(PHASE8_WATCHDOG_S, exit=True)
    try:
        return _training_checks(corpus)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _vit_attention(cfg):
    """The float32 flash kernel at the ViT's attention shape: forward and
    the gradient of its autograd Function against the plain version,
    then its time beside the plain version's, SDPA's and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    B = VIT_BATCH
    shape = (B, cfg.num_patches, cfg.num_heads, cfg.num_kv_heads,
             cfg.head_dim)
    f32 = torch.float32
    tol = FLASH_TOL["float32"]
    q, k, v = _flash_inputs(shape, f32, seed=8)
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    check(ops.LAUNCHES == {**before, "flash_attention":
                           before["flash_attention"] + 1},
          f"flash_attention at the ViT shape launched "
          f"{ {n: ops.LAUNCHES[n] - before[n] for n in before} }")
    want = ref.flash_attention(q, k, v, False)
    diff = (got - want).abs()
    err = diff.max().item()
    typical = want.abs().median().item()
    bad = int((diff > tol + tol * want.abs()).sum())
    print(f"flash_attention {shape} float32 full: max_abs_err {err} "
          f"(rtol=atol={tol}; median |out| {typical}), {bad} over")
    check(typical > 10 * tol and bad == 0,
          f"flash_attention at the ViT shape: {bad} elements outside "
          f"rtol=atol={tol} (median |out| {typical})")
    g = torch.Generator(device=DEV).manual_seed(9)
    dout = torch.randn(q.shape, generator=g, device=DEV)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    out = ops.flash_attention(*leaves, causal=False)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    check(ops.LAUNCHES["flash_attention"] == 1 and
          sum(ops.LAUNCHES.values()) == 1,
          f"the gradient's forward launched {ops.LAUNCHES}")
    plain = torch.autograd.grad(ref.flash_attention(*leaves, False), leaves,
                                dout)
    for name, a, b in zip("qkv", grads, plain):
        d = (a - b).abs()
        over = int((d > tol + tol * b.abs()).sum())
        print(f"  d{name}: max_abs_err {d.max().item()} against autograd "
              f"through the plain version (max |d{name}| "
              f"{b.abs().max().item()}), {over} over rtol=atol={tol}")
        check(over == 0 and b.abs().max().item() > 10 * tol,
              f"d{name} of the flash Function: {over} elements outside "
              f"rtol=atol={tol}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=False))
    plain_ms = cuda_ms(lambda: ref.flash_attention(q, k, v, False), iters=5)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    grad_ms = cuda_ms(lambda: ops._flash_attention_grad(q, k, v, dout,
                                                        False), iters=5)
    nbytes, flops = flash_work(*shape, False, 4)
    b_ms, b_by = bound_ms(nbytes, flops)
    row = {"name": "flash_attention", "shape": list(shape),
           "dtype": "float32", "causal": False, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": library_ms,
           "backward_plain_ms": grad_ms}
    print(f"flash_attention at the ViT shape {shape} float32: ms {ms} "
          f"plain_ms {plain_ms} library_ms {library_ms} (SDPA float32) "
          f"bound_ms {b_ms} ({b_by}: {nbytes} B, {flops} FLOP); its "
          f"backward (plain float32 math) {grad_ms} ms")
    if cfg.head_dim in (16, 32, 64, 128):      # the parent's head dims
        parent_lines(f"the ViT shape {shape} float32 full",
                     lambda: ops.flash_attention(q, k, v, causal=False),
                     q, k, v, False)
    return row


def _small_vit(batch):
    """The trainer's default ViT (``small``: 6 layers, 4 heads of 48) on
    one batch: the kernel at its attention shape (forward, gradient, time
    beside SDPA and the bound), one step's loss and gradients through the
    kernel against the plain loop, and a few train steps, each forward one
    ``flash_attention`` launch per layer."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train import vision_pipeline as vp
    cfg = vp.MODELS[VIT_SMALL_MODEL]
    print(f"ViT-{VIT_SMALL_MODEL}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}")
    row = _vit_attention(cfg)
    state = vp.init_state(cfg, 5, torch.device(DEV))
    _routes_agree(cfg, state, batch)
    losses = []
    for _ in range(VIT_SMALL_STEPS):
        ops.reset_launches()
        state, metrics = vp.train_step(state, batch, cfg, vp.OPT, vp.CTX)
        torch.cuda.synchronize()
        check(ops.LAUNCHES["flash_attention"] == cfg.num_layers and
              sum(ops.LAUNCHES.values()) == cfg.num_layers,
              f"a ViT-{VIT_SMALL_MODEL} step launched {ops.LAUNCHES}, want "
              f"{cfg.num_layers} flash_attention")
        losses.append(metrics["loss"].item())
    check(np.isfinite(losses).all(), f"ViT-{VIT_SMALL_MODEL} losses {losses}")
    print(f"ViT-{VIT_SMALL_MODEL}: {VIT_SMALL_STEPS} steps on one batch, "
          f"{cfg.num_layers} flash_attention launches each; losses {losses}")
    row.update(launches_per_step=cfg.num_layers)
    return row


def _vit_batch(corpus):
    """The corpus's first ``VIT_BATCH`` images, decoded by ``cuda-batch``
    and fitted to the ViT's input, with their labels, on the card."""
    import numpy as np
    import torch
    from repro_torch.codecs import open_decoder
    from repro_torch.data.loader import center_fit
    files = corpus.files[:VIT_BATCH]
    outs = open_decoder("cuda-batch").decode_batch(files)
    check(all(o.ok for o in outs), "cuda-batch failed the ViT batch")
    images = np.stack([center_fit(o.image, *VIT_HW) for o in outs])
    return {"image": torch.from_numpy(images).to(DEV),
            "label": torch.tensor(corpus.labels[:VIT_BATCH],
                                  dtype=torch.int32, device=DEV)}


def _routes_agree(cfg, state, batch):
    """One train step's loss and gradients through the flash kernel
    against the plain attention loop, from the same state and batch."""
    import dataclasses
    import functools
    import torch
    from repro_torch import tree
    from repro_torch.train import vision_pipeline as vp
    out = {}
    for route, ctx in (("kernel", vp.CTX), ("plain", dataclasses.replace(
            vp.CTX, flash_kernel=False))):
        (metrics, grads), launches, dt = drive(
            f"ViT loss and gradients, {route} route",
            functools.partial(vp.loss_and_grads, state["params"], batch,
                              cfg, ctx))
        out[route] = (metrics["loss"].item(), tree.flatten_with_names(grads),
                      launches, dt)
    (k_loss, k_grads, k_launches, k_s), (p_loss, p_grads, p_launches, p_s) \
        = out["kernel"], out["plain"]
    check(k_launches["flash_attention"] == cfg.num_layers and
          sum(k_launches.values()) == cfg.num_layers,
          f"the kernel route launched {k_launches}, want "
          f"{cfg.num_layers} flash_attention")
    check(sum(p_launches.values()) == 0,
          f"the plain route launched {p_launches}")
    rel = abs(k_loss - p_loss) / abs(p_loss)
    worst, worst_name = 0.0, ""
    for name, want in p_grads.items():
        got = k_grads[name]
        scale = want.abs().max().item()
        check(scale > 0 and torch.isfinite(got).all().item(),
              f"gradient {name}: max |g| {scale}")
        r = (got - want).abs().max().item() / scale
        if r >= worst:
            worst, worst_name = r, name
    print(f"ViT step, kernel route against plain route: loss {k_loss} vs "
          f"{p_loss} (relative {rel}, limit {VIT_LOSS_RTOL}); worst "
          f"gradient leaf {worst_name} at {worst} of its max |g| (limit "
          f"{VIT_GRAD_TOL}) over {len(p_grads)} leaves; forward+backward "
          f"{k_s} s kernel route, {p_s} s plain route (first calls)")
    check(rel <= VIT_LOSS_RTOL, f"ViT loss differs by {rel} relative")
    check(worst <= VIT_GRAD_TOL, f"ViT gradient {worst_name} differs by "
                                 f"{worst} of its max")


def _steps_on_one_batch(cfg, state, batch, opt_cfg):
    """``VIT_LEARN_STEPS`` train steps on ``batch``: (state, losses,
    seconds per step, flash_attention launches)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train import vision_pipeline as vp
    losses, seconds = [], []
    ops.reset_launches()
    for _ in range(VIT_LEARN_STEPS):
        t0 = time.perf_counter()
        state, metrics = vp.train_step(state, batch, cfg, opt_cfg, vp.CTX)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
    return state, losses, seconds, ops.LAUNCHES["flash_attention"]


def _learns(cfg, state, batch):
    """``VIT_LEARN_STEPS`` train steps on one batch already on the card:
    the mean of the last 5 losses must fall below 0.8x the first 5's
    (tests/test_system.py's bar), at ``VIT_LEARN_LR``. The same steps at
    the example's ``vp.OPT`` are printed first, unchecked. Then where a
    step's time goes: forward+backward, then AdamW."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.train import vision_pipeline as vp
    from repro_torch.train.optimizer import adamw_update
    runs = ((f"the example's lr {vp.OPT.lr}", vp.OPT, False),
            (f"lr {VIT_LEARN_LR}",
             dataclasses.replace(vp.OPT, lr=VIT_LEARN_LR), True))
    for label, opt_cfg, checked in runs:
        end, losses, seconds, flash = _steps_on_one_batch(cfg, state, batch,
                                                          opt_cfg)
        first = float(np.mean(losses[:5]))
        last = float(np.mean(losses[-5:]))
        print(f"{VIT_LEARN_STEPS} steps on one batch at {label} "
              f"(warmup {opt_cfg.warmup_steps}): losses {losses}; mean of "
              f"the first 5 {first}, of the last 5 {last}; flash_attention "
              f"launched {flash} times")
        check(np.isfinite(losses).all(), f"non-finite loss at {label}")
        check(flash == VIT_LEARN_STEPS * cfg.num_layers,
              f"flash_attention launched {flash} times in "
              f"{VIT_LEARN_STEPS} steps")
        if checked:
            check(last < 0.8 * first, f"the ViT did not learn at {label}: "
                                      f"{first} -> {last} (bar 0.8x)")
    fb, opt = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        _, grads = vp.loss_and_grads(end["params"], batch, cfg, vp.CTX)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        adamw_update(grads, end["opt"], end["params"], end["step"], vp.OPT)
        torch.cuda.synchronize()
        fb.append(t1 - t0)
        opt.append(time.perf_counter() - t1)
        del grads
    print(f"train step: {float(np.mean(seconds[1:])) * 1e3} ms mean over "
          f"steps 2-{VIT_LEARN_STEPS} (first {seconds[0] * 1e3} ms); "
          f"forward+backward {float(np.median(fb)) * 1e3} ms, AdamW "
          f"{float(np.median(opt)) * 1e3} ms (medians of 3)")


def _pipeline_loader(corpus, path, workers, batch_decode_fn=None):
    from repro_torch.codecs import get_decoder
    from repro_torch.data.loader import DataLoader, LoaderConfig
    cfg = LoaderConfig(batch_size=VIT_BATCH, num_workers=workers,
                       mode="thread",
                       decode_batch=LOADER_CHUNK if path == "cuda-batch"
                       else 0, target_hw=VIT_HW, shuffle=True,
                       drop_remainder=True)
    if batch_decode_fn is None:
        return DataLoader(corpus.files, corpus.labels, cfg=cfg,
                          path_name=path)
    return DataLoader(corpus.files, corpus.labels, cfg=cfg,
                      decode_fn=get_decoder(path).fn,
                      batch_decode_fn=batch_decode_fn)


def _quiesce(before, timeout=120.0):
    """Wait until every thread started since ``before`` has ended: the
    prefetch producer and the loader's workers run ahead of the trainer
    and finish their last chunk after it stops."""
    import threading
    deadline = time.monotonic() + timeout
    while True:
        extra = [t for t in threading.enumerate() if t not in before]
        if not extra:
            return
        check(time.monotonic() < deadline,
              f"threads still running {timeout} s after training: "
              f"{[t.name for t in extra]}")
        gc.collect()
        time.sleep(0.05)


def _share_line(label, rep, steps):
    print(f"{label}: {steps} steps, step {rep['step_s'] / steps * 1e3} ms "
          f"mean (synchronised), data wait {rep['data_s']} s, "
          f"input-pipeline share {rep['share']}; losses {rep['losses']}")


def _training_checks(corpus):
    import tempfile
    import threading
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.codecs import get_decoder
    from repro_torch.data import autotune_workers
    from repro_torch.data.loader import DataLoader, LoaderConfig
    from repro_torch.jpeg import parser as P
    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    from repro_torch.train import vision_pipeline as vp
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device(DEV)
    cfg = vp.MODELS[VIT_MODEL]
    state0 = vp.init_state(cfg, 0, dev)
    n_params = sum(t.numel() for t in tree.leaves(state0["params"]))
    print(f"ViT-{VIT_MODEL}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, {cfg.num_patches} patches of {cfg.patch}x"
          f"{cfg.patch} at {cfg.image_hw}, {cfg.num_classes} classes, "
          f"{n_params} parameters in float32, batch {VIT_BATCH}")

    row = _vit_attention(cfg)
    batch = _vit_batch(corpus)
    _routes_agree(cfg, state0, batch)
    _learns(cfg, state0, batch)
    small_row = _small_vit(batch)
    del batch

    # the pipeline: cuda-batch in two loader threads, chunks of 8, through
    # prefetch_to_device into the trainer, async save after step 3
    comps = {f: len(P.parse(f, headers_only=True).components)
             for f in corpus.files}
    spec = get_decoder("cuda-batch")
    colour = {"images": 0}
    lock = threading.Lock()

    def counted(datas):
        out = spec.decode_batch(datas)
        with lock:
            colour["images"] += sum(comps[d] == 3 for d in datas)
        return out

    tmp = tempfile.TemporaryDirectory()
    try:
        mgr = CheckpointManager(tmp.name, keep=2)
        tracer = trace.Tracer()
        before = set(threading.enumerate())
        torch.cuda.synchronize()
        ops.reset_launches()
        with trace.use_tracer(tracer):
            state, rep = vp.train(
                state0, _pipeline_loader(corpus, "cuda-batch", VIT_WORKERS,
                                         counted),
                steps=VIT_STEPS, cfg=cfg, mgr=mgr,
                save_every=VIT_SAVE_EVERY, log_every=1)
            _quiesce(before)
        launches = dict(ops.LAUNCHES)
        spans = sum(e.get("ph") == "X" and e["name"] == "jpeg.dequant_idct"
                    for e in tracer.events())
        print(f"pipeline launches {launches}; jpeg.dequant_idct spans "
              f"{spans}; colour images decoded {colour['images']} (the "
              f"loader decodes ahead of the trainer)")
        _share_line("cuda-batch pipeline (2 threads, chunks of 8)", rep,
                    VIT_STEPS)
        check(np.isfinite(rep["losses"]).all() and
              len(rep["losses"]) == VIT_STEPS, f"losses {rep['losses']}")
        check(int(state["step"]) == VIT_STEPS, "step counter")
        check(launches["flash_attention"] == VIT_STEPS * cfg.num_layers,
              f"flash_attention launched {launches['flash_attention']} "
              f"times in {VIT_STEPS} steps")
        check(launches["decode_batch"] == spans and spans >= 1,
              f"decode_batch launched {launches['decode_batch']} times "
              f"for {spans} jpeg.dequant_idct spans")
        check(launches["ycbcr2rgb"] == colour["images"] >= 1,
              f"ycbcr2rgb launched {launches['ycbcr2rgb']} times for "
              f"{colour['images']} colour images")
        check(sum(launches.values()) == launches["flash_attention"] +
              launches["decode_batch"] + launches["ycbcr2rgb"],
              f"other kernels launched: {launches}")
        check(mgr.steps() == [VIT_SAVE_EVERY, VIT_STEPS],
              f"checkpoints {mgr.steps()}")

        # restart: a new loader and state from the latest checkpoint
        like = vp.init_state(cfg, 1, dev)
        step, restored, extra = mgr.restore_latest(like=like)
        del like
        check(step == VIT_STEPS, f"restored step {step}")
        for name, t in tree.flatten_with_names(state).items():
            check(torch.equal(tree.flatten_with_names(restored)[name], t),
                  f"restored leaf {name} differs from the trained state")
        loader = _pipeline_loader(corpus, "cuda-batch", VIT_WORKERS)
        loader.restore(extra["loader"])
        before = set(threading.enumerate())
        state2, rep2 = vp.train(restored, loader,
                                steps=VIT_STEPS + VIT_RESTART_STEPS,
                                cfg=cfg, mgr=mgr, log_every=1)
        _quiesce(before)
        check(int(state2["step"]) == VIT_STEPS + VIT_RESTART_STEPS,
              f"after the restart the step counter reads "
              f"{int(state2['step'])}")
        check(np.isfinite(rep2["losses"]).all(), "non-finite loss after "
                                                 "the restart")
        # a loader that was never stopped (same order; images not decoded)
        steady = DataLoader(corpus.files, corpus.labels,
                            cfg=LoaderConfig(batch_size=VIT_BATCH,
                                             target_hw=VIT_HW, shuffle=True,
                                             drop_remainder=True),
                            decode_fn=lambda data: np.zeros(
                                (8, 8, 3), np.uint8))
        want = []
        while len(want) < VIT_STEPS + VIT_RESTART_STEPS:
            want += [b["label"] for b in steady]
        got = rep["labels"] + rep2["labels"]
        for i, (g, w) in enumerate(zip(got, want)):
            check(np.array_equal(g, w), f"batch {i + 1} labels {g}, a loader "
                                        f"never stopped gives {w}")
        print(f"restart: resumed at step {step}, trained to "
              f"{int(state2['step'])}; the {len(got)} batches' labels equal "
              f"those of a loader never stopped; losses {rep2['losses']}")
        del state, restored, state2
    finally:
        tmp.cleanup()

    # the same pipeline at a 0.5 ms interpreter switch interval: the
    # eager step needs the interpreter lock for each of its launches
    # while the loader's threads run the host decode in Python
    default_interval = sys.getswitchinterval()
    before = set(threading.enumerate())
    sys.setswitchinterval(VIT_SWITCH_INTERVAL_S)
    try:
        _, rep4 = vp.train(vp.init_state(cfg, 3, dev),
                           _pipeline_loader(corpus, "cuda-batch",
                                            VIT_WORKERS),
                           steps=VIT_SHARE_STEPS, cfg=cfg, log_every=1)
    finally:
        sys.setswitchinterval(default_interval)
    _quiesce(before)
    check(np.isfinite(rep4["losses"]).all(), "non-finite loss at a short "
                                             "switch interval")
    _share_line(f"cuda-batch pipeline at a {VIT_SWITCH_INTERVAL_S * 1e3} ms "
                f"switch interval (default {default_interval * 1e3} ms)",
                rep4, VIT_SHARE_STEPS)

    # the share under numpy-fast, autotuned as the trainer does
    tuned = autotune_workers(
        lambda w: _pipeline_loader(corpus, "numpy-fast", w),
        candidates=(0, 2, 4), max_items=VIT_BATCH, repeats=1)
    print(f"autotune_workers (numpy-fast): best {tuned['best']} sweep "
          f"{tuned['sweep']}")
    before = set(threading.enumerate())
    ops.reset_launches()
    _, rep3 = vp.train(vp.init_state(cfg, 2, dev),
                       _pipeline_loader(corpus, "numpy-fast", tuned["best"]),
                       steps=VIT_SHARE_STEPS, cfg=cfg, log_every=1)
    _quiesce(before)
    _share_line(f"numpy-fast pipeline ({tuned['best']} threads)", rep3,
                VIT_SHARE_STEPS)
    check(np.isfinite(rep3["losses"]).all(), "non-finite numpy-fast loss")
    check(ops.LAUNCHES["flash_attention"] == VIT_SHARE_STEPS *
          cfg.num_layers and ops.LAUNCHES["decode_batch"] == 0,
          f"numpy-fast pipeline launches {ops.LAUNCHES}")
    row.update(launches=launches["flash_attention"],
               launches_per_step=cfg.num_layers)
    print(json.dumps({"vit_flash_attention": row,
                      "vit_small_flash_attention": small_row}))
    print(f"phase 8: peak device memory {torch.cuda.max_memory_allocated()}"
          f" bytes; {time.perf_counter() - t_phase} s")
    return {"flash_attention": launches["flash_attention"],
            "decode_batch": launches["decode_batch"],
            "ycbcr2rgb": launches["ycbcr2rgb"]}


PHASE9_WATCHDOG_S = 600
#: the JPEG kernels the sweep's cuda-* cells must launch: cuda-batch ->
#: decode_batch, cuda-fused -> dequant_idct, cuda-idct and strict-cuda ->
#: idct8x8, every colour image -> ycbcr2rgb
BENCH_KERNELS = ("decode_batch", "dequant_idct", "idct8x8", "ycbcr2rgb")
#: the sweep's cuda-* paths, each held image by image to its own plain
#: versions on the host over the smoke profile's three corpora
BENCH_PATHS = ("cuda-batch", "cuda-fused", "cuda-idct", "strict-cuda")


def phase_bench():
    import faulthandler
    print("== phase 9: the bench harness's smoke sweep on the card")
    held_report("phase 9")
    # a hang (a forked loader worker stuck on a lock held at fork) fails
    # the run with every thread's traceback instead of running out the
    # clock
    faulthandler.dump_traceback_later(PHASE9_WATCHDOG_S, exit=True)
    try:
        return _bench_checks()
    finally:
        faulthandler.cancel_dump_traceback_later()


def _bench_cli(argv):
    """``repro_torch.bench.cli.main(argv)`` with its output kept off the
    log but for its last line; returns (exit code, last line)."""
    import contextlib
    import io
    from repro_torch.bench import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(argv)
    lines = buf.getvalue().strip().splitlines()
    return code, lines[-1] if lines else ""


def _bench_checks():
    import tempfile
    import torch
    from repro_torch.bench import PROFILES, build_registry, run_sweep
    from repro_torch.bench.registry import KIND_SINGLE
    from repro_torch.core import decision, report
    t_phase = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    power_limit = smi_line().rsplit(",", 1)[1].strip()
    prof = PROFILES["smoke"]
    runs = {s.name for s in build_registry() if prof.wants(s)[0]}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bench")
        res, launches, dt = drive(
            "smoke sweep (python -m repro_torch.bench sweep --smoke "
            "--trace)", lambda: run_sweep("smoke", out_dir=out, trace=True))
        by = {r.scenario: r for r in res.records}
        counts = {}
        for r in res.records:
            counts[r.status] = counts.get(r.status, 0) + 1
        print(f"smoke sweep: {len(res.records)} records {counts}, "
              f"{len(runs)} cells in the profile, elapsed {res.elapsed_s} "
              f"s, {len(res.files)} artifacts")
        errors = [(r.scenario, r.meta.get("reason")) for r in res.records
                  if r.status == "error"]
        check(not errors, f"sweep cells failed: {errors}")
        for r in res.records:
            if r.ok:
                check(r.platform == card and r.throughput_mean > 0 and
                      "stage_s" in r.meta,
                      f"{r.scenario}: platform {r.platform!r}, "
                      f"{r.throughput_mean} images/s, traced "
                      f"{'stage_s' in r.meta}")
            cuda_single = r.protocol == KIND_SINGLE and \
                "cuda" in r.decoder and r.scenario in runs
            if cuda_single and not r.ok:
                check(r.status == "skipped" and
                      r.meta.get("eligible") is False and
                      r.meta.get("reason"),
                      f"{r.scenario} is neither ok nor a capability skip: "
                      f"{r.to_json()}")
        for name in ("cuda-idct", "cuda-fused", "cuda-batch",
                     "strict-cuda"):
            check(by[f"single/{name}"].ok, f"single/{name} did not run")
        check(by["single/cuda-fused/corpus-mixed"].ok,
              "single/cuda-fused/corpus-mixed did not run")
        fork = by["loader/cuda-batch/w2/process"]
        check(fork.status == "skipped" and fork.samples == [] and
              "fork" in fork.meta.get("reason", ""),
              f"loader/cuda-batch/w2/process: {fork.to_json()}")
        shard = by["loader/numpy-fast/w2/process/shard"]
        mem = by["loader/numpy-fast/w2/process"]
        check(shard.ok and mem.ok and shard.num_images == mem.num_images
              == prof.corpus_n and shard.meta["delivered"] ==
              mem.meta["delivered"] == prof.corpus_n,
              f"shard cell {shard.to_json()} against its memory twin "
              f"{mem.to_json()}")
        batched = by["batched/cuda-batch"]
        check(batched.ok, f"batched/cuda-batch: {batched.to_json()}")
        moved = {k: launches[k] for k in BENCH_KERNELS}
        check(all(n >= 1 for n in moved.values()),
              f"a JPEG kernel did not launch in the sweep: {moved}")
        with open(os.path.join(out, "summary_smoke.json")) as f:
            summary = json.load(f)
        host = summary["host"]
        check(host["device"] == card and host["power_limit"] ==
              power_limit, f"summary host {host}, want {card} at "
                           f"{power_limit}")
        print(f"summary host: device {host['device']}, power limit "
              f"{host['power_limit']}, torch {host['torch']}, CUDA "
              f"{host['cuda']}, fingerprint {host['fingerprint']}")
        for r in res.records:
            if r.ok:
                print(json.dumps({"record": r.scenario,
                                  "images_s": r.samples,
                                  "mean": r.throughput_mean,
                                  "skips": r.skip_indices}))
        print(f"batched/cuda-batch: batched {batched.throughput_mean} "
              f"images/s, serial {batched.meta['serial_ips']}, "
              f"batched/serial {batched.meta['ratio']} over "
              f"{batched.meta['n_buckets']} buckets; stage s "
              f"{batched.meta['stage_s']}")
        live = res.ok_records()
        print(report.single_thread_report(live))
        print(report.loader_report(live))
        print(report.flip_report(
            decision.recommend(res.records)["protocol_disagreement"]))

        records = res.files[0]
        store = os.path.join(tmp, "history.jsonl")
        for argv in (["compare", records, records],
                     ["history", "append", records, "--store", store,
                      "--profile", "smoke"],
                     ["history", "show", "--store", store],
                     ["compare", records, records, "--attribute",
                      "--history", store]):
            code, last = _bench_cli(argv)
            check(code == 0, f"bench cli {argv[:2]} exited {code}: {last}")
            print(f"bench cli {' '.join(argv[:2])}: exit 0; {last}")
    _bench_kernel_checks(prof)
    print(f"phase 9: {time.perf_counter() - t_phase} s (sweep {dt} s)")
    return moved


def _smoke_corpora(prof):
    """The corpora the smoke profile's cells decode: the baseline and
    the corpus axis's mixed and progressive variants (as the harness
    builds them)."""
    from repro_torch.jpeg.corpus import build_corpus
    dri = list(prof.corpus_dri) or None
    return {kind: build_corpus(prof.corpus_n, seed=prof.corpus_seed,
                               restart_intervals=dri, progressive=frac)
            for kind, frac in (("baseline", 0.0), ("mixed", 0.5),
                               ("progressive", 1.0))}


def _capture_kernel_inputs(calls):
    """Wrap the JPEG kernels' wrappers (module attributes the paths look
    up at each call) so every call's inputs are kept in ``calls[name]``;
    returns a function that puts the wrappers back."""
    from repro_torch.kernels import ops
    saved = {name: getattr(ops, name) for name in BENCH_KERNELS}

    def wrap(name):
        def call(*args):
            calls[name].append(tuple(a.clone() for a in args))
            return saved[name](*args)
        return call
    for name in BENCH_KERNELS:
        setattr(ops, name, wrap(name))

    def restore():
        for name, fn in saved.items():
            setattr(ops, name, fn)
    return restore


def _bench_kernel_checks(prof):
    """The sweep checks statuses, not pixels: hold what its cuda-* paths
    compute at the smoke size to the plain versions. Each corpus goes
    through each path on the card (one batched call, then image by
    image) and the same path on the host; then every kernel wrapper is
    held to its plain version on the very inputs those decodes gave it."""
    import numpy as np
    import torch
    from repro_torch.codecs import ExecContext, open_decoder
    from repro_torch.device import use_device
    from repro_torch.kernels import ops, ref
    svc = ExecContext.SERVICE
    ref_sess = open_decoder("numpy-ref", context=svc)
    calls = {name: [] for name in BENCH_KERNELS}
    summary = []
    for kind, corpus in _smoke_corpora(prof).items():
        files, rare = corpus.files, corpus.rare_index
        refs = [ref_sess.decode(f) for f in files]
        for name in BENCH_PATHS:
            restore = _capture_kernel_inputs(calls)
            try:
                sess = open_decoder(name, context=svc)
                outs = sess.decode_batch(files)
                serial = [sess.decode(f) for f in files]
            finally:
                restore()
            with use_device("cpu"):
                plain = open_decoder(name, context=svc).decode_batch(files)
            worst = 0
            for i, (o, one, p, want) in enumerate(
                    zip(outs, serial, plain, refs)):
                label = f"{name} on the {kind} corpus, image {i}"
                check(o.kind == one.kind == p.kind,
                      f"{label}: {o.kind} batched, {one.kind} serial on "
                      f"the card, {p.kind} on the host ({o.reason})")
                if not o.ok:
                    continue
                check(np.array_equal(o.image, one.image),
                      f"{label}: batched output differs from serial")
                check(o.image.shape == p.image.shape and
                      o.image.dtype == np.uint8,
                      f"{label}: shape {o.image.shape} dtype "
                      f"{o.image.dtype}, plain {p.image.shape}")
                vs_plain = int(np.abs(o.image.astype(int) -
                                      p.image.astype(int)).max())
                check(vs_plain <= 1, f"{label}: {vs_plain} levels from "
                                     f"the plain versions on the host")
                if want.ok:
                    err = int(np.abs(o.image.astype(int) -
                                     want.image.astype(int)).max())
                    plain_err = int(np.abs(p.image.astype(int) -
                                           want.image.astype(int)).max())
                    tol = 16 if i == rare else 4
                    check(err <= max(tol, plain_err),
                          f"{label}: {err} levels from numpy-ref (limit "
                          f"{tol}; the plain versions on the host: "
                          f"{plain_err})")
                worst = max(worst, vs_plain)
            summary.append((kind, name, sum(o.ok for o in outs),
                            sum(o.kind == "skip" for o in outs), worst))
    print("smoke corpora on the card vs the same paths' plain versions on "
          "the host (corpus, path, ok, skipped, max levels): "
          f"{summary}")

    plain_fns = {
        "decode_batch": ref.decode_batch,
        "dequant_idct": ref.dequant_idct,
        "idct8x8": ref.idct8x8,
        "ycbcr2rgb": lambda y, cb, cr: torch.stack(
            ref.ycbcr2rgb(y, cb, cr), dim=-1),
    }
    for name in BENCH_KERNELS:
        seen = calls[name]
        check(seen, f"{name}: the smoke corpora's decodes never called it")
        err, shapes = 0.0, set()
        for args in seen:
            check(all(a.device.type == DEV for a in args),
                  f"{name} was called with host tensors on the card path")
            got = getattr(ops, name)(*args)
            want = plain_fns[name](*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            err = max(err, (got - want).abs().max().item())
            shapes.add(tuple(args[0].shape))
        rows = sorted(sh[0] for sh in shapes)
        print(f"{name} at the smoke corpora's inputs: {len(seen)} calls, "
              f"{len(shapes)} shapes (first dim {rows[0]}-{rows[-1]}), "
              f"max_abs_err {err} (rtol {RTOL}, atol {ATOL})")


PHASE10_WATCHDOG_S = 600
#: the views the reference's ``run.py tables`` prints, by the first word
#: of their rows' names (the kernel view's rows begin with ``kernel.``)
TABLE_ROW_PREFIX = {"table1": "table1", "table2": "table2",
                    "table3": "table3", "table4": "table4",
                    "table5": "table5", "fig3": "fig3", "kernels": "kernel",
                    "roofline": "roofline", "service": "service"}
#: where the reference's TPU dry-run artifacts live; the port's views must
#: never read them (the port's roofline reads artifacts/dryrun_torch/)
REF_DRYRUN = os.path.join(ROOT, "artifacts", "dryrun")
_REF_DRYRUN_SEEN = []
_AUDIT_ON = False


def _audit_dryrun(event, args):
    """An audit hook: note every open, glob or directory listing of a path
    under the reference's dry-run directory while ``_AUDIT_ON``."""
    if not _AUDIT_ON or event not in ("open", "glob.glob", "os.scandir",
                                      "os.listdir") or not args:
        return
    path = args[0]
    if isinstance(path, (str, bytes, os.PathLike)):
        path = os.path.abspath(os.fsdecode(path))
        if path == REF_DRYRUN or path.startswith(REF_DRYRUN + os.sep):
            _REF_DRYRUN_SEEN.append((event, path))


def phase_tables():
    import faulthandler
    print("== phase 10: the paper-table views (python -m repro_torch.bench "
          "tables) on the card")
    held_report("phase 10")
    # the quick sweep forks numpy-fast and numpy-int loader workers (and
    # the interval-parallel entropy pool) beside a live CUDA context: a
    # hang fails the run with every thread's traceback
    faulthandler.dump_traceback_later(PHASE10_WATCHDOG_S, exit=True)
    try:
        return _tables_checks()
    finally:
        faulthandler.cancel_dump_traceback_later()


def _tables_cli(argv):
    """``repro_torch.bench.cli.main(argv)`` with its standard output
    captured; returns (exit code, every line)."""
    import contextlib
    import io
    from repro_torch.bench import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(argv)
    return code, buf.getvalue().strip().splitlines()


def _spy_views(platforms, launches):
    """Wrap the views' module attributes the CLI calls: each live view's
    ``sweep_records`` notes the platforms of the records it read, and the
    kernel view's ``run`` zeroes the launch counters just before it and
    reads them just after. Returns a function that puts them back."""
    import torch
    from repro_torch.bench.views import VIEWS, kernels_bench
    from repro_torch.kernels import ops
    saved = []
    for name in ("table2", "table3", "table4", "table5", "fig3"):
        mod = VIEWS[name]
        saved.append((mod, "sweep_records", mod.sweep_records))

        def spy(quick=True, _name=name, _read=mod.sweep_records):
            recs = _read(quick)
            platforms[_name] = sorted({r.platform for r in recs})
            return recs
        mod.sweep_records = spy
    saved.append((kernels_bench, "run", kernels_bench.run))

    def run(quick=True, _run=kernels_bench.run):
        torch.cuda.synchronize()
        ops.reset_launches()
        rows = _run(quick)
        torch.cuda.synchronize()
        launches.update(ops.LAUNCHES)
        return rows
    kernels_bench.run = run

    def restore():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return restore


def _check_kernel_rows(label, rows, launches):
    """The kernel view's rows: every JPEG kernel launched, every kernel row
    on the card's route and within phase 2's atol of its plain version
    (max |diff| <= ATOL, which implies the allclose at RTOL), and the
    batched launch equal to the serial per-image loop bit for bit."""
    moved = {k: launches.get(k, 0) for k in BENCH_KERNELS}
    check(all(n >= 1 for n in moved.values()),
          f"{label}: a JPEG kernel did not launch in the kernel view: "
          f"{moved}")
    kernel_rows = [r for r in rows if r.startswith("kernel.")]
    check(not any(".plain" in r.split(",", 1)[0] for r in kernel_rows),
          f"{label}: a kernel row on the plain route: {kernel_rows}")
    errs = {}
    for r in kernel_rows:
        name, _, derived = r.split(",", 2)
        if "max_abs_err=" in derived:
            check(".cuda[" in name, f"{label}: {name} not on the card")
            errs[name] = float(derived.split("max_abs_err=")[1].split()[0])
        if "max_abs_diff_vs_batched=" in derived:
            diff = float(derived.split("max_abs_diff_vs_batched=")[1])
            check(diff == 0.0, f"{label}: decode_batch differs from the "
                               f"serial dequant_idct loop by {diff}")
    check(sorted(n.split(".")[1] for n in errs) ==
          sorted(BENCH_KERNELS),
          f"{label}: kernel rows with an error column: {sorted(errs)}")
    bad = {n: e for n, e in errs.items() if not e <= ATOL}
    check(not bad, f"{label}: kernels beyond atol {ATOL}: {bad}")
    print(f"{label}: kernel view launches {moved}; max_abs_err {errs} "
          f"(atol {ATOL})")
    return moved


def _tables_checks():
    import torch
    from repro_torch.bench.cli import TABLES
    global _AUDIT_ON
    t_phase = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    sys.addaudithook(_audit_dryrun)
    platforms, launches = {}, {}
    restore = _spy_views(platforms, launches)
    _AUDIT_ON = True
    try:
        t0 = time.perf_counter()
        code, lines = _tables_cli(["tables"])
        dt_quick = time.perf_counter() - t0
    finally:
        _AUDIT_ON = False
        restore()
    for line in lines:
        print(f"tables: {line}")
    print(f"tables (quick): exit {code} in {dt_quick} s")
    check(code == 0, f"tables exited {code}")
    check(lines and lines[0] == "name,us_per_call,derived",
          f"tables header: {lines[:1]}")
    rows = lines[1:]
    errors = [r for r in rows if ".ERROR," in r]
    check(not errors, f"views failed: {errors}")
    for view in TABLES:
        prefix = TABLE_ROW_PREFIX[view] + "."
        check(any(r.startswith(prefix) for r in rows),
              f"view {view} printed no row")
    check(platforms.get("table2") == platforms.get("table5") == [card],
          f"the live views read records of {platforms}, want [{card!r}]")
    by_name = {r.split(",", 1)[0]: r for r in rows}
    for name in ("table2.live_single_thread", "table2.live_loader",
                 "table5.live"):
        check(name in by_name and by_name[name].split(",", 2)[2],
              f"no live row {name}: {by_name.get(name)}")
    roof = [r for r in rows if r.startswith("roofline.")]
    check(roof == ["roofline.matrix,0.0,pod ok=0 skipped=0 err=0; "
                   "multipod ok=0"], f"roofline rows: {roof}")
    check(not _REF_DRYRUN_SEEN,
          f"the views read the reference's dry-run: {_REF_DRYRUN_SEEN}")
    quick = _check_kernel_rows("tables (quick)", rows, launches)

    launches.clear()
    restore = _spy_views(platforms, launches)
    try:
        t0 = time.perf_counter()
        code, lines = _tables_cli(["tables", "--full", "--only",
                                   "kernels"])
        dt_full = time.perf_counter() - t0
    finally:
        restore()
    for line in lines:
        print(f"tables --full --only kernels: {line}")
    check(code == 0, f"tables --full --only kernels exited {code}")
    rows = lines[1:]
    check(any("[8192x64]" in r for r in rows) and
          any("[8x2048x64]" in r for r in rows),
          f"the full kernel view's shapes: {rows}")
    full = _check_kernel_rows("tables --full --only kernels", rows,
                              launches)
    print(f"phase 10: {time.perf_counter() - t_phase} s (tables "
          f"{dt_quick} s, --full --only kernels {dt_full} s); records of "
          f"{platforms}")
    return {"quick": quick, "full": full}


LM_TRAIN_ARCH = "qwen2-7b"      # full width; depth cut to fit the card
LM_CHECK_LAYERS = 2             # (a): float32, ~6.2 GB of weights
LM_CHECK_SEQ = 512
LM_TRAIN_LAYERS = 4             # (b): bf16, ~8 GB weights+grads, ~16 GB AdamW
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 2, 2048
LM_TRAIN_STEPS = 6
LM_LOSS_RTOL = 1e-5             # kernel route against the plain loop
LM_GRAD_TOL = 1e-4              # of each gradient leaf's largest |element|


def phase_lm_train():
    """Phase 11: returns the launches of its checks and steps."""
    import torch
    print("== phase 11: LM training at full width")
    held_report("phase 11")
    t_phase = time.perf_counter()
    card = smi_line()
    launches = _lm_routes_agree(card)
    gc.collect()
    for name, n in _lm_train_steps(card).items():
        launches[name] = launches.get(name, 0) + n
    _lm_launcher()
    torch.cuda.synchronize()
    print(f"phase 11: {time.perf_counter() - t_phase} s; launches "
          f"{launches}")
    return launches


def _lm_routes_agree(card):
    """(a): the float32 loss and gradients at full width through the FFMA
    flash kernel against the plain loop, from the same weights and batch."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.train.train_step import loss_and_grads
    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH),
                              num_layers=LM_CHECK_LAYERS, dtype="float32")
    dev = torch.device(DEV)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in tree.leaves(params))
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, LM_CHECK_SEQ + 1)).astype(np.int32)).to(dev)
    print(f"(a) {LM_TRAIN_ARCH} in float32, depth cut from "
          f"{get_config(LM_TRAIN_ARCH).num_layers} to {cfg.num_layers} "
          f"layers: {n_params} parameters, d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}; batch 1 x {LM_CHECK_SEQ}, remat full")
    out = {}
    for route, ctx in (("kernel", ModelContext(remat="full")),
                       ("plain", ModelContext(remat="full",
                                              flash_kernel=False))):
        ((loss, _), grads), launches, dt = drive(
            f"(a) lm_loss and gradients, {route} route",
            lambda ctx=ctx: loss_and_grads(params, {"tokens": tokens}, cfg,
                                           ctx))
        out[route] = (loss.item(), tree.flatten_with_names(grads), launches,
                      dt)
    (k_loss, k_grads, k_launches, k_s), (p_loss, p_grads, p_launches, p_s) \
        = out["kernel"], out["plain"]
    want = 2 * cfg.num_layers
    check(k_launches["flash_attention"] == want and
          sum(k_launches.values()) == want,
          f"(a) the kernel route launched {k_launches}, want {want} "
          f"flash_attention (forward and recompute per layer)")
    check(sum(p_launches.values()) == 0,
          f"(a) the plain route launched {p_launches}")
    rel = abs(k_loss - p_loss) / abs(p_loss)
    worst, worst_name, worst_diff = 0.0, "", 0.0
    for name, want_g in p_grads.items():
        got = k_grads[name]
        scale = want_g.abs().max().item()
        check(scale > 0 and torch.isfinite(got).all().item(),
              f"(a) gradient {name}: max |g| {scale}")
        diff = (got - want_g).abs().max().item()
        if diff / scale >= worst:
            worst, worst_name, worst_diff = diff / scale, name, diff
    print(f"(a) loss kernel route {k_loss}, plain route {p_loss} (relative "
          f"{rel}, limit {LM_LOSS_RTOL}); worst gradient leaf {worst_name}: "
          f"max difference {worst_diff}, {worst} of its max |g| (limit "
          f"{LM_GRAD_TOL}) over {len(p_grads)} leaves; forward+backward "
          f"{k_s} s kernel route, {p_s} s plain route (first calls); peak "
          f"device memory {torch.cuda.max_memory_allocated()} bytes ({card})")
    check(rel <= LM_LOSS_RTOL, f"(a) loss differs by {rel} relative")
    check(worst <= LM_GRAD_TOL,
          f"(a) gradient {worst_name} differs by {worst} of its max")
    return {"flash_attention": k_launches["flash_attention"]}


def _lm_train_steps(card):
    """(b): bf16 training steps at full width, 4 layers."""
    import dataclasses
    import statistics
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression
    from repro_torch.kernels import ops
    from repro_torch.launch.train import token_batches
    from repro_torch.models.layers import ModelContext
    from repro_torch.train import OptimizerConfig
    from repro_torch.train.train_step import make_train_state, make_train_step
    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH),
                              num_layers=LM_TRAIN_LAYERS)
    dev = torch.device(DEV)
    ctx = ModelContext(remat="full", q_chunk=256, k_chunk=256)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=10)   # the launcher's
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(torch.Generator(device=dev).manual_seed(0),
                             cfg, opt_cfg)
    n_params = sum(t.numel() for t in tree.leaves(state["params"]))
    print(f"(b) {LM_TRAIN_ARCH} in {cfg.dtype}, depth cut from "
          f"{get_config(LM_TRAIN_ARCH).num_layers} to {cfg.num_layers} "
          f"layers: {n_params} parameters, AdamW moments in "
          f"{cfg.opt_dtype}; batches of {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} "
          f"tokens, remat full; state {torch.cuda.memory_allocated()} "
          f"bytes")
    first = state["params"]["layers"][0]["attn"]["wq"].clone()
    batches = token_batches(cfg.vocab_size, LM_TRAIN_BATCH, LM_TRAIN_SEQ)

    def run(step_fn, box, n, label):
        """``n`` steps on ``box["state"]``; the box holds the only
        reference to the state, so a step's old state is freed as soon
        as the step returns its new one (two states, not three, at a
        time: ~20 GB each)."""
        ms, losses, gnorms = [], [], []
        torch.cuda.synchronize()
        ops.reset_launches()
        for _ in range(n):
            tokens = torch.from_numpy(next(batches)).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            box["state"], metrics = step_fn(box["state"],
                                            {"tokens": tokens})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
            gnorms.append(metrics["grad_norm"].item())
        launches = dict(ops.LAUNCHES)
        print(f"(b) {label}: losses {losses}, grad norms {gnorms}, step ms "
              f"{ms}, launches {launches}")
        check(all(map(math.isfinite, losses + gnorms)),
              f"(b) {label}: a loss or gradient norm is not finite")
        return ms, launches

    box = {"state": state}
    del state
    step = make_train_step(cfg, ctx, opt_cfg)
    ms, launches = run(step, box, LM_TRAIN_STEPS, f"{LM_TRAIN_STEPS} steps")
    state = box["state"]
    peak = torch.cuda.max_memory_allocated()
    want = LM_TRAIN_LAYERS * 2 * LM_TRAIN_STEPS
    check(launches["flash_attention_wgmma"] == want and
          sum(launches.values()) == want,
          f"(b) launched {launches}, want {want} flash_attention_wgmma "
          f"and no other kernel")
    check(int(state["step"]) == LM_TRAIN_STEPS,
          f"(b) step reads {int(state['step'])}")
    moved = (state["params"]["layers"][0]["attn"]["wq"].float()
             - first.float()).abs().max().item()
    check(moved > 0, "(b) the parameters did not move")
    del first, state
    med = statistics.median(ms[1:])
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    print(f"(b) step {med} ms (median of steps 2-{LM_TRAIN_STEPS}), "
          f"{tokens / med * 1e3} tokens/s, peak device memory {peak} bytes; "
          f"layer 0 wq moved by up to {moved} ({card})")
    total = dict(launches)

    box["state"]["err"] = compression.init_error_buffer(
        box["state"]["params"])
    ms_c, launches = run(
        make_train_step(cfg, ctx, opt_cfg, grad_compression=True), box, 1,
        "one step with int8 gradient compression")
    check(launches["flash_attention_wgmma"] == LM_TRAIN_LAYERS * 2,
          f"(b) the compressed step launched {launches}")
    del box["state"]["err"]
    for name, n in launches.items():
        total[name] += n
    ms_m, launches = run(
        make_train_step(cfg, ctx, opt_cfg, microbatch=1), box, 1,
        f"one step with microbatch=1 ({LM_TRAIN_BATCH} slices)")
    check(launches["flash_attention_wgmma"] ==
          LM_TRAIN_LAYERS * 2 * LM_TRAIN_BATCH,
          f"(b) the microbatched step launched {launches}")
    for name, n in launches.items():
        total[name] += n
    print(f"(b) compressed step {ms_c[0]} ms, microbatched step {ms_m[0]} "
          f"ms; peak device memory over (b) "
          f"{torch.cuda.max_memory_allocated()} bytes ({card})")
    return {name: n for name, n in total.items() if n}


def _lm_launcher():
    """(c): the launcher in a subprocess on the card, then its resume."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.configs import get_config
    from repro_torch.train import OptimizerConfig
    from repro_torch.train.train_step import make_train_state
    os.makedirs(os.path.join(ROOT, "artifacts"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="lm_launcher_",
                            dir=os.path.join(ROOT, "artifacts"))
    env = dict(os.environ, PYTHONPATH=SRC)
    outs = []
    for steps in (6, 9):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "qwen2-7b-smoke", "--steps", str(steps), "--ckpt-every", "3",
             "--ckpt", ckpt], capture_output=True, text=True, timeout=300,
            env=env, cwd=ROOT)
        dt = time.perf_counter() - t0
        for line in (r.stdout + r.stderr).strip().splitlines()[-6:]:
            print(f"(c) --steps {steps}: {line}")
        check(r.returncode == 0, f"(c) the launcher exited {r.returncode}")
        outs.append(r.stdout)
        print(f"(c) --steps {steps}: {dt} s")
    check("resumed from step 6" in outs[1],
          "(c) the second run did not resume from step 6")
    like = make_train_state(
        torch.Generator(device=torch.device(DEV)).manual_seed(1),
        get_config("qwen2-7b-smoke"), OptimizerConfig())
    step_dir = os.path.join(ckpt, "step_6")
    stored, _ = restore_pytree(step_dir)
    restored, _ = restore_pytree(step_dir, like=like)
    flat = tree.flatten_with_names(restored)
    check(set(flat) == set(stored), "(c) restored leaves differ by name")
    for name, t in flat.items():
        check(t.device.type == torch.device(DEV).type,
              f"(c) {name} restored on {t.device}")
        got = t.cpu()
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16)
        check(got.numpy().tobytes() == np.asarray(stored[name]).tobytes(),
              f"(c) restored {name} differs from the stored leaf")
    print(f"(c) step 6 restored on the card equals its {len(flat)} stored "
          f"leaves bit for bit")
    shutil.rmtree(ckpt)


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
    global PARENT_FLASH
    args = sys.argv[1:]
    if "--parent" in args:
        # time the parent's float32 flash kernel beside this one
        PARENT_FLASH = load_parent_flash(args[args.index("--parent") + 1])
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
        training_launches = phase_training(corpus)
        bench_launches = phase_bench()
        tables_launches = phase_tables()
        lm_training_launches = phase_lm_train()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # the float32 flash kernel's main path now includes training
    launches["flash_attention"] += training_launches["flash_attention"]
    # and LM training (phase 11)
    for name, count in lm_training_launches.items():
        launches[name] += count
    for name, count in launches.items():
        if count < 1:
            print(f"chip_smoke: FAILED: {name} never launched on its path",
                  file=sys.stderr)
            return 1
        kernels[name]["launches"] = count
    print(json.dumps({"service_launches": service_launches}))
    print(json.dumps({"loader_launches": loader_launches}))
    print(json.dumps({"training_launches": training_launches}))
    print(json.dumps({"bench_launches": bench_launches}))
    print(json.dumps({"tables_launches": tables_launches}))
    print(json.dumps({"lm_training_launches": lm_training_launches}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
