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
   head_dim 128, causal), ragged S=100 and 129, S=1, phase 20's
   ``serve_lm`` prefill (4 x 32) and ``causal=False``;
   ``flash_attention`` (FFMA) at the float32 cases, head dims 48 and 80
   included, and bf16 at head dim 48; and at the other served models'
   prefills (4 x 2048, causal, bf16): ``deepseek-moe-16b``'s 16/16 heads
   of 128, ``musicgen-medium``'s 24/24 of 64 and
   ``llama-3.2-vision-90b``'s self-attention, 64/8 of 128, on wgmma,
   ``zamba2-2.7b``'s 32/32 of 80 on FFMA; and at the MTP layer of phase
   17's loss (1 x 2047, 128/128 heads of 128, wgmma); and at phase 19's
   training shapes: float32 at 1 x 512 (``deepseek-moe-16b``'s 16/16
   heads of 128, ``zamba2-2.7b``'s 32/32 of 80, ``musicgen-medium``'s
   24/24 of 64, the VLM's 64/8 of 128, the MTP layer's 128/128 of 128 at
   1 x 511) and bf16 at 2 x 2048 (the first three, and the MTP layer at
   2 x 2047); and at phase 23's heads of one rank of two (14/2 of 128:
   bf16 and float32 at 2 x 1024, float32 at 1 x 512; the first two
   timed too). Each against the
   plain PyTorch version on the card, with tests/test_kernels.py's
   tolerances (2e-2 in bf16, 2e-5 in f32), on inputs drawn so that the
   output is of the order of 1 (peaked attention); each call must move
   its own kernel's launch count and no other. Then both kernels' times
   at the prefill's shape (wgmma in bf16, FFMA in float32) and at the
   other served and trained shapes above, beside the plain version's,
   ``scaled_dot_product_attention``'s (a yardstick the port never calls)
   and the bound (the FLOPs at the inputs' type's rate: bf16 tensor-core
   on either route, FP32).
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
   workers at a 0.5 ms interpreter switch interval, once each after the
   main run (once each, so that the whole script ends within its limit
   on a slow host); results are checked the same way, and images/s,
   latency and stage seconds printed beside the main run's.
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
   protocols over 6 of the 33 images (the first 5 and the rare one; 16
   before phase 23, 14 before its FSDP part, 10 before phase 24), labelled with the card's name: ``SingleThreadProtocol`` (2 repeats,
   before and after the sweeps) and ``WorkerSweep`` in thread and
   process mode at workers 0, 2 and 8 (1 repeat), over
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
   ``train`` for 3 steps, with an async save at step 2 and a final
   one:
   finite losses, 12 ``flash_attention`` launches a step,
   ``decode_batch`` launches equal to the ``jpeg.dequant_idct`` spans
   and ``ycbcr2rgb`` launches equal to the colour images decoded (the
   loader decodes ahead of the trainer). A restart builds a new loader
   and state from the latest checkpoint and trains to step 4; every
   batch's labels must be those of a loader never stopped. Then 1 step
   of the same pipeline at a 0.5 ms interpreter switch interval, and 1
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
   repro_torch.launch.train --arch qwen2-7b-smoke``'s entry point in a
   subprocess for 2 steps, then again to 3 in the same one (6 and 9
   before phase 24): it must print
   ``resumed from step 2``, and the step-2 checkpoint restored on the
   card must equal its stored leaves bit for bit. Prints the phase's
   seconds.
12. The invariant checker on the card's machine, with the launch
   counters zeroed just before and read just after (it launches no
   kernel; (a)'s two runs and (b)'s two probe scripts run as four
   subprocesses at once): (a) ``python -m repro_torch.analysis check`` in a subprocess
   from the repo root (``PYTHONPATH=src``) over its default roots
   (``src/repro_torch``, ``chip_smoke.py``, ``tools``) must exit 0 and
   print ``analysis clean``, and ``rules`` must list the nine ids; (b)
   a probe script whose parent holds a CUDA context starts a child that
   touches CUDA: by ``fork`` the child must fail with CUDA's
   re-initialisation error on its stderr, by ``spawn`` it must exit 0,
   each child within its own timeout (a hang fails); the checker must
   flag the fork source (``torch-cuda-in-fork``) and not the spawn one;
   (c) a thread started inside ``use_device("cpu")`` must read
   ``cuda:0``, and the checker flag it (``torch-thread-no-device``);
   one that re-enters the starter's device must read ``cpu``, unflagged;
   (d) printed only: the host ms of 50 small matmuls with an ``.item()``
   each against one synchronise after the loop, in turns, beside the
   card's name and power limit. Prints the phase's seconds.
13. The dry-run on the card's machine (it launches no kernel; the
   launch counters are zeroed just before and read just after): (a)
   ``python -m repro_torch.launch.dryrun --arch <arch> --force`` with
   ``--single-pod-only`` and with ``--multi-pod-only``, one subprocess
   for each of the ten architectures and the two meshes, all twenty at
   once, into one scratch directory under ``artifacts/`` (never
   ``artifacts/dryrun_torch/``, which phase 10 holds at zero cells):
   each must exit 0, together with
   33 ``ok``, 7 ``skipped`` and 0 ``error`` records on each mesh (the
   pod's one card and a rank of the reference's 2 x 16 x 16 multi-pod
   mesh, whose every ``ok`` record has 512 devices and whose train
   cells count collectives); prints the counting seconds of
   ``deepseek-v3-671b``'s and ``llama-3.2-vision-90b``'s cells, each
   multi-pod cell's compute, memory and collective seconds, peak and
   collectives, and the matrix's wall seconds; the port's roofline view,
   pointed at that directory in this process, must read ``pod ok=33
   skipped=7 err=0; multipod ok=33`` and print the 33 cells' rows. (b) ``run_cell``
   of ``qwen2-7b`` x ``train_4k`` and the counts of (c) and (d), made in
   this process beside the live CUDA context, must leave
   ``torch.cuda.memory_allocated()``, the allocator's count of
   allocations and ``ops.LAUNCHES`` unchanged (the garbage of earlier
   phases collected first) and never call ``build.kernel``. (c) Phase 11's bf16 cell (4 layers,
   2 x 2048, remat full, 256-row chunks, the launcher's AdamW) counted
   by ``dryrun_lib.count_cell``: its predicted peak (argument + temp
   bytes) over phase 11's ``max_memory_allocated`` of the uncompressed
   steps must lie within 0.85-1.15. (d) Printed only: the dry-run's
   ``bound_s`` and dominant term beside the measured seconds of phase
   5's bf16 prefill (counted as ``vmem_flash``), one of its decode steps
   and phase 11's step. The phase must end within 240 s; prints its
   seconds.

14. MoE serving: ``deepseek-moe-16b`` (the MoE family: 28 layers, the
   first a dense FFN of d_ff 10944, then 64 routed experts of d_ff
   1408, top-6, and 2 shared; d_model 2048, 16 heads of 128; 16.38 B
   parameters, random bf16 weights from a seeded generator, made on the
   card) at full width and depth through ``engine.generate``: 4 prompts
   of 2048 tokens, 32 greedy new tokens. ``flash_attention_wgmma`` must
   launch exactly once per layer (prefill only) and nothing else. Prints
   prefill tokens/s, decode ms a step, the fewest and most rows any
   expert took in each MoE layer of the prefill and the summed aux
   (``models.moe.route`` wrapped for one prefill), the last logits
   beside the plain attention loop's (bf16 noise, not held) and the
   peak memory. Then the float32 check at full width, depth cut to 4
   layers (1 dense + 3 MoE; the bf16 weights released first): the FFMA
   kernel must launch once per layer and the wgmma kernel never; the
   two routes' expert choices are compared token by token in each MoE
   layer. A differing choice whose row and position no earlier
   differing choice reaches (a root flip: causal attention carries a
   change only to later positions of its row) must have been a near
   tie, the k-th and (k+1)-th probabilities closer than 1e-5 in both
   runs; the last logits of every row without a differing choice must
   agree within 1e-4 of the largest logit. Prints the differing choices
   per layer, each root flip's gap and each row's logit difference. The
   phase must end within 180 s; prints its seconds.

15. The SSM, hybrid and audio families: ``mamba2-370m`` (48 Mamba2
   layers, d_model 1024, 32 SSM heads of 64, state 128; 0.42 B
   parameters), ``zamba2-2.7b`` (9 super-blocks of 6 Mamba2 layers and
   one shared attention block, 32 heads of 80, no FFN; 2.34 B, the shared
   attention's parameters held once) and ``musicgen-medium`` (48 dense
   layers, 24 heads of 64; 1.82 B), each at full width and depth in bf16
   with random weights from a seeded generator, served one at a time
   (each model's weights released before the next) through
   ``engine.generate`` with phase 5's traffic (4 prompts of 2048 tokens,
   32 greedy new tokens). A generate and a prefill must launch exactly:
   ``mamba2`` no kernel; ``zamba2`` 9 ``flash_attention`` (FFMA, bf16 at
   head dim 80) and no wgmma; ``musicgen`` 48 ``flash_attention_wgmma``
   and nothing else (decode launches none). Prints prefill tokens/s,
   decode ms a step, the peak memory and the last logits beside the
   plain attention loop's (bf16 noise, not held). Then float32 at full
   width, depth cut: ``zamba2`` at 2 super-blocks (2 FFMA launches) and
   ``musicgen`` at 4 layers (4), the kernel route's last logits within
   1e-4 of the largest logit of the plain loop's; and ``mamba2`` at 4
   layers, the chunked prefill of 2032 tokens and 16 decode steps against
   the chunked prefill of all 2048 within 0.08 (tests/test_models.py's
   bound). The phase must end within 180 s; prints its seconds.

16. The local/global family: ``gemma3-4b`` (34 layers in two stages, 5
   blocks of 5 sliding-window layers (window 1024) and a global one, then
   4 window layers; d_model 2560, 8 heads over 4 KV heads of 256, vocab
   262,144; 4.55 B parameters, random bf16 weights from a seeded
   generator, made on the card) at full width and depth through
   ``engine.generate`` with phase 5's traffic. Head dim 256 and the
   windows take the plain attention loop, so a generate and a prefill
   must launch no hand-written kernel. The prefill's caches must have
   1024 rows in a window layer and the cache length in a global one.
   Prints prefill tokens/s, decode ms a step, the KV cache's bytes, the
   peak memory, and the plain loop's time at a global and a window
   layer's attention beside SDPA's and the global layer's bound (what a
   head-dim-256 kernel is to beat). Then float32 at full width, cut to 8
   layers (one block and 2 window layers, both stages): prompts of 2048
   and of 1500 tokens (not a multiple of the window: the rings wrap out
   of the prompt's order), each prefilled and then decoded 8 steps
   teacher-forced, every step's logits within 1e-4 of the largest logit
   of the forward over the same tokens. The phase must end within 180
   s; prints its seconds.

17. MLA and MTP: ``deepseek-v3-671b`` at full width, its depth cut to 4
   layers (671 B parameters do not fit one card): both stages of its
   plan, 3 dense MLA layers (d_ff 18432) and 1 MoE MLA layer with all
   256 routed experts (top-8, one shared expert), and the MTP module;
   16.08 B parameters, random bf16 weights from a seeded generator,
   made on the card. Through ``engine.generate`` with phase 5's traffic
   no hand-written kernel may launch: MLA's prefill attention (q and k
   192 wide, v 128, scale 1/sqrt(192)) takes the plain loop and its
   decode the absorbed latent path. Prints prefill tokens/s, decode ms
   a step, the latent caches' bytes (1,152 a row and layer), the peak,
   and the plain loop's time at an MLA layer beside SDPA and the bound.
   Then one ``lm_loss`` under ``no_grad`` at 1 x 2048: ``ce``, ``mtp``
   and ``aux`` finite, and ``flash_attention_wgmma`` launched exactly
   once (the MTP layer's GQA attention). Then float32 at full attention
   width, cut to 2 layers (1 dense, 1 MoE) and 16 experts: a prompt of
   1024 tokens and 8 teacher-forced absorbed decode steps within 1e-4 of
   the largest logit of the expanded forward over the same tokens, the
   decode steps' expert choices equal to the forward's (a choice may
   differ only at a near tie, whose row is then not held); and the MTP
   layer on the FFMA kernel against the plain loop within 1e-4, its
   ``mtp`` loss within 1e-5. The phase must end within 180 s; prints
   its seconds.

18. The VLM family: ``llama-3.2-vision-90b`` at full width, its depth cut
   to 10 layers (90 B parameters do not fit one card): two super-blocks
   of 4 self-attention layers (64/8 heads of 128) and a cross-attention
   layer over 1600 image tokens; 10.66 B parameters, random bf16
   weights, the cross layers' gates set to seeded values in [0.5, 1.5)
   (0 at init closes them), and seeded stub image embeddings (0.1 x
   normal, the reference's vision tower is a stub). Through
   ``engine.generate`` with phase 5's traffic a prefill must launch
   ``flash_attention_wgmma`` exactly once a self-attention layer (8)
   and nothing else, a decode step nothing: cross-attention (2048 query
   rows against 1600 image rows) takes the plain loop. Other image
   embeddings must move the logits. Prints prefill tokens/s, decode ms a
   step, the peak, and the plain loop's time at a cross-attention layer
   beside SDPA and the bound. Then float32 at full width cut to 5 layers
   (one super-block): the prefill and 8 teacher-forced decode steps
   within 1e-4 of the forward over the same tokens and image, and the
   prefill's logits on the FFMA kernel route within 1e-4 of the plain
   loop's. The phase must end within 180 s; prints its seconds.

19. LM training of the non-dense families at full width: (a) float32
   ``lm_loss`` and every gradient leaf under ``remat="full"`` at 1 x 512,
   the FFMA kernel route against the plain loop (loss within 1e-5
   relative, each leaf within 1e-4 of its largest |g|, the launches
   exact): ``deepseek-moe-16b`` at 2 layers (4 launches; its kernel
   route run twice must repeat the loss and every leaf bit for bit),
   ``zamba2-2.7b`` at one super-block (2), ``musicgen-medium`` at 2
   layers (4), ``deepseek-v3-671b`` at one dense MLA layer and the MTP
   module (1, the MTP layer) and ``llama-3.2-vision-90b`` at one self
   and one cross layer over 1600 image rows (2); (b) bf16 AdamW steps
   at 2 x 2048 on the launcher's batches: ``deepseek-moe-16b`` at 4
   layers, ``mamba2-370m``, ``zamba2-2.7b`` and ``musicgen-medium`` at
   full depth, ``gemma3-4b`` at 6 layers and ``deepseek-v3-671b`` at
   one dense MLA layer with MTP, 2 steps each (4 before phase 23): finite
   losses and gradient norms, ``step`` 2, layer 0 moved, the launches of every
   step exact (8 wgmma, 0, 18 FFMA, 96 wgmma, 0, 1 wgmma) and the MoE
   layers' host reads (one a layer in the forward and one in its
   recompute); then an int8-compressed and a ``microbatch=1`` step of
   ``deepseek-moe-16b``; prints each cell's median step ms, tokens/s
   and peak; (c) each (b) cell counted by ``dryrun_lib.count_cell`` in a
   subprocess that never touches CUDA (started with the phase): the
   predicted peak within 0.85-1.15 of the measured one; (d) the
   launcher's entry point (``launch.train.main``) at ``--arch
   <a>-smoke --steps 1`` for the seven non-dense families
   (``llama-3.2-vision-90b-smoke``'s run checkpointed), then that run
   resumed to 2, in turn in one subprocess beside (a), its step-1
   checkpoint restored on the card bit for bit after (a).
   A cross
   layer's one-element gate gradient, a sum whose terms cancel, is held
   in (a) by its terms: the gate broadcast to a [B, S, d] field of its
   value, whose gradient is checked leaf-wise. Phase 19 runs with the
   allocator's expandable segments (the V3 cell's 75.8 GB peak does not
   fit fixed segments' fragmentation). The phase must end within 300 s;
   prints its seconds.
20. The example entry points (``repro_torch.examples``), each through
   its ``main(argv)`` in this process with no ``--device`` (the card),
   the launch counters zeroed just before and read just after, plus one
   ``python -m repro_torch.examples.quickstart`` subprocess, run to its
   end (exit 0) before the in-process examples start. Contrib: whether
   ``PIL`` and ``cv2`` import here, ``contrib.available()``, and ``decoder_names()``
   equal to the 14 port paths followed by it (a plugin that imports
   decodes phase 3's corpus within 32 levels of ``numpy-ref``, the rare
   image exempt). ``quickstart``: ``cuda-idct`` launches ``idct8x8``
   once per component of the decoded image and nothing else launches;
   ``strict-fast`` skips the rare image. ``serve_lm --arch qwen2-7b``
   (full config, 28 layers, bf16; 4 x 32 tokens, 24 new): exactly 28
   ``flash_attention_wgmma`` launches (one a layer in the prefill, none
   in decode) and no other, ids equal to ``engine.generate`` called
   directly on the same seeded parameters and prompt; prints prefill
   and decode seconds and the peak device memory. ``serve_decode`` at
   its defaults but 30 requests a client (2 workers, 4 clients x 30
   zipf requests over 24 images, UCB) with ``/metrics`` on an ephemeral
   port: no failure,
   served plus shed equal to the requests, every arm pulled, one
   scrape; ``decode_batch`` and ``ycbcr2rgb`` launch (``cuda-fused``
   and ``cuda-batch`` serve a micro-batch through their shared batch
   entry point, one ``decode_batch`` launch a structure group, as the
   reference's ``pallas-fused`` does, so ``dequant_idct`` launches only
   on a fallback single decode; its count is printed). ``storage_loader``:
   exact resume, nothing launched. ``autotune_workers``: every path
   swept. The phase must end within 240 s.
21. Expert parallelism: ``deepseek-moe-16b`` at full width and depth
   (28 layers, bf16) served through ``engine.generate`` with
   ``make_context(make_host_mesh(1, 1))``, a world of one over NCCL
   (never gloo on the card), so every MoE layer runs
   ``models.moe.routed_ep``: fixed buffers of ``cap = ceil(T·k / E ·
   1.25)`` rows an expert, ``all_to_all_single`` out and back, no host
   read. (a) Phase 14's batch, prompt and new tokens: exactly 28
   ``flash_attention_wgmma`` launches and no other; prefill tokens/s,
   decode ms a step, peak device memory, the kept share of (token,
   slot) pairs per MoE layer; one decode step's MoE layers under
   ``torch.cuda.set_sync_debug_mode("error")``, so a host read fails
   the phase. (b) float32 at ``MOE_CHECK_LAYERS``: ``"ep"`` at a
   capacity that can drop nothing (``cap = T``) against the drop-free
   ``routed``, logits within 1e-5 of the largest |logit| on rows
   without a routing flip (flips only under phase 14's gap); then the
   first MoE layer of (a)'s prefill, its parameters and its 4 x 2048
   input cast to float32, at 1.25 on the card: pairs must drop, the
   kept pairs must equal those of a plain capacity-drop combine (each
   pair's slot by a stable sort, each expert's SwiGLU over its kept
   tokens) and the outputs lie within 1e-5 of its largest |y|; the
   block twice on the card gives the same bits; the same block and
   input on the CPU (a gloo world of one, made after the NCCL one is
   gone): the same choices but near ties, the same kept pairs, outputs
   within 1e-5 of the largest |y|.
   (c) The exchange's device time (CUDA events) at the prefill's and a
   decode step's buffers. The phase must end within 120 s.
22. Training through expert parallelism: ``deepseek-moe-16b`` at full
   width over the same NCCL world of one, the launcher's context
   (``make_context(make_host_mesh(1, 1), remat="full", q_chunk=256,
   k_chunk=256)``), so every MoE layer's forward and backward run
   ``routed_ep`` and the step reduces its gradients over the mesh
   (``distributed.data_parallel``, nothing over axes of one rank). (a)
   float32 ``loss_and_grads`` at 1 x 512, phase 19 (a)'s cut (1 dense +
   1 MoE layer): at a capacity that drops nothing (``cap = T``) the loss
   within 1e-5 and every gradient leaf within 1e-4 of its largest
   |element| of the drop-free ``routed``'s; at 1.25 (pairs must drop)
   the same against a plain capacity-drop combine (phase 21's, swapped
   in for ``moe_block``), and a second run repeats every bit; 4
   ``flash_attention`` launches a run. (b) Phase 21's float32 first MoE
   layer (4 x 2048 tokens) at 1.25: the block's gradients (``x``, the
   router, ``w1``, ``w3``, ``w2``) under a seeded cotangent on the card
   within 1e-4 of each leaf's largest |element| of the same block's on
   the CPU (a gloo world of one), the same choices and kept pairs, pairs
   dropped, and a second card run repeats every bit. (c) bf16 AdamW
   steps at phase 19 (b)'s cut (4 layers: 1 dense + 3 MoE) on the
   launcher's batches at 2 x 2048: 4 steps, one int8-compressed and one
   ``microbatch=1`` step; exactly 8 ``flash_attention_wgmma`` launches
   a step (16 the microbatched one); every MoE layer's forward, remat
   recompute and backward under ``torch.cuda.set_sync_debug_mode(
   "error")`` (a host read fails the phase); step ms, tokens/s and the
   peak device memory beside the dry-run's count of the same cell
   through ``routed_ep`` (a subprocess that never touches CUDA; within
   0.85-1.15) and phase 19's ``routed`` step of the same cell in the same
   run. The phase must end within 150 s.

23. Tensor parallelism over the model axis: two ranks share the one
   card, spawned as processes in a gloo world (NCCL refuses two ranks on
   one device; ``make_host_mesh(1, 2, backend="gloo")``, the backend
   printed), each holding its share of every leaf the model axis splits
   (``convert.local_tp_params``: heads, FFN hidden units, vocabulary
   rows) of ``qwen2-7b`` at full width and depth, random bf16 weights
   from one seed. (a) A 2 x 1024 prefill and 8 greedy decode steps
   through ``engine.generate``: exactly 28 ``flash_attention_wgmma``
   launches a rank (14/2 heads of 128 a rank; phase 4 holds the kernel
   there) and no other; each rank's peak device memory beside its
   parameters' bytes (the whole leaves, half of each split one) and its
   caches', below the whole model's; prefill tokens/s and decode ms a
   step, figures of a card shared by two processes over gloo, not of
   tensor parallelism. Then a float32 cut to 2 layers: the prefill's
   logits the same on both ranks and within 1e-4 of the largest |logit|
   of a world of one (the whole model in one process, rank 0), and the
   generated ids equal. (b) One float32 training step's gradients at the
   cut, 1 x 512, remat full: each leaf, gathered whole over the model
   axis, within 1e-4 of its largest |element| (phase 19's bound) of a
   world of one's, and the loss within 1e-5. (c) FSDP: the same two
   ranks as a 2 x 1 mesh (``make_host_mesh(2, 1, backend="gloo")``),
   each holding its data-axis block of every leaf whose rule has
   ``"data"`` (``distributed.fsdp``: gathered layer by layer on use,
   gradients reduce-scattered). (c1) One float32 gradient at the cut, 1
   x 512 a rank: each rank's reduce-scattered block within 1e-5 of its
   leaf's largest |element| of the same block of a world of one's
   gradient on the global 2 x 512 batch, the loss within 1e-6, exactly 4
   FFMA launches a rank. (c2) 2 bf16 AdamW steps at the cut, 1 x 2048 a
   rank: each rank's parameter and moment bytes equal to the layout's
   count (printed beside a world of one's), its peak device memory,
   exactly 8 ``flash_attention_wgmma`` launches a rank, step ms (a
   shared card's over gloo, not FSDP's), and a checkpoint gathered from
   the blocks with a world of one's names and shapes. Each rank records
   the collectives of its first step through the seam
   (``distributed.collectives.recording``); the dry-run's count of the
   same step at that rank's coordinates of a 2 x 1 mesh
   (``launch.mesh.RankMesh``, counted in this process while the ranks
   run) must equal them exactly, by kind and group size (count and
   operand bytes), and equal the rank's argument bytes (its state and
   rows), and the rank's peak device memory must lie within 0.85-1.15 of
   the count's peak. The phase must end within 150 s.
24. Tensor parallelism for MLA, MTP, cross-attention and Mamba2: the
   same two gloo ranks on the card (``make_host_mesh(1, 2,
   backend="gloo")``), each building its block a top-level leaf or a
   layer at a time from one seed, in turn (``model.init(...,
   keep=convert.local_tp_keep(...))``: no rank holds a whole model),
   its parameter bytes equal to the layout's count and below the whole
   model's. (a) ``deepseek-v3-671b`` at full width, 1 dense and 1 MoE
   MLA layer (all 256 experts through ``routed_ep``), bf16: a 2 x 1024
   prefill and 4 greedy decode steps through ``engine.generate``, no
   flash launch (MLA's q/k 192, v 128 take the plain loop); float32 at
   1 MLA layer and the MTP module: the prefill's logits at 2 x 512 and
   one step's loss (its MTP term included) and every gradient block at
   1 x 512, remat full, against a world of one; exactly 1 FFMA launch
   a rank in the step (the MTP layer). (b) ``llama-3.2-vision-90b`` at
   5 layers (4 self, 1 cross; 1,600 stub image rows, the cross gate
   opened): the same, 4 ``flash_attention_wgmma`` launches a rank in
   the bf16 prefill, 4 FFMA in the float32 prefill and 8 in the step.
   (c) ``zamba2-2.7b`` at full width and depth, bf16: 9 FFMA launches a
   rank (the shared attention at 16/16 heads of 80); float32 at 2
   super-blocks: 2 in the prefill, 4 in each step, the step with and
   without ``seq_shard_residual``. Every run's ids equal on both ranks;
   float32 logits within 1e-4 of the largest |logit|, the loss within
   1e-5 and each rank's block of each gradient leaf within 1e-4 of that
   leaf's largest |element| of the world of one's, which this process
   computes first, one run at a time, and writes to the temporary
   directory (one file a rank) while the ranks serve; (a)'s float32
   check then decodes 4 greedy steps on its MLA latent cache cut over
   the model axis, each step's logits against the world of one's and
   each rank's cache bytes the layout's half ((d4)). (d), on the same
   ranks, float32 against worlds of one: ``deepseek-moe-16b`` at 1
   dense + 1 MoE layer, the step's gradient (1) under ``no_tp`` over
   the 2 ranks as data ranks (the dense route's aux the global
   batch's), (1) with the dense route under ``seq_shard_residual`` and
   (2) through ``routed_ep`` at 1 x 511, every rank routing every
   position (loss, global norm and 4,096 seeded elements of every
   gradient block); (3) ``gemma3-4b`` at 6 layers under ``no_tp``, a
   batch of 1 of 1,536 tokens and 8 decode steps on caches cut on the
   sequence over the 2 ranks (each step's logits, the ids, each rank's
   cache bytes the layout's half). Times are a shared card's over
   gloo. The phase must end within 300 s.
25. Context-parallel attention: ``qwen2-7b`` at full width cut to 2
   layers over 8 gloo ranks sharing the card (``make_host_mesh(1, 8,
   backend="gloo")``; its 4 KV heads do not divide over 8, so each rank
   holds 1/8 of every attention leaf, attends with its rows of the
   queries and decodes on caches cut on the sequence over the ranks).
   bf16: ``engine.generate`` on 2 x 2048 at q chunks of 256 (one a
   rank) and 4 greedy decode steps, the ids equal on every rank, each
   rank's parameter bytes the layout's count and its caches 1/8 of a
   world of one's, no flash launch (the rows take the chunked loop); a
   prefill's collectives through the seam equal to the dry-run's count
   of the same cell at (0, 0) and (0, 7). float32 against a world of one
   that this process computes while the ranks serve: logits at 2 x 512
   (q chunks of 64) and 4 greedy steps within 1e-5 of the largest
   |logit|, ids equal; one step's gradient at 1 x 512 (loss within
   1e-5, global norm within 1e-5, 4,096 seeded elements of each rank's
   block of each leaf within 1e-5 of the leaf's largest |element|).
   Then the chunked loop's time for one rank's rows, beside SDPA on the
   same rows, the flash kernel over all rows and the bound. The phase
   must end within 180 s.

Before phases 3 to 11 and 14 to 25 the script releases cuBLAS's per-stream
workspaces and the allocator's free blocks, then prints the device
memory still held and the live CUDA tensors behind it, so that each
phase's peak is its own.

``python3 chip_smoke.py --profile`` adds a ``torch.profiler`` pass over
one prefill and a few decode steps of phases 5, 14 to 18 and over one
more training step of each phase 19 (b) cell (device time by kernel,
device busy share); the default run does not profile.

The last lines are the service's launches (``{"service_launches":
...}``), the loader's (``{"loader_launches": ...}``), the training
pipeline's (``{"training_launches": ...}``), the bench sweep's
(``{"bench_launches": ...}``), the table views' kernel view, quick and
``--full`` (``{"tables_launches": ...}``), LM training's
(``{"lm_training_launches": ...}``), the invariant checker's (all
zero, ``{"analysis_launches": ...}``), the dry-run's (all zero,
``{"dryrun_launches": ...}``), MoE serving's
(``{"moe_serving_launches": ...}``), the SSM, hybrid and audio
families' (``{"ssm_serving_launches": ...}``), the local/global
family's (all zero, ``{"local_global_serving_launches": ...}``), MLA
and MTP's (``{"mla_serving_launches": ...}``), the VLM family's
(``{"vlm_serving_launches": ...}``), the non-dense families'
training (``{"lm_family_training_launches": ...}``), the example entry
points' (``{"examples_launches": ...}``), expert-parallel serving's
(``{"ep_serving_launches": ...}``), expert-parallel training's
(``{"ep_training_launches": ...}``), tensor parallelism's
(``{"tp_launches": ...}``), tensor parallelism's for the other
blocks (``{"tp_family_launches": ...}``) and context parallelism's
(none, ``{"cp_launches": ...}``), the ``kernels`` JSON
object (``flash_attention``'s launches: phase 5's float32 check, phase
8's pipeline, phase 11's check, phase 14's float32 check, phase 15's
``zamba2`` prefill and float32 checks, phase 17's float32 MTP checks,
phase 18's float32 checks, phase 19's float32 checks and ``zamba2``
steps, phase 21's float32 check, phase 22's float32 gradients, phase 23's
float32 prefills and gradients and phase 24's ``zamba2`` prefill and
float32 checks;
``flash_attention_wgmma``'s: phase 5's prefill, phase 11's steps, phase
14's prefill, phase 15's ``musicgen`` prefill, phase 17's ``lm_loss``,
phase 18's prefills, phase 19's steps, phase 20's ``serve_lm`` prefill,
phase 21's prefills, phase 22's steps, phase 23's prefills and phase
24's VLM prefill; the
JPEG kernels' also count phase 20's ``quickstart`` and
``serve_decode``), the card's name and power limit, and
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


#: what phases 5 and 11 measured, for phase 13's bounds
MEASURED = {}


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
    # Once each, after the main run: the host's speed drifts within a
    # call, so compare them as the rough figures they are.
    two, one, fast = ("two workers", 2, None), ("one worker", 1, None), \
        ("two workers, switch interval 0.5 ms", 2, 0.0005)
    rates = {two[0]: [n_req / wall]}
    default_interval = sys.getswitchinterval()
    for label, workers, interval in (one, fast):
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
#: the sweeps' worker counts (0, 2, 4 and 8 until phase 19 needed the
#: ~50 s that workers 4 took of the 1200 s run)
PROTOCOL_WORKERS = (0, 2, 8)
#: the protocols run over this many of the corpus's images, the first
#: ones and the rare one (index 13): host entropy decode sets their time,
#: and the whole script must end within its limit on a slow host (16
#: until phase 23 needed the time, 14 until its FSDP part did, 10 until
#: phase 24 did)
PROTOCOL_IMAGES = 6
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
    import dataclasses
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
    keep = sorted(set(range(PROTOCOL_IMAGES - 1)) | {corpus.rare_index})
    sub = dataclasses.replace(
        corpus, files=[corpus.files[i] for i in keep],
        labels=corpus.labels[keep], sizes=[corpus.sizes[i] for i in keep],
        rare_index=keep.index(corpus.rare_index),
        progressive_indices=[keep.index(i)
                             for i in corpus.progressive_indices
                             if i in keep])
    check(len(sub.files) == PROTOCOL_IMAGES and
          sub.files[sub.rare_index] == corpus.files[corpus.rare_index],
          "the rare image is cut off")

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[label] = time.perf_counter() - t0
        return out
    single = timed("single-thread", lambda: protocols.SingleThreadProtocol(
        sub, repeats=2, platform=platform).run(paths))
    thread = timed("thread sweep", lambda: protocols.WorkerSweep(
        sub, repeats=1, mode="thread", platform=platform).run(
            paths, workers=PROTOCOL_WORKERS))
    process = timed("process sweep", lambda: protocols.WorkerSweep(
        sub, repeats=1, mode="process", platform=platform).run(
            paths, workers=PROTOCOL_WORKERS))
    again = timed("single-thread again",
                  lambda: protocols.SingleThreadProtocol(
                      sub, repeats=2, platform=platform).run(paths))
    print(f"protocol seconds: {seconds}")
    for first, second in zip(single, again):
        print(f"single-thread {first.decoder}: {first.samples} before the "
              f"sweeps, {second.samples} after")
    records = single + thread + process
    for r in records:
        check(r.platform == platform, f"record platform {r.platform}")
        if r.ok:
            check(r.throughput_mean > 0 and len(r.samples) >= 1 and
                  r.skip_indices == [] and r.num_images == len(sub) and
                  r.meta["delivered"] == len(sub),
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
    # phases 14 and 15's prefills: one KV head per query head; zamba2's
    # shared attention at head dim 80 (the FFMA kernel in bf16),
    # musicgen's at 64 (wgmma)
    moe_path, zamba_path, musicgen_path = (
        (LM_BATCH, LM_PROMPT, c.num_heads, c.num_kv_heads, c.head_dim)
        for c in map(get_config, (MOE_ARCH, "zamba2-2.7b",
                                  "musicgen-medium")))
    # phase 18's self-attention prefill (64/8 heads of 128) and phase
    # 17's MTP layer in its lm_loss (1 x MLA_LOSS_SEQ inputs: the layer
    # sees one position fewer; 128/128 heads of 128)
    vlm, mla = get_config(VLM_ARCH), get_config(MLA_ARCH)
    vlm_path = (LM_BATCH, LM_PROMPT, vlm.num_heads, vlm.num_kv_heads,
                vlm.head_dim)
    mtp_path = (1, MLA_LOSS_SEQ - 1, mla.num_heads, mla.num_kv_heads,
                mla.head_dim)
    # phase 19's training shapes: (a) float32 at 1 x FAMILY_CHECK_SEQ
    # (the MTP layer one position fewer), (b) bf16 at FAMILY_TRAIN_BATCH x
    # FAMILY_TRAIN_SEQ
    fams = [get_config(a) for a in (MOE_ARCH, "zamba2-2.7b",
                                    "musicgen-medium", VLM_ARCH)]
    train_f32 = [(1, FAMILY_CHECK_SEQ, c.num_heads, c.num_kv_heads,
                  c.head_dim) for c in fams] + [
        (1, FAMILY_CHECK_SEQ - 1, mla.num_heads, mla.num_kv_heads,
         mla.head_dim)]
    train_bf16 = [(FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ, c.num_heads,
                   c.num_kv_heads, c.head_dim) for c in fams[:3]] + [
        (FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ - 1, mla.num_heads,
         mla.num_kv_heads, mla.head_dim)]
    serve_lm_path = (SERVE_LM_BATCH, SERVE_LM_PROMPT, *heads)
    # phase 23's shapes: each rank's heads on a model axis of TP_RANKS,
    # its bf16 prefill, float32 prefill and float32 training step
    tp_heads = (cfg.num_heads // TP_RANKS, cfg.num_kv_heads // TP_RANKS,
                cfg.head_dim)
    tp_path = (TP_BATCH, TP_PROMPT, *tp_heads)
    # phase 24's shapes, each rank's heads on a model axis of TPF_RANKS:
    # the VLM's self-attention (32/4 of 128) and zamba2's shared attention
    # (16/16 of 80) at the bf16 prefill and the float32 one, and in a
    # float32 step of 1 x TPF_TRAIN_SEQ with V3's MTP layer (64/64 of
    # 128, one position fewer), and zamba2's in its bf16 step
    tpf_vlm, tpf_zamba, tpf_mtp = (
        (c.num_heads // TPF_RANKS, c.num_kv_heads // TPF_RANKS, c.head_dim)
        for c in (vlm, get_config("zamba2-2.7b"), mla))
    tpf_bf16 = [(TPF_BATCH, TPF_PROMPT, *tpf_vlm),
                (TPF_BATCH, TPF_PROMPT, *tpf_zamba),
                (1, TPF_TRAIN_SEQ, *tpf_zamba)]
    tpf_f32 = [(TPF_BATCH, TPF_CHECK_PROMPT, *tpf_vlm),
               (TPF_BATCH, TPF_CHECK_PROMPT, *tpf_zamba),
               (1, TPF_TRAIN_SEQ, *tpf_vlm), (1, TPF_TRAIN_SEQ, *tpf_zamba),
               (1, TPF_TRAIN_SEQ - 1, *tpf_mtp)]
    serving = (path, moe_path, zamba_path, musicgen_path, vlm_path,
               mtp_path, serve_lm_path, *train_bf16, tp_path, *tpf_bf16)
    cases = [(path, bf16, True), (moe_path, bf16, True),
             (zamba_path, bf16, True), (musicgen_path, bf16, True),
             (vlm_path, bf16, True), (mtp_path, bf16, True),
             ((LM_BATCH, 100, *heads), bf16, True),
             ((LM_BATCH, 129, *heads), bf16, True),
             ((LM_BATCH, 1, *heads), bf16, True),
             # phase 20's serve_lm prefill (qwen2-7b, 4 x 32 tokens)
             (serve_lm_path, bf16, True),
             ((1, LM_PROMPT, *heads), bf16, False),
             ((1, 512, *heads), f32, True),
             ((2, 100, *heads), f32, False),
             # head dims 48 (the `small` ViT's) and 80 (zamba2's)
             ((2, 256, 8, 2, 48), f32, True),
             ((2, 100, 8, 2, 80), f32, False),
             ((2, 130, 4, 4, 48), bf16, True)] + \
        [(shape, f32, True) for shape in train_f32] + \
        [(shape, bf16, True) for shape in train_bf16] + \
        [(tp_path, bf16, True), (tp_path, f32, True),
         ((1, TP_TRAIN_SEQ, *tp_heads), f32, True),
         # phase 23 (c2)'s bf16 steps: all heads on a data-axis rank
         # ((c1)'s float32 1 x 512 is the case above at 1 x 512)
         ((1, FSDP_SEQ, *heads), bf16, True)] + \
        [(shape, bf16, True) for shape in tpf_bf16] + \
        [(shape, f32, True) for shape in tpf_f32]
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
        if shape in serving or dtype == f32:
            worst[kernel] = max(worst.get(kernel, 0.0), err)
        del q, k, v, got, want, diff

    results = {}
    spec = chip_spec()
    # the bound: the FLOPs at the inputs' type's peak (bf16 inputs at the
    # tensor-core rate, on either route)
    for dtype, shape in ((bf16, path), (f32, path), (bf16, moe_path),
                         (bf16, zamba_path), (bf16, musicgen_path),
                         (bf16, vlm_path), (bf16, mtp_path),
                         *((f32, shape) for shape in train_f32),
                         *((bf16, shape) for shape in train_bf16),
                         (bf16, tp_path), (f32, tp_path),
                         *((bf16, shape) for shape in tpf_bf16),
                         *((f32, shape) for shape in tpf_f32)):
        flops_per_s = spec.peak_bf16_flops if dtype == bf16 else \
            spec.peak_fp32_flops
        name = ops.flash_kernel_for(dtype, shape[-1])
        q, k, v = _flash_inputs(shape, dtype, seed=0)
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
        nbytes, flops = flash_work(*shape, True, q.element_size())
        b_ms, b_by = bound_ms(nbytes, flops, flops_per_s)
        print(f"{name} at {shape} {dtype} causal: ms {ms} plain_ms "
              f"{plain_ms} library_ms {library_ms} (SDPA, max diff to the "
              f"kernel {lib_err.item()}) bound_ms {b_ms} ({b_by}: {nbytes} "
              f"B, {flops} FLOP at {flops_per_s:.3g} FLOP/s), "
              f"{b_ms / ms} of the bound; {flops / ms / 1e9} TFLOP/s; "
              f"eager calls {eager_ms} ms each")
        if dtype == f32 and shape == path:
            parent_lines(f"{path} float32 causal", kern, q, k, v, True)
        if shape == path:       # the other models' shapes are printed only
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


def _profile_serving(label, cfg, ctx, params, prompt, cache_len,
                     image_embeds=None):
    """``_profile`` over one prefill and over 8 decode steps."""
    from repro_torch.serve import engine
    prefill = engine.make_prefill_step(cfg, ctx, cache_len)
    _profile(f"{label}prefill", lambda: prefill(params, prompt,
                                                image_embeds))
    caches, logits = prefill(params, prompt, image_embeds)
    tok = logits.argmax(dim=-1)[:, None]
    decode = engine.make_decode_step(cfg, ctx)

    def steps():
        c, t = caches, tok
        for i in range(8):
            c, lg = decode(params, c, t, LM_PROMPT + i, image_embeds)
            t = lg.argmax(dim=-1)[:, None]
    _profile(f"{label}decode 8 steps", steps)


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
    MEASURED["lm_serve"] = {"cfg": cfg, "ctx": ctx, "cache_len": cache_len,
                            "prefill_s": pre_s,
                            "decode_step_s": dec_s / (LM_NEW - 1)}
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
        _profile_serving("", cfg, ctx, params, prompt, cache_len)
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
VIT_STEPS = 3                 # the pipeline run: async save after step 2
VIT_SAVE_EVERY = 2
VIT_RESTART_STEPS = 1
VIT_LEARN_STEPS = 20
VIT_SHARE_STEPS = 1
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
    # prefetch_to_device into the trainer, async save after step 2
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
    from repro_torch.launch.train import train_batches
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
    batches = train_batches(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)

    def run(step_fn, box, n, label):
        """``n`` steps on ``box["state"]``; the box holds the only
        reference to the state, so a step's old state is freed as soon
        as the step returns its new one (two states, not three, at a
        time: ~20 GB each)."""
        ms, losses, gnorms = [], [], []
        torch.cuda.synchronize()
        ops.reset_launches()
        for _ in range(n):
            tokens = next(batches)["tokens"].to(dev)
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
    MEASURED["lm_train"] = {"cfg": cfg, "ctx": ctx, "opt_cfg": opt_cfg,
                            "step_s": med / 1e3, "peak": peak}
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


#: (c)'s launcher runs: the first, then its resume (6 and 9 until phase
#: 24 needed the time), in one process since PR 36 (``LAUNCHERS``)
LM_LAUNCHER_STEPS = (2, 3)


def _lm_launcher():
    """(c): the launcher on the card, then its resume, in turn in one
    subprocess (``_launchers_start``)."""
    import tempfile
    os.makedirs(os.path.join(ROOT, "artifacts"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="lm_launcher_",
                            dir=os.path.join(ROOT, "artifacts"))
    first, then = LM_LAUNCHER_STEPS
    runs = {f"qwen2-7b-smoke --steps {n}": _launcher_argv("qwen2-7b", n, ckpt)
            for n in LM_LAUNCHER_STEPS}
    outs = _launchers_finish("(c)", *_launchers_start(runs), 300)
    check(f"resumed from step {first}" in
          outs[f"qwen2-7b-smoke --steps {then}"],
          f"(c) the second run did not resume from step {first}")
    _restored_on_card_bit_for_bit("(c)", os.path.join(ckpt,
                                                      f"step_{first}"),
                                  "qwen2-7b-smoke")
    shutil.rmtree(ckpt)


def _restored_on_card_bit_for_bit(label, step_dir, arch):
    """A launcher checkpoint restored on the card (``like`` a state made
    there) must equal its stored leaves bit for bit."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.configs import get_config
    from repro_torch.train import OptimizerConfig
    from repro_torch.train.train_step import make_train_state
    like = make_train_state(
        torch.Generator(device=torch.device(DEV)).manual_seed(1),
        get_config(arch), OptimizerConfig())
    stored, _ = restore_pytree(step_dir)
    restored, _ = restore_pytree(step_dir, like=like)
    flat = tree.flatten_with_names(restored)
    check(set(flat) == set(stored), f"{label} restored leaves differ by name")
    for name, t in flat.items():
        check(t.device.type == torch.device(DEV).type,
              f"{label} {name} restored on {t.device}")
        got = t.cpu()
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16)
        check(got.numpy().tobytes() == np.asarray(stored[name]).tobytes(),
              f"{label} restored {name} differs from the stored leaf")
    print(f"{label} {arch}: {os.path.basename(step_dir)} restored on the "
          f"card equals its {len(flat)} stored leaves bit for bit")


ANALYSIS_TIMEOUT_S = 300        # the checker over the port, in a subprocess
CHILD_TIMEOUT_S = 120           # each probe's child process or thread
DEVICE_RULE_IDS = ("torch-thread-no-device", "torch-cuda-in-fork",
                   "torch-host-sync-in-loop")

#: (b)'s probe, a script of its own: the parent takes a CUDA context,
#: then starts a child by ``{method}`` that touches CUDA. It prints the
#: child's exit code; the child's traceback goes to stderr.
FORK_PROBE = """\
import multiprocessing as mp
import sys

import torch


def touch_cuda():
    x = torch.ones(4, device="cuda")
    torch.cuda.synchronize()
    print("child sum", float(x.sum()), flush=True)


def main(timeout):
    torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    child = mp.get_context("{method}").Process(target=touch_cuda)
    child.start()
    child.join(timeout)
    if child.is_alive():
        child.kill()
        child.join()
        print("child hung", flush=True)
        return 3
    print("child exit code", child.exitcode, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(float(sys.argv[1])))
"""

#: (c)'s probes, run in this process: a thread started inside
#: ``use_device("cpu")`` reads the device, bare and re-entering the
#: starter's device.
THREAD_PROBE = """\
import threading

from repro_torch.device import current_device, use_device


def report(out):
    out.append(str(current_device()))


def start(out, timeout):
    with use_device("cpu"):
        t = threading.Thread(target=report, args=(out,), daemon=True)
        t.start()
        t.join(timeout)
"""

THREAD_PROBE_SCOPED = """\
import threading

from repro_torch.device import current_device, selected_device, use_device


def report(dev, out):
    with use_device(dev):
        out.append(str(current_device()))


def start(out, timeout):
    with use_device("cpu"):
        t = threading.Thread(target=report, args=(selected_device(), out),
                             daemon=True)
        t.start()
        t.join(timeout)
"""


def phase_analysis():
    """Phase 12: the invariant checker over the port on the card's
    machine, and the two runtime facts behind its device rules; returns
    the launches during the phase (none). The checker's two runs and the
    two probe scripts run as four subprocesses at once."""
    import tempfile
    import torch
    from repro_torch.kernels import ops
    print("== phase 12: the invariant checker on the card's machine")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        started = {"check": _analysis_start("check"),
                   "rules": _analysis_start("rules")}
        started.update(_fork_probe_start(tmp))
        try:
            _analysis_check(started)
            _fork_probe(started)
        finally:
            for p, _, _ in started.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    _thread_probe()
    _sync_in_loop_ms()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(not any(launches.values()),
          f"phase 12 launched a kernel: {launches}")
    print(f"phase 12: {time.perf_counter() - t_phase} s; launches "
          f"{launches}")
    return launches


def _started(argv, timeout, cwd=None, env=None):
    """(a running process, its start time, its time limit)."""
    return (subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            time.perf_counter(), timeout)


def _finished(started, what):
    """Wait for a ``_started`` process within its limit (a hang fails):
    (its ``CompletedProcess``, its seconds)."""
    p, t0, timeout = started
    try:
        out, err = p.communicate(timeout=max(
            1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"{what} hung: {e}")
    return (subprocess.CompletedProcess(p.args, p.returncode, out, err),
            time.perf_counter() - t0)


def _analysis_start(*argv):
    return _started([sys.executable, "-m", "repro_torch.analysis", *argv],
                    ANALYSIS_TIMEOUT_S, cwd=ROOT,
                    env=dict(os.environ, PYTHONPATH=SRC))


def _analysis_check(started):
    """(a): ``python -m repro_torch.analysis check`` from the repo root
    exits 0 with ``analysis clean``; ``rules`` lists the nine ids."""
    run, dt = _finished(started["check"], "repro_torch.analysis check")
    print(run.stdout.strip())
    check(run.returncode == 0 and "analysis clean" in run.stdout,
          f"(a) analysis check exited {run.returncode}: "
          f"{run.stdout[-2000:]} {run.stderr[-2000:]}")
    rules, _ = _finished(started["rules"], "repro_torch.analysis rules")
    ids = [line for line in rules.stdout.splitlines()
           if line and not line.startswith(" ")]
    check(rules.returncode == 0 and len(ids) == 9 and
          set(DEVICE_RULE_IDS) <= set(ids),
          f"(a) analysis rules exited {rules.returncode}: {ids}")
    print(f"(a) python -m repro_torch.analysis check: exit 0, analysis "
          f"clean, {dt} s; rules: {', '.join(ids)}")


def _flagged(source, rule):
    from repro_torch.analysis import analyze_source
    return analyze_source(source, path="probe.py", only=[rule])


def _fork_probe_start(tmp):
    """(b)'s two probe scripts, written under ``tmp`` and started."""
    out = {}
    for method in ("fork", "spawn"):
        script = os.path.join(tmp, f"probe_{method}.py")
        with open(script, "w") as f:
            f.write(FORK_PROBE.replace("{method}", method))
        out[method] = _started([sys.executable, script,
                                str(CHILD_TIMEOUT_S)], CHILD_TIMEOUT_S + 120)
    return out


def _fork_probe(started):
    """(b): with the parent holding a context, a forked child that
    touches CUDA fails with CUDA's re-initialisation error; under spawn
    it exits 0. The checker flags the fork source and not the spawn."""
    for method in ("fork", "spawn"):
        source = FORK_PROBE.replace("{method}", method)
        run, _ = _finished(started[method], f"(b) the {method} probe")
        said = [line for line in run.stdout.splitlines()
                if line.startswith("child exit code")]
        check(run.returncode == 0 and len(said) == 1,
              f"(b) the {method} probe exited {run.returncode}: "
              f"{run.stdout[-2000:]} {run.stderr[-2000:]}")
        code = int(said[0].split()[-1])
        found = _flagged(source, "torch-cuda-in-fork")
        if method == "fork":
            check(code != 0 and "re-initialize CUDA" in run.stderr,
                  f"(b) the forked child exited {code} without CUDA's "
                  f"re-initialisation error: {run.stderr[-2000:]}")
            check(len(found) == 1 and "touch_cuda()" in found[0].message,
                  f"(b) the checker did not flag the fork source: "
                  f"{[f.render() for f in found]}")
            error = [line for line in run.stderr.splitlines()
                     if "re-initialize CUDA" in line][0]
            print(f"(b) fork: child exit code {code}; {error.strip()}; "
                  f"flagged: {found[0].render()}")
        else:
            check(code == 0 and "child sum 4.0" in run.stdout,
                  f"(b) the spawned child exited {code}: "
                  f"{run.stdout[-2000:]} {run.stderr[-2000:]}")
            check(found == [], f"(b) the checker flagged the spawn "
                  f"source: {[f.render() for f in found]}")
            print(f"(b) spawn: child exit code {code}, not flagged")


def _thread_probe():
    """(c): a thread started inside ``use_device("cpu")`` reads
    ``cuda:0``, and the checker flags it; the thread that re-enters the
    starter's device reads ``cpu``, and the checker does not."""
    for source, want, flags in ((THREAD_PROBE, "cuda:0", 1),
                                (THREAD_PROBE_SCOPED, "cpu", 0)):
        space = {}
        exec(compile(source, "probe.py", "exec"), space)
        out = []
        space["start"](out, CHILD_TIMEOUT_S)
        check(out == [want], f"(c) the thread read {out}, want [{want!r}] "
              f"(an empty list: it hung)")
        found = _flagged(source, "torch-thread-no-device")
        check(len(found) == flags,
              f"(c) the checker gave {[f.render() for f in found]} for the "
              f"thread reading {want}, want {flags} finding(s)")
        print(f"(c) a thread started inside use_device('cpu') read {out[0]}"
              f" ({'bare' if flags else 're-entering the device'}); "
              f"findings: {[f.render() for f in found]}")


def _sync_in_loop_ms(steps=50, reps=5):
    """(d), printed only: host ms of ``steps`` small matmuls with an
    ``.item()`` each, against one synchronise after the loop, in turns."""
    import torch
    a = torch.randn(256, 256, device="cuda") / 16

    def per_step():
        x = a
        for _ in range(steps):
            x = torch.tanh(x @ a)
            x.sum().item()

    def once():
        x = a
        for _ in range(steps):
            x = torch.tanh(x @ a)
        torch.cuda.synchronize()

    times = {"item per step": [], "one sync": []}
    for fn in (per_step, once):
        fn()
    for k in range(reps):
        for name, fn in ((("item per step", per_step), ("one sync", once))
                         if k % 2 == 0 else
                         (("one sync", once), ("item per step", per_step))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    print(f"(d) {steps} matmuls of 256x256, host ms over {reps} turns: "
          f"{ {k: sorted(v) for k, v in times.items()} } ({smi_line()})")


DRYRUN_TIMEOUT_S = 600          # the whole matrix, in subprocesses
DRYRUN_MATRIX = {"pod": {"ok": 33, "skipped": 7, "error": 0},
                 "multipod": {"ok": 33, "skipped": 7, "error": 0}}
DRYRUN_FIRST_ROW = "pod ok=33 skipped=7 err=0; multipod ok=33"
#: the multi-pod mesh's devices (2 x 16 x 16)
DRYRUN_MULTIPOD_DEVICES = 512
#: the cells this slice added to the matrix: their counting seconds print
DRYRUN_NEW_ARCHS = ("deepseek-v3-671b", "llama-3.2-vision-90b")
DRYRUN_CELL = ("qwen2-7b", "train_4k")      # (b): counted in this process
#: (c): predicted / measured peak of phase 11's uncompressed steps; fixed
#: before the first card run
DRYRUN_PEAK_RATIO = (0.85, 1.15)
PHASE13_LIMIT_S = 240


def phase_dryrun():
    """Phase 13: the dry-run (``python -m repro_torch.launch.dryrun``) on
    the card's machine; returns the launches during the phase (none)."""
    import torch
    from repro_torch.kernels import ops
    print("== phase 13: the dry-run on the card's machine")
    t_phase = time.perf_counter()
    card = smi_line()
    torch.cuda.synchronize()
    ops.reset_launches()
    _dryrun_matrix()
    counts = _dryrun_in_process()
    _dryrun_memory(counts["train"], card)
    _dryrun_bounds(counts, card)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(not any(launches.values()),
          f"phase 13 launched a kernel: {launches}")
    dt = time.perf_counter() - t_phase
    print(f"phase 13: {dt} s (limit {PHASE13_LIMIT_S} s); launches "
          f"{launches}")
    check(dt <= PHASE13_LIMIT_S, f"phase 13 took {dt} s")
    return launches


def _dryrun_matrix():
    """(a): the whole matrix, one ``python -m repro_torch.launch.dryrun
    --arch <arch>`` subprocess an architecture and mesh
    (``--single-pod-only``, ``--multi-pod-only``), all at once, each
    logging to a file of one scratch directory (not
    artifacts/dryrun_torch/, which phase 10 holds at zero cells), then the
    port's roofline view over it in this process."""
    import glob
    import tempfile
    from repro_torch.bench.views import roofline
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun_lib import all_archs
    os.makedirs(os.path.join(ROOT, "artifacts"), exist_ok=True)
    out = tempfile.mkdtemp(prefix="phase13_dryrun_",
                           dir=os.path.join(ROOT, "artifacts"))
    t0 = time.perf_counter()
    procs = {}
    try:
        for arch in all_archs():
            for flag in ("--single-pod-only", "--multi-pod-only"):
                log = os.path.join(out, f"{arch}{flag}.log")
                with open(log, "w") as f:
                    procs[arch, flag] = (subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--arch", arch, flag, "--force", "--out", out],
                        stdout=f, stderr=subprocess.STDOUT,
                        env=dict(os.environ, PYTHONPATH=SRC), cwd=ROOT), log)
        done = {}
        for job, (p, log) in procs.items():
            code = p.wait(timeout=max(
                1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
            with open(log) as f:
                done[job] = (code, f.read())
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    dt = time.perf_counter() - t0
    for (arch, flag), (code, log) in done.items():
        last = log.strip().splitlines()[-1:]
        print(f"(a) dryrun --arch {arch} {flag}: exit {code}; {last}")
        check(code == 0, f"(a) the dry-run of {arch} {flag} exited {code}")
    got = {kind: {"ok": 0, "skipped": 0, "error": 0}
           for kind in DRYRUN_MATRIX}
    for path in sorted(glob.glob(os.path.join(out, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        got[rec["mesh_name"]][rec["status"]] += 1
        if rec["arch"] in DRYRUN_NEW_ARCHS and rec["mesh_name"] == "pod":
            print(f"(a) {rec['arch']} x {rec['shape']}: {rec['status']}"
                  + (f", counted in {rec['lower_s']} s"
                     if rec["status"] == "ok" else
                     f" ({rec.get('reason')})"))
        if rec["mesh_name"] == "multipod" and rec["status"] == "ok":
            _dryrun_multipod_row(rec)
    print(f"(a) the matrix in {len(done)} subprocesses, all at once, on "
          f"{os.cpu_count()} CPUs: wall {dt} s; records {got}")
    check(got == DRYRUN_MATRIX, f"(a) records {got}, want {DRYRUN_MATRIX}")
    saved = roofline.DRYRUN_DIR
    roofline.DRYRUN_DIR = out
    try:
        rows = roofline.run()
    finally:
        roofline.DRYRUN_DIR = saved
    check(rows and rows[0][2] == DRYRUN_FIRST_ROW,
          f"(a) the roofline view's first row: {rows[:1]}")
    # a cell's row is roofline.<arch>.<shape> (an arch may hold a dot)
    cells = [row for row in rows if row[0].rsplit(".", 1)[-1] in SHAPES]
    for name, us, derived in cells:
        print(f"(a) {name}: bound {us} us, {derived}")
    check(len(cells) == DRYRUN_MATRIX["pod"]["ok"],
          f"(a) the roofline view has {len(cells)} cell rows")
    shutil.rmtree(out)


def _dryrun_multipod_row(rec):
    """(a): one multi-pod record's line, and its checks: the mesh's 512
    devices, collectives in a train cell, the model FLOPs a chip."""
    ro, mem, coll = rec["roofline"], rec["memory"], rec["collectives"]
    kinds = {k: v["count"] for k, v in coll["by_kind"].items()}
    print(f"(a) multipod {rec['arch']} x {rec['shape']} on "
          f"{rec['mesh']}: compute_s {ro['compute_s']}, memory_s "
          f"{ro['memory_s']}, collective_s {ro['collective_s']} "
          f"({ro['dominant']}); peak {mem['peak_hbm_proxy_bytes']} B a "
          f"rank (argument {mem['argument_bytes']}, fits "
          f"{mem['fits_hbm']}); {coll['num_collectives']} collectives "
          f"{kinds}, {coll['total_traffic_bytes']} B of traffic; counted "
          f"in {rec['lower_s']} s")
    check(rec["num_devices"] == DRYRUN_MULTIPOD_DEVICES,
          f"(a) {rec['arch']} x {rec['shape']}: {rec['num_devices']} "
          f"devices")
    check(rec["shape"] != "train_4k" or coll["num_collectives"] > 0,
          f"(a) {rec['arch']} x train_4k counted no collective")
    check(rec["model_flops_per_chip"] * DRYRUN_MULTIPOD_DEVICES ==
          rec["model_flops_total"],
          f"(a) {rec['arch']} x {rec['shape']}: model FLOPs a chip")


def _cuda_memory():
    """(bytes allocated now, allocations made so far) on the card, after
    collecting the garbage of earlier phases (a collection during the
    count would free their CUDA tensors and read as the count's)."""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    return (torch.cuda.memory_allocated(),
            torch.cuda.memory_stats().get("allocation.all.allocated", 0))


def _dryrun_in_process():
    """(b): cells counted in this process beside a live CUDA context: no
    CUDA memory (none held more, none allocated even for a while), no
    launch and no kernel build. Returns the counts that (c) and (d)
    read."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import build, ops
    from repro_torch.launch import dryrun_lib
    calls = []
    real = build.kernel

    def refuse(name):
        calls.append(name)
        raise RuntimeError(f"the dry-run reached kernel {name}")
    (mem0, allocs0), launches0 = _cuda_memory(), dict(ops.LAUNCHES)
    build.kernel = refuse
    try:
        t0 = time.perf_counter()
        rec = dryrun_lib.run_cell(*DRYRUN_CELL)
        dt = time.perf_counter() - t0
        train = MEASURED["lm_train"]
        counts = {"train": dryrun_lib.count_cell(
            train["cfg"], ShapeConfig("phase11_train", "train",
                                      LM_TRAIN_SEQ, LM_TRAIN_BATCH),
            train["ctx"], opt_cfg=train["opt_cfg"])}
        serve = MEASURED["lm_serve"]
        counts["prefill"] = dryrun_lib.count_cell(
            serve["cfg"], ShapeConfig("phase5_prefill", "prefill",
                                      LM_PROMPT, LM_BATCH),
            serve["ctx"], fused_scopes=(dryrun_lib.FLASH_SCOPE,))
        counts["decode"] = dryrun_lib.count_cell(
            serve["cfg"], ShapeConfig("phase5_decode", "decode",
                                      serve["cache_len"], LM_BATCH),
            serve["ctx"])
    finally:
        build.kernel = real
    (mem1, allocs1), launches1 = _cuda_memory(), dict(ops.LAUNCHES)
    print(f"(b) run_cell{DRYRUN_CELL}: {rec['status']} in {dt} s, "
          f"{rec.get('cost')}; CUDA memory allocated {mem0} -> {mem1} "
          f"bytes, allocations {allocs0} -> {allocs1}; launches "
          f"{launches0} -> {launches1}; build.kernel calls {calls}")
    check(rec["status"] == "ok", f"(b) run_cell: {rec}")
    check(mem1 == mem0 and allocs1 == allocs0,
          f"(b) CUDA memory {mem0} -> {mem1} bytes, allocations {allocs0} "
          f"-> {allocs1} around the dry-run")
    check(launches1 == launches0, "(b) the dry-run launched a kernel")
    check(not calls, f"(b) the dry-run reached build.kernel: {calls}")
    return counts


def _dryrun_memory(counts, card):
    """(c): the predicted peak of phase 11's cell against the card's."""
    lo, hi = DRYRUN_PEAK_RATIO
    measured = MEASURED["lm_train"]["peak"]
    predicted = counts["peak_bytes"]
    ratio = predicted / measured
    print(f"(c) phase 11's cell ({LM_TRAIN_LAYERS} layers, "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, remat full): predicted peak "
          f"{predicted} bytes (argument {counts['argument_bytes']} + temp "
          f"{predicted - counts['argument_bytes']}), measured "
          f"max_memory_allocated {measured} bytes, ratio {ratio} (bound "
          f"{lo}-{hi}; {card})")
    check(lo <= ratio <= hi, f"(c) predicted/measured peak {ratio}")


def _dryrun_bounds(counts, card):
    """(d): each phase's measured seconds against the dry-run's bound
    (printed, not checked)."""
    from repro_torch.common import hw
    measured = {"prefill": MEASURED["lm_serve"]["prefill_s"],
                "decode": MEASURED["lm_serve"]["decode_step_s"],
                "train": MEASURED["lm_train"]["step_s"]}
    labels = {"prefill": f"phase 5 bf16 prefill, {LM_BATCH} x {LM_PROMPT}, "
                         f"counted as vmem_flash (cache of {LM_PROMPT} "
                         f"rows; phase 5 pads to "
                         f"{MEASURED['lm_serve']['cache_len']})",
              "decode": f"phase 5 decode step, {LM_BATCH} x 1 against "
                        f"{MEASURED['lm_serve']['cache_len']} cache rows",
              "train": f"phase 11 bf16 step, {LM_TRAIN_LAYERS} layers, "
                       f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}"}
    for key, c in counts.items():
        terms = hw.roofline_terms(c["flops"], c["bytes"], 0.0)
        print(f"(d) {labels[key]}: {c['flops']} FLOPs ({c['matmul_flops']} "
              f"in matmuls), {c['bytes']} bytes; bound_s "
              f"{terms['bound_s']} ({terms['dominant']}; compute_s "
              f"{terms['compute_s']}, memory_s {terms['memory_s']}); "
              f"measured {measured[key]} s; bound_s / measured "
              f"{terms['bound_s'] / measured[key]} ({card})")


MOE_ARCH = "deepseek-moe-16b"   # full width and depth in bf16 (~32.8 GB)
MOE_CHECK_LAYERS = 4            # the float32 check: 1 dense + 3 MoE, ~9 GB
#: a routing decision the float32 kernel route and the plain loop make
#: differently must have been a near tie: the k-th and (k+1)-th
#: probabilities closer than this in both runs
MOE_GAP_TOL = 1e-5
PHASE14_LIMIT_S = 180


def phase_moe(profile=False):
    """Phase 14: ``deepseek-moe-16b`` served at full width and depth in
    bf16, and the float32 check of the kernel route at 4 layers; returns
    the flash kernels' launches of the phase. ``profile`` adds
    ``_profile`` over one bf16 prefill and 8 decode steps."""
    import torch
    from repro_torch.configs import get_config
    print(f"== phase 14: {MOE_ARCH} (the MoE family) serving at full width "
          f"and depth")
    t_phase = time.perf_counter()
    card = smi_line()
    held = held_report("phase 14")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(MOE_ARCH)
    launches = _moe_serve(cfg, held, card, profile)
    gc.collect()
    torch.cuda.empty_cache()
    k_launches = _moe_float32_check(cfg, card)
    for name, count in k_launches.items():
        launches[name] += count
    dt = time.perf_counter() - t_phase
    print(f"phase 14: {dt} s (limit {PHASE14_LIMIT_S} s); peak device "
          f"memory {torch.cuda.max_memory_allocated()} bytes ({held} held "
          f"before the phase); launches {launches} ({card})")
    check(dt <= PHASE14_LIMIT_S, f"phase 14 took {dt} s")
    return launches


def _capture_routes(fn):
    """Run ``fn`` with ``models.moe.route`` wrapped: returns (fn's result,
    one record a MoE layer: each token's chosen experts as a sorted set,
    the gap between its k-th and (k+1)-th probability, and the aux)."""
    import torch
    from repro_torch.models import moe
    real, records = moe.route, []

    def route(xt, router, k, over=None):
        gates, idx, aux = real(xt, router, k, over)
        top = torch.topk(torch.softmax(xt.float() @ router, dim=-1), k + 1,
                         dim=-1).values
        records.append({"idx": idx.sort(dim=-1).values,
                        "gap": top[:, k - 1] - top[:, k], "aux": aux})
        return gates, idx, aux
    moe.route = route
    try:
        return fn(), records
    finally:
        moe.route = real


def _capture_keep(fn):
    """Run ``fn`` with ``models.moe.dispatch_slots`` wrapped: returns
    (fn's result, each ``routed_ep`` call's kept mask over its (token,
    slot) pairs)."""
    from repro_torch.models import moe
    real, kept = moe.dispatch_slots, []

    def dispatch_slots(ids, num_experts, cap):
        pos, keep = real(ids, num_experts, cap)
        kept.append(keep)
        return pos, keep
    moe.dispatch_slots = dispatch_slots
    try:
        return fn(), kept
    finally:
        moe.dispatch_slots = real


def _root_flips(rec_a, rec_b):
    """Routing decisions that differ between two prefills of
    ``LM_BATCH`` x ``LM_PROMPT`` tokens (``_capture_routes`` records) ->
    (differing decisions per MoE layer, root flips as (layer, row,
    position, gap), the rows with a flip). A decision at (layer, row b,
    position t) reaches only later layers at positions >= t of row b
    (causal attention; routing is per token): a root flip has no
    differing decision before it there."""
    import torch
    first = [LM_PROMPT] * LM_BATCH      # earliest flipped position by row
    per_layer, roots = [], []
    for li, (a, b) in enumerate(zip(rec_a, rec_b)):
        differ = (a["idx"] != b["idx"]).any(dim=-1).nonzero()[:, 0]
        gaps = torch.maximum(a["gap"], b["gap"])
        flips = [(int(t) // LM_PROMPT, int(t) % LM_PROMPT,
                  gaps[t].item()) for t in differ]
        per_layer.append(len(flips))
        roots += [(li, row, pos, gap) for row, pos, gap in flips
                  if pos < first[row]]
        for row, pos, _ in flips:
            first[row] = min(first[row], pos)
    flipped_rows = sorted({row for row in range(LM_BATCH)
                           if first[row] < LM_PROMPT})
    return per_layer, roots, flipped_rows


def _moe_generate(label, cfg, ctx, held, card):
    """bf16 ``MOE_ARCH`` at full width and depth, made on the card from
    seed 0 and served through ``engine.generate`` with ``ctx`` on
    ``LM_BATCH`` x ``LM_PROMPT`` prompt tokens from seed 1 and ``LM_NEW``
    new ones: exactly one ``flash_attention_wgmma`` launch a layer and
    nothing else. Returns (params, prompt, cache_len, the generated ids,
    the launches)."""
    import torch
    from repro_torch import tree
    from repro_torch.models import model
    from repro_torch.serve import engine
    dev = torch.device(DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    n_layers = len(params["layers"])
    print(f"{MOE_ARCH}: {n_layers} layers ({cfg.first_dense_layers} dense "
          f"of d_ff {cfg.dense_d_ff}, then MoE: {cfg.num_experts} experts "
          f"of d_ff {cfg.moe_d_ff}, top-{cfg.experts_per_token}, "
          f"{cfg.num_shared_experts} shared), d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads of "
          f"{cfg.head_dim}, {n_params} parameters ({cfg.param_count()} by "
          f"param_count, {cfg.active_param_count()} active a token), "
          f"{torch.cuda.memory_allocated() - held} bytes, made on the card "
          f"in {time.perf_counter() - t0:.3f} s")
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=g, device=dev)
    cache_len = LM_PROMPT + LM_NEW
    # the first calls build cuBLAS handles for the experts' row counts
    # (and, over a mesh, open its communicator): not measured
    engine.generate(params, prompt, cfg, ctx, max_new_tokens=2,
                    cache_len=cache_len)
    timings = {}
    out, launches, _ = drive(label, lambda: engine.generate(
        params, prompt, cfg, ctx, max_new_tokens=LM_NEW,
        cache_len=cache_len, timings=timings))
    check(launches["flash_attention_wgmma"] == n_layers and
          sum(launches.values()) == n_layers,
          f"{label} launched {launches}; want flash_attention_wgmma once a "
          f"layer ({n_layers}) and nothing else")
    check(tuple(out.shape) == (LM_BATCH, LM_NEW) and
          0 <= out.min().item() and
          out.max().item() < cfg.padded_vocab_size,
          f"generated {tuple(out.shape)} ids in [{out.min().item()}, "
          f"{out.max().item()}]")
    pre_s, dec_s = timings["prefill_s"], timings["decode_s"]
    print(f"prefill: {LM_BATCH * LM_PROMPT} tokens in {pre_s} s, "
          f"{LM_BATCH * LM_PROMPT / pre_s} tokens/s ({card})")
    print(f"decode: {LM_NEW - 1} steps of {LM_BATCH} in {dec_s} s, "
          f"{dec_s / (LM_NEW - 1) * 1e3} ms per step ({card})")
    print(f"first generated ids: {out[:, :8].tolist()}")
    return params, prompt, cache_len, out, launches


def _moe_serve(cfg, held, card, profile):
    """bf16 at full width and depth through ``engine.generate``."""
    import dataclasses
    import torch
    from repro_torch.models.layers import ModelContext
    from repro_torch.serve import engine
    ctx = ModelContext()
    params, prompt, cache_len, out, launches = _moe_generate(
        f"{MOE_ARCH} generate", cfg, ctx, held, card)
    n_layers = len(params["layers"])
    prefill = engine.make_prefill_step(cfg, ctx, cache_len)
    (_, got), records = _capture_routes(lambda: prefill(params, prompt))
    loads = [torch.bincount(r["idx"].reshape(-1),
                            minlength=cfg.num_experts) for r in records]
    check(len(records) == n_layers - cfg.first_dense_layers and
          all(int(c.sum()) == LM_BATCH * LM_PROMPT * cfg.experts_per_token
              for c in loads), f"{len(records)} MoE layers routed")
    aux = torch.stack([r["aux"] for r in records])
    print(f"expert rows per MoE layer of the prefill (fewest, most of "
          f"{cfg.num_experts} experts; {LM_BATCH * LM_PROMPT} tokens x "
          f"{cfg.experts_per_token} = "
          f"{LM_BATCH * LM_PROMPT * cfg.experts_per_token} rows, "
          f"{LM_BATCH * LM_PROMPT * cfg.experts_per_token // cfg.num_experts}"
          f" each if even): "
          f"{[(int(c.min()), int(c.max())) for c in loads]}")
    print(f"prefill aux summed over {len(records)} MoE layers: "
          f"{aux.sum().item()} (per layer {aux.tolist()})")
    check(bool(torch.isfinite(aux).all()), "non-finite aux")
    check(torch.equal(out[:, 0], got.argmax(dim=-1)),
          "generate's first token is not the prefill's argmax")
    (_, want), p_launches, p_s = drive(
        "prefill, plain attention", lambda: engine.make_prefill_step(
            cfg, dataclasses.replace(ctx, flash_kernel=False),
            cache_len)(params, prompt))
    check(sum(p_launches.values()) == 0, f"plain launches {p_launches}")
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "non-finite logits")
    scale = want.abs().max().item()
    print(f"bf16 last-position logits: kernel path vs plain attention max "
          f"abs diff / max |logit| = {(got - want).abs().max().item() / scale}"
          f" (bf16 noise, printed, not held; max |logit| {scale}); "
          f"plain-attention prefill {p_s} s")
    nbytes, flops = flash_work(LM_BATCH, LM_PROMPT, cfg.num_heads,
                               cfg.num_kv_heads, cfg.head_dim, True, 2)
    b_ms, b_by = bound_ms(nbytes, flops, chip_spec().peak_bf16_flops)
    print(f"flash_attention_wgmma a prefill layer: bound_ms {b_ms} ({b_by}: "
          f"{nbytes} B, {flops} FLOP); phase 4 holds and times the kernel "
          f"at this shape, the profile gives its ms a launch here")
    if profile:
        _profile_serving("moe ", cfg, ctx, params, prompt, cache_len)
    print(f"peak device memory over the bf16 part: "
          f"{torch.cuda.max_memory_allocated()} bytes ({card})")
    return {"flash_attention_wgmma": launches["flash_attention_wgmma"],
            "flash_attention": launches["flash_attention"]}


def _moe_float32_pair(cfg, card, runs, tol):
    """Float32 at full width, depth cut to ``MOE_CHECK_LAYERS`` (weights
    from seed 0, ``LM_BATCH`` x ``LM_PROMPT`` prompt tokens from seed 1),
    prefilled through both ``runs`` ((label, context, the launches it
    must make), the second the one held to): a routing decision that
    differs must be a near tie, and the last logits of the rows without
    a root flip must agree within ``tol`` of the largest |logit|.
    Returns each run's (launches, the kept masks of its ``routed_ep``
    calls)."""
    import dataclasses
    import torch
    from repro_torch.models import model
    from repro_torch.serve import engine
    dev = torch.device(DEV)
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=MOE_CHECK_LAYERS)
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg32)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=g, device=dev)
    done = []
    for label, ctx, want_launches in runs:
        step = engine.make_prefill_step(cfg32, ctx, LM_PROMPT)
        (((_, logits), records), kept), launches, _ = drive(
            f"float32 prefill ({MOE_CHECK_LAYERS} layers), {label}",
            lambda: _capture_keep(
                lambda: _capture_routes(lambda: step(params, prompt))))
        check(all(launches[n] == c for n, c in want_launches.items()) and
              sum(launches.values()) == sum(want_launches.values()),
              f"float32 {label} launched {launches}; want {want_launches}")
        check(bool(torch.isfinite(logits).all()),
              f"non-finite float32 logits, {label}")
        done.append((logits, records, launches, kept))
    (got, rec_a, _, _), (want, rec_b, _, _) = done
    per_layer, roots, flipped_rows = _root_flips(rec_a, rec_b)
    scale = want.abs().max().item()
    rel = (got - want).abs().max(dim=-1).values / scale
    print(f"float32 routing, {runs[0][0]} vs {runs[1][0]}: differing "
          f"decisions per MoE layer {per_layer} of {LM_BATCH * LM_PROMPT} "
          f"each; root flips (layer, row, position, gap) {roots} (gap "
          f"limit {MOE_GAP_TOL}); rows with a flip {flipped_rows}")
    print(f"float32 last-position logits: max abs diff / max |logit| by row "
          f"{rel.tolist()} (limit {tol} on rows without a flip; max |logit| "
          f"{scale}) ({card})")
    check(all(gap < MOE_GAP_TOL for _, _, _, gap in roots),
          f"a routing decision differs without a near tie: {roots}")
    clean = [row for row in range(LM_BATCH) if row not in flipped_rows]
    check(all(rel[row].item() < tol for row in clean),
          f"float32 prefill logits differ by {rel.tolist()} relative")
    return [(launches, kept) for _, _, launches, kept in done]


def _moe_float32_check(cfg, card):
    """Float32 at full width, depth cut to ``MOE_CHECK_LAYERS``: the
    FFMA kernel route against the plain loop, decision by decision and
    on the last logits."""
    import dataclasses
    from repro_torch.models.layers import ModelContext
    ctx = ModelContext()
    (k_launches, _), _ = _moe_float32_pair(cfg, card, (
        ("kernel path", ctx, {"flash_attention": MOE_CHECK_LAYERS}),
        ("plain attention", dataclasses.replace(ctx, flash_kernel=False),
         {})), LM_F32_REL_TOL)
    return {"flash_attention": k_launches["flash_attention"],
            "flash_attention_wgmma": k_launches["flash_attention_wgmma"]}


SSM_ARCHS = ("mamba2-370m", "zamba2-2.7b", "musicgen-medium")
#: flash kernel launches of one bf16 prefill at full depth: mamba2 has no
#: attention; zamba2's shared attention (head dim 80, the FFMA kernel in
#: bf16) is applied 9 times; musicgen has 48 layers at head dim 64 (wgmma)
SSM_PREFILL_LAUNCHES = {"mamba2-370m": {},
                        "zamba2-2.7b": {"flash_attention": 9},
                        "musicgen-medium": {"flash_attention_wgmma": 48}}
#: the float32 check's depth, full width: zamba2 at 2 super-blocks (12
#: Mamba2 layers, 2 applications of the shared attention), musicgen at 4
#: layers; then its FFMA launches a prefill
SSM_CHECK = {"zamba2-2.7b": (12, 2), "musicgen-medium": (4, 4)}
#: mamba2 in float32 at 4 layers: stepwise decode over the prompt's last
#: SSM_STREAM_TOKENS tokens against the chunked prefill's logits, within
#: tests/test_models.py's bound for chunked against stepwise SSD
SSM_STREAM_LAYERS, SSM_STREAM_TOKENS, SSM_STREAM_TOL = 4, 16, 0.08
PHASE15_LIMIT_S = 180


def phase_ssm(profile=False):
    """Phase 15: ``mamba2-370m``, ``zamba2-2.7b`` and ``musicgen-medium``
    served one at a time at full width and depth in bf16, each model's
    weights released before the next; then the float32 checks. Returns
    the flash kernels' launches of the phase. ``profile`` adds
    ``_profile`` over one bf16 prefill and 8 decode steps of each."""
    import torch
    from repro_torch.configs import get_config
    print("== phase 15: the SSM, hybrid and audio families serving at full "
          "width and depth")
    t_phase = time.perf_counter()
    card = smi_line()
    launches = {"flash_attention": 0, "flash_attention_wgmma": 0}
    for arch in SSM_ARCHS:
        held = held_report(f"phase 15 ({arch})")
        torch.cuda.reset_peak_memory_stats()
        for name, count in _ssm_serve(get_config(arch), held, card,
                                      profile).items():
            launches[name] += count
    for arch in SSM_CHECK:
        gc.collect()
        torch.cuda.empty_cache()
        for name, count in _ssm_float32_check(get_config(arch),
                                              card).items():
            launches[name] += count
    gc.collect()
    torch.cuda.empty_cache()
    _ssm_stream_check(get_config("mamba2-370m"), card)
    dt = time.perf_counter() - t_phase
    print(f"phase 15: {dt} s (limit {PHASE15_LIMIT_S} s); launches "
          f"{launches} ({card})")
    check(dt <= PHASE15_LIMIT_S, f"phase 15 took {dt} s")
    return launches


def _ssm_serve(cfg, held, card, profile):
    """bf16 at full width and depth through ``engine.generate``: the
    launches of one generate (its prefill's), exactly the expected."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.serve import engine
    dev = torch.device(DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    specs = model.layer_specs(cfg)
    n_attn = sum(spec.kind == "attn" for spec in specs)
    print(f"{cfg.name} ({cfg.family}): {len(specs)} layer applications "
          f"({len(specs) - n_attn} Mamba2, {n_attn} attention"
          f"{', one shared set' if cfg.family == 'hybrid' else ''}), "
          f"d_model {cfg.d_model}, "
          + (f"SSM {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
             f"{cfg.ssm_state}, " if cfg.ssm_state else "")
          + (f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads of "
             f"{cfg.head_dim}, " if n_attn else "")
          + f"{sum(t.numel() for t in tree.leaves(params))} parameters "
          f"({cfg.param_count()} by param_count), "
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
    out, launches, _ = drive(
        f"{cfg.name} generate", lambda: engine.generate(
            params, prompt, cfg, ctx, max_new_tokens=LM_NEW,
            cache_len=cache_len, timings=timings))
    want = {name: SSM_PREFILL_LAUNCHES[cfg.name].get(name, 0)
            for name in launches}
    check(launches == want, f"{cfg.name} generate launched {launches}; "
                            f"want {want}")
    check(tuple(out.shape) == (LM_BATCH, LM_NEW) and
          0 <= out.min().item() and
          out.max().item() < cfg.padded_vocab_size,
          f"generated {tuple(out.shape)} ids in [{out.min().item()}, "
          f"{out.max().item()}]")
    pre_s, dec_s = timings["prefill_s"], timings["decode_s"]
    print(f"prefill: {LM_BATCH * LM_PROMPT} tokens in {pre_s} s, "
          f"{LM_BATCH * LM_PROMPT / pre_s} tokens/s ({card})")
    print(f"decode: {LM_NEW - 1} steps of {LM_BATCH} in {dec_s} s, "
          f"{dec_s / (LM_NEW - 1) * 1e3} ms per step ({card})")
    print(f"first generated ids: {out[:, :8].tolist()}")
    prefill = engine.make_prefill_step(cfg, ctx, cache_len)
    (_, got), k_launches, _ = drive("prefill, kernel path",
                                    lambda: prefill(params, prompt))
    check(k_launches == want, f"prefill launched {k_launches}; want {want}")
    (_, plain), p_launches, p_s = drive(
        "prefill, plain attention", lambda: engine.make_prefill_step(
            cfg, dataclasses.replace(ctx, flash_kernel=False),
            cache_len)(params, prompt))
    check(sum(p_launches.values()) == 0, f"plain launches {p_launches}")
    check(bool(torch.isfinite(got).all() and torch.isfinite(plain).all()),
          "non-finite logits")
    check(torch.equal(out[:, 0], got.argmax(dim=-1)),
          "generate's first token is not the prefill's argmax")
    scale = plain.abs().max().item()
    print(f"bf16 last-position logits: kernel path vs plain attention max "
          f"abs diff / max |logit| = "
          f"{(got - plain).abs().max().item() / scale} (bf16 noise, "
          f"printed, not held; max |logit| {scale}); plain-attention "
          f"prefill {p_s} s")
    print(f"peak device memory: {torch.cuda.max_memory_allocated()} bytes "
          f"({held} held before; {card})")
    if profile:
        _profile_serving(f"{cfg.name} ", cfg, ctx, params, prompt,
                         cache_len)
    del params, got, plain
    return {"flash_attention": launches["flash_attention"],
            "flash_attention_wgmma": launches["flash_attention_wgmma"]}


def _ssm_float32_check(cfg, card):
    """Float32 at full width, depth cut (``SSM_CHECK``): the FFMA kernel
    route's last logits against the plain loop's within
    ``LM_F32_REL_TOL`` of the largest logit."""
    import dataclasses
    import torch
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.serve import engine
    layers, ffma = SSM_CHECK[cfg.name]
    dev = torch.device(DEV)
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=layers)
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg32)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=g, device=dev)
    ctx = ModelContext()
    (_, got), k_launches, k_s = drive(
        f"{cfg.name} float32 prefill ({layers} layers), kernel path",
        lambda: engine.make_prefill_step(cfg32, ctx, LM_PROMPT)(params,
                                                                prompt))
    (_, want), p_launches, p_s = drive(
        f"{cfg.name} float32 prefill ({layers} layers), plain attention",
        lambda: engine.make_prefill_step(
            cfg32, dataclasses.replace(ctx, flash_kernel=False),
            LM_PROMPT)(params, prompt))
    check(k_launches["flash_attention"] == ffma and
          sum(k_launches.values()) == ffma and
          sum(p_launches.values()) == 0,
          f"float32 launches {k_launches} / {p_launches}; want "
          f"flash_attention {ffma} and nothing else")
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "non-finite float32 logits")
    scale = want.abs().max().item()
    rel = (got - want).abs().max().item() / scale
    print(f"{cfg.name} float32 last-position logits: kernel path vs plain "
          f"attention max abs diff / max |logit| = {rel} (limit "
          f"{LM_F32_REL_TOL}; max |logit| {scale}); prefill {k_s} s vs "
          f"{p_s} s ({card})")
    check(rel < LM_F32_REL_TOL, f"{cfg.name} float32 prefill logits differ "
                                f"by {rel} relative")
    return {"flash_attention": k_launches["flash_attention"],
            "flash_attention_wgmma": k_launches["flash_attention_wgmma"]}


def _ssm_stream_check(cfg, card):
    """mamba2 in float32 at full width, ``SSM_STREAM_LAYERS`` layers: the
    chunked prefill of the first S - T tokens, then T decode steps, must
    give the chunked prefill's logits of all S within
    ``SSM_STREAM_TOL`` of the largest logit."""
    import dataclasses
    import torch
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.serve import engine
    dev = torch.device(DEV)
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=SSM_STREAM_LAYERS)
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg32)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=g, device=dev)
    ctx = ModelContext()
    head = LM_PROMPT - SSM_STREAM_TOKENS
    decode = engine.make_decode_step(cfg32, ctx)

    def stream():
        caches, logits = engine.make_prefill_step(cfg32, ctx, LM_PROMPT)(
            params, prompt[:, :head])
        for t in range(head, LM_PROMPT):
            caches, logits = decode(params, caches, prompt[:, t:t + 1], t)
        return logits
    (_, want), _, _ = drive(f"{cfg.name} float32 prefill of {LM_PROMPT} "
                            f"({SSM_STREAM_LAYERS} layers)",
                            lambda: engine.make_prefill_step(
                                cfg32, ctx, LM_PROMPT)(params, prompt))
    got, launches, _ = drive(f"{cfg.name} float32 prefill of {head}, then "
                             f"{SSM_STREAM_TOKENS} decode steps", stream)
    check(sum(launches.values()) == 0, f"mamba2 launched {launches}")
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "non-finite float32 logits")
    scale = want.abs().max().item()
    rel = (got - want).abs().max().item() / scale
    print(f"{cfg.name} float32: stepwise decode over the last "
          f"{SSM_STREAM_TOKENS} tokens vs the chunked prefill, max abs "
          f"diff / max |logit| = {rel} (limit {SSM_STREAM_TOL}; max "
          f"|logit| {scale}) ({card})")
    check(rel < SSM_STREAM_TOL, f"stepwise decode differs by {rel} "
                                f"relative from the chunked scan")


LG_ARCH = "gemma3-4b"       # full width and depth in bf16 (~9.10 GB)
#: the float32 check: full width, a two-stage cut in depth (one block of
#: 5 window layers and a global one, then 2 window layers, ~8.4 GB),
#: prompts of a multiple of the window and of another length, each
#: followed by LG_CHECK_STEPS teacher-forced decode steps held to the
#: forward over the same tokens within LM_F32_REL_TOL
LG_CHECK_LAYERS = 8
LG_CHECK_PROMPTS = (2048, 1500)
LG_CHECK_STEPS = 8
PHASE16_LIMIT_S = 180


def phase_local_global(profile=False):
    """Phase 16: ``gemma3-4b`` served at full width and depth in bf16,
    then the float32 check of its ring caches at a two-stage cut; returns
    the hand-written kernels' launches of the phase (none: head dim 256
    and sliding windows take the plain loop). ``profile`` adds
    ``_profile`` over one bf16 prefill and 8 decode steps."""
    import torch
    from repro_torch.configs import get_config
    print(f"== phase 16: {LG_ARCH} (the local/global family) serving at "
          f"full width and depth")
    t_phase = time.perf_counter()
    card = smi_line()
    held = held_report("phase 16")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LG_ARCH)
    launches = _lg_serve(cfg, held, card, profile)
    gc.collect()
    torch.cuda.empty_cache()
    for name, count in _lg_float32_check(cfg, card).items():
        launches[name] += count
    dt = time.perf_counter() - t_phase
    print(f"phase 16: {dt} s (limit {PHASE16_LIMIT_S} s); peak device "
          f"memory {torch.cuda.max_memory_allocated()} bytes ({held} held "
          f"before the phase); launches {launches} ({card})")
    check(not any(launches.values()),
          f"phase 16 launched a hand-written kernel: {launches}")
    check(dt <= PHASE16_LIMIT_S, f"phase 16 took {dt} s")
    return launches


def _lg_serve(cfg, held, card, profile):
    """bf16 at full width and depth through ``engine.generate``: no
    hand-written kernel launches; prints prefill tokens/s, decode ms a
    step, the caches' rows and the peak; then the plain loop's time at a
    global and a window layer's attention beside SDPA's and the bound."""
    import torch
    from repro_torch import tree
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.serve import engine
    dev = torch.device(DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    specs = model.layer_specs(cfg)
    n_window = sum(bool(spec.window) for spec in specs)
    print(f"{cfg.name} ({cfg.family}): {len(specs)} layers ({n_window} "
          f"with a window of {cfg.sliding_window}, "
          f"{len(specs) - n_window} global; plan "
          f"{[(st.repeat, len(st.layers)) for st in cfg.plan()]}), "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads over "
          f"{cfg.num_kv_heads} KV heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}, {sum(t.numel() for t in tree.leaves(params))} "
          f"parameters ({cfg.param_count()} by param_count), "
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
    out, launches, _ = drive(
        f"{cfg.name} generate", lambda: engine.generate(
            params, prompt, cfg, ctx, max_new_tokens=LM_NEW,
            cache_len=cache_len, timings=timings))
    check(not any(launches.values()),
          f"{cfg.name} generate launched {launches}; want none")
    check(tuple(out.shape) == (LM_BATCH, LM_NEW) and
          0 <= out.min().item() and
          out.max().item() < cfg.padded_vocab_size,
          f"generated {tuple(out.shape)} ids in [{out.min().item()}, "
          f"{out.max().item()}]")
    pre_s, dec_s = timings["prefill_s"], timings["decode_s"]
    print(f"prefill: {LM_BATCH * LM_PROMPT} tokens in {pre_s} s, "
          f"{LM_BATCH * LM_PROMPT / pre_s} tokens/s ({card})")
    print(f"decode: {LM_NEW - 1} steps of {LM_BATCH} in {dec_s} s, "
          f"{dec_s / (LM_NEW - 1) * 1e3} ms per step ({card})")
    print(f"first generated ids: {out[:, :8].tolist()}")
    (caches, logits), p_launches, p_s = drive(
        "prefill", lambda: engine.make_prefill_step(cfg, ctx, cache_len)(
            params, prompt))
    check(not any(p_launches.values()), f"prefill launched {p_launches}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(torch.equal(out[:, 0], logits.argmax(dim=-1)),
          "generate's first token is not the prefill's argmax")
    rows = sorted({(spec.window, c[0].shape[1])
                   for spec, c in zip(specs, caches)})
    want_rows = sorted({(cfg.sliding_window, cfg.sliding_window),
                        (0, cache_len)})
    check(rows == want_rows, f"cache rows {rows}; want {want_rows}")
    kv_bytes = sum(t.untyped_storage().nbytes() for c in caches for t in c)
    print(f"caches: (window, rows) {rows}, {kv_bytes} bytes of KV cache "
          f"for {len(caches)} layers")
    del caches, logits
    print(f"peak device memory: {torch.cuda.max_memory_allocated()} bytes "
          f"({held} held before; {card})")
    if profile:
        _profile_serving(f"{cfg.name} ", cfg, ctx, params, prompt,
                         cache_len)
    del params
    _lg_attention_times(cfg, card)
    return {"flash_attention": launches["flash_attention"],
            "flash_attention_wgmma": launches["flash_attention_wgmma"]}


def _lg_attention_times(cfg, card):
    """The plain loop at the prefill's global-layer and window-layer
    attention (4 x 2048, 8/4 heads of 256, causal, bf16), eager, beside
    SDPA (a yardstick the port never calls) and the bound of the global
    layer's work at the bf16 rate: what a head-dim-256 kernel is to
    beat."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers
    B, S, H, KV, D = (LM_BATCH, LM_PROMPT, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim)
    q, k, v = _flash_inputs((B, S, H, KV, D), torch.bfloat16, 16)
    plain = {w: cuda_ms(lambda w=w: layers.attention(
        q, k, v, causal=True, window=w), iters=5, warmup=1, graph=False)
        for w in (0, cfg.sliding_window)}
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True), iters=10, warmup=2,
        graph=False)
    nbytes, flops = flash_work(B, S, H, KV, D, True, 2)
    bound, by = bound_ms(nbytes, flops, chip_spec().peak_bf16_flops)
    n_global = sum(not spec.window
                   for st in cfg.plan() for _ in range(st.repeat)
                   for spec in st.layers)
    print(f"plain attention loop, {B} x {S}, {H}/{KV} heads of {D}, "
          f"causal, bf16: global layer {plain[0]} ms (x {n_global} = "
          f"{plain[0] * n_global} ms of a prefill), window layer "
          f"{plain[cfg.sliding_window]} ms; SDPA {sdpa} ms; bound {bound} "
          f"ms ({by}, bf16 rate) ({card})")


def _lg_float32_check(cfg, card):
    """Float32 at full width, ``LG_CHECK_LAYERS`` layers (two stages):
    for each prompt length, the prefill's last logits and
    ``LG_CHECK_STEPS`` teacher-forced decode steps' logits against the
    forward over the same tokens, within ``LM_F32_REL_TOL`` of its
    largest logit. At 1500 the window layers' rings wrap out of the
    prompt's order, as at no multiple of the window."""
    import dataclasses
    import torch
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.serve import engine
    dev = torch.device(DEV)
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=LG_CHECK_LAYERS)
    stages = [(st.repeat, len(st.layers)) for st in cfg32.plan()]
    check(len(stages) == 2, f"the float32 cut's plan {stages}")
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg32)
    ctx = ModelContext()
    launches = {"flash_attention": 0, "flash_attention_wgmma": 0}
    for S in LG_CHECK_PROMPTS:
        g = torch.Generator(device=dev).manual_seed(2)
        tokens = torch.randint(0, cfg.vocab_size,
                               (LM_BATCH, S + LG_CHECK_STEPS), generator=g,
                               device=dev)
        decode = engine.make_decode_step(cfg32, ctx)

        def served():
            caches, logits = engine.make_prefill_step(
                cfg32, ctx, S + LG_CHECK_STEPS)(params, tokens[:, :S])
            out = [logits]
            for t in range(S, S + LG_CHECK_STEPS):
                caches, logits = decode(params, caches,
                                        tokens[:, t:t + 1], t)
                out.append(logits)
            return torch.stack(out, dim=1)

        def forward():
            hid, _ = model.forward(params, tokens, cfg32, ctx)
            return (hid[:, S - 1:] @ params["unembed"]).float()
        want, f_launches, f_s = drive(
            f"{cfg.name} float32 ({LG_CHECK_LAYERS} layers, plan {stages}) "
            f"forward over {S} + {LG_CHECK_STEPS} tokens", forward)
        got, s_launches, s_s = drive(
            f"{cfg.name} float32 prefill of {S}, then {LG_CHECK_STEPS} "
            f"decode steps", served)
        for name in launches:
            launches[name] += f_launches[name] + s_launches[name]
        check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
              "non-finite float32 logits")
        scale = want.abs().max().item()
        per_step = ((got - want).abs().amax(dim=(0, 2)) / scale).tolist()
        rel = max(per_step)
        print(f"{cfg.name} float32, prompt {S}: prefill and decode logits "
              f"vs the forward's, max abs diff / max |logit| = {rel} "
              f"(limit {LM_F32_REL_TOL}; max |logit| {scale}; by step "
              f"{per_step}) ({card})")
        check(rel < LM_F32_REL_TOL, f"{cfg.name} float32 prompt {S}: "
                                    f"served logits differ by {rel}")
        del got, want
    del params
    return launches


MLA_ARCH = "deepseek-v3-671b"
#: full width, depth cut to fit one card (671 B parameters in all): both
#: stages of the plan, 3 dense MLA layers and 1 MoE MLA layer with all
#: 256 routed experts, and the MTP module (~16.1 B parameters, ~32.2 GB)
MLA_LAYERS = 4
#: lm_loss's batch: 1 x MLA_LOSS_SEQ inputs (MLA_LOSS_SEQ + 1 tokens)
MLA_LOSS_SEQ = 2048
#: the float32 check: full attention width, 1 dense and 1 MoE layer and
#: the MTP module; the experts cut to 16 (still top-8; 4.3 B parameters,
#: ~17 GB): the check is of MLA and MTP, not of routing. Its prompt is
#: 1024 tokens, so that the forward over prompt + steps (1032 rows, one
#: query block) keeps its float32 score blocks near 2 GB at 128 heads
MLA_CHECK_LAYERS = 2
MLA_CHECK_EXPERTS = 16
MLA_CHECK_PROMPT = 1024
MLA_CHECK_STEPS = 8
PHASE17_LIMIT_S = 180


def phase_mla(profile=False):
    """Phase 17: ``deepseek-v3-671b`` (MLA, MoE, MTP) served at full
    width in bf16, depth cut to ``MLA_LAYERS``, then one ``lm_loss`` with
    the MTP head, then the float32 checks at ``MLA_CHECK_LAYERS``;
    returns the flash kernels' launches of the phase. ``profile`` adds
    ``_profile`` over one bf16 prefill and 8 decode steps."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    print(f"== phase 17: {MLA_ARCH} (MLA and MTP) serving at full width, "
          f"{MLA_LAYERS} layers")
    t_phase = time.perf_counter()
    card = smi_line()
    held = held_report("phase 17")
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MLA_ARCH), num_layers=MLA_LAYERS)
    check([(st.repeat, st.layers[0].kind, st.layers[0].ffn)
           for st in cfg.plan()] == [(3, "mla", "dense"), (1, "mla", "moe")],
          f"the cut's plan {cfg.plan()}")
    launches = _mla_serve(cfg, held, card, profile)
    gc.collect()
    torch.cuda.empty_cache()
    for name, count in _mla_float32_check(cfg, card).items():
        launches[name] += count
    dt = time.perf_counter() - t_phase
    print(f"phase 17: {dt} s (limit {PHASE17_LIMIT_S} s); peak device "
          f"memory {torch.cuda.max_memory_allocated()} bytes ({held} held "
          f"before the phase); launches {launches} ({card})")
    check(dt <= PHASE17_LIMIT_S, f"phase 17 took {dt} s")
    return launches


def _mla_attention_times(cfg, card):
    """The plain loop at an MLA layer's prefill attention (4 x 2048, 128
    heads, q and k 192 wide, v 128, causal, scale 1/sqrt(192), bf16),
    eager, beside SDPA (a yardstick the port never calls) and the bound
    of its work at the bf16 rate: what an MLA kernel is to beat."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers
    B, S, H = LM_BATCH, LM_PROMPT, cfg.num_heads
    dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    dv = cfg.v_head_dim
    g = torch.Generator(device=DEV).manual_seed(17)
    q, k = [(2.0 * torch.randn(B, S, H, dqk, generator=g, device=DEV))
            .to(torch.bfloat16) for _ in range(2)]
    v = torch.randn(B, S, H, dv, generator=g, device=DEV).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(dqk)
    plain = cuda_ms(lambda: layers.attention(q, k, v, causal=True,
                                             scale=scale),
                    iters=3, warmup=1, graph=False)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, scale=scale), iters=10, warmup=2,
        graph=False)
    pairs = S * (S + 1) // 2
    nbytes = B * S * H * (2 * dqk + 2 * dv) * 2
    flops = 2 * B * H * pairs * (dqk + dv)
    bound, by = bound_ms(nbytes, flops, chip_spec().peak_bf16_flops)
    print(f"plain attention loop, MLA prefill layer, {B} x {S}, {H} heads, "
          f"q/k {dqk} and v {dv} wide, causal, bf16: {plain} ms (x "
          f"{cfg.num_layers} layers = {plain * cfg.num_layers} ms of a "
          f"prefill); SDPA {sdpa} ms; bound {bound} ms ({by}: {nbytes} B, "
          f"{flops} FLOP at the bf16 rate) ({card})")


def _mla_serve(cfg, held, card, profile):
    """bf16 at full width through ``engine.generate``: no hand-written
    kernel launches (MLA prefill takes the plain loop, decode the
    absorbed latent path); prints prefill tokens/s, decode ms a step,
    the latent caches' bytes and the peak; the plain loop's time at an
    MLA layer beside SDPA and the bound; then one ``lm_loss`` under
    ``no_grad`` at 1 x ``MLA_LOSS_SEQ``, whose MTP layer (GQA attention,
    128/128 heads of 128) launches ``flash_attention_wgmma`` exactly
    once."""
    import torch
    from repro_torch import tree
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.serve import engine
    dev = torch.device(DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    n_mtp = sum(t.numel() for t in tree.leaves(params["mtp"]))
    print(f"{cfg.name} ({cfg.family}, MLA): {cfg.num_layers} layers "
          f"({cfg.first_dense_layers} dense of d_ff {cfg.dense_d_ff}, then "
          f"MoE: {cfg.num_experts} experts of d_ff {cfg.moe_d_ff}, "
          f"top-{cfg.experts_per_token}, {cfg.num_shared_experts} shared), "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads, MLA ranks "
          f"q {cfg.q_lora_rank} kv {cfg.kv_lora_rank}, nope/rope/v "
          f"{cfg.qk_nope_head_dim}/{cfg.qk_rope_head_dim}/"
          f"{cfg.v_head_dim}; MTP module (GQA {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, dense FFN) "
          f"{n_mtp} parameters; {n_params} parameters in all "
          f"({cfg.param_count()} by param_count without MTP, "
          f"{cfg.active_param_count()} active a token), "
          f"{torch.cuda.memory_allocated() - held} bytes, made on the card "
          f"in {time.perf_counter() - t0:.3f} s")
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=g, device=dev)
    cache_len = LM_PROMPT + LM_NEW
    ctx = ModelContext()
    # first calls build cuBLAS handles for the experts' row counts: not
    # measured
    engine.generate(params, prompt, cfg, ctx, max_new_tokens=2,
                    cache_len=cache_len)
    timings = {}
    out, launches, _ = drive(
        f"{cfg.name} generate", lambda: engine.generate(
            params, prompt, cfg, ctx, max_new_tokens=LM_NEW,
            cache_len=cache_len, timings=timings))
    check(not any(launches.values()),
          f"{cfg.name} generate launched {launches}; want none")
    check(tuple(out.shape) == (LM_BATCH, LM_NEW) and
          0 <= out.min().item() and
          out.max().item() < cfg.padded_vocab_size,
          f"generated {tuple(out.shape)} ids in [{out.min().item()}, "
          f"{out.max().item()}]")
    pre_s, dec_s = timings["prefill_s"], timings["decode_s"]
    print(f"prefill: {LM_BATCH * LM_PROMPT} tokens in {pre_s} s, "
          f"{LM_BATCH * LM_PROMPT / pre_s} tokens/s ({card})")
    print(f"decode: {LM_NEW - 1} steps of {LM_BATCH} in {dec_s} s, "
          f"{dec_s / (LM_NEW - 1) * 1e3} ms per step ({card})")
    print(f"first generated ids: {out[:, :8].tolist()}")
    (caches, logits), p_launches, _ = drive(
        "prefill", lambda: engine.make_prefill_step(cfg, ctx, cache_len)(
            params, prompt))
    check(not any(p_launches.values()), f"prefill launched {p_launches}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(torch.equal(out[:, 0], logits.argmax(dim=-1)),
          "generate's first token is not the prefill's argmax")
    shapes = {tuple(t.shape) for c in caches for t in c}
    want = {(LM_BATCH, cache_len, cfg.kv_lora_rank),
            (LM_BATCH, cache_len, cfg.qk_rope_head_dim)}
    check(shapes == want, f"latent cache shapes {shapes}; want {want}")
    kv_bytes = sum(t.untyped_storage().nbytes() for c in caches for t in c)
    per_row = kv_bytes // (len(caches) * LM_BATCH * cache_len)
    print(f"latent caches: {sorted(shapes)}, {kv_bytes} bytes for "
          f"{len(caches)} layers ({per_row} bytes a row and layer)")
    del caches, logits
    if profile:
        _profile_serving(f"{cfg.name} ", cfg, ctx, params, prompt,
                         cache_len)
    print(f"peak device memory over serving: "
          f"{torch.cuda.max_memory_allocated()} bytes ({held} held before; "
          f"{card})")
    _mla_attention_times(cfg, card)

    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (1, MLA_LOSS_SEQ + 1),
                           generator=g, device=dev)
    with torch.no_grad():
        (loss, metrics), l_launches, l_s = drive(
            f"lm_loss with MTP, 1 x {MLA_LOSS_SEQ}", lambda: model.lm_loss(
                params, {"tokens": tokens}, cfg, ctx))
    check(l_launches["flash_attention_wgmma"] == 1 and
          sum(l_launches.values()) == 1,
          f"lm_loss launched {l_launches}; want flash_attention_wgmma once "
          f"(the MTP layer)")
    vals = {k: v.item() for k, v in metrics.items()}
    print(f"lm_loss: {vals} in {l_s} s ({card})")
    check(set(vals) == {"ce", "aux", "mtp", "loss"} and
          all(math.isfinite(v) for v in vals.values()),
          f"lm_loss metrics {vals}")
    del params
    return {"flash_attention": l_launches["flash_attention"],
            "flash_attention_wgmma": l_launches["flash_attention_wgmma"]}


def _mla_float32_check(cfg, card):
    """Float32 at full attention width, ``MLA_CHECK_LAYERS`` layers (1
    dense, 1 MoE of ``MLA_CHECK_EXPERTS`` experts): (a) the prefill of
    ``MLA_CHECK_PROMPT`` tokens and ``MLA_CHECK_STEPS`` teacher-forced
    absorbed decode steps against the expanded forward over the same
    tokens, within ``LM_F32_REL_TOL`` of its largest logit, the decode
    steps' expert choices equal to the forward's (a choice may differ
    only at a near tie, ``MOE_GAP_TOL``); (b) the MTP layer on the kernel
    route (the FFMA kernel, float32 at head dim 128) against the plain
    loop within ``LM_F32_REL_TOL``, and ``lm_loss``'s ``mtp`` within
    1e-5 relative."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.serve import engine
    dev = torch.device(DEV)
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=MLA_CHECK_LAYERS,
                                first_dense_layers=1,
                                num_experts=MLA_CHECK_EXPERTS)
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg32)
    print(f"{cfg.name} float32 cut: {MLA_CHECK_LAYERS} layers, "
          f"{MLA_CHECK_EXPERTS} experts (top-{cfg.experts_per_token}), "
          f"{sum(t.numel() for t in tree.leaves(params))} parameters with "
          f"MTP, {torch.cuda.memory_allocated()} bytes")
    ctx = ModelContext()
    launches = {"flash_attention": 0, "flash_attention_wgmma": 0}
    S, steps = MLA_CHECK_PROMPT, MLA_CHECK_STEPS
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, S + steps),
                           generator=g, device=dev)
    decode = engine.make_decode_step(cfg32, ctx)

    def served():
        caches, logits = engine.make_prefill_step(cfg32, ctx, S + steps)(
            params, tokens[:, :S])
        out = [logits]
        for t in range(S, S + steps):
            caches, logits = decode(params, caches, tokens[:, t:t + 1], t)
            out.append(logits)
        return torch.stack(out, dim=1)

    def forward():
        hid, _ = model.forward(params, tokens, cfg32, ctx)
        return (hid[:, S - 1:] @ params["unembed"]).float()
    (want, f_routes), f_launches, _ = drive(
        f"{cfg.name} float32 forward over {S} + {steps} tokens",
        lambda: _capture_routes(forward))
    (got, s_routes), s_launches, _ = drive(
        f"{cfg.name} float32 prefill of {S}, then {steps} absorbed decode "
        f"steps", lambda: _capture_routes(served))
    for name in launches:
        launches[name] += f_launches[name] + s_launches[name]
    check(not any(launches.values()), f"MLA float32 launched {launches}")
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "non-finite float32 logits")
    # the forward's one MoE layer routes every position; the prefill
    # routes the prompt, then each decode step its one position
    fwd = f_routes[0]
    flips = []
    for i, rec in enumerate(s_routes[1:]):
        t = S + i
        rows = torch.arange(LM_BATCH, device=dev) * (S + steps) + t
        differ = (rec["idx"] != fwd["idx"][rows]).any(dim=-1)
        gaps = torch.maximum(rec["gap"], fwd["gap"][rows])
        flips += [(t, int(b), gaps[b].item())
                  for b in differ.nonzero()[:, 0]]
    check(len(s_routes) == 1 + steps and len(f_routes) == 1,
          f"{len(s_routes)} and {len(f_routes)} MoE routings")
    # a row whose choices differ (at a near tie) is not held on its logits
    clean = [b for b in range(LM_BATCH) if b not in {r for _, r, _ in flips}]
    scale = want.abs().max().item()
    per_step = ((got[clean] - want[clean]).abs().amax(dim=(0, 2)) /
                scale).tolist()
    rel = max(per_step)
    print(f"(a) {cfg.name} float32: absorbed decode vs the expanded "
          f"forward, max abs diff / max |logit| = {rel} over rows {clean} "
          f"(limit {LM_F32_REL_TOL}; max |logit| {scale}; by step "
          f"{per_step}); decode steps' expert choices differing from the "
          f"forward's (position, row, gap): {flips} (gap limit "
          f"{MOE_GAP_TOL}) ({card})")
    check(all(gap < MOE_GAP_TOL for _, _, gap in flips),
          f"an expert choice differs without a near tie: {flips}")
    check(clean, f"every row's expert choices differ: {flips}")
    check(rel < LM_F32_REL_TOL, f"absorbed decode differs by {rel}")
    del got, want

    g = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, MLA_LOSS_SEQ + 1),
                           generator=g, device=dev)
    plain_ctx = dataclasses.replace(ctx, flash_kernel=False)
    with torch.no_grad():
        hidden, _ = model.forward(params, tokens[:, :-1], cfg32, ctx)
        p = params["mtp"]
        hm = model.mtp_input(params, hidden, tokens[:, 1:], cfg32)
        positions = torch.arange(hm.shape[1], device=dev)[None, :]
        outs = {}
        for label, c in (("kernel path", ctx), ("plain loop", plain_ctx)):
            (y, _, _), lc, _ = drive(
                f"MTP layer, float32, {label}", lambda c=c: model._apply_layer(
                    model.MTP_SPEC, p, hm, cfg32, c, positions=positions))
            (_, m), lm_launches, _ = drive(
                f"lm_loss with MTP, float32, {label}", lambda c=c:
                model.lm_loss(params, {"tokens": tokens}, cfg32, c))
            outs[label] = (y, m, lc, lm_launches)
    (y_k, m_k, lc_k, ll_k), (y_p, m_p, lc_p, ll_p) = \
        outs["kernel path"], outs["plain loop"]
    check(lc_k["flash_attention"] == 1 and sum(lc_k.values()) == 1 and
          ll_k["flash_attention"] == 1 and sum(ll_k.values()) == 1 and
          not any(lc_p.values()) and not any(ll_p.values()),
          f"MTP float32 launches {lc_k} {ll_k} / {lc_p} {ll_p}")
    for name in launches:
        launches[name] += lc_k[name] + ll_k[name]
    y_rel = ((y_k - y_p).abs().max() / y_p.abs().max()).item()
    mtp_rel = abs(m_k["mtp"].item() - m_p["mtp"].item()) / \
        abs(m_p["mtp"].item())
    print(f"(b) MTP layer (1 x {MLA_LOSS_SEQ - 1}, GQA {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}), float32: kernel "
          f"route vs plain loop max abs diff / max |out| = {y_rel} (limit "
          f"{LM_F32_REL_TOL}); lm_loss mtp {m_k['mtp'].item()} vs "
          f"{m_p['mtp'].item()}, relative {mtp_rel} (limit 1e-5); ce "
          f"{m_k['ce'].item()} vs {m_p['ce'].item()} ({card})")
    check(y_rel < LM_F32_REL_TOL, f"MTP layer differs by {y_rel}")
    check(mtp_rel < 1e-5, f"MTP loss differs by {mtp_rel}")
    check(m_k["ce"].item() == m_p["ce"].item(),
          "the main loss moved with the MTP layer's route")
    del params
    return launches


VLM_ARCH = "llama-3.2-vision-90b"
#: full width, depth cut to fit one card (90 B parameters in all): two
#: super-blocks of 4 self-attention layers and a cross-attention one
#: (10.83 B parameters, ~21.7 GB)
VLM_LAYERS = 10
#: the float32 check: one super-block (6.4 B parameters, ~25.5 GB)
VLM_CHECK_LAYERS = 5
VLM_CHECK_STEPS = 8
PHASE18_LIMIT_S = 180


def _open_gates(params, cfg, seed):
    """Set each cross-attention layer's ``gate`` (0 at init, where
    tanh(gate) switches the layer off) to a seeded value in [0.5, 1.5):
    the weights are random, and a closed gate would leave the image
    unread."""
    import torch
    from repro_torch.models import model
    g = torch.Generator(device="cpu").manual_seed(seed)
    for layer, spec in zip(params["layers"], model.layer_specs(cfg)):
        if spec.kind == "cross_attn":
            layer["attn"]["gate"].fill_(0.5 + torch.rand((), generator=g)
                                        .item())


def _image_embeds(cfg, seed):
    """Stub patch embeddings ``[LM_BATCH, num_image_tokens, d_model]``,
    0.1 x normal (tests/test_models.py's), in the model dtype."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    return (0.1 * torch.randn(LM_BATCH, cfg.num_image_tokens, cfg.d_model,
                              generator=g, device=DEV)).to(
        getattr(torch, cfg.dtype))


def phase_vlm(profile=False):
    """Phase 18: ``llama-3.2-vision-90b`` (self-attention with a
    cross-attention layer every 5th layer over 1600 image tokens) served
    at full width in bf16, depth cut to ``VLM_LAYERS``, then the float32
    check at ``VLM_CHECK_LAYERS``; returns the flash kernels' launches of
    the phase. ``profile`` adds ``_profile`` over one bf16 prefill and 8
    decode steps."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    print(f"== phase 18: {VLM_ARCH} (the VLM family) serving at full "
          f"width, {VLM_LAYERS} layers")
    t_phase = time.perf_counter()
    card = smi_line()
    held = held_report("phase 18")
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(VLM_ARCH), num_layers=VLM_LAYERS)
    check([(st.repeat, len(st.layers)) for st in cfg.plan()] == [(2, 5)],
          f"the cut's plan {cfg.plan()}")
    launches = _vlm_serve(cfg, held, card, profile)
    gc.collect()
    torch.cuda.empty_cache()
    for name, count in _vlm_float32_check(cfg, card).items():
        launches[name] += count
    dt = time.perf_counter() - t_phase
    print(f"phase 18: {dt} s (limit {PHASE18_LIMIT_S} s); peak device "
          f"memory {torch.cuda.max_memory_allocated()} bytes ({held} held "
          f"before the phase); launches {launches} ({card})")
    check(dt <= PHASE18_LIMIT_S, f"phase 18 took {dt} s")
    return launches


def _vlm_serve(cfg, held, card, profile):
    """bf16 at full width through ``engine.generate`` with seeded image
    embeddings: ``flash_attention_wgmma`` exactly once a self-attention
    layer of a prefill (8) and never in decode; cross-attention (1600
    image rows, non-causal) takes the plain loop. Prints prefill
    tokens/s, decode ms a step, the peak, and the plain loop's time at a
    cross-attention layer beside SDPA and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch import tree
    from repro_torch.models import layers, model
    from repro_torch.models.layers import ModelContext
    from repro_torch.serve import engine
    dev = torch.device(DEV)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    _open_gates(params, cfg, 1)
    torch.cuda.synchronize()
    specs = model.layer_specs(cfg)
    n_self = sum(spec.kind == "attn" for spec in specs)
    print(f"{cfg.name} ({cfg.family}): {len(specs)} layers ({n_self} "
          f"self-attention, {len(specs) - n_self} cross-attention over "
          f"{cfg.num_image_tokens} image tokens), d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{sum(t.numel() for t in tree.leaves(params))} parameters "
          f"({cfg.param_count()} by param_count), "
          f"{torch.cuda.memory_allocated() - held} bytes, made on the card "
          f"in {time.perf_counter() - t0:.3f} s")
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=g, device=dev)
    img = _image_embeds(cfg, 2)
    cache_len = LM_PROMPT + LM_NEW
    ctx = ModelContext()
    # first calls build cuBLAS handles and load kernels: not measured
    engine.generate(params, prompt, cfg, ctx, max_new_tokens=2,
                    cache_len=cache_len, image_embeds=img)
    timings = {}
    out, launches, _ = drive(
        f"{cfg.name} generate", lambda: engine.generate(
            params, prompt, cfg, ctx, max_new_tokens=LM_NEW,
            cache_len=cache_len, image_embeds=img, timings=timings))
    check(launches["flash_attention_wgmma"] == n_self and
          sum(launches.values()) == n_self,
          f"{cfg.name} generate launched {launches}; want "
          f"flash_attention_wgmma once a self-attention layer ({n_self}) "
          f"and nothing else")
    check(tuple(out.shape) == (LM_BATCH, LM_NEW) and
          0 <= out.min().item() and
          out.max().item() < cfg.padded_vocab_size,
          f"generated {tuple(out.shape)} ids in [{out.min().item()}, "
          f"{out.max().item()}]")
    pre_s, dec_s = timings["prefill_s"], timings["decode_s"]
    print(f"prefill: {LM_BATCH * LM_PROMPT} tokens and "
          f"{LM_BATCH * cfg.num_image_tokens} image rows in {pre_s} s, "
          f"{LM_BATCH * LM_PROMPT / pre_s} tokens/s ({card})")
    print(f"decode: {LM_NEW - 1} steps of {LM_BATCH} in {dec_s} s, "
          f"{dec_s / (LM_NEW - 1) * 1e3} ms per step (the image K/V "
          f"recomputed at each step, as the reference) ({card})")
    print(f"first generated ids: {out[:, :8].tolist()}")
    (caches, logits), p_launches, _ = drive(
        "prefill", lambda: engine.make_prefill_step(cfg, ctx, cache_len)(
            params, prompt, img))
    check(p_launches["flash_attention_wgmma"] == n_self and
          sum(p_launches.values()) == n_self,
          f"prefill launched {p_launches}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(torch.equal(out[:, 0], logits.argmax(dim=-1)),
          "generate's first token is not the prefill's argmax")
    check([len(c) for c in caches] == [0 if s.kind == "cross_attn" else 2
                                        for s in specs],
          "a cross-attention layer holds a cache")
    (_, d_logits), d_launches, _ = drive(
        "decode step", lambda: engine.make_decode_step(cfg, ctx)(
            params, caches, out[:, :1], LM_PROMPT, img))
    check(not any(d_launches.values()), f"decode launched {d_launches}")
    _, other = engine.make_prefill_step(cfg, ctx, cache_len)(
        params, prompt, _image_embeds(cfg, 3))
    moved = (other - logits).abs().max().item()
    print(f"other image embeddings move the last logits by up to {moved}")
    check(moved > 0, "the image does not reach the logits")
    del caches, logits, d_logits, other
    if profile:
        _profile_serving(f"{cfg.name} ", cfg, ctx, params, prompt,
                         cache_len, image_embeds=img)
    print(f"peak device memory over serving: "
          f"{torch.cuda.max_memory_allocated()} bytes ({held} held before; "
          f"{card})")
    # the plain loop at a cross-attention layer's prefill attention
    B, S, H, KV, D, N = (LM_BATCH, LM_PROMPT, cfg.num_heads,
                         cfg.num_kv_heads, cfg.head_dim,
                         cfg.num_image_tokens)
    g = torch.Generator(device=DEV).manual_seed(18)
    q = (2.0 * torch.randn(B, S, H, D, generator=g, device=DEV)).to(
        torch.bfloat16)
    k = (2.0 * torch.randn(B, N, KV, D, generator=g, device=DEV)).to(
        torch.bfloat16)
    v = torch.randn(B, N, KV, D, generator=g, device=DEV).to(torch.bfloat16)
    plain = cuda_ms(lambda: layers.attention(q, k, v, causal=False),
                    iters=5, warmup=1, graph=False)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, enable_gqa=True), iters=10, warmup=2, graph=False)
    nbytes = (B * S * H * D * 2 + B * N * KV * D * 2) * 2
    flops = 4 * B * H * S * N * D
    bound, by = bound_ms(nbytes, flops, chip_spec().peak_bf16_flops)
    n_cross = len(specs) - n_self
    print(f"plain attention loop, cross-attention layer, {B} x {S} against "
          f"{N} image rows, {H}/{KV} heads of {D}, bf16: {plain} ms (x "
          f"{n_cross} = {plain * n_cross} ms of a prefill); SDPA {sdpa} "
          f"ms; bound {bound} ms ({by}: {nbytes} B, {flops} FLOP at the "
          f"bf16 rate) ({card})")
    del params
    return {"flash_attention": launches["flash_attention"],
            "flash_attention_wgmma": launches["flash_attention_wgmma"]}


def _vlm_float32_check(cfg, card):
    """Float32 at full width, ``VLM_CHECK_LAYERS`` layers (one super-
    block), with the bf16 phase's image embeddings in float32: (a) the
    prefill and ``VLM_CHECK_STEPS`` teacher-forced decode steps against
    the forward over the same tokens and image, within
    ``LM_F32_REL_TOL`` of its largest logit; (b) the prefill's logits on
    the kernel route (the FFMA kernel once a self-attention layer)
    against the plain loop, within ``LM_F32_REL_TOL``."""
    import dataclasses
    import torch
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.serve import engine
    dev = torch.device(DEV)
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=VLM_CHECK_LAYERS)
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg32)
    _open_gates(params, cfg32, 1)
    n_self = sum(s.kind == "attn" for s in model.layer_specs(cfg32))
    img = _image_embeds(cfg32, 2)
    ctx = ModelContext()
    plain_ctx = dataclasses.replace(ctx, flash_kernel=False)
    launches = {"flash_attention": 0, "flash_attention_wgmma": 0}
    S, steps = LM_PROMPT, VLM_CHECK_STEPS
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, S + steps),
                           generator=g, device=dev)
    decode = engine.make_decode_step(cfg32, ctx)

    def served():
        caches, logits = engine.make_prefill_step(cfg32, ctx, S + steps)(
            params, tokens[:, :S], img)
        out = [logits]
        for t in range(S, S + steps):
            caches, logits = decode(params, caches, tokens[:, t:t + 1], t,
                                    img)
            out.append(logits)
        return torch.stack(out, dim=1)

    def forward():
        hid, _ = model.forward(params, tokens, cfg32, ctx, image_embeds=img)
        return (hid[:, S - 1:] @ params["unembed"]).float()
    want, f_launches, _ = drive(
        f"{cfg.name} float32 ({VLM_CHECK_LAYERS} layers) forward over "
        f"{S} + {steps} tokens", forward)
    got, s_launches, _ = drive(
        f"{cfg.name} float32 prefill of {S}, then {steps} decode steps",
        served)
    check(f_launches["flash_attention"] == n_self and
          s_launches["flash_attention"] == n_self and
          sum(f_launches.values()) + sum(s_launches.values()) == 2 * n_self,
          f"float32 launches {f_launches} / {s_launches}")
    for name in launches:
        launches[name] += f_launches[name] + s_launches[name]
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "non-finite float32 logits")
    scale = want.abs().max().item()
    per_step = ((got - want).abs().amax(dim=(0, 2)) / scale).tolist()
    rel = max(per_step)
    print(f"(a) {cfg.name} float32: prefill and decode logits vs the "
          f"forward's, max abs diff / max |logit| = {rel} (limit "
          f"{LM_F32_REL_TOL}; max |logit| {scale}; by step {per_step}) "
          f"({card})")
    check(rel < LM_F32_REL_TOL, f"served logits differ by {rel}")
    runs = {}
    for label, c in (("kernel path", ctx), ("plain loop", plain_ctx)):
        (_, logits), lc, _ = drive(
            f"float32 prefill ({VLM_CHECK_LAYERS} layers), {label}",
            lambda c=c: engine.make_prefill_step(cfg32, c, S)(
                params, tokens[:, :S], img))
        runs[label] = (logits, lc)
    (got, k_launches), (want, p_launches) = \
        runs["kernel path"], runs["plain loop"]
    check(k_launches["flash_attention"] == n_self and
          sum(k_launches.values()) == n_self and
          not any(p_launches.values()),
          f"float32 launches {k_launches} / {p_launches}")
    for name in launches:
        launches[name] += k_launches[name]
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"(b) float32 last-position logits: kernel path vs plain loop "
          f"max abs diff / max |logit| = {rel} (limit {LM_F32_REL_TOL}) "
          f"({card})")
    check(rel < LM_F32_REL_TOL, f"float32 prefill logits differ by {rel}")
    del params
    return launches


#: phase 19: LM training of the non-dense families at full width.
#: (a) float32 loss and gradients at 1 x FAMILY_CHECK_SEQ, remat full, the
#: kernel route against the plain loop: each arch's cut and the
#: ``flash_attention`` launches of one ``loss_and_grads`` on the kernel
#: route (an attention layer's forward and its remat recompute; the MTP
#: layer, not under remat, once; windows, MLA and cross-attention take
#: the plain loop)
FAMILY_CHECK = {
    "deepseek-moe-16b": (dict(num_layers=2), 4),      # 1 dense + 1 MoE
    "zamba2-2.7b": (dict(num_layers=6), 2),           # one super-block
    "musicgen-medium": (dict(num_layers=2), 4),
    "deepseek-v3-671b": (dict(num_layers=1, first_dense_layers=1), 1),
    # 1 self + 1 cross, the interleave of the reference's reduced()
    "llama-3.2-vision-90b": (dict(num_layers=2, cross_attn_every=2), 2),
}
FAMILY_CHECK_SEQ = 512
#: its kernel-route gradients are computed twice and must repeat their
#: bits (the backward of the MoE layer's gathers)
FAMILY_REPEAT_BITS = "deepseek-moe-16b"
#: (b) bf16 AdamW steps at FAMILY_TRAIN_BATCH x FAMILY_TRAIN_SEQ on the
#: launcher's batches, ctx and optimizer: each arch's cut (the depth
#: whose predicted peak fits one card) and the launches of one step
FAMILY_TRAIN = {
    "deepseek-moe-16b": (dict(num_layers=4),          # 1 dense + 3 MoE
                         {"flash_attention_wgmma": 8}),
    "mamba2-370m": ({}, {}),                          # all 48 layers
    "zamba2-2.7b": ({}, {"flash_attention": 18}),     # all 54, D 80
    "musicgen-medium": ({}, {"flash_attention_wgmma": 96}),   # all 48
    "gemma3-4b": (dict(num_layers=6), {}),            # 5 window + 1 global
    # one dense MLA layer and the MTP module (a V3 MoE layer's 256
    # experts alone are 11.3 B parameters)
    "deepseek-v3-671b": (dict(num_layers=1, first_dense_layers=1),
                         {"flash_attention_wgmma": 1}),
}
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ = 2, 2048
#: 4 until phase 23 needed the time; step ms is the median of steps 2 on
FAMILY_TRAIN_STEPS = 2
#: the arch that also takes an int8-compressed and a microbatched step
FAMILY_EXTRA_STEPS = "deepseek-moe-16b"
#: (d) the launcher at each non-dense family's -smoke config
FAMILY_LAUNCHER_ARCHS = ("deepseek-moe-16b", "deepseek-v3-671b",
                         "mamba2-370m", "zamba2-2.7b", "musicgen-medium",
                         "gemma3-4b", "llama-3.2-vision-90b")
FAMILY_RESUME_ARCH = "llama-3.2-vision-90b"
#: (d)'s steps: each family's run, and the resumed arch's first run and
#: its resume (3, and 6 then 9, until phase 23 needed the time; 2, and 4
#: then 6, until phase 24 did)
FAMILY_LAUNCHER_STEPS = 1
FAMILY_RESUME_STEPS = (1, 2)
FAMILY_COUNT_TIMEOUT_S = 240
FAMILY_LAUNCHER_TIMEOUT_S = 240
PHASE19_LIMIT_S = 300

FAMILY_COUNT = """\
import dataclasses, json, sys, time
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import make_context
from repro_torch.kernels import build, ops
from repro_torch.launch import dryrun_lib
from repro_torch.models.layers import ModelContext
from repro_torch.train import OptimizerConfig
calls = []


def refuse(name):
    calls.append(name)
    raise RuntimeError(f"the dry-run reached kernel {name}")


build.kernel = refuse
arch, cut, seq, batch = sys.argv[1], json.loads(sys.argv[2]), \\
    int(sys.argv[3]), int(sys.argv[4])
cfg = dataclasses.replace(get_config(arch), **cut)
kw = dict(remat="full", q_chunk=256, k_chunk=256)
# "ep": the production mesh's context, whose MoE layers run routed_ep
ctx = make_context({"data": 1, "model": 1}, **kw) if sys.argv[5:] == \\
    ["ep"] else ModelContext(**kw)
t0 = time.perf_counter()
counts = dryrun_lib.count_cell(
    cfg, ShapeConfig("phase19_train", "train", seq, batch), ctx,
    opt_cfg=OptimizerConfig(lr=1e-3, warmup_steps=10))
print(json.dumps({"counts": counts, "seconds": time.perf_counter() - t0,
                  "cuda_initialized": torch.cuda.is_initialized(),
                  "launches": dict(ops.LAUNCHES), "build_calls": calls}))
"""


def phase_family_train(profile=False):
    """Phase 19: LM training of the non-dense families (MoE, MLA with
    MTP, SSM, hybrid, audio, local/global; the VLM's gradients) at full
    width on the card; returns the flash kernels' launches of the phase.
    ``profile`` adds ``_profile`` over one more step of each (b) cell."""
    import torch
    print("== phase 19: LM training of the non-dense families at full "
          "width")
    t_phase = time.perf_counter()
    card = smi_line()
    held_report("phase 19")
    procs = _family_counts_start()
    launchers = _family_launchers_start()
    # the V3 cell peaks at ~75.5 GB of the card's 85.0: with fixed
    # segments its AdamW found 9.5 GiB reserved and free in pieces too
    # small for a 3.45 GiB leaf and ran out; expandable segments map
    # pages into one growing segment. Set for this phase only, after
    # releasing the earlier phases' segments.
    torch.cuda.empty_cache()
    _allocator("expandable_segments:True")
    print("phase 19 allocator: expandable_segments:True")
    try:
        launches = {"flash_attention": 0, "flash_attention_wgmma": 0}
        for arch, (cut, want) in FAMILY_CHECK.items():
            for name, n in _family_routes_agree(arch, cut, want,
                                                card).items():
                launches[name] += n
            _release()
        print(f"(a) done at {time.perf_counter() - t_phase} s")
        _family_launchers_finish(*launchers)
        print(f"(d) done at {time.perf_counter() - t_phase} s")
        measured = {}
        for arch, (cut, want) in FAMILY_TRAIN.items():
            got, measured[arch] = _family_train_steps(arch, cut, want,
                                                      card, profile)
            for name, n in got.items():
                launches[name] += n
            _release()
        print(f"(b) done at {time.perf_counter() - t_phase} s")
        _family_peaks(procs, measured, card)
        MEASURED["family_train"] = {arch: {"step_s": m["step_s"],
                                           "peak": m["peak"]}
                                    for arch, m in measured.items()}
    finally:
        for p in list(procs.values()) + [launchers[2]]:
            if p.poll() is None:
                p.kill()
                p.wait()
        _release()
        _allocator("expandable_segments:False")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_phase
    print(f"phase 19: {dt} s (limit {PHASE19_LIMIT_S} s); launches "
          f"{launches} ({card})")
    check(dt <= PHASE19_LIMIT_S, f"phase 19 took {dt} s")
    return launches


def _allocator(setting):
    """Set the caching allocator's ``setting`` in this process (torch
    2.11 names the call deprecated; its successor is private too)."""
    import torch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        torch.cuda.memory._set_allocator_settings(setting)


def _release():
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _family_cfg(arch, cut, **kw):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **cut, **kw)


def _family_routes_agree(arch, cut, want, card):
    """(a): float32 ``loss_and_grads`` at full width through the FFMA
    kernel against the plain loop, from the same weights and batch; for
    ``FAMILY_REPEAT_BITS`` the kernel route once more, bit for bit."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.train.train_step import loss_and_grads
    cfg = _family_cfg(arch, cut, dtype="float32")
    dev = torch.device(DEV)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    if cfg.cross_attn_every:
        _open_gates(params, cfg, 1)
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, FAMILY_CHECK_SEQ + 1)).astype(np.int32)).to(
            dev)
    batch = {"tokens": tokens}
    if cfg.cross_attn_every:
        g = torch.Generator(device=dev).manual_seed(2)
        batch["image_embeds"] = 0.1 * torch.randn(
            1, cfg.num_image_tokens, cfg.d_model, generator=g, device=dev)
    specs = model.layer_specs(cfg)
    print(f"(a) {arch} in float32, cut to {len(specs)} layer applications "
          f"({', '.join(sorted({f'{s.kind}/{s.ffn}' for s in specs}))}"
          f"{', MTP' if 'mtp' in params else ''}"
          f"{f', {cfg.num_image_tokens} image rows' if cfg.cross_attn_every else ''}"
          f"): {sum(t.numel() for t in tree.leaves(params))} parameters, d "
          f"{cfg.d_model}; batch 1 x {FAMILY_CHECK_SEQ}, remat full")
    kernel = ModelContext(remat="full")
    runs = [("kernel", kernel),
            ("plain", ModelContext(remat="full", flash_kernel=False))]
    if arch == FAMILY_REPEAT_BITS:
        runs.append(("kernel again", kernel))
    out = {}
    for route, ctx in runs:
        ((loss, _), grads), got, dt = drive(
            f"(a) {arch} lm_loss and gradients, {route} route",
            lambda ctx=ctx: loss_and_grads(params, batch, cfg, ctx))
        out[route] = (loss, tree.flatten_with_names(grads), got, dt)
        del grads
    (k_loss, k_grads, k_launches, k_s), (p_loss, p_grads, p_launches, p_s) \
        = out["kernel"], out["plain"]
    check(k_launches["flash_attention"] == want and
          sum(k_launches.values()) == want,
          f"(a) {arch}: the kernel route launched {k_launches}, want {want} "
          f"flash_attention")
    check(sum(p_launches.values()) == 0,
          f"(a) {arch}: the plain route launched {p_launches}")
    rel = abs(k_loss.item() - p_loss.item()) / abs(p_loss.item())
    # a one-element leaf (a cross layer's gate) is one sum over every
    # B x S x d element of its layer's output, whose terms cancel: it is
    # held, after the other leaves, by its terms before that sum
    scalars = [name for name, g in p_grads.items() if g.numel() == 1]
    check(all(name.endswith("/attn/gate") for name in scalars),
          f"(a) {arch}: one-element leaves {scalars}")
    worst, worst_name, worst_diff = 0.0, "", 0.0
    for name, want_g in p_grads.items():
        if name in scalars:
            continue
        got_g = k_grads[name]
        scale = want_g.abs().max().item()
        check(scale > 0 and torch.isfinite(got_g).all().item(),
              f"(a) {arch} gradient {name}: max |g| {scale}")
        diff = (got_g - want_g).abs().max().item()
        if diff / scale >= worst:
            worst, worst_name, worst_diff = diff / scale, name, diff
    print(f"(a) {arch}: loss kernel route {k_loss.item()}, plain route "
          f"{p_loss.item()} (relative {rel}, limit {LM_LOSS_RTOL}); worst "
          f"gradient leaf {worst_name}: max difference {worst_diff}, "
          f"{worst} of its max |g| (limit {LM_GRAD_TOL}) over "
          f"{len(p_grads) - len(scalars)} leaves of more than one element; "
          f"{k_s} s kernel route, {p_s} s plain "
          f"route; peak device memory {torch.cuda.max_memory_allocated()} "
          f"bytes ({card})")
    check(rel <= LM_LOSS_RTOL, f"(a) {arch}: loss differs by {rel}")
    check(worst <= LM_GRAD_TOL,
          f"(a) {arch}: gradient {worst_name} differs by {worst}")
    n = k_launches["flash_attention"]
    for name in scalars:
        print(f"(a) {arch} {name} (one element): kernel route "
              f"{k_grads[name].item()}, plain route {p_grads[name].item()}")
    if scalars:
        got, k_n = _gate_terms_agree(arch, params, batch, cfg, kernel,
                                     {name: (k_grads[name].item(),
                                             p_grads[name].item())
                                      for name in scalars},
                                     (k_loss, p_loss), card)
        # every self-attention layer's forward; only those after the
        # first gate are recomputed (nothing before it needs a gradient)
        kinds = [spec.kind for spec in specs]
        first = kinds.index("cross_attn")
        want_terms = kinds.count("attn") + kinds[first:].count("attn")
        check(got["flash_attention"] == want_terms and
              sum(got.values()) == want_terms,
              f"(a) {arch}: the gate terms' kernel route launched {got}, "
              f"want {want_terms}")
        n += k_n
    if "kernel again" in out:
        a_loss, a_grads, a_launches, _ = out["kernel again"]
        check(a_launches == k_launches,
              f"(a) {arch}: the second kernel run launched {a_launches}")
        same = [name for name, t in a_grads.items()
                if torch.equal(t, k_grads[name])]
        print(f"(a) {arch}: a second kernel-route run repeats the loss "
              f"{'bit for bit' if torch.equal(a_loss, k_loss) else 'NOT'}"
              f" and {len(same)} of {len(k_grads)} gradient leaves bit for "
              f"bit")
        check(torch.equal(a_loss, k_loss) and len(same) == len(k_grads),
              f"(a) {arch}: gradients that did not repeat: "
              f"{sorted(set(k_grads) - set(same))[:6]}")
        n += a_launches["flash_attention"]
    del params, out, k_grads, p_grads
    return {"flash_attention": n}


def _gate_terms_agree(arch, params, batch, cfg, kernel, summed, losses,
                      card):
    """(a) for the cross layers' gates: each gate broadcast to a ``[B, S,
    d]`` field of its value (the same function), whose gradient is the
    gate gradient's terms before their sum; the field's gradient on the
    kernel route against the plain loop within ``LM_GRAD_TOL`` of its
    largest |term|, each field's sum and the summed gradients of both
    routes printed beside them; the loss with the fields must
    equal ``losses`` (kernel, plain) bit for bit. Returns (launches, the
    kernel route's flash launches)."""
    import torch
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    B, S = batch["tokens"].shape[0], batch["tokens"].shape[1] - 1
    names = [f"layers/[{i}]/attn/gate"
             for i, spec in enumerate(model.layer_specs(cfg))
             if spec.kind == "cross_attn"]
    check(sorted(names) == sorted(summed),
          f"(a) {arch}: gates {names}, one-element leaves {list(summed)}")
    runs = {}
    for route, ctx in (("kernel", kernel),
                       ("plain", ModelContext(remat="full",
                                              flash_kernel=False))):
        layers, fields = [], []
        for layer, spec in zip(params["layers"], model.layer_specs(cfg)):
            if spec.kind == "cross_attn":
                field = layer["attn"]["gate"].detach().expand(
                    B, S, cfg.d_model).clone().requires_grad_()
                fields.append(field)
                layer = dict(layer, attn=dict(layer["attn"], gate=field))
            layers.append(layer)

        def terms(ctx=ctx, layers=layers, fields=fields):
            loss, _ = model.lm_loss(dict(params, layers=layers), batch,
                                    cfg, ctx)
            return loss.detach(), torch.autograd.grad(loss, fields)
        runs[route] = drive(f"(a) {arch} gate terms, {route} route", terms)
    ((k_loss, k_terms), k_launches, _), ((p_loss, p_terms), p_launches, _) \
        = runs["kernel"], runs["plain"]
    check(sum(p_launches.values()) == 0,
          f"(a) {arch}: the plain route launched {p_launches}")
    # the fields compute the same function: the same loss, bit for bit
    check(torch.equal(k_loss, losses[0]) and torch.equal(p_loss, losses[1]),
          f"(a) {arch}: the loss with gate fields {k_loss.item()}, "
          f"{p_loss.item()} differs from {[x.item() for x in losses]}")
    for name, k_t, p_t in zip(names, k_terms, p_terms):
        scale = p_t.abs().max().item()
        diff = (k_t - p_t).abs().max().item()
        k_sum, p_sum = summed[name]
        print(f"(a) {arch} {name} before its sum over {tuple(p_t.shape)}: "
              f"max |term| {scale}, sum of |terms| {p_t.abs().sum().item()}"
              f", max difference {diff}, {diff / scale} of the max |term| "
              f"(limit {LM_GRAD_TOL}); summed: kernel route {k_t.sum().item()}"
              f" (gradient {k_sum}), plain route {p_t.sum().item()} "
              f"(gradient {p_sum}) ({card})")
        check(scale > 0 and diff <= LM_GRAD_TOL * scale,
              f"(a) {arch}: {name}'s terms differ by {diff / scale}")
    return k_launches, k_launches["flash_attention"]


def _family_train_steps(arch, cut, want, card, profile):
    """(b): ``FAMILY_TRAIN_STEPS`` bf16 steps of ``make_train_step`` on
    the launcher's batches; for ``FAMILY_EXTRA_STEPS`` then one int8-
    compressed and one ``microbatch=1`` step. Returns (launches, the
    cell's measurements for (c))."""
    import statistics
    import torch
    from repro_torch import tree
    from repro_torch.distributed import compression
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_batches
    from repro_torch.models import model, moe
    from repro_torch.models.layers import ModelContext
    from repro_torch.train import OptimizerConfig
    from repro_torch.train.train_step import make_train_state, make_train_step
    cfg = _family_cfg(arch, cut)
    dev = torch.device(DEV)
    ctx = ModelContext(remat="full", q_chunk=256, k_chunk=256)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=10)   # the launcher's
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(torch.Generator(device=dev).manual_seed(0),
                             cfg, opt_cfg)
    n_params = sum(t.numel() for t in tree.leaves(state["params"]))
    specs = model.layer_specs(cfg)
    n_moe = sum(s.ffn == "moe" for s in specs)
    # layer 0's largest leaf, to see the step move it
    first_name, first = max(tree.flatten_with_names(
        state["params"]["layers"][0]).items(), key=lambda kv: kv[1].numel())
    first = first.clone()
    print(f"(b) {arch} in {cfg.dtype}, {len(specs)} layer applications "
          f"(full: {len(model.layer_specs(_family_cfg(arch, {})))})"
          f"{' and the MTP module' if 'mtp' in state['params'] else ''}: "
          f"{n_params} parameters, AdamW moments in {cfg.opt_dtype}; "
          f"batches of {FAMILY_TRAIN_BATCH} x {FAMILY_TRAIN_SEQ}, remat "
          f"full; state {torch.cuda.memory_allocated() - held} bytes "
          f"({held} held before)")
    batches = train_batches(cfg, FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ)
    reads = [0]
    real_rows = moe.expert_rows

    def counted_rows(flat, num_experts):
        reads[0] += 1
        return real_rows(flat, num_experts)

    def run(step_fn, box, n, label):
        """``n`` steps on ``box["state"]``, the only reference to the
        state, so a step's old state is freed as the step returns."""
        ms, losses, gnorms = [], [], []
        torch.cuda.synchronize()
        ops.reset_launches()
        reads[0] = 0
        for _ in range(n):
            tokens = next(batches)["tokens"].to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            box["state"], metrics = step_fn(box["state"],
                                            {"tokens": tokens})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
            gnorms.append(metrics["grad_norm"].item())
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        print(f"(b) {arch} {label}: losses {losses}, grad norms {gnorms}, "
              f"step ms {ms}, launches {launches}, expert-count host reads "
              f"{reads[0]}")
        check(all(map(math.isfinite, losses + gnorms)),
              f"(b) {arch} {label}: a loss or gradient norm is not finite")
        return ms, launches

    def want_times(k):
        return {name: n * k for name, n in want.items()}

    box = {"state": state}
    del state
    step = make_train_step(cfg, ctx, opt_cfg)
    moe.expert_rows = counted_rows
    try:
        ms, launches = run(step, box, FAMILY_TRAIN_STEPS,
                           f"{FAMILY_TRAIN_STEPS} steps")
        peak = torch.cuda.max_memory_allocated()
        # one host read a MoE layer in the forward and one in its remat
        # recompute
        check(reads[0] == 2 * n_moe * FAMILY_TRAIN_STEPS,
              f"(b) {arch}: {reads[0]} expert-count host reads, want "
              f"{2 * n_moe * FAMILY_TRAIN_STEPS}")
        check(launches == want_times(FAMILY_TRAIN_STEPS),
              f"(b) {arch} launched {launches}, want "
              f"{want_times(FAMILY_TRAIN_STEPS)}")
        check(int(box["state"]["step"]) == FAMILY_TRAIN_STEPS,
              f"(b) {arch}: step reads {int(box['state']['step'])}")
        after = tree.flatten_with_names(
            box["state"]["params"]["layers"][0])[first_name]
        moved = (after.float() - first.float()).abs().max().item()
        check(moved > 0, f"(b) {arch}: layer 0 {first_name} did not move")
        med = statistics.median(ms[1:])
        tokens = FAMILY_TRAIN_BATCH * FAMILY_TRAIN_SEQ
        print(f"(b) {arch}: step {med} ms (median of steps "
              f"2-{FAMILY_TRAIN_STEPS}), {tokens / med * 1e3} tokens/s, "
              f"peak device memory {peak} bytes; layer 0 {first_name} "
              f"moved by up to {moved} ({card})")
        total = dict(launches)
        if arch == FAMILY_EXTRA_STEPS:
            box["state"]["err"] = compression.init_error_buffer(
                box["state"]["params"])
            ms_c, got = run(make_train_step(cfg, ctx, opt_cfg,
                                            grad_compression=True),
                            box, 1, "one step with int8 compression")
            check(got == want_times(1),
                  f"(b) {arch}: the compressed step launched {got}")
            del box["state"]["err"]
            for name, n in got.items():
                total[name] += n
            ms_m, got = run(make_train_step(cfg, ctx, opt_cfg, microbatch=1),
                            box, 1, f"one step with microbatch=1 "
                            f"({FAMILY_TRAIN_BATCH} slices)")
            check(got == want_times(FAMILY_TRAIN_BATCH),
                  f"(b) {arch}: the microbatched step launched {got}")
            for name, n in got.items():
                total[name] += n
            print(f"(b) {arch}: compressed step {ms_c[0]} ms, microbatched "
                  f"step {ms_m[0]} ms; peak device memory over them "
                  f"{torch.cuda.max_memory_allocated()} bytes ({card})")
        if profile:
            tokens_p = next(batches)["tokens"].to(dev)

            def one_step():
                box["state"], _ = step(box["state"], {"tokens": tokens_p})
            _profile(f"{arch} train step", one_step)
    finally:
        moe.expert_rows = real_rows
    del box, first, after
    return total, {"cfg": cfg, "peak": peak, "held": held,
                   "step_s": med / 1e3}


def _family_counts_start():
    """(c)'s counts, one subprocess a (b) cell, started together at the
    phase's start (each ~3-12 s of CPU on the sandbox)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    return {arch: subprocess.Popen(
        [sys.executable, "-c", FAMILY_COUNT, arch, json.dumps(cut),
         str(FAMILY_TRAIN_SEQ), str(FAMILY_TRAIN_BATCH)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for arch, (cut, _) in FAMILY_TRAIN.items()}


def _family_peaks(procs, measured, card):
    """(c): each (b) cell's predicted peak (``dryrun_lib.count_cell`` in
    a subprocess that never touches CUDA: no memory, no launch, no
    kernel build) against the card's ``max_memory_allocated``."""
    from repro_torch.common import hw
    lo, hi = DRYRUN_PEAK_RATIO
    for arch, p in procs.items():
        out, _ = p.communicate(timeout=FAMILY_COUNT_TIMEOUT_S)
        check(p.returncode == 0,
              f"(c) the count of {arch} exited {p.returncode}: "
              f"{out.strip().splitlines()[-3:]}")
        rec = json.loads(out.strip().splitlines()[-1])
        check(not rec["cuda_initialized"] and
              not any(rec["launches"].values()) and not rec["build_calls"],
              f"(c) the count of {arch} touched the card: {rec}")
        c, m = rec["counts"], measured[arch]
        ratio = c["peak_bytes"] / m["peak"]
        terms = hw.roofline_terms(c["flops"], c["bytes"], 0.0)
        print(f"(c) {arch}: predicted peak {c['peak_bytes']} bytes "
              f"(argument {c['argument_bytes']}), measured "
              f"max_memory_allocated {m['peak']} bytes ({m['held']} held "
              f"before), ratio {ratio} (bound {lo}-{hi}); counted in "
              f"{rec['seconds']} s; bound_s {terms['bound_s']} "
              f"({terms['dominant']}), measured {m['step_s']} s a step, "
              f"bound_s / measured {terms['bound_s'] / m['step_s']} "
              f"({card})")
        check(lo <= ratio <= hi,
              f"(c) {arch}: predicted/measured peak {ratio}")


#: launcher runs in one process, in turn: each is the launcher's entry
#: point, ``launch.train.main(argv)``, as ``python -m
#: repro_torch.launch.train`` calls it, its output captured by label. A
#: resumed run reads the checkpoint that an earlier run of the list
#: wrote. One process shares the imports and the card's context, and a
#: fresh process's first steps on the card cost ~10-30 s (phase 11's
#: launcher took 9.48 s a step, PR 36): until PR 36 phase 19's eight
#: runs were eight processes and phase 11's two were two.
LAUNCHERS = """\
import contextlib, io, json, sys
from repro_torch.launch import train
out = {}
for label, argv in json.loads(sys.argv[1]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    out[label] = [rc, buf.getvalue()]
    print(label, "exit", rc, file=sys.stderr, flush=True)
print(json.dumps(out))
"""


def _launcher_argv(arch, steps, ckpt):
    return ["--arch", f"{arch}-smoke", "--steps", str(steps),
            "--ckpt-every", "3", "--ckpt", ckpt]


def _launchers_start(runs):
    """``runs`` ({label: argv}, each label ending in ``--steps N``) in
    turn in one subprocess (``LAUNCHERS``). Returns (runs, the process,
    its start) for ``_launchers_finish``."""
    p = subprocess.Popen(
        [sys.executable, "-c", LAUNCHERS, json.dumps(list(runs.items()))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=SRC), cwd=ROOT)
    return runs, p, time.perf_counter()


def _launchers_finish(label, runs, p, t0, timeout):
    """Wait for ``_launchers_start``'s process (within ``timeout`` s of
    its start): each run must exit 0 having done its steps. Returns
    {label: output}."""
    try:
        out, err = p.communicate(timeout=max(
            1.0, timeout - (time.perf_counter() - t0)))
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    check(p.returncode == 0, f"{label} the launchers' process exited "
                             f"{p.returncode}: {err.strip()[-2000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    check(list(got) == list(runs), f"{label} launcher runs {list(got)}")
    outs = {}
    for name, (rc, text) in got.items():
        for line in text.strip().splitlines()[-3:]:
            print(f"{label} {name}: {line}")
        check(rc == 0, f"{label} the launcher at {name} exited {rc}")
        steps = name.rsplit(" ", 1)[-1]
        check(f"done: {steps} steps" in text,
              f"{label} the launcher at {name} did not finish {steps} "
              f"steps")
        outs[name] = text
    print(f"{label} {len(runs)} launcher runs in turn in one process: "
          f"{time.perf_counter() - t0} s")
    return outs


def _family_launchers_start():
    """(d), started with the phase: the launcher at ``--arch <a>-smoke
    --steps FAMILY_LAUNCHER_STEPS`` for each family, a run of
    ``FAMILY_RESUME_ARCH`` to the first of ``FAMILY_RESUME_STEPS`` with a
    checkpoint every 3 (its family run), and that run's resumption to the
    second, in turn in one subprocess (``_launchers_start``). Returns
    (scratch directory, runs, the process, its start)."""
    import tempfile
    os.makedirs(os.path.join(ROOT, "artifacts"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="family_launcher_",
                            dir=os.path.join(ROOT, "artifacts"))
    n = FAMILY_LAUNCHER_STEPS
    runs = {f"{arch}-smoke --steps {n}": _launcher_argv(
        arch, n, os.path.join(root, arch)) for arch in FAMILY_LAUNCHER_ARCHS}
    for steps in FAMILY_RESUME_STEPS:
        runs[f"{FAMILY_RESUME_ARCH}-smoke --steps {steps}"] = _launcher_argv(
            FAMILY_RESUME_ARCH, steps, os.path.join(root, "resume"))
    return (root,) + _launchers_start(runs)


def _family_launchers_finish(root, runs, p, t0):
    """(d): the runs of ``_family_launchers_start``; the resumed run
    must resume from the first of ``FAMILY_RESUME_STEPS``, and that
    checkpoint is then restored on the card bit for bit."""
    first, then = FAMILY_RESUME_STEPS
    outs = _launchers_finish("(d)", runs, p, t0, FAMILY_LAUNCHER_TIMEOUT_S)
    check(f"resumed from step {first}" in
          outs[f"{FAMILY_RESUME_ARCH}-smoke --steps {then}"],
          f"(d) the second run did not resume from step {first}")
    _restored_on_card_bit_for_bit("(d)", os.path.join(root, "resume",
                                                      f"step_{first}"),
                                  f"{FAMILY_RESUME_ARCH}-smoke")
    shutil.rmtree(root)


# ---------------------------------------------------------------- phase 20
#: the port's built-in paths, in registration order
PORT_PATHS = ("numpy-ref", "numpy-fast", "numpy-int", "numpy-sparse",
              "fft-idct", "strict-fast", "torch-basic", "torch-fused",
              "torch-batch", "strict-torch", "cuda-idct", "cuda-fused",
              "cuda-batch", "strict-cuda")
SERVE_LM_ARCH = "qwen2-7b"      # the full config: 28 layers, bf16
SERVE_LM_BATCH, SERVE_LM_PROMPT, SERVE_LM_NEW = 4, 32, 24
SERVE_LM_ARGV = ["--arch", SERVE_LM_ARCH, "--batch", str(SERVE_LM_BATCH),
                 "--prompt-len", str(SERVE_LM_PROMPT), "--new-tokens",
                 str(SERVE_LM_NEW)]
#: the example's defaults but 30 requests a client
SERVE_DECODE_CLIENTS, SERVE_DECODE_REQUESTS = 4, 30
SERVE_DECODE_ARGV = ["--metrics-port", "0", "--requests",
                     str(SERVE_DECODE_REQUESTS)]
CONTRIB_TOL = 32                # tests/test_codecs.py's bound
EXAMPLE_TIMEOUT_S = 300         # the quickstart's own process
PHASE20_LIMIT_S = 240
PHASE20_WATCHDOG_S = 600


def phase_examples(corpus):
    """Phase 20: the five example entry points on the card; returns the
    kernels' launches of the phase, summed over the examples."""
    import faulthandler
    print("== phase 20: the example entry points (repro_torch.examples) "
          "on the card")
    t_phase = time.perf_counter()
    card = smi_line()
    held_report("phase 20")
    faulthandler.dump_traceback_later(PHASE20_WATCHDOG_S, exit=True)
    try:
        # the entry point's own process ends before the in-process
        # examples start, so it shares neither the card nor the CPUs
        # with what they time
        _quickstart_entry_point()
        per_example = _examples_checks(corpus, card)
    finally:
        faulthandler.cancel_dump_traceback_later()
    launches = {}
    for got in per_example.values():
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
    MEASURED["examples"] = per_example
    dt = time.perf_counter() - t_phase
    print(f"phase 20: {dt} s (limit {PHASE20_LIMIT_S} s); launches "
          f"{launches} ({card})")
    check(dt <= PHASE20_LIMIT_S, f"phase 20 took {dt} s")
    return launches


def _quickstart_entry_point():
    """``python -m repro_torch.examples.quickstart``, run to its end."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.quickstart"],
        env=dict(os.environ, PYTHONPATH=SRC), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print(f"python -m repro_torch.examples.quickstart: exit "
          f"{proc.returncode} in {time.perf_counter() - t0} s; last lines "
          f"{out.strip().splitlines()[-4:]}")
    check(proc.returncode == 0 and "zero-skip tier" in out,
          f"the quickstart entry point exited {proc.returncode}: "
          f"{err.strip()[-2000:]}")


def _examples_checks(corpus, card):
    """Each example through its ``main`` on the card; returns each
    one's launches."""
    _contrib_on_card(corpus)
    per_example = {"quickstart": _quickstart_on_card()}
    _release()
    per_example["serve_lm"] = _serve_lm_on_card(card)
    _release()
    per_example["serve_decode"] = _serve_decode_on_card()
    per_example["storage_loader"] = _storage_loader_on_card()
    per_example["autotune_workers"] = _autotune_on_card()
    return per_example


def _contrib_on_card(corpus):
    """Which of Pillow and OpenCV import here, what registered, and the
    registry's order; a plugin that imports decodes phase 3's corpus."""
    import importlib
    import numpy as np
    from repro_torch.codecs import contrib, decoder_names, get_decoder
    imports = {}
    for lib in ("PIL", "cv2"):
        try:
            importlib.import_module(lib)
            imports[lib] = True
        except ImportError:
            imports[lib] = False
    print(f"contrib: imports {imports}; contrib.available() "
          f"{contrib.available()}; {len(decoder_names())} decoders "
          f"registered")
    check(decoder_names() == list(PORT_PATHS) + list(contrib.available()),
          f"registry {decoder_names()}")
    ref = get_decoder("numpy-ref")
    # the reference decodes once for every plugin
    wants = [ref.fn(f) for f in corpus.files] if contrib.available() \
        else []
    for name in contrib.available():
        dec = get_decoder(name)
        worst = 0
        for i, (f, want) in enumerate(zip(corpus.files, wants)):
            img = dec.fn(f)
            check(img.dtype == np.uint8 and img.shape == want.shape,
                  f"{name} image {i}: {img.shape} {img.dtype}")
            if i != corpus.rare_index:
                worst = max(worst, int(np.abs(img.astype(int) -
                                              want.astype(int)).max()))
        print(f"{name}: {len(corpus.files)} images, max level difference "
              f"to numpy-ref {worst} (limit {CONTRIB_TOL}, rare image "
              f"exempt)")
        check(worst <= CONTRIB_TOL, f"{name} differs by {worst} levels")


def _quickstart_on_card():
    from repro_torch.examples import quickstart
    from repro_torch.jpeg import parser as P
    from repro_torch.jpeg.corpus import build_corpus
    out, launches, dt = drive("quickstart", lambda: quickstart.main([]))
    first = build_corpus(out["corpus"]["n"], seed=0).files[0]
    n_comp = len(P.parse(first).components)
    check(launches["idct8x8"] == n_comp and
          sum(launches.values()) == n_comp,
          f"quickstart launches {launches} for a {n_comp}-component "
          f"image through cuda-idct")
    check(out["strict"]["kind"] == "skip",
          f"strict-fast on the rare image: {out['strict']}")
    check(out["decodes"]["cuda-idct"] == out["decodes"]["numpy-fast"],
          f"decodes {out['decodes']}")
    print(f"quickstart: {dt} s; idct8x8 {launches['idct8x8']} launches "
          f"for {n_comp} components; tier {out['tier']}; leaders "
          f"{out['disagreement']['single_leader']} / "
          f"{out['disagreement']['loader_leader']}")
    return launches


def _serve_lm_on_card(card):
    """``serve_lm --arch qwen2-7b``: 28 wgmma launches, ids equal to a
    direct ``engine.generate`` on the same seeded inputs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_lm
    from repro_torch.models import model
    from repro_torch.serve import engine
    cfg = get_config(SERVE_LM_ARCH)
    out, launches, dt = drive(f"serve_lm --arch {SERVE_LM_ARCH}",
                              lambda: serve_lm.main(SERVE_LM_ARGV))
    check(launches["flash_attention_wgmma"] == cfg.num_layers and
          sum(launches.values()) == cfg.num_layers,
          f"serve_lm launched {launches} for {cfg.num_layers} layers "
          f"(want one wgmma launch a layer, in the prefill)")
    _release()
    dev = torch.device(DEV)
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    prompt, _ = serve_lm.inputs(cfg, SERVE_LM_BATCH, SERVE_LM_PROMPT, dev)
    want = engine.generate(params, prompt, cfg, serve_lm.CTX,
                           max_new_tokens=SERVE_LM_NEW).cpu().tolist()
    del params
    check(out["ids"] == want, "serve_lm's ids differ from a direct "
          "engine.generate's on the same parameters and prompt")
    check(out["shape"] == [SERVE_LM_BATCH, SERVE_LM_NEW] and
          out["dtype"] == "bfloat16",
          f"serve_lm gave {out['shape']} in {out['dtype']}")
    steps = SERVE_LM_NEW - 1
    print(f"serve_lm {SERVE_LM_ARCH}: prefill {SERVE_LM_BATCH} x "
          f"{SERVE_LM_PROMPT} tokens {out['prefill_s']} s, decode {steps} "
          f"steps {out['decode_s']} s ({out['decode_s'] / steps * 1e3} ms "
          f"a step), "
          f"{out['tokens_per_s']} tokens/s with the first calls, peak "
          f"device memory {out['peak_bytes']} bytes; ids equal a direct "
          f"generate's ({card})")
    return launches


def _serve_decode_on_card():
    from repro_torch.codecs import contrib
    from repro_torch.examples import serve_decode
    out, launches, dt = drive("serve_decode",
                              lambda: serve_decode.main(SERVE_DECODE_ARGV))
    svc = out["stats"]["service"]
    n_req = SERVE_DECODE_CLIENTS * SERVE_DECODE_REQUESTS
    pulls = {k: v["pulls"] for k, v in out["stats"]["router"].items()}
    print(f"serve_decode: {dt} s; {svc['requests']} requests, "
          f"{svc['completed']} completed, {svc['shed']} shed, "
          f"{svc['failed']} failed, {svc['cache_hits']} cache hits; "
          f"pulls {pulls}; best {out['router_best']}; launches {launches} "
          f"(dequant_idct only on a cuda-fused fallback decode)")
    check(svc["failed"] == 0 and svc["requests"] == n_req and
          svc["completed"] + svc["shed"] == n_req,
          f"serve_decode served {svc}")
    check(sum(c["served"] + c["shed"] for c in out["clients"].values())
          == n_req, f"clients {out['clients']}")
    check(list(pulls) == list(PORT_PATHS) + list(contrib.available()) and
          all(n >= 1 for n in pulls.values()), f"arm pulls {pulls}")
    check(launches["decode_batch"] >= 1 and launches["ycbcr2rgb"] >= 1,
          f"serve_decode launches {launches}")
    check(any(ln.startswith("service_requests")
              for ln in out.get("metrics_lines", [])),
          "no /metrics scrape")
    return launches


def _storage_loader_on_card():
    from repro_torch.examples import storage_loader
    out, launches, dt = drive("storage_loader",
                              lambda: storage_loader.main([]))
    check(out["parity"] and sum(launches.values()) == 0 and
          out["fingerprint"] == out["corpus_fingerprint"],
          f"storage_loader {launches}")
    print(f"storage_loader: {dt} s; resume parity after "
          f"{len(out['first'])} images; memory {out['memory_img_s']} "
          f"img/s, shard {out['shard_img_s']} img/s")
    return launches


def _autotune_on_card():
    from repro_torch.examples import autotune_workers
    out, launches, dt = drive("autotune_workers",
                              lambda: autotune_workers.main([]))
    check(list(out["paths"]) == list(autotune_workers.PATHS) and all(
        sorted(r["sweep"]) == [0, 2, 4, 8] for r in out["paths"].values())
        and sum(launches.values()) == 0, f"autotune {out['paths']}")
    print(f"autotune_workers: {dt} s; best "
          f"{ {k: v['best'] for k, v in out['paths'].items()} } on "
          f"{out['cpu_count']} CPUs")
    return launches


#: float32 outputs of routed_ep against routed, and card against CPU,
#: relative to the largest |value|
EP_F32_REL_TOL = 1e-5
EP_EXCHANGE_ITERS = 20
PHASE21_LIMIT_S = 120


def phase_ep(profile=False):
    """Phase 21: ``deepseek-moe-16b`` served through ``routed_ep`` over a
    world of one (NCCL on the card), the float32 checks and the
    exchange's time; returns the flash kernels' launches of the phase.
    ``profile`` adds ``_profile`` over one bf16 prefill and 8 decode
    steps."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_context
    from repro_torch.launch.mesh import BACKENDS, make_host_mesh
    print(f"== phase 21: {MOE_ARCH} served through routed_ep (expert "
          f"parallelism over a world of one)")
    t_phase = time.perf_counter()
    card = smi_line()
    held = held_report("phase 21")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    mesh = make_host_mesh(1, 1)
    try:
        ctx = make_context(mesh)
        print(f"process group: {dist.get_backend()}, world of "
              f"{dist.get_world_size()}; {mesh}, made in "
              f"{time.perf_counter() - t0} s; context moe_impl "
              f"{ctx.moe_impl!r}, capacity_factor {ctx.capacity_factor}")
        check(dist.get_backend() == BACKENDS[torch.device(DEV).type] and
              ctx.moe_impl == "ep" and ctx.model_axis_size == 1,
              f"the context runs {ctx.moe_impl} over "
              f"{dist.get_backend()}")
        launches, block = _ep_serve(cfg, ctx, held, card, profile)
        gc.collect()
        torch.cuda.empty_cache()
        f32_launches = _ep_float32_check(cfg, ctx, block, card)
    finally:
        dist.destroy_process_group()
    _ep_block_on_the_cpu(block, card)
    MEASURED["ep_block"] = {k: block[k] for k in ("p", "x", "cfg")}
    for name, count in f32_launches.items():
        launches[name] += count
    dt = time.perf_counter() - t_phase
    print(f"phase 21: {dt} s (limit {PHASE21_LIMIT_S} s); peak device "
          f"memory {torch.cuda.max_memory_allocated()} bytes ({held} held "
          f"before the phase); launches {launches} ({card})")
    check(dt <= PHASE21_LIMIT_S, f"phase 21 took {dt} s")
    return launches


def _ep_serve(cfg, ctx, held, card, profile):
    """(a) bf16 at full width and depth through ``engine.generate`` over
    ``ctx``, and (c) the exchange's time. Returns the launches and the
    first MoE layer of the prefill, its parameters and input, as float32
    on the host."""
    import dataclasses
    import torch
    from repro_torch.models import moe
    from repro_torch.serve import engine
    params, prompt, cache_len, out, launches = _moe_generate(
        f"{MOE_ARCH} generate (routed_ep)", cfg, ctx, held, card)
    n_moe = len(params["layers"]) - cfg.first_dense_layers
    prefill = engine.make_prefill_step(cfg, ctx, cache_len)
    real, first = moe.moe_block, []

    def moe_block(p, x, cfg, ctx=None):
        if not first:
            first.append((p, x))
        return real(p, x, cfg, ctx)
    moe.moe_block = moe_block
    try:
        (caches, got), kept = _capture_keep(lambda: prefill(params, prompt))
    finally:
        moe.moe_block = real
    T, k = LM_BATCH * LM_PROMPT, cfg.experts_per_token
    cap = moe.capacity(T, cfg, ctx)
    check(len(kept) == n_moe and all(m.numel() == T * k for m in kept),
          f"{len(kept)} MoE layers dispatched")
    share = [m.float().mean().item() for m in kept]
    print(f"kept share of the {T} x {k} (token, slot) pairs per MoE layer "
          f"of the prefill at capacity factor {ctx.capacity_factor} (cap "
          f"{cap} rows an expert, {cfg.num_experts * cap} in all): {share}; "
          f"mean {sum(share) / len(share)}")
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    check(torch.equal(out[:, 0], got.argmax(dim=-1)),
          "generate's first token is not the prefill's argmax")
    _, dense = engine.make_prefill_step(
        cfg, dataclasses.replace(ctx, moe_impl="dense"), cache_len)(
        params, prompt)
    scale = dense.abs().max().item()
    print(f"bf16 last-position logits, routed_ep vs the drop-free routed: "
          f"max abs diff / max |logit| "
          f"{(got - dense).abs().max().item() / scale} (printed, not held: "
          f"pairs drop at {ctx.capacity_factor}; max |logit| {scale})")
    _decode_without_host_reads(params, caches, out[:, :1], cfg, ctx, n_moe)
    _ep_times(params, cfg, ctx, card)
    if profile:
        _profile_serving("ep ", cfg, ctx, params, prompt, cache_len)
    print(f"peak device memory over the bf16 part: "
          f"{torch.cuda.max_memory_allocated()} bytes ({card})")
    p, x = first[0]
    block = {"p": {n: t.float().cpu() for n, t in p.items()},
             "x": x.float().cpu()}
    return ({"flash_attention_wgmma": launches["flash_attention_wgmma"],
             "flash_attention": launches["flash_attention"]}, block)


def _decode_without_host_reads(params, caches, token, cfg, ctx, n_moe):
    """One decode step with each MoE layer under
    ``torch.cuda.set_sync_debug_mode("error")``: a host read there
    raises, and fails the phase."""
    import torch
    from repro_torch.models import moe
    from repro_torch.serve import engine
    real, calls = moe.moe_block, []

    def moe_block(p, x, cfg, ctx=None):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(p, x, cfg, ctx)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(tuple(x.shape))
        return out
    moe.moe_block = moe_block
    try:
        _, logits = engine.make_decode_step(cfg, ctx)(
            params, caches, token, LM_PROMPT)
        torch.cuda.synchronize()
    except RuntimeError as e:
        check(False, f"a decode step's MoE layer read to the host: {e}")
    finally:
        moe.moe_block = real
    check(len(calls) == n_moe and bool(torch.isfinite(logits).all()),
          f"{len(calls)} MoE layers ran under the sync check")
    print(f"one decode step: {len(calls)} MoE layers of input {calls[0]} "
          f"under set_sync_debug_mode('error'), no host read")


def _ep_times(params, cfg, ctx, card):
    """(c) the exchange's device time at the prefill's and a decode
    step's buffers, and one MoE layer through routed_ep and through
    routed at those inputs (CUDA events, eager)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.models import moe
    dev = torch.device(DEV)
    group = ctx.mesh.get_group(ctx.model_axis)
    E, d = cfg.num_experts, cfg.d_model
    dt = getattr(torch, cfg.dtype)
    p = params["layers"][cfg.first_dense_layers]["ffn"]
    dense = dataclasses.replace(ctx, moe_impl="dense")
    g = torch.Generator(device=dev).manual_seed(3)
    for label, S in (("prefill", LM_PROMPT), ("decode step", 1)):
        T = LM_BATCH * S
        cap = moe.capacity(T, cfg, ctx)
        send = torch.randn(E * cap, d, generator=g, device=dev).to(dt)
        recv = torch.empty_like(send)
        ms = cuda_ms(lambda: dist.all_to_all_single(recv, send, group=group),
                     iters=EP_EXCHANGE_ITERS, graph=False)
        check(torch.equal(recv, send),
              "a world of one's exchange changed the buffer")
        nbytes = send.numel() * send.element_size()
        x = torch.randn(LM_BATCH, S, d, generator=g, device=dev).to(dt)
        ep_ms = cuda_ms(lambda: moe.moe_block(p, x, cfg, ctx), iters=5,
                        graph=False)
        dense_ms = cuda_ms(lambda: moe.moe_block(p, x, cfg, dense),
                           iters=5, graph=False)
        print(f"(c) {label}: the exchange of a [{E}, {cap}, {d}] "
              f"{cfg.dtype} buffer ({nbytes} B) {ms} ms (CUDA events, "
              f"{EP_EXCHANGE_ITERS} back to back; two a MoE layer), "
              f"{2 * nbytes / (ms * 1e-3) / 1e12} TB/s read and written; one "
              f"MoE layer at {T} tokens: routed_ep {ep_ms} ms, routed "
              f"{dense_ms} ms (eager, 5 back to back) ({card})")


def _ep_float32_check(cfg, ctx, block, card):
    """(b) float32: routed_ep at a capacity that drops nothing against
    routed at ``MOE_CHECK_LAYERS``; then ``block``, the first MoE layer
    of the bf16 prefill with its parameters and input cast to float32,
    at the context's capacity on the card: pairs must drop, the kept
    pairs must be the plain capacity-drop combine's and the outputs
    within ``EP_F32_REL_TOL`` of its, and a second run must repeat its
    bits. Returns the flash kernels' launches; adds the block's results
    on the host to ``block``."""
    import dataclasses
    import torch
    from repro_torch.models import moe
    from repro_torch.models.layers import ModelContext
    dev = torch.device(DEV)
    n_moe = MOE_CHECK_LAYERS - cfg.first_dense_layers
    # cap = T: an expert takes a token at most once, so nothing drops
    nodrop = dataclasses.replace(
        ctx, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    want_launches = {"flash_attention": MOE_CHECK_LAYERS}
    (e_launches, kept), (d_launches, _) = _moe_float32_pair(cfg, card, (
        ("routed_ep at cap = T", nodrop, want_launches),
        ("routed", ModelContext(), want_launches)), EP_F32_REL_TOL)
    check(len(kept) == n_moe and all(bool(m.all()) for m in kept),
          f"routed_ep at cap = T dropped pairs in {len(kept)} layers")

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p = {n: t.to(dev) for n, t in block["p"].items()}
    x = block["x"].to(dev)
    ((y, aux), records), kept = _capture_keep(
        lambda: _capture_routes(lambda: moe.moe_block(p, x, cfg32, ctx)))
    y2, aux2 = moe.moe_block(p, x, cfg32, ctx)
    check(torch.equal(y, y2) and torch.equal(aux, aux2),
          "a second routed_ep block on the card gave other bits")
    keep = kept[0]
    want, want_keep, _ = _ep_plain_block(p, x, cfg32, ctx)
    rel = (y - want).abs().max().item() / want.abs().max().item()
    print(f"float32 first MoE layer of the bf16 prefill ({x.shape[0]} x "
          f"{x.shape[1]} tokens), capacity factor {ctx.capacity_factor}: "
          f"kept share {keep.float().mean().item()} "
          f"({int((~keep).sum())} pairs dropped); kept pairs equal the "
          f"plain combine's: {torch.equal(keep, want_keep)}; max abs diff "
          f"/ max |y| against it {rel} (limit {EP_F32_REL_TOL}); a second "
          f"run repeats its bits ({card})")
    check(not bool(keep.all()), "no pair dropped: the block does not "
          "reach routed_ep's drop path")
    check(torch.equal(keep, want_keep),
          "routed_ep kept other pairs than the plain combine")
    check(rel <= EP_F32_REL_TOL,
          f"routed_ep differs from the plain combine by {rel} relative")
    block.update(cfg=cfg32, y=y.cpu(), aux=aux.cpu(),
                 idx=records[0]["idx"].cpu(), gap=records[0]["gap"].cpu(),
                 keep=keep.cpu())
    return {"flash_attention": e_launches["flash_attention"] +
            d_launches["flash_attention"], "flash_attention_wgmma": 0}


def _ep_plain_block(p, x, cfg, ctx):
    """The capacity-drop MoE block written plainly, apart from
    ``routed_ep``'s dispatch, exchange and gather: each (token, slot)
    pair's slot is its rank among its expert's pairs in token-major
    order (a stable sort), the pairs below ``cap`` are kept, and each
    expert's SwiGLU runs on its kept pairs' tokens, weighed by the gates
    and added. -> (y, the kept mask over the pairs, aux)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    B, S, d = x.shape
    k = cfg.experts_per_token
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps).reshape(B * S, d)
    gates, idx, aux = moe.route(xn, p["router"], k)
    flat, w = idx.reshape(-1), gates.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ranked = flat[order]
    pos = torch.empty_like(flat)
    pos[order] = (torch.arange(flat.numel(), device=flat.device) -
                  torch.searchsorted(ranked, ranked))
    keep = pos < moe.capacity(B * S, cfg, ctx)
    r = torch.zeros_like(xn)
    for e in range(cfg.num_experts):
        pairs = ((flat == e) & keep).nonzero()[:, 0]
        tok = pairs // k
        r.index_add_(0, tok, L.swiglu(xn[tok], p["w1"][e], p["w3"][e],
                                      p["w2"][e]) * w[pairs, None])
    y = x + r.reshape(B, S, d)
    if cfg.num_shared_experts:
        y = y + L.swiglu(xn, p["sh_w1"], p["sh_w3"],
                         p["sh_w2"]).reshape(B, S, d)
    return y, keep, aux


def _ep_block_on_the_cpu(block, card):
    """(b) the card's float32 MoE block against the same block and input
    on the CPU, over a gloo world of one that the caller asked for."""
    import torch
    import torch.distributed as dist
    from repro_torch.device import use_device
    from repro_torch.distributed.sharding import make_context
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    t0 = time.perf_counter()
    with use_device("cpu"):
        mesh = make_host_mesh(1, 1)
        try:
            check(dist.get_backend() == "gloo", dist.get_backend())
            ctx = make_context(mesh)
            ((y, aux), records), kept = _capture_keep(
                lambda: _capture_routes(lambda: moe.moe_block(
                    block["p"], block["x"], block["cfg"], ctx)))
        finally:
            dist.destroy_process_group()
    idx, gap, keep = records[0]["idx"], records[0]["gap"], kept[0]
    T, k = idx.shape
    differ = (idx != block["idx"]).any(dim=-1)
    gaps = torch.maximum(gap, block["gap"])[differ]
    moved = (keep != block["keep"]).view(T, k).any(dim=-1)
    same = ~(differ | moved)
    y, want = y.reshape(T, -1), block["y"].reshape(T, -1)
    scale = want.abs().max().item()
    rel = (y - want)[same].abs().max().item() / scale
    print(f"float32 MoE block, card vs CPU ({time.perf_counter() - t0} s on "
          f"the CPU): {int(differ.sum())} of {T} tokens choose other "
          f"experts (gaps {gaps.tolist()}, limit {MOE_GAP_TOL}), "
          f"{int(moved.sum())} keep other pairs; {int((~keep).sum())} pairs "
          f"dropped on the CPU, {int((~block['keep']).sum())} on the card; "
          f"max abs diff / max |y| {rel} over the {int(same.sum())} others "
          f"(limit {EP_F32_REL_TOL}); aux {aux.item()} vs "
          f"{block['aux'].item()} ({card})")
    check(bool((gaps < MOE_GAP_TOL).all()),
          f"an expert choice differs without a near tie: {gaps.tolist()}")
    check(bool(differ.any()) or not bool(moved.any()),
          "the same choices kept other pairs")
    check(not bool(keep.all()), "no pair dropped on the CPU")
    check(rel <= EP_F32_REL_TOL and
          abs(aux.item() - block["aux"].item()) <=
          EP_F32_REL_TOL * abs(aux.item()),
          f"the card's block differs from the CPU's by {rel} relative")


# ---------------------------------------------------------------- phase 22
#: (a) float32 gradients at 1 x EP_TRAIN_CHECK_SEQ, phase 19 (a)'s cut of
#: MOE_ARCH; (c) phase 19 (b)'s cut, batches, steps and launches
EP_TRAIN_CHECK_SEQ = 512
#: (c)'s plain bf16 steps (phase 19 (b)'s count before phase 23 cut it)
EP_TRAIN_STEPS = 4
#: (b) the block's gradients, card against CPU, of each leaf's largest
#: |element| (phase 19's gradient bound)
EP_BLOCK_GRAD_TOL = LM_GRAD_TOL
PHASE22_LIMIT_S = 150


def phase_ep_train(profile=False):
    """Phase 22: ``deepseek-moe-16b`` trained through ``routed_ep`` over
    a world of one (NCCL on the card); returns the flash kernels'
    launches of the phase. Needs phase 21's float32 block
    (``MEASURED["ep_block"]``). ``profile`` adds ``_profile`` over one
    more (c) step."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import make_context
    from repro_torch.launch.mesh import BACKENDS, make_host_mesh
    print(f"== phase 22: {MOE_ARCH} trained through routed_ep (expert "
          f"parallelism over a world of one)")
    t_phase = time.perf_counter()
    card = smi_line()
    held_report("phase 22")
    check("ep_block" in MEASURED, "phase 22 needs phase 21's MoE block")
    cut = FAMILY_TRAIN[MOE_ARCH][0]
    count = subprocess.Popen(
        [sys.executable, "-c", FAMILY_COUNT, MOE_ARCH, json.dumps(cut),
         str(FAMILY_TRAIN_SEQ), str(FAMILY_TRAIN_BATCH), "ep"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=SRC), cwd=ROOT)
    mesh = make_host_mesh(1, 1)
    try:
        ctx = make_context(mesh, remat="full", q_chunk=256, k_chunk=256)
        print(f"process group: {dist.get_backend()}, world of "
              f"{dist.get_world_size()}; context moe_impl "
              f"{ctx.moe_impl!r}, capacity_factor {ctx.capacity_factor}, "
              f"model axis {ctx.model_axis_size}, data axes "
              f"{ctx.data_axes_size}")
        check(dist.get_backend() == BACKENDS[torch.device(DEV).type] and
              ctx.moe_impl == "ep",
              f"the context runs {ctx.moe_impl} over {dist.get_backend()}")
        launches = _ep_train_grads(ctx, card)
        _release()
        block = _ep_train_block_on_card(ctx, card)
        _release()
        got, measured = _ep_train_steps(ctx, card, profile)
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        _release()
        _ep_train_peak(count, measured, card)
    finally:
        if count.poll() is None:
            count.kill()
            count.wait()
        dist.destroy_process_group()
    _ep_train_block_on_the_cpu(block, card)
    dt = time.perf_counter() - t_phase
    print(f"phase 22: {dt} s (limit {PHASE22_LIMIT_S} s); launches "
          f"{launches} ({card})")
    check(dt <= PHASE22_LIMIT_S, f"phase 22 took {dt} s")
    return {"flash_attention": launches.get("flash_attention", 0),
            "flash_attention_wgmma": launches.get("flash_attention_wgmma",
                                                  0)}


def _grad_gap(got, want):
    """(worst leaf, its max difference over its max |want|) of two
    ``{name: gradient}``; every leaf must be finite with max |want| > 0."""
    import torch
    worst, worst_name = -1.0, ""
    for name, w in want.items():
        scale = w.abs().max().item()
        check(scale > 0 and bool(torch.isfinite(got[name]).all()),
              f"gradient {name}: max |g| {scale}")
        rel = (got[name] - w).abs().max().item() / scale
        if rel > worst:
            worst, worst_name = rel, name
    return worst_name, worst


def _ep_train_grads(ctx, card):
    """(a): float32 ``loss_and_grads`` through ``routed_ep`` against the
    drop-free ``routed`` at ``cap = T`` and against the plain
    capacity-drop combine at the context's capacity, the latter twice,
    bit for bit. Returns the launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.models import model, moe
    from repro_torch.models.layers import ModelContext
    from repro_torch.train.train_step import loss_and_grads
    cut, want = FAMILY_CHECK[MOE_ARCH]
    cfg = _family_cfg(MOE_ARCH, cut, dtype="float32")
    dev = torch.device(DEV)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, EP_TRAIN_CHECK_SEQ + 1)).astype(
            np.int32)).to(dev)
    batch = {"tokens": tokens}
    nodrop = dataclasses.replace(
        ctx, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    routed = ModelContext(remat="full", q_chunk=256, k_chunk=256)
    real = moe.moe_block

    def plain_block(p, x, cfg, ctx=None):
        y, _, aux = _ep_plain_block(p, x, cfg, ctx)
        return y, aux
    runs = [("routed_ep at cap = T", nodrop, real),
            ("routed", routed, real),
            (f"routed_ep at {ctx.capacity_factor}", ctx, real),
            (f"routed_ep at {ctx.capacity_factor} again", ctx, real),
            (f"the plain capacity-drop combine at {ctx.capacity_factor}",
             ctx, plain_block)]
    print(f"(a) {MOE_ARCH} in float32, {cfg.num_layers} layers "
          f"({cfg.first_dense_layers} dense): "
          f"{sum(t.numel() for t in tree.leaves(params))} parameters; batch "
          f"1 x {EP_TRAIN_CHECK_SEQ}, remat full")
    out, launches = {}, {}
    for label, c, block in runs:
        moe.moe_block = block
        try:
            (((loss, _), grads), kept), got, dt = drive(
                f"(a) {label}", lambda c=c: _capture_keep(
                    lambda: loss_and_grads(params, batch, cfg, c)))
        finally:
            moe.moe_block = real
        check(got["flash_attention"] == want and
              sum(got.values()) == want,
              f"(a) {label} launched {got}, want {want} flash_attention")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        out[label] = (loss, tree.flatten_with_names(grads), kept)
        del grads
    ep0, dense, ep1, ep2, plain = (out[label] for label, _, _ in runs)
    n_moe = cfg.num_layers - cfg.first_dense_layers
    check(len(ep0[2]) == 2 * n_moe and all(bool(m.all()) for m in ep0[2]),
          "(a) routed_ep at cap = T dropped pairs")
    check(len(ep1[2]) == 2 * n_moe and not bool(ep1[2][0].all()),
          f"(a) no pair dropped at {ctx.capacity_factor}: the drop path is "
          f"not reached")
    for label, (loss, grads, _), (w_loss, w_grads, _) in (
            ("routed_ep at cap = T vs routed", ep0, dense),
            (f"routed_ep at {ctx.capacity_factor} vs the plain combine",
             ep1, plain)):
        rel = abs(loss.item() - w_loss.item()) / abs(w_loss.item())
        name, worst = _grad_gap(grads, w_grads)
        print(f"(a) {label}: loss {loss.item()} vs {w_loss.item()} "
              f"(relative {rel}, limit {LM_LOSS_RTOL}); worst gradient leaf "
              f"{name}, {worst} of its max |g| (limit {LM_GRAD_TOL}) over "
              f"{len(w_grads)} leaves ({card})")
        check(rel <= LM_LOSS_RTOL, f"(a) {label}: loss differs by {rel}")
        check(worst <= LM_GRAD_TOL,
              f"(a) {label}: gradient {name} differs by {worst}")
    share = ep1[2][0].float().mean().item()
    same = [n for n, t in ep2[1].items() if torch.equal(t, ep1[1][n])]
    print(f"(a) kept share at {ctx.capacity_factor}: {share} "
          f"({int((~ep1[2][0]).sum())} pairs dropped); a second run repeats "
          f"the loss {'bit for bit' if torch.equal(ep1[0], ep2[0]) else 'NOT'}"
          f" and {len(same)} of {len(ep1[1])} gradient leaves bit for bit; "
          f"peak device memory {torch.cuda.max_memory_allocated()} bytes "
          f"({card})")
    check(torch.equal(ep1[0], ep2[0]) and len(same) == len(ep1[1]),
          f"(a) leaves that did not repeat: "
          f"{sorted(set(ep1[1]) - set(same))[:6]}")
    del params, out, ep0, dense, ep1, ep2, plain
    return launches


#: (b) the block gradients held: the input's and the routed experts'
EP_BLOCK_LEAVES = ("router", "w1", "w3", "w2")


def _ep_block_grads(block, ctx):
    """The float32 MoE block of ``block`` (phase 21's) under ``ctx`` on
    the tensors' device: (loss, aux, {x and EP_BLOCK_LEAVES: gradient},
    the routes' records, the kept masks) under a seeded cotangent of
    ``y`` and a weight of 1 on aux."""
    import torch
    from repro_torch.models import moe
    dev = torch.device(block.get("device", DEV))
    p = {n: t.to(dev).requires_grad_(n in EP_BLOCK_LEAVES)
         for n, t in block["p"].items()}
    x = block["x"].to(dev).requires_grad_()
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)
                      ).to(dev)

    def run():
        y, aux = moe.moe_block(p, x, block["cfg"], ctx)
        loss = (y * cot).sum() + aux
        grads = torch.autograd.grad(loss, [x] + [p[n]
                                                 for n in EP_BLOCK_LEAVES])
        return loss.detach(), aux.detach(), dict(zip(
            ("x",) + EP_BLOCK_LEAVES, grads))
    (out, records), kept = _capture_keep(lambda: _capture_routes(run))
    return out + (records, kept)


def _ep_train_block_on_card(ctx, card):
    """(b) on the card: the block's gradients twice, bit for bit, pairs
    dropped. Returns phase 21's block with the card's results on the
    host."""
    import torch
    block = dict(MEASURED["ep_block"])
    t0 = time.perf_counter()
    loss, aux, grads, records, kept = _ep_block_grads(block, ctx)
    loss2, _, grads2, _, _ = _ep_block_grads(block, ctx)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    same = [n for n in grads if torch.equal(grads[n], grads2[n])]
    keep = kept[0]
    print(f"(b) float32 first MoE layer ({tuple(block['x'].shape)}) at "
          f"{ctx.capacity_factor} on the card, forward and backward twice in "
          f"{dt} s: kept share {keep.float().mean().item()} "
          f"({int((~keep).sum())} pairs dropped); the second run repeats the "
          f"loss {'bit for bit' if torch.equal(loss, loss2) else 'NOT'} and "
          f"{len(same)} of {len(grads)} gradients bit for bit ({card})")
    check(not bool(keep.all()), "(b) no pair dropped")
    check(torch.equal(loss, loss2) and len(same) == len(grads),
          f"(b) gradients that did not repeat: "
          f"{sorted(set(grads) - set(same))}")
    block.update(loss=loss.cpu(), aux=aux.cpu(),
                 grads={n: g.cpu() for n, g in grads.items()},
                 idx=records[0]["idx"].cpu(), keep=keep.cpu())
    return block


def _ep_train_block_on_the_cpu(block, card):
    """(b) on the CPU, over a gloo world of one that the caller asked
    for: the same choices and kept pairs as the card's, and each
    gradient within ``EP_BLOCK_GRAD_TOL`` of its largest |element|."""
    import torch
    import torch.distributed as dist
    from repro_torch.device import use_device
    from repro_torch.distributed.sharding import make_context
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    with use_device("cpu"):
        mesh = make_host_mesh(1, 1)
        try:
            check(dist.get_backend() == "gloo", dist.get_backend())
            ctx = make_context(mesh)
            loss, aux, grads, records, kept = _ep_block_grads(
                dict(block, device="cpu"), ctx)
        finally:
            dist.destroy_process_group()
    flips = int((records[0]["idx"] != block["idx"]).any(dim=-1).sum())
    moved = int((kept[0] != block["keep"]).sum())
    name, worst = _grad_gap(block["grads"], grads)
    print(f"(b) the same block on the CPU ({time.perf_counter() - t0} s): "
          f"{flips} tokens choose other experts, {moved} pairs kept "
          f"otherwise; loss {block['loss'].item()} vs {loss.item()}, aux "
          f"{block['aux'].item()} vs {aux.item()}; worst gradient "
          f"{name}, {worst} of its max |g| (limit {EP_BLOCK_GRAD_TOL}) over "
          f"{', '.join(grads)} ({card})")
    check(flips == 0 and moved == 0,
          f"(b) card and CPU routed otherwise: {flips} tokens, {moved} pairs")
    check(worst <= EP_BLOCK_GRAD_TOL,
          f"(b) the card's gradient {name} differs by {worst}")


def _ep_train_steps(ctx, card, profile):
    """(c): bf16 AdamW steps through ``routed_ep``: ``EP_TRAIN_STEPS``,
    one int8-compressed and one ``microbatch=1`` step, each MoE layer's
    forward, recompute and backward under the sync check. Returns (the
    launches, the cell's measurements)."""
    import statistics
    import torch
    from repro_torch import tree
    from repro_torch.distributed import compression
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_batches
    from repro_torch.models import convert, layers, model, moe
    from repro_torch.train import OptimizerConfig
    from repro_torch.train.train_step import data_shard, make_train_state, \
        make_train_step
    cut, want = FAMILY_TRAIN[MOE_ARCH]
    cfg = _family_cfg(MOE_ARCH, cut)
    dev = torch.device(DEV)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=10)   # the launcher's
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = convert.local_tp_state(make_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, opt_cfg), cfg, ctx)
    n_moe = sum(s.ffn == "moe" for s in model.layer_specs(cfg))
    print(f"(c) {MOE_ARCH} in {cfg.dtype}, {cfg.num_layers} layers "
          f"({n_moe} MoE): {sum(t.numel() for t in tree.leaves(state['params']))}"
          f" parameters; batches of {FAMILY_TRAIN_BATCH} x "
          f"{FAMILY_TRAIN_SEQ}, remat full; state "
          f"{torch.cuda.memory_allocated() - held} bytes ({held} held before)")
    batches = train_batches(cfg, FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ)
    real, calls = moe.moe_block, {"forward": 0, "backward": 0}
    real_attn = layers.attn_block

    class Mark(torch.autograd.Function):
        """Identity; its backward sets the sync debug mode: "error" where
        a gradient enters the MoE block, 0 where the input's leaves."""
        @staticmethod
        def forward(fctx, t, mode):
            fctx.mode = mode
            return t.view_as(t)

        @staticmethod
        def backward(fctx, g):
            if fctx.mode == "error":
                calls["backward"] += 1
            torch.cuda.set_sync_debug_mode(fctx.mode)
            return g, None

    def checked_block(p, x, cfg, ctx=None):
        # counted on entry: the remat recompute stops once it has what
        # the backward needs
        calls["forward"] += 1
        x = Mark.apply(x, 0)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = real(p, x, cfg, ctx)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        return Mark.apply(y, "error"), Mark.apply(aux, "error")

    def unchecked_attn_block(*args, **kw):
        # the remat recompute of a MoE layer's attention runs inside the
        # layer's backward, within the MoE block's marks: not checked
        # (its RoPE frequencies are a host-to-device copy)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real_attn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    def run(step_fn, box, n, label, microbatch=0):
        ms, losses = [], []
        torch.cuda.synchronize()
        ops.reset_launches()
        calls.update(forward=0, backward=0)
        for _ in range(n):
            batch = {k: v.to(dev) for k, v in data_shard(
                next(batches), ctx, microbatch).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                box["state"], metrics = step_fn(box["state"], batch)
                torch.cuda.synchronize()
            except RuntimeError as e:
                check(False, f"(c) {label}: a MoE layer read to the host: "
                             f"{e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        slices = max(1, FAMILY_TRAIN_BATCH // microbatch) if microbatch \
            else 1
        # forward and remat recompute of each MoE layer, one backward
        want_calls = {"forward": 2 * n_moe * n * slices,
                      "backward": 2 * n_moe * n * slices}
        print(f"(c) {label}: losses {losses}, step ms {ms}, launches "
              f"{launches}, MoE layer passes under the sync check {calls} "
              f"(want {want_calls})")
        check(all(map(math.isfinite, losses)),
              f"(c) {label}: a loss is not finite")
        check(launches == {k: v * n * slices for k, v in want.items()},
              f"(c) {label} launched {launches}, want {want} a step")
        check(calls == want_calls, f"(c) {label}: MoE passes {calls}")
        return ms, launches

    box = {"state": state}
    del state
    moe.moe_block, layers.attn_block = checked_block, unchecked_attn_block
    total = {}
    try:
        ms, got = run(make_train_step(cfg, ctx, opt_cfg), box,
                      EP_TRAIN_STEPS, f"{EP_TRAIN_STEPS} steps")
        peak = torch.cuda.max_memory_allocated()
        for name, n in got.items():
            total[name] = total.get(name, 0) + n
        box["state"]["err"] = compression.init_error_buffer(
            box["state"]["params"])
        ms_c, got = run(make_train_step(cfg, ctx, opt_cfg,
                                        grad_compression=True),
                        box, 1, "one step with int8 compression")
        for name, n in got.items():
            total[name] += n
        del box["state"]["err"]
        ms_m, got = run(make_train_step(cfg, ctx, opt_cfg, microbatch=1),
                        box, 1, f"one step with microbatch=1 "
                        f"({FAMILY_TRAIN_BATCH} slices)", microbatch=1)
        for name, n in got.items():
            total[name] += n
    finally:
        moe.moe_block, layers.attn_block = real, real_attn
    check(int(box["state"]["step"]) == EP_TRAIN_STEPS + 2,
          f"(c) step reads {int(box['state']['step'])}")
    med = statistics.median(ms[1:])
    tokens = FAMILY_TRAIN_BATCH * FAMILY_TRAIN_SEQ
    routed = MEASURED.get("family_train", {}).get(MOE_ARCH)
    print(f"(c) {MOE_ARCH} through routed_ep: step {med} ms (median of "
          f"steps 2-{EP_TRAIN_STEPS}), {tokens / med * 1e3} tokens/s, "
          f"peak device memory {peak} bytes; compressed step {ms_c[0]} ms, "
          f"microbatched step {ms_m[0]} ms; phase 19's routed step of the "
          f"same cell in this run: "
          + (f"{routed['step_s'] * 1e3} ms, {tokens / routed['step_s']} "
             f"tokens/s, peak {routed['peak']} bytes" if routed else
             "not run in this call") + f" ({card})")
    if profile:
        batch = {k: v.to(dev) for k, v in next(batches).items()}
        step = make_train_step(cfg, ctx, opt_cfg)

        def one_step():
            box["state"], _ = step(box["state"], batch)
        _profile(f"{MOE_ARCH} routed_ep train step", one_step)
    del box
    return total, {"cfg": cfg, "peak": peak, "held": held,
                   "step_s": med / 1e3}


def _ep_train_peak(proc, m, card):
    """(c): the dry-run's count of the cell through ``routed_ep`` (the
    production mesh's context, in a subprocess that never touches CUDA)
    against the card's peak."""
    from repro_torch.common import hw
    lo, hi = DRYRUN_PEAK_RATIO
    out, _ = proc.communicate(timeout=FAMILY_COUNT_TIMEOUT_S)
    check(proc.returncode == 0,
          f"(c) the count exited {proc.returncode}: "
          f"{out.strip().splitlines()[-3:]}")
    rec = json.loads(out.strip().splitlines()[-1])
    check(not rec["cuda_initialized"] and not any(rec["launches"].values())
          and not rec["build_calls"], f"(c) the count touched the card: {rec}")
    c = rec["counts"]
    ratio = c["peak_bytes"] / m["peak"]
    terms = hw.roofline_terms(c["flops"], c["bytes"], 0.0)
    print(f"(c) {MOE_ARCH} through routed_ep: predicted peak "
          f"{c['peak_bytes']} bytes (argument {c['argument_bytes']}), "
          f"measured max_memory_allocated {m['peak']} bytes ({m['held']} "
          f"held before), ratio {ratio} (bound {lo}-{hi}); counted in "
          f"{rec['seconds']} s; bound_s {terms['bound_s']} "
          f"({terms['dominant']}), measured {m['step_s']} s a step, "
          f"bound_s / measured {terms['bound_s'] / m['step_s']} ({card})")
    check(lo <= ratio <= hi, f"(c) predicted/measured peak {ratio}")


TP_ARCH = "qwen2-7b"            # full width and depth, bf16
TP_RANKS = 2                    # model axis; both ranks on the one card
TP_BATCH, TP_PROMPT, TP_NEW = 2, 1024, 8     # TP_NEW decode steps
TP_CHECK_LAYERS = 2             # the float32 cut of (a) and (b)
TP_TRAIN_SEQ = 512
TP_RANK_TIMEOUT_S = 140
PHASE23_LIMIT_S = 150
# (c): FSDP over a data axis of the same two ranks (2 x 1)
FSDP_GRAD_TOL = 1e-5            # of each leaf's largest |element|
FSDP_LOSS_RTOL = 1e-6
FSDP_SEQ = 2048                 # (c2)'s rows a rank: 1 x FSDP_SEQ
FSDP_STEPS = 2                  # (c2)'s AdamW steps; the first warms up

TP_RANK = """\
import dataclasses, gc, json, sys, time
import numpy as np, torch, torch.distributed as dist
rank, world, store, out, args = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4],
                                 json.loads(sys.argv[5]))
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.device import set_device
from repro_torch.distributed import collectives, data_parallel
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import make_context
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert, model
from repro_torch.models.layers import ModelContext
from repro_torch.serve import engine
from repro_torch.train import OptimizerConfig
from repro_torch.train.train_step import (data_shard, loss_and_grads,
                                          make_train_state,
                                          make_train_state_shapes,
                                          make_train_step)
set_device("cuda")
dev = torch.device("cuda", 0)
mesh = make_host_mesh(1, world, backend="gloo")
res = {"rank": rank, "backend": dist.get_backend(),
       "model_rank": mesh.get_local_rank("model")}
B, S, new = args["batch"], args["prompt"], args["new"]
cache_len = S + new + 1


def nbytes(t):
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


def release():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def serve(cfg, params, ctx, prompt):
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launches()
    timings = {}
    ids = engine.generate(params, prompt, cfg, ctx, max_new_tokens=new + 1,
                          cache_len=cache_len, timings=timings)
    torch.cuda.synchronize()
    return ids, dict(ops.LAUNCHES), timings


# (a) bf16 at full width and depth: every rank makes the whole model from
# one seed and keeps its share
cfg = get_config(args["arch"])
ctx = make_context(mesh)
whole = model.init(torch.Generator(device=dev).manual_seed(0), cfg)
split = TP.layout(cfg, ctx)
flat = tree.flatten_with_names(whole)
res["whole_bytes"] = nbytes(whole)
res["split_bytes"] = sum(nbytes(flat[n]) for n in split)
params = convert.local_tp_params(whole, cfg, ctx)
del whole, flat
release()
res["param_bytes"] = nbytes(params)
res["heads"] = [params["layers"][0]["attn"]["wq"].shape[1] // cfg.head_dim,
                params["layers"][0]["attn"]["wk"].shape[1] // cfg.head_dim]
prompt = torch.randint(0, cfg.vocab_size, (B, S),
                       generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
# first calls load the kernels and build cuBLAS handles: not measured
engine.generate(params, prompt, cfg, ctx, max_new_tokens=2,
                cache_len=cache_len)
release()
torch.cuda.reset_peak_memory_stats()
ids, res["launches"], t = serve(cfg, params, ctx, prompt)
res["peak"] = torch.cuda.max_memory_allocated()
caches, _ = model.prefill(params, prompt, cfg, ctx, cache_len=cache_len)
res["cache_bytes"] = nbytes(caches)
del caches
res["prefill_s"], res["decode_s"] = t["prefill_s"], t["decode_s"]
res["ids"] = ids[:, :8].tolist()
del params, ids
release()

# the float32 cut: the model axis against a world of one (rank 0 runs the
# whole model in this process)
cfg32 = dataclasses.replace(cfg, dtype="float32",
                            num_layers=args["check_layers"])
whole32 = model.init(torch.Generator(device=dev).manual_seed(0), cfg32)
p32 = convert.local_tp_params(whole32, cfg32, ctx)
if rank:
    del whole32
ids32, res["launches32"], _ = serve(cfg32, p32, ctx, prompt)
_, logits = model.prefill(p32, prompt, cfg32, ctx, cache_len=cache_len)
parts = [torch.empty_like(logits) for _ in range(world)]
dist.all_gather(parts, logits)
res["logits_same"] = all(torch.equal(x, parts[0]) for x in parts)
one = ModelContext()
if rank == 0:
    want_ids = engine.generate(whole32, prompt, cfg32, one,
                               max_new_tokens=new + 1, cache_len=cache_len)
    _, want = model.prefill(whole32, prompt, cfg32, one, cache_len=cache_len)
    res["ids_equal"] = bool(torch.equal(ids32, want_ids))
    res["logits_rel"] = ((logits - want).abs().max()
                         / want.abs().max()).item()
    res["logits_finite"] = bool(torch.isfinite(logits).all())
    del want, want_ids
del logits, ids32
release()

# (b) one float32 training step's gradients at the cut
tokens = torch.randint(0, cfg32.vocab_size, (1, args["train_seq"] + 1),
                       generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev)
batch = {"tokens": tokens}
tctx = make_context(mesh, remat="full", q_chunk=256, k_chunk=256)
split32 = TP.layout(cfg32, tctx)
torch.cuda.synchronize()
dist.barrier()
ops.reset_launches()
t0 = time.perf_counter()
(loss, _), grads = loss_and_grads(p32, batch, cfg32, tctx)
grads = data_parallel.reduce_gradients(grads, tctx, split32)
torch.cuda.synchronize()
res["train_s"] = time.perf_counter() - t0
res["train_launches"] = dict(ops.LAUNCHES)
got = tree.flatten_with_names(data_parallel.gather_split(grads, tctx,
                                                         split32))
res["loss"] = loss.item()
del grads, p32
release()
if rank == 0:
    (want_loss, _), want = loss_and_grads(
        whole32, batch, cfg32, ModelContext(remat="full", q_chunk=256,
                                            k_chunk=256))
    want = tree.flatten_with_names(want)
    worst, worst_name = -1.0, ""
    for name, w in want.items():
        scale = w.abs().max().item()
        rel = (got[name] - w).abs().max().item() / max(scale, 1e-30)
        if rel > worst and scale > 0:
            worst, worst_name = rel, name
    res["grad_worst"], res["grad_worst_leaf"] = worst, worst_name
    res["grad_leaves"] = len(want)
    res["grads_finite"] = all(bool(torch.isfinite(g).all())
                              for g in got.values())
    res["want_loss"] = want_loss.item()
    # the loop's last leaf too: a whole float32 gradient
    del want, want_loss, w
del got
if rank == 0:
    del whole32
release()

# (c) FSDP: the same two ranks as a 2 x 1 mesh, each holding its data-axis
# block of every leaf the reference cuts over "data"
fmesh = make_host_mesh(world, 1, backend="gloo")
res["data_rank"] = fmesh.get_local_rank("data")
fctx = make_context(fmesh, remat="full", q_chunk=256, k_chunk=256)
# (c1) float32 gradients at the cut on the global world x train_seq batch
whole32 = model.init(torch.Generator(device=dev).manual_seed(0), cfg32)
fcuts32 = TP.layout(cfg32, fctx)
pf = convert.local_tp_params(whole32, cfg32, fctx)
if rank:
    del whole32
gtokens = torch.randint(0, cfg32.vocab_size, (world, args["train_seq"] + 1),
                        generator=torch.Generator(device=dev).manual_seed(4),
                        device=dev)
torch.cuda.synchronize()
dist.barrier()
ops.reset_launches()
t0 = time.perf_counter()
(floss, _), fgrads = loss_and_grads(pf, data_shard({"tokens": gtokens}, fctx),
                                    cfg32, fctx)
fgrads = data_parallel.reduce_gradients(fgrads, fctx, fcuts32)
torch.cuda.synchronize()
res["fsdp_grad_s"] = time.perf_counter() - t0
res["fsdp_launches32"] = dict(ops.LAUNCHES)
res["fsdp_cut_leaves"] = len(fcuts32)
mean = floss.clone()
dist.all_reduce(mean)
res["fsdp_loss"] = (mean / world).item()
# every rank's blocks, gathered in rank order: block d is rank d's shard
fgot = tree.flatten_with_names(data_parallel.gather_split(fgrads, fctx,
                                                          fcuts32))
del pf, fgrads
release()
if rank == 0:
    (want_loss, _), want = loss_and_grads(
        whole32, {"tokens": gtokens}, cfg32,
        ModelContext(remat="full", q_chunk=256, k_chunk=256))
    worst = [[-1.0, ""] for _ in range(world)]
    for name, w in tree.flatten_with_names(want).items():
        scale = w.abs().max().item()
        cuts = fcuts32.get(name)
        for d in range(world):
            blk = (lambda t: TP.local_block(t, cuts, (0, 1), (d, world))) \
                if cuts is not None else (lambda t: t)
            rel = (blk(fgot[name]) - blk(w)).abs().max().item() / max(
                scale, 1e-30)
            if rel > worst[d][0] and scale > 0:
                worst[d] = [rel, name]
    res["fsdp_grad_worst"] = worst
    res["fsdp_grads_finite"] = all(bool(torch.isfinite(g).all())
                                   for g in fgot.values())
    res["fsdp_want_loss"] = want_loss.item()
    del want, whole32, w
del fgot
release()

# (c2) bf16 AdamW steps at the cut, 1 x FSDP_SEQ a rank: the state made
# whole from one seed, then cut to this rank's block
cfg2 = dataclasses.replace(cfg, num_layers=args["check_layers"])
opt_cfg = OptimizerConfig(warmup_steps=10)
shapes = make_train_state_shapes(cfg2, opt_cfg)
fcuts = TP.layout(cfg2, fctx)
res["fsdp_whole_state_bytes"] = nbytes(shapes["params"]) + nbytes(
    shapes["opt"])
# the count from the layout: a data-cut leaf's bytes over the axis
flat = tree.flatten_with_names({"params": shapes["params"],
                                "opt": shapes["opt"]})
cut = TP.cuts_of(flat, fcuts)
res["fsdp_layout_state_bytes"] = sum(
    t.numel() * t.element_size() // (
        world if n in cut and cut[n].data is not None else 1)
    for n, t in flat.items())
state = convert.local_tp_state(make_train_state(
    torch.Generator(device=dev).manual_seed(0), cfg2, opt_cfg), cfg2, fctx)
release()
res["fsdp_state_bytes"] = nbytes(state["params"]) + nbytes(state["opt"])
step = make_train_step(cfg2, fctx, opt_cfg)
tokens2 = torch.randint(0, cfg2.vocab_size, (world, args["fsdp_seq"] + 1),
                        generator=torch.Generator(device=dev).manual_seed(5),
                        device=dev, dtype=torch.int32)
batch2 = data_shard({"tokens": tokens2}, fctx)
# the step's arguments, as the dry-run counts them: the state and the rows
res["fsdp_arg_bytes"] = nbytes(state) + nbytes(batch2)
torch.cuda.reset_peak_memory_stats()
torch.cuda.synchronize()
dist.barrier()
ops.reset_launches()
ms, losses = [], []
for i in range(args["fsdp_steps"]):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with collectives.recording() as tally:
        state, met = step(state, batch2)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
    losses.append(met["loss"].item())
    if i == 0:
        # the first step's collectives through the seam, as the dry-run
        # keys them: "<kind> <group size> count|operand_bytes"
        res["fsdp_collectives"] = {
            f"{kind} {ways} {what}": n
            for (kind, ways), rec in tally.calls.items()
            for what, n in zip(("count", "operand_bytes"), rec)}
res["fsdp_launches"] = dict(ops.LAUNCHES)
res["fsdp_peak"] = torch.cuda.max_memory_allocated()
res["fsdp_step_ms"], res["fsdp_losses"] = ms, losses
res["fsdp_steps_done"] = int(state["step"])
# a checkpoint: every leaf gathered whole, a world of one's shapes
ckpt = data_parallel.gather_split(state, fctx, fcuts)
want_shapes = {n: tuple(t.shape)
               for n, t in tree.flatten_with_names(shapes).items()}
res["fsdp_ckpt_shapes_equal"] = {
    n: tuple(t.shape) for n, t in tree.flatten_with_names(ckpt).items()
} == want_shapes
res["fsdp_ckpt_leaves"] = len(want_shapes)
del ckpt, state
release()
with open(out, "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def _fsdp_counts():
    """Phase 23 (c2)'s first step counted by the dry-run at each rank's
    coordinates of the 2 x 1 mesh (``launch.mesh.RankMesh``): the same
    cut, rows, context and optimizer as the ranks'."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import make_context
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.train import OptimizerConfig
    cfg = dataclasses.replace(get_config(TP_ARCH),
                              num_layers=TP_CHECK_LAYERS)
    shape = ShapeConfig("phase23_fsdp", "train", FSDP_SEQ, TP_RANKS)
    out = []
    for d in range(TP_RANKS):
        ctx = make_context(RankMesh(("data", "model"), (TP_RANKS, 1),
                                    (d, 0), one_rank_groups=True),
                           remat="full", q_chunk=256, k_chunk=256)
        t0 = time.perf_counter()
        c = dryrun_lib.count_cell(cfg, shape, ctx,
                                  opt_cfg=OptimizerConfig(warmup_steps=10))
        c["count_s"] = time.perf_counter() - t0
        out.append(c)
    return out


def _fsdp_report(res, card, counts):
    """Phase 23 (c): the ranks' FSDP results, printed and checked, (c2)'s
    against the dry-run's ``counts`` (``_fsdp_counts``)."""
    import statistics
    r0 = res[0]
    check([r["data_rank"] for r in res] == list(range(TP_RANKS)),
          f"(c) data-axis ranks {[r['data_rank'] for r in res]}")
    rel = abs(r0["fsdp_loss"] - r0["fsdp_want_loss"]) / abs(
        r0["fsdp_want_loss"])
    print(f"(c1) float32 gradients at {TP_CHECK_LAYERS} layers on the "
          f"global {TP_RANKS} x {TP_TRAIN_SEQ} batch, each rank 1 x "
          f"{TP_TRAIN_SEQ} and its data-axis block of "
          f"{r0['fsdp_cut_leaves']} cut leaves: loss {r0['fsdp_loss']} vs a "
          f"world of one's {r0['fsdp_want_loss']} (relative {rel}, limit "
          f"{FSDP_LOSS_RTOL}); worst reduce-scattered block by rank "
          f"{r0['fsdp_grad_worst']} of its leaf's max |g| (limit "
          f"{FSDP_GRAD_TOL}); {[r['fsdp_grad_s'] for r in res]} s a rank; "
          f"launches {[r['fsdp_launches32'] for r in res]} ({card})")
    check(all(r["fsdp_loss"] == r0["fsdp_loss"] for r in res) and
          rel <= FSDP_LOSS_RTOL, f"(c1) loss differs by {rel}")
    check(r0["fsdp_grads_finite"] and all(
        w <= FSDP_GRAD_TOL for w, _ in r0["fsdp_grad_worst"]),
        f"(c1) gradient blocks differ: {r0['fsdp_grad_worst']}")
    want = FSDP_STEPS * 2 * TP_CHECK_LAYERS
    for r in res:
        check(r["fsdp_launches32"]["flash_attention"] == 2 * TP_CHECK_LAYERS
              and sum(r["fsdp_launches32"].values()) == 2 * TP_CHECK_LAYERS,
              f"(c1) rank {r['rank']} launched {r['fsdp_launches32']}")
        check(r["fsdp_launches"]["flash_attention_wgmma"] == want and
              sum(r["fsdp_launches"].values()) == want,
              f"(c2) rank {r['rank']} launched {r['fsdp_launches']}, want "
              f"{want} flash_attention_wgmma")
        after = statistics.median(r["fsdp_step_ms"][1:])
        print(f"(c2) rank {r['rank']}: bf16 AdamW state (parameters + "
              f"moments) {r['fsdp_state_bytes']} bytes, the layout's count "
              f"{r['fsdp_layout_state_bytes']}, a world of one's "
              f"{r['fsdp_whole_state_bytes']}; peak device memory "
              f"{r['fsdp_peak']} bytes over {FSDP_STEPS} steps of 1 x "
              f"{FSDP_SEQ} ({r['fsdp_peak'] / r['fsdp_state_bytes']} of the "
              f"state); steps {r['fsdp_step_ms']} ms (after the first: "
              f"{after} ms, a card shared by {TP_RANKS} "
              f"processes over gloo, not FSDP's); losses "
              f"{r['fsdp_losses']}; launches {r['fsdp_launches']}; "
              f"checkpoint of {r['fsdp_ckpt_leaves']} whole leaves, a world "
              f"of one's shapes: {r['fsdp_ckpt_shapes_equal']} ({card})")
        check(r["fsdp_state_bytes"] == r["fsdp_layout_state_bytes"],
              f"(c2) rank {r['rank']} holds {r['fsdp_state_bytes']} bytes "
              f"of state, the layout counts {r['fsdp_layout_state_bytes']}")
        check(r["fsdp_state_bytes"] < r["fsdp_whole_state_bytes"] and
              r["fsdp_state_bytes"] <= r["fsdp_peak"],
              f"(c2) rank {r['rank']} state {r['fsdp_state_bytes']}, peak "
              f"{r['fsdp_peak']}")
        check(r["fsdp_steps_done"] == FSDP_STEPS and all(
            math.isfinite(x) for x in r["fsdp_losses"]),
            f"(c2) rank {r['rank']} steps {r['fsdp_steps_done']}, losses "
            f"{r['fsdp_losses']}")
        check(r["fsdp_ckpt_shapes_equal"],
              f"(c2) rank {r['rank']}'s gathered checkpoint differs in "
              f"shapes from a world of one's")
    check(all(r["fsdp_losses"] == r0["fsdp_losses"] for r in res),
          "(c2) the ranks' losses differ")
    lo, hi = DRYRUN_PEAK_RATIO
    for r in res:
        c = counts[r["data_rank"]]
        want = {k[len("collective "):]: v for k, v in c.items()
                if k.startswith("collective ")}
        ratio = c["peak_bytes"] / r["fsdp_peak"]
        print(f"(c3) rank {r['rank']}: the first step's collectives "
              f"through the seam {r['fsdp_collectives']}; the dry-run's "
              f"count at ({r['data_rank']}, 0) of a {TP_RANKS} x 1 mesh "
              f"{want} (counted in {c['count_s']} s); argument bytes "
              f"{r['fsdp_arg_bytes']} vs {c['argument_bytes']}; predicted "
              f"peak {c['peak_bytes']} bytes, measured {r['fsdp_peak']}, "
              f"ratio {ratio} (bound {lo}-{hi}; {card})")
        check(r["fsdp_collectives"] == want,
              f"(c3) rank {r['rank']}'s collectives differ from the "
              f"dry-run's")
        check(r["fsdp_arg_bytes"] == c["argument_bytes"],
              f"(c3) rank {r['rank']}'s arguments {r['fsdp_arg_bytes']} "
              f"bytes, the dry-run's {c['argument_bytes']}")
        check(lo <= ratio <= hi,
              f"(c3) rank {r['rank']}: predicted/measured peak {ratio}")


def phase_tp():
    """Phase 23: ``qwen2-7b`` tensor-parallel over a model axis of two
    ranks sharing the card (spawned processes, gloo), then FSDP over a
    data axis of the same two ranks; returns the flash kernels' launches
    of the ranks' main paths."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    print(f"== phase 23: {TP_ARCH} tensor-parallel over a model axis of "
          f"{TP_RANKS} ranks sharing the card (gloo)")
    t_phase = time.perf_counter()
    card = smi_line()
    held_report("phase 23")
    cfg = get_config(TP_ARCH)
    args = {"arch": TP_ARCH, "batch": TP_BATCH, "prompt": TP_PROMPT,
            "new": TP_NEW, "check_layers": TP_CHECK_LAYERS,
            "train_seq": TP_TRAIN_SEQ, "fsdp_seq": FSDP_SEQ,
            "fsdp_steps": FSDP_STEPS}
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(TP_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", TP_RANK, str(r), str(TP_RANKS),
             os.path.join(tmp, "store"), outs[r], json.dumps(args)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=SRC), cwd=ROOT)
            for r in range(TP_RANKS)]
        try:
            # (c3)'s counts, on the host while the ranks run
            counts = _fsdp_counts()
            logs = [p.communicate(timeout=TP_RANK_TIMEOUT_S)[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"rank {r} exited {p.returncode}: "
                  f"{log.strip().splitlines()[-6:]}")
        res = []
        for path in outs:
            with open(path) as f:
                res.append(json.load(f))
    r0 = res[0]
    hd = cfg.head_dim
    print(f"process group: {r0['backend']}, {TP_RANKS} ranks on "
          f"{torch.cuda.get_device_name(0)}; model-axis ranks "
          f"{[r['model_rank'] for r in res]}")
    check(all(r["backend"] == "gloo" for r in res) and
          [r["model_rank"] for r in res] == list(range(TP_RANKS)),
          f"backends {[r['backend'] for r in res]}")
    n_layers = cfg.num_layers
    for r in res:
        heads = (cfg.num_heads // TP_RANKS, cfg.num_kv_heads // TP_RANKS)
        want_bytes = r["whole_bytes"] - r["split_bytes"] + \
            r["split_bytes"] // TP_RANKS
        print(f"(a) rank {r['rank']}: {r['heads'][0]}/{r['heads'][1]} heads "
              f"of {hd}; parameters {r['param_bytes']} bytes (whole leaves "
              f"+ half of the split ones' {r['split_bytes']}: {want_bytes}; "
              f"the whole model {r['whole_bytes']}), caches "
              f"{r['cache_bytes']} bytes, peak device memory {r['peak']} "
              f"bytes over generate ({card})")
        check(tuple(r["heads"]) == heads, f"rank heads {r['heads']}")
        check(r["param_bytes"] == want_bytes,
              f"rank {r['rank']} holds {r['param_bytes']} bytes of "
              f"parameters, want {want_bytes}")
        check(r["param_bytes"] + r["cache_bytes"] <= r["peak"]
              < r["whole_bytes"],
              f"rank {r['rank']} peak {r['peak']} bytes")
        check(r["launches"]["flash_attention_wgmma"] == n_layers and
              sum(r["launches"].values()) == n_layers,
              f"(a) rank {r['rank']} launched {r['launches']}, want "
              f"{n_layers} flash_attention_wgmma")
        n_dec = TP_BATCH * TP_NEW
        print(f"(a) rank {r['rank']}: prefill {TP_BATCH * TP_PROMPT} tokens "
              f"in {r['prefill_s']} s ({TP_BATCH * TP_PROMPT / r['prefill_s']}"
              f" tokens/s), decode {TP_NEW} steps of {TP_BATCH} in "
              f"{r['decode_s']} s ({r['decode_s'] / TP_NEW * 1e3} ms a "
              f"step, {n_dec / r['decode_s']} tokens/s): figures of one card "
              f"shared by {TP_RANKS} processes over gloo, not of tensor "
              f"parallelism; launches {r['launches']}; first ids "
              f"{r['ids'][0][:8]}")
    check(all(r["ids"] == r0["ids"] for r in res),
          "(a) the ranks generated different ids")
    for r in res:
        check(r["launches32"]["flash_attention"] == TP_CHECK_LAYERS and
              sum(r["launches32"].values()) == TP_CHECK_LAYERS,
              f"(a) float32 rank {r['rank']} launched {r['launches32']}")
        check(r["train_launches"]["flash_attention"] == 2 * TP_CHECK_LAYERS
              and sum(r["train_launches"].values()) == 2 * TP_CHECK_LAYERS,
              f"(b) rank {r['rank']} launched {r['train_launches']}")
    print(f"(a) float32 at {TP_CHECK_LAYERS} layers: logits the same on "
          f"both ranks: {all(r['logits_same'] for r in res)}; max abs diff "
          f"/ max |logit| against a world of one {r0['logits_rel']} (limit "
          f"{LM_F32_REL_TOL}); ids equal: {r0['ids_equal']} ({card})")
    check(all(r["logits_same"] for r in res) and r0["logits_finite"],
          "(a) float32 logits differ between the ranks or are not finite")
    check(r0["logits_rel"] < LM_F32_REL_TOL,
          f"(a) float32 logits differ by {r0['logits_rel']}")
    check(r0["ids_equal"], "(a) float32 ids differ from a world of one")
    rel = abs(r0["loss"] - r0["want_loss"]) / abs(r0["want_loss"])
    print(f"(b) float32 step at {TP_CHECK_LAYERS} layers, 1 x "
          f"{TP_TRAIN_SEQ}: loss {r0['loss']} vs {r0['want_loss']} "
          f"(relative {rel}, limit {LM_LOSS_RTOL}); worst gradient leaf "
          f"{r0['grad_worst_leaf']}, {r0['grad_worst']} of its max |g| "
          f"(limit {LM_GRAD_TOL}) over {r0['grad_leaves']} leaves; "
          f"{[r['train_s'] for r in res]} s a rank; launches "
          f"{r0['train_launches']} ({card})")
    check(all(r["loss"] == r0["loss"] for r in res) and rel <= LM_LOSS_RTOL,
          f"(b) loss differs by {rel}")
    check(r0["grads_finite"] and r0["grad_worst"] <= LM_GRAD_TOL,
          f"(b) gradient {r0['grad_worst_leaf']} differs by "
          f"{r0['grad_worst']}")
    _fsdp_report(res, card, counts)
    launches = {
        "flash_attention_wgmma": sum(r["launches"]["flash_attention_wgmma"]
                                     + r["fsdp_launches"][
                                         "flash_attention_wgmma"]
                                     for r in res),
        "flash_attention": sum(r["launches32"]["flash_attention"] +
                               r["train_launches"]["flash_attention"] +
                               r["fsdp_launches32"]["flash_attention"]
                               for r in res)}
    dt = time.perf_counter() - t_phase
    print(f"phase 23: {dt} s (limit {PHASE23_LIMIT_S} s); launches "
          f"{launches} ({card})")
    check(dt <= PHASE23_LIMIT_S, f"phase 23 took {dt} s")
    return launches


# ---------------------------------------------------------------- phase 24
TPF_RANKS = 2                   # model axis; both ranks on the one card
#: TPF_NEW decode steps (8 until PR 36: zamba2's ran 0.4-2.2 s a step
#: on the shared card over gloo, PR 36 made room for part (d))
TPF_BATCH, TPF_PROMPT, TPF_NEW = 2, 1024, 4
TPF_CHECK_PROMPT = 512          # the float32 logits: TPF_BATCH x this
TPF_TRAIN_SEQ = 512             # the float32 step: 1 x this
#: each run: (tag, arch, the bf16 serving cut, the float32 cut, the
#: float32 step's seq_shard_residual settings, whether one bf16
#: make_train_step step follows at the float32 cut's depth, under the
#: last of those settings)
TPF_RUNS = (
    # 1 dense + 1 MoE MLA layer (29.83 GB whole), all 256 experts through
    # routed_ep; float32: 1 MLA layer and the MTP module (13.62 GB); no
    # bf16 step: a rank's state (10.6 GB), its gradients, AdamW's new
    # copy and its float32 temporaries of the vocabulary's rows ran out
    # of the card's 79 GiB with two ranks (34.3 GiB allocated a rank)
    ("a", "deepseek-v3-671b", dict(num_layers=2, first_dense_layers=1),
     dict(num_layers=1, first_dense_layers=1), (False,), False),
    # 4 self + 1 cross (12.76 GB whole in bf16, 25.52 GB in float32); no
    # bf16 step: a rank's state at the cut is 31.9 GB (float32 moments)
    ("b", "llama-3.2-vision-90b", dict(num_layers=5), dict(num_layers=5),
     (False,), False),
    # full width and depth (4.69 GB); float32 at 2 super-blocks
    ("c", "zamba2-2.7b", {}, dict(num_layers=12), (False, True), True),
)
#: the flash launches a rank, from the code: (bf16 generate, float32
#: prefill, one float32 step's gradient, the bf16 step). MLA takes the
#: plain loop (q/k 192, v 128) and the MTP layer's GQA attention (64/64
#: heads of 128 a rank) one FFMA launch a step; the VLM's 4 self-attention layers (32/4 heads of 128 a rank)
#: one a prefill and two a step (forward and remat recompute), its cross
#: layer the plain loop (Sq != Skv); zamba2's shared attention (16/16
#: heads of 80 a rank) the FFMA kernel in bf16 too, at each of its 9
#: applications (2 at the cut)
TPF_LAUNCHES = {
    "a": ({}, {}, {"flash_attention": 1}, None),
    "b": ({"flash_attention_wgmma": 4}, {"flash_attention": 4},
          {"flash_attention": 8}, None),
    "c": ({"flash_attention": 9}, {"flash_attention": 2},
          {"flash_attention": 4}, {"flash_attention": 4}),
}
#: the float32 global norm (the optimizer's, over the step's gradient
#: blocks) against a world of one's, relative: each leaf's blocks lie
#: within LM_GRAD_TOL of its max, most elements far closer
TPF_NORM_RTOL = 1e-5
#: the bf16 step's loss against the float32 world of one's (the same
#: seeded numbers, rounded), relative: the CPU tests' bf16 bound
TPF_BF16_RTOL = 5e-2
TPF_RANK_TIMEOUT_S = 420
PHASE24_LIMIT_S = 300
#: (d4): the runs whose float32 check also decodes TPF_CHECK_NEW greedy
#: steps from its prefill, logits against the world of one's at every
#: step: V3's MLA latent cache cut over the model axis
TPF_DECODE_RUNS, TPF_CHECK_NEW = ("a",), 4
#: (d): the layouts the port once refused and the decode caches cut as
#: the reference's ``cache_specs`` cuts them, float32 over the same two
#: ranks, each against a world of one computed first in the phase's
#: process: (tag, arch, cut, context fields, what runs). The MoE cut: 1
#: dense + 1 MoE layer (64 experts, the dense route or routed_ep);
#: gemma3-4b: 5 window + 1 global layer.
TPF_D_MOE_CUT = dict(num_layers=2, first_dense_layers=1)
TPF_D_RUNS = (
    # (d1) the dense route over 2 data ranks (the no_tp hint's default):
    # the global batch's load-balance aux
    ("d1-notp", "deepseek-moe-16b", TPF_D_MOE_CUT, dict(no_tp=True),
     "grads"),
    # (d1) the dense route under seq_shard_residual over the model axis
    ("d1-seq", "deepseek-moe-16b", TPF_D_MOE_CUT,
     dict(moe_impl="dense", seq_shard_residual=True), "grads"),
    # (d2) routed_ep under autograd at 1 x 511 (every rank routes every
    # position; E/k: no pair drops, the world of one's dense route)
    ("d2-odd", "deepseek-moe-16b", TPF_D_MOE_CUT,
     dict(capacity_factor=64 / 6), "grads"),
    # (d3) a batch of 1 over 2 data ranks: its caches cut on the sequence
    ("d3-ctx", "gemma3-4b", dict(num_layers=6),
     dict(no_tp=True, batch_replicated=True), "decode"),
)
#: (d1)'s batch (whole on each rank under the hint, a row a rank under
#: no_tp), (d2)'s: tokens [b, s + 1]
TPF_D_BATCH = {"d1-notp": (2, 512), "d1-seq": (2, 512), "d2-odd": (1, 511)}
#: (d3): a prompt longer than the window (1,024), so that the ring's and
#: the global cache's rows spread over both ranks, then greedy steps
TPF_D_PROMPT, TPF_D_NEW = 1536, 8
#: the flash launches a rank in (d): the MoE cut's attention (16/16
#: heads of 128; 8/8 a rank where the model axis splits it) in float32,
#: its two layers' forward and remat recompute; gemma3-4b's head dim 256
#: and windows take the plain loop
TPF_D_LAUNCHES = {"d1-notp": {"flash_attention": 4},
                  "d1-seq": {"flash_attention": 4},
                  "d2-odd": {"flash_attention": 4}, "d3-ctx": {}}
#: (d)'s gradients: each leaf's block at TPF_D_SAMPLES seeded elements
#: against the world of one's, over the leaf's largest |element| (a
#: whole block of the MoE cut is ~4.5 GB a case: too much to write),
#: beside the global norm, which every element enters
TPF_D_SAMPLES = 4096

TPF_RANK = """\
import dataclasses, gc, json, os, sys, time
import torch, torch.distributed as dist
rank, world, store, out, tmp, args = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5],
                                      json.loads(sys.argv[6]))
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
import chip_smoke as C
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.device import set_device
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import make_context
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert, model
from repro_torch.models.layers import ShapesOnly
from repro_torch.serve import engine
from repro_torch.train import OptimizerConfig
from repro_torch.train.optimizer import global_norm
from repro_torch.train import train_step
from repro_torch.train.train_step import (make_grads_fn, make_train_state,
                                          make_train_state_shapes,
                                          make_train_step)
set_device("cuda")
dev = torch.device("cuda", 0)
mesh = make_host_mesh(1, world, backend="gloo")
ctx = make_context(mesh)
res = {"rank": rank, "backend": dist.get_backend(),
       "model_rank": mesh.get_local_rank("model"), "runs": {}}
B, S, new = args["batch"], args["prompt"], args["new"]


def wait_for(path):
    deadline = time.monotonic() + args["wait_s"]
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"nothing at {path}")
        time.sleep(0.1)


# the phase's process holds the card for its worlds of one until "go"
wait_for(os.path.join(tmp, "go"))


def nbytes(t):
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


def release():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def build(cfg, opt_cfg=None, kctx=None):
    # each rank in turn makes the model (with opt_cfg: a train state) from
    # one seed, a top-level leaf or a layer at a time, and keeps its block
    # (convert.local_tp_keep; kctx: another context's): no rank holds the
    # whole model, and one whole layer at most is made on the card at a
    # time
    out = None
    for r in range(world):
        if r == rank:
            gen = torch.Generator(device=dev).manual_seed(0)
            keep = convert.local_tp_keep(cfg, kctx or ctx)
            out = (model.init(gen, cfg, keep=keep) if opt_cfg is None else
                   make_train_state(gen, cfg, opt_cfg, keep=keep))
            if cfg.family == "vlm":
                C._open_gates(out if opt_cfg is None else out["params"],
                              cfg, 1)
            release()
        dist.barrier()
    return out


def sizes(r, key, cfg, params):
    # this rank's bytes, the layout's count of them, the whole model's
    cuts = TP.layout(cfg, ctx)
    whole = tree.flatten_with_names(model.init(ShapesOnly(), cfg))
    r[key] = {"rank": nbytes(params), "whole": nbytes(whole),
              "layout": sum(t.numel() * t.element_size() // (
                  world if n in cuts and cuts[n].model is not None else 1)
                  for n, t in whole.items())}


def images(cfg, b):
    return ({"image_embeds": C._tpf_image(cfg, b)}
            if cfg.family == "vlm" else {})


def reference(tag):
    path = os.path.join(tmp, f"{tag}_rank{rank}.pt")
    wait_for(path)
    return torch.load(path, mmap=True)


def cache_bytes(cfg, dctx, caches, B, cache_len):
    # this rank's attention and MLA cache bytes, the layout's count of
    # them (the batch-1 sequence cut over the data ranks, the MLA latent
    # over the model axis) and a world of one's
    specs = model.layer_specs(cfg)
    D = dctx.data_axes_size if dctx.batch_replicated else 1
    M = dctx.tp_size
    out = {"rank": 0, "layout": 0, "whole": 0}
    for spec, c in zip(specs, caches):
        if spec.kind not in ("attn", "mla"):
            continue
        out["rank"] += nbytes(list(c))
        rows = model.cache_rows(spec, cache_len)
        if spec.kind == "mla":
            w = B * rows * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 4
            out["layout"] += w // M
        else:
            w = 2 * B * rows * cfg.num_kv_heads * cfg.head_dim * 4
            out["layout"] += w // (D if rows % D == 0 else 1)
        out["whole"] += w
    return out


def decode_check(cfg, dctx, params, caches, logits, S, n, want, cache_len):
    # greedy steps from a prefill's caches and last logits: each step's
    # logits against the world of one's (want: [n + 1, B, Vp] on the
    # host, the prefill's first), the ids, this rank's cache bytes
    out = {"cache": cache_bytes(cfg, dctx, caches, logits.shape[0],
                                cache_len), "rel": [], "ids": []}
    for i in range(n + 1):
        w = want[i].to(dev)
        out["rel"].append(((logits - w).abs().max()
                           / w.abs().max()).item())
        out["finite"] = out.get("finite", True) and bool(
            torch.isfinite(logits).all())
        ids = logits.argmax(-1)
        out["ids"].append(ids.tolist())
        out["ids_equal"] = out.get("ids_equal", True) and bool(
            (ids == w.argmax(-1)).all())
        if i < n:
            caches, logits = model.decode_step(params, caches, ids[:, None],
                                               S + i, cfg, dctx)
    torch.cuda.synchronize()
    return out


for tag, arch, cut16, cut32, seqs, step16 in args["runs"]:
    r = res["runs"][tag] = {}
    t_run = time.perf_counter()
    # bf16 serving at full width
    cfg = dataclasses.replace(get_config(arch), **cut16)
    t0 = time.perf_counter()
    params = build(cfg)
    r["build_s"] = time.perf_counter() - t0
    sizes(r, "bytes", cfg, params)
    prompt = C._tpf_tokens(cfg, B, S, 1)
    img = images(cfg, B)
    # first calls load the kernels and build cuBLAS handles: not measured
    engine.generate(params, prompt[:, :64], cfg, ctx, max_new_tokens=2,
                    **img)
    release()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    ops.reset_launches()
    timings = {}
    ids = engine.generate(params, prompt, cfg, ctx, max_new_tokens=new + 1,
                          cache_len=S + new + 1, timings=timings, **img)
    torch.cuda.synchronize()
    r["launches"] = dict(ops.LAUNCHES)
    r["peak"] = torch.cuda.max_memory_allocated()
    r["prefill_s"], r["decode_s"] = timings["prefill_s"], timings["decode_s"]
    r["ids"] = ids.tolist()
    del params, ids, img
    release()
    r["bf16_s"] = time.perf_counter() - t_run
    # float32 at the cut against a world of one
    cfg32 = dataclasses.replace(get_config(arch), dtype="float32", **cut32)
    p32 = build(cfg32)
    sizes(r, "bytes32", cfg32, p32)
    t0 = time.perf_counter()
    ref = reference(tag)
    r["wait_s"] = time.perf_counter() - t0
    prompt = C._tpf_tokens(cfg32, B, args["check_prompt"], 1)
    new32 = args["check_new"] if tag in args["decode_runs"] else 0
    dist.barrier()
    ops.reset_launches()
    caches, logits = model.prefill(p32, prompt, cfg32, ctx,
                                   cache_len=args["check_prompt"] + 1
                                   + new32, **images(cfg32, B))
    torch.cuda.synchronize()
    r["launches32"] = dict(ops.LAUNCHES)
    want = ref["logits"].to(dev)
    r["logits_rel"] = ((logits - want).abs().max()
                       / want.abs().max()).item()
    r["logits_finite"] = bool(torch.isfinite(logits).all())
    if new32:
        # (d4): greedy decode steps on this rank's cut of the caches
        r["decode32"] = decode_check(cfg32, ctx, p32, caches, logits,
                                     args["check_prompt"], new32,
                                     ref["decode"],
                                     args["check_prompt"] + 1 + new32)
    del logits, want, caches
    batch = {"tokens": C._tpf_tokens(cfg32, 1, args["train_seq"] + 1, 3),
             **images(cfg32, 1)}
    r["steps"] = {}
    for seq in seqs:
        tctx = make_context(mesh, remat="full", q_chunk=256, k_chunk=256,
                            seq_shard_residual=seq)
        split = TP.layout(cfg32, tctx)
        # the training step's own gradient (make_train_step's): reduced
        # over the axis, then the optimizer's global norm of the blocks
        grads_fn = make_grads_fn(cfg32, tctx)
        torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launches()
        t0 = time.perf_counter()
        met, grads = grads_fn(p32, batch)
        torch.cuda.synchronize()
        s = r["steps"][str(seq)] = {"s": time.perf_counter() - t0,
                                    "launches": dict(ops.LAUNCHES),
                                    "loss": met["loss"].item()}
        s["norm"] = global_norm(grads, tctx, split).item()
        # this rank's block of every leaf against the same block of the
        # world of one's gradient, over that leaf's largest |element|
        worst, leaf, finite = -1.0, "", True
        for n, g in tree.flatten_with_names(grads).items():
            w = ref["grads"][n].to(dev)
            finite = finite and bool(torch.isfinite(g).all())
            rel = (g - w).abs().max().item() / max(ref["scale"][n], 1e-30)
            if rel > worst and ref["scale"][n] > 0:
                worst, leaf = rel, n
        s.update(grad_worst=worst, grad_leaf=leaf, grads_finite=finite,
                 grad_leaves=len(ref["grads"]))
        del grads, w
        release()
    r["want_loss"], r["want_norm"] = ref["loss"], ref["norm"]
    del p32, ref, batch
    release()
    if step16:
        # one bf16 AdamW step through make_train_step at the float32 cut's
        # depth, under the last context above: this rank's block of the
        # state, its launches, loss and the global norm
        cfg16 = dataclasses.replace(get_config(arch), **cut32)
        opt_cfg = OptimizerConfig(warmup_steps=10)
        state = build(cfg16, opt_cfg)
        shapes = tree.flatten_with_names(make_train_state_shapes(
            cfg16, opt_cfg))
        held = [n for n in shapes if n.split("/")[0] in ("params", "opt")]
        cut = TP.cuts_of(held, TP.layout(cfg16, tctx))
        r["state_bytes"] = {
            "rank": nbytes([state["params"], state["opt"]]),
            "whole": nbytes([shapes[n] for n in held]),
            "layout": sum(nbytes(shapes[n]) // (
                world if n in cut and cut[n].model is not None else 1)
                for n in held)}
        step = make_train_step(cfg16, tctx, opt_cfg)
        batch = {"tokens": C._tpf_tokens(cfg16, 1, args["train_seq"] + 1, 3),
                 **images(cfg16, 1)}
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launches()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        r["step16"] = {"s": time.perf_counter() - t0,
                       "launches": dict(ops.LAUNCHES),
                       "peak": torch.cuda.max_memory_allocated(),
                       "loss": met["loss"].item(),
                       "norm": met["grad_norm"].item(),
                       "steps": int(state["step"]),
                       "finite": all(bool(torch.isfinite(t).all())
                                     for t in tree.leaves(state["params"])),
                       "bytes_after": nbytes([state["params"],
                                              state["opt"]])}
        del state, batch, step
        release()
    r["run_s"] = time.perf_counter() - t_run

# (d): the layouts the port once refused, and the decode caches cut
res["d"] = {}
t_d = time.perf_counter()
whole = {}
for tag, arch, cut, fields, what in args["d_runs"]:
    r = res["d"][tag] = {}
    t_run = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **cut)
    dctx = make_context(mesh, remat="full", q_chunk=256, k_chunk=256,
                        **fields)
    if arch not in whole:
        whole.clear()
        release()
        # every rank holds the whole model (no_tp's layout) and cuts it
        # for each context
        whole[arch] = build(cfg, kctx=make_context(mesh, no_tp=True))
    params = convert.local_tp_params(whole[arch], cfg, dctx)
    ref = reference(tag)
    if what == "grads":
        b, s = args["d_batch"][tag]
        batch = train_step.data_shard(
            {"tokens": C._tpf_tokens(cfg, b, s + 1, 5)}, dctx)
        split = TP.layout(cfg, dctx)
        grads_fn = make_grads_fn(cfg, dctx)
        torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launches()
        t0 = time.perf_counter()
        met, grads = grads_fn(params, batch)
        torch.cuda.synchronize()
        r.update(s=time.perf_counter() - t0, launches=dict(ops.LAUNCHES),
                 loss=met["loss"].item(), aux=met["aux"].item(),
                 norm=global_norm(grads, dctx, split).item(),
                 rows=list(batch["tokens"].shape), want_loss=ref["loss"],
                 want_aux=ref["aux"], want_norm=ref["norm"])
        worst, leaf, finite = -1.0, "", True
        for n, g in tree.flatten_with_names(grads).items():
            idx, vals, scale = ref["samples"][n]
            finite = finite and bool(torch.isfinite(g).all())
            got = g.reshape(-1)[idx.to(dev)].cpu()
            rel = (got - vals).abs().max().item() / max(scale, 1e-30)
            if rel > worst and scale > 0:
                worst, leaf = rel, n
        r.update(grad_worst=worst, grad_leaf=leaf, grads_finite=finite,
                 grad_leaves=len(ref["samples"]))
        del grads, batch
    else:
        prompt = C._tpf_tokens(cfg, 1, args["d_prompt"], 4)
        dist.barrier()
        ops.reset_launches()
        t0 = time.perf_counter()
        caches, logits = model.prefill(params, prompt, cfg, dctx,
                                       cache_len=args["d_prompt"]
                                       + args["d_new"])
        r.update(decode_check(cfg, dctx, params, caches, logits,
                              args["d_prompt"], args["d_new"],
                              ref["decode"],
                              args["d_prompt"] + args["d_new"]))
        r.update(s=time.perf_counter() - t0, launches=dict(ops.LAUNCHES))
        del caches, logits
    del params, ref
    release()
    r["run_s"] = time.perf_counter() - t_run
whole.clear()
release()
res["d_s"] = time.perf_counter() - t_d
with open(out, "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def _tpf_tokens(cfg, b, s, seed):
    """Seeded token ids ``[b, s]`` on the card (phase 24's ranks and its
    world of one draw the same)."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                         device=DEV)


def _tpf_image(cfg, b):
    """Stub patch embeddings ``[b, num_image_tokens, d_model]``, 0.1 x
    normal from seed 2 (``_image_embeds``'), in the model dtype."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(2)
    return (0.1 * torch.randn(b, cfg.num_image_tokens, cfg.d_model,
                              generator=g, device=DEV)).to(
        getattr(torch, cfg.dtype))


def _tpf_reference(arch, cut32, new=0):
    """A float32 world of one at the cut, in this process: the prefill's
    logits at ``TPF_BATCH x TPF_CHECK_PROMPT`` (with ``new``, those of
    ``new`` greedy decode steps after it too, ``[new + 1, B, Vp]``), one
    step's loss, global norm and each gradient leaf's largest |element|,
    and every rank's block of every gradient leaf (``tensor_parallel``'s
    layout over ``TPF_RANKS``), all on the host."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import loss_and_grads
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **cut32)
    params = model.init(torch.Generator(device=DEV).manual_seed(0), cfg)
    if cfg.family == "vlm":
        _open_gates(params, cfg, 1)
    img = ({"image_embeds": _tpf_image(cfg, TPF_BATCH)}
           if cfg.family == "vlm" else {})
    caches, logits = model.prefill(
        params, _tpf_tokens(cfg, TPF_BATCH, TPF_CHECK_PROMPT, 1), cfg,
        ModelContext(), cache_len=TPF_CHECK_PROMPT + 1 + new, **img)
    decode = _greedy_logits(params, caches, logits, cfg, ModelContext(),
                            TPF_CHECK_PROMPT, new) if new else None
    del caches
    batch = {"tokens": _tpf_tokens(cfg, 1, TPF_TRAIN_SEQ + 1, 3)}
    if img:
        batch["image_embeds"] = _tpf_image(cfg, 1)
    (loss, _), grads = loss_and_grads(
        params, batch, cfg, ModelContext(remat="full", q_chunk=256,
                                         k_chunk=256))
    del params, img, batch
    cuts = TP._layout(cfg, TPF_RANKS, 1, True)
    norm = global_norm(grads).item()
    out = [{"logits": logits.cpu(), "loss": loss.item(), "norm": norm,
            "scale": {}, "grads": {}, "decode": decode}
           for _ in range(TPF_RANKS)]
    flat = tree.flatten_with_names(grads)
    del grads
    for n in list(flat):
        g = flat.pop(n)
        scale = g.abs().max().item()
        for m, o in enumerate(out):
            o["scale"][n] = scale
            o["grads"][n] = (TP.local_block(g, cuts[n], (m, TPF_RANKS),
                                            (0, 1)) if n in cuts
                             else g).cpu()
        del g
    del logits
    return out


def _greedy_logits(params, caches, logits, cfg, ctx, S, n):
    """The prefill's last logits and those of ``n`` greedy decode steps
    after it, ``[n + 1, B, Vp]`` on the host."""
    import torch
    from repro_torch.models import model
    out = [logits.cpu()]
    for i in range(n):
        caches, logits = model.decode_step(
            params, caches, logits.argmax(-1)[:, None], S + i, cfg, ctx)
        out.append(logits.cpu())
    return torch.stack(out)


def _tpf_d_references():
    """(d)'s float32 worlds of one, in this process, each rank's: for a
    gradient run, its loss and global norm and, for each leaf of the
    rank's layout (``TPF_D_RUNS``' context over ``TPF_RANKS``), its
    block's values at ``TPF_D_SAMPLES`` seeded elements with the whole
    leaf's largest |element|; for (d3), the prefill's and
    ``TPF_D_NEW`` greedy steps' logits. All on the host."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import loss_and_grads
    refs, made = {}, {}
    tctx = ModelContext(remat="full", q_chunk=256, k_chunk=256)
    for tag, arch, cut, fields, what in TPF_D_RUNS:
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **cut)
        if arch not in made:
            made.clear()
            _release()
            made[arch] = model.init(torch.Generator(device=DEV).manual_seed(
                0), cfg)
        params = made[arch]
        if what != "grads":
            caches, logits = model.prefill(
                params, _tpf_tokens(cfg, 1, TPF_D_PROMPT, 4), cfg,
                ModelContext(), cache_len=TPF_D_PROMPT + TPF_D_NEW)
            want = _greedy_logits(params, caches, logits, cfg,
                                  ModelContext(), TPF_D_PROMPT, TPF_D_NEW)
            del caches, logits
            refs[tag] = [{"decode": want} for _ in range(TPF_RANKS)]
            continue
        b, s = TPF_D_BATCH[tag]
        (loss, met), grads = loss_and_grads(
            params, {"tokens": _tpf_tokens(cfg, b, s + 1, 5)}, cfg, tctx)
        M = 1 if fields.get("no_tp") else TPF_RANKS
        ep = fields.get("moe_impl", "ep") == "ep" and M > 1
        cuts = TP._layout(cfg, M, 1, ep) if M > 1 else {}
        out = [{"loss": loss.item(), "aux": met["aux"].item(),
                "norm": global_norm(grads).item(), "samples": {}}
               for _ in range(TPF_RANKS)]
        for i, (n, g) in enumerate(tree.flatten_with_names(grads).items()):
            scale = g.abs().max().item()
            for m, o in enumerate(out):
                block = (TP.local_block(g, cuts[n], (m, M), (0, 1))
                         if n in cuts else g).reshape(-1)
                idx = torch.randint(
                    0, block.numel(), (min(TPF_D_SAMPLES, block.numel()),),
                    generator=torch.Generator().manual_seed(i))
                o["samples"][n] = (idx, block[idx.to(block.device)].cpu(),
                                   scale)
        del grads
        refs[tag] = out
    made.clear()
    return refs


def _tpf_write(tmp, refs, errors):
    """Each run's references, one file a rank (``{tag}_rank{m}.pt``), in
    run order; each file appears whole (written, then renamed)."""
    import torch
    try:
        for tag in [run[0] for run in TPF_RUNS + TPF_D_RUNS]:
            for m, ref in enumerate(refs.pop(tag)):
                path = os.path.join(tmp, f"{tag}_rank{m}.pt")
                torch.save(ref, path + ".part")
                os.replace(path + ".part", path)
    except Exception as e:  # noqa: BLE001 - the phase reports it
        errors.append(f"{type(e).__name__}: {e}")


def phase_tp_families():
    """Phase 24: ``deepseek-v3-671b`` (MLA, MTP, routed experts),
    ``llama-3.2-vision-90b`` (cross-attention) and ``zamba2-2.7b``
    (Mamba2, shared attention) tensor-parallel over a model axis of two
    ranks sharing the card (spawned processes, gloo), each built a layer
    at a time from one seed; their float32 cuts against a world of one
    computed first in this process. Returns the flash kernels' launches
    of the ranks' main paths."""
    import tempfile
    import threading
    import torch
    print(f"== phase 24: MLA and MTP, cross-attention and Mamba2 "
          f"tensor-parallel over a model axis of {TPF_RANKS} ranks sharing "
          f"the card (gloo)")
    t_phase = time.perf_counter()
    card = smi_line()
    held_report("phase 24")
    args = {"batch": TPF_BATCH, "prompt": TPF_PROMPT, "new": TPF_NEW,
            "check_prompt": TPF_CHECK_PROMPT, "train_seq": TPF_TRAIN_SEQ,
            "runs": TPF_RUNS, "wait_s": TPF_RANK_TIMEOUT_S,
            "decode_runs": TPF_DECODE_RUNS, "check_new": TPF_CHECK_NEW,
            "d_runs": TPF_D_RUNS, "d_batch": TPF_D_BATCH,
            "d_prompt": TPF_D_PROMPT, "d_new": TPF_D_NEW}
    with tempfile.TemporaryDirectory() as tmp:
        # the ranks start now and wait for "go": their imports overlap the
        # worlds of one, which hold the card until then
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(TPF_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", TPF_RANK, str(r), str(TPF_RANKS),
             os.path.join(tmp, "store"), outs[r], tmp, json.dumps(args)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join((SRC, ROOT))),
            cwd=ROOT) for r in range(TPF_RANKS)]
        errors, writer = [], None
        try:
            refs = {}
            for tag, arch, _, cut32, _, _ in TPF_RUNS:
                t0 = time.perf_counter()
                torch.cuda.reset_peak_memory_stats()
                refs[tag] = _tpf_reference(
                    arch, cut32,
                    TPF_CHECK_NEW if tag in TPF_DECODE_RUNS else 0)
                peak = torch.cuda.max_memory_allocated()
                _release()
                n = sum(t.numel() for t in refs[tag][0]["grads"].values())
                print(f"({tag}) {arch} float32 world of one at {cut32}: "
                      f"loss {refs[tag][0]['loss']}, "
                      f"{len(refs[tag][0]['grads'])} gradient leaves, {n} "
                      f"elements rank 0's blocks; "
                      f"{time.perf_counter() - t0} s, peak device memory "
                      f"{peak} bytes ({card})")
            t0 = time.perf_counter()
            refs.update(_tpf_d_references())
            _release()
            print(f"(d) float32 worlds of one: {time.perf_counter() - t0} "
                  f"s ({card})")
            print(f"references: {shutil.disk_usage(tmp).free} bytes free "
                  f"under {tmp}")
            held_report("phase 24's ranks")
            open(os.path.join(tmp, "go"), "w").close()
            # the references are written while the ranks serve in bf16
            # repro: ignore[torch-thread-no-device] -- host tensors only
            writer = threading.Thread(target=_tpf_write,
                                      args=(tmp, refs, errors))
            writer.start()
            logs = [p.communicate(timeout=TPF_RANK_TIMEOUT_S)[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            if writer is not None:
                writer.join()
        check(not errors, f"writing the references: {errors}")
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"rank {r} exited {p.returncode}: "
                  f"{log.strip().splitlines()[-8:]}")
        res = []
        for path in outs:
            with open(path) as f:
                res.append(json.load(f))
    print(f"process group: {res[0]['backend']}, {TPF_RANKS} ranks on "
          f"{torch.cuda.get_device_name(0)}; model-axis ranks "
          f"{[r['model_rank'] for r in res]}")
    check(all(r["backend"] == "gloo" for r in res) and
          [r["model_rank"] for r in res] == list(range(TPF_RANKS)),
          f"backends {[r['backend'] for r in res]}")
    launches = {"flash_attention": 0, "flash_attention_wgmma": 0}
    for tag, arch, cut16, cut32, seqs, _ in TPF_RUNS:
        _tpf_report(tag, arch, cut16, cut32, seqs, [r["runs"][tag]
                                                    for r in res],
                    launches, card)
    _tpf_d_report(res, launches, card)
    dt = time.perf_counter() - t_phase
    print(f"phase 24: {dt} s (limit {PHASE24_LIMIT_S} s); launches "
          f"{launches} ({card})")
    check(dt <= PHASE24_LIMIT_S, f"phase 24 took {dt} s")
    return launches


def _tpf_decode_report(label, runs, card):
    """A decode check of phase 24 (``decode_check`` in ``TPF_RANK``): the
    logits at every step within ``LM_F32_REL_TOL`` of the world of
    one's, the greedy ids its own and the ranks', each rank's cache
    bytes the layout's count, below a world of one's."""
    for m, d in enumerate(runs):
        c = d["cache"]
        print(f"{label} rank {m}: logits / max |logit| against a world of "
              f"one at each step {d['rel']} (limit {LM_F32_REL_TOL}); ids "
              f"{[i[0] for i in d['ids']]}; cache bytes {c['rank']}, the "
              f"layout's count {c['layout']}, a world of one's "
              f"{c['whole']} ({card})")
        check(d["finite"] and max(d["rel"]) < LM_F32_REL_TOL,
              f"{label} rank {m}'s decode logits differ: {d['rel']}")
        check(d["ids_equal"], f"{label} rank {m}'s greedy ids differ")
        check(c["rank"] == c["layout"] < c["whole"],
              f"{label} rank {m} holds {c} cache bytes")
    check(all(d["ids"] == runs[0]["ids"] for d in runs),
          f"{label} the ranks decoded different ids")


def _tpf_d_report(res, launches, card):
    """Phase 24 (d): each item's ranks, printed and checked; adds their
    launches to ``launches``."""
    for tag, arch, cut, fields, what in TPF_D_RUNS:
        runs = [r["d"][tag] for r in res]
        label = f"(d) {tag} {arch} at {cut}, {fields}:"
        for m, r in enumerate(runs):
            got = {k: v for k, v in r["launches"].items() if v}
            print(f"{label} rank {m}: {r['s']} s, {r['run_s']} s with its "
                  f"build; launches {got} (want {TPF_D_LAUNCHES[tag]})")
            check(got == TPF_D_LAUNCHES[tag],
                  f"{label} rank {m} launched {got}")
            for k, v in got.items():
                launches[k] += v
        if what == "decode":
            _tpf_decode_report(label, runs, card)
            continue
        for m, r in enumerate(runs):
            rel = abs(r["loss"] - r["want_loss"]) / abs(r["want_loss"])
            norm = abs(r["norm"] - r["want_norm"]) / r["want_norm"]
            print(f"{label} rank {m}: rows {r['rows']}; loss {r['loss']} vs "
                  f"{r['want_loss']} (relative {rel}, limit {LM_LOSS_RTOL}); "
                  f"aux {r['aux']} vs {r['want_aux']}; global norm "
                  f"{r['norm']} vs {r['want_norm']} (relative {norm}, limit "
                  f"{TPF_NORM_RTOL}); worst gradient block {r['grad_leaf']} "
                  f"{r['grad_worst']} of its leaf's max |g| at "
                  f"{TPF_D_SAMPLES} elements a leaf (limit {LM_GRAD_TOL}) "
                  f"over {r['grad_leaves']} leaves ({card})")
            check(rel <= LM_LOSS_RTOL and norm <= TPF_NORM_RTOL,
                  f"{label} rank {m}: loss {rel}, norm {norm}")
            check(r["grads_finite"] and 0 <= r["grad_worst"] <= LM_GRAD_TOL,
                  f"{label} rank {m}'s gradient {r['grad_leaf']} differs by "
                  f"{r['grad_worst']}")
    print(f"(d): {[r['d_s'] for r in res]} s a rank ({card})")


def _tpf_report(tag, arch, cut16, cut32, seqs, runs, launches, card):
    """Phase 24: one run's ranks, printed and checked; adds their
    launches to ``launches``."""
    want16, want32, want_step, want_bf16_step = TPF_LAUNCHES[tag]
    r0 = runs[0]
    for m, r in enumerate(runs):
        for key, cut in (("bytes", cut16), ("bytes32", cut32)):
            b = r[key]
            print(f"({tag}) {arch} at {cut or 'full depth'}"
                  f"{' float32' if key == 'bytes32' else ''}, rank {m}: "
                  f"parameters {b['rank']} bytes, the layout's count "
                  f"{b['layout']}, the whole model's {b['whole']}")
            check(b["rank"] == b["layout"] and b["rank"] < b["whole"],
                  f"({tag}) rank {m} holds {b} bytes")
        print(f"({tag}) rank {m}: {r['run_s']} s in all, bf16 "
              f"{r['bf16_s']} s, waited {r['wait_s']} s for the "
              f"references; built in {r['build_s']} s; prefill "
              f"{TPF_BATCH} x {TPF_PROMPT} in {r['prefill_s']} s, decode "
              f"{TPF_NEW} steps in {r['decode_s']} s "
              f"({r['decode_s'] / TPF_NEW * 1e3} ms a step): figures of one "
              f"card shared by {TPF_RANKS} processes over gloo, not of "
              f"tensor parallelism; peak device memory {r['peak']} bytes; "
              f"launches {r['launches']} (want {want16}); first ids "
              f"{r['ids'][0][:8]} ({card})")
        for got, want, what in ((r["launches"], want16, "bf16 generate"),
                                (r["launches32"], want32,
                                 "float32 prefill")):
            got = {k: v for k, v in got.items() if v}
            check(got == want,
                  f"({tag}) rank {m}'s {what} launched {got}, want {want}")
            for k, v in got.items():
                launches[k] += v
    check(all(r["ids"] == r0["ids"] for r in runs),
          f"({tag}) the ranks generated different ids")
    print(f"({tag}) float32 at {cut32}: logits / max |logit| against a "
          f"world of one {[r['logits_rel'] for r in runs]} (limit "
          f"{LM_F32_REL_TOL}) ({card})")
    check(all(r["logits_finite"] and r["logits_rel"] < LM_F32_REL_TOL
              for r in runs), f"({tag}) float32 logits differ")
    if tag in TPF_DECODE_RUNS:
        _tpf_decode_report(f"(d4) ({tag}) {arch} float32 at {cut32}, "
                           f"{TPF_CHECK_NEW} decode steps:",
                           [r["decode32"] for r in runs], card)
    for seq in seqs:
        steps = [r["steps"][str(seq)] for r in runs]
        rel = [abs(s["loss"] - r0["want_loss"]) / abs(r0["want_loss"])
               for s in steps]
        norm = [abs(s["norm"] - r0["want_norm"]) / r0["want_norm"]
                for s in steps]
        print(f"({tag}) float32 step's gradient at {cut32}, 1 x "
              f"{TPF_TRAIN_SEQ}{', seq_shard_residual' if seq else ''}: "
              f"loss {[s['loss'] for s in steps]} vs {r0['want_loss']} "
              f"(relative {rel}, limit {LM_LOSS_RTOL}); global norm "
              f"{[s['norm'] for s in steps]} vs {r0['want_norm']} "
              f"(relative {norm}, limit {TPF_NORM_RTOL}); worst gradient "
              f"block a rank {[(s['grad_leaf'], s['grad_worst']) for s in steps]}"
              f" of its leaf's max |g| (limit {LM_GRAD_TOL}) over "
              f"{steps[0]['grad_leaves']} leaves; {[s['s'] for s in steps]} "
              f"s a rank; launches {[s['launches'] for s in steps]} (want "
              f"{want_step}) ({card})")
        for m, s in enumerate(steps):
            check(rel[m] <= LM_LOSS_RTOL,
                  f"({tag}) rank {m}'s loss differs by {rel[m]}")
            check(norm[m] <= TPF_NORM_RTOL,
                  f"({tag}) rank {m}'s global norm differs by {norm[m]}")
            check(s["grads_finite"] and s["grad_worst"] <= LM_GRAD_TOL,
                  f"({tag}) rank {m}'s gradient {s['grad_leaf']} differs "
                  f"by {s['grad_worst']}")
            got = {k: v for k, v in s["launches"].items() if v}
            check(got == want_step,
                  f"({tag}) rank {m}'s step launched {got}, want "
                  f"{want_step}")
            for k, v in got.items():
                launches[k] += v
    if want_bf16_step is None:
        return
    steps = [r["step16"] for r in runs]
    for m, (r, s) in enumerate(zip(runs, steps)):
        b = r["state_bytes"]
        got = {k: v for k, v in s["launches"].items() if v}
        print(f"({tag}) bf16 make_train_step at {cut32}, 1 x "
              f"{TPF_TRAIN_SEQ}{', seq_shard_residual' if seqs[-1] else ''}"
              f", rank {m}: state (parameters + moments) {b['rank']} bytes, "
              f"the layout's count {b['layout']}, a world of one's "
              f"{b['whole']}; after the step {s['bytes_after']}; loss "
              f"{s['loss']} (float32 world of one {r0['want_loss']}, "
              f"limit {TPF_BF16_RTOL} relative), "
              f"grad_norm {s['norm']} (float32 {r0['want_norm']}); "
              f"{s['s']} s, peak device memory {s['peak']} bytes; launches "
              f"{got} (want {want_bf16_step}) ({card})")
        check(b["rank"] == b["layout"] == s["bytes_after"] and
              b["rank"] < b["whole"],
              f"({tag}) rank {m} holds {b} bytes of state, "
              f"{s['bytes_after']} after the step")
        check(s["steps"] == 1 and s["finite"] and
              math.isfinite(s["loss"]) and math.isfinite(s["norm"]),
              f"({tag}) rank {m}'s bf16 step: {s['steps']} steps, loss "
              f"{s['loss']}, norm {s['norm']}, finite {s['finite']}")
        rel = abs(s["loss"] - r0["want_loss"]) / abs(r0["want_loss"])
        check(rel <= TPF_BF16_RTOL,
              f"({tag}) rank {m}'s bf16 step loss {s['loss']} is {rel} "
              f"from the float32 world of one's (limit {TPF_BF16_RTOL})")
        check(got == want_bf16_step,
              f"({tag}) rank {m}'s bf16 step launched {got}, want "
              f"{want_bf16_step}")
        for k, v in got.items():
            launches[k] += v
    check(all(s["loss"] == steps[0]["loss"] and
              s["norm"] == steps[0]["norm"] for s in steps),
          f"({tag}) the ranks' bf16 step metrics differ")


# ---------------------------------------------------------------- phase 25
CP_ARCH = "qwen2-7b"            # full width, depth cut to CP_LAYERS
CP_LAYERS = 2
#: the model axis: 4 KV heads do not divide over 8 (the smallest axis on
#: which a full config's GQA block runs context-parallel); all 8 ranks
#: share the card
CP_RANKS = 8
#: bf16 serving: CP_BATCH x CP_PROMPT at q chunks of CP_CHUNK (8 chunks:
#: one a rank), then CP_NEW greedy decode steps on a cache of
#: CP_CACHE_LEN rows (257 a rank)
CP_BATCH, CP_PROMPT, CP_NEW, CP_CHUNK = 2, 2048, 4, 256
CP_CACHE_LEN = CP_PROMPT + 8
#: float32 against a world of one: logits at CP_BATCH x CP_CHECK_PROMPT
#: (q chunks of CP_CHECK_CHUNK: one a rank) and CP_CHECK_NEW greedy
#: steps on a cache of CP_CHECK_PROMPT + 8 rows, then one step's
#: gradient at 1 x CP_TRAIN_SEQ
CP_CHECK_PROMPT, CP_CHECK_CHUNK, CP_CHECK_NEW = 512, 64, 4
CP_TRAIN_SEQ = 512
#: the float32 bounds: logits over max |logit| at every step, each
#: gradient block's sampled elements over its leaf's max |g|, the global
#: norm and the loss relative
CP_LOGITS_TOL = CP_GRAD_TOL = CP_NORM_RTOL = 1e-5
CP_SAMPLES = 4096               # sampled elements of each gradient block
CP_RANK_TIMEOUT_S = 240
PHASE25_LIMIT_S = 180

CP_RANK = """\
import dataclasses, gc, json, os, sys, time
import torch, torch.distributed as dist
rank, world, store, out, tmp, args = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5],
                                      json.loads(sys.argv[6]))
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
import chip_smoke as C
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.device import set_device
from repro_torch.distributed import collectives
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import make_context
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert, model
from repro_torch.models.layers import ShapesOnly
from repro_torch.serve import engine
from repro_torch.train.optimizer import global_norm
from repro_torch.train.train_step import make_grads_fn
set_device("cuda")
dev = torch.device("cuda", 0)
mesh = make_host_mesh(1, world, backend="gloo")
res = {"rank": rank, "backend": dist.get_backend(),
       "model_rank": mesh.get_local_rank("model")}
B, S, new, L = args["batch"], args["prompt"], args["new"], args["layers"]
t_rank = time.perf_counter()


def nbytes(t):
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


def release():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def build(cfg, ctx):
    # this rank's block, made from one seed a leaf or a layer at a time
    # through the converter's cut (convert.local_tp_keep)
    return model.init(torch.Generator(device=dev).manual_seed(0), cfg,
                      keep=convert.local_tp_keep(cfg, ctx))


def sizes(cfg, ctx, params):
    # this rank's bytes, the layout's count of them, the whole model's,
    # and whether every GQA attention leaf is among the cut ones
    cuts = TP.layout(cfg, ctx)
    whole = tree.flatten_with_names(model.init(ShapesOnly(), cfg))
    attn = [n for n in whole if "/attn/" in n and n.rsplit("/", 1)[1] in
            ("wq", "wk", "wv", "wo", "bq", "bk", "bv")]
    return {"rank": nbytes(params), "whole": nbytes(list(whole.values())),
            "layout": sum(t.numel() * t.element_size() // (
                world if n in cuts and cuts[n].model is not None else 1)
                for n, t in whole.items()),
            "attn_leaves": len(attn),
            "attn_cut": all(n in cuts and cuts[n].model is not None
                            for n in attn)}


def cache_sizes(cfg, caches, b, rows):
    kinds = sorted({type(c).__name__ for c in caches})
    whole = L * 2 * b * rows * cfg.num_kv_heads * cfg.head_dim * \\
        torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    return {"rank": nbytes(caches), "whole": whole,
            "layout": whole // world, "kinds": kinds}


# (a) bf16 serving at full width
cfg = dataclasses.replace(get_config(args["arch"]), num_layers=L)
ctx = make_context(mesh, q_chunk=args["chunk"], k_chunk=args["chunk"])
plan = TP.plan(cfg, ctx)
res["plan"] = {"attn": plan.attn, "cp": plan.cp}
params = build(cfg, ctx)
res["bytes"] = sizes(cfg, ctx, params)
prompt = C._tpf_tokens(cfg, B, S, 1)
# first calls load cuBLAS and the gloo paths: not measured
engine.generate(params, prompt, cfg, ctx, max_new_tokens=2,
                cache_len=args["cache_len"])
release()
torch.cuda.reset_peak_memory_stats()
dist.barrier()
ops.reset_launches()
timings = {}
ids = engine.generate(params, prompt, cfg, ctx, max_new_tokens=new + 1,
                      cache_len=args["cache_len"], timings=timings)
torch.cuda.synchronize()
res["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
res["peak"] = torch.cuda.max_memory_allocated()
res["prefill_s"], res["decode_s"] = timings["prefill_s"], timings["decode_s"]
res["ids"] = ids.tolist()
# one prefill at cache_len S (the dry-run's prefill cell): its
# collectives through the seam and this rank's caches
dist.barrier()
ops.reset_launches()
with collectives.recording() as tally:
    caches, _ = model.prefill(params, prompt, cfg, ctx, cache_len=S)
torch.cuda.synchronize()
res["prefill_launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
res["collectives"] = {f"{kind} {ways} {what}": n
                      for (kind, ways), rec in tally.calls.items()
                      for what, n in zip(("count", "operand_bytes"), rec)}
res["cache"] = cache_sizes(cfg, caches, B, S)
del params, caches, ids
release()
res["bf16_s"] = time.perf_counter() - t_rank

# (b) float32 at the cut against the world of one's (the phase's process
# computes it while the ranks serve)
cfg32 = dataclasses.replace(cfg, dtype="float32")
cctx = make_context(mesh, q_chunk=args["check_chunk"],
                    k_chunk=args["check_chunk"])
p32 = build(cfg32, cctx)
res["bytes32"] = sizes(cfg32, cctx, p32)
path = os.path.join(tmp, f"rank{rank}.pt")
t0 = time.perf_counter()
deadline = time.monotonic() + args["wait_s"]
while not os.path.exists(path):
    if time.monotonic() > deadline:
        raise TimeoutError(f"nothing at {path}")
    time.sleep(0.1)
res["wait_s"] = time.perf_counter() - t0
ref = torch.load(path, mmap=True)
P = args["check_prompt"]
dist.barrier()
ops.reset_launches()
caches, logits = model.prefill(p32, C._tpf_tokens(cfg32, B, P, 1), cfg32,
                               cctx, cache_len=P + 8)
rel, same, finite, steps = [], True, True, []
for i in range(args["check_new"] + 1):
    w = ref["decode"][i].to(dev)
    rel.append(((logits - w).abs().max() / w.abs().max()).item())
    finite = finite and bool(torch.isfinite(logits).all())
    got = logits.argmax(-1)
    same = same and bool((got == w.argmax(-1)).all())
    steps.append(got.tolist())
    if i < args["check_new"]:
        caches, logits = model.decode_step(p32, caches, got[:, None], P + i,
                                           cfg32, cctx)
torch.cuda.synchronize()
res["check"] = {"rel": rel, "ids_equal": same, "finite": finite,
                "ids": steps,
                "launches": {k: v for k, v in ops.LAUNCHES.items() if v},
                "cache": cache_sizes(cfg32, caches, B, P + 8)}
del caches, logits, w
# (c) one float32 step's gradient (make_train_step's, reduced) at 1 x
# CP_TRAIN_SEQ, q chunks of the check's size: one a rank
tctx = make_context(mesh, remat="full", q_chunk=args["check_chunk"],
                    k_chunk=args["check_chunk"])
batch = {"tokens": C._tpf_tokens(cfg32, 1, args["train_seq"] + 1, 3)}
torch.cuda.synchronize()
dist.barrier()
ops.reset_launches()
t0 = time.perf_counter()
met, grads = make_grads_fn(cfg32, tctx)(p32, batch)
torch.cuda.synchronize()
g = {"s": time.perf_counter() - t0,
     "launches": {k: v for k, v in ops.LAUNCHES.items() if v},
     "loss": met["loss"].item(),
     "norm": global_norm(grads, tctx, TP.layout(cfg32, tctx)).item()}
worst, leaf, finite = -1.0, "", True
for n, t in tree.flatten_with_names(grads).items():
    idx, vals, scale = ref["samples"][n]
    finite = finite and bool(torch.isfinite(t).all())
    got = t.reshape(-1)[idx.to(dev)].cpu()
    r = (got - vals).abs().max().item() / max(scale, 1e-30)
    if r > worst and scale > 0:
        worst, leaf = r, n
g.update(worst=worst, leaf=leaf, finite=finite, leaves=len(ref["samples"]))
res["grads"] = g
del grads, p32, ref
release()
res["rank_s"] = time.perf_counter() - t_rank
with open(out, "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def _cp_reference():
    """Phase 25's float32 world of one at the cut, in this process: the
    prefill's logits at ``CP_BATCH x CP_CHECK_PROMPT`` and those of
    ``CP_CHECK_NEW`` greedy steps after it, one step's loss and global
    norm, and for each rank of ``CP_RANKS`` its block of every gradient
    leaf (``tensor_parallel``'s layout) at ``CP_SAMPLES`` seeded elements
    with the whole leaf's largest |element|; all on the host. Also the
    world of one's flash launches."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.models.layers import ModelContext
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import loss_and_grads
    cfg = dataclasses.replace(get_config(CP_ARCH), num_layers=CP_LAYERS,
                              dtype="float32")
    params = model.init(torch.Generator(device=DEV).manual_seed(0), cfg)
    one = ModelContext(q_chunk=CP_CHECK_CHUNK, k_chunk=CP_CHECK_CHUNK)
    ops.reset_launches()
    caches, logits = model.prefill(
        params, _tpf_tokens(cfg, CP_BATCH, CP_CHECK_PROMPT, 1), cfg, one,
        cache_len=CP_CHECK_PROMPT + 8)
    decode = _greedy_logits(params, caches, logits, cfg, one,
                            CP_CHECK_PROMPT, CP_CHECK_NEW)
    del caches, logits
    (loss, _), grads = loss_and_grads(
        params, {"tokens": _tpf_tokens(cfg, 1, CP_TRAIN_SEQ + 1, 3)}, cfg,
        ModelContext(remat="full", q_chunk=CP_CHECK_CHUNK,
                     k_chunk=CP_CHECK_CHUNK))
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    del params
    cuts = TP._layout(cfg, CP_RANKS, 1, True)
    out = [{"decode": decode, "loss": loss.item(),
            "norm": global_norm(grads).item(), "samples": {}}
           for _ in range(CP_RANKS)]
    for i, (n, g) in enumerate(tree.flatten_with_names(grads).items()):
        scale = g.abs().max().item()
        for m, o in enumerate(out):
            block = (TP.local_block(g, cuts[n], (m, CP_RANKS), (0, 1))
                     if n in cuts else g).reshape(-1)
            idx = torch.randint(
                0, block.numel(), (min(CP_SAMPLES, block.numel()),),
                generator=torch.Generator().manual_seed(i))
            o["samples"][n] = (idx, block[idx.to(block.device)].cpu(), scale)
    del grads
    return out, launches


def _cp_counts():
    """Phase 25's prefill cell counted by the dry-run at the first and
    last rank's coordinates of the 1 x ``CP_RANKS`` mesh
    (``launch.mesh.RankMesh``): the ranks' cut, rows and context."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import make_context
    from repro_torch.launch import dryrun_lib
    from repro_torch.launch.mesh import RankMesh
    cfg = dataclasses.replace(get_config(CP_ARCH), num_layers=CP_LAYERS)
    shape = ShapeConfig("phase25_prefill", "prefill", CP_PROMPT, CP_BATCH)
    out = {}
    for m in (0, CP_RANKS - 1):
        ctx = make_context(RankMesh(("data", "model"), (1, CP_RANKS),
                                    (0, m), one_rank_groups=True),
                           q_chunk=CP_CHUNK, k_chunk=CP_CHUNK)
        t0 = time.perf_counter()
        c = dryrun_lib.count_cell(cfg, shape, ctx)
        out[m] = ({k[len("collective "):]: v for k, v in c.items()
                   if k.startswith("collective ")},
                  time.perf_counter() - t0)
    return out


def _cp_write(tmp, refs, errors):
    """Each rank's reference (``rank{m}.pt``), written, then renamed."""
    import torch
    try:
        for m, ref in enumerate(refs):
            path = os.path.join(tmp, f"rank{m}.pt")
            torch.save(ref, path + ".part")
            os.replace(path + ".part", path)
    except Exception as e:  # noqa: BLE001 - the phase reports it
        errors.append(f"{type(e).__name__}: {e}")


def _cp_rows_ms(card):
    """The chunked loop's time for one rank's rows of the bf16 prefill
    (``CP_BATCH x CP_PROMPT/CP_RANKS`` query rows of all 28 heads at
    ``q_offset = m · CP_PROMPT/CP_RANKS`` against all ``CP_PROMPT`` keys
    and values of 4 KV heads, q and k chunks of ``CP_CHUNK``: the call
    every context-parallel prefill makes), beside the flash kernel over
    the whole sequence (a world of one's call), ``scaled_dot_product_
    attention`` over the same rows with their causal mask, and the rows'
    bound (their q, k, v and output bytes over the HBM rate, or every
    block's QK^T and PV over the dense bf16 rate). Eager calls, CUDA
    events."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    cfg = get_config(CP_ARCH)
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n = CP_PROMPT // CP_RANKS
    g = torch.Generator(device=DEV).manual_seed(6)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=DEV,
                           dtype=torch.bfloat16)
    q, k, v = randn(CP_BATCH, CP_PROMPT, H, D), \
        randn(CP_BATCH, CP_PROMPT, KV, D), randn(CP_BATCH, CP_PROMPT, KV, D)
    out = {}
    for m in (0, CP_RANKS - 1):
        rows = q[:, m * n:(m + 1) * n].contiguous()
        out[f"loop_ms_rank{m}"] = cuda_ms(lambda: L.attention(
            rows, k, v, causal=True, q_offset=m * n, q_chunk=CP_CHUNK,
            k_chunk=CP_CHUNK), iters=10, graph=False)
        mask = (torch.arange(CP_PROMPT, device=DEV)[None, :]
                <= m * n + torch.arange(n, device=DEV)[:, None])
        qh = rows.transpose(1, 2)
        kh = k.repeat_interleave(H // KV, 2).transpose(1, 2)
        vh = v.repeat_interleave(H // KV, 2).transpose(1, 2)
        out[f"sdpa_ms_rank{m}"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                   attn_mask=mask),
            iters=10, graph=False)
        # the loop against SDPA on these rows
        got = L.attention(rows, k, v, causal=True, q_offset=m * n,
                          q_chunk=CP_CHUNK, k_chunk=CP_CHUNK).float()
        want = F.scaled_dot_product_attention(
            qh.float(), kh.float(), vh.float(),
            attn_mask=mask).transpose(1, 2)
        out[f"loop_vs_sdpa_rank{m}"] = (got - want).abs().max().item()
    ops.reset_launches()
    out["flash_whole_ms"] = cuda_ms(lambda: L.attention(
        q, k, v, causal=True, q_chunk=CP_CHUNK, k_chunk=CP_CHUNK), iters=10)
    out["flash_launches"] = ops.LAUNCHES["flash_attention_wgmma"]
    nbytes = 2 * (2 * CP_BATCH * n * H * D + 2 * CP_BATCH * CP_PROMPT * KV * D)
    flops = 4 * CP_BATCH * H * n * CP_PROMPT * D
    out["bound_ms"], out["bound_by"] = bound_ms(
        nbytes, flops, chip_spec().peak_bf16_flops)
    print(f"(d) the chunked loop over one rank's rows ({CP_BATCH} x {n} of "
          f"{H} heads of {D} at q_offset 0 and {(CP_RANKS - 1) * n}, against "
          f"{CP_PROMPT} keys of {KV} heads, chunks of {CP_CHUNK}; bf16 in, "
          f"float32 math): {out['loop_ms_rank0']} ms and "
          f"{out[f'loop_ms_rank{CP_RANKS - 1}']} ms eager; "
          f"scaled_dot_product_attention on the same rows with their causal "
          f"mask {out['sdpa_ms_rank0']} / "
          f"{out[f'sdpa_ms_rank{CP_RANKS - 1}']} ms (max abs difference "
          f"{out['loop_vs_sdpa_rank0']}, "
          f"{out[f'loop_vs_sdpa_rank{CP_RANKS - 1}']}); the rows' bound "
          f"{out['bound_ms']} ms ({out['bound_by']}); the flash kernel "
          f"over all {CP_PROMPT} rows (a world of one's call, "
          f"{out['flash_launches']} wgmma launches timed) "
          f"{out['flash_whole_ms']} ms ({card})")
    return out


def phase_cp():
    """Phase 25: ``qwen2-7b`` at full width, cut to ``CP_LAYERS`` layers,
    over a model axis of ``CP_RANKS`` ranks sharing the card (spawned
    processes, gloo), where its 4 KV heads do not divide: the reference's
    context-parallel attention (every attention leaf cut, the q rows
    split, the decode caches cut on the sequence). bf16 serving, then
    float32 logits, greedy steps and one step's gradient against a world
    of one computed in this process while the ranks serve; the ranks'
    recorded collectives against the dry-run's count of the same prefill;
    the chunked loop's time for a rank's rows. Returns the ranks' flash
    launches (none: their rows take the chunked loop)."""
    import tempfile
    import threading
    import torch
    from repro_torch.configs import get_config
    print(f"== phase 25: {CP_ARCH} at {CP_LAYERS} layers context-parallel "
          f"over a model axis of {CP_RANKS} ranks sharing the card (gloo)")
    t_phase = time.perf_counter()
    card = smi_line()
    held_report("phase 25")
    args = {"arch": CP_ARCH, "layers": CP_LAYERS, "batch": CP_BATCH,
            "prompt": CP_PROMPT, "new": CP_NEW, "chunk": CP_CHUNK,
            "cache_len": CP_CACHE_LEN, "check_prompt": CP_CHECK_PROMPT,
            "check_chunk": CP_CHECK_CHUNK, "check_new": CP_CHECK_NEW,
            "train_seq": CP_TRAIN_SEQ, "wait_s": CP_RANK_TIMEOUT_S}
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"out{r}.json") for r in range(CP_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", CP_RANK, str(r), str(CP_RANKS),
             os.path.join(tmp, "store"), outs[r], tmp, json.dumps(args)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join((SRC, ROOT))),
            cwd=ROOT) for r in range(CP_RANKS)]
        errors, writer = [], None
        try:
            t0 = time.perf_counter()
            refs, one_launches = _cp_reference()
            _release()
            print(f"float32 world of one at {CP_LAYERS} layers: loss "
                  f"{refs[0]['loss']}, global norm {refs[0]['norm']}, "
                  f"{len(refs[0]['samples'])} gradient leaves; flash "
                  f"launches {one_launches}; {time.perf_counter() - t0} s "
                  f"({card})")
            # repro: ignore[torch-thread-no-device] -- host tensors only
            writer = threading.Thread(target=_cp_write,
                                      args=(tmp, refs, errors))
            writer.start()
            # the dry-run's count, on the host while the ranks run
            counts = _cp_counts()
            logs = [p.communicate(timeout=CP_RANK_TIMEOUT_S)[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            if writer is not None:
                writer.join()
        check(not errors, f"writing the references: {errors}")
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"rank {r} exited {p.returncode}: "
                  f"{log.strip().splitlines()[-8:]}")
        res = []
        for path in outs:
            with open(path) as f:
                res.append(json.load(f))
    cfg = get_config(CP_ARCH)
    print(f"process group: {res[0]['backend']}, {CP_RANKS} ranks on "
          f"{torch.cuda.get_device_name(0)}; model-axis ranks "
          f"{[r['model_rank'] for r in res]}; plan {res[0]['plan']}")
    check(all(r["backend"] == "gloo" for r in res) and
          [r["model_rank"] for r in res] == list(range(CP_RANKS)),
          f"backends {[r['backend'] for r in res]}")
    check(all(r["plan"] == {"attn": False, "cp": True} for r in res),
          f"plans {[r['plan'] for r in res]}")
    launches = {}
    for r in res:
        m = r["rank"]
        for key in ("bytes", "bytes32"):
            b = r[key]
            print(f"(a) rank {m}{' float32' if key == 'bytes32' else ''}: "
                  f"parameters {b['rank']} bytes, the layout's count (whole "
                  f"leaves + 1/{CP_RANKS} of the cut ones) {b['layout']}, "
                  f"the whole model's {b['whole']}; its {b['attn_leaves']} "
                  f"attention leaves cut: {b['attn_cut']}")
            check(b["rank"] == b["layout"] < b["whole"] and b["attn_cut"],
                  f"(a) rank {m} holds {b}")
        for key, rows in (("cache", CP_PROMPT), ("check", None)):
            c = r[key] if key == "cache" else r[key]["cache"]
            print(f"(a) rank {m}: {'bf16' if key == 'cache' else 'float32'}"
                  f" attention caches {c['rank']} bytes ({c['kinds']}), 1/"
                  f"{CP_RANKS} of a world of one's {c['whole']}: "
                  f"{c['layout']}")
            check(c["rank"] == c["layout"] and c["kinds"] == ["ModelSplit"],
                  f"(a) rank {m}'s caches {c}")
        n_dec = CP_BATCH * CP_NEW
        print(f"(a) rank {m}: prefill {CP_BATCH} x {CP_PROMPT} in "
              f"{r['prefill_s']} s ({CP_BATCH * CP_PROMPT / r['prefill_s']} "
              f"tokens/s), decode {CP_NEW} steps in {r['decode_s']} s "
              f"({r['decode_s'] / CP_NEW * 1e3} ms a step, "
              f"{n_dec / r['decode_s']} tokens/s): figures of one card "
              f"shared by {CP_RANKS} processes over gloo, not of context "
              f"parallelism; peak device memory {r['peak']} bytes; flash "
              f"launches {r['launches']}, a prefill's "
              f"{r['prefill_launches']}, the float32 check's "
              f"{r['check']['launches']}, the step's "
              f"{r['grads']['launches']}; {r['bf16_s']} s bf16, "
              f"{r['rank_s']} s in all, waited {r['wait_s']} s for the "
              f"reference; first ids {r['ids'][0][:8]} ({card})")
        for got in (r["launches"], r["prefill_launches"],
                    r["check"]["launches"], r["grads"]["launches"]):
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
    check(all(r["ids"] == res[0]["ids"] for r in res),
          "(a) the ranks generated different ids")
    # the rows take the chunked loop (q_offset, Sq != Skv): no kernel
    check(not any(launches.values()), f"the ranks launched {launches}")
    want = counts[0][0]
    for r in res:
        print(f"(a) rank {r['rank']}: a prefill's collectives through the "
              f"seam {r['collectives']}")
        check(r["collectives"] == want,
              f"(a) rank {r['rank']}'s collectives differ from the "
              f"dry-run's")
    print(f"(a) the dry-run's count of the same prefill at (0, 0) and (0, "
          f"{CP_RANKS - 1}) of a 1 x {CP_RANKS} mesh: {want} (counted in "
          f"{counts[0][1]} s and {counts[CP_RANKS - 1][1]} s)")
    check(counts[CP_RANKS - 1][0] == want,
          "(a) the dry-run's counts differ between the ranks")
    r0 = res[0]
    for r in res:
        c, g = r["check"], r["grads"]
        print(f"(b) rank {r['rank']} float32 at {CP_LAYERS} layers, "
              f"{CP_BATCH} x {CP_CHECK_PROMPT} and {CP_CHECK_NEW} greedy "
              f"steps: logits / max |logit| against the world of one at "
              f"each step {c['rel']} (limit {CP_LOGITS_TOL}); ids equal "
              f"{c['ids_equal']} ({card})")
        check(c["finite"] and max(c["rel"]) <= CP_LOGITS_TOL,
              f"(b) rank {r['rank']}'s float32 logits differ: {c['rel']}")
        check(c["ids_equal"] and c["ids"] == r0["check"]["ids"],
              f"(b) rank {r['rank']}'s greedy ids differ")
        loss = abs(g["loss"] - refs[0]["loss"]) / abs(refs[0]["loss"])
        norm = abs(g["norm"] - refs[0]["norm"]) / refs[0]["norm"]
        print(f"(c) rank {r['rank']} float32 step's gradient at 1 x "
              f"{CP_TRAIN_SEQ}: loss {g['loss']} (relative {loss}), global "
              f"norm {g['norm']} (relative {norm}, limit {CP_NORM_RTOL}); "
              f"worst gradient block {g['leaf']} {g['worst']} of its leaf's "
              f"max |g| at {CP_SAMPLES} elements a leaf (limit "
              f"{CP_GRAD_TOL}) over {g['leaves']} leaves; {g['s']} s "
              f"({card})")
        check(loss <= LM_LOSS_RTOL and norm <= CP_NORM_RTOL,
              f"(c) rank {r['rank']}: loss {loss}, norm {norm}")
        check(g["finite"] and 0 <= g["worst"] <= CP_GRAD_TOL,
              f"(c) rank {r['rank']}'s gradient {g['leaf']} differs by "
              f"{g['worst']}")
    MEASURED["cp"] = _cp_rows_ms(card)
    dt = time.perf_counter() - t_phase
    print(f"phase 25: {dt} s (limit {PHASE25_LIMIT_S} s); the ranks' "
          f"launches {launches} ({card})")
    check(dt <= PHASE25_LIMIT_S, f"phase 25 took {dt} s")
    return launches


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
        analysis_launches = phase_analysis()
        dryrun_launches = phase_dryrun()
        moe_launches = phase_moe(profile="--profile" in sys.argv[1:])
        ssm_launches = phase_ssm(profile="--profile" in sys.argv[1:])
        local_global_launches = phase_local_global(
            profile="--profile" in sys.argv[1:])
        mla_launches = phase_mla(profile="--profile" in sys.argv[1:])
        vlm_launches = phase_vlm(profile="--profile" in sys.argv[1:])
        family_training_launches = phase_family_train(
            profile="--profile" in sys.argv[1:])
        examples_launches = phase_examples(corpus)
        ep_launches = phase_ep(profile="--profile" in sys.argv[1:])
        ep_training_launches = phase_ep_train(
            profile="--profile" in sys.argv[1:])
        tp_launches = phase_tp()
        tp_family_launches = phase_tp_families()
        cp_launches = phase_cp()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # the float32 flash kernel's main path now includes training
    launches["flash_attention"] += training_launches["flash_attention"]
    # and LM training (phase 11)
    for name, count in lm_training_launches.items():
        launches[name] += count
    # and MoE serving (phase 14), the SSM, hybrid and audio families
    # (phase 15), MLA and MTP (phase 17), the VLM family (phase 18) and
    # the non-dense families' training (phase 19), the example entry
    # points (phase 20), expert-parallel serving (phase 21) and training
    # (phase 22), and tensor parallelism (phases 23 and 24)
    for name, count in list(tp_launches.items()) + \
            list(tp_family_launches.items()) + \
            list(moe_launches.items()) + \
            list(ssm_launches.items()) + list(mla_launches.items()) + \
            list(vlm_launches.items()) + \
            list(family_training_launches.items()) + \
            list(examples_launches.items()) + list(ep_launches.items()) + \
            list(ep_training_launches.items()):
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
    print(json.dumps({"analysis_launches": analysis_launches}))
    print(json.dumps({"dryrun_launches": dryrun_launches}))
    print(json.dumps({"moe_serving_launches": moe_launches}))
    print(json.dumps({"ssm_serving_launches": ssm_launches}))
    print(json.dumps({"local_global_serving_launches":
                      local_global_launches}))
    print(json.dumps({"mla_serving_launches": mla_launches}))
    print(json.dumps({"vlm_serving_launches": vlm_launches}))
    print(json.dumps({"lm_family_training_launches":
                      family_training_launches}))
    print(json.dumps({"examples_launches": MEASURED["examples"]}))
    print(json.dumps({"ep_serving_launches": ep_launches}))
    print(json.dumps({"ep_training_launches": ep_training_launches}))
    print(json.dumps({"tp_launches": tp_launches}))
    print(json.dumps({"tp_family_launches": tp_family_launches}))
    print(json.dumps({"cp_launches": cp_launches}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
