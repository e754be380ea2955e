#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, is right, serves and trains.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. environment — torch / CUDA versions, the card's name and power limit;
2. build — every CUDA kernel of the port, from ``src/repro_torch/kernels/
   csrc`` (``paged_attention.cu``: the split-KV fp and int8 decode
   kernels, two CUDA launches per op call — splits of 128 rows, grid
   (kv_head, lane, split), then their merge in a fixed order;
   ``paged_verify.cu``: the split-KV verify kernel, two CUDA launches per
   op call — the splits of 256 rows, grid (kv_head, lane, split), then
   their merge in a fixed order (``split_kv.cuh``, shared by both);
   ``flash_attention.cu``: the bf16 flash
   kernel on the tensor cores (wgmma, 128-byte-swizzled cp.async ring)
   and the f32 flash kernel on the CUDA cores beside it, chosen by dtype;
   ``fused_decode.cu``: the fused decode layer, eight CUDA launches per
   op call — the split-KV decode kernel and its merge (``paged_decode.cuh``,
   shared with ``paged_attention.cu``), then the weight-streaming products
   (``stream_gemm.cuh``: bf16 on the tensor cores, f32 on the CUDA cores)
   and the row passes as programmatic dependent launches; ``rmsnorm.cu``:
   a row held in registers from 16-byte loads; ``swiglu.cu``: at most 32
   bf16 / 8 f32 rows the fused layer's streaming products (4 launches),
   past that two tiled mma.sync launches, f32 split into bf16 hi + lo;
   ``ssd_scan.cu``: bf16 on the tensor cores (mma.sync), f32 on the
   CUDA cores; shared device code in ``*.cuh``), with nvcc for
   sm_90a, one nvcc per source, in parallel;
3. kernel vs plain — each kernel against its plain PyTorch version at the
   serving shapes of qwen3-0.6b (16 heads, 8 KV heads, head_dim 128,
   block 16; 8 and 32 lanes; ragged lengths up to 4096 with block
   boundaries; one lane on the garbage block; one sliding-window case):
   the paged-attention kernel in bf16 (tolerance 2e-2) and f32 (2e-5); the
   verify kernel at k = 1, 4, 8 in bf16 and f32; the int8 kernel with bf16
   q over int8 pages (2e-2).  A paged, int8 or verify op call is two CUDA
   launches (split kernel and merge) counted as one.  Each with
   CUDA-event times of the kernel,
   the plain version and ``scaled_dot_product_attention`` over K/V
   gathered (and for int8 dequantized) ahead with an explicit mask — the
   library yardstick, which the port never calls (every ``[kernel]`` line
   also gives ``bound_share`` = bound_ms / ms); the fused decode layer
   (d 1024, f 3072; 8 and 32 lanes, the same ragged lengths, garbage lane
   and window case) in bf16 (2e-2) and f32 (2e-4); the harness floor
   (``cuda_ms`` of an empty kernel), then RMSNorm and SwiGLU at rows {1,
   8, 32, 33, 127, 2048} of d 1024 (f 3072; SwiGLU's routes meet at 32 |
   33 rows in bf16, 8 | 9 in f32), RMSNorm at 512 x 1022 (its element
   path), both at the profiler's probe shapes (512, 512[, 1024]), in
   bf16 (2e-2) and f32
   (2e-5 / 2e-4), with ``F.rms_norm`` as RMSNorm's yardstick (the fused
   layer and SwiGLU have no one-call equivalent; bf16 SwiGLU rows also
   time the cuBLAS composition, which rounds the hidden to bf16: not the
   same function);
4. serve — full-width qwen3-0.6b (bf16 compute, f32 params seeded on the
   card) through ``InferenceEngine(backend="paged")``: 8 requests with
   prompts of 64..1024 tokens, two sharing a 256-token prefix (one also a
   partial boundary block, so aliasing and copy-on-write both run), 32
   tokens each, 8 lanes, block 16.  The paged-attention kernel's launch
   count over this run must equal decode_steps x n_layers;
5. one decode step of the phase-4 engine state both ways — kernel and
   plain attention, both bf16 — each held against the same step in f32
   compute: the kernel's logits may be at most 2x as far from the f32
   step as the plain bf16 path's (bf16 noise over 28 layers, not the
   kernel, dominates); and one profiled decode step (device busy share);
5b. fused serve — the same requests through ``paged_impl="fused"``: the
   fused layer must run decode_steps x n_layers times; one decode step
   both ways (fused kernel and fused plain version, bf16), each gated
   against the f32 step as in phase 5; one fused step profiled beside
   phase 5's; tokens matching phase 4 reported, not gated (bf16);
6. speculative serve — the same requests through ``backend="spec",
   spec_inner="paged"``, draft_k 4: (a) with the target's own parameters
   as the draft, (b) with a random 4-layer qwen3-0.6b draft (seed 1), so
   rollback runs every round.  The verify kernel must launch spec_rounds
   x n_layers times, and the pool and the ledger must be empty after; one
   verify round both ways, gated as in phase 5; one draft chain and one
   verify forward profiled, for each draft;
7. int8 serve — the same requests through ``backend="paged",
   kv_dtype="int8"``: the int8 kernel must launch decode_steps x n_layers
   times and a block cost 2·28·16·8·(128+4) B; one int8 decode step both
   ways, gated as in phase 5, and one profiled;
8. small float32 engines — paged decode through the kernel and the plain
   version, speculative decode through the verify kernel against plain
   paged greedy, int8 pages through the int8 kernel and the plain
   version, and the fused decode layer's kernel against the plain unfused
   paged engine must each give identical tokens;
9. flash kernel vs plain — 16/8 heads, head_dim 128, b 1 and 2, sq = sk
   in {64, 127, 128, 129, 1000, 2048, 4096} and two sq < sk, causal and
   not, window 512, bf16 (2e-2: the tensor-core kernel) and f32 (2e-5:
   the CUDA-core kernel), with the kernel's, the plain version's and
   SDPA's times (same mask) and the bound;
10. SHARP training — two full-width qwen3-0.6b TrainJobs (seeds 0 and 1,
   lr 1e-4 and 3e-4, AdamW, SyntheticTokens batch 2 x seq 1024, 3 steps)
   through ``Session`` on two virtual devices of 5 GB: at least 3 shards a
   model, models x steps x 2 x shards units, the ledger never over its
   budget, and each model's losses equal to plain full-model training on
   the card (``train_sequential_reference``) at 3e-4;
11. spilled eval — an ``EvalJob`` of 2 batches over model 0's trained
   params through the shard queue (2 GB budget), with the flash kernel
   and with plain attention: the kernel must launch batches x 28 times;
   one full forward through the kernel, gated against an f32 forward as
   in phase 5; the kernel's numbers at layer 0's q/k/v of the batch;
12. one SHARP forward unit and one backward unit (promotion, compute,
   and for the backward the optimizer step and demotion) profiled;
13. profiler — ``build_facts()`` on the card (transfer rows in GB/s, the
   dense, ssm and hybrid decode grids, the seven kernel rows — the JAX
   probe has no SSD row; saved to ``build/profile_facts.json``), counting
   the RMSNorm and SwiGLU kernels' launches; phase 10's session planned
   with those facts (measured queries > 0, none without, the same shard
   boundaries); a smoke-width two-model session trained with and without
   the facts (identical losses);
14. build — ``ssd_scan.cu`` is part of phase 2's parallel build;
15. SSD kernel vs plain — ``ssd_scan_bshpn`` against the plain chunked
   scan in bf16 (2e-2) and f32 (2e-4, the JAX test's tolerance), rel+abs:
   zamba2's Mamba2 (b 1 and 2, s 256 / 1024 / 4096, h 64, p = n = 64,
   chunk 256, B/C broadcast over heads and contiguous), xlstm-350m's
   mLSTM (b 1, s 1024, h 4, p = n = 512), the four shapes of
   tests/test_kernels.py, and the decay edges log_a = 0 and -30 a step;
   with the kernel's and the plain version's times and the bound (no one
   PyTorch call computes this function: no library yardstick);
16. full-width zamba2-1.2b (38 Mamba2 layers, d 2048, shared block 32/32
   heads of 64 after every 6th layer; bf16 compute, f32 params seeded on
   the card): (a) serve — ``InferenceEngine`` (slot backend), 8 requests
   with prompts of 16..128 tokens (numpy seed 0), 16 tokens each, 8
   lanes: every request gets exactly 16 tokens, decode and prefill tok/s,
   one decode step profiled, and ``backend="paged"`` falls back to slot
   with the warning; (b) spilled eval — an ``EvalJob`` of 2 batches of
   2 x 1024 through the shard queue (2 GB budget) with the flash kernel
   and without: the kernel must launch batches x 6 times; one flash call
   at the shared block's shape held against its plain version; (c) one
   forward of the eval batch composed as the hybrid shard plan's segments
   with every Mamba2 scan through ``ssd_scan_bshpn``: exactly 38
   launches, logits gated against an f32 forward as in phase 5, and the
   kernel's numbers at layer 0's scan inputs; (d) SHARP — two TrainJobs
   (seeds 0 and 1, AdamW, 2 x 1024, 2 steps) on two virtual devices of
   8 GB (3 shards a model), gated as phase 10; (e) a small f32 zamba2
   engine whose lanes at different positions give the tokens each request
   gets alone;
17. session serve — one ``Session`` (one virtual device of ``TRAIN_BUDGET``
   plus the hot job's worst-case KV-page cap, computed from
   ``FamilySpec.kv_block_bytes``) holding phase 10's first TrainJob, a hot
   paged ``ServeJob`` of full-width qwen3-0.6b (seed 0, the phase-4
   requests, pages charged to the session's ledger) and a cold slot
   ``ServeJob`` (seed 1, 4 of those prompts, promoted out of the host
   store by its first request): the plan round-trips through JSON and
   runs, its meta records the paged backend, the capabilities and the
   cap; every request gets its tokens; serve ticks fall between shard
   units (unit and serve traces); the losses equal phase 10's first
   model's at 3e-4; the paged kernel launches decode_steps x 28 times; the
   ledger stays within its budget and cap and ends at 0 reserved; the
   cold promotion's bytes are its shards' transfer bytes; then a small
   f32 session (paged and spec over paged) token-identical to bare f32
   engines, and ``profiler --smoke`` in process with phase 13's facts;
18. Fig 8 — the paper's end-to-end comparison
   (``benchmarks/bench_end_to_end.py``) at full width: up to 12
   ``TrainJob``s of bert-large-1b (36 layers, d 1536, layer norm, GELU,
   biases, non-causal attention; seeds 0.., the grid's learning rates
   1e-3..1e-6 in turn, AdamW, 2 steps of 2 x 512) on 8 virtual devices of
   the paper's 11e9 B, transfers modelled at this card's measured pinned
   host-to-device rate; as many models as have host stores (f32 params
   and two Adam moments, pinned) fitting in half of ``MemAvailable``, the
   count and reason printed; then ``core/baselines.py`` replays the
   pilot's unit runtimes under model, pipeline and task parallelism.
   Gates: units = models x steps x 2 x shards, no ledger over budget,
   finite losses, model 0's losses equal plain full-model training on the
   card at 3e-4, task parallelism raises ``MemoryError`` at 11e9 B and
   replays at 80e9 B, pipeline <= model parallelism, utilisations in
   (0, 1], SHARP's makespan below model parallelism's;
19. bucketed serve — phase 4's requests through ``InferenceEngine(
   backend="paged", bucket_sizes=pow2_buckets(max_seq))``, then the same
   engine without buckets: every request gets its tokens, one prefill per
   (admission round, bucket), every prefill width a bucket, the paged
   kernel launches decode_steps x 28 times, the pool and ledger end
   empty, each bucketed group's first-token logits at most LOGIT_REL x as
   far from an f32 exact-length prefill as the bf16 exact-length prefill
   is; prefill tok/s (true tokens) and distinct prefill shapes both ways;
   small f32 engines (slot and paged, bucketed and exact) token-identical;
20. tiered memory — (a) phase 4's requests as ``priority="low"`` on 8
   lanes (the prefix sharers submitted last, so they are the first
   victims), a ledger budget of their reservations plus one block less
   than 4 ``priority="high"`` 256-token requests need, the highs arriving
   after 3 steps; untiered, then ``tiered_kv=True`` (eager demotion on
   preempt, ``prefetch_ticks=1``).  Gates: more peak live requests tiered;
   ``kv_demoted_bytes`` > 0 and equal to ``kv_prefetched_bytes``; every
   demoted block's rows, cloned just before demotion, equal its pages
   element for element after its prefetch lands; after every step the
   host pool equals the ledger's host term and the ledger is in budget;
   no shared, indexed or prefix block demotes; everything drains; the
   paged kernel launches decode_steps x 28.  (b) the pressure path:
   ``SLOPolicy(demote_on_preempt=False)``, prefix sharing off, a fifth
   640-token high — only ``relieve_pressure`` demotes, and the long high's
   first token comes at an earlier decode step than untiered; (a)'s other
   gates.  (c) (a)'s tiered run over an int8 pool: rows and scales round
   trip, the int8 kernel launches decode_steps x 28.  The page moves
   alone: 64 blocks down and up through a fresh host pool, D2H / H2D GB/s
   by the side stream's events.  (d) three full-width models (seeds 0-2)
   in pinned host stores of >= 4 shards, one ledger of twice the model
   bytes plus KV slack, ``hot_bytes`` half a model, one request each,
   stepped round robin: tokens equal each model's fully resident engine,
   more models hold hot shards than whole models fit, shards stream,
   between ticks ``memory_allocated`` over the baseline is exactly the hot
   shards' tensors, the ledger drains; the in-tick allocated peak beside
   the ledger's, streamed-shard GB/s.  (e) (a) and (d) at the smoke shape
   in f32: token-identical to decoding each prompt alone;
21. planning and the async session — (a) phase 10's first TrainJob
   planned with ``partition_oracle="probe"`` on one virtual device of
   ``PROBE_BUDGET`` (6 GB: at ``TRAIN_BUDGET`` the JAX package's rule
   finds the head segment alone too large, which the line reports): per
   shard the pilot's allocator peak, the live-bytes count beside the
   allocator's peak of one more pilot of it, and the rule's two sides;
   the analytic partition beside it, the pilot count and seconds; gates:
   an ordered cover, at most segments + shards pilots.  (b) the plan
   saved, then ``Plan.load`` run by a fresh session: no pilot, (a)'s
   partition, units = steps x 2 x shards, the ledger in budget, losses
   equal phase 10's first model's at 3e-4, and the run's
   ``max_memory_allocated`` over its baseline at most ``TRAIN_BUDGET``
   (each unit's allocated peak printed beside its shard's probe
   charge).  (c) ``run_async`` on ``PROBE_BUDGET`` plus the hot job's KV
   cap with a hot paged ServeJob: phase 4's first 4 requests before, the
   other 4 once training runs; the handle not done at once and a second
   ``run_async`` / ``run`` refused; every request gets its tokens, each
   mid-run request decodes tokens between two shard units, losses equal
   phase 10's, paged launches = decode_steps x 28, the ledger ends at 0,
   ``result()`` twice the same report, a second ``run_async`` serves one
   more request, a loader raising after its first batch makes
   ``result()`` raise it.  (d) ``examples/quickstart_torch.py``'s
   ``main()`` on the card (its own assertion), and ``make_grad_step``'s
   grad norm equal to ``make_train_step``'s at 2e-4 at full width;
22. ROADMAP item 8 up to MoE at full width (each model freed before the
   next; every depth cut printed, widths as published) — (a) the paged
   kernel (bf16 2e-2, f32 2e-5), the int8 kernel and verify (k 1, 4, 5;
   and 8 at 12 groups: 96 rows, run as query chunks)
   at 5, 6, 7 and 12 query heads per KV head (8 KV heads of 128, phase
   3's ragged lengths, garbage lane and window case), the fused layer at
   qwen2.5-32b's, yi-34b's and command-r-plus-104b's d and f, flash at
   mixtral's 48/8 heads, s 8192, window 4096, each with its times, bound
   and SDPA's; (b) those three configs cut to 2 layers (f32 params seeded
   on the card, bf16 compute) serving phase 4's requests, 16 new tokens
   each, on the paged backend: launches = decode_steps x 2, one decode
   step both ways and the fused kernel against its plain version
   (LOGIT_REL on the mean abs logit difference); (c) mixtral-8x22b and
   dbrx-132b at 2 layers through ``InferenceEngine``: a paged, bucketed
   engine falls back to slot without buckets, the requests get exactly
   16 tokens each on the slot backend, tok/s, each prefill's
   frac_dropped, a profiled decode step; (d) an ``EvalJob`` of 1 x 8192
   over (c)'s mixtral through the MoE shard plan (2 shards at 15 GB), flash
   and plain: flash launches = 2, one full forward both ways with the
   route flips against f32, the kernel at layer 0's q/k/v; (e) mixtral at
   1 layer under SHARP (its 32.5 GB pinned store held against half of
   ``MemAvailable``), 2 AdamW steps of 2 x 1024 at the least budget that
   cuts the analytic plan in two: units = steps x 2 x shards, the ledger
   in budget, losses, lb_loss and z_loss equal to plain training stepped
   in place at 3e-4, each unit's peak beside its charge, the probe
   oracle's partition beside the analytic one; (f) mixtral and dbrx smoke
   slot engines give each prompt its tokens alone, command-r-plus smoke at
   12 query heads per KV head gives identical tokens through the paged
   kernel and the plain paged engine.  Alone: ``python3
   tools/item8_phase.py``.
23. ROADMAP item 8's second half at full width (cut nothing; every model
   freed before the next): (a) the paged, int8 and verify kernels at
   llava-next-mistral-7b's 32/8 heads of 128 (phase 3's ragged lengths,
   garbage lane and window case; verify at k 1, 4, 8, and at 12 query
   heads per KV head and k 8 — 96 rows, run as query chunks of the
   kernel's 64), the fused layer at d 4096 / f 14336, flash at llava's
   eval shape (b 1, s 4096) and whisper's decoder self-attention (b 2, s
   448, 16/16 heads of 64); (b) llava at 32 layers (f32 params, one bf16
   copy of the layer weights shared by its engines) serves phase 4's
   requests on the paged, fused, spec (self-draft) and int8 backends:
   launches = steps (rounds) x 32, each kernel step gated against its
   plain version on the mean (LOGIT_REL, phase 22's rule), each kernel
   at its serve inputs, one profiled paged step; (c) llava's spilled
   eval of a random ``embeds`` batch (1 x 4096) with flash and without:
   32 launches, one full forward both ways; (d) whisper-medium (24 + 24
   layers): two TrainJobs under SHARP (2 AdamW steps of 2 x 448) at the
   largest budget whose analytic plan cuts >= 3 shards with a boundary
   past the bridge, unit peaks beside charges, losses equal plain
   training at 3e-4; the probe's plan beside the analytic one; a
   spilled eval with flash (24 launches) and without; encode ->
   precompute_cross_kv -> 16 decode steps against the forward (mean abs
   within 2e-2); (e) two vit-300m models under SHARP on random patch
   embeddings, losses equal plain training; (f) llava smoke f32 slot,
   paged, spec and int8 engines give each prompt its tokens alone, and
   the engine refuses whisper smoke with the JAX package's reason.
   ``MemAvailable`` is printed before (c)'s stores, (d) and (e).  Alone:
   ``python3 tools/encdec_vlm_phase.py``.
24. the fp8 KV cache, the HTTP front end and checkpoints (full-width
   qwen3-0.6b, seed 0, phase 4's requests) — (b) served on the paged
   backend over bf16 pages, then over e4m3 pages
   (``kv_cache_dtype="float8_e4m3fn"``): every request gets its tokens,
   the paged kernel launches decode_steps x 28 both times, the e4m3
   pool's page peak and block bytes are half the bf16 pool's, one decode
   step of the fp8 snapshot both ways (phase 5's gate), one step of the
   bf16 snapshot with its pages as they are and cast to e4m3 (mean
   |softmax delta| < 2e-3, the JAX fp8 test's bound); the fused path
   (``paged_impl="fused"``) and spec over a paged inner (self-draft, k 4)
   over e4m3 pages, 16 tokens a request: fused launches = decode_steps x
   28, verify launches = spec_rounds x 28; (a) each e4m3 route (decode,
   fused, verify k 4) at the fp8 serve's inputs against its plain
   version, with its times, byte bound and SDPA over K/V gathered and
   upcast; (c) ``HydraHTTPServer`` on 127.0.0.1, port 0, over a paged
   engine: 8 streaming and 4 non-streaming clients at once, 16 tokens
   each — every client's ids equal the engine's record of its request,
   the paged kernel launches decode steps x 28, client TTFT and
   per-stream tok/s printed beside the card's name and power limit; a
   mid-decode ``/v1/cancel`` frees the lane and the KV reservation within
   one tick; ``/v1/metrics`` back to its baseline; a small f32 engine's
   HTTP tokens equal its offline engine's; ``python -m
   repro_torch.launch.serve --arch qwen3-0.6b --backend paged --http
   --port 0`` on its default device (the card) prints its first line,
   answers ``/health`` and streams the ids a non-streamed completion
   returns, and exits 0 on SIGINT; (d) the params saved with
   ``checkpoint.save`` (the JAX format) and restored bit for bit, GB/s
   each way.  Alone: ``python3 tools/fp8_http_phase.py``.
25. training over a device mesh (full-width qwen3-0.6b, seed 0) — (a) a
   ``Session`` + ``SpmdTrainJob`` on the card with ``mesh="auto"`` (a
   (1, 1) NCCL mesh of one rank; DTensor params, AdamW at 3e-4), 20
   steps of 8 x 256: every loss finite, the last below the first, the
   first 3 equal ``make_train_step`` without a mesh from the same seed and
   batches at 3e-4; trained tok/s and max memory allocated; (b) ``python
   -m repro_torch.launch.train --arch qwen3-0.6b --steps 10 --ckpt-dir
   TMP`` on its default device: exit 0, its JSON line, the checkpoint
   restored bit for bit; (c) ``python -m repro_torch.launch.dryrun --arch
   qwen3-0.6b --shape decode_32k`` on the 256-rank fake mesh and the
   roofline's ``main`` over its record, in this process: both ``ok``, the
   peak per device and the dominant term printed as an analysis of 256
   H100s, not a time on the card.  One card runs one rank: NCCL refuses
   two ranks on one GPU, so the multi-rank paths ((2, 2) training, the
   (2, 4) expert-parallel MoE) are held by the gloo tests
   (``tests/test_torch_spmd_train.py``,
   ``tests/test_torch_moe_expert_parallel.py``).  No kernel runs here.
   Alone: ``python3 tools/spmd_phase.py``.
26. the remaining examples at full width, each model freed before the
   next — (a) ``examples/large_model_single_device_torch.py`` on
   bert-large-1b (36 layers, d 1536): 17 GB of params + grads + Adam on
   one device of 2e9 B, 4 steps of 2 x 512, then the spilled eval at a
   third of the budget: >= 2 shards, no ledger over its budget, units =
   steps x 2 x shards, losses and the eval's mean loss equal plain
   full-model training and a plain forward on the card at 3e-4; (b)
   ``examples/model_selection_torch.py``: the grid's first three points at
   full width, 1 step of seq 512 on 4 virtual devices of 11e9 B (SHARP's
   transfers at the measured host-to-device rate): units
   = steps x 2 x shards summed, finite losses, task parallelism out of
   memory, pipeline <= model parallelism, SHARP below model parallelism;
   (c) ``examples/serve_batched_torch.py``: qwen3-0.6b, mixtral-8x22b
   cold (2 layers, a 40e9 B budget) and xlstm-350m, 8 tokens for each of three requests,
   a cold promotion, all three in the schedule, buckets on qwen3-0.6b
   alone; (d) the dry run of qwen3-0.6b at long_500k (no K/V plane
   all-gathered, under 1 GB of collectives a device: attention over the
   sequence-sharded cache merges by log-sum-exp) and at decode_32k (its
   record unchanged).  No kernel runs here.  Alone: ``python3
   tools/examples_phase.py``.

Each kernel's launch count is zeroed just before the run of its own path
(a serve run, the spilled eval, the profiler's ``build_facts`` for
RMSNorm and SwiGLU, the zamba2 kernel forward for the SSD scan; the
paged kernel's again before phase 17's session run, phase 19's serve
runs, each of phase 20's tiered runs, phase 21 (c)'s async run and
each of phase 22 (b)'s serves, the int8 kernel's before phase 20 (c),
flash's before each of phase 22 (d)'s eval runs) and read just after;
the kernel line reports it with the kernel's numbers at that path's
inputs, the paged and int8 kernels' launches on the tiered path (phase
20 (a) tiered, (c)) as ``tiered_launches``, and the paged kernel's on
the async session path (phase 21 (c)) as ``async_launches``; the paged
kernel's summed over phase 22 (b)'s three wide dense serves as
``wide_gqa_launches`` and flash's on phase 22 (d)'s MoE eval as
``moe_eval_launches``; the paged, verify, int8 and fused kernels' on
phase 23 (b)'s llava serves as ``vlm_launches`` and flash's on phase 23
(d)'s whisper eval as ``audio_launches``, the paged kernel's on phase 24
(c)'s HTTP run as ``http_launches`` (each zeroed before its run); the
e4m3 routes have entries of their own (``[e4m3 pages]``), with phase 24
(b)'s fp8 paged, fused and spec launches and (a)'s numbers.

The second-to-last lines are a JSON object of per-kernel numbers and the
card's ``nvidia-smi`` name/power line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Details also go to ``build/chip_smoke.json``.  ``--out-dir DIR`` puts
that file in DIR instead, beside ``chip_smoke.log``, a copy of every line
the run printed (the log of a failed run too).
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12,     # f32 outside the tensor cores
              "bfloat16": 989e12}   # dense bf16 tensor-core rate
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_REL = 2.0     # kernel vs f32 step, relative to plain bf16 vs f32
NH, NKV, HD, BS = 16, 8, 128, 16
GEN, CAPACITY, DRAFT_K = 32, 8, 4


LOG_FILE = None      # set by --out-dir: every printed line is copied there


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    _copy_line(f"chip_smoke FAILED: {msg}")
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)
    _copy_line(msg)


def _copy_line(msg: str) -> None:
    if LOG_FILE is not None:
        with open(LOG_FILE, "a") as f:
            f.write(msg + "\n")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


SPIN_CYCLES = 1_000_000     # ~0.5 ms of device time at the H100's clocks


def cuda_ms(fn, iters: int = 20, flush=None) -> float:
    """Median device time of ``fn`` by CUDA events, after one warm-up;
    ``flush`` (a large buffer) is rewritten before each launch so the
    inputs come from HBM, as they do on the serving path, where each
    layer's pages were last touched a whole decode step earlier.  A spin
    kernel ahead of the start event keeps the stream busy while the host
    enqueues ``fn``, so a slow host adds no idle gap to the time."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# ---------------------------------------------------------------------------
# phase 3: the paged-attention kernel against its plain version
# ---------------------------------------------------------------------------

def paged_bytes_flops(lengths, tables_width, dtype_bytes, q_bytes, n, window,
                      nh=NH, nkv=NKV):
    """Least bytes a launch must move — q read, out written, the K and V
    rows each lane attends to (rows inside [length - window, length)),
    tables, lengths — and the flops it must do (q.k and p.v over those
    rows), from these inputs (``nh`` query, ``nkv`` KV heads of HD)."""
    rows = sum(int(le) - (max(0, int(le) - window) if window else 0)
               for le in lengths)
    nbytes = (rows * nkv * HD * 2 * dtype_bytes
              + 2 * n * nh * HD * q_bytes + 4 * n * tables_width + 4 * n)
    flops = 4 * rows * nh * HD
    return nbytes, flops


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def set_bound(res, nbytes, flops, dtype_name):
    """Put the bound (ms, what bounds it) and the bound's share of the
    measured time, ``bound_ms / ms``, into a kernel's result."""
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype_name)
    res["bound_share"] = res["bound_ms"] / res["ms"]


def measure_paged(q, kp, vp, tables, lengths, window, dtype_name, flush):
    """Kernel vs plain on one set of inputs: error, times, bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    out = ops.paged_attention(q, kp, vp, tables, lengths, window=window,
                              impl="cuda")
    exp = ref.paged_attention_ref(q, kp, vp, tables, lengths, window=window)
    torch.cuda.synchronize()
    diff = (out.float() - exp.float()).abs()
    tol = TOL[dtype_name]
    ok = bool((diff <= tol + tol * exp.float().abs()).all())
    finite = bool(torch.isfinite(out).all())
    # library yardstick: SDPA over K/V gathered and head-expanded ahead
    n, B = tables.shape
    S = B * BS
    nh, nkv = q.shape[1], kp.shape[2]
    g = nh // nkv
    tl = tables.long()
    # fp8 pages reach SDPA upcast to q's dtype (a no-op for bf16 and f32)
    k = ref.gather_blocks(kp, tl).to(q.dtype).reshape(n, S, nkv, HD) \
        .repeat_interleave(g, 2).transpose(1, 2)
    v = ref.gather_blocks(vp, tl).to(q.dtype).reshape(n, S, nkv, HD) \
        .repeat_interleave(g, 2).transpose(1, 2)
    pos = torch.arange(S, device=q.device)[None, :]
    le = lengths.long()[:, None]
    mask = pos < le
    if window:
        mask &= pos > le - 1 - window
    mask = mask[:, None, None, :]
    qh = q[:, :, None, :]

    def lib():
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

    lib_err = (lib()[:, :, 0].float() - exp.float()).abs().max()
    res = {
        "max_abs_err": float(diff.max()),
        "library_max_abs_err": float(lib_err),
        "within_tol": ok and finite,
        "ms": cuda_ms(lambda: ops.paged_attention(
            q, kp, vp, tables, lengths, window=window, impl="cuda"),
            flush=flush),
        "plain_ms": cuda_ms(lambda: ref.paged_attention_ref(
            q, kp, vp, tables, lengths, window=window), iters=5,
            flush=flush),
        "library_ms": cuda_ms(lib, flush=flush),
    }
    nbytes, flops = paged_bytes_flops(
        lengths.tolist(), B, kp.element_size(), q.element_size(), n, window,
        nh, nkv)
    set_bound(res, nbytes, flops, dtype_name)
    res["bytes"], res["flops"] = nbytes, flops
    del k, v
    return res


def sweep_inputs(n, dtype, seed, max_len=4096, nh=NH, nkv=NKV):
    """Ragged lengths 1..max_len with block boundaries, distinct random
    physical blocks per lane, the last lane inactive (all-garbage table,
    length 1); ``nh`` query and ``nkv`` KV heads of HD."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    edge = [min(e, max_len)
            for e in (1, BS - 1, BS, BS + 1, max_len, max_len - 1, 2 * BS,
                      1000)]
    lengths = rng.integers(1, max_len + 1, n)
    lengths[:min(n - 1, len(edge))] = edge[:min(n - 1, len(edge))]
    lengths[-1] = 1
    B = -(-max_len // BS)
    need = [-(-int(x) // BS) for x in lengths[:-1]]
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((n, B), np.int32)
    at = 0
    for i, nb in enumerate(need):
        tables[i, :nb] = perm[at:at + nb]
        at += nb
    dev = "cuda"
    q = torch.randn(n, nh, HD, device=dev).to(dtype)
    kp = torch.randn(P, BS, nkv, HD, device=dev).to(dtype)
    vp = torch.randn(P, BS, nkv, HD, device=dev).to(dtype)
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev))


def phase_kernel_sweep(flush):
    import torch
    cases = [("bfloat16", 8, None), ("bfloat16", 32, None),
             ("float32", 8, None), ("float32", 32, None),
             ("bfloat16", 32, 512)]
    rows = []
    for i, (dt, n, window) in enumerate(cases):
        torch.manual_seed(i)
        args = sweep_inputs(n, getattr(torch, dt), seed=i)
        r = measure_paged(*args, window, dt, flush)
        r.update(dtype=dt, lanes=n, window=window,
                 lengths=args[4].tolist())
        rows.append(r)
        log(f"[kernel] paged_attention {dt} lanes={n} window={window}: "
            f"max_abs_err={r['max_abs_err']:.3g} (tol {TOL[dt]}) "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f}"
            f" bound_share={r['bound_share']:.3f}")
        if not r["within_tol"]:
            fail(f"paged_attention kernel disagrees with its plain version "
                 f"({dt}, {n} lanes, window={window}): max abs err "
                 f"{r['max_abs_err']}")
        del args
    return rows


# ---------------------------------------------------------------------------
# phase 3b: the verify kernel against its plain version
# ---------------------------------------------------------------------------

def verify_bytes_flops(lengths, kq, tables_width, dtype_bytes, q_bytes, n,
                       window, nh=NH, nkv=NKV):
    """Least bytes a verify launch must move — q read, out written, each
    lane's K/V rows [lo, lengths + k) once, tables, lengths — and its flops
    (q.k and p.v of every query row over the rows it attends), from these
    inputs."""
    cap = tables_width * BS
    rows = qk_rows = 0
    for le in lengths:
        le = int(le)
        lo = max(0, le - window + 1) if window else 0
        rows += max(0, min(le + kq, cap) - lo)
        for i in range(kq):
            lo_i = max(0, le + i - window + 1) if window else 0
            qk_rows += max(0, min(le + i + 1, cap) - lo_i)
    nbytes = (rows * nkv * HD * 2 * dtype_bytes
              + 2 * n * kq * nh * HD * q_bytes + 4 * n * tables_width + 4 * n)
    return nbytes, 4 * qk_rows * nh * HD


def verify_mask(lengths, kq, S, window, device):
    """(n, 1, k, S) rows each query attends, for the library yardstick."""
    import torch
    pos = torch.arange(S, device=device)[None, None, :]
    lim = lengths.long()[:, None, None] \
        + torch.arange(kq, device=device)[None, :, None]
    mask = pos <= lim
    if window:
        mask &= pos > lim - window
    return mask[:, None]


def measure_verify(q, kp, vp, tables, lengths, window, dtype_name, flush,
                   lanes=None):
    """Verify kernel vs plain on one set of inputs: error (over ``lanes``,
    default all), times, bound; SDPA over K/V gathered and head-expanded
    ahead, with an explicit mask, is the library yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    out = ops.paged_verify(q, kp, vp, tables, lengths, window=window,
                           impl="cuda")
    exp = ref.paged_verify_ref(q, kp, vp, tables, lengths, window=window)
    torch.cuda.synchronize()
    sel = slice(None) if lanes is None else lanes
    diff = (out[sel].float() - exp[sel].float()).abs()
    tol = TOL[dtype_name]
    ok = bool((diff <= tol + tol * exp[sel].float().abs()).all())
    finite = bool(torch.isfinite(out[sel]).all())
    n, B = tables.shape
    kq, nh, nkv = q.shape[1], q.shape[2], kp.shape[2]
    S = B * BS
    g = nh // nkv
    tl = tables.long()
    k = ref.gather_blocks(kp, tl).to(q.dtype).reshape(n, S, nkv, HD) \
        .repeat_interleave(g, 2).transpose(1, 2)
    v = ref.gather_blocks(vp, tl).to(q.dtype).reshape(n, S, nkv, HD) \
        .repeat_interleave(g, 2).transpose(1, 2)
    mask = verify_mask(lengths, kq, S, window, q.device)
    qh = q.transpose(1, 2)

    def lib():
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

    lib_err = (lib().transpose(1, 2)[sel].float()
               - exp[sel].float()).abs().max()
    res = {
        "max_abs_err": float(diff.max()),
        "library_max_abs_err": float(lib_err),
        "within_tol": ok and finite,
        "ms": cuda_ms(lambda: ops.paged_verify(
            q, kp, vp, tables, lengths, window=window, impl="cuda"),
            flush=flush),
        "plain_ms": cuda_ms(lambda: ref.paged_verify_ref(
            q, kp, vp, tables, lengths, window=window), iters=5,
            flush=flush),
        "library_ms": cuda_ms(lib, flush=flush),
    }
    nbytes, flops = verify_bytes_flops(
        lengths.tolist(), kq, B, kp.element_size(), q.element_size(), n,
        window, nh, nkv)
    set_bound(res, nbytes, flops, dtype_name)
    res["bytes"], res["flops"] = nbytes, flops
    del k, v
    return res


def verify_sweep_inputs(n, kq, dtype, seed, max_len=4096, nh=NH, nkv=NKV):
    """Committed lengths 0..max_len-k with block edges (a round's queries
    straddling one), distinct random physical blocks per lane, the last
    lane on the garbage block as the spec backend leaves lanes outside a
    round (its length is not reset)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    top = max_len - kq
    edge = [min(e, top) for e in (0, BS - 1, BS - kq // 2, BS, top, 2 * BS,
                                  1000, top - 1)]
    lengths = rng.integers(0, top + 1, n)
    lengths[:min(n - 1, len(edge))] = edge[:min(n - 1, len(edge))]
    lengths[-1] = 37
    B = -(-max_len // BS)
    need = [-(-(int(x) + kq) // BS) for x in lengths[:-1]]
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((n, B), np.int32)
    at = 0
    for i, nb in enumerate(need):
        tables[i, :nb] = perm[at:at + nb]
        at += nb
    dev = "cuda"
    q = torch.randn(n, kq, nh, HD, device=dev).to(dtype)
    kp = torch.randn(P, BS, nkv, HD, device=dev).to(dtype)
    vp = torch.randn(P, BS, nkv, HD, device=dev).to(dtype)
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev))


def phase_verify_sweep(flush):
    import torch
    cases = [("bfloat16", 8, 1, None), ("bfloat16", 8, 4, None),
             ("bfloat16", 32, 8, None), ("float32", 8, 4, None),
             ("float32", 32, 8, None), ("bfloat16", 32, 4, 512)]
    rows = []
    for i, (dt, n, kq, window) in enumerate(cases):
        torch.manual_seed(100 + i)
        args = verify_sweep_inputs(n, kq, getattr(torch, dt), seed=100 + i)
        r = measure_verify(*args, window, dt, flush)
        r.update(dtype=dt, lanes=n, k=kq, window=window,
                 lengths=args[4].tolist())
        rows.append(r)
        log(f"[kernel] paged_verify {dt} lanes={n} k={kq} window={window}: "
            f"max_abs_err={r['max_abs_err']:.3g} (tol {TOL[dt]}) "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f}"
            f" bound_share={r['bound_share']:.3f}")
        if not r["within_tol"]:
            fail(f"paged_verify kernel disagrees with its plain version "
                 f"({dt}, {n} lanes, k={kq}, window={window}): max abs err "
                 f"{r['max_abs_err']}")
        del args
    return rows


# ---------------------------------------------------------------------------
# phase 3c: the int8 kernel against its plain version
# ---------------------------------------------------------------------------

def quant_bytes_flops(lengths, tables_width, q_bytes, n, window, nh=NH,
                      nkv=NKV):
    """Least bytes an int8 launch must move — q, out, the attended rows'
    int8 K/V (hd bytes each) and f32 scales (4 bytes each), tables,
    lengths — and its flops (q.k, p.v and the dequantizing products)."""
    rows = sum(int(le) - (max(0, int(le) - window) if window else 0)
               for le in lengths)
    nbytes = (rows * nkv * (HD + 4) * 2
              + 2 * n * nh * HD * q_bytes + 4 * n * tables_width + 4 * n)
    return nbytes, 4 * rows * nh * HD + 2 * rows * nkv * HD


def measure_quant(q, kq8, vq8, ks, vs, tables, lengths, window, flush):
    """int8 kernel vs plain on one set of inputs; the library yardstick is
    SDPA over K/V gathered, dequantized to q's dtype and head-expanded
    ahead, with an explicit mask."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    args = (q, kq8, vq8, ks, vs, tables, lengths)
    out = ops.paged_attention_quant(*args, window=window, impl="cuda")
    exp = ref.paged_attention_quant_ref(*args, window=window)
    torch.cuda.synchronize()
    diff = (out.float() - exp.float()).abs()
    tol = TOL["bfloat16"]
    ok = bool((diff <= tol + tol * exp.float().abs()).all())
    finite = bool(torch.isfinite(out).all())
    n, B = tables.shape
    S = B * BS
    nh, nkv = q.shape[1], kq8.shape[2]
    g = nh // nkv
    tl = tables.long()

    def deq(p8, sc):
        x = ref.dequantize_kv(p8[tl].reshape(n, S, nkv, HD),
                              sc[tl].reshape(n, S, nkv)).to(q.dtype)
        return x.repeat_interleave(g, 2).transpose(1, 2)

    k, v = deq(kq8, ks), deq(vq8, vs)
    pos = torch.arange(S, device=q.device)[None, :]
    le = lengths.long()[:, None]
    mask = pos < le
    if window:
        mask &= pos > le - 1 - window
    mask = mask[:, None, None, :]
    qh = q[:, :, None, :]

    def lib():
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

    lib_err = (lib()[:, :, 0].float() - exp.float()).abs().max()
    res = {
        "max_abs_err": float(diff.max()),
        "library_max_abs_err": float(lib_err),
        "within_tol": ok and finite,
        "ms": cuda_ms(lambda: ops.paged_attention_quant(
            *args, window=window, impl="cuda"), flush=flush),
        "plain_ms": cuda_ms(lambda: ref.paged_attention_quant_ref(
            *args, window=window), iters=5, flush=flush),
        "library_ms": cuda_ms(lib, flush=flush),
    }
    nbytes, flops = quant_bytes_flops(lengths.tolist(), B, q.element_size(),
                                      n, window, nh, nkv)
    set_bound(res, nbytes, flops, "bfloat16")
    res["bytes"], res["flops"] = nbytes, flops
    del k, v
    return res


def phase_quant_sweep(flush):
    import torch

    from repro_torch.kernels import ref
    cases = [(8, None), (32, None), (32, 512)]
    rows = []
    for i, (n, window) in enumerate(cases):
        torch.manual_seed(200 + i)
        q, kp, vp, tables, lengths = sweep_inputs(n, torch.float32,
                                                  seed=200 + i)
        kq8, ks = ref.quantize_kv(kp)
        vq8, vs = ref.quantize_kv(vp)
        del kp, vp
        r = measure_quant(q.to(torch.bfloat16), kq8, vq8, ks, vs, tables,
                          lengths, window, flush)
        r.update(dtype="bfloat16 q, int8 pages", lanes=n, window=window,
                 lengths=lengths.tolist())
        rows.append(r)
        log(f"[kernel] paged_attention_quant bf16/int8 lanes={n} "
            f"window={window}: max_abs_err={r['max_abs_err']:.3g} (tol "
            f"{TOL['bfloat16']}) ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} bound_share={r['bound_share']:.3f}")
        if not r["within_tol"]:
            fail(f"paged_attention_quant kernel disagrees with its plain "
                 f"version ({n} lanes, window={window}): max abs err "
                 f"{r['max_abs_err']}")
    return rows


# ---------------------------------------------------------------------------
# phase 3d: the fused decode layer against its plain version
# ---------------------------------------------------------------------------

D_MODEL, D_FF = 1024, 3072
MM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # kernels ending in matmuls


def fused_weights(dtype, seed, d=D_MODEL, f=D_FF, nh=NH):
    """wo, the MLP norm scale, Wg, Wu, Wd at qwen3-0.6b's widths (or
    ``d``, ``f`` and ``nh`` heads of HD), scaled as the model's
    initializer scales them (N(0, 1/fan_in))."""
    import torch
    g = torch.Generator("cuda").manual_seed(seed)

    def dense(fan_in, fan_out):
        return (torch.randn(fan_in, fan_out, device="cuda", generator=g)
                / fan_in ** 0.5).to(dtype)
    scale = (torch.randn(d, device="cuda", generator=g) * 0.1 + 1.0)
    return (dense(nh * HD, d), scale.to(dtype), dense(d, f), dense(d, f),
            dense(f, d))


def fused_bytes_flops(lengths, tables_width, n, window, act_bytes, kv_bytes,
                      d=D_MODEL, f=D_FF, nh=NH, nkv=NKV):
    """Least bytes of one fused layer: the K/V rows the lanes attend, q, h
    and out, tables and lengths, and the weights read once for all lanes;
    flops: the attention's and 2 n (nh hd d + 3 d f) for the products."""
    nbytes, flops = paged_bytes_flops(lengths, tables_width, kv_bytes,
                                      act_bytes, n, window, nh, nkv)
    nbytes -= n * nh * HD * act_bytes            # out is (n, d), not q-sized
    nbytes += (2 * n * d + nh * HD * d + 3 * d * f + d) * act_bytes
    flops += 2 * n * (nh * HD * d + 3 * d * f)
    return nbytes, flops


def measure_fused(h, q, kp, vp, tables, lengths, weights, window,
                  dtype_name, flush):
    """Fused kernel vs plain on one set of inputs: error, times, bound."""
    import torch

    from repro_torch.kernels import ops, ref

    args = (h, q, kp, vp, tables, lengths, *weights)
    out = ops.fused_decode_layer(*args, window=window, impl="cuda")
    exp = ref.fused_decode_layer_ref(*args, window=window)
    torch.cuda.synchronize()
    diff = (out.float() - exp.float()).abs()
    tol = MM_TOL[dtype_name]
    res = {"max_abs_err": float(diff.max()),
           "within_tol": bool((diff <= tol + tol * exp.float().abs()).all()
                              and torch.isfinite(out).all()),
           "ms": cuda_ms(lambda: ops.fused_decode_layer(
               *args, window=window, impl="cuda"), flush=flush),
           "plain_ms": cuda_ms(lambda: ref.fused_decode_layer_ref(
               *args, window=window), iters=5, flush=flush),
           "library_ms": None}     # no one PyTorch call computes the layer
    nbytes, flops = fused_bytes_flops(
        lengths.tolist(), tables.shape[1], h.shape[0], window,
        h.element_size(), kp.element_size(), h.shape[1],
        weights[2].shape[1], q.shape[1], kp.shape[2])
    set_bound(res, nbytes, flops, dtype_name)
    res["bytes"], res["flops"] = nbytes, flops
    return res


def phase_fused_sweep(flush):
    import torch
    cases = [("bfloat16", 8, None), ("bfloat16", 32, None),
             ("float32", 8, None), ("float32", 32, None),
             ("bfloat16", 32, 512)]
    rows = []
    for i, (dt, n, window) in enumerate(cases):
        torch.manual_seed(100 + i)
        dtype = getattr(torch, dt)
        q, kp, vp, tables, lengths = sweep_inputs(n, dtype, seed=100 + i)
        h = torch.randn(n, D_MODEL, device="cuda").to(dtype)
        r = measure_fused(h, q, kp, vp, tables, lengths,
                          fused_weights(dtype, 100 + i), window, dt, flush)
        r.update(dtype=dt, lanes=n, window=window, lengths=lengths.tolist())
        rows.append(r)
        log(f"[kernel] fused_decode_layer {dt} lanes={n} window={window}: "
            f"max_abs_err={r['max_abs_err']:.3g} (tol {MM_TOL[dt]}) "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f}"
            f" bound_share={r['bound_share']:.3f} ({r['bound_by']})")
        if not r["within_tol"]:
            fail(f"fused_decode_layer kernel disagrees with its plain "
                 f"version ({dt}, {n} lanes, window={window}): max abs err "
                 f"{r['max_abs_err']}")
        del q, kp, vp
    return rows


# ---------------------------------------------------------------------------
# phase 3e: RMSNorm and SwiGLU against their plain versions
# ---------------------------------------------------------------------------

RMS_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the profiler's probe shapes: rms_norm (rows, d), swiglu (rows, d, f)
PROBE_SHAPE = (512, 512, 1024)
# rows at qwen3-0.6b's widths: decode lanes, SwiGLU's route boundaries
# (bf16 32 stream | 33 tiled; f32 8 | 9), a ragged prefill, a long one
SWEEP_ROWS = (1, 8, 32, 33, 127, 2048)
RAGGED_RMS = (512, 1022)      # d % 8 != 0: RMSNorm's element path


def rms_swiglu_inputs(rows, d, f, dtype_name):
    """x ~ N(0, 1), the norm scale ~ 1 + N(0, 0.01), SwiGLU weights ~
    N(0, 1/fan_in), on the card, from a generator seeded by the shape."""
    import torch
    dtype = getattr(torch, dtype_name)
    g = torch.Generator("cuda").manual_seed(rows + d + f)
    x = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    w = (torch.randn(d, device="cuda", generator=g) * 0.1 + 1.0).to(dtype)
    mats = [(torch.randn(a, b, device="cuda", generator=g) / a ** 0.5)
            .to(dtype) for a, b in ((d, f), (d, f), (f, d))]
    return x, w, mats


def harness_floor_ms(flush) -> float:
    """``cuda_ms`` of an empty kernel (``torch.cuda._sleep(0)``), with the
    flush and the spin: the least time the timer can report."""
    import torch
    return cuda_ms(lambda: torch.cuda._sleep(0), flush=flush)


def swiglu_bound(rows, d, f, dtype_name, item):
    """SwiGLU's least bytes (x, out, the three weights) and the time of
    the products its route issues: the tiled f32 route splits each
    operand into two bf16 parts and issues three tensor-core products for
    each of the reference's (``swiglu.bound_flops``)."""
    import torch

    from repro_torch.kernels.swiglu import bound_flops
    nbytes = (2 * rows * d + 3 * d * f) * item
    flops, unit = bound_flops(rows, d, f, getattr(torch, dtype_name))
    peak = PEAK_FLOPS["bfloat16" if unit == "tensor" else "float32"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return nbytes, flops, max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def _gate(name, r, tol, shape):
    if not r["within_tol"]:
        fail(f"{name} kernel disagrees with its plain version ({shape}): "
             f"max abs err {r['max_abs_err']}")


def _compare(got, exp, tol):
    import torch
    torch.cuda.synchronize()
    diff = (got.float() - exp.float()).abs()
    return {"max_abs_err": float(diff.max()),
            "within_tol": bool((diff <= tol + tol * exp.float().abs()).all()
                               and torch.isfinite(got).all())}


def measure_rms(rows, d, dtype_name, flush):
    """RMSNorm over (rows, d), kernel vs plain: error, times, bound, and
    ``F.rms_norm`` (one PyTorch call) as the library yardstick."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    x, w, _ = rms_swiglu_inputs(rows, d, 8, dtype_name)
    tol = RMS_TOL[dtype_name]
    r = _compare(ops.rms_norm(x, w, impl="cuda"), ref.rms_norm_ref(x, w),
                 tol)
    r.update(ms=cuda_ms(lambda: ops.rms_norm(x, w, impl="cuda"),
                        flush=flush),
             plain_ms=cuda_ms(lambda: ref.rms_norm_ref(x, w), iters=5,
                              flush=flush),
             library_ms=cuda_ms(lambda: F.rms_norm(x, (d,), w, 1e-6),
                                flush=flush),
             rows=rows, d=d, f=None, dtype=dtype_name)
    set_bound(r, (2 * rows * d + d) * x.element_size(), 4 * rows * d,
              dtype_name)
    log(f"[kernel] rms_norm {dtype_name} rows={rows} d={d}: max_abs_err="
        f"{r['max_abs_err']:.3g} (tol {tol}) ms={r['ms']:.4f} plain_ms="
        f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} bound_ms="
        f"{r['bound_ms']:.4f} bound_share={r['bound_share']:.3f} "
        f"({r['bound_by']})")
    _gate("rms_norm", r, tol, f"{dtype_name}, rows {rows}, d {d}")
    return r


def measure_swiglu(rows, d, f, dtype_name, flush):
    """SwiGLU over (rows, d, f), kernel vs plain: error, times, the bound
    of its route's products; no one PyTorch call computes it (library
    null).  Beside the plain time, bf16 rows also time the cuBLAS
    composition (F.silu(x @ Wg) * (x @ Wu)) @ Wd in bf16 — not the same
    function (it rounds the hidden to bf16), a measure of how far the
    products are from the card's library."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.swiglu import swiglu_route
    x, _, mats = rms_swiglu_inputs(rows, d, f, dtype_name)
    wg, wu, wd = mats
    tol = MM_TOL[dtype_name]
    r = _compare(ops.swiglu(x, *mats, impl="cuda"),
                 ref.swiglu_ref(x, *mats), tol)
    r.update(ms=cuda_ms(lambda: ops.swiglu(x, *mats, impl="cuda"),
                        flush=flush),
             plain_ms=cuda_ms(lambda: ref.swiglu_ref(x, *mats), iters=5,
                              flush=flush),
             library_ms=None,
             cublas_bf16_ms=(cuda_ms(lambda: (F.silu(x @ wg) * (x @ wu))
                                     @ wd, flush=flush)
                             if dtype_name == "bfloat16" else None),
             route=swiglu_route(rows, x.dtype), rows=rows, d=d, f=f,
             dtype=dtype_name)
    r["bytes"], r["flops"], r["bound_ms"], r["bound_by"] = swiglu_bound(
        rows, d, f, dtype_name, x.element_size())
    r["bound_share"] = r["bound_ms"] / r["ms"]
    cub = ("" if r["cublas_bf16_ms"] is None else
           f" cublas_bf16_ms={r['cublas_bf16_ms']:.4f} (not the same "
           f"function: the hidden rounded to bf16)")
    log(f"[kernel] swiglu {dtype_name} rows={rows} d={d} f={f} route="
        f"{r['route']}: max_abs_err={r['max_abs_err']:.3g} (tol {tol}) "
        f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f}{cub} bound_ms="
        f"{r['bound_ms']:.4f} bound_share={r['bound_share']:.3f} "
        f"({r['bound_by']})")
    _gate("swiglu", r, tol, f"{dtype_name}, rows {rows}, d {d}, f {f}")
    return r


def phase_rms_swiglu_sweep(flush):
    """The harness floor, then RMSNorm and SwiGLU at SWEEP_ROWS of
    qwen3-0.6b's widths, RMSNorm at RAGGED_RMS, and both at the profiler's
    probe shapes, in bf16 and f32.  Returns (report, the probe-shape f32
    rows — the shapes the profiler's path gives the kernels)."""
    floor = harness_floor_ms(flush)
    log(f"[kernel] harness floor: cuda_ms of an empty kernel "
        f"(torch.cuda._sleep(0), flush and spin) = {floor:.4f} ms")
    rows, probe = [], {}
    for dt in ("bfloat16", "float32"):
        for m in SWEEP_ROWS:
            rows.append({"rms_norm": measure_rms(m, D_MODEL, dt, flush),
                         "swiglu": measure_swiglu(m, D_MODEL, D_FF, dt,
                                                  flush)})
        rows.append({"rms_norm": measure_rms(*RAGGED_RMS, dt, flush)})
        r = {"rms_norm": measure_rms(*PROBE_SHAPE[:2], dt, flush),
             "swiglu": measure_swiglu(*PROBE_SHAPE, dt, flush)}
        rows.append(r)
        if dt == "float32":
            probe = r
    return {"harness_floor_ms": floor, "rows": rows}, probe


# ---------------------------------------------------------------------------
# phase 4-5: serve full-width qwen3-0.6b, then one step both ways
# ---------------------------------------------------------------------------

def serve_prompts(vocab, seed=0):
    """8 prompts of 64..1024 tokens; prompt 1 is the first 264 tokens of
    prompt 0: it shares prompt 0's 256-token (16-block) prefix and the
    first half of its next block, so it aliases 17 blocks and
    copy-on-writes the partial one at its first decode step."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1025, 8)
    lens[0] = max(int(lens[0]), 300)
    prompts = [rng.integers(0, vocab, int(n), dtype=np.int32) for n in lens]
    prompts[1] = prompts[0][:256 + BS // 2].copy()
    return prompts


def paged_snapshot(eng):
    """The paged backend's state as its next decode step gets it: pages
    (cloned), block tables, lengths and the lanes' next input tokens.

    The backend's own ``_prepare_lanes`` runs first.  That step would run
    it anyway, and then finds every block in place.  Without it, a lane
    whose next row opens a new block still names the pool's garbage
    block there.  Every such lane writes that row to the same garbage
    row, and which write lands is unspecified, so the lanes read back one
    another's K/V and two steps on the snapshot differ."""
    be = eng.backend
    be._prepare_lanes(eng._active)
    return {"pages": {k: v.clone() for k, v in be.pool.pages.items()},
            "tables": be._tables.copy(), "lengths": be._lengths.copy(),
            "tokens": eng._tokens[:, 0, :].copy()}


def drive_serve(cfg, eng, prompts, counter, label, snap_step=None, gen=GEN):
    """Submit every prompt, zero the kernel's launch count, drive the
    engine to the end (snapshotting the paged state at decode step
    ``snap_step``), check every request got exactly ``gen`` tokens, and
    return (snapshot, result) with the count read just after the run."""
    import torch
    for i, p in enumerate(prompts):
        eng.submit(p, gen, request_id=f"r{i}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter.launches = 0                 # count this path's run only
    t0 = time.perf_counter()
    snap = None
    while eng.step():
        if snap_step is not None and eng.decode_steps == snap_step \
                and snap is None:
            snap = paged_snapshot(eng)
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches
    summary = eng.summary()
    done = {r.request_id: r for r in eng.completed}
    if len(done) != len(prompts):
        fail(f"{label}: served {len(done)} of {len(prompts)} requests")
    for rid, r in done.items():
        if len(r.generated) != gen or r.status.value != "finished":
            fail(f"{label} {rid}: {len(r.generated)} tokens, status "
                 f"{r.status}")
    res = {
        "requests": len(done), "gen": gen, "wall_s": wall,
        "prompt_lens": [len(p) for p in prompts],
        "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        **{k: summary.get(k) for k in (
            "backend", "decode_steps", "prefill_calls", "prefill_tok_per_s",
            "decode_tok_per_s", "kv_page_peak_bytes", "kv_peak_bytes",
            "kv_reserved_bytes", "shared_block_hits", "cow_copies",
            "peak_concurrency", "paged_impl", "n_blocks", "block_bytes",
            "kv_dtype")},
        "prefill_s": eng.prefill_s, "decode_s": eng.decode_s,
        "tokens": {rid: r.generated for rid, r in done.items()},
    }
    return snap, res, summary


def phase_serve(cfg, params, prompts):
    import torch

    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.serving.engine import InferenceEngine

    max_seq = max(len(p) for p in prompts) + GEN
    # warm-up engine (cuBLAS handles, kernel library load): not measured
    warm = InferenceEngine(cfg, params, capacity=2, max_seq=128,
                           backend="paged", block_size=BS, device="cuda")
    for p in prompts[2:4]:
        warm.submit(p[:64], 4)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    eng = InferenceEngine(cfg, params, capacity=CAPACITY, max_seq=max_seq,
                          backend="paged", block_size=BS, device="cuda")
    snap, res, summary = drive_serve(cfg, eng, prompts,
                                     paged_attention_lanes, "serve",
                                     snap_step=8)
    launches = res["launches"]
    expect = summary["decode_steps"] * cfg.n_layers
    if launches != expect:
        fail(f"paged_attention launched {launches} times on the serve "
             f"path; expected decode_steps x layers = {expect}")
    if summary["shared_block_hits"] < 16 or summary["cow_copies"] < 1:
        fail(f"prefix sharing did not run: {summary['shared_block_hits']} "
             f"shared blocks, {summary['cow_copies']} copy-on-write copies")
    log(f"[serve] qwen3-0.6b full width: {res['requests']} requests x {GEN} "
        f"tokens, prefill {res['prefill_tok_per_s']} tok/s, decode "
        f"{res['decode_tok_per_s']} tok/s, decode_steps "
        f"{res['decode_steps']}, kernel launches {launches}, "
        f"kv_page_peak_bytes {res['kv_page_peak_bytes']}, "
        f"max_memory_allocated {res['max_memory_allocated']}, "
        f"shared_block_hits {res['shared_block_hits']}, cow_copies "
        f"{res['cow_copies']}")
    return eng, snap, res


def phase_spec_serve(cfg, params, prompts, draft_cfg, draft_params, label,
                     snap_round=3):
    """Full-width speculative serve over the paged inner: the engine's
    verify forward is wrapped to snapshot one round's inputs (pages,
    tables, lengths, tokens) for the both-ways check and the kernel's
    numbers at the serve inputs.  Checks: every request gets exactly GEN
    tokens, the verify kernel runs once per layer per round, and the pool
    and the ledger are empty afterwards."""
    import torch

    from repro_torch.kernels.paged_verify import paged_verify_lanes
    from repro_torch.serving.engine import InferenceEngine

    from repro_torch.models import api
    from repro_torch.serving.paging import blocks_for_rows

    max_seq = max(len(p) for p in prompts) + GEN
    # the draft state's bytes are charged to the paged inner's ledger, as
    # in the JAX package: budget the worst-case target pages plus every
    # lane's draft state, so all CAPACITY lanes can run at once
    budget = (CAPACITY * blocks_for_rows(max_seq + DRAFT_K, BS)
              * api.kv_block_bytes(cfg, BS)
              + CAPACITY * api.decode_state_bytes(draft_cfg, 1,
                                                   max_seq + DRAFT_K))
    eng = InferenceEngine(cfg, params, capacity=CAPACITY, max_seq=max_seq,
                          backend="spec", spec_inner="paged",
                          draft_cfg=draft_cfg, draft_params=draft_params,
                          draft_k=DRAFT_K, block_size=BS,
                          kv_budget_bytes=budget, device="cuda")
    be = eng.backend
    verify = be._verify
    snap = {}

    def snooping_verify(p, pages, tables, lengths, tokens):
        if be.spec_rounds == snap_round and not snap:
            snap.update(pages={k: v.clone() for k, v in pages.items()},
                        tables=tables.clone(), lengths=lengths.clone(),
                        tokens=tokens.clone())
        return verify(p, pages, tables, lengths, tokens)

    # host wall time of every round and of its two forwards, during the
    # run itself (each already ends in a device sync: the draft chain and
    # the round copy their tokens to the host; verify gets its own sync,
    # which the round's copy of the greedy tokens would do anyway)
    times = {"round": [], "draft_chain": [], "verify": []}

    def timed(key, fn, sync=False):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    be._verify = timed("verify", snooping_verify, sync=True)
    be._draft_chain = timed("draft_chain", be._draft_chain)
    be._spec_round = timed("round", be._spec_round)
    _, res, summary = drive_serve(cfg, eng, prompts, paged_verify_lanes,
                                  label)
    res["round_host_ms"] = {k: statistics.median(v) if v else None
                            for k, v in times.items()}
    expect = summary["spec_rounds"] * cfg.n_layers
    if res["launches"] != expect:
        fail(f"{label}: paged_verify launched {res['launches']} times; "
             f"expected spec_rounds x layers = {expect}")
    if eng.pool.n_used != 0 or eng.ledger.kv_reserved_bytes != 0:
        fail(f"{label}: {eng.pool.n_used} blocks still allocated and "
             f"{eng.ledger.kv_reserved_bytes} B still reserved after the "
             "run")
    if not snap:
        fail(f"{label}: the run ended before verify round {snap_round}")
    if summary["peak_concurrency"] != CAPACITY:
        fail(f"{label}: peak concurrency {summary['peak_concurrency']}, "
             f"expected all {CAPACITY} lanes busy")
    for k in ("spec_rounds", "target_steps", "spec_tokens",
              "accepted_tokens_per_target_step", "draft_accept_rate",
              "verify_impl", "draft_slot_bytes"):
        res[k] = summary[k]
    rt = res["round_host_ms"]
    log(f"[spec] {label}: per round, median of {len(times['round'])}: "
        f"round {rt['round']:.2f} ms = draft chain {rt['draft_chain']:.2f} ms "
        f"+ verify {rt['verify']:.2f} ms + the rest (host wall time)")
    # where a round's time goes: its draft chain (run on the draft state
    # the serve left behind: same shapes, whatever the lanes' indices) and
    # its verify forward on the snapshot round's inputs
    t_last = snap["tokens"][:, 0].cpu().numpy()
    res["profile_draft_chain"] = profiled(
        f"{label}: one draft chain ({DRAFT_K} draft steps, "
        f"{CAPACITY} lanes)", lambda: be._draft_chain(t_last))
    pages = {k: v.clone() for k, v in snap["pages"].items()}
    res["profile_verify"] = profiled(
        f"{label}: one verify forward ({CAPACITY} lanes x {DRAFT_K})",
        lambda: api.paged_verify_step(
            cfg, eng.params, pages, snap["tables"], snap["lengths"],
            snap["tokens"].long(), impl=be.verify_impl))
    del pages
    log(f"[spec] {label}: {res['requests']} requests x {GEN} tokens, "
        f"draft {draft_cfg.name} ({draft_cfg.n_layers} layers), k "
        f"{DRAFT_K}: spec_rounds {res['spec_rounds']}, target_steps "
        f"{res['target_steps']}, spec_tokens {res['spec_tokens']}, "
        f"accepted_tokens_per_target_step "
        f"{res['accepted_tokens_per_target_step']}, draft_accept_rate "
        f"{res['draft_accept_rate']}, decode {res['decode_tok_per_s']} "
        f"tok/s, prefill {res['prefill_tok_per_s']} tok/s, verify kernel "
        f"launches {res['launches']}, max_memory_allocated "
        f"{res['max_memory_allocated']}")
    return snap, res


def phase_int8_serve(cfg, params, prompts, fp_res):
    """Full-width serve from an int8 paged pool: the dequantizing kernel
    runs once per layer per decode step; a block costs rows * (hd + 4)."""
    from repro_torch.kernels.paged_attention import \
        paged_attention_quant_lanes
    from repro_torch.serving.engine import InferenceEngine

    max_seq = max(len(p) for p in prompts) + GEN
    eng = InferenceEngine(cfg, params, capacity=CAPACITY, max_seq=max_seq,
                          backend="paged", kv_dtype="int8", block_size=BS,
                          device="cuda")
    snap, res, summary = drive_serve(cfg, eng, prompts,
                                     paged_attention_quant_lanes, "int8",
                                     snap_step=8)
    expect = summary["decode_steps"] * cfg.n_layers
    if res["launches"] != expect:
        fail(f"paged_attention_quant launched {res['launches']} times on "
             f"the int8 serve path; expected decode_steps x layers = "
             f"{expect}")
    want = 2 * cfg.n_layers * BS * NKV * (HD + 4)
    if summary["block_bytes"] != want:
        fail(f"int8 block_bytes {summary['block_bytes']}, expected {want}")
    res["block_ratio_vs_fp"] = summary["block_bytes"] / fp_res["block_bytes"]
    res["kv_page_peak_ratio_vs_fp"] = (res["kv_page_peak_bytes"]
                                       / fp_res["kv_page_peak_bytes"])
    same = sum(res["tokens"][r] == fp_res["tokens"][r] for r in res["tokens"])
    res["requests_token_identical_to_fp"] = same
    log(f"[int8] paged int8 KV: {res['requests']} requests x {GEN} tokens, "
        f"block_bytes {summary['block_bytes']} "
        f"({res['block_ratio_vs_fp']:.4f} x fp), kv_page_peak_bytes "
        f"{res['kv_page_peak_bytes']} vs fp {fp_res['kv_page_peak_bytes']}, "
        f"decode {res['decode_tok_per_s']} tok/s, decode_steps "
        f"{res['decode_steps']}, kernel launches {res['launches']}, "
        f"max_memory_allocated {res['max_memory_allocated']}, requests "
        f"token-identical to the bf16 pool {same} of {res['requests']}")
    return eng, snap, res


def phase_both_ways(cfg, eng, snap, params, stat="max"):
    """One decode step of the snapshot state through the kernel and
    through the plain attention (both bf16), each held against the same
    step in float32 compute with the plain attention.  bf16 rounding over
    28 layers of random weights moves the logits far more than the
    kernel's own error, so the gate is relative to that noise: the
    kernel's logits may be at most LOGIT_REL times as far from the f32
    step as the plain bf16 step's are."""
    import torch

    from repro_torch.models import api

    dev = "cuda"
    tables = torch.from_numpy(snap["tables"]).to(dev)
    lengths = torch.from_numpy(snap["lengths"]).to(dev)
    tokens = torch.from_numpy(snap["tokens"]).long().to(dev)
    cfg32 = cfg.replace(dtype="float32")
    runs = {"cuda": (cfg, eng.params, "cuda"),
            "ref": (cfg, eng.params, "ref"),
            "f32": (cfg32, api.prepare_params(cfg32, params, dev), "ref")}
    logits = {}
    with torch.no_grad():
        for key, (c, p, impl) in runs.items():
            pages = {k: v.clone() for k, v in snap["pages"].items()}
            logits[key] = api.paged_decode_step(
                c, p, pages, tables, lengths, tokens, impl=impl).float()
            del pages
    torch.cuda.synchronize()
    return logit_gate(f"{cfg.name} one decode step", logits, stat=stat)


def profiled(label, fn):
    """One call of ``fn`` under torch.profiler, after one warm call: its
    wall time, the device time summed over CUDA kernels, the device's busy
    share of the wall time, the kernel launches and the top kernels.  The
    profiler inflates the host side, so the busy share is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in kern)
    res = {"wall_ms": wall * 1e3,
           "device_ms": busy_us / 1e3 if kern else None,
           "device_busy_share": busy_us / 1e6 / wall if kern else None,
           "kernel_launches": sum(e.count for e in kern),
           "top": [{"name": e.key[:80], "count": e.count,
                    "ms": dev_us(e) / 1e3}
                   for e in sorted(kern, key=dev_us, reverse=True)[:8]]}
    log(f"[profile] {label} (profiler on): wall {res['wall_ms']:.2f} ms, "
        f"device {res['device_ms']} ms, busy share "
        f"{res['device_busy_share']}, {res['kernel_launches']} kernel "
        "launches")
    for t in res["top"]:
        log(f"[profile]   {t['ms']:.3f} ms x{t['count']} {t['name']}")
    return res


def phase_profile(cfg, eng, snap, label="one decode step (8 lanes)",
                  impl=None):
    """One decode step of the snapshot state under the profiler."""
    import torch

    from repro_torch.models import api

    dev = "cuda"
    args = (torch.from_numpy(snap["tables"]).to(dev),
            torch.from_numpy(snap["lengths"]).to(dev),
            torch.from_numpy(snap["tokens"]).long().to(dev))
    pages = {k: v.clone() for k, v in snap["pages"].items()}
    res = profiled(label, lambda: api.paged_decode_step(
        cfg, eng.params, pages, *args, impl=impl))
    del pages
    return res


def logit_gate(label, logits, names=("kernel", "plain"), stat="max"):
    """The both-ways gate over {"cuda", "ref", "f32"} logits: the kernel's
    logits may be at most LOGIT_REL times as far from the f32 run as the
    plain bf16 path's are, by the max abs difference (``stat="max"``) or
    the mean (``"mean"``: phase 22).  ``names`` say in the log what the
    "cuda" and "ref" runs are."""
    import torch
    kn, pn = names
    a, b, f = logits["cuda"], logits["ref"], logits["f32"]
    res = {"max_abs_logit_diff_kernel_vs_plain": float((a - b).abs().max()),
           "max_abs_err_kernel_vs_f32": float((a - f).abs().max()),
           "max_abs_err_plain_vs_f32": float((b - f).abs().max()),
           "mean_abs_err_kernel_vs_f32": float((a - f).abs().mean()),
           "mean_abs_err_plain_vs_f32": float((b - f).abs().mean()),
           "max_abs_logit": float(f.abs().max()),
           "argmax_flips_kernel_vs_plain": int(
               (a.argmax(-1) != b.argmax(-1)).sum()),
           "argmax_flips_kernel_vs_f32": int(
               (a.argmax(-1) != f.argmax(-1)).sum()),
           "argmax_flips_plain_vs_f32": int(
               (b.argmax(-1) != f.argmax(-1)).sum()),
           "positions": int(a.numel() // a.shape[-1])}
    err_k = res[f"{stat}_abs_err_kernel_vs_f32"]
    err_p = res[f"{stat}_abs_err_plain_vs_f32"]
    res["within_tol"] = (err_k <= LOGIT_REL * err_p
                         and bool(torch.isfinite(a).all()))
    res["gate_stat"] = stat
    also_max = ("" if stat == "max" else
                f" (max {res['max_abs_err_kernel_vs_f32']:.4g}, "
                f"{res['max_abs_err_plain_vs_f32']:.4g})")
    log(f"[both-ways] {label}: {kn} vs {pn} max abs logit diff "
        f"{res['max_abs_logit_diff_kernel_vs_plain']:.4g}; {stat} abs "
        f"diff from f32 {kn} {err_k:.4g}, {pn} {err_p:.4g}{also_max} (gate: "
        f"{kn} <= {LOGIT_REL} x {pn}; max |logit| "
        f"{res['max_abs_logit']:.3g}); argmax flips "
        f"{kn}/{pn} {res['argmax_flips_kernel_vs_plain']}, {kn}/f32 "
        f"{res['argmax_flips_kernel_vs_f32']}, {pn}/f32 "
        f"{res['argmax_flips_plain_vs_f32']} of {res['positions']}")
    if not res["within_tol"]:
        fail(f"{label}: the {kn} logits are farther from the f32 run "
             f"({err_k}) than {LOGIT_REL} x the {pn} bf16 path's ({err_p})")
    return res


def phase_verify_both_ways(cfg, snap, params, bf16_params, stat="max"):
    """One verify round of the spec run's snapshot through the kernel and
    through the plain path (both bf16), each against the same round in
    f32 compute; only the lanes in the round are compared (the others
    write into the garbage block in an unspecified order)."""
    import torch

    from repro_torch.models import api

    dev = "cuda"
    lanes = (snap["tables"] != 0).any(dim=1)
    cfg32 = cfg.replace(dtype="float32")
    runs = {"cuda": (cfg, bf16_params, "cuda"),
            "ref": (cfg, bf16_params, "ref"),
            "f32": (cfg32, api.prepare_params(cfg32, params, dev), "ref")}
    logits = {}
    with torch.no_grad():
        for key, (c, p, impl) in runs.items():
            pages = {k: v.clone() for k, v in snap["pages"].items()}
            logits[key] = api.paged_verify_step(
                c, p, pages, snap["tables"], snap["lengths"],
                snap["tokens"].long(), impl=impl)[lanes].float()
            del pages
    torch.cuda.synchronize()
    res = logit_gate(f"{cfg.name} one verify round ({int(lanes.sum())} "
                     f"lanes x {DRAFT_K} positions)", logits, stat=stat)
    res["lanes_in_round"] = int(lanes.sum())
    return res


def phase_int8_both_ways(cfg, snap, params, bf16_params, stat="max"):
    """One decode step of the int8 run's snapshot through the int8 kernel
    and through the plain int8 path (both bf16), each against the same
    step in f32 compute over the same int8 pages."""
    import torch

    from repro_torch.models import api

    dev = "cuda"
    tables = torch.from_numpy(snap["tables"]).to(dev)
    lengths = torch.from_numpy(snap["lengths"]).to(dev)
    tokens = torch.from_numpy(snap["tokens"]).long().to(dev)
    cfg32 = cfg.replace(dtype="float32")
    runs = {"cuda": (cfg, bf16_params, "cuda"),
            "ref": (cfg, bf16_params, "ref"),
            "f32": (cfg32, api.prepare_params(cfg32, params, dev), "ref")}
    logits = {}
    with torch.no_grad():
        for key, (c, p, impl) in runs.items():
            pages = {k: v.clone() for k, v in snap["pages"].items()}
            logits[key] = api.paged_decode_step(
                c, p, pages, tables, lengths, tokens, impl=impl).float()
            del pages
    torch.cuda.synchronize()
    return logit_gate(f"{cfg.name} one int8 decode step", logits,
                      stat=stat)


def step_turns(cfg, params, snap, tables, lengths, tokens, impls, rounds=3):
    """Host wall time of one decode step of the snapshot state per impl
    (each from fresh page copies, ended by a sync), taken in turns — A, B,
    B, A, ``rounds`` times — so the two share the host's drift."""
    import torch

    from repro_torch.models import api

    a, b = impls
    times = {a: [], b: []}
    with torch.no_grad():
        for key in [a, b, b, a] * rounds:
            pages = {k: v.clone() for k, v in snap["pages"].items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.paged_decode_step(cfg, params, pages, tables, lengths,
                                  tokens, impl=impls[key])
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
            del pages
    return {k: {"median": statistics.median(v), "all": v}
            for k, v in times.items()}


def phase_fused_serve(cfg, params, prompts, fp_res, fp_profile, flush):
    """The phase-4 requests through ``paged_impl="fused"``: the fused
    layer's kernel chain runs once per layer per decode step; one decode
    step of the snapshot state both ways — the fused kernel and the fused
    plain version (bf16), each gated against the same step in f32 as
    phase 5 gates the attention kernel (at most LOGIT_REL x the plain
    unfused bf16 step's distance); one fused step profiled beside phase
    5's; and the kernel's numbers at layer 0's serve inputs."""
    import torch

    from repro_torch.kernels.fused_decode import fused_decode_layer
    from repro_torch.models import transformer
    from repro_torch.serving.engine import InferenceEngine

    max_seq = max(len(p) for p in prompts) + GEN
    eng = InferenceEngine(cfg, params, capacity=CAPACITY, max_seq=max_seq,
                          backend="paged", paged_impl="fused",
                          block_size=BS, device="cuda")
    snap, res, summary = drive_serve(cfg, eng, prompts, fused_decode_layer,
                                     "fused", snap_step=8)
    expect = summary["decode_steps"] * cfg.n_layers
    if res["launches"] != expect:
        fail(f"fused_decode_layer launched {res['launches']} times on the "
             f"fused serve path; expected decode_steps x layers = {expect}")
    same = sum(res["tokens"][r] == fp_res["tokens"][r] for r in res["tokens"])
    res["requests_token_identical_to_paged"] = same
    log(f"[fused] paged_impl=fused: {res['requests']} requests x {GEN} "
        f"tokens, decode {res['decode_tok_per_s']} tok/s (paged "
        f"{fp_res['decode_tok_per_s']}), prefill {res['prefill_tok_per_s']} "
        f"tok/s, decode_steps {res['decode_steps']}, kernel launches "
        f"{res['launches']}, max_memory_allocated "
        f"{res['max_memory_allocated']}, requests token-identical to the "
        f"unfused paged run {same} of {res['requests']} (bf16: not gated)")

    dev = "cuda"
    tables = torch.from_numpy(snap["tables"]).to(dev)
    lengths = torch.from_numpy(snap["lengths"]).to(dev)
    tokens = torch.from_numpy(snap["tokens"]).long().to(dev)
    res.update(fused_both_ways(cfg, eng, snap, params))
    res["step_host_ms"] = step_turns(cfg, eng.params, snap, tables, lengths,
                                     tokens, {"unfused": "cuda",
                                              "fused": "fused"})
    st = res["step_host_ms"]
    log(f"[fused] one decode step, host wall to a sync, median of "
        f"{len(st['fused']['all'])} in turns (unfused, fused, fused, "
        f"unfused): unfused {st['unfused']['median']:.2f} ms, fused "
        f"{st['fused']['median']:.2f} ms")
    res["profile"] = phase_profile(cfg, eng, snap,
                                   "one fused decode step (8 lanes)",
                                   impl="fused")
    pr = res["profile"]
    log(f"[fused] one decode step: {pr['kernel_launches']} launches, busy "
        f"share {pr['device_busy_share']} (unfused paged step: "
        f"{fp_profile['kernel_launches']} launches, busy share "
        f"{fp_profile['device_busy_share']})")

    # the kernel at the serve path's inputs: layer 0's pages and weights
    lp = transformer.layer_slices(eng.params["layers"], 1)[0]
    bf = torch.bfloat16
    weights = (lp["attn"]["wo"].to(bf).contiguous(),
               lp["mlp_norm"]["scale"].to(bf).contiguous(),
               lp["mlp"]["w_gate"].to(bf).contiguous(),
               lp["mlp"]["w_up"].to(bf).contiguous(),
               lp["mlp"]["w_down"].to(bf).contiguous())
    le = torch.from_numpy(snap["lengths"] + 1).cuda()
    h = torch.randn(CAPACITY, D_MODEL, device="cuda").to(bf)
    q = torch.randn(CAPACITY, NH, HD, device="cuda").to(bf)
    m = measure_fused(h, q, snap["pages"]["k"][0], snap["pages"]["v"][0],
                      tables, le, weights, None, "bfloat16", flush)
    m["lengths"] = le.tolist()
    log(f"[kernel] fused_decode_layer at the fused serve path's inputs "
        f"(lengths {m['lengths']}): ms={m['ms']:.4f} "
        f"plain_ms={m['plain_ms']:.4f} bound_ms={m['bound_ms']:.4f}"
        f" bound_share={m['bound_share']:.3f} "
        f"({m['bound_by']}) max_abs_err={m['max_abs_err']:.3g}")
    if not m["within_tol"]:
        fail("fused_decode_layer kernel disagrees with its plain version at "
             "the fused serve path's inputs")
    res["main_path_kernel"] = m
    del eng, snap
    return res


def fused_both_ways(cfg, eng, snap, params, label="one fused decode step",
                    yardstick="ref", stat="max"):
    """One decode step of the snapshot state through the fused layer's
    kernel and its plain version (bf16), against the same step in f32 as
    phase 5 gates the attention kernel.  ``yardstick="ref"`` (phase 5b)
    gates both at most LOGIT_REL x as far from f32 as the plain unfused
    bf16 step; ``"fused_ref"`` (phase 22) gates the kernel against its
    own plain version and reports the unfused step's distance."""
    import torch

    from repro_torch.models import api

    dev = "cuda"
    tables = torch.from_numpy(snap["tables"]).to(dev)
    lengths = torch.from_numpy(snap["lengths"]).to(dev)
    tokens = torch.from_numpy(snap["tokens"]).long().to(dev)
    cfg32 = cfg.replace(dtype="float32")
    runs = {"fused": (cfg, eng.params, "fused"),
            "fused_ref": (cfg, eng.params, "fused_ref"),
            "ref": (cfg, eng.params, "ref"),
            "f32": (cfg32, api.prepare_params(cfg32, params, dev), "ref")}
    logits = {}
    with torch.no_grad():
        for key, (c, p, impl) in runs.items():
            pages = {k: v.clone() for k, v in snap["pages"].items()}
            logits[key] = api.paged_decode_step(
                c, p, pages, tables, lengths, tokens, impl=impl).float()
            del pages
    torch.cuda.synchronize()
    del runs
    if yardstick == "fused_ref":
        res = {"both_ways_kernel": logit_gate(
            f"{label}, fused kernel vs its plain version", dict(
                cuda=logits["fused"], ref=logits["fused_ref"],
                f32=logits["f32"]), names=("fused kernel", "fused plain"),
            stat=stat),
            "max_abs_err_unfused_plain_vs_f32": float(
                (logits["ref"] - logits["f32"]).abs().max())}
        log(f"[both-ways] {label}: the plain unfused bf16 step is "
            f"{res['max_abs_err_unfused_plain_vs_f32']:.4g} from f32")
    else:
        res = {"both_ways_kernel": logit_gate(
            f"{label}, fused kernel", dict(
                cuda=logits["fused"], ref=logits["ref"], f32=logits["f32"])),
            "both_ways_plain": logit_gate(
                f"{label}, fused plain version", dict(
                    cuda=logits["fused_ref"], ref=logits["ref"],
                    f32=logits["f32"]))}
    res["max_abs_logit_diff_kernel_vs_fused_plain"] = float(
        (logits["fused"] - logits["fused_ref"]).abs().max())
    log(f"[both-ways] {label}: fused kernel vs fused plain version: max "
        f"abs logit diff "
        f"{res['max_abs_logit_diff_kernel_vs_fused_plain']:.4g}")
    return res


def phase_small_f32():
    """Small float32 engines: paged decode through the kernel and through
    the plain attention give identical tokens; speculative decode over the
    paged inner (verify through the kernel, a random draft) gives plain
    paged greedy's tokens; int8 pages through the int8 kernel and through
    the plain int8 path give identical tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(3),
                             "cuda")
    draft = api.init_params(cfg, torch.Generator("cuda").manual_seed(7),
                            "cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (5, 17, 32, 9)]

    def serve(**kw):
        eng = InferenceEngine(cfg, params, capacity=2, max_seq=64,
                              block_size=8, device="cuda", **kw)
        for i, p in enumerate(prompts):
            eng.submit(p, 12, request_id=f"s{i}")
        eng.run()
        return eng, {r.request_id: r.generated for r in eng.completed}

    from repro_torch.kernels.fused_decode import fused_decode_layer
    out = {impl: serve(backend="paged", paged_impl=impl)[1]
           for impl in ("cuda", "ref")}
    fused_before = fused_decode_layer.launches
    out["fused"] = serve(backend="paged", paged_impl="fused")[1]
    fused_launches = fused_decode_layer.launches - fused_before
    spec_eng, out["spec"] = serve(backend="spec", spec_inner="paged",
                                  draft_cfg=cfg, draft_params=draft,
                                  draft_k=3)
    for impl in ("cuda", "ref"):
        out[f"int8_{impl}"] = serve(backend="paged", kv_dtype="int8",
                                    paged_impl=impl)[1]
    res = {"identical_tokens": out["cuda"] == out["ref"]
           and len(out["cuda"]) == len(prompts),
           "spec_identical_to_plain": out["spec"] == out["ref"],
           "spec_verify_impl": spec_eng.backend.verify_impl,
           "spec_draft_accept_rate":
               spec_eng.summary()["draft_accept_rate"],
           "int8_identical_kernel_vs_plain":
               out["int8_cuda"] == out["int8_ref"]
               and len(out["int8_cuda"]) == len(prompts),
           "fused_identical_to_plain": out["fused"] == out["ref"],
           "fused_launches": fused_launches}
    log(f"[small-f32] smoke engines, tokens identical: paged kernel vs "
        f"plain {res['identical_tokens']}; spec (verify "
        f"{res['spec_verify_impl']}, draft accept rate "
        f"{res['spec_draft_accept_rate']}) vs plain paged "
        f"{res['spec_identical_to_plain']}; int8 kernel vs plain int8 "
        f"{res['int8_identical_kernel_vs_plain']}; fused kernel "
        f"({fused_launches} launches) vs plain unfused paged "
        f"{res['fused_identical_to_plain']}")
    if not res["identical_tokens"]:
        fail("small f32 engine: kernel and plain attention gave different "
             "tokens")
    if not res["spec_identical_to_plain"] or res["spec_verify_impl"] != "cuda":
        fail("small f32 engine: speculative decode through the verify "
             "kernel did not give plain greedy's tokens")
    if not res["int8_identical_kernel_vs_plain"]:
        fail("small f32 engine: int8 pages through the kernel and through "
             "the plain version gave different tokens")
    if not res["fused_identical_to_plain"] or fused_launches == 0:
        fail("small f32 engine: the fused decode layer's kernel did not "
             "give the plain unfused paged engine's tokens")
    return res


# ---------------------------------------------------------------------------
# phase 9: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------

def visible_pairs(sq, sk, causal, window):
    """(query, key) pairs the mask lets through: key j < sk visible to
    query i iff j <= i (causal) and j > i - window (window)."""
    import numpy as np
    i = np.arange(sq)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(sq, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_mask(sq, sk, causal, window, device):
    import torch
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return mask


def measure_flash(q, k, v, causal, window, dtype_name, flush):
    """Flash kernel vs plain on one set of layer-layout inputs (q (b, sq,
    nh, hd), k/v (b, sk, nkv, hd)): error, times, bound.  The library
    yardstick is SDPA over head-expanded K/V made ahead, with the same
    mask (``is_causal`` where that mask is the plain causal one)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    b, sq, nh, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="cuda")
        exp = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="ref")
    torch.cuda.synchronize()
    diff = (out.float() - exp.float()).abs()
    tol = TOL[dtype_name]
    ok = bool((diff <= tol + tol * exp.float().abs()).all())
    finite = bool(torch.isfinite(out).all())
    g = nh // nkv
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(g, 2).transpose(1, 2)
    vh = v.repeat_interleave(g, 2).transpose(1, 2)
    plain_causal = causal and not window and sq == sk
    mask = None if plain_causal or (not causal and not window) \
        else flash_mask(sq, sk, causal, window, q.device)

    def lib():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              is_causal=plain_causal)

    with torch.no_grad():
        lib_err = (lib().transpose(1, 2).float() - exp.float()).abs().max()
        res = {
            "max_abs_err": float(diff.max()),
            "library_max_abs_err": float(lib_err),
            "within_tol": ok and finite,
            "ms": cuda_ms(lambda: ops.flash_attention(
                q, k, v, causal=causal, window=window, impl="cuda"),
                flush=flush),
            "plain_ms": cuda_ms(lambda: ops.flash_attention(
                q, k, v, causal=causal, window=window, impl="ref"),
                iters=5, flush=flush),
            "library_ms": cuda_ms(lib, flush=flush),
        }
    item = q.element_size()
    nbytes = (2 * b * sq * nh * hd + 2 * b * sk * nkv * hd) * item
    flops = 4 * hd * nh * b * visible_pairs(sq, sk, causal, window)
    set_bound(res, nbytes, flops, dtype_name)
    res["bytes"], res["flops"] = nbytes, flops
    del kh, vh, mask
    return res


def phase_flash_sweep(flush):
    import torch
    cases = [  # b, sq, sk, causal, window, dtype
        (2, 64, 64, True, None, "bfloat16"),
        (2, 127, 127, True, None, "bfloat16"),
        (2, 128, 128, True, None, "bfloat16"),
        (2, 129, 129, True, None, "bfloat16"),
        (2, 1000, 1000, True, None, "bfloat16"),
        (2, 2048, 2048, True, None, "bfloat16"),
        (2, 4096, 4096, True, None, "bfloat16"),
        (1, 129, 129, True, None, "float32"),
        (1, 1000, 1000, True, None, "float32"),
        (1, 2048, 2048, True, None, "float32"),
        (1, 1000, 1000, False, None, "bfloat16"),
        (1, 2048, 2048, False, None, "float32"),
        (2, 2048, 2048, True, 512, "bfloat16"),
        (1, 4096, 4096, True, 512, "float32"),
        (1, 1000, 1000, False, 512, "bfloat16"),
        (1, 512, 2048, True, None, "bfloat16"),
        (1, 300, 1000, True, None, "float32"),
    ]
    rows = []
    for i, (b, sq, sk, causal, window, dt) in enumerate(cases):
        gen = torch.Generator("cuda").manual_seed(100 + i)
        dtype = getattr(torch, dt)
        q = torch.randn(b, sq, NH, HD, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, sk, NKV, HD, device="cuda",
                        generator=gen).to(dtype)
        v = torch.randn(b, sk, NKV, HD, device="cuda",
                        generator=gen).to(dtype)
        r = measure_flash(q, k, v, causal, window, dt, flush)
        r.update(dtype=dt, b=b, sq=sq, sk=sk, causal=causal, window=window)
        rows.append(r)
        log(f"[kernel] flash_attention {dt} b={b} sq={sq} sk={sk} "
            f"causal={causal} window={window}: max_abs_err="
            f"{r['max_abs_err']:.3g} (tol {TOL[dt]}) ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f}"
            f" bound_ms={r['bound_ms']:.4f}"
            f" bound_share={r['bound_share']:.3f} ({r['bound_by']})")
        if not r["within_tol"]:
            fail(f"flash_attention kernel disagrees with its plain version "
                 f"({dt}, b={b}, sq={sq}, sk={sk}, causal={causal}, "
                 f"window={window}): max abs err {r['max_abs_err']}")
        del q, k, v
    return rows


# ---------------------------------------------------------------------------
# phase 10-12: SHARP training and spilled eval of full-width qwen3-0.6b
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 3
TRAIN_BUDGET = 5 * 10**9      # per virtual device
EVAL_BUDGET = 2 * 10**9       # forward-only: cut the model into 2 shards
EVAL_BATCHES = 2
SHARP_TOL = 3e-4              # tests/test_orchestrator.py's bound
TRAIN_LRS = (1e-4, 3e-4)


def train_loader(cfg, seed):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(batch_size=TRAIN_BATCH,
                                      seq_len=TRAIN_SEQ,
                                      vocab_size=cfg.vocab_size, seed=seed))


def track_ledger_peaks(session) -> dict:
    """{device id: high-water mark of used bytes} of a session's device
    ledgers, filled as the run promotes shards."""
    peak_used = {}
    for dm in session.devices:
        def charge(nbytes, *, into_buffer, dm=dm, orig=dm.charge_promotion):
            orig(nbytes, into_buffer=into_buffer)
            peak_used[dm.device_id] = max(peak_used.get(dm.device_id, 0),
                                          dm.used_bytes())
        dm.charge_promotion = charge
    return peak_used


def phase_sharp_train(cfg, budget=TRAIN_BUDGET, steps=TRAIN_STEPS, *,
                      loader=train_loader, batch=TRAIN_BATCH,
                      seq=TRAIN_SEQ, min_shards=3, unit_peaks=False):
    """Two full-width TrainJobs of ``cfg`` (seeds 0 and 1, lr 1e-4 and
    3e-4, AdamW) through the port's Session on two virtual devices of
    ``budget`` bytes each (qwen3-0.6b: 5 GB, 3 steps), ``steps`` steps of
    ``loader(cfg, seed)``'s batches (default 2 x 1024 tokens); then each
    model's plain full-model training on the card.  Gates: >=
    ``min_shards`` shards a model, units = models x steps x 2 x shards,
    the ledger never over its budget, SHARP losses equal to the
    sequential reference at 3e-4.  ``unit_peaks`` records each unit's
    allocated peak over the baseline beside its shard's analytic
    charge."""
    import numpy as np
    import torch

    from repro_torch.api import HydraConfig, Session, TrainJob
    from repro_torch.core.orchestrator import (ModelTask,
                                               train_sequential_reference)

    lrs = TRAIN_LRS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = Session(HydraConfig(n_devices=2,
                                  device_budget_bytes=budget),
                      device="cuda", profile=None)
    for seed, lr in enumerate(lrs):
        session.submit(TrainJob(cfg, loader(cfg, seed), lr=lr,
                                optimizer="adamw", epochs=1,
                                steps_per_epoch=steps, seed=seed,
                                batch=batch, seq=seq))
    plan = session.plan()
    setup_s = time.perf_counter() - t0
    peak_used = track_ledger_peaks(session)
    units = []
    if unit_peaks:
        tick = session.serve_tick

        def unit_peak():
            if len(session.unit_trace) > len(units):
                torch.cuda.synchronize()
                units.append((session.unit_trace[-1],
                              torch.cuda.max_memory_allocated() - base))
                torch.cuda.reset_peak_memory_stats()
            return tick()
        session.serve_tick = unit_peak
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    report = session.run(plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train = report.train
    execs = session.train_execs
    shards = [len(m.partition.shards) for m in execs]
    promoted = sum(s.promoted_bytes for s in train.transfer.values())
    res = {"shards": shards,
           "shard_layers": [[(s.seg_lo, s.seg_hi) for s in m.partition]
                            for m in execs],
           "losses": {int(k): v for k, v in train.losses.items()},
           "units_executed": train.units_executed,
           "virtual_makespan_s": train.makespan,
           "avg_utilization": train.avg_utilization,
           "exposed_transfer_s": train.exposed_transfer_time,
           "hidden_transfer_s": train.hidden_transfer_time,
           "setup_s": setup_s, "wall_s": wall,
           "bytes_promoted": promoted,
           "effective_h2d_gb_per_s": promoted / wall / 1e9,
           "trained_tok_per_s": len(execs) * steps * batch * seq / wall,
           "ledger_peak_bytes": peak_used,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "plan_provenance": plan.provenance,
           "plan_est_makespan_s": plan.schedule["est_makespan_s"],
           "plan_shard_bounds": [[(sh["seg_lo"], sh["seg_hi"])
                                  for sh in j.partition["shards"]]
                                 for j in plan.jobs]}
    if unit_peaks:
        m = execs[0]
        charge = {s.index: s.param_bytes + s.act_bytes
                  + m.partition.shared_bytes for s in m.partition.shards}
        res["unit_peaks"] = [{"unit": list(k), "peak": p,
                              "charge": charge[k[1]]} for k, p in units]
        for r in res["unit_peaks"]:
            log(f"[sharp] {cfg.name} unit {r['unit']}: allocated peak "
                f"{r['peak']} B over the baseline; its shard's analytic "
                f"charge {r['charge']} B")
    log(f"[sharp] 2 x {cfg.name} full width, {steps} steps of "
        f"{batch}x{seq} tokens: shards {shards} "
        f"{res['shard_layers'][0]}, units {train.units_executed}, virtual "
        f"makespan {train.makespan:.4f} s, avg utilization "
        f"{train.avg_utilization:.4f}, wall {wall:.2f} s (setup "
        f"{setup_s:.2f} s), bytes promoted {promoted} "
        f"({res['effective_h2d_gb_per_s']:.3f} GB/s over the wall), "
        f"trained {res['trained_tok_per_s']:.1f} tok/s, ledger peak "
        f"{peak_used} of {budget}, max_memory_allocated "
        f"{res['max_memory_allocated']}")
    if min(shards) < min_shards:
        fail(f"SHARP partitioned {cfg.name} into {shards} shards at a "
             f"{budget} B budget; expected at least {min_shards} a model")
    expect = len(execs) * steps * 2 * shards[0]
    if len(set(shards)) != 1 or train.units_executed != expect:
        fail(f"SHARP ran {train.units_executed} units; expected models x "
             f"steps x 2 x shards = {expect}")
    if max(peak_used.values()) > budget:
        fail(f"the device ledger went over its budget: {peak_used}")

    refs = {}
    for seed, lr in enumerate(lrs):
        _, refs[seed] = train_sequential_reference(
            ModelTask(cfg, loader(cfg, seed), lr=lr, epochs=1,
                      steps_per_epoch=steps, seed=seed,
                      batch=batch, seq=seq), device="cuda")
        torch.cuda.empty_cache()
    res["sequential_losses"] = refs
    res["max_abs_loss_diff"] = max(
        float(np.abs(np.subtract(refs[i], train.losses[i])).max())
        for i in refs)
    log(f"[sharp] losses {res['losses']}; sequential reference {refs}; "
        f"max abs diff {res['max_abs_loss_diff']:.3g} (tol {SHARP_TOL})")
    for i in refs:
        if not np.allclose(train.losses[i], refs[i], rtol=SHARP_TOL,
                           atol=SHARP_TOL):
            fail(f"model {i}: SHARP losses {train.losses[i]} differ from "
                 f"sequential training's {refs[i]}")
    return session, res


def layer0_qkv(cfg, params, batch):
    """Layer 0's roped q, k, v of ``batch`` (bf16, layer layout), as the
    eval path hands them to the flash kernel."""
    import torch

    from repro_torch.configs import torch_dtype
    from repro_torch.core.spilling import to_device
    from repro_torch.models import layers as nn
    from repro_torch.models import transformer

    with torch.no_grad():
        embed = to_device(params["embed"], "cuda")
        lp = transformer.layer_slices(params["layers"], 1)[0]
        lp = to_device({"attn_norm": lp["attn_norm"], "attn": lp["attn"]},
                       "cuda")
        x = nn.embed(embed, batch["tokens"], torch_dtype(cfg.dtype))
        q, k, v = nn._project_qkv(lp["attn"],
                                  transformer._norm(cfg, lp["attn_norm"], x),
                                  cfg)
        pos = torch.arange(x.shape[1], device="cuda")[None, :]
        return (nn.apply_rope(q, pos, cfg.rope_theta),
                nn.apply_rope(k, pos, cfg.rope_theta), v)


def phase_spilled_eval(cfg, trained, flush):
    """An EvalJob of 2 batches (2 x 1024) over model 0's trained params,
    forward-only through the shard queue, once with the flash kernel
    (attn_impl 'cuda') and once with the default plain attention.  The
    kernel must launch batches x layers times; one full forward through
    the kernel may be at most LOGIT_REL x as far from an f32 forward as
    the plain bf16 forward; and the kernel's numbers at layer 0's q/k/v
    of the first batch."""
    import torch

    from repro_torch.api import EvalJob, HydraConfig, Session
    from repro_torch.core.spilling import to_device
    from repro_torch.data.pipeline import as_tensors
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.models import api

    res = {}
    for impl in ("cuda", "xla"):
        session = Session(HydraConfig(n_devices=1,
                                      device_budget_bytes=EVAL_BUDGET),
                          device="cuda")
        session.submit(EvalJob(cfg.replace(attn_impl=impl),
                               train_loader(cfg, 10), n_batches=EVAL_BATCHES,
                               params=trained, batch=TRAIN_BATCH,
                               seq=TRAIN_SEQ))
        session.plan()                          # build stores and shards
        torch.cuda.synchronize()
        flash_attention_bhsd.launches = 0
        t0 = time.perf_counter()
        ev = session.run().evals["eval-0"]
        torch.cuda.synchronize()
        ev["wall_s"] = time.perf_counter() - t0
        ev["launches"] = flash_attention_bhsd.launches
        res[impl] = ev
        log(f"[eval] attn_impl={impl}: {ev['n_shards']} shards, losses "
            f"{ev['losses']}, mean {ev['mean_loss']:.6f}, perplexity "
            f"{ev['perplexity']:.3f}, bytes moved {ev['bytes_moved']}, wall "
            f"{ev['wall_s']:.3f} s, flash launches {ev['launches']}")
        del session
    expect = EVAL_BATCHES * cfg.n_layers
    if res["cuda"]["launches"] != expect:
        fail(f"flash_attention launched {res['cuda']['launches']} times on "
             f"the eval path; expected batches x layers = {expect}")
    if res["xla"]["launches"] != 0:
        fail("the default attn_impl launched the flash kernel")
    if res["cuda"]["n_shards"] < 2:
        fail("the eval ran unspilled (one shard)")

    batch = as_tensors(next(iter(train_loader(cfg, 10))), "cuda")
    with torch.no_grad():
        dev_params = to_device(trained, "cuda")
        cfg32 = cfg.replace(dtype="float32")
        logits = {
            "cuda": api.forward(cfg.replace(attn_impl="cuda"), dev_params,
                                batch),
            "ref": api.forward(cfg, dev_params, batch),
            "f32": api.forward(cfg32, dev_params, batch)}
    res["both_ways"] = logit_gate("one full forward (2 x 1024)", logits)
    del logits, dev_params
    torch.cuda.empty_cache()
    q, k, v = layer0_qkv(cfg, trained, batch)
    m = measure_flash(q, k, v, True, None, "bfloat16", flush)
    log(f"[kernel] flash_attention at the eval path's layer 0 q/k/v "
        f"(b {TRAIN_BATCH}, s {TRAIN_SEQ}, causal): ms={m['ms']:.4f} "
        f"plain_ms={m['plain_ms']:.4f} library_ms={m['library_ms']:.4f} "
        f"bound_ms={m['bound_ms']:.4f}"
        f" bound_share={m['bound_share']:.3f} ({m['bound_by']}) "
        f"max_abs_err={m['max_abs_err']:.3g}")
    if not m["within_tol"]:
        fail("flash_attention kernel disagrees with its plain version at "
             "the eval path's inputs")
    res["main_path_kernel"] = m
    return res


def phase_unit_profiles(session):
    """One SHARP forward unit and one backward unit of model 0's middle
    shard, each as the executor runs it (promote; forward — or backward,
    optimizer step and demote), under the profiler."""
    import torch

    from repro_torch.data.pipeline import as_tensors

    m = session.train_execs[0]
    shards = m.partition.shards
    mid = shards[len(shards) // 2]
    batch = as_tensors(next(iter(train_loader(m.cfg, 20))), "cuda")
    act = {}
    with torch.no_grad():
        for s in shards[:mid.index]:
            own, shared, _ = m.store.promote_shard(s)
            act, _ = m.fns.fwd(s)(own, shared, act, batch)
    cot = {"x": torch.full_like(act["x"], 1e-3)}
    entry = act

    def fwd_unit():
        own, shared, _ = m.store.promote_shard(mid)
        return m.fns.fwd(mid)(own, shared, entry, batch)

    def bwd_unit():
        own, shared, opt_state = m.store.promote_shard(mid)
        g_own, _, g_act = m.fns.bwd(mid)(own, shared, entry, cot, batch)
        new_own, new_opt = m.fns._step(own, g_own, opt_state)
        m.store.demote_shard(mid, new_own, new_opt)
        return g_act

    label = (f"SHARP {{}} unit, qwen3-0.6b shard {mid.index} (layers "
             f"{mid.seg_lo - 1}..{mid.seg_hi - 2}, "
             f"{m.store.shard_transfer_bytes(mid)} B promoted)")
    return {"shard": mid.index,
            "fwd": profiled(label.format("forward"), fwd_unit),
            "bwd": profiled(label.format("backward"), bwd_unit)}


# ---------------------------------------------------------------------------
# phase 13: the machine profiler and measured-cost planning
# ---------------------------------------------------------------------------

def smoke_loader(cfg, seed):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(batch_size=2, seq_len=64,
                                      vocab_size=cfg.vocab_size, seed=seed))


def phase_profiler(cfg, sharp_res):
    """``build_facts()`` on the card (every probe, full size; saved under
    build/), with the launches of the RMSNorm and SwiGLU kernels its
    kernel probe makes; phase 10's two-model session planned again with
    those facts (measured queries > 0 where phase 10's analytic plan had
    0, and the same shard boundaries); a smoke-width two-model session
    trained with and without the facts (identical losses: facts change
    estimates, never execution)."""
    import torch

    from repro_torch.api import HydraConfig, Session, TrainJob
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import rms_norm_2d
    from repro_torch.kernels.swiglu import swiglu_2d
    from repro_torch.profiler import build_facts

    counters = {"rms_norm_2d": rms_norm_2d, "swiglu_2d": swiglu_2d}
    for c in counters.values():
        c.launches = 0                   # count this path's run only
    t0 = time.perf_counter()
    facts = build_facts(device="cuda")
    res = {"build_facts_s": time.perf_counter() - t0,
           "launches": {k: c.launches for k, c in counters.items()}}
    res["path"] = facts.save(str(ROOT / "build" / "profile_facts.json"))
    res.update(transfer=facts.transfer, decode=facts.decode,
               kernels=facts.kernels, accept_rates=facts.accept_rates,
               notes=facts.notes, fingerprint=facts.fingerprint)
    log(f"[profiler] build_facts() on {facts.fingerprint['device_kind']}: "
        f"{res['build_facts_s']:.2f} s, saved to build/profile_facts.json; "
        f"kernel launches of the probe {res['launches']}")
    for d in ("h2d", "d2h"):
        log(f"[profiler] {d}: " + ", ".join(
            f"{r['bytes']} B {r['gbytes_per_s']:.3f} GB/s"
            for r in facts.transfer[d]))
    for fam in ("dense", "ssm", "hybrid"):
        if fam not in facts.decode:
            fail(f"the decode probe measured no {fam} grid: "
                 f"{facts.notes.get('decode_errors')}")
        g = facts.decode[fam]
        log(f"[profiler] {fam} decode grid ({g['arch']}, batches "
            f"{g['batches']} x seqs {g['seqs']}): decode_step_s "
            f"{g['decode_step_s']}, prefill_s_per_token "
            f"{g['prefill_s_per_token']}")
    log(f"[profiler] families whose decode probe failed: "
        f"{sorted(facts.notes.get('decode_errors', {}))}; accept probe "
        f"errors {sorted(facts.notes.get('accept_errors', {}))}")
    log(f"[profiler] accept rates: {facts.accept_rates}")
    for name, r in facts.kernels.items():
        log(f"[profiler] kernel {name}: kernel_us {r['kernel_us']:.1f} "
            f"ref_us {r['ref_us']:.1f} fallback_delta "
            f"{r['fallback_delta']:.3f} default_impl {r['default_impl']}")
    want = {"flash_attention", "rms_norm", "swiglu", "paged_attention",
            "paged_verify", "paged_attention_quant", "fused_decode_layer"}
    if set(facts.kernels) != want or any(
            r["default_impl"] != "cuda" for r in facts.kernels.values()):
        fail(f"the kernel probe's rows {sorted(facts.kernels)} are not the "
             f"seven kernels on the card")
    if min(res["launches"].values()) == 0:
        fail(f"the profiler's kernel probe launched no RMSNorm / SwiGLU "
             f"kernel: {res['launches']}")

    # phase 10's session, planned with the facts
    session = Session(HydraConfig(n_devices=2,
                                  device_budget_bytes=TRAIN_BUDGET),
                      device="cuda", profile=facts)
    for seed, lr in enumerate(TRAIN_LRS):
        session.submit(TrainJob(cfg, train_loader(cfg, seed), lr=lr,
                                optimizer="adamw", epochs=1,
                                steps_per_epoch=TRAIN_STEPS, seed=seed,
                                batch=TRAIN_BATCH, seq=TRAIN_SEQ))
    plan = session.plan()
    bounds = [[(sh["seg_lo"], sh["seg_hi"]) for sh in j.partition["shards"]]
              for j in plan.jobs]
    analytic = sharp_res["plan_provenance"]
    res["plan"] = {"n_measured": plan.provenance["n_measured"],
                   "n_analytic": plan.provenance["n_analytic"],
                   "est_makespan_s": plan.schedule["est_makespan_s"],
                   "analytic_n_measured": analytic["n_measured"],
                   "analytic_est_makespan_s":
                       sharp_res["plan_est_makespan_s"],
                   "same_shard_bounds":
                       bounds == sharp_res["plan_shard_bounds"]}
    del session, plan
    torch.cuda.empty_cache()
    pl = res["plan"]
    log(f"[profiler] phase 10's session planned with the facts: "
        f"{pl['n_measured']} measured / {pl['n_analytic']} analytic "
        f"queries (without: {pl['analytic_n_measured']} measured), "
        f"est_makespan_s {pl['est_makespan_s']} (analytic "
        f"{pl['analytic_est_makespan_s']}), same shard boundaries "
        f"{pl['same_shard_bounds']}")
    if pl["n_measured"] <= 0 or pl["analytic_n_measured"] != 0 \
            or not pl["same_shard_bounds"]:
        fail("measured-cost planning: expected measured queries with the "
             "facts, none without, and the same shard boundaries")

    # smoke-width two-model training both ways
    scfg = get_config("qwen3-0.6b", smoke=True)
    runs = []
    for profile in (None, facts):
        s = Session(HydraConfig(n_devices=2, device_budget_bytes=18 * 10**6),
                    device="cuda", profile=profile)
        for seed in (0, 1):
            s.submit(TrainJob(scfg, smoke_loader(scfg, seed), epochs=1,
                              steps_per_epoch=2, seed=seed, batch=2, seq=64))
        p = s.plan()
        runs.append((p.provenance["n_measured"],
                     {int(k): v for k, v in s.run(p).train.losses.items()}))
    res["smoke_train"] = {"n_measured": [r[0] for r in runs],
                          "losses": [r[1] for r in runs],
                          "identical": runs[0][1] == runs[1][1]}
    log(f"[profiler] smoke two-model training, analytic plan "
        f"({runs[0][0]} measured queries) vs measured plan ({runs[1][0]}): "
        f"losses {runs[0][1]} vs {runs[1][1]}, identical "
        f"{res['smoke_train']['identical']}")
    if not res["smoke_train"]["identical"] or runs[1][0] == 0:
        fail("training losses changed with the cost facts: facts may "
             "change estimates, never execution")
    return res


# ---------------------------------------------------------------------------
# phase 15: the SSD scan kernel against its plain version
# ---------------------------------------------------------------------------

SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # f32: the JAX test's MM_TOL


def distinct_bytes(t):
    """Bytes of the distinct elements a view covers: a broadcast axis
    (stride 0) counts once, as the kernel must read it once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def measure_ssd(x, log_a, b_coef, c_coef, chunk, dtype_name, flush):
    """SSD kernel vs plain chunked scan on one set of inputs: error, times,
    bound.  Least bytes: x, log_a, B, C read once (``distinct_bytes``) and
    y written once; operations: ``ssd_flops`` (the causal half of each
    chunk's products).  No one PyTorch call computes this function, so
    there is no library yardstick."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ssd_scan import ssd_flops

    with torch.no_grad():
        out = ops.ssd_scan(x, log_a, b_coef, c_coef, chunk=chunk,
                           impl="cuda")[0]
        exp = ref.ssd_chunked_ref(x, log_a, b_coef, c_coef, chunk)[0]
        torch.cuda.synchronize()
        diff = (out.float() - exp.float()).abs()
        tol = SSD_TOL[dtype_name]
        ok = bool((diff <= tol + tol * exp.float().abs()).all())
        res = {"max_abs_err": float(diff.max()),
               "max_abs_ref": float(exp.float().abs().max()),
               "within_tol": ok and bool(torch.isfinite(out).all()),
               "ms": cuda_ms(lambda: ops.ssd_scan(
                   x, log_a, b_coef, c_coef, chunk=chunk, impl="cuda"),
                   flush=flush),
               "plain_ms": cuda_ms(lambda: ref.ssd_chunked_ref(
                   x, log_a, b_coef, c_coef, chunk), iters=5, flush=flush),
               "library_ms": None}
    bsz, s, h, p = x.shape
    n = b_coef.shape[-1]
    nbytes = sum(distinct_bytes(t) for t in (x, log_a, b_coef, c_coef)) \
        + x.numel() * x.element_size()
    flops = ssd_flops(bsz, s, h, p, n, chunk)
    set_bound(res, nbytes, flops, dtype_name)
    res["bytes"], res["flops"] = nbytes, flops
    del out, exp, diff
    return res


def ssd_inputs(b, s, h, p, n, dtype, seed, broadcast=False, log_a=None):
    """The reference tests' scales (x ~ N(0,1), log decay -|N(0,1)|·0.1,
    B and C ~ N(0,1)·0.3), made on the card from ``seed``; ``broadcast``
    expands one B/C group over the heads (head stride 0, the Mamba2
    block's layout); ``log_a`` pins every decay to one value."""
    import torch
    gen = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x = randn(b, s, h, p).to(dtype)
    la = (-randn(b, s, h).abs() * 0.1 if log_a is None
          else torch.full((b, s, h), float(log_a), device="cuda"))
    hb = 1 if broadcast else h
    bc = (randn(b, s, hb, n) * 0.3).to(dtype)
    cc = (randn(b, s, hb, n) * 0.3).to(dtype)
    if broadcast:
        bc, cc = bc.expand(b, s, h, n), cc.expand(b, s, h, n)
    return x, la, bc, cc


def phase_ssd_sweep(flush):
    """zamba2's Mamba2 (b 1, 2; s 256, 1024, 4096; h 64, p = n = 64, chunk
    256; B/C broadcast and contiguous), xlstm-350m's mLSTM (b 1, s 1024,
    h 4, p = n = 512), the four shapes of tests/test_kernels.py, and the
    decay edges (log_a = 0 and -30 per step), in bf16 and f32."""
    import torch
    cases = []          # b, s, h, p, n, chunk, broadcast, log_a
    for b in (1, 2):
        for s in (256, 1024, 4096):
            for bc in (True, False):
                cases.append((b, s, 64, 64, 64, 256, bc, None))
    cases.append((1, 1024, 4, 512, 512, 256, False, None))
    cases += [(2, 256, 2, 16, 8, 64, False, None),
              (1, 128, 4, 64, 32, 32, False, None),
              (1, 64, 1, 8, 8, 64, False, None),
              (2, 96, 2, 32, 16, 32, False, None)]
    cases += [(1, 1024, 64, 64, 64, 256, True, 0.0),
              (1, 1024, 64, 64, 64, 256, True, -30.0)]
    rows = []
    for dt in ("bfloat16", "float32"):
        for i, (b, s, h, p, n, chunk, bc, la) in enumerate(cases):
            x, lg, bm, cm = ssd_inputs(b, s, h, p, n, getattr(torch, dt),
                                       300 + i, broadcast=bc, log_a=la)
            r = measure_ssd(x, lg, bm, cm, chunk, dt, flush)
            r.update(dtype=dt, b=b, s=s, h=h, p=p, n=n, chunk=chunk,
                     broadcast=bc, log_a=la)
            rows.append(r)
            log(f"[kernel] ssd_scan {dt} b={b} s={s} h={h} p={p} n={n} "
                f"chunk={chunk} broadcast_bc={bc} log_a={la}: max_abs_err="
                f"{r['max_abs_err']:.3g} (tol {SSD_TOL[dt]} rel+abs, max "
                f"|ref| {r['max_abs_ref']:.3g}) ms={r['ms']:.4f} plain_ms="
                f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f}"
                f" bound_share={r['bound_share']:.3f} "
                f"({r['bound_by']})")
            if not r["within_tol"]:
                fail(f"ssd_scan kernel disagrees with its plain version "
                     f"({dt}, b={b}, s={s}, h={h}, p={p}, n={n}, chunk="
                     f"{chunk}, broadcast={bc}, log_a={la}): max abs err "
                     f"{r['max_abs_err']}")
            del x, lg, bm, cm
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 16: full-width zamba2-1.2b — serve, spilled eval, kernel forward,
# SHARP, small f32 engine
# ---------------------------------------------------------------------------

Z_GEN, Z_CAPACITY, Z_REQUESTS = 16, 8, 8
Z_TRAIN_BUDGET = 8 * 10**9    # per virtual device: 3 shards a model
Z_TRAIN_STEPS = 2


def zamba_prompts(vocab, seed=0):
    """8 prompts of 16..128 tokens (numpy seed 0)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 129, Z_REQUESTS)
    return [rng.integers(0, vocab, int(n), dtype=np.int32) for n in lens]


def phase_zamba_serve(cfg, params, prompts):
    """Full-width zamba2 through ``InferenceEngine`` (slot backend): every
    request gets exactly Z_GEN tokens; decode and prefill tok/s; one
    decode step over the final pool state profiled; ``backend="paged"``
    falls back to slot with a CapabilityFallbackWarning."""
    import warnings

    import torch

    from repro_torch.models import api
    from repro_torch.models.registry import CapabilityFallbackWarning
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.tree import tree_map

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        peng = InferenceEngine(cfg, params, capacity=1, max_seq=32,
                               backend="paged", device="cuda")
    s = peng.summary()
    fell_back = (any(issubclass(w.category, CapabilityFallbackWarning)
                     for w in caught)
                 and (s["backend"], s["requested_backend"])
                 == ("slot", "paged"))
    del peng
    if not fell_back:
        fail("zamba2: backend='paged' did not fall back to slot with a "
             "CapabilityFallbackWarning")
    warm = InferenceEngine(cfg, params, capacity=2, max_seq=32,
                           device="cuda")
    for p in prompts[:2]:
        warm.submit(p[:8], 2)
    warm.run()
    del warm
    torch.cuda.empty_cache()

    max_seq = max(len(p) for p in prompts) + Z_GEN
    eng = InferenceEngine(cfg, params, capacity=Z_CAPACITY, max_seq=max_seq,
                          device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(p, Z_GEN, request_id=f"z{i}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = eng.summary()
    done = {r.request_id: r for r in eng.completed}
    if len(done) != len(prompts):
        fail(f"zamba2 serve: served {len(done)} of {len(prompts)} requests")
    for rid, r in done.items():
        if len(r.generated) != Z_GEN or r.status.value != "finished":
            fail(f"zamba2 serve {rid}: {len(r.generated)} tokens, status "
                 f"{r.status}")
    res = {"requests": len(done), "gen": Z_GEN, "wall_s": wall,
           "fell_back_from_paged": fell_back,
           "prompt_lens": [len(p) for p in prompts],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **{k: summary.get(k) for k in (
               "backend", "slot_bytes", "decode_steps", "prefill_calls",
               "prefill_tok_per_s", "decode_tok_per_s", "kv_peak_bytes",
               "peak_concurrency")},
           "prefill_s": eng.prefill_s, "decode_s": eng.decode_s,
           "tokens": {rid: r.generated for rid, r in done.items()}}
    log(f"[zamba2 serve] full width (38 Mamba2 layers, 6 shared-block "
        f"sites): {res['requests']} requests x {Z_GEN} tokens, prompts "
        f"{res['prompt_lens']}, prefill {res['prefill_tok_per_s']} tok/s "
        f"(token by token), decode {res['decode_tok_per_s']} tok/s, "
        f"decode_steps {res['decode_steps']}, prefill_calls "
        f"{res['prefill_calls']}, slot_bytes {res['slot_bytes']}, wall "
        f"{wall:.2f} s, max_memory_allocated {res['max_memory_allocated']}"
        f"; paged request fell back to slot: {fell_back}")
    state = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                     else t, eng.pool.state)
    toks = torch.zeros((Z_CAPACITY, 1), dtype=torch.long, device="cuda")
    res["profile"] = profiled(
        "zamba2 one decode step (8 lanes)",
        lambda: api.decode_step(cfg, eng.params, state, toks))
    del eng, state
    torch.cuda.empty_cache()
    return res


def hybrid_site0_qkv(cfg, params, batch):
    """The roped q, k, v the shared block's first invocation site computes
    for ``batch`` (bf16, layer layout): embed, the Mamba2 layers up to the
    first flagged one, the shared block's attention norm and projection."""
    import numpy as np
    import torch

    from repro_torch.configs import torch_dtype
    from repro_torch.models import hybrid
    from repro_torch.models import layers as nn
    from repro_torch.models.transformer import layer_slices

    first = int(np.argmax(hybrid.attn_flags(cfg)))
    sp = params["shared_attn"]
    with torch.no_grad():
        x = nn.embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
        for lp in layer_slices(params["layers"], first + 1):
            x = hybrid.apply_layer(cfg, lp, x, sp, False)
        q, k, v = nn._project_qkv(sp["attn"],
                                  nn.rms_norm(sp["attn_norm"], x), cfg)
        pos = torch.arange(x.shape[1], device="cuda")[None, :]
        return (nn.apply_rope(q, pos, cfg.rope_theta),
                nn.apply_rope(k, pos, cfg.rope_theta), v)


def plan_forward(cfg, params, batch, use_kernel):
    """One forward composed of the hybrid shard plan's segments (embed,
    38 layer segments, head), each Mamba2 layer through
    ``mamba2_forward(use_kernel=...)`` as ``_hybrid_plan``'s layer apply
    would run with the switch on."""
    import torch

    from repro_torch.core import shard_graph as sg
    from repro_torch.models import hybrid

    plan = sg.build_plan(cfg)
    flags = hybrid.attn_flags(cfg)
    act = {}
    with torch.no_grad():
        for seg in plan.segments:
            apply = seg.apply
            if seg.name.startswith("mamba"):
                i = int(seg.name[len("mamba"):])
                apply = sg.hybrid_layer_apply(bool(flags[i]),
                                              use_kernel=use_kernel)
            own = sg.resolve_ref(params, seg.param_ref)
            shared = {n: sg.resolve_ref(params, plan.shared_refs[n])
                      for n in seg.shared}
            act = apply(cfg, own, shared, act, batch)
    return act["logits"]


def phase_zamba_eval(cfg, params, flush):
    """(b) An EvalJob of 2 batches (2 x 1024) through the shard queue,
    with the flash kernel (attn_impl 'cuda') and with plain attention: the
    flash kernel must launch batches x 6 times; one flash call at the
    shared block's shape (its first site's q/k/v) against its plain
    version.  (c) One forward of the eval batch composed as the hybrid
    plan's segments with every Mamba2 scan through the SSD kernel: 38
    launches exactly, and its logits at most LOGIT_REL x as far from an
    f32 forward as the plain bf16 forward's; the kernel's numbers at layer
    0's scan inputs of that batch."""
    import torch

    from repro_torch.api import EvalJob, HydraConfig, Session
    from repro_torch.data.pipeline import as_tensors
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.ssd_scan import ssd_scan_bshpn
    from repro_torch.models import hybrid, ssm
    from repro_torch.models import layers as nn
    from repro_torch.models.transformer import layer_slices

    sites = hybrid.n_attn_invocations(cfg)
    res = {}
    for impl in ("cuda", "xla"):
        session = Session(HydraConfig(n_devices=1,
                                      device_budget_bytes=EVAL_BUDGET),
                          device="cuda", profile=None)
        session.submit(EvalJob(cfg.replace(attn_impl=impl),
                               train_loader(cfg, 10), n_batches=EVAL_BATCHES,
                               params=params, batch=TRAIN_BATCH,
                               seq=TRAIN_SEQ))
        session.plan()
        torch.cuda.synchronize()
        flash_attention_bhsd.launches = 0
        t0 = time.perf_counter()
        ev = session.run().evals["eval-0"]
        torch.cuda.synchronize()
        ev["wall_s"] = time.perf_counter() - t0
        ev["launches"] = flash_attention_bhsd.launches
        res[impl] = ev
        log(f"[zamba2 eval] attn_impl={impl}: {ev['n_shards']} shards, "
            f"losses {ev['losses']}, mean {ev['mean_loss']:.6f}, perplexity "
            f"{ev['perplexity']:.3f}, bytes moved {ev['bytes_moved']}, wall "
            f"{ev['wall_s']:.3f} s, flash launches {ev['launches']}")
        del session
        torch.cuda.empty_cache()
    if res["cuda"]["launches"] != EVAL_BATCHES * sites:
        fail(f"zamba2 eval: flash_attention launched "
             f"{res['cuda']['launches']} times; expected batches x sites = "
             f"{EVAL_BATCHES * sites}")
    if res["xla"]["launches"] != 0:
        fail("zamba2 eval: the default attn_impl launched the flash kernel")
    if res["cuda"]["n_shards"] < 2:
        fail("zamba2 eval ran unspilled (one shard)")

    batch = as_tensors(next(iter(train_loader(cfg, 10))), "cuda")
    q, k, v = hybrid_site0_qkv(cfg, params, batch)
    m = measure_flash(q, k, v, True, None, "bfloat16", flush)
    log(f"[kernel] flash_attention at the shared block's first site "
        f"(b {TRAIN_BATCH}, s {TRAIN_SEQ}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads of {cfg.head_dim}, causal): ms={m['ms']:.4f} plain_ms="
        f"{m['plain_ms']:.4f} library_ms={m['library_ms']:.4f} bound_ms="
        f"{m['bound_ms']:.4f} bound_share={m['bound_share']:.3f} "
        f"({m['bound_by']}) max_abs_err="
        f"{m['max_abs_err']:.3g}")
    if not m["within_tol"]:
        fail("flash_attention kernel disagrees with its plain version at "
             "the shared block's shape")
    res["flash_hybrid_shape"] = m
    del q, k, v

    # (c) the forward through the SSD kernel, gated both ways
    torch.cuda.synchronize()
    ssd_scan_bshpn.launches = 0
    t0 = time.perf_counter()
    kernel_logits = plan_forward(cfg, params, batch, True)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = ssd_scan_bshpn.launches
    logits = {"cuda": kernel_logits,
              "ref": plan_forward(cfg, params, batch, False),
              "f32": plan_forward(cfg.replace(dtype="float32"), params,
                                  batch, False)}
    log(f"[zamba2 kernel forward] every Mamba2 scan through ssd_scan_bshpn: "
        f"{launches} launches, forward {fwd_s:.3f} s")
    if launches != cfg.n_layers:
        fail(f"ssd_scan_bshpn launched {launches} times in the kernel "
             f"forward; expected one per Mamba2 layer = {cfg.n_layers}")
    res["kernel_forward"] = {"launches": launches, "wall_s": fwd_s,
                             **logit_gate("zamba2 forward through the SSD "
                                          "kernel (2 x 1024)", logits)}
    del logits, kernel_logits
    torch.cuda.empty_cache()
    with torch.no_grad():
        lp = layer_slices(params["layers"], 1)[0]
        x = nn.embed(params["embed"], batch["tokens"], torch.bfloat16)
        xdt, la, bc, cc, _, _ = ssm.mamba2_scan_inputs(
            lp["mamba"], nn.rms_norm(lp["norm"], x), cfg)
    m = measure_ssd(xdt, la, bc, cc, cfg.ssm_chunk, "bfloat16", flush)
    log(f"[kernel] ssd_scan at the kernel forward's layer 0 inputs (b "
        f"{TRAIN_BATCH}, s {TRAIN_SEQ}, h {xdt.shape[2]}, p {xdt.shape[3]}, "
        f"n {bc.shape[3]}, B/C broadcast): ms={m['ms']:.4f} plain_ms="
        f"{m['plain_ms']:.4f} bound_ms={m['bound_ms']:.4f}"
        f" bound_share={m['bound_share']:.3f} "
        f"({m['bound_by']}) max_abs_err={m['max_abs_err']:.3g}")
    if not m["within_tol"]:
        fail("ssd_scan kernel disagrees with its plain version at the "
             "kernel forward's inputs")
    res["main_path_kernel"] = m
    return res


def phase_small_hybrid_f32():
    """A small float32 zamba2 engine (smoke width): lanes at different
    positions in one pooled step give each request the tokens it gets
    decoded alone."""
    return small_slot_f32("zamba2-1.2b", 5)


def small_slot_f32(arch, seed):
    """A small float32 slot engine of ``arch`` (smoke width), 3 lanes
    joining one tick apart: each request gets the tokens it gets decoded
    alone."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config(arch, smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                             "cuda")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (5, 17, 9, 12)]
    same = pooled_vs_alone(cfg, params, prompts, f"{arch} smoke engine")
    return {"requests": len(prompts), "identical": same}


def pooled_vs_alone(cfg, params, prompts, label, **engine_kw):
    """An f32 engine of ``cfg`` (``engine_kw`` picks its backend), 3 lanes
    joining one tick apart: how many requests get the tokens they get
    decoded alone; fails unless all do."""
    from repro_torch.serving.engine import InferenceEngine

    def serve(ps, capacity):
        eng = InferenceEngine(cfg, params, capacity=capacity, max_seq=40,
                              device="cuda", **engine_kw)
        pending = list(enumerate(ps))
        while pending or eng.has_work():
            for i, p in pending[:1]:
                eng.submit(p, 10, request_id=f"h{i}")
            pending = pending[1:]
            eng.step()
        eng.run()
        return {r.request_id: r.generated for r in eng.completed}

    pooled = serve(prompts, 3)
    alone = {f"h{i}": serve([p], 1)["h0"] for i, p in enumerate(prompts)}
    same = sum(pooled.get(k) == alone[k] for k in alone)
    log(f"[small f32] {label}, 3 lanes joining one tick apart: {same} of "
        f"{len(alone)} requests token-identical to decoding alone")
    if same != len(alone):
        fail(f"{label} (f32): pooled lanes at different positions did not "
             "give the tokens each request gets alone")
    return same


# ---------------------------------------------------------------------------
# phase 17: training and serving in one Session (the serve half of Session)
# ---------------------------------------------------------------------------

COLD_REQUESTS = 4


def phase_session_serve(cfg, ref_losses, ref_tokens, facts_path):
    """One port ``Session`` on the card at full width: phase 10's first
    TrainJob (seed 0, lr 1e-4, 3 steps of 2 x 1024) beside a hot paged
    ServeJob (seed 0, the phase-4 requests; its pages charge the session's
    device-0 ledger) and a cold slot ServeJob (seed 1, 4 of those prompts;
    promoted out of the host store by its first request).  The budget is
    ``TRAIN_BUDGET`` plus the hot job's worst-case page cap, so the train
    partition is phase 10's.  Gates: the plan round-trips through JSON and
    runs; every request gets GEN tokens; a serve tick falls between two
    shard units; the losses equal ``ref_losses`` (phase 10's first model)
    at 3e-4; the paged kernel launches decode_steps x layers times; the
    ledger stays within its budget and its cap and ends at 0 reserved; the
    cold job's promotion is accounted; a small f32 session is
    token-identical to bare engines; ``profiler --smoke`` runs in process
    with the facts at ``facts_path``.  The hot tokens against
    ``ref_tokens`` (phase 4) are reported, not gated (bf16)."""
    import numpy as np
    import torch

    from repro_torch.api import HydraConfig, Plan, ServeJob, Session, TrainJob
    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.models.registry import spec as family_spec
    from repro_torch.serving.paging import blocks_for_rows

    smi = nvidia_smi_line()
    prompts = serve_prompts(cfg.vocab_size)
    max_seq = max(len(p) for p in prompts) + GEN
    cap = (CAPACITY * blocks_for_rows(max_seq, BS)
           * family_spec(cfg).kv_block_bytes(cfg, BS))
    budget = TRAIN_BUDGET + cap
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    session = Session(HydraConfig(n_devices=1, device_budget_bytes=budget),
                      device="cuda", profile=None)
    tid = session.submit(TrainJob(cfg, train_loader(cfg, 0),
                                  lr=TRAIN_LRS[0], optimizer="adamw",
                                  epochs=1, steps_per_epoch=TRAIN_STEPS,
                                  seed=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ))
    hot = session.submit(ServeJob(cfg, seed=0, name=cfg.name,
                                  capacity=CAPACITY, max_seq=max_seq,
                                  backend="paged", block_size=BS))
    cold = session.submit(ServeJob(cfg, seed=1, name=f"{cfg.name}-cold",
                                   capacity=COLD_REQUESTS, max_seq=max_seq,
                                   cold=True))
    plan = session.plan()
    text = plan.to_json()
    replan = Plan.from_json(text)
    mem = plan.schedule["memory"]
    hmeta, cmeta = plan.job(hot).meta, plan.job(cold).meta
    bounds = [(sh["seg_lo"], sh["seg_hi"])
              for sh in plan.job(tid).partition["shards"]]
    res = {"budget_bytes": budget, "kv_cap_from_code": cap, "memory": mem,
           "plan_json_bytes": len(text),
           "round_trip": replan.to_json() == text,
           "hot_meta": {k: hmeta.get(k) for k in (
               "backend", "capabilities", "kv_page_cap_bytes", "block_bytes",
               "max_blocks_per_request", "shared_ledger")},
           "cold_meta": {k: cmeta.get(k) for k in ("backend", "cold")},
           "train_shard_bounds": bounds,
           "poll_before": session.poll(cold)}
    log(f"[session] plan: memory split {mem}; hot meta {res['hot_meta']}; "
        f"cold meta {res['cold_meta']}; train shards {bounds}; plan JSON "
        f"{len(text)} B, round trip {res['round_trip']} ({smi})")
    if not res["round_trip"] or hmeta["backend"] != "paged" \
            or hmeta["capabilities"] != family_spec(cfg).capabilities() \
            or hmeta["kv_page_cap_bytes"] != cap \
            or mem["serve_kv_page_cap_bytes"] != cap \
            or cmeta["cold"] is not True:
        fail("session plan: JSON round trip, the hot job's paged meta "
             "(backend, capabilities, kv_page_cap_bytes = the code's cap) "
             "or the cold job's cold meta is wrong")
    if plan.job(tid).partition["budget_bytes"] != TRAIN_BUDGET:
        fail(f"the train partition was cut against "
             f"{plan.job(tid).partition['budget_bytes']} B, not the "
             f"budget minus the KV cap ({TRAIN_BUDGET})")
    if res["poll_before"].get("promoted") is not False:
        fail(f"the cold job is promoted before any request: "
             f"{res['poll_before']}")

    hot_reqs = [session.submit_request(hot, p, GEN, request_id=f"r{i}")
                for i, p in enumerate(prompts)]
    cold_reqs = [session.submit_request(cold, p, GEN, request_id=f"c{i}")
                 for i, p in enumerate(prompts[:COLD_REQUESTS])]
    res["poll_after_submit"] = {k: v for k, v in session.poll(cold).items()
                                if k != "recent_requests"}

    dm = session.devices[0]
    peak = {"used": 0, "kv": 0}

    def watch(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            peak["used"] = max(peak["used"], dm.used_bytes())
            peak["kv"] = max(peak["kv"], dm.kv_reserved_bytes)
            return out
        return wrapped
    dm.charge_promotion = watch(dm.charge_promotion)
    dm.reserve_kv = watch(dm.reserve_kv)
    ticks = []                       # (units done, serve ticks) per tick
    tick = session.serve_tick

    def traced_tick():
        ticks.append((len(session.unit_trace), len(session.serve_trace)))
        return tick()
    session.serve_tick = traced_tick

    torch.cuda.synchronize()
    paged_attention_lanes.launches = 0   # count this path's run only
    t0 = time.perf_counter()
    report = session.run(replan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention_lanes.launches
    units = report.train.units_executed
    between = [(u, t) for u, t in ticks if 0 < u < units]
    hrec, crec = report.serve[hot], report.serve[cold]
    losses = report.train.losses[0]
    res.update(
        wall_s=wall, units=units, serve_ticks=len(report.serve_trace),
        ticks_between_units=len(between),
        first_ticks_between=between[:4],
        unit_trace_head=[list(k) for k in report.unit_trace[:4]],
        serve_trace_head=report.serve_trace[:8],
        losses=losses, ref_losses=ref_losses,
        max_abs_loss_diff=float(np.abs(np.subtract(losses,
                                                   ref_losses)).max()),
        launches=launches, hot_decode_steps=hrec["decode_steps"],
        ledger_peak_used_bytes=peak["used"],
        ledger_kv_peak_bytes=dm.kv_peak_bytes,
        ledger_kv_reserved_after=dm.kv_reserved_bytes,
        promote_bytes=crec["promote_bytes"], promote_s=crec["promote_s"],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        hot={k: hrec.get(k) for k in (
            "decode_tok_per_s", "prefill_tok_per_s", "decode_steps",
            "prefill_calls", "kv_page_peak_bytes", "shared_block_hits",
            "cow_copies", "peak_concurrency", "paged_impl")},
        cold={k: crec.get(k) for k in (
            "decode_tok_per_s", "prefill_tok_per_s", "decode_steps",
            "prefill_calls", "backend", "slot_bytes")})
    shard_bytes = sum(
        session._cold[cold]["store"].shard_transfer_bytes(s, train=False)
        for s in session._cold[cold]["partition"].shards)
    res["promote_gb_per_s"] = (crec["promote_bytes"] / crec["promote_s"]
                               / 1e9 if crec["promote_s"] else None)
    hot_tokens = {r.request_id: list(r.generated) for r in hot_reqs}
    res["hot_identical_to_phase4"] = sum(
        hot_tokens[k] == list(v) for k, v in ref_tokens.items()
        if k in hot_tokens)
    log(f"[session] train + hot paged + cold slot serve, {cfg.name} full "
        f"width: run wall {wall:.2f} s; {units} shard units, "
        f"{len(report.serve_trace)} serve ticks, {len(between)} of them "
        f"between two shard units (first (units done, ticks before): "
        f"{between[:4]}); unit trace head {res['unit_trace_head']}, serve "
        f"trace head {res['serve_trace_head']} ({smi})")
    log(f"[session] hot {cfg.name}: decode {res['hot']['decode_tok_per_s']}"
        f" tok/s, prefill {res['hot']['prefill_tok_per_s']} tok/s, "
        f"{res['hot']['decode_steps']} decode steps, paged kernel launches "
        f"{launches}; cold {cfg.name}-cold: decode "
        f"{res['cold']['decode_tok_per_s']} tok/s, promotion "
        f"{crec['promote_bytes']} B in {crec['promote_s']} s "
        f"({res['promote_gb_per_s']} GB/s); hot tokens identical to phase "
        f"4 for {res['hot_identical_to_phase4']} of {len(ref_tokens)} "
        f"requests (bf16: reported, not gated) ({smi})")
    log(f"[session] losses {losses} vs phase 10 {ref_losses} (max abs diff "
        f"{res['max_abs_loss_diff']:.3g}, tol {SHARP_TOL}); ledger: peak "
        f"used {peak['used']} of {budget} B, kv peak {dm.kv_peak_bytes} "
        f"of cap {cap} B, kv reserved after the drain "
        f"{dm.kv_reserved_bytes}; max_memory_allocated "
        f"{res['max_memory_allocated']} ({smi})")
    for r in hot_reqs + cold_reqs:
        if len(r.generated) != GEN or r.status.value != "finished":
            fail(f"session serve {r.request_id}: {len(r.generated)} tokens, "
                 f"status {r.status}")
    if not between:
        fail("no serve tick fell between two shard units of the training")
    if not np.allclose(losses, ref_losses, rtol=SHARP_TOL, atol=SHARP_TOL):
        fail(f"training beside serving changed the losses: {losses} vs "
             f"phase 10's {ref_losses}")
    if launches != hrec["decode_steps"] * cfg.n_layers or launches == 0:
        fail(f"paged_attention launched {launches} times in the session; "
             f"expected decode_steps x layers = "
             f"{hrec['decode_steps'] * cfg.n_layers}")
    if dm.kv_peak_bytes > cap or peak["used"] > budget \
            or dm.kv_reserved_bytes != 0 or dm.kv_peak_bytes == 0:
        fail(f"the session ledger: kv peak {dm.kv_peak_bytes} (cap {cap}), "
             f"peak used {peak['used']} (budget {budget}), kv reserved "
             f"after the drain {dm.kv_reserved_bytes}")
    if crec["promote_bytes"] != shard_bytes or shard_bytes <= 0 \
            or crec.get("promote_s") is None \
            or res["poll_after_submit"].get("promoted") is not True:
        fail(f"cold promotion: promote_bytes {crec['promote_bytes']} vs "
             f"the shards' {shard_bytes}, promote_s {crec.get('promote_s')}, "
             f"poll {res['poll_after_submit']}")
    del session, report, hot_reqs, cold_reqs
    torch.cuda.empty_cache()

    res["small_f32"] = phase_small_session_f32()
    res["profile_smoke"] = phase_profile_smoke(facts_path)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[session] phase wall {res['phase_s']:.2f} s ({smi})")
    return res


def phase_small_session_f32():
    """A small float32 session on the card: a paged and a spec-over-paged
    ServeJob give the tokens of bare float32 engines built alike."""
    import numpy as np
    import torch

    from repro_torch.api import HydraConfig, ServeJob, Session
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(3),
                             "cuda")
    draft = api.init_params(cfg, torch.Generator("cuda").manual_seed(7),
                            "cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (5, 17, 32, 9)]
    jobs = {"paged": dict(backend="paged"),
            "spec": dict(backend="spec", spec_inner="paged",
                         draft_model=cfg, draft_params=draft, draft_k=3)}
    session = Session(HydraConfig(n_devices=1,
                                  device_budget_bytes=18 * 10**6),
                      device="cuda", profile=None)
    reqs = {}
    for name, kw in jobs.items():
        session.submit(ServeJob(cfg, params=params, name=name, capacity=2,
                                max_seq=64, block_size=8, **kw))
        reqs[name] = [session.submit_request(name, p, 12) for p in prompts]
    session.drain_serving()
    res = {"verify_impl": session.engine("spec").backend.verify_impl,
           "paged_impl": session.engine("paged").paged_impl}
    for name, kw in jobs.items():
        kw = dict(kw)
        if name == "spec":
            kw = dict(backend="spec", spec_inner="paged", draft_cfg=cfg,
                      draft_params=draft, draft_k=3)
        eng = InferenceEngine(cfg, params, capacity=2, max_seq=64,
                              block_size=8, device="cuda", **kw)
        bare = [eng.submit(p, 12) for p in prompts]
        eng.run()
        res[name] = ([list(r.generated) for r in reqs[name]]
                     == [list(r.generated) for r in bare])
    res["ledger_kv_reserved_after"] = session.devices[0].kv_reserved_bytes
    log(f"[session] small f32 session vs bare f32 engines, tokens "
        f"identical: paged (impl {res['paged_impl']}) {res['paged']}, spec "
        f"over paged (verify {res['verify_impl']}) {res['spec']}; ledger "
        f"kv reserved after {res['ledger_kv_reserved_after']}")
    if not (res["paged"] and res["spec"]) or res["paged_impl"] != "cuda" \
            or res["verify_impl"] != "cuda" \
            or res["ledger_kv_reserved_after"] != 0:
        fail("small f32 session: the session's paged / spec jobs did not "
             "give the bare engines' tokens through the kernels")
    return res


def phase_profile_smoke(facts_path):
    """``python -m repro_torch.profiler --smoke`` in process on the card,
    with the facts phase 13 measured (saved at ``facts_path``)."""
    from repro_torch.profiler import MachineFacts
    from repro_torch.profiler.__main__ import _smoke

    facts = MachineFacts.load(facts_path)
    rec = _smoke(facts_path, device="cuda", facts=facts)
    log(f"[session] profiler --smoke on the card with phase 13's facts: "
        f"{rec['analytic_queries_a']} analytic queries vs "
        f"{rec['measured_queries_b']} measured, provenance differs "
        f"{rec['provenance_differs']}, tokens identical "
        f"{rec['tokens_identical']}, est_makespan_s "
        f"{rec['est_makespan_analytic_s']} vs "
        f"{rec['est_makespan_measured_s']}")
    if not (rec["ok"] and rec["tokens_identical"]
            and rec["provenance_differs"]):
        fail("profiler --smoke: the measured plan changed the tokens or "
             "cited no facts")
    return rec


# ---------------------------------------------------------------------------
# phase 18: the paper's Fig 8 — bert-large-1b under SHARP against model,
# pipeline and task parallelism
# ---------------------------------------------------------------------------

FIG8_MODELS, FIG8_STEPS, FIG8_BATCH, FIG8_SEQ = 12, 2, 2, 512
FIG8_LRS = (1e-3, 1e-4, 1e-5, 1e-6)     # benchmarks/common.py's grid
FIG8_DEVICES = 8
FIG8_BUDGET = 11 * 10**9                # HydraConfig's default (RTX 2080 Ti)
FIG8_ROOMY_BUDGET = 80 * 10**9          # a device one whole model fits


def mem_available_bytes() -> int:
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    fail("/proc/meminfo has no MemAvailable line")


def settled_mem_available(timeout_s: float = 30.0) -> int:
    """MemAvailable once it stops rising: freed pinned memory comes back
    to the system over seconds (about 5 GB/s on the one-card H100
    machine), not when the host cache is emptied."""
    t0, last = time.perf_counter(), mem_available_bytes()
    while time.perf_counter() - t0 < timeout_s:
        time.sleep(0.5)
        now = mem_available_bytes()
        if now - last < 2**26:
            return now
        last = now
    return last


def empty_host_cache() -> bool:
    """Hand the pinned blocks that PyTorch's host allocator caches (the
    freed host stores of earlier phases) back to the system; False where
    this PyTorch has no call for it."""
    import torch
    fn = (getattr(torch._C, "_host_emptyCache", None)
          or getattr(torch._C, "_accelerator_emptyHostCache", None))
    if fn is None:
        return False
    fn()
    return True


def h2d_gb_per_s(nbytes: int = 2**30) -> float:
    """Host-to-device copy rate from pinned memory, by CUDA events."""
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), iters=5)
    del src, dst
    return nbytes / (ms / 1e3) / 1e9


def fig8_loader(cfg, seed):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(batch_size=FIG8_BATCH,
                                      seq_len=FIG8_SEQ,
                                      vocab_size=cfg.vocab_size, seed=seed))


def fig8_model_count(store_bytes: int, avail: int) -> int:
    """12 when twelve host stores fit in half of ``avail``, else the
    largest count >= 2 that does (0 when not even two do)."""
    n = FIG8_MODELS
    while n >= 2 and n * store_bytes > avail // 2:
        n -= 1
    return n if n >= 2 else 0


def phase_fig8(smi):
    """The paper's Fig 8 on the card: ``benchmarks/bench_end_to_end.py``'s
    workload at full width.  Up to 12 ``TrainJob``s of bert-large-1b
    (seeds 0.., the grid's learning rates 1e-3..1e-6 in turn, AdamW, 2
    steps of 2 x 512 tokens) train through the port's SHARP executor on 8
    virtual devices of the paper's 11e9 B, one unit at a time on the one
    card; the pilot's measured unit runtimes are then replayed under
    model, pipeline and task parallelism (``core/baselines.py``).  Both
    sides are virtual timelines over the same unit runtimes; SHARP's also
    holds transfers modelled at ``link_bw``, set to this card's measured
    pinned host-to-device rate, and the baselines hold none.  The host
    store holds f32 params and two Adam moments of every model (12 bytes
    a parameter, pinned): fewer than 12 models run when 12 stores do not
    fit in half of ``MemAvailable``, and the line says so.  Gates: units
    = models x steps x 2 x shards; no ledger over its budget; every loss
    finite; model 0's losses equal plain full-model training on the card
    at 3e-4; ``task_parallel`` raises ``MemoryError`` at 11e9 B and
    replays at 80e9 B; pipeline <= model parallelism; every utilisation
    in (0, 1]; SHARP's makespan below model parallelism's."""
    import numpy as np
    import torch

    from repro_torch.api import HydraConfig, Session, TrainJob
    from repro_torch.configs import get_config
    from repro_torch.core import baselines as bl
    from repro_torch.core.orchestrator import (ModelTask,
                                               train_sequential_reference)
    from repro_torch.core.partitioner import tree_bytes
    from repro_torch.models import api

    t_phase = time.perf_counter()
    cfg = get_config("bert-large-1b")
    p0 = api.init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    param_bytes = tree_bytes(p0)
    del p0
    gc.collect()
    torch.cuda.empty_cache()
    avail_before = mem_available_bytes()
    host_cache_emptied = empty_host_cache()
    t0 = time.perf_counter()
    avail = settled_mem_available()
    settle_s = time.perf_counter() - t0
    store_bytes = 3 * param_bytes          # f32 params + two Adam moments
    n = fig8_model_count(store_bytes, avail)
    if n == 0:
        fail(f"fig8: one bert-large-1b host store is {store_bytes} B; two "
             f"do not fit in half of MemAvailable ({avail} B)")
    reduction = ("none: 12 models" if n == FIG8_MODELS else
                 f"{n} of 12 models: 12 host stores need "
                 f"{FIG8_MODELS * store_bytes} B, more than half of "
                 f"MemAvailable {avail} B; {n} need {n * store_bytes} B")
    link = h2d_gb_per_s() * 1e9
    hc = HydraConfig(n_devices=FIG8_DEVICES, device_budget_bytes=FIG8_BUDGET,
                     link_bw=link)
    steps = [FIG8_STEPS] * n
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = Session(hc, device="cuda", profile=None)
    for i in range(n):
        session.submit(TrainJob(cfg, fig8_loader(cfg, i),
                                lr=FIG8_LRS[i % len(FIG8_LRS)],
                                optimizer="adamw", epochs=1,
                                steps_per_epoch=FIG8_STEPS, seed=i,
                                batch=FIG8_BATCH, seq=FIG8_SEQ))
    plan = session.plan()
    setup_s = time.perf_counter() - t0
    execs = session.train_execs
    host_bytes = sum(tree_bytes(m.store.params) + tree_bytes(m.store.opt)
                     + tree_bytes(m.store.shared_opt) for m in execs)
    peak_used = track_ledger_peaks(session)
    t0 = time.perf_counter()
    train = session.run(plan).train
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shards = [len(m.partition.shards) for m in execs]
    res = {"models": n, "reduction": reduction, "mem_available": avail,
           "mem_available_before_host_cache_emptied": avail_before,
           "mem_settle_s": settle_s,
           "param_bytes": param_bytes, "store_bytes_per_model": store_bytes,
           "host_store_bytes": host_bytes,
           "host_cache_emptied": host_cache_emptied,
           "link_bw": link, "budget": hc.device_budget_bytes,
           "shards": shards,
           "shard_layers": [(s.seg_lo, s.seg_hi)
                            for s in execs[0].partition.shards],
           "setup_s": setup_s,
           "pinned_store_gb_per_s": host_bytes / setup_s / 1e9,
           "wall_s": wall, "units_executed": train.units_executed,
           "losses": {int(k): v for k, v in train.losses.items()},
           "ledger_peak_bytes": peak_used,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "pilot_fwd_ms": [1e3 * statistics.median(
               m.partition.shards[j].fwd_runtime for m in execs)
               for j in range(shards[0])],
           "pilot_bwd_ms": [1e3 * statistics.median(
               m.partition.shards[j].bwd_runtime for m in execs)
               for j in range(shards[0])]}
    expect = n * FIG8_STEPS * 2 * shards[0]
    if len(set(shards)) != 1 or train.units_executed != expect:
        fail(f"fig8: SHARP ran {train.units_executed} units over shards "
             f"{shards}; expected models x steps x 2 x shards = {expect}")
    if max(peak_used.values()) > hc.device_budget_bytes:
        fail(f"fig8: a device ledger went over its budget: {peak_used}")
    if not all(np.isfinite(v).all() and len(v) == FIG8_STEPS
               for v in train.losses.values()):
        fail(f"fig8: losses not finite or missing: {train.losses}")

    mp = bl.model_parallel(execs, FIG8_DEVICES, steps)
    pipe = bl.pipeline(execs, FIG8_DEVICES, steps)
    try:
        bl.task_parallel(execs, FIG8_DEVICES, steps, hc.device_budget_bytes)
    except MemoryError as e:
        res["task_parallel_error"] = str(e)
    else:
        fail("fig8: task parallelism fit a bert-large-1b with its optimizer "
             f"state in {hc.device_budget_bytes} B")
    tp = bl.task_parallel(execs, FIG8_DEVICES, steps, FIG8_ROOMY_BUDGET)
    rows = {"hydra": (train.makespan, train.avg_utilization),
            "model_parallel": (mp.makespan, mp.avg_utilization),
            "pipeline": (pipe.makespan, pipe.avg_utilization),
            "task_parallel_80GB": (tp.makespan, tp.avg_utilization)}
    res["fig8"] = {k: {"makespan_us": ms * 1e6, "util": u,
                       "speedup_vs_mp": mp.makespan / ms}
                   for k, (ms, u) in rows.items()}
    res["phase_s"] = time.perf_counter() - t_phase
    cells = "; ".join(
        f"fig8_{k}={v['makespan_us']:.1f} us (speedup_vs_mp="
        f"{v['speedup_vs_mp']:.2f}, util={v['util']:.4f})"
        for k, v in res["fig8"].items())
    log(f"[fig8] {n} x bert-large-1b full width ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {param_bytes // 4} params), {FIG8_STEPS} steps of "
        f"{FIG8_BATCH}x{FIG8_SEQ}, {FIG8_DEVICES} virtual devices of "
        f"{hc.device_budget_bytes} B, link_bw {link / 1e9:.2f} GB/s "
        f"(measured h2d): {cells}; fig8_task_parallel at "
        f"{hc.device_budget_bytes} B: OOM ({res['task_parallel_error']}); "
        f"shards per model {shards[0]} {res['shard_layers']}; units "
        f"{train.units_executed}; pilot median per shard fwd "
        f"{[round(x, 2) for x in res['pilot_fwd_ms']]} ms, bwd "
        f"{[round(x, 2) for x in res['pilot_bwd_ms']]} ms; run wall "
        f"{wall:.2f} s; setup {setup_s:.2f} s: params made on the card, "
        f"partitioned and copied into pinned host stores of {host_bytes} B "
        f"({res['pinned_store_gb_per_s']:.2f} GB/s); reduction: "
        f"{reduction} (MemAvailable {avail_before} B before the pinned "
        f"host cache was emptied (emptied {host_cache_emptied}), settled "
        f"after {settle_s:.1f} s); ledger "
        f"peak {max(peak_used.values())}; "
        f"max_memory_allocated {res['max_memory_allocated']}; phase "
        f"{res['phase_s']:.1f} s ({smi})")
    if pipe.makespan > mp.makespan:
        fail(f"fig8: pipeline makespan {pipe.makespan} above model "
             f"parallelism's {mp.makespan}")
    if not all(0 < u <= 1 for _, u in rows.values()):
        fail(f"fig8: a utilisation outside (0, 1]: {rows}")
    if not train.makespan < mp.makespan:
        fail(f"fig8: SHARP's makespan {train.makespan} is not below model "
             f"parallelism's {mp.makespan}")

    del session, execs, plan
    empty_host_cache()
    _, ref = train_sequential_reference(ModelTask(
        cfg, fig8_loader(cfg, 0), lr=FIG8_LRS[0], epochs=1,
        steps_per_epoch=FIG8_STEPS, seed=0, batch=FIG8_BATCH,
        seq=FIG8_SEQ), device="cuda")
    torch.cuda.empty_cache()
    res["sequential_losses_0"] = ref
    res["max_abs_loss_diff_0"] = float(
        np.abs(np.subtract(ref, train.losses[0])).max())
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[fig8] model 0 losses {train.losses[0]} vs plain full-model "
        f"training on the card {ref}: max abs diff "
        f"{res['max_abs_loss_diff_0']:.3g} (tol {SHARP_TOL}); phase "
        f"{res['phase_s']:.1f} s")
    if not np.allclose(train.losses[0], ref, rtol=SHARP_TOL,
                       atol=SHARP_TOL):
        fail(f"fig8: model 0's SHARP losses {train.losses[0]} differ from "
             f"plain training's {ref}")
    return res


# ---------------------------------------------------------------------------
# phase 19: length-bucketed prefill on the paged serve path
# ---------------------------------------------------------------------------

def spy_calls(eng, attr, record):
    """Wrap ``eng.<attr>`` (a prefill function or ``_admit``) so each call
    appends ``record(args, result)`` to the returned list."""
    calls, orig = [], getattr(eng, attr)

    def wrapped(*args):
        out = orig(*args)
        calls.append(record(args, out))
        return out
    setattr(eng, attr, wrapped)
    return calls


def exact_prefill_logits(cfg, params, prompt):
    """Last-position logits of an exact-length prefill of ``prompt`` over
    a contiguous cache as wide as the paged backend makes it (the prompt
    rounded up to whole blocks)."""
    import numpy as np
    import torch

    from repro_torch.models import api
    from repro_torch.serving.paging import blocks_for_rows
    from repro_torch.training.train_loop import make_prefill_into_cache
    width = blocks_for_rows(len(prompt), BS) * BS
    state = api.init_decode_state(cfg, 1, width, "cuda")
    tokens = torch.from_numpy(prompt.astype(np.int64))[None].to("cuda")
    logits, _ = make_prefill_into_cache(cfg)(params, state, tokens)
    return logits[0].float()


def bucketed_engine_run(cfg, params, prompts, buckets, label):
    """One paged engine over ``prompts`` (length buckets or none), with its
    prefill calls and admission rounds recorded."""
    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.serving.engine import InferenceEngine

    max_seq = max(len(p) for p in prompts) + GEN
    eng = InferenceEngine(cfg, params, capacity=CAPACITY, max_seq=max_seq,
                          backend="paged", block_size=BS,
                          bucket_sizes=buckets, device="cuda")
    if buckets:
        calls = spy_calls(eng, "_padded_prefill", lambda a, out: {
            "shape": tuple(a[2].shape), "lengths": a[3].tolist(),
            "tokens": a[2].cpu(), "logits": out[0].float()})
    else:
        calls = spy_calls(eng, "_prefill", lambda a, out: {
            "shape": tuple(a[2].shape)})
    rounds = spy_calls(eng, "_admit", lambda a, out: sorted(
        {eng._bucket(r.prompt_len) for r in out}))
    _, res, summary = drive_serve(cfg, eng, prompts, paged_attention_lanes,
                                  label)
    res["calls"], res["rounds"] = calls, [r for r in rounds if r]
    res["shapes"] = sorted({c["shape"] for c in calls})
    res["pool_free"] = eng.pool.n_free == eng.pool.n_allocatable
    res["ledger_reserved"] = eng.ledger.kv_reserved_bytes
    res["bucket_sizes"] = summary["bucket_sizes"]
    return eng, res, summary


def phase_bucketed_serve(cfg, prompts, ref_tokens, smi):
    """Phase 4's requests through ``InferenceEngine(backend="paged",
    bucket_sizes=pow2_buckets(max_seq))`` at full width, then the same
    engine without buckets.  Gates: every request its GEN tokens; prefill
    calls = the distinct (admission round, bucket) keys; every prefill
    width a bucket; paged kernel launches = decode_steps x 28; the pool
    and the ledger end empty; each bucketed group's first-token logits at
    most LOGIT_REL x as far from an f32 exact-length prefill as the bf16
    exact-length prefill is; small f32 engines (slot and paged, bucketed
    and exact) token-identical.  Prefill tok/s (true tokens) and the
    number of distinct prefill shapes both ways; tokens matching phase 4
    reported (bf16), not gated."""
    import torch

    from repro_torch.models import api
    from repro_torch.serving.engine import pow2_buckets

    t_phase = time.perf_counter()
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    buckets = pow2_buckets(max(len(p) for p in prompts) + GEN)
    eng, res, summary = bucketed_engine_run(cfg, params, prompts, buckets,
                                            "bucketed serve")
    expect_calls = sum(len(r) for r in res["rounds"])
    widths = [c["shape"][1] for c in res["calls"]]
    bad = [w for w in widths if w not in buckets]
    launches = res["launches"]
    if not summary["prefill_calls"] == len(res["calls"]) == expect_calls:
        fail(f"bucketed serve: {summary['prefill_calls']} prefill calls, "
             f"{len(res['calls'])} recorded; expected one per (admission "
             f"round, bucket) = {expect_calls}")
    if bad:
        fail(f"bucketed serve: prefill widths {bad} are not buckets of "
             f"{buckets}")
    if launches != summary["decode_steps"] * cfg.n_layers:
        fail(f"bucketed serve: paged_attention launched {launches} times; "
             f"expected decode_steps x layers = "
             f"{summary['decode_steps'] * cfg.n_layers}")
    if not res["pool_free"] or res["ledger_reserved"] != 0 \
            or summary["kv_reserved_bytes"] != 0:
        fail(f"bucketed serve: the pool or the ledger did not end empty "
             f"(pool free {res['pool_free']}, ledger "
             f"{res['ledger_reserved']} B)")

    # each group's first-token logits against exact-length prefills
    cfg32 = cfg.replace(dtype="float32", kv_cache_dtype="float32")
    p32 = api.prepare_params(cfg32, params, "cuda")
    gates = []
    with torch.no_grad():
        for i, c in enumerate(res["calls"]):
            rows = [c["tokens"][j, :n].numpy()
                    for j, n in enumerate(c["lengths"])]
            gates.append(logit_gate(
                f"bucketed prefill group {i} (bucket {c['shape'][1]}, "
                f"lengths {c['lengths']})",
                {"cuda": c["logits"],
                 "ref": torch.stack([exact_prefill_logits(cfg, eng.params, r)
                                     for r in rows]),
                 "f32": torch.stack([exact_prefill_logits(cfg32, p32, r)
                                     for r in rows])},
                names=("bucketed", "exact")))
    del p32, eng
    for c in res["calls"]:
        del c["tokens"], c["logits"]
    torch.cuda.empty_cache()

    _, exact, esum = bucketed_engine_run(cfg, params, prompts, None,
                                         "exact serve")
    del params
    torch.cuda.empty_cache()
    out = {"buckets": list(buckets), "bucketed": res, "exact": exact,
           "logit_gates": gates,
           "identical_to_phase4": sum(
               res["tokens"][k] == ref_tokens.get(k)
               for k in res["tokens"]),
           "bucketed_vs_exact_identical": sum(
               res["tokens"][k] == exact["tokens"][k]
               for k in res["tokens"])}
    out["small_f32"] = phase_small_bucketed_f32()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[buckets] qwen3-0.6b full width, paged, buckets {list(buckets)}: "
        f"{res['requests']} requests x {GEN} tokens; prefill calls "
        f"{summary['prefill_calls']} (rounds {res['rounds']}) in "
        f"{len(res['shapes'])} shapes {res['shapes']}, prefill "
        f"{res['prefill_tok_per_s']} tok/s (true tokens); exact: "
        f"{esum['prefill_calls']} calls in {len(exact['shapes'])} shapes, "
        f"prefill {exact['prefill_tok_per_s']} tok/s; decode "
        f"{res['decode_tok_per_s']} / {exact['decode_tok_per_s']} tok/s; "
        f"paged launches {launches} = {summary['decode_steps']} x "
        f"{cfg.n_layers}; bucketed tokens identical to exact for "
        f"{out['bucketed_vs_exact_identical']} of {len(prompts)}, to phase "
        f"4 for {out['identical_to_phase4']} (bf16, not gated); phase "
        f"{out['phase_s']:.1f} s ({smi})")
    return out


def phase_small_bucketed_f32():
    """Small f32 engines on the card: slot and paged (the paged kernel),
    each with pow2 length buckets and without, give identical tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine, pow2_buckets

    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(5),
                             "cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (5, 17, 32, 9, 12, 3)]
    prompts.append(prompts[2][:20].copy())       # a shared prefix
    out, calls = {}, {}
    for backend in ("slot", "paged"):
        for buckets in (None, pow2_buckets(64)):
            eng = InferenceEngine(cfg, params, capacity=3, max_seq=64,
                                  backend=backend, block_size=8,
                                  bucket_sizes=buckets, device="cuda")
            before = paged_attention_lanes.launches
            for i, p in enumerate(prompts):
                eng.submit(p, 10, request_id=f"b{i}")
            eng.run()
            key = f"{backend}{'-bucketed' if buckets else ''}"
            out[key] = {r.request_id: r.generated for r in eng.completed}
            calls[key] = (eng.prefill_calls,
                          paged_attention_lanes.launches - before)
    ref = out["slot"]
    res = {"identical": all(v == ref for v in out.values())
           and len(ref) == len(prompts),
           "prefill_calls_and_launches": calls}
    log(f"[buckets] small f32 engines (slot, paged; pow2 buckets and "
        f"exact): tokens identical {res['identical']}; (prefill calls, "
        f"paged kernel launches) {calls}")
    if not res["identical"] or calls["paged-bucketed"][1] == 0:
        fail("small f32 engines: bucketed and exact prefill gave different "
             "tokens, or the bucketed paged engine ran no kernel")
    return res


# ---------------------------------------------------------------------------
# phase 20: tiered memory — KV pages demoted to host DRAM and prefetched
# back, and shard-resident serve weights
# ---------------------------------------------------------------------------

TIER_HIGH_PLEN, TIER_HIGH_GEN, TIER_N_HIGH = 256, 8, 4
TIER_BIG_PLEN = 640      # (b)'s fifth high needs more than a high frees
TIER_LOW_ORDER = (2, 3, 4, 5, 6, 7, 0, 1)    # the prefix sharers last


def tier_high_prompts(vocab, n, plen=TIER_HIGH_PLEN, seed=20):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, plen, dtype=np.int32) for _ in range(n)]


class PageAudit:
    """Watches a tiered engine's host pool: each block's rows are cloned on
    the device just before they are demoted (and the block checked to be
    private and outside ``prefix``), and compared element by element with
    the clone once its prefetch has landed — on the compute stream after
    its wait on the copy, so a copy the stream were not ordered after
    would show.  Mismatches accumulate on the device (no host sync in the
    run) and are read at the end."""

    def __init__(self, eng, prefix):
        import torch
        be, pool = eng.backend, eng.backend.host_pool
        self.clones, self.landing = {}, {}
        self.bad = torch.zeros((), dtype=torch.int64, device=eng.device)
        self.prefix_demoted, self.shared_demoted = [], []
        self.demoted, self.landed = 0, 0
        demote, prefetch, land = pool.demote, pool.prefetch, pool.land

        def audited_demote(pages, bids):
            self.prefix_demoted += [b for b in bids if b in prefix]
            self.shared_demoted += [b for b in bids
                                    if be.pool.ref(b) != 1 or b in be._rev]
            rows = [{n: p[:, b].clone() for n, p in pages.items()}
                    for b in bids]
            keys = demote(pages, bids)
            self.clones.update(zip(keys, rows))
            self.demoted += len(keys)
            return keys

        def audited_prefetch(pages, keys, bids):
            fetch = prefetch(pages, keys, bids)
            self.landing[id(fetch)] = list(zip(keys, bids))
            return fetch

        def audited_land(fetch):
            done = land(fetch)
            for key, bid in self.landing.pop(id(fetch), ()):
                want = self.clones.pop(key)
                for n, p in be.pool.pages.items():
                    self.bad += (p[:, bid] != want[n]).sum()
                self.landed += 1
            return done

        pool.demote, pool.prefetch, pool.land = (
            audited_demote, audited_prefetch, audited_land)


def tiered_kv_run(cfg, params, lows, highs, label, *, tiered, device,
                  kv_dtype=None, policy="slo", prefix_share=True,
                  counter=None):
    """Phase 4's requests as ``priority="low"`` (the prefix sharers
    submitted last, so they are the first victims) on CAPACITY lanes; the
    ledger budget, set once the lows hold their reservations, is those
    plus one block less than the first TIER_N_HIGH highs need; after 3
    steps ``highs`` arrive as ``priority="high"``.  After every step the
    host pool and the ledger's host term must agree and the ledger stay
    in budget; at the end every request has its tokens and every tier is
    back at zero."""
    import torch

    from repro_torch.core.spilling import DeviceMemory
    from repro_torch.models.registry import spec as family_spec
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.paging import blocks_for_rows

    bb = family_spec(cfg).kv_block_bytes(cfg, BS, kv_dtype)
    max_seq = max(len(p) for p in lows + highs) + GEN
    ledger = DeviceMemory(-1, budget_bytes=2**62)
    eng = InferenceEngine(cfg, params, capacity=CAPACITY, max_seq=max_seq,
                          backend="paged", block_size=BS, ledger=ledger,
                          kv_dtype=kv_dtype, tiered_kv=tiered,
                          prefetch_ticks=1, policy=policy,
                          prefix_share=prefix_share, device=device)
    reqs = {f"low{i}": eng.submit(lows[i], GEN, request_id=f"low{i}",
                                  priority="low") for i in TIER_LOW_ORDER}
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if counter is not None:
        counter.launches = 0             # count this run only
    checks = {"steps": 0, "host_mismatch": 0, "over_budget": 0}
    audit = None
    first_tick = {}

    def step():
        more = eng.step()
        checks["steps"] += 1
        if tiered and eng.backend.host_pool.used_bytes() \
                != ledger.host_kv_bytes:
            checks["host_mismatch"] += 1
        if ledger.used_bytes() > ledger.budget:
            checks["over_budget"] += 1
        for rid, r in reqs.items():
            if rid not in first_tick and r.generated:
                first_tick[rid] = eng.decode_steps
        return more

    t0 = time.perf_counter()
    step()                               # admits every low
    if any(r.status.value != "running" for r in reqs.values()):
        fail(f"{label}: the {len(lows)} lows were not all admitted at once")
    need = sum(blocks_for_rows(max(blocks_for_rows(len(h), BS) * BS,
                                   len(h) + TIER_HIGH_GEN - 1), BS)
               for h in highs[:TIER_N_HIGH])
    ledger.budget = ledger.kv_reserved_bytes + (need - 1) * bb
    prefix = set(eng.backend._lane_blocks[reqs["low0"].slot][:256 // BS])
    if tiered:
        audit = PageAudit(eng, prefix)
    step()
    step()
    for k, h in enumerate(highs):
        reqs[f"high{k}"] = eng.submit(h, TIER_HIGH_GEN,
                                      request_id=f"high{k}",
                                      priority="high", deadline_ms=60_000.0)
    while step():
        pass
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.summary()
    for rid, r in reqs.items():
        want = GEN if rid.startswith("low") else TIER_HIGH_GEN
        if r.status.value != "finished" or len(r.generated) != want:
            fail(f"{label} {rid}: {len(r.generated)} tokens, status "
                 f"{r.status.value}")
    be = eng.backend
    res = {k: s.get(k) for k in (
        "peak_live_requests", "peak_concurrency", "n_preempted",
        "n_resumed", "decode_steps", "block_bytes", "kv_demoted_bytes",
        "kv_prefetched_bytes", "host_pool_peak_blocks", "host_slab_bytes",
        "prefetch_hits", "prefetch_misses", "prefetch_hit_rate",
        "prefetch_copy_done_at_landing", "decode_tok_per_s",
        "kv_peak_bytes")}
    res.update(
        label=label, tiered=tiered, kv_dtype=kv_dtype or "fp",
        n_layers=cfg.n_layers, prefix_share=prefix_share,
        budget_bytes=ledger.budget, wall_s=wall, first_tick=first_tick,
        launches=None if counter is None else counter.launches,
        tokens={rid: r.generated for rid, r in reqs.items()},
        preempted=sorted(rid for rid, r in reqs.items() if r.preemptions),
        drained=(ledger.kv_reserved_bytes == 0 and ledger.host_kv_bytes == 0
                 and eng.pool.refcounts() == {}
                 and eng.pool.n_free == eng.pool.n_allocatable
                 and (not tiered or be.host_pool.n_blocks == 0)),
        **checks)
    if cuda:
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    if tiered:
        res.update(demoted_blocks=audit.demoted, landed_blocks=audit.landed,
                   mismatched_elements=int(audit.bad),
                   prefix_demoted=audit.prefix_demoted,
                   shared_demoted=audit.shared_demoted,
                   demote_on_preempt=eng._demote_on_preempt)
        if cuda:
            res["rates"] = be.host_pool.transfer_rates()
    return res


def page_move_rates(pool_pages, block_bytes, n_blocks=64, repeats=3):
    """The page-move machinery alone: ``n_blocks`` blocks of a serve pool
    demoted through a fresh ``HostBlockPool`` and prefetched back, timed
    by its side-stream events; the median of ``repeats`` of each
    direction."""
    import statistics

    import torch

    from repro_torch.serving.paging import HostBlockPool
    pool = HostBlockPool(pool_pages, block_bytes)
    bids = list(range(1, n_blocks + 1))
    d2h, h2d = [], []
    for _ in range(repeats):
        keys = pool.demote(pool_pages, bids)
        pool.land(pool.prefetch(pool_pages, keys, bids))
        rates = pool.transfer_rates()
        pool.transfers.clear()
        d2h.append(rates["d2h"]["gb_per_s"])
        h2d.append(rates["h2d"]["gb_per_s"])
    torch.cuda.synchronize()
    return {"blocks": n_blocks, "bytes": n_blocks * block_bytes,
            "d2h_gb_per_s": statistics.median(d2h),
            "h2d_gb_per_s": statistics.median(h2d),
            "slab_bytes": pool.slab_bytes()}


def tier_gates(label, res, base=None, prefix_gate=True):
    """The gates every tiered KV run shares; ``base`` (the untiered run of
    the same requests) for the live-request comparison."""
    if res["host_mismatch"] or res["over_budget"]:
        fail(f"{label}: host pool and ledger disagreed after "
             f"{res['host_mismatch']} step(s), over budget after "
             f"{res['over_budget']}")
    if not res["kv_demoted_bytes"] or \
            res["kv_demoted_bytes"] != res["kv_prefetched_bytes"]:
        fail(f"{label}: kv_demoted_bytes {res['kv_demoted_bytes']} vs "
             f"kv_prefetched_bytes {res['kv_prefetched_bytes']}")
    if res["mismatched_elements"] or \
            res["landed_blocks"] != res["demoted_blocks"]:
        fail(f"{label}: {res['landed_blocks']} of {res['demoted_blocks']} "
             f"demoted blocks landed, {res['mismatched_elements']} elements"
             f" differ from the rows before demotion")
    if res["shared_demoted"]:
        fail(f"{label}: shared or indexed blocks demoted: "
             f"{res['shared_demoted']}")
    if prefix_gate and (res["prefix_demoted"] or not {"low0", "low1"}
                        & set(res["preempted"])):
        fail(f"{label}: prefix blocks demoted {res['prefix_demoted']} "
             f"(preempted {res['preempted']})")
    if not res["drained"]:
        fail(f"{label}: the pool, ledger or host pool did not drain")
    if res["launches"] is not None and \
            res["launches"] != res["decode_steps"] * res["n_layers"]:
        fail(f"{label}: the decode kernel launched {res['launches']} times; "
             f"expected decode_steps x layers = "
             f"{res['decode_steps'] * res['n_layers']}")
    if base is not None and \
            res["peak_live_requests"] <= base["peak_live_requests"]:
        fail(f"{label}: {res['peak_live_requests']} peak live requests, "
             f"untiered {base['peak_live_requests']}")


def tier_line(res):
    rates = res.get("rates", {})
    d2h, h2d = rates.get("d2h", {}), rates.get("h2d", {})
    return (f"peak_live_requests {res['peak_live_requests']}, preempted "
            f"{res['n_preempted']} resumed {res['n_resumed']}, decode_steps "
            f"{res['decode_steps']}, launches {res['launches']}, budget "
            f"{res['budget_bytes']} B, kv_demoted_bytes "
            f"{res['kv_demoted_bytes']} kv_prefetched_bytes "
            f"{res['kv_prefetched_bytes']} ({res.get('demoted_blocks')} "
            f"blocks), host_slab_bytes {res['host_slab_bytes']}, prefetch "
            f"hits {res['prefetch_hits']} misses {res['prefetch_misses']} "
            f"hit_rate {res['prefetch_hit_rate']} copy_done_at_landing "
            f"{res['prefetch_copy_done_at_landing']}, d2h "
            f"{d2h.get('gb_per_s')} GB/s over {d2h.get('bytes')} B, h2d "
            f"{h2d.get('gb_per_s')} GB/s over {h2d.get('bytes')} B, wall "
            f"{res['wall_s']:.3f} s, decode {res['decode_tok_per_s']} tok/s")


def phase_tiered_kv(cfg, params, smi, device="cuda"):
    """(a) byte-blocked preemption untiered, then tiered (eager demotion);
    (b) the pressure path — eager demotion off, a fifth, longer high, no
    prefix sharing — untiered, then tiered; (c) (a)'s tiered run over an
    int8 pool; the page-move rate of 64 blocks alone."""
    import torch

    from repro_torch.kernels.paged_attention import (
        paged_attention_lanes, paged_attention_quant_lanes)
    from repro_torch.serving.slo import SLOPolicy

    cuda = device == "cuda"
    lows = serve_prompts(cfg.vocab_size)
    highs = tier_high_prompts(cfg.vocab_size, TIER_N_HIGH)
    big = tier_high_prompts(cfg.vocab_size, 1, TIER_BIG_PLEN, seed=21)
    fp = paged_attention_lanes if cuda else None
    q8 = paged_attention_quant_lanes if cuda else None
    out = {}

    # (a)
    base = tiered_kv_run(cfg, params, lows, highs, "tier (a) untiered",
                         tiered=False, device=device, counter=fp)
    tier = tiered_kv_run(cfg, params, lows, highs, "tier (a) tiered",
                         tiered=True, device=device, counter=fp)
    tier_gates("tier (a)", tier, base)
    same = sum(tier["tokens"][k] == base["tokens"][k] for k in base["tokens"])
    log(f"[tier (a)] untiered: {tier_line(base)}")
    log(f"[tier (a)] tiered: {tier_line(tier)}; tokens equal to untiered "
        f"for {same} of {len(base['tokens'])} requests (bf16: reported, "
        f"not gated) ({smi})")
    out["a"] = {"untiered": base, "tiered": tier, "same_tokens": same}

    # (b)
    kw = dict(device=device, counter=fp, prefix_share=False)
    base_b = tiered_kv_run(cfg, params, lows, highs + big,
                           "tier (b) untiered", tiered=False, **kw)
    tier_b = tiered_kv_run(cfg, params, lows, highs + big,
                           "tier (b) tiered", tiered=True,
                           policy=SLOPolicy(demote_on_preempt=False), **kw)
    tier_gates("tier (b)", tier_b, prefix_gate=False)
    big_id = f"high{TIER_N_HIGH}"
    if tier_b["demote_on_preempt"] or \
            tier_b["first_tick"][big_id] >= base_b["first_tick"][big_id]:
        fail(f"tier (b): the long high's first token came at decode step "
             f"{tier_b['first_tick'][big_id]} tiered vs "
             f"{base_b['first_tick'][big_id]} untiered (demote_on_preempt "
             f"{tier_b['demote_on_preempt']})")
    log(f"[tier (b)] pressure path (demote_on_preempt=False, prefix "
        f"sharing off, a {TIER_BIG_PLEN}-token fifth high): the long high's "
        f"first token at decode step {tier_b['first_tick'][big_id]} vs "
        f"{base_b['first_tick'][big_id]} untiered; tiered: "
        f"{tier_line(tier_b)}")
    out["b"] = {"untiered": base_b, "tiered": tier_b}

    # (c)
    tier_c = tiered_kv_run(cfg, params, lows, highs, "tier (c) int8",
                           tiered=True, kv_dtype="int8", device=device,
                           counter=q8)
    tier_gates("tier (c)", tier_c)
    log(f"[tier (c)] int8 pool (rows and scales round-trip): "
        f"{tier_line(tier_c)}")
    out["c"] = tier_c

    if cuda:
        from repro_torch.models import api
        pages = api.init_kv_pages(cfg, 65, BS, device)
        bb = tier["block_bytes"]
        out["page_moves"] = page_move_rates(pages, bb)
        del pages
        m = out["page_moves"]
        log(f"[tier] page moves alone: {m['blocks']} blocks ({m['bytes']} "
            f"B): d2h {m['d2h_gb_per_s']:.2f} GB/s, h2d "
            f"{m['h2d_gb_per_s']:.2f} GB/s (pinned slab {m['slab_bytes']} "
            f"B; median of 3) ({smi})")
        torch.cuda.empty_cache()
    return out


TIER_MODELS, TIER_MIN_SHARDS, TIER_WEIGHT_GEN = 3, 4, 16


def tier_partition(cfg, host, plan, max_seq, min_shards):
    """The serve partition of the largest budget — four times the
    parameter bytes, then 4/5 of that, and so on — that cuts at least
    ``min_shards`` shards."""
    from repro_torch.core import partitioner as pt
    from repro_torch.core.partitioner import tree_bytes
    budget = 4 * tree_bytes(host)
    while True:
        try:
            part = pt.partition(cfg, host, plan, budget_bytes=budget,
                                batch=1, seq=max_seq, train=False)
        except MemoryError:         # a segment alone exceeds the budget
            fail(f"no partition of {cfg.name} cut {min_shards} shards")
        if len(part.shards) >= min_shards:
            return part
        budget = budget * 4 // 5


def phase_tiered_weights(cfg, smi, device="cuda", seeds=range(TIER_MODELS),
                         gen=TIER_WEIGHT_GEN, min_shards=TIER_MIN_SHARDS):
    """(d) shard-resident weights: one model per seed, each partitioned
    into >= ``min_shards`` shards in a pinned host store, served under ONE
    ledger of twice the model bytes plus KV slack with ``hot_bytes`` = half
    the model, capacity 1 and one request each, the engines stepped round
    robin.  Gates: tokens equal to a fully resident paged engine of the
    same params; more models holding hot shards at once than the budget
    holds whole; streamed bytes > 0; between ticks the device holds
    exactly the hot shards' tensors: the caching allocator's
    ``requested_bytes`` (the sizes asked for, before its rounding) after
    each tick, less its reading once every model is drained, equal their
    bytes to the byte (``memory_allocated``, which rounds each block up
    to 512 B and keeps a cached large block whole when less than 1 MiB
    would be left, is reported beside it); the ledger drains to 0."""
    import torch

    from repro_torch.core import shard_graph as sg
    from repro_torch.core.spilling import DeviceMemory, HostModelStore
    from repro_torch.models import api
    from repro_torch.models.registry import spec as family_spec
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.paging import blocks_for_rows
    from repro_torch.serving.residency import (ResidencyCoordinator,
                                               ShardResidentParams)

    cuda = device == "cuda"
    prompt = serve_prompts(cfg.vocab_size)[0]
    max_seq = len(prompt) + gen
    plan = sg.build_plan(cfg)
    t0 = time.perf_counter()
    stores, refs, part = [], [], None
    for seed in seeds:
        gen_ = torch.Generator(device).manual_seed(seed)
        params = api.init_params(cfg, gen_, device)
        eng = InferenceEngine(cfg, params, capacity=1, max_seq=max_seq,
                              backend="paged", block_size=BS, policy="fifo",
                              device=device)
        r = eng.submit(prompt, gen)
        eng.run()
        refs.append({"tokens": r.generated,
                     "decode_tok_per_s": eng.summary()["decode_tok_per_s"]})
        del eng
        if part is None:
            part = tier_partition(cfg, sg.prepare_host_params(cfg, params),
                                  plan, max_seq, min_shards)
        # sgd: one moment beside the params (the store keeps optimizer
        # state; serving never reads it)
        stores.append(HostModelStore(cfg, plan, params,
                                     OptimizerConfig(kind="sgd",
                                                     grad_clip=0.0),
                                     part, device=device))
        del params
    setup_s = time.perf_counter() - t0
    model_bytes = sum(stores[0].shard_transfer_bytes(s, train=False)
                      for s in part.shards)
    kv_slack = (blocks_for_rows(max_seq, BS) + 1) * TIER_MODELS * \
        family_spec(cfg).kv_block_bytes(cfg, BS)
    budget = 2 * model_bytes + kv_slack
    ledger = DeviceMemory(-1, budget_bytes=budget)
    coord = ResidencyCoordinator(ledger)
    sources, engines, reqs = [], [], []
    for i, store in enumerate(stores):
        src = ShardResidentParams(cfg, store, part, ledger,
                                  hot_bytes=model_bytes // 2,
                                  name=f"{cfg.name}#{i}")
        coord.register(src)
        eng = InferenceEngine(cfg, None, capacity=1, max_seq=max_seq,
                              backend="paged", block_size=BS, ledger=ledger,
                              policy="fifo", model_name=src.name,
                              param_source=src, device=device)
        sources.append(src)
        engines.append(eng)
        reqs.append(eng.submit(prompt, gen))
    peak_ledger = 0
    for src in sources:
        begin = src.begin_tick

        def wrapped(begin=begin):
            nonlocal peak_ledger
            out = begin()
            peak_ledger = max(peak_ledger, ledger.used_bytes())
            return out
        src.begin_tick = wrapped

    def requested():
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    if cuda:
        torch.cuda.synchronize()
        before_gc = torch.cuda.memory_allocated()
        gc.collect()        # the reference engines' cycles, before the base
        base_alloc = torch.cuda.memory_allocated()
        log(f"[tier (d)] allocated before the first tick {base_alloc} B "
            f"({before_gc - base_alloc} B freed by gc.collect)")
        torch.cuda.reset_peak_memory_stats()
    peak_resident, ticks, readings = 0, 0, []
    t0 = time.perf_counter()
    while any(e.has_work() for e in engines):
        for eng in engines:
            if eng.has_work():
                eng.step()
                ticks += 1
                if cuda:
                    readings.append((ticks, requested(), sum(
                        s.held_device_bytes() for s in sources)))
        peak_resident = max(peak_resident, sum(
            1 for s in sources if s.hot_resident_bytes > 0))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"models": len(sources), "n_shards": len(part.shards),
           "model_bytes": model_bytes, "budget_bytes": budget,
           "whole_model_fit": budget // model_bytes,
           "peak_resident_models": peak_resident, "ticks": ticks,
           "setup_s": setup_s, "wall_s": wall,
           "peak_ledger_in_tick": peak_ledger,
           "stream_promoted_bytes": sum(s.stream_promoted_bytes
                                        for s in sources),
           "n_hot_demotions": sum(s.n_hot_demotions for s in sources),
           "hot_shards": [sorted(s._hot) for s in sources],
           "hot_device_bytes": [s.held_device_bytes() for s in sources],
           "decode_tok_per_s": [e.summary()["decode_tok_per_s"]
                                for e in engines],
           "resident_decode_tok_per_s": [r["decode_tok_per_s"]
                                         for r in refs],
           "tokens_equal": [r.generated == ref["tokens"]
                            for r, ref in zip(reqs, refs)]}
    if cuda:
        res["in_tick_peak_bytes"] = torch.cuda.max_memory_allocated() \
            - base_alloc
        res["allocated_over_held"] = torch.cuda.memory_allocated() \
            - base_alloc - sum(res["hot_device_bytes"])
        res["stream_rates"] = [s.transfer_rates() for s in sources]
    for s in sources:
        s.demote_all()
    res["ledger_drained"] = ledger.used_bytes() == 0 and \
        ledger.host_kv_bytes == 0
    residency_gaps = []
    if cuda:
        torch.cuda.synchronize()
        drained = requested()
        residency_gaps = [(t, got - drained - want)
                          for t, got, want in readings
                          if got - drained != want]
        res["residency_gaps"] = residency_gaps[:8]
        res["after_drain_bytes"] = torch.cuda.memory_allocated() - \
            base_alloc
    rate = (None if not cuda else
            sum(r["bytes"] for r in res["stream_rates"])
            / sum(r["ms"] for r in res["stream_rates"]) / 1e6)
    res["stream_gb_per_s"] = rate
    log(f"[tier (d)] {res['models']} x {cfg.name} ({res['n_shards']} shards,"
        f" {model_bytes} B each) under one ledger of {budget} B (whole "
        f"models that fit: {res['whole_model_fit']}), hot_bytes "
        f"{model_bytes // 2}: peak models holding hot shards "
        f"{peak_resident}, hot shards {res['hot_shards']} "
        f"({res['hot_device_bytes']} B on the device), streamed "
        f"{res['stream_promoted_bytes']} B at {rate} GB/s (host bytes / "
        f"event time of copies and casts), n_hot_demotions "
        f"{res['n_hot_demotions']}, ledger peak in a tick "
        f"{peak_ledger} B vs allocated peak over the baseline "
        f"{res.get('in_tick_peak_bytes')} B, allocated over the hot "
        f"shards' bytes at the end {res.get('allocated_over_held')} B, "
        f"decode "
        f"{res['decode_tok_per_s']} tok/s vs fully resident "
        f"{res['resident_decode_tok_per_s']}, tokens equal "
        f"{res['tokens_equal']}, {ticks} ticks in {wall:.2f} s (stores "
        f"built in {setup_s:.2f} s) ({smi})")
    if not all(res["tokens_equal"]):
        fail("tier (d): shard-resident decode diverged from the fully "
             "resident engine")
    if peak_resident <= res["whole_model_fit"]:
        fail(f"tier (d): {peak_resident} models held hot shards at once; "
             f"whole-model promotion fits {res['whole_model_fit']}")
    if not res["stream_promoted_bytes"] or not res["ledger_drained"]:
        fail("tier (d): nothing streamed, or the ledger did not drain")
    if residency_gaps:
        fail(f"tier (d): device bytes between ticks are not the hot "
             f"shards': (tick, requested - drained - held) "
             f"{residency_gaps[:8]}")
    del engines, sources, stores, coord
    return res


def phase_small_tiered_f32(device="cuda"):
    """(e) (a) and (d) at the smoke shape in f32: a tiered engine whose
    preempted low demotes and prefetches back, and a 2-shard model with
    one shard hot, each token-identical to decoding each prompt alone."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import shard_graph as sg
    from repro_torch.core.spilling import DeviceMemory, HostModelStore
    from repro_torch.models import api
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.residency import ShardResidentParams

    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    params = api.init_params(cfg, torch.Generator(device).manual_seed(0),
                             device)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 8, dtype=np.int32)
               for _ in range(3)]
    gens = (16, 16, 4)

    def alone():
        eng = InferenceEngine(cfg, params, capacity=1, max_seq=64,
                              backend="paged", block_size=8, policy="fifo",
                              device=device)
        out = []
        for p, g in zip(prompts, gens):
            r = eng.submit(p, g)
            eng.run()
            out.append(r.generated)
        return out

    ref = alone()
    ledger = DeviceMemory(-1, budget_bytes=10**9)
    eng = InferenceEngine(cfg, params, capacity=2, max_seq=64,
                          backend="paged", block_size=8, n_blocks=32,
                          ledger=ledger, tiered_kv=True, device=device)
    lows = [eng.submit(p, g, priority="low")
            for p, g in zip(prompts[:2], gens)]
    for _ in range(3):
        eng.step()
    high = eng.submit(prompts[2], gens[2], priority="high",
                      deadline_ms=60_000.0)
    eng.run()
    s = eng.summary()
    kv_ok = [r.generated for r in lows + [high]] == ref and \
        s["kv_demoted_bytes"] > 0 and \
        s["kv_prefetched_bytes"] == s["kv_demoted_bytes"]
    plan = sg.build_plan(cfg)
    part = tier_partition(cfg, sg.prepare_host_params(cfg, params), plan, 64,
                          2)
    store = HostModelStore(cfg, plan, params,
                           OptimizerConfig(kind="sgd", grad_clip=0.0), part,
                           device=device)
    weights = store.shard_transfer_bytes(part.shards[0], train=False)
    src = ShardResidentParams(cfg, store, part,
                              DeviceMemory(-1, budget_bytes=10**9),
                              hot_bytes=weights)
    weng = InferenceEngine(cfg, None, capacity=1, max_seq=64,
                           backend="paged", block_size=8, policy="fifo",
                           param_source=src, device=device)
    r = weng.submit(prompts[0], gens[0])
    weng.run()
    ws = weng.summary()
    w_ok = r.generated == ref[0] and 0 < ws["n_hot_shards"] < \
        ws["n_shards"] and ws["stream_promoted_bytes"] > 0
    res = {"kv_identical": kv_ok, "kv_demoted_bytes": s["kv_demoted_bytes"],
           "weights_identical": w_ok, "n_shards": ws["n_shards"],
           "n_hot_shards": ws["n_hot_shards"]}
    log(f"[tier (e)] small f32 engines: tiered KV (demoted "
        f"{s['kv_demoted_bytes']} B, prefetched "
        f"{s['kv_prefetched_bytes']} B) token-identical to decoding alone "
        f"{kv_ok}; shard-resident ({ws['n_hot_shards']} of "
        f"{ws['n_shards']} shards hot) token-identical {w_ok}")
    if not kv_ok or not w_ok:
        fail("tier (e): a small f32 tiered engine diverged from decoding "
             "each prompt alone")
    return res


def phase_tiering(cfg, smi, device="cuda"):
    """Phase 20: (a)-(c) tiered KV, (d) shard-resident weights, (e) small
    f32 engines, at full width on the card."""
    import torch

    from repro_torch.models import api
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device).manual_seed(0),
                             device)
    out = phase_tiered_kv(cfg, params, smi, device)
    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    out["d"] = phase_tiered_weights(cfg, smi, device)
    if device == "cuda":
        torch.cuda.empty_cache()
    out["e"] = phase_small_tiered_f32(device)
    out["phase_s"] = time.perf_counter() - t0
    log(f"[tier] phase wall {out['phase_s']:.2f} s ({smi})")
    return out


# ---------------------------------------------------------------------------
# phase 21: planning and the async session — the probe oracle at full
# width, a saved plan run by a fresh session, run_async with serving
# ---------------------------------------------------------------------------

# The probe's rule (the JAX package's) charges the head segment its pilot
# peak (the tied table, its gradient, the f32 logits and their gradient:
# 3.8 GB at 2 x 1024 tokens) plus twice the table again for the shared
# optimizer state, 5.04 GB in all: more than 95% of TRAIN_BUDGET, so at
# 5 GB the probe finds the model unpartitionable.  Phase 21 plans at 6 GB.
PROBE_BUDGET = 6 * 10**9
ASYNC_FIRST = 4         # phase 4's prompts submitted before run_async


def probe_train_job(cfg, loader=None):
    """Phase 10's first TrainJob: seed 0, ``TRAIN_LRS[0]``, AdamW, 3 steps
    of 2 x 1024 (``loader`` in place of its SyntheticTokens)."""
    from repro_torch.api import TrainJob
    return TrainJob(cfg, loader if loader is not None
                    else train_loader(cfg, 0), lr=TRAIN_LRS[0],
                    optimizer="adamw", epochs=1, steps_per_epoch=TRAIN_STEPS,
                    seed=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ)


def _sync(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def shard_probe(partition, shard):
    """The pilot that accepted ``shard``: its record of ``[lo, hi)``."""
    return next(p for p in reversed(partition.probes)
                if (p.lo, p.hi) == (shard.seg_lo, shard.seg_hi) and p.fits)


def phase_probe_plan(cfg, smi, budget, path, device="cuda"):
    """21 (a): plan phase 10's first TrainJob with the probe oracle on one
    virtual device of ``budget`` bytes and save the plan to ``path``;
    the analytic partition of the same params and budget beside it, and
    the probe at ``TRAIN_BUDGET`` (reported).  Gates: the shards are an
    ordered cover; at most segments + shards pilots."""
    import torch

    from repro_torch.api import HydraConfig, Session
    from repro_torch.core import partitioner as pt
    from repro_torch.core import shard_graph as sg

    session = Session(HydraConfig(n_devices=1, device_budget_bytes=budget,
                                  partition_oracle="probe"),
                      device=device, profile=None)
    tid = session.submit(probe_train_job(cfg))
    pilots0 = pt.pilot_peak.pilots
    t0 = time.perf_counter()
    plan = session.plan()
    plan_s = time.perf_counter() - t0
    pilots = pt.pilot_peak.pilots - pilots0
    part = session._train_execs[tid].partition
    host = session._train_execs[tid].store.params
    splan = sg.build_plan(cfg)
    n_seg = len(splan.segments)
    analytic = pt.partition(cfg, host, splan, budget_bytes=budget,
                            batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    bounds = [(s.seg_lo, s.seg_hi) for s in part.shards]
    abounds = [(s.seg_lo, s.seg_hi) for s in analytic.shards]
    rows = []
    for s in part.shards:
        p = shard_probe(part, s)
        # the planner's pilots skip the live-bytes count on a card: one
        # more pilot of each shard takes the allocator's peak and the
        # count together
        peak, counted = pt.pilot_peak(cfg, host, splan, s.seg_lo, s.seg_hi,
                                      TRAIN_BATCH, TRAIN_SEQ, device,
                                      count=True)
        rows.append({"shard": s.index, "segments": [s.seg_lo, s.seg_hi],
                     "peak": p.peak, "recount_peak": peak,
                     "counted": counted, "counted_over_peak": counted / peak,
                     "lhs": p.lhs, "limit": p.limit})
        log(f"[probe (a)] shard {s.index} segments [{s.seg_lo}, "
            f"{s.seg_hi}): pilot peak {p.peak} B (allocator); counted "
            f"pilot: allocator {peak} B, live-bytes count {counted} B "
            f"(ratio {counted / peak:.4f}); rule {p.lhs} B <= "
            f"{p.limit:.0f} B ({smi})")
    probe_s = sum(p.seconds for p in part.probes)
    res = {"budget_bytes": budget, "shards": bounds,
           "analytic_shards": abounds, "pilots": pilots,
           "segments": n_seg, "probe_s": probe_s, "plan_s": plan_s,
           "per_shard": rows,
           "pilot_peaks": [[p.lo, p.hi, p.peak, p.lhs, p.fits]
                           for p in part.probes]}
    try:
        pt.partition(cfg, host, splan, budget_bytes=TRAIN_BUDGET,
                     batch=TRAIN_BATCH, seq=TRAIN_SEQ, oracle="probe",
                     device=device)
        res["at_train_budget"] = "plans"
    except MemoryError as e:
        res["at_train_budget"] = str(e)
    log(f"[probe (a)] {cfg.name} full width, {TRAIN_BATCH}x{TRAIN_SEQ} "
        f"tokens, budget {budget} B: probe shards {bounds} "
        f"({len(bounds)}), analytic shards {abounds} ({len(abounds)}); "
        f"{pilots} pilots for {n_seg} segments in {probe_s:.2f} s of "
        f"piloting (plan {plan_s:.2f} s, host store included); the probe "
        f"at TRAIN_BUDGET {TRAIN_BUDGET} B: {res['at_train_budget']} "
        f"({smi})")
    segs = [i for a, b in bounds for i in range(a, b)]
    if segs != list(range(n_seg)):
        fail(f"probe (a): the probed shards {bounds} are not an ordered "
             f"cover of the {n_seg} segments")
    if pilots > n_seg + len(bounds):
        fail(f"probe (a): {pilots} pilots for {n_seg} segments and "
             f"{len(bounds)} shards (at most segments + shards)")
    plan.save(str(path))
    del session
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_saved_plan_run(cfg, smi, budget, path, probe, ref_losses,
                         ref_tok_s, device="cuda"):
    """21 (b): a fresh Session with the same config and job runs
    ``Plan.load(path)``.  Gates: no pilot; the partition is (a)'s; units
    = steps x 2 x shards; the ledger within its budget; losses equal
    ``ref_losses`` at 3e-4; on a card, the run's allocator peak over its
    baseline at most ``TRAIN_BUDGET``, tighter than the ``budget`` the
    plan was probed at: the probe's charge is a bound, and a unit that
    allocates past it (the head unit holding the forward's logits into
    its backward did: 5.03 GB) fails here.  Each unit's allocated peak
    beside its shard's probe estimate, trained tok/s beside
    ``ref_tok_s``."""
    import numpy as np
    import torch

    from repro_torch.api import HydraConfig, Plan, Session
    from repro_torch.core import partitioner as pt

    cuda = device == "cuda"
    session = Session(HydraConfig(n_devices=1, device_budget_bytes=budget,
                                  partition_oracle="probe"),
                      device=device, profile=None)
    session.submit(probe_train_job(cfg))
    plan = Plan.load(str(path))
    peak_used = track_ledger_peaks(session)
    units = []                       # (unit key, allocated peak) per unit
    tick = session.serve_tick

    def unit_peak():
        if len(session.unit_trace) > len(units):
            peak = None
            if cuda:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                torch.cuda.reset_peak_memory_stats()
            units.append((session.unit_trace[-1], peak))
        return tick()
    session.serve_tick = unit_peak

    pilots0 = pt.pilot_peak.pilots
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    report = session.run(plan)
    _sync(device)
    wall = time.perf_counter() - t0
    tail_peak = (torch.cuda.max_memory_allocated() - base) if cuda else None
    pilots = pt.pilot_peak.pilots - pilots0
    m = session.train_execs[0]
    bounds = [(s.seg_lo, s.seg_hi) for s in m.partition.shards]
    losses = report.train.losses[0]
    est = {tuple(r["segments"]): r["lhs"] for r in probe["per_shard"]}
    unit_rows = [{"unit": list(k), "peak": p,
                  "probe_lhs": est[bounds[k[1]]]} for k, p in units]
    run_peak = max([p for _, p in units if p is not None]
                   + ([tail_peak] if tail_peak is not None else []),
                   default=None)
    tok_s = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / wall
    res = {"pilots": pilots, "shards": bounds,
           "units": report.train.units_executed, "losses": losses,
           "ref_losses": ref_losses,
           "max_abs_loss_diff": float(np.abs(np.subtract(losses,
                                                         ref_losses)).max()),
           "ledger_peak_bytes": peak_used, "wall_s": wall,
           "trained_tok_per_s": tok_s, "phase10_tok_per_s": ref_tok_s,
           "unit_peaks": unit_rows, "run_peak_bytes": run_peak,
           "budget_bytes": budget}
    for r in unit_rows:
        log(f"[probe (b)] unit {r['unit']}: allocated peak {r['peak']} B "
            f"over the baseline; its shard's probe charge {r['probe_lhs']} "
            f"B")
    log(f"[probe (b)] fresh session, Plan.load: {pilots} pilots, shards "
        f"{bounds}, {res['units']} units, ledger peak {peak_used}, run "
        f"allocated peak {run_peak} B over the baseline (at most "
        f"TRAIN_BUDGET {TRAIN_BUDGET} B; planned at {budget} B), trained "
        f"{tok_s:.1f} tok/s (phase 10: {ref_tok_s}), losses {losses} vs "
        f"phase 10 {ref_losses} (max abs diff "
        f"{res['max_abs_loss_diff']:.3g}, tol {SHARP_TOL}) ({smi})")
    if pilots != 0:
        fail(f"probe (b): the loaded plan ran {pilots} pilots (expected 0)")
    if bounds != [tuple(b) for b in probe["shards"]]:
        fail(f"probe (b): the run's partition {bounds} is not (a)'s "
             f"{probe['shards']}")
    expect = TRAIN_STEPS * 2 * len(bounds)
    if res["units"] != expect or len(units) != expect:
        fail(f"probe (b): {res['units']} units ({len(units)} traced); "
             f"expected steps x 2 x shards = {expect}")
    if max(peak_used.values()) > budget:
        fail(f"probe (b): the ledger went over its budget: {peak_used}")
    if not np.allclose(losses, ref_losses, rtol=SHARP_TOL, atol=SHARP_TOL):
        fail(f"probe (b): losses {losses} differ from phase 10's "
             f"{ref_losses}")
    if cuda and run_peak > TRAIN_BUDGET:
        over = [r for r in unit_rows if r["peak"] > TRAIN_BUDGET]
        fail(f"probe (b): the run allocated {run_peak} B over its baseline, "
             f"more than TRAIN_BUDGET ({TRAIN_BUDGET} B; the probe planned "
             f"for {budget} B) (units over: {over})")
    del session, report
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return res


def _exploding_loader(cfg):
    """A loader that yields one batch, then raises."""
    first = next(iter(train_loader(cfg, 0)))
    yield first
    raise RuntimeError("probe (c): the loader failed after its first batch")


def phase_async_serve(cfg, smi, budget, prompts, ref_losses, device="cuda"):
    """21 (c): one Session of ``budget`` plus the hot job's KV cap (probe
    oracle) holding phase 10's first TrainJob and a hot paged ServeJob
    (seed 0); phase 4's first requests before ``run_async``, the rest
    once training runs.  Gates: the handle is not done at once, and
    ``run_async`` / ``run`` raise "already in flight"; every request gets
    GEN tokens; each request submitted mid-run decodes a token between
    two shard units; losses equal ``ref_losses`` at 3e-4; the paged
    kernel launches decode_steps x layers times; the ledger ends at 0
    reserved; ``result()`` gives the same report twice; a second
    ``run_async`` serves one more request; a loader that raises after
    its first batch makes ``result()`` raise its error."""
    import numpy as np
    import torch

    from repro_torch.api import HydraConfig, ServeJob, Session
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.models.registry import spec as family_spec
    from repro_torch.serving.paging import blocks_for_rows

    max_seq = max(len(p) for p in prompts) + GEN
    cap = (CAPACITY * blocks_for_rows(max_seq, BS)
           * family_spec(cfg).kv_block_bytes(cfg, BS))
    session = Session(HydraConfig(n_devices=1,
                                  device_budget_bytes=budget + cap,
                                  partition_oracle="probe"),
                      device=device, profile=None)
    tid = session.submit(probe_train_job(cfg))
    hot = session.submit(ServeJob(cfg, seed=0, name=cfg.name,
                                  capacity=CAPACITY, max_seq=max_seq,
                                  backend="paged", block_size=BS))
    reqs = [session.submit_request(hot, p, GEN, request_id=f"r{i}")
            for i, p in enumerate(prompts[:ASYNC_FIRST])]
    ticks = []          # (units done, {request id: tokens}) after a tick
    tick = session.serve_tick

    def traced():
        out = tick()
        ticks.append((len(session.unit_trace),
                      {r.request_id: len(r.generated) for r in reqs}))
        return out
    session.serve_tick = traced

    _sync(device)
    paged_attention_lanes.launches = 0   # count this path's run only
    t0 = time.perf_counter()
    handle = session.run_async()
    done_at_once = handle.done()
    refused = {}
    for name, call in (("run_async", session.run_async),
                       ("run", session.run)):
        try:
            call()
            refused[name] = None
        except RuntimeError as e:
            refused[name] = str(e)
    statuses = set()
    while session.poll(tid)["status"] != "running":
        if handle.done():
            break
        statuses.add(session.poll(tid)["status"])
        time.sleep(0.002)
    units_at_submit = len(session.unit_trace)
    mid = [session.submit_request(hot, p, GEN, request_id=f"r{i}")
           for i, p in enumerate(prompts[ASYNC_FIRST:], ASYNC_FIRST)]
    reqs += mid
    while not handle.done():
        statuses.add(session.poll(tid)["status"])
        time.sleep(0.01)
    report = handle.result(timeout=600)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = paged_attention_lanes.launches
    units = report.train.units_executed
    hrec = report.serve[hot]
    losses = report.train.losses[0]
    mid_between = {}
    for r in mid:
        prev = 0
        mid_between[r.request_id] = 0
        for u, gen in ticks:
            n = gen.get(r.request_id, 0)
            if n > prev and 0 < u < units:
                mid_between[r.request_id] += n - prev
            prev = n
    same_twice = handle.result() is report
    dm = session.devices[0]
    extra = session.submit_request(hot, prompts[0], GEN, request_id="extra")
    again = session.run_async().result(timeout=600)
    res = {"budget_bytes": budget + cap, "kv_cap": cap,
           "done_at_once": done_at_once, "refused": refused,
           "statuses_seen": sorted(statuses),
           "units_at_submit": units_at_submit, "units": units,
           "wall_s": wall, "launches": launches,
           "decode_steps": hrec["decode_steps"],
           "tokens": {r.request_id: len(r.generated) for r in reqs},
           "mid_tokens_between_units": mid_between,
           "losses": losses, "ref_losses": ref_losses,
           "max_abs_loss_diff": float(np.abs(np.subtract(losses,
                                                         ref_losses)).max()),
           "kv_reserved_after": dm.kv_reserved_bytes,
           "same_report_twice": same_twice,
           "second_run_completed": again.serve[hot]["n_completed"],
           "extra_tokens": len(extra.generated),
           "shards": [(s.seg_lo, s.seg_hi)
                      for s in session.train_execs[0].partition.shards],
           "decode_tok_per_s": hrec.get("decode_tok_per_s")}
    log(f"[probe (c)] run_async, {cfg.name} train + hot paged serve, "
        f"budget {budget} + KV cap {cap} B: done at once {done_at_once}, "
        f"a second run_async / run refused: {refused}; {ASYNC_FIRST} "
        f"requests before, {len(mid)} submitted at unit {units_at_submit} "
        f"of {units}; tokens {res['tokens']}; mid-run requests' tokens "
        f"decoded between two shard units {mid_between}; paged launches "
        f"{launches} for {hrec['decode_steps']} decode steps; wall "
        f"{wall:.2f} s; shards {res['shards']}; decode "
        f"{res['decode_tok_per_s']} tok/s ({smi})")
    log(f"[probe (c)] losses {losses} vs phase 10 {ref_losses} (max abs "
        f"diff {res['max_abs_loss_diff']:.3g}); kv reserved after "
        f"{dm.kv_reserved_bytes}; result() twice the same report "
        f"{same_twice}; a second run_async served {len(extra.generated)} "
        f"tokens of one more request ({res['second_run_completed']} "
        f"completed in all)")
    if done_at_once or any(v is None or "already in flight" not in v
                           for v in refused.values()):
        fail(f"probe (c): the async run was done at once ({done_at_once}) "
             f"or a second run was not refused: {refused}")
    if any(n != GEN for n in res["tokens"].values()) or len(reqs) != 8:
        fail(f"probe (c): tokens {res['tokens']} (expected {GEN} each)")
    if not mid or any(v < 1 for v in mid_between.values()):
        fail(f"probe (c): a request submitted mid-run decoded no token "
             f"between two shard units: {mid_between}")
    if not np.allclose(losses, ref_losses, rtol=SHARP_TOL, atol=SHARP_TOL):
        fail(f"probe (c): losses {losses} differ from phase 10's "
             f"{ref_losses}")
    if device == "cuda" and (launches == 0 or launches
                             != hrec["decode_steps"] * cfg.n_layers):
        fail(f"probe (c): paged_attention launched {launches} times; "
             f"expected decode_steps x layers = "
             f"{hrec['decode_steps'] * cfg.n_layers}")
    if dm.kv_reserved_bytes != 0 or not same_twice \
            or len(extra.generated) != GEN:
        fail(f"probe (c): kv reserved after {dm.kv_reserved_bytes}, the "
             f"same report twice {same_twice}, the second run's request "
             f"{len(extra.generated)} tokens")
    del session, report, again, reqs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # a loader that raises after its first batch: result() re-raises it
    scfg = get_config(cfg.name, smoke=True)
    failing = Session(HydraConfig(n_devices=1,
                                  device_budget_bytes=10**9,
                                  partition_oracle="probe"),
                      device=device, profile=None)
    failing.submit(probe_train_job(scfg, _exploding_loader(scfg)))
    try:
        failing.run_async().result(timeout=600)
        res["failure_raised"] = None
    except RuntimeError as e:
        res["failure_raised"] = str(e)
    log(f"[probe (c)] a loader raising after its first batch: result() "
        f"raised {res['failure_raised']!r}")
    if res["failure_raised"] is None \
            or "after its first batch" not in res["failure_raised"]:
        fail("probe (c): a failing run's result() did not raise its error")
    return res


def phase_quickstart_grad(cfg, smi, device="cuda"):
    """21 (d): ``examples/quickstart_torch.py``'s ``main()`` in process
    (its own assertion is the gate), and ``make_grad_step`` on one batch
    of phase 10 at full width: the global norm of its grads equals
    ``make_train_step``'s ``grad_norm`` at 2e-4."""
    import importlib.util

    import torch

    from repro_torch.data.pipeline import as_tensors
    from repro_torch.models import api
    from repro_torch.optim import optimizers as opt
    from repro_torch.training import make_grad_step, make_train_step

    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    t0 = time.perf_counter()
    quick = qs.main(device=device)
    quick_s = time.perf_counter() - t0
    params = api.init_params(cfg, torch.Generator(device).manual_seed(0),
                             device)
    batch = as_tensors(next(iter(train_loader(cfg, 0))), device)
    grads, metrics = make_grad_step(cfg)(params, batch)
    gnorm = float(opt.global_norm(grads))
    loss = float(metrics["loss"])
    del grads
    ocfg = opt.OptimizerConfig(kind="adamw", lr=TRAIN_LRS[0], grad_clip=0.0)
    _, _, tm = make_train_step(cfg, ocfg)(params, opt.init_state(ocfg,
                                                                 params),
                                          batch)
    ref_norm, ref_loss = float(tm["grad_norm"]), float(tm["loss"])
    res = {"quickstart": {str(k): v for k, v in quick.items()},
           "quickstart_s": quick_s, "grad_norm": gnorm,
           "train_step_grad_norm": ref_norm, "loss": loss,
           "train_step_loss": ref_loss}
    log(f"[probe (d)] examples/quickstart_torch.py main() on {device}: "
        f"model 0 {quick[0]} = sequential {quick['reference']} (its own "
        f"assertion) in {quick_s:.2f} s; make_grad_step at full width: "
        f"grad norm {gnorm} vs make_train_step's {ref_norm}, loss {loss} "
        f"vs {ref_loss} ({smi})")
    if abs(gnorm - ref_norm) > 2e-4 * (1 + abs(ref_norm)) \
            or abs(loss - ref_loss) > 2e-4 * (1 + abs(ref_loss)):
        fail(f"probe (d): make_grad_step's grad norm {gnorm} / loss {loss} "
             f"differ from make_train_step's {ref_norm} / {ref_loss}")
    del params, batch
    return res


def phase_probe_async(cfg, smi, prompts, ref_losses, ref_tok_s,
                      budget=PROBE_BUDGET, device="cuda"):
    """Phase 21: (a) the probe plan, (b) the saved plan run by a fresh
    session, (c) run_async with serving, (d) the quickstart and
    ``make_grad_step``."""
    import torch
    t0 = time.perf_counter()
    path = ROOT / "build" / "probe_plan.json"
    path.parent.mkdir(exist_ok=True)
    out = {"a": phase_probe_plan(cfg, smi, budget, path, device)}
    out["b"] = phase_saved_plan_run(cfg, smi, budget, path, out["a"],
                                    ref_losses, ref_tok_s, device)
    out["c"] = phase_async_serve(cfg, smi, budget, prompts, ref_losses,
                                 device)
    out["d"] = phase_quickstart_grad(cfg, smi, device)
    if device == "cuda":
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"[probe] phase wall {out['phase_s']:.2f} s ({smi})")
    return out



# ---------------------------------------------------------------------------
# phase 22: ROADMAP Queue 1 item 8 up to MoE at full width — the split-KV
# kernels at 5, 6, 7 and 12 query heads per KV head, the three widest
# dense configs, mixtral-8x22b and dbrx-132b
# ---------------------------------------------------------------------------

WIDE_GROUPS = (5, 6, 7, 12)     # qwen2.5-32b 5, yi-34b 7, command-r-plus 12
WIDE_DENSE = ("qwen2.5-32b", "yi-34b", "command-r-plus-104b")
ITEM8_LAYERS = 2                # the depth cut of (b)-(d): device memory
ITEM8_GEN = 16
MOE_EVAL_SEQ = 8192
MOE_EVAL_BUDGET = 15 * 10**9    # forward-only: one layer a shard
MOE_TRAIN_STEPS = 2


def wide_gate(kind, label, r, tol, rows):
    """Log one phase-22 kernel row and fail if it disagrees."""
    rows.append(r)
    lib = ("-" if r["library_ms"] is None else f"{r['library_ms']:.4f}")
    log(f"[wide] {kind} {label}: max_abs_err={r['max_abs_err']:.3g} (tol "
        f"{tol}) ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
        f"library_ms={lib} bound_ms={r['bound_ms']:.4f} "
        f"bound_share={r['bound_share']:.3f} ({r['bound_by']})")
    if not r["within_tol"]:
        fail(f"{kind} kernel disagrees with its plain version ({label}): "
             f"max abs err {r['max_abs_err']}")


def phase_wide_kernels(flush):
    """22 (a): each split-KV kernel at 5, 6, 7 and 12 query heads per KV
    head (8 KV heads of 128, block 16, phase 3's ragged lengths, garbage
    lane and window case; verify at k 1, 4, 5, and 8 at 12 groups), the
    fused layer at each wide dense config's d and f, and flash at
    mixtral's 48/8 heads, s 8192, window 4096."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref

    out = {"paged": [], "int8": [], "verify": [], "fused": [], "flash": []}
    for g in WIDE_GROUPS:
        nh = NKV * g
        for i, (dt, n, window) in enumerate(
                [("bfloat16", 8, None), ("bfloat16", 32, None),
                 ("float32", 8, None), ("float32", 32, None),
                 ("bfloat16", 32, 512)]):
            seed = 400 + 10 * g + i
            torch.manual_seed(seed)
            args = sweep_inputs(n, getattr(torch, dt), seed, nh=nh)
            r = measure_paged(*args, window, dt, flush)
            r.update(groups=g, dtype=dt, lanes=n, window=window)
            wide_gate("paged_attention", f"groups={g} {dt} lanes={n} "
                      f"window={window}", r, TOL[dt], out["paged"])
            del args
        for i, (n, window) in enumerate([(8, None), (32, 512)]):
            seed = 500 + 10 * g + i
            torch.manual_seed(seed)
            q, kp, vp, tables, lengths = sweep_inputs(n, torch.float32, seed,
                                                      nh=nh)
            kq8, ks = ref.quantize_kv(kp)
            vq8, vs = ref.quantize_kv(vp)
            del kp, vp
            r = measure_quant(q.to(torch.bfloat16), kq8, vq8, ks, vs, tables,
                              lengths, window, flush)
            r.update(groups=g, dtype="bfloat16 q, int8 pages", lanes=n,
                     window=window)
            wide_gate("paged_attention_quant", f"groups={g} bf16/int8 "
                      f"lanes={n} window={window}", r, TOL["bfloat16"],
                      out["int8"])
            del q, kq8, vq8, ks, vs
        # at 12 groups also k 8: 96 rows, the kernel over query chunks
        for i, (dt, n, kq, window) in enumerate(
                [("bfloat16", 8, 1, None), ("bfloat16", 8, 4, None),
                 ("float32", 8, 5, None), ("bfloat16", 32, 5, 512)]
                + ([("bfloat16", 8, 8, None)] if g == 12 else [])):
            seed = 600 + 10 * g + i
            torch.manual_seed(seed)
            args = verify_sweep_inputs(n, kq, getattr(torch, dt), seed,
                                       nh=nh)
            r = measure_verify(*args, window, dt, flush)
            r.update(groups=g, dtype=dt, lanes=n, k=kq, window=window)
            wide_gate("paged_verify", f"groups={g} {dt} lanes={n} k={kq} "
                      f"window={window}", r, TOL[dt], out["verify"])
            del args
    for arch in WIDE_DENSE:
        cfg = get_config(arch)
        for i, (dt, n, window) in enumerate(
                [("bfloat16", 8, None), ("float32", 8, None),
                 ("bfloat16", 32, 512)]):
            seed = 700 + 10 * WIDE_DENSE.index(arch) + i
            torch.manual_seed(seed)
            dtype = getattr(torch, dt)
            q, kp, vp, tables, lengths = sweep_inputs(
                n, dtype, seed, nh=cfg.n_heads, nkv=cfg.n_kv_heads)
            h = torch.randn(n, cfg.d_model, device="cuda").to(dtype)
            weights = fused_weights(dtype, seed, cfg.d_model, cfg.d_ff,
                                    cfg.n_heads)
            r = measure_fused(h, q, kp, vp, tables, lengths, weights, window,
                              dt, flush)
            r.update(arch=arch, groups=cfg.n_heads // cfg.n_kv_heads,
                     d=cfg.d_model, f=cfg.d_ff, dtype=dt, lanes=n,
                     window=window)
            wide_gate("fused_decode_layer", f"{arch} d={cfg.d_model} "
                      f"f={cfg.d_ff} {dt} lanes={n} window={window}", r,
                      MM_TOL[dt], out["fused"])
            del q, kp, vp, h, weights
            torch.cuda.empty_cache()
    mcfg = get_config("mixtral-8x22b")
    for i, dt in enumerate(("bfloat16", "float32")):
        gen = torch.Generator("cuda").manual_seed(800 + i)
        dtype = getattr(torch, dt)

        def draw(heads):
            return torch.randn(1, MOE_EVAL_SEQ, heads, HD, device="cuda",
                               generator=gen).to(dtype)
        q, k, v = draw(mcfg.n_heads), draw(mcfg.n_kv_heads), \
            draw(mcfg.n_kv_heads)
        r = measure_flash(q, k, v, True, mcfg.window, dt, flush)
        r.update(dtype=dt, b=1, sq=MOE_EVAL_SEQ, heads=[mcfg.n_heads,
                                                         mcfg.n_kv_heads],
                 window=mcfg.window)
        wide_gate("flash_attention", f"{dt} b=1 s={MOE_EVAL_SEQ} heads "
                  f"{mcfg.n_heads}/{mcfg.n_kv_heads} window={mcfg.window}",
                  r, TOL[dt], out["flash"])
        del q, k, v
        torch.cuda.empty_cache()
    return out


def depth_cut(cfg, full):
    """Log the depth cut of a phase-22 model; widths are the config's."""
    log(f"[item8] {full.name}: depth cut {full.n_layers} -> {cfg.n_layers} "
        f"layers (device memory: {cfg.n_params} params, "
        f"{4 * cfg.n_params} B in f32); widths as published: d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, f {cfg.d_ff}, vocab {cfg.vocab_size}"
        + (f", {cfg.n_experts} experts top-{cfg.top_k}"
           if cfg.family == "moe" else "")
        + (f", window {cfg.window}" if cfg.window else ""))


def step_repeat_diff(cfg, eng, snap, impl="ref"):
    """Max abs difference of two paged decode steps of the snapshot state
    with the same params, inputs and ``impl``."""
    import torch

    from repro_torch.models import api
    dev = "cuda"
    args = (torch.from_numpy(snap["tables"]).to(dev),
            torch.from_numpy(snap["lengths"]).to(dev),
            torch.from_numpy(snap["tokens"]).long().to(dev))
    out = []
    with torch.no_grad():
        for _ in range(2):
            pages = {k: v.clone() for k, v in snap["pages"].items()}
            out.append(api.paged_decode_step(cfg, eng.params, pages, *args,
                                             impl=impl).float())
            del pages
    return float((out[0] - out[1]).abs().max())


def phase_wide_dense(flush):
    """22 (b): each wide dense config at 2 layers (f32 params seeded on the
    card, bf16 compute) serves cell 1's 8 requests, 16 new tokens each, on
    the paged backend: every request gets its tokens, paged launches =
    decode_steps x 2; one decode step both ways against the f32 step
    (LOGIT_REL, as phase 5, on the mean abs difference) and one fused
    step, the kernel against its plain version; the plain step run
    twice, its two logits' max difference reported (0 since the snapshot
    gives a lane opening a block its block, ``paged_snapshot``); the
    kernel at the serve path's layer-0 inputs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine

    out = {}
    for arch in WIDE_DENSE:
        full = get_config(arch)
        cfg = full.replace(n_layers=ITEM8_LAYERS)
        depth_cut(cfg, full)
        params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                 "cuda")
        prompts = serve_prompts(cfg.vocab_size)
        max_seq = max(len(p) for p in prompts) + ITEM8_GEN
        eng = InferenceEngine(cfg, params, capacity=CAPACITY,
                              max_seq=max_seq, backend="paged",
                              block_size=BS, device="cuda")
        snap, res, summary = drive_serve(cfg, eng, prompts,
                                         paged_attention_lanes,
                                         f"wide dense {arch}", snap_step=8,
                                         gen=ITEM8_GEN)
        expect = summary["decode_steps"] * cfg.n_layers
        if res["launches"] != expect:
            fail(f"{arch}: paged_attention launched {res['launches']} "
                 f"times; expected decode_steps x layers = {expect}")
        groups = cfg.n_heads // cfg.n_kv_heads
        log(f"[item8] {arch} paged serve ({groups} query heads per KV "
            f"head): {res['requests']} requests x {ITEM8_GEN} tokens, "
            f"prefill {res['prefill_tok_per_s']} tok/s, decode "
            f"{res['decode_tok_per_s']} tok/s, decode_steps "
            f"{res['decode_steps']}, paged launches {res['launches']}, "
            f"max_memory_allocated {res['max_memory_allocated']}")
        le = torch.from_numpy(snap["lengths"] + 1).cuda()
        tb = torch.from_numpy(snap["tables"]).cuda()
        q = torch.randn(CAPACITY, cfg.n_heads, HD,
                        device="cuda").to(torch.bfloat16)
        m = measure_paged(q, snap["pages"]["k"][0], snap["pages"]["v"][0],
                          tb, le, None, "bfloat16", flush)
        m["lengths"] = le.tolist()
        wide_gate("paged_attention", f"at {arch}'s serve inputs (lengths "
                  f"{m['lengths']})", m, TOL["bfloat16"], [])
        res["main_path_kernel"] = m
        res["both_ways"] = phase_both_ways(cfg, eng, snap, params,
                                           stat="mean")
        res["fused_both_ways"] = fused_both_ways(
            cfg, eng, snap, params, label=f"{arch} one fused decode step",
            yardstick="fused_ref", stat="mean")
        res["plain_step_repeat_diff"] = step_repeat_diff(cfg, eng, snap)
        log(f"[item8] {arch}: the plain bf16 decode step twice on the same "
            f"inputs: max abs logit diff {res['plain_step_repeat_diff']}")
        res.pop("tokens")
        out[arch] = res
        del eng, snap, params, q
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_moe_serve(cfg, params, prompts):
    """22 (c): a full-width MoE model through ``InferenceEngine``: a paged,
    bucketed engine falls back to slot and drops its buckets, with JAX's
    warnings; cell 1's requests, 16 new tokens each, on the slot backend:
    every request gets exactly 16; decode and prefill tok/s, each prefill
    call's frac_dropped, one decode step profiled."""
    import warnings

    import torch

    from repro_torch.models import api, moe
    from repro_torch.models.registry import CapabilityFallbackWarning
    from repro_torch.serving.engine import InferenceEngine, pow2_buckets
    from repro_torch.tree import tree_map

    max_seq = max(len(p) for p in prompts) + ITEM8_GEN
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        peng = InferenceEngine(cfg, params, capacity=1, max_seq=max_seq,
                               backend="paged",
                               bucket_sizes=pow2_buckets(max_seq),
                               device="cuda")
    s = peng.summary()
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, CapabilityFallbackWarning)]
    fell_back = ((s["backend"], s["requested_backend"]) == ("slot", "paged")
                 and any("paging" in m for m in msgs))
    no_buckets = (peng.bucket_sizes is None
                  and any("padded_prefill" in m for m in msgs))
    del peng
    torch.cuda.empty_cache()
    if not fell_back or not no_buckets:
        fail(f"{cfg.name}: backend='paged' with buckets did not fall back "
             f"to slot without buckets, with the warnings ({msgs})")

    drops = []                       # each prefill call's frac_dropped
    inner = moe._moe_mlp_inner

    def spy(p, x, c):
        y, aux = inner(p, x, c)
        if x.shape[1] > 1:
            drops.append(aux["frac_dropped"])
        return y, aux

    moe._moe_mlp_inner = spy
    try:
        eng = InferenceEngine(cfg, params, capacity=CAPACITY,
                              max_seq=max_seq, device="cuda")
        for i, p in enumerate(prompts):
            eng.submit(p, ITEM8_GEN, request_id=f"m{i}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        moe._moe_mlp_inner = inner
    summary = eng.summary()
    done = {r.request_id: r for r in eng.completed}
    if len(done) != len(prompts):
        fail(f"{cfg.name} serve: served {len(done)} of {len(prompts)}")
    for rid, r in done.items():
        if len(r.generated) != ITEM8_GEN or r.status.value != "finished":
            fail(f"{cfg.name} serve {rid}: {len(r.generated)} tokens, "
                 f"status {r.status}")
    frac = [float(d) for d in drops]
    res = {"requests": len(done), "gen": ITEM8_GEN, "wall_s": wall,
           "fell_back_from_paged": fell_back, "buckets_dropped": no_buckets,
           "prompt_lens": [len(p) for p in prompts],
           "prefill_frac_dropped": frac,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **{k: summary.get(k) for k in (
               "backend", "slot_bytes", "decode_steps", "prefill_calls",
               "prefill_tok_per_s", "decode_tok_per_s",
               "peak_concurrency")}}
    log(f"[item8] {cfg.name} slot serve: {res['requests']} requests x "
        f"{ITEM8_GEN} tokens, prefill {res['prefill_tok_per_s']} tok/s, "
        f"decode {res['decode_tok_per_s']} tok/s, decode_steps "
        f"{res['decode_steps']}, prefill_calls {res['prefill_calls']}, "
        f"prefill frac_dropped per expert layer call: mean "
        f"{statistics.mean(frac):.4f}, max {max(frac):.4f} over "
        f"{len(frac)}; wall {wall:.2f} s, max_memory_allocated "
        f"{res['max_memory_allocated']}; paged + buckets fell back to slot "
        f"without buckets: {fell_back and no_buckets}")
    state = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                     else t, eng.pool.state)
    toks = torch.zeros((CAPACITY, 1), dtype=torch.long, device="cuda")
    res["profile"] = profiled(
        f"{cfg.name} one decode step ({CAPACITY} lanes)",
        lambda: api.decode_step(cfg, eng.params, state, toks))
    del eng, state
    torch.cuda.empty_cache()
    return res


def eval_both_impls(cfg, params, loader, budget, batch, seq, label):
    """One ``EvalJob`` of ``loader``'s first batch over ``params``, spilled
    at ``budget`` through a Session of its own, with the flash kernel
    (attn_impl 'cuda') and without ('xla'); flash's count is zeroed just
    before each run and read just after.  ``MemAvailable`` is read before
    the first host store is built; the second store reuses the pinned
    blocks the first one freed.  Gates: flash launches = the config's
    (causal) layers with the kernel and none without, >= 2 shards."""
    import torch

    from repro_torch.api import EvalJob, HydraConfig, Session
    from repro_torch.kernels.flash_attention import flash_attention_bhsd

    res = {}
    empty_host_cache()
    avail = settled_mem_available()
    for impl in ("cuda", "xla"):
        session = Session(HydraConfig(n_devices=1,
                                      device_budget_bytes=budget),
                          device="cuda", profile=None)
        session.submit(EvalJob(cfg.replace(attn_impl=impl), loader,
                               n_batches=1, params=params, batch=batch,
                               seq=seq))
        t0 = time.perf_counter()
        session.plan()                          # the pinned host store
        plan_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        flash_attention_bhsd.launches = 0
        t0 = time.perf_counter()
        ev = session.run().evals["eval-0"]
        torch.cuda.synchronize()
        ev.update(wall_s=time.perf_counter() - t0, plan_s=plan_s,
                  launches=flash_attention_bhsd.launches,
                  mem_available=avail)
        res[impl] = ev
        log(f"{label} eval attn_impl={impl}: {batch} x {seq} tokens, "
            f"{ev['n_shards']} shards at {budget} B, loss {ev['losses']}, "
            f"bytes moved {ev['bytes_moved']}, run {ev['wall_s']:.2f} s "
            f"(plan with the host store {plan_s:.2f} s; MemAvailable "
            f"before {avail} B), flash launches {ev['launches']}")
        del session
        gc.collect()
    empty_host_cache()
    if res["cuda"]["launches"] != cfg.n_layers:
        fail(f"{cfg.name} eval: flash launched {res['cuda']['launches']} "
             f"times; expected batches x layers = {cfg.n_layers}")
    if res["xla"]["launches"] != 0 or res["cuda"]["n_shards"] < 2:
        fail(f"{cfg.name} eval: the plain run launched flash, or the eval "
             f"ran in {res['cuda']['n_shards']} shard")
    return res


def moe_eval_loader(cfg):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(batch_size=1, seq_len=MOE_EVAL_SEQ,
                                      vocab_size=cfg.vocab_size, seed=11))


def phase_moe_eval(cfg, params):
    """22 (d): an ``EvalJob`` of 1 batch of 1 x 8192 over (c)'s mixtral
    through the MoE shard plan at MOE_EVAL_BUDGET (>= 2 shards), with the
    flash kernel and without: launches = batches x layers; one full
    forward through the kernel gated against an f32 forward (LOGIT_REL on
    the mean abs difference: route flips set the max), with the route
    flips of each bf16 forward against the f32 one.
    Returns the result and layer 0's q/k/v of the batch."""
    import torch

    from repro_torch.data.pipeline import as_tensors
    from repro_torch.models import api, moe

    res = eval_both_impls(cfg, params, moe_eval_loader(cfg),
                          MOE_EVAL_BUDGET, 1, MOE_EVAL_SEQ,
                          f"[item8] {cfg.name}")
    batch = as_tensors(next(iter(moe_eval_loader(cfg))), "cuda")
    routes = {}
    routing = moe._routing

    def spy_routes(key):
        def run(x, router, c):
            out = routing(x, router, c)
            routes.setdefault(key, []).append(out[1])
            return out
        return run

    logits = {}
    try:
        with torch.no_grad():
            for key, c in (("cuda", cfg.replace(attn_impl="cuda")),
                           ("ref", cfg), ("f32", cfg.replace(
                               dtype="float32"))):
                moe._routing = spy_routes(key)
                logits[key] = api.forward(c, params, batch)
    finally:
        moe._routing = routing
    flips = {k: int(sum(int((a != b).sum()) for a, b in
                        zip(routes[k], routes["f32"])))
             for k in ("cuda", "ref")}
    slots = int(sum(a.numel() for a in routes["f32"]))
    res["route_flips_vs_f32"] = flips
    res["route_slots"] = slots
    log(f"[item8] {cfg.name} full forward 1 x {MOE_EVAL_SEQ}: expert "
        f"choices differing from the f32 forward's: kernel {flips['cuda']},"
        f" plain bf16 {flips['ref']} of {slots} (token, slot) routes")
    res["both_ways"] = logit_gate(
        f"{cfg.name} one full forward (1 x {MOE_EVAL_SEQ})", logits,
        stat="mean")
    del logits, routes
    torch.cuda.empty_cache()
    qkv = layer0_qkv(cfg, params, batch)
    return res, qkv


def two_shard_budget(cfg, params, batch, seq):
    """The least budget at which the analytic rule fits the plan's first
    two segments as one shard (and, for a one-layer model, not the
    third): the plan then cuts after them."""
    from repro_torch.core import partitioner as pt
    from repro_torch.core import shard_graph as sg
    plan = sg.build_plan(cfg)
    shared = pt.shared_cost(cfg, params, plan)
    lo, hi = 1, 10**12
    while lo < hi:
        mid = (lo + hi) // 2
        if pt.analytic_fits(cfg, params, plan, 0, 2, batch, seq, mid,
                            shared, 0.05):
            hi = mid
        else:
            lo = mid + 1
    return lo


def phase_moe_sharp(smi):
    """22 (e): one full-width mixtral-8x22b TrainJob cut to one layer (its
    pinned store of f32 params and two Adam moments held against half of
    MemAvailable), 2 AdamW steps of 2 x 1024 on one virtual device whose
    budget makes the analytic plan cut two shards; gates: units = steps x
    2 x shards, the ledger within its budget, losses, lb_loss and z_loss
    equal plain training stepped in place (``make_grad_step`` +
    ``optimizers.update_``) at 3e-4; each unit's allocated peak beside its
    shard's charge; then the probe oracle's partition of the same host
    store beside the analytic one (its pilots through ``_peaks``, which
    runs the same ``pilot_peak`` and keeps each peak)."""
    import numpy as np
    import torch

    from repro_torch.api import HydraConfig, Session, TrainJob
    from repro_torch.configs import get_config
    from repro_torch.core import partitioner as pt
    from repro_torch.core import shard_graph as sg
    from repro_torch.data.pipeline import as_tensors
    from repro_torch.models import api
    from repro_torch.optim import optimizers as opt
    from repro_torch.training.train_loop import make_grad_step

    full = get_config("mixtral-8x22b")
    cfg = full.replace(n_layers=1)
    depth_cut(cfg, full)
    store_bytes = 12 * cfg.n_params          # f32 params + two moments
    empty_host_cache()
    avail = settled_mem_available()
    log(f"[item8] mixtral SHARP: pinned store {store_bytes} B against half "
        f"of MemAvailable {avail} B")
    if store_bytes > avail // 2:
        fail(f"mixtral SHARP: the pinned store ({store_bytes} B) does not "
             f"fit in half of MemAvailable ({avail} B)")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    budget = two_shard_budget(cfg, params, TRAIN_BATCH, TRAIN_SEQ)
    del params
    torch.cuda.empty_cache()

    splan = sg.build_plan(cfg)
    records = []                      # (loss, lb, z) of each loss backward
    orig_loss = splan.loss

    def loss(c, act, batch):
        out = orig_loss(c, act, batch)
        if torch.is_grad_enabled():   # a backward unit (the pilot's too)
            aux = {k: float(v.detach()) / c.n_layers
                   for k, v in act["aux"].items()}
            records.append((float(out.detach()), aux["lb"], aux["z"]))
        return out

    session = Session(HydraConfig(n_devices=1, device_budget_bytes=budget),
                      device="cuda", profile=None)
    job = TrainJob(cfg, train_loader(cfg, 0), lr=TRAIN_LRS[0],
                   optimizer="adamw", epochs=1,
                   steps_per_epoch=MOE_TRAIN_STEPS, seed=0,
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    session.submit(job)
    t0 = time.perf_counter()
    plan = session.plan()
    plan_s = time.perf_counter() - t0
    m = session.train_execs[0]
    bounds = [(s.seg_lo, s.seg_hi) for s in m.partition.shards]
    charge = {s.index: s.param_bytes + s.act_bytes + m.partition.shared_bytes
              for s in m.partition.shards}
    peak_used = track_ledger_peaks(session)
    units = []
    tick = session.serve_tick

    def unit_peak():
        if len(session.unit_trace) > len(units):
            torch.cuda.synchronize()
            units.append((session.unit_trace[-1],
                          torch.cuda.max_memory_allocated() - base))
            torch.cuda.reset_peak_memory_stats()
        return tick()
    session.serve_tick = unit_peak
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    splan.loss = loss
    try:
        t0 = time.perf_counter()
        report = session.run(plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        splan.loss = orig_loss
    losses = report.train.losses[0]
    # each step's (lb, z): those of the backward whose loss SHARP reported
    aux_log = [next(((lb, z) for ls, lb, z in reversed(records)
                     if ls == step_loss), None) for step_loss in losses]
    res = {"budget_bytes": budget, "shards": bounds,
           "store_bytes": store_bytes, "mem_available": avail,
           "units": report.train.units_executed, "losses": losses,
           "aux": aux_log, "ledger_peak_bytes": peak_used,
           "plan_s": plan_s, "wall_s": wall,
           "unit_peaks": [{"unit": list(k), "peak": p,
                           "charge": charge[k[1]]} for k, p in units]}
    for r in res["unit_peaks"]:
        log(f"[item8] mixtral SHARP unit {r['unit']}: allocated peak "
            f"{r['peak']} B over the baseline; its shard's analytic charge "
            f"{r['charge']} B")
    log(f"[item8] mixtral SHARP at budget {budget} B: shards {bounds}, "
        f"{res['units']} units, ledger peak {peak_used}, plan (host store "
        f"included) {plan_s:.2f} s, run {wall:.2f} s, losses {losses}, "
        f"lb/z {aux_log} ({smi})")
    if len(bounds) < 2:
        fail(f"mixtral SHARP: the analytic plan at {budget} B has "
             f"{len(bounds)} shard")
    expect = MOE_TRAIN_STEPS * 2 * len(bounds)
    if res["units"] != expect:
        fail(f"mixtral SHARP: {res['units']} units; expected steps x 2 x "
             f"shards = {expect}")
    if max(peak_used.values()) > budget:
        fail(f"mixtral SHARP: the ledger went over its budget: {peak_used}")
    if len(losses) != MOE_TRAIN_STEPS or None in aux_log:
        fail(f"mixtral SHARP: {len(losses)} losses for {MOE_TRAIN_STEPS} "
             f"steps, aux terms {aux_log}")

    # the probe oracle over the same host store (pilots of the shard that
    # starts at layer 0 enter with the aux sums)
    # (each pilot's peak kept here too: a refusal returns no record)
    host = m.store.params
    pilots = []

    def pilot(lo, hi):
        try:
            peak, _ = pt.pilot_peak(cfg, host, splan, lo, hi, TRAIN_BATCH,
                                    TRAIN_SEQ, "cuda")
        except torch.OutOfMemoryError:
            peak = None
        torch.cuda.empty_cache()
        own = sum(pt.tree_bytes(sg.resolve_ref(host, splan.segments[i]
                                                .param_ref))
                  for i in range(lo, hi)
                  if splan.segments[i].param_ref is not None)
        pilots.append({"lo": lo, "hi": hi, "peak": peak,
                       "rule_lhs": None if peak is None else
                       peak + 2 * own + m.partition.shared_bytes // 2})
        return float("inf") if peak is None else peak

    t0 = time.perf_counter()
    try:
        probe = pt.partition(cfg, host, splan, budget_bytes=budget,
                             batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                             oracle="probe", _peaks=pilot)
        res["probe_shards"] = [(s.seg_lo, s.seg_hi) for s in probe.shards]
    except MemoryError as e:        # the JAX rule refusing a segment
        res["probe_shards"] = str(e)
    res["probe_pilots"] = pilots
    log(f"[item8] mixtral probe plan at {budget} B (rule limit "
        f"{0.95 * budget:.0f} B): shards {res['probe_shards']} beside "
        f"analytic {bounds}; pilots {pilots} "
        f"({time.perf_counter() - t0:.2f} s)")
    ocfg = job.opt_config()
    del session, report, m, job
    gc.collect()
    torch.cuda.empty_cache()
    empty_host_cache()

    # plain training on the card, stepped in place: params, gradients and
    # two moments (43 GB here) and no second copy
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    state = opt.init_state(ocfg, params)
    grad_step = make_grad_step(cfg)
    it = iter(train_loader(cfg, 0))
    ref_losses, ref_aux = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(MOE_TRAIN_STEPS):
        grads, mt = grad_step(params, as_tensors(next(it), "cuda"))
        opt.update_(ocfg, params, grads, state)
        del grads
        ref_losses.append(float(mt["loss"]))
        ref_aux.append((float(mt["lb_loss"]), float(mt["z_loss"])))
    res["ref_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del params, state
    torch.cuda.empty_cache()
    res["ref_losses"], res["ref_aux"] = ref_losses, ref_aux
    diff = max(float(np.abs(np.subtract(losses, ref_losses)).max()),
               float(np.abs(np.subtract(aux_log, ref_aux)).max()))
    res["max_abs_diff"] = diff
    log(f"[item8] mixtral plain training stepped in place: losses "
        f"{ref_losses}, lb/z {ref_aux}, max_memory_allocated "
        f"{res['ref_max_memory_allocated']}; max abs diff to SHARP "
        f"{diff:.3g} (tol {SHARP_TOL})")
    if not (np.allclose(losses, ref_losses, rtol=SHARP_TOL, atol=SHARP_TOL)
            and np.allclose(aux_log, ref_aux, rtol=SHARP_TOL,
                            atol=SHARP_TOL)):
        fail(f"mixtral SHARP: losses {losses} / lb, z {aux_log} differ "
             f"from plain training's {ref_losses} / {ref_aux}")
    return res


def phase_small_item8_f32():
    """22 (f): mixtral and dbrx smoke slot engines, lanes at different
    positions, give each prompt its tokens alone; command-r-plus smoke at
    12 query heads per KV head gives identical tokens through the paged
    kernel and the plain paged engine."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine

    res = {"mixtral": small_slot_f32("mixtral-8x22b", 6),
           "dbrx": small_slot_f32("dbrx-132b", 7)}
    cfg = get_config("command-r-plus-104b", smoke=True).replace(
        n_heads=12, n_kv_heads=1, head_dim=32, dtype="float32",
        kv_cache_dtype="float32")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(8),
                             "cuda")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (5, 17, 32, 9)]
    out = {}
    for impl in ("cuda", "ref"):
        eng = InferenceEngine(cfg, params, capacity=2, max_seq=64,
                              block_size=8, backend="paged", paged_impl=impl,
                              device="cuda")
        for i, p in enumerate(prompts):
            eng.submit(p, 12, request_id=f"c{i}")
        before = paged_attention_lanes.launches
        eng.run()
        out[impl] = ({r.request_id: r.generated for r in eng.completed},
                     paged_attention_lanes.launches - before)
    same = out["cuda"][0] == out["ref"][0] and len(out["cuda"][0]) == 4
    res["wide_gqa"] = {"identical": same, "launches": out["cuda"][1]}
    log(f"[small f32] command-r-plus-104b smoke at 12/1 heads of 32: paged "
        f"kernel ({out['cuda'][1]} launches) vs plain paged tokens "
        f"identical: {same}")
    if not same or out["cuda"][1] == 0 or out["ref"][1] != 0:
        fail("command-r-plus smoke f32 at 12 query heads per KV head: the "
             "paged kernel did not give the plain paged engine's tokens")
    return res


def phase_item8(flush, smi):
    """Phase 22: (a) the kernels at the new group counts, (b) the wide
    dense configs, (c)-(d) mixtral served and evaluated, then dbrx served,
    (e) mixtral under SHARP, (f) small f32 engines."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    t0 = time.perf_counter()
    out = {"a": phase_wide_kernels(flush), "b": phase_wide_dense(flush),
           "c": {}}
    out["wide_gqa_launches"] = sum(r["launches"] for r in out["b"].values())
    for arch in ("mixtral-8x22b", "dbrx-132b"):
        full = get_config(arch)
        cfg = full.replace(n_layers=ITEM8_LAYERS)
        depth_cut(cfg, full)
        params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                 "cuda")
        out["c"][arch] = phase_moe_serve(cfg, params,
                                         serve_prompts(cfg.vocab_size))
        if arch == "mixtral-8x22b":
            out["d"], (q, k, v) = phase_moe_eval(cfg, params)
            del params
            gc.collect()
            torch.cuda.empty_cache()
            m = measure_flash(q, k, v, True, cfg.window, "bfloat16", flush)
            wide_gate("flash_attention", f"at the {arch} eval path's layer 0"
                      f" q/k/v (b 1, s {MOE_EVAL_SEQ}, window {cfg.window})",
                      m, TOL["bfloat16"], [])
            out["d"]["main_path_kernel"] = m
            out["moe_eval_launches"] = out["d"]["cuda"]["launches"]
            del q, k, v
        else:
            del params
        gc.collect()
        torch.cuda.empty_cache()
    out["e"] = phase_moe_sharp(smi)
    out["f"] = phase_small_item8_f32()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"[item8] phase wall {out['phase_s']:.2f} s ({smi})")
    return out


# ---------------------------------------------------------------------------
# phase 23: ROADMAP Queue 1 item 8's second half at full width — the
# kernels at llava's and whisper's shapes, llava-next-mistral-7b served
# and evaluated from embeddings, whisper-medium and the paper's vit-300m
# under SHARP
# ---------------------------------------------------------------------------

VLM_ARCH, AUDIO_ARCH, VIT_ARCH = ("llava-next-mistral-7b", "whisper-medium",
                                  "vit-300m")
VLM_EVAL_SEQ = 4096
VLM_EVAL_BUDGET = 15 * 10**9    # forward-only: llava's 28.4 GB in >= 2
AUDIO_SEQ = 448                 # whisper's decoder length
AUDIO_STEPS = 2
AUDIO_EVAL_BUDGET = 2 * 10**9   # forward-only: whisper's 3.1 GB in >= 2
AUDIO_DECODE_STEPS = 16
VIT_SEQ = 256                   # 197 patch tokens of a 224 px image, padded
VIT_STEPS = 2
ENC_TOL = 2e-2                  # JAX test_decode_matches_forward's bound


def item8b_arch_line(cfg):
    """Log a phase-23 model's size: widths as published, no depth cut."""
    enc = (f", {cfg.n_encoder_layers} encoder layers, encoder_len "
           f"{cfg.encoder_len}" if cfg.is_encoder_decoder else "")
    log(f"[item8b] {cfg.name} ({cfg.family}) full width and depth: "
        f"{cfg.n_layers} layers{enc}, d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}, f {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.n_params} params by the JAX package's "
        f"count ({4 * cfg.n_params} B in f32)")


def phase_item8b_kernels(flush):
    """23 (a): the split-KV kernels at llava's 32/8 heads of 128 (phase
    3's ragged lengths, garbage lane and window case), verify at k 1, 4
    and 8, then at 12 query heads per KV head and k 8 (96 rows: the
    kernel over query chunks), the fused layer at d 4096 / f 14336, flash
    at llava's eval shape (b 1, s 4096, 32/8) and whisper's decoder
    self-attention (b 2, s 448, 16/16 heads of 64, causal)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref

    cfg = get_config(VLM_ARCH)
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    out = {"paged": [], "int8": [], "verify": [], "fused": [], "flash": []}
    for i, (dt, n, window) in enumerate(
            [("bfloat16", 8, None), ("bfloat16", 32, None),
             ("float32", 8, None), ("float32", 32, None),
             ("bfloat16", 32, 512)]):
        torch.manual_seed(900 + i)
        args = sweep_inputs(n, getattr(torch, dt), 900 + i, nh=nh, nkv=nkv)
        r = measure_paged(*args, window, dt, flush)
        r.update(dtype=dt, lanes=n, window=window)
        wide_gate("paged_attention", f"llava 32/8 {dt} lanes={n} "
                  f"window={window}", r, TOL[dt], out["paged"])
        del args
    for i, (n, window) in enumerate([(8, None), (32, 512)]):
        torch.manual_seed(910 + i)
        q, kp, vp, tables, lengths = sweep_inputs(n, torch.float32, 910 + i,
                                                  nh=nh, nkv=nkv)
        kq8, ks = ref.quantize_kv(kp)
        vq8, vs = ref.quantize_kv(vp)
        del kp, vp
        r = measure_quant(q.to(torch.bfloat16), kq8, vq8, ks, vs, tables,
                          lengths, window, flush)
        r.update(dtype="bfloat16 q, int8 pages", lanes=n, window=window)
        wide_gate("paged_attention_quant", f"llava 32/8 bf16/int8 lanes={n}"
                  f" window={window}", r, TOL["bfloat16"], out["int8"])
        del q, kq8, vq8, ks, vs
    for i, (dt, n, kq, window, heads) in enumerate(
            [("bfloat16", 8, 1, None, (nh, nkv)),
             ("bfloat16", 8, 4, None, (nh, nkv)),
             ("bfloat16", 8, 8, None, (nh, nkv)),
             ("float32", 8, 8, None, (nh, nkv)),
             ("bfloat16", 32, 4, 512, (nh, nkv)),
             ("bfloat16", 8, 8, None, (96, 8)),
             ("float32", 8, 8, None, (96, 8)),
             ("bfloat16", 32, 8, 512, (96, 8))]):
        torch.manual_seed(920 + i)
        args = verify_sweep_inputs(n, kq, getattr(torch, dt), 920 + i,
                                   nh=heads[0], nkv=heads[1])
        r = measure_verify(*args, window, dt, flush)
        g = heads[0] // heads[1]
        r.update(dtype=dt, lanes=n, k=kq, groups=g, window=window,
                 rows=kq * g)
        wide_gate("paged_verify", f"{heads[0]}/{heads[1]} heads {dt} "
                  f"lanes={n} k={kq} ({kq * g} rows) window={window}", r,
                  TOL[dt], out["verify"])
        del args
    for i, (dt, n, window) in enumerate(
            [("bfloat16", 8, None), ("float32", 8, None),
             ("bfloat16", 32, 512)]):
        seed = 940 + i
        torch.manual_seed(seed)
        dtype = getattr(torch, dt)
        q, kp, vp, tables, lengths = sweep_inputs(n, dtype, seed, nh=nh,
                                                  nkv=nkv)
        h = torch.randn(n, cfg.d_model, device="cuda").to(dtype)
        weights = fused_weights(dtype, seed, cfg.d_model, cfg.d_ff, nh)
        r = measure_fused(h, q, kp, vp, tables, lengths, weights, window,
                          dt, flush)
        r.update(d=cfg.d_model, f=cfg.d_ff, dtype=dt, lanes=n,
                 window=window)
        wide_gate("fused_decode_layer", f"llava d={cfg.d_model} "
                  f"f={cfg.d_ff} {dt} lanes={n} window={window}", r,
                  MM_TOL[dt], out["fused"])
        del q, kp, vp, h, weights
        torch.cuda.empty_cache()
    acfg = get_config(AUDIO_ARCH)
    for i, (b, s, heads, hd, dt) in enumerate(
            [(1, VLM_EVAL_SEQ, (nh, nkv), cfg.head_dim, "bfloat16"),
             (1, VLM_EVAL_SEQ, (nh, nkv), cfg.head_dim, "float32"),
             (2, AUDIO_SEQ, (acfg.n_heads, acfg.n_kv_heads), acfg.head_dim,
              "bfloat16"),
             (2, AUDIO_SEQ, (acfg.n_heads, acfg.n_kv_heads), acfg.head_dim,
              "float32")]):
        gen = torch.Generator("cuda").manual_seed(950 + i)
        dtype = getattr(torch, dt)

        def draw(n_heads):
            return torch.randn(b, s, n_heads, hd, device="cuda",
                               generator=gen).to(dtype)
        q, k, v = draw(heads[0]), draw(heads[1]), draw(heads[1])
        r = measure_flash(q, k, v, True, None, dt, flush)
        r.update(dtype=dt, b=b, sq=s, heads=list(heads), head_dim=hd)
        wide_gate("flash_attention", f"{dt} b={b} s={s} heads "
                  f"{heads[0]}/{heads[1]} of {hd} causal", r, TOL[dt],
                  out["flash"])
        del q, k, v
        torch.cuda.empty_cache()
    return out


def phase_llava_serve(cfg, params, flush):
    """23 (b): full-width, full-depth llava-next-mistral-7b (f32 params
    seeded on the card, one bf16 copy of the layer weights shared by every
    engine) serves phase 4's 8 requests, 32 new tokens each, on four
    backends — paged, fused paged, spec over paged with the model as its
    own draft, int8 pages: each request gets its tokens, each kernel
    launches decode steps (spec: rounds) x 32 times, each kernel step is
    gated against its plain version on the mean abs logit difference from
    the f32 step (LOGIT_REL, phase 22's rule), each kernel at its serve
    path's inputs, one paged decode step profiled."""
    import torch

    from repro_torch.kernels.fused_decode import fused_decode_layer
    from repro_torch.kernels.paged_attention import (n_splits,
                                                     paged_attention_lanes)
    from repro_torch.models import api, transformer
    from repro_torch.serving.engine import InferenceEngine

    bf16 = api.prepare_params(cfg, params, "cuda")
    prompts = serve_prompts(cfg.vocab_size)
    max_seq = max(len(p) for p in prompts) + GEN
    L = cfg.n_layers
    nh = cfg.n_heads
    out = {}

    eng = InferenceEngine(cfg, bf16, capacity=CAPACITY, max_seq=max_seq,
                          backend="paged", block_size=BS, device="cuda")
    snap, res, summary = drive_serve(cfg, eng, prompts,
                                     paged_attention_lanes, "llava paged",
                                     snap_step=8)
    if res["launches"] != summary["decode_steps"] * L:
        fail(f"llava paged: paged_attention launched {res['launches']} "
             f"times; expected decode_steps x layers = "
             f"{summary['decode_steps'] * L}")
    log(f"[vlm] llava paged serve: {res['requests']} requests x {GEN} "
        f"tokens, prefill {res['prefill_tok_per_s']} tok/s, decode "
        f"{res['decode_tok_per_s']} tok/s, decode_steps "
        f"{res['decode_steps']}, paged launches {res['launches']}, "
        f"kv_page_peak_bytes {res['kv_page_peak_bytes']}, shared_block_hits "
        f"{res['shared_block_hits']}, max_memory_allocated "
        f"{res['max_memory_allocated']}")
    tb = torch.from_numpy(snap["tables"]).cuda()
    le = torch.from_numpy(snap["lengths"] + 1).cuda()
    q = torch.randn(CAPACITY, nh, HD, device="cuda").to(torch.bfloat16)
    m = measure_paged(q, snap["pages"]["k"][0], snap["pages"]["v"][0], tb,
                      le, None, "bfloat16", flush)
    m.update(lengths=le.tolist(), splits=n_splits(tb.shape[1], BS))
    wide_gate("paged_attention", f"at llava's paged serve inputs (lengths "
              f"{m['lengths']}, splits {m['splits']})", m, TOL["bfloat16"],
              [])
    res["main_path_kernel"] = m
    res["both_ways"] = phase_both_ways(cfg, eng, snap, params, stat="mean")
    res["profile"] = phase_profile(
        cfg, eng, snap, "llava-next-mistral-7b one paged decode step "
        f"({CAPACITY} lanes, {L} layers)")
    out["paged"] = res
    del eng, snap, q
    torch.cuda.empty_cache()

    eng = InferenceEngine(cfg, bf16, capacity=CAPACITY, max_seq=max_seq,
                          backend="paged", paged_impl="fused",
                          block_size=BS, device="cuda")
    snap, res, summary = drive_serve(cfg, eng, prompts, fused_decode_layer,
                                     "llava fused", snap_step=8)
    if res["launches"] != summary["decode_steps"] * L:
        fail(f"llava fused: fused_decode_layer launched {res['launches']} "
             f"times; expected decode_steps x layers = "
             f"{summary['decode_steps'] * L}")
    log(f"[vlm] llava fused paged serve: {res['requests']} requests x "
        f"{GEN} tokens, decode {res['decode_tok_per_s']} tok/s (paged "
        f"{out['paged']['decode_tok_per_s']}), decode_steps "
        f"{res['decode_steps']}, fused launches {res['launches']}")
    res["both_ways"] = fused_both_ways(
        cfg, eng, snap, params, label="llava one fused decode step",
        yardstick="fused_ref", stat="mean")
    lp = transformer.layer_slices(eng.params["layers"], 1)[0]
    bf = torch.bfloat16
    weights = (lp["attn"]["wo"].to(bf).contiguous(),
               lp["mlp_norm"]["scale"].to(bf).contiguous(),
               lp["mlp"]["w_gate"].to(bf).contiguous(),
               lp["mlp"]["w_up"].to(bf).contiguous(),
               lp["mlp"]["w_down"].to(bf).contiguous())
    tb = torch.from_numpy(snap["tables"]).cuda()
    le = torch.from_numpy(snap["lengths"] + 1).cuda()
    h = torch.randn(CAPACITY, cfg.d_model, device="cuda").to(bf)
    q = torch.randn(CAPACITY, nh, HD, device="cuda").to(bf)
    m = measure_fused(h, q, snap["pages"]["k"][0], snap["pages"]["v"][0],
                      tb, le, weights, None, "bfloat16", flush)
    m["lengths"] = le.tolist()
    wide_gate("fused_decode_layer", f"at llava's fused serve inputs "
              f"(lengths {m['lengths']})", m, MM_TOL["bfloat16"], [])
    res["main_path_kernel"] = m
    res.pop("tokens")
    out["fused"] = res
    del eng, snap, weights, h, q, lp
    torch.cuda.empty_cache()

    vsnap, res = phase_spec_serve(cfg, bf16, prompts, cfg, bf16,
                                  "llava spec self-draft")
    lanes = (vsnap["tables"] != 0).any(dim=1)
    qv = torch.randn(CAPACITY, DRAFT_K, nh, HD,
                     device="cuda").to(torch.bfloat16)
    m = measure_verify(qv, vsnap["pages"]["k"][0], vsnap["pages"]["v"][0],
                       vsnap["tables"], vsnap["lengths"], None, "bfloat16",
                       flush, lanes=lanes)
    m.update(lengths=vsnap["lengths"].tolist(),
             lanes_in_round=int(lanes.sum()))
    wide_gate("paged_verify", f"at llava's spec serve inputs (k {DRAFT_K},"
              f" lengths {m['lengths']})", m, TOL["bfloat16"], [])
    res["main_path_kernel"] = m
    res["both_ways"] = phase_verify_both_ways(cfg, vsnap, params, bf16,
                                              stat="mean")
    res["requests_token_identical_to_paged"] = sum(
        res["tokens"][k] == out["paged"]["tokens"][k] for k in res["tokens"])
    res.pop("tokens")
    log(f"[vlm] llava spec self-draft: verify launches {res['launches']}, "
        f"spec_rounds {res['spec_rounds']}, draft_accept_rate "
        f"{res['draft_accept_rate']}, requests token-identical to paged "
        f"{res['requests_token_identical_to_paged']} of {len(prompts)}")
    out["spec"] = res
    del vsnap, qv
    torch.cuda.empty_cache()

    ieng, isnap, res = phase_int8_serve(cfg, bf16, prompts, out["paged"])
    del ieng
    pg = isnap["pages"]
    qq = torch.randn(CAPACITY, nh, HD, device="cuda").to(torch.bfloat16)
    itb = torch.from_numpy(isnap["tables"]).cuda()
    ile = torch.from_numpy(isnap["lengths"] + 1).cuda()
    m = measure_quant(qq, pg["k"][0], pg["v"][0], pg["k_scale"][0],
                      pg["v_scale"][0], itb, ile, None, flush)
    m.update(lengths=ile.tolist(), splits=n_splits(itb.shape[1], BS))
    wide_gate("paged_attention_quant", f"at llava's int8 serve inputs "
              f"(lengths {m['lengths']})", m, TOL["bfloat16"], [])
    res["main_path_kernel"] = m
    res["both_ways"] = phase_int8_both_ways(cfg, isnap, params, bf16,
                                            stat="mean")
    res.pop("tokens")
    log(f"[vlm] llava int8 serve: int8 launches {res['launches']} = "
        f"decode_steps {res['decode_steps']} x {L}")
    out["int8"] = res
    out["paged"].pop("tokens")
    del isnap, qq, bf16
    gc.collect()
    torch.cuda.empty_cache()
    return out


def embeds_loader(cfg, batch, seq, seed, n=None):
    """``models.api.make_dummy_batch`` batches from ``seed``, made on the
    host (the pipeline moves them to the card): bf16 ``embeds`` (vlm) or
    ``enc_embeds`` (audio) beside int64 tokens and labels; ``n`` batches,
    or without end."""
    import itertools

    import torch

    from repro_torch.models import api

    class Loader:
        def __iter__(self):
            g = torch.Generator().manual_seed(seed)
            for _ in (range(n) if n else itertools.count()):
                yield api.make_dummy_batch(cfg, batch, seq, g, device="cpu")
    return Loader()


def phase_llava_eval(cfg, params):
    """23 (c): an ``EvalJob`` of one random ``embeds`` batch (1 x 4096)
    over llava's 28.4 GB of f32 params, spilled through the dense shard
    plan at VLM_EVAL_BUDGET, with the flash kernel and without: launches
    = layers, none without; one full forward from the same embeds through
    the kernel gated against an f32 forward (LOGIT_REL on the mean)."""
    import torch

    from repro_torch.data.pipeline import as_tensors
    from repro_torch.models import api

    res = eval_both_impls(cfg, params,
                          embeds_loader(cfg, 1, VLM_EVAL_SEQ, 23, 1),
                          VLM_EVAL_BUDGET, 1, VLM_EVAL_SEQ,
                          "[vlm] llava from embeds")
    batch = as_tensors(next(iter(embeds_loader(cfg, 1, VLM_EVAL_SEQ, 23,
                                               1))), "cuda")
    with torch.no_grad():
        logits = {"cuda": api.forward(cfg.replace(attn_impl="cuda"), params,
                                      batch),
                  "ref": api.forward(cfg, params, batch),
                  "f32": api.forward(cfg.replace(dtype="float32"), params,
                                     batch)}
    res["both_ways"] = logit_gate(
        f"llava one full forward from embeds (1 x {VLM_EVAL_SEQ})", logits,
        stat="mean")
    del logits
    torch.cuda.empty_cache()
    return res


def largest_budget(cfg, host, batch, seq, ok, train=True):
    """The largest budget (to 1 MB) whose analytic partition ``ok``
    accepts, searched down from 1 TB in steps of 10 %, then bisected;
    ``ok`` takes the partition (None where a segment does not fit)."""
    from repro_torch.core import partitioner as pt
    from repro_torch.core import shard_graph as sg
    plan = sg.build_plan(cfg)

    def part(budget):
        try:
            return pt.partition(cfg, host, plan, budget_bytes=budget,
                                batch=batch, seq=seq, train=train)
        except MemoryError:
            return None
    hi = 10**12
    lo = hi
    while not ok(part(lo)):
        hi, lo = lo, lo * 9 // 10
        if lo < 10**6:
            fail(f"{cfg.name}: no budget gives the partition asked for")
    while hi - lo > 10**6:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if ok(part(mid)) else (lo, mid)
    return lo


def phase_whisper(smi):
    """23 (d): full-width, full-depth whisper-medium.  SHARP: two
    TrainJobs (2 AdamW steps of 2 x 448 decoder tokens over 1500 encoder
    frames) at the largest budget whose analytic plan cuts >= 3 shards
    with a boundary past the bridge (the encoder output crosses a shard
    boundary), each unit's peak beside its charge, losses equal plain
    training at 3e-4; the probe oracle's plan beside the analytic one;
    a spilled ``EvalJob`` with flash (24 launches a batch) and without;
    encode, precompute_cross_kv and 16 decode steps against the
    forward's logits (mean abs within 2e-2, the max printed)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import partitioner as pt
    from repro_torch.core import shard_graph as sg
    from repro_torch.data.pipeline import as_tensors
    from repro_torch.models import api, encdec

    cfg = get_config(AUDIO_ARCH)
    item8b_arch_line(cfg)
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    tree = api.param_count(params)
    host = sg.prepare_host_params(cfg, params)
    plan = sg.build_plan(cfg)
    bridge = [s.name for s in plan.segments].index("bridge")

    def cut(p):
        return p is not None and len(p.shards) >= 3 and any(
            s.seg_lo > bridge for s in p.shards)
    budget = largest_budget(cfg, host, 2, AUDIO_SEQ, cut)
    store = 2 * 12 * tree                 # two models: params + 2 moments
    empty_host_cache()
    avail = settled_mem_available()
    log(f"[item8b] whisper: {tree} params in the tree (cross-attention and "
        f"dec_pos included); SHARP pinned stores {store} B against half of "
        f"MemAvailable {avail} B; budget {budget} B")
    if store > avail // 2:
        fail(f"whisper SHARP: the pinned stores ({store} B) do not fit in "
             f"half of MemAvailable ({avail} B)")
    res = {"params_in_tree": tree, "mem_available": avail}
    session, res["sharp"] = phase_sharp_train(
        cfg, budget, AUDIO_STEPS, unit_peaks=True, batch=2, seq=AUDIO_SEQ,
        loader=lambda c, seed: embeds_loader(c, 2, AUDIO_SEQ, seed))
    sh = session.train_execs[0]
    pilots = []
    shost = sh.store.params

    def pilot(lo, hi):
        try:
            peak, _ = pt.pilot_peak(cfg, shost, plan, lo, hi, 2, AUDIO_SEQ,
                                    "cuda")
        except torch.OutOfMemoryError:
            peak = None
        torch.cuda.empty_cache()
        pilots.append({"lo": lo, "hi": hi, "peak": peak})
        return float("inf") if peak is None else peak

    t0 = time.perf_counter()
    try:
        probe = pt.partition(cfg, shost, plan, budget_bytes=budget, batch=2,
                             seq=AUDIO_SEQ, oracle="probe", _peaks=pilot)
        res["probe_shards"] = [(s.seg_lo, s.seg_hi) for s in probe.shards]
    except MemoryError as e:
        res["probe_shards"] = str(e)
    res["probe_pilots"] = pilots
    log(f"[item8b] whisper probe plan at {budget} B: shards "
        f"{res['probe_shards']} beside analytic "
        f"{res['sharp']['shard_layers'][0]}; "
        f"{len(pilots)} pilots, the largest peak "
        f"{max((p['peak'] or 0) for p in pilots)} B "
        f"({time.perf_counter() - t0:.2f} s)")
    if isinstance(res["probe_shards"], list) and [
            i for lo, hi in res["probe_shards"] for i in range(lo, hi)] != \
            list(range(len(plan.segments))):
        fail(f"whisper probe: {res['probe_shards']} is no ordered cover")
    del session, sh, shost
    gc.collect()
    torch.cuda.empty_cache()
    empty_host_cache()

    res["eval"] = eval_both_impls(
        cfg, params, embeds_loader(cfg, 2, AUDIO_SEQ, 24, 1),
        AUDIO_EVAL_BUDGET, 2, AUDIO_SEQ,
        f"[item8b] whisper (over 2 x {cfg.encoder_len} frames)")

    batch = as_tensors(next(iter(embeds_loader(cfg, 2, AUDIO_DECODE_STEPS,
                                               25, 1))), "cuda")
    with torch.no_grad():
        full = api.forward(cfg, params, batch)
        enc = encdec.encode(cfg, params, batch["enc_embeds"])
        state = api.init_decode_state(cfg, 2, AUDIO_DECODE_STEPS + 4,
                                      "cuda")
        state["cross"] = encdec.precompute_cross_kv(cfg, params, enc)
        outs = []
        for i in range(AUDIO_DECODE_STEPS):
            logits, state = api.decode_step(cfg, params, state,
                                            batch["tokens"][:, i:i + 1])
            outs.append(logits[:, 0])
        diff = (torch.stack(outs, 1) - full).abs()
    res["decode_vs_forward"] = {"mean_abs": float(diff.mean()),
                                "max_abs": float(diff.max()),
                                "max_abs_logit": float(full.abs().max())}
    log(f"[item8b] whisper encode -> precompute_cross_kv -> "
        f"{AUDIO_DECODE_STEPS} decode steps vs the forward's logits: mean "
        f"abs {res['decode_vs_forward']['mean_abs']:.4g} (tol {ENC_TOL}), "
        f"max abs {res['decode_vs_forward']['max_abs']:.4g}, max |logit| "
        f"{res['decode_vs_forward']['max_abs_logit']:.3g} ({smi})")
    if not res["decode_vs_forward"]["mean_abs"] <= ENC_TOL:
        fail(f"whisper decode: mean abs logit difference to the forward "
             f"{res['decode_vs_forward']['mean_abs']} over {ENC_TOL}")
    del params, host, enc, state, full, outs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_vit_sharp():
    """23 (e): the paper's ViT* workload at full width: two vit-300m
    TrainJobs over random patch embeddings (2 AdamW steps of 2 x 256) at
    the largest budget whose analytic plan cuts >= 2 shards; losses equal
    plain training at 3e-4."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import shard_graph as sg
    from repro_torch.models import api

    cfg = get_config(VIT_ARCH)
    item8b_arch_line(cfg)
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    budget = largest_budget(cfg, sg.prepare_host_params(cfg, params), 2,
                            VIT_SEQ,
                            lambda p: p is not None and len(p.shards) >= 2)
    del params
    torch.cuda.empty_cache()
    empty_host_cache()
    avail = settled_mem_available()
    log(f"[item8b] vit-300m: SHARP pinned stores {2 * 12 * cfg.n_params} B "
        f"against MemAvailable {avail} B")
    session, res = phase_sharp_train(
        cfg, budget, VIT_STEPS, min_shards=2, batch=2, seq=VIT_SEQ,
        loader=lambda c, seed: embeds_loader(c, 2, VIT_SEQ, seed))
    res["mem_available"] = avail
    del session
    gc.collect()
    torch.cuda.empty_cache()
    empty_host_cache()
    return res


def phase_small_item8b_f32():
    """23 (f): llava smoke in f32 on the slot, paged (kernel), spec over
    paged (verify kernel, a random draft) and int8-paged backends: 3 lanes
    joining one tick apart give each request the tokens it gets decoded
    alone; whisper smoke: the engine refuses it with the JAX package's
    "encoder-decoder" reason."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config(VLM_ARCH, smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(9),
                             "cuda")
    draft = api.init_params(cfg, torch.Generator("cuda").manual_seed(10),
                            "cuda")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (5, 17, 9, 12)]
    backends = {"slot": {}, "paged": dict(backend="paged", block_size=8),
                # a ledger that also admits one lane's draft state
                "spec": dict(backend="spec", spec_inner="paged", draft_k=3,
                             block_size=8, draft_cfg=cfg,
                             draft_params=draft, kv_budget_bytes=2**24),
                "int8": dict(backend="paged", kv_dtype="int8",
                             block_size=8)}

    res = {name: pooled_vs_alone(cfg, params, prompts,
                                 f"llava smoke {name}", **kw)
           for name, kw in backends.items()}
    wcfg = get_config(AUDIO_ARCH, smoke=True)
    try:
        InferenceEngine(wcfg, params=None, capacity=1, max_seq=16,
                        device="cuda")
        refused = None
    except ValueError as e:
        refused = str(e)
    log(f"[small f32] whisper smoke through InferenceEngine: {refused}")
    if refused is None or "encoder-decoder" not in refused:
        fail("whisper smoke: InferenceEngine did not refuse the "
             "encoder-decoder family with the JAX package's reason")
    res["whisper_refused"] = refused
    return res


def phase_item8b(flush, smi):
    """Phase 23: (a) the kernels at llava's and whisper's shapes, (b)
    llava served on four backends, (c) llava's eval from embeddings, (d)
    whisper-medium under SHARP, probed, evaluated and decoded, (e)
    vit-300m under SHARP, (f) small f32 engines."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    t0 = time.perf_counter()
    out = {"a": phase_item8b_kernels(flush)}
    cfg = get_config(VLM_ARCH)
    item8b_arch_line(cfg)
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    out["b"] = phase_llava_serve(cfg, params, flush)
    out["c"] = phase_llava_eval(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["d"] = phase_whisper(smi)
    out["e"] = phase_vit_sharp()
    out["f"] = phase_small_item8b_f32()
    torch.cuda.empty_cache()
    out["vlm_launches"] = {k: out["b"][k]["launches"]
                           for k in ("paged", "fused", "spec", "int8")}
    out["audio_launches"] = out["d"]["eval"]["cuda"]["launches"]
    out["phase_s"] = time.perf_counter() - t0
    log(f"[item8b] phase wall {out['phase_s']:.2f} s ({smi})")
    return out


# ---------------------------------------------------------------------------
# phase 24: the fp8 KV cache, the HTTP/SSE front end and checkpoints
# ---------------------------------------------------------------------------

FP8 = "float8_e4m3fn"
FP8_GEN = 16          # new tokens a request on the fused and spec fp8 runs
FP8_DP_TOL = 2e-3     # mean |softmax delta| vs the bf16 cache (JAX's bound)
HTTP_STREAM, HTTP_FULL, HTTP_GEN = 8, 4, 16
HTTP_CANCEL_GEN = 400


def fp8_kernel_rows(snap8, params8, flush):
    """(a) each e4m3 route at the fp8 serve path's inputs (layer 0's fp8
    pages, the lanes' tables and lengths at the snapshot step; bf16 q):
    decode, the fused layer (layer 0's weights) and verify (k 4), each
    against its plain version with its times, byte bound (1 byte an
    element of K/V) and the SDPA yardstick of ``measure_paged``."""
    import torch

    from repro_torch.models import transformer

    bf = torch.bfloat16
    kp, vp = snap8["pages"]["k"][0], snap8["pages"]["v"][0]
    tb = torch.from_numpy(snap8["tables"]).cuda()
    le = torch.from_numpy(snap8["lengths"] + 1).cuda()
    rows = {}
    q = torch.randn(CAPACITY, NH, HD, device="cuda").to(bf)
    rows["paged"] = measure_paged(q, kp, vp, tb, le, None, "bfloat16", flush)
    lp = transformer.layer_slices(params8["layers"], 1)[0]
    weights = tuple(t.to(bf).contiguous() for t in (
        lp["attn"]["wo"], lp["mlp_norm"]["scale"], lp["mlp"]["w_gate"],
        lp["mlp"]["w_up"], lp["mlp"]["w_down"]))
    h = torch.randn(CAPACITY, D_MODEL, device="cuda").to(bf)
    rows["fused"] = measure_fused(h, q, kp, vp, tb, le, weights, None,
                                  "bfloat16", flush)
    qv = torch.randn(CAPACITY, DRAFT_K, NH, HD, device="cuda").to(bf)
    committed = torch.from_numpy(snap8["lengths"]).cuda()
    rows["verify"] = measure_verify(qv, kp, vp, tb, committed, None,
                                    "bfloat16", flush)
    for name, m in rows.items():
        # decode and fused take rows with the current token; verify the
        # committed rows its k queries follow
        m["lengths"] = (committed if name == "verify" else le).tolist()
        lib = "-" if m["library_ms"] is None else f"{m['library_ms']:.4f}"
        log(f"[fp8 (a)] {name} e4m3 route at the fp8 serve path's inputs "
            f"(lengths {m['lengths']}): ms={m['ms']:.4f} "
            f"plain_ms={m['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={m['bound_ms']:.4f} ({m['bound_by']}) "
            f"bound_share={m['bound_share']:.3f} "
            f"max_abs_err={m['max_abs_err']:.3g}")
        if not m["within_tol"]:
            fail(f"fp8 (a): the {name} kernel's e4m3 route disagrees with "
                 "its plain version at the fp8 serve path's inputs")
    return rows


def fp8_vs_bf16_step(cfg, params16, snap16):
    """One decode step of the bf16 serve's snapshot with its pages as they
    are and cast to e4m3 (the fp8 cache's view of the same rows), both
    through the kernels: the mean |softmax delta| (JAX's fp8 test bound)."""
    import torch

    from repro_torch.models import api

    dev = "cuda"
    args = (torch.from_numpy(snap16["tables"]).to(dev),
            torch.from_numpy(snap16["lengths"]).to(dev),
            torch.from_numpy(snap16["tokens"]).long().to(dev))
    cfg8 = cfg.replace(kv_cache_dtype=FP8)
    probs = {}
    with torch.no_grad():
        for key, c, dt in (("bf16", cfg, torch.bfloat16),
                           ("fp8", cfg8, torch.float8_e4m3fn)):
            pages = {k: v.to(dt) for k, v in snap16["pages"].items()}
            probs[key] = torch.softmax(api.paged_decode_step(
                c, params16, pages, *args, impl="cuda").float(), dim=-1)
            del pages
    delta = (probs["fp8"] - probs["bf16"]).abs()
    # the mean runs over the whole vocabulary (151,936 entries), so the
    # total variation (half the row's sum) is printed beside it
    res = {"mean_abs_dp": float(delta.mean()),
           "max_abs_dp": float(delta.max()),
           "total_variation": float(delta.sum(-1).max() / 2),
           "argmax_flips": int((probs["fp8"].argmax(-1)
                                != probs["bf16"].argmax(-1)).sum())}
    log(f"[fp8 (b)] one decode step, fp8 vs bf16 pages of the same rows: "
        f"mean |dp| {res['mean_abs_dp']:.3g} (limit {FP8_DP_TOL}), max "
        f"{res['max_abs_dp']:.3g}, largest total variation of a lane "
        f"{res['total_variation']:.3g}, argmax flips {res['argmax_flips']} of "
        f"{CAPACITY}")
    if not (res["mean_abs_dp"] < FP8_DP_TOL
            and bool(torch.isfinite(probs["fp8"]).all())):
        fail(f"fp8 (b): mean |dp| {res['mean_abs_dp']} against the bf16 "
             f"cache is not under {FP8_DP_TOL}")
    return res


def fp8_spec_serve(cfg8, params, prompts):
    """Spec over a paged inner of fp8 pages, the target's own parameters
    as the draft: the verify kernel's e4m3 route runs spec_rounds x 28."""
    from repro_torch.kernels.paged_verify import paged_verify_lanes
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.paging import blocks_for_rows

    max_seq = max(len(p) for p in prompts) + FP8_GEN
    budget = (CAPACITY * blocks_for_rows(max_seq + DRAFT_K, BS)
              * api.kv_block_bytes(cfg8, BS)
              + CAPACITY * api.decode_state_bytes(cfg8, 1,
                                                   max_seq + DRAFT_K))
    eng = InferenceEngine(cfg8, params, capacity=CAPACITY, max_seq=max_seq,
                          backend="spec", spec_inner="paged", draft_cfg=cfg8,
                          draft_params=params, draft_k=DRAFT_K,
                          block_size=BS, kv_budget_bytes=budget,
                          device="cuda")
    _, res, summary = drive_serve(cfg8, eng, prompts, paged_verify_lanes,
                                  "fp8 spec", gen=FP8_GEN)
    res["spec_rounds"] = summary["spec_rounds"]
    res["accepted_tokens_per_target_step"] = \
        summary["accepted_tokens_per_target_step"]
    if res["launches"] != summary["spec_rounds"] * cfg8.n_layers:
        fail(f"fp8 spec: paged_verify launched {res['launches']} times; "
             f"expected spec_rounds x layers = "
             f"{summary['spec_rounds'] * cfg8.n_layers}")
    return res


def phase_fp8_serve(cfg, params, prompts, flush):
    """(b) full-width qwen3-0.6b on fp8 pages against bf16 pages, then the
    fused and spec paths over fp8 pages; (a) the e4m3 kernel rows."""
    import torch

    from repro_torch.kernels.fused_decode import fused_decode_layer
    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.serving.engine import InferenceEngine

    cfg8 = cfg.replace(kv_cache_dtype=FP8)
    max_seq = max(len(p) for p in prompts) + GEN
    out = {}
    runs = {}
    for key, c in (("bf16", cfg), ("fp8", cfg8)):
        eng = InferenceEngine(c, params, capacity=CAPACITY, max_seq=max_seq,
                              backend="paged", block_size=BS, device="cuda")
        snap, res, summary = drive_serve(c, eng, prompts,
                                         paged_attention_lanes,
                                         f"{key} paged", snap_step=8)
        if res["launches"] != summary["decode_steps"] * c.n_layers:
            fail(f"fp8 (b) {key}: paged_attention launched "
                 f"{res['launches']} times; expected decode_steps x layers "
                 f"= {summary['decode_steps'] * c.n_layers}")
        runs[key] = (eng, snap, res)
        del eng
    (eng8, snap8, r8), (eng16, snap16, r16) = runs["fp8"], runs["bf16"]
    if eng8.pool.pages["k"].dtype != torch.float8_e4m3fn:
        fail(f"fp8 (b): the pool holds {eng8.pool.pages['k'].dtype} pages")
    half = (2 * r8["kv_page_peak_bytes"] == r16["kv_page_peak_bytes"]
            and 2 * r8["block_bytes"] == r16["block_bytes"])
    same = sum(r8["tokens"][k] == r16["tokens"][k] for k in r8["tokens"])
    out["serve"] = {**r8, "bf16_kv_page_peak_bytes": r16["kv_page_peak_bytes"],
                    "bf16_block_bytes": r16["block_bytes"],
                    "bf16_decode_tok_per_s": r16["decode_tok_per_s"],
                    "requests_token_identical_to_bf16": same}
    log(f"[fp8 (b)] paged over e4m3 pages: {r8['requests']} requests x "
        f"{GEN} tokens, decode_steps {r8['decode_steps']}, kernel launches "
        f"{r8['launches']} (= decode_steps x {cfg.n_layers}), "
        f"kv_page_peak_bytes {r8['kv_page_peak_bytes']} vs bf16 "
        f"{r16['kv_page_peak_bytes']}, block_bytes {r8['block_bytes']} vs "
        f"{r16['block_bytes']}, decode {r8['decode_tok_per_s']} tok/s (bf16 "
        f"{r16['decode_tok_per_s']}), requests token-identical to bf16 "
        f"{same} of {r8['requests']} (not gated)")
    if not half:
        fail("fp8 (b): the e4m3 pool's page peak and block bytes are not "
             "half of the bf16 pool's")
    out["both_ways"] = phase_both_ways(cfg8, eng8, snap8, params)
    out["vs_bf16"] = fp8_vs_bf16_step(cfg, eng16.params, snap16)
    del runs, eng16, snap16
    torch.cuda.empty_cache()

    feng = InferenceEngine(cfg8, params, capacity=CAPACITY,
                           max_seq=max(len(p) for p in prompts) + FP8_GEN,
                           backend="paged", paged_impl="fused",
                           block_size=BS, device="cuda")
    _, fres, fsum = drive_serve(cfg8, feng, prompts, fused_decode_layer,
                                "fp8 fused", gen=FP8_GEN)
    del feng
    if fres["launches"] != fsum["decode_steps"] * cfg.n_layers:
        fail(f"fp8 fused: fused_decode_layer launched {fres['launches']} "
             f"times; expected decode_steps x layers = "
             f"{fsum['decode_steps'] * cfg.n_layers}")
    out["fused"] = fres
    out["spec"] = fp8_spec_serve(cfg8, params, prompts)
    log(f"[fp8 (b)] fused over e4m3 pages: {FP8_GEN} tokens a request, "
        f"decode_steps {fres['decode_steps']}, fused launches "
        f"{fres['launches']}, decode {fres['decode_tok_per_s']} tok/s; spec "
        f"(self-draft, k {DRAFT_K}) over e4m3 pages: spec_rounds "
        f"{out['spec']['spec_rounds']}, verify launches "
        f"{out['spec']['launches']}, accepted tokens a target step "
        f"{out['spec']['accepted_tokens_per_target_step']}")
    torch.cuda.empty_cache()
    out["kernels"] = fp8_kernel_rows(snap8, eng8.params, flush)
    del eng8, snap8
    return out


def http_client(url, body, stream):
    """One HTTP client: POST a completion, read the SSE stream (or the
    JSON body); returns its ids, the final event, the TTFT seen by the
    client and the decode rate after the first token."""
    import http.client
    host, port = url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/v1/completions",
                     json.dumps(dict(body, stream=stream)),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            return {"status": resp.status, "error": resp.read().decode()}
        if not stream:
            obj = json.loads(resp.read().decode())
            return {"status": 200, "ids": obj["choices"][0]["token_ids"],
                    "request_id": obj["id"], "e2e_s":
                    time.perf_counter() - t0}
        ids, times, final = [], [], None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):]
            if data == b"[DONE]":
                break
            event = json.loads(data)
            choice = event["choices"][0]
            if "token_id" in choice:
                ids.append(choice["token_id"])
                times.append(time.perf_counter())
            else:
                final = event
        ttft = times[0] - t0 if times else None
        rate = ((len(times) - 1) / (times[-1] - times[0])
                if len(times) > 1 and times[-1] > times[0] else None)
        return {"status": 200, "ids": ids, "final": final,
                "request_id": final["id"] if final else None,
                "ttft_s": ttft, "tok_per_s": rate,
                "e2e_s": time.perf_counter() - t0}
    finally:
        conn.close()


def http_json(url, method, path, body=None):
    """One JSON request: (status, decoded body)."""
    import http.client
    host, port = url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request(method, path, None if body is None
                     else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def recording_submit(frontend):
    """Wrap ``frontend.submit`` to keep every Request it returns, by id:
    the engine's own record of each request's tokens."""
    seen = {}
    submit = frontend.submit

    def wrapped(*a, **k):
        req = submit(*a, **k)
        seen[req.request_id] = req
        return req
    frontend.submit = wrapped
    return seen


def phase_http(cfg, params, prompts, smi):
    """(c) ``HydraHTTPServer`` on 127.0.0.1, port 0, over full-width
    qwen3-0.6b on the paged backend: 8 streaming and 4 non-streaming
    clients at once; a mid-decode ``/v1/cancel``; ``/v1/metrics`` back to
    its baseline; then a small f32 engine's HTTP tokens against the same
    engine type decoding offline."""
    import threading

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.models import api
    from repro_torch.serving import (HydraHTTPServer, InferenceEngine,
                                     MultiModelServer)

    max_seq = max(len(p) for p in prompts) + HTTP_CANCEL_GEN
    eng = InferenceEngine(cfg, params, capacity=CAPACITY, max_seq=max_seq,
                          backend="paged", block_size=BS, device="cuda",
                          model_name=cfg.name)
    srv = HydraHTTPServer(MultiModelServer({cfg.name: eng}),
                          host="127.0.0.1", port=0)
    out = {}
    with srv:
        url = srv.url
        seen = recording_submit(srv.frontend)
        _, base = http_json(url, "GET", "/v1/metrics")
        if http_json(url, "GET", "/health") != (200, {"status": "ok"}):
            fail("http (c): /health did not answer ok")
        bodies = [({"model": cfg.name, "prompt": p.tolist(),
                    "max_tokens": HTTP_GEN, "request_id": f"s{i}"}, True)
                  for i, p in enumerate(prompts[:HTTP_STREAM])]
        bodies += [({"model": cfg.name, "prompt": p[:128].tolist(),
                     "max_tokens": HTTP_GEN, "request_id": f"f{i}"}, False)
                   for i, p in enumerate(prompts[:HTTP_FULL])]
        results = [None] * len(bodies)
        steps0 = eng.decode_steps
        paged_attention_lanes.launches = 0     # count this path's run only

        def client(i):
            results[i] = http_client(url, *bodies[i])
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = paged_attention_lanes.launches
        steps = eng.decode_steps - steps0
        if any(r is None or r["status"] != 200 for r in results):
            fail(f"http (c): a client failed: {results}")
        for (body, stream), r in zip(bodies, results):
            rid = body["request_id"]
            req = seen.get(rid)
            if req is None or list(map(int, req.generated)) != r["ids"] \
                    or len(r["ids"]) != HTTP_GEN:
                fail(f"http (c) {rid}: the client got {r['ids']}, the "
                     f"engine generated "
                     f"{None if req is None else req.generated}")
        if launches != steps * cfg.n_layers:
            fail(f"http (c): paged_attention launched {launches} times "
                 f"over {steps} decode steps x {cfg.n_layers} layers")
        streams = [r for r in results if "ttft_s" in r]
        ttft = sorted(r["ttft_s"] for r in streams)
        rates = sorted(r["tok_per_s"] for r in streams)
        out["load"] = {
            "clients_streaming": HTTP_STREAM, "clients_full": HTTP_FULL,
            "max_tokens": HTTP_GEN, "wall_s": wall, "decode_steps": steps,
            "launches": launches, "ttft_s": ttft, "tok_per_s": rates,
            "ttft_median_s": statistics.median(ttft),
            "tok_per_s_median": statistics.median(rates),
            "e2e_full_s": sorted(r["e2e_s"] for r in results
                                 if "ttft_s" not in r)}
        log(f"[http (c)] {HTTP_STREAM} streaming + {HTTP_FULL} non-streaming "
            f"clients x {HTTP_GEN} tokens over qwen3-0.6b paged: wall "
            f"{wall:.3f} s, {steps} decode steps, paged kernel launches "
            f"{launches} (= steps x {cfg.n_layers}); streamed ids = the "
            f"engine's for all {len(results)}; client TTFT median "
            f"{out['load']['ttft_median_s'] * 1e3:.1f} ms (min "
            f"{ttft[0] * 1e3:.1f}, max {ttft[-1] * 1e3:.1f}), per-stream "
            f"decode median {out['load']['tok_per_s_median']:.1f} tok/s "
            f"({smi})")

        # a mid-decode cancel: lane and KV freed within one tick
        done = []
        rid = "cancel-1"
        body = {"model": cfg.name, "prompt": prompts[2].tolist(),
                "max_tokens": HTTP_CANCEL_GEN, "request_id": rid}
        t = threading.Thread(target=lambda: done.append(
            http_client(url, body, True)))
        t.start()
        deadline = time.time() + 60
        while time.time() < deadline and not (
                rid in seen and seen[rid].generated):
            time.sleep(0.005)
        if not (rid in seen and seen[rid].generated):
            fail("http (c): the request to cancel never started decoding")
        status, ack = http_json(url, "POST", "/v1/cancel",
                                 {"request_id": rid})
        ticks_ack = srv.frontend.ticks
        t_ack = time.perf_counter()
        while time.perf_counter() - t_ack < 30:
            if eng.n_free_lanes == CAPACITY and \
                    eng.budget.reserved_bytes == 0:
                break
            time.sleep(0.001)
        freed_s = time.perf_counter() - t_ack
        ticks_to_free = srv.frontend.ticks - ticks_ack
        t.join(timeout=60)
        n_streamed = len(done[0]["ids"]) if done else None
        finish = (done[0]["final"]["choices"][0]["finish_reason"]
                  if done and done[0]["final"] else None)
        out["cancel"] = {"ack": ack, "status": status, "freed_s": freed_s,
                         "ticks_to_free": ticks_to_free,
                         "tokens_streamed": n_streamed,
                         "tokens_saved": HTTP_CANCEL_GEN - (n_streamed or 0),
                         "finish_reason": finish}
        log(f"[http (c)] /v1/cancel mid-decode after {n_streamed} tokens: "
            f"lane and KV free {freed_s * 1e3:.2f} ms after the ack, "
            f"{ticks_to_free} tick(s), finish_reason {finish!r}")
        if not (status == 200 and ack["cancelled"] and ticks_to_free <= 1
                and eng.n_free_lanes == CAPACITY
                and eng.budget.reserved_bytes == 0 and finish == "cancelled"
                and n_streamed < HTTP_CANCEL_GEN):
            fail(f"http (c): the cancel did not free lane and KV within a "
                 f"tick: {out['cancel']}")
        _, after = http_json(url, "GET", "/v1/metrics")
        keys = ("free_lanes", "kv_reserved_bytes")
        b, a = base["engines"][cfg.name], after["engines"][cfg.name]
        out["metrics"] = {"before": {k: b[k] for k in keys},
                          "after": {k: a[k] for k in keys},
                          "n_submitted": after["n_submitted"],
                          "n_completed": after["n_completed"],
                          "n_cancelled": after["n_cancelled"],
                          "ticks": after["ticks"]}
        if any(a[k] != b[k] for k in keys) or after["n_submitted"] != \
                len(bodies) + 1 or after["n_cancelled"] != 1:
            fail(f"http (c): /v1/metrics not back to its baseline: "
                 f"{out['metrics']}")
        log(f"[http (c)] /v1/metrics back to baseline: {out['metrics']}")
    del eng, srv
    torch.cuda.empty_cache()

    # a small f32 model: HTTP tokens = its offline engine's
    scfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    sparams = api.init_params(scfg, torch.Generator("cuda").manual_seed(5),
                              "cuda")
    rng = np.random.default_rng(5)
    sprompts = [rng.integers(0, scfg.vocab_size, n, dtype=np.int32)
                for n in (5, 17, 9, 12)]
    offline = []
    for p in sprompts:
        e = InferenceEngine(scfg, sparams, capacity=1, max_seq=64,
                            backend="paged", block_size=8, device="cuda")
        r = e.submit(p, 12)
        e.run()
        offline.append(list(map(int, r.generated)))
    seng = InferenceEngine(scfg, sparams, capacity=3, max_seq=64,
                           backend="paged", block_size=8, device="cuda")
    with HydraHTTPServer(MultiModelServer({"small": seng})) as ssrv:
        got = [None] * len(sprompts)

        def sclient(i):
            got[i] = http_client(ssrv.url, {
                "model": "small", "prompt": sprompts[i].tolist(),
                "max_tokens": 12}, i % 2 == 0)["ids"]
        threads = [threading.Thread(target=sclient, args=(i,))
                   for i in range(len(sprompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    out["small_f32"] = {"requests": len(sprompts),
                        "identical": sum(g == o for g, o in
                                         zip(got, offline))}
    log(f"[http (c)] small f32 model over HTTP (2 streaming, 2 not, 3 "
        f"lanes): tokens equal its offline engine's for "
        f"{out['small_f32']['identical']} of {len(sprompts)}")
    if out["small_f32"]["identical"] != len(sprompts):
        fail("http (c): the small f32 model's HTTP tokens differ from its "
             "offline engine's")
    return out


def phase_http_cli():
    """(c) the serve CLI's HTTP mode on its default device, the card:
    ``python -m repro_torch.launch.serve --arch qwen3-0.6b --backend paged
    --http --port 0`` prints its first line, answers ``/health``, streams
    a completion whose ids equal a non-streamed one's, and stops on
    SIGINT (its Ctrl-C path)."""
    import os
    import select
    import signal

    err_path = ROOT / "build" / "phase24_cli.err"
    err_path.parent.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "qwen3-0.6b", "--backend", "paged", "--http", "--port", "0",
             "--max-seq", "64"], stdout=subprocess.PIPE, stderr=err,
            env=env, cwd=str(ROOT))
        try:
            ready = select.select([proc.stdout], [], [], 300)[0]
            line = proc.stdout.readline() if ready else b""
            if not line:
                fail("http (c) CLI: no first line; stderr: "
                     + err_path.read_text()[-2000:])
            first = json.loads(line)
            up_s = time.perf_counter() - t0
            url = first["url"]
            body = {"model": "qwen3-0.6b", "prompt": [5, 17, 42],
                    "max_tokens": 8}
            health = http_json(url, "GET", "/health")
            status, full = http_json(url, "POST", "/v1/completions", body)
            streamed = http_client(url, body, True)
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            proc.stdout.close()
    ids = full["choices"][0]["token_ids"] if status == 200 else None
    res = {"first_line": first, "up_s": up_s, "health": health[1],
           "ids": ids, "streamed_ids": streamed.get("ids"), "rc": rc}
    log(f"[http (c)] serve CLI --http --port 0 on the card: first line "
        f"{json.dumps(first)} after {up_s:.1f} s, /health {health}, "
        f"completion ids {ids}, streamed {res['streamed_ids']}, exit "
        f"{rc} on SIGINT")
    if not (set(first) == {"url", "models"} and first["models"] ==
            ["qwen3-0.6b"] and health == (200, {"status": "ok"})
            and ids is not None and len(ids) == 8
            and res["streamed_ids"] == ids and rc == 0):
        fail(f"http (c): the serve CLI's HTTP mode failed: {res}")
    return res


def phase_checkpoint(params, smi):
    """(d) full-width qwen3-0.6b params saved (``checkpoint.save``, the JAX
    format) from the card and restored: bit-equal leaves and dtypes, with
    the rates (host wall, the device-to-host copies included)."""
    import shutil

    import torch

    from repro_torch import checkpoint
    from repro_torch.tree import tree_leaves

    d = ROOT / "build" / "phase24_ckpt" / "step_1"
    shutil.rmtree(d.parent, ignore_errors=True)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(str(d), params, step=1,
                        metadata={"arch": "qwen3-0.6b"})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, manifest = checkpoint.restore(
            checkpoint.latest_step(str(d.parent)), like=params)
        restore_s = time.perf_counter() - t0
        same = all(a.dtype == b.dtype and torch.equal(a.cpu(), b)
                   for a, b in zip(tree_leaves(params), tree_leaves(got)))
    finally:
        shutil.rmtree(d.parent, ignore_errors=True)
    res = {"bytes": nbytes, "leaves": len(manifest["leaves"]),
           "save_s": save_s, "restore_s": restore_s,
           "save_gb_per_s": nbytes / save_s / 1e9,
           "restore_gb_per_s": nbytes / restore_s / 1e9,
           "bit_equal": same}
    log(f"[ckpt (d)] qwen3-0.6b params, {nbytes} B in {res['leaves']} "
        f"leaves: save {save_s:.2f} s ({res['save_gb_per_s']:.3f} GB/s, "
        f"device to npz), restore {restore_s:.2f} s "
        f"({res['restore_gb_per_s']:.3f} GB/s, npz to host tensors); "
        f"bit-equal {same} ({smi})")
    if not same:
        fail("ckpt (d): restored params differ from the saved ones")
    return res


def phase_fp8_http(flush, smi):
    """Phase 24: (a) + (b) the fp8 KV cache at full width, (c) the HTTP
    front end, (d) checkpoints."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api

    t0 = time.perf_counter()
    cfg = get_config("qwen3-0.6b")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    prompts = serve_prompts(cfg.vocab_size)
    out = {"fp8": phase_fp8_serve(cfg, params, prompts, flush)}
    torch.cuda.empty_cache()
    out["http"] = phase_http(cfg, params, prompts, smi)
    out["http"]["cli"] = phase_http_cli()
    torch.cuda.empty_cache()
    out["checkpoint"] = phase_checkpoint(params, smi)
    del params
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"[fp8/http] phase wall {out['phase_s']:.2f} s ({smi})")
    return out


# ---------------------------------------------------------------------------
# phase 25: training over a device mesh, the training CLI, the lowering dry
# run and the roofline
# ---------------------------------------------------------------------------

SPMD_STEPS, SPMD_BATCH, SPMD_SEQ, SPMD_LR = 20, 8, 256, 3e-4
CLI_STEPS = 10


def _spmd_rates(lines, batch, seq):
    """Trained tok/s over steps 1..n from ``_run_spmd``'s log lines (each
    prints the cumulative rate since the loop began, step 0's DTensor
    placement search included)."""
    rows = []
    for line in lines:
        parts = line.split()
        if len(parts) >= 8 and parts[0] == "step" and parts[-1] == "tok/s":
            step, rate = int(parts[1]), float(parts[-2])
            rows.append((step, batch * seq * (step + 1) / rate))
    (s0, t0), (sn, tn) = rows[0], rows[-1]
    return {"cumulative_tok_per_s": batch * seq * (sn + 1) / tn,
            "trained_tok_per_s": batch * seq * (sn - s0) / (tn - t0),
            "step0_s": t0}


def phase_spmd_session(smi):
    """(a) a ``Session`` + ``SpmdTrainJob`` on the card (``mesh="auto"``:
    a (1, 1) NCCL mesh of one rank), against ``make_train_step`` without
    a mesh from the same seed and batches."""
    import contextlib
    import io

    import torch

    from repro_torch.api import Session, SpmdTrainJob
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, SyntheticTokens,
                                           as_tensors)
    from repro_torch.models import api
    from repro_torch.optim.optimizers import OptimizerConfig, init_state
    from repro_torch.training import make_train_step

    cfg = get_config("qwen3-0.6b")
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    sess = Session(device="cuda")
    jid = sess.submit(SpmdTrainJob(cfg, steps=SPMD_STEPS, batch=SPMD_BATCH,
                                   seq=SPMD_SEQ, lr=SPMD_LR, seed=0,
                                   log_every=1))
    with contextlib.redirect_stdout(buf):
        rec = sess.run().spmd[jid]
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    lines = buf.getvalue().splitlines()
    losses = [h["loss"] for h in rec["history"]]
    rates = _spmd_rates(lines, SPMD_BATCH, SPMD_SEQ)
    torch.cuda.empty_cache()

    # the same 3 steps without a mesh: same seed, schedule and batches
    ocfg = OptimizerConfig(kind="adamw", lr=SPMD_LR,
                           schedule="linear_warmup_cosine",
                           warmup_steps=max(SPMD_STEPS // 20, 1),
                           total_steps=SPMD_STEPS)
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    state = init_state(ocfg, params)
    step = make_train_step(cfg, ocfg)
    it = iter(SyntheticTokens(DataConfig(batch_size=SPMD_BATCH,
                                         seq_len=SPMD_SEQ,
                                         vocab_size=cfg.vocab_size, seed=0)))
    ref = []
    for _ in range(3):
        params, state, m = step(params, state, as_tensors(next(it), "cuda"))
        ref.append(float(m["loss"]))
    del params, state
    torch.cuda.empty_cache()
    diff = max(abs(a - b) for a, b in zip(losses[:3], ref))
    res = {"losses": losses, "reference_losses": ref, "max_abs_diff": diff,
           "wall_s": wall, "max_memory_allocated": peak, **rates,
           "params": rec["params"], "log_lines": lines[:3] + lines[-1:]}
    log(f"[spmd (a)] Session + SpmdTrainJob, qwen3-0.6b full width on a "
        f"(1, 1) NCCL mesh, {SPMD_STEPS} steps of {SPMD_BATCH} x "
        f"{SPMD_SEQ}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; first 3 "
        f"vs make_train_step without a mesh: max |diff| {diff:.3g} "
        f"(tol {SHARP_TOL}); trained {rates['trained_tok_per_s']:.0f} tok/s "
        f"(steps 1-{SPMD_STEPS - 1}; {rates['cumulative_tok_per_s']:.0f} "
        f"with step 0's {rates['step0_s']:.1f} s), max memory allocated "
        f"{peak / 1e9:.2f} GB, run {wall:.1f} s ({smi})")
    if not all(math.isfinite(x) for x in losses):
        fail(f"spmd (a): a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"spmd (a): the last loss {losses[-1]} is not below the first "
             f"{losses[0]}")
    if not diff <= SHARP_TOL:
        fail(f"spmd (a): the first 3 losses {losses[:3]} differ from "
             f"make_train_step's {ref} by {diff} > {SHARP_TOL}")
    return res


def phase_spmd_cli(smi):
    """(b) ``python -m repro_torch.launch.train`` on its default device
    (the card) with a checkpoint: exit 0, the JSON line, and the final
    checkpoint restored bit for bit (a restore saved again restores to
    the same bits, every leaf in its param's shape and dtype)."""
    import os
    import tempfile

    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.sharding.specs import leaves_with_path

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "qwen3-0.6b", "--steps", str(CLI_STEPS), "--ckpt-dir", tmp],
            capture_output=True, text=True, env=env, cwd=str(ROOT),
            timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"spmd (b): the training CLI exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        tree, man = ckpt.restore(f"{tmp}/step_{CLI_STEPS}")
        ckpt.save(f"{tmp}/again", tree, step=man["step"])
        again, _ = ckpt.restore(f"{tmp}/again")
    like = api.init_params(get_config("qwen3-0.6b"), torch.Generator(),
                           "meta")
    want = {"/".join(map(str, p)): v for p, v in leaves_with_path(like)}
    same = tree.keys() == again.keys() == want.keys() and all(
        tree[k].dtype == again[k].dtype == want[k].dtype
        and tuple(tree[k].shape) == tuple(want[k].shape)
        and torch.equal(tree[k].view(torch.uint8), again[k].view(torch.uint8))
        and bool(torch.isfinite(tree[k].float()).all()) for k in tree)
    res = {"json": out, "rc": proc.returncode, "wall_s": wall,
           "manifest_step": man["step"], "restored_bit_for_bit": same,
           "log_lines": proc.stdout.strip().splitlines()}
    log(f"[spmd (b)] python -m repro_torch.launch.train --arch qwen3-0.6b "
        f"--steps {CLI_STEPS} on the card: exit 0, {json.dumps(out)}, "
        f"{wall:.1f} s with start-up; checkpoint step {man['step']} "
        f"restored bit for bit: {same} ({smi})")
    if not (set(out) == {"final_loss", "params"}
            and math.isfinite(out["final_loss"]) and same
            and man["step"] == CLI_STEPS):
        fail(f"spmd (b): the training CLI's result or checkpoint is "
             f"wrong: {res}")
    return res


def phase_spmd_lowering(smi):
    """(c) the lowering dry run of qwen3-0.6b at decode_32k on the
    256-rank fake mesh, then the roofline over its record — an analysis
    of a 256-H100 mesh, not a time measured on the card."""
    import os
    import tempfile

    import contextlib
    import io

    from repro_torch.launch import roofline

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen3-0.6b", "--shape", "decode_32k", "--out",
             f"{tmp}/dry.jsonl"], capture_output=True, text=True, env=env,
            cwd=str(ROOT), timeout=600)
        if proc.returncode != 0:
            fail(f"spmd (c): repro_torch.launch.dryrun exited "
                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        # the roofline's CLI entry point in this process (no process of its
        # own to start: it reads the record and writes two files)
        with contextlib.redirect_stdout(io.StringIO()):
            roofline.main(["--dryrun", f"{tmp}/dry.jsonl", "--out",
                           f"{tmp}/roof.json", "--markdown",
                           f"{tmp}/roof.md"])
        wall = time.perf_counter() - t0
        rec = json.loads(Path(f"{tmp}/dry.jsonl").read_text().splitlines()[0])
        (row,) = json.loads(Path(f"{tmp}/roof.json").read_text())
    rf = row["roofline"]
    res = {"status": rec["status"], "mesh": rec["mesh"],
           "bytes_per_device": rec.get("bytes_per_device"),
           "flops_per_device": rec.get("hlo_flops_per_device"),
           "collectives": rec.get("collectives"),
           "trace_s": rec.get("compile_s"), "roofline": rf, "wall_s": wall}
    if rec["status"] != "ok" or row["status"] != "ok" or rf is None:
        fail(f"spmd (c): the dry run or the roofline failed: {rec}")
    log(f"[spmd (c)] lowering dry run, qwen3-0.6b decode_32k on the "
        f"256-rank fake mesh {rec['mesh']} (an analysis for 256 H100s, not "
        f"a time on this card): peak {rec['bytes_per_device']['peak'] / 1e9:.2f}"
        f" GB per device, {rec['hlo_flops_per_device']:.3e} FLOPs and "
        f"{rec['collectives']['total'] / 1e9:.3f} GB of collectives per "
        f"device; roofline terms compute {rf['t_compute_s']:.3e} s, memory "
        f"{rf['t_memory_s']:.3e} s, collective {rf['t_collective_s']:.3e} s "
        f"-> {rf['dominant']}-bound ({wall:.1f} s for both; {smi})")
    return res


def phase_spmd(smi):
    """Phase 25: training over a device mesh (a), the training CLI (b),
    the lowering dry run and the roofline (c)."""
    import torch

    t0 = time.perf_counter()
    out = {"a": phase_spmd_session(smi)}
    torch.cuda.empty_cache()
    out["b"] = phase_spmd_cli(smi)
    out["c"] = phase_spmd_lowering(smi)
    out["phase_s"] = time.perf_counter() - t0
    log(f"[spmd] phase wall {out['phase_s']:.2f} s ({smi})")
    return out


# ---------------------------------------------------------------------------
# phase 26: the three remaining examples at full width, and the mesh decode
# over a sequence-sharded cache in the dry run
# ---------------------------------------------------------------------------

LARGE_BUDGET = 2 * 10**9        # ~8x under bert-large-1b's 17 GB of state
LARGE_STEPS, LARGE_BATCH, LARGE_SEQ = 4, 2, 512
# three grid points: SHARP's timeline chains each model's transfers and
# units, so two full-width models on 4 devices finish no sooner than
# model parallelism runs both one after the other (2.09 against 2.08 s
# on an H100); a third model is where SHARP's overlap shows.  One step
# (the example's two): both makespans scale with the steps, and the
# script stays inside its time limit
SELECT_POINTS, SELECT_STEPS, SELECT_SEQ = 3, 1, 512
SELECT_DEVICES, SELECT_BUDGET = 4, 11 * 10**9   # the paper's 11e9 B
SERVE_BUDGET = 40 * 10**9      # a mixtral-8x22b layer passes 11e9 B
DECODE_32K_RECORD = ("2.12", "4.484e+09", "0.379")   # GB, FLOPs, GB


def load_example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class LedgerWatch:
    """Every ``DeviceMemory`` ledger's high-water mark while the block
    runs (its ``charge_promotion`` wrapped at class level, so the ledgers
    of sessions an example makes inside are seen): ``peaks`` maps each
    ledger to ``[peak used bytes, budget]``."""

    def __enter__(self):
        from repro_torch.core.spilling import DeviceMemory
        self.peaks, self._orig = {}, DeviceMemory.charge_promotion
        orig, peaks = self._orig, self.peaks

        def charge(dm, nbytes, *, into_buffer):
            orig(dm, nbytes, into_buffer=into_buffer)
            rec = peaks.setdefault(id(dm), [0, dm.budget])
            rec[0] = max(rec[0], dm.used_bytes())
        DeviceMemory.charge_promotion = charge
        return self

    def __exit__(self, *exc):
        from repro_torch.core.spilling import DeviceMemory
        DeviceMemory.charge_promotion = self._orig
        return False

    def over_budget(self) -> list:
        return [v for v in self.peaks.values() if v[0] > v[1]]


def phase_examples_large(smi, device="cuda"):
    """(a) ``examples/large_model_single_device_torch.py`` at full width:
    bert-large-1b (the paper's BERT-Large*-1B) trained on one device of
    2e9 B, 4 steps of 2 x 512, through spilling, then evaluated at a
    third of the budget (the least budget that plans where a segment does
    not fit, and why).  Gates: the model's state exceeds the budget;
    >= 2 shards; no ledger over its budget; units = steps x 2 x shards;
    the losses equal plain full-model training on the card, and the
    eval's mean loss a plain forward's, at 3e-4."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.orchestrator import (ModelTask,
                                               train_sequential_reference)
    from repro_torch.data.pipeline import as_tensors
    from repro_torch.models import api
    from repro_torch.training.losses import softmax_xent
    from repro_torch.tree import tree_map

    ex = load_example("large_model_single_device_torch")
    cfg = get_config("bert-large-1b")
    budget, why = LARGE_BUDGET, None
    while True:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with LedgerWatch() as watch:
                out = ex.main(device=device, cfg=cfg, budget=budget,
                              steps=LARGE_STEPS, batch=LARGE_BATCH,
                              seq=LARGE_SEQ)
        except MemoryError as e:
            if "alone exceeds" not in str(e) or budget >= 4 * LARGE_BUDGET:
                fail(f"examples (a): {e}")
            why, budget = str(e), int(budget * 1.25)
            continue
        break
    wall = time.perf_counter() - t0
    peak_alloc = torch.cuda.max_memory_allocated()
    ev = out["eval"]
    n_shards = len(out["shards"])

    # the eval's batch through a plain forward of the trained weights
    trained = tree_map(lambda v: v.to(device),
                       out.pop("train_exec").store.model_params())
    batch = as_tensors(next(iter(ex.loader(cfg, 7, LARGE_BATCH,
                                           LARGE_SEQ))), device)
    with torch.no_grad():
        plain_eval = float(softmax_xent(api.forward(cfg, trained, batch),
                                        batch["labels"]))
    del trained, batch
    gc.collect()
    torch.cuda.empty_cache()
    empty_host_cache()
    _, ref = train_sequential_reference(ModelTask(
        cfg, ex.loader(cfg, 0, LARGE_BATCH, LARGE_SEQ), lr=1e-3, epochs=1,
        steps_per_epoch=LARGE_STEPS, batch=LARGE_BATCH, seq=LARGE_SEQ),
        device=device)
    torch.cuda.empty_cache()
    loss_diff = float(np.abs(np.subtract(out["losses"], ref)).max())
    eval_diff = abs(ev["mean_loss"] - plain_eval)
    res = {"budget": budget, "budget_raised_because": why,
           "model_bytes": out["model_bytes"], "shards": out["shards"],
           "losses": out["losses"], "reference_losses": ref,
           "max_abs_loss_diff": loss_diff,
           "units_executed": out["units_executed"],
           "promoted_bytes": out["promoted_bytes"],
           "demoted_bytes": out["demoted_bytes"],
           "ledger_peaks": sorted(watch.peaks.values()),
           "max_memory_allocated": peak_alloc, "wall_s": wall,
           "eval": {k: ev[k] for k in ("n_shards", "bytes_moved",
                                       "mean_loss", "perplexity")},
           "eval_budget": out["eval_budget"], "plain_eval_loss": plain_eval,
           "eval_abs_diff": eval_diff}
    log(f"[examples (a)] large_model_single_device_torch: bert-large-1b "
        f"full width ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_params} params), {out['model_bytes']} B of params + grads "
        f"+ Adam on one device of {budget} B"
        + (f" (raised from {LARGE_BUDGET}: {why})" if why else "")
        + f": {n_shards} shards, {out['units_executed']} units, "
        f"{LARGE_STEPS} steps of {LARGE_BATCH} x {LARGE_SEQ}, losses "
        f"{[round(x, 4) for x in out['losses']]} vs plain full-model "
        f"training on the card {[round(x, 4) for x in ref]}: max |diff| "
        f"{loss_diff:.3g} (tol {SHARP_TOL}); promoted "
        f"{out['promoted_bytes']} B, demoted {out['demoted_bytes']} B; "
        f"ledger peak {max(p for p, _ in watch.peaks.values())} B; spilled "
        f"eval at {out['eval_budget']} B: {ev['n_shards']} shards, "
        f"{ev['bytes_moved']} B moved, mean loss {ev['mean_loss']:.6f} vs "
        f"plain forward {plain_eval:.6f} (|diff| {eval_diff:.3g}), "
        f"perplexity {ev['perplexity']:.2f}; wall {wall:.1f} s, max "
        f"memory allocated {peak_alloc / 1e9:.2f} GB ({smi})")
    if not out["model_bytes"] > budget:
        fail(f"examples (a): the model's {out['model_bytes']} B fit the "
             f"budget {budget}")
    if n_shards < 2:
        fail(f"examples (a): {n_shards} shard(s); a spilled model needs 2+")
    if watch.over_budget():
        fail(f"examples (a): a ledger went over its budget: "
             f"{watch.over_budget()}")
    if out["units_executed"] != LARGE_STEPS * 2 * n_shards:
        fail(f"examples (a): {out['units_executed']} units; expected steps "
             f"x 2 x shards = {LARGE_STEPS * 2 * n_shards}")
    if not np.allclose(out["losses"], ref, rtol=SHARP_TOL, atol=SHARP_TOL):
        fail(f"examples (a): the spilled losses {out['losses']} differ from "
             f"plain training's {ref}")
    if not eval_diff <= SHARP_TOL + SHARP_TOL * abs(plain_eval):
        fail(f"examples (a): the spilled eval's mean loss {ev['mean_loss']} "
             f"differs from a plain forward's {plain_eval}")
    return res


def phase_examples_selection(smi, device="cuda"):
    """(b) ``examples/model_selection_torch.py`` at full width: the grid's
    first three points (lr 1e-3 at batch 2 and 4, 1e-4 at batch 2) of
    bert-large-1b, 1 step of seq 512, on 4 virtual devices of 11e9 B,
    SHARP's transfers at the measured host-to-device rate as in phase 18
    (fewer points where their host stores do not fit in half of
    ``MemAvailable``, phase 18's rule).
    Gates: units = the sum over models of steps x 2 x shards; finite
    losses; task parallelism runs out of memory at 11e9 B; pipeline <=
    model parallelism; SHARP's makespan below model parallelism's."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.partitioner import tree_bytes
    from repro_torch.models import api

    ex = load_example("model_selection_torch")
    cfg = get_config("bert-large-1b")
    store_bytes = 3 * tree_bytes(api.init_params(cfg, torch.Generator(),
                                                 "meta"))
    empty_host_cache()
    avail = settled_mem_available()
    n = SELECT_POINTS
    while n >= 1 and n * store_bytes > avail // 2:
        n -= 1
    if n == 0:
        fail(f"examples (b): one bert-large-1b host store ({store_bytes} B) "
             f"does not fit in half of MemAvailable ({avail} B)")
    grid = ex.GRID[:n]
    # SHARP's timeline charges transfers at the card's measured pinned
    # host-to-device rate, as phase 18's does
    link = h2d_gb_per_s() * 1e9 if device == "cuda" else None
    t0 = time.perf_counter()
    with LedgerWatch() as watch:
        out = ex.main(device=device, cfg=cfg, grid=grid,
                      budget=SELECT_BUDGET, n_devices=SELECT_DEVICES,
                      steps=SELECT_STEPS, seq=SELECT_SEQ, link_bw=link)
    wall = time.perf_counter() - t0
    session = out.pop("session")
    shards = [len(m.partition.shards) for m in session.train_execs]
    del session
    gc.collect()
    torch.cuda.empty_cache()
    empty_host_cache()
    ms = out["makespan"]
    expect = sum(SELECT_STEPS * 2 * s for s in shards)
    res = {**{k: v for k, v in out.items()}, "points": n, "grid": grid,
           "shards": shards, "mem_available": avail,
           "store_bytes_per_model": store_bytes, "link_bw": link,
           "wall_s": wall,
           "ledger_peaks": sorted(watch.peaks.values()),
           "speedup_vs_mp": ms["model_parallel"] / ms["sharp"]}
    log(f"[examples (b)] model_selection_torch: {n} grid point(s) {grid} "
        f"of bert-large-1b full width"
        + ("" if n == SELECT_POINTS else
           f" (not {SELECT_POINTS}: {SELECT_POINTS} host stores of "
           f"{store_bytes} B exceed half of MemAvailable {avail} B)")
        + f", {SELECT_STEPS} step(s) of seq {SELECT_SEQ}, {SELECT_DEVICES} "
        f"virtual devices of {SELECT_BUDGET} B, link_bw "
        f"{(link or 16e9) / 1e9:.2f} GB/s"
        + (" (measured h2d)" if link else "")
        + f": shards {shards}, units "
        f"{out['units_executed']}; makespan SHARP {ms['sharp']:.4f} s, "
        f"model parallel {ms['model_parallel']:.4f} s, pipeline "
        f"{ms['pipeline']:.4f} s (SHARP {res['speedup_vs_mp']:.2f}x model "
        f"parallelism); task parallel at {SELECT_BUDGET} B: "
        + ("CRASH (OOM)" if ms["task_parallel"] is None
           else f"{ms['task_parallel']:.4f} s")
        + f"; losses {out['losses']}; best {out['best']}; wall "
        f"{wall:.1f} s ({smi})")
    if out["units_executed"] != expect:
        fail(f"examples (b): {out['units_executed']} units; expected "
             f"steps x 2 x shards summed = {expect}")
    if not all(np.isfinite(v).all() and len(v) == SELECT_STEPS
               for v in out["losses"].values()):
        fail(f"examples (b): losses not finite or missing: {out['losses']}")
    if ms["task_parallel"] is not None:
        fail(f"examples (b): task parallelism fit a bert-large-1b with its "
             f"optimizer state in {SELECT_BUDGET} B")
    if watch.over_budget():
        fail(f"examples (b): a ledger went over its budget: "
             f"{watch.over_budget()}")
    if ms["pipeline"] > ms["model_parallel"]:
        fail(f"examples (b): pipeline makespan {ms['pipeline']} above model "
             f"parallelism's {ms['model_parallel']}")
    if not ms["sharp"] < ms["model_parallel"]:
        fail(f"examples (b): SHARP's makespan {ms['sharp']} is not below "
             f"model parallelism's {ms['model_parallel']}")
    return res


def phase_examples_serve(smi, device="cuda"):
    """(c) ``examples/serve_batched_torch.py`` at full width: qwen3-0.6b,
    mixtral-8x22b cold (cut to 2 layers for device memory; its shards cut
    for a 40e9 B device, since one of its layers alone passes the default
    11e9 B) and xlstm-350m under LRTF, three prompts each (11, 13, 15
    tokens), 8 new tokens.  Gates: every request gets its 8 tokens; the cold model's
    ``promote_bytes`` > 0; the schedule names all three; only qwen3-0.6b
    keeps its power-of-two buckets.  Decode tok/s printed, not gated."""
    import torch

    from repro_torch.configs import get_config

    ex = load_example("serve_batched_torch")
    full = get_config("mixtral-8x22b")
    cfgs = [get_config("qwen3-0.6b"), full.replace(n_layers=2),
            get_config("xlstm-350m")]
    t0 = time.perf_counter()
    out = ex.main(device=device, cfgs=cfgs, budget=SERVE_BUDGET)
    wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    empty_host_cache()
    recs = {r["model"]: r for r in out["serve"].values()}
    res = {"serve": {m: {k: r.get(k) for k in (
        "n_completed", "prefill_calls", "bucket_sizes", "cold",
        "promote_bytes", "promote_s", "decode_tok_per_s")}
        for m, r in recs.items()},
        "schedule_len": len(out["schedule"]),
        "schedule_head": out["schedule"][:12], "tokens": out["tokens"],
        "wall_s": wall}
    log(f"[examples (c)] serve_batched_torch at full width (mixtral-8x22b "
        f"cut {full.n_layers} -> 2 layers for device memory; widths as "
        f"published; device budget {SERVE_BUDGET} B): "
        + "; ".join(f"{m} {r['n_completed']} done, prefill_calls "
                    f"{r['prefill_calls']}, buckets "
                    f"{'pow2' if r['bucket_sizes'] else None}, decode "
                    f"{r['decode_tok_per_s'] or 0:.1f} tok/s"
                    + (f", cold: promoted {r['promote_bytes']} B in "
                       f"{r['promote_s'] * 1e3:.0f} ms" if r.get("cold")
                       else "")
                    for m, r in recs.items())
        + f"; {len(out['schedule'])} ticks, schedule head "
        f"{out['schedule'][:12]}; wall {wall:.1f} s ({smi})")
    for m, toks in out["tokens"].items():
        if [len(t) for t in toks] != [ex.GEN] * 3:
            fail(f"examples (c): {m}'s requests got {[len(t) for t in toks]}"
                 f" tokens, not {ex.GEN} each")
    if set(recs) != set(ex.ARCHS) or set(out["schedule"]) != set(ex.ARCHS):
        fail(f"examples (c): the schedule names {set(out['schedule'])}, "
             f"not the three models {ex.ARCHS}")
    cold = recs[ex.COLD]
    if not (cold.get("cold") and cold["promote_bytes"] > 0):
        fail(f"examples (c): the cold model promoted nothing: {cold}")
    if [m for m, r in recs.items() if r["bucket_sizes"]] != ["qwen3-0.6b"]:
        fail(f"examples (c): power-of-two buckets on "
             f"{[m for m, r in recs.items() if r['bucket_sizes']]}, not on "
             f"qwen3-0.6b alone")
    return res


def phase_examples_dryrun(smi):
    """(d) the lowering dry run of qwen3-0.6b at long_500k (the cache's
    sequence sharded over every rank) and decode_32k on the 256-rank fake
    mesh, on this machine's torch — an analysis of 256 H100s, not a time
    on the card.  Gates: long_500k moves no K/V plane by all-gather and
    under 1 GB of collectives a device; decode_32k keeps its record
    (2.12 GB peak, 4.484e9 FLOPs, 0.379 GB of collectives a device)."""
    import os
    import tempfile

    from repro_torch.launch.dryrun import kv_plane_gathers

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    shapes = ("long_500k", "decode_32k")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        # the dry run's CLI once a shape, in one process (one start-up)
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys\n"
             "from repro_torch.launch.dryrun import main\n"
             "for shape in sys.argv[2:]:\n"
             "    main(['--arch', 'qwen3-0.6b', '--shape', shape, '--out', "
             "sys.argv[1]])", f"{tmp}/dry.jsonl", *shapes],
            capture_output=True, text=True, env=env, cwd=str(ROOT),
            timeout=600)
        if proc.returncode != 0:
            fail(f"examples (d): the dry runs exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        lines = Path(f"{tmp}/dry.jsonl").read_text().splitlines()
    recs = {rec["shape"]: rec for rec in map(json.loads, lines)}
    wall = time.perf_counter() - t0
    res = {}
    for shape, rec in recs.items():
        if rec["status"] != "ok":
            fail(f"examples (d): the dry run at {shape} failed: {rec}")
        res[shape] = {"peak_gb": rec["bytes_per_device"]["peak"] / 1e9,
                      "flops": rec["hlo_flops_per_device"],
                      "collectives": rec["collectives"],
                      "kv_plane_gathers": kv_plane_gathers(rec),
                      "trace_s": rec["compile_s"]}
        r = res[shape]
        log(f"[examples (d)] dry run qwen3-0.6b {shape} on {rec['mesh']} "
            f"(an analysis of 256 H100s, not a time on the card): peak "
            f"{r['peak_gb']:.2f} GB, {r['flops']:.3e} FLOPs, "
            f"{rec['collectives']['total'] / 1e9:.3f} GB of collectives a "
            f"device ({rec['collectives']['n_ops']} ops: "
            f"{ {k: v for k, v in rec['collectives'].items() if '-' in k} }"
            f"), K/V-plane all-gathers {r['kv_plane_gathers'] or 'none'} "
            f"({smi})")
    res["wall_s"] = wall
    log(f"[examples (d)] both dry runs in one process: {wall:.1f} s")
    long = recs["long_500k"]
    if res["long_500k"]["kv_plane_gathers"] \
            or not long["collectives"]["total"] < 1e9:
        fail(f"examples (d): long_500k still gathers the cache: "
             f"{res['long_500k']}")
    d = recs["decode_32k"]
    got = (f"{d['bytes_per_device']['peak'] / 1e9:.2f}",
           f"{d['hlo_flops_per_device']:.3e}",
           f"{d['collectives']['total'] / 1e9:.3f}")
    if got != DECODE_32K_RECORD:
        fail(f"examples (d): decode_32k's record moved: {got} against "
             f"{DECODE_32K_RECORD}")
    return res


def phase_examples(smi):
    """Phase 26: the three remaining examples at full width (a)-(c), each
    model freed before the next, and the mesh decode's dry runs (d)."""
    import torch

    t0 = time.perf_counter()
    out = {"a": phase_examples_large(smi)}
    torch.cuda.empty_cache()
    out["b"] = phase_examples_selection(smi)
    torch.cuda.empty_cache()
    out["c"] = phase_examples_serve(smi)
    torch.cuda.empty_cache()
    out["d"] = phase_examples_dryrun(smi)
    out["phase_s"] = time.perf_counter() - t0
    log(f"[examples] phase wall {out['phase_s']:.2f} s ({smi})")
    return out


def kernel_entry(name, source, replaces, launches, m, **paths):
    """One kernel's entry of the kernels line; ``paths``: its launches on
    other paths of this run, by name (each counted from 0 over that
    path's own run)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "bound_share": m["bound_share"], **paths}


def main() -> None:
    import argparse
    global LOG_FILE
    ap = argparse.ArgumentParser(description="chip smoke run of the port")
    ap.add_argument("--out-dir", default=None,
                    help="write chip_smoke.json and chip_smoke.log here "
                    "(default: chip_smoke.json under build/, no log copy)")
    args = ap.parse_args()
    out_dir = Path(args.out_dir) if args.out_dir else ROOT / "build"
    if args.out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
        LOG_FILE = out_dir / "chip_smoke.log"
        LOG_FILE.write_text("")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy  # noqa: F401

        from repro_torch import kernels
        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
        from repro_torch.kernels.paged_attention import SPLIT_ROWS, n_splits
        from repro_torch.models import api
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    report: dict = {}

    # 1. environment
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {name} "
        f"count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {smi}")
    report["env"] = {"torch": torch.__version__, "cuda": torch.version.cuda,
                     "device": name, "nvidia_smi": smi}

    # 2 (and 14). build: paged_attention.cu (fp and int8 entry points),
    #    paged_verify.cu, flash_attention.cu, fused_decode.cu, rmsnorm.cu,
    #    swiglu.cu and ssd_scan.cu, one nvcc each, in parallel
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(kernels.KERNELS)} (paged_attention_lanes "
        f"and paged_attention_quant_lanes: split-KV, {SPLIT_ROWS}-row "
        f"splits, then a fixed-order merge, two launches an op call; "
        f"paged_verify_lanes, "
        f"flash_attention_bhsd, fused_decode_layer, rms_norm_2d, "
        f"swiglu_2d, ssd_scan_bshpn) built in "
        f"{build_s:.2f} s (nvcc {_build.nvcc_path()}, sm_90a)")
    for k, text in _build.build_logs.items():
        for line in text.strip().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {k}: {line.strip()}")
    report["build_s"] = build_s

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    # 3. each kernel against its plain version over its sweep
    report["sweep"] = phase_kernel_sweep(flush)
    report["verify_sweep"] = phase_verify_sweep(flush)
    report["quant_sweep"] = phase_quant_sweep(flush)
    report["fused_sweep"] = phase_fused_sweep(flush)
    report["rms_swiglu_sweep"], probe_shape = phase_rms_swiglu_sweep(flush)

    # 4. serve full-width qwen3-0.6b on the paged backend
    cfg = get_config("qwen3-0.6b")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    prompts = serve_prompts(cfg.vocab_size)
    eng, snap, report["serve"] = phase_serve(cfg, params, prompts)

    # the kernel's numbers at the serve path's own inputs (layer 0 pages
    # and the lanes' lengths at the snapshot step)
    le = torch.from_numpy(snap["lengths"] + 1).cuda()
    tb = torch.from_numpy(snap["tables"]).cuda()
    q = torch.randn(CAPACITY, NH, HD, device="cuda").to(torch.bfloat16)
    main_path = measure_paged(q, snap["pages"]["k"][0], snap["pages"]["v"][0],
                              tb, le, None, "bfloat16", flush)
    main_path["lengths"] = le.tolist()
    main_path["splits"] = n_splits(tb.shape[1], BS)
    log(f"[kernel] paged_attention at the serve path's inputs "
        f"(lengths {main_path['lengths']}, {tb.shape[1]}-block tables, "
        f"splits={main_path['splits']}): ms={main_path['ms']:.4f} "
        f"plain_ms={main_path['plain_ms']:.4f} "
        f"library_ms={main_path['library_ms']:.4f} "
        f"bound_ms={main_path['bound_ms']:.4f}"
        f" bound_share={main_path['bound_share']:.3f} "
        f"max_abs_err={main_path['max_abs_err']:.3g}")
    if not main_path["within_tol"]:
        fail("paged_attention kernel disagrees with its plain version at "
             "the serve path's inputs")
    report["main_path_kernel"] = main_path

    # 5. one step both ways, and one profiled step
    report["both_ways"] = phase_both_ways(cfg, eng, snap, params)
    report["profile"] = phase_profile(cfg, eng, snap)
    bf16_params = eng.params
    del eng, snap
    torch.cuda.empty_cache()

    # 5b. the same requests through the fused decode layer
    report["fused_serve"] = phase_fused_serve(
        cfg, params, prompts, report["serve"], report["profile"], flush)
    torch.cuda.empty_cache()

    # 6. speculative serve over the paged inner: (a) the target's own
    #    parameters as the draft (every round accepts k), (b) a random
    #    4-layer qwen3-0.6b draft from seed 1 (rollback every round)
    _, report["spec_self"] = phase_spec_serve(
        cfg, params, prompts, cfg, params, "spec (a) self-draft")
    dcfg = cfg.replace(n_layers=4)
    dparams = api.init_params(dcfg, torch.Generator("cuda").manual_seed(1),
                              "cuda")
    vsnap, report["spec_random"] = phase_spec_serve(
        cfg, params, prompts, dcfg, dparams, "spec (b) random 4-layer draft")
    del dparams
    for key in ("spec_self", "spec_random"):
        r = report[key]
        r["requests_token_identical_to_paged"] = sum(
            r["tokens"][k] == report["serve"]["tokens"][k]
            for k in r["tokens"])
    lanes = (vsnap["tables"] != 0).any(dim=1)
    qv = torch.randn(CAPACITY, DRAFT_K, NH, HD,
                     device="cuda").to(torch.bfloat16)
    verify_path = measure_verify(qv, vsnap["pages"]["k"][0],
                                 vsnap["pages"]["v"][0], vsnap["tables"],
                                 vsnap["lengths"], None, "bfloat16", flush,
                                 lanes=lanes)
    verify_path["lengths"] = vsnap["lengths"].tolist()
    verify_path["lanes_in_round"] = int(lanes.sum())
    log(f"[kernel] paged_verify at the spec serve path's inputs (k "
        f"{DRAFT_K}, lengths {verify_path['lengths']}, "
        f"{verify_path['lanes_in_round']} lanes in the round): "
        f"ms={verify_path['ms']:.4f} plain_ms={verify_path['plain_ms']:.4f} "
        f"library_ms={verify_path['library_ms']:.4f} "
        f"bound_ms={verify_path['bound_ms']:.4f}"
        f" bound_share={verify_path['bound_share']:.3f} "
        f"max_abs_err={verify_path['max_abs_err']:.3g}")
    if not verify_path["within_tol"]:
        fail("paged_verify kernel disagrees with its plain version at the "
             "spec serve path's inputs")
    report["verify_path_kernel"] = verify_path
    report["verify_both_ways"] = phase_verify_both_ways(cfg, vsnap, params,
                                                        bf16_params)
    del vsnap
    torch.cuda.empty_cache()

    # 7. serve from an int8 paged pool
    ieng, isnap, report["int8_serve"] = phase_int8_serve(
        cfg, params, prompts, report["serve"])
    del ieng
    qq = torch.randn(CAPACITY, NH, HD, device="cuda").to(torch.bfloat16)
    pg = isnap["pages"]
    quant_path = measure_quant(
        qq, pg["k"][0], pg["v"][0], pg["k_scale"][0], pg["v_scale"][0],
        torch.from_numpy(isnap["tables"]).cuda(),
        torch.from_numpy(isnap["lengths"] + 1).cuda(), None, flush)
    quant_path["lengths"] = (isnap["lengths"] + 1).tolist()
    quant_path["splits"] = n_splits(isnap["tables"].shape[1], BS)
    log(f"[kernel] paged_attention_quant at the int8 serve path's inputs "
        f"(lengths {quant_path['lengths']}, {isnap['tables'].shape[1]}-block"
        f" tables, splits={quant_path['splits']}): "
        f"ms={quant_path['ms']:.4f} "
        f"plain_ms={quant_path['plain_ms']:.4f} "
        f"library_ms={quant_path['library_ms']:.4f} "
        f"bound_ms={quant_path['bound_ms']:.4f}"
        f" bound_share={quant_path['bound_share']:.3f} "
        f"max_abs_err={quant_path['max_abs_err']:.3g}")
    if not quant_path["within_tol"]:
        fail("paged_attention_quant kernel disagrees with its plain version "
             "at the int8 serve path's inputs")
    report["quant_path_kernel"] = quant_path
    report["int8_both_ways"] = phase_int8_both_ways(cfg, isnap, params,
                                                    bf16_params)
    report["int8_profile"] = phase_profile(
        cfg, SimpleNamespace(params=bf16_params), isnap,
        "one int8 decode step (8 lanes)")
    del isnap, bf16_params, params
    torch.cuda.empty_cache()

    # 8. small float32 engines both ways
    report["small_f32"] = phase_small_f32()
    torch.cuda.empty_cache()

    # 9. the flash kernel against its plain version over its sweep
    report["flash_sweep"] = phase_flash_sweep(flush)
    torch.cuda.empty_cache()

    # 10. SHARP training of two full-width models through the Session
    session, report["sharp_train"] = phase_sharp_train(cfg)
    torch.cuda.empty_cache()

    # 11. spilled eval of model 0's trained params, kernel and plain
    report["spilled_eval"] = phase_spilled_eval(
        cfg, session.train_execs[0].store.model_params(), flush)
    flash_path = report["spilled_eval"]["main_path_kernel"]
    torch.cuda.empty_cache()

    # 12. one SHARP forward unit and one backward unit, profiled
    report["unit_profiles"] = phase_unit_profiles(session)
    del session
    torch.cuda.empty_cache()

    # 13. the machine profiler, and plans priced with its facts
    report["profiler"] = phase_profiler(cfg, report["sharp_train"])
    torch.cuda.empty_cache()

    # 15. the SSD scan kernel against its plain version over its sweep
    report["ssd_sweep"] = phase_ssd_sweep(flush)

    # 16. full-width zamba2-1.2b: (a) serve, (b) spilled eval and (c) a
    #     forward through the SSD kernel, (d) SHARP, (e) small f32 engine
    zcfg = get_config("zamba2-1.2b")
    zparams = api.init_params(zcfg, torch.Generator("cuda").manual_seed(0),
                              "cuda")
    report["zamba_serve"] = phase_zamba_serve(zcfg, zparams,
                                              zamba_prompts(zcfg.vocab_size))
    report["zamba_eval"] = phase_zamba_eval(zcfg, zparams, flush)
    ssd_path = report["zamba_eval"]["main_path_kernel"]
    del zparams
    torch.cuda.empty_cache()
    zsession, report["zamba_sharp"] = phase_sharp_train(
        zcfg, Z_TRAIN_BUDGET, Z_TRAIN_STEPS)
    del zsession
    torch.cuda.empty_cache()
    report["zamba_small_f32"] = phase_small_hybrid_f32()
    torch.cuda.empty_cache()

    # 17. training and serving in one Session: phase 10's first model, a
    #     hot paged and a cold slot qwen3-0.6b, then a small f32 session
    #     and profiler --smoke
    report["session_serve"] = phase_session_serve(
        cfg, report["sharp_train"]["losses"][0],
        report["serve"]["tokens"], report["profiler"]["path"])

    # 18. the paper's Fig 8: up to 12 full-width bert-large-1b models
    #     under SHARP, then model, pipeline and task parallelism replayed
    #     over the same measured unit runtimes
    report["fig8"] = phase_fig8(smi)
    torch.cuda.empty_cache()

    # 19. phase 4's requests with length-bucketed prefill, and without
    report["bucketed_serve"] = phase_bucketed_serve(
        cfg, prompts, report["serve"]["tokens"], smi)
    torch.cuda.empty_cache()

    # 20. tiered memory: KV pages demoted to pinned host slabs and
    #     prefetched back (fp and int8 pools, eager and pressure-driven),
    #     shard-resident weights of three models under one ledger, small
    #     f32 engines
    report["tiering"] = phase_tiering(cfg, smi)
    torch.cuda.empty_cache()

    # 21. planning and the async session: the probe oracle at full width,
    #     its plan saved and run by a fresh session, run_async beside a
    #     hot paged serve job, the quickstart and make_grad_step
    report["probe_async"] = phase_probe_async(
        cfg, smi, prompts, report["sharp_train"]["losses"][0],
        report["sharp_train"]["trained_tok_per_s"])
    torch.cuda.empty_cache()

    # 22. ROADMAP item 8 up to MoE: the kernels at 5, 6, 7 and 12 query
    #     heads per KV head, the three widest dense configs served, mixtral
    #     and dbrx served, mixtral's spilled eval and SHARP, small f32
    #     engines
    report["item8"] = phase_item8(flush, smi)
    torch.cuda.empty_cache()

    # 23. ROADMAP item 8's second half: the kernels at llava's and
    #     whisper's shapes, llava-next-mistral-7b served on four backends
    #     and evaluated from embeddings, whisper-medium and vit-300m under
    #     SHARP, small f32 engines
    report["item8b"] = phase_item8b(flush, smi)
    torch.cuda.empty_cache()

    # 24. the fp8 KV cache (e4m3 pages through the decode, fused and
    #     verify kernels), the HTTP/SSE front end, checkpoints
    report["fp8_http"] = phase_fp8_http(flush, smi)
    torch.cuda.empty_cache()

    # 25. training over a device mesh: Session + SpmdTrainJob on a (1, 1)
    #     NCCL mesh, the training CLI and its checkpoint, the lowering dry
    #     run and the roofline
    report["spmd"] = phase_spmd(smi)
    torch.cuda.empty_cache()

    # 26. the remaining examples at full width — large-model training and
    #     eval through spilling, model selection against the baselines,
    #     three families served — and the mesh decode's dry runs
    report["examples"] = phase_examples(smi)
    torch.cuda.empty_cache()
    report["total_s"] = time.perf_counter() - t_start
    vlm = report["item8b"]["vlm_launches"]
    fp8 = report["fp8_http"]["fp8"]

    src = "src/repro_torch/kernels/csrc/"
    kernel_line = {"kernels": [
        kernel_entry("paged_attention_lanes", src + "paged_attention.cu",
                     "src/repro/kernels/paged_attention.py:76",
                     report["serve"]["launches"], main_path,
                     tiered_launches=report["tiering"]["a"]["tiered"][
                         "launches"],
                     async_launches=report["probe_async"]["c"]["launches"],
                     wide_gqa_launches=report["item8"][
                         "wide_gqa_launches"],
                     vlm_launches=vlm["paged"],
                     http_launches=report["fp8_http"]["http"]["load"][
                         "launches"]),
        kernel_entry("paged_verify_lanes", src + "paged_verify.cu",
                     "src/repro/kernels/paged_verify.py:81",
                     report["spec_random"]["launches"], verify_path,
                     vlm_launches=vlm["spec"]),
        kernel_entry("paged_attention_quant_lanes",
                     src + "paged_attention.cu",
                     "src/repro/kernels/paged_attention.py:164",
                     report["int8_serve"]["launches"], quant_path,
                     tiered_launches=report["tiering"]["c"]["launches"],
                     vlm_launches=vlm["int8"]),
        kernel_entry("flash_attention_bhsd", src + "flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:74",
                     report["spilled_eval"]["cuda"]["launches"],
                     flash_path,
                     moe_eval_launches=report["item8"][
                         "moe_eval_launches"],
                     audio_launches=report["item8b"]["audio_launches"]),
        kernel_entry("fused_decode_layer", src + "fused_decode.cu",
                     "src/repro/kernels/fused_decode.py:92",
                     report["fused_serve"]["launches"],
                     report["fused_serve"]["main_path_kernel"],
                     vlm_launches=vlm["fused"]),
        kernel_entry("rms_norm_2d", src + "rmsnorm.cu",
                     "src/repro/kernels/rmsnorm.py:22",
                     report["profiler"]["launches"]["rms_norm_2d"],
                     probe_shape["rms_norm"]),
        kernel_entry("swiglu_2d", src + "swiglu.cu",
                     "src/repro/kernels/swiglu.py:44",
                     report["profiler"]["launches"]["swiglu_2d"],
                     probe_shape["swiglu"]),
        kernel_entry("ssd_scan_bshpn", src + "ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:60",
                     report["zamba_eval"]["kernel_forward"]["launches"],
                     ssd_path),
        # the e4m3 page routes of the three kernels that read pages
        kernel_entry("paged_attention_lanes[e4m3 pages]",
                     src + "paged_attention.cu",
                     "src/repro/kernels/paged_attention.py:76",
                     fp8["serve"]["launches"], fp8["kernels"]["paged"]),
        kernel_entry("fused_decode_layer[e4m3 pages]",
                     src + "fused_decode.cu",
                     "src/repro/kernels/fused_decode.py:92",
                     fp8["fused"]["launches"], fp8["kernels"]["fused"]),
        kernel_entry("paged_verify_lanes[e4m3 pages]",
                     src + "paged_verify.cu",
                     "src/repro/kernels/paged_verify.py:81",
                     fp8["spec"]["launches"], fp8["kernels"]["verify"]),
    ]}
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['total_s']:.1f} s")
    log(json.dumps(kernel_line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
