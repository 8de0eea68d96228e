#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

It drives the port's paths once, each at full width -- serving qwen3-0.6b,
falcon-mamba-7b and hymba-1.5b, int8 MobileNet-V2 1.0-224 on the N-EUREKA
operators, qwen3-0.6b again from a paged 4-bit store whose cold half is
wire-served, both qwen3-0.6b stores once more behind the deadline-aware
``Scheduler`` under XR traffic, qwen3-0.6b with its KV cache paged,
alone and beside falcon-mamba-7b as two tenants of one page pool, the
MoE qwen2-moe-a2.7b on the grouped expert kernel, training qwen3-0.6b,
the serving launcher and the XR pipeline example, in process through
their ``main``, then the VLM llava-next-34b, the encoder-decoder
whisper-tiny and hymba-1.5b's segmented window path, training of the
MoE, SSM, hybrid, VLM and encoder-decoder families with hymba-1.5b
trained (8 of its 32 layers) and served, the launcher's ``main`` on
gemma-7b (head dim 256), qwen2.5-3b, olmo-1b and llava-next-34b and the
MoE store's cold expert pages wire-served, hymba-1.5b and paged
qwen3-0.6b in bfloat16 on the kernels' bf16 routes, paged qwen3-0.6b
sharded over four links of one mesh, through the launcher's ``--mesh 4``
and ``attach_paging(mesh=)``, the MoE store in bfloat16, and last
full-width qwen3-0.6b trained on a mesh of four ``torch.distributed``
ranks of the one card a layer at a time, and the reference's own train
cell (bf16, Adafactor, ``moe_groups`` 0) of qwen2-moe-a2.7b on four ranks,
and four cells of the dry-run counted as one rank of the production mesh
and timed on the card -- and fails (non-zero exit, no result line) if any
phase fails:

1. set-up: requires a CUDA device, turns TF32 off, prints the card's name
   and power limit, builds every ``csrc/*.cu`` with nvcc for sm_90a (one
   nvcc each, in parallel), prints what ptxas reports for each kernel and
   fails if the tensor-core kernels of the f32 matmuls (``qmm_dec``,
   ``bs_dec`` for M <= 16, ``qmm_tc``, ``bs_tc`` above), the flash kernel
   (``flash_fwd_tc``), the scan's two routes (``scan_step``,
   ``scan_chunked``), the int8 MMA kernels (``qmm_int8_direct``,
   ``qmm_int8_staged``, ``dense3x3_mma``) or the depthwise kernel
   (``dw3x3_vec``, every instantiation) spill, each with its bf16
   instantiations and the flash kernel's bf16 route (``flash_fwd_bf16``),
   or if ``cuobjdump --dump-sass`` finds no ``IMMA`` in an int8 MMA
   kernel, no TF32 ``HMMA`` in the flash kernel or no bf16
   ``HMMA.16816.F32.BF16`` in its bf16 route;
2. each Hopper kernel against its plain PyTorch version on the card, at the
   shapes its path gives it: ``qmatmul_f32``, ``flash_attention`` and
   ``selective_scan`` within the stated tolerances (flash at each tile the
   kernel holds, with GQA 2 and 5, windows, hymba's long prompt and rows
   that see no key, and two calls bit-equal; the scan also at a ragged S,
   with and without h0, at N 4 / 8 / 32 on a ragged Di, on each side of
   its route threshold, and its dt = 0 pads bit-exact no-ops on both
   routes);
   ``qmatmul_int8``, ``conv3x3_dense`` and ``conv3x3_dw`` bit for bit
   (``torch.equal``) at every distinct MobileNet-V2 job shape at 224, at 8,
   4 and 2 bits, at the ragged shapes of the reference's kernel tests (and
   dense 3x3 at Cin 40 and 64, depthwise 3x3 at C 24, 17 and 1, and
   ``qmatmul_int8`` on each side of its plan's K-split thresholds) and at
   requant ties; ``qmatmul_f32`` and
   ``qmatmul_f32_blockscale`` must
   also give the same bits on two calls.  Then each is timed with CUDA
   events (L2-cold: inputs rotate over more than the 50 MB L2) beside its
   plain version, one PyTorch library call for the same function where
   there is one, and its bound: bytes over 3.35 TB/s, or operations over
   67 TFLOP/s (f32), 1,979 TOP/s (int8 tensor cores) or the SFUs'
   exponential rate, whichever is larger; the f32 matmuls and flash
   attention at their own route, two (matmuls) or three (flash) TF32
   passes at 495 TFLOP/s, with the f32 CUDA-core bound beside it.  Besides
   qwen3-0.6b's layer, falcon-mamba-7b's four linears of a layer are timed
   at M = 4 and 256, and so are llava-next-34b's seven; flash at
   qwen3-0.6b's prefill chunk, hymba-1.5b's longest prompt,
   llava-next-34b's prefill of phase 12, whisper-tiny's encoder and
   gemma-7b's prefill chunk at head dim 256; the grouped
   ``qmatmul_f32_blockscale_grouped`` (B3 over a stack of experts' int8
   wire-form pages) against its plain version at qwen2-moe-a2.7b's expert
   shapes (E 60, C 8 and 24, a ragged C, one expert; experts with no rows
   give zeros, two calls bit-equal) and timed at one layer's three expert
   linears at C 8 and 24 beside ``torch.bmm`` on pre-dequantised f32; the scan at falcon-mamba-7b's and hymba-1.5b's prefill
   and decode; the N-EUREKA kernels at MobileNet-V2 jobs (``NEUREKA_TIMED``:
   ``conv3x3_dw`` at b0.dw, b1.dw and b14.dw, its largest stride-1 and
   stride-2 maps and its smallest one).
   Device times replay a CUDA graph of the calls, so the host's
   launch gaps drop out; the same calls enqueued eagerly from Python are
   printed beside them;
3. serving, three times: full-width qwen3-0.6b (28 layers, d_model 1024),
   falcon-mamba-7b (32 of its 64 layers, ``SERVE_LAYERS``, d_model 4096,
   d_inner 8192) and hymba-1.5b
   (32 layers, d_model 1600, 128 meta tokens, window 1024 with 3 global
   layers), each with random weights from a seeded CUDA ``torch.Generator``,
   frozen at 8 bits, ``ServingEngine(batch_slots=4)`` on the card answering
   8 greedy requests (prompts of 16-256 tokens, and one of 1,000-1,200 for
   hymba so that its window binds; 16 new tokens each); the launch counters
   of the family's kernels are set to 0 before and must have grown after;
4. after each serve: the same requests again on a fresh engine under
   ``torch.profiler``, with every call the model code makes to
   ``qmatmul_f32``, ``flash_attention`` and ``selective_scan`` noted (and
   counted: flash launches by shape, scan launches by route); each
   kernel is then held against its plain version at every distinct call
   shape (and window, offsets, h0 use) of that serve, on random inputs.
   Then card vs CPU: ``forward`` logits of one 64-token sequence with the
   same packed weights on the card (kernels) and on the CPU (plain
   versions); all layers of qwen3-0.6b, the first 2 of falcon-mamba-7b and
   the first 4 of hymba-1.5b, and for hymba also its longest served prompt,
   where the window binds;
5. frames: MobileNet-V2 1.0-224 with random weights from a seeded
   ``torch.Generator``, frozen at 8 bits on the card, runs 16 random uint8
   frames through ``apply``; the N-EUREKA launch counters must grow by
   exactly 1 / 17 / 35 a frame; the tree frozen on the card must equal
   the CPU's; two frames must equal the plain path on the CPU bit for
   bit, and one frame each frozen at 4 and 2 bits too.  It prints the
   eager and CUDA-graph frame times, peak memory, and from
   ``torch.profiler`` the device time by kernel and by job (each
   ``qmatmul_int8`` job with its launch plan) and the device's idle share
   of the eager frames; the k-th N-EUREKA kernel of the profile must be
   job k's operator, and the per-job times summed by operator must equal
   the per-kernel sums;
6. paged serving (§II-B2 virtual paging with wire-serve): full-width
   qwen3-0.6b, its first ``PAGED_LAYERS`` (14) of 28 layers, with random
   weights from a seeded CUDA ``torch.Generator``,
   frozen at 4 bits; ``plan_for_budget`` pins half the store's bytes on the
   card and int8-pages the rest; ``attach_paging(wire_serve=True)`` keeps
   the cold groups on the host, pinned, and every tick streams them to the
   card as int8 pages with per-32 scales, CRC-checked, which
   ``qmatmul_f32_blockscale`` multiplies from that wire form; once the
   caller's own cold leaves go to the host too, the card's memory must
   have fallen by the cold groups' bytes.  First
   ``qmatmul_f32_blockscale`` is held against its plain version (the
   reference test's shapes, bits 2, ragged K, the cold linears) and timed
   like the others, at decode M = 4 and prefill M = 256.  Then the 8
   requests of phase 3 are served: the launch counters of
   ``qmatmul_f32``, ``qmatmul_f32_blockscale`` and ``flash_attention`` are
   set to 0 before and must have grown after; swaps and misses must equal
   the ticks times ``pass_counters``, nothing may be decoded on the host,
   and each tick is split into its page wait (the worker's CRC and copy)
   and compute.  The tokens must equal, per uid and bit for bit, those of
   a resident engine holding the same wire-form bytes on the card, and
   those of the same serve under ``FaultPlan(seed=3, fail_rate=0.2,
   bitflip_rate=0.2)`` (with faults injected, and every checksum failure
   refetched); one pass begun before a forward and fenced after must give
   the pages of a sync pass; the kernels are checked at every call of a
   profiled serve; and the wire tree's logits (4 layers) on the card must
   match the CPU's;
7. the scheduled XR serve: the XR traffic of
   ``benchmarks/serving_load.py`` (copied: the bench imports JAX) -- a
   t = 0 backlog of best-effort assistant requests (16-48 prompt tokens,
   24 new) and a hand-tracking (priority 2, 15 ms deadline) and a gaze
   request (priority 1, 10 ms; 2-8 prompt tokens, 2 new) every 6 ms --
   served by ``serving.Scheduler`` on the bench's virtual clock (1 ms a
   tick) with its defaults (4 slots, max_len 128, prefill chunk 16, token
   budget 96, ``est_tick_s`` pinned), on the first ``XR_LAYERS`` (4) of
   qwen3-0.6b's 28 layers at full width (cut so that the script ends
   within 1,200 s; the decisions on this clock hold at any depth).  (a)
   Phase 3's 8-bit qwen3-0.6b tree, 60 requests, under both legs of the
   bench: run-to-completion, and
   continuous (token budget, preemption, reject-mode admission; traced).
   It fails unless every uid's tokens are equal across the legs, the
   continuous leg preempted, the trackers' miss rate is <= 0.05 and the
   assistant's tokens per virtual second are >= 0.90 of the baseline's
   (the bench's gate), both metrics documents pass ``metrics.validate``
   and the trace ``trace.validate``, and ``qmatmul_f32`` and
   ``flash_attention`` launched in each leg.  (b) The same traffic on a
   2-layer smoke config of qwen3-0.6b on the CPU: each leg's decisions
   (per uid: arrival, admission, first-token and finish times on the
   virtual clock, preemptions, rejection, degradation, ``max_new_tokens``;
   the scheduler's counters) must equal the card's, since on this clock
   they depend only on the traffic.  (c) Phase 6's paged store, 24
   requests, continuous leg with ``async_io=True``: swaps and misses must
   equal the ticks times ``pass_counters`` under preemption, the tokens
   must equal per uid those of a resident engine on the same wire-form
   bytes under the same leg (a reference run, whose launches are not
   counted), and ``qmatmul_f32_blockscale`` must have launched.  The
   kernels are checked against their plain versions at every distinct call
   of the continuous legs of (a) and (c) (the short-prompt prefill buckets
   and the decode tiles that the scheduler's budget gives them).  (d) The
   same paged leg on the real clock
   (``time.perf_counter``), printed as a smoke reading: TTFT p50 / p99 by
   stream, tok/s, miss rate, exposed and hidden page wait and
   ``overlap_frac``, the predicted-vs-measured stall ratio; nothing is
   asserted on these times;
8. KV paging and tenancy, the two-tenant leg of
   ``benchmarks/serving_load.py`` (``_tenant_reqs`` copied: prompts of
   2-47 tokens, 8 new tokens each, a third of them on each XR stream) at
   its defaults (4 slots, max_len 128, prefill chunk 16, ``budget_frac``
   0.5, ``shared_budget_frac`` 0.6, KV blocks of 16 rows, ``async_io``).
   Each tenant is phase 3's 8-bit tree cut to its first layers at full
   width (``TENANCY_LAYERS``: 4 of qwen3-0.6b's 28, 8 of
   falcon-mamba-7b's 64, cut so that the script, build included, ends
   within 1,200 s; the checks hold at any depth, and phase 11 (c) pages
   falcon-mamba-7b's full-depth leaves beside qwen3-0.6b's KV blocks).
   (a) That qwen3-0.6b tree with its cold half
   (``attach_paging``) and its KV cache (``attach_kv_paging(16)``) joined
   to one ``SharedPagePool`` (0.6 of the cold bytes), 24 requests through
   ``Scheduler``: the tokens must equal per uid those of a resident
   unpaged engine (a reference run, not counted); every pool member's
   swaps, misses, pool hits, evictions, drops and wire / raw bytes must
   equal the ``kv_pass_counters`` replay of the pool's event log; the KV
   table's swaps times its page bytes must equal its streamed bytes, and
   ``memsys.kv_stream_bytes`` over the spans its fetch batches listed its
   swaps plus pool hits.  (b) That tree and phase 3's falcon-mamba-7b
   tree, each half-paged, as two tenants of one ``MultiScheduler`` and
   one pool (0.6 of both cold halves), qwen3-0.6b KV-paged, 8 requests a
   tenant: each tenant's tokens must equal its solo run on a private
   pager (reference runs, not counted), the counters the replay, and the
   metrics v9 multi document must pass ``metrics.validate``.  Both legs'
   kernel calls are recorded and each distinct call of ``qmatmul_f32``,
   ``flash_attention`` and ``selective_scan`` is held against its plain
   version; each leg must have launched them.  The pool summaries, the KV
   exposed / hidden seconds and the host wall a tick are printed as smoke
   readings;
9. the MoE family: ``qmatmul_f32_grouped`` (B1 over a stack of experts
   in one launch) against its plain version at qwen2-moe-a2.7b's expert
   shapes (E 60; C 8, 16 and 24; (K, N) (2048, 1408) and (1408, 2048)),
   a ragged C on each route, E = 1 on each, bits 4 and 2, with experts
   that got no rows giving zeros and two calls bit-equal; timed like the
   others (one layer's three expert linears at C 8 and 24) beside the
   plain version and ``torch.bmm`` on pre-dequantised f32 weights.  Then
   qwen2-moe-a2.7b at full width (24 layers, d_model 2048, 60 experts
   top-4 of d_ff 1408, a shared expert of 5632, vocab 151,936) with
   random weights from a seeded CUDA ``torch.Generator``, each weight
   frozen at 8 bits as it is drawn (``init_params(bits=)``, the
   launcher's draw), served as in phases 3-4 (8 requests;
   the grouped and plain ``qmatmul_f32`` and ``flash_attention`` counters
   set to 0 before and grown after; every distinct call of the profiled
   serve, grouped ones included, against its plain version; the first 2
   layers' logits card vs CPU within ``LOGITS_TOL``);
10. training qwen3-0.6b (``launch/steps.make_train_step`` -> ``lm_loss`` ->
   ``chunked_attention``; f32 matmuls, TF32 off; no Hopper kernel, as the
   reference trains through no Pallas kernel).  (a) One step of 2
   full-width layers (d_model 1024, 16 / 8 heads of 128, d_ff 3072, vocab
   151,936), batch 2 x 128, on the card against the CPU from the same
   weights and batch: the loss within 1e-5 relative, every gradient leaf
   present, finite and non-zero on the card and within 1e-4 of the CPU
   leaf's largest element, one AdamW step's loss and grad norm within
   1e-5; C9: each Hopper kernel wrapper raises for an input that requires
   grad (and launches under ``torch.no_grad``), and ``forward`` over a
   tree that requires grad raises at the flash kernel.  (b) All 28 layers,
   ``remat`` on, AdamW at 3e-4, batch 4 x 256, 6 steps through
   ``Trainer`` on ``SyntheticLMDataset(seed=0)``: the last loss below the
   first; step time on the host clock (the loss read inside the step),
   tokens/s and peak device memory printed; the ~7.2 GB checkpoint
   deleted.  (c) 4 full-width layers, 8 steps, a checkpoint every 3, a
   failure injected at step 5, against an uninterrupted run, in a
   subprocess (``python3 chip_smoke.py --train-restart``) with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and
   ``torch.use_deterministic_algorithms(True)``: ``restarts`` exactly 1
   and every leaf of the params and AdamW state bit-equal.  (d) (b)'s
   trained tree, its leaves set to require grad, frozen at 8 bits (C10:
   no packed leaf requires grad) and served, 4 requests: the B1 and B2
   counters, zeroed before, grown after, each kernel held against its
   plain version at every distinct call of the serve; the first layer's
   logits card vs CPU within ``LOGITS_TOL``.  (e) ``dtype="bfloat16"``
   (bf16 weights, f32 optimizer state, no master copy): (i) (a)'s check
   at bf16, the loss within 1e-3 relative, each gradient leaf within 3e-2
   of the CPU leaf's largest element (``TRAIN_BF16_TOL``: both round every
   bf16 op, in their own orders), one AdamW step's loss and grad norm
   within 5e-3; (ii) (b) at bf16 from (b)'s weights cast to bf16, on (b)'s
   batches: the last loss below the first, each step's loss printed
   beside (b)'s f32 loss, step time, tokens/s and peak memory;
11. the launcher and the XR pipeline, each through the ``main`` a user
   calls, in this process.  (a) ``repro_torch.launch.serve.main`` on
   full-width qwen3-0.6b at 4 bits, ``--budget-mb`` half of the packed
   linears of the tree it draws (``packed_sizes``, printed), ``--kv-paged
   --requests 8 --max-new 16 --deadline-ms 20 --preemptive --token-budget
   64``: both verify lines (paged against the resident plan, async
   against sync streaming with the counters and ticks unchanged) must
   print BIT-EXACT, and a failed verify's ``sys.exit(1)`` fails the
   phase; every request must get its 16 tokens and the metrics v9
   document must validate.  (b) ``examples/xr_pipeline_torch.py``'s
   ``main`` with ``--img 224 --full``: MobileNet-V2 1.0-224 frames, one
   tenancy tick a frame of full-width qwen3-0.6b (KV-paged) and
   falcon-mamba-7b through one ``MultiScheduler`` and one pool, every
   assert of the example (a preemption by the wake request, preemptions
   equal to restores, the pool on the ``kv_pass_counters`` replay, each
   tenant's tokens equal to its solo run, the 30 FPS memsys check, the
   trace valid); the N-EUREKA kernels launched 1 / 17 / 35 times a frame;
   the frame stage against the CPU on the same frozen tree: index maps,
   corrected frame and logits equal, gestures within ``GESTURE_RTOL``.
   The launch counters are set to 0 before each leg and read after (the
   launcher's own verify serves count: they are part of its main); each
   kernel is held against its plain version at every distinct call of
   both legs (B1, B2, B7 as in phase 8, B4-B6 at each job of the frames).
   The launcher's tick time and tok/s, the frame latency p50 / p99 and
   the tenancy tick on the host clock are printed as smoke readings;
12. the VLM and encoder-decoder families and hymba's segmented window
   path, at full width with random weights from seeded CUDA generators.
   (a) llava-next-34b (60 layers, d_model 7,168, 56 / 8 heads of 128,
   d_ff 20,480, vocab 64,000, untied head), each weight frozen at 8 bits
   as it is drawn (``frozen_tree``): (i) ``launch/steps``'
   ``make_prefill_step`` on 2 rows of 2,880 patch embeddings (std 0.02)
   + 16-token prompts, then 16 greedy ``make_decode_step`` steps; (ii)
   ``ServingEngine`` serves 4 text requests of 16-64 tokens for 16 new
   tokens each; (iii) 1 row of 64 patches + 16 tokens through the first
   2 layers, card vs CPU within ``LOGITS_TOL``; peak device memory
   printed and below the card's.  (b) whisper-tiny (4 + 4 layers,
   d_model 384, 1,500 frames): ``make_prefill_step`` on 4 rows of random
   frames + 4-token prompts, then 32 greedy decode steps, the whole model
   on the CPU and then on the card with the CPU's tokens fed in: logits
   at every step within ``LOGITS_TOL``, and the card's greedy token the
   CPU's wherever the CPU's top two logits lie more than twice that
   tolerance apart.  (c) hymba-1.5b's ``forward`` with
   ``segmented_window_scan`` on phase 3's 1,035-token prompt (+ 128 meta
   tokens; the 1,024 window binds) against the unsegmented ``forward``
   on the card within ``LOGITS_TOL``, both timed on the host clock.  The
   B1, B2 and B7 counters are zeroed before each leg and must grow after
   it; every distinct kernel call of (a)-(c) is held against its plain
   version (``recording``, ``check_path``);
13. training of the other families (``make_train_step`` ->
   ``lm_loss`` / ``seq2seq_loss`` -> ``chunked_attention`` and the
   reference's chunked associative scan, ``models/ssm.selective_scan``; no
   Hopper kernel, as in phase 10), at full width with random weights.
   (a) One ``loss_and_grads`` and one ``make_train_step`` step on the card
   against the CPU from the same weights (drawn on the card, copied to
   the CPU) and batch, as phase 10 (a): hymba-1.5b 2 layers at 1 x 64
   (+ 128 meta tokens), falcon-mamba-7b 1 layer at 1 x 64,
   qwen2-moe-a2.7b 1 layer at 1 x 64 (its top-k indices card vs CPU
   equal in every ``route`` call first, else the phase fails with the
   count), whisper-tiny whole at 1 x 64 tokens over 1,500 frames (one
   row each: at two the CPU side took 115 s): the loss within 1e-5
   relative,
   every gradient leaf present, finite, non-zero (hymba's ``ssm_norm``,
   which the loss never reads, zero on both) and within 1e-4 of the CPU
   leaf's largest element.  (b) hymba-1.5b at 8 of its 32 layers (cut
   so that the script ends within 1,200 s; remat), AdamW at 3e-4, batch
   4 x 256, 6 steps through ``Trainer``: the
   last loss below the first; step time, tokens/s and peak memory
   printed, one more step profiled, the checkpoint deleted; (b') the
   same at ``dtype="bfloat16"`` from (b)'s weights cast to bf16, 3 steps,
   the same readings.  (d) (b)'s
   trained tree, its leaves set to require grad, frozen at 8 bits (no
   packed leaf requires grad) and served, 4 requests: the B1, B2 and B7
   counters zeroed before and grown after, each kernel held against its
   plain version at every distinct call of the serve, the first layer's
   logits card vs CPU within ``LOGITS_TOL``.  (c) 4 ``make_train_step``
   steps on one batch at full width and cut depth: falcon-mamba-7b 4 of
   64 layers at 2 x 128, qwen2-moe-a2.7b 2 of 24 at 2 x 128,
   llava-next-34b 2 of 60 at 1 x 256 text tokens after all 2,880 patches,
   whisper-tiny whole at 2 x 64: each loss falling; step time, tokens/s
   and peak memory printed;
14. the launcher at full width through its ``main``, in this process:
   ``--arch gemma-7b`` (head dim 256 on the flash kernel), ``qwen2.5-3b``,
   ``olmo-1b`` and ``llava-next-34b`` (``--requests 4 --max-new 8``), each
   ``--bits 8 --kv-paged`` (so both verify legs run): both verify lines
   BIT-EXACT, every request its tokens in the vocabulary, the B1 and B2
   launches of the served run (its first ``_serve``) grown, peak device
   memory below the card's, tok/s printed.  Then gemma-7b, qwen2.5-3b and
   olmo-1b cut to 2 layers at full width, ``forward`` logits of 64 tokens
   card vs CPU within ``LOGITS_TOL``.  Then qwen2-moe-a2.7b cut to 2 of
   its 24 layers at full width, each weight frozen at 4 bits as drawn,
   its experts' three linears int8-paged (1.17 GB of wire bytes a pass)
   and the rest pinned, ``attach_paging(wire_serve=True)``: 4 requests of
   8 new tokens, phase 6's checks (tokens in the vocabulary, swaps and
   misses, nothing decoded on the host, the device memory down by the
   cold bytes, tokens equal to a resident engine on the same wire-form
   bytes), ``pager.wire_served`` the expert groups, and
   ``qmatmul_f32_blockscale_grouped`` launched.  Every distinct B1, B2 and
   grouped B3 call of the phase is held against its plain version;
15. the bf16 contracts (B2, B7, B3, and B1 at bf16 x) on the model path,
   the configs replaced as the reference's dry-run replaces them: (a)
   hymba-1.5b at full width and 16 of its 32 layers, 8 bits, ``dtype``,
   ``attn_dtype``
   and ``scan_dtype`` bf16, drawn by ``init_params(bits=8)``, serving
   phase 4's 8 requests (the 1,035-token prompt among them) through
   ``ServingEngine``; (b) qwen3-0.6b's phase-6 store (4 bits, the cold
   half wire-served as int8 pages) at ``dtype="bfloat16"``, 8 requests.
   Each serve's launches are read by dtype: every B1, B2, B3 and B7
   launch of it takes its bf16 route (B7 both routes), and each kernel is
   held against its plain version at every distinct call (B1 / B3
   ``QMM_TOL``, B2 ``flash_bf16_bound``, B7 ``SCAN_BF16_TOL``).  Beside
   each, the f32 config serves the same weights: the share of greedy
   tokens that agree, and ``launch/steps.make_prefill_step`` (2 x 64
   tokens) and ``make_decode_step`` at both dtypes with the largest logit
   difference at the first decode step; (c) qwen2-moe-a2.7b at full
   width cut to 2 of its 24 layers, 8 bits, ``dtype="bfloat16"``, 4
   requests: every grouped B1 launch on its bf16 x route; then phase
   14's wire-served MoE leg at ``dtype="bfloat16"`` (1 layer, 4 bits,
   the experts int8-paged): every grouped B3 launch on its bf16 x route,
   its calls held against the plain version.  Then B2's bf16
   route at every head dim with P rounded and P kept f32-accurate, and
   with an f32 output, and the grouped B3 at bf16 x on qwen2-moe-a2.7b's
   expert shape (E = 60, C = 8), and the grouped B1 at bf16 x timed there
   beside ``torch.bmm`` at bf16; each bf16 route timed
   beside its plain version and library call, its bound the bytes at
   bf16 over 3.35 TB/s or the operations at 989 TFLOP/s (B7: the SFUs);
16. mesh-sharded paging (``launch/mesh.make_test_mesh((1, 4))``: four
   links, each a fetch worker and copy stream, all on the one card).  (a)
   ``repro_torch.launch.serve.main`` on full-width qwen3-0.6b at 4 bits,
   ``--kv-paged --requests 4 --max-new 8 --mesh 4``, ``--budget-mb`` 0.4 of
   the linears' per-link charge (``packed_sizes(shard_factors=)``; the
   phase fails unless half or more of the linear bytes stay paged, and on
   "serving unsharded"): the async, sync and mesh verify lines BIT-EXACT,
   the ledger on its prediction, the metrics' ``mesh`` section with
   ``predicted_ok`` and ``ledger_ok`` true, ``sharded_params`` > 0 and
   ``n_devices`` 4, ``paging.devices`` the ledger's rows.  (b) phase 6's
   store (the cold half wire-served as int8 pages) and 8 requests through
   ``attach_paging(wire_serve=True, mesh=)``, on one link, on four, and on
   four with per-link pools of 2/3 of a link's page bytes: every serve's
   tokens equal phase 6's, the counters ``predict()``, nothing decoded on
   the host, the wire bytes of four links those of one.  B1 and B2
   launched in (a)'s mesh run, B1, B2 and B3 in (b)'s; every distinct
   call of both held against its plain version.  Printed with the card
   line: per-link wire bytes, CRC and copy seconds, exposed and hidden page
   wait a tick, tick p50 on four links and on one;
17. multi-rank training (``parallel/distributed.run_ranks``: 4 processes
   of one ``gloo`` group, each on the one card, TF32 off and
   deterministic algorithms on; the collectives go through the host, and
   gloo's send / receive of CUDA tensors, which it cannot take, is staged
   through pinned host buffers; no Hopper kernel, as in phases 10 and
   13).  (a) qwen3-0.6b at full width and 8 of its 28 layers (cut so that
   the script ends within 1,200 s: at 28 the phase took 222-272 s, the
   host's collectives binding), on a (2, 2)
   ("data", "model") rank mesh, AdamW at 3e-4, batch 4 x 256, 3 steps of
   ``make_distributed_train_step`` (each layer's blocks gathered over
   "data" by one all-gather just before its use and again in its remat
   backward, each matmul weight kept as the rank's "model" block, so that
   a rank computes its share of every layer matmul, the attention by
   heads and the logits by vocab rows; its gradient reduced over "data"
   as its backward ends) against rank 0's 3 steps of the
   single-rank ``make_train_step`` from the same weights and batches:
   every loss within 1e-4, every step's global gradient norm within a
   relative 1e-4, every gathered leaf within rtol = atol = 2e-3 and its
   change from the start within 5 % of one rank's change in norm (a first
   AdamW step moves an element by about lr whatever its gradient, below
   the leaf tolerance), each rank's bytes held between steps equal to the specs' (each
   leaf over its shard count), every shard on the card, every layer
   linear computed on its block, the attention by heads, the rank's
   layer multiply-adds a quarter of one device's and its logits (2, 256,
   V / 2); (b) the same with
   Adafactor, 2 steps; (c) ``int8_allreduce`` / ``compressed_allreduce_
   mean`` of (4, 1 << 20) f32 rows, one a rank: the int32 totals and the
   scale equal the CPU's arithmetic on the same rows, the mean within
   absmax / 127, 8 rounds of error feedback not growing the error; (d)
   ``pipelined_apply`` of ``tanh(x @ w)`` over 4 stages at width 1,024, 8
   microbatches, within 2e-4 of the sequential layers; (e) (a)'s state
   saved from (2, 2) and restored onto (4, 1) and (1, 4), every rank's
   blocks bit-equal, and ``Trainer(shardings=)`` at 2 layers under
   Adafactor, 4 steps with a failure injected at step 2, ending on the
   uninterrupted run's bits.  (f) the reference's train cell with a MoE:
   qwen2-moe-a2.7b at full width and 1 of its 24 layers, ``moe_groups``
   0, ``dtype="bfloat16"``, Adafactor, batch 4 x 128, 1 step on a (2, 2)
   mesh of 4 ranks (the 60 experts expert-parallel over "model", each
   model row's 30 split again over "data": a rank runs a quarter of one
   device's expert slots, else the phase fails), each step against rank
   0's single-rank step from the
   same (gathered) state: the router's top-k indices of the gathered
   tokens equal in every ``route`` call (else the phase fails with the
   count), the loss and global gradient norm within
   ``DIST_BF16_LOSS_RTOL`` / ``DIST_BF16_GNORM_RTOL``, every leaf within
   ``DIST_LEAF_TOL``; the routed experts' time a rank (its 15 of the 60
   experts' slots) against all 60's, what every rank ran before ROADMAP
   C22 closed.  A rank that fails or outlives ``DIST_TIMEOUT_S`` fails
   the phase.  Printed with the card line: step times on the ranks and
   on one, the comm split a step (the dp weight gathers', the dp
   gradient reduces' and the model-axis activation collectives' bytes
   and seconds), the rank's layer multiply-adds against one device's,
   the most layers alive at once, each rank's peak device memory and the
   single rank's, the staged collectives;
18. the dry-run (``repro_torch.launch.dryrun.main`` with ``--measure``,
   ROADMAP A12 (d)) of four cells of the single-pod production mesh:
   qwen3-0.6b ``train_4k`` and ``prefill_32k``, falcon-mamba-7b
   ``prefill_32k`` and hymba-1.5b ``long_500k``.  Each is counted on
   ``meta`` as rank 0 of a fake process group of 256 ranks (FLOPs, bytes,
   collectives, the rank's argument bytes, the roofline on H100 rates),
   then run on the card at depth 1 and 2 of its config, full width, at the
   rank's shapes (the train cell as rank 0 of the fake group, whose
   collectives move nothing; a serve cell on the rank's dp rows with
   whole 8-bit weights, at the reference's bf16 ``dtype``) and
   extrapolated to its depth.  The phase fails unless the serve cells
   launch their kernels (B1 and B2; B1 and the chunked B7; B1 and the step
   B7), each distinct kernel call holds against its plain version (B2 at
   the first and last ``DRYRUN_ROWS`` query rows of a call too long for
   the plain one), each extrapolated step is at or above the count's
   compute and memory bound, and each extrapolated peak at or above the
   rank's argument bytes.  Printed with the card line: one line a cell,
   then ``launch/report.py``'s two tables;
19. the ``{"serve": ...}``, ``{"train": ...}``, ``{"phase12": ...}``,
   ``{"train_families": ...}``, ``{"phase14": ...}``, ``{"bf16": ...}``,
   ``{"mesh": ...}``, ``{"dist_train": ...}``, ``{"dryrun": ...}`` and
   ``{"kernels": [...]}`` lines (a ``[bf16]`` entry for each bf16 route,
   the grouped B1's among them; phase 18's launches under ``dryrun``
   paths), the card line, and as
   the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core rate
TF32_FLOPS_PER_S = 495e12        # H100 SXM dense TF32 tensor-core rate
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate

QMM_TOL = dict(rtol=1e-4, atol=1e-4)      # f32 accumulate, reordered sums
FLASH_TOL = dict(rtol=3e-5, atol=3e-5)    # the reference kernel test's
SCAN_TOL = dict(rtol=5e-4, atol=5e-4)     # the reference kernel test's
LOGITS_TOL = dict(rtol=1e-3, atol=1e-3)   # 28 f32 layers, card vs CPU order
# falcon-mamba (2 layers) and hymba (4 layers) cut copies: f32 sums in
# another order and the N-state recurrence over 64 (192 with hymba's meta
# tokens) steps, through full-width layers
CUT_LOGITS_TOL = dict(rtol=2e-3, atol=2e-3)
MUFU_PER_S = 16 * 132 * 1.98e9   # H100 SXM exponentials: 16 a clock per SM

MNV2_IMG = 224
MNV2_FRAMES = 16
NEUREKA_KERNELS = ("conv3x3_dense", "conv3x3_dw", "qmatmul_int8")
NEUREKA_PER_FRAME = {"conv3x3_dense": 1, "conv3x3_dw": 17, "qmatmul_int8": 35}
# the jobs timed alone: B4 at its largest map, at a 7 x 7 projection with a
# long K, at conv_last and at fc; B5 at conv0; B6 at its largest stride-2
# map (b1.dw), its largest stride-1 map (b0.dw) and its smallest (b14.dw)
NEUREKA_TIMED = ("b1.pw_exp", "b14.pw_proj", "conv_last", "fc", "conv0",
                 "b1.dw", "b0.dw", "b14.dw")
L2_COLD_BYTES = 64e6             # rotate timing inputs over more than L2

# the serving paths: (arch, max_len, one prompt of 1,000-1,200 tokens so that
# hymba's window of 1,024 binds, depth of the card-vs-CPU copy: None = all)
SERVE_PATHS = (("qwen3-0.6b", 512, False, None),
               ("falcon-mamba-7b", 512, False, 2),
               ("hymba-1.5b", 2048, True, 4))
# served depth where cut: falcon-mamba-7b's first 32 of its 64 layers at
# full width (d_inner 8192; a serve's checks hold at any depth; cut for the
# script's time, as PAGED_LAYERS)
SERVE_LAYERS = {"falcon-mamba-7b": 32}
SERVE_KERNELS = {"dense": ("qmatmul_f32", "flash_attention"),
                 "moe": ("qmatmul_f32", "qmatmul_f32_grouped",
                         "flash_attention"),
                 "ssm": ("qmatmul_f32", "selective_scan"),
                 "hybrid": ("qmatmul_f32", "flash_attention",
                            "selective_scan")}

# (K, N) of each packed linear of a qwen3-0.6b layer
LAYER_LINEARS = {"wq": (1024, 2048), "wk": (1024, 1024), "wv": (1024, 1024),
                 "wo": (2048, 1024), "w_gate": (1024, 3072),
                 "w_up": (1024, 3072), "w_down": (3072, 1024)}
# (K, N) of each packed linear of a llava-next-34b layer: d_model 7,168,
# 56 / 8 heads of 128, d_ff 20,480
LLAVA_LINEARS = {"wq": (7168, 7168), "wk": (7168, 1024), "wv": (7168, 1024),
                 "wo": (7168, 7168), "w_gate": (7168, 20480),
                 "w_up": (7168, 20480), "w_down": (20480, 7168)}
# (K, N) of each packed linear of a falcon-mamba-7b layer: d_model 4,096,
# d_inner 8,192, dt_rank 256, N 16 (x_proj gives dt_rank + 2N)
FALCON_LINEARS = {"in_proj": (4096, 16384), "x_proj": (8192, 288),
                  "dt_proj": (256, 8192), "out_proj": (8192, 4096)}
# the tensor-core kernels of the f32 matmuls: decode, M <= 16
# (csrc/qmm_decode.cuh), and M > 16 (csrc/qmm_tc.cuh); the flash kernel; the
# scan's two routes (csrc/ssm_scan.cu); each name covers its bf16
# instantiations too, the flash kernel's bf16 route its own name
TC_KERNELS = ("qmm_dec", "bs_dec", "qmm_tc", "bs_tc", "flash_fwd_tc",
              "flash_fwd_bf16")
SCAN_KERNELS = ("scan_step", "scan_chunked")
# the depthwise kernel's instantiations (csrc/neureka_conv.cu)
DW_KERNELS = ("dw3x3_vec",)
# the kernels whose SASS must hold their tensor-core op: {function name
# fragment: (library, the op's tokens)}; the int8 MMA kernels
# (csrc/int8_mma.cuh) IMMA, the flash kernel a TF32 HMMA, its bf16 route a
# bf16 HMMA with f32 accumulators
MMA_OPS = {"qmm_int8_direct": ("qmatmul_int8", ("IMMA",)),
           "qmm_int8_staged": ("qmatmul_int8", ("IMMA",)),
           "dense3x3_mma": ("neureka_conv", ("IMMA",)),
           "flash_fwd_tc": ("flash_attention", ("HMMA", "TF32")),
           "flash_fwd_bf16": ("flash_attention", ("HMMA.16816.F32.BF16",))}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls, CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=None)
def capture_stream(torch):
    """One side stream for every graph capture: cuBLAS keeps a workspace for
    each stream it has run on, and those would stay allocated while serving."""
    return torch.cuda.Stream()


def graph_ms(torch, fn, n_sets: int, replays: int = 10) -> float:
    """Device time of one ``fn(i)``: the calls for i in range(n_sets) are
    captured once into a CUDA graph and replayed, so the host's launch gaps
    drop out of the measurement."""
    side = capture_stream(torch)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up before capture
        for i in range(n_sets):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_sets):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * n_sets)


def time_versions(torch, kernel, plain, library, n_sets: int,
                  eager_iters: int):
    """Kernel, plain, library, kernel, in turns.  ``ms`` and the other
    device times come from graph replay; ``eager_*`` are the same calls
    enqueued one by one from Python, launch gaps included."""
    fns = (kernel, plain, library, kernel)
    dev = [None if f is None else graph_ms(torch, f, n_sets) for f in fns]
    eager = [None if f is None else cuda_ms(torch, f, eager_iters)
             for f in fns]
    torch.cuda.empty_cache()
    return dict(ms=min(dev[0], dev[3]), ms_runs=[dev[0], dev[3]],
                plain_ms=dev[1], library_ms=dev[2],
                eager_ms=min(eager[0], eager[3]), eager_plain_ms=eager[1],
                eager_library_ms=eager[2])


def bound_ms(nbytes: float, ops: float, rate: float = F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build(build):
    """Build every kernel, print what ptxas reports, and fail if a
    tensor-core, scan or depthwise kernel spills or an MMA kernel's SASS
    lacks its tensor-core op."""
    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] nvcc sm_90a, {time.perf_counter() - t0:.2f} s")
    checked = TC_KERNELS + SCAN_KERNELS + DW_KERNELS + tuple(MMA_OPS)
    spills = []
    for name, report in build.ptxas_reports().items():
        func = None
        for line in report.splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1] if "'" in line else line
            if "Compiling entry function" in line or "Used" in line \
                    or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
            spilled = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            if (func is not None and any(k in func for k in checked)
                    and any(int(b) for b in spilled)):
                spills.append(f"{func}: {line.strip()}")
    if spills:
        raise AssertionError("the tensor-core, scan or depthwise kernels "
                             "spill:\n"
                             + "\n".join(spills))
    ops = sass_mma(build)
    print(f"[build] cuobjdump: tensor-core ops in each MMA kernel "
          f"{json.dumps(ops)}")
    for frag, (_, tokens) in MMA_OPS.items():
        mine = {f: c for f, c in ops.items() if frag in f}
        if not mine or not all(mine.values()):
            raise AssertionError(f"{frag}: no {' '.join(tokens)} in its "
                                 f"SASS: {mine}")


def sass_mma(build) -> dict:
    """{MMA kernel function: its count of instructions with all of its
    op's tokens (``MMA_OPS``)} from ``cuobjdump --dump-sass`` of the built
    libraries."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    counts = {}
    for lib in sorted({lib for lib, _ in MMA_OPS.values()}):
        sass = subprocess.run([str(tool), "--dump-sass",
                               str(build.BUILD_DIR / f"{lib}.so")],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        func = tokens = None
        for line in sass.splitlines():
            hit = re.search(r"Function : (\S+)", line)
            if hit:
                func = hit.group(1)
                tokens = next((t for frag, (lb, t) in MMA_OPS.items()
                               if lb == lib and frag in func), None)
                if tokens is None:
                    func = None
                else:
                    counts[func] = 0
            elif func is not None and all(t in line for t in tokens):
                counts[func] += 1
    return counts


def check_qmatmul(torch, ops, ref, qmm, dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    cases = [(bits, m, k, n) for bits in (8, 4, 2) for m in (1, 4, 16, 256)
             for k, n in sorted(set(LAYER_LINEARS.values()))]
    cases += [(bits, m, 1001, 515) for bits in (8, 4, 2) for m in (7, 37)]
    for bits, m, k, n in cases:
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
        packed, scale = ops.prep_linear(w, bits)
        got = qmm.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k)
        expect = ref.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k)
        again = qmm.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k)
        torch.cuda.synchronize()
        err = (got - expect).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(got, expect, **QMM_TOL):
            raise AssertionError(f"qmatmul_f32 bits={bits} M={m} K={k} N={n}:"
                                 f" max abs err {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"qmatmul_f32 bits={bits} M={m} K={k} N={n}:"
                                 " two calls on one input differ")
    print(f"[check] qmatmul_f32: {len(cases)} cases (bits 8/4/2, M "
          f"1/4/16/256 at the layer shapes, ragged K=1001), max abs err "
          f"{worst:.3e}, "
          f"tolerance {QMM_TOL}; each case called twice, bit-equal")
    return worst


FLASH_CASES = [
    # b, hq, hkv, sq, sk, d, window, per-row q_offset (None: sk - sq), causal
    (4, 16, 8, 64, 512, 128, None, (0, 64, 192, 448), True),   # qwen3, timed
    (4, 16, 8, 16, 256, 128, None, (3, 40, 77, 240), True),
    (4, 16, 8, 64, 64, 128, None, None, True),
    (4, 16, 8, 64, 512, 128, 96, (0, 100, 300, 448), True),
    # hymba-1.5b's longest prompt (1,035 tokens + 128 meta tokens, all four
    # rows alike, as the engine pads a group), window 1,024; timed
    (4, 25, 5, 1163, 2048, 64, 1024, (0, 0, 0, 0), True),
    # rows that see no key (the mean of v): Sq > Sk at the default offset
    # (whole blocks and a mixed one), a window past the keys' end, and one
    # row of a block whose kv range spans two slices
    (2, 4, 2, 100, 24, 64, None, None, True),
    (2, 8, 8, 32, 64, 32, 16, (0, 70), True),
    (1, 2, 2, 64, 280, 16, 40, (256,), False),
    # llava-next-34b's prefill of phase 12 (a) (i): 2,880 patches + 16
    # tokens, GQA 7 (56 / 8 heads of 128); timed
    (2, 56, 8, 2896, 2896, 128, None, None, True),
    # whisper-tiny, 4 rows: the encoder over 1,500 frames (not causal;
    # timed), the 4-token prefill's and one decode token's cross-attention
    (4, 6, 6, 1500, 1500, 64, None, None, False),
    (4, 6, 6, 4, 1500, 64, None, None, False),
    (4, 6, 6, 1, 1500, 64, None, None, False),
    # gemma-7b's prefill chunk at head dim 256 (16 heads, no GQA), offsets
    # as in the qwen3 row; timed
    (4, 16, 16, 64, 512, 256, None, (0, 64, 192, 448), True),
]
# FLASH_CASES rows timed
FLASH_TIMED = {"qwen3": 0, "hymba": 4, "llava": 8, "whisper": 9, "gemma": 12}


def flash_inputs(torch, gen, dev, case):
    b, hq, hkv, sq, sk, d, window, offs, causal = case
    q = torch.randn((b, hq, sq, d), generator=gen, device=dev)
    k = torch.randn((b, hkv, sk, d), generator=gen, device=dev)
    v = torch.randn((b, hkv, sk, d), generator=gen, device=dev)
    off = None if offs is None else torch.tensor(offs, dtype=torch.int32,
                                                 device=dev)
    return q, k, v, dict(causal=causal, window=window, q_offset=off)


def check_flash(torch, ref, fa, dev) -> float:
    """Each FLASH_CASES row at its plan against the plain version; the call
    twice, bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for case in FLASH_CASES:
        q, k, v, kw = flash_inputs(torch, gen, dev, case)
        expect = ref.flash_attention(q, k, v, **kw)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (got - expect).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(got, expect, **FLASH_TOL):
            raise AssertionError(f"flash_attention case {case}: max abs err "
                                 f"{err}")
        if not torch.equal(got, fa.flash_attention(q, k, v, **kw)):
            raise AssertionError(f"flash_attention case {case}: two calls "
                                 "differ")
        del q, k, v, expect, got
    print(f"[check] flash_attention: {len(FLASH_CASES)} cases (GQA 16/8, "
          f"25/5 and 56/8, per-row q_offset, causal and not, windows, "
          f"hymba's long prompt, llava's prefill, whisper's encoder and "
          f"cross-attention, gemma's chunk at head dim 256, rows that see "
          f"no key), max abs err {worst:.3e}, "
          f"tolerance {FLASH_TOL}; each call twice, bit-equal")
    return worst


def route_bound(res, nbytes: float, flops: float, passes: int,
                bf16: bool = False):
    """The f32 matmuls and flash attention run on the tensor cores,
    ``passes`` TF32 MMAs for each f32 multiply-add: ``bound_ms`` is that
    route's bound (the bytes bind at decode, the operations at prefill),
    with both figures beside it (``bytes_ms``, ``tf32_ops_ms``) and the f32
    CUDA-core bound in ``bound_f32_ms``.  With ``bf16`` operands the bound
    is the operations at the dense bf16 tensor-core rate, or the bytes."""
    res["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    if bf16:
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops,
                                                    BF16_FLOPS_PER_S)
        return
    res["tf32_passes"] = passes
    res["tf32_ops_ms"] = passes * flops / TF32_FLOPS_PER_S * 1e3
    res["bound_f32_ms"], res["bound_f32_by"] = bound_ms(nbytes, flops)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, passes * flops,
                                                TF32_FLOPS_PER_S)


def time_qmatmul(torch, packing, ops, ref, qmm, dev, m: int,
                 bits: int = 8, copies: int = 8, linears=LAYER_LINEARS,
                 what: str = "qmatmul_f32 layer x7", dtype=None):
    """One layer's packed linears (qwen3-0.6b's seven by default) at M rows,
    over ``copies`` layer copies (8 x 15.7 MB of 8-bit qwen3 weights, or
    2 x 105 MB of falcon-mamba's, > the 50 MB L2); x and the library's
    dequantised weights in ``dtype`` (f32, or bf16 for the bf16 route)."""
    dtype = dtype or torch.float32
    elem, bf16 = dtype.itemsize, dtype == torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    layers = []
    for _ in range(copies):
        layer = []
        for k, n in linears.values():
            w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
            packed, scale = ops.prep_linear(w, bits)
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            deq = packing.unpack(packed, bits, k).float() * scale[:, None]
            layer.append((x, packed, scale, k, deq.to(dtype)))
        layers.append(layer)

    def kernel(i):
        for x, p, s, k, _ in layers[i % copies]:
            qmm.qmatmul_f32(x, p, s, bits=bits, k_orig=k)

    def plain(i):
        for x, p, s, k, _ in layers[i % copies]:
            ref.qmatmul_f32(x, p, s, bits=bits, k_orig=k)

    def library(i):
        for x, _, _, _, deq in layers[i % copies]:
            torch.matmul(x, deq.T)

    res = time_versions(torch, kernel, plain, library, copies, 40)
    flops, nbytes = (sum(w) for w in zip(*(
        qmm.qmm_work(1, m, n, k, p.shape[1], elem)
        for (_, p, _, k, _), (_, n) in zip(layers[0], linears.values()))))
    route_bound(res, nbytes, flops, 2, bf16)
    x_dt = " bf16 x" if bf16 else ""
    res["work"] = f"{what} {list(linears)}, M={m}{x_dt}, {bits}-bit"
    print_times(f"{what} M={m}{x_dt} bits={bits}",
                f"torch.matmul on pre-dequantised {dtype}", res, nbytes,
                flops)
    return res


def check_blockscale(torch, ref, qmm, dev, linears) -> float:
    """qmatmul_f32_blockscale against its plain version: the reference
    kernel test's shapes (bits 8 at K = 70, bits 4 at K = 69), bits 2, a
    ragged K = 1,001, and the paged serve's cold linears at decode and
    prefill M."""
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = [(8, 4, 70, 9), (4, 4, 69, 9), (2, 4, 70, 9), (2, 4, 69, 9)]
    cases += [(bits, m, 1001, 515) for bits in (8, 4, 2) for m in (7, 37)]
    cases += [(8, m, k, n) for m in (1, 4, 16, 256) for k, n in linears]
    worst = 0.0
    for bits, m, k, n in cases:
        packed, scales = wire_weight(torch, gen, dev, n, k, bits)
        x = torch.randn((m, k), generator=gen, device=dev)
        got = qmm.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                         k_orig=k)
        expect = ref.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                            k_orig=k)
        again = qmm.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                           k_orig=k)
        torch.cuda.synchronize()
        err = (got - expect).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(got, expect, **QMM_TOL):
            raise AssertionError(f"qmatmul_f32_blockscale bits={bits} M={m} "
                                 f"K={k} N={n}: max abs err {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"qmatmul_f32_blockscale bits={bits} M={m} "
                                 f"K={k} N={n}: two calls on one input differ")
    print(f"[check] qmatmul_f32_blockscale: {len(cases)} cases (the "
          f"reference test's bits 8 / K 70 and bits 4 / K 69, bits 2, ragged "
          f"K=1001 at bits 8/4/2, the cold linears {linears} at M "
          f"1/4/16/256), "
          f"max abs err {worst:.3e}, tolerance {QMM_TOL}; each case called "
          "twice, bit-equal")
    return worst


def time_blockscale(torch, packing, ref, qmm, dev, m: int, linears,
                    copies: int = 8, dtype=None):
    """One layer's cold linears in wire form (int8 levels, per-32 scales) at
    M rows, over ``copies`` layer copies (8 x 9.4 MB > the 50 MB L2); x and
    the library's dequantised weights in ``dtype`` (f32 or bf16)."""
    dtype = dtype or torch.float32
    elem, bf16 = dtype.itemsize, dtype == torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(12)
    layers = []
    for _ in range(copies):
        layer = []
        for k, n in linears:
            packed, scales = wire_weight(torch, gen, dev, n, k, 8)
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            deq = (packing.unpack(packed, 8, k).float().reshape(n, -1, 32)
                   * scales[:, :, None]).reshape(n, k)
            layer.append((x, packed, scales, k, deq.to(dtype)))
        layers.append(layer)

    def kernel(i):
        for x, p, s, k, _ in layers[i % copies]:
            qmm.qmatmul_f32_blockscale(x, p, s, bits=8, k_orig=k)

    def plain(i):
        for x, p, s, k, _ in layers[i % copies]:
            ref.qmatmul_f32_blockscale(x, p, s, bits=8, k_orig=k)

    def library(i):
        for x, _, _, _, deq in layers[i % copies]:
            torch.matmul(x, deq.T)

    res = time_versions(torch, kernel, plain, library, copies, 40)
    nbytes = sum(m * k * elem + p.numel() + s.numel() * 4 + m * n * 4
                 for (x, p, s, k, _), (_, n) in zip(layers[0], linears))
    flops = sum(2 * m * n * k for k, n in linears)
    route_bound(res, nbytes, flops, 2, bf16)
    res["work"] = (f"one layer's {len(linears)} cold linears {linears}, "
                   f"M={m}{' bf16 x' if bf16 else ''}, int8 wire form")
    print_times(f"qmatmul_f32_blockscale {res['work']}",
                f"torch.matmul on pre-dequantised {dtype}", res, nbytes,
                flops)
    return res


def time_flash(torch, F, ref, fa, dev, which: str = "qwen3",
               copies: int = 4, dtype=None, p_dtype=None):
    """A timed FLASH_CASES row (qwen3-0.6b's prefill chunk: 4 rows x 16/8
    heads, 64 queries over a 512-row kv span at per-row offsets; hymba-
    1.5b's longest prompt: 4 rows x 25/5 heads, 1,163 queries, window
    1,024; llava-next-34b's prefill: 2 rows x 56/8 heads of 128, 2,896
    queries; whisper-tiny's encoder: 4 rows x 6 heads of 64, 1,500 frames,
    not causal; gemma-7b's chunk: 4 rows x 16 heads of 256, 64 queries
    over 512 keys) on ``copies`` input sets in turn (more than the 50 MB
    L2).  The
    library call is ``F.scaled_dot_product_attention`` with the same
    boolean mask, on k and v expanded to Hq heads outside the timing.
    q, k and v in ``dtype`` (f32, or bf16 for the bf16 route, P rounded
    to ``p_dtype`` there)."""
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    case = FLASH_CASES[FLASH_TIMED[which]]
    b, hq, hkv, sq, sk, d, window, offs, causal = case
    gen = torch.Generator(device=dev).manual_seed(4)
    sets = []
    for _ in range(copies):
        q, k, v, kw = flash_inputs(torch, gen, dev, case)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        if p_dtype is not None:
            kw = dict(kw, p_dtype=p_dtype)
        # the library call takes equal head counts: expand outside timing
        ke = k.repeat_interleave(hq // hkv, dim=1)
        ve = v.repeat_interleave(hq // hkv, dim=1)
        sets.append((q, k, v, ke, ve))
    off = kw["q_offset"]
    if off is None:
        off = torch.full((b,), sk - sq, dtype=torch.int32, device=dev)
    qpos = off[:, None] + torch.arange(sq, device=dev)
    kpos = torch.arange(sk, device=dev)[None, None]
    mask = torch.ones((b, sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos[..., None]
    if window:
        mask &= kpos > qpos[..., None] - window

    def kernel(i):
        q, k, v, _, _ = sets[i % copies]
        fa.flash_attention(q, k, v, **kw)

    def plain(i):
        q, k, v, _, _ = sets[i % copies]
        ref.flash_attention(q, k, v, **kw)

    def library(i):
        q, _, _, ke, ve = sets[i % copies]
        F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask[:, None])

    res = time_versions(torch, kernel, plain, library, copies, 20)
    flops, nbytes = fa.flash_work(
        b, hq, hkv, sq, sk, d, causal=causal, window=window,
        offsets=offs if offs is not None else (sk - sq,) * b,
        q_bytes=dtype.itemsize, out_bytes=dtype.itemsize)
    route_bound(res, nbytes, flops, 3, bf16)
    route = f" bf16, P in {p_dtype or torch.float32}" if bf16 else ""
    res["work"] = (f"{which}: B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} D={d} "
                   f"window={window} offsets={offs}{route}")
    print_times(f"flash_attention {res['work']}",
                f"F.scaled_dot_product_attention at {dtype}, same mask", res,
                nbytes, flops)
    return res


def print_times(what: str, library: str, res, nbytes: int, flops: int,
                ops: str = "flop"):
    def ms(key):
        return "none" if res[key] is None else f"{res[key]:.4f}"
    passes = res.get("tf32_passes")
    f32 = (f" (bytes {res['bytes_ms']:.4f}, {passes} x TF32 operations "
           f"{res['tf32_ops_ms']:.4f}); f32 CUDA-core bound "
           f"{res['bound_f32_ms']:.4f} ({res['bound_f32_by']})"
           if "bound_f32_ms" in res else "")
    route = f" at the {passes} x TF32 route" if f32 else ""
    print(f"[time] {what}: device (graph replay) kernel_ms "
          f"{res['ms_runs'][0]:.4f}/{res['ms_runs'][1]:.4f} plain_ms "
          f"{res['plain_ms']:.4f} library_ms ({library}) "
          f"{ms('library_ms')}; eager kernel_ms {res['eager_ms']:.4f} "
          f"plain_ms {res['eager_plain_ms']:.4f} library_ms "
          f"{ms('eager_library_ms')}; bound_ms{route} "
          f"{res['bound_ms']:.4f} ({res['bound_by']}; {nbytes} B, {flops} "
          f"{ops}){f32}")


# bsz, S, Di, N, with h0: the falcon-mamba prefill chunk and decode step at
# 4 slots, a ragged S, a hymba prefill and decode, and N = 4, 8 and 32 at a
# ragged Di; check_scan adds S on each side of the route threshold
SCAN_CASES = [(4, 64, 8192, 16, True), (4, 64, 8192, 16, False),
              (4, 1, 8192, 16, True), (4, 1, 8192, 16, False),
              (4, 37, 8192, 16, True), (4, 157, 3200, 16, True),
              (4, 1, 3200, 16, True), (3, 37, 1001, 4, True),
              (3, 37, 1001, 8, False), (3, 37, 1001, 32, True),
              (2, 1, 1001, 4, True), (2, 1, 1001, 32, False)]
# the scan shapes timed: falcon-mamba-7b's prefill chunk and decode step,
# hymba-1.5b's longest prompt and decode step, 4 slots each
SCAN_TIMED = {"falcon_prefill": (4, 64, 8192), "falcon_decode": (4, 1, 8192),
              "hymba_prefill": (4, 1163, 3200), "hymba_decode": (4, 1, 3200)}


def scan_inputs(torch, gen, dev, bsz, s, di, n, h0):
    """The reference kernel test's distributions (test_ssm_kernel.py)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
    return (randn(bsz, s, di), uniform(0.001, 0.1, bsz, s, di),
            -uniform(0.5, 2.0, di, n), randn(bsz, s, n), randn(bsz, s, n),
            randn(di), randn(bsz, di, n) if h0 else None)


def check_scan(torch, ref, ssm, dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(8)
    worst = 0.0
    edge = ssm.STEP_MAX_S
    cases = SCAN_CASES + [(4, s, 8192, 16, True) for s in (edge, edge + 1)]
    for case in cases:
        args = scan_inputs(torch, gen, dev, *case)
        (y, h), (y_ref, h_ref) = ssm.selective_scan(*args), \
            ref.selective_scan(*args)
        torch.cuda.synchronize()
        err = max((y - y_ref).abs().max().item(),
                  (h - h_ref).abs().max().item())
        worst = max(worst, err)
        if not (torch.allclose(y, y_ref, **SCAN_TOL)
                and torch.allclose(h, h_ref, **SCAN_TOL)):
            raise AssertionError(f"selective_scan {case} "
                                 f"{ssm.scan_plan(case[1], case[3])}: max "
                                 f"abs err {err}")
    # pads (dt = 0) are exact no-ops at each route: h_last after [real,
    # pads] equals h_last after the real tokens alone (h0 after none)
    routes = set()
    for s_all, real in ((64, 37), (edge + 1, edge), (edge, 0)):
        x, dt, A, B, C, D, h0 = scan_inputs(torch, gen, dev, 4, s_all, 8192,
                                            16, True)
        dt_pad = dt.clone()
        dt_pad[:, real:] = 0
        _, h_pad = ssm.selective_scan(x, dt_pad, A, B, C, D, h0)
        h_real = h0 if real == 0 else ssm.selective_scan(
            x[:, :real].contiguous(), dt[:, :real].contiguous(), A,
            B[:, :real], C[:, :real], D, h0)[1]
        torch.cuda.synchronize()
        if not torch.equal(h_pad, h_real):
            raise AssertionError(f"selective_scan: dt = 0 pads changed "
                                 f"h_last (S={s_all}, {real} real steps)")
        routes.add(ssm.scan_plan(s_all, 16).route)
    if routes != {"step", "chunked"}:
        raise AssertionError(f"pads checked on routes {routes} only")
    print(f"[check] selective_scan: {len(cases)} cases (falcon-mamba "
          f"prefill 4x64x8192 and decode 4x1x8192 with and without h0, "
          f"ragged S=37, hymba 4x157x3200 and 4x1x3200, N 4/8/32 at Di "
          f"1001, S {edge} and {edge + 1} on each side of the route "
          f"threshold), max abs err {worst:.3e}, tolerance {SCAN_TOL}; dt=0 "
          f"pads leave h_last equal (torch.equal) on both routes")
    return worst


def time_scan(torch, ref, ssm, dev, which: str, n: int = 16, dtype=None):
    """One layer's scan at a SCAN_TIMED shape, from h0, inputs rotated over
    more than 50 MB; x, dt, B, C and y in ``dtype`` (f32, or bf16 for the
    bf16 route), A, D and h f32.  No PyTorch call computes a selective
    scan, so there is no library time."""
    dtype = dtype or torch.float32
    bsz, s, di = SCAN_TIMED[which]
    gen = torch.Generator(device=dev).manual_seed(9)
    nbytes = ssm.scan_work(bsz, s, di, n, in_bytes=dtype.itemsize,
                           y_bytes=dtype.itemsize, h0=True)[1]
    copies = int(max(2, -(-L2_COLD_BYTES // nbytes)))
    sets = []
    for _ in range(copies):
        x, dt, A, B, C, D, h0 = scan_inputs(torch, gen, dev, bsz, s, di, n,
                                            True)
        sets.append((x.to(dtype), dt.to(dtype), A, B.to(dtype), C.to(dtype),
                     D, h0))
    res = time_versions(torch, lambda i: ssm.selective_scan(*sets[i % copies]),
                        lambda i: ref.selective_scan(*sets[i % copies]),
                        None, copies, 20)
    exps = bsz * s * di * n
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, exps, MUFU_PER_S)
    res["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    res["exp_ms"] = exps / MUFU_PER_S * 1e3
    res["route"] = ssm.scan_plan(s, n).route
    res["work"] = (f"{which}: Bz={bsz} S={s} Di={di} N={n}, from h0"
                   f"{', bf16 x, dt, B, C' if dtype == torch.bfloat16 else ''}")
    print_times(f"selective_scan {res['work']} ({res['route']} route)",
                "none: no single PyTorch call computes a selective scan",
                res, nbytes, exps, "exp")
    return res


class _Recorder:
    """Stands in for one kernel module as ``kernels/ops.py`` sees it: each
    wrapper named in ``fns`` is the recording function given for it, every
    other attribute the module's own."""

    def __init__(self, module, fns):
        self._module, self._fns = module, fns

    def __getattr__(self, attr):
        return self._fns.get(attr) or getattr(self._module, attr)


@contextlib.contextmanager
def recording(torch, ops):
    """Notes each call that the model code makes to the LM kernel wrappers
    while the block runs.  The model code reaches every kernel through
    ``kernels/ops.py``, which calls each wrapper through its kernel module;
    those module references are put behind recorders that call the wrapper
    unchanged (so its launch count moves as usual) and are restored after.
    Yields {kernel name: [call key, ...]}; per-row query offsets are kept as
    device tensors until the block ends, so nothing syncs."""
    calls = {"qmatmul_f32": [], "qmatmul_f32_grouped": [],
             "qmatmul_f32_blockscale": [],
             "qmatmul_f32_blockscale_grouped": [], "flash_attention": [],
             "selective_scan": []}
    qmm, fa, ssm = ops._qmm, ops._fa, ops._ssm

    def rec_qmm(x, packed, scale, *, bits, k_orig):
        calls["qmatmul_f32"].append((x.shape[0], k_orig, packed.shape[0],
                                     bits, x.dtype))
        return qmm.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k_orig)

    def rec_grouped(x, packed, scale, *, bits, k_orig):
        calls["qmatmul_f32_grouped"].append((x.shape[0], x.shape[1], k_orig,
                                             packed.shape[1], bits, x.dtype))
        return qmm.qmatmul_f32_grouped(x, packed, scale, bits=bits,
                                       k_orig=k_orig)

    def rec_bs(x, packed, scales, *, bits, k_orig, block=32):
        calls["qmatmul_f32_blockscale"].append((x.shape[0], k_orig,
                                                packed.shape[0], bits))
        return qmm.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                          k_orig=k_orig, block=block)

    def rec_gbs(x, packed, scales, *, bits, k_orig, block=32):
        calls["qmatmul_f32_blockscale_grouped"].append(
            (x.shape[0], x.shape[1], k_orig, packed.shape[1], bits))
        return qmm.qmatmul_f32_blockscale_grouped(x, packed, scales,
                                                  bits=bits, k_orig=k_orig,
                                                  block=block)

    def rec_fa(q, k, v, **kw):
        off = kw.get("q_offset")
        calls["flash_attention"].append((
            tuple(q.shape), tuple(k.shape), kw.get("causal", True),
            kw.get("scale"), kw.get("window"),
            off.clone() if isinstance(off, torch.Tensor) else off,
            kw.get("p_dtype"), kw.get("out_dtype")))
        return fa.flash_attention(q, k, v, **kw)

    def rec_scan(x, dt, A, B, C, D, h0=None, *, h_out=None, y_dtype=None):
        calls["selective_scan"].append((
            tuple(x.shape), A.shape[1], h0 is not None,
            h_out is not None and h_out is h0))
        return ssm.selective_scan(x, dt, A, B, C, D, h0, h_out=h_out,
                                  y_dtype=y_dtype)

    ops._qmm = _Recorder(qmm, {"qmatmul_f32": rec_qmm,
                               "qmatmul_f32_grouped": rec_grouped,
                               "qmatmul_f32_blockscale": rec_bs,
                               "qmatmul_f32_blockscale_grouped": rec_gbs})
    ops._fa = _Recorder(fa, {"flash_attention": rec_fa})
    ops._ssm = _Recorder(ssm, {"selective_scan": rec_scan})
    try:
        yield calls
    finally:
        ops._qmm, ops._fa, ops._ssm = qmm, fa, ssm
    calls["flash_attention"] = [
        key[:5] + (tuple(key[5].reshape(-1).tolist())
                   if isinstance(key[5], torch.Tensor) else key[5],)
        + key[6:] for key in calls["flash_attention"]]
    for name in calls:
        calls[name] = list(dict.fromkeys(calls[name]))


def wire_weight(torch, gen, dev, n: int, k: int, bits: int):
    """(packed, scales) of a random (n, k) weight at the model's init scale
    in the page codec's wire form: levels packed at ``bits`` and one f32
    scale per 32 weights of a row (the codec runs on the host)."""
    from repro_torch.core import packing, quantize

    w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
    levels, scales = quantize.quantize_blockwise(w.cpu().numpy(), bits)
    packed = packing.pack(torch.from_numpy(levels), bits)
    return packed.to(dev), torch.from_numpy(scales).to(dev)


def wire_form(torch, w, bits: int):
    """The page codec's blockwise wire form of an (rows, k) f32 weight,
    computed on its device as ``quantize.quantize_blockwise`` computes it
    on the host: (levels packed at ``bits``, scales (rows, k / 32))."""
    from repro_torch.core import packing, quantize

    rows, k = w.shape
    nblk = -(-k // 32)
    qmin, qmax = quantize.weight_qrange(bits)
    groups = torch.nn.functional.pad(w, (0, nblk * 32 - k)).reshape(
        rows, nblk, 32)
    absmax = groups.abs().amax(-1)
    scales = torch.where(absmax > 0, absmax / torch.tensor(
        float(qmax), device=w.device), torch.ones_like(absmax))
    levels = torch.clamp(torch.round(groups / scales[..., None]), qmin,
                         qmax).to(torch.int8).reshape(rows, -1)[:, :k]
    return packing.pack(levels, bits), scales


def expert_wire_weights(torch, ops, gen, dev, e: int, k: int, n: int,
                        bits: int = 4, page_bits: int = 8):
    """(packed (E, N, Kp), scales (E, N, K / 32)) of E random (n, k) expert
    weights frozen at ``bits`` and re-encoded as a wire-served cold page
    (``core/paging.encode_host_param``): dequantised, then blockwise
    quantised at ``page_bits``."""
    from repro_torch.core import packing

    packed, scale = expert_weights(torch, ops, gen, dev, e, k, n, bits)
    dense = (packing.unpack(packed.reshape(e * n, -1), bits, k).float()
             * scale.reshape(-1, 1))
    wp, scales = wire_form(torch, dense, page_bits)
    return wp.reshape(e, n, -1), scales.reshape(e, n, -1)


def expert_weights(torch, ops, gen, dev, e: int, k: int, n: int, bits: int):
    """(packed (E, N, Kp), scale (E, N)) of E random (n, k) expert weights
    at the model's init scale, frozen as ``freeze_for_serving`` does."""
    w = torch.randn((e * n, k), generator=gen, device=dev) * k ** -0.5
    packed, scale = ops.prep_linear(w, bits)
    return packed.reshape(e, n, -1), scale.reshape(e, n)


def check_path(torch, ops, ref, qmm, fa, ssm, dev, arch: str, calls,
               dtype=None):
    """Each LM kernel against its plain version at every distinct call of
    one serve (``recording``), on random inputs with the distributions the
    other checks use; the tolerances are theirs.  A scan call that wrote
    h_last over h0 is also repeated so, and must equal the fresh output.
    ``dtype=torch.bfloat16`` (a bf16 serve): B2's q, k, v, B3's x and B7's
    x, dt, B, C in bf16, each kernel on its bf16 route, B2 held to
    ``flash_bf16_bound`` at the call's P dtype and B7's y to SCAN_BF16_TOL
    (B1 takes each call's own x dtype either way)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    worst = dict.fromkeys(calls, 0.0)
    share = {}           # B2 at bf16: the largest err / flash_bf16_bound
    dtype = dtype or torch.float32
    scan_y_tol = SCAN_TOL if dtype == torch.float32 else SCAN_BF16_TOL

    def hold(name, got, expect, tol, what):
        torch.cuda.synchronize()
        got, expect = got.float(), expect.float()
        err = (got - expect).abs().max().item() if got.numel() else 0.0
        worst[name] = max(worst[name], err)
        if callable(tol):
            ratio = ((got - expect).abs() / tol(expect)).max().item()
            share[name] = max(share.get(name, 0.0), ratio)
            ok = ratio <= 1
        else:
            ok = torch.allclose(got, expect, **tol)
        if not ok:
            raise AssertionError(f"{arch} {name} {what}: max abs err {err}")

    weights = {}
    for m, k, n, bits, x_dtype in calls["qmatmul_f32"]:
        if (k, n, bits) not in weights:
            w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
            weights[k, n, bits] = ops.prep_linear(w, bits)
            del w
        packed, scale = weights[k, n, bits]
        x = torch.randn((m, k), generator=gen, device=dev).to(x_dtype)
        hold("qmatmul_f32",
             qmm.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k),
             ref.qmatmul_f32(x, packed, scale, bits=bits, k_orig=k),
             QMM_TOL, f"M={m} K={k} N={n} bits={bits}")
    del weights
    for e, c, k, n, bits, x_dtype in calls.get("qmatmul_f32_grouped", ()):
        packed, scale = expert_weights(torch, ops, gen, dev, e, k, n, bits)
        x = torch.randn((e, c, k), generator=gen, device=dev).to(x_dtype)
        got = qmm.qmatmul_f32_grouped(x, packed, scale, bits=bits, k_orig=k)
        hold("qmatmul_f32_grouped", got,
             ref.qmatmul_f32_grouped(x, packed, scale, bits=bits, k_orig=k),
             QMM_TOL, f"E={e} C={c} K={k} N={n} bits={bits}")
        del packed, scale, x, got
    wires = {}
    for m, k, n, bits in calls["qmatmul_f32_blockscale"]:
        if (k, n, bits) not in wires:
            wires[k, n, bits] = wire_weight(torch, gen, dev, n, k, bits)
        packed, scales = wires[k, n, bits]
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        hold("qmatmul_f32_blockscale",
             qmm.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                        k_orig=k),
             ref.qmatmul_f32_blockscale(x, packed, scales, bits=bits,
                                        k_orig=k),
             QMM_TOL, f"M={m} K={k} N={n} bits={bits}")
    del wires
    for e, c, k, n, bits in calls.get("qmatmul_f32_blockscale_grouped", ()):
        packed, scales = expert_wire_weights(torch, ops, gen, dev, e, k, n,
                                             page_bits=bits)
        x = torch.randn((e, c, k), generator=gen, device=dev).to(dtype)
        hold("qmatmul_f32_blockscale_grouped",
             qmm.qmatmul_f32_blockscale_grouped(x, packed, scales, bits=bits,
                                                k_orig=k),
             ref.qmatmul_f32_blockscale_grouped(x, packed, scales, bits=bits,
                                                k_orig=k),
             QMM_TOL, f"E={e} C={c} K={k} N={n} bits={bits}")
        del packed, scales, x
    for (qs, ks, causal, scale, window, offs, p_dtype,
         out_dtype) in calls["flash_attention"]:
        q = torch.randn(qs, generator=gen, device=dev).to(dtype)
        k = torch.randn(ks, generator=gen, device=dev).to(dtype)
        v = torch.randn(ks, generator=gen, device=dev).to(dtype)
        off = (torch.tensor(offs, dtype=torch.int32, device=dev)
               if isinstance(offs, tuple) else offs)
        kw = dict(causal=causal, scale=scale, window=window, q_offset=off,
                  p_dtype=p_dtype or torch.float32, out_dtype=out_dtype)
        tol = FLASH_TOL if dtype == torch.float32 else (
            lambda e, pr=p_dtype == torch.bfloat16: flash_bf16_bound(e, pr))
        hold("flash_attention", fa.flash_attention(q, k, v, **kw),
             ref.flash_attention(q, k, v, **kw), tol,
             f"q {qs} k {ks} window {window} q_offset {offs} P {p_dtype}")
    for (bsz, s, di), n, has_h0, in_place in calls["selective_scan"]:
        args = list(scan_inputs(torch, gen, dev, bsz, s, di, n, has_h0))
        for i in (0, 1, 3, 4):                 # x, dt, B, C
            args[i] = args[i].to(dtype)
        y, h = ssm.selective_scan(*args)
        y_ref, h_ref = ref.selective_scan(*args)
        what = f"({bsz}, {s}, {di}) N={n} h0={has_h0}"
        hold("selective_scan", y, y_ref, scan_y_tol, what + " y")
        hold("selective_scan", h, h_ref, SCAN_TOL, what + " h_last")
        if in_place:
            cache = args[-1].clone()
            y_ip, h_ip = ssm.selective_scan(*args[:-1], cache, h_out=cache)
            torch.cuda.synchronize()
            if not (torch.equal(y_ip, y) and torch.equal(h_ip, h)):
                raise AssertionError(f"{arch} selective_scan {what}: h_last "
                                     "written over h0 differs")
    torch.cuda.empty_cache()

    def span(vals):
        return f"{min(vals)}-{max(vals)}" if vals else "-"
    qc, gc_, bc, gbc, fc, sc = (calls.get(k, []) for k in (
        "qmatmul_f32", "qmatmul_f32_grouped", "qmatmul_f32_blockscale",
        "qmatmul_f32_blockscale_grouped", "flash_attention",
        "selective_scan"))
    print(f"[check] {arch} path{'' if dtype == torch.float32 else ' (bf16)'}"
          f", kernels vs plain at each distinct call of "
          f"the serve: qmatmul_f32 {len(qc)} (M {span([c[0] for c in qc])}, "
          f"(K, N) {sorted({c[1:3] for c in qc})}), qmatmul_f32_grouped "
          f"{len(gc_)} ((E, C) {sorted({c[:2] for c in gc_})}, (K, N) "
          f"{sorted({c[2:4] for c in gc_})}), qmatmul_f32_blockscale "
          f"{len(bc)} (M {span([c[0] for c in bc])}, (K, N) "
          f"{sorted({c[1:3] for c in bc})}), "
          f"qmatmul_f32_blockscale_grouped {len(gbc)} ((E, C) "
          f"{sorted({c[:2] for c in gbc})}, (K, N) "
          f"{sorted({c[2:4] for c in gbc})}), flash_attention "
          f"{len(fc)} (q {sorted({c[0] for c in fc})}, k "
          f"{sorted({c[1] for c in fc})}, windows "
          f"{sorted({c[4] for c in fc if c[4] is not None})}), "
          f"selective_scan {len(sc)} ((Bz, S, Di) "
          f"{sorted({c[0] for c in sc})}, {sum(c[3] for c in sc)} written "
          f"over h0); max abs err {json.dumps(worst)}"
          f"{'; err / bound ' + json.dumps(share) if share else ''}")
    return dict(cases={k: len(v) for k, v in calls.items()},
                max_abs_err=worst, share_of_bound=share)


# the wrappers that also split their launches, with the attribute that
# holds the split: flash attention by (Sq, Sk), the scan by route
SPLIT_LAUNCHES = {"flash_attention": "launches_by_shape",
                  "selective_scan": "launches_by_route"}


def zero_launches(counters):
    """Sets each wrapper's launch count, and its split of them, to 0."""
    for name, fn in counters.items():
        fn.launches = 0
        if name in SPLIT_LAUNCHES:
            getattr(fn, SPLIT_LAUNCHES[name]).clear()


def read_launches(counters):
    """({wrapper: launches}, {wrapper: its split of them}); fails if a
    split does not add up to its wrapper's count."""
    launches = {name: fn.launches for name, fn in counters.items()}
    split = {name: dict(getattr(counters[name], attr))
             for name, attr in SPLIT_LAUNCHES.items() if name in counters}
    for name, by in split.items():
        if sum(by.values()) != launches[name]:
            raise AssertionError(f"{name}: launches split as {by} add up to "
                                 f"{sum(by.values())}, not {launches[name]}")
    return launches, split


def serve_prompts(np, vocab: int, long_prompt: bool):
    """(rng, lengths, prompts) of ``serve_lm``'s 8 requests: 16-256 tokens,
    the last 1,000-1,200 with ``long_prompt`` (hymba-1.5b's: 1,035); the
    rng goes on to draw the forward check's tokens."""
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 257, 8)
    if long_prompt:
        lens[-1] = rng.integers(1000, 1201)
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]
    return rng, lens, prompts


def serve_lm(torch, m, cfg, max_len: int, long_prompt: bool, counters,
             depth, dev, make_tree=None, logits_tol=None):
    """Serve 8 greedy requests (prompts of 16-256 tokens, one of 1,000-1,200
    with ``long_prompt``; 16 new tokens each) on full-width ``cfg`` with
    random weights from a CUDA generator seeded 0, frozen at 8 bits (or the
    packed tree ``make_tree()`` builds); the family's kernels must launch.
    Then ``forward`` logits of 64 tokens on the card against the CPU's plain
    path, on the first ``depth`` layers (all with None), within
    ``logits_tol`` (default: LOGITS_TOL for all layers, CUT_LOGITS_TOL for
    a cut copy).  Returns the serve's readings and the packed tree."""
    np, tfm = m["np"], m["tfm"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    if make_tree is not None:
        packed = make_tree()
    else:
        params = tfm.init_params(cfg, generator=torch.Generator(
            device=dev).manual_seed(0))
        packed = m["freeze"](params, bits=8)
        del params
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    n_packed = sum(t.numel() * t.element_size() for t in leaves(packed))
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model},"
          f" vocab {cfg.vocab_size}; init + freeze (8-bit) "
          f"{time.perf_counter() - t0:.2f} s, {n_packed / 2**30:.3f} GiB "
          f"frozen, peak {init_peak / 2**30:.3f} GiB")
    eng = m["ServingEngine"](cfg, packed, batch_slots=4, max_len=max_len)
    rng, lens, prompts = serve_prompts(np, cfg.vocab_size, long_prompt)
    if cfg.family == "ssm" and lens.max() <= eng.prefill_chunk:
        raise AssertionError("no prompt spans two prefill chunks")
    reqs = [m["Request"](uid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_launches(counters)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done, ticks = [], 0
    while eng.pending:
        done += eng.step()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_class = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    ttft = [r.first_token_s - r.arrival_s for r in done]
    if len(done) != 8 or any(len(r.generated) != 16 for r in done):
        raise AssertionError("not every request got its 16 tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("token id out of the vocabulary")
    for name in SERVE_KERNELS[cfg.family]:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched while serving "
                                 f"{cfg.name}")
    print(f"[serve] {cfg.name}: {len(done)} requests, prompts "
          f"{lens.tolist()} ({int(lens.sum())} prompt tokens), "
          f"{sum(len(r.generated) for r in done)} new tokens, wall "
          f"{wall:.3f} s after synchronize ({ticks} ticks, "
          f"{wall / ticks * 1e3:.1f} ms a tick, "
          f"{sum(len(r.generated) for r in done) / wall:.2f} new tok/s), "
          f"TTFT mean {np.mean(ttft):.3f} s "
          f"max {np.max(ttft):.3f} s, peak memory {peak / 2**30:.3f} GiB "
          f"({base / 2**30:.3f} GiB allocated at the start), "
          f"launches {launches}, by flash shape and scan route "
          f"{json.dumps(by_class)}")
    del eng
    # the same requests again on a fresh engine, under the profiler, with
    # the kernel calls noted; then each kernel at each of those calls
    with recording(torch, m["ops"]) as calls:
        profile = profile_serve(torch, cfg, lambda: m["ServingEngine"](
            cfg, packed, batch_slots=4, max_len=max_len), [
                m["Request"](uid=r.uid, prompt=r.prompt, max_new_tokens=16)
                for r in reqs])
    path_check = check_path(torch, m["ops"], m["ref"], m["qmm"], m["fa"],
                            m["ssm"], dev, cfg.name, calls)

    # card vs CPU logits with the same packed weights: 64 tokens, and with
    # a long prompt that prompt too (hymba's window binds there)
    fcfg, tree = cfg, packed
    if depth is not None:
        fcfg = cfg.replace(n_layers=depth)
        tree = dict(packed, layers=first_layers(packed["layers"], depth))
    tree_cpu = to_device(torch, tree, "cpu")
    seqs = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64)))]
    if long_prompt:
        seqs.append(torch.from_numpy(reqs[-1].prompt[None].astype(np.int64)))
    tol = logits_tol or (LOGITS_TOL if depth is None else CUT_LOGITS_TOL)
    errs = []
    for toks in seqs:
        gpu_logits = tfm.forward(tree, toks.to(dev), fcfg).cpu()
        cpu_logits = tfm.forward(tree_cpu, toks, fcfg)
        err = (gpu_logits - cpu_logits).abs().max().item()
        top1 = (gpu_logits.argmax(-1) == cpu_logits.argmax(-1)).float().mean()
        positions = cfg.n_meta_tokens + toks.shape[1]
        if not (torch.isfinite(gpu_logits).all() and gpu_logits.shape
                == (1, positions, cfg.vocab_size)):
            raise AssertionError(f"{cfg.name}: card logits are not finite or "
                                 "misshapen")
        if not torch.allclose(gpu_logits, cpu_logits, **tol):
            raise AssertionError(f"{cfg.name} card vs CPU logits, "
                                 f"{toks.shape[1]} tokens: max abs err {err}")
        windows = tfm.layer_windows(fcfg)
        print(f"[forward] {cfg.name} ({fcfg.n_layers} of {cfg.n_layers} "
              f"layers, windows {windows}) {toks.shape[1]} tokens "
              f"({positions} positions) card vs CPU: max abs err {err:.3e} "
              f"(tolerance {tol}), top-1 agreement {top1.item():.4f}, max "
              f"|logit| {cpu_logits.abs().max().item():.3f}")
        errs.append(err)
        del gpu_logits, cpu_logits
    return dict(launches=launches, launches_by_class=by_class,
        wall_s=wall, ticks=ticks, ttft_mean_s=float(np.mean(ttft)), ttft_max_s=float(np.max(ttft)), peak_gib=peak / 2**30,
        prompt_tokens=int(lens.sum()), logits_max_abs_err=max(errs),
        path_check=path_check, profile=profile), packed


# the paged path: qwen3-0.6b frozen at 4 bits, half the store's bytes pinned
# on the card, the cold half int8-paged and served from its wire form
# (benchmarks/serving_load.py --wire-serve at budget_frac 0.5)
PAGED_ARCH = "qwen3-0.6b"
# the store's first 14 of qwen3-0.6b's 28 layers at full width (its checks
# hold at any depth; cut so that the script ends within 1,000 s on a fast
# machine and 1,200 s on one ~25 % slower): phases 6, 7, 15 (b) and 16
PAGED_LAYERS = 14
PAGED_KERNELS = ("qmatmul_f32", "qmatmul_f32_blockscale", "flash_attention")
PAGED_FAULTS = dict(seed=3, fail_rate=0.2, bitflip_rate=0.2)


def host_cold(m, packed, plan, cold, bits: int):
    """After ``attach_paging``, the caller's cold leaves go to the host too,
    so that the card holds the pinned groups and nothing of the cold ones.
    Returns (the tree with the cold leaves on the host, their packed and
    scale bytes on the card); the caller drops its old tree before
    ``check_freed``."""
    pg = m["paging"]
    on_card = pg.packed_tree_store(packed, plan).params
    want = sum(t.numel() * t.element_size() for n in cold
               for t in (on_card[n].packed, on_card[n].scale))
    return pg.thread_packed(packed, {
        n: m["PackedParam"](packed=on_card[n].packed.cpu(),
                            scale=on_card[n].scale.cpu(), bits=bits,
                            orig_shape=on_card[n].orig_shape)
        for n in cold}), want


def check_freed(torch, before: int, want: int, groups: int) -> int:
    """The card's memory, ``before`` allocated ahead of ``attach_paging``,
    must have fallen by the cold groups' ``want`` bytes; returns the bytes
    freed."""
    gc.collect()
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    # the allocator rounds a block up by less than 1 MiB + 512 B
    if not want <= freed <= want + groups * 2 * (2**20 + 512):
        raise AssertionError(f"attach_paging and the release of the cold "
                             f"leaves freed {freed} B of device memory, "
                             f"want {want} B (the cold groups' packed "
                             f"and scale bytes)")
    return freed


def serve_paged(torch, m, cfg, dev):
    """Serve the 8 greedy requests of ``serve_lm`` from a paged 4-bit store
    with wire-serve on; check the counters, the tokens against a resident
    engine on the same wire-form bytes, the same serve under faults, an
    overlapped pass against a sync one, and card vs CPU logits of the wire
    tree; time B3 and split the paged tick into CRC, copy and compute.
    Returns the readings, B3's error and times, and the paged store (the
    tree with its cold leaves on the host, the plan) with the resident
    wire-form tree and plan, for phase 7, and the served tokens, for
    phase 16."""
    np, tfm, pl, pg = m["np"], m["tfm"], m["placement"], m["paging"]
    qmm, fa = m["qmm"], m["fa"]
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0))
    packed = m["freeze"](params, bits=4)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sizes = pl.packed_sizes(packed)
    plan = pl.plan_for_budget(
        sizes, sum(sizes.values()) // 2, sizes_bits=4,
        hot=pl.Placement("l1mram", 4, "resident"),
        cold=pl.Placement("l1mram", 4, "paged", 8))
    hot, cold = plan.split_names(sorted(sizes))
    linears = [LAYER_LINEARS[n.split("/")[-1]] for n in cold]
    print(f"[paged] {cfg.name}: init + freeze (4-bit) "
          f"{time.perf_counter() - t0:.2f} s; store {sum(sizes.values())} B, "
          f"budget {sum(sizes.values()) // 2} B; pinned {hot} "
          f"({plan.resident_bytes(sizes)} B), cold int8-paged {cold} "
          f"({plan.paged_bytes(sizes)} B at 4 bits)")
    bs_err = check_blockscale(torch, m["ref"], qmm, dev, linears)
    t_bs = {"decode": time_blockscale(torch, m["packing"], m["ref"], qmm,
                                      dev, 4, linears),
            "prefill": time_blockscale(torch, m["packing"], m["ref"], qmm,
                                       dev, 256, linears)}
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)          # serve_lm's requests
    lens = rng.integers(16, 257, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]

    def requests():
        return [m["Request"](uid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]

    def engine(faults=None):
        eng = m["ServingEngine"](cfg, packed, batch_slots=4, max_len=512,
                                 plan=plan)
        eng.attach_paging(wire_serve=True, faults=faults)
        return eng

    def serve(eng):
        for r in requests():
            eng.submit(r)
        ticks = []
        while eng.pending:
            t = time.perf_counter()
            eng.step()
            ticks.append((time.perf_counter() - t, eng.last_stall_s))
        torch.cuda.synchronize()
        done = eng.finished
        if len(done) != 8 or any(len(r.generated) != 16 for r in done):
            raise AssertionError("not every request got its 16 tokens")
        if any(not 0 <= t < cfg.vocab_size for r in done
               for t in r.generated):
            raise AssertionError("token id out of the vocabulary")
        return {r.uid: r.generated for r in done}, ticks, done

    t0 = time.perf_counter()
    eng = m["ServingEngine"](cfg, packed, batch_slots=4, max_len=512,
                             plan=plan)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng.attach_paging(wire_serve=True)
    attach_s = time.perf_counter() - t0
    pager = eng.pager
    packed, want = host_cold(m, packed, plan, cold, 4)
    freed = check_freed(torch, before, want, len(cold))
    print(f"[paged] device memory fell by {freed} B after attach_paging and "
          f"the release of the caller's cold leaves (cold packed + scale "
          f"{want} B; plan.paged_bytes {plan.paged_bytes(sizes)} B)")
    n_pages = len(pager.pages)
    wire_pass = sum(p.wire_nbytes for p in pager.pages)
    print(f"[paged] attach_paging(wire_serve=True) {attach_s:.2f} s (host "
          f"encode, pin, CRC); {n_pages} pages "
          f"{[list(p.param_names) for p in pager.pages]}, {wire_pass} wire B "
          f"a pass ({sum(p.nbytes for p in pager.pages)} B on the card at "
          f"4 bits), wire-served {sorted(pager.wire_served)}")
    counters = {"qmatmul_f32": qmm.qmatmul_f32,
                "qmatmul_f32_blockscale": qmm.qmatmul_f32_blockscale,
                "flash_attention": fa.flash_attention}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_launches(counters)
    t0 = time.perf_counter()
    tokens, ticks, done = serve(eng)
    wall = time.perf_counter() - t0
    launches, by_class = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    ttft = [r.first_token_s - r.arrival_s for r in done]
    summary, fsum = eng.paging_summary(), eng.faults_summary()
    for name in PAGED_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched in the paged serve")
    per_pass = pg.pass_counters(n_pages, 2)
    if (summary["swap_count"], summary["miss_count"]) != (
            len(ticks) * per_pass["swaps"], len(ticks) * per_pass["misses"]):
        raise AssertionError(f"swap / miss {summary['swap_count']} / "
                             f"{summary['miss_count']} over {len(ticks)} "
                             f"ticks, want {per_pass} a tick")
    if summary["decode_s"] != 0.0 or summary["decode_skipped_bytes"] <= 0:
        raise AssertionError(f"wire-serve decoded on the host: {summary}")
    if any(fsum.values()):
        raise AssertionError(f"fault counters moved without faults: {fsum}")
    nt = len(ticks)
    tick_mean = sum(t for t, _ in ticks) / nt
    exposed = sum(s for _, s in ticks) / nt
    split = dict(ticks=nt, tick_ms=tick_mean * 1e3,
                 exposed_ms=exposed * 1e3,
                 crc_ms=summary["crc_s"] / nt * 1e3,
                 copy_ms=summary["copy_s"] / nt * 1e3,
                 compute_ms=(tick_mean - exposed) * 1e3)
    print(f"[paged] {cfg.name} paged serve: {len(done)} requests, prompts "
          f"{lens.tolist()}, wall {wall:.3f} s after synchronize, TTFT mean "
          f"{np.mean(ttft):.3f} s max {np.max(ttft):.3f} s, peak memory "
          f"{peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB at the start), "
          f"launches {launches}, by flash shape "
          f"{json.dumps(by_class)}; {nt} ticks x {per_pass} = swaps "
          f"{summary['swap_count']} misses {summary['miss_count']}, "
          f"{summary['bytes_streamed_wire']} wire B streamed, decode_s "
          f"{summary['decode_s']}, decode_skipped_bytes "
          f"{summary['decode_skipped_bytes']}")
    print(f"[paged] tick split (host clock, mean of {nt}): tick "
          f"{split['tick_ms']:.2f} ms = exposed page wait "
          f"{split['exposed_ms']:.2f} ms (worker: CRC {split['crc_ms']:.2f} "
          f"ms, copy {split['copy_ms']:.2f} ms) + compute "
          f"{split['compute_ms']:.2f} ms")

    # a resident engine on the same bytes: the cold groups already in wire
    # form on the card, the same plan, no pager
    wire_plan = plan.replace(wire_serve=True)
    view = {n: m["PackedParam"](packed=p.packed.to(dev),
                                scale=p.scale.to(dev), bits=p.bits,
                                orig_shape=p.orig_shape)
            for n, p in pager.template_view().items()}
    wire_tree = pg.thread_packed(packed, {**pager.resident, **view})
    resident = m["ServingEngine"](cfg, wire_tree, batch_slots=4,
                                  max_len=512, plan=wire_plan)
    r_tokens, _, _ = serve(resident)
    del resident
    if r_tokens != tokens:
        bad = [u for u in tokens if tokens[u] != r_tokens[u]]
        raise AssertionError(f"paged tokens differ from the resident "
                             f"wire-form engine's for uids {bad}")
    print("[paged] tokens equal per uid, bit for bit, to a resident engine "
          "holding the same wire-form bytes on the card (no pager)")

    # one pass overlapped with a forward, against a sync pass
    toks64 = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))).to(
        dev)
    ps = pager.begin_pass()
    tfm.forward(wire_tree, toks64, cfg, engine=wire_plan)
    torch.cuda.synchronize()
    fenced = ps.fence()
    synced = {}
    for _page, got in pager.stream():
        synced.update(got)
    if set(fenced) != set(cold) or any(
            not (torch.equal(fenced[n].packed, synced[n].packed)
                 and torch.equal(fenced[n].scale, synced[n].scale)
                 and torch.equal(fenced[n].packed, view[n].packed))
            for n in cold):
        raise AssertionError("an overlapped pass's pages differ from a "
                             "sync pass's")
    overlap = dict(swap_s=ps.swap_s, window_s=ps.window_s,
                   hidden_s=ps.hidden_s, exposed_s=ps.exposed_s)
    print(f"[paged] begin_pass() overlapped with a 64-token forward, then "
          f"fence(): pages torch.equal to a sync stream() pass; swap_s "
          f"{ps.swap_s:.4f} hidden_s {ps.hidden_s:.4f} exposed_s "
          f"{ps.exposed_s:.4f} (window_s {ps.window_s:.4f})")
    del fenced, synced
    pager.close()
    del eng, pager

    # the same requests again under the profiler, the kernel calls noted
    engines = []

    def profiled_engine():
        engines.append(engine())
        return engines[-1]

    with recording(torch, m["ops"]) as calls:
        profile = profile_serve(torch, cfg, profiled_engine, requests())
    engines.pop().pager.close()
    path_check = check_path(torch, m["ops"], m["ref"], qmm, fa, m["ssm"],
                            dev, f"{cfg.name} paged", calls)

    # the same serve under faults
    chaos = engine(m["FaultPlan"](**PAGED_FAULTS))
    f_tokens, _, _ = serve(chaos)
    fsum = chaos.faults_summary()
    chaos.pager.close()
    del chaos
    if f_tokens != tokens:
        raise AssertionError("tokens changed under faults")
    if fsum["injected"] <= 0 or fsum["checksum_failures"] != \
            fsum["refetches"]:
        raise AssertionError(f"fault counters {fsum}")
    print(f"[paged] under FaultPlan({PAGED_FAULTS}): tokens equal per uid; "
          f"faults {fsum}")

    # card vs CPU logits of the wire tree, first 4 layers
    depth = min(4, cfg.n_layers)
    fcfg = cfg.replace(n_layers=depth)
    tree = dict(wire_tree, layers=first_layers(wire_tree["layers"], depth))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64)))
    gpu_logits = tfm.forward(tree, toks.to(dev), fcfg,
                             engine=wire_plan).cpu()
    cpu_logits = tfm.forward(to_device(torch, tree, "cpu"), toks, fcfg,
                             engine=wire_plan)
    err = (gpu_logits - cpu_logits).abs().max().item()
    if not (torch.isfinite(gpu_logits).all()
            and gpu_logits.shape == (1, 64, cfg.vocab_size)):
        raise AssertionError("paged wire tree: card logits are not finite "
                             "or misshapen")
    if not torch.allclose(gpu_logits, cpu_logits, **CUT_LOGITS_TOL):
        raise AssertionError(f"wire tree card vs CPU logits: max abs err "
                             f"{err}")
    print(f"[forward] {cfg.name} wire tree ({depth} of {cfg.n_layers} "
          f"layers, cold groups in wire form) 64 tokens card vs CPU: max "
          f"abs err {err:.3e} (tolerance {CUT_LOGITS_TOL})")
    bs_err = max(bs_err, path_check["max_abs_err"]["qmatmul_f32_blockscale"])
    return dict(
        launches=launches, launches_by_class=by_class, wall_s=wall,
        ttft_mean_s=float(np.mean(ttft)),
        ttft_max_s=float(np.max(ttft)), peak_gib=peak / 2**30,
        prompt_tokens=int(lens.sum()), attach_s=attach_s,
        cold_freed_bytes=freed,
        plan=dict(pinned=hot, cold=cold,
                  resident_bytes=plan.resident_bytes(sizes),
                  paged_bytes=plan.paged_bytes(sizes)),
        n_pages=n_pages, wire_bytes_per_pass=wire_pass,
        paging={k: v for k, v in summary.items()}, tick_split=split,
        overlap=overlap, faults=fsum, logits_max_abs_err=err,
        path_check=path_check, profile=profile), bs_err, t_bs, dict(
            packed=packed, plan=plan, wire_tree=wire_tree,
            wire_plan=wire_plan, tokens=tokens)


# the scheduled XR serve: the XR traffic and the two scheduling legs of
# benchmarks/serving_load.py (STREAMS :95-99, _VirtualClock :288-303,
# _xr_traffic :306-330, _run_xr :333-382, the gate :385-417), copied since
# the bench imports JAX; its defaults --xr-requests 60, --slots 4,
# --max-len 128, --prefill-chunk 16, --token-budget 96, --tick-ms 1
XR_STREAMS = (("hand_tracking", dict(priority=2, deadline_ms=15.0)),
              ("gaze", dict(priority=1, deadline_ms=10.0)),
              ("assistant", dict(priority=0, deadline_ms=None)))
XR_TRACKERS = ("hand_tracking", "gaze")
XR = dict(requests=60, slots=4, max_len=128, prefill_chunk=16,
          token_budget=96, tick_s=1e-3, period_ms=6.0, assist_new=24, seed=0)
XR_ARCH = "qwen3-0.6b"
# the first 4 of qwen3-0.6b's 28 layers (14 before phase 17 (f) and the
# bf16 legs came), at full width, so that the script, the build included,
# ends within 1,000 s of its 1,200 on a fast machine (PERF.md sections 4
# and 7); on the virtual clock the decisions do not depend on the depth
XR_LAYERS = 4
XR_PAGED_REQUESTS = 24           # parts (c)-(d): ~0.1 s a paged tick
XR_GATE = dict(miss_rate=0.05, assistant_tok_ratio=0.90)


class VirtualClock:
    """Deterministic time: the loop advances one tick's ``tick_s`` per
    scheduler tick, and every read adds 1 us so that timestamps within a
    tick stay ordered."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        self.now += 1e-6
        return self.now

    def advance(self, seconds):
        self.now += seconds


def xr_traffic(make_request, vocab: int, n_requests: int = XR["requests"],
               seed: int = XR["seed"]):
    """A t = 0 backlog of best-effort assistant requests (16-48 prompt
    tokens, 24 new) and a hand-tracking and a gaze request (4-8 and 2-6
    prompt tokens, 2 new) every 6 ms: [(arrival s, stream, request)] in
    arrival order."""
    import numpy as np

    rng = np.random.default_rng(seed + 7)
    events, uid = [], 0
    n_per_stream = max(n_requests // 3, 2)
    for _ in range(n_per_stream):
        n = int(rng.integers(16, 48))
        events.append((0.0, "assistant", make_request(
            uid=uid,
            prompt=rng.integers(0, vocab, n).astype(np.int32),
            max_new_tokens=XR["assist_new"])))
        uid += 1
    period = XR["period_ms"] / 1e3
    for k in range(n_per_stream):
        for off, stream, lo, hi in ((0.004, "hand_tracking", 4, 9),
                                    (0.006, "gaze", 2, 7)):
            n = int(rng.integers(lo, hi))
            events.append((off + k * period, stream, make_request(
                uid=uid,
                prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=2)))
            uid += 1
    return sorted(events, key=lambda e: (e[0], e[2].uid))


def xr_scheduler(scheduler_cls, eng, clock, continuous: bool, **kw):
    """The bench's two legs: run-to-completion, or continuous (the token
    budget, preemption, reject-mode admission with the cost model pinned
    to one tick); ``kw`` adds to or overrides the leg's arguments."""
    args = dict(prefill_chunk=XR["prefill_chunk"], clock=clock,
                token_budget=XR["token_budget"] if continuous else None,
                preemptive=continuous,
                admission="reject" if continuous else None,
                est_tick_s=XR["tick_s"] if continuous else None)
    sched = scheduler_cls(eng, **{**args, **kw})
    for name, spec in XR_STREAMS:
        sched.add_stream(name, **spec)
    return sched


def serve_xr(sched, clock, events, tick_s=XR["tick_s"]):
    """Submit each request at its arrival and tick until all are served;
    on a :class:`VirtualClock` (``tick_s`` set) each tick advances it
    ``tick_s``, on the real clock (``tick_s`` None) arrivals wait for the
    wall.  Returns (finished requests, {uid: time of the tick that
    admitted it}), both clocks measured from the first arrival."""
    from collections import deque

    t0 = 0.0 if tick_s is not None else clock()

    def now():
        return clock.now if tick_s is not None else clock() - t0

    arrivals = deque(events)
    done, admitted = [], {}
    while arrivals or sched.pending:
        if not sched.pending and arrivals and arrivals[0][0] > now():
            if tick_s is not None:
                clock.advance(arrivals[0][0] - clock.now)
            else:
                time.sleep(arrivals[0][0] - now())
        while arrivals and arrivals[0][0] <= now():
            _t, stream, req = arrivals.popleft()
            sched.submit(req, stream=stream)
        queued, t_tick = list(sched.queue), now()
        done += sched.tick()
        waiting = {id(r) for r in sched.queue}
        for r in queued:
            if id(r) not in waiting and not r.rejected:
                admitted.setdefault(r.uid, t_tick)
        if tick_s is not None:
            clock.advance(tick_s)
    return done, admitted


def xr_record(sched, done, admitted):
    """What the scheduler decided, per uid and in its counters: the part of
    a run that depends on the traffic and not on the model or the device."""
    per_uid = {r.uid: dict(arrival_s=r.arrival_s, admitted_s=admitted.get(
        r.uid), first_token_s=r.first_token_s, finish_s=r.finish_s,
        preemptions=r.preemptions, rejected=r.rejected, degraded=r.degraded,
        max_new_tokens=r.max_new_tokens, n_generated=len(r.generated))
        for r in done + sched.rejected}
    mt = sched.metrics
    counters = dict(ticks=sched.ticks, deferred_ticks=sched.deferred_ticks,
                    preemptions=mt.preemptions, restores=mt.restores,
                    rejected=mt.rejected, degraded=mt.degraded,
                    budget_used=list(mt.tick_budget_used))
    return dict(per_uid=dict(sorted(per_uid.items())), counters=counters)


def xr_gate(base, cont):
    """The bench's gate over the two legs' runs: the trackers' worst miss
    rate in the continuous leg, and its assistant tok/s (virtual seconds)
    over the baseline's."""
    def assist_tok_s(run):
        recs = run["sched"].metrics.records
        return (sum(r.n_generated for r in recs if r.stream == "assistant")
                / max(run["doc"]["throughput"]["wall_s"], 1e-9))
    miss = max(cont["doc"]["streams"][s]["miss_rate"] for s in XR_TRACKERS
               if s in cont["doc"]["streams"])
    return miss, assist_tok_s(cont) / max(assist_tok_s(base), 1e-9)


def serve_xr_phase(torch, m, cfg, resident_tree, paged, dev):
    """Phase 7, the scheduled XR serve (see the module doc): (a) the
    resident 8-bit qwen3-0.6b under both legs, (b) the decisions against a
    2-layer smoke config on the CPU, (c) the paged 4-bit store under the
    continuous leg, (d) that leg again on the real clock."""
    np, sv, tr_mod, qmm, fa = m["np"], m["serving"], m["trace"], m["qmm"], \
        m["fa"]
    counters = {"qmatmul_f32": qmm.qmatmul_f32,
                "qmatmul_f32_blockscale": qmm.qmatmul_f32_blockscale,
                "flash_attention": fa.flash_attention}
    total = {name: 0 for name in counters}
    total_split = {}

    def count(launches, split):
        for name, n in launches.items():
            total[name] += n
        for name, by in split.items():
            for k, n in by.items():
                total_split.setdefault(name, {})
                total_split[name][k] = total_split[name].get(k, 0) + n

    calls = {}

    def leg(eng, continuous, events, traced=False, clock=None,
            counted=True, recorded=False, **kw):
        """One leg on ``eng``; a card leg's launches go into the phase's
        count unless ``counted`` is False (a leg that is only a reference),
        and with ``recorded`` its kernel calls go into ``calls``."""
        clock = clock if clock is not None else VirtualClock()
        tracer = tr_mod.Tracer() if traced else None
        sched = xr_scheduler(sv.Scheduler, eng, clock, continuous,
                             tracer=tracer, trace_track="xr", **kw)
        zero_launches(counters)
        t0 = time.perf_counter()
        with (recording(torch, m["ops"]) if recorded
              else contextlib.nullcontext({})) as seen:
            done, admitted = serve_xr(sched, clock, events,
                                      XR["tick_s"] if isinstance(
                                          clock, VirtualClock) else None)
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches, split = read_launches(counters)
        if eng.device.type == "cuda" and counted:
            count(launches, split)
        for name, keys in seen.items():
            calls[name] = list(dict.fromkeys(calls.get(name, []) + keys))
        doc = sv.validate(sched.metrics.summary(
            paging=eng.paging_summary(), trace=sched.trace_summary(),
            faults=sched.faults_summary()))
        if tracer is not None:
            tr_mod.validate(tracer.to_dict())
        if any(not 0 <= t < eng.cfg.vocab_size for r in done
               for t in r.generated):
            raise AssertionError("token id out of the vocabulary")
        return dict(sched=sched, done=done, doc=doc, wall_s=wall,
                    launches=launches, split=split, tracer=tracer,
                    tokens={r.uid: r.generated for r in done},
                    record=xr_record(sched, done, admitted))

    def fresh(events, mod=None):
        return [(t, s, sv.Request(uid=r.uid, prompt=r.prompt if mod is None
                                  else r.prompt % mod,
                                  max_new_tokens=r.max_new_tokens))
                for t, s, r in events]

    # (a) resident 8-bit, both legs
    events = xr_traffic(sv.Request, cfg.vocab_size)
    res = {}
    for name, continuous in (("baseline", False), ("continuous", True)):
        eng = sv.ServingEngine(cfg, resident_tree, batch_slots=XR["slots"],
                               max_len=XR["max_len"], seed=XR["seed"])
        res[name] = leg(eng, continuous, fresh(events), traced=continuous,
                        recorded=continuous)
        for kname in ("qmatmul_f32", "flash_attention"):
            if res[name]["launches"][kname] <= 0:
                raise AssertionError(f"{kname} never launched in the XR "
                                     f"{name} leg")
        del eng
    base, cont = res["baseline"], res["continuous"]
    if base["tokens"] != cont["tokens"]:
        bad = [u for u in base["tokens"]
               if base["tokens"][u] != cont["tokens"].get(u)]
        raise AssertionError(f"XR tokens differ between the legs for uids "
                             f"{bad}")
    miss, ratio = xr_gate(base, cont)
    preempted = cont["doc"]["scheduler"]["preemptions"]
    gate = dict(deadline_miss_rate=miss, assistant_tok_ratio=ratio,
                preemptions=preempted,
                restores=cont["doc"]["scheduler"]["restores"],
                rejected=cont["doc"]["scheduler"]["rejected"],
                bit_exact=True, ticks=dict(
                    baseline=base["sched"].ticks,
                    continuous=cont["sched"].ticks))
    print(f"[xr] {cfg.name} resident (8-bit), {len(events)} requests: "
          f"gate {json.dumps(gate)}; host wall baseline "
          f"{base['wall_s']:.2f} s, continuous {cont['wall_s']:.2f} s; "
          f"trace {cont['tracer'].event_count} events on tracks "
          f"{cont['tracer'].track_names}; launches baseline "
          f"{base['launches']}, continuous {cont['launches']}")
    if not (preempted >= 1 and miss <= XR_GATE["miss_rate"]
            and ratio >= XR_GATE["assistant_tok_ratio"]):
        raise AssertionError(f"XR gate failed: {gate}")

    # (b) the decisions of a 2-layer smoke config of the family on the CPU
    scfg = cfg.smoke()
    sparams = m["tfm"].init_params(scfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    stree = m["freeze"](sparams, bits=8, device="cpu")
    for name, continuous in (("baseline", False), ("continuous", True)):
        eng = sv.ServingEngine(scfg, stree, batch_slots=XR["slots"],
                               max_len=XR["max_len"], seed=XR["seed"],
                               device="cpu")
        cpu = leg(eng, continuous, fresh(events, scfg.vocab_size))
        if cpu["record"] != res[name]["record"]:
            card_rec, cpu_rec = res[name]["record"], cpu["record"]
            bad = [u for u in card_rec["per_uid"]
                   if card_rec["per_uid"][u] != cpu_rec["per_uid"].get(u)]
            raise AssertionError(
                f"XR {name} leg: the card's decisions differ from the CPU's "
                f"on {scfg.n_layers} layers: uids {bad}, counters "
                f"{card_rec['counters']} vs {cpu_rec['counters']}")
    print(f"[xr] decisions (admission, first-token and finish times on the "
          f"virtual clock, preemptions, rejections, degradations, the "
          f"scheduler's counters) equal per uid to the CPU's on a "
          f"{scfg.n_layers}-layer smoke config of {cfg.name}, both legs")

    # (c) the paged 4-bit store (cold half int8 wire pages), continuous
    events24 = xr_traffic(sv.Request, cfg.vocab_size, XR_PAGED_REQUESTS)
    eng = sv.ServingEngine(cfg, paged["packed"], batch_slots=XR["slots"],
                           max_len=XR["max_len"], seed=XR["seed"],
                           plan=paged["plan"])
    eng.attach_paging(wire_serve=True)
    pg = leg(eng, True, fresh(events24), recorded=True, async_io=True)
    per_pass = m["paging"].pass_counters(len(eng.pager.pages),
                                         eng.page_resident_slots)
    ticks = pg["sched"].ticks
    summary = pg["doc"]["paging"]
    if (summary["swap_count"], summary["miss_count"]) != (
            ticks * per_pass["swaps"], ticks * per_pass["misses"]):
        raise AssertionError(f"paged XR: swap / miss "
                             f"{summary['swap_count']} / "
                             f"{summary['miss_count']} over {ticks} ticks, "
                             f"want {per_pass} a tick")
    if pg["launches"]["qmatmul_f32_blockscale"] <= 0:
        raise AssertionError("qmatmul_f32_blockscale never launched in the "
                             "paged XR leg")
    eng.pager.close()
    del eng
    wire = sv.ServingEngine(cfg, paged["wire_tree"], batch_slots=XR["slots"],
                            max_len=XR["max_len"], seed=XR["seed"],
                            plan=paged["wire_plan"])
    ref = leg(wire, True, fresh(events24), counted=False)
    del wire
    if ref["tokens"] != pg["tokens"]:
        bad = [u for u in pg["tokens"]
               if pg["tokens"][u] != ref["tokens"].get(u)]
        raise AssertionError(f"paged XR tokens differ from the resident "
                             f"wire-form engine's for uids {bad}")
    print(f"[xr] {cfg.name} paged (4-bit, cold half int8 wire pages), "
          f"continuous leg, {len(events24)} requests: {ticks} ticks x "
          f"{per_pass} = swaps {summary['swap_count']} misses "
          f"{summary['miss_count']}, preemptions "
          f"{pg['doc']['scheduler']['preemptions']}; tokens equal per uid to "
          f"a resident engine on the same wire-form bytes; host wall "
          f"{pg['wall_s']:.2f} s; launches {pg['launches']}")

    # each kernel against its plain version at every distinct call of the
    # continuous legs of (a) and (c)
    path_check = check_path(torch, m["ops"], m["ref"], qmm, fa, m["ssm"],
                            dev, f"{cfg.name} xr", calls)

    # (d) the same paged continuous leg on the real clock
    eng = sv.ServingEngine(cfg, paged["packed"], batch_slots=XR["slots"],
                           max_len=XR["max_len"], seed=XR["seed"],
                           plan=paged["plan"])
    eng.attach_paging(wire_serve=True)
    real = leg(eng, True, fresh(events24), clock=time.perf_counter,
               async_io=True)
    eng.pager.close()
    del eng
    doc = real["doc"]
    ttft = {}
    for s in sorted({r.stream for r in real["sched"].metrics.records}):
        xs = [r.ttft_s * 1e3 for r in real["sched"].metrics.records
              if r.stream == s and r.ttft_s is not None]
        ttft[s] = dict(p50=float(np.percentile(xs, 50)),
                       p99=float(np.percentile(xs, 99)), n=len(xs))
    pgs = doc["paging"]
    reading = dict(
        ttft_ms=ttft, tok_per_s=doc["throughput"]["tok_per_s"],
        wall_s=doc["throughput"]["wall_s"], ticks=doc["ticks"]["count"],
        tick_ms=doc["ticks"]["latency_ms"],
        miss_rate=doc["deadlines"]["miss_rate"],
        rejected=doc["scheduler"]["rejected"],
        preemptions=doc["scheduler"]["preemptions"],
        exposed_s=pgs["exposed_s"], hidden_s=pgs["hidden_s"],
        overlap_frac=pgs["overlap_frac"],
        predicted_vs_measured_stall_ratio=doc["trace"][
            "predicted_vs_measured_stall_ratio"])
    print(f"[xr] {cfg.name} paged continuous leg on the real clock "
          f"(smoke reading, nothing asserted): {json.dumps(reading)}")
    return dict(
        launches=total, launches_by_class=total_split, gate=gate,
        path_check=path_check,
        resident=dict(baseline=base["doc"], continuous=cont["doc"]),
        paged=dict(doc=pg["doc"], per_pass=per_pass, ticks=ticks),
        real_clock=reading)

# phase 8: KV paging and tenancy, the two-tenant leg of
# benchmarks/serving_load.py (_tenant_reqs :121-131, _bench_multi :134-210)
# at its defaults --arch qwen3-0.6b --arch2 falcon-mamba-7b --slots 4
# --max-new 8 --max-len 128 --prefill-chunk 16 --budget-frac 0.5
# --shared-budget-frac 0.6 --kv-block 16 --async-io, with --kv-paged for
# the tenant that has a KV cache; copied since the bench imports JAX.  The
# bench's 24 requests a tenant are cut to KV_REQUESTS / TENANT_REQUESTS
TENANCY = dict(slots=4, max_new=8, max_len=128, prefill_chunk=16,
               budget_frac=0.5, shared_budget_frac=0.6, kv_block=16, seed=0)
TENANTS = ("qwen3-0.6b", "falcon-mamba-7b")
# each tenant's first layers of phase 3's tree, at full width: phase 8's
# checks hold at any depth, and full depth took ~107 s of the 1,200 s the
# whole script must finish in, its kernels' build included (PERF.md
# sections 6-7); phase 11 (c) keeps falcon-mamba-7b's full-depth pages
# beside qwen3-0.6b's KV blocks in one pool
TENANCY_LAYERS = {"qwen3-0.6b": 4, "falcon-mamba-7b": 8}
KV_REQUESTS = 24                 # part (a): ~0.1-0.2 s a paged qwen3 tick
TENANT_REQUESTS = 8              # part (b): ~0.4 s of CRC a falcon pass
KV_KERNELS = ("qmatmul_f32", "flash_attention", "selective_scan")


def tenant_reqs(make_request, vocab: int, n_requests: int, salt: int):
    """``_tenant_reqs``: prompts of 2-47 tokens, ``max_new`` new tokens
    each, from ``default_rng(seed + salt)``."""
    import numpy as np

    rng = np.random.default_rng(TENANCY["seed"] + salt)
    hi = max(3, min(48, TENANCY["max_len"] - TENANCY["max_new"] - 2))
    out = []
    for uid in range(n_requests):
        n = int(rng.integers(2, hi))
        out.append(make_request(
            uid=uid, prompt=rng.integers(0, vocab, n).astype(np.int32),
            max_new_tokens=TENANCY["max_new"]))
    return out


def half_paged_plan(placement, tree):
    """The bench's plan: ``plan_for_budget`` at ``budget_frac`` of the
    store's bytes (8-bit, cold pages streamed verbatim)."""
    sizes = placement.packed_sizes(tree)
    return placement.plan_for_budget(
        sizes, int(sum(sizes.values()) * TENANCY["budget_frac"]))


def pool_replay_check(paging, pool, weights, tables, what):
    """Every pool member's counters and streamed bytes against the
    ``kv_pass_counters`` replay of the pool's event log; the KV tables'
    drops too.  Returns the replay."""
    pred = paging.kv_pass_counters(
        {name: paging.page_sizes(store.pages)
         for name, store in weights.items()},
        pool.budget_bytes, pool.events)
    summ = pool.summary()
    for name, c in summ["models"].items():
        got = dict(swaps=c["swaps"], misses=c["misses"],
                   pool_hits=c["pool_hits"], evicted=c["evicted"],
                   bytes_wire=c["bytes_streamed_wire"],
                   bytes_raw=c["bytes_streamed_raw"])
        want = {k: pred.get(name, {}).get(k, 0) for k in got}
        if name in tables:
            got["dropped"] = tables[name].dropped
            want["dropped"] = pred.get(name, {}).get("dropped", 0)
        if got != want:
            raise AssertionError(f"{what}: pool member {name} counters "
                                 f"{got}, the replay of the event log "
                                 f"{want}")
    return pred


def kv_span_bytes(memsys, table, events):
    """The bytes of the KV spans each fetch batch of ``table`` listed, by
    ``memsys.kv_stream_bytes`` over each slot's block range."""
    total = 0
    for ev in events:
        if ev[0] != "kv" or ev[1] != table.name:
            continue
        per_slot = {}
        for page, _nb in ev[2]:
            slot = page // table.n_blocks
            per_slot[slot] = per_slot.get(slot, 0) + 1
        total += sum(memsys.kv_stream_bytes(n * table.block_rows,
                                            table.block_rows,
                                            table.row_nbytes)
                     for n in per_slot.values())
    return total


def serve_kv_tenancy_phase(torch, m, cfgs, trees, dev):
    """Phase 8 (see the module doc): (a) qwen3-0.6b with its cold half and
    its KV cache paged through one pool, against a resident unpaged engine;
    (b) qwen3-0.6b (KV-paged) and falcon-mamba-7b as two tenants of one
    ``MultiScheduler`` and one pool, each against its solo run on a
    private pager.  ``cfgs`` / ``trees`` map each tenant to its config and
    its frozen 8-bit tree on ``dev``."""
    sv, paging, placement, memsys = (m["serving"], m["paging"],
                                     m["placement"], m["memsys"])
    qwen, falcon = TENANTS
    counters = {"qmatmul_f32": m["qmm"].qmatmul_f32,
                "flash_attention": m["fa"].flash_attention,
                "selective_scan": m["ssm"].selective_scan}
    names = [s for s, _kw in XR_STREAMS]
    card = dev.type == "cuda"

    def sync():
        if card:
            torch.cuda.synchronize()

    def engine(name, plan=None):
        return sv.ServingEngine(cfgs[name], trees[name],
                                batch_slots=TENANCY["slots"],
                                max_len=TENANCY["max_len"], plan=plan,
                                seed=TENANCY["seed"])

    def scheduler(eng):
        sched = sv.Scheduler(eng, prefill_chunk=TENANCY["prefill_chunk"],
                             async_io=True)
        for sname, spec in XR_STREAMS:
            sched.add_stream(sname, **spec)
        return sched

    def serve(sched, reqs):
        for r in reqs:
            sched.submit(r, stream=names[r.uid % len(names)])
        t0 = time.perf_counter()
        done = sched.run_until_done()
        sync()
        return {r.uid: r.generated for r in done}, time.perf_counter() - t0

    def close(eng):
        for part in (eng.pager, eng.kv_table):
            if part is not None:
                part.close()

    def tokens_equal(got, want, name, what):
        if got != want:
            bad = [u for u in want if got.get(u) != want[u]]
            raise AssertionError(f"{what}: tokens differ for uids {bad}")
        if any(not 0 <= t < cfgs[name].vocab_size for ts in got.values()
               for t in ts):
            raise AssertionError(f"{what}: token id out of the vocabulary")

    def kv_reading(eng, sched):
        pg = eng.paging_summary()
        return dict(ticks=sched.ticks, kv_swaps=pg["kv_swaps"],
                    kv_pool_hits=pg["kv_pool_hits"],
                    kv_writebacks=pg["kv_writebacks"],
                    kv_dropped=pg["kv_dropped"],
                    kv_exposed_s=pg["kv_exposed_s"],
                    kv_hidden_s=pg["kv_hidden_s"],
                    exposed_s=pg["exposed_s"], hidden_s=pg["hidden_s"],
                    crc_s=pg["crc_s"], copy_s=pg["copy_s"])

    calls = {}
    out = {}

    # (a) one tenant: weights and KV blocks through one pool
    plan = half_paged_plan(placement, trees[qwen])
    cold = plan.paged_bytes(placement.packed_sizes(trees[qwen]))
    pool = paging.SharedPagePool(int(cold * TENANCY["shared_budget_frac"]))
    eng = engine(qwen, plan)
    eng.attach_paging(pool=pool, name=qwen)
    eng.attach_kv_paging(TENANCY["kv_block"], pool=pool)
    sched = scheduler(eng)
    reqs = tenant_reqs(sv.Request, cfgs[qwen].vocab_size, KV_REQUESTS, 0)
    zero_launches(counters)
    with recording(torch, m["ops"]) as seen:
        got, wall = serve(sched, reqs)
    launches_a, split_a = read_launches(counters)
    for name, keys in seen.items():
        calls[name] = list(dict.fromkeys(calls.get(name, []) + keys))
    table = eng.kv_table
    pred = pool_replay_check(paging, pool, {qwen: eng.pager},
                             {table.name: table}, "kv-paged qwen3")
    span = kv_span_bytes(memsys, table, pool.events)
    if not (table.swap_count * table.page_nbytes == table.bytes_streamed_wire
            == pred[table.name]["bytes_wire"]
            and span == (table.swap_count + table.pool_hits)
            * table.page_nbytes and table.swap_count > 0
            and table.writebacks > 0):
        raise AssertionError(
            f"kv-paged qwen3: kv_swaps {table.swap_count} x page "
            f"{table.page_nbytes} B, streamed {table.bytes_streamed_wire} "
            f"B, spans listed {span} B with {table.pool_hits} pool hits, "
            f"{table.writebacks} writebacks")
    for kname in ("qmatmul_f32", "flash_attention"):
        if launches_a[kname] <= 0:
            raise AssertionError(f"{kname} never launched in the kv-paged "
                                 "leg")
    doc = sv.validate(sched.metrics.summary(paging=eng.paging_summary()))
    reading = kv_reading(eng, sched)
    summary_a = pool.summary()
    pool.close()
    del eng, sched
    ref = engine(qwen)
    want, ref_wall = serve(scheduler(ref), tenant_reqs(
        sv.Request, cfgs[qwen].vocab_size, KV_REQUESTS, 0))
    del ref
    tokens_equal(got, want, qwen,
                 "kv-paged qwen3 against the resident engine")
    reading.update(wall_s=wall, tick_ms=wall / reading["ticks"] * 1e3,
                   resident_wall_s=ref_wall, requests=len(reqs),
                   tok_per_s=doc["throughput"]["tok_per_s"],
                   page_nbytes=table.page_nbytes,
                   kv_stream_bytes=span)
    members = {name: {k: c[k] for k in ("swaps", "misses", "pool_hits",
                                        "evicted")}
               for name, c in summary_a["models"].items()}
    print(f"[kv] {qwen} (8-bit, cold half paged, KV in blocks of "
          f"{TENANCY['kv_block']} rows, one pool of "
          f"{summary_a['budget_bytes']} B), {len(reqs)} requests: tokens "
          f"equal per uid to a resident unpaged engine's; pool members on "
          f"the kv_pass_counters replay ({json.dumps(members)}); "
          f"kv_swaps x page = {table.swap_count} x {table.page_nbytes} B, "
          f"kv_stream_bytes of the listed spans {span} B; host clock "
          f"(smoke reading): {json.dumps(reading)}; launches {launches_a}")
    out["kv"] = dict(launches=launches_a, launches_by_class=split_a,
                     reading=reading, pool=summary_a, doc=doc)

    # (b) two tenants, one MultiScheduler, one pool
    plans = {name: half_paged_plan(placement, trees[name])
             for name in TENANTS}
    cold = sum(plans[n].paged_bytes(placement.packed_sizes(trees[n]))
               for n in TENANTS)
    budget = max(int(cold * TENANCY["shared_budget_frac"]), 1)
    ms = sv.MultiScheduler(pool=paging.SharedPagePool(budget),
                           async_io=True)
    for salt, name in enumerate(TENANTS):
        eng = engine(name, plans[name])
        ms.add_model(name, eng, prefill_chunk=TENANCY["prefill_chunk"],
                     kv_paged="kv" in eng.cache,
                     kv_block_rows=TENANCY["kv_block"])
        for sname, spec in XR_STREAMS:
            ms.add_stream(name, sname, **spec)
        for r in tenant_reqs(sv.Request, cfgs[name].vocab_size,
                             TENANT_REQUESTS, salt):
            ms.submit(name, r, stream=names[r.uid % len(names)])
    zero_launches(counters)
    t0 = time.perf_counter()
    with recording(torch, m["ops"]) as seen:
        done = ms.run_until_done()
        sync()
    wall = time.perf_counter() - t0
    launches_b, split_b = read_launches(counters)
    for name, keys in seen.items():
        calls[name] = list(dict.fromkeys(calls.get(name, []) + keys))
    doc = sv.validate(ms.summary())
    engines = {n: ms.model(n).engine for n in TENANTS}
    pool_replay_check(paging, ms.pool,
                      {n: e.pager for n, e in engines.items()},
                      {e.kv_table.name: e.kv_table for e in engines.values()
                       if e.kv_table is not None}, "tenancy")
    for kname in KV_KERNELS:
        if launches_b[kname] <= 0:
            raise AssertionError(f"{kname} never launched in the tenancy "
                                 "leg")
    readings = {n: kv_reading(e, ms.model(n)) for n, e in engines.items()}
    summary_b = ms.pool.summary()
    ms.close()
    del engines, ms
    gc.collect()
    for salt, name in enumerate(TENANTS):
        eng = engine(name, plans[name])
        eng.attach_paging()
        if "kv" in eng.cache:
            eng.attach_kv_paging(TENANCY["kv_block"])
        want, solo_wall = serve(scheduler(eng), tenant_reqs(
            sv.Request, cfgs[name].vocab_size, TENANT_REQUESTS, salt))
        close(eng)
        del eng
        gc.collect()
        tokens_equal({r.uid: r.generated for r in done.get(name, [])}, want,
                     name, f"tenant {name} against its solo run")
        readings[name]["solo_wall_s"] = solo_wall
    ticks = doc["ticks"]["count"]
    reading = dict(wall_s=wall, ticks=ticks, tick_ms=wall / ticks * 1e3,
                   tok_per_s=doc["totals"]["tok_per_s"],
                   requests=doc["totals"]["requests"], tenants=readings)
    print(f"[tenancy] {' + '.join(TENANTS)} (8-bit, cold halves paged, "
          f"{qwen} KV-paged), {TENANT_REQUESTS} requests a tenant, one pool "
          f"of {budget} B ({TENANCY['shared_budget_frac']} of {cold} B "
          f"cold): tokens equal per uid to each tenant's solo run on a "
          f"private pager; pool members on the kv_pass_counters replay; "
          f"metrics v9 multi document valid; pool {json.dumps(summary_b)}; "
          f"host clock (smoke reading): {json.dumps(reading)}; launches "
          f"{launches_b}")
    out["tenancy"] = dict(launches=launches_b, launches_by_class=split_b,
                          reading=reading, pool=summary_b)
    out["path_check"] = check_path(torch, m["ops"], m["ref"], m["qmm"],
                                   m["fa"], m["ssm"], dev,
                                   "kv-paged + tenancy", calls)
    return out


# kernel-name fragments of the LM paths' device time, as the profiler names
# them; cuBLAS / CUTLASS GEMMs are the unembedding's f32 matmul
PROFILE_LM_KERNELS = (("qmm_tc", "qmatmul_f32 tensor cores (prefill)"),
                      ("qmm_dec", "qmatmul_f32 tensor cores (decode)"),
                      ("bs_tc", "qmatmul_f32_blockscale tensor cores "
                       "(prefill)"),
                      ("bs_dec", "qmatmul_f32_blockscale tensor cores "
                       "(decode)"),
                      ("memcpy", "memcpy (host <-> device)"),
                      ("flash_fwd", "flash_attention"),
                      ("scan_step", "selective_scan (step route)"),
                      ("scan_chunked", "selective_scan (chunked route)"),
                      ("gemm", "torch.matmul (unembed)"))


def profile_serve(torch, cfg, make_engine, reqs):
    """Device time by kernel and the device's idle share of one serve, from
    ``torch.profiler`` (device activity only, to keep its cost low)."""
    from torch.profiler import ProfilerActivity, profile

    eng = make_engine()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    if not kernels:
        print(f"[serve] {cfg.name} profiler: no device events recorded; "
              "device time by kernel not measured")
        return None
    def busy_us(events):
        busy, end = 0.0, -1.0
        for e in events:
            t0_, t1_ = e.time_range.start, e.time_range.end
            busy += max(0.0, t1_ - max(t0_, end))
            end = max(end, t1_)
        return busy

    by_kernel = {}
    for e in kernels:
        label = next((lab for frag, lab in PROFILE_LM_KERNELS
                      if frag in e.name.lower()), "other torch ops")
        by_kernel[label] = (by_kernel.get(label, 0.0)
                            + (e.time_range.end - e.time_range.start) / 1e3)
    busy = busy_us(kernels)
    # the copy engine's memcpys left out: how idle the compute engine is
    compute = busy_us([e for e in kernels if "memcpy" not in e.name.lower()])
    res = dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
               idle_share=1.0 - busy / wall_us,
               compute_busy_ms=compute / 1e3,
               compute_idle_share=1.0 - compute / wall_us,
               n_kernels=len(kernels),
               by_kernel_ms={k: round(v, 3) for k, v in by_kernel.items()})
    print(f"[serve] {cfg.name} profiler over the same requests: device busy "
          f"{busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms on the host clock "
          f"(idle share {res['idle_share']:.3f}; without memcpy "
          f"{compute / 1e3:.1f} ms, idle share "
          f"{res['compute_idle_share']:.3f}), {len(kernels)} kernels; "
          f"by kernel (ms) {json.dumps(res['by_kernel_ms'])}")
    return res


def first_layers(tree, depth: int):
    if isinstance(tree, dict):
        return {k: first_layers(v, depth) for k, v in tree.items()}
    return tree[:depth]


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def job_key(j):
    """(op, shape) of one N-EUREKA job: pw1x1 (M, K, N), dense3x3 (H, W,
    Cin, Cout, stride), dw3x3 (H, W, C, stride).  Every pw1x1 job of the
    network has stride 1."""
    if j.op_kind == "pw1x1":
        return "pw1x1", (j.h * j.w, j.cin, j.cout)
    if j.op_kind == "dense3x3":
        return "dense3x3", (j.h, j.w, j.cin, j.cout, j.stride)
    return "dw3x3", (j.h, j.w, j.cin, j.stride)


def neureka_case(torch, packing, ops, gen, dev, op, shape, bits,
                 tie=False):
    """(x, packed, mult, bias) of one N-EUREKA job.  ``mult`` spreads the
    int32 sums over ~40 LSB as ``freeze_packed`` does and the bias sits
    near 128; with ``tie`` the activations are small and ``mult`` is 0.5 or
    0.25, so many outputs land on an exact .5 before rounding."""
    hi = 4 if tie else 256
    if op == "pw1x1":
        m, k, n = shape
        x = torch.randint(0, hi, (m, k), generator=gen, device=dev,
                          dtype=torch.uint8)
        packed = ops.prep_linear(torch.randn((n, k), generator=gen,
                                             device=dev), bits)[0]
        levels, k_red = packing.unpack(packed, bits, k), k
    elif op == "dense3x3":
        h, w, cin, n, _ = shape
        x = torch.randint(0, hi, (h, w, cin), generator=gen, device=dev,
                          dtype=torch.uint8)
        packed = ops.prep_conv3x3(torch.randn((n, 3, 3, cin), generator=gen,
                                              device=dev), bits)[0]
        levels, k_red = packing.unpack(packed, bits, cin), 9 * cin
    else:
        h, w, n, _ = shape
        x = torch.randint(0, hi, (h, w, n), generator=gen, device=dev,
                          dtype=torch.uint8)
        packed = ops.prep_dw3x3(torch.randn((n, 3, 3), generator=gen,
                                            device=dev), bits)[0]
        levels, k_red = packing.unpack(packed, bits, 9), 9
    if tie:
        mult = torch.where(torch.arange(n, device=dev) % 2 == 0, 0.5, 0.25)
        bias = torch.full((n,), 100, dtype=torch.int32, device=dev)
    else:
        rms = levels.reshape(n, -1).float().pow(2).mean(1).sqrt()
        mult = 40.0 / (128.0 * rms.clamp(min=1e-3) * k_red ** 0.5)
        bias = torch.randint(96, 160, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
    return x, packed, mult.float().contiguous(), bias


def neureka_pair(nkc, qmm, ref, op, shape, bits):
    """(kernel name, kernel call, plain call) for one job shape."""
    if op == "pw1x1":
        k = shape[1]
        return ("qmatmul_int8",
                lambda *a: qmm.qmatmul_int8(*a, bits=bits, k_orig=k),
                lambda *a: ref.qmatmul_int8(*a, bits=bits, k_orig=k))
    if op == "dense3x3":
        cin, st = shape[2], shape[4]
        return ("conv3x3_dense",
                lambda *a: nkc.conv3x3_dense(*a, bits=bits, cin=cin,
                                             stride=st),
                lambda *a: ref.conv3x3_dense(*a, bits=bits, cin=cin,
                                             stride=st))
    st = shape[3]
    return ("conv3x3_dw",
            lambda *a: nkc.conv3x3_dw(*a, bits=bits, stride=st),
            lambda *a: ref.conv3x3_dw(*a, bits=bits, stride=st))


# the ragged shapes of the reference's kernel tests (test_kernels.py:45-100),
# dense 3x3 at Cin 40 and 64 (odd maps; K runs over several 32-wide steps
# across taps), and depthwise 3x3 at C 24, 17 and 1 (8, 1 and 1 channels a
# thread)
RAGGED_CASES = (
    [("pw1x1", (40, 130, 50)), ("pw1x1", (1, 33, 7)), ("pw1x1", (63, 130, 17))]
    + [("dense3x3", (12, 10, 24, 16, s)) for s in (1, 2)]
    + [("dense3x3", (7, 7, 3, 32, s)) for s in (1, 2)]
    + [("dense3x3", (9, 11, 40, 8, s)) for s in (1, 2)]
    + [("dense3x3", (13, 7, 64, 40, s)) for s in (1, 2)]
    + [("dw3x3", shape + (s,)) for s in (1, 2)
       for shape in ((9, 11, 40), (12, 10, 24), (9, 11, 17), (7, 5, 1))])
TIE_CASES = [("pw1x1", (37, 4, 9)), ("pw1x1", (50, 24, 40)),
             ("dense3x3", (7, 7, 3, 32, 1)), ("dw3x3", (9, 11, 40, 2))]


def split_edges(plan, m: int, n: int, most: int = 4):
    """(m, k, n) on each side of the first ``most`` K values (multiples of
    32 up to 2,048) where ``plan(m, k, n)`` changes its number of K splits."""
    out, prev = [], plan(m, 32, n).splits
    for k in range(64, 2049, 32):
        splits = plan(m, k, n).splits
        if splits != prev and len(out) < 2 * most:
            out += [(m, k - 32, n), (m, k, n)]
        prev = splits
    return out


def check_neureka(torch, packing, ops, ref, nkc, qmm, dev, jobs):
    """Every N-EUREKA kernel equals its plain version bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(5)
    shapes = list(dict.fromkeys(job_key(j) for j in jobs))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    edges = [("pw1x1", shape) for mn in ((49, 160), (1, 1000), (196, 96))
             for shape in split_edges(lambda m, k, n: qmm.int8_plan(
                 m, k, n, sms), *mn)]
    cases = [(op, shape, bits, False) for op, shape in shapes
             for bits in (8, 4, 2)]
    cases += [(op, shape, bits, False) for op, shape in RAGGED_CASES + edges
              for bits in (8, 4, 2)]
    cases += [(op, shape, bits, True) for op, shape in TIE_CASES
              for bits in (4, 2)]
    counts = dict.fromkeys(NEUREKA_KERNELS, 0)
    worst = dict.fromkeys(NEUREKA_KERNELS, 0)
    for op, shape, bits, tie in cases:
        args = neureka_case(torch, packing, ops, gen, dev, op, shape, bits,
                            tie)
        name, kernel, plain = neureka_pair(nkc, qmm, ref, op, shape, bits)
        got, expect = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        diff = (got.int() - expect.int()).abs()
        worst[name] = max(worst[name], int(diff.max().item()))
        if got.shape != expect.shape or not torch.equal(got, expect):
            raise AssertionError(
                f"{name} {op} {shape} bits={bits} tie={tie}: "
                f"{int((diff > 0).sum().item())} of {got.numel()} outputs "
                f"differ from the plain version (max {worst[name]})")
        counts[name] += 1
    print(f"[check] N-EUREKA kernels bit-equal to their plain versions: "
          f"{counts} cases ({len(shapes)} distinct MobileNet-V2 job shapes "
          f"at {MNV2_IMG} x bits 8/4/2, {len(RAGGED_CASES)} ragged shapes "
          f"and {len(edges)} qmatmul_int8 shapes at its K-split thresholds "
          f"x bits 8/4/2, {len(TIE_CASES)} requant-tie shapes x bits 4/2)")
    return worst


def cold_sets(torch, packing, ops, gen, dev, op, shape, bits):
    """Input sets of one job, as many as rotate over more than L2 (2-64)."""
    probe = neureka_case(torch, packing, ops, gen, dev, op, shape, bits)
    if op == "pw1x1":
        out_numel = shape[0] * shape[2]
    else:   # (H, W, ..., C out, stride)
        s = shape[-1]
        out_numel = -(-shape[0] // s) * -(-shape[1] // s) * shape[-2]
    set_bytes = probe[0].numel() + probe[1].numel() + out_numel
    copies = int(min(64, max(2, -(-L2_COLD_BYTES // set_bytes))))
    return [probe] + [neureka_case(torch, packing, ops, gen, dev, op, shape,
                                   bits) for _ in range(copies - 1)]


def time_neureka(torch, F, packing, ops, ref, nkc, qmm, dev, op, shape,
                 job, note=""):
    """One N-EUREKA job at 8 bits, inputs rotated over > 50 MB.  The
    library call is the same accumulation in f32 on pre-unpacked levels,
    without the requant: ``torch.matmul`` for pw1x1, ``F.conv2d`` (NCHW,
    ``groups=C`` for dw3x3) for the 3x3 operators.  ``note`` (the launch
    plan; a dw3x3 job prints the plan its timed launches took) is added
    to the printed work."""
    bits = 8
    gen = torch.Generator(device=dev).manual_seed(7)
    name, kernel, plain = neureka_pair(nkc, qmm, ref, op, shape, bits)
    sets = []
    for x, packed, mult, bias in cold_sets(torch, packing, ops, gen, dev, op,
                                           shape, bits):
        if op == "pw1x1":
            lib_args = (x.float(), packing.unpack(packed, bits,
                                                  shape[1]).float().T)
        elif op == "dense3x3":
            lib_args = (x.permute(2, 0, 1)[None].float(),
                        packing.unpack(packed, bits, shape[2]).float()
                        .permute(0, 3, 1, 2).contiguous())
        else:
            lib_args = (x.permute(2, 0, 1)[None].float(),
                        packing.unpack(packed, bits, 9).float()
                        .reshape(-1, 1, 3, 3))
        sets.append(((x, packed, mult, bias), lib_args))
    copies = len(sets)

    def library(i):
        a, w = sets[i % copies][1]
        if op == "pw1x1":
            torch.matmul(a, w)
        elif op == "dense3x3":
            F.conv2d(a, w, stride=shape[4], padding=1)
        else:
            F.conv2d(a, w, stride=shape[3], padding=1, groups=shape[2])

    res = time_versions(torch, lambda i: kernel(*sets[i % copies][0]),
                        lambda i: plain(*sets[i % copies][0]), library,
                        copies, 50)
    # the plan of the dw3x3 launches just timed (tools/neureka_ab.py also
    # times checkouts whose wrapper kept no plans)
    if op == "dw3x3" and getattr(nkc.conv3x3_dw, "plans", None):
        res["plan"] = nkc.conv3x3_dw.plans[-1]
        note = plan_text(res["plan"])
    x, packed, mult, _ = sets[0][0]
    out_numel = plain(*sets[0][0]).numel()
    if op == "pw1x1":
        macs = shape[0] * shape[1] * shape[2]
    elif op == "dense3x3":
        macs = out_numel * 9 * shape[2]
    else:
        macs = out_numel * 9
    nbytes = x.numel() + packed.numel() + 8 * mult.numel() + out_numel
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 2 * macs,
                                                INT8_OPS_PER_S)
    res["work"] = f"{job} {op} {shape} bits={bits}" + (
        f", {note}" if note else "")
    library_name = ("torch.matmul f32 on unpacked levels" if op == "pw1x1"
                    else "F.conv2d f32 on unpacked levels")
    print_times(f"{name} {res['work']}",
                f"{library_name}, no requant", res, nbytes, 2 * macs)
    return res


def plan_text(plan) -> str:
    """An ``Int8Plan`` as 'route, splits x kchunk K, blocks', a ``DwPlan``
    as 'vec B a thread, cg ch x tc x rows a block, route, blocks'."""
    if hasattr(plan, "route"):
        return (f"{plan.route}, {plan.splits} x {plan.kchunk} K, "
                f"{plan.blocks} blocks")
    return (f"{plan.vec} B a thread, {plan.cg} ch x "
            f"{plan.tc} x {plan.rows} rows a block, "
            f"{'staged' if plan.staged else 'direct'}, {plan.blocks} blocks")


# kernel-name fragments of the N-EUREKA kernels, as the profiler names them,
# and the kernel of each job's operator
PROFILE_KERNELS = (("qmm_int8", "qmatmul_int8"), ("dense3x3", "conv3x3_dense"),
                   ("dw3x3", "conv3x3_dw"))
OP_KERNEL = {"pw1x1": "qmatmul_int8", "dense3x3": "conv3x3_dense",
             "dw3x3": "conv3x3_dw"}


def profile_frames(torch, mnv2, qmm, frozen, frames, jobs, n: int = 4):
    """Device time of ``n`` eager frames by kernel and by job, and the
    device's idle share of the host window, from ``torch.profiler``.  One
    frame before them is traced and dropped (the schedule's warm-up step,
    one cycle), so that the tracer runs before the first kernel it counts.
    The k-th N-EUREKA kernel is job k mod len(jobs); the phase fails if its
    name is not that job's operator, or if the per-job times summed by
    operator differ from the per-kernel sums."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels.neureka_conv import conv3x3_dw

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n,
                                   repeat=1)) as prof:
        for i in range(n + 1):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            mnv2.apply(frozen, frames[i], weight_bits=8, img=MNV2_IMG)
            if i == n:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
    # device events, without the schedule's own step annotations
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith("ProfilerStep")),
                     key=lambda e: e.time_range.start)
    if not kernels:
        raise AssertionError("profile: no device events recorded over the "
                             f"{n} frames")
    by_kernel, by_job, others = {}, {}, {}
    busy, end = 0.0, -1.0
    nk = 0
    for e in kernels:
        t0_, t1_ = e.time_range.start, e.time_range.end
        busy += max(0.0, t1_ - max(t0_, end))
        end = max(end, t1_)
        label = next((lab for frag, lab in PROFILE_KERNELS if frag in e.name),
                     "other torch ops")
        by_kernel[label] = by_kernel.get(label, 0.0) + (t1_ - t0_) / n
        if label == "other torch ops":
            name = re.sub(r"void |at::native::|\(anonymous namespace\)::|"
                          r"std::array<[^>]*>", "", e.name)[:64]
            others[name] = others.get(name, 0.0) + (t1_ - t0_) / n
        else:
            job = jobs[nk % len(jobs)]
            if OP_KERNEL[job.op_kind] != label:
                raise AssertionError(
                    f"profile: N-EUREKA kernel {nk} is {e.name} ({label}), "
                    f"but job {job.name} runs {OP_KERNEL[job.op_kind]}")
            by_job[job.name] = by_job.get(job.name, 0.0) + (t1_ - t0_) / n
            nk += 1
    if nk != n * len(jobs):
        raise AssertionError(f"profile: {nk} N-EUREKA kernels in {n} frames, "
                             f"want {len(jobs)} a frame")
    by_op = {}
    for job in jobs:
        lab = OP_KERNEL[job.op_kind]
        by_op[lab] = by_op.get(lab, 0.0) + by_job[job.name]
    for lab, t in by_op.items():
        if abs(t - by_kernel[lab]) > 1e-6 * max(1.0, by_kernel[lab]):
            raise AssertionError(f"profile: {lab}'s jobs add up to {t:.3f} "
                                 f"us a frame, its kernels to "
                                 f"{by_kernel[lab]:.3f}")
    span = kernels[-1].time_range.end - kernels[0].time_range.start
    top = dict(sorted(((k, round(v, 2)) for k, v in others.items()),
                      key=lambda kv: -kv[1])[:4])
    res = dict(busy_us_per_frame=busy / n, wall_us_per_frame=wall_us / n,
               idle_share=1.0 - busy / wall_us, kernel_span_us=span / n,
               by_kernel_us=by_kernel, n_kernel_launches=nk,
               other_ops_us=top)
    index = frames.device.index
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device() if index is None else index
    ).multi_processor_count
    # the plans the last frame's depthwise launches took, in job order
    n_dw = sum(job.op_kind == "dw3x3" for job in jobs)
    dw_plans = iter(list(conv3x3_dw.plans)[-n_dw:])
    per_job = {}
    for job in jobs:
        entry = {"op": OP_KERNEL[job.op_kind],
                 "us": round(by_job[job.name], 3)}
        if job.op_kind == "pw1x1":
            entry["plan"] = plan_text(qmm.int8_plan(
                job.h * job.w, job.cin, job.cout, sms))
        elif job.op_kind == "dw3x3":
            entry["plan"] = plan_text(next(dw_plans))
        per_job[job.name] = entry
    res["by_job"] = per_job
    print(f"[frames] profiler over {n} eager frames (after one warm-up frame):"
          f" device busy {busy / n:.1f} us a frame of {wall_us / n:.1f} us on "
          f"the host clock (idle share {res['idle_share']:.3f}); by kernel "
          f"(us a frame) "
          f"{json.dumps({k: round(v, 2) for k, v in by_kernel.items()})}; "
          f"the largest other ops (us a frame) {json.dumps(top)}")
    print(f"[frames] device time by job at 8 bits (us a frame, job order; "
          f"summed by operator equal to the per-kernel sums): "
          f"{json.dumps(per_job)}")
    return res


def run_frames(torch, mnv2, nkc, qmm, dev):
    """Full-width MobileNet-V2 1.0-224 on the card: 16 frames at 8 bits
    with the launch counts checked, card vs CPU at 8, 4 and 2 bits."""
    t0 = time.perf_counter()
    params = mnv2.init_params(torch.Generator().manual_seed(0),
                              weight_bits=8, img=MNV2_IMG)
    frozen = mnv2.freeze_packed(params, weight_bits=8, img=MNV2_IMG)
    torch.cuda.synchronize()
    n_bytes = sum(leaf["packed"].numel() for leaf in frozen.values())
    print(f"[frames] MobileNet-V2 1.0-{MNV2_IMG}: {len(frozen)} N-EUREKA jobs,"
          f" init + freeze (8-bit, {n_bytes} packed weight bytes) "
          f"{time.perf_counter() - t0:.2f} s")
    # freezing on the card gives the CPU's packed bytes and biases; mult
    # is an f32 rms, summed in another order
    on_cpu = mnv2.freeze_packed(to_device(torch, params, "cpu"),
                                weight_bits=8, img=MNV2_IMG)
    mult_rel = 0.0
    for name, leaf in frozen.items():
        want = on_cpu[name]
        if not (torch.equal(leaf["packed"].cpu(), want["packed"])
                and torch.equal(leaf["bias"].cpu(), want["bias"])):
            raise AssertionError(f"{name}: packed weights frozen on the card"
                                 " differ from the CPU's")
        rel = ((leaf["mult"].cpu() - want["mult"]).abs()
               / want["mult"].abs()).max().item()
        mult_rel = max(mult_rel, rel)
    if mult_rel > 1e-6:
        raise AssertionError(f"mult frozen on the card: rel diff {mult_rel}")
    print(f"[frames] frozen on the card vs on the CPU: packed and bias equal, "
          f"mult max rel diff {mult_rel:.3e} (tolerance 1e-6)")
    gen = torch.Generator(device=dev).manual_seed(6)
    frames = torch.randint(0, 256, (MNV2_FRAMES, MNV2_IMG, MNV2_IMG, 3),
                           generator=gen, device=dev, dtype=torch.uint8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counters = {"conv3x3_dense": nkc.conv3x3_dense,
                "conv3x3_dw": nkc.conv3x3_dw, "qmatmul_int8": qmm.qmatmul_int8}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits = [mnv2.apply(frozen, frames[i], weight_bits=8, img=MNV2_IMG)
              for i in range(MNV2_FRAMES)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        if n != NEUREKA_PER_FRAME[name] * MNV2_FRAMES:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{MNV2_FRAMES} frames, want "
                                 f"{NEUREKA_PER_FRAME[name]} a frame")
    out = torch.stack(logits)
    if out.shape != (MNV2_FRAMES, 1000) or out.dtype != torch.uint8:
        raise AssertionError(f"logits {tuple(out.shape)} {out.dtype}")
    if not bool((out.max(1).values > out.min(1).values).all()):
        raise AssertionError("a frame's logits collapsed to one value")
    graph = graph_ms(torch, lambda i: mnv2.apply(
        frozen, frames[i], weight_bits=8, img=MNV2_IMG), 4)
    profile_frames(torch, mnv2, qmm, frozen, frames,
                   mnv2.job_list(8, MNV2_IMG))
    print(f"[frames] {MNV2_FRAMES} frames at 8 bits: eager wall {wall:.4f} s "
          f"after synchronize ({wall / MNV2_FRAMES * 1e3:.3f} ms a frame), "
          f"CUDA-graph replay {graph:.4f} ms a frame, peak memory "
          f"{peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB allocated at the "
          f"start), launches {launches}")

    # card vs CPU, same frozen weights: two frames at 8 bits, one each at
    # 4 and 2 bits
    checked = []
    for bits, idx in ((8, 0), (8, MNV2_FRAMES - 1), (4, 1), (2, 2)):
        tree = frozen if bits == 8 else mnv2.freeze_packed(
            params, weight_bits=bits, img=MNV2_IMG)
        card = (logits[idx] if bits == 8 else mnv2.apply(
            tree, frames[idx], weight_bits=bits, img=MNV2_IMG)).cpu()
        cpu = mnv2.apply(to_device(torch, tree, "cpu"), frames[idx].cpu(),
                         weight_bits=bits, img=MNV2_IMG)
        if not torch.equal(card, cpu):
            raise AssertionError(
                f"frame {idx} at {bits} bits: card and CPU logits differ in "
                f"{int((card != cpu).sum())} of 1000")
        checked.append(f"frame {idx} @ {bits} bits")
    print(f"[frames] card vs CPU plain path bit-equal: {', '.join(checked)}")
    return launches


# phase 9: the MoE family, qwen2-moe-a2.7b at full width (24 layers,
# d_model 2048, 60 experts top-4 of d_ff 1408, a shared expert of 5632,
# vocab 151,936, an untied head)
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_KERNELS = ("qmatmul_f32", "qmatmul_f32_grouped", "flash_attention")
# (K, N) of a layer's three expert linears
EXPERT_LINEARS = {"w_gate": (2048, 1408), "w_up": (2048, 1408),
                  "w_down": (1408, 2048)}
# (E, C, K, N, bits) of the grouped kernel's checks: the expert linears at
# decode (C 8: 4 slots, top-4 of 60, factor 1.25) and at the prefill
# capacities of 16-256 token prompts (C 16, 24), a ragged C on each route,
# one expert on each route, and bits 4 and 2
GROUPED_CASES = ([(60, c, k, n, 8) for c in (8, 16, 24)
                  for k, n in ((2048, 1408), (1408, 2048))]
                 + [(60, 13, 2048, 1408, 8), (60, 40, 1408, 2048, 8),
                    (1, 8, 2048, 1408, 8), (1, 24, 1408, 2048, 8),
                    (60, 8, 2048, 1408, 4), (60, 24, 1408, 2048, 4),
                    (60, 8, 1408, 2048, 2), (60, 24, 2048, 1408, 2)])


def frozen_tree(torch, m, cfg, dev, bits: int = 8):
    """``cfg``'s packed tree with random weights from a CUDA generator
    seeded 0, drawn by ``init_params(bits=)``, which packs each weight as it
    is drawn: the launcher's draw, equal to ``freeze_for_serving`` of the
    whole f32 draw (~57 GB for qwen2-moe-a2.7b, 137 GB for llava-next-34b),
    which never exists."""
    return m["tfm"].init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                device=dev, bits=bits)


def check_grouped(torch, ops, ref, qmm, dev) -> float:
    """The grouped ``qmatmul_f32`` against its plain version at
    ``GROUPED_CASES``, within QMM_TOL; every seventh expert gets no rows
    (zero x, as dispatch leaves an unrouted expert) and must give zeros, and
    two calls must give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0
    for e, c, k, n, bits in GROUPED_CASES:
        packed, scale = expert_weights(torch, ops, gen, dev, e, k, n, bits)
        x = torch.randn((e, c, k), generator=gen, device=dev)
        x[1::7] = 0.0
        got = qmm.qmatmul_f32_grouped(x, packed, scale, bits=bits, k_orig=k)
        again = qmm.qmatmul_f32_grouped(x, packed, scale, bits=bits,
                                        k_orig=k)
        expect = ref.qmatmul_f32_grouped(x, packed, scale, bits=bits,
                                         k_orig=k)
        torch.cuda.synchronize()
        err = (got - expect).abs().max().item()
        worst = max(worst, err)
        what = f"E={e} C={c} K={k} N={n} bits={bits}"
        if not torch.allclose(got, expect, **QMM_TOL):
            raise AssertionError(f"qmatmul_f32_grouped {what}: max abs err "
                                 f"{err}")
        if not torch.equal(again, got):
            raise AssertionError(f"qmatmul_f32_grouped {what}: two calls "
                                 "give different bits")
        if got[1::7].any():
            raise AssertionError(f"qmatmul_f32_grouped {what}: an expert "
                                 "with no rows gave non-zeros")
        del packed, scale, x, got, again, expect
    torch.cuda.empty_cache()
    print(f"[check] qmatmul_f32_grouped vs plain at {len(GROUPED_CASES)} "
          f"(E, C, K, N, bits) cases {GROUPED_CASES}: max abs err "
          f"{worst:.3e} (tolerance {QMM_TOL}), two calls bit-equal, "
          "experts with no rows give zeros")
    return worst


def time_grouped(torch, packing, ops, ref, qmm, dev, c: int, bits: int = 8,
                 copies: int = 2, dtype=None):
    """One qwen2-moe-a2.7b layer's three expert linears grouped over its 60
    experts at capacity ``c``, over ``copies`` layer copies (519 MB of 8-bit
    levels each, > the 50 MB L2), beside the plain version and torch.bmm on
    pre-dequantised f32 weights (``dtype=torch.bfloat16``: x in bf16, the
    grouped B1's bf16 x route, beside ``torch.bmm`` at bf16 on
    pre-dequantised bf16 weights; the bound is the bytes at bf16 x)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    dtype = dtype or torch.float32
    layers = []
    for _ in range(copies):
        layer = []
        for k, n in EXPERT_LINEARS.values():
            packed, scale = expert_weights(torch, ops, gen, dev, 60, k, n,
                                           bits)
            x = torch.randn((60, c, k), generator=gen, device=dev).to(dtype)
            deq = (packing.unpack(packed, bits, k).float()
                   * scale[..., None]).to(dtype)
            layer.append((x, packed, scale, k, deq))
        layers.append(layer)

    def kernel(i):
        for x, p, s, k, _ in layers[i % copies]:
            qmm.qmatmul_f32_grouped(x, p, s, bits=bits, k_orig=k)

    def plain(i):
        for x, p, s, k, _ in layers[i % copies]:
            ref.qmatmul_f32_grouped(x, p, s, bits=bits, k_orig=k)

    def library(i):
        for x, _, _, _, deq in layers[i % copies]:
            torch.bmm(x, deq.transpose(1, 2))

    res = time_versions(torch, kernel, plain, library, copies, 20)
    nbytes = sum(x.numel() * x.element_size() + p.numel() + s.numel() * 4
                 + x.shape[0] * c * p.shape[1] * 4
                 for x, p, s, _, _ in layers[0])
    flops = sum(2 * 60 * c * n * k for k, n in EXPERT_LINEARS.values())
    route_bound(res, nbytes, flops, 2, dtype == torch.bfloat16)
    tag = "" if dtype == torch.float32 else f", {str(dtype)[6:]} x"
    res["work"] = (f"qmatmul_f32_grouped, one layer's 3 expert linears "
                   f"{list(EXPERT_LINEARS)}, E=60, C={c}, {bits}-bit{tag}")
    print_times(f"qmatmul_f32_grouped {MOE_ARCH} layer x3 E=60 C={c} "
                f"bits={bits}{tag}", f"torch.bmm on pre-dequantised "
                f"{str(dtype)[6:]}", res, nbytes, flops)
    del layers
    torch.cuda.empty_cache()
    return res


# (E, C, K, N) of the grouped blockscale kernel's checks: qwen2-moe-a2.7b's
# expert linears at decode (C 8) and at prefill capacity (C 24), a ragged C
# on each route and one expert on each, their weights 4-bit levels
# re-encoded as the page codec's int8 wire form (phase 14's cold pages)
GROUPED_BS_CASES = ([(60, c, k, n) for c in (8, 24)
                     for k, n in ((2048, 1408), (1408, 2048))]
                    + [(60, 13, 2048, 1408), (60, 40, 1408, 2048),
                       (1, 8, 2048, 1408), (1, 24, 1408, 2048)])


def check_grouped_blockscale(torch, ops, ref, qmm, dev) -> float:
    """``qmatmul_f32_blockscale_grouped`` against its plain version at
    ``GROUPED_BS_CASES``, within QMM_TOL (B3's 1e-4); every seventh expert
    gets no rows and must give zeros, and two calls must give the same
    bits."""
    gen = torch.Generator(device=dev).manual_seed(13)
    worst = 0.0
    for e, c, k, n in GROUPED_BS_CASES:
        packed, scales = expert_wire_weights(torch, ops, gen, dev, e, k, n)
        x = torch.randn((e, c, k), generator=gen, device=dev)
        x[1::7] = 0.0
        got = qmm.qmatmul_f32_blockscale_grouped(x, packed, scales, bits=8,
                                                 k_orig=k)
        again = qmm.qmatmul_f32_blockscale_grouped(x, packed, scales, bits=8,
                                                   k_orig=k)
        expect = ref.qmatmul_f32_blockscale_grouped(x, packed, scales,
                                                    bits=8, k_orig=k)
        torch.cuda.synchronize()
        err = (got - expect).abs().max().item()
        worst = max(worst, err)
        what = f"E={e} C={c} K={k} N={n}"
        if not torch.allclose(got, expect, **QMM_TOL):
            raise AssertionError(f"qmatmul_f32_blockscale_grouped {what}: "
                                 f"max abs err {err}")
        if not torch.equal(again, got):
            raise AssertionError(f"qmatmul_f32_blockscale_grouped {what}: "
                                 "two calls give different bits")
        if got[1::7].any():
            raise AssertionError(f"qmatmul_f32_blockscale_grouped {what}: "
                                 "an expert with no rows gave non-zeros")
        del packed, scales, x, got, again, expect
    torch.cuda.empty_cache()
    print(f"[check] qmatmul_f32_blockscale_grouped vs plain at "
          f"{len(GROUPED_BS_CASES)} (E, C, K, N) cases {GROUPED_BS_CASES} "
          f"(4-bit levels in the int8 wire form): max abs err {worst:.3e} "
          f"(tolerance {QMM_TOL}), two calls bit-equal, experts with no "
          "rows give zeros")
    return worst


def time_grouped_blockscale(torch, ops, ref, qmm, dev, c: int,
                            copies: int = 2, dtype=None):
    """One qwen2-moe-a2.7b layer's three expert linears as wire-served cold
    pages (int8 levels, per-32 scales: 584 MB a layer, > the 50 MB L2),
    grouped over its 60 experts at capacity ``c``, over ``copies`` layer
    copies, beside the plain version and torch.bmm on pre-dequantised
    weights; x and those weights in ``dtype`` (f32 or bf16)."""
    dtype = dtype or torch.float32
    elem, bf16 = dtype.itemsize, dtype == torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(14)
    layers = []
    for _ in range(copies):
        layer = []
        for k, n in EXPERT_LINEARS.values():
            packed, scales = expert_wire_weights(torch, ops, gen, dev, 60, k,
                                                 n)
            x = torch.randn((60, c, k), generator=gen, device=dev).to(dtype)
            deq = ref.blockscale_weight(packed, scales, 8, k, 32).to(dtype)
            layer.append((x, packed, scales, k, deq))
        layers.append(layer)

    def kernel(i):
        for x, p, s, k, _ in layers[i % copies]:
            qmm.qmatmul_f32_blockscale_grouped(x, p, s, bits=8, k_orig=k)

    def plain(i):
        for x, p, s, k, _ in layers[i % copies]:
            ref.qmatmul_f32_blockscale_grouped(x, p, s, bits=8, k_orig=k)

    def library(i):
        for x, _, _, _, deq in layers[i % copies]:
            torch.bmm(x, deq.transpose(1, 2))

    res = time_versions(torch, kernel, plain, library, copies, 20)
    nbytes = sum(x.numel() * elem + p.numel() + s.numel() * 4
                 + x.shape[0] * c * p.shape[1] * 4
                 for x, p, s, _, _ in layers[0])
    flops = sum(2 * 60 * c * n * k for k, n in EXPERT_LINEARS.values())
    route_bound(res, nbytes, flops, 2, bf16)
    x_dt = " bf16 x," if bf16 else ""
    res["work"] = (f"qmatmul_f32_blockscale_grouped, one layer's 3 expert "
                   f"linears {list(EXPERT_LINEARS)}, E=60, C={c},{x_dt} int8 "
                   f"wire form")
    print_times(f"qmatmul_f32_blockscale_grouped {MOE_ARCH} layer x3 E=60 "
                f"C={c}{x_dt} int8 wire form",
                f"torch.bmm on pre-dequantised {dtype}", res, nbytes, flops)
    del layers
    torch.cuda.empty_cache()
    return res


def serve_moe_phase(torch, m, cfg, dev):
    """Phase 9: the grouped kernel checked and timed, then qwen2-moe-a2.7b
    served at full width (``serve_lm``: 8 requests, the grouped and plain
    B1 and B2 counters zeroed before and grown after, every distinct call
    of the profiled serve held against its plain version, and the first 2
    layers' logits card vs CPU within LOGITS_TOL)."""
    err = check_grouped(torch, m["ops"], m["ref"], m["qmm"], dev)
    times = {c: time_grouped(torch, m["packing"], m["ops"], m["ref"],
                             m["qmm"], dev, c) for c in (8, 24)}
    gc.collect()
    torch.cuda.empty_cache()
    counters = {"qmatmul_f32": m["qmm"].qmatmul_f32,
                "qmatmul_f32_grouped": m["qmm"].qmatmul_f32_grouped,
                "flash_attention": m["fa"].flash_attention}
    served, tree = serve_lm(torch, m, cfg, 512, False, counters, 2, dev,
                            make_tree=lambda: frozen_tree(torch, m, cfg, dev),
                            logits_tol=LOGITS_TOL)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    return served, err, times


# phase 10: training (launch/steps.make_train_step -> lm_loss ->
# chunked_attention, f32 matmuls without TF32); training runs none of the
# Hopper kernels, which are forward-only (C9), as the reference's runs none
# of its Pallas kernels
TRAIN_ARCH = "qwen3-0.6b"
# (a) card vs CPU, (b) full depth through Trainer, (c) restart equivalence
# in a subprocess under deterministic algorithms, (d) the trained tree served
TRAIN_CHECK = dict(layers=2, batch=2, seq=128)
TRAIN_FULL = dict(steps=6, batch=4, seq=256, lr=3e-4)
TRAIN_RESTART = dict(layers=4, steps=8, every=3, fail_at=5, batch=2,
                     seq=128, lr=3e-4)
TRAIN_SERVE = dict(requests=4, max_new=8, max_len=128)
TRAIN_LOSS_RTOL = 1e-5     # card vs CPU loss: f32 sums in another order
TRAIN_GRAD_TOL = 1e-4      # card vs CPU, of each CPU leaf's largest element
TRAIN_KERNELS = ("qmatmul_f32", "flash_attention")
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
# (e) at dtype="bfloat16" (ROADMAP A10): bf16 weights, f32 optimizer state,
# no master copy.  (i) card vs CPU at TRAIN_CHECK's size: both round every
# bf16 op, in their own summation orders, so the CPU tests' bf16 gradient
# tolerance (tests/test_torch_train.py's BF16_GRAD_TOL), the loss and a
# step's loss and global gradient norm within the relative tolerances
# below; (ii) TRAIN_FULL from (b)'s weights cast to bf16, on (b)'s batches
TRAIN_BF16_TOL = dict(loss=1e-3, grad=3e-2, step=5e-3)
# kernel-name fragments of a train step's device time, as the profiler
# names them (cuBLAS / CUTLASS f32 GEMMs; PyTorch's own kernels)
PROFILE_TRAIN_KERNELS = (("gemm", "f32 matmuls"),
                         ("softmax", "softmax"), ("reduce", "reductions"),
                         ("elementwise", "elementwise"),
                         ("index", "indexing and sort"),
                         ("sort", "indexing and sort"),
                         ("scatter", "indexing and sort"),
                         ("gather", "indexing and sort"))


def forward_only_cases(torch, packing, ops, qmm, fa, ssm, nkc, dev):
    """(wrapper, call(t), t) for each Hopper kernel wrapper at a small
    shape, ``t`` the float input that is made to require grad (C9)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    q, k, x = randn(1, 2, 8, 16), randn(1, 1, 8, 16), randn(4, 64)
    packed, scale = ops.prep_linear(randn(32, 64), 8)
    gpacked, gscale = expert_weights(torch, ops, gen, dev, 2, 64, 32, 8)
    wpacked, wscales = wire_weight(torch, gen, dev, 32, 64, 8)
    xq, ipacked, mult, bias = neureka_case(torch, packing, ops, gen, dev,
                                           "pw1x1", (4, 64, 32), 8)
    scan = scan_inputs(torch, gen, dev, 1, 4, 64, 16, True)
    dense = neureka_case(torch, packing, ops, gen, dev, "dense3x3",
                         (8, 8, 16, 16, 1), 8)
    dw = neureka_case(torch, packing, ops, gen, dev, "dw3x3", (8, 8, 16, 1),
                      8)
    return (
        ("flash_attention", lambda t: fa.flash_attention(t, k, k), q),
        ("qmatmul_f32", lambda t: qmm.qmatmul_f32(t, packed, scale, bits=8,
                                                  k_orig=64), x),
        ("qmatmul_f32_grouped", lambda t: qmm.qmatmul_f32_grouped(
            t, gpacked, gscale, bits=8, k_orig=64), randn(2, 4, 64)),
        ("qmatmul_f32_blockscale", lambda t: qmm.qmatmul_f32_blockscale(
            t, wpacked, wscales, bits=8, k_orig=64), x.clone()),
        ("qmatmul_int8", lambda t: qmm.qmatmul_int8(
            xq, ipacked, t, bias, bits=8, k_orig=64), mult),
        ("selective_scan", lambda t: ssm.selective_scan(t, *scan[1:]),
         scan[0]),
        ("conv3x3_dense", lambda t: nkc.conv3x3_dense(
            dense[0], dense[1], t, dense[3], bits=8, cin=16), dense[2]),
        ("conv3x3_dw", lambda t: nkc.conv3x3_dw(dw[0], dw[1], t, dw[3],
                                                bits=8), dw[2]),
    )


def check_forward_only(torch, m, dev):
    """C9 on the card: each wrapper given an input that requires grad
    under grad mode raises; under ``torch.no_grad`` it launches.  Returns
    the wrappers checked."""
    names = []
    for name, call, t in forward_only_cases(
            torch, m["packing"], m["ops"], m["qmm"], m["fa"], m["ssm"],
            m["nkc"], dev):
        t.requires_grad_()
        try:
            call(t)
        except RuntimeError as e:
            if "forward-only" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} launched on an input that "
                                 "requires grad (C9)")
        with torch.no_grad():
            call(t)
        names.append(name)
    torch.cuda.synchronize()
    return names


def train_batch(torch, m, cfg, batch: int, seq: int, step: int, dev):
    """``SyntheticLMDataset(seed=0)``'s batch ``step``, with the VLM's patch
    and the encoder-decoder's frame embeddings where the family has them,
    as the training launcher builds it."""
    ds = m["SyntheticLMDataset"](cfg.vocab_size, seq, batch, seed=0,
                                 family=cfg.family, d_model=cfg.d_model,
                                 n_frames=cfg.n_audio_frames,
                                 n_patches=cfg.n_patches)
    return {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(step).items()}


def card_vs_cpu(torch, m, ccfg, batch, dev, unread=frozenset(), tol=None):
    """One ``loss_and_grads`` and one ``make_train_step`` step of ``ccfg``
    on the card against the CPU from the same weights (drawn on the card
    from a CUDA generator and copied to the CPU, which draws far slower)
    and ``batch`` (CPU tensors): the loss within TRAIN_LOSS_RTOL,
    every gradient leaf present, finite and non-zero on the card (zero on
    both, for a leaf in ``unread``: one the loss never reads) and within
    TRAIN_GRAD_TOL of the CPU's largest element; the card's step's loss and
    grad norm within TRAIN_LOSS_RTOL of the CPU's (the loss and gradient
    norm of its ``loss_and_grads``, which is what the CPU's step computes)
    (``tol``: other ``loss``, ``grad`` and
    ``step`` tolerances, a bf16 config's).  Returns the readings; the
    card's tree and batch are left in ``out["gpu"]``, ``out["gbatch"]``."""
    tol = tol or dict(loss=TRAIN_LOSS_RTOL, grad=TRAIN_GRAD_TOL,
                      step=TRAIN_LOSS_RTOL)
    T, steps = m["tree"], m["steps"]
    gpu = steps._init_fn(ccfg)(ccfg, torch.Generator(device=dev)
                               .manual_seed(0), device=dev)
    cpu = T.tree_map(lambda t: t.cpu(), gpu)
    gbatch = {k: v.to(dev) for k, v in batch.items()}
    t0 = time.perf_counter()
    lc, gc_ = steps.loss_and_grads(cpu, batch, ccfg)
    t_cpu = time.perf_counter() - t0
    lg, gg = steps.loss_and_grads(gpu, gbatch, ccfg)
    torch.cuda.synchronize()
    what = f"{ccfg.name} ({ccfg.n_layers} layers)"
    loss_err = abs(lg.item() - lc.item()) / abs(lc.item())
    if not loss_err <= tol["loss"]:
        raise AssertionError(f"{what} train loss card {lg.item()} vs CPU "
                             f"{lc.item()}: relative error {loss_err}")
    worst, n_leaves = 0.0, 0
    for (path, a), b in zip(T.flatten_with_paths(gg), T.leaves(gc_)):
        a, name = a.cpu(), "/".join(path)
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{what} gradient of {name} is missing, "
                                 "misshapen or not finite on the card")
        if name in unread:
            if a.abs().max() > 0 or b.abs().max() > 0:
                raise AssertionError(f"{what} gradient of {name}, a leaf "
                                     "the loss never reads, is not zero")
            n_leaves += 1
            continue
        if not a.abs().max() > 0:
            raise AssertionError(f"{what} gradient of {name} is zero on "
                                 "the card (cut off from autograd?)")
        a, b = a.float(), b.float()
        err = ((a - b).abs().max() / b.abs().max()).item()
        if not err <= tol["grad"]:
            raise AssertionError(f"{what} gradient of {name} card vs CPU: "
                                 f"{err:.3e} of its largest element")
        worst, n_leaves = max(worst, err), n_leaves + 1
    # the CPU's step: make_train_step's loss and grad norm are
    # loss_and_grads' loss and clip_by_global_norm's norm of its gradients
    # (launch/steps.py), so the CPU's are taken from the values above, not
    # from a second CPU pass
    mc = dict(loss=lc, grad_norm=m["clip_by_global_norm"](gc_, 1.0)[1])
    del gc_, gg
    opt = m["adamw"]()
    step = steps.make_train_step(ccfg, opt, lr=TRAIN_FULL["lr"])
    _, _, mg = step(gpu, opt.init(gpu), gbatch)
    step_err = {k: abs(mg[k].item() - mc[k].item()) / abs(mc[k].item())
                for k in ("loss", "grad_norm")}
    if not max(step_err.values()) <= tol["step"]:
        raise AssertionError(f"{what} make_train_step card vs CPU: "
                             f"{step_err}")
    return dict(loss_card=lg.item(), loss_cpu=lc.item(),
                loss_rel_err=loss_err, grad_max_rel_err=worst,
                grad_leaves=n_leaves, step_rel_err=step_err, cpu_s=t_cpu,
                gpu=gpu, gbatch=gbatch)


def train_check(torch, m, cfg, dev):
    """(a) :func:`card_vs_cpu` on ``TRAIN_CHECK['layers']`` full-width
    layers.  Then C9: each wrapper refuses an input that requires grad, and
    serving's ``forward`` over a tree that requires grad raises at the
    flash kernel instead of cutting the gradient."""
    c = TRAIN_CHECK
    ccfg = cfg.replace(n_layers=c["layers"])
    res = card_vs_cpu(torch, m, ccfg, train_batch(
        torch, m, ccfg, c["batch"], c["seq"], 0, "cpu"), dev)
    gpu, gbatch = res.pop("gpu"), res.pop("gbatch")
    loss_err, worst, n_leaves, step_err, t_cpu = (res[k] for k in (
        "loss_rel_err", "grad_max_rel_err", "grad_leaves", "step_rel_err",
        "cpu_s"))
    lg, lc = res["loss_card"], res["loss_cpu"]
    T = m["tree"]
    refused = check_forward_only(torch, m, dev)
    for p in T.leaves(gpu):
        p.requires_grad_()
    try:
        m["tfm"].forward(gpu, gbatch["tokens"], ccfg)
    except RuntimeError as e:
        if "forward-only" not in str(e):
            raise
    else:
        raise AssertionError("forward over a tree that requires grad ran "
                             "through the flash kernel (C9)")
    print(f"[train] (a) {cfg.name} {c['layers']} layers at full width, "
          f"batch {c['batch']} x {c['seq']}: loss card {lg:.6f} CPU "
          f"{lc:.6f} (relative {loss_err:.2e}, tolerance "
          f"{TRAIN_LOSS_RTOL}); {n_leaves} gradient leaves present, finite "
          f"and non-zero, worst {worst:.2e} of the leaf's largest element "
          f"(tolerance {TRAIN_GRAD_TOL}); one AdamW step's loss / grad norm "
          f"relative {step_err['loss']:.2e} / {step_err['grad_norm']:.2e}; "
          f"the CPU's value and grad took {t_cpu:.2f} s; C9: "
          f"{', '.join(refused)} and forward's flash refuse an input that "
          "requires grad")
    return dict(loss_rel_err=loss_err, grad_max_rel_err=worst,
                grad_leaves=n_leaves, step_rel_err=step_err,
                forward_only=refused)


def train_full(torch, m, cfg, dev, f=TRAIN_FULL, tag="[train] (b)",
               beside=None, profile=True):
    """(b) ``cfg``'s depth (qwen3-0.6b's 28 layers in phase 10, 16 of
    hymba-1.5b's 32 in phase 13), ``remat`` on, AdamW, ``f['steps']``
    steps through ``Trainer`` on ``SyntheticLMDataset(seed=0)``: the last
    loss must be below the first.  The weights are drawn at f32 from seed
    0 and cast to ``cfg``'s dtypes, so that a bf16 run (10 (e), 13 (b'))
    starts from (b)'s weights, on (b)'s batches; ``beside``, (b)'s f32
    losses, is printed beside its losses.  Returns the readings and the
    trained params; the checkpoint directory is deleted."""
    import shutil

    if not cfg.remat:
        raise AssertionError(f"{cfg.name} trains with remat")
    opt = m["adamw"]()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    draw = cfg.replace(dtype="float32")
    dtypes = [x.dtype for x in m["tree"].leaves(m["steps"].param_specs(cfg))]

    def init_state():
        p = m["tfm"].init_params(draw, torch.Generator(device=dev)
                                 .manual_seed(0), device=dev)
        p = m["tree"].unflatten(p, [x.to(d) for x, d in zip(
            m["tree"].leaves(p), dtypes)])
        return dict(params=p, opt_state=opt.init(p))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step_fn = m["steps"].make_train_step(cfg, opt, lr=f["lr"])
    trainer = m["Trainer"](
        m["TrainerConfig"](total_steps=f["steps"],
                           checkpoint_dir=str(TRAIN_CKPT), log_every=1),
        step_fn, init_state,
        m["SyntheticLMDataset"](cfg.vocab_size, f["seq"], f["batch"], seed=0),
        device=dev)
    out = trainer.run()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    profile = profile_train_step(torch, step_fn, out, train_batch(
        torch, m, cfg, f["batch"], f["seq"], f["steps"], dev)) \
        if profile else None
    ckpt_bytes = sum(p.stat().st_size for p in TRAIN_CKPT.rglob("*.npy"))
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    losses = [r["loss"] for r in out["metrics"]]
    steps_s = trainer.monitor.history
    if out["restarts"] or len(losses) != f["steps"]:
        raise AssertionError(f"full-width training restarted "
                             f"{out['restarts']} times over {len(losses)} "
                             "steps")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"full-width training losses {losses}: the "
                             "last is not below the first")
    steady = sorted(steps_s[1:])[len(steps_s[1:]) // 2]
    tokens = f["batch"] * f["seq"]
    print(f"{tag} {cfg.name} at full width ({cfg.n_layers} layers, "
          f"remat, dtype {cfg.dtype}), AdamW lr {f['lr']}, batch "
          f"{f['batch']} x {f['seq']}, {f['steps']} steps through Trainer: "
          f"losses {[round(x, 4) for x in losses]}"
          + (f" beside (b)'s f32 losses at the same steps "
             f"{[round(x, 4) for x in beside[:len(losses)]]}"
             if beside else "") + "; step time (host clock, loss "
          f"read inside the step) first {steps_s[0] * 1e3:.1f} ms, median "
          f"of the rest {steady * 1e3:.1f} ms, each "
          f"{[round(s * 1e3, 1) for s in steps_s]}; {tokens / steady:.0f} "
          f"tokens/s; peak device memory {peak / 2**30:.2f} GiB; the "
          f"checkpoint {ckpt_bytes / 1e9:.2f} GB, run {wall:.1f} s in all "
          "(init, steps, checkpoint), deleted")
    return dict(losses=losses, step_s=steps_s, step_ms_median=steady * 1e3,
                tokens_per_s=tokens / steady, peak_gib=peak / 2**30,
                checkpoint_gb=ckpt_bytes / 1e9, wall_s=wall,
                profile=profile), out["params"]


def profile_train_step(torch, step_fn, state, batch):
    """Device time by kernel kind and the device's idle share of one more
    train step from ``state``'s params and optimizer state, from
    ``torch.profiler`` (device activity only); the step is thrown away."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, metrics = step_fn(state["params"], state["opt_state"], batch)
        metrics["loss"].item()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    if not kernels:
        print("[train] profiler: no device events recorded; device time "
              "by kernel not measured")
        return None
    busy, end, by_kind = 0.0, -1.0, {}
    for e in kernels:
        t0_, t1_ = e.time_range.start, e.time_range.end
        busy += max(0.0, t1_ - max(t0_, end))
        end = max(end, t1_)
        kind = next((lab for frag, lab in PROFILE_TRAIN_KERNELS
                     if frag in e.name.lower()), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + (t1_ - t0_) / 1e3
    res = dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
               idle_share=1.0 - busy / wall_us, n_kernels=len(kernels),
               by_kind_ms={k: round(v, 3) for k, v in sorted(
                   by_kind.items(), key=lambda kv: -kv[1])})
    print(f"[train] profiler over one more step: device busy "
          f"{busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms on the host clock "
          f"(idle share {res['idle_share']:.3f}), {len(kernels)} kernels; "
          f"by kind (ms) {json.dumps(res['by_kind_ms'])}")
    return res


def restart_leg(torch, m, cfg, dev):
    """(c) The body of the subprocess: ``TRAIN_RESTART['layers']``
    full-width layers, a run with a failure injected against an
    uninterrupted one under deterministic algorithms; ``restarts`` must be
    exactly 1 (0 for the clean run) and the final params and optimizer
    state equal bit for bit."""
    import shutil

    r = TRAIN_RESTART
    rcfg = cfg.replace(n_layers=r["layers"])
    opt = m["adamw"]()
    T = m["tree"]

    def run(name, fail_at):
        path = TRAIN_CKPT / name
        shutil.rmtree(path, ignore_errors=True)

        def init_state():
            p = m["tfm"].init_params(rcfg, torch.Generator(device=dev)
                                     .manual_seed(0), device=dev)
            return dict(params=p, opt_state=opt.init(p))

        t0 = time.perf_counter()
        out = m["Trainer"](
            m["TrainerConfig"](total_steps=r["steps"],
                               checkpoint_every=r["every"],
                               checkpoint_dir=str(path), log_every=100),
            m["steps"].make_train_step(rcfg, opt, lr=r["lr"]), init_state,
            m["SyntheticLMDataset"](rcfg.vocab_size, r["seq"], r["batch"],
                                    seed=0),
            failure_injector=m["FailureInjector"](fail_at), device=dev).run()
        out["wall_s"] = time.perf_counter() - t0
        shutil.rmtree(path, ignore_errors=True)
        return out

    clean = run("clean", [])
    crashed = run("crashed", [r["fail_at"]])
    if clean["restarts"] != 0 or crashed["restarts"] != 1:
        raise AssertionError(f"restarts: clean {clean['restarts']}, crashed "
                             f"{crashed['restarts']}; want 0 and 1")
    unequal = [path for (path, a), b in zip(
        T.flatten_with_paths(dict(p=clean["params"], o=clean["opt_state"])),
        T.leaves(dict(p=crashed["params"], o=crashed["opt_state"])))
        if not torch.equal(a, b)]
    if unequal:
        raise AssertionError(f"the restarted run's leaves {unequal[:4]} "
                             "differ from the uninterrupted run's")
    return dict(layers=r["layers"], steps=r["steps"], fail_at=r["fail_at"],
                restarts=crashed["restarts"],
                steps_run=[x["step"] for x in crashed["metrics"]],
                leaves_equal=len(T.leaves(clean["params"]))
                + len(T.leaves(clean["opt_state"])),
                wall_s=[clean["wall_s"], crashed["wall_s"]])


def train_restart(torch):
    """(c) ``restart_leg`` in a subprocess with ``CUBLAS_WORKSPACE_CONFIG``
    set, so the deterministic cuBLAS workspace does not touch this
    process's library timings."""
    import os

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--train-restart"], capture_output=True, text=True,
                         timeout=600, env=env)
    if out.returncode != 0:
        raise AssertionError(f"restart leg exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])["restart"]
    print(f"[train] (c) {TRAIN_ARCH} {res['layers']} layers at full width, "
          f"{res['steps']} steps, a checkpoint every "
          f"{TRAIN_RESTART['every']}, a failure injected at step "
          f"{res['fail_at']}, under torch.use_deterministic_algorithms "
          f"(CUBLAS_WORKSPACE_CONFIG=:4096:8, a subprocess): restarts "
          f"{res['restarts']}, steps run {res['steps_run']}; all "
          f"{res['leaves_equal']} leaves of the params and AdamW state equal "
          f"the uninterrupted run's bit for bit; walls "
          f"{[round(w, 1) for w in res['wall_s']]} s")
    return res


def train_restart_main() -> int:
    """The subprocess of (c): ``python3 chip_smoke.py --train-restart``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    from repro_torch.configs import get_config

    res = restart_leg(torch, train_modules(), get_config(TRAIN_ARCH),
                      torch.device("cuda"))
    print(json.dumps({"restart": res}))
    return 0


def train_serve(torch, m, cfg, params, dev, kernels=TRAIN_KERNELS,
                max_len=TRAIN_SERVE["max_len"], tag="[train] (d)"):
    """(d) (b)'s trained tree, its leaves set to require grad, frozen at 8
    bits: no leaf of the packed tree requires grad (C10); 4 requests
    through ``ServingEngine`` launch each of ``kernels`` (counters zeroed
    before), each held against its plain version at every distinct call
    of the serve (``recording``, ``check_path``); the first layer's logits
    on the card match the CPU's."""
    import numpy as np

    T = m["tree"]
    for p in T.leaves(params):
        p.requires_grad_()
    packed = m["freeze"](params, bits=8, device=dev)
    grad_leaves = [p for p in leaves(packed) if p.requires_grad]
    if grad_leaves:
        raise AssertionError(f"{len(grad_leaves)} leaves of the frozen tree "
                             "require grad (C10)")
    s = TRAIN_SERVE
    eng = m["ServingEngine"](cfg, packed, batch_slots=4, max_len=max_len,
                             device=dev)
    rng = np.random.default_rng(10)
    for uid, n in enumerate(rng.integers(16, 65, s["requests"])):
        eng.submit(m["Request"](uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, int(n)).astype(np.int32),
            max_new_tokens=s["max_new"]))
    counters = {"qmatmul_f32": m["qmm"].qmatmul_f32,
                "flash_attention": m["fa"].flash_attention,
                "selective_scan": m["ssm"].selective_scan}
    counters = {name: counters[name] for name in kernels}
    zero_launches(counters)
    with recording(torch, m["ops"]) as calls:
        t0 = time.perf_counter()
        done = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, split = read_launches(counters)
    if (len(done) != s["requests"]
            or any(len(r.generated) != s["max_new"] for r in done)):
        raise AssertionError("the trained tree's serve left requests short")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched serving the "
                                 "trained tree")
    path_check = check_path(torch, m["ops"], m["ref"], m["qmm"], m["fa"],
                            m["ssm"], dev, f"{cfg.name} trained", calls)
    fcfg = cfg.replace(n_layers=1)
    tree = dict(packed, layers=first_layers(packed["layers"], 1))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64)))
    with torch.no_grad():
        got = m["tfm"].forward(tree, toks.to(dev), fcfg).cpu()
        want = m["tfm"].forward(to_device(torch, tree, "cpu"), toks, fcfg)
    err = (got - want).abs().max().item()
    if not (torch.isfinite(got).all() and torch.allclose(got, want,
                                                         **LOGITS_TOL)):
        raise AssertionError(f"trained tree's first-layer logits card vs "
                             f"CPU: max abs err {err}")
    print(f"{tag} the trained tree (leaves set to require grad) frozen "
          f"at 8 bits: no packed leaf requires grad; {len(done)} requests, "
          f"{sum(len(r.generated) for r in done)} new tokens in {wall:.2f} s,"
          f" launches {launches}; first layer's logits card vs CPU max abs "
          f"err {err:.3e} (tolerance {LOGITS_TOL})")
    return dict(launches=launches, launches_by_class=split, wall_s=wall,
                logits_max_abs_err=err, path_check=path_check)


def train_bf16(torch, m, cfg, dev, beside):
    """(e) ``cfg`` at ``dtype="bfloat16"``: (i) :func:`card_vs_cpu` on
    TRAIN_CHECK's layers and batch at TRAIN_BF16_TOL; (ii)
    :func:`train_full` at full depth from (b)'s weights cast to bf16, its
    losses printed beside (b)'s f32 ``beside``."""
    bcfg = cfg.replace(dtype="bfloat16")
    c = TRAIN_CHECK
    ccfg = bcfg.replace(n_layers=c["layers"])
    t0 = time.perf_counter()
    res = card_vs_cpu(torch, m, ccfg, train_batch(
        torch, m, ccfg, c["batch"], c["seq"], 0, "cpu"), dev,
        tol=TRAIN_BF16_TOL)
    del res["gpu"], res["gbatch"]
    bad = [p for p in m["tree"].leaves(m["steps"].param_specs(ccfg))
           if p.dtype != torch.bfloat16]
    print(f"[train] (e) (i) {cfg.name} {c['layers']} layers at full width, "
          f"dtype bfloat16 ({len(bad)} leaves not bf16), batch "
          f"{c['batch']} x {c['seq']}: loss card {res['loss_card']:.6f} CPU "
          f"{res['loss_cpu']:.6f} (relative {res['loss_rel_err']:.2e}, "
          f"tolerance {TRAIN_BF16_TOL['loss']}); {res['grad_leaves']} "
          f"gradient leaves present, finite and non-zero, worst "
          f"{res['grad_max_rel_err']:.2e} of the leaf's largest element "
          f"(tolerance {TRAIN_BF16_TOL['grad']}); one AdamW step's loss / "
          f"grad norm relative {res['step_rel_err']['loss']:.2e} / "
          f"{res['step_rel_err']['grad_norm']:.2e} (tolerance "
          f"{TRAIN_BF16_TOL['step']}); {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    full, params = train_full(torch, m, bcfg, dev, TRAIN_FULL,
                              "[train] (e) (ii)", beside=beside,
                              profile=False)
    del params
    return dict(check=res, full=full)


def train_modules():
    """The port's modules phase 10 and its subprocess use."""
    from repro_torch.core import packing, tree
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import neureka_conv as nkc
    from repro_torch.kernels import qmatmul as qmm
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw, clip_by_global_norm
    from repro_torch.parallel.sharding import freeze_for_serving
    from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig
    from repro_torch.serving.engine import Request, ServingEngine

    return dict(packing=packing, tree=tree,
                SyntheticLMDataset=SyntheticLMDataset, ops=ops, ref=ref,
                fa=fa, nkc=nkc, qmm=qmm, ssm=ssm, steps=steps, moe=moe,
                tfm=tfm, adamw=adamw, clip_by_global_norm=clip_by_global_norm,
                freeze=freeze_for_serving, FailureInjector=FailureInjector,
                Trainer=Trainer, TrainerConfig=TrainerConfig,
                Request=Request, ServingEngine=ServingEngine)


def train_phase(torch, cfg, dev):
    """Phase 10: (a) card vs CPU and C9, (b) full depth through Trainer,
    (c) restart equivalence in a subprocess, (d) the trained tree served
    (C10).  Returns the readings."""
    m = train_modules()
    t0 = time.perf_counter()
    check = train_check(torch, m, cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    full, params = train_full(torch, m, cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    served = train_serve(torch, m, cfg, params, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    restart = train_restart(torch)
    bf16 = train_bf16(torch, m, cfg, dev, full["losses"])
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"[train] phase 10 took {wall:.1f} s")
    return dict(check=check, full=full, restart=restart, serve=served,
                bf16=bf16, wall_s=wall)


# phase 13: training of the MoE, SSM, hybrid, VLM and encoder-decoder
# families (launch/steps.make_train_step -> lm_loss / seq2seq_loss ->
# chunked_attention and the reference's chunked associative scan,
# models/ssm.selective_scan); no Hopper kernel, as in phase 10
FAMILY_ARCH = "hymba-1.5b"
# (a) card vs CPU: (arch, layers (None: all), batch, text positions); one
# row each (at two rows the CPU side took 115 s of the phase; the check
# holds at any row count) of 64 positions (128 until phase 18 came: the
# CPU side of these rows takes most of their time)
FAMILY_CHECKS = (("hymba-1.5b", 2, 1, 64), ("falcon-mamba-7b", 1, 1, 64),
                 ("qwen2-moe-a2.7b", 1, 1, 64), ("whisper-tiny", None, 1, 64))
# (b) hymba-1.5b at full width through Trainer, 8 of its 32 layers (16
# before (b') came; full depth took ~40 s more than 16 of the time the
# whole script must finish in; PERF.md sections 6-7)
FAMILY_FULL = dict(steps=6, batch=4, seq=256, lr=3e-4, layers=8)
# (b') the same at dtype="bfloat16" (ROADMAP A10), from (b)'s weights cast
# to bf16, 3 steps
FAMILY_BF16 = dict(FAMILY_FULL, steps=3)
# (c) make_train_step at full width and cut depth: (arch, layers (None:
# all), batch, text positions); llava-next-34b with all 2,880 patches
FAMILY_STEPS = (("falcon-mamba-7b", 4, 2, 128), ("qwen2-moe-a2.7b", 2, 2, 128),
                ("llava-next-34b", 2, 1, 256), ("whisper-tiny", None, 2, 64))
FAMILY_STEP_COUNT = 4
# (d) hymba's prompts of 16-64 tokens + 128 meta tokens + 8 new
FAMILY_SERVE_LEN = 256
FAMILY_KERNELS = ("qmatmul_f32", "flash_attention", "selective_scan")
# leaves the loss never reads, whose gradient is zero in both packages:
# hymba's SSM heads take the attention's normalised input
UNREAD_LEAVES = {"hybrid": frozenset({"layers/ssm_norm/scale"})}


def cut(cfg, layers):
    return cfg if layers is None else cfg.replace(n_layers=layers)


@contextlib.contextmanager
def recorded_routes(m):
    """Notes the top-k indices of every ``moe.route`` call in the block
    (on the host), in call order."""
    routes, real = [], m["moe"].route

    def route(*a, **kw):
        gates, idx = real(*a, **kw)
        routes.append(idx.detach().cpu())
        return gates, idx

    m["moe"].route = route
    try:
        yield routes
    finally:
        m["moe"].route = real


def family_check(torch, m, dev, arch: str, layers, batch: int, seq: int):
    """(a) :func:`card_vs_cpu` on ``layers`` full-width layers of ``arch``;
    for the MoE family the card's top-k indices must first equal the
    CPU's in every ``route`` call (a near-tie that flips one fails here,
    with the count, rather than in the gradients)."""
    ccfg = cut(m["get_config"](arch), layers)
    batch_ = train_batch(torch, m, ccfg, batch, seq, 0, "cpu")
    t0 = time.perf_counter()
    with recorded_routes(m) as routes:
        res = card_vs_cpu(torch, m, ccfg, batch_, dev,
                          UNREAD_LEAVES.get(ccfg.family, frozenset()))
    del res["gpu"], res["gbatch"]
    if ccfg.family == "moe":
        # the CPU's loss_and_grads, the card's, then the card's
        # make_train_step: the CPU's calls against each of the card's
        third = len(routes) // 3
        if not third or len(routes) != 3 * third:
            raise AssertionError(f"{arch}: {len(routes)} route calls")
        cpu_r = routes[:third] * 2
        card_r = routes[third:]
        flips = sum(int((a != b).any(-1).sum()) for a, b in zip(cpu_r,
                                                                card_r))
        if flips:
            raise AssertionError(
                f"{arch}: {flips} tokens' top-{ccfg.n_experts_active} "
                "experts differ card vs CPU (a near-tie in the router "
                "logits); the gradient tolerance is not loosened for it")
        res["route_calls"] = len(cpu_r)
        res["tokens_routed"] = sum(int(r.shape[0]) for r in cpu_r)
    res["wall_s"] = time.perf_counter() - t0
    print(f"[families] (a) {arch} {ccfg.n_layers} layers at full width, "
          f"batch {batch} x {seq}: loss card {res['loss_card']:.6f} CPU "
          f"{res['loss_cpu']:.6f} (relative {res['loss_rel_err']:.2e}, "
          f"tolerance {TRAIN_LOSS_RTOL}); {res['grad_leaves']} gradient "
          f"leaves present and finite, worst {res['grad_max_rel_err']:.2e} "
          f"of the leaf's largest element (tolerance {TRAIN_GRAD_TOL}); one "
          f"AdamW step's loss / grad norm relative "
          f"{res['step_rel_err']['loss']:.2e} / "
          f"{res['step_rel_err']['grad_norm']:.2e}"
          + (f"; top-k equal card vs CPU in all {res['route_calls']} "
             f"route calls ({res['tokens_routed']} tokens)"
             if "route_calls" in res else "")
          + f"; {res['wall_s']:.1f} s")
    return res


def family_steps(torch, m, dev, arch: str, layers, batch: int, seq: int):
    """(c) ``FAMILY_STEP_COUNT`` AdamW steps of ``make_train_step`` on
    ``layers`` full-width layers of ``arch`` (weights from a seeded CUDA
    generator), each on ``SyntheticLMDataset(seed=0)``'s batch 0, so that
    the loss's fall measures the steps, not the spread between batches:
    every loss finite and the last below the first.  Step times on the
    host clock, the loss read inside each step."""
    cfg = cut(m["get_config"](arch), layers)
    steps = m["steps"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = steps._init_fn(cfg)(cfg, torch.Generator(device=dev)
                                 .manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in m["tree"].leaves(params))
    opt = m["adamw"]()
    state = opt.init(params)
    step_fn = steps.make_train_step(cfg, opt, lr=FAMILY_FULL["lr"])
    losses, times = [], []
    b = train_batch(torch, m, cfg, batch, seq, 0, dev)
    for _ in range(FAMILY_STEP_COUNT):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, state, metrics = step_fn(params, state, b)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del params, state, b
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} training losses {losses}: the last is "
                             "not below the first")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    positions = seq + cfg.n_patches + cfg.n_meta_tokens
    res = dict(layers=cfg.n_layers, of_layers=m["get_config"](arch).n_layers,
               params=n_params, batch=batch, seq=seq, positions=positions,
               losses=losses, step_s=times, step_ms_median=steady * 1e3,
               tokens_per_s=batch * seq / steady, peak_gib=peak / 2**30,
               wall_s=wall)
    print(f"[families] (c) {arch} at full width, {cfg.n_layers} of "
          f"{res['of_layers']} layers ({n_params / 1e9:.3f} B parameters, "
          f"remat {cfg.remat}), AdamW lr {FAMILY_FULL['lr']}, batch {batch} "
          f"x {seq} text tokens ({positions} positions a row), "
          f"{FAMILY_STEP_COUNT} make_train_step steps on one batch: losses "
          f"{[round(x, 4) for x in losses]}; step time (host clock) first "
          f"{times[0] * 1e3:.1f} ms, median of the rest {steady * 1e3:.1f} "
          f"ms; {res['tokens_per_s']:.0f} text tokens/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; {wall:.1f} s with init")
    return res


def family_train_phase(torch, dev, get_config):
    """Phase 13: (a) card vs CPU for hymba-1.5b, falcon-mamba-7b,
    qwen2-moe-a2.7b and whisper-tiny, (b) hymba-1.5b (8 layers) through
    Trainer, (c) the other families' steps at full width and cut depth,
    (d) (b)'s trained tree served (B1, B2 and B7 launched and checked
    against their plain versions).  Returns the readings."""
    m = dict(train_modules(), get_config=get_config)
    t0 = time.perf_counter()
    check = {}
    for arch, layers, batch, seq in FAMILY_CHECKS:
        check[arch] = family_check(torch, m, dev, arch, layers, batch, seq)
        gc.collect()
        torch.cuda.empty_cache()
    cfg = cut(get_config(FAMILY_ARCH), FAMILY_FULL["layers"])
    full, params = train_full(torch, m, cfg, dev, FAMILY_FULL,
                              "[families] (b)")
    served = train_serve(torch, m, cfg, params, dev, FAMILY_KERNELS,
                         FAMILY_SERVE_LEN, "[families] (d)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    full_bf16, params = train_full(
        torch, m, cfg.replace(dtype="bfloat16"), dev, FAMILY_BF16,
        "[families] (b')", beside=full["losses"], profile=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cut_steps = {arch: family_steps(torch, m, dev, arch, layers, batch, seq)
                 for arch, layers, batch, seq in FAMILY_STEPS}
    wall = time.perf_counter() - t0
    print(f"[families] phase 13 took {wall:.1f} s")
    return dict(check=check, full=full, full_bf16=full_bf16,
                steps=cut_steps, serve=served, wall_s=wall)


# phase 11: the serving launcher and the XR pipeline (ROADMAP A12's
# launchers + A13), each driven in process through the entry point a user
# calls: (a) ``repro_torch.launch.serve.main`` on full-width qwen3-0.6b at 4
# bits, half of its packed linears resident, KV-paged, under the deadline
# scheduler with preemption and a token budget, both verify legs on; (b)
# ``examples/xr_pipeline_torch.py``'s ``main`` with MobileNet-V2 1.0-224
# frames beside full-width qwen3-0.6b and falcon-mamba-7b tenants; (c) the
# launcher's ``--models`` tenancy of the same two at a shared budget above
# falcon-mamba-7b's page, which (b)'s pool (0.6 of the cold bytes) is
# below, so that (b) evicts nothing.  Each path's launches are counted over
# its served run alone, never over the reference runs of its verify legs.
# A CPU rehearsal adds --smoke to LAUNCH_FLAGS and TENANCY_FLAGS and
# empties XR_FLAGS
LAUNCH_ARCH = "qwen3-0.6b"
LAUNCH_FLAGS = ["--arch", LAUNCH_ARCH, "--bits", "4", "--kv-paged",
                "--requests", "8", "--max-new", "16", "--deadline-ms", "20",
                "--preemptive", "--token-budget", "64"]
LAUNCH_VERIFY = ("verify: paged tokens BIT-EXACT vs resident plan",
                 "verify: async tokens BIT-EXACT vs sync streaming, "
                 "counters unchanged by overlap")
TENANCY_FLAGS = ["--models", ",".join(TENANTS), "--bits", "4", "--kv-paged",
                 "--requests", "2", "--max-new", "4"]
TENANCY_VERIFY = tuple(
    [f"  verify {name}: tokens BIT-EXACT vs solo private pager"
     for name in TENANTS]
    + ["  pool counters (incl. wire/raw bytes) MATCH the static "
       "kv_pass_counters prediction"])
XR_EXAMPLE = ROOT / "examples" / "xr_pipeline_torch.py"
XR_FLAGS = ["--img", str(MNV2_IMG), "--full"]
LAUNCH_KERNELS = ("qmatmul_f32", "flash_attention")
XR_KERNELS = ("qmatmul_f32", "flash_attention", "selective_scan")


class _Tee:
    """Writes to each of ``outs``: the launcher's lines reach the log and
    a buffer the phase reads its verify lines from."""

    def __init__(self, *outs):
        self._outs = outs

    def write(self, s):
        for out in self._outs:
            out.write(s)
        return len(s)

    def flush(self):
        for out in self._outs:
            out.flush()


@contextlib.contextmanager
def recording_neureka(torch, ops):
    """Notes each call the model code makes to the N-EUREKA wrappers
    (through ``kernels/ops.neureka_conv2d``) as ``(op, job shape, bits)``
    in ``job_key``'s form; the wrappers run unchanged.  The pointwise jobs
    reach ``qmatmul_int8`` through ``conv1x1``."""
    calls = {name: [] for name in NEUREKA_KERNELS}
    nkc = ops._nkc

    def rec_dense(x, packed, mult, bias, *, bits, cin, stride=1):
        h, w, _ = x.shape
        calls["conv3x3_dense"].append(
            ("dense3x3", (h, w, cin, packed.shape[0], stride), bits))
        return nkc.conv3x3_dense(x, packed, mult, bias, bits=bits, cin=cin,
                                 stride=stride)

    def rec_dw(x, packed, mult, bias, *, bits, stride=1, **kw):
        h, w, c = x.shape
        calls["conv3x3_dw"].append(("dw3x3", (h, w, c, stride), bits))
        return nkc.conv3x3_dw(x, packed, mult, bias, bits=bits,
                              stride=stride, **kw)

    def rec_pw(x, packed, mult, bias, *, bits, cin, stride=1):
        h, w, _ = x.shape
        m = -(-h // stride) * -(-w // stride)
        calls["qmatmul_int8"].append(
            ("pw1x1", (m, cin, packed.shape[0]), bits))
        return nkc.conv1x1(x, packed, mult, bias, bits=bits, cin=cin,
                           stride=stride)

    ops._nkc = _Recorder(nkc, {"conv3x3_dense": rec_dense,
                               "conv3x3_dw": rec_dw, "conv1x1": rec_pw})
    try:
        yield calls
    finally:
        ops._nkc = nkc
    for name in calls:
        calls[name] = list(dict.fromkeys(calls[name]))


def check_neureka_calls(torch, packing, ops, ref, nkc, qmm, dev, calls):
    """Each N-EUREKA kernel bit-equal to its plain version at every
    distinct job shape and bits ``recording_neureka`` noted."""
    gen = torch.Generator(device=dev).manual_seed(11)
    worst = dict.fromkeys(NEUREKA_KERNELS, 0)
    for name, keys in calls.items():
        for op, shape, bits in keys:
            args = neureka_case(torch, packing, ops, gen, dev, op, shape,
                                bits)
            kname, kernel, plain = neureka_pair(nkc, qmm, ref, op, shape,
                                                bits)
            got, expect = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            diff = (got.int() - expect.int()).abs()
            worst[kname] = max(worst[kname], int(diff.max().item()))
            if got.shape != expect.shape or not torch.equal(got, expect):
                raise AssertionError(
                    f"{kname} {op} {shape} bits={bits}: "
                    f"{int((diff > 0).sum().item())} of {got.numel()} "
                    f"outputs differ from the plain version")
    print(f"[check] xr pipeline frames, N-EUREKA kernels bit-equal to their "
          f"plain versions at each distinct job: "
          f"{ {k: len(v) for k, v in calls.items()} }")
    return worst


def check_frame_launches(launches, frames: int):
    """The N-EUREKA kernels launched 1 / 17 / 35 times a frame."""
    for name, n in launches.items():
        if n != NEUREKA_PER_FRAME[name] * frames:
            raise AssertionError(f"{name} launched {n} times in {frames} "
                                 f"frames, want {NEUREKA_PER_FRAME[name]} "
                                 "a frame")


def load_example(path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def counted_runs(torch, module, attr: str, zero, read, card: bool):
    """Replaces ``module.attr`` (a function, or a class whose instances
    start a run) with a wrapper that reads the launch counts (``read()``)
    around each call: a function's counts are zeroed before it runs and
    read after it returns; a class's are read when an instance is made,
    that is when the run before it has ended.  Yields the list of
    readings, in call order."""
    real = getattr(module, attr)
    runs = []

    def sync():
        if card:
            torch.cuda.synchronize()

    if isinstance(real, type):
        def wrapped(*a, **kw):
            sync()
            runs.append(read())
            return real(*a, **kw)
    else:
        def wrapped(*a, **kw):
            zero()
            res = real(*a, **kw)
            sync()
            runs.append(read())
            return res
    setattr(module, attr, wrapped)
    try:
        yield runs
    finally:
        setattr(module, attr, real)


def run_main(torch, main, argv, card: bool):
    """``main(argv)`` with its standard output also kept: (result, text,
    wall seconds).  A failed verify's ``sys.exit(1)`` propagates."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        res = main(argv)
    if card:
        torch.cuda.synchronize()
    return res, buf.getvalue(), time.perf_counter() - t0


def expect_lines(text: str, lines, what: str):
    for line in lines:
        if line not in text.splitlines():
            raise AssertionError(f"{what}: no line {line!r}")


def expect_launched(launches, kernels, what: str):
    for kname in kernels:
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} never launched in {what}")


def tenancy_budget_mb(launch_serve, placement, argv) -> float:
    """A shared budget between the tenants' largest page and their cold
    bytes: every page fits, the cold set does not, so pages evict one
    another.  The largest page of ``attach_paging``'s first-fit paging is
    the largest cold group (its ``page_bytes``).  Each tenant is drawn as
    the launcher draws it (``_build_model``) and dropped."""
    args = launch_serve._parser().parse_args(argv)
    largest = cold = 0
    for arch in args.models.split(","):
        _cfg, packed, plan = launch_serve._build_model(arch, args)
        sizes = placement.packed_sizes(packed)
        paged = plan.split_names(list(sizes))[1]
        largest = max([largest] + [sizes[n] for n in paged])
        cold += sum(sizes[n] for n in paged)
        del packed
    return (largest + (cold - largest) // 2) / 2**20


def launch_xr_phase(torch, m, dev):
    """Phase 11 (see the comment above LAUNCH_ARCH)."""
    launch_serve, mnv2 = m["launch_serve"], m["mnv2"]
    quantiles = m["serving"].metrics.quantiles
    t_phase = time.perf_counter()
    card = dev.type == "cuda"
    device = ["--device", dev.type]
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    lm = {"qmatmul_f32": m["qmm"].qmatmul_f32,
          "flash_attention": m["fa"].flash_attention,
          "selective_scan": m["ssm"].selective_scan}
    nk = {"conv3x3_dense": m["nkc"].conv3x3_dense,
          "conv3x3_dw": m["nkc"].conv3x3_dw,
          "qmatmul_int8": m["qmm"].qmatmul_int8}

    def zero_all():
        zero_launches(lm)
        for fn in nk.values():
            fn.launches = 0

    def read_all():
        launches, split = read_launches(lm)
        return ({**launches, **{n: fn.launches for n, fn in nk.items()}},
                split)

    def free():
        gc.collect()
        if card:
            torch.cuda.empty_cache()

    out = {}

    # (a) the launcher: --budget-mb at half of the 4-bit tree's packed
    # linears, from the tree it draws (seed 0) for the config it serves
    # once given a budget
    flags = LAUNCH_FLAGS + device
    probe = launch_serve._parser().parse_args(flags + ["--budget-mb", "1"])
    cfg = launch_serve._config(probe)
    sizes = m["placement"].packed_sizes(
        launch_serve._init_packed(cfg, 0, probe))
    linears = sum(sizes.values())
    budget_mb = linears / 2 / 2**20
    metrics = out_dir / "launch_metrics.json"
    argv = flags + ["--budget-mb", repr(budget_mb), "--metrics-json",
                    str(metrics)]
    print(f"[launch] python -m repro_torch.launch.serve {' '.join(argv)}  "
          f"(packed linears {linears} B at 4 bits, budget half: "
          f"{budget_mb:.4f} MiB)")
    # the first _serve is the served run; the others are the verify legs'
    # references (the resident plan, the sync re-serve)
    with recording(torch, m["ops"]) as seen_a, \
            counted_runs(torch, launch_serve, "_serve", zero_all, read_all,
                         card) as serves:
        done, text, wall_a = run_main(torch, launch_serve.main, argv, card)
    (launches_a, split_a), verify_a = serves[0], [r[0] for r in serves[1:]]
    expect_lines(text, LAUNCH_VERIFY, "launcher")
    if len(done) != 8 or any(len(r.generated) != 16 for r in done):
        raise AssertionError("launcher: not every request got its 16 "
                             "tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("launcher: token id out of the vocabulary")
    expect_launched(launches_a, LAUNCH_KERNELS, "the launcher's served run")
    launches_a = {k: launches_a[k] for k in lm}
    doc = m["serving"].validate(json.loads(metrics.read_text()))
    reading_a = dict(
        wall_s=wall_a, ticks=doc["ticks"]["count"],
        tick_ms=doc["ticks"]["latency_ms"],
        tok_per_s=doc["throughput"]["tok_per_s"],
        serve_wall_s=doc["throughput"]["wall_s"],
        deadlines=doc["deadlines"], scheduler=doc["scheduler"],
        kv_swaps=doc["paging"]["kv_swaps"],
        exposed_s=doc["paging"]["exposed_s"],
        hidden_s=doc["paging"]["hidden_s"], budget_mb=budget_mb)
    print(f"[launch] {LAUNCH_ARCH} (4-bit, half of the linears resident, "
          f"KV-paged): both verify lines BIT-EXACT; whole main {wall_a:.2f} "
          f"s (the served run and {len(verify_a)} verify serves); the "
          f"served run on the host clock (smoke reading, {m['card']}): "
          f"{json.dumps(reading_a)}; launches of the served run "
          f"{launches_a}, of the verify serves (not counted) "
          f"{[{k: r[k] for k in lm} for r in verify_a]}")
    out["launcher"] = dict(launches=launches_a, launches_by_class=split_a,
                           reading=reading_a)
    del done
    free()

    # (b) the XR pipeline: frames beside two full-width tenants; its solo
    # legs are the only Scheduler it makes, so the counts read there are
    # the frames' and the shared tenancy's
    xr = load_example(XR_EXAMPLE)
    trace = out_dir / "xr_pipeline_trace.json"
    argv = device + ["--trace-json", str(trace)] + XR_FLAGS
    print(f"[xr] python examples/xr_pipeline_torch.py {' '.join(argv)}")
    zero_all()
    with recording(torch, m["ops"]) as seen_b, \
            recording_neureka(torch, m["ops"]) as seen_nk, \
            counted_runs(torch, xr, "Scheduler", zero_all, read_all,
                         card) as solos:
        res, _text, wall_b = run_main(torch, xr.main, argv, card)
    launches_b, split_b = solos[0]
    frames_run = 1 + xr.N_FRAMES + res["ticks"]   # warm-up, timed, loop
    check_frame_launches({n: launches_b[n] for n in nk}, frames_run)
    expect_launched(launches_b, XR_KERNELS, "the xr pipeline's tenancy")
    # the frame stage against the CPU: the same frame, the same frozen tree
    frame = res["frames"][0]
    img = res["img"]
    ys, xs = xr.distortion_map(img, img, dev)
    ys_c, xs_c = xr.distortion_map(img, img, "cpu")
    if not (torch.equal(ys.cpu(), ys_c) and torch.equal(xs.cpu(), xs_c)):
        raise AssertionError("distortion index maps differ, card vs CPU")
    corrected = xr.distortion_correct(frame)
    corrected_c = xr.distortion_correct(frame.cpu())
    logits = mnv2.apply(res["frozen"], corrected, weight_bits=8, img=img)
    logits_c = mnv2.apply(to_device(torch, res["frozen"], "cpu"),
                          corrected_c, weight_bits=8, img=img)
    if not (torch.equal(corrected.cpu(), corrected_c)
            and torch.equal(logits.cpu(), logits_c)):
        raise AssertionError("frame stage: corrected frame or MobileNet "
                             "logits differ, card vs CPU")
    gest, gest_c = xr.post_process(logits).cpu(), xr.post_process(logits_c)
    g_err = float(((gest - gest_c).abs() / gest_c.abs()).max())
    if not torch.allclose(gest, gest_c, rtol=xr.GESTURE_RTOL, atol=0):
        raise AssertionError(f"gestures card vs CPU: rel err {g_err}")
    tot = res["doc"]["totals"]
    reading_b = dict(
        img=img, tenants=res["tenants"], ticks=res["ticks"],
        frame_ms=quantiles(res["frame_ms"]),
        tick_ms=quantiles(res["tick_ms"]), loop_s=res["loop_s"],
        frame_ms_alone=res["frames_ms_alone"], build_s=res["build_s"],
        solo_s=res["solo_s"], preemptions=tot["preemptions"],
        restores=tot["restores"], tok_per_s=tot["tok_per_s"],
        pool={k: res["pool"][k] for k in (
            "budget_bytes", "evictions", "bytes_streamed_wire")},
        wall_s=wall_b, gesture_rel_err=g_err)
    print(f"[xr] MobileNet-V2 1.0-{img} frames beside "
          f"{' + '.join(res['tenants'].values())}: every assert of the "
          f"example held; frame stage card vs CPU: index maps, corrected "
          f"frame and logits equal, gestures within rel "
          f"{xr.GESTURE_RTOL} (max {g_err:.2e}); host clock (smoke "
          f"reading, {m['card']}): {json.dumps(reading_b)}; launches of "
          f"the frames and the shared tenancy, read before the solo legs "
          f"{launches_b} ({frames_run} frames)")
    out["xr"] = dict(launches=launches_b, launches_by_class=split_b,
                     reading=reading_b)
    del res, frame, logits, logits_c
    free()

    # (c) the launcher's tenancy at a budget where pages evict each other
    budget = tenancy_budget_mb(launch_serve, m["placement"],
                               TENANCY_FLAGS + device)
    free()
    metrics = out_dir / "tenancy_metrics.json"
    argv = TENANCY_FLAGS + device + ["--shared-budget-mb", repr(budget),
                                     "--metrics-json", str(metrics)]
    print(f"[tenancy] python -m repro_torch.launch.serve {' '.join(argv)}")
    with recording(torch, m["ops"]) as seen_c, \
            counted_runs(torch, launch_serve, "_serve_tenants", zero_all,
                         read_all, card) as served:
        _done, text, wall_c = run_main(torch, launch_serve.main, argv, card)
    launches_c, split_c = served[0]
    launches_c = {k: launches_c[k] for k in lm}
    expect_lines(text, TENANCY_VERIFY, "launcher tenancy")
    expect_launched(launches_c, XR_KERNELS, "the launcher's tenancy")
    doc = m["serving"].validate(json.loads(metrics.read_text()))
    pool = doc["shared_pool"]
    if pool["evictions"] <= 0:
        raise AssertionError(f"launcher tenancy: no page evicted at "
                             f"{budget} MiB: {pool}")
    reading_c = dict(
        wall_s=wall_c, ticks=doc["ticks"], budget_mb=budget,
        evictions=pool["evictions"],
        members={n: {k: c[k] for k in ("swaps", "misses", "pool_hits",
                                       "evicted")}
                 for n, c in pool["models"].items()},
        bytes_streamed_wire=pool["bytes_streamed_wire"])
    print(f"[tenancy] {' + '.join(TENANTS)} (4-bit, cold halves paged, "
          f"KV-paged) on one pool of {budget:.3f} MiB: pages evicted "
          f"{pool['evictions']} times; pool counters MATCH the "
          f"kv_pass_counters replay; each tenant BIT-EXACT vs its solo "
          f"private pager; host clock (smoke reading, {m['card']}): "
          f"{json.dumps(reading_c)}; launches of the shared run {launches_c}")
    out["tenancy"] = dict(launches=launches_c, launches_by_class=split_c,
                          reading=reading_c)
    free()

    calls = {}
    for seen in (seen_a, seen_b, seen_c):
        for name, keys in seen.items():
            calls[name] = list(dict.fromkeys(calls.get(name, []) + keys))
    out["path_check"] = check_path(torch, m["ops"], m["ref"], m["qmm"],
                                   m["fa"], m["ssm"], dev,
                                   "launcher + xr pipeline", calls)
    out["path_check"]["max_abs_err"].update(check_neureka_calls(
        torch, m["packing"], m["ops"], m["ref"], m["nkc"], m["qmm"], dev,
        seen_nk))
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[phase11] launcher + xr pipeline + launcher tenancy took "
          f"{out['wall_s']:.1f} s")
    return out


# phase 12: the VLM and encoder-decoder families and hymba's segmented
# window path (ROADMAP A9, rest), each at full width through the entry
# points a user calls (launch/steps, ServingEngine, transformer.forward)
VLM_ARCH = "llava-next-34b"
ENCDEC_ARCH = "whisper-tiny"
SEG_ARCH = "hymba-1.5b"
VLM = dict(rows=2, prompt=16, new=16, serve_requests=4, serve_new=16,
           serve_max_len=128, check_patches=64, check_layers=2)
ENCDEC = dict(rows=4, prompt=4, steps=32)
PHASE12_KERNELS = {VLM_ARCH: ("qmatmul_f32", "flash_attention"),
                   ENCDEC_ARCH: ("qmatmul_f32", "flash_attention"),
                   SEG_ARCH: ("qmatmul_f32", "flash_attention",
                              "selective_scan")}


def counted_leg(torch, counters, kernels, what):
    """Zeroes the launch counters, runs the block, reads them after a
    synchronize and fails unless each of ``kernels`` launched; yields a
    dict that holds ``launches`` and ``launches_by_class`` afterwards."""
    @contextlib.contextmanager
    def leg():
        out = {}
        zero_launches(counters)
        yield out
        torch.cuda.synchronize()
        out["launches"], out["launches_by_class"] = read_launches(counters)
        expect_launched(out["launches"], kernels, what)
    return leg()


def merge_calls(into, calls):
    for name, keys in calls.items():
        into[name] = list(dict.fromkeys(into.get(name, []) + keys))


def vlm_leg(torch, m, cfg, dev, counters, calls):
    """(a): llava-next-34b at full width, 8 bits, each weight frozen as drawn;
    (i) make_prefill_step on patches + prompts and make_decode_step, (ii)
    ServingEngine on text prompts, (iii) the first layers card vs CPU."""
    np, tfm, steps, vlm = m["np"], m["tfm"], m["steps"], m["vlm"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tree = frozen_tree(torch, m, cfg, dev)
    torch.cuda.synchronize()
    n_packed = sum(t.numel() * t.element_size() for t in leaves(tree))
    draw_s = time.perf_counter() - t0
    print(f"[vlm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; drawn and frozen (8-bit) "
          f"weight by weight in {draw_s:.2f} s, {n_packed / 2**30:.3f} GiB "
          f"resident, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          "GiB")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, s, new = VLM["rows"], VLM["prompt"], VLM["new"]
    start = cfg.n_patches + s
    patches = torch.randn((rows, cfg.n_patches, cfg.d_model), generator=gen,
                          device=dev) * 0.02
    tokens = torch.randint(0, cfg.vocab_size, (rows, s), generator=gen,
                           device=dev)
    out = {}
    # (i) the serve steps: patches + prompt prefill, then greedy decode
    with counted_leg(torch, counters, PHASE12_KERNELS[cfg.name],
                     f"{cfg.name} serve steps") as leg, \
            recording(torch, m["ops"]) as rec:
        cache = tfm.init_serve_cache(cfg, rows, start + new, device=dev)
        prefill, decode = (steps.make_prefill_step(cfg),
                           steps.make_decode_step(cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(tree, patches, tokens, cache)
        nxt = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        got = []
        t0 = time.perf_counter()
        for i in range(new):
            logits, cache = decode(tree, nxt, cache, start + i)
            nxt = logits[:, -1].argmax(-1)[:, None]
            got.append(nxt)
        got = torch.cat(got, 1).cpu()
        decode_s = (time.perf_counter() - t0) / new
    merge_calls(calls, rec)
    if got.shape != (rows, new) or not bool(((got >= 0)
                                              & (got < cfg.vocab_size)).all()):
        raise AssertionError(f"{cfg.name}: not every row got its {new} "
                             "tokens in the vocabulary")
    kv_gib = sum(t.numel() * 4 for t in cache["kv"].values()) / 2**30
    del cache, logits
    print(f"[vlm] {cfg.name} (i) make_prefill_step: {rows} rows of "
          f"{cfg.n_patches} patches + {s} tokens ({start} positions) in "
          f"{prefill_s:.3f} s on the host clock after synchronize; "
          f"{new} make_decode_step steps, {decode_s * 1e3:.2f} ms a step; "
          f"tokens {got.tolist()}; KV cache {kv_gib:.3f} GiB; launches "
          f"{leg['launches']}, by flash shape "
          f"{json.dumps(leg['launches_by_class'])}")
    out["steps"] = dict(prefill_s=prefill_s, decode_step_ms=decode_s * 1e3,
                        positions=start, **leg)
    gc.collect()
    torch.cuda.empty_cache()

    # (ii) the engine on text prompts, as the reference's serves the family
    rng = np.random.default_rng(12)
    lens = rng.integers(16, 65, VLM["serve_requests"])
    reqs = [m["Request"](uid=i, prompt=rng.integers(0, cfg.vocab_size, int(n))
                         .astype(np.int32),
                         max_new_tokens=VLM["serve_new"])
            for i, n in enumerate(lens)]
    with counted_leg(torch, counters, PHASE12_KERNELS[cfg.name],
                     f"{cfg.name} engine") as leg, \
            recording(torch, m["ops"]) as rec:
        eng = m["ServingEngine"](cfg, tree, batch_slots=4,
                                 max_len=VLM["serve_max_len"])
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        done, ticks = [], 0
        while eng.pending:
            done += eng.step()
            ticks += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    merge_calls(calls, rec)
    if len(done) != len(reqs) or any(len(r.generated) != VLM["serve_new"]
                                     for r in done):
        raise AssertionError(f"{cfg.name}: not every engine request got its "
                             f"{VLM['serve_new']} tokens")
    n_new = sum(len(r.generated) for r in done)
    print(f"[vlm] {cfg.name} (ii) ServingEngine: {len(done)} text requests "
          f"(prompts {lens.tolist()}), {n_new} new tokens, wall {wall:.3f} s "
          f"({ticks} ticks, {wall / ticks * 1e3:.1f} ms a tick, "
          f"{n_new / wall:.2f} new tok/s), launches {leg['launches']}")
    out["engine"] = dict(wall_s=wall, ticks=ticks, new_tokens=n_new, **leg)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # (iii) the first layers, card vs CPU, on patches + tokens
    depth = VLM["check_layers"]
    fcfg = cfg.replace(n_layers=depth)
    sub = dict(tree, layers=first_layers(tree["layers"], depth))
    sub_cpu = to_device(torch, sub, "cpu")
    pat = torch.randn((1, VLM["check_patches"], cfg.d_model), generator=gen,
                      device=dev) * 0.02
    toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=dev)
    with torch.no_grad():
        card = vlm.forward(sub, toks, pat, fcfg).cpu()
        cpu = vlm.forward(sub_cpu, toks.cpu(), pat.cpu(), fcfg)
    err = (card - cpu).abs().max().item()
    if not (torch.isfinite(card).all() and card.shape == (
            1, VLM["check_patches"] + s, cfg.vocab_size)):
        raise AssertionError(f"{cfg.name}: card logits not finite or "
                             "misshapen")
    if not torch.allclose(card, cpu, **LOGITS_TOL):
        raise AssertionError(f"{cfg.name} card vs CPU logits ({depth} "
                             f"layers): max abs err {err}")
    top1 = (card.argmax(-1) == cpu.argmax(-1)).float().mean().item()
    print(f"[forward] {cfg.name} ({depth} of {cfg.n_layers} layers) "
          f"{VLM['check_patches']} patches + {s} tokens card vs CPU: max abs "
          f"err {err:.3e} (tolerance {LOGITS_TOL}), top-1 agreement "
          f"{top1:.4f}, max |logit| {cpu.abs().max().item():.3f}")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"[vlm] {cfg.name}: peak device memory {peak / 2**30:.3f} GiB of "
          f"{total / 2**30:.3f} GiB")
    if peak >= total:
        raise AssertionError(f"{cfg.name}: peak memory {peak} >= {total}")
    out.update(draw_s=draw_s, resident_gib=n_packed / 2**30,
               peak_gib=peak / 2**30, logits_max_abs_err=err)
    del tree, sub, sub_cpu
    return out


def encdec_leg(torch, m, cfg, dev, counters, calls):
    """(b): whisper-tiny at full width, 8 bits; the CPU's greedy run, then
    the card's with the CPU's tokens fed in: logits at every step within
    LOGITS_TOL, and the card's greedy token the CPU's wherever the CPU's
    top two logits lie further apart than twice that tolerance."""
    steps, encdec = m["steps"], m["encdec"]
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = m["freeze"](encdec.init_params(cfg, generator=gen), bits=8)
    tree_cpu = to_device(torch, tree, "cpu")
    rows, s, n = ENCDEC["rows"], ENCDEC["prompt"], ENCDEC["steps"]
    frames = torch.randn((rows, cfg.n_audio_frames, cfg.d_model),
                         generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (rows, s), generator=gen,
                           device=dev)
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)

    def run(tree_, frames_, tokens_, dev_, feed=None):
        cache = encdec.init_serve_cache(cfg, rows, s + n, device=dev_)
        logits, cache = prefill(tree_, frames_, tokens_, cache)
        out, fed = [logits[:, -1].cpu()], []
        for i in range(n):
            nxt = (feed[i] if feed is not None
                   else out[-1].argmax(-1)[:, None])
            fed.append(nxt)
            logits, cache = decode(tree_, nxt.to(dev_), cache, s + i)
            out.append(logits[:, -1].cpu())
        return torch.stack(out, 1), fed, logits

    t0 = time.perf_counter()
    cpu_logits, fed, _ = run(tree_cpu, frames.cpu(), tokens.cpu(), "cpu")
    cpu_s = time.perf_counter() - t0
    with counted_leg(torch, counters, PHASE12_KERNELS[cfg.name],
                     f"{cfg.name} serve steps") as leg, \
            recording(torch, m["ops"]) as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_logits, _, last = run(tree, frames, tokens, dev, feed=fed)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    merge_calls(calls, rec)
    err = (card_logits - cpu_logits).abs().max().item()
    if not (torch.isfinite(card_logits).all()
            and last.shape == (rows, 1, cfg.vocab_size)):
        raise AssertionError(f"{cfg.name}: card logits not finite or "
                             "misshapen")
    if not torch.allclose(card_logits, cpu_logits, **LOGITS_TOL):
        raise AssertionError(f"{cfg.name} card vs CPU logits over {n + 1} "
                             f"steps: max abs err {err}")
    top2 = cpu_logits.topk(2, dim=-1).values
    tol = LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * top2[..., 0].abs()
    clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
    same = card_logits.argmax(-1) == cpu_logits.argmax(-1)
    if not bool(same[clear].all()):
        raise AssertionError(f"{cfg.name}: a greedy token differs where the "
                             "CPU's top two logits are apart")
    print(f"[encdec] {cfg.name}: {cfg.n_encoder_layers} + {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, "
          f"{cfg.n_audio_frames} frames, vocab {cfg.vocab_size}; "
          f"make_prefill_step on {rows} rows of frames + {s}-token prompts "
          f"and {n} make_decode_step steps: card {card_s:.3f} s, CPU "
          f"{cpu_s:.3f} s on the host clock; logits at every step card vs "
          f"CPU max abs err {err:.3e} (tolerance {LOGITS_TOL}); greedy tokens "
          f"equal at {int(same[clear].sum())} of {int(clear.sum())} clear "
          f"positions ({int(same.sum())} of {same.numel()} in all); "
          f"launches {leg['launches']}, by flash shape "
          f"{json.dumps(leg['launches_by_class'])}")
    del tree, tree_cpu
    return dict(card_s=card_s, cpu_s=cpu_s, logits_max_abs_err=err,
                clear_positions=int(clear.sum()),
                tokens_equal=int(same.sum()), positions=same.numel(), **leg)


def segmented_leg(torch, m, cfg, dev, counters, calls):
    """(c): hymba-1.5b's forward with segmented_window_scan on phase 3's
    long prompt (the window of 1,024 binds), against the unsegmented
    forward on the card; both timed on the host clock."""
    np, tfm = m["np"], m["tfm"]
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = m["freeze"](tfm.init_params(cfg, generator=gen), bits=8)
    gc.collect()
    torch.cuda.empty_cache()
    _, lens, prompts = serve_prompts(np, cfg.vocab_size, True)
    toks = torch.from_numpy(prompts[-1][None].astype(np.int64)).to(dev)
    seg = cfg.replace(segmented_window_scan=True)
    times = {}
    with torch.no_grad():
        tfm.forward(tree, toks, cfg)            # warm: builds, allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat = tfm.forward(tree, toks, cfg)
        torch.cuda.synchronize()
        times["unsegmented_s"] = time.perf_counter() - t0
        with counted_leg(torch, counters, PHASE12_KERNELS[cfg.name],
                         f"{cfg.name} segmented forward") as leg, \
                recording(torch, m["ops"]) as rec:
            t0 = time.perf_counter()
            got = tfm.forward(tree, toks, seg)
            torch.cuda.synchronize()
            times["segmented_s"] = time.perf_counter() - t0
    merge_calls(calls, rec)
    err = (got - flat).abs().max().item()
    positions = cfg.n_meta_tokens + toks.shape[1]
    if not (torch.isfinite(got).all()
            and got.shape == (1, positions, cfg.vocab_size)):
        raise AssertionError(f"{cfg.name}: segmented logits not finite or "
                             "misshapen")
    if not torch.allclose(got, flat, **LOGITS_TOL):
        raise AssertionError(f"{cfg.name} segmented vs unsegmented: max abs "
                             f"err {err}")
    windows = sorted({w for w in tfm.layer_windows(cfg) if w})
    print(f"[segmented] {cfg.name} forward, {cfg.n_layers} layers (windows "
          f"{windows}), {toks.shape[1]} tokens ({positions} positions): "
          f"segmented_window_scan {times['segmented_s']:.3f} s, unsegmented "
          f"{times['unsegmented_s']:.3f} s on the host clock after "
          f"synchronize; max abs err {err:.3e} (tolerance {LOGITS_TOL}); "
          f"launches {leg['launches']}, by flash shape and scan route "
          f"{json.dumps(leg['launches_by_class'])}")
    del tree, flat, got
    return dict(logits_max_abs_err=err, positions=positions, **times, **leg)


def vlm_encdec_phase(torch, m, dev, counters):
    """Phase 12 (see the module doc): (a) llava-next-34b, (b) whisper-tiny,
    (c) hymba-1.5b's segmented window path; then every distinct kernel call
    of the three held against its plain version."""
    get_config = m["get_config"]
    t_phase = time.perf_counter()
    calls = {}
    out = {}
    for arch, leg in ((VLM_ARCH, vlm_leg), (ENCDEC_ARCH, encdec_leg),
                      (SEG_ARCH, segmented_leg)):
        out[arch] = leg(torch, m, get_config(arch), dev, counters, calls)
        gc.collect()
        torch.cuda.empty_cache()
    out["path_check"] = check_path(torch, m["ops"], m["ref"], m["qmm"],
                                   m["fa"], m["ssm"], dev, "phase 12", calls)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[phase 12] took {out['wall_s']:.1f} s")
    return out



# phase 14: the launcher at full width on the dense archs and the VLM that
# no earlier phase serves through it (gemma-7b's head dim 256 on the flash
# kernel), each beside a 2-layer cut card vs CPU, then a MoE store's cold
# expert pages wire-served through the grouped blockscale kernel.  A CPU
# rehearsal appends --smoke to LAUNCH14_FLAGS and passes a get_config that
# gives smoke configs
LAUNCH14 = (("gemma-7b", []), ("qwen2.5-3b", []), ("olmo-1b", []),
            (VLM_ARCH, ["--requests", "4", "--max-new", "8"]))
LAUNCH14_FLAGS = ["--bits", "8", "--kv-paged"]
LAUNCH14_KERNELS = ("qmatmul_f32", "flash_attention")
CUT14 = dict(archs=("gemma-7b", "qwen2.5-3b", "olmo-1b"), layers=2,
             tokens=64)
# qwen2-moe-a2.7b cut to 2 of its 24 layers at full width, drawn at 4 bits:
# the experts' three linears of both layers int8-paged and wire-served
# (1.17 GB of CRC'd wire bytes a pass), every other packed group pinned
WIRE_MOE = dict(layers=2, bits=4, requests=4, new=8, max_len=256)
WIRE_MOE_KERNELS = ("qmatmul_f32", "qmatmul_f32_blockscale_grouped",
                    "flash_attention")


def expert_wire_plan(pl, sizes):
    """The experts' (w_gate, w_up, w_down) groups int8-paged, the rest
    pinned, at WIRE_MOE's bits."""
    bits = WIRE_MOE["bits"]
    hot = pl.Placement("l1mram", bits, "resident")
    cold = pl.Placement("l1mram", bits, "paged", 8)
    experts = {n for n in sizes if n.startswith("layers/moe/w_")}
    return pl.PlacementPlan(default=cold, rules=tuple(
        (n, hot) for n in sorted(sizes) if n not in experts)), sorted(experts)


def launcher_leg(torch, m, dev, arch, extra, lm, calls):
    """One ``main`` of the launcher on ``arch``: both verify lines
    BIT-EXACT, every request its tokens, the launches of the served run
    (its first ``_serve``), tok/s and the peak device memory."""
    launch_serve = m["launch_serve"]
    card = dev.type == "cuda"
    metrics = ROOT / "build" / f"launch_{arch}_metrics.json"
    argv = (["--arch", arch] + LAUNCH14_FLAGS + extra
            + ["--device", dev.type, "--metrics-json", str(metrics)])
    args = launch_serve._parser().parse_args(argv)
    cfg = launch_serve._config(args)
    print(f"[launch14] python -m repro_torch.launch.serve {' '.join(argv)}")
    if card:
        torch.cuda.reset_peak_memory_stats()
    with recording(torch, m["ops"]) as seen, \
            counted_runs(torch, launch_serve, "_serve",
                         lambda: zero_launches(lm),
                         lambda: read_launches(lm), card) as serves:
        done, text, wall = run_main(torch, launch_serve.main, argv, card)
    merge_calls(calls, seen)
    launches, split = serves[0]
    expect_lines(text, LAUNCH_VERIFY, f"launcher --arch {arch}")
    if len(done) != args.requests or any(len(r.generated) != args.max_new
                                         for r in done):
        raise AssertionError(f"launcher --arch {arch}: not every request "
                             f"got its {args.max_new} tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError(f"launcher --arch {arch}: token id out of the "
                             "vocabulary")
    expect_launched(launches, LAUNCH14_KERNELS,
                    f"the launcher's served run of {arch}")
    doc = m["serving"].validate(json.loads(metrics.read_text()))
    reading = dict(
        wall_s=wall, ticks=doc["ticks"]["count"],
        tick_ms=doc["ticks"]["latency_ms"],
        tok_per_s=doc["throughput"]["tok_per_s"],
        serve_wall_s=doc["throughput"]["wall_s"],
        requests=args.requests, max_new=args.max_new, layers=cfg.n_layers,
        d_model=cfg.d_model, head_dim=cfg.hd)
    if card:
        peak = torch.cuda.max_memory_allocated()
        total = torch.cuda.get_device_properties(dev).total_memory
        if peak >= total:
            raise AssertionError(f"launcher --arch {arch}: peak memory "
                                 f"{peak} >= {total}")
        reading.update(peak_gib=peak / 2**30, device_gib=total / 2**30)
    print(f"[launch14] {arch} (8-bit, KV-paged, {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, head dim {cfg.hd}): both verify lines "
          f"BIT-EXACT; whole main {wall:.2f} s; host clock (smoke reading, "
          f"{m['card']}): {json.dumps(reading)}; launches of the served run "
          f"{launches}, by flash shape {json.dumps(split)}")
    return dict(launches=launches, launches_by_class=split, reading=reading)


def cut_leg(torch, m, dev, arch, calls):
    """``arch`` cut to CUT14's layers at full width, each weight frozen at
    8 bits as drawn: ``forward`` logits of 64 tokens on the card against
    the CPU's plain path on the same tree, within LOGITS_TOL."""
    cfg = m["get_config"](arch)
    cfg = cfg.replace(n_layers=min(cfg.n_layers, CUT14["layers"]))
    tree = frozen_tree(torch, m, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    toks = torch.randint(0, cfg.vocab_size, (1, CUT14["tokens"]),
                         generator=gen, device=dev)
    with torch.no_grad(), recording(torch, m["ops"]) as seen:
        card = m["tfm"].forward(tree, toks, cfg).cpu()
    merge_calls(calls, seen)
    cpu = m["tfm"].forward(to_device(torch, tree, "cpu"), toks.cpu(), cfg)
    err = (card - cpu).abs().max().item()
    if not (torch.isfinite(card).all()
            and card.shape == (1, CUT14["tokens"], cfg.vocab_size)):
        raise AssertionError(f"{arch}: card logits not finite or misshapen")
    if not torch.allclose(card, cpu, **LOGITS_TOL):
        raise AssertionError(f"{arch} card vs CPU logits ({cfg.n_layers} "
                             f"layers): max abs err {err}")
    top1 = (card.argmax(-1) == cpu.argmax(-1)).float().mean().item()
    print(f"[forward] {arch} ({cfg.n_layers} layers at full width, d_model "
          f"{cfg.d_model}, head dim {cfg.hd}) {CUT14['tokens']} tokens card "
          f"vs CPU: max abs err {err:.3e} (tolerance {LOGITS_TOL}), top-1 "
          f"agreement {top1:.4f}, max |logit| {cpu.abs().max().item():.3f}")
    return err


def wire_moe_leg(torch, m, dev, calls, dtype: str = "float32",
                 layers: int = WIRE_MOE["layers"]):
    """qwen2-moe-a2.7b cut to WIRE_MOE's layers at full width (at
    ``dtype``: phase 15 (c) serves it at bf16), drawn at 4
    bits, its experts' linears int8-paged and served from their wire form
    (``attach_paging(wire_serve=True)``): phase 6's checks (each request its
    tokens in the vocabulary, swaps and misses the ticks times
    ``pass_counters``, nothing decoded on the host, the device memory down
    by the cold bytes once the caller's cold leaves go to the host, the
    tokens of a resident engine on the same wire-form bytes), the
    wire-served set the expert groups, and the grouped blockscale kernel
    launched."""
    np, pl, pg = m["np"], m["placement"], m["paging"]
    card = dev.type == "cuda"
    cfg = m["get_config"](MOE_ARCH)
    depth = cfg.n_layers
    cfg = cfg.replace(n_layers=min(depth, layers), dtype=dtype)
    t0 = time.perf_counter()
    packed = frozen_tree(torch, m, cfg, dev, bits=WIRE_MOE["bits"])
    sizes = pl.packed_sizes(packed)
    plan, cold = expert_wire_plan(pl, sizes)
    draw_s = time.perf_counter() - t0
    rng = np.random.default_rng(14)
    lens = rng.integers(16, 65, WIRE_MOE["requests"])
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]

    def serve(eng):
        for i, p in enumerate(prompts):
            eng.submit(m["Request"](uid=i, prompt=p,
                                    max_new_tokens=WIRE_MOE["new"]))
        ticks = 0
        while eng.pending:
            eng.step()
            ticks += 1
        if card:
            torch.cuda.synchronize()
        done = eng.finished
        if len(done) != len(prompts) or any(
                len(r.generated) != WIRE_MOE["new"] for r in done):
            raise AssertionError(f"{cfg.name} wire-served: not every request "
                                 f"got its {WIRE_MOE['new']} tokens")
        if any(not 0 <= t < cfg.vocab_size for r in done
               for t in r.generated):
            raise AssertionError(f"{cfg.name} wire-served: token id out of "
                                 "the vocabulary")
        return {r.uid: r.generated for r in done}, ticks

    eng = m["ServingEngine"](cfg, packed, batch_slots=4,
                             max_len=WIRE_MOE["max_len"], plan=plan,
                             device=dev)
    before = None
    if card:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng.attach_paging(wire_serve=True)
    attach_s = time.perf_counter() - t0
    pager = eng.pager
    if set(pager.wire_served) != set(cold):
        raise AssertionError(f"wire-served {sorted(pager.wire_served)}, want "
                             f"the expert groups {cold}")
    packed, want = host_cold(m, packed, plan, cold, WIRE_MOE["bits"])
    freed = check_freed(torch, before, want, len(cold)) if card else None
    wire_pass = sum(p.wire_nbytes for p in pager.pages)
    counters = {"qmatmul_f32": m["qmm"].qmatmul_f32,
                "qmatmul_f32_grouped": m["qmm"].qmatmul_f32_grouped,
                "qmatmul_f32_blockscale_grouped":
                    m["qmm"].qmatmul_f32_blockscale_grouped,
                "flash_attention": m["fa"].flash_attention}
    zero_launches(counters)
    for fn in counters.values():
        fn.launches_by_dtype.clear()
    t0 = time.perf_counter()
    with recording(torch, m["ops"]) as seen:
        tokens, ticks = serve(eng)
    wall = time.perf_counter() - t0
    launches, split = read_launches(counters)
    by_dtype = dtype_launches(counters)
    merge_calls(calls, seen)
    expect_launched(launches, WIRE_MOE_KERNELS,
                    f"the wire-served {cfg.name} serve")
    summary = eng.paging_summary()
    per_pass = pg.pass_counters(len(pager.pages), 2)
    if (summary["swap_count"], summary["miss_count"]) != (
            ticks * per_pass["swaps"], ticks * per_pass["misses"]):
        raise AssertionError(f"swap / miss {summary['swap_count']} / "
                             f"{summary['miss_count']} over {ticks} ticks, "
                             f"want {per_pass} a tick")
    if summary["decode_s"] != 0.0 or summary["decode_skipped_bytes"] <= 0:
        raise AssertionError(f"wire-serve decoded on the host: {summary}")
    view = {n: m["PackedParam"](packed=p.packed.to(dev),
                                scale=p.scale.to(dev), bits=p.bits,
                                orig_shape=p.orig_shape)
            for n, p in pager.template_view().items()}
    wire_tree = pg.thread_packed(packed, {**pager.resident, **view})
    pager.close()
    resident = m["ServingEngine"](cfg, wire_tree, batch_slots=4,
                                  max_len=WIRE_MOE["max_len"],
                                  plan=plan.replace(wire_serve=True),
                                  device=dev)
    r_tokens, _ = serve(resident)
    if r_tokens != tokens:
        bad = [u for u in tokens if tokens[u] != r_tokens[u]]
        raise AssertionError(f"wire-served {cfg.name} tokens differ from the "
                             f"resident wire-form engine's for uids {bad}")
    reading = dict(
        layers=cfg.n_layers, draw_s=draw_s, attach_s=attach_s,
        pages=[list(p.param_names) for p in pager.pages],
        wire_bytes_a_pass=wire_pass, cold_device_bytes=want,
        freed_bytes=freed, ticks=ticks, wall_s=wall,
        tick_ms=wall / ticks * 1e3, crc_ms=summary["crc_s"] / ticks * 1e3,
        copy_ms=summary["copy_s"] / ticks * 1e3,
        swaps=summary["swap_count"], misses=summary["miss_count"],
        bytes_streamed_wire=summary["bytes_streamed_wire"],
        decode_skipped_bytes=summary["decode_skipped_bytes"])
    print(f"[wire-moe] {cfg.name} ({cfg.n_layers} of {depth} layers at full "
          f"width, dtype {dtype}, {WIRE_MOE['bits']}-bit, experts int8-paged "
          f"and "
          f"wire-served {cold}): {len(prompts)} requests (prompts "
          f"{lens.tolist()}), tokens equal per uid to a resident engine on "
          f"the same wire-form bytes; device memory fell by {freed} B (cold "
          f"{want} B); host clock (smoke reading, {m['card']}): "
          f"{json.dumps(reading)}; launches {launches}, by dtype "
          f"{json.dumps(by_dtype)}")
    del eng, resident, wire_tree, packed
    return dict(launches=launches, launches_by_class=split,
                launches_by_dtype=by_dtype, reading=reading)


def launcher_archs_phase(torch, m, dev):
    """Phase 14 (see the comment above LAUNCH14)."""
    t_phase = time.perf_counter()
    card = dev.type == "cuda"
    (ROOT / "build").mkdir(exist_ok=True)
    lm = {"qmatmul_f32": m["qmm"].qmatmul_f32,
          "flash_attention": m["fa"].flash_attention}

    def free():
        gc.collect()
        if card:
            torch.cuda.empty_cache()

    calls, out = {}, {}
    for arch, extra in LAUNCH14:
        out[arch] = launcher_leg(torch, m, dev, arch, extra, lm, calls)
        free()
    out["cut_logits_max_abs_err"] = {}
    for arch in CUT14["archs"]:
        out["cut_logits_max_abs_err"][arch] = cut_leg(torch, m, dev, arch,
                                                      calls)
        free()
    out["wire_moe"] = wire_moe_leg(torch, m, dev, calls)
    free()
    out["path_check"] = check_path(torch, m["ops"], m["ref"], m["qmm"],
                                   m["fa"], m["ssm"], dev, "phase 14", calls)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[phase14] launcher at full width + 2-layer cuts + wire-served "
          f"MoE experts took {out['wall_s']:.1f} s")
    return out


# phase 15: the bf16 contracts of B2 (flash_attention), B7 (selective_scan)
# and B3 (qmatmul_f32_blockscale), with B1 at bf16 x, on the model path:
# the configs replaced as the reference's dry-run replaces them
# (launch/steps.py:207, cfg.replace(dtype="bfloat16")), plus a bf16
# attention and scan compute dtype for hymba-1.5b
BF16_ARCH = "hymba-1.5b"
BF16_PAGED_ARCH = "qwen3-0.6b"
# (a) hymba-1.5b at 16 of its 32 layers (the window still binds on the
# 1,035-token prompt; cut for the script's time, as PAGED_LAYERS)
BF16_HYMBA_LAYERS = 16
BF16_HYBRID = dict(dtype="bfloat16", attn_dtype="bfloat16",
                   scan_dtype="bfloat16")
BF16_KERNELS = {BF16_ARCH: ("qmatmul_f32", "flash_attention",
                            "selective_scan"),
                BF16_PAGED_ARCH: ("qmatmul_f32", "qmatmul_f32_blockscale",
                                  "flash_attention"),
                MOE_ARCH: ("qmatmul_f32", "qmatmul_f32_grouped",
                           "flash_attention")}
# (c) the bf16 MoE serve: qwen2-moe-a2.7b at full width, cut to phase 14's
# 2 of its 24 layers, 8 bits, dtype bf16, 4 requests; then wire-served at
# 1 layer (the host encodes and CRCs ~0.6 GB of wire pages a layer)
BF16_MOE = dict(layers=2, requests=4, wire_layers=1)
# the bf16 routes against their plain versions, which widen the same bf16
# inputs to f32: B1 / B3 keep QMM_TOL (bf16 x is exact in TF32, one pass);
# B7's y is rounded to bf16 by both after an f32 difference within
# SCAN_TOL, which may move it one ulp (2^-8 of |y|), and its f32 h_last
# keeps SCAN_TOL.  B2: see flash_bf16_bound
SCAN_BF16_TOL = dict(rtol=2 ** -7, atol=5e-4)
# B2's bf16 route against its plain version on the same bf16 inputs: both
# round the output to bf16 after f32 values far closer than its ulp, so
# they may land one ulp apart: 2^-7 of |o| at most, FLASH_BF16_ATOL where
# o is near 0.  With P rounded to bf16 (a bf16 attn_dtype) the kernel rounds
# each weight at its running max, the plain version at the row's final
# max; each rounding moves a weight by up to 2^-9 of itself, so o by about
# 2^-9 of the row's typical |o|: FLASH_BF16_ROW of the row's largest |o| on
# top.  The kernel's arithmetic emulated in numpy at the serves' shapes
# (tests/test_torch_flash_attention.py) comes to 0.53 of this bound at most
FLASH_BF16_ATOL = 1e-5
FLASH_BF16_ROW = 2 ** -7


def flash_bf16_bound(expect, p_rounded: bool):
    """The elementwise bound on |B2 bf16 - plain| (the comment above):
    2^-7 of |expect| plus FLASH_BF16_ATOL, plus FLASH_BF16_ROW of each
    row's largest |expect| where P is rounded to bf16."""
    bound = expect.abs() * 2 ** -7 + FLASH_BF16_ATOL
    if p_rounded:
        bound = bound + FLASH_BF16_ROW * expect.abs().amax(-1, keepdim=True)
    return bound
# card vs CPU logits of a bf16 model's first BF16_CUT_LAYERS layers: both
# round every activation to bf16, in another order of sums, so a rounding
# may land one bf16 ulp (2^-8 of its magnitude) apart and carry through
# the layers: BF16_CUT_ULPS ulps of the largest logit
BF16_CUT_LAYERS = 4
BF16_CUT_ULPS = 8
# a bf16 MoE's router reads bf16 inputs that card and CPU round in their
# own orders, so a near-tie may pick another expert for a token: the cut
# runs one layer (a token's experts then reach no other token) and holds
# the logits of the tokens whose top-k agree; at most this many of the 64
# may differ
BF16_MOE_FLIPS = 4
# FLASH_CASES rows that phase 15 also holds at bf16, each with P rounded
# and P f32-accurate: head dims 16, 32, 64 (rows that see no key), 128
# (qwen3-0.6b's chunk) and 256 (gemma-7b's)
BF16_FLASH_EXTRA = (7, 6, 5, 0, 12)
# the bf16 routes timed, each at its serve's P: qwen3-0.6b's chunk at a bf16
# dtype (attention computed in f32, P kept f32-accurate), hymba-1.5b's long
# prompt at a bf16 attn_dtype (P rounded to bf16); B7 at hymba's prefill and
# decode; B3 at one layer's cold linears of the paged serve at decode (M =
# 4; phase 6's linears) and grouped at E = 60, C = 8; B1 at qwen3-0.6b's
# layer at decode
BF16_TIMED_FLASH = {"qwen3": "float32", "hymba": "bfloat16"}
BF16_TIMED_SCAN = ("hymba_prefill", "hymba_decode")


def widen_bf16(torch, tree):
    """``tree`` with its bf16 leaves in f32 (the packed levels and their
    f32 scales as they are): the same weights for the f32 config."""
    if isinstance(tree, dict):
        return {k: widen_bf16(torch, v) for k, v in tree.items()}
    return tree.float() if tree.dtype == torch.bfloat16 else tree


def check_bf16_extra(torch, ops, ref, qmm, fa, dev):
    """B2's bf16 route at every head dim (FLASH_CASES rows BF16_FLASH_EXTRA)
    with P rounded to bf16 and with P kept f32-accurate, and writing f32 (a
    bf16 attention in an f32 model) at D = 128; the grouped B3 at bf16 x on
    qwen2-moe-a2.7b's expert shapes (E = 60, C = 8): each against its plain
    version, B2 to ``flash_bf16_bound``."""
    gen = torch.Generator(device=dev).manual_seed(16)
    bf = torch.bfloat16
    worst = {"flash_attention": 0.0,
             "qmatmul_f32_blockscale_grouped": 0.0}
    share = {}

    cases = [(FLASH_CASES[i], p, None) for i in BF16_FLASH_EXTRA
             for p in (torch.float32, bf)]
    cases.append((FLASH_CASES[0], bf, torch.float32))
    for case, p_dtype, out_dtype in cases:
        q, k, v, kw = flash_inputs(torch, gen, dev, case)
        q, k, v = q.to(bf), k.to(bf), v.to(bf)
        kw.update(out_dtype=out_dtype, p_dtype=p_dtype)
        got = fa.flash_attention(q, k, v, **kw)
        if got.dtype != (out_dtype or bf):
            raise AssertionError(f"flash_attention bf16 wrote {got.dtype}")
        expect = ref.flash_attention(q, k, v, **kw).float()
        torch.cuda.synchronize()
        err = (got.float() - expect).abs()
        ratio = (err / flash_bf16_bound(expect, p_dtype == bf)).max().item()
        key = f"D={case[5]} P={str(p_dtype)[6:]}"
        share[key] = max(share.get(key, 0.0), ratio)
        worst["flash_attention"] = max(worst["flash_attention"],
                                       err.max().item())
        if ratio > 1:
            raise AssertionError(f"flash_attention bf16 case {case} P "
                                 f"{p_dtype} out {out_dtype or bf}: max abs "
                                 f"err {err.max().item()}, {ratio:.3f} of "
                                 "the bound")
        if not torch.equal(got, fa.flash_attention(q, k, v, **kw)):
            raise AssertionError(f"flash_attention bf16 case {case}: two "
                                 "calls differ")
        del q, k, v, got, expect, err
    for k, n in EXPERT_LINEARS.values():
        packed, scales = expert_wire_weights(torch, ops, gen, dev, 60, k, n)
        x = torch.randn((60, 8, k), generator=gen, device=dev).to(bf)
        got = qmm.qmatmul_f32_blockscale_grouped(x, packed, scales, bits=8,
                                                 k_orig=k)
        expect = ref.qmatmul_f32_blockscale_grouped(x, packed, scales,
                                                    bits=8, k_orig=k)
        torch.cuda.synchronize()
        err = (got - expect).abs().max().item()
        worst["qmatmul_f32_blockscale_grouped"] = max(
            worst["qmatmul_f32_blockscale_grouped"], err)
        if not torch.allclose(got, expect, **QMM_TOL):
            raise AssertionError(f"qmatmul_f32_blockscale_grouped bf16 E=60 "
                                 f"C=8 K={k} N={n}: max abs err {err}")
        del packed, scales, x, got, expect
    torch.cuda.empty_cache()
    print(f"[check] bf16 routes beyond the serves: flash_attention at D = "
          f"{[FLASH_CASES[i][5] for i in BF16_FLASH_EXTRA]}, P rounded and "
          f"P f32-accurate, and f32 out at D = 128 (flash_bf16_bound, two "
          f"calls bit-equal; err / bound {json.dumps(share)}), "
          f"qmatmul_f32_blockscale_grouped at bf16 x, E=60 C=8, "
          f"{list(EXPERT_LINEARS)} (tolerance {QMM_TOL}); max abs err "
          f"{json.dumps(worst)}")
    return dict(worst, flash_share_of_bound=share)


def time_bf16_activations(torch, F, cfg, dev):
    """One layer's activations of ``cfg`` (hymba-1.5b) at bf16 as
    ``models/layers.py`` computes them there, op by op in bf16 as XLA
    rounds them (the mixer's silu of the conv output and of z, softplus of
    dt, on (B, S, d_inner); the MLP's silu on (B, S, d_ff)), beside
    PyTorch's fused ops on the same inputs (what the port runs at f32): at
    decode (4 rows of one token) and over the 1,163-token prompt.  Eager
    times (the serve enqueues them one by one) and graph-replay device
    times, a layer."""
    from repro_torch.models import layers
    gen = torch.Generator(device=dev).manual_seed(20)
    out = {}
    for leg, (b, s) in (("decode", (4, 1)), ("prefill", (1, 1163))):
        xs = [torch.randn((b, s, w), generator=gen, device=dev).to(
            torch.bfloat16) for w in (cfg.d_inner,) * 3 + (cfg.d_ff,)]
        zero = torch.zeros((), dtype=torch.bfloat16, device=dev)

        def ours(i):
            layers.silu(xs[0]), layers.softplus(xs[1])
            layers.silu(xs[2]), layers.silu(xs[3])

        def fused(i):
            F.silu(xs[0]), torch.logaddexp(xs[1], zero)
            F.silu(xs[2]), F.silu(xs[3])
        res = dict(eager_ms=cuda_ms(torch, ours, 50),
                   fused_eager_ms=cuda_ms(torch, fused, 50),
                   ms=graph_ms(torch, ours, 1),
                   fused_ms=graph_ms(torch, fused, 1),
                   work=f"B={b} S={s} d_inner={cfg.d_inner} d_ff={cfg.d_ff}")
        out[leg] = res
        print(f"[time] bf16 activations of one {cfg.name} layer {leg} "
              f"({res['work']}): op by op as XLA (models/layers.py) eager "
              f"{res['eager_ms']:.4f} ms, device {res['ms']:.4f} ms; fused "
              f"ops eager {res['fused_eager_ms']:.4f} ms, device "
              f"{res['fused_ms']:.4f} ms; x {cfg.n_layers} layers the "
              f"difference is "
              f"{(res['eager_ms'] - res['fused_eager_ms']) * cfg.n_layers:.3f}"
              f" ms eager a step")
        del xs
    return out


def dtype_launches(counters):
    """{wrapper: its launches_by_dtype}."""
    return {name: dict(fn.launches_by_dtype) for name, fn in counters.items()}


def bf16_serve_leg(torch, m, cfg, tree, dev, counters, *, max_len: int,
                   long_prompt: bool, plan=None, make_tree32=None,
                   requests: int = 8):
    """Serve the first ``requests`` of ``serve_lm``'s 8 greedy requests (16
    new tokens) on the bf16
    ``cfg`` through ``ServingEngine`` (with ``plan``, paged and wire-served
    through ``attach_paging(wire_serve=True)``), every call noted; the
    arch's kernels must launch, all at bf16.  Then the same requests on the
    f32 config with the same weights (``make_tree32()``: the tree and plan
    an f32 engine serves them from, resident), and the share of greedy
    tokens that agree; and one ``launch/steps.make_prefill_step`` (2 rows
    of 64 tokens) and ``make_decode_step`` call at each dtype, with the
    largest logit difference at the first decode step; and the bf16
    ``forward`` of the first BF16_CUT_LAYERS layers, card vs CPU."""
    np, steps = m["np"], m["steps"]
    arch = cfg.name
    cfg32 = cfg.replace(dtype="float32", attn_dtype="float32",
                        scan_dtype="float32")
    rng, lens, prompts = serve_prompts(np, cfg.vocab_size, long_prompt)
    lens, prompts = lens[:requests], prompts[:requests]
    wire = {}

    def serve(c, t, p, paged):
        eng = m["ServingEngine"](c, t, batch_slots=4, max_len=max_len,
                                 plan=p)
        if paged:
            eng.attach_paging(wire_serve=True)
        for i, pr in enumerate(prompts):
            eng.submit(m["Request"](uid=i, prompt=pr, max_new_tokens=16))
        done = []
        while eng.pending:
            done += eng.step()
        torch.cuda.synchronize()
        if len(done) != requests or any(len(r.generated) != 16
                                        for r in done):
            raise AssertionError(f"{arch}: not every request got its 16 "
                                 "tokens")
        if any(not 0 <= t_ < cfg.vocab_size for r in done
               for t_ in r.generated):
            raise AssertionError(f"{arch}: token id out of the vocabulary")
        if eng.pager is not None:
            # the tree the serve multiplied: the cold groups in the wire
            # form the pager copied, the pinned ones as they are
            view = {n: m["PackedParam"](packed=q.packed.to(dev),
                                        scale=q.scale.to(dev), bits=q.bits,
                                        orig_shape=q.orig_shape)
                    for n, q in eng.pager.template_view().items()}
            wire["tree"] = m["paging"].thread_packed(
                t, {**eng.pager.resident, **view})
            eng.pager.close()
        return {r.uid: list(r.generated) for r in done}

    zero_launches(counters)
    for fn in counters.values():
        fn.launches_by_dtype.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(torch, m["ops"]) as calls:
        tokens = serve(cfg, tree, plan, plan is not None)
    wall = time.perf_counter() - t0
    launches, by_class = read_launches(counters)
    by_dtype = dtype_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    for name in BF16_KERNELS[arch]:
        n_bf = by_dtype[name].get("bfloat16", 0)
        if n_bf <= 0 or n_bf != launches[name]:
            raise AssertionError(f"{arch} bf16 serve: {name} launched "
                                 f"{by_dtype[name]} by dtype, "
                                 f"{launches[name]} in all; every launch "
                                 "must take its bf16 route")
    if "selective_scan" in BF16_KERNELS[arch] and set(
            by_class.get("selective_scan", {})) != {"step", "chunked"}:
        raise AssertionError(f"{arch} bf16 serve: scan routes "
                             f"{by_class.get('selective_scan')}")
    new = sum(len(v) for v in tokens.values())
    print(f"[bf16] {arch} ({cfg.dtype} weights and activations, attention "
          f"{cfg.attn_dtype}, scan {cfg.scan_dtype}"
          f"{', paged, cold half wire-served' if plan is not None else ''}):"
          f" {requests} requests, prompts {lens.tolist()}, {new} new "
          f"tokens, wall "
          f"{wall:.3f} s ({new / wall:.2f} new tok/s), peak "
          f"{peak / 2**30:.3f} GiB; launches {launches}, by dtype "
          f"{json.dumps(by_dtype)}, by flash shape and scan route "
          f"{json.dumps(by_class)}")
    if any(c[-1] != torch.bfloat16 for name in ("qmatmul_f32",
                                                 "qmatmul_f32_grouped")
           for c in calls[name]):
        raise AssertionError(f"{arch}: B1 took f32 x in a bf16 serve")
    path_check = check_path(torch, m["ops"], m["ref"], m["qmm"], m["fa"],
                            m["ssm"], dev, arch, calls,
                            dtype=torch.bfloat16)

    tree32, plan32, step_tree, step_tree32, step_plan = make_tree32(
        wire.pop("tree", None))
    t0 = time.perf_counter()
    tokens32 = serve(cfg32, tree32, plan32, False)
    wall32 = time.perf_counter() - t0
    agree = np.mean([a == b for u in tokens for a, b in zip(tokens[u],
                                                           tokens32[u])])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))).to(dev)
    logits = {}
    for c, t in ((cfg, step_tree), (cfg32, step_tree32)):
        cache = m["tfm"].init_serve_cache(c, 2, cfg.n_meta_tokens + 72)
        pre, cache = steps.make_prefill_step(c, step_plan)(t, toks, cache)
        nxt = logits.get("next", pre[:, -1].float().argmax(-1,
                                                           keepdim=True))
        logits["next"] = nxt
        dec, _ = steps.make_decode_step(c, step_plan)(
            t, nxt, cache, cfg.n_meta_tokens + 64)
        if not torch.isfinite(dec.float()).all():
            raise AssertionError(f"{arch} {c.dtype} decode logits not finite")
        logits[c.dtype] = (pre.float(), dec.float())
    pre_err = (logits["bfloat16"][0] - logits["float32"][0]).abs().max()
    dec_err = (logits["bfloat16"][1] - logits["float32"][1]).abs().max()
    top = logits["float32"][1].abs().max().item()

    # the bf16 forward of the first layers, card vs the CPU's plain path;
    # a MoE's at one layer, its tokens whose top-k experts differ card vs
    # CPU (a near-tie of bf16 router inputs) counted and left out
    depth = 1 if cfg.n_experts else min(BF16_CUT_LAYERS, cfg.n_layers)
    fcfg = cfg.replace(n_layers=depth)
    ftree = dict(step_tree, layers=first_layers(step_tree["layers"], depth))
    with recorded_routes(m) as routes:
        card = m["tfm"].forward(ftree, toks[:1], fcfg,
                                engine=step_plan).float().cpu()
        host = m["tfm"].forward(to_device(torch, ftree, "cpu"),
                                toks[:1].cpu(), fcfg,
                                engine=step_plan).float()
    keep = torch.ones(card.shape[1], dtype=torch.bool)
    if routes:
        half = len(routes) // 2
        for a, b in zip(routes[:half], routes[half:]):
            keep &= ~(a != b).any(-1)
    flips = int((~keep).sum())
    if flips > BF16_MOE_FLIPS:
        raise AssertionError(f"{arch} bf16 card vs CPU: {flips} tokens' "
                             "top-k experts differ")
    cut_err = (card - host)[:, keep].abs().max().item()
    cut_tol = BF16_CUT_ULPS * host.abs().max().item() * 2.0 ** -8
    if not (torch.isfinite(card).all() and card.shape == host.shape
            and cut_err <= cut_tol):
        raise AssertionError(f"{arch} bf16 card vs CPU logits, "
                             f"{depth} layers: max abs err "
                             f"{cut_err} (tolerance {cut_tol})")
    cut_top1 = (card.argmax(-1) == host.argmax(-1)).float().mean().item()
    print(f"[forward] {arch} bf16 ({depth} of {cfg.n_layers} "
          f"layers) 64 tokens card vs CPU: max abs err {cut_err:.4e} "
          f"(tolerance {BF16_CUT_ULPS} bf16 ulps of the largest logit, "
          f"{cut_tol:.4e})"
          + (f" over the {int(keep.sum())} tokens whose top-k experts "
             f"agree ({flips} differ, at most {BF16_MOE_FLIPS} allowed)"
             if routes else "") + f", top-1 agreement {cut_top1:.4f}")
    print(f"[bf16] {arch} beside the f32 serve of the same weights (f32 "
          f"wall {wall32:.3f} s): greedy tokens agree at {agree:.4f} of "
          f"{new} positions; make_prefill_step (2 x 64) then "
          f"make_decode_step: largest logit difference bf16 vs f32 "
          f"{pre_err.item():.4f} at prefill, {dec_err.item():.4f} at the "
          f"first decode step (largest |logit| {top:.3f})")
    return dict(launches=launches, launches_by_class=by_class,
                launches_by_dtype=by_dtype, wall_s=wall, wall_f32_s=wall32,
                peak_gib=peak / 2**30, prompt_tokens=int(lens.sum()),
                token_agreement=float(agree),
                first_decode_max_logit_diff=dec_err.item(),
                prefill_max_logit_diff=pre_err.item(),
                max_abs_logit=top, cut_logits_max_abs_err=cut_err,
                cut_route_flips=flips, cut_top1=cut_top1,
                path_check=path_check)


def bf16_moe_leg(torch, m, dev, get_config, counters):
    """(c) qwen2-moe-a2.7b at full width, BF16_MOE's layers, 8 bits,
    ``dtype="bfloat16"``, served through :func:`bf16_serve_leg` beside the
    f32 config of the same weights: every grouped B1 launch on its bf16 x
    route, each distinct call held against its plain version; then
    :func:`wire_moe_leg` at bf16: every grouped B3 launch on its bf16 x
    route, each distinct call held likewise."""
    counters = dict(counters,
                    qmatmul_f32_grouped=m["qmm"].qmatmul_f32_grouped)
    cfg = cut(get_config(MOE_ARCH), BF16_MOE["layers"]).replace(
        dtype="bfloat16")
    tree = frozen_tree(torch, m, cfg, dev)

    def moe32(_wire):
        t32 = widen_bf16(torch, tree)
        return t32, None, tree, t32, None
    out = bf16_serve_leg(torch, m, cfg, tree, dev, counters, max_len=512,
                         long_prompt=False, make_tree32=moe32,
                         requests=BF16_MOE["requests"])
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    # the same store with its experts wire-served (phase 14's leg at bf16):
    # every grouped B3 launch on its bf16 x route
    calls = {}
    out["wire"] = wire_moe_leg(torch, m, dev, calls, dtype="bfloat16",
                               layers=BF16_MOE["wire_layers"])
    by = out["wire"]["launches_by_dtype"]["qmatmul_f32_blockscale_grouped"]
    n = out["wire"]["launches"]["qmatmul_f32_blockscale_grouped"]
    if not n or by.get("bfloat16", 0) != n:
        raise AssertionError(f"bf16 wire-served MoE: the grouped B3 launched "
                             f"{by} by dtype, {n} in all")
    out["wire"]["path_check"] = check_path(
        torch, m["ops"], m["ref"], m["qmm"], m["fa"], m["ssm"], dev,
        f"{MOE_ARCH} wire-served bf16", calls, dtype=torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def bf16_phase(torch, m, dev, get_config):
    """(a) hymba-1.5b at full width, BF16_HYMBA_LAYERS deep, 8 bits,
    dtype, attn_dtype
    and scan_dtype bf16 (B1 at bf16 x, B2's bf16 route at D = 64 with the
    window, B7's bf16 chunked and step routes); (b) qwen3-0.6b's phase-6
    store (4 bits, the cold half wire-served as int8 pages) at a bf16
    dtype (B3 at bf16 x, B2 at D = 128); (c) the bf16 MoE serve
    (:func:`bf16_moe_leg`: the grouped B1 at bf16 x); each served beside
    the f32 config of the same weights.  Then the bf16 routes at the shapes
    no serve reaches, and each timed (the grouped B1 at bf16 x too)."""
    tfm, pl = m["tfm"], m["placement"]
    counters = {"qmatmul_f32": m["qmm"].qmatmul_f32,
                "qmatmul_f32_blockscale": m["qmm"].qmatmul_f32_blockscale,
                "flash_attention": m["fa"].flash_attention,
                "selective_scan": m["ssm"].selective_scan}
    out = {}
    cfg = cut(get_config(BF16_ARCH), BF16_HYMBA_LAYERS).replace(
        **BF16_HYBRID)
    t0 = time.perf_counter()
    tree = frozen_tree(torch, m, cfg, dev)
    print(f"[bf16] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, drawn bf16 and packed at 8 bits as drawn "
          f"(init_params(bits=8)) in {time.perf_counter() - t0:.2f} s")

    def hybrid32(_wire):
        t32 = widen_bf16(torch, tree)
        return t32, None, tree, t32, None
    out[BF16_ARCH] = bf16_serve_leg(torch, m, cfg, tree, dev, counters,
                                    max_len=2048, long_prompt=True,
                                    make_tree32=hybrid32)
    del tree
    gc.collect()
    torch.cuda.empty_cache()

    cfg = cut(get_config(BF16_PAGED_ARCH), PAGED_LAYERS).replace(
        dtype="bfloat16")
    tree = frozen_tree(torch, m, cfg, dev, bits=4)
    sizes = pl.packed_sizes(tree)
    plan = pl.plan_for_budget(
        sizes, sum(sizes.values()) // 2, sizes_bits=4,
        hot=pl.Placement("l1mram", 4, "resident"),
        cold=pl.Placement("l1mram", 4, "paged", 8))
    cold_linears = [LAYER_LINEARS[n.split("/")[-1]]
                    for n in plan.split_names(sorted(sizes))[1]]

    def paged32(wire):
        # the weights the paged serve multiplied, resident: the cold groups
        # in their int8 wire form, no pager (as phase 6's resident leg)
        wire_plan = plan.replace(wire_serve=True)
        wire32 = widen_bf16(torch, wire)
        return wire32, wire_plan, wire, wire32, wire_plan
    out[BF16_PAGED_ARCH] = bf16_serve_leg(
        torch, m, cfg, tree, dev, counters, max_len=512, long_prompt=False,
        plan=plan, make_tree32=paged32)
    del tree
    gc.collect()
    torch.cuda.empty_cache()

    out[MOE_ARCH] = bf16_moe_leg(torch, m, dev, get_config, counters)
    out["activations"] = time_bf16_activations(
        torch, m["F"], get_config(BF16_ARCH), dev)
    out["extra_check"] = check_bf16_extra(torch, m["ops"], m["ref"],
                                          m["qmm"], m["fa"], dev)
    bf = torch.bfloat16
    out["times"] = times = {
        f"flash_{which}": time_flash(torch, m["F"], m["ref"], m["fa"], dev,
                                     which, dtype=bf,
                                     p_dtype=getattr(torch, p_dtype))
        for which, p_dtype in BF16_TIMED_FLASH.items()}
    for which in BF16_TIMED_SCAN:
        times[f"scan_{which}"] = time_scan(torch, m["ref"], m["ssm"], dev,
                                           which, dtype=bf)
    times["blockscale_decode"] = time_blockscale(
        torch, m["packing"], m["ref"], m["qmm"], dev, 4, cold_linears,
        dtype=bf)
    times["blockscale_grouped"] = time_grouped_blockscale(
        torch, m["ops"], m["ref"], m["qmm"], dev, 8, copies=1, dtype=bf)
    times["qmatmul_decode"] = time_qmatmul(
        torch, m["packing"], m["ops"], m["ref"], m["qmm"], dev, 4, dtype=bf)
    times["grouped_decode"] = time_grouped(
        torch, m["packing"], m["ops"], m["ref"], m["qmm"], dev, 8, dtype=bf)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 16: mesh-sharded paged serving (ROADMAP A11 (a)).  A mesh's links
# all stream to the one card: N fetch workers (each CRC-checking its own
# shard's pages) and N copy streams feeding one device, joined at the
# tick's fence.  (a) The launcher's main on full-width qwen3-0.6b at 4 bits,
# KV-paged, --mesh 4, with a budget at which at least half of the packed
# linear bytes stay paged under the sharded charge (plan_for_budget's
# shard_factors charge a sharded param a quarter a link: at phase 11's
# half-of-the-linears budget everything would be resident and the launcher
# would serve unsharded).  (b) Phase 6's store (4 bits, the cold half
# wire-served as int8 pages) through attach_paging(wire_serve=True,
# mesh=make_test_mesh((1, 4))): pool-less, and with a per-link budget that
# holds only part of a link's pages (a one-member pool never evicts its own
# pages, so the rest re-swap every pass); phase 6's requests, tokens equal
# to phase 6's single-link serve, counters equal to predict()
MESH_ARCH = "qwen3-0.6b"
MESH_LINKS = 4
MESH_FLAGS = ["--arch", MESH_ARCH, "--bits", "4", "--kv-paged",
              "--requests", "4", "--max-new", "8", "--mesh", str(MESH_LINKS)]
MESH_VERIFY = LAUNCH_VERIFY + (
    "verify: mesh tokens BIT-EXACT vs single-device paged run, byte ledger "
    "obeys the sharding algebra",)
# the launcher's budget: this share of the linears' per-link charge
MESH_BUDGET_SHARE = 0.4
# (b)'s per-link pool: this share of a link's page bytes
MESH_POOL_SHARE = 2 / 3
MESH_KERNELS = ("qmatmul_f32", "flash_attention")
MESH_WIRE_KERNELS = ("qmatmul_f32", "qmatmul_f32_blockscale",
                     "flash_attention")


@contextlib.contextmanager
def captured_serves(torch, launch_serve, zero, read, card: bool):
    """Wraps the launcher's ``_serve``: each call's launches (zeroed before
    it, read after it), its ticks' latency and page-wait quantiles, its
    paging summary and whether it ran on a mesh, in call order."""
    real = launch_serve._serve
    runs = []

    def wrapped(*a, **kw):
        zero()
        done, sched, eng = real(*a, **kw)
        if card:
            torch.cuda.synchronize()
        launches, split = read()
        doc = sched.metrics.summary(paging=eng.paging_summary())
        runs.append(dict(launches=launches, split=split,
                         mesh=kw.get("mesh") is not None,
                         ticks=doc["ticks"], paging=doc["paging"]))
        return done, sched, eng

    launch_serve._serve = wrapped
    try:
        yield runs
    finally:
        launch_serve._serve = real


def link_rows(rows):
    """Per-link wire bytes, CRC and copy seconds of ``paging.devices``."""
    return [dict(link=r["device"], wire_bytes=r["bytes_streamed_wire"],
                 crc_s=r["crc_s"], copy_s=r["copy_s"]) for r in rows]


def mesh_phase(torch, m, dev, cfg, store):
    """Phase 16 (see the comment above MESH_ARCH).  ``store`` is phase 6's
    paged store (its tree with the cold leaves on the host, its plan, its
    served tokens)."""
    np, pl, pg = m["np"], m["placement"], m["paging"]
    launch_serve, qmm, fa = m["launch_serve"], m["qmm"], m["fa"]
    t_phase = time.perf_counter()
    card = dev.type == "cuda"
    lm = {"qmatmul_f32": qmm.qmatmul_f32,
          "qmatmul_f32_blockscale": qmm.qmatmul_f32_blockscale,
          "flash_attention": fa.flash_attention}
    mesh = m["mesh"].make_test_mesh((1, MESH_LINKS), ("data", "model"),
                                    device=dev)
    links = [str(link) for link in mesh.links]
    print(f"[mesh] {MESH_LINKS} links {links}, all on the one physical "
          f"device {dev} ({torch.cuda.get_device_name(dev) if card else dev}"
          f"): {MESH_LINKS} fetch workers and copy streams")
    out = {}

    # (a) the launcher: the budget from the tree it draws, charged per link
    flags = MESH_FLAGS + ["--device", dev.type]
    probe = launch_serve._parser().parse_args(flags + ["--budget-mb", "1"])
    packed = launch_serve._init_packed(launch_serve._config(probe), 0, probe)
    factors = launch_serve._mesh_shard_factors(packed, mesh)
    sizes = pl.packed_sizes(packed)
    per_link = pl.packed_sizes(packed, shard_factors=factors)
    budget_mb = sum(per_link.values()) * MESH_BUDGET_SHARE / 2**20
    plan = pl.plan_for_budget(
        sizes, int(budget_mb * 2**20),
        hot=pl.Placement("l1mram", 4, "resident"),
        cold=pl.Placement("l3flash", 4, "paged"), sizes_bits=4,
        shard_factors=factors)
    del packed
    paged_share = plan.paged_bytes(sizes) / sum(sizes.values())
    print(f"[mesh] (a) packed linears {sum(sizes.values())} B at 4 bits, "
          f"{sum(per_link.values())} B charged a link ({len(factors)} of "
          f"{len(sizes)} groups shard {MESH_LINKS} ways); --budget-mb "
          f"{budget_mb:.4f} pins {plan.split_names(sorted(sizes))[0]}, "
          f"pages {paged_share:.3f} of the linear bytes")
    if paged_share < 0.5:
        raise AssertionError(f"the mesh budget pages only {paged_share:.3f} "
                             "of the linear bytes, want half or more")
    metrics = ROOT / "build" / "mesh_metrics.json"
    metrics.parent.mkdir(exist_ok=True)
    argv = flags + ["--budget-mb", repr(budget_mb), "--metrics-json",
                    str(metrics)]
    print(f"[mesh] python -m repro_torch.launch.serve {' '.join(argv)}")

    def zero():
        zero_launches(lm)

    def read():
        return read_launches(lm)

    with recording(torch, m["ops"]) as seen_a, \
            captured_serves(torch, launch_serve, zero, read, card) as runs:
        done, text, wall_a = run_main(torch, launch_serve.main, argv, card)
    if "nothing paged under this plan" in text or \
            "serving unsharded" in text:
        raise AssertionError("the launcher served unsharded")
    expect_lines(text, MESH_VERIFY, "mesh launcher")
    if not any(line.startswith(f"mesh 1x{MESH_LINKS}: ") and line.endswith(
            "global ledger MATCHES the static kv_pass_counters prediction")
            for line in text.splitlines()):
        raise AssertionError("mesh launcher: the ledger does not match its "
                             "prediction")
    if len(done) != 4 or any(len(r.generated) != 8 for r in done):
        raise AssertionError("mesh launcher: not every request got its 8 "
                             "tokens")
    doc = m["serving"].validate(json.loads(metrics.read_text()))
    md = doc["mesh"]
    if not (md["bit_exact"] and md["predicted_ok"] and md["ledger_ok"]
            and md["sharded_params"] > 0 and md["n_devices"] == MESH_LINKS):
        raise AssertionError(f"mesh section {json.dumps(md)}")
    if doc["paging"]["devices"] != md["ledger"]["per_device"]:
        raise AssertionError("paging.devices differs from the ledger's rows")
    served, single = runs[0], runs[-1]
    if not served["mesh"] or single["mesh"]:
        raise AssertionError("the launcher's first serve is not the mesh "
                             "run, or its last not the single-link one")
    expect_launched(served["launches"], MESH_KERNELS,
                    "the launcher's mesh run")

    def reading(run):
        nt = run["ticks"]["count"]
        return dict(ticks=nt, tick_ms=run["ticks"]["latency_ms"],
                    exposed_ms_a_tick=run["paging"]["exposed_s"] / nt * 1e3,
                    hidden_ms_a_tick=run["paging"]["hidden_s"] / nt * 1e3,
                    crc_s=run["paging"]["crc_s"],
                    copy_s=run["paging"]["copy_s"],
                    wire_bytes=run["paging"]["bytes_streamed_wire"])

    out["launcher"] = dict(
        launches={k: served["launches"][k] for k in MESH_KERNELS},
        launches_by_class=served["split"], wall_s=wall_a,
        budget_mb=budget_mb, paged_share=paged_share,
        sharded_params=md["sharded_params"], predicted=md["predicted"],
        single_device=md["single_device"],
        per_link_max_wire=md["per_link_max_wire"],
        mesh=dict(reading(served),
                  links=link_rows(served["paging"]["devices"])),
        one_link=reading(single))
    print(f"[mesh] (a) the launcher's main, every verify line BIT-EXACT, "
          f"the ledger on its prediction ({wall_a:.2f} s with its "
          f"{len(runs) - 1} verify serves); readings ({m['card']}): "
          f"{json.dumps(out['launcher'])}")

    # (b) phase 6's wire-served store on four links
    rng = np.random.default_rng(0)          # serve_lm's requests
    lens = rng.integers(16, 257, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    plan = store["plan"]
    cold = plan.split_names(sorted(pl.packed_sizes(store["packed"])))[1]
    full = pg.packed_tree_store(store["packed"], plan)
    page_bytes = max(-(-full.params[n].nbytes_packed // MESH_LINKS)
                     for n in cold)
    del full

    def serve(mesh=None, budget=None):
        eng = m["ServingEngine"](cfg, store["packed"], batch_slots=4,
                                 max_len=512, plan=plan)
        eng.attach_paging(wire_serve=True, mesh=mesh,
                          page_bytes=page_bytes if mesh else None,
                          shard_budget_bytes=budget)
        for i, p in enumerate(prompts):
            eng.submit(m["Request"](uid=i, prompt=p, max_new_tokens=16))
        ticks = []
        zero()
        while eng.pending:
            t = time.perf_counter()
            eng.step()
            ticks.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        launches, split = read()
        tokens = {r.uid: r.generated for r in eng.finished}
        if tokens != store["tokens"]:
            bad = [u for u in tokens if tokens[u] != store["tokens"].get(u)]
            raise AssertionError(f"wire-served store on "
                                 f"{'a mesh' if mesh else 'one link'}: "
                                 f"tokens differ from phase 6's for uids "
                                 f"{bad}")
        summary = eng.paging_summary()
        pager = eng.pager
        nt = len(ticks)
        got = dict(ticks=nt, tick_ms=m["serving"].metrics.quantiles(
                       [t * 1e3 for t in ticks]),
                   exposed_ms_a_tick=summary["exposed_s"] / nt * 1e3,
                   hidden_ms_a_tick=summary["hidden_s"] / nt * 1e3,
                   crc_s=summary["crc_s"], copy_s=summary["copy_s"],
                   wire_bytes=summary["bytes_streamed_wire"],
                   decode_s=summary["decode_s"],
                   decode_skipped_bytes=summary["decode_skipped_bytes"])
        if mesh is not None:
            pred = pager.predict()
            if (pred["swaps"], pred["misses"], pred["bytes_wire"],
                    pred["bytes_raw"]) != (
                    summary["swap_count"], summary["miss_count"],
                    summary["bytes_streamed_wire"],
                    summary["bytes_streamed_raw"]):
                raise AssertionError(f"mesh counters {summary} differ from "
                                     f"predict() {pred}")
            if summary["decode_s"] != 0.0 or \
                    summary["decode_skipped_bytes"] <= 0:
                raise AssertionError(f"wire-serve decoded on the host: "
                                     f"{summary}")
            got.update(predicted=pred, links=link_rows(summary["devices"]),
                       pages_a_link=[len(s.pages) for s in pager.stores],
                       page_bytes_a_link=[sum(p.nbytes for p in s.pages)
                                          for s in pager.stores],
                       shard_axes=sorted(pager.shard_axes))
        pager.close()
        return got, launches, split

    one, _, _ = serve()
    with recording(torch, m["ops"]) as seen_b:
        four, launches_b, split_b = serve(mesh)
    expect_launched(launches_b, MESH_WIRE_KERNELS,
                    "the wire-served store on four links")
    if four["wire_bytes"] != one["wire_bytes"]:
        raise AssertionError(f"four links moved {four['wire_bytes']} wire "
                             f"B, one link {one['wire_bytes']}")
    budget = int(max(four["page_bytes_a_link"]) * MESH_POOL_SHARE
                 ) * MESH_LINKS
    pooled, _, _ = serve(mesh, budget)
    pred = pooled["predicted"]
    if pred["pool_hits"] <= 0 or pred["swaps"] <= sum(
            pooled["pages_a_link"]):
        raise AssertionError(f"the per-link pools ({budget // MESH_LINKS} B "
                             f"each) hold all or none of a link's pages: "
                             f"{pred}")
    out["wire"] = dict(launches={k: launches_b[k] for k in lm},
                       launches_by_class=split_b, page_bytes=page_bytes,
                       one_link=one, mesh=four,
                       pooled=dict(pooled, budget_bytes=budget))
    print(f"[mesh] (b) phase 6's wire-served store, tokens equal to phase "
          f"6's single-link serve on one link, on {MESH_LINKS} links and on "
          f"{MESH_LINKS} links with {budget // MESH_LINKS} B pools; counters "
          f"on predict(); readings ({m['card']}): {json.dumps(out['wire'])}")
    for what, part in (("(a) launcher", out["launcher"]),
                       ("(b) wire-served", out["wire"])):
        print(f"[mesh] {what}: tick p50 {part['mesh']['tick_ms']['p50']:.2f}"
              f" ms on {MESH_LINKS} links, "
              f"{part['one_link']['tick_ms']['p50']:.2f} ms on one; exposed "
              f"/ hidden page wait a tick "
              f"{part['mesh']['exposed_ms_a_tick']:.2f} / "
              f"{part['mesh']['hidden_ms_a_tick']:.2f} ms on {MESH_LINKS} "
              f"links, {part['one_link']['exposed_ms_a_tick']:.2f} / "
              f"{part['one_link']['hidden_ms_a_tick']:.2f} on one; per link "
              f"{json.dumps(part['mesh']['links'])} ({m['card']})")
    calls = {k: list(dict.fromkeys(seen_a[k] + seen_b[k])) for k in seen_a}
    out["path_check"] = check_path(torch, m["ops"], m["ref"], qmm, fa,
                                   m["ssm"], dev, f"{MESH_ARCH} mesh", calls)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[mesh] phase 16 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: multi-rank training (ROADMAP A11 (b)), the compute split over
# "model" as the reference's GSPMD splits it.  DIST_WORLD ranks, the
# processes of one gloo process group (parallel/distributed.run_ranks), all
# on the one card: the collectives go through the host.  Training runs no
# Hopper kernel, as in phases 10 and 13.
# ---------------------------------------------------------------------------

DIST_ARCH = "qwen3-0.6b"
DIST_WORLD = 4
# (a) AdamW and (b) Adafactor on a (2, 2) ("data", "model") mesh, each
# against one rank's make_train_step from the same weights and batches.
# 8 of qwen3-0.6b's 28 layers: at 28 the phase took 222-272 s on an H100
# (the collectives through the host bind), and the script keeps within
# its 1,200 s
DIST_TRAIN = dict(mesh=(2, 2), layers=8, batch=4, seq=256, lr=3e-4,
                  steps={"adamw": 3, "adafactor": 2})
# the reference's tolerances (tests/test_multidevice.py:144-149)
DIST_LOSS_TOL = 1e-4
DIST_LEAF_TOL = dict(rtol=2e-3, atol=2e-3)
# a first AdamW step moves an element by about lr whatever its gradient,
# below DIST_LEAF_TOL: each step's global gradient norm (before the clip)
# is also held to one rank's, relative, and each leaf's change over the
# steps to one rank's change, in norm
DIST_GNORM_RTOL = 1e-4
DIST_DELTA_RTOL = 0.05
# (c) the int8 compressed all-reduce of one row a rank, error feedback
DIST_COMPRESS = dict(shape=(DIST_WORLD, 1 << 20), rounds=8)
# (d) GPipe: tanh(x @ w) a stage, one stage a rank
DIST_PIPE = dict(width=1024, batch=64, microbatches=8, tol=2e-4)
# (e) (a)'s state saved from (2, 2) and restored onto these meshes; then
# Trainer(shardings=) at cut depth with a failure injected, under Adafactor
# (its checkpoints a third of AdamW's bytes: each save is a gather)
DIST_ELASTIC = ((4, 1), (1, 4))
DIST_TRAINER = dict(layers=2, steps=4, every=2, fail_at=2, opt="adafactor")
DIST_TIMEOUT_S = 900
DIST_CKPT = ROOT / "build" / "dist_ckpt"
# (f) the reference's train cell with a MoE (launch/steps.py:204-225: bf16
# weights, Adafactor for a large model, dp axes on a mesh, moe_groups 0,
# so each MoE layer routes the whole batch's tokens, gathered over "data"):
# qwen2-moe-a2.7b at full width, 1 of its 24 layers, on a (2, 2) mesh of 4
# ranks (its 60 experts expert-parallel over "model", each model row's 30
# split again over "data": 15 a rank), each step against rank 0's
# single-rank step from the same state; 1 step (the leg took 48.6-59.9 s
# at 2 steps on (2, 1), most of it the collectives)
DIST_MOE = dict(arch="qwen2-moe-a2.7b", world=4, mesh=(2, 2), layers=1,
                batch=4, seq=128, steps=1, opt="adafactor", lr=3e-4)
# (f)'s routed experts, forward and backward, as every rank of the gathered
# route ran them before its dp ranks split the experts (all 60 experts'
# slots of the batch; measured on an NVIDIA H100 80GB HBM3 at 700 W)
GATHERED_EXPERTS_MS = 6.46
# bf16 against one rank: a rank rounds its bf16 gradient before the dp sum
# adds the other's, where one rank rounds the whole batch's sum once (the
# CPU tests: 1.3e-4 in the global norm), and the two ranks' rows go
# through the card's matmuls in other shapes than one rank's
DIST_BF16_LOSS_RTOL = 1e-3
DIST_BF16_GNORM_RTOL = 5e-3


def dist_modules():
    """The port's modules a rank of phase 17 uses."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import dist_steps, steps
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adafactor, adamw
    from repro_torch.parallel import compress, distributed, pipeline
    from repro_torch.parallel import sharding
    from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig

    return dict(dist=dist, CheckpointManager=CheckpointManager,
                get_config=get_config, tree=tree,
                SyntheticLMDataset=SyntheticLMDataset, steps=steps,
                make_rank_mesh=make_rank_mesh, moe=moe, tfm=tfm,
                opts=dict(adamw=adamw, adafactor=adafactor),
                compress=compress, D=distributed, DS=dist_steps,
                pipeline=pipeline,
                shd=sharding, FailureInjector=FailureInjector,
                Trainer=Trainer, TrainerConfig=TrainerConfig)


def dist_sharded_state(torch, m, cfg, opt, mesh, dev):
    """``cfg``'s weights drawn from seed 0 on ``dev`` (the same on every
    rank) and ``opt``'s state, whole, their specs on ``mesh``, and their
    shard trees."""
    shd, D = m["shd"], m["D"]
    params = m["tfm"].init_params(cfg, torch.Generator(device=dev)
                                  .manual_seed(0), device=dev)
    state = opt.init(params)
    specs = (shd.param_shardings(params, mesh),
             shd.opt_state_shardings(state, mesh, params))
    return (params, state), specs, (D.shard_tree(params, specs[0], mesh),
                                    D.shard_tree(state, specs[1], mesh))


def dist_train_leg(torch, m, cfg, name, dev):
    """(a) / (b): ``name``'s steps on the (2, 2) rank mesh against one
    rank's.  Rank 0 runs the single-rank steps first (the others wait);
    then every rank runs the sharded steps.  Checks each loss, every
    gathered leaf, the bytes a rank holds and the tensors' device.
    Returns the readings and the sharded state."""
    import gc as gc_

    dist, D, T = m["dist"], m["D"], m["tree"]
    f = DIST_TRAIN
    rank = dist.get_rank()
    mesh = m["make_rank_mesh"](f["mesh"], ("data", "model"), dev)
    opt = m["opts"][name]()
    whole, specs, (sp, so) = dist_sharded_state(torch, m, cfg, opt, mesh,
                                                dev)
    want = (m["D"].spec_bytes(whole[0], specs[0], mesh)
            + m["D"].spec_bytes(whole[1], specs[1], mesh))
    ds = m["SyntheticLMDataset"](cfg.vocab_size, f["seq"], f["batch"],
                                 seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                ds.batch(i).items()} for i in range(f["steps"][name])]
    single = dict(losses=[], grad_norms=[], step_s=[])
    ref_params = start = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if rank == 0:
        step1 = m["steps"].make_train_step(cfg, opt, lr=f["lr"])
        p, o = whole
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, met = step1(p, o, b)
            single["losses"].append(float(met["loss"]))
            torch.cuda.synchronize()
            single["step_s"].append(time.perf_counter() - t0)
            single["grad_norms"].append(float(met["grad_norm"]))
        ref_params = p
        start = [x.cpu() for x in T.leaves(whole[0])]   # off the card
        del o
        single["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del whole
    gc_.collect()
    torch.cuda.empty_cache()
    D.barrier()
    torch.cuda.reset_peak_memory_stats()
    step = m["DS"].make_distributed_train_step(cfg, opt, mesh, lr=f["lr"])
    sharded = dict(losses=[], grad_norms=[], step_s=[], comm=[])
    for b in batches:
        D.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp, so, met = step(sp, so, b)
        sharded["losses"].append(float(met["loss"]))
        torch.cuda.synchronize()
        sharded["step_s"].append(time.perf_counter() - t0)
        sharded["grad_norms"].append(float(met["grad_norm"]))
        sharded["comm"].append(met["comm"])
    sharded["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    held = D.held_bytes(sp) + D.held_bytes(so)
    if held != want:
        raise AssertionError(f"rank {rank} holds {held} B of {name}'s "
                             f"params and state; the specs give {want}")
    # the compute split over "model": every layer linear on its block, the
    # rank's multiply-adds one device's over dp * M, the logits its vocab
    # block, attention by heads
    c, (dp, mm) = sharded["comm"][-1], f["mesh"]
    logits = (f["batch"] // dp, f["seq"], cfg.vocab_size // mm)
    if (c["linears_whole"] or c["attention_whole"]
            or c["layer_macs"] * dp * mm != c["layer_macs_one_device"]
            or tuple(c["logits"]) != logits):
        raise AssertionError(f"rank {rank}: {name}'s step is not split over "
                             f"\"model\" ({c}; logits {logits} expected)")
    off = [leaf.to_local().device.type for leaf in T.leaves(dict(p=sp,
                                                                 o=so))
           if leaf.to_local().device.type != dev.type]
    if off:
        raise AssertionError(f"rank {rank}: {len(off)} shards off "
                             f"{dev.type} ({set(off)})")
    # every leaf gathered (a collective); rank 0 holds it, and its change
    # from the start, against its own
    worst, worst_delta, n_leaves = 0.0, 0.0, 0
    ref_flat = T.leaves(ref_params) if rank == 0 else None
    for i, leaf in enumerate(T.leaves(sp)):
        got = D.gather(leaf)
        if rank == 0:
            want_leaf = ref_flat[i]
            if not torch.allclose(got, want_leaf, **DIST_LEAF_TOL):
                raise AssertionError(
                    f"{name}: param leaf {i} after {len(batches)} steps on "
                    f"{DIST_WORLD} ranks vs one: max abs err "
                    f"{(got - want_leaf).abs().max().item()}")
            worst = max(worst, (got - want_leaf).abs().max().item())
            x0 = start[i].to(dev)
            moved = torch.linalg.vector_norm(want_leaf - x0).item()
            apart = torch.linalg.vector_norm(got - want_leaf).item()
            if not apart <= DIST_DELTA_RTOL * moved:
                raise AssertionError(
                    f"{name}: param leaf {i} moved {moved} from the start on "
                    f"one rank; the {DIST_WORLD} ranks' result is {apart} "
                    "away from it")
            worst_delta = max(worst_delta, apart / max(moved, 1e-30))
            n_leaves += 1
            del x0
        del got
    if rank == 0:
        errs = [abs(a - b) for a, b in zip(sharded["losses"],
                                           single["losses"])]
        if not max(errs) < DIST_LOSS_TOL:
            raise AssertionError(f"{name} losses on {DIST_WORLD} ranks "
                                 f"{sharded['losses']} vs one "
                                 f"{single['losses']}")
        gerrs = [abs(a - b) / b for a, b in zip(sharded["grad_norms"],
                                                single["grad_norms"])]
        if not max(gerrs) <= DIST_GNORM_RTOL:
            raise AssertionError(f"{name} gradient norms on {DIST_WORLD} "
                                 f"ranks {sharded['grad_norms']} vs one "
                                 f"{single['grad_norms']}")
        single.update(loss_abs_err=errs, leaf_max_abs_err=worst,
                      gnorm_rel_err=max(gerrs), delta_rel_err=worst_delta,
                      leaves=n_leaves)
    del ref_params, start
    gc_.collect()
    torch.cuda.empty_cache()
    return dict(single=single if rank == 0 else None, sharded=sharded,
                held_bytes=held, spec_bytes=want), (sp, so)


def dist_compress_leg(torch, m, dev):
    """(c) ``int8_allreduce`` / ``compressed_allreduce_mean`` of one row a
    rank: the int32 totals and the scale equal the CPU's arithmetic on the
    same rows, the mean is within absmax / 127 of the exact one, and 8
    rounds of error feedback do not grow the error."""
    C, D = m["compress"], m["D"]
    mesh = m["make_rank_mesh"]((DIST_WORLD,), ("data",), dev)
    group = mesh.group("data")
    r = mesh.coordinate()["data"]
    g = torch.randn(DIST_COMPRESS["shape"], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total, scale = C.int8_allreduce(g[r], group)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = g.cpu()
    scale_c = torch.clamp(host.abs().max() / torch.tensor(127.0), min=1e-12)
    total_c = torch.clamp(torch.round(host / scale_c), -127, 127).to(
        torch.int32).sum(0, dtype=torch.int32)
    if not (torch.equal(total.cpu(), total_c)
            and torch.equal(scale.cpu(), scale_c)):
        raise AssertionError(
            "int8 all-reduce: the card's int32 totals differ from the CPU's "
            f"in {(total.cpu() != total_c).sum().item()} places (scale "
            f"{scale.item()} vs {scale_c.item()})")
    expect = g.mean(0)
    bound = host.abs().max().item() / 127 + 1e-6
    err = (C.compressed_allreduce_mean(g[r], group) - expect).abs().max()
    if not err.item() <= bound:
        raise AssertionError(f"compressed mean max abs err {err.item()} "
                             f"above absmax / 127 = {bound}")
    res = torch.zeros_like(g[r])
    acc = torch.zeros_like(g[r])
    errs = []
    for it in range(DIST_COMPRESS["rounds"]):
        out, new_r = C.with_error_feedback(dict(g=g[r]), dict(g=res), group)
        acc += out["g"]
        res = new_r["g"]
        errs.append((acc / (it + 1) - expect).abs().max().item())
    if not errs[-1] <= errs[0] + 1e-9:
        raise AssertionError(f"error feedback grew the error: {errs}")
    return dict(shape=list(DIST_COMPRESS["shape"]), max_abs_err=err.item(),
                bound=bound, feedback_errs=errs, int8_allreduce_s=wall,
                int32_bytes=total.numel() * 4)


def dist_pipe_leg(torch, m, dev):
    """(d) ``pipelined_apply`` of ``tanh(x @ w)`` over a stage a rank,
    the stage weights a DTensor sharded over "stage", against the
    sequential layers on the card."""
    D, P = m["D"], m["pipeline"]
    f = DIST_PIPE
    mesh = m["make_rank_mesh"]((DIST_WORLD,), ("stage",), dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    w = f["width"]
    ws = torch.randn((DIST_WORLD, w, w), generator=gen, device=dev) / w**0.5
    x = torch.randn((f["batch"], w), generator=gen, device=dev)
    layer = lambda x, w: torch.tanh(x @ w)
    fn = P.pipelined_apply(layer, mesh, "stage", f["microbatches"])
    sharded_ws = D.shard(ws, m["shd"].P("stage"), mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(x, sharded_ws)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = x
    for i in range(DIST_WORLD):
        ref = layer(ref, ws[i])
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, rtol=f["tol"], atol=f["tol"]):
        raise AssertionError(f"pipeline vs sequential max abs err {err}")
    return dict(max_abs_err=err, wall_s=wall,
                bubble=P.bubble_fraction(DIST_WORLD, f["microbatches"]))


def dist_elastic_leg(torch, m, sp, so, dev, ckpt):
    """(e) (a)'s sharded params and AdamW state saved from (2, 2) and
    restored onto each of DIST_ELASTIC: every rank's restored block equal
    bit for bit to that block of the (2, 2) state gathered whole."""
    import shutil

    D, T, shd = m["D"], m["tree"], m["shd"]
    rank = m["dist"].get_rank()
    mgr = m["CheckpointManager"](ckpt, async_save=False)
    tmpl = dict(params=sp, opt_state=so)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(0, tmpl)
    mgr.wait()
    save_s = time.perf_counter() - t0
    restored, restore_s = [], []
    for shape in DIST_ELASTIC:
        mesh = m["make_rank_mesh"](shape, ("data", "model"), dev)
        shardings = dict(
            params=D.named_shardings(shd.param_shardings(sp, mesh), sp,
                                     mesh),
            opt_state=D.named_shardings(shd.opt_state_shardings(so, mesh,
                                                                sp), so,
                                        mesh))
        t0 = time.perf_counter()
        step, st = mgr.restore(tmpl, shardings=shardings)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t0)
        restored.append(T.leaves(st))
    n = 0
    for i, leaf in enumerate(T.leaves(tmpl)):
        whole = D.gather(leaf)
        for shape, flat in zip(DIST_ELASTIC, restored):
            b = flat[i]
            if not torch.equal(b.to_local(), D.block_of(whole, b.device_mesh,
                                                      b.placements)):
                raise AssertionError(f"rank {rank}: leaf {i} restored onto "
                                     f"{shape} differs from the saved state")
        n += 1
    D.barrier()
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    return dict(leaves=n, meshes=[list(s) for s in DIST_ELASTIC],
                save_s=save_s, restore_s=restore_s)


def dist_trainer_leg(torch, m, cfg, dev, ckpt):
    """(e) ``Trainer(shardings=)`` with the sharded step at
    DIST_TRAINER['layers'] full-width layers: a run with a failure injected
    against an uninterrupted one; restarts 0 and 1, and every rank's
    blocks of the final params and state equal bit for bit."""
    import shutil

    D, T, shd = m["D"], m["tree"], m["shd"]
    f, g = DIST_TRAINER, DIST_TRAIN
    tcfg = cfg.replace(n_layers=f["layers"])
    mesh = m["make_rank_mesh"](g["mesh"], ("data", "model"), dev)
    opt = m["opts"][f["opt"]]()

    def init_state():
        _, _, (p, o) = dist_sharded_state(torch, m, tcfg, opt, mesh, dev)
        return dict(params=p, opt_state=o)

    tmpl = init_state()
    specs = dict(params=shd.param_shardings(tmpl["params"], mesh),
                 opt_state=shd.opt_state_shardings(tmpl["opt_state"], mesh,
                                                   tmpl["params"]))
    shardings = {k: D.named_shardings(specs[k], tmpl[k], mesh)
                 for k in tmpl}
    del tmpl
    runs = {}
    for name, fail in (("clean", []), ("crashed", [f["fail_at"]])):
        path = Path(ckpt) / name
        t0 = time.perf_counter()
        out = m["Trainer"](
            m["TrainerConfig"](total_steps=f["steps"],
                               checkpoint_every=f["every"],
                               checkpoint_dir=str(path), log_every=100),
            m["DS"].make_distributed_train_step(tcfg, opt, mesh, lr=g["lr"]),
            init_state, m["SyntheticLMDataset"](tcfg.vocab_size, g["seq"],
                                                g["batch"], seed=0),
            failure_injector=m["FailureInjector"](fail), device=dev,
            shardings=shardings).run()
        out["wall_s"] = time.perf_counter() - t0
        runs[name] = out
    D.barrier()
    if m["dist"].get_rank() == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    if runs["clean"]["restarts"] != 0 or runs["crashed"]["restarts"] != 1:
        raise AssertionError(f"restarts clean {runs['clean']['restarts']}, "
                             f"crashed {runs['crashed']['restarts']}")
    a, b = (T.leaves(dict(p=runs[k]["params"], o=runs[k]["opt_state"]))
            for k in ("clean", "crashed"))
    unequal = [i for i, (x, y) in enumerate(zip(a, b))
               if not torch.equal(x.to_local(), y.to_local())]
    if unequal:
        raise AssertionError(f"the restarted run's leaves {unequal[:4]} "
                             "differ from the uninterrupted run's")
    return dict(layers=f["layers"], opt=f["opt"], steps=f["steps"],
                fail_at=f["fail_at"],
                restarts=runs["crashed"]["restarts"], leaves_equal=len(a),
                steps_run=[x["step"] for x in runs["crashed"]["metrics"]],
                wall_s=[runs[k]["wall_s"] for k in ("clean", "crashed")])


def dist_rank(ckpt: str, layers: int, device: str = "cuda"):
    """One rank of phase 17 (``run_ranks`` starts it): (a)-(e) in turn at
    ``layers`` full-width layers, under deterministic algorithms (the
    restart leg's bit-equality needs them; every rank is a fresh process,
    so no other phase is touched).  Returns the rank's readings."""
    import os

    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = dist_modules()
    dev = torch.device(device)
    cfg = m["get_config"](DIST_ARCH).replace(n_layers=layers)
    t0 = time.perf_counter()
    out = dict(rank=m["dist"].get_rank(), layers=cfg.n_layers)
    out["adamw"], (sp, so) = dist_train_leg(torch, m, cfg, "adamw", dev)
    out["elastic"] = dist_elastic_leg(torch, m, sp, so, dev,
                                      str(Path(ckpt) / "elastic"))
    del sp, so
    out["adafactor"], _ = dist_train_leg(torch, m, cfg, "adafactor", dev)
    out["compress"] = dist_compress_leg(torch, m, dev)
    out["pipeline"] = dist_pipe_leg(torch, m, dev)
    out["trainer"] = dist_trainer_leg(torch, m, cfg, dev,
                                      str(Path(ckpt) / "trainer"))
    out["staged"] = dict(m["D"].STAGED)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["wall_s"] = time.perf_counter() - t0
    return out


def expert_share_cost(torch, m, cfg, params, dev, mesh):
    """ROADMAP C22, closed: one MoE layer's routed experts, forward and
    backward on the card over the whole batch's gathered tokens, as a rank
    runs them now (its share, E / (dp * M) experts' slots, through
    ``moe._routed_blocks``) and as every rank ran them before the split
    (all E experts' slots, ``moe._routed``); the medians of 3 on the host
    clock, synchronised, no collective inside."""
    moe, D = m["moe"], m["D"]
    p = {k: params["layers"]["moe"][k][0]
         for k in ("router", "w_gate", "w_up", "w_down")}
    parts = mesh[0] * mesh[1]
    n = cfg.n_experts // parts
    axis = D.ModelAxis(None, dev)
    share = dict(p, **{k: D.ModelBlock(p[k][:n], 0, axis)
                       for k in ("w_gate", "w_up", "w_down")})
    kw = dict(n_experts=cfg.n_experts, k=cfg.n_experts_active,
              capacity_factor=cfg.capacity_factor, act=cfg.mlp_act,
              groups=1, engine=dict(dp_axes=("data",)))
    tokens = DIST_MOE["batch"] * DIST_MOE["seq"]
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((tokens, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    out = dict(tokens=tokens, share_experts=n, experts=cfg.n_experts)
    for name, fn in (("share", lambda: moe._routed_blocks(
            x, share, rows=None, **kw)), ("all", lambda: moe._routed(
                x, p, **kw))):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn().float().sum().backward()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[f"{name}_ms"] = sorted(times[1:])[1] * 1e3
    out["share_slots"] = axis.stats["expert_slots"] // 4
    return out


def dist_moe_rank(device: str = "cuda"):
    """One rank of phase 17 (f): DIST_MOE's sharded steps, every rank's
    router top-k noted; then rank 0 takes one rank's step from each step's
    starting state (gathered) and holds the sharded step to it: the loss,
    the global gradient norm, every leaf (DIST_LEAF_TOL) and each route
    call's top-k indices, equal, else the phase fails with the count of
    tokens whose experts differ.  Returns the rank's readings."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = dist_modules()
    dist, D, T = m["dist"], m["D"], m["tree"]
    dev = torch.device(device)
    f = DIST_MOE
    rank = dist.get_rank()
    t_leg = time.perf_counter()
    cfg = m["get_config"](f["arch"]).replace(
        n_layers=f["layers"], dtype="bfloat16", moe_groups=0)
    mesh = m["make_rank_mesh"](f["mesh"], ("data", "model"), dev)
    opt = m["opts"][f["opt"]]()
    whole, specs, (sp, so) = dist_sharded_state(torch, m, cfg, opt, mesh,
                                                dev)
    n_params = sum(x.numel() for x in T.leaves(whole[0]))
    want = (D.spec_bytes(whole[0], specs[0], mesh)
            + D.spec_bytes(whole[1], specs[1], mesh))
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    ds = m["SyntheticLMDataset"](cfg.vocab_size, f["seq"], f["batch"],
                                 seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                ds.batch(i).items()} for i in range(f["steps"])]
    step = m["DS"].make_distributed_train_step(cfg, opt, mesh, lr=f["lr"])
    starts, routes = [], []
    sharded = dict(losses=[], grad_norms=[], step_s=[], comm=[])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for b in batches:
        st = (D.gather_tree(sp), D.gather_tree(so))
        if rank == 0:
            starts.append(st)
        del st
        D.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_routes(m) as r:
            sp, so, met = step(sp, so, b)
            sharded["losses"].append(float(met["loss"]))
        torch.cuda.synchronize()
        sharded["step_s"].append(time.perf_counter() - t0)
        sharded["grad_norms"].append(float(met["grad_norm"]))
        sharded["comm"].append(met["comm"])
        routes.append(r)
    sharded["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    held = D.held_bytes(sp) + D.held_bytes(so)
    if held != want:
        raise AssertionError(f"rank {rank} holds {held} B of the MoE's "
                             f"params and state; the specs give {want}")
    # C22 closed: the rank runs 1 / (dp * M) of one device's expert slots
    c = sharded["comm"][-1]
    if (c["expert_slots"] * f["world"] != c["expert_slots_one_device"]
            or c["linears_whole"]):
        raise AssertionError(f"rank {rank}: (f)'s experts are not split "
                             f"over the ranks ({c})")
    final = D.gather_tree(sp)
    out = dict(rank=rank, sharded=sharded, held_bytes=held, params=n_params,
               layers=cfg.n_layers)
    if rank == 0:
        step1 = m["steps"].make_train_step(cfg, opt, lr=f["lr"])
        ends = [s[0] for s in starts[1:]] + [final]
        single = dict(losses=[], grad_norms=[], step_s=[])
        worst, worst_delta, flips, calls, tokens = 0.0, 0.0, 0, 0, 0
        for k, b in enumerate(batches):
            p0, s0 = starts[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorded_routes(m) as r1:
                p1, _, met = step1(p0, s0, b)
                single["losses"].append(float(met["loss"]))
            torch.cuda.synchronize()
            single["step_s"].append(time.perf_counter() - t0)
            single["grad_norms"].append(float(met["grad_norm"]))
            if len(r1) != len(routes[k]):
                raise AssertionError(f"step {k}: {len(routes[k])} route calls "
                                     f"on the ranks, {len(r1)} on one")
            for a, c in zip(routes[k], r1):
                flips += int((a != c).any(-1).sum())
                calls += 1
                tokens += int(c.shape[0])
            for i, (a, c, a0) in enumerate(zip(
                    T.leaves(ends[k]), T.leaves(p1), T.leaves(p0))):
                a, c, a0 = a.float(), c.float(), a0.float()
                err = (a - c).abs().max().item()
                if not torch.allclose(a, c, **DIST_LEAF_TOL):
                    raise AssertionError(f"(f) step {k} leaf {i}: max abs "
                                         f"err {err} against one rank")
                worst = max(worst, err)
                worst_delta = max(worst_delta, (
                    torch.linalg.vector_norm(a - c)
                    / torch.linalg.vector_norm(c - a0).clamp(min=1e-30)
                ).item())
            del p1
        if flips:
            raise AssertionError(
                f"(f): {flips} gathered tokens' top-{cfg.n_experts_active} "
                f"experts differ between the ranks and one rank over "
                f"{calls} route calls")
        errs = [abs(a - c) / abs(c) for a, c in zip(sharded["losses"],
                                                     single["losses"])]
        gerrs = [abs(a - c) / c for a, c in zip(sharded["grad_norms"],
                                                 single["grad_norms"])]
        if not max(errs) <= DIST_BF16_LOSS_RTOL:
            raise AssertionError(f"(f) losses {sharded['losses']} on the "
                                 f"ranks vs {single['losses']} on one")
        if not max(gerrs) <= DIST_BF16_GNORM_RTOL:
            raise AssertionError(f"(f) gradient norms "
                                 f"{sharded['grad_norms']} vs "
                                 f"{single['grad_norms']}")
        single.update(loss_rel_err=max(errs), gnorm_rel_err=max(gerrs),
                      leaf_max_abs_err=worst, delta_rel=worst_delta,
                      route_calls=calls, tokens_routed=tokens)
        out["single"] = single
        del starts, ends
        gc.collect()
        torch.cuda.empty_cache()
        out["expert_share"] = expert_share_cost(torch, m, cfg, final, dev,
                                                f["mesh"])
    del final
    out["wall_s"] = time.perf_counter() - t_leg
    return out


def comm_split(c) -> str:
    """A rank's ``metrics["comm"]`` of one step: the dp weight gathers, the
    dp gradient reduces, the model-axis activation collectives (host
    clock) and the rank's share of the layer compute."""
    return (f"dp weight gathers {c['gather_bytes'] / 1e9:.3f} GB in "
            f"{c['gather_s']:.3f} s ({c['layer_gathers']} layer gathers, at "
            f"most {c['layers_alive_max']} layers' gathered leaves alive at "
            f"once), dp gradient reduces {c['reduce_bytes'] / 1e9:.3f} GB "
            f"in "
            f"{c['reduce_s']:.3f} s, model-axis activation collectives "
            f"{c['act_calls']} calls, {c['act_bytes'] / 1e9:.3f} GB in "
            f"{c['act_s']:.3f} s (a rank, host clock); layer linears on a "
            f"block {c['linears_block']}, whole {c['linears_whole']}; "
            f"attention by heads {c['attention_split']}, whole "
            f"{c['attention_whole']}; the rank's layer multiply-adds "
            f"{c['layer_macs'] / 1e9:.3f} G against one device's "
            f"{c['layer_macs_one_device'] / 1e9:.3f} G (x"
            f"{c['layer_macs'] / max(c['layer_macs_one_device'], 1):.4f}); "
            f"expert slots {c['expert_slots']} of one device's "
            f"{c['expert_slots_one_device']}; logits a rank {c['logits']}; "
            f"gathered whole over \"model\": {c['over_model']}")


def dist_train_phase(torch, card: str, layers: int = DIST_TRAIN["layers"]):
    """Phase 17: :func:`dist_rank` on DIST_WORLD ranks of the one card.
    A rank that fails or outlives DIST_TIMEOUT_S fails the phase."""
    from repro_torch.parallel.distributed import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(dist_rank, DIST_WORLD, str(DIST_CKPT), layers,
                      timeout_s=DIST_TIMEOUT_S)
    wall_4 = time.perf_counter() - t0
    moe_ranks = run_ranks(dist_moe_rank, DIST_MOE["world"],
                          timeout_s=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for name in ("adamw", "adafactor"):
        s, d = r0[name]["single"], r0[name]["sharded"]
        c = d["comm"][-1]
        print(f"[dist] ({'a' if name == 'adamw' else 'b'}) {DIST_ARCH} "
              f"{r0['layers']} layers at full width, {name}, batch "
              f"{DIST_TRAIN['batch']} x {DIST_TRAIN['seq']}, on a "
              f"{DIST_TRAIN['mesh']} mesh of {DIST_WORLD} gloo ranks vs one "
              f"rank: losses {[round(x, 6) for x in d['losses']]} vs "
              f"{[round(x, 6) for x in s['losses']]} (abs err "
              f"{max(s['loss_abs_err']):.2e}, tolerance {DIST_LOSS_TOL}); "
              f"gradient norms {[round(x, 6) for x in d['grad_norms']]} "
              f"(relative err {s['gnorm_rel_err']:.2e}, tolerance "
              f"{DIST_GNORM_RTOL}); {s['leaves']} leaves within "
              f"{DIST_LEAF_TOL} (worst {s['leaf_max_abs_err']:.2e}), each "
              f"leaf's change within {DIST_DELTA_RTOL} of one rank's in norm "
              f"(worst {s['delta_rel_err']:.2e}); step {d['step_s'][-1]:.3f} s "
              f"on {DIST_WORLD} ranks, {s['step_s'][-1]:.3f} s on one; the "
              f"last step's {comm_split(c)}; held bytes "
              f"{[r[name]['held_bytes'] for r in ranks]} = the specs'; peak "
              f"device memory a rank "
              f"{[round(r[name]['sharded']['peak_gib'], 2) for r in ranks]}"
              f" GiB, one rank's {s['peak_gib']:.2f} GiB; {card}")
    c, p, e, t = (r0[k] for k in ("compress", "pipeline", "elastic",
                                  "trainer"))
    print(f"[dist] (c) int8 all-reduce of {c['shape']} f32 rows, one a "
          f"rank: int32 totals and scale equal the CPU's, mean max abs err "
          f"{c['max_abs_err']:.3e} <= absmax / 127 = {c['bound']:.3e}; "
          f"error feedback over {len(c['feedback_errs'])} rounds "
          f"{c['feedback_errs'][0]:.3e} -> {c['feedback_errs'][-1]:.3e}; "
          f"{c['int32_bytes'] / 1e6:.1f} MB of int32 in "
          f"{c['int8_allreduce_s']:.3f} s; (d) pipeline of {DIST_WORLD} "
          f"stages x {DIST_PIPE['microbatches']} microbatches at width "
          f"{DIST_PIPE['width']}: max abs err {p['max_abs_err']:.2e} "
          f"(tolerance {DIST_PIPE['tol']}), {p['wall_s']:.3f} s, bubble "
          f"{p['bubble']:.3f}; (e) {e['leaves']} leaves of (a)'s state "
          f"saved from {DIST_TRAIN['mesh']} in {e['save_s']:.1f} s, restored "
          f"onto {e['meshes']} in {[round(x, 1) for x in e['restore_s']]} s,"
          f" bit-equal; Trainer ({t['opt']}) at {t['layers']} layers, "
          f"failure at step "
          f"{t['fail_at']}: restarts {t['restarts']}, steps run "
          f"{t['steps_run']}, {t['leaves_equal']} leaves bit-equal to the "
          f"uninterrupted run's; staged through the host "
          f"{ranks[0]['staged']}; 4 ranks {wall_4:.1f} s; {card}")
    f, r0 = DIST_MOE, moe_ranks[0]
    s, d = r0["single"], r0["sharded"]
    c = d["comm"][-1]
    x = r0["expert_share"]
    print(f"[dist] (f) {f['arch']} {r0['layers']} layer at full width "
          f"({r0['params'] / 1e9:.3f} B parameters), dtype bfloat16, "
          f"moe_groups 0 (the gathered route), {f['opt']}, batch "
          f"{f['batch']} x {f['seq']}, on a {f['mesh']} mesh of "
          f"{f['world']} gloo ranks, each step vs one rank's from the same "
          f"state: losses {[round(v, 6) for v in d['losses']]} vs "
          f"{[round(v, 6) for v in s['losses']]} (relative "
          f"{s['loss_rel_err']:.2e}, tolerance {DIST_BF16_LOSS_RTOL}); "
          f"gradient norms {[round(v, 5) for v in d['grad_norms']]} vs "
          f"{[round(v, 5) for v in s['grad_norms']]} (relative "
          f"{s['gnorm_rel_err']:.2e}, tolerance {DIST_BF16_GNORM_RTOL}); "
          f"leaves within {DIST_LEAF_TOL} (worst {s['leaf_max_abs_err']:.2e}"
          f"; a step's change apart by at most {s['delta_rel']:.3f} of it "
          f"in norm); top-k equal in all {s['route_calls']} route calls "
          f"({s['tokens_routed']} gathered tokens); step "
          f"{[round(v, 3) for v in d['step_s']]} s on {f['world']} ranks, "
          f"{[round(v, 3) for v in s['step_s']]} s on one; the last step's "
          f"{comm_split(c)}; peak device memory a rank "
          f"{[round(r['sharded']['peak_gib'], 2) for r in moe_ranks]} GiB; "
          f"C22 closed: one MoE layer's "
          f"routed experts forward and backward over the {x['tokens']} "
          f"gathered tokens, a rank's share ({x['share_experts']} of "
          f"{x['experts']} experts, {x['share_slots']} slots) "
          f"{x['share_ms']:.2f} ms against all {x['experts']} experts' "
          f"{x['all_ms']:.2f} ms (what every rank ran before the split: "
          f"{GATHERED_EXPERTS_MS} ms then); (f) {wall - wall_4:.1f} s, phase "
          f"{wall:.1f} s; {card}")
    return dict(ranks=ranks, moe_ranks=moe_ranks, wall_s=wall, card=card)


# ---------------------------------------------------------------------------
# 18. the dry-run (ROADMAP A12 (d)): cells counted on meta, timed on the card
# ---------------------------------------------------------------------------

# (arch, shape, the kernels its measured run launches) of phase 18: the
# train cell launches none (training runs no Hopper kernel)
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", ()),
                ("qwen3-0.6b", "prefill_32k",
                 ("qmatmul_f32", "flash_attention")),
                ("falcon-mamba-7b", "prefill_32k",
                 ("qmatmul_f32", "selective_scan")),
                ("hymba-1.5b", "long_500k", ("qmatmul_f32", "selective_scan")))
DRYRUN_DIR = ROOT / "build" / "dryrun_results"
# query rows at each end of a flash call too long for the plain version
# (qwen3's 2 x 16 heads x 32,768^2 f32 scores would be 137 GB) held
# against it, the rows' keys all read
DRYRUN_ROWS = 256
DRYRUN_KERNELS = ("qmatmul_f32", "qmatmul_f32_grouped", "flash_attention",
                  "selective_scan")


def _signature(torch, v):
    if isinstance(v, torch.Tensor):
        return ("tensor", tuple(v.shape), str(v.dtype).removeprefix("torch."))
    return v


@contextlib.contextmanager
def recording_signatures(torch, ops):
    """Each distinct call that the model code makes to B1 (plain and
    grouped), B2 and B7 while the block runs: ((each argument's (shape,
    dtype), or itself), sorted keywords), by wrapper; the wrapper runs
    unchanged (``recording``'s stand-ins)."""
    calls = {name: [] for name in DRYRUN_KERNELS}
    saved = {attr: getattr(ops, attr) for attr in ("_qmm", "_fa", "_ssm")}

    def wrap(name, fn):
        def rec(*args, **kw):
            calls[name].append((
                tuple(_signature(torch, a) for a in args),
                tuple(sorted((k, _signature(torch, v))
                             for k, v in kw.items()))))
            return fn(*args, **kw)
        return rec

    for attr, names in (("_qmm", DRYRUN_KERNELS[:2]),
                        ("_fa", DRYRUN_KERNELS[2:3]),
                        ("_ssm", DRYRUN_KERNELS[3:])):
        setattr(ops, attr, _Recorder(saved[attr], {
            n: wrap(n, getattr(saved[attr], n)) for n in names}))
    try:
        yield calls
    finally:
        for attr, mod in saved.items():
            setattr(ops, attr, mod)
    for name in calls:
        calls[name] = list(dict.fromkeys(calls[name]))


def check_dryrun_calls(torch, ops, ref, qmm, fa, ssm, dev, what, calls):
    """Each kernel against its plain version at every distinct call of a
    dry-run cell's measured run, on random inputs of the call's shapes and
    dtypes: B1 whole (QMM_TOL), B7 whole (y to SCAN_TOL, or SCAN_BF16_TOL
    for bf16 inputs; h_last to SCAN_TOL), B2's output at the first and
    last DRYRUN_ROWS query rows, the plain version over those rows and
    every key (FLASH_TOL, or ``flash_bf16_bound`` at bf16)."""
    gen = torch.Generator(device=dev).manual_seed(18)
    worst = dict.fromkeys(calls, 0.0)

    def dt(name):
        return getattr(torch, name)

    def hold(name, got, expect, tol, case):
        torch.cuda.synchronize()
        got, expect = got.float(), expect.float()
        err = (got - expect).abs().max().item() if got.numel() else 0.0
        worst[name] = max(worst[name], err)
        ok = (((got - expect).abs() / tol(expect)).max().item() <= 1
              if callable(tol) else torch.allclose(got, expect, **tol))
        if not ok:
            raise AssertionError(f"[dryrun] {what} {name} {case}: max abs "
                                 f"err {err}")

    for name in ("qmatmul_f32", "qmatmul_f32_grouped"):
        for args, kw in calls[name]:
            kw = dict(kw)
            x_shape, x_dtype = args[0][1:]
            k, n, bits = x_shape[-1], args[1][1][-2], kw["bits"]
            if name == "qmatmul_f32":
                w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
                packed, scale = ops.prep_linear(w, bits)
                del w
            else:
                packed, scale = expert_weights(torch, ops, gen, dev,
                                               x_shape[0], k, n, bits)
            x = torch.randn(x_shape, generator=gen, device=dev).to(
                dt(x_dtype))
            hold(name, getattr(qmm, name)(x, packed, scale, bits=bits,
                                          k_orig=k),
                 getattr(ref, name)(x, packed, scale, bits=bits, k_orig=k),
                 QMM_TOL, f"x {x_shape} {x_dtype} N={n} bits={bits}")
            del packed, scale, x
    for args, kw in calls["flash_attention"]:
        kw = dict(kw)
        q, k, v = (torch.randn(a[1], generator=gen, device=dev).to(
            dt(a[2])) for a in args)
        bf16 = q.dtype == torch.bfloat16
        p_round = kw.get("p_dtype") == torch.bfloat16
        tol = (FLASH_TOL if not bf16 else
               (lambda e, pr=p_round: flash_bf16_bound(e, pr)))
        out = fa.flash_attention(q, k, v, **kw)
        sq, sk = q.shape[2], k.shape[2]
        off = kw.get("q_offset")
        off = sk - sq if off is None else int(off)
        for lo in sorted({0, max(0, sq - DRYRUN_ROWS)}):
            hi = min(sq, lo + DRYRUN_ROWS)
            hold("flash_attention", out[:, :, lo:hi],
                 ref.flash_attention(q[:, :, lo:hi], k, v,
                                     **dict(kw, q_offset=off + lo)),
                 tol, f"q {tuple(q.shape)} {q.dtype} rows {lo}-{hi}")
        del q, k, v, out
    for args, kw in calls["selective_scan"]:
        kw = dict(kw)
        (bsz, s, di), n = args[0][1], args[2][1][1]
        h0 = len(args) > 6 and args[6] is not None
        x, dtv, A, B, C, D, h = scan_inputs(torch, gen, dev, bsz, s, di, n,
                                            h0)
        x, dtv, B, C = (t.to(dt(a[2])) for t, a in zip(
            (x, dtv, B, C), (args[0], args[1], args[3], args[4])))
        y_dtype = kw.get("y_dtype")
        h_in = None if h is None else h.clone()
        y, h_last = ssm.selective_scan(
            x, dtv, A, B, C, D, h_in,
            h_out=h_in if kw.get("h_out") is not None else None,
            y_dtype=y_dtype)
        y_ref, h_ref = ref.selective_scan(x, dtv, A, B, C, D, h,
                                          y_dtype=y_dtype)
        case = f"({bsz}, {s}, {di}) N={n} {x.dtype}"
        hold("selective_scan", y, y_ref,
             SCAN_BF16_TOL if x.dtype == torch.bfloat16 else SCAN_TOL,
             case + " y")
        hold("selective_scan", h_last, h_ref, SCAN_TOL, case + " h_last")
        del x, dtv, B, C, y, y_ref
    torch.cuda.empty_cache()
    return dict(cases={k: len(v) for k, v in calls.items()},
                max_abs_err={k: v for k, v in worst.items() if calls[k]})


def dryrun_phase(torch, m, dev, card: str):
    """Phase 18: ``repro_torch.launch.dryrun.main`` with ``--measure`` on
    each DRYRUN_CELLS cell of the single-pod production mesh: the cell
    counted on ``meta`` as rank 0 of a fake group of 256 ranks, then timed
    on the card at depth 1 and 2.  Fails unless its kernels launched in
    that run, each distinct kernel call holds against its plain version,
    the extrapolated step is at or above the count's roofline bound (its
    compute and memory terms: the fake group's collectives move nothing)
    and the extrapolated peak at or above the rank's argument bytes."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun, report

    ops, ref, qmm, fa, ssm = (m[k] for k in ("ops", "ref", "qmm", "fa",
                                             "ssm"))
    counters = {"qmatmul_f32": qmm.qmatmul_f32,
                "qmatmul_f32_grouped": qmm.qmatmul_f32_grouped,
                "flash_attention": fa.flash_attention,
                "selective_scan": ssm.selective_scan}
    cells = {}
    t_phase = time.perf_counter()
    try:
        for arch, shape, kernels in DRYRUN_CELLS:
            t0 = time.perf_counter()
            by_dtype = {k: dict(f.launches_by_dtype)
                        for k, f in counters.items()}
            zero_launches(counters)
            with recording_signatures(torch, ops) as calls:
                rc = dryrun.main(["--arch", arch, "--shape", shape,
                                  "--measure", "--force", "--dir",
                                  str(DRYRUN_DIR)])
            launches, _ = read_launches(counters)
            if rc:
                raise AssertionError(f"[dryrun] {arch} {shape}: dryrun.main "
                                     f"exited {rc}")
            expect_launched(launches, kernels, f"[dryrun] {arch} {shape}")
            launched_by_dtype = {
                k: {d: n - by_dtype[k].get(d, 0)
                    for d, n in f.launches_by_dtype.items()
                    if n > by_dtype[k].get(d, 0)}
                for k, f in counters.items()}
            t_run = time.perf_counter() - t0
            check = check_dryrun_calls(torch, ops, ref, qmm, fa, ssm, dev,
                                       f"{arch} {shape}", calls)
            name = dryrun.cell_name(arch, shape, False, 8)
            rec = json.loads((DRYRUN_DIR / f"{name}.json").read_text())
            rf, mem, meas = rec["roofline"], rec["memory"], rec["measured"]
            bound = max(rf["compute_s"], rf["memory_s"])
            if rec["measured_step_s"] < bound:
                raise AssertionError(
                    f"[dryrun] {name}: measured step "
                    f"{rec['measured_step_s']:.4e} s below the count's "
                    f"bound {bound:.4e} s")
            if mem["peak_memory_in_bytes"] < mem["argument_size_in_bytes"]:
                raise AssertionError(
                    f"[dryrun] {name}: peak {mem['peak_memory_in_bytes']} B "
                    f"below the rank's argument bytes "
                    f"{mem['argument_size_in_bytes']}")
            d1, d2 = meas["depths"]["1"], meas["depths"]["2"]

            def spread(d, key):
                sp = d["spread"][key]
                return (f"{sp['median']:.4f} [{sp['min']:.4f}-"
                        f"{sp['max']:.4f}]")
            print(f"[dryrun] {arch} {shape} as rank 0 of the "
                  f"{rec['mesh']} production mesh: count "
                  f"{rec['compile_s']:.2f} s ({rec['aten_ops']} aten ops, "
                  f"kernels {json.dumps(rec['kernels'])}), FLOPs "
                  f"{rf['flops_per_chip']:.4e}, bytes "
                  f"{rf['hbm_bytes_per_chip']:.4e}, collective bytes "
                  f"{rf['collective_bytes_per_chip']:.4e} "
                  f"{json.dumps(rec['collectives']['counts'])}; roofline "
                  f"compute {rf['compute_s']:.4e} s, memory "
                  f"{rf['memory_s']:.4e} s, collective "
                  f"{rf['collective_s']:.4e} s ({rf['bound']}); measured at "
                  f"depth 1 / 2, median [least-most] of "
                  f"{len(d1['profiled'])} calls each, "
                  f"{spread(d1, 'step_s')} / {spread(d2, 'step_s')} s "
                  f"(device busy {spread(d1, 'device_busy_s')} / "
                  f"{spread(d2, 'device_busy_s')} s over "
                  f"{[p['events'] for p in d1['profiled']]} / "
                  f"{[p['events'] for p in d2['profiled']]} device events, "
                  f"in profiled calls of {spread(d1, 'profiled_step_s')} / "
                  f"{spread(d2, 'profiled_step_s')} s), a layer "
                  f"{meas['layer_s']:.4f} s, the step at "
                  f"{meas['layers']} layers {rec['measured_step_s']:.4f} s "
                  f"(range {meas['measured_step_range_s'][0]:.4f}-"
                  f"{meas['measured_step_range_s'][1]:.4f} s) "
                  f">= the bound {bound:.4e} s ({meas['timed']}); peak "
                  f"{mem['peak_memory_in_bytes'] / 1e9:.3f} GB >= the "
                  f"rank's arguments "
                  f"{mem['argument_size_in_bytes'] / 1e9:.4f} GB, fits "
                  f"{meas['fits']}; useful FLOPs "
                  f"{rec['useful_flops_frac']:.4f}; launches "
                  f"{json.dumps(launched_by_dtype)}; kernels vs plain at "
                  f"{json.dumps(check['cases'])} distinct calls, max abs "
                  f"err {json.dumps(check['max_abs_err'])}; "
                  f"{t_run:.1f} s; {card}")
            cells[name] = dict(record=rec, launches=launched_by_dtype,
                               path_check=check, wall_s=t_run)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    recs = {name: c["record"] for name, c in cells.items()}
    print(report.dryrun_table(recs))
    print(report.roofline_table(recs))
    wall = time.perf_counter() - t_phase
    print(f"[dryrun] phase 18 {wall:.1f} s; {card}")
    return dict(cells=cells, wall_s=wall, card=card)


def phase_clock(phase_s):
    """``mark(name)`` closes the running phase (its wall seconds into
    ``phase_s``) and starts ``name``'s."""
    state = {"name": None, "t0": time.perf_counter()}

    def mark(name):
        now = time.perf_counter()
        if state["name"] is not None:
            phase_s[state["name"]] = now - state["t0"]
        state.update(name=name, t0=now)
    return mark


def to_device(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(torch, v, dev) for k, v in tree.items()}
    return tree.to(dev)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import memsys, packing, paging, placement
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.weight_store import PackedParam
    from repro_torch.core.perf_model import mobilenet_v2_jobs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import neureka_conv as nkc
    from repro_torch.kernels import qmatmul as qmm
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.models import mobilenet_v2 as mnv2
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import freeze_for_serving
    from repro_torch import serving
    from repro_torch.serving import trace
    from repro_torch.serving.engine import Request, ServingEngine

    phase_s = {}          # wall seconds by phase, the build included in 1
    mark = phase_clock(phase_s)
    mark("1")
    # 1. set-up
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}  torch {torch.__version__} cuda {torch.version.cuda}"
          f"  devices {torch.cuda.device_count()}")
    phase_build(build)

    mark("2")
    # 2. kernels against their plain versions, then timed
    qmm_err = check_qmatmul(torch, ops, ref, qmm, dev)
    fa_err = check_flash(torch, ref, fa, dev)
    t_dec = time_qmatmul(torch, packing, ops, ref, qmm, dev, m=4)
    t_pre = time_qmatmul(torch, packing, ops, ref, qmm, dev, m=256)
    t_falcon_dec, t_falcon = (
        time_qmatmul(torch, packing, ops, ref, qmm, dev, m=m, copies=2,
                     linears=FALCON_LINEARS,
                     what="qmatmul_f32 falcon-mamba-7b layer x4")
        for m in (4, 256))
    t_llava_dec, t_llava = (
        time_qmatmul(torch, packing, ops, ref, qmm, dev, m=m, copies=2,
                     linears=LLAVA_LINEARS,
                     what=f"qmatmul_f32 {VLM_ARCH} layer x7")
        for m in (4, 256))
    t_fa = {which: time_flash(torch, F, ref, fa, dev, which)
            for which in FLASH_TIMED}
    gbs_err = check_grouped_blockscale(torch, ops, ref, qmm, dev)
    t_gbs = {c: time_grouped_blockscale(torch, ops, ref, qmm, dev, c)
             for c in (8, 24)}
    jobs = {j.name: j for j in mobilenet_v2_jobs(8, MNV2_IMG)}
    nk_err = check_neureka(torch, packing, ops, ref, nkc, qmm, dev,
                           list(jobs.values()))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {name: qmm.int8_plan(*job_key(jobs[name])[1], sms)
             for name in NEUREKA_TIMED if jobs[name].op_kind == "pw1x1"}
    t_nk = {name: time_neureka(torch, F, packing, ops, ref, nkc, qmm, dev,
                               *job_key(jobs[name]), name,
                               plan_text(plans[name]) if name in plans
                               else "")
            for name in NEUREKA_TIMED}
    for name, plan in plans.items():
        t_nk[name].update(plan=plan._asdict(), launch_route=plan.route)
    for t in t_nk.values():
        if "plan" in t and not isinstance(t["plan"], dict):
            t["plan"] = t["plan"]._asdict()
    scan_err = check_scan(torch, ref, ssm, dev)
    t_scan = {which: time_scan(torch, ref, ssm, dev, which)
              for which in SCAN_TIMED}
    gc.collect()                  # drop the timing graphs and their pools
    torch.cuda.empty_cache()

    mark("3-4")
    # 3-4. serve full-width qwen3-0.6b, falcon-mamba-7b and hymba-1.5b,
    # each with its card-vs-CPU logits check
    mods = dict(np=np, tfm=tfm, freeze=freeze_for_serving, Request=Request,
                ServingEngine=ServingEngine, ops=ops, ref=ref, qmm=qmm, fa=fa,
                ssm=ssm)
    counters = {"qmatmul_f32": qmm.qmatmul_f32,
                "flash_attention": fa.flash_attention,
                "selective_scan": ssm.selective_scan}
    served = {}
    for arch, max_len, long_prompt, depth in SERVE_PATHS:
        served[arch], tree = serve_lm(torch, mods,
                                      cut(get_config(arch),
                                          SERVE_LAYERS.get(arch)), max_len,
                                      long_prompt, counters, depth, dev)
        if arch == XR_ARCH:
            xr_tree = tree               # phases 7 and 8 serve it again
        if arch == TENANTS[1]:
            falcon_tree = tree           # phase 8's second tenant
        del tree
        gc.collect()
        torch.cuda.empty_cache()
    launches = {name: sum(s["launches"][name] for s in served.values())
                for name in counters}
    qmm_err, fa_err, scan_err = (
        max([err] + [s["path_check"]["max_abs_err"][name]
                     for s in served.values()])
        for err, name in ((qmm_err, "qmatmul_f32"),
                          (fa_err, "flash_attention"),
                          (scan_err, "selective_scan")))

    mark("5")
    # 5. MobileNet-V2 1.0-224 frames on the N-EUREKA kernels
    gc.collect()
    torch.cuda.empty_cache()
    nk_launches = run_frames(torch, mnv2, nkc, qmm, dev)

    mark("6")
    # 6. paged serving: qwen3-0.6b at 4 bits, the cold half wire-served
    gc.collect()
    torch.cuda.empty_cache()
    mods.update(placement=placement, paging=paging, packing=packing,
                PackedParam=PackedParam, FaultPlan=FaultPlan)
    paged_cfg = cut(get_config(PAGED_ARCH), PAGED_LAYERS)
    paged, bs_err, t_bs, paged_store = serve_paged(torch, mods, paged_cfg,
                                                   dev)
    served[f"{PAGED_ARCH} paged"] = paged
    for name in ("qmatmul_f32", "flash_attention"):
        launches[name] += paged["launches"][name]
    qmm_err = max(qmm_err, paged["path_check"]["max_abs_err"]["qmatmul_f32"])
    fa_err = max(fa_err,
                 paged["path_check"]["max_abs_err"]["flash_attention"])

    mark("7")
    # 7. the scheduled XR serve, resident and paged
    gc.collect()
    torch.cuda.empty_cache()
    mods.update(serving=serving, trace=trace)
    xr = serve_xr_phase(
        torch, mods, cut(get_config(XR_ARCH), XR_LAYERS),
        dict(xr_tree, layers=first_layers(xr_tree["layers"], XR_LAYERS)),
        {k: dict(paged_store[k], layers=first_layers(
            paged_store[k]["layers"], XR_LAYERS)) if k in (
                "packed", "wire_tree") else v
         for k, v in paged_store.items()}, dev)
    # phase 16 serves the same store on four links
    mesh_store = {k: paged_store[k] for k in ("packed", "plan", "tokens")}
    del paged_store
    served[f"{XR_ARCH} xr"] = xr
    for name in ("qmatmul_f32", "flash_attention"):
        launches[name] += xr["launches"][name]
    qmm_err = max(qmm_err, xr["path_check"]["max_abs_err"]["qmatmul_f32"])
    fa_err = max(fa_err, xr["path_check"]["max_abs_err"]["flash_attention"])
    bs_err = max(bs_err,
                 xr["path_check"]["max_abs_err"]["qmatmul_f32_blockscale"])

    mark("8")
    # 8. KV paging and tenancy over one page pool
    gc.collect()
    torch.cuda.empty_cache()
    mods.update(memsys=memsys)
    trees = {TENANTS[0]: xr_tree, TENANTS[1]: falcon_tree}
    kvt = serve_kv_tenancy_phase(
        torch, mods,
        {name: cut(get_config(name), TENANCY_LAYERS[name])
         for name in TENANTS},
        {name: dict(trees[name], layers=first_layers(
            trees[name]["layers"], TENANCY_LAYERS[name]))
         for name in TENANTS}, dev)
    del trees
    del xr_tree, falcon_tree
    for path, part in ((f"{TENANTS[0]} kv-paged", "kv"),
                       (f"{'+'.join(TENANTS)} tenancy", "tenancy")):
        served[path] = kvt[part]
        for name in KV_KERNELS:
            launches[name] += kvt[part]["launches"][name]
    qmm_err, fa_err, scan_err = (
        max(err, kvt["path_check"]["max_abs_err"][name])
        for err, name in ((qmm_err, "qmatmul_f32"),
                          (fa_err, "flash_attention"),
                          (scan_err, "selective_scan")))
    b3_by_path = {f"{PAGED_ARCH} paged":
                  paged["launches"]["qmatmul_f32_blockscale"],
                  f"{XR_ARCH} xr": xr["launches"]["qmatmul_f32_blockscale"]}

    mark("9")
    # 9. the MoE family: qwen2-moe-a2.7b, its experts on the grouped kernel
    gc.collect()
    torch.cuda.empty_cache()
    moe, grouped_err, t_grouped = serve_moe_phase(
        torch, mods, get_config(MOE_ARCH), dev)
    served[MOE_ARCH] = moe
    for name in ("qmatmul_f32", "flash_attention"):
        launches[name] += moe["launches"][name]
    qmm_err, fa_err = (max(err, moe["path_check"]["max_abs_err"][name])
                       for err, name in ((qmm_err, "qmatmul_f32"),
                                         (fa_err, "flash_attention")))
    grouped_err = max(grouped_err, moe["path_check"]["max_abs_err"][
        "qmatmul_f32_grouped"])

    mark("10")
    # 10. training qwen3-0.6b on the card; then its trained tree served
    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase(torch, get_config(TRAIN_ARCH), dev)
    for name in TRAIN_KERNELS:
        launches[name] += train["serve"]["launches"][name]
    served[f"{TRAIN_ARCH} trained"] = train["serve"]
    qmm_err, fa_err = (
        max(err, train["serve"]["path_check"]["max_abs_err"][name])
        for err, name in ((qmm_err, "qmatmul_f32"),
                          (fa_err, "flash_attention")))

    mark("11")
    # 11. the serving launcher and the XR pipeline, in process
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.launch import serve as launch_serve
    mods.update(launch_serve=launch_serve, mnv2=mnv2, nkc=nkc, card=card)
    p11 = launch_xr_phase(torch, mods, dev)
    served[f"{LAUNCH_ARCH} launcher"] = p11["launcher"]
    served["xr pipeline"] = p11["xr"]
    served[f"{'+'.join(TENANTS)} launcher tenancy"] = p11["tenancy"]
    for name in counters:
        for part in ("launcher", "xr", "tenancy"):
            launches[name] += p11[part]["launches"][name]
    qmm_err, fa_err, scan_err = (
        max(err, p11["path_check"]["max_abs_err"][name])
        for err, name in ((qmm_err, "qmatmul_f32"),
                          (fa_err, "flash_attention"),
                          (scan_err, "selective_scan")))
    for name in NEUREKA_KERNELS:
        nk_err[name] = max(nk_err[name],
                           p11["path_check"]["max_abs_err"][name])

    mark("12")
    # 12. the VLM and encoder-decoder families and hymba's segmented path
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.launch import steps
    from repro_torch.models import encdec, vlm
    mods.update(steps=steps, vlm=vlm, encdec=encdec, get_config=get_config)
    p12 = vlm_encdec_phase(torch, mods, dev, counters)
    served[f"{VLM_ARCH} serve steps"] = p12[VLM_ARCH]["steps"]
    served[f"{VLM_ARCH} engine"] = p12[VLM_ARCH]["engine"]
    served[f"{ENCDEC_ARCH} serve steps"] = p12[ENCDEC_ARCH]
    served[f"{SEG_ARCH} segmented forward"] = p12[SEG_ARCH]
    for path in (f"{VLM_ARCH} serve steps", f"{VLM_ARCH} engine",
                 f"{ENCDEC_ARCH} serve steps",
                 f"{SEG_ARCH} segmented forward"):
        for name in counters:
            launches[name] += served[path]["launches"][name]
    qmm_err, fa_err, scan_err = (
        max(err, p12["path_check"]["max_abs_err"][name])
        for err, name in ((qmm_err, "qmatmul_f32"),
                          (fa_err, "flash_attention"),
                          (scan_err, "selective_scan")))

    mark("13")
    # 13. training of the MoE, SSM, hybrid, VLM and encoder-decoder
    # families; hymba-1.5b's trained tree served
    gc.collect()
    torch.cuda.empty_cache()
    p13 = family_train_phase(torch, dev, get_config)
    served[f"{FAMILY_ARCH} trained"] = p13["serve"]
    for name in FAMILY_KERNELS:
        launches[name] += p13["serve"]["launches"][name]
    qmm_err, fa_err, scan_err = (
        max(err, p13["serve"]["path_check"]["max_abs_err"][name])
        for err, name in ((qmm_err, "qmatmul_f32"),
                          (fa_err, "flash_attention"),
                          (scan_err, "selective_scan")))

    mark("14")
    # 14. the launcher at full width on gemma-7b, qwen2.5-3b, olmo-1b and
    # llava-next-34b, their 2-layer cuts card vs CPU, and qwen2-moe's cold
    # expert pages wire-served through the grouped blockscale kernel
    gc.collect()
    torch.cuda.empty_cache()
    p14 = launcher_archs_phase(torch, mods, dev)
    for arch, _extra in LAUNCH14:
        served[f"{arch} launcher"] = p14[arch]
        for name in LAUNCH14_KERNELS:
            launches[name] += p14[arch]["launches"][name]
    served[f"{MOE_ARCH} wire-served experts"] = p14["wire_moe"]
    for name in ("qmatmul_f32", "flash_attention"):
        launches[name] += p14["wire_moe"]["launches"][name]
    qmm_err, fa_err = (max(err, p14["path_check"]["max_abs_err"][name])
                       for err, name in ((qmm_err, "qmatmul_f32"),
                                         (fa_err, "flash_attention")))
    gbs_err = max(gbs_err, p14["path_check"]["max_abs_err"][
        "qmatmul_f32_blockscale_grouped"])

    mark("15")
    # 15. the bf16 contracts on the model path: hymba-1.5b with dtype,
    # attn_dtype and scan_dtype bf16, qwen3-0.6b paged at a bf16 dtype
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.models import moe as moe_mod
    mods.update(F=F, paging=paging, PackedParam=PackedParam, moe=moe_mod)
    p15 = bf16_phase(torch, mods, dev, get_config)

    mark("16")
    # 16. mesh-sharded paged serving: the launcher's --mesh 4 at full width,
    # and phase 6's wire-served store on four links
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.launch import mesh as mesh_mod
    mods.update(mesh=mesh_mod)
    p16 = mesh_phase(torch, mods, dev, paged_cfg, mesh_store)
    del mesh_store
    for leg in ("launcher", "wire"):
        served[f"{MESH_ARCH} mesh {leg}"] = p16[leg]
        for name in ("qmatmul_f32", "flash_attention"):
            launches[name] += p16[leg]["launches"][name]
    b3_by_path[f"{PAGED_ARCH} mesh wire"] = p16["wire"]["launches"][
        "qmatmul_f32_blockscale"]
    qmm_err, fa_err, bs_err = (
        max(err, p16["path_check"]["max_abs_err"][name])
        for err, name in ((qmm_err, "qmatmul_f32"),
                          (fa_err, "flash_attention"),
                          (bs_err, "qmatmul_f32_blockscale")))

    mark("17")
    # 17. multi-rank training: 4 gloo ranks on the card
    gc.collect()
    torch.cuda.empty_cache()
    p17 = dist_train_phase(torch, card)

    mark("18")
    # 18. the dry-run: four cells counted on meta and timed on the card
    gc.collect()
    torch.cuda.empty_cache()
    p18 = dryrun_phase(torch, mods, dev, card)

    mark("19")
    # 19. result lines
    by_path = {name: {arch: s["launches"][name] for arch, s in served.items()
                      if name in s["launches"]}
               for name in counters}
    by_class = {name: {arch: s["launches_by_class"][name]
                       for arch, s in served.items()
                       if s["launches_by_class"].get(name)}
                for name in SPLIT_LAUNCHES}
    kernels = [
        dict(name="qmatmul_f32", route="cuda",
             source="src/repro_torch/csrc/qmatmul_f32.cu",
             replaces="src/repro/kernels/qmatmul.py:132",
             launches=launches["qmatmul_f32"],
             launches_by_path=by_path["qmatmul_f32"], max_abs_err=qmm_err,
             ms=t_dec["ms"], plain_ms=t_dec["plain_ms"],
             bound_ms=t_dec["bound_ms"], bound_by=t_dec["bound_by"],
             library_ms=t_dec["library_ms"], eager_ms=t_dec["eager_ms"],
             work="one layer's 7 packed linears, decode M=4, 8-bit",
             bytes_ms=t_dec["bytes_ms"], tf32_ops_ms=t_dec["tf32_ops_ms"],
             bound_f32_ms=t_dec["bound_f32_ms"],
             decode_falcon_M4=t_falcon_dec, prefill_M256=t_pre,
             prefill_falcon_M256=t_falcon, decode_llava_M4=t_llava_dec,
             prefill_llava_M256=t_llava),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:71",
             launches=launches["flash_attention"],
             launches_by_path=by_path["flash_attention"],
             launches_by_shape=by_class["flash_attention"],
             max_abs_err=fa_err, ms=t_fa["qwen3"]["ms"],
             plain_ms=t_fa["qwen3"]["plain_ms"],
             bound_ms=t_fa["qwen3"]["bound_ms"],
             bound_by=t_fa["qwen3"]["bound_by"],
             library_ms=t_fa["qwen3"]["library_ms"],
             eager_ms=t_fa["qwen3"]["eager_ms"], work=t_fa["qwen3"]["work"],
             bytes_ms=t_fa["qwen3"]["bytes_ms"],
             tf32_ops_ms=t_fa["qwen3"]["tf32_ops_ms"],
             bound_f32_ms=t_fa["qwen3"]["bound_f32_ms"],
             hymba=t_fa["hymba"], llava=t_fa["llava"],
             whisper=t_fa["whisper"], gemma=t_fa["gemma"]),
    ]
    for name, source, replaces, timed in (
            ("qmatmul_int8", "qmatmul_int8.cu", "qmatmul.py:218",
             "b1.pw_exp"),
            ("conv3x3_dense", "neureka_conv.cu", "neureka_conv.py:80",
             "conv0"),
            ("conv3x3_dw", "neureka_conv.cu", "neureka_conv.py:153",
             "b1.dw")):
        t = t_nk[timed]
        entry = dict(name=name, route="cuda",
                     source=f"src/repro_torch/csrc/{source}",
                     replaces=f"src/repro/kernels/{replaces}",
                     launches=nk_launches[name] + p11["xr"]["launches"][name],
                     launches_by_path={
                         "frames": nk_launches[name],
                         "xr pipeline": p11["xr"]["launches"][name]},
                     launches_per_frame=nk_launches[name] / MNV2_FRAMES,
                     max_abs_err=nk_err[name], ms=t["ms"],
                     plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                     bound_by=t["bound_by"], library_ms=t["library_ms"],
                     eager_ms=t["eager_ms"], work=t["work"])
        if name == "qmatmul_int8":
            entry.update(launch_route=t["launch_route"], plan=t["plan"],
                         b14_pw_proj=t_nk["b14.pw_proj"],
                         conv_last=t_nk["conv_last"], fc=t_nk["fc"])
        if name == "conv3x3_dw":
            entry.update(plan=t["plan"], b0_dw=t_nk["b0.dw"],
                         b14_dw=t_nk["b14.dw"])
        kernels.append(entry)
    t = t_scan["falcon_prefill"]
    kernels.append(dict(
        name="selective_scan", route="cuda",
        source="src/repro_torch/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:64",
        launches=launches["selective_scan"],
        launches_by_path=by_path["selective_scan"],
        launches_by_route=by_class["selective_scan"], max_abs_err=scan_err,
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None,
        library_note="no single PyTorch call computes a selective scan",
        eager_ms=t["eager_ms"], work=t["work"],
        **{k: v for k, v in t_scan.items() if k != "falcon_prefill"}))
    t = t_grouped[8]
    kernels.append(dict(
        name="qmatmul_f32_grouped", route="cuda",
        source="src/repro_torch/csrc/qmatmul_f32.cu",
        replaces="src/repro/kernels/qmatmul.py:132",
        replaces_note="qmatmul_f32 vmapped over the experts by "
        "src/repro/models/moe.py:97-106: one Pallas launch whose grid "
        "gains the expert axis",
        launches=moe["launches"]["qmatmul_f32_grouped"],
        launches_by_path={MOE_ARCH: moe["launches"]["qmatmul_f32_grouped"]},
        max_abs_err=grouped_err, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], eager_ms=t["eager_ms"], work=t["work"],
        bytes_ms=t["bytes_ms"], tf32_ops_ms=t["tf32_ops_ms"],
        bound_f32_ms=t["bound_f32_ms"], prefill_C24=t_grouped[24]))
    t = t_bs["decode"]
    kernels.append(dict(
        name="qmatmul_f32_blockscale", route="cuda",
        source="src/repro_torch/csrc/qmatmul_blockscale.cu",
        replaces="src/repro/kernels/qmatmul.py:170",
        launches=sum(b3_by_path.values()), launches_by_path=b3_by_path,
        max_abs_err=bs_err, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], eager_ms=t["eager_ms"], work=t["work"],
        bytes_ms=t["bytes_ms"], tf32_ops_ms=t["tf32_ops_ms"],
        bound_f32_ms=t["bound_f32_ms"], prefill_M256=t_bs["prefill"]))
    t = t_gbs[8]
    gbs_launches = p14["wire_moe"]["launches"][
        "qmatmul_f32_blockscale_grouped"]
    kernels.append(dict(
        name="qmatmul_f32_blockscale_grouped", route="cuda",
        source="src/repro_torch/csrc/qmatmul_blockscale.cu",
        replaces="src/repro/kernels/qmatmul.py:170",
        replaces_note="qmatmul_f32_blockscale vmapped over the experts by "
        "src/repro/models/moe.py:97-106 when a MoE store's cold expert "
        "pages are wire-served: one Pallas launch whose grid gains the "
        "expert axis",
        launches=gbs_launches,
        launches_by_path={f"{MOE_ARCH} wire-served experts": gbs_launches},
        max_abs_err=gbs_err, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], eager_ms=t["eager_ms"], work=t["work"],
        bytes_ms=t["bytes_ms"], tf32_ops_ms=t["tf32_ops_ms"],
        bound_f32_ms=t["bound_f32_ms"], prefill_C24=t_gbs[24]))
    # the bf16 routes (phase 15): launches of its two serves, errors at
    # every distinct call and beyond, times
    legs = (BF16_ARCH, BF16_PAGED_ARCH, MOE_ARCH)
    t15 = p15["times"]
    for name, source, replaces, t, more in (
            ("flash_attention", "flash_attention.cu", "flash_attention.py:71",
             t15["flash_qwen3"], dict(hymba=t15["flash_hymba"])),
            ("selective_scan", "ssm_scan.cu", "ssm_scan.py:64",
             t15["scan_hymba_prefill"],
             dict(hymba_decode=t15["scan_hymba_decode"],
                  library_note="no single PyTorch call computes a "
                  "selective scan")),
            ("qmatmul_f32_blockscale", "qmatmul_blockscale.cu",
             "qmatmul.py:170", t15["blockscale_decode"],
             dict(grouped_E60_C8=t15["blockscale_grouped"],
                  grouped_max_abs_err=max(
                      p15["extra_check"]["qmatmul_f32_blockscale_grouped"],
                      p15[MOE_ARCH]["wire"]["path_check"]["max_abs_err"][
                          "qmatmul_f32_blockscale_grouped"]),
                  grouped_launches_by_path={
                      f"{MOE_ARCH} wire-served bf16": p15[MOE_ARCH]["wire"][
                          "launches"]["qmatmul_f32_blockscale_grouped"]})),
            ("qmatmul_f32", "qmatmul_f32.cu", "qmatmul.py:132",
             t15["qmatmul_decode"], {})):
        by_leg = {f"{a} bf16": p15[a]["launches_by_dtype"].get(
            name, {}).get("bfloat16", 0) for a in legs}
        err = max(p15[a]["path_check"]["max_abs_err"].get(name, 0.0)
                  for a in legs)
        if name == "flash_attention":
            err = max(err, p15["extra_check"]["flash_attention"])
        kernels.append(dict(
            name=f"{name}[bf16]", route="cuda", dtype="bfloat16",
            source=f"src/repro_torch/csrc/{source}",
            replaces=f"src/repro/kernels/{replaces}",
            launches=sum(by_leg.values()), launches_by_path=by_leg,
            max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], eager_ms=t["eager_ms"],
            work=t["work"], bytes_ms=t["bytes_ms"], **more))
    t = t15["grouped_decode"]
    by_leg = {f"{MOE_ARCH} bf16": p15[MOE_ARCH]["launches_by_dtype"][
        "qmatmul_f32_grouped"].get("bfloat16", 0)}
    kernels.append(dict(
        name="qmatmul_f32_grouped[bf16]", route="cuda", dtype="bfloat16",
        source="src/repro_torch/csrc/qmatmul_f32.cu",
        replaces="src/repro/kernels/qmatmul.py:132",
        replaces_note="qmatmul_f32 vmapped over the experts by "
        "src/repro/models/moe.py:97-106, at a bf16 dtype",
        launches=sum(by_leg.values()), launches_by_path=by_leg,
        max_abs_err=p15[MOE_ARCH]["path_check"]["max_abs_err"][
            "qmatmul_f32_grouped"],
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        eager_ms=t["eager_ms"], work=t["work"], bytes_ms=t["bytes_ms"]))
    # the dry-run cells' launches (phase 18), on the route of x's dtype
    by_entry = {k["name"]: k for k in kernels}
    for cell, c in p18["cells"].items():
        for name, by in c["launches"].items():
            for dtype, n in by.items():
                entry = by_entry[name if dtype == "float32"
                                 else f"{name}[bf16]"]
                entry["launches"] += n
                entry["launches_by_path"][f"dryrun {cell}"] = n
    print(f"[phases] wall seconds by phase (host clock): "
          f"{json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    print(json.dumps({"serve": served}))
    print(json.dumps({"train": train}))
    print(json.dumps({"phase12": {k: v for k, v in p12.items()
                                  if k != "path_check"},
                      "phase12_path_check": p12["path_check"]}))
    print(json.dumps({"train_families": p13}))
    print(json.dumps({"phase14": {k: v for k, v in p14.items()
                                  if k != "path_check"},
                      "phase14_path_check": p14["path_check"]}))
    print(json.dumps({"bf16": {k: v for k, v in p15.items()
                               if k != "times"}}))
    print(json.dumps({"mesh": {k: v for k, v in p16.items()
                               if k != "path_check"},
                      "mesh_path_check": p16["path_check"]}))
    print(json.dumps({"dist_train": p17}))
    print(json.dumps({"dryrun": {k: v for k, v in p18.items()
                                 if k != "cells"},
                      "dryrun_cells": {
                          name: dict(c, record={
                              k: v for k, v in c["record"].items()
                              if k not in ("cost", "collectives")})
                          for name, c in p18["cells"].items()}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(train_restart_main() if sys.argv[1:] == ["--train-restart"]
             else main())
