#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU — the quickest proof that the port starts on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build the six CUDA kernels from ``src/repro_torch/csrc`` (one
     ``nvcc`` per source, in parallel), print the build seconds and each
     compiled kernel's registers and spills from the ``ptxas`` report;
  3. hold each kernel against its plain PyTorch version on the card at
     the main path's shapes in bfloat16 (rtol 2e-2 / atol 1e-2, the bf16
     tolerance of ``tests/test_kernels.py``; the four matmul kernels
     at M = 1, 5, 8, 17, 128 and 200 rows, each call's launch plan
     printed; the strip kernels' empty strip must come back zero and
     two calls bitwise equal; flash attention also with a suffix, a
     window with softcap and in fp32, paged attention also as verify
     blocks of Q = 4 (bf16 and fp32 q) and Q = 16 (Q * G = 32 rows) and
     with fp32 q, its dead slot exactly zero and two calls bitwise equal,
     each attention call's plan printed; flash also at phase 7's suffix
     shapes, timed against SDPA under a lower-right causal mask; the
     paged verify blocks timed against SDPA under the block's causal
     mask), and time
     the kernel, the plain version and one library call computing the
     same function (a yardstick only — the port never calls it) as device
     time from CUDA-graph replay, beside the least time the card could
     take (bytes at 3.35 TB/s, bf16 operations at 989 TFLOP/s, whichever
     is larger) and the kernel's eager time (host launch cost included).
     The block
     and combined packs have exactly half of each weight's (128, 128)
     tiles zeroed, one empty strip and padding slots; the lookahead
     kernel also reproduces integer weights bit-exactly.  Then the same
     nm_spmm, flash and paged checks at phase 9's shapes: one layer of
     stablelm-12b (32 query heads of 160 over 8 kv heads) and of
     qwen2-vl-72b (64 of 128 over 8, so 8 query rows of a kv head); and
     at phase 10's: nm_spmm at one routed expert of qwen2-moe-a2.7b
     (2048 → 1408 → 2048) and of dbrx-132b (6144 → 10752 → 6144) at the
     rows a capacity dispatch hands an expert (M = 1, 3, 11, 40), timed
     over enough experts to stream from HBM, qwen2-moe's shared FFN
     (5632 wide) at M = 8 and 128, and both attention kernels at 16
     heads over 16 (G = 1) and 48 over 8 (G = 6); and at phase 11's:
     nm_spmm at mamba2-130m's ``out_proj`` (1536 → 768) and at one
     zamba2-1.2b layer (``out_proj`` 4096 → 2048 and the shared MLP's
     2048 ↔ 8192), timed over enough copies to stream from HBM, and both
     attention kernels at zamba2's heads (D = 64, 32 over 32, G = 1);
     and at phase 12's: nm_spmm at one seamless-m4t-large-v2 MLP
     (1024 → 8192 → 1024, also at M = 512, an encoder's rows), both
     attention kernels at its heads (D = 64, 16 over 16), and flash
     without the causal mask (``NONCAUSAL_SHAPES``: the encoder at L =
     512 and 300, a prompt's cross-attention of 128 rows over 512 source
     rows, 8 queries over 6 keys) in bf16 and fp32, each against
     ``mha_ref(causal=False)`` and timed beside SDPA without a mask;
     and at phase 13's (``check_gemma_kernels``): nm_spmm at one gated
     MLP of gemma2-27b (4608 ↔ 36864) and of gemma3-1b (1152 ↔ 6912),
     both attention kernels at their heads (32 over 16 at D = 128; 4
     over 1 at D = 256, bf16 on the FMA route), the paged kernel in bf16
     and with fp32 q, Q = 1 and 4, with a sliding window whose mask
     bites (gemma2: 256 rows over lens up to 512, softcap 50; gemma3:
     512 over lens up to 1024) and without it (the global layers), timed
     beside SDPA under the same window mask (SDPA has no softcap), and
     flash with the window and softcap at the served prompts (gemma2:
     128 rows; gemma3: 640 rows, window 512, and without the window);
     and at phase 15's (``check_bench_kernels``): the serving bench's
     geometry (d_model 64, 4 heads over 2, D = 16): nm_spmm at its 2:4
     MLP with g = 64 (K = 64 keeps 32 rows: the half stage) and
     csa_matmul at its combined MLP (64 x 64 tiles, 32 kept rows a
     tile), each at M = 1, 8, 16, 128, and both attention kernels at D =
     16 on their FMA routes (flash at L = 16, 128, 512 in bf16 and fp32;
     paged over a 36-page view at Q = 1, 3, 5 and with fp32 q), each
     timed beside cuBLAS or SDPA and its bound;
  4. serve qwen3-0.6b at full width, 28 layers (the other formats than
     2:4 cut to ``FORMAT_LAYERS``), bf16, random weights from
     a seed, through ``Engine`` over the paged KV cache, once per pack
     format on all seven projections: ``sparse()`` (2:4, g=128) and
     ``combined`` with 16 requests of 16–128 tokens and 64 new tokens
     each, ``block`` and ``lookahead`` with 8 requests and 32 tokens.
     Before packing, exactly half of each projection's tiles are zeroed
     (not for ``sparse()``), so block and combined packs have tile
     density 0.50.  Every request must reach its budget, ``sync_count``
     must equal the number of decode chunks, the kernels of the format's
     path must launch (counts set to 0 just before each serve, read just
     after) and no other format's matmul kernel may; each scheduler
     tick (admission, prefill and chunk) and each decode chunk is timed
     on the host clock.  Decode chunks run as captured CUDA graphs, one
     per view bucket (a key's first chunk eagerly, its second captured,
     every later one replayed).  After the 2:4 and the combined serve,
     the ``[graph]`` turns: the same engine serves the stream again warm,
     then with graphs off, in turns (warm, eager, warm, eager); tokens,
     ``sync_count`` and each kernel's launches must equal the eager
     serves' exactly and no key may be captured twice; each key's capture
     and instantiate seconds and graph nodes, and each serve's decode ms
     per step, tok/s and peak memory are printed.  Then one more decode
     chunk, a replay of a captured key, under ``torch.profiler``: the
     card's busy share of the wall time and the operations that fill it;
  5. each format's model cut to 2 layers at float32: greedy tokens on
     the card against the port's CPU path; a token may differ only where
     the CPU logits' top-2 gap is under 1e-2 (the gaps are printed).

  6. the paper layer: (a) the four TinyML CNNs of
     ``repro_torch.models.cnn`` at width 1.0 on the paper's inputs
     (VGG16 and ResNet-56 32×32×3, MobileNetV2 96×96×3, DS-CNN 49×10×1),
     batch 32, float32 with TF32 off, weights from a seed combined-pruned
     at (x_ss, x_us) = (0.6, 0.6) and INT7 fake-quantized: logits on the
     card against the port's CPU path within ``CNN_RTOL`` of the largest
     logit, argmax equal wherever the CPU top-2 gap exceeds that
     tolerance, ms per batch from CUDA events as issued eagerly and as
     device time from CUDA-graph replay; (b)
     ``repro_torch.benchmarks.bench_kernels`` on the card at (256, 2048,
     2048) in float32 and bfloat16 (every row held against its plain
     version; the four matmul kernels must launch, counts set to 0 just
     before); (c) Figs. 8 and 9, Table III (``smem_bytes`` read from the
     built libraries) and Fig. 10 at (0.6, 0.6) for all four models:
     every PASS/FAIL line must read PASS.  These are simulated CFU cycles
     and byte counts on the host, not card measurements;
  7. prefix sharing: ``sparse()`` qwen3-0.6b at full width, bf16, with
     ``prefix_cache=True`` and 16-row prompt buckets: one
     ``register_prefix`` of a 64-token head, then 16 requests of 32
     tokens (8 with ``prefix=handle`` and suffixes of 16-48 tokens, 4
     repeating one of those prompts token for token, 4 keeping the
     head's first 40 rows and diverging inside its third page), and the
     same stream on an engine with ``prefix_cache=False``.  Gates: every
     request reaches its budget; ``sync_count`` equals the chunks;
     ``prefix_hits``, ``shared_pages`` and ``cow_copies`` equal what the
     script works out from its own prompts; fewer peak pages than the
     unshared run; the head's pages byte-equal after the serve; the flash
     kernel launched with fewer queries than keys in every layer of every
     hit; tokens equal the unshared run's unless the first split is at a
     near tie (``near_tie``: a top-2 gap under ``GAP_TOL`` or within two
     steps of the bf16 logits' resolution, read by replaying the
     unshared tokens one sequence at a time); and the same stream at 2
     layers in fp32 gives the CPU path's tokens (phase 5's rule);
  8. speculative decoding: phase 4's qwen3-0.6b at full width, cut to
     ``SPEC_LAYERS`` of its 28 layers (bf16, ``sparse()``'s config over
     dense random weights; the cut keeps the whole run well inside its
     time limit as later phases join it) and stream through
     (a) the plain loop, a cold and a warm graph serve, then with
     ``spec_k=3`` (b) the self draft and (c) the config's 2:4 packs as
     the draft (``spec_draft="pack"``: nm_spmm drafts, the dense weights
     verify), each on one engine in phase 4's ``[graph]`` turns (cold,
     warm, eager, warm, eager).  Gates: every request reaches its budget;
     ``sync_count`` equals the chunks; tokens, ``sync_count``, drafted,
     accepted and launches per kernel equal the eager turns'; one
     paged-attention verify block (Q = 4) per layer and step, and in (c)
     7 nm_spmm launches per layer and draft step; tokens equal (a)'s or
     split first at a near tie (``near_tie``).  Printed: each turn's
     decode ms per step, tok/s, tokens per chunk, drafted, accepted and
     acceptance rate, peak memory; capture and instantiate seconds per
     key; the warm means against (a).  Then the model at 2 layers in
     fp32 with a ``pack`` draft in each format against the CPU path's
     greedy tokens (phase 5's rule): the FMA route's verify block;
  9. stablelm-12b (cut to ``STABLELM_LAYERS`` of its 40 layers, d_model
     5120, 32 heads of 160 over 8 kv heads, d_ff 13824, vocab 100352, an
     untied head) and qwen2-vl-72b
     (d_model 8192, 64 heads of 128 over 8, d_ff 29568, vocab 152064,
     M-RoPE (16, 24, 24), cut to ``QWEN2_VL_LAYERS`` of its 80 layers:
     80 dense bf16 layers do not fit the card before packing) at their
     published widths, bf16, random weights from a seed, ``sparse()``'s
     2:4 packs on all seven projections, through phase 4's serve and
     stream: a cold graph serve, then phase 4's turns (warm graph,
     eager, warm graph, eager).  Gates: budgets and syncs; tokens,
     ``sync_count`` and launches of every turn equal; only nm_spmm and
     the two attention kernels launch, the attention kernels on their
     tensor-core routes, flash once per layer and prefill, paged once
     per layer and decode step, nm_spmm 7 times per layer and forward;
     qwen2-vl's prefill of its prompt's embedding rows gives the token
     prefill's logits bitwise.  Then both at 2 layers in fp32 against
     the CPU path (phase 5's rule), both attention kernels on the FMA
     route;
 10. the MoE family: qwen2-moe-a2.7b (d_model 2048, 16 heads of 128
     over 16, 60 experts top-4 of d_expert 1408 and 4 shared, vocab
     151936, tied; cut to ``QWEN2_MOE_LAYERS`` of its 24 layers so that
     phase 13 fits the time limit) and dbrx-132b (d_model 6144, 48 heads
     of 128 over 8, 16 experts top-4 of d_expert 10752, vocab 100352,
     cut to ``DBRX_LAYERS`` of its 40 layers: 40 packed layers are ~134
     GB)
     at published widths, bf16, random weights from a seed, each layer
     packed as it is drawn (one dense layer is the only transient),
     ``sparse()``'s 2:4 packs on the routed (and qwen2-moe's shared)
     experts, attention dense, served through the sorted capacity
     dispatch in phase 4's serve and stream: a cold graph serve, then
     phase 4's turns.  Gates: budgets and syncs; turns equal; only
     nm_spmm and the two attention kernels launch, attention on the
     tensor-core routes, flash once per layer and prefill, paged once
     per layer and decode step, nm_spmm 3 E times per layer and forward
     (+ 3 for the shared FFN).  Printed: the share of routes dropped at
     decode and at prefill, and the turns' metrics.  Then both at 2
     layers in fp32: the Engine's tokens on the card against the same
     batch decoded on the CPU path (``batched_greedy``; phase 5's rule
     at the first split).  The CPU side runs in a process of its own
     (``--moe-cpu-reference``, on ``MOE_REFERENCE_THREADS`` threads),
     which draws the same weights on the card from the seed and frees
     them there before phase 11 starts; its tokens are checked after
     phase 13, and the phases between are timed with it beside them.
 11. the SSM/hybrid family: mamba2-130m (cut to ``MAMBA2_LAYERS`` of
     its 24 Mamba-2 layers, d_model 768, 24 SSD heads of 64, state 128,
     vocab 50280, tied) and zamba2-1.2b (cut to ``ZAMBA2_LAYERS`` of its
     38 layers, d_model 2048, 64 SSD heads of 64, state 64, one shared
     attention block of 32 heads of 64 and a gated MLP of 8192 before
     layers 3 and 9 of those, vocab 32000, tied) at published widths,
     bf16, random weights from a seed, each
     layer packed as it is drawn: ``sparse()``'s 2:4 packs on
     ``out_proj`` and the shared MLP, ``in_proj`` dense (its width is no
     multiple of 128), through phase 4's serve and stream: a cold graph
     serve, then phase 4's turns.  Gates: budgets and syncs; turns
     equal; only nm_spmm (and zamba2's attention kernels, on the
     tensor-core routes) launch, nm_spmm once per ``out_proj`` and
     shared-MLP projection and forward, flash once per shared slot and
     prefill, paged once per shared slot and decode step; the recurrent
     state keeps its addresses through all serves.  Printed: the turns'
     metrics, the profile of a replayed chunk, and the device ms of the
     SSD scan of a prompt and of the recurrent update per layer.  Then
     in fp32, mamba2 at 2 layers and zamba2 at its first 4: the Engine's
     tokens on the card against one-sequence greedy decoding on the CPU
     path (phase 5's rule), monolithic in two waves (the second wave
     starts from zero recurrent state) and paged; and zamba2 at 4
     layers speculative (``spec_k = 3``) with a draft from another seed:
     a rollback of the recurrent state at nearly every step, the plain
     loop's tokens, warm graph turns equal to the eager ones.
 12. the encoder-decoder family: seamless-m4t-large-v2 (cut to
     ``SEAMLESS_LAYERS`` of its 24 encoder and 24 decoder layers each,
     d_model 1024, 16 heads of 64 over 16, an ungated MLP of 8192, vocab
     256206, tied) at published widths, bf16, random weights from a seed, each layer packed as it is drawn:
     ``sparse()``'s 2:4 packs on every ``w_in`` and ``w_out``, attention
     dense.  (a) Phase 4's serve and stream (the Engine feeds tokens, so
     each prefill encodes the null source of ``max_len`` = 512 frames):
     a cold graph serve, then phase 4's turns.  Gates: budgets and
     syncs; turns equal; only nm_spmm and both attention kernels launch,
     on the tensor-core routes, per prefill flash once per encoder layer
     and twice per decoder layer (self causal, cross non-causal; the
     non-causal count checked apart) and nm_spmm twice per layer of both
     stacks, per step nm_spmm twice and paged once per decoder layer
     (``encdec_launches``); the cross K/V keep their addresses through
     all serves.  Printed: the turns' metrics and the profile of a
     replayed chunk.  (b) One prefill of two random sources of 300
     frames under 128-token prompts: launches, finite logits moved by
     the source, and its time eager and as device time, the encoder
     apart.  (c) At 2 + 2 layers in fp32 against the CPU path: the
     Engine's greedy tokens (monolithic in two waves, paged; phase 5's
     rule), model-level logits with a random source (prefill, 4 decode
     steps, a T = 4 block) within ``FID_ATOL``, and ``spec_k = 3`` with
     a draft from another seed: the plain loop's tokens, warm graph
     turns equal to the eager ones.
 13. the gemma pair: gemma2-27b (46 layers, 23 of them local with a
     window of 4096, d_model 4608, 32 heads of 128 over 16, d_ff 36864,
     vocab 256000 tied, attention softcap 50, final softcap 30) and
     gemma3-1b (26 layers, 22 local with a window of 512, d_model 1152,
     4 heads of 256 over 1, qk-norm, d_ff 6912, vocab 262144 tied), both
     with post-norms and scaled embeddings, at published widths (gemma2
     cut to ``GEMMA2_LAYERS`` and gemma3 to ``GEMMA3_LAYERS`` since
     phase 14), bf16, random weights from a seed, each layer packed as it is
     drawn: ``sparse()``'s 2:4 packs on the MLPs, attention dense.
     (a) gemma2 through phase 4's serve and stream (``max_len`` 512:
     the window never masks, the softcaps and post-norms do their work):
     a cold graph serve, then phase 4's turns and a profiled replayed
     chunk.  (b) gemma3 the same, then ``LONG_SERVE``: 8 prompts of
     384–600 tokens padded to 640 rows and 256 new tokens each, so every
     local layer's window masks.  Gates: budgets and syncs; turns equal;
     only nm_spmm and both attention kernels launch, nm_spmm 3 times per
     layer and forward, flash once per layer and prefill, paged once per
     layer and step, the local layers' launches with the window (the
     wrappers' ``window_launches``: local layers × prefills and × steps);
     gemma2's attention on the tensor-core routes, gemma3's (D = 256,
     bf16) on the FMA routes.  (c) Each cut to 2 layers (one local, one
     global) in fp32 with a 32-row window and an untied head (random
     weights under the tied, scaled head repeat the last prompt token):
     the Engine's greedy tokens against the CPU path past the window
     (phase 5's rule), model-level logits (prefill, 4 decode steps, a T
     = 4 block) within ``FID_ATOL``, and a garbage-draft speculative
     serve equal to the plain loop.
 14. training, the paper's co-design loop, on qwen3-0.6b ``config()`` at
     published widths and full depth (28 layers, bf16, remat, seeded
     random init; ``repro_torch.examples.train_sparse_lm``'s functions):
     (a) the ``Trainer``, ``DENSE_STEPS`` steps of 8 x 128 tokens (lr
     3e-3, warmup 20), one asynchronous checkpoint at ``CKPT_STEP`` under
     ``build/``; gates: finite losses and grad norms, the last 10 losses'
     mean at least ``LOSS_DROP`` below the first 10's, the checkpoint
     restored bitwise equal to a host copy taken at that step; prints the
     median step and its split (data, forward, backward, optimizer; CUDA
     events over ``TIMED_STEPS`` extra steps), tokens/s, model
     utilization, peak memory and the checkpoint's stall and write
     seconds.  (b) 2:4 masks along K on all seven projections (positions
     shared over 128 columns, as ``sparse()`` packs them) and
     ``FT_STEPS`` masked fine-tune steps (lr 1e-3, warmup 10); gates:
     masked positions exactly 0 and no mask's kept positions all 0, the
     held-out loss after the fine-tune below the one right after
     pruning.  (c) ``pack_params`` under ``sparse()``, phase 4's Engine
     over 16 held-out prompts; gates: each pack keeps its mask's
     positions, budgets and syncs, only nm_spmm and both attention
     kernels at their per-layer counts, tokens equal to the masked
     weights served dense or split at a near tie; prints warm ms/step and
     tok/s and the share of generated tokens that follow the stream's
     transition (dense-trained, one-shot pruned pack, fine-tuned pack).
     (d) the dense-trained weights verify ``SPEC_K`` tokens drafted by
     (c)'s pack; gates: one verify block per layer and step, nm_spmm 7
     times per layer and draft step, tokens equal to the plain loop's or
     split at a near tie; prints acceptance and tokens per chunk beside
     phase 8's pack draft on random weights.  (e) each family's
     ``reduced()`` config in fp32: loss and every gradient on the card
     against the CPU, and one train step (Adam's epsilon at
     ``STEP_EPS``) with every param compared; no kernel launches
     across any training (the training route is plain PyTorch).  The
     line before ``nvidia-smi``'s second reading is ``{"train": ...}``.
 15. the launchers, the serving bench, CNN training and the examples
     (``launchers_and_cnn``): (a) ``repro_torch.launch.serve.main`` at
     qwen3-0.6b's full width and depth (``LAUNCH_FLAGS``: 16 requests
     on 8 slots, 128-token prompts, 64 new, 16-row pages, chunks of 16),
     plain and with ``--spec-k 3 --spec-draft self``; gates: host syncs
     equal the chunks served, flash once per layer and prefill, paged
     once per layer and step (and per draft; one Q = 4 verify block per
     layer and step), no matmul kernel (dense projections on cuBLAS);
     then ``python -m repro_torch.launch.serve --arch qwen3-0.6b
     --reduced --checkpoint-dir D`` in a subprocess on a checkpoint the
     phase writes, which must print ``restored checkpoint step N`` and
     the counts of an in-process serve of it.  (b)
     ``benchmarks.bench_serving.run()`` under ``REPRO_BENCH_SMOKE=1``,
     every row printed; gates: nm_spmm and csa_matmul launched on their
     half stage and both attention kernels on their FMA routes (D = 16),
     every row's syncs equal its chunks, the chunked and per-token
     serves of a grid row equal in tokens.  (c) Table II
     (``benchmarks.bench_int7.run()``: ResNet-56, MobileNetV2, DS-CNN
     trained 250 / 200 / 250 steps of 64) and
     ``examples.tinyml_repro``, printed as findings, not gated; then 3
     fp32 DS-CNN steps on the card against the CPU path from one init
     (Adam at ``STEP_EPS``), every leaf within ``STEP_RTOL`` of its
     largest, no kernel launched.  (d) ``examples.quickstart`` (its
     step 3 raises if a kernel disagrees with its plain version),
     ``serve_lm`` and ``serve_stream`` on the card; gate: all six
     kernels launched.  The line after ``{"train": ...}`` is
     ``{"launchers": ...}``.
 16. the dry run, the autotune rows, roofline and perf trend
     (``dryrun_and_autotune``; the autotune cache is a fresh file under
     ``build/chip_smoke/``, set in ``REPRO_TORCH_AUTOTUNE_CACHE`` before
     the port is imported, so phases 3-15 run the tiling rule): (a)
     qwen3-0.6b ``sparse()`` at full width and phase 4's serve geometry
     on ``meta`` (``TRACE_STEPS`` of a decode chunk through
     ``launch.analysis``); gates: the param and cache bytes equal the
     bytes the built engine's params, cache and chunk buffers asked the
     allocator for, and the predicted peak of a decode chunk is at least
     ``PEAK_FLOOR`` of the card's for one eager chunk; the predicted step
     bound against phase 4's warm ms per step is printed as a finding.
     (b) ``benchmarks.warm_autotune`` on one layer each of nm and
     combined qwen3-0.6b and its paged geometry (every page view of the
     serve, Q = 1 and the verify blocks); gates: every row written with
     no skipped candidate, each cached plan within the bf16 tolerance of
     its plain version on fresh inputs, a serve at ``AUTOTUNE_LAYERS``
     layers under the cache runs cached plans (``autotune.hits``, every
     decode-geometry nm key among them) and gives the tokens of the same
     serve under an empty cache or splits only at a near tie.  (c)
     ``launch.dryrun.run_cell`` of qwen3-0.6b's prefill and decode cells
     through ``benchmarks.roofline``, and ``benchmarks.perf_trend``
     between two ``benchmarks.run --json`` records of the kernels
     section at its smoke shape (a finding: exit 1 only names rows that
     moved past 30%).  The line after ``{"launchers": ...}`` is
     ``{"dryrun": ...}``.
 17. faults and chaos (``faults_and_chaos``): qwen3-0.6b ``sparse()`` at
     published widths cut to ``FAULT_LAYERS`` = 4 of its 28 layers, bf16,
     paged (16-row pages, 16-row prompt buckets), prefix sharing on,
     graphs on, 8 slots.  (a) ``preemption``: a pool sized to 8
     low-priority requests, then 2 arrivals at priority 5; gates:
     preemptions >= 1, every victim resumes to its budget, each
     re-admission a prefix hit, tokens equal an uninterrupted serve's or
     split at a near tie, no new graph key captured for the resumed
     decode, the audit clean after every tick.  (b) ``chaos_run``:
     ``ChaosConfig(seed=7, rate=0.05)`` over 24 requests of 16-128
     tokens at priorities 0, 1 and 5; gates: ``step()`` never raises,
     the audit after every step, every request terminal, the kernel,
     drop, delay, nan and pressure sites each fired, a second fresh
     engine at the seed gives the same schedule, statuses and tokens bit
     for bit; the counters printed.  (c) ``degraded_mode``: one kernel
     fault; gates: while degraded no kernel launches and the plain
     versions' launches counted, after ``RECOVER_CHUNKS`` clean chunks
     the kernels launch again and every chunk replays its graph, tokens
     equal a clean serve's or split at a near tie, a monkey at rate 0
     gives the clean serve's tokens and launches.  (d)
     ``chaos_vs_cpu``: (b)'s run at 2 layers in fp32 on the card and on
     the CPU path (in a process of its own, started with the phase and
     run beside (a)-(c)): the same schedule and statuses, tokens equal
     (phase 5's rule).  Every other phase fails on a plain launch
     (``launch_counts``), on a fault counter of a serve (``healthy``) and
     on an engine entering degraded mode (its warning is an error
     there).  The line after ``{"dryrun": ...}`` is ``{"faults": ...}``.
 18. the journal and the supervisor (``journal_and_supervisor``): (a)
     ``supervised_crash``: qwen3-0.6b ``sparse()`` at full width and all
     28 layers, bf16, phase 17's serve geometry with a pinned 64-row
     head; phase 4's 16 requests with 32 new tokens served uninterrupted
     (cold, then two warm serves), journaled (the same) and under the
     ``Supervisor`` with ``ChaosConfig(seed=7, rate=0.0,
     crash_tick=CRASH_AT)`` and a snapshot every ``SNAPSHOT_EVERY``
     ticks; gates: one restart, every handle's streamed events joined
     are its tokens (indices 0..n-1 once each), tokens equal the
     uninterrupted serve's or split at a near tie, the audit clean after
     every step with one journaled pin after the restart, the prefix
     handle re-bound, no capture live at the crash, the teardown frees at
     least the dead engine's cache and ``memory_allocated`` after the
     restored serve is within 1% of the uninterrupted engine's (both
     read with cuBLAS's per-stream workspaces released); printed:
     the recovery's ms, the restored engine's capture and instantiate s,
     warm tok/s plain against journaled, the fsyncs.  (b)
     ``supervised_hang`` at ``fault_config()``: a watchdog
     ``HANG_MARGIN`` times the slowest steady step of a cold journaled
     serve, a stall ``STALL_MARGIN`` times the watchdog from tick
     ``HANG_AT``; gates: one watchdog trip and one restart, tokens equal
     or split at a near tie, the fresh engine captures again and no
     warm-up or capture step trips the watchdog.  (c) ``exact_crash``: a
     supervised crash at 2 layers fp32 on the card against the
     uninterrupted serve of the port's CPU path (in a process of its own,
     ``--journal-cpu-reference``, started with the phase): every token
     equal.  The line after ``{"faults": ...}`` is ``{"journal": ...}``.

The line before the last is a JSON object with every kernel's launches,
error and times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
FP32_FLOPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
RTOL, ATOL = 2e-2, 1e-2            # bf16 tolerance of tests/test_kernels.py
GAP_TOL = 1e-2                     # phases 5 and 7: a token split needs a
#                                    top-2 logit gap below this, or (bf16
#                                    logits) within two steps of their own
#                                    resolution: see ``near_tie``
CNN_RTOL = 1e-3                    # phase 6: float32 logits, cuDNN against
#                                    the CPU convolutions (other algorithms
#                                    and summation orders through up to 57
#                                    layers), relative to the largest logit
CNN_BATCH = 32
SEED = 0


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, n: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of ``fn()`` issued eagerly from Python (CUDA
    events, warmed): the device time or the host's launch time, whichever
    is longer."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, reps)


def device_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds of ``fn()``: ``reps`` calls captured in
    one CUDA graph and replayed, so the host's launch cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay, 3) / reps
    del graph
    return ms


def timings(kernel, plain, library, copies: int) -> dict:
    """Per-call device ms of the kernel, its plain version and the library
    yardstick (each ``fn`` makes ``copies`` calls), plus the kernel's
    eager per-call ms."""
    return dict(ms=device_ms(kernel) / copies,
                plain_ms=device_ms(plain, reps=3) / copies,
                library_ms=device_ms(library) / copies,
                eager_ms=cuda_ms(kernel) / copies)


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version (max abs err "
            f"{err.max().item():.3e}, {int(bad.sum())} elements outside "
            f"rtol={RTOL} atol={ATOL})")
    return err.max().item()


def ptxas_table(report: str) -> list:
    """(kernel, registers, spill line) of each function in an
    ``nvcc -Xptxas -v`` report, the names demangled where ``c++filt``
    is on the PATH."""
    rows, fn, spills = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        elif "spill stores" in line:
            spills = line.strip().split(", ", 1)[-1]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            rows.append([fn, int(m.group(1)), spills])
            fn = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60)
        for r, name in zip(rows, names.stdout.splitlines()):
            r[0] = name.replace("(anonymous namespace)::", "") \
                .removeprefix("void ").split("(")[0]
    return rows


# --- phase 3: each kernel against its plain version -------------------------

def layer_projections(cfg):
    """(name, K, N) of the seven projections of one layer of ``cfg``."""
    d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    return [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
            ("w_in", d, ff), ("w_gate", d, ff), ("w_out", ff, d)]


SWEEP_M = (1, 5, 8, 17, 128, 200)   # decode, ragged and prefill rows
TIMED_M = (8, 128)                  # decode at 8 slots; a 128-token prompt


def log_plans(name: str, M: int, plans) -> None:
    """The bf16 launch plan (``kernels.*.plan``) of each ``(projection,
    plan)``."""
    parts = [f"{proj} {p['route']} bm{p['bm']} bn{p['bn']} "
             f"split{p['split']} steps{p['steps_per_block']} grid{p['grid']}"
             + (f" ks{p['ks']}" if "ks" in p else "")
             for proj, p in plans]
    log(f"[plan] {name} M={M}: " + "; ".join(parts))


def check_nm_spmm(cfg, dev, copies: int = 4, projections=None,
                  sweep=SWEEP_M, timed=TIMED_M, what="layer",
                  g: int = 128) -> dict:
    """Each projection geometry of ``projections`` (default: the seven of
    one layer) at every M of ``sweep`` against the plain version; timed
    at ``timed`` per ``what`` (a layer, an expert): ``copies`` of distinct
    packs, so the weights stream from HBM as they do through the model's
    layers (one layer of stablelm-12b or qwen2-vl-72b is already
    0.28-0.88 G of weights), and each projection alone against cuBLAS
    and its bound (a small one stays in the L2 across the replays).  The
    packs keep their 2:4 positions per ``g`` columns."""
    from repro_torch.core import pruning, sparsity
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels import ref
    projections = projections or layer_projections(cfg)
    n_proj = len(projections)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    packs, dense = [], []
    for _ in range(copies):
        for _, k, n in projections:
            w = (torch.randn((k, n), generator=gen, device=dev)
                 / k ** 0.5).to(torch.bfloat16)
            pw, _ = pruning.n_m(w, 2, 4, group=g)
            packs.append(sparsity.pack_nm(pw, 2, 4, g=g))
            dense.append(pw)
    err, rows = 0.0, {}
    for M in sweep:
        log_plans(f"nm_spmm {cfg.name}", M,
                  [(proj, K.plan(M, k, n, torch.bfloat16, 2, 4, g))
                   for proj, k, n in projections])
        xs = {k: torch.randn((M, k), generator=gen, device=dev)
              .to(torch.bfloat16) for _, k, _ in projections}
        err_m = max(check_close(f"nm_spmm M={M} K={p.K} N={p.N}",
                                K.nm_spmm(xs[p.K], p),
                                ref.nm_spmm_ref(xs[p.K], p))
                    for p in packs[:n_proj])
        log(f"[kernels] nm_spmm {cfg.name} M={M}: max abs err {err_m:.3e} "
            "against the plain version")
        err = max(err, err_m)
        if M not in timed:
            continue
        costs = [K.cost(M, p.K, p.N, torch.bfloat16, 2, 4, g)
                 for p in packs[:n_proj]]
        b, by = bound_ms(sum(c["bytes"] for c in costs),
                         sum(c["flops"] for c in costs))
        rows[M] = dict(
            **timings(lambda: [K.nm_spmm(xs[p.K], p) for p in packs],
                      lambda: [ref.nm_spmm_ref(xs[p.K], p) for p in packs],
                      lambda: [torch.matmul(xs[w.shape[0]], w)
                               for w in dense], copies),
            bound_ms=b, bound_by=by)
        log(f"[kernels] nm_spmm {cfg.name} one {what}'s {n_proj} projections"
            f" at M={M}: {json.dumps(rows[M])}")
        for (proj, _, _), p, w in zip(projections, packs, dense):
            x = xs[p.K]
            c = K.cost(M, p.K, p.N, torch.bfloat16, 2, 4, g)
            b, by = bound_ms(c["bytes"], c["flops"])
            log(f"[kernels] nm_spmm {cfg.name} {proj} M={M}: " + json.dumps(
                dict(ms=device_ms(lambda: K.nm_spmm(x, p)),
                     library_ms=device_ms(lambda: torch.matmul(x, w)),
                     bound_ms=b, bound_by=by)))
    return dict(name="nm_spmm", source="src/repro_torch/csrc/nm_spmm.cu",
                replaces="src/repro/kernels/nm_spmm.py:68",
                max_abs_err=err, **rows[timed[0]])


def log_attn_plan(name: str, what: str, plan: dict) -> None:
    log(f"[plan] {name} {what}: " + " ".join(
        f"{k}={v}" for k, v in plan.items()))


#: phase 3's paged-attention calls: (lens case, Q, q dtype); the first is
#: the kernel's row of the ``kernels`` line; Q > 1 are verify blocks (Q =
#: 4 is phase 8's, Q = 16 gives Q * G = 32 to 128 rows, several row
#: tiles); fp32 q takes the FMA route
PAGED_CASES = (("mixed", 1, torch.bfloat16), ("serve", 1, torch.bfloat16),
               ("mixed", 4, torch.bfloat16), ("mixed", 1, torch.float32),
               ("mixed", 4, torch.float32), ("mixed", 16, torch.bfloat16))


def check_paged_attention(cfg, dev, copies: int = 12, cases=PAGED_CASES,
                          mp: int = 32, lens_of=None, window=None,
                          softcap=None) -> dict:
    """Decode attention at B = 8 slots over a 256-page pool of 16-row
    pages, an ``mp``-page view (default 32: 512 rows), held against the
    plain version at each of ``cases`` (default ``PAGED_CASES``): mixed
    lens with one dead slot (its rows must be exactly zero, two calls
    bitwise equal) and the serve's own lens, 129..192, one query per
    slot, bf16 and fp32 q (the tensor-core and the FMA route); verify
    blocks of Q = 4 (bf16 and fp32 q) and Q = 16.  With a ``window``
    and a ``softcap`` (gemma's local layers) every call takes them.
    Each is timed over ``copies`` pools, so the live rows (5.7 MB a pool
    at qwen3's heads) stream from HBM rather than the 50 MB L2, as one
    layer's do in a decode step, beside SDPA over the gathered view under
    the same causal (and window) mask; SDPA has no softcap, so its time
    is without one.  The bound counts the rows each query reaches, the
    window's rows only under a window."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.kernels import ref
    B, H, Hk, D, ps, P = 8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        16, 257
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED)
    ptab = torch.from_numpy(np.stack([rng.permutation(np.arange(1, P))[:mp]
                                      for _ in range(B)]).astype(np.int32))
    ptab = ptab.to(dev)
    pools = [tuple(torch.randn((P, ps, Hk, D), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(2))
             for _ in range(copies)]
    kp, vp = pools[0]
    lens_of = lens_of or {
        "mixed": [0, 1, 17, 64, 130, 256, 400, 512],
        "serve": sorted(rng.integers(129, 193, size=B).tolist())}
    kw = dict(window=window, softcap=softcap)
    extra = "".join(f" {k}={v}" for k, v in kw.items() if v is not None)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    views = {}                       # the gathered (B, H, L, D) view
    err, rows = {}, {}
    for what, Q, dtype in cases:
        lens_l = lens_of[what]
        lens_np = np.asarray(lens_l, np.int32)
        lens = torch.from_numpy(lens_np).to(dev)
        shape = (B, H, D) if Q == 1 else (B, Q, H, D)
        q = torch.randn(shape, generator=gen, device=dev).to(dtype)
        name = f"{str(dtype)[6:]} B={B} H={H} Hk={Hk} D={D} Q={Q} " \
            f"lens={what}{extra}"
        log_attn_plan("paged_attention", name,
                      K.plan(B, H, Hk, Q, mp, D, (q.dtype, kp.dtype), ps))
        got = K.paged_attention(q, kp, vp, ptab, lens, **kw)
        err[name] = check_close(
            f"paged_attention {name}", got,
            ref.paged_attention_ref(q, kp, vp, ptab, lens, **kw))
        if not torch.equal(got, K.paged_attention(q, kp, vp, ptab, lens,
                                                  **kw)):
            raise AssertionError(f"paged_attention {name}: two calls differ")
        if lens_l[0] == 0 and (got[0] != 0).any():
            raise AssertionError(f"paged_attention {name}: the lens == 0 "
                                 "row is not zero")
        if dtype not in views:
            views[dtype] = [[t[ptab.long()].reshape(B, mp * ps, Hk, D)
                             .transpose(1, 2).repeat_interleave(H // Hk, 1)
                             .to(dtype).contiguous() for t in kv]
                            for kv in pools]
        # query i at lens - Q + i sees the keys up to it (and after it
        # less the window): keys [first, reach) of the view
        qpos = lens_np[:, None] - Q + np.arange(Q)              # (B, Q)
        reach = np.clip(qpos + 1, 0, mp * ps)
        first = np.clip(qpos - window + 1 if window else 0 * qpos, 0, reach)
        kpos = torch.arange(mp * ps, device=dev)[None, None, :]
        mask = ((kpos < torch.from_numpy(reach).to(dev)[:, :, None])
                & (kpos >= torch.from_numpy(first).to(dev)[:, :, None])
                )[:, None]
        qs = (q[:, None] if Q == 1 else q).transpose(1, 2)  # (B, H, Q, D)
        lo, hi = first.min(1), reach.max(1)                 # rows read
        live = int(np.maximum(hi - lo, 0).sum())
        pages = int(sum(-(-int(h) // ps) - int(l) // ps
                        for l, h in zip(lo, hi) if h > l))
        c = K.cost(B, H, Hk, Q, mp, D, (q.dtype, pools[0][0].dtype), ps,
                   pairs=int((reach - first).sum()), rows=live, pages=pages)
        b, by = bound_ms(c["bytes"], c["flops"],
                         BF16_FLOPS_PER_S if dtype == torch.bfloat16
                         else FP32_FLOPS_PER_S)
        rows[what, Q, dtype] = dict(
            **timings(lambda: [K.paged_attention(q, k, v, ptab, lens, **kw)
                               for k, v in pools],
                      lambda: [ref.paged_attention_ref(q, k, v, ptab, lens,
                                                       **kw)
                               for k, v in pools],
                      lambda: [sdpa(qs, k, v, attn_mask=mask)
                               for k, v in views[dtype]], copies),
            bound_ms=b, bound_by=by)
        log(f"[kernels] paged_attention {name} lens={lens_l}: "
            f"{json.dumps(rows[what, Q, dtype])}")
    log("[kernels] paged_attention max abs err against the plain version: "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + "; the lens == 0 rows zero; two calls bitwise equal"
        + ("; SDPA timed without the softcap" if softcap else ""))
    return dict(name="paged_attention",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:107",
                max_abs_err=max(err.values()),
                **rows[cases[0]])


def check_flash_attention(cfg, dev, lengths=(128, 200)) -> dict:
    """Prefill attention of one prompt, timed at each of ``lengths``
    (default L = 128 and a ragged 200) in bf16 (the tensor-core route, or
    the FMA route where the head dim has none) and fp32 (the FMA route);
    phase 7's
    suffixes of a shared prefix (``SUFFIX_SHAPES``), checked and timed
    against SDPA under a lower-right causal mask; checked, not timed: a
    suffix (37 queries over 200 keys) and a window with softcap.  The
    row's ``max_abs_err`` is the bf16 calls' largest."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref
    H, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def qkv(Lq, Lk, dtype=torch.bfloat16):
        return [torch.randn((1, h, n, D), generator=gen, device=dev).to(dtype)
                for h, n in ((H, Lq), (Hk, Lk), (Hk, Lk))]

    err, rows = {torch.bfloat16: 0.0, torch.float32: 0.0}, {}
    for dtype in err:
        for L in lengths:
            q, k, v = qkv(L, L, dtype)
            what = f"{str(dtype)[6:]} B=1 H={H} Hk={Hk} D={D} L={L}"
            log_attn_plan("flash_attention", what,
                          K.plan(1, H, Hk, L, L, D, q.dtype))
            err[dtype] = max(err[dtype], check_close(
                f"flash_attention {what}", K.flash_attention(q, k, v),
                ref.mha_ref(q.float(), k.float(), v.float())))
            kr, vr = (t.repeat_interleave(H // Hk, dim=1) for t in (k, v))
            c = K.cost(1, H, Hk, L, L, D, dtype, pairs=L * (L + 1) / 2)
            b, by = bound_ms(c["bytes"], c["flops"],
                             BF16_FLOPS_PER_S if dtype == torch.bfloat16
                             else FP32_FLOPS_PER_S)
            rows[L, dtype] = dict(
                **timings(lambda: K.flash_attention(q, k, v),
                          lambda: ref.mha_ref(q, k, v),
                          lambda: sdpa(q, kr, vr, is_causal=True), 1),
                bound_ms=b, bound_by=by)
            log(f"[kernels] flash_attention {what}: "
                f"{json.dumps(rows[L, dtype])}")
    from torch.nn.attention.bias import causal_lower_right
    for Lq, Lk in SUFFIX_SHAPES:
        q, k, v = qkv(Lq, Lk)
        log_attn_plan("flash_attention", f"bf16 suffix Lq={Lq} Lk={Lk}",
                      K.plan(1, H, Hk, Lq, Lk, D, q.dtype))
        err[torch.bfloat16] = max(err[torch.bfloat16], check_close(
            f"flash_attention suffix Lq={Lq} Lk={Lk}",
            K.flash_attention(q, k, v),
            ref.mha_ref(q.float(), k.float(), v.float())))
        kr, vr = (t.repeat_interleave(H // Hk, dim=1) for t in (k, v))
        mask = causal_lower_right(Lq, Lk)
        c = K.cost(1, H, Hk, Lq, Lk, D, torch.bfloat16,
                   pairs=Lq * (Lk - Lq) + Lq * (Lq + 1) / 2)
        b, by = bound_ms(c["bytes"], c["flops"])
        row = dict(**timings(lambda: K.flash_attention(q, k, v),
                             lambda: ref.mha_ref(q, k, v),
                             lambda: sdpa(q, kr, vr, attn_mask=mask), 1),
                   bound_ms=b, bound_by=by)
        log(f"[kernels] flash_attention B=1 H={H} Hk={Hk} D={D} suffix "
            f"Lq={Lq} Lk={Lk} (SDPA with a lower-right causal mask): "
            f"{json.dumps(row)}")
    for what, (Lq, Lk, kw) in {
            "suffix Lq=37 Lk=200": (37, 200, {}),
            "window 64 softcap 30 L=200": (200, 200,
                                           dict(window=64, softcap=30.0))
    }.items():
        q, k, v = qkv(Lq, Lk)
        err[torch.bfloat16] = max(err[torch.bfloat16], check_close(
            f"flash_attention {what}", K.flash_attention(q, k, v, **kw),
            ref.mha_ref(q.float(), k.float(), v.float(), **kw)))
    Ls = ", ".join(map(str, lengths))
    log(f"[kernels] flash_attention H={H} Hk={Hk} D={D} max abs err "
        f"{err[torch.bfloat16]:.3e} (bf16: L = {Ls}, phase 7's "
        f"suffixes, window + softcap), {err[torch.float32]:.3e} (fp32: L = "
        f"{Ls}) against the plain version")
    return dict(name="flash_attention",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:97",
                max_abs_err=err[torch.bfloat16],
                **rows[lengths[0], torch.bfloat16])


#: (queries, keys) of phase 7's suffix prefills: a 48-token suffix after
#: the 64-row head, a full-match repeat recomputing its last row, and a
#: prompt diverging at row 40 of 96
SUFFIX_SHAPES = ((48, 112), (1, 96), (56, 96))

FORMATS = {   # the other pack formats, as the JAX tests declare them
    "combined": dict(format="combined", sparsity=0.5, n=2, m=4,
                     block_k=128, block_n=128),
    "block": dict(format="block", sparsity=0.5, block_k=128, block_n=128),
    "lookahead": dict(format="lookahead", sparsity=0.5),
}
TILE = 128


def zero_half_tiles(w: torch.Tensor, rng, empty_strip: bool = False
                    ) -> torch.Tensor:
    """``w`` with exactly half of its ``(128, 128)`` tiles zeroed, chosen
    by ``rng``; with ``empty_strip`` the first N-strip's tiles are among
    them, so a block pack has a strip with ``counts == 0``."""
    K, N = w.shape
    Kb, Nb = K // TILE, N // TILE
    zero = np.zeros(Kb * Nb, bool)
    if empty_strip:
        zero[np.arange(Kb * Nb) % Nb == 0] = True
    if zero.sum() > Kb * Nb // 2:
        raise ValueError(f"one strip of {w.shape} is more than half its "
                         "tiles")
    rest = np.flatnonzero(~zero)
    zero[rng.permutation(rest)[:Kb * Nb // 2 - int(zero.sum())]] = True
    keep = torch.from_numpy(~zero.reshape(Kb, Nb)).to(w.device)
    return w * keep.repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)


def pack_strip(w: torch.Tensor, fmt: str):
    """The pruned ``w`` and its ``fmt`` (block or combined) pack of
    (128, 128) tiles, padded one slot past the largest strip count."""
    from repro_torch.core import pruning, sparsity
    if fmt == "block":
        pw, _ = pruning.block_semi_structured(w, 0.5, block=TILE)
        p = sparsity.pack_block_sparse(pw, TILE, TILE)
        return pw, sparsity.pack_block_sparse(pw, TILE, TILE,
                                              pad_to=p.max_nnz + 1)
    pw, _ = pruning.combined_nm(w, 0.5, 2, 4, group=TILE, block=TILE)
    p = sparsity.pack_combined(pw, 2, 4, TILE, TILE)
    return pw, sparsity.pack_combined(pw, 2, 4, TILE, TILE,
                                      pad_to=p.max_nnz + 1)


def strip_packs(cfg, dev, fmt: str, copies: int, seed: int):
    """``copies`` layers of seven tile-zeroed projections (the first strip
    empty) packed in ``fmt`` by ``pack_strip``; with the pruned dense
    weights."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    packs, dense = [], []
    for _ in range(copies):
        for _, k, n in layer_projections(cfg):
            w = zero_half_tiles((torch.randn((k, n), generator=gen,
                                             device=dev) / k ** 0.5)
                                .to(torch.bfloat16), rng, empty_strip=True)
            pw, p = pack_strip(w, fmt)
            counts = p.counts.tolist()
            assert counts[0] == 0 and max(counts) < p.max_nnz
            assert p.density == 0.5, p.density
            packs.append(p)
            dense.append(pw)
    return packs, dense


def check_strip_kernel(cfg, dev, fmt: str, copies: int) -> dict:
    """``bsr_matmul`` (block) or ``csa_matmul`` (combined) on one layer's
    seven tile-zeroed projections at every M of ``SWEEP_M``: held against
    the plain version, the empty first strip must come back zero and two
    calls bitwise equal; timed at ``TIMED_M`` over ``copies`` layers of
    distinct packs so the kept tiles stream from HBM."""
    from repro_torch.kernels import bsr_matmul, csa_matmul, ref
    if fmt == "block":
        name, mod, plain = "bsr_matmul", bsr_matmul, ref.bsr_matmul_ref
    else:
        name, mod, plain = "csa_matmul", csa_matmul, ref.csa_matmul_ref
    kernel = getattr(mod, name)
    packs, dense = strip_packs(cfg, dev, fmt, copies, SEED + 3)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    err, rows = 0.0, {}
    for M in SWEEP_M:
        log_plans(name, M, [
            (proj, mod.plan(M, p.K, p.N, torch.bfloat16, p.max_nnz))
            for (proj, _, _), p in zip(layer_projections(cfg), packs)])
        xs = {k: torch.randn((M, k), generator=gen, device=dev)
              .to(torch.bfloat16) for _, k, _ in layer_projections(cfg)}
        err_m = 0.0
        for p in packs[:7]:
            what = f"{name} M={M} K={p.K} N={p.N}"
            got = kernel(xs[p.K], p)
            if not torch.equal(got, kernel(xs[p.K], p)):
                raise AssertionError(f"{what}: two calls differ")
            if (got[:, :p.bn] != 0).any():
                raise AssertionError(f"{what}: the empty strip is not zero")
            err_m = max(err_m, check_close(what, got, plain(xs[p.K], p)))
        log(f"[kernels] {name} M={M}: max abs err {err_m:.3e} against the "
            "plain version; empty strip zero; two calls bitwise equal")
        err = max(err, err_m)
        if M not in TIMED_M:
            continue
        # the tiles this run's data holds (counts.sum()), not every slot
        costs = [(bsr_matmul.cost(M, p.K, p.N, torch.bfloat16, p.max_nnz,
                                  p.bk, p.bn, nnz=int(p.counts.sum()))
                  if fmt == "block" else
                  csa_matmul.cost(M, p.K, p.N, torch.bfloat16, p.max_nnz,
                                  p.bk, p.bn, p.n, p.m,
                                  nnz=int(p.counts.sum())))
                 for p in packs[:7]]
        b, by = bound_ms(sum(c["bytes"] for c in costs),
                         sum(c["flops"] for c in costs))
        rows[M] = dict(
            **timings(lambda: [kernel(xs[p.K], p) for p in packs],
                      lambda: [plain(xs[p.K], p) for p in packs],
                      lambda: [torch.matmul(xs[w.shape[0]], w)
                               for w in dense], copies),
            bound_ms=b, bound_by=by)
        log(f"[kernels] {name} one layer's 7 projections at M={M}, tile "
            f"density 0.50: {json.dumps(rows[M])}")
    return dict(name=name, source=f"src/repro_torch/csrc/{name}.cu",
                replaces={"bsr_matmul": "src/repro/kernels/bsr_matmul.py:63",
                          "csa_matmul": "src/repro/kernels/csa_matmul.py:56"
                          }[name],
                max_abs_err=err, **rows[8])


def check_lookahead(cfg, dev, copies: int = 4) -> dict:
    """``lookahead_matmul`` on one layer's seven projections (pruned at
    block 4 after zeroing half of each weight's tiles) at every M of
    ``SWEEP_M``, timed at ``TIMED_M`` over ``copies`` layers; then the
    bit-exact check of ``tests/test_kernels.py::test_lookahead_int7_exact``
    on the card."""
    from repro_torch.core import encoding, pruning, sparsity
    from repro_torch.kernels import lookahead_decode as K
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    packs, dense = [], []
    for _ in range(copies):
        for _, k, n in layer_projections(cfg):
            w = zero_half_tiles((torch.randn((k, n), generator=gen,
                                             device=dev) / k ** 0.5)
                                .to(torch.bfloat16), rng)
            pw, _ = pruning.block_semi_structured(w, 0.5, block=4)
            p = sparsity.LookaheadPack.from_float(pw)
            packs.append(p)
            dense.append(p.decode().to(torch.bfloat16))
    err, rows = 0.0, {}
    for M in SWEEP_M:
        log_plans("lookahead_matmul", M,
                  [(proj, K.plan(M, k, n, torch.bfloat16))
                   for proj, k, n in layer_projections(cfg)])
        xs = {k: torch.randn((M, k), generator=gen, device=dev)
              .to(torch.bfloat16) for _, k, _ in layer_projections(cfg)}
        err_m = max(check_close(f"lookahead_matmul M={M} K={p.K} N={p.N}",
                                K.lookahead_matmul(xs[p.K], p),
                                ref.lookahead_matmul_ref(xs[p.K], p))
                    for p in packs[:7])
        log(f"[kernels] lookahead_matmul M={M}: max abs err {err_m:.3e} "
            "against the plain version")
        err = max(err, err_m)
        if M not in TIMED_M:
            continue
        costs = [K.cost(M, p.K, p.N, torch.bfloat16) for p in packs[:7]]
        b, by = bound_ms(sum(c["bytes"] for c in costs),
                         sum(c["flops"] for c in costs))
        rows[M] = dict(
            **timings(lambda: [K.lookahead_matmul(xs[p.K], p)
                               for p in packs],
                      lambda: [ref.lookahead_matmul_ref(xs[p.K], p)
                               for p in packs],
                      lambda: [torch.matmul(xs[w.shape[0]], w)
                               for w in dense], copies),
            bound_ms=b, bound_by=by)
        log(f"[kernels] lookahead_matmul one layer's 7 projections at "
            f"M={M}: {json.dumps(rows[M])}")
    ints = torch.from_numpy(rng.integers(-64, 64, size=(1024, 1024))
                            .astype(np.int8))
    exact = sparsity.LookaheadPack(
        enc=encoding.encode_weight_matrix(ints).to(dev),
        scale=torch.ones((1, 1024), device=dev), K=1024, N=1024)
    eye = torch.eye(1024, device=dev, dtype=torch.bfloat16)
    if K.plan(1024, 1024, 1024, eye.dtype)["route"] != "mma":
        raise AssertionError("bf16 x must take the tensor-core route")
    out = K.lookahead_matmul(eye, exact)
    if not torch.equal(out.float().cpu(), ints.float()):
        raise AssertionError("lookahead_matmul is not bit-exact on integer "
                             "weights")
    log("[kernels] lookahead_matmul reproduces 1024x1024 int7 weights "
        "bit-exactly on the tensor-core route (identity x, scale 1)")
    return dict(name="lookahead_matmul",
                source="src/repro_torch/csrc/lookahead_decode.cu",
                replaces="src/repro/kernels/lookahead_decode.py:62",
                max_abs_err=err, **rows[8])


# --- phases 4 and 5 --------------------------------------------------------

def dense_model(cfg, dev, seed, zero_tiles: bool = False):
    """Random dense params from ``seed``; ``zero_tiles`` zeroes exactly
    half of each projection's tiles."""
    from repro_torch import models
    params = models.init_model(cfg, seed=seed, device=dev)
    if zero_tiles:
        rng = np.random.default_rng(seed)
        for layer in params["layers"]:
            for fam, names in (("attn", ("wq", "wk", "wv", "wo")),
                               ("mlp", ("w_in", "w_gate", "w_out"))):
                for name in names:
                    layer[fam][name] = zero_half_tiles(layer[fam][name], rng)
    return params


def sparse_model(cfg, dev, seed, zero_tiles: bool = False):
    """:func:`dense_model`'s params packed per ``cfg``."""
    from repro_torch.core.sparse_linear import pack_params
    return pack_params(dense_model(cfg, dev, seed, zero_tiles), cfg)


def pack_summary(params) -> str:
    """Tile density of the block/combined packs, or the share of zero
    4-blocks the lookahead skip bits encode."""
    from repro_torch.core import encoding
    from repro_torch.core.sparsity import LookaheadPack
    weights = [w for layer in params["layers"] for fam in layer.values()
               for w in fam.values()]
    looks = [w for w in weights if isinstance(w, LookaheadPack)]
    strips = [w for w in weights if hasattr(w, "counts")]
    if looks:
        zero = sum(int(encoding.block_is_zero(encoding.decode_values(
            p.enc).T).sum()) for p in looks)
        blocks = sum(p.K * p.N // 4 for p in looks)
        return f"zero 4-block share {zero / blocks:.4f}"
    if strips:
        kept = sum(int(p.counts.sum()) for p in strips)
        tiles = sum((p.K // p.bk) * (p.N // p.bn) for p in strips)
        return f"tile density {kept / tiles:.4f}"
    return "no tile skipping"


#: the wrappers' counts of a kind of their launches, and the tag of each
#: in :func:`launch_counts`: verify blocks (paged Q > 1), the tensor-core
#: route and the launches with a sliding window (both attention kernels),
#: the half-stage launches (the matmul kernels)
SUB_COUNTS = {"block_launches": "Q>1", "mma_launches": "mma",
              "noncausal_launches": "non-causal",
              "window_launches": "window", "half_launches": "half",
              "plain_launches": "plain"}


def zero_counts(counters) -> None:
    """Set every wrapper's launch counts to 0."""
    for mod in counters:
        mod.launches = 0
        for attr in SUB_COUNTS:
            if hasattr(mod, attr):
                setattr(mod, attr, 0)


def counted(launches: dict) -> list:
    """The kernel names of a :func:`launch_counts` dict."""
    return [name for name in launches if " " not in name]


def launch_counts(counters, plain_ok: bool = False) -> dict:
    """Each wrapper's launches by kernel module name, ``paged_attention
    Q>1`` (the paged launches of a verify block), ``<kernel> mma``, the
    attention launches on the tensor-core route, and ``<kernel> plain``,
    the plain versions a degraded engine ran on the card in the kernel's
    place: anywhere but phase 17 (c) (``plain_ok``) a plain launch
    fails the phase, so degraded mode never stands in for a kernel."""
    got = {mod.__name__.rsplit(".", 1)[1]: mod.launches for mod in counters}
    for mod in counters:
        for attr, tag in SUB_COUNTS.items():
            if hasattr(mod, attr):
                got[f"{mod.__name__.rsplit('.', 1)[1]} {tag}"] = \
                    getattr(mod, attr)
    plain = {k: n for k, n in got.items() if k.endswith(" plain") and n}
    if plain and not plain_ok:
        raise AssertionError(f"plain versions ran on the card in the "
                             f"kernels' place: {plain}")
    return got


def healthy(tag: str, st) -> None:
    """A serve outside phase 17 contains no fault: no kernel failure, no
    fetch error, no numeric fault, and the engine never degraded."""
    bad = {k: getattr(st, k) for k in ("kernel_failures", "fetch_errors",
                                        "numeric_faults", "degraded")
           if getattr(st, k)}
    if bad:
        raise AssertionError(f"{tag}: the fault layer acted: {bad}")


def phase4_prompts(vocab: int, requests: int = 16) -> list:
    """Phase 4's stream: ``requests`` random prompts of 16-128 tokens."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(1, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(16, 129, size=requests)]


def serve_prompts(eng, prompts, counters) -> tuple:
    """Serve ``prompts`` on ``eng`` (launch counts and stats set to 0 just
    before, read just after): (tokens per request, report, launches).
    Every request must reach its budget within the vocabulary and
    ``sync_count`` must equal the number of decode chunks."""
    eng.reset_stats()
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    handles = [eng.submit(p) for p in prompts]
    step_s = []                  # whole ticks: admission + prefill + chunk
    while eng.num_queued or eng.num_live:
        if len(step_s) > 4 * len(prompts):
            raise AssertionError("the serve does not drain")
        t1 = time.perf_counter()
        eng.step()
        step_s.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(counters)
    st = eng.stats()
    healthy(eng.cfg.name, st)
    outs = [h.tokens for h in handles]
    budget = eng.scfg.max_new_tokens
    if not all(h.status.value == "done" and len(o) == budget
               for h, o in zip(handles, outs)):
        raise AssertionError("a request did not finish with its budget: "
                             f"{[len(o) for o in outs]}")
    if not all(0 <= t < eng.cfg.vocab_size for o in outs for t in o):
        raise AssertionError("a token outside the vocabulary")
    if st.sync_count != len(st.chunk_s):
        raise AssertionError(f"sync_count {st.sync_count} != "
                             f"{len(st.chunk_s)} chunks")
    ntok = sum(len(o) for o in outs)
    ttft = sorted(h.ttft_s for h in handles)
    replays = [t for t, (_, how) in zip(st.chunk_s, st.chunk_runs)
               if how == "replay"]
    return outs, {
        "requests": len(handles), "tokens": ntok,
        "tok_per_s": ntok / wall, "wall_s": wall,
        "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
        "decode_ms_per_step": 1e3 * sum(st.chunk_s)
        / (len(st.chunk_s) * eng.scfg.decode_chunk),
        "replay_ms_per_step": 1e3 * sum(replays)
        / (len(replays) * eng.scfg.decode_chunk) if replays else None,
        "step_ms": [round(1e3 * t, 1) for t in step_s],
        "chunk_ms": [round(1e3 * t, 1) for t in st.chunk_s],
        "chunks": len(st.chunk_s), "sync_count": st.sync_count,
        "tokens_per_chunk": ntok / len(st.chunk_s),
        "drafted": st.drafted, "accepted": st.accepted,
        "acceptance_rate": st.acceptance_rate,
        "prefills": st.prefills, "peak_pages": st.peak_pages,
        "launches": launches,
        "chunk_runs": {how: sum(h == how for _, h in st.chunk_runs)
                       for how in ("eager", "capture", "replay")},
        "captures": st.graph_captures,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }, launches


#: phase 4's warm graph ms per decode step, per format (phase 16 (a)
#: prints the dry run's bound against nm's)
WARM_MS_PER_STEP: dict = {}


def serve_full_width(cfg, dev, counters, path, *, requests: int = 16,
                     max_new: int = 64, zero_tiles: bool = False,
                     profile: bool = True) -> dict:
    """Serve ``requests`` random prompts of 16–128 tokens through the
    paged Engine, its decode chunks as CUDA graphs; ``path`` names the
    kernels that must launch, every other module of ``counters`` must
    not.  With ``profile``, the ``[graph]`` turns against the eager body
    and one profiled replayed chunk follow."""
    from repro_torch.serving import Engine, ServeConfig
    fmt = cfg.mlp_sparsity.format
    t0 = time.perf_counter()
    params = sparse_model(cfg, dev, SEED, zero_tiles=zero_tiles)
    torch.cuda.synchronize()
    log(f"[serve {fmt}] {cfg.name} {cfg.n_layers} layers "
        f"d_model={cfg.d_model} {cfg.dtype}: random init + pack in "
        f"{time.perf_counter() - t0:.1f} s, {pack_summary(params)}")
    scfg = ServeConfig(slots=8, max_len=512, prompt_pad=128, page_size=16,
                       decode_chunk=16, max_new_tokens=max_new, eos_token=-1)
    prompts = phase4_prompts(cfg.vocab_size, requests)
    eng = Engine(cfg, scfg, params, device=dev)
    cold = serve_prompts(eng, prompts, counters)
    outs, report, launches = cold
    if any((launches[name] > 0) != (name in path) for name in counted(
            launches)):
        raise AssertionError(f"{fmt}: the kernels of {sorted(path)} must "
                             f"launch and no other: {launches}")
    log(f"[serve {fmt}] {json.dumps(report)}")
    log(f"[serve {fmt}] first request's tokens: {outs[0][:16]}")
    if profile:
        turns = graph_turns(eng, prompts, counters, cold, f"graph {fmt}")
        warm = [ms for name, _, (_, rep, _) in turns if name == "graph warm"
                for ms in rep["chunk_ms"]]
        profile_decode_chunk(eng, prompts, sum(warm) / len(warm))
        WARM_MS_PER_STEP[fmt] = sum(warm) / len(warm) / scfg.decode_chunk
    return launches


def graph_nodes(graph) -> int:
    """Nodes of a captured CUDA graph (``cuGraphGetNodes`` of ``libcuda``
    on the graph its runner kept)."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    fn = cuda.cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    err = fn(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return n.value


def check_graph_runs(st, seen: dict, captured: set, graphs: bool) -> None:
    """Each chunk of one serve ran as the rule says: with graphs off
    eagerly; with graphs on a key's first chunk ever eagerly, its next
    one as the key's capture, every later one as a replay — so every key
    served past its first chunk with graphs on is in ``captured``.  The
    captures the engine recorded are exactly those chunks' keys."""
    caps = []
    for key, how in st.chunk_runs:
        n = seen.get(key, 0)
        want = ("eager" if not graphs or n == 0 else
                "replay" if key in captured else "capture")
        if how != want:
            raise AssertionError(f"chunk of key {key} ran as {how!r}, "
                                 f"the rule says {want!r}")
        if how == "capture":
            captured.add(key)
            caps.append(key)
        seen[key] = n + 1
    if [tuple(c["key"]) for c in st.graph_captures] != caps:
        raise AssertionError(f"captures recorded {st.graph_captures} are "
                             f"not the capturing chunks' keys {caps}")


def log_turn(tag: str, name: str, rep: dict) -> None:
    replay = rep["replay_ms_per_step"]
    log(f"[{tag}] {name}: decode {rep['decode_ms_per_step']:.3f} ms/step ("
        + ("no replay" if replay is None else f"replayed chunks {replay:.3f}")
        + f"), {rep['tok_per_s']:.2f} tok/s, wall {rep['wall_s']:.3f} s, "
        f"TTFT p50 {rep['ttft_p50_ms']:.1f} ms, "
        f"{rep['tokens_per_chunk']:.1f} tokens/chunk, drafted "
        f"{rep['drafted']}, accepted {rep['accepted']} (acceptance "
        f"{rep['acceptance_rate']:.4f}), sync_count {rep['sync_count']}, "
        f"chunks {rep['chunk_runs']}, peak_mem_gb {rep['peak_mem_gb']:.3f}")


def mean_of(turns, what: str, graphs: bool) -> float:
    """Mean of report key ``what`` over the warm graph (or the eager)
    turns of :func:`graph_turns`."""
    vals = [rep[what] for name, g, (_, rep, _) in turns
            if g == graphs and name != "graph cold" and rep[what] is not None]
    return sum(vals) / len(vals) if vals else float("nan")


#: the turns after a cold serve: (name, graphs on)
TURNS = (("graph warm", True), ("eager", False), ("graph warm", True),
         ("eager", False))


def graph_turns(eng, prompts, counters, cold, tag: str) -> list:
    """The ``[graph]`` turns (phases 4, 8 and 9) on the engine that just
    served ``prompts`` cold (captures included): the same stream again,
    warm with graphs on or eager with them off (the backend's private
    switch), in ``TURNS``: warm, eager, warm, eager.  Tokens,
    ``sync_count``, drafted and accepted tokens and each kernel's
    launches (verify blocks and routes included) must equal the first
    eager serve's exactly, and every key that ran twice
    has exactly one capture.  Returns the turns, ``(name, graphs, (tokens,
    report, launches))``, the cold serve first."""
    seen, captured = {}, set()
    check_graph_runs(eng.stats(), seen, captured, True)
    turns = [("graph cold", True, cold)]
    for name, graphs in TURNS:
        eng._backend._graphs = graphs
        got = serve_prompts(eng, prompts, counters)
        check_graph_runs(eng.stats(), seen, captured, graphs)
        turns.append((name, graphs, got))
    eng._backend._graphs = True
    for name, graphs, (outs, rep, launches) in turns:
        log_turn(tag, name, rep)
    runners = eng._backend._chunks
    caps = [c for _, _, (_, rep, _) in turns for c in rep["captures"]]
    for c in caps:
        key = tuple(c["key"])
        log(f"[{tag}] key (view_pages, sampled) {key}: capture "
            f"{c['capture_s']:.3f} s, instantiate {c['instantiate_s']:.3f} "
            f"s, {graph_nodes(runners[key].graph)} graph nodes")
    eager = [t for t in turns if not t[1]]
    base_outs, base_rep, base_launches = eager[0][2]
    same = ("sync_count", "drafted", "accepted")
    for name, _, (outs, rep, launches) in turns:
        if outs != base_outs:
            bad = [i for i, (a, b) in enumerate(zip(outs, base_outs))
                   if a != b]
            raise AssertionError(f"{tag} {name}: requests {bad} differ "
                                 "from the eager serve's tokens")
        if any(rep[k] != base_rep[k] for k in same):
            raise AssertionError(f"{tag} {name}: {[rep[k] for k in same]} "
                                 f"!= eager {[base_rep[k] for k in same]} "
                                 f"({', '.join(same)})")
        if launches != base_launches:
            raise AssertionError(f"{tag} {name}: launches {launches} != "
                                 f"eager {base_launches}")
    if len(caps) != len(captured):
        raise AssertionError(f"{tag}: a key was captured twice: {caps}")
    log(f"[{tag}] tokens, sync_count, drafted, accepted and launches equal "
        f"in all {len(turns)} serves; {len(caps)} captures = the "
        f"{len(captured)} keys served past their first chunk with graphs "
        f"on, of {len(seen)} keys; warm graph "
        f"{mean_of(turns, 'decode_ms_per_step', True):.3f} ms/step "
        f"(replayed chunks {mean_of(turns, 'replay_ms_per_step', True):.3f})"
        f", {mean_of(turns, 'tok_per_s', True):.2f} tok/s vs eager "
        f"{mean_of(turns, 'decode_ms_per_step', False):.3f} ms/step, "
        f"{mean_of(turns, 'tok_per_s', False):.2f} tok/s (means of 2 turns "
        "each)")
    return turns


def profile_decode_chunk(eng, prompts, warm_chunk_ms: float) -> None:
    """torch.profiler over one decode chunk with every slot live, a
    replay of a key captured earlier: the card's busy share of the
    chunk's wall time (and of ``warm_chunk_ms``, the warm graph serves'
    mean chunk wall without the profiler) and the operations that fill
    it.  Runs after the launch counts were read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[:eng.scfg.slots]:
        eng.submit(p)
    eng.step()                                 # admission + a first chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    key, how = eng.stats().chunk_runs[-1]
    eng.run()
    if how != "replay":
        raise AssertionError(f"the profiled chunk ran as {how!r}, not as a "
                             "replay of a captured key")
    by_name: dict = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_ops += 1
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ")[:100]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log(f"[profile] one decode chunk of {eng.scfg.decode_chunk} steps, a "
        f"replay of the graph of key (view_pages, sampled) {key}: wall "
        f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"({busy / wall_us:.3f} of the wall; {busy / 1e3 / warm_chunk_ms:.3f}"
        f" of the warm serves' mean chunk of {warm_chunk_ms:.3f} ms without "
        f"the profiler), {n_ops} device operations")
    for name, us in top:
        log(f"[profile]   {us / 1e3:9.3f} ms  {name}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def near_tie(gap: float, top: float, dtype: torch.dtype) -> bool:
    """Whether a top-2 logit gap is a near tie: under ``GAP_TOL``, or at
    most two steps of the logits' own resolution at the top logit.  The
    unembedding returns logits in the model's dtype; in bf16 they move in
    steps of 2**-5 between 4 and 8, so the smallest gap short of a tie is
    three times ``GAP_TOL`` there.  Two steps: the split is read in a
    one-sequence replay, itself a step off the batched run it stands
    for, and the two runs compared may each round a step apart.  In fp32
    the step is ~5e-7 and only ``GAP_TOL`` counts (phase 5's rule)."""
    step = torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(abs(top)))
    return gap < GAP_TOL or gap <= 2 * step


def greedy(params, cfg, prompt, max_new, prompt_pad, max_len,
           device="cpu", forced=None):
    """1-token-at-a-time greedy decode of one sequence on ``device``;
    returns each step's argmax, top-2 logit gap and top logit.
    ``forced`` feeds those tokens back instead of the argmax (the gaps
    along another run's tokens)."""
    from repro_torch import models
    tokens = np.zeros((1, prompt_pad), np.int32)
    tokens[0, prompt_pad - len(prompt):] = prompt
    cache = models.init_cache(cfg, 1, max_len, device=device)
    logits, cache = models.prefill(
        params, cfg, {"tokens": torch.from_numpy(tokens).to(device)}, cache)
    out, gaps, tops, pos = [], [], [], prompt_pad
    for t in range(max_new):
        lg = logits[0, :cfg.vocab_size].float().cpu()
        top = lg.topk(2).values
        gaps.append(float(top[0] - top[1]))
        tops.append(float(top[0]))
        out.append(int(lg.argmax()))
        if t == max_new - 1:
            break
        fed = out[-1] if forced is None else int(forced[t])
        logits, cache = models.decode_step(
            params, cfg, torch.tensor([fed], dtype=torch.int32,
                                      device=device), cache,
            torch.tensor([pos], dtype=torch.int32, device=device))
        pos += 1
    return out, gaps, tops


def card_vs_cpu(cfg, dev, zero_tiles: bool = False) -> None:
    from repro_torch.serving import Engine, ServeConfig
    fmt = cfg.mlp_sparsity.format
    params = sparse_model(cfg, dev, SEED + 1, zero_tiles=zero_tiles)
    scfg = ServeConfig(slots=4, max_len=160, prompt_pad=32, page_size=16,
                       decode_chunk=8, max_new_tokens=16, eos_token=-1)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in (5, 17, 26, 32)]
    gpu = Engine(cfg, scfg, params, device=dev).generate(prompts)
    cpu_params = _to(params, "cpu")
    for i, (p, got) in enumerate(zip(prompts, gpu)):
        want, gaps, _ = greedy(cpu_params, cfg, p, scfg.max_new_tokens,
                               scfg.prompt_pad, scfg.max_len)
        split = next((t for t, (a, b) in enumerate(zip(got, want)) if a != b),
                     None)
        log(f"[fidelity {fmt} {cfg.name}] request {i}: {len(got)} tokens, "
            f"first split at {split}, min CPU top-2 gap {min(gaps):.3e}"
            + ("" if split is None else f", gap there {gaps[split]:.3e}"))
        if len(got) != len(want) or (split is not None
                                     and gaps[split] >= GAP_TOL):
            raise AssertionError(f"{fmt} request {i}: card {got} vs CPU "
                                 f"{want}")


# --- phase 6: the paper layer ------------------------------------------------

def check_cnns(dev) -> None:
    """Each TinyML CNN at width 1.0: init on the CPU from the seed,
    combined-pruned at the largest Fig. 10 point, INT7 fake-quantized,
    then one batch on the card against the port's CPU path."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.tinyml import FIG10_CONFIGS, PAPER_MODELS
    from repro_torch.models import cnn
    x_us, x_ss = max(FIG10_CONFIGS)
    for i, (name, spec) in enumerate(PAPER_MODELS.items()):
        init, apply = cnn.CNN_ZOO[name]
        params = init(seed=SEED + i, num_classes=spec["classes"],
                      device="cpu")
        params = cnn.quantize_dequantize(
            cnn.prune_combined(params, x_ss=x_ss, x_us=x_us), bits7=True)
        x = torch.from_numpy(np.random.default_rng(SEED + i).normal(
            size=(CNN_BATCH, *spec["input"])).astype(np.float32))
        want = apply(params, x)
        with FlopCounterMode(display=False) as flops:
            apply(params, x[:1])
        gpu = _to(params, dev)
        xg = x.to(dev)
        got = apply(gpu, xg).cpu()
        ms = cuda_ms(lambda: apply(gpu, xg), reps=10)
        graph_ms = device_ms(lambda: apply(gpu, xg), reps=3)
        err = (got - want).abs().max().item()
        tol = CNN_RTOL * want.abs().max().item()
        top = want.topk(2, dim=1).values
        sure = (top[:, 0] - top[:, 1]) > tol
        n_params = sum(t.numel() for t in _leaves(params))
        log(f"[cnn] {name} {spec['input']} batch {CNN_BATCH}: "
            f"{n_params} params, {flops.get_total_flops() // 2} MACs per "
            f"sample, {ms:.3f} ms per batch (CUDA events; {graph_ms:.3f} "
            f"from CUDA-graph replay), max abs err "
            f"{err:.3e} (tolerance {tol:.3e}), argmax checked on "
            f"{int(sure.sum())}/{CNN_BATCH}")
        if not torch.isfinite(got).all() or err > tol or \
                (got.argmax(1) != want.argmax(1))[sure].any():
            raise AssertionError(f"{name}: the card's logits disagree with "
                                 "the CPU path")


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def paper_section(mod, data) -> None:
    """Print a benchmark's table; every PASS/FAIL line must read PASS."""
    from repro_torch.benchmarks.run import print_table
    verdicts = print_table(mod, data)
    if not verdicts or any("PASS" not in ln for ln in verdicts):
        raise AssertionError(f"{mod.__name__}: {verdicts}")


def paper_layer(dev, counters) -> dict:
    """Phase 6: the CNNs, the kernel bench on the card (launch counts set
    to 0 just before, read just after) and the simulated figures."""
    from repro_torch.benchmarks import (bench_csa_models, bench_kernels,
                                        bench_resources, bench_sssa,
                                        bench_ussa)
    from repro_torch.configs.tinyml import FIG10_CONFIGS
    check_cnns(dev)
    for mod in counters:
        mod.launches = 0
    torch.cuda.synchronize()
    out = bench_kernels.run(device=dev)
    torch.cuda.synchronize()
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.launches
                for mod in counters}
    bench_kernels.main(out)
    log(f"[paper] bench_kernels launches {json.dumps(launches)}")
    matmul = ("nm_spmm", "bsr_matmul", "csa_matmul", "lookahead_decode")
    if any(launches[k] == 0 for k in matmul):
        raise AssertionError(f"a matmul kernel did not launch: {launches}")
    log("[paper] Figs. 8-10 and Table III below are simulated CFU cycles "
        "and byte counts on the host, not card measurements")
    paper_section(bench_ussa, bench_ussa.run())
    paper_section(bench_sssa, bench_sssa.run())
    res = bench_resources.run()
    if any(r["smem_bytes"] is None for r in res["rows"]
           if r["format"] != "dense"):
        raise AssertionError("smem_bytes missing from the libraries")
    paper_section(bench_resources, res)
    paper_section(bench_csa_models, bench_csa_models.run(
        configs=[max(FIG10_CONFIGS)]))
    return launches


# --- phase 7: prefix sharing -------------------------------------------------

PAGE = 16                          # phase 7's page and prompt bucket
HEAD_ROWS = 64                     # the registered head: 4 pages
DIVERGE_ROW = 40                   # inside the head's third page


def prefix_stream(vocab: int, seed: int):
    """Phase 7's head and requests ``[(prompt, suffix or None)]``: 8
    requests led by the head with suffixes of 16, 32 or 48 tokens
    (``suffix`` set: submitted with ``prefix=handle``), 4 repeating the
    first four of those prompts token for token, and 4 keeping the head's
    first ``DIVERGE_ROW`` rows.  Every prompt fills its 16-row bucket, and
    each suffix and divergence starts with a token of its own."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, vocab, HEAD_ROWS).astype(np.int32)
    leads = iter(rng.choice(np.setdiff1d(np.arange(1, vocab),
                                         head[DIVERGE_ROW]), 12,
                            replace=False).astype(np.int32))

    def fresh(n):
        return np.concatenate([[next(leads)],
                               rng.integers(1, vocab, n - 1)]).astype(np.int32)

    suffixes = [fresh(n) for n in (16, 32, 48, 16, 32, 48, 16, 32)]
    requests = [(np.concatenate([head, t]), t) for t in suffixes]
    requests += [(p, None) for p, _ in requests[:4]]
    requests += [(np.concatenate([head[:DIVERGE_ROW],
                                  fresh(n - DIVERGE_ROW)]), None)
                 for n in (80, 96, 112, 96)]
    return head, requests


def expected_sharing(head, prompts) -> tuple:
    """(prefix_hits, shared_pages, cow_copies) for ``prompts`` (each
    filling its bucket) admitted in order after ``head`` was registered,
    worked out without the index: a prompt maps the full pages of its
    longest common row prefix with the head or an earlier prompt (full
    pages only are published), keeps at least its last row to recompute,
    and copies the page that prefix ends inside."""
    published = [head]
    hits = shared = copies = 0
    for p in prompts:
        rows = len(p)
        common = 0
        for q in published:
            n = min(len(p), len(q))
            neq = np.flatnonzero(p[:n] != q[:n])
            common = max(common, int(neq[0]) if len(neq) else n)
        m = min(common // PAGE, (rows - 1) // PAGE)
        r = min(common, rows - 1) - m * PAGE
        hits += bool(m or r)
        shared += m
        copies += r > 0
        published.append(p[:rows // PAGE * PAGE])
    return hits, shared, copies


def prefix_engine(cfg, params, dev, max_new: int, prefix_cache: bool):
    from repro_torch.serving import Engine, ServeConfig
    scfg = ServeConfig(slots=8, max_len=512, page_size=PAGE,
                       decode_chunk=16, prompt_buckets=PAGE,
                       max_new_tokens=max_new, eos_token=-1,
                       prefix_cache=prefix_cache)
    return Engine(cfg, scfg, params, device=dev)


def serve_stream(eng, requests, handle=None) -> tuple:
    """Submit phase 7's requests (the head-led ones as their suffix with
    ``prefix=handle`` when there is a handle) and serve them; returns
    (tokens per request, report).  Every request must reach its budget
    and ``sync_count`` must equal the chunks."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(t, prefix=handle)
               if handle is not None and t is not None else eng.submit(p)
               for p, t in requests]
    ticks = 0
    while eng.num_queued or eng.num_live:
        if ticks > 8 * len(requests):
            raise AssertionError("the prefix serve does not drain")
        eng.step()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    healthy(f"prefix {eng.cfg.name}", st)
    outs = [h.tokens for h in handles]
    budget = eng.scfg.max_new_tokens
    if not all(h.status.value == "done" and len(o) == budget
               for h, o in zip(handles, outs)):
        raise AssertionError("a request did not finish with its budget: "
                             f"{[len(o) for o in outs]}")
    if st.sync_count != len(st.chunk_s):
        raise AssertionError(f"sync_count {st.sync_count} != "
                             f"{len(st.chunk_s)} chunks")
    ntok = sum(len(o) for o in outs)
    return outs, {
        "tokens": ntok, "tok_per_s": ntok / wall, "wall_s": wall,
        "decode_ms_per_step": 1e3 * sum(st.chunk_s)
        / (len(st.chunk_s) * eng.scfg.decode_chunk),
        "chunks": len(st.chunk_s), "sync_count": st.sync_count,
        "prefills": st.prefills, "peak_pages": st.peak_pages,
        "prefix_hits": st.prefix_hits, "shared_pages": st.shared_pages,
        "cow_copies": st.cow_copies}


def first_split(got, want):
    return next((t for t, (a, b) in enumerate(zip(got, want)) if a != b),
                None)


def prefix_sharing(cfg, dev, counters) -> dict:
    """Phase 7 at full width: the shared serve (launch counts set to 0
    just before, read just after) and the unshared one, both printed
    before the gates."""
    from repro_torch.kernels import flash_attention
    head, requests = prefix_stream(cfg.vocab_size, SEED + 7)
    want = expected_sharing(head, [p for p, _ in requests])
    params = sparse_model(cfg, dev, SEED)
    shared = prefix_engine(cfg, params, dev, 32, prefix_cache=True)
    handle = shared.register_prefix(head)
    pages = torch.tensor([nd.page for nd in handle._nodes], device=dev)
    pinned = [shared._cache[k][:, pages].clone() for k in ("kp", "vp")]
    zero_counts(counters)
    flash_attention.suffix_launches = 0
    torch.cuda.synchronize()
    outs, report = serve_stream(shared, requests, handle)
    launches = launch_counts(counters)
    suffix = flash_attention.suffix_launches
    kept = all(torch.equal(shared._cache[k][:, pages], t)
               for k, t in zip(("kp", "vp"), pinned))
    handle.release()
    plain, plain_report = serve_stream(
        prefix_engine(cfg, params, dev, 32, prefix_cache=False), requests)
    got = (report["prefix_hits"], report["shared_pages"],
           report["cow_copies"])
    log(f"[prefix] shared: {json.dumps(report)}")
    log(f"[prefix] unshared: {json.dumps(plain_report)}")
    log(f"[prefix] launches {json.dumps(launches)}, flash_attention with "
        f"Lq < Lk: {suffix}")
    log(f"[prefix] (prefix_hits, shared_pages, cow_copies) {got}, worked "
        f"out from the prompts {want}; peak pages {report['peak_pages']} "
        f"shared, {plain_report['peak_pages']} unshared; the head's "
        f"{len(pages)} pages {'byte-equal' if kept else 'CHANGED'} after "
        "the serve")
    path = {"nm_spmm", "paged_attention", "flash_attention"}
    if any((launches[name] > 0) != (name in path) for name in counted(
            launches)):
        raise AssertionError(f"the kernels of {sorted(path)} must launch "
                             f"and no other: {launches}")
    if got != want:
        raise AssertionError(f"prefix counts {got} != expected {want}")
    if suffix != cfg.n_layers * want[0]:
        raise AssertionError(f"{suffix} suffix flash launches for "
                             f"{want[0]} hits of {cfg.n_layers} layers")
    if not kept:
        raise AssertionError("the registered head's pages changed")
    if report["peak_pages"] >= plain_report["peak_pages"]:
        raise AssertionError("sharing did not lower the peak pages")
    dtype = params["embed"].dtype
    far = []
    for i, ((p, _), a, b) in enumerate(zip(requests, outs, plain)):
        split = first_split(a, b)
        if split is None:
            continue
        replay, gaps, tops = greedy(params, cfg, p, len(b), len(p), 512,
                                    device=dev, forced=b)
        tie = near_tie(gaps[split], tops[split], dtype)
        log(f"[prefix] request {i}: first split at {split}, unshared top-2 "
            f"gap there {gaps[split]:.3e} at top logit {tops[split]:.4f} "
            f"(one-sequence replay): {'a near tie' if tie else 'NOT a tie'}; "
            f"the replay's own argmax first leaves the unshared tokens at "
            f"{first_split(replay, b)}")
        if not tie:
            far.append(i)
    log(f"[prefix] {sum(first_split(a, b) is None for a, b in zip(outs, plain))}"
        f"/{len(outs)} requests token-equal to the unshared run")
    if far:
        raise AssertionError(f"requests {far} split from the unshared run "
                             "away from a near tie")
    return launches


def prefix_vs_cpu(cfg, dev) -> None:
    """Phase 7's stream at 2 layers in fp32: the card's prefix serve
    against one-sequence greedy decoding on the CPU (phase 5's rule)."""
    params = sparse_model(cfg, dev, SEED + 1)
    head, requests = prefix_stream(cfg.vocab_size, SEED + 7)
    eng = prefix_engine(cfg, params, dev, 16, prefix_cache=True)
    outs, report = serve_stream(eng, requests, eng.register_prefix(head))
    want = expected_sharing(head, [p for p, _ in requests])
    got = (report["prefix_hits"], report["shared_pages"],
           report["cow_copies"])
    if got != want:
        raise AssertionError(f"fp32 prefix counts {got} != {want}")
    cpu_params = _to(params, "cpu")
    splits = []
    for i, ((p, _), a) in enumerate(zip(requests, outs)):
        b, gaps, _ = greedy(cpu_params, cfg, p, len(a), len(p), 512)
        split = first_split(a, b)
        splits.append(split)
        if split is not None and gaps[split] >= GAP_TOL:
            raise AssertionError(f"fp32 request {i}: card {a} vs CPU {b}")
    log(f"[prefix fidelity] 2 layers fp32: counts {got}; first splits "
        f"against the CPU {splits}")


# --- phase 8: speculative decoding ------------------------------------------

SPEC_K = 3                         # drafted tokens per verify block
#: phase 8's depth: 12 serves of 28 layers took ~200 s of the run; cut
#: from 8 to 6 with phase 16 (PR 30's first whole run took 1086 s on a
#: host whose eager steps ran 1.3-1.7x slower than PR 21's, phase 8
#: 78.3 s of it: the host-bound turns scale with the layers)
SPEC_LAYERS = 6


def spec_config(**kw):
    """Phase 4's serve, optionally speculative."""
    from repro_torch.serving import ServeConfig
    return ServeConfig(slots=8, max_len=512, prompt_pad=128, page_size=16,
                       decode_chunk=16, max_new_tokens=64, eos_token=-1,
                       **kw)


def speculation(cfg, dev, counters) -> tuple:
    """Phase 8 at full width: phase 4's stream through (a) the plain
    dense loop (a graph serve cold, then warm), (b) a self draft and (c)
    the config's 2:4 packs as the draft with the dense weights verifying,
    each speculative engine through :func:`graph_turns`.  Gates: budgets and
    syncs (``serve_prompts``); one verify block (Q = K + 1) per layer and
    step, and in (c) nm_spmm's 7 projections per layer and draft step;
    each speculative serve's tokens equal (a)'s or split first at a near
    tie (``near_tie``, read by replaying (a)'s tokens one sequence at a
    time).  Returns the cold turns' launches, summed, and each draft's
    acceptance rate."""
    from repro_torch.serving import Engine
    params = dense_model(cfg, dev, SEED)
    prompts = phase4_prompts(cfg.vocab_size)
    plain_eng = Engine(cfg, spec_config(), params, device=dev)
    plain = [serve_prompts(plain_eng, prompts, counters) for _ in range(2)]
    for name, (_, rep, _) in zip(("graph cold", "graph warm"), plain):
        log_turn("spec plain", name, rep)
    base, base_rep, total = plain[0][0], plain[1][1], dict(plain[0][2])
    if plain[1][0] != base:
        raise AssertionError("the two plain serves differ")
    gaps: dict = {}                  # request -> (gaps, tops) along (a)
    acceptance = {}
    dtype = params["embed"].dtype
    for draft in ("self", "pack"):
        tag = f"spec {draft}"
        eng = Engine(cfg, spec_config(spec_k=SPEC_K, spec_draft=draft),
                     params, device=dev)
        turns = graph_turns(eng, prompts, counters,
                            serve_prompts(eng, prompts, counters), tag)
        outs, rep, launches = turns[0][2]
        acceptance[draft] = rep["acceptance_rate"]
        steps = rep["chunks"] * eng.scfg.decode_chunk
        want_nm = 7 * cfg.n_layers * steps * SPEC_K if draft == "pack" else 0
        path = {"paged_attention", "flash_attention"} | (
            {"nm_spmm"} if draft == "pack" else set())
        if any((launches[k] > 0) != (k in path) for k in counted(launches)):
            raise AssertionError(f"{tag}: the kernels of {sorted(path)} must "
                                 f"launch and no other: {launches}")
        if launches["paged_attention Q>1"] != cfg.n_layers * steps or \
                launches["nm_spmm"] != want_nm:
            raise AssertionError(
                f"{tag}: {launches['paged_attention Q>1']} verify blocks and "
                f"{launches['nm_spmm']} nm_spmm launches for {steps} steps "
                f"of {cfg.n_layers} layers (want {cfg.n_layers * steps} and "
                f"{want_nm})")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        far, equal = [], 0
        for i, (p, a, b) in enumerate(zip(prompts, outs, base)):
            split = first_split(a, b)
            if split is None:
                equal += 1
                continue
            if i not in gaps:
                gaps[i] = greedy(params, cfg, p, len(b), 128, 512,
                                 device=dev, forced=b)[1:]
            gap, top = gaps[i][0][split], gaps[i][1][split]
            tie = near_tie(gap, top, dtype)
            log(f"[{tag}] request {i}: first split from the plain loop at "
                f"{split}, plain top-2 gap there {gap:.3e} at top logit "
                f"{top:.4f} (one-sequence replay): "
                f"{'a near tie' if tie else 'NOT a tie'}")
            if not tie:
                far.append(i)
        log(f"[{tag}] vs plain: {equal}/{len(outs)} requests token-equal; "
            f"acceptance {rep['acceptance_rate']:.4f} ({rep['accepted']} of "
            f"{rep['drafted']} drafted), {rep['tokens_per_chunk']:.1f} "
            f"tokens/chunk vs {base_rep['tokens_per_chunk']:.1f}; warm graph "
            f"{mean_of(turns, 'decode_ms_per_step', True):.3f} ms/step "
            f"(replayed chunks {mean_of(turns, 'replay_ms_per_step', True):.3f}"
            f"), {mean_of(turns, 'tok_per_s', True):.2f} tok/s vs plain warm "
            f"{base_rep['decode_ms_per_step']:.3f} ms/step, "
            f"{base_rep['tok_per_s']:.2f} tok/s; eager "
            f"{mean_of(turns, 'decode_ms_per_step', False):.3f} ms/step, "
            f"{mean_of(turns, 'tok_per_s', False):.2f} tok/s")
        if far:
            raise AssertionError(f"{tag}: requests {far} split from the "
                                 "plain loop away from a near tie")
    return total, acceptance


def spec_vs_cpu(cfg, dev, counters) -> None:
    """Phase 8 at 2 layers in fp32 (``cfg`` the 2:4 one): a ``pack`` draft
    in each format (block
    and combined with half their tiles zeroed) over the dense verify, on
    the card, against one-sequence greedy decoding on the CPU (phase 5's
    rule).  The fp32 verify block runs the FMA route's Q-block."""
    from repro_torch.serving import Engine, ServeConfig
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in (5, 17, 26, 32)]
    kernel = {"nm": "nm_spmm", "combined": "csa_matmul",
              "block": "bsr_matmul", "lookahead": "lookahead_decode"}
    for fmt, mod in kernel.items():
        fcfg = cfg if fmt == "nm" else with_format(cfg, fmt)
        params = dense_model(fcfg, dev, SEED + 1,
                             zero_tiles=fmt in ("block", "combined"))
        scfg = ServeConfig(slots=4, max_len=160, prompt_pad=32, page_size=16,
                           decode_chunk=8, max_new_tokens=16, eos_token=-1,
                           spec_k=SPEC_K, spec_draft="pack")
        eng = Engine(fcfg, scfg, params, device=dev)
        zero_counts(counters)
        outs = eng.generate(prompts)
        launches = launch_counts(counters)
        if not launches[mod] or not launches["paged_attention Q>1"]:
            raise AssertionError(f"fp32 spec {fmt}: no {mod} or verify "
                                 f"block launch: {launches}")
        cpu_params = _to(params, "cpu")
        splits = []
        for i, (p, got) in enumerate(zip(prompts, outs)):
            want, gaps, _ = greedy(cpu_params, fcfg, p, len(got),
                                   scfg.prompt_pad, scfg.max_len)
            split = first_split(got, want)
            splits.append(split)
            if len(got) != scfg.max_new_tokens or (
                    split is not None and gaps[split] >= GAP_TOL):
                raise AssertionError(f"fp32 spec {fmt} request {i}: card "
                                     f"{got} vs CPU {want}")
        log(f"[spec fidelity {fmt}] 2 layers fp32, pack draft: acceptance "
            f"{eng.acceptance_rate():.4f}, {launches[mod]} {mod} and "
            f"{launches['paged_attention Q>1']} verify-block launches; "
            f"first splits against the CPU {splits}")


# --- phase 9: stablelm-12b and qwen2-vl-72b ---------------------------------

#: The depths of phases 4 (the other formats) and 9-12 on the card.  At
#: their earlier depths (qwen3 28, stablelm 40, qwen2-vl 16, qwen2-moe 12,
#: dbrx 8, mamba2 24, zamba2 38, seamless 24 + 24) phases 2-12 took 971 s
#: of a run whose host issued eager steps ~1.3x slower than the run
#: before, so phase 13 (~190-250 s) was cut by the 1200 s limit: the
#: eager turns are host-bound and scale with the layers.  Widths stay
#: published; qwen2-vl-72b and dbrx-132b also could not fit the card at
#: full depth (a dense bf16 init of qwen2-vl's 80 layers is ~141 GB,
#: dbrx's 40 packed layers ~134 GB).  Phase 15 came with stablelm cut
#: again from 10 layers to 8 (its first whole run took 898 s, phase 9
#: 78.7 s of it, against the script's 950 s cap).  Phase 16 came with
#: both cut again, to 6 (phase 9 took 94.6 s of a 1086 s run, see
#: ``SPEC_LAYERS``), and phase 4's other formats from 14 layers to 10.
FORMAT_LAYERS = 10
STABLELM_LAYERS = 6
QWEN2_VL_LAYERS = 6


def cut_depth(cfg, n_layers: int):
    """``cfg`` cut to its first ``n_layers`` layers (an enc-dec config
    to as many encoder layers too)."""
    enc = {"n_encoder_layers": n_layers} if cfg.is_encoder_decoder else {}
    return dataclasses.replace(cfg, n_layers=n_layers,
                               layer_kinds=cfg.layer_kinds[:n_layers], **enc)


def family_configs() -> list:
    """Phase 9's configurations: stablelm-12b ``sparse()`` cut to
    ``STABLELM_LAYERS`` and qwen2-vl-72b ``sparse()`` to
    ``QWEN2_VL_LAYERS`` layers."""
    from repro_torch.configs import qwen2_vl_72b, stablelm_12b
    return [cut_depth(stablelm_12b.sparse(), STABLELM_LAYERS),
            cut_depth(qwen2_vl_72b.sparse(), QWEN2_VL_LAYERS)]


def check_routes(tag: str, launches: dict, route: str) -> None:
    """Both attention kernels launched, every launch on ``route``."""
    for name in ("flash_attention", "paged_attention"):
        want = launches[name] if route == "mma" else 0
        if not launches[name] or launches[f"{name} mma"] != want:
            raise AssertionError(f"{tag}: {name} must launch on its {route} "
                                 f"route only: {launches}")


def embeds_prefill(params, cfg, dev, prompt) -> None:
    """The prompt's token prefill and the prefill of its rows of the
    embedding table (``input_mode="embeds"``), each on a fresh cache:
    the logits must be bitwise equal."""
    from repro_torch import models
    tokens = torch.from_numpy(prompt[None]).to(dev)
    got = []
    for batch in ({"tokens": tokens},
                  {"embeds": params["embed"][tokens.long()]}):
        cache = models.init_cache(cfg, 1, 512, device=dev)
        got.append(models.prefill(params, cfg, batch, cache)[0])
    if not torch.equal(*got):
        raise AssertionError(f"{cfg.name}: the embeds prefill differs from "
                             "the token prefill (max abs diff "
                             f"{(got[0] - got[1]).abs().max().item():.3e})")
    log(f"[family {cfg.name}] embeds prefill of a {len(prompt)}-token "
        "prompt: logits bitwise equal to its token prefill")


def family_serve(cfg, dev, counters) -> dict:
    """Phase 9 (a) and (b): ``cfg`` at its published widths, bf16, random
    weights from the seed, 2:4 packs on all seven projections (the dense
    weights freed after packing), phase 4's serve and stream through the
    Engine: a cold graph serve, then :func:`graph_turns`.  Gates:
    budgets and syncs (``serve_prompts``); only nm_spmm and both
    attention kernels launch, the attention kernels on their tensor-core
    routes, flash once per layer and prefill, paged once per layer and
    decode step, nm_spmm 7 times per layer and forward; for an embeds
    config,
    :func:`embeds_prefill`.  Then one replayed decode chunk under the
    profiler (:func:`profile_decode_chunk`).  Returns the cold serve's
    launches."""
    import gc

    from repro_torch.core.sparsity import NMPack
    from repro_torch.serving import Engine
    tag = f"family {cfg.name}"
    t0 = time.perf_counter()
    params = sparse_model(cfg, dev, SEED)
    torch.cuda.synchronize()
    packs = [w for layer in params["layers"] for fam in ("attn", "mlp")
             for name, w in layer[fam].items() if not name.endswith("_norm")]
    if len(packs) != 7 * cfg.n_layers or \
            not all(isinstance(w, NMPack) for w in packs):
        raise AssertionError(f"{tag}: not every projection is a 2:4 pack")
    tables = [params[k] for k in ("embed", "unembed") if k in params]
    log(f"[{tag}] {cfg.n_layers} layers d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"{'tied' if cfg.tie_embeddings else 'untied'} head, "
        f"mrope={cfg.mrope_sections}, {cfg.dtype}: random init + pack in "
        f"{time.perf_counter() - t0:.1f} s; packed values "
        f"{sum(w.values.numel() * 2 for w in packs) / 1e9:.3f} GB, "
        f"embedding tables {[round(t.numel() * 2 / 1e9, 3) for t in tables]}"
        f" GB, {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    eng = Engine(cfg, spec_config(), params, device=dev)
    prompts = phase4_prompts(cfg.vocab_size)
    cold = serve_prompts(eng, prompts, counters)
    _, rep, launches = cold
    path = {"nm_spmm", "paged_attention", "flash_attention"}
    if any((launches[k] > 0) != (k in path) for k in counted(launches)):
        raise AssertionError(f"{tag}: the kernels of {sorted(path)} must "
                             f"launch and no other: {launches}")
    check_routes(tag, launches, "mma")
    steps = rep["chunks"] * eng.scfg.decode_chunk
    want = {"flash_attention": cfg.n_layers * rep["prefills"],
            "paged_attention": cfg.n_layers * steps,
            "nm_spmm": 7 * cfg.n_layers * (rep["prefills"] + steps)}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{tag}: launches {launches}, want {want} for "
                             f"{rep['prefills']} prefills and {steps} steps")
    log(f"[{tag}] {json.dumps(rep)}")
    turns = graph_turns(eng, prompts, counters, cold, tag)
    warm = [ms for name, _, (_, r, _) in turns if name == "graph warm"
            for ms in r["chunk_ms"]]
    profile_decode_chunk(eng, prompts, sum(warm) / len(warm))
    if cfg.input_mode == "embeds":
        embeds_prefill(params, cfg, dev, prompts[0])
    del eng, params, packs, tables
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def family_vs_cpu(cfg, dev, counters) -> None:
    """Phase 9 (c): ``cfg`` cut to 2 layers in fp32 through phase 5's
    :func:`card_vs_cpu`; both attention kernels launch on the FMA route
    (D = 160 for stablelm)."""
    small = dataclasses.replace(cfg, n_layers=2, layer_kinds=(),
                                dtype="float32")
    zero_counts(counters)
    card_vs_cpu(small, dev)
    check_routes(f"fidelity {cfg.name}", launch_counts(counters), "fma")


# --- phase 10: the MoE family ------------------------------------------------

#: phase 10's depths (see ``FORMAT_LAYERS``): qwen2-moe's eager step is
#: ~230 ms at 12 layers (183 nm_spmm launches a layer and step); cut from
#: 6 layers to 4 for phase 15 (phase 10 took 99.9 s of its first run),
#: and both to 3 for phase 16 (97.6 s of a 1086 s run, see ``SPEC_LAYERS``)
QWEN2_MOE_LAYERS = 3
DBRX_LAYERS = 3
#: rows each expert takes in phase 10's serve: C at 8 decode slots
#: (qwen2-moe 1, dbrx 3) and in a 128-row prompt (11, 40)
EXPERT_M = (1, 3, 11, 40)


def moe_configs() -> list:
    """Phase 10's configurations: qwen2-moe-a2.7b ``sparse()`` cut to
    ``QWEN2_MOE_LAYERS`` and dbrx-132b ``sparse()`` to ``DBRX_LAYERS``
    layers."""
    from repro_torch.configs import dbrx_132b, qwen2_moe_a2_7b
    return [cut_depth(qwen2_moe_a2_7b.sparse(), QWEN2_MOE_LAYERS),
            cut_depth(dbrx_132b.sparse(), DBRX_LAYERS)]


def expert_projections(cfg):
    """(name, K, N) of one routed expert of ``cfg``."""
    d, de = cfg.d_model, cfg.d_expert
    return [("w_in", d, de), ("w_gate", d, de), ("w_out", de, d)]


def shared_projections(cfg):
    """(name, K, N) of ``cfg``'s shared-expert FFN."""
    d, ds = cfg.d_model, cfg.d_expert * cfg.n_shared_experts
    return [("shared w_in", d, ds), ("shared w_gate", d, ds),
            ("shared w_out", ds, d)]


def check_moe_kernels(cfg, dev) -> None:
    """Phase 3 at an MoE config: nm_spmm at one routed expert (timed over
    enough experts to stream from HBM) at every M of ``EXPERT_M``, the
    shared FFN at 8 and 128 rows, and both attention kernels at its
    heads."""
    per_expert = sum(k * n for _, k, n in expert_projections(cfg))
    copies = max(1, math.ceil(128e6 / per_expert))     # > the 50 MB L2
    check_nm_spmm(cfg, dev, copies=copies,
                  projections=expert_projections(cfg), sweep=EXPERT_M,
                  timed=EXPERT_M, what="expert")
    if cfg.n_shared_experts:
        check_nm_spmm(cfg, dev, copies=4, projections=shared_projections(cfg),
                      what="shared FFN")
    check_paged_attention(cfg, dev)
    check_flash_attention(cfg, dev)


def moe_serve(cfg, dev, counters) -> dict:
    """Phase 10 (a) and (b): ``cfg`` at its published widths, bf16, random
    weights from the seed, each layer packed as it is drawn
    (``init_model(packed=True)``), phase 4's serve and stream through the
    Engine: a cold graph serve, then :func:`graph_turns`.  Gates: budgets
    and syncs (``serve_prompts``); every routed and shared expert
    projection a 2:4 pack; only nm_spmm and both attention kernels
    launch, the attention kernels on their tensor-core routes, flash
    once per layer and prefill, paged once per layer and decode step,
    nm_spmm ``3 E`` times per layer and forward (plus 3 for the shared
    FFN).  Printed: the share of routes dropped at decode and at
    prefill in the cold serve (``models.moe.route_tally``).  Then one
    replayed decode chunk under the profiler.  Returns the cold serve's
    launches."""
    import gc

    from repro_torch import models
    from repro_torch.core.sparsity import NMPack
    from repro_torch.models import moe as MOE
    from repro_torch.serving import Engine
    tag = f"moe {cfg.name}"
    t0 = time.perf_counter()
    params = models.init_model(cfg, seed=SEED, device=dev, packed=True)
    torch.cuda.synchronize()
    E, shared = cfg.n_experts, 3 if cfg.n_shared_experts else 0
    moes = [layer["moe"] for layer in params["layers"]]
    experts = [w for m in moes for k in MOE.EXPERT_WEIGHTS for w in m[k]]
    shared_w = [w for m in moes for w in m.get("shared", {}).values()]
    if len(experts) != 3 * E * cfg.n_layers or len(shared_w) != \
            shared * cfg.n_layers or not all(
                isinstance(w, NMPack) for w in experts + shared_w):
        raise AssertionError(f"{tag}: not every expert projection is a 2:4 "
                             "pack")
    attn = [w for layer in params["layers"] for w in layer["attn"].values()]

    def gb(ws):
        return round(sum(w.values.numel() * 2 + w.idx.numel() * 4
                         if isinstance(w, NMPack) else w.numel() * 2
                         for w in ws) / 1e9, 3)

    log(f"[{tag}] {cfg.n_layers} layers d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} {E} experts "
        f"top-{cfg.top_k} d_expert={cfg.d_expert} shared="
        f"{cfg.n_shared_experts} vocab={cfg.vocab_size}, {cfg.dtype}: "
        f"random init + pack layer by layer in "
        f"{time.perf_counter() - t0:.1f} s; GB: routed experts "
        f"{gb(experts)}, shared {gb(shared_w)}, attention (dense) "
        f"{gb(attn)}, embedding {gb([params['embed']])}; "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    MOE.route_tally = {k: torch.zeros(2, dtype=torch.int64, device=dev)
                       for k in ("decode", "prefill")}
    try:
        eng = Engine(cfg, spec_config(), params, device=dev)
        prompts = phase4_prompts(cfg.vocab_size)
        cold = serve_prompts(eng, prompts, counters)
        kept = {k: t.tolist() for k, t in MOE.route_tally.items()}
        _, rep, launches = cold
        path = {"nm_spmm", "paged_attention", "flash_attention"}
        if any((launches[k] > 0) != (k in path) for k in counted(launches)):
            raise AssertionError(f"{tag}: the kernels of {sorted(path)} must "
                                 f"launch and no other: {launches}")
        check_routes(tag, launches, "mma")
        steps = rep["chunks"] * eng.scfg.decode_chunk
        fwd = rep["prefills"] + steps
        want = {"flash_attention": cfg.n_layers * rep["prefills"],
                "paged_attention": cfg.n_layers * steps,
                "nm_spmm": (3 * E + shared) * cfg.n_layers * fwd}
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"{tag}: launches {launches}, want {want} "
                                 f"for {rep['prefills']} prefills and {steps} "
                                 "steps")
        log(f"[{tag}] {json.dumps(rep)}")
        log(f"[{tag}] routes dropped in the cold serve: " + ", ".join(
            f"{k} {1 - a / b:.4f} ({b - a} of {b}, C = "
            f"{models.expert_rows(cfg, 8 if k == 'decode' else 128)})"
            for k, (a, b) in kept.items()))
        turns = graph_turns(eng, prompts, counters, cold, tag)
        warm = [ms for name, _, (_, r, _) in turns if name == "graph warm"
                for ms in r["chunk_ms"]]
        profile_decode_chunk(eng, prompts, sum(warm) / len(warm))
    finally:
        MOE.route_tally = None
    del eng, params, moes, experts, shared_w, attn
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def batched_greedy(params, cfg, prompts, max_new, prompt_pad, max_len,
                   device="cpu"):
    """Greedy decoding of ``prompts`` as one batch, routed as the Engine
    routes them: each prompt (left-padded to ``prompt_pad``) prefilled
    alone into its slot, then one decode step of every slot at a time.
    Returns each request's tokens and the top-2 logit gap at each step.
    A capacity dispatch couples the slots of a step, so one-sequence
    decoding (:func:`greedy`) is not the MoE reference."""
    from repro_torch import models
    B = len(prompts)
    cache = models.init_cache(cfg, B, max_len, device=device)
    first = []
    for i, p in enumerate(prompts):
        tokens = np.zeros((1, prompt_pad), np.int32)
        tokens[0, prompt_pad - len(p):] = p
        scratch = models.blank_slot_cache(cache)
        logits, scratch = models.prefill(
            params, cfg, {"tokens": torch.from_numpy(tokens).to(device)},
            scratch)
        models.merge_cache_slot(cache, scratch, i)
        first.append(logits[0])
    logits = torch.stack(first)
    pos = torch.full((B,), prompt_pad, dtype=torch.int32, device=device)
    out, gaps = [[] for _ in prompts], [[] for _ in prompts]
    for t in range(max_new):
        lg = logits[:, :cfg.vocab_size].float().cpu()
        top = lg.topk(2, dim=-1).values
        tok = lg.argmax(-1)
        for i in range(B):
            out[i].append(int(tok[i]))
            gaps[i].append(float(top[i, 0] - top[i, 1]))
        if t == max_new - 1:
            break
        logits, cache = models.decode_step(
            params, cfg, tok.to(torch.int32).to(device), cache, pos)
        pos = pos + 1
    return out, gaps


#: phase 10 (c)'s CPU reference: its command-line flag and torch
#: threads (it runs beside phases 11-13 on a host of 8 cores)
MOE_REFERENCE = "--moe-cpu-reference"
MOE_REFERENCE_THREADS = 2


def moe_fidelity_setup(cfg) -> tuple:
    """Phase 10 (c)'s model, serve and stream for ``cfg``: (``cfg`` cut
    to 2 layers in fp32, the ServeConfig, the prompts)."""
    from repro_torch.serving import ServeConfig
    small = dataclasses.replace(cfg, n_layers=2, layer_kinds=(),
                                dtype="float32")
    # 4 new tokens (8 before PR 30): the CPU path streams a dbrx layer's
    # 6.3 GB of fp32 packs per forward, a second or more each (dbrx's CPU
    # path took 43.0 s of phase 10 at 8 tokens)
    scfg = ServeConfig(slots=4, max_len=160, prompt_pad=32, page_size=16,
                       decode_chunk=4, max_new_tokens=4, eos_token=-1)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, small.vocab_size, size=int(n)).astype(np.int32)
               for n in (5, 17, 26, 32)]
    return small, scfg, prompts


def moe_fidelity_params(small, dev):
    """(c)'s weights, each layer packed as drawn on ``dev`` from the
    seed: the card draws the same values in any process."""
    from repro_torch import models
    return models.init_model(small, seed=SEED + 1, device=dev, packed=True)


def weights_digest(tree) -> int:
    """The sum of every tensor's elements in ``tree`` (dicts, lists and
    packs) read as integers of their width, computed where the tensors
    lie: equal for trees of equal bits."""
    if isinstance(tree, torch.Tensor):
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[tree.element_size()]
        return int(tree.view(ints).sum())
    if isinstance(tree, dict):
        parts = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        parts = list(tree)
    elif dataclasses.is_dataclass(tree):
        parts = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    else:                           # a pack's shape fields, a None
        return 0
    return sum(weights_digest(v) for v in parts)


def moe_cpu_reference(out: str) -> int:
    """This script's CPU-reference mode for phase 10 (c): each MoE
    config's weights drawn on the card as (c) draws them, copied to the
    CPU and freed on the card (then the file ``moe_drawn(out)`` is
    made), and :func:`batched_greedy` on the port's CPU path on
    ``MOE_REFERENCE_THREADS`` threads.  Each config's tokens, top-2 gaps,
    seconds and :func:`weights_digest` are written to ``out`` as
    JSON."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(MOE_REFERENCE_THREADS)
    dev = torch.device("cuda", 0)
    drawn = {}
    for cfg in moe_configs():
        small, _, _ = moe_fidelity_setup(cfg)
        params = moe_fidelity_params(small, dev)
        drawn[cfg.name] = (weights_digest(params), _to(params, "cpu"))
        del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    moe_drawn(out).touch()
    result = {}
    for cfg in moe_configs():
        small, scfg, prompts = moe_fidelity_setup(cfg)
        digest, params = drawn.pop(cfg.name)
        t0 = time.perf_counter()
        want, gaps = batched_greedy(params, small, prompts,
                                    scfg.max_new_tokens, scfg.prompt_pad,
                                    scfg.max_len)
        result[cfg.name] = {"tokens": want, "gaps": gaps, "digest": digest,
                            "s": time.perf_counter() - t0}
        del params
    Path(out).write_text(json.dumps(result))
    return 0


def moe_drawn(out) -> Path:
    """The file by which (c)'s reference says its weights left the card."""
    return Path(f"{out}.drawn")


def start_moe_reference() -> tuple:
    """Start (c)'s reference process: (process, its output file)."""
    moe_drawn(ROOT / "build" / "chip_smoke" / "moe_cpu.json").unlink(
        missing_ok=True)
    return start_cpu_reference(MOE_REFERENCE, "moe_cpu.json")


def moe_vs_cpu(cfg, dev, counters) -> tuple:
    """Phase 10 (c)'s card side: ``cfg`` cut to 2 layers in fp32, each
    layer packed as drawn, served by the Engine, both attention kernels
    on the FMA route.  Returns (its greedy tokens, the weights'
    digest) for :func:`moe_check`."""
    from repro_torch.serving import Engine
    small, scfg, prompts = moe_fidelity_setup(cfg)
    params = moe_fidelity_params(small, dev)
    digest = weights_digest(params)
    zero_counts(counters)
    got = Engine(small, scfg, params, device=dev).generate(prompts)
    check_routes(f"moe fidelity {cfg.name}", launch_counts(counters), "fma")
    return got, digest


def wait_moe_drawn(proc, out: Path) -> None:
    """Wait until (c)'s reference has freed its weights on the card, so
    that phase 11 has the card to itself."""
    t0 = time.perf_counter()
    while not moe_drawn(out).exists():
        if proc.poll() is not None:
            raise AssertionError(f"phase 10 (c): the CPU reference exited "
                                 f"{proc.returncode}")
        if time.perf_counter() - t0 > 600:
            raise AssertionError("phase 10 (c): the CPU reference drew no "
                                 "weights in 600 s")
        time.sleep(0.1)
    log(f"[phase 10] (c) waited {time.perf_counter() - t0:.1f} s for the "
        "CPU reference to draw its weights and free them on the card")


def moe_check(cards: list, proc, out: Path) -> None:
    """Phase 10 (c)'s check: each config's greedy tokens on the card
    (``cards``: (cfg, tokens, digest), from :func:`moe_vs_cpu`) against
    :func:`batched_greedy` on the CPU path in the reference process, on
    weights of the same digest: equal, or the first step at which any
    request splits is a near tie of that request's CPU logits (phase
    5's rule; after it the slots' routes differ, so nothing later is
    compared)."""
    t0 = time.perf_counter()
    if proc.wait(timeout=900):
        raise AssertionError(f"phase 10 (c): the CPU reference exited "
                             f"{proc.returncode}")
    waited = time.perf_counter() - t0
    cpu = json.loads(out.read_text())
    for cfg, got, digest in cards:
        tag = f"moe fidelity {cfg.name}"
        _, scfg, prompts = moe_fidelity_setup(cfg)
        ref = cpu[cfg.name]
        if ref["digest"] != digest:
            raise AssertionError(f"{tag}: the CPU reference drew other "
                                 f"weights (digest {ref['digest']} vs the "
                                 f"card's {digest})")
        want, gaps = ref["tokens"], ref["gaps"]
        splits = [first_split(a, b) for a, b in zip(got, want)]
        step = min((t for t in splits if t is not None), default=None)
        log(f"[{tag}] 2 layers fp32, {len(prompts)} requests of "
            f"{scfg.max_new_tokens} tokens (CPU path {ref['s']:.1f} s in "
            f"its own process on {MOE_REFERENCE_THREADS} threads, waited "
            f"{waited:.1f} s): first splits {splits}, min CPU top-2 gap "
            f"{min(min(g) for g in gaps):.3e}")
        bad = [i for i, t in enumerate(splits) if t == step and t is not None
               and gaps[i][t] >= GAP_TOL]
        if any(len(g) != scfg.max_new_tokens for g in got) or bad:
            raise AssertionError(f"{tag}: card {got} vs CPU {want}")


# --- phase 11: the SSM/hybrid family -----------------------------------------

#: phase 11's depths (see ``FORMAT_LAYERS``): zamba2's first 13 layers
#: hold two of its shared-attention slots (before layers 3 and 9)
MAMBA2_LAYERS = 8
ZAMBA2_LAYERS = 13


def hybrid_configs() -> list:
    """Phase 11's configurations: mamba2-130m and zamba2-1.2b ``sparse()``
    at full width, cut to ``MAMBA2_LAYERS`` and ``ZAMBA2_LAYERS``."""
    from repro_torch.configs import mamba2_130m, zamba2_1_2b
    return [cut_depth(mamba2_130m.sparse(), MAMBA2_LAYERS),
            cut_depth(zamba2_1_2b.sparse(), ZAMBA2_LAYERS)]


def hybrid_packs(cfg) -> int:
    """nm_spmm launches of one forward of ``cfg``: every ``out_proj``,
    and the shared MLP's three projections at each shared slot."""
    from repro_torch.models.hybrid import shared_slots
    return cfg.n_layers + 3 * len(shared_slots(cfg))


def check_hybrid_kernels(cfg, dev) -> None:
    """Phase 3 at a hybrid config: nm_spmm at its ``out_proj`` (and
    zamba2's shared MLP, one layer's four projections), timed over enough
    copies to stream from HBM; for zamba2 both attention kernels at its
    heads (D = 64, 32 over 32)."""
    from repro_torch.models.hybrid import shared_slots
    projections = [("out_proj", cfg.d_inner, cfg.d_model)]
    if shared_slots(cfg):
        d, ff = cfg.d_model, cfg.d_ff
        projections += [("shared w_in", d, ff), ("shared w_gate", d, ff),
                        ("shared w_out", ff, d)]
    per = sum(k * n for _, k, n in projections)
    check_nm_spmm(cfg, dev, copies=max(1, math.ceil(128e6 / per)),
                  projections=projections)
    if shared_slots(cfg):
        check_paged_attention(cfg, dev)
        check_flash_attention(cfg, dev)


def ssm_times(cfg, dev) -> None:
    """Device ms (CUDA-graph replay) of the SSM parts of phase 11's serve
    at its shapes, per layer: the SSD scan of one 128-row prompt (the
    per-slot prefill), the O(1) recurrent update of 8 slots beside its
    bound (the fp32 state read and written once), and one whole mamba
    layer (projections included) at decode and at prefill."""
    from repro_torch import models
    from repro_torch.models import ssm
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    bf = torch.bfloat16

    def rand(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    A = -torch.arange(1, H + 1, device=dev, dtype=torch.float32)
    xs, dt = rand(1, 128, H, P), rand(1, 128, H, dtype=torch.float32).exp()
    Bp, Cp = rand(1, 128, H, N), rand(1, 128, H, N)
    chunk = ssm._pick_chunk(128, cfg.ssm_chunk)
    scan = device_ms(lambda: ssm.ssd_chunked(xs, dt, A, Bp, Cp, chunk))
    state = rand(8, H, P, N, dtype=torch.float32)
    x1, dt1 = rand(8, H, P), rand(8, H, dtype=torch.float32).exp()
    B1, C1 = rand(8, H, N), rand(8, H, N)
    upd = device_ms(lambda: ssm.ssm_update(state, x1, dt1, A, B1, C1))
    b, by = bound_ms(2 * state.numel() * 4, 4.0 * state.numel(),
                     FP32_FLOPS_PER_S)
    one = dataclasses.replace(cfg, n_layers=1,
                              layer_kinds=(int(models.LayerKind.MAMBA),))
    p = models.init_model(one, seed=SEED, device=dev,
                          packed=True)["mamba"][0]
    cache = models.init_cache(one, 8, 512, device=dev)["ssm"]
    layer = {k: v[0] for k, v in cache.items()}
    h8, h128 = rand(8, 1, cfg.d_model), rand(1, 128, cfg.d_model)
    blank = {k: v[:, :1].clone()[0] for k, v in cache.items()}
    dec = device_ms(lambda: ssm.mamba_block(p, cfg, h8, cache=layer,
                                            sparsity=cfg.mlp_sparsity))
    pre = device_ms(lambda: ssm.mamba_block(p, cfg, h128, cache=blank,
                                            sparsity=cfg.mlp_sparsity))
    L = cfg.n_layers
    log(f"[hybrid {cfg.name}] per layer, device ms by graph replay: SSD scan "
        f"of a 128-row prompt (chunk {chunk}) {scan:.5f} (x {L} layers = "
        f"{scan * L:.4f}); recurrent update of 8 slots {upd:.5f} (bound "
        f"{b:.5f}, {by}; x {L} = {upd * L:.4f}); one mamba layer, decode of "
        f"8 slots {dec:.5f}, prefill of 128 rows {pre:.5f}")


def hybrid_serve(cfg, dev, counters) -> dict:
    """Phase 11 (a): ``cfg`` at its published widths, bf16,
    random weights from the seed, each layer packed as it is drawn
    (``init_model(packed=True)``), phase 4's serve and stream through the
    Engine: a cold graph serve, then :func:`graph_turns`.  Gates: budgets
    and syncs (``serve_prompts``); every ``out_proj`` and shared-MLP
    projection a 2:4 pack, every ``in_proj`` dense; only nm_spmm (and
    zamba2's two attention kernels, on their tensor-core routes) launch,
    nm_spmm :func:`hybrid_packs` times per forward, flash once per shared
    slot and prefill, paged once per shared slot and decode step; the
    recurrent state at the same addresses from before the first serve to
    after the last.  Then one replayed decode chunk under the profiler
    and :func:`ssm_times`.  Returns the cold serve's launches."""
    import gc

    from repro_torch import models
    from repro_torch.core.sparsity import NMPack
    from repro_torch.models.hybrid import shared_slots
    from repro_torch.serving import Engine
    tag = f"hybrid {cfg.name}"
    t0 = time.perf_counter()
    params = models.init_model(cfg, seed=SEED, device=dev, packed=True)
    torch.cuda.synchronize()
    n_shared = len(shared_slots(cfg))
    outs = [m["out_proj"] for m in params["mamba"]]
    ins = [m["in_proj"] for m in params["mamba"]]
    mlp = list(params["shared"]["mlp"].values()) if n_shared else []
    if not all(isinstance(w, NMPack) for w in outs + mlp) or any(
            isinstance(w, NMPack) for w in ins):
        raise AssertionError(f"{tag}: out_proj and the shared MLP must be "
                             "2:4 packs and in_proj dense")

    def gb(ws):
        return round(sum(w.values.numel() * 2 + w.idx.numel() * 4
                         if isinstance(w, NMPack) else w.numel() * 2
                         for w in ws) / 1e9, 3)

    log(f"[{tag}] {cfg.n_layers} layers d_model={cfg.d_model} d_inner="
        f"{cfg.d_inner} ssm heads {cfg.n_ssm_heads}x{cfg.ssm_head_dim} "
        f"state {cfg.ssm_state}, shared slots {shared_slots(cfg)} "
        f"(heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}, d_ff "
        f"{cfg.d_ff}), vocab {cfg.vocab_size}, {cfg.dtype}: random init + "
        f"pack layer by layer in {time.perf_counter() - t0:.1f} s; GB: "
        f"in_proj (dense) {gb(ins)}, out_proj {gb(outs)}, shared MLP "
        f"{gb(mlp)}, embedding {gb([params['embed']])}; "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    eng = Engine(cfg, spec_config(), params, device=dev)
    eng._ensure_device_state()
    state = models.cache_leaves(models.recurrent_state(eng._cache))
    ptrs = [t.data_ptr() for t in state]
    log(f"[{tag}] recurrent state {[tuple(t.shape) for t in state]} fp32, "
        f"{sum(t.numel() * 4 for t in state) / 1e9:.3f} GB")
    prompts = phase4_prompts(cfg.vocab_size)
    cold = serve_prompts(eng, prompts, counters)
    _, rep, launches = cold
    path = {"nm_spmm"} | ({"paged_attention", "flash_attention"}
                          if n_shared else set())
    if any((launches[k] > 0) != (k in path) for k in counted(launches)):
        raise AssertionError(f"{tag}: the kernels of {sorted(path)} must "
                             f"launch and no other: {launches}")
    if n_shared:
        check_routes(tag, launches, "mma")
    steps = rep["chunks"] * eng.scfg.decode_chunk
    want = {"flash_attention": n_shared * rep["prefills"],
            "paged_attention": n_shared * steps,
            "nm_spmm": hybrid_packs(cfg) * (rep["prefills"] + steps)}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{tag}: launches {launches}, want {want} for "
                             f"{rep['prefills']} prefills and {steps} steps")
    log(f"[{tag}] {json.dumps(rep)}")
    turns = graph_turns(eng, prompts, counters, cold, tag)
    warm = [ms for name, _, (_, r, _) in turns if name == "graph warm"
            for ms in r["chunk_ms"]]
    profile_decode_chunk(eng, prompts, sum(warm) / len(warm))
    if [t.data_ptr() for t in models.cache_leaves(
            models.recurrent_state(eng._cache))] != ptrs:
        raise AssertionError(f"{tag}: the recurrent state moved")
    log(f"[{tag}] the recurrent state kept its {len(ptrs)} addresses "
        "through all serves")
    ssm_times(cfg, dev)
    del eng, params, outs, ins, mlp, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def hybrid_small(cfg):
    """``cfg`` in fp32 cut to 2 layers, or for zamba2 to its first 4
    (``zamba_kinds(38, 6)[:4]``: the shared block runs before layer 3)."""
    from repro_torch.models.hybrid import shared_slots
    layers = 4 if shared_slots(cfg) else 2
    return dataclasses.replace(cfg, n_layers=layers,
                               layer_kinds=cfg.layer_kinds[:layers],
                               dtype="float32")


def hybrid_prompts(vocab: int) -> list:
    rng = np.random.default_rng(SEED + 1)
    return [rng.integers(1, vocab, size=int(n)).astype(np.int32)
            for n in (5, 17, 26, 32, 9, 30, 12, 21)]


def hybrid_vs_cpu(cfg, dev, counters) -> None:
    """Phase 11 (b): :func:`hybrid_small` on the card against one-sequence
    greedy decoding on the CPU path (phase 5's rule at the first split),
    eight requests on four slots: monolithic in two waves of four (the
    second wave must start every slot's recurrent state from zero), and
    paged (per-slot prefills).  nm_spmm launches :func:`hybrid_packs`
    times per forward; on the monolithic layout both waves are one
    prefill call each."""
    from repro_torch import models
    from repro_torch.serving import Engine, ServeConfig
    small = hybrid_small(cfg)
    tag = f"hybrid fidelity {cfg.name}"
    params = models.init_model(small, seed=SEED + 1, device=dev, packed=True)
    cpu_params = _to(params, "cpu")
    prompts = hybrid_prompts(small.vocab_size)
    wants = [greedy(cpu_params, small, p, 16, 32, 160) for p in prompts]
    for page_size in (0, 16):
        scfg = ServeConfig(slots=4, max_len=160, prompt_pad=32,
                           page_size=page_size, decode_chunk=8,
                           max_new_tokens=16, eos_token=-1)
        eng = Engine(small, scfg, params, device=dev)
        zero_counts(counters)
        got = eng.generate(prompts[:4]) + eng.generate(prompts[4:])
        launches = launch_counts(counters)
        st = eng.stats()
        calls = 8 if page_size else 2
        steps = len(st.chunk_s) * scfg.decode_chunk
        if launches["nm_spmm"] != hybrid_packs(small) * (calls + steps):
            raise AssertionError(f"{tag}: nm_spmm {launches['nm_spmm']} for "
                                 f"{calls} prefill calls and {steps} steps")
        splits = []
        for i, (g, (want, gaps, _)) in enumerate(zip(got, wants)):
            split = first_split(g, want)
            splits.append(split)
            if len(g) != 16 or (split is not None
                                and gaps[split] >= GAP_TOL):
                raise AssertionError(f"{tag} request {i}: card {g} vs CPU "
                                     f"{want}")
        log(f"[{tag}] {small.n_layers} layers fp32, "
            f"{'paged' if page_size else 'monolithic, two waves'}: first "
            f"splits against the CPU {splits}, min CPU top-2 gap "
            f"{min(min(w[1]) for w in wants):.3e}; launches {launches}")


def garbage_spec(small, dev, counters, tag: str, attn_layers: int
                 ) -> dict:
    """The fp32 model ``small`` on the paged layout, ``spec_k = 3`` with a
    draft from another seed (rejected almost always: every step verifies
    a block and keeps its first token): on one engine a cold graph serve
    and :func:`graph_turns` (warm graph turns equal to the eager ones
    exactly); the tokens equal the plain loop's on the card; one verify
    block per attention layer (``attn_layers``) and step.  Returns the
    cold serve's launches."""
    from repro_torch import models
    from repro_torch.serving import Engine, ServeConfig
    params = models.init_model(small, seed=SEED + 1, device=dev, packed=True)
    garbage = models.init_model(small, seed=SEED + 2, device=dev,
                                packed=True)
    kw = dict(slots=4, max_len=160, prompt_pad=32, page_size=16,
              decode_chunk=8, max_new_tokens=16, eos_token=-1)
    prompts = hybrid_prompts(small.vocab_size)
    plain, _, _ = serve_prompts(Engine(small, ServeConfig(**kw), params,
                                       device=dev), prompts, counters)
    eng = Engine(small, ServeConfig(**kw, spec_k=SPEC_K), params,
                 draft_params=garbage, device=dev)
    turns = graph_turns(eng, prompts, counters,
                        serve_prompts(eng, prompts, counters), tag)
    outs, rep, launches = turns[0][2]
    steps = rep["chunks"] * eng.scfg.decode_chunk
    if launches["paged_attention Q>1"] != attn_layers * steps:
        raise AssertionError(f"{tag}: {launches['paged_attention Q>1']} "
                             f"verify blocks for {steps} steps")
    if outs != plain or rep["acceptance_rate"] >= 0.5:
        raise AssertionError(f"{tag}: tokens equal to the plain loop's: "
                             f"{outs == plain}; acceptance "
                             f"{rep['acceptance_rate']:.4f}")
    log(f"[{tag}] garbage draft: acceptance {rep['acceptance_rate']:.4f} "
        f"({rep['accepted']} of {rep['drafted']}), every request's tokens "
        "equal to the plain loop's")
    return launches


def hybrid_spec(cfg, dev, counters) -> dict:
    """Phase 11 (c): zamba2 at :func:`hybrid_small`'s 4 layers in fp32
    through :func:`garbage_spec`: every step rolls the recurrent state
    back; one verify block per shared slot and step."""
    from repro_torch.models.hybrid import shared_slots
    small = hybrid_small(cfg)
    return garbage_spec(small, dev, counters, f"hybrid spec {cfg.name}",
                        len(shared_slots(small)))


# --- phase 12: the encoder-decoder family ------------------------------------

#: phase 3's non-causal flash calls at seamless's heads: (what, Lq, Lk) —
#: the encoder of a per-slot prefill (512 frames, the Engine's null
#: source) and of phase 12 (b)'s 300 frames, a prompt's cross-attention
#: over the source, and more queries than source rows
NONCAUSAL_SHAPES = (("encoder L=512", 512, 512), ("encoder L=300", 300, 300),
                    ("cross Lq=128 Lk=512", 128, 512),
                    ("cross Lq=8 Lk=6", 8, 6))
FID_ATOL = 1e-3                    # phase 12 (c): fp32 logits, card vs CPU


#: phase 12's depth (see ``FORMAT_LAYERS``): encoder and decoder layers,
#: cut from 8 to 6 with phase 16 (PR 30's whole runs took 1083-1110 s)
SEAMLESS_LAYERS = 6


def encdec_config():
    """Phase 12's configuration: seamless-m4t-large-v2 ``sparse()`` at
    full width, cut to ``SEAMLESS_LAYERS`` + ``SEAMLESS_LAYERS``."""
    from repro_torch.configs import seamless_m4t_large_v2
    return cut_depth(seamless_m4t_large_v2.sparse(), SEAMLESS_LAYERS)


def check_noncausal_flash(cfg, dev) -> None:
    """Phase 3 at seamless's heads: the flash kernel without the causal
    mask at each of ``NONCAUSAL_SHAPES``, bf16 (tensor-core route) and
    fp32 (FMA route), held against ``mha_ref(causal=False)`` and timed
    beside SDPA without a mask and the bound."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref
    H, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in (torch.bfloat16, torch.float32):
        err = 0.0
        for what, Lq, Lk in NONCAUSAL_SHAPES:
            q, k, v = [torch.randn((1, h, n, D), generator=gen, device=dev)
                       .to(dtype) for h, n in ((H, Lq), (Hk, Lk), (Hk, Lk))]
            name = f"{str(dtype)[6:]} B=1 H={H} Hk={Hk} D={D} non-causal " \
                f"{what}"
            log_attn_plan("flash_attention", name,
                          K.plan(1, H, Hk, Lq, Lk, D, dtype))
            err = max(err, check_close(
                f"flash_attention {name}",
                K.flash_attention(q, k, v, causal=False),
                ref.mha_ref(q.float(), k.float(), v.float(), causal=False)))
            kr, vr = (t.repeat_interleave(H // Hk, dim=1) for t in (k, v))
            b, by = bound_ms((2 * H * Lq + 2 * Hk * Lk) * D
                             * q.element_size(), 4.0 * H * D * Lq * Lk,
                             BF16_FLOPS_PER_S if dtype == torch.bfloat16
                             else FP32_FLOPS_PER_S)
            row = dict(**timings(
                lambda: K.flash_attention(q, k, v, causal=False),
                lambda: ref.mha_ref(q, k, v, causal=False),
                lambda: sdpa(q, kr, vr), 1), bound_ms=b, bound_by=by)
            log(f"[kernels] flash_attention {name} (SDPA without a mask): "
                f"{json.dumps(row)}")
        log(f"[kernels] flash_attention non-causal {str(dtype)[6:]} H={H} "
            f"Hk={Hk} D={D}: max abs err {err:.3e} against the plain "
            "version")


def check_encdec_kernels(cfg, dev) -> None:
    """Phase 3 at seamless: nm_spmm at one layer's MLP (``w_in`` 1024 →
    8192, ``w_out`` 8192 → 1024), also at M = 512 (an encoder's rows),
    timed over enough copies to stream from HBM; paged attention at its
    heads (16 over 16, D = 64); flash causal (the prompt's
    self-attention) and non-causal (:func:`check_noncausal_flash`)."""
    d, ff = cfg.d_model, cfg.d_ff
    projections = [("w_in", d, ff), ("w_out", ff, d)]
    check_nm_spmm(cfg, dev, copies=max(1, math.ceil(128e6 / (2 * d * ff))),
                  projections=projections, sweep=SWEEP_M + (512,),
                  timed=TIMED_M + (512,))
    check_paged_attention(cfg, dev)
    check_flash_attention(cfg, dev)
    check_noncausal_flash(cfg, dev)


def encdec_launches(cfg, prefills: int, steps: int) -> dict:
    """Each kernel's launches for ``prefills`` prefill calls and ``steps``
    decode steps of ``cfg`` on the paged layout: per prefill flash once
    per encoder layer and twice per decoder layer (self, causal; cross,
    non-causal), nm_spmm twice per layer of both stacks; per step nm_spmm
    twice and paged once per decoder layer."""
    E, L = cfg.n_encoder_layers, cfg.n_layers
    return {"nm_spmm": 2 * (E + L) * prefills + 2 * L * steps,
            "flash_attention": (E + 2 * L) * prefills,
            "flash_attention non-causal": (E + L) * prefills,
            "paged_attention": L * steps}


def check_launches(tag: str, launches: dict, want: dict) -> None:
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{tag}: launches {launches}, want {want}")


def encdec_serve(cfg, dev, counters) -> dict:
    """Phase 12 (a) and (b): ``cfg`` at its published widths,
    bf16, random weights from the seed, each layer packed as it is drawn
    (``init_model(packed=True)``), phase 4's serve and stream through the
    Engine: a cold graph serve, then :func:`graph_turns`.  Gates: budgets
    and syncs (``serve_prompts``); every ``w_in``/``w_out`` a 2:4 pack and
    every attention projection dense; only nm_spmm and both attention
    kernels launch, on their tensor-core routes, as
    :func:`encdec_launches` counts; the cross K/V at the same addresses
    from before the first serve to after the last.  Then one replayed
    decode chunk under the profiler, and :func:`source_prefill`.  Returns
    the cold serve's launches."""
    import gc

    from repro_torch import models
    from repro_torch.core.sparsity import NMPack
    from repro_torch.serving import Engine
    tag = f"encdec {cfg.name}"
    t0 = time.perf_counter()
    params = models.init_model(cfg, seed=SEED, device=dev, packed=True)
    torch.cuda.synchronize()
    layers = params["encoder"] + params["decoder"]
    mlps = [w for layer in layers for w in layer["mlp"].values()]
    attns = [w for layer in layers for k in ("attn", "self_attn",
                                             "cross_attn")
             if k in layer for w in layer[k].values()]
    if len(mlps) != 2 * len(layers) or not all(
            isinstance(w, NMPack) for w in mlps) or any(
            isinstance(w, NMPack) for w in attns):
        raise AssertionError(f"{tag}: every w_in/w_out must be a 2:4 pack "
                             "and every attention projection dense")

    def gb(ws):
        return round(sum(w.values.numel() * 2 + w.idx.numel() * 4
                         if isinstance(w, NMPack) else w.numel() * 2
                         for w in ws) / 1e9, 3)

    log(f"[{tag}] {cfg.n_encoder_layers} + {cfg.n_layers} layers d_model="
        f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} "
        f"d_ff {cfg.d_ff} (ungated), vocab {cfg.vocab_size} (padded "
        f"{cfg.vocab_padded}), {cfg.dtype}: random init + pack layer by "
        f"layer in {time.perf_counter() - t0:.1f} s; GB: MLPs (2:4) "
        f"{gb(mlps)}, attention (dense) {gb(attns)}, embedding "
        f"{gb([params['embed']])}; {torch.cuda.memory_allocated() / 1e9:.3f}"
        " GB allocated")
    eng = Engine(cfg, spec_config(), params, device=dev)
    eng._ensure_device_state()
    cross = models.cache_leaves(eng._cache["cross"])
    ptrs = [t.data_ptr() for t in cross]
    log(f"[{tag}] cross K/V {[tuple(t.shape) for t in cross]} "
        f"{cross[0].dtype}, {sum(t.numel() * 2 for t in cross) / 1e9:.3f} "
        "GB; each per-slot prefill encodes the null source of "
        f"{cross[0].shape[2]} frames")
    prompts = phase4_prompts(cfg.vocab_size)
    cold = serve_prompts(eng, prompts, counters)
    _, rep, launches = cold
    path = {"nm_spmm", "paged_attention", "flash_attention"}
    if any((launches[k] > 0) != (k in path) for k in counted(launches)):
        raise AssertionError(f"{tag}: the kernels of {sorted(path)} must "
                             f"launch and no other: {launches}")
    check_routes(tag, launches, "mma")
    steps = rep["chunks"] * eng.scfg.decode_chunk
    check_launches(tag, launches,
                   encdec_launches(cfg, rep["prefills"], steps))
    log(f"[{tag}] {json.dumps(rep)}")
    turns = graph_turns(eng, prompts, counters, cold, tag)
    warm = [ms for name, _, (_, r, _) in turns if name == "graph warm"
            for ms in r["chunk_ms"]]
    profile_decode_chunk(eng, prompts, sum(warm) / len(warm))
    if [t.data_ptr() for t in models.cache_leaves(
            eng._cache["cross"])] != ptrs:
        raise AssertionError(f"{tag}: the cross K/V moved")
    log(f"[{tag}] the cross K/V kept their {len(ptrs)} addresses through "
        "all serves")
    del eng, cross
    gc.collect()
    torch.cuda.empty_cache()
    source_prefill(params, cfg, dev, counters)
    del params, layers, mlps, attns
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def source_prefill(params, cfg, dev, counters) -> None:
    """Phase 12 (b): one prefill of B = 2 random sources of 300 frames
    (no multiple of a tile) under 128-token prompts at full width:
    launches as :func:`encdec_launches` counts for one call, logits
    finite and moved by the source (against the null source of the same
    length); timed as issued eagerly and as device time (CUDA-graph
    replay), the encoder alone too."""
    from repro_torch import models
    from repro_torch.models import encdec
    tag = f"encdec {cfg.name}"
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    B, Ls, Lt = 2, 300, 128
    src = torch.randn((B, Ls, cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16)
    tokens = torch.randint(1, cfg.vocab_size, (B, Lt), generator=gen,
                           device=dev, dtype=torch.int32)
    cache = models.init_cache(cfg, B, 512, src_len=Ls, page_size=16,
                              device=dev)
    models.set_page_table(cache, np.arange(1, B * 32 + 1, dtype=np.int32)
                          .reshape(B, 32))

    def run(batch):
        return models.prefill(params, cfg, batch, cache)[0]

    null = run({"tokens": tokens})
    zero_counts(counters)
    got = run({"src": src, "tokens": tokens})
    torch.cuda.synchronize()
    launches = launch_counts(counters)
    check_launches(f"{tag} source prefill", launches,
                   encdec_launches(cfg, 1, 0))
    moved = (got - null).abs().max().item()
    if not torch.isfinite(got).all() or moved <= 0.1:
        raise AssertionError(f"{tag}: source prefill logits finite "
                             f"{bool(torch.isfinite(got).all())}, moved by "
                             f"the source {moved:.3e}")
    batch = {"src": src, "tokens": tokens}
    times = {"prefill_eager_ms": cuda_ms(lambda: run(batch), reps=5),
             "prefill_device_ms": device_ms(lambda: run(batch), reps=3),
             "encode_eager_ms": cuda_ms(
                 lambda: encdec.encode(params, cfg, src), reps=5),
             "encode_device_ms": device_ms(
                 lambda: encdec.encode(params, cfg, src), reps=3)}
    log(f"[{tag}] source prefill B={B} frames={Ls} prompt={Lt}: logits "
        f"finite, moved by the source up to {moved:.3f} against the null "
        f"source; launches {launches}; {json.dumps(times)}")


def encdec_small(cfg):
    """``cfg`` in fp32 cut to 2 encoder and 2 decoder layers."""
    return dataclasses.replace(cfg, n_layers=2, n_encoder_layers=2,
                               layer_kinds=(), dtype="float32")


def encdec_vs_cpu(cfg, dev, counters) -> None:
    """Phase 12 (c): :func:`encdec_small` on the card against the CPU path.
    The Engine's greedy tokens against one-sequence greedy decoding on the
    CPU (phase 5's rule at the first split), eight requests on four
    slots, monolithic in two waves of four and paged, nm_spmm launching
    as :func:`encdec_launches` counts; then model-level logits with a
    random source of 40 frames under 32-token prompts (prefill, 4 decode
    steps, a T = 4 verify block, paged) within ``FID_ATOL`` of the
    CPU's."""
    from repro_torch import models
    from repro_torch.serving import Engine, ServeConfig
    small = encdec_small(cfg)
    tag = f"encdec fidelity {cfg.name}"
    params = models.init_model(small, seed=SEED + 1, device=dev, packed=True)
    cpu_params = _to(params, "cpu")
    prompts = hybrid_prompts(small.vocab_size)
    wants = [greedy(cpu_params, small, p, 16, 32, 160) for p in prompts]
    for page_size in (0, 16):
        scfg = ServeConfig(slots=4, max_len=160, prompt_pad=32,
                           page_size=page_size, decode_chunk=8,
                           max_new_tokens=16, eos_token=-1)
        eng = Engine(small, scfg, params, device=dev)
        zero_counts(counters)
        got = eng.generate(prompts[:4]) + eng.generate(prompts[4:])
        launches = launch_counts(counters)
        calls = 8 if page_size else 2
        steps = len(eng.stats().chunk_s) * scfg.decode_chunk
        want = encdec_launches(small, calls, steps)
        if not page_size:
            want["paged_attention"] = 0
        check_launches(tag, launches, want)
        splits = []
        for i, (g, (w, gaps, _)) in enumerate(zip(got, wants)):
            split = first_split(g, w)
            splits.append(split)
            if len(g) != 16 or (split is not None
                                and gaps[split] >= GAP_TOL):
                raise AssertionError(f"{tag} request {i}: card {g} vs CPU "
                                     f"{w}")
        log(f"[{tag}] {small.n_encoder_layers} + {small.n_layers} layers "
            f"fp32, {'paged' if page_size else 'monolithic, two waves'}: "
            f"first splits against the CPU {splits}, min CPU top-2 gap "
            f"{min(min(w[1]) for w in wants):.3e}; launches {launches}")
    gen = np.random.default_rng(SEED + 2)
    src = gen.normal(size=(2, 40, small.d_model)).astype(np.float32)
    logits_vs_cpu(small, params, cpu_params, dev, tag, 32,
                  "random source (40 frames)", src=src)


def logits_vs_cpu(small, params, cpu_params, dev, tag: str, prompt: int,
                  what: str, **batch) -> None:
    """Model-level fp32 logits of ``small`` on the card against the CPU
    path on the same weights: a prefill of two random ``prompt``-token
    prompts (plus ``batch``'s arrays, e.g. an enc-dec ``src``) into a
    paged fp32 cache, 4 decode steps and a T = 4 verify block, every
    logit within ``FID_ATOL``."""
    from repro_torch import models
    gen = np.random.default_rng(SEED + 4)
    B = 2
    tokens = gen.integers(1, small.vocab_size, (B, prompt)).astype(np.int32)
    block = gen.integers(1, small.vocab_size, (B, 4)).astype(np.int32)
    table = np.arange(1, B * 10 + 1, dtype=np.int32).reshape(B, 10)
    extra = {"src_len": batch["src"].shape[1]} if "src" in batch else {}
    logits = {}
    for where, p in (("cpu", cpu_params), ("card", params)):
        d = "cpu" if where == "cpu" else dev
        cache = models.init_cache(small, B, 160, page_size=16,
                                  dtype=torch.float32, device=d, **extra)
        models.set_page_table(cache, table)
        lg, cache = models.prefill(p, small, {
            "tokens": torch.from_numpy(tokens).to(d),
            **{k: torch.from_numpy(v).to(d) for k, v in batch.items()}},
            cache)
        out = [lg]
        pos = torch.tensor([prompt] * B, dtype=torch.int32, device=d)
        tok = torch.from_numpy(tokens[:, -1]).to(d)
        for t in range(4):
            lg, cache = models.decode_step(p, small, tok, cache, pos + t)
            out.append(lg)
            tok = torch.from_numpy(block[:, t]).to(d)
        lg, cache = models.decode_block(p, small, torch.from_numpy(
            block).to(d), cache, pos + 4)
        out.append(lg)
        logits[where] = [t.float().cpu() for t in out]
    errs = [(a - b).abs().max().item()
            for a, b in zip(logits["card"], logits["cpu"])]
    if max(errs) > FID_ATOL:
        raise AssertionError(f"{tag}: logits card vs CPU max abs err "
                             f"{errs} > {FID_ATOL}")
    log(f"[{tag}] {what}, B={B}, {prompt}-token prompts, paged: prefill, "
        "4 decode steps and a T = 4 block, fp32 logits max abs err card "
        f"vs CPU {[f'{e:.2e}' for e in errs]} (tolerance {FID_ATOL})")


def encdec_spec(cfg, dev, counters) -> dict:
    """Phase 12 (c), speculation: :func:`encdec_small` through
    :func:`garbage_spec`, one verify block per decoder layer and step."""
    small = encdec_small(cfg)
    return garbage_spec(small, dev, counters, f"encdec spec {cfg.name}",
                        small.n_layers)


# --- phase 13: the gemma pair ------------------------------------------------

#: phase 3's windowed paged calls at phase 13's heads: (lens case, Q, q
#: dtype), bf16 and fp32 q, one query and a verify block
WINDOW_CASES = (("past", 1, torch.bfloat16), ("past", 4, torch.bfloat16),
                ("past", 1, torch.float32), ("past", 4, torch.float32))
#: phase 3's paged calls per gemma config: (window, view pages, lens past
#: it); gemma2's window is cut to 256 there so that its mask bites within
#: phase 4's 512-row view (its own 4096 never masks in phase 13)
GEMMA_PAGED = {"gemma2-27b": (256, 32, [0, 1, 100, 255, 256, 300, 450, 512]),
               "gemma3-1b": (512, 64, [0, 1, 200, 511, 512, 600, 900, 1024])}
#: phase 13 (b)'s serve past gemma3's 512-row window: 8 prompts of
#: 384-600 tokens padded to 640 rows, 256 new tokens each, so the decode
#: runs at positions 640..895 and every local layer's window masks
LONG_SERVE = dict(slots=8, max_len=1024, prompt_pad=640, page_size=16,
                  decode_chunk=16, max_new_tokens=256, eos_token=-1)
GEMMA_WINDOW = 32                  # phase 13 (c): the 2-layer window


#: phase 13's depths since phase 14 came: the whole script must stay
#: under 950 s with training added, and phase 13 is the one cut for it
#: (gemma2 first).  At 8 of gemma2-27b's 46 layers and gemma3-1b's full
#: 26, phase 13 took 177.3 s of a 988 s run, gemma3's serves most of it
#: (the eager turns past the window are host-bound, ~75 ms a step).
#: gemma2 keeps two periods of its 1:1 local/global pattern, gemma3 one
#: of its 5:1
GEMMA2_LAYERS = 4
GEMMA3_LAYERS = 6


def gemma_configs() -> list:
    """Phase 13's configurations: gemma2-27b ``sparse()`` cut to
    ``GEMMA2_LAYERS`` (2 local, 2 global) and gemma3-1b ``sparse()`` to
    ``GEMMA3_LAYERS`` (5 local, 1 global), at published widths."""
    from repro_torch.configs import gemma2_27b, gemma3_1b
    return [cut_depth(gemma2_27b.sparse(), GEMMA2_LAYERS),
            cut_depth(gemma3_1b.sparse(), GEMMA3_LAYERS)]


def mlp_projections(cfg):
    """(name, K, N) of one gated MLP of ``cfg``."""
    d, ff = cfg.d_model, cfg.d_ff
    return [("w_in", d, ff), ("w_gate", d, ff), ("w_out", ff, d)]


def check_flash_window(cfg, dev, L: int, window, softcap) -> None:
    """One prompt's prefill at ``cfg``'s heads with a sliding ``window``
    and a ``softcap``, bf16 and fp32, against the plain version; timed
    beside SDPA under the same causal window mask (without the softcap:
    SDPA has none), the bound counting the keys each query reaches."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref
    H, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pos = torch.arange(L, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (
        pos[None, :] > pos[:, None] - (window or L))
    pairs = sum(min(i + 1, window or L) for i in range(L))
    kw = dict(window=window, softcap=softcap)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((1, h, L, D), generator=gen, device=dev)
                   .to(dtype) for h in (H, Hk, Hk))
        what = (f"{str(dtype)[6:]} B=1 H={H} Hk={Hk} D={D} L={L} "
                f"window={window} softcap={softcap}")
        log_attn_plan("flash_attention", what,
                      K.plan(1, H, Hk, L, L, D, q.dtype))
        err = check_close(f"flash_attention {what}",
                          K.flash_attention(q, k, v, **kw),
                          ref.mha_ref(q.float(), k.float(), v.float(), **kw))
        kr, vr = (t.repeat_interleave(H // Hk, dim=1) for t in (k, v))
        b, by = bound_ms((2 * H + 2 * Hk) * L * D * q.element_size(),
                         4.0 * H * D * pairs,
                         BF16_FLOPS_PER_S if dtype == torch.bfloat16
                         else FP32_FLOPS_PER_S)
        row = dict(**timings(lambda: K.flash_attention(q, k, v, **kw),
                             lambda: ref.mha_ref(q, k, v, **kw),
                             lambda: sdpa(q, kr, vr, attn_mask=mask), 1),
                   bound_ms=b, bound_by=by, max_abs_err=err)
        log(f"[kernels] flash_attention {what} (SDPA under the window mask,"
            f" no softcap): {json.dumps(row)}")


def check_gemma_kernels(cfg, dev) -> None:
    """Phase 3 at phase 13's shapes: nm_spmm at one gated MLP, the paged
    kernel with the local layers' window (``GEMMA_PAGED``) and the
    attention softcap, and without the window (the global layers), each
    in ``WINDOW_CASES``; flash with the window and softcap at the served
    prefills' rows (128, phase 4's prompt; for gemma3 also 640,
    ``LONG_SERVE``'s, with the window and without)."""
    window, mp, lens = GEMMA_PAGED[cfg.name]
    check_nm_spmm(cfg, dev, copies=1, projections=mlp_projections(cfg),
                  what="MLP")
    copies = 12 if cfg.n_kv_heads > 1 else 24     # stream from HBM
    for w in (window, None):
        check_paged_attention(cfg, dev, copies=copies, cases=WINDOW_CASES,
                              mp=mp, lens_of={"past": lens}, window=w,
                              softcap=cfg.attn_softcap)
    check_flash_window(cfg, dev, 128, cfg.window_size, cfg.attn_softcap)
    if cfg.window_size < LONG_SERVE["max_len"]:
        L = LONG_SERVE["prompt_pad"]
        check_flash_window(cfg, dev, L, cfg.window_size, cfg.attn_softcap)
        check_flash_window(cfg, dev, L, None, cfg.attn_softcap)


def local_layers(cfg) -> int:
    from repro_torch.models.config import LayerKind
    return cfg.layer_kinds.count(int(LayerKind.ATTN_LOCAL))


def gemma_launches(cfg, prefills: int, steps: int) -> dict:
    """Each kernel's launches for ``prefills`` prefill calls and ``steps``
    decode steps of ``cfg`` on the paged layout, 2:4 MLPs and dense
    attention: nm_spmm three times per layer and forward, flash once per
    layer and prefill, paged once per layer and step; the local layers'
    launches carry the window."""
    L, W = cfg.n_layers, local_layers(cfg)
    return {"nm_spmm": 3 * L * (prefills + steps),
            "flash_attention": L * prefills,
            "flash_attention window": W * prefills,
            "paged_attention": L * steps,
            "paged_attention window": W * steps}


def gemma_serve(cfg, dev, counters, params, scfg, prompts, what: str
                ) -> dict:
    """One of phase 13's serves: a cold graph serve of ``prompts`` under
    ``scfg``, then :func:`graph_turns` and one profiled replayed chunk.
    Gates: budgets and syncs (``serve_prompts``); only nm_spmm and both
    attention kernels launch, as :func:`gemma_launches` counts, the
    window on every local layer's launches; attention on the tensor
    cores at D = 128 and on the FMA kernels at D = 256 (bf16, queue 2
    item 2(b)).  Returns the cold serve's launches."""
    import gc

    from repro_torch.serving import Engine
    tag = f"gemma {cfg.name} {what}"
    route = "mma" if cfg.head_dim == 128 else "fma"
    eng = Engine(cfg, scfg, params, device=dev)
    cold = serve_prompts(eng, prompts, counters)
    _, rep, launches = cold
    path = {"nm_spmm", "paged_attention", "flash_attention"}
    if any((launches[k] > 0) != (k in path) for k in counted(launches)):
        raise AssertionError(f"{tag}: the kernels of {sorted(path)} must "
                             f"launch and no other: {launches}")
    check_routes(tag, launches, route)
    steps = rep["chunks"] * scfg.decode_chunk
    check_launches(tag, launches,
                   gemma_launches(cfg, rep["prefills"], steps))
    log(f"[{tag}] {json.dumps(rep)}")
    log(f"[{tag}] first request's tokens: {cold[0][0][:16]}; distinct "
        f"tokens per request {[len(set(o)) for o in cold[0]]}")
    turns = graph_turns(eng, prompts, counters, cold, tag)
    warm = [ms for name, _, (_, r, _) in turns if name == "graph warm"
            for ms in r["chunk_ms"]]
    profile_decode_chunk(eng, prompts, sum(warm) / len(warm))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def long_prompts(vocab: int) -> list:
    """Phase 13 (b)'s 8 prompts of 384-600 tokens."""
    rng = np.random.default_rng(SEED + 3)
    return [rng.integers(1, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(384, 601, size=8)]


def gemma_full(cfg, dev, counters) -> dict:
    """Phase 13 (a) and (b): ``cfg`` at its published widths and depth,
    bf16, random weights from the seed, each layer packed as it is drawn
    (``init_model(packed=True)``: 2:4 MLPs, dense attention), phase 4's
    serve and stream through :func:`gemma_serve`; for gemma3 also
    ``LONG_SERVE``, whose decode runs past the local layers' window.
    Returns the launches of the cold serves."""
    import gc

    from repro_torch import models
    from repro_torch.core.sparsity import NMPack
    tag = f"gemma {cfg.name}"
    t0 = time.perf_counter()
    params = models.init_model(cfg, seed=SEED, device=dev, packed=True)
    torch.cuda.synchronize()
    mlps = [w for layer in params["layers"] for w in layer["mlp"].values()]
    attns = [w for layer in params["layers"]
             for k, w in layer["attn"].items() if not k.endswith("_norm")]
    if len(mlps) != 3 * cfg.n_layers or not all(
            isinstance(w, NMPack) for w in mlps) or any(
            isinstance(w, NMPack) for w in attns) or not all(
            "ln_attn_post" in layer and "ln_mlp_post" in layer
            for layer in params["layers"]):
        raise AssertionError(f"{tag}: every MLP projection must be a 2:4 "
                             "pack, every attention projection dense, and "
                             "every layer must hold its post-norms")

    def gb(ws):
        return round(sum(w.values.numel() * 2 + w.idx.numel()
                         * w.idx.element_size()
                         if isinstance(w, NMPack) else w.numel() * 2
                         for w in ws) / 1e9, 3)

    log(f"[{tag}] {cfg.n_layers} layers ({local_layers(cfg)} local, window "
        f"{cfg.window_size}) d_model={cfg.d_model} heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}x{cfg.head_dim} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size} tied, softcaps {cfg.attn_softcap}/"
        f"{cfg.final_softcap}, qk_norm {cfg.qk_norm}, {cfg.dtype}: random "
        f"init + pack layer by layer in {time.perf_counter() - t0:.1f} s; "
        f"GB: MLPs (2:4) {gb(mlps)}, attention (dense) {gb(attns)}, "
        f"embedding {gb([params['embed']])}; "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    launches = gemma_serve(cfg, dev, counters, params, spec_config(),
                           phase4_prompts(cfg.vocab_size), "phase 4")
    if cfg.window_size < LONG_SERVE["max_len"]:
        from repro_torch.serving import ServeConfig
        got = gemma_serve(cfg, dev, counters, params,
                          ServeConfig(**LONG_SERVE),
                          long_prompts(cfg.vocab_size), "past the window")
        launches = {k: launches[k] + got[k] for k in launches}
    del params, mlps, attns
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def gemma_small(cfg):
    """``cfg`` in fp32 cut to 2 layers, one local and one global, with a
    ``GEMMA_WINDOW``-row window and an untied head: with the tied head
    and scaled embeddings, random weights make every transcript the last
    prompt token repeated (the token's own row dominates its logits), so
    tokens that the window or softcap got wrong would still agree, and a
    garbage draft would be accepted."""
    from repro_torch.models.config import LayerKind
    return dataclasses.replace(
        cfg, n_layers=2, dtype="float32", window_size=GEMMA_WINDOW,
        tie_embeddings=False,
        layer_kinds=(int(LayerKind.ATTN_LOCAL), int(LayerKind.ATTN_GLOBAL)))


def gemma_vs_cpu(cfg, dev, counters) -> None:
    """Phase 13 (c): :func:`gemma_small` on the card against the CPU path:
    the Engine's greedy tokens against one-sequence greedy decoding on
    the CPU (phase 5's rule at the first split), four requests padded to
    48 rows so that the decode runs past the window, launches as
    :func:`gemma_launches` counts on the FMA routes; then model-level
    logits (B = 2, 48-token prompts: prefill, 4 decode steps, a T = 4
    verify block, paged) within ``FID_ATOL`` of the CPU's."""
    from repro_torch import models
    from repro_torch.serving import Engine, ServeConfig
    small = gemma_small(cfg)
    tag = f"gemma fidelity {cfg.name}"
    params = models.init_model(small, seed=SEED + 1, device=dev, packed=True)
    cpu_params = _to(params, "cpu")
    prompts = hybrid_prompts(small.vocab_size)[:4]
    scfg = ServeConfig(slots=4, max_len=160, prompt_pad=48, page_size=16,
                       decode_chunk=8, max_new_tokens=16, eos_token=-1)
    wants = [greedy(cpu_params, small, p, 16, 48, 160) for p in prompts]
    eng = Engine(small, scfg, params, device=dev)
    zero_counts(counters)
    got = eng.generate(prompts)
    launches = launch_counts(counters)
    check_routes(tag, launches, "fma")
    check_launches(tag, launches, gemma_launches(
        small, len(prompts), len(eng.stats().chunk_s) * scfg.decode_chunk))
    splits = []
    for i, (g, (w, gaps, _)) in enumerate(zip(got, wants)):
        split = first_split(g, w)
        splits.append(split)
        if len(g) != 16 or (split is not None and gaps[split] >= GAP_TOL):
            raise AssertionError(f"{tag} request {i}: card {g} vs CPU {w}")
    if any(len(set(g)) < 2 for g in got):
        raise AssertionError(f"{tag}: a constant transcript: {got}")
    log(f"[{tag}] 2 layers (local window {GEMMA_WINDOW}, global) fp32, "
        f"untied, paged: first splits against the CPU {splits}, min CPU "
        "top-2 gap "
        f"{min(min(w[1]) for w in wants):.3e}, distinct tokens "
        f"{[len(set(g)) for g in got]}; launches {launches}")
    logits_vs_cpu(small, params, cpu_params, dev, tag, 48,
                  f"past the {GEMMA_WINDOW}-row window")


def gemma_spec(cfg, dev, counters) -> dict:
    """Phase 13 (c), speculation: :func:`gemma_small` through
    :func:`garbage_spec` (past the window from position 33 on), one
    verify block per layer and step."""
    small = gemma_small(cfg)
    return garbage_spec(small, dev, counters, f"gemma spec {cfg.name}",
                        small.n_layers)


# --- phase 14: training, the co-design loop at full width -------------------

#: phase 14's stages: the dense stage of examples/train_sparse_lm.py (lr
#: 3e-3, warmup 20), then the masked fine-tune (lr 1e-3, warmup 10), cut
#: from 60 steps: phase 14 took ~230 s of its 240 at 60 (a step is
#: ~0.55-0.65 s of host-bound eager work on the card's host).  The dense
#: stage was cut from 120 steps to 60 with phase 16: PR 30's whole runs
#: took 1086 and 1092 s, phase 14 197-200 s of them (the dense stage 86 s)
DENSE_STEPS = 60
FT_STEPS = 40
CKPT_STEP = 40                     # the one asynchronous checkpoint
#: launch/train.py's defaults
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TIMED_STEPS = 4                    # steps instrumented with CUDA events
HELDOUT_BATCHES = 4
LOSS_DROP = 1.0                    # first 10 minus last 10 mean losses
#: phase 14 (e): card against the CPU, fp32 (TF32 off): the loss within
#: LOSS_RTOL, every gradient leaf within GRAD_RTOL of its largest entry
#: (the tolerances of tests/test_torch_loss.py)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
#: and after one step every param within STEP_RTOL of its leaf's largest
#: plus STEP_ATOL, with Adam's epsilon at STEP_EPS as in
#: tests/test_torch_train.py: at 1e-8 the first step moves an entry by
#: lr·g/(|g| + 1e-8), about ±lr whatever |g|, so an entry whose gradient
#: is float32 noise moves either way; at 1e-3 the step's gain is at most
#: 1e3 and the comparison holds
STEP_RTOL, STEP_ATOL, STEP_EPS = 1e-5, 1e-6, 1e-3
TRAIN_ARCHS = ("qwen3-0.6b", "qwen2-moe-a2.7b", "zamba2-1.2b",
               "seamless-m4t-large-v2", "gemma2-27b")


def train_data():
    from repro_torch.data import DataConfig
    return DataConfig(seed=SEED, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)


def no_kernel_launched(tag: str, counters, before: dict) -> None:
    after = launch_counts(counters)
    if after != before:
        raise AssertionError(f"{tag}: the training route launched a kernel: "
                             f"{before} -> {after}")


def step_split(trainer, params, opt) -> dict:
    """Median device ms of a train step's parts over ``TIMED_STEPS``
    extra steps of the trainer's own step (``build_train_step`` with its
    configs; results dropped, the step is functional): data wait (the
    batch drawn on the host and copied), forward, backward and optimizer,
    between CUDA events recorded by the step's ``mark`` hook as the host
    issues each part."""
    from repro_torch.data import make_batch
    from repro_torch.train import build_train_step
    events: list = []

    def mark(part: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((part, ev))

    step = build_train_step(trainer.cfg, trainer.tcfg, masks=trainer.masks,
                            mark=mark)
    parts = {"data": [], "forward": [], "backward": [], "optimizer": []}
    for i in range(TIMED_STEPS):
        events.clear()
        torch.cuda.synchronize()
        mark("start")
        batch = make_batch(trainer.cfg, trainer.dcfg, trainer.tcfg.steps + i,
                           trainer.device)
        mark("data")
        out = step(params, opt, batch)
        torch.cuda.synchronize()
        for (_, a), (part, b) in zip(events, events[1:]):
            parts[part].append(a.elapsed_time(b))
        del out
    return {k: float(np.median(v)) for k, v in parts.items()}


def dense_training(cfg, dev, counters) -> tuple:
    """Phase 14 (a): the port's ``Trainer`` from a seeded random init,
    ``DENSE_STEPS`` steps, one asynchronous checkpoint at ``CKPT_STEP``
    under ``build/``.  Gates: finite losses and grad norms; the mean of
    the last 10 losses at least ``LOSS_DROP`` below the first 10's; the
    checkpoint restores bitwise equal to a host copy taken at that step;
    no kernel launches.  Returns (params, report)."""
    from repro_torch.checkpoint import CheckpointManager, load_checkpoint
    from repro_torch.examples import train_sparse_lm as ex
    from repro_torch.tree import leaves, with_paths
    ckpt = ROOT / "build" / "phase14_checkpoints"
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt), keep=1)
    trainer = ex.dense_trainer(cfg, train_data(), DENSE_STEPS, device=dev,
                               log_every=1)
    host = {}

    def progress(step, m):
        if step % 10 == 0 or step == DENSE_STEPS - 1:
            log(f"[train dense] step {step}: loss {m['loss']:.4f}, grad "
                f"norm {m['grad_norm']:.3f}, lr {m['lr']:.2e}, "
                f"{1e3 * m['step_time_s']:.1f} ms")
        if step + 1 == CKPT_STEP:
            host.update({k: v.detach().to("cpu", copy=True) for k, v in
                         with_paths({"params": trainer.params})})
            mgr.save(CKPT_STEP, {"params": trainer.params,
                                 "opt": trainer.opt_state})

    before = launch_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = trainer.fit(progress=progress)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mgr.wait()
    no_kernel_launched("train dense", counters, before)
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist):
        raise AssertionError("train dense: a loss or grad norm is not finite")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    if not last <= first - LOSS_DROP:
        raise AssertionError(f"train dense: loss {first:.4f} -> {last:.4f}, "
                             f"a drop under {LOSS_DROP}")
    t1 = time.perf_counter()
    flat, manifest = load_checkpoint(str(ckpt / f"step_{CKPT_STEP:09d}"))
    restore_s = time.perf_counter() - t1
    bad = [k for k, v in host.items() if v.dtype != flat[k].dtype
           or not torch.equal(v, flat[k])]
    if manifest["step"] != CKPT_STEP or bad:
        raise AssertionError(f"train dense: the step-{CKPT_STEP} checkpoint "
                             f"differs from the host copy at {bad[:5]}")
    split = step_split(trainer, params, opt)
    del opt
    steps_ms = sorted(1e3 * h["step_time_s"] for h in hist[5:])
    step_ms = float(np.median(steps_ms))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n = cfg.param_count()
    ck = mgr.timings[0]
    rep = {"steps": len(hist), "fit_s": fit_s, "loss_first10": first,
           "loss_last10": last, "step_ms_median": step_ms,
           "step_ms_min_max": [steps_ms[0], steps_ms[-1]],
           "split_ms": split, "tokens_per_s": tokens / step_ms * 1e3,
           "matmul_params": n, "model_utilization": 6 * n * tokens
           / (step_ms * 1e-3) / BF16_FLOPS_PER_S,
           "peak_mem_gb": peak_gb, "checkpoint_stall_s": ck["stall_s"],
           "checkpoint_total_s": ck["total_s"],
           "checkpoint_restore_s": restore_s,
           "checkpoint_leaves": len(flat),
           "stragglers": len(trainer.straggler_flags)}
    log(f"[train dense] {json.dumps(rep)}")
    log(f"[train dense] loss {first:.4f} -> {last:.4f} (means of the first "
        f"and last 10 of {len(hist)} steps); median step {step_ms:.2f} ms "
        f"after 5 warm-up steps ({rep['tokens_per_s']:.0f} tokens/s; split "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f" ms); model utilization {rep['model_utilization']:.4f} = 6 x "
        f"{n} matmul params (head included) x {tokens} tokens / step time / "
        f"989 TFLOP/s, recompute not counted; peak {peak_gb:.3f} GB; "
        f"checkpoint at step {CKPT_STEP}: stall {ck['stall_s']:.3f} s, "
        f"written in {ck['total_s']:.3f} s, restored bitwise ({len(flat)} "
        f"arrays, {restore_s:.3f} s)")
    shutil.rmtree(ckpt, ignore_errors=True)
    return params, rep


def check_masks(params, masks, tag: str) -> None:
    """Every masked position exactly 0; no mask's kept positions all 0."""
    from repro_torch.examples import train_sparse_lm as ex
    pairs = ex.masked_leaves(params, masks)
    if not ex.zeros_kept(params, masks):
        raise AssertionError(f"{tag}: a masked position is not 0")
    if any(not bool((p[m == 1] != 0).any()) for p, m in pairs):
        raise AssertionError(f"{tag}: a mask's kept positions are all 0")


def prune_finetune(cfg, params, dev, counters) -> tuple:
    """Phase 14 (b): 2:4 masks along K on all seven projections,
    positions shared over 128 columns (``sparse()``'s packs), then
    ``FT_STEPS`` masked fine-tune steps.  Gates: masked positions 0 and
    no mask's kept positions all 0, on the card; the held-out loss after
    the fine-tune below the loss right after pruning; no kernel
    launches.  Returns (masks, fine-tuned params, report)."""
    from repro_torch.examples import train_sparse_lm as ex
    from repro_torch.optim import apply_mask
    dcfg = train_data()
    dense = ex.heldout_loss(params, cfg, dcfg, HELDOUT_BATCHES, dev)
    masks = ex.nm_masks(params, 2, 4, group=128, names=ex.PROJECTIONS)
    pruned = apply_mask(params, masks)
    after_prune = ex.heldout_loss(pruned, cfg, dcfg, HELDOUT_BATCHES, dev)
    before = launch_counts(counters)

    def progress(s, m):
        if s % 10 == 0 or s == FT_STEPS - 1:
            log(f"[train finetune] step {s}: loss {m['loss']:.4f}, grad norm "
                f"{m['grad_norm']:.3f}, {1e3 * m['step_time_s']:.1f} ms")

    tuned, hist = ex.finetune(cfg, pruned, masks, dcfg, FT_STEPS, device=dev,
                              progress=progress)
    no_kernel_launched("train finetune", counters, before)
    check_masks(tuned, masks, "train finetune")
    finetuned = ex.heldout_loss(tuned, cfg, dcfg, HELDOUT_BATCHES, dev)
    rep = {"heldout_dense": dense, "heldout_pruned": after_prune,
           "heldout_finetuned": finetuned,
           "step_ms_median": float(np.median([1e3 * h["step_time_s"]
                                              for h in hist[5:]])),
           "masked_leaves": len(ex.masked_leaves(tuned, masks))}
    log(f"[train finetune] {json.dumps(rep)}")
    if not finetuned < after_prune:
        raise AssertionError(f"train finetune: held-out loss {finetuned:.4f} "
                             f"not below {after_prune:.4f} after pruning")
    return masks, tuned, rep


def check_packs_keep_masks(packed, masks) -> int:
    """Each pack's kept K-rows, per column group, are exactly its mask's."""
    from repro_torch.core.sparsity import NMPack
    from repro_torch.tree import leaves, leaves_as
    n = 0
    for pack, m in zip(leaves(packed), leaves_as(masks, packed)):
        if m is None:
            continue
        if not isinstance(pack, NMPack):
            raise AssertionError(f"a masked weight was not packed: "
                                 f"{type(pack)}")
        kept = torch.zeros((pack.K, pack.N // pack.g), dtype=torch.bool,
                           device=m.device)
        cols = torch.arange(pack.N // pack.g, device=m.device)
        kept[pack.src_rows(), cols.expand(pack.Kc, -1)] = True
        if not torch.equal(kept, m[:, ::pack.g] != 0):
            raise AssertionError("a pack keeps other positions than its "
                                 "mask")
        n += 1
    return n


def heldout_prompts(cfg) -> list:
    """16 prompts of 16-128 tokens from batches no stage trains on."""
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.examples import train_sparse_lm as ex
    rows = make_batch(cfg, DataConfig(seed=SEED, global_batch=16,
                                      seq_len=128),
                      ex.HELDOUT_START + 1000, "cpu")["tokens"].numpy()
    lens = np.random.default_rng(SEED).integers(16, 129, size=16)
    return [rows[i, :n].astype(np.int32) for i, n in enumerate(lens)]


def transition_share(cfg, prompts, outs) -> float:
    """Share of generated tokens that follow the stream's deterministic
    transition from the token before them."""
    from repro_torch.data import transition
    hit = total = 0
    for p, o in zip(prompts, outs):
        prev = [int(p[-1])] + list(o[:-1])
        hit += sum(int(transition(a, cfg.vocab_size)) == b
                   for a, b in zip(prev, o))
        total += len(o)
    return hit / total


def nm_launches(cfg, prefills: int, steps: int) -> dict:
    """2:4 on all seven projections, paged: nm_spmm 7 times per layer
    and forward, flash once per layer and prefill, paged once per layer
    and step."""
    L = cfg.n_layers
    return {"nm_spmm": 7 * L * (prefills + steps),
            "flash_attention": L * prefills, "paged_attention": L * steps}


def splits_at_near_ties(tag, params, cfg, dev, prompts, outs, base) -> int:
    """Each request's tokens equal ``base``'s or split first at a near
    tie of ``base``'s model (``near_tie``, read by replaying ``base`` one
    sequence at a time).  Returns the requests token-equal."""
    dtype = params["embed"].dtype
    far, equal = [], 0
    for i, (p, a, b) in enumerate(zip(prompts, outs, base)):
        split = first_split(a, b)
        if split is None:
            equal += 1
            continue
        _, gaps, tops = greedy(params, cfg, p, len(b), 128, 512, device=dev,
                               forced=b)
        tie = near_tie(gaps[split], tops[split], dtype)
        log(f"[{tag}] request {i}: first split at {split}, top-2 gap there "
            f"{gaps[split]:.3e} at top logit {tops[split]:.4f}: "
            f"{'a near tie' if tie else 'NOT a tie'}")
        if not tie:
            far.append(i)
    if far:
        raise AssertionError(f"{tag}: requests {far} split away from a near "
                             "tie")
    return equal


def pack_and_serve(cfg, dense, tuned, masks, dev, counters) -> tuple:
    """Phase 14 (c): ``pack_params`` under ``sparse()`` of the fine-tuned
    weights, served through phase 4's Engine over held-out prompts (cold,
    then warm).  Gates: each pack keeps exactly its mask's positions;
    budgets and syncs (``serve_prompts``); only nm_spmm and both
    attention kernels, as ``nm_launches`` counts; the tokens equal the
    masked weights' served dense or split first at a near tie.  Also
    serves the dense-trained weights and their one-shot pruned pack for
    the transition shares.  Returns (the fine-tuned pack, the dense
    serve's tokens, launches, report)."""
    from repro_torch.core.sparse_linear import SparsityConfig, pack_params
    from repro_torch.serving import Engine
    nm = SparsityConfig(format="nm", n=2, m=4, block_n=128)   # sparse()'s
    scfg = dataclasses.replace(cfg, mlp_sparsity=nm, attn_sparsity=nm)
    packed = pack_params(tuned, scfg)
    n_packs = check_packs_keep_masks(packed, masks)
    prompts = heldout_prompts(cfg)
    eng = Engine(scfg, spec_config(), packed, device=dev)
    outs, rep, launches = serve_prompts(eng, prompts, counters)
    path = {"nm_spmm", "paged_attention", "flash_attention"}
    if any((launches[k] > 0) != (k in path) for k in counted(launches)):
        raise AssertionError(f"train serve: the kernels of {sorted(path)} "
                             f"must launch and no other: {launches}")
    check_launches("train serve", launches, nm_launches(
        scfg, rep["prefills"], rep["chunks"] * eng.scfg.decode_chunk))
    warm_outs, warm, _ = serve_prompts(eng, prompts, counters)
    if warm_outs != outs:
        raise AssertionError("train serve: the warm serve's tokens differ")
    log(f"[train serve] fine-tuned pack ({n_packs} packs keep their masks): "
        f"{json.dumps(rep)}")
    masked_dense = serve_prompts(Engine(cfg, spec_config(), tuned,
                                        device=dev), prompts, counters)[0]
    equal = splits_at_near_ties("train serve", tuned, cfg, dev, prompts,
                                outs, masked_dense)
    dense_outs = serve_prompts(Engine(cfg, spec_config(), dense, device=dev),
                               prompts, counters)[0]
    oneshot = serve_prompts(Engine(scfg, spec_config(),
                                   pack_params(dense, scfg), device=dev),
                            prompts, counters)[0]
    shares = {what: transition_share(cfg, prompts, o) for what, o in
              (("dense", dense_outs), ("one-shot pruned pack", oneshot),
               ("fine-tuned pack", outs))}
    out = {"warm_decode_ms_per_step": warm["decode_ms_per_step"],
           "warm_tok_per_s": warm["tok_per_s"],
           "equal_to_masked_dense": equal, "transition_share": shares}
    log(f"[train serve] warm {warm['decode_ms_per_step']:.3f} ms/step, "
        f"{warm['tok_per_s']:.2f} tok/s; {equal}/{len(prompts)} requests "
        f"token-equal to the masked weights served dense; share of "
        "generated tokens that follow the stream's transition: "
        + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
    return packed, dense_outs, launches, out


def trained_speculation(cfg, dense, packed, base, dev, counters,
                        random_acceptance: float) -> tuple:
    """Phase 14 (d): the dense-trained weights verify ``SPEC_K`` tokens
    drafted by the fine-tuned pack (``draft_params``).  Gates: budgets
    and syncs; one verify block per layer and step; nm_spmm 7 times per
    layer and draft step; the tokens equal the plain loop's (``base``)
    or split first at a near tie.  Printed beside ``random_acceptance``,
    phase 8's pack draft on random weights in this run."""
    from repro_torch.serving import Engine
    prompts = heldout_prompts(cfg)
    eng = Engine(cfg, spec_config(spec_k=SPEC_K), dense,
                 draft_params=packed, device=dev)
    outs, rep, launches = serve_prompts(eng, prompts, counters)
    steps = rep["chunks"] * eng.scfg.decode_chunk
    L = cfg.n_layers
    if launches["paged_attention Q>1"] != L * steps or \
            launches["nm_spmm"] != 7 * L * steps * SPEC_K:
        raise AssertionError(f"train spec: {launches} for {steps} steps of "
                             f"{L} layers")
    equal = splits_at_near_ties("train spec", dense, cfg, dev, prompts, outs,
                                base)
    out = {"acceptance": rep["acceptance_rate"],
           "tokens_per_chunk": rep["tokens_per_chunk"],
           "random_weights_acceptance": random_acceptance,
           "equal_to_plain": equal, "decode_ms_per_step":
           rep["decode_ms_per_step"], "tok_per_s": rep["tok_per_s"]}
    log(f"[train spec] {json.dumps(rep)}")
    log(f"[train spec] trained weights, fine-tuned pack draft, k = {SPEC_K}:"
        f" acceptance {rep['acceptance_rate']:.4f} ({rep['accepted']} of "
        f"{rep['drafted']}), {rep['tokens_per_chunk']:.1f} tokens/chunk "
        f"(phase 8's pack draft on random weights at {SPEC_LAYERS} layers "
        f"accepted {random_acceptance:.4f} in this run); "
        f"{equal}/{len(prompts)} requests equal to "
        "the plain loop")
    return launches, out


def train_vs_cpu(dev, counters) -> None:
    """Phase 14 (e): each family's reduced config in fp32 (TF32 off):
    ``model_loss`` and every gradient leaf on the card against the CPU
    path, then one ``build_train_step`` step with Adam at ``STEP_EPS``
    (loss, grad norm, first moments and every param); the six kernels'
    launch counters read 0 across it."""
    from unittest import mock

    from repro_torch import configs as C
    from repro_torch import models
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, build_train_step, \
        init_opt_state
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import leaves
    for arch in TRAIN_ARCHS:
        cfg = dataclasses.replace(C._module(arch).reduced(), dtype="float32")
        params = models.init_model(cfg, seed=SEED, device="cpu")
        gparams = _to(params, dev)
        d = DataConfig(seed=SEED, global_batch=2, seq_len=24)
        cb, gb = make_batch(cfg, d, 0, "cpu"), make_batch(cfg, d, 0, dev)

        def loss_fn(p, b):
            return models.model_loss(p, cfg, b)

        before = launch_counts(counters)
        lc, g_cpu = value_and_grad(loss_fn, params, cb)
        lg, g_card = value_and_grad(loss_fn, gparams, gb)
        tcfg = TrainConfig(steps=3, lr=1e-3)
        with mock.patch.object(trainer_mod, "AdamWConfig", functools.partial(
                AdamWConfig, eps=STEP_EPS)):
            step = build_train_step(cfg, tcfg)
        pc, oc, mc = step(params, init_opt_state(params, tcfg), cb)
        pg, og, mg = step(gparams, init_opt_state(gparams, tcfg), gb)
        torch.cuda.synchronize()
        no_kernel_launched(f"train fidelity {arch}", counters, before)
        errs = []
        if abs(float(lg) - float(lc)) > LOSS_RTOL * abs(float(lc)):
            raise AssertionError(f"{arch}: loss {float(lg)} vs {float(lc)}")
        for a, b in zip(leaves(g_card), leaves(g_cpu)):
            err = float((a.cpu() - b).abs().max())
            errs.append(err / max(float(b.abs().max()), 1e-30))
            if err > GRAD_RTOL * float(b.abs().max()) + 1e-8:
                raise AssertionError(f"{arch}: a gradient leaf is {err:.3e} "
                                     "off the CPU's")
        for k in ("loss", "grad_norm"):
            if abs(float(mg[k]) - float(mc[k])) > \
                    LOSS_RTOL * abs(float(mc[k])):
                raise AssertionError(f"{arch}: step {k} {float(mg[k])} vs "
                                     f"{float(mc[k])}")
        for a, b in zip(leaves(og["mu"]), leaves(oc["mu"])):
            if float((a.cpu() - b).abs().max()) > \
                    GRAD_RTOL * float(b.abs().max()) + 1e-12:
                raise AssertionError(f"{arch}: a first moment is off the "
                                     "CPU's")
        worst = 0.0
        for a, b, g, h in zip(leaves(pg), leaves(pc), leaves(g_cpu),
                              leaves(g_card)):
            diff = (a.cpu() - b).abs()
            off = diff > STEP_RTOL * float(b.abs().max()) + STEP_ATOL
            if bool(off.any()):
                raise AssertionError(
                    f"{arch}: {int(off.sum())} params after the step are "
                    f"off the CPU's by up to {float(diff.max()):.3e}, their "
                    f"gradients {g[off][:4].tolist()} on the CPU, "
                    f"{h.cpu()[off][:4].tolist()} on the card")
            worst = max(worst, float(diff.max()))
        log(f"[train fidelity {arch}] fp32 card vs CPU: loss {float(lg):.6f} "
            f"vs {float(lc):.6f}, worst gradient leaf {max(errs):.3e} of its "
            f"largest entry ({len(errs)} leaves); one step (Adam eps "
            f"{STEP_EPS}): loss, grad norm and first moments within "
            f"tolerance, every param within {STEP_RTOL} of its leaf's "
            f"largest + {STEP_ATOL} (worst {worst:.3e}); no kernel launched")


def training(dev, counters, random_acceptance: float) -> tuple:
    """Phase 14: (a)-(d) on qwen3-0.6b at full width and depth (bf16,
    seeded random init), then (e); ``random_acceptance`` is phase 8's
    pack draft's.  Returns (serve launches, report)."""
    import gc

    from repro_torch.configs import qwen3_0_6b
    cfg = qwen3_0_6b.config()
    log(f"[train] {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
        f"vocab {cfg.vocab_size} {cfg.dtype}, remat={cfg.remat}; batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}; dense {DENSE_STEPS} steps, fine-tune "
        f"{FT_STEPS}")
    report = {}
    dense, report["dense"] = dense_training(cfg, dev, counters)
    masks, tuned, report["finetune"] = prune_finetune(cfg, dense, dev,
                                                      counters)
    packed, base, launches, report["serve"] = pack_and_serve(
        cfg, dense, tuned, masks, dev, counters)
    got, report["spec"] = trained_speculation(cfg, dense, packed, base, dev,
                                              counters, random_acceptance)
    for k in ("nm_spmm", "paged_attention", "flash_attention"):
        launches[k] += got[k]
    del dense, tuned, packed, masks
    gc.collect()
    torch.cuda.empty_cache()
    train_vs_cpu(dev, counters)
    return launches, report


# --- phase 3 at phase 15's shapes: the serving bench's geometries -----------

def bench_config():
    """The serving bench's model geometry (``bench_serving._model``):
    d_model 64 over 4 heads and 2 kv heads (D = 16), MLPs of 64 <-> 128,
    bf16."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="bench", n_layers=2, d_model=64, vocab_size=256,
                       n_heads=4, n_kv_heads=2, d_ff=128, remat=False)


#: rows of the bench's matmuls: decode at 1 and 8 slots, a slot's 16-row
#: prefill and the 8 x 16 wave prefill
BENCH_M = (1, 8, 16, 128)


def check_bench_csa(cfg, dev) -> None:
    """``csa_matmul`` at the bench's combined MLP (64 x 64 tiles, 32 kept
    rows each: the half stage) at ``BENCH_M``, held against the plain
    version (two calls bitwise equal), timed at 8 and 128 rows beside
    cuBLAS on the dense weight and the bound."""
    from repro_torch.core import pruning, sparsity
    from repro_torch.kernels import csa_matmul as K
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    packs, dense = [], []
    for _, k, n in mlp_projections(cfg):
        w = (torch.randn((k, n), generator=gen, device=dev)
             / k ** 0.5).to(torch.bfloat16)
        pw, _ = pruning.combined_nm(w, 0.5, 2, 4, group=64, block=64)
        packs.append(sparsity.pack_combined(pw, 2, 4, 64, 64))
        dense.append(pw)
    err = 0.0
    for M in BENCH_M:
        log_plans("csa_matmul bench", M, [
            (proj, K.plan(M, p.K, p.N, torch.bfloat16, p.max_nnz, 64, 64))
            for (proj, _, _), p in zip(mlp_projections(cfg), packs)])
        xs = {k: torch.randn((M, k), generator=gen, device=dev)
              .to(torch.bfloat16) for _, k, _ in mlp_projections(cfg)}
        for p in packs:
            what = f"csa_matmul bench M={M} K={p.K} N={p.N}"
            got = K.csa_matmul(xs[p.K], p)
            if not torch.equal(got, K.csa_matmul(xs[p.K], p)):
                raise AssertionError(f"{what}: two calls differ")
            err = max(err, check_close(what, got,
                                       ref.csa_matmul_ref(xs[p.K], p)))
        if M not in (8, 128):
            continue
        nbytes = flops = 0.0
        for p in packs:
            kept = int(p.counts.sum()) * p.bkc
            nbytes += (M * p.K + kept * p.bn + M * p.N) * 2 \
                + (int(p.counts.sum()) + p.counts.numel() + kept) * 4
            flops += 2.0 * M * kept * p.bn
        b, by = bound_ms(nbytes, flops)
        row = dict(**timings(
            lambda: [K.csa_matmul(xs[p.K], p) for p in packs],
            lambda: [ref.csa_matmul_ref(xs[p.K], p) for p in packs],
            lambda: [torch.matmul(xs[w.shape[0]], w) for w in dense], 1),
            bound_ms=b, bound_by=by, density=sum(
                float(p.density) for p in packs) / len(packs))
        log(f"[kernels] csa_matmul bench MLP (3 projections, 64 x 64 "
            f"tiles) at M={M}: {json.dumps(row)}")
    log(f"[kernels] csa_matmul bench: max abs err {err:.3e} against the "
        "plain version at M = 1, 8, 16, 128; two calls bitwise equal")


def check_bench_kernels(dev) -> None:
    """Phase 3 at phase 15's shapes: the new instances the serving bench
    and the streaming demo run, against their plain versions and timed:
    ``nm_spmm`` at the bench's 2:4 MLP (g = 64; K = 64 keeps 32 rows, the
    half stage), ``csa_matmul`` at its combined MLP, and both attention
    kernels at D = 16 (4 heads over 2) on their FMA routes: flash at L =
    16 (a slot's prompt), 128 and 512 (the longest bucket), paged at 8
    slots over a 36-page view (the bench's 576 rows) at Q = 1, the
    speculative verify blocks Q = 3 and 5, and fp32 q."""
    cfg = bench_config()
    check_nm_spmm(cfg, dev, copies=1, projections=mlp_projections(cfg),
                  sweep=BENCH_M, timed=(8, 128), what="bench MLP", g=64)
    check_bench_csa(cfg, dev)
    check_flash_attention(cfg, dev, lengths=(16, 128, 512))
    bf16 = torch.bfloat16
    check_paged_attention(cfg, dev, copies=4, mp=36, cases=(
        ("mixed", 1, bf16), ("serve", 1, bf16), ("mixed", 3, bf16),
        ("mixed", 5, bf16), ("mixed", 1, torch.float32)))


# --- phase 15: the launchers, the serving bench, CNN training, examples -----

#: phase 15 (a): the launcher at qwen3-0.6b's full width and depth
LAUNCH_FLAGS = ["--arch", "qwen3-0.6b", "--requests", "16", "--slots", "8",
                "--prompt-len", "128", "--prompt-pad", "128", "--max-len",
                "512", "--max-new", "64", "--page-size", "16",
                "--decode-chunk", "16"]
LAUNCH_SPEC = ["--spec-k", "3", "--spec-draft", "self"]
#: the report's wall-clock fields; the others are counts
LAUNCH_TIMED = ("wall_s", "tok_per_s", "ttft_p50_ms")
CKPT_STEP_15 = 5                   # phase 15 (a)'s checkpoint step


def run_launcher(argv, counters) -> tuple:
    """``launch.serve.main(argv)`` in-process with every launch count set
    to 0 just before and read just after: (printed lines, report,
    launches, the engine it served)."""
    import contextlib
    import io
    from unittest import mock

    import repro_torch.serving as S
    from repro_torch.launch import serve
    engines = []

    class Recorded(S.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    buf = io.StringIO()
    zero_counts(counters)
    torch.cuda.synchronize()
    with mock.patch.object(S, "Engine", Recorded), \
            contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    torch.cuda.synchronize()
    launches = launch_counts(counters)
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or len(engines) != 1:
        raise AssertionError(f"launcher {argv}: exit {rc}, {len(engines)} "
                             "engines")
    return lines, json.loads(lines[-1]), launches, engines[0]


def launcher_full_width(dev, counters) -> dict:
    """Phase 15 (a): ``launch.serve.main`` at qwen3-0.6b's full width and
    depth, plain and with a ``spec_k = 3`` self draft.  Gates: one host
    sync per decode chunk; flash once per layer and prefill; paged once
    per layer and step (plain), or per layer, step and draft plus one
    Q = 4 verify block per layer and step (speculation); no matmul
    kernel (dense projections run on cuBLAS, as in JAX)."""
    from repro_torch.configs import qwen3_0_6b
    L = qwen3_0_6b.config().n_layers
    out = {}
    for tag, argv in (("plain", LAUNCH_FLAGS),
                      ("spec self", LAUNCH_FLAGS + LAUNCH_SPEC)):
        _, rep, launches, eng = run_launcher(argv, counters)
        st = eng.stats()
        chunks = len(st.chunk_s)
        steps = chunks * eng.scfg.decode_chunk
        K = eng.scfg.spec_k
        want = {"flash_attention": L * rep["prefills"],
                "paged_attention": L * steps * (K + 1),
                "paged_attention Q>1": L * steps if K else 0}
        got = {k: launches[k] for k in want}
        if rep["host_syncs"] != chunks or got != want or any(
                launches[k] for k in ("nm_spmm", "csa_matmul", "bsr_matmul",
                                      "lookahead_decode")):
            raise AssertionError(f"launcher {tag}: {rep['host_syncs']} "
                                 f"syncs for {chunks} chunks; launches "
                                 f"{launches}, want {want}")
        log(f"[launch {tag}] {json.dumps(rep)}")
        runs = {h: sum(r == h for _, r in st.chunk_runs)
                for h in ("eager", "capture", "replay")}
        log(f"[launch {tag}] {chunks} chunks ({steps} steps), launches "
            f"{json.dumps(launches)}; chunk runs {json.dumps(runs)}")
        out[tag] = dict(rep, launches=launches)
        del eng
        torch.cuda.empty_cache()
    return out


def launcher_checkpoint(dev, counters, tmp: Path) -> None:
    """Phase 15 (a), restore: write ``{"params": ...}`` of qwen3-0.6b's
    ``reduced()`` (seed ``SEED + 15``) with the port's
    ``CheckpointManager``, serve it with ``python -m
    repro_torch.launch.serve --arch qwen3-0.6b --reduced --checkpoint-dir
    D`` in a subprocess, and in-process with the same flags: the
    subprocess must print ``restored checkpoint step N`` and the same
    counts."""
    import os

    from repro_torch import models as MZ
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import qwen3_0_6b
    d = tmp / "launch_ckpt"
    params = MZ.init_model(qwen3_0_6b.reduced(), seed=SEED + 15, device=dev)
    CheckpointManager(str(d)).save(CKPT_STEP_15, {"params": params},
                                   blocking=True)
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--checkpoint-dir", str(d)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *argv], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the launcher's subprocess failed: "
                             f"{proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    sub = json.loads(lines[-1])
    here_lines, here, _, _ = run_launcher(argv, counters)
    want = f"restored checkpoint step {CKPT_STEP_15}"
    counts = {k: v for k, v in here.items() if k not in LAUNCH_TIMED}
    if lines[0] != want or here_lines[0] != want or \
            {k: sub.get(k) for k in counts} != counts:
        raise AssertionError(f"launcher restore: {lines[0]!r}, "
                             f"{here_lines[0]!r}; {sub} vs {here}")
    log(f"[launch restore] subprocess ({sub_s:.1f} s): {lines[0]}; "
        f"{json.dumps(sub)}; the in-process serve of the same checkpoint "
        "gives the same counts")


def bench_serving_smoke(dev, counters) -> tuple:
    """Phase 15 (b): ``bench_serving.run()`` at the smoke sizes on the
    card.  Gates: ``nm_spmm`` and ``csa_matmul`` launched on their half
    stage and both attention kernels on their FMA routes (D = 16, the
    only bf16 FMA geometry the bench has); every chunked row's syncs
    equal its chunks; the chunked and per-token serves of a grid row
    count equal tokens."""
    import importlib
    import os
    os.environ["REPRO_BENCH_SMOKE"] = "1"
    import repro_torch.benchmarks.bench_serving as B
    B = importlib.reload(B)
    zero_counts(counters)
    t0 = time.perf_counter()
    out = B.run(device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(counters)
    for r in out["rows"]:
        log(f"[bench serving] {json.dumps(r)}")
    for why in out["not_ported"].items():
        log(f"[bench serving] not ported: {why[0]} ({why[1]})")
    bad = [r["config"] for r in out["rows"] if r["syncs"] != r["chunks"]]
    bad += [r["config"] for r in out["rows"]
            if "ref_tokens" in r and r["ref_tokens"] != r["tokens"]]
    fma = {k: launches[k] - launches[f"{k} mma"]
           for k in ("flash_attention", "paged_attention")}
    if bad or not launches["nm_spmm half"] or \
            not launches["csa_matmul half"] or not all(fma.values()):
        raise AssertionError(f"bench serving: rows {bad} break the sync or "
                             f"token contract; launches {launches}")
    log(f"[bench serving] run() {wall:.1f} s on the card; launches "
        f"{json.dumps(launches)} (FMA-route attention {json.dumps(fma)})")
    return launches, out


def cnn_training_vs_cpu(dev, counters) -> None:
    """Phase 15 (c): three fp32 DS-CNN steps of ``bench_int7._train`` on
    the card (TF32 off) against the CPU path from the same init, Adam at
    ``STEP_EPS``; every leaf within ``STEP_RTOL`` of its largest entry;
    no kernel launches."""
    from unittest import mock

    import repro_torch.optim as O
    from repro_torch.benchmarks.bench_int7 import RUNS, _train
    from repro_torch.models import cnn
    model, shape, classes, width, _ = next(r for r in RUNS
                                           if r[0] == "dscnn")
    init = cnn.CNN_ZOO[model][0](seed=SEED, num_classes=classes, width=width,
                                 device="cpu")
    before = launch_counts(counters)
    with mock.patch.object(O, "AdamWConfig", functools.partial(
            O.AdamWConfig, eps=STEP_EPS)):
        pc, acc_c, _ = _train(model, shape, classes, width, 3, params=init,
                              device="cpu")
        pg, acc_g, _ = _train(model, shape, classes, width, 3,
                              params=_to(init, dev), device=dev)
    torch.cuda.synchronize()
    no_kernel_launched("cnn fidelity", counters, before)
    worst = 0.0
    for a, b in zip(_leaves(pg), _leaves(pc)):
        err = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
        if err > STEP_RTOL:
            raise AssertionError(f"cnn fidelity: a leaf after 3 steps is "
                                 f"{err:.3e} of its largest off the CPU's")
        worst = max(worst, err)
    log(f"[cnn fidelity] {model} w={width}: 3 fp32 AdamW steps (eps "
        f"{STEP_EPS}) on the card vs the CPU: worst leaf {worst:.3e} of its "
        f"largest entry (limit {STEP_RTOL}); held-out acc {acc_g(pg):.4f} "
        f"vs {acc_c(pc):.4f}; no kernel launched")


def cnn_training(dev, counters) -> dict:
    """Phase 15 (c): Table II (``bench_int7.run()``: three CNNs, 250 /
    200 / 250 steps of 64) and ``examples.tinyml_repro`` on the card,
    printed as findings (not gated), then the fp32 comparison with the
    CPU."""
    import contextlib
    import io

    from repro_torch.benchmarks import bench_int7
    from repro_torch.examples import tinyml_repro
    t0 = time.perf_counter()
    out = bench_int7.run(device=dev)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_int7.main(out)
    for line in buf.getvalue().strip().splitlines():
        log(f"[table2] {line}")
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf := io.StringIO()):
        tiny = tinyml_repro.main(["--device", str(dev)])
    for line in buf.getvalue().strip().splitlines():
        log(f"[tinyml] {line}")
    log(f"[table2] bench_int7.run() {t1 - t0:.1f} s, tinyml_repro "
        f"{time.perf_counter() - t1:.1f} s on the card")
    cnn_training_vs_cpu(dev, counters)
    return {"table2": out["rows"], "tinyml": {
        k: v for k, v in tiny.items() if k != "speedups"}}


def examples_on_card(dev, counters) -> dict:
    """Phase 15 (d): ``quickstart`` (its step 3 raises if a kernel
    disagrees with its plain version), ``serve_lm`` and ``serve_stream``
    (its own asserts) on the card; the launches of all three."""
    import contextlib
    import io

    from repro_torch.examples import quickstart, serve_lm, serve_stream
    zero_counts(counters)
    for name, main_fn, argv in (("quickstart", quickstart.main, []),
                                ("serve_lm", serve_lm.main, []),
                                ("serve_stream", serve_stream.main, [])):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf := io.StringIO()):
            main_fn(argv + ["--device", str(dev)])
        text = buf.getvalue().strip().splitlines()
        if text[-1] != "ok":
            raise AssertionError(f"{name} did not end with ok: {text[-3:]}")
        for line in text:
            log(f"[{name}] {line}")
        log(f"[{name}] {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = launch_counts(counters)
    if not all(launches[k] for k in ("nm_spmm", "csa_matmul", "bsr_matmul",
                                     "lookahead_decode", "flash_attention",
                                     "paged_attention")):
        raise AssertionError(f"examples: a kernel did not launch: {launches}")
    log(f"[examples] launches {json.dumps(launches)}")
    return launches


def launchers_and_cnn(dev, counters) -> tuple:
    """Phase 15: (a) the serve launcher at full width and from a
    checkpoint, (b) the serving bench, (c) CNN training, (d) the
    examples.  Returns (launches on the main path, report)."""
    import tempfile
    total = {}
    report = {}

    def add(launches):
        for k in counted(launches):
            total[k] = total.get(k, 0) + launches[k]

    t0 = time.perf_counter()
    report["launcher"] = launcher_full_width(dev, counters)
    for rep in report["launcher"].values():
        add(rep["launches"])
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        launcher_checkpoint(dev, counters, Path(tmp))
    report["seconds_a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, _ = bench_serving_smoke(dev, counters)
    add(launches)
    report["seconds_b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["cnn"] = cnn_training(dev, counters)
    report["seconds_c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    add(examples_on_card(dev, counters))
    report["seconds_d"] = time.perf_counter() - t0
    log("[phase 15] seconds " + json.dumps(
        {k: round(v, 1) for k, v in report.items()
         if k.startswith("seconds")}))
    return total, report


# --- phase 16: the dry run, the autotune rows, roofline and perf trend ------

#: phase 4's serving geometry, the one phase 16 predicts and warms
PHASE4_SERVE = dict(slots=8, max_len=512, prompt_pad=128, page_size=16,
                    decode_chunk=16, eos_token=-1)
#: (a): the dry run's decode-chunk peak against the card's, at least
PEAK_FLOOR = 0.9
#: (b): depth of the serves under the cache and without it
AUTOTUNE_LAYERS = 4
#: (a): steps of the decode chunk the meta trace runs (each step is the
#: same work; a whole chunk of 16 took 22.2 s of host time at full width)
TRACE_STEPS = 2


def requested() -> int:
    """Bytes the live tensors on the card asked the allocator for (its
    ``allocated`` rounds each block up, and keeps a large block's
    remainder under 1 MiB unsplit)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def check_allocated(what: str, asked: int, allocated: int, want: int,
                    n: int) -> None:
    """The card's bytes for ``n`` tensors against the dry run's ``want``:
    the bytes they asked for equal to it, the allocator's blocks at least
    as large."""
    log(f"[dryrun] {what}: predicted {want} B; the card: {asked} B asked "
        f"for, {allocated} B allocated, {n} tensors")
    if asked != want or allocated < want:
        raise AssertionError(f"{what}: the dry run's {want} B is not what "
                             f"the card holds ({asked} B asked for)")


def dryrun_vs_card(cfg, dev) -> dict:
    """(a) ``cfg`` (full-width qwen3-0.6b, 2:4 MLPs) at phase 4's serve
    geometry: the dry run's param and cache bytes against what the built
    engine allocates, its decode-chunk peak against the card's peak for
    one eager chunk, and its step bound against phase 4's warm ms."""
    from repro_torch import models as MZ
    from repro_torch.launch.analysis import (count_step, memory_traffic,
                                             tensors_of)
    from repro_torch.launch.dryrun import HBM_BW, PEAK_FLOPS, tree_bytes
    from repro_torch.serving import (Engine, ServeConfig, init_decode_state,
                                     loops)
    scfg = ServeConfig(max_new_tokens=64, **PHASE4_SERVE)
    traced = dataclasses.replace(scfg, decode_chunk=TRACE_STEPS)
    t0 = time.perf_counter()
    params_m = MZ.abstract_model(cfg, packed=True)
    cache_m = MZ.abstract_cache(cfg, scfg.slots, scfg.max_len,
                                page_size=scfg.page_size,
                                num_pages=scfg.pool_pages)
    meta = functools.partial(torch.empty, device="meta")
    with torch.no_grad():
        count = count_step(
            loops.build_decode_loop(cfg, traced, paged=True), params_m,
            cache_m, init_decode_state(scfg.slots, "meta"),
            meta((scfg.slots,), dtype=torch.float32), None,
            meta((scfg.slots, scfg.max_pages), dtype=torch.int32))
    want_p, want_c = tree_bytes(params_m), tree_bytes(cache_m)
    log(f"[dryrun] {cfg.name} decode chunk, {TRACE_STEPS} of its "
        f"{scfg.decode_chunk} steps on meta in "
        f"{time.perf_counter() - t0:.1f} s: {count.flops:.4g} "
        f"FLOPs, peak {count.peak_live_bytes} B ({count.temp_bytes} B past "
        f"the inputs), kernels {json.dumps(count.kernel_calls)}")
    # one layer first: whatever the build allocates once per process (a
    # library's workspace) is then part of the baseline
    del params_m, cache_m
    sparse_model(cut_depth(cfg, 1), dev, SEED)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, base_req = torch.cuda.memory_allocated(), requested()
    params = sparse_model(cfg, dev, SEED)
    torch.cuda.synchronize()
    after_p, after_req = torch.cuda.memory_allocated(), requested()
    if tree_bytes(params) != want_p:
        raise AssertionError(f"params: {tree_bytes(params)} B built, "
                             f"{want_p} B predicted")
    check_allocated("params", after_req - base_req, after_p - base, want_p,
                    len(tensors_of(params)))
    eng = Engine(cfg, scfg, params, device=dev)
    eng._backend._graphs = False        # the eager chunk the dry run ran
    eng._ensure_device_state()
    torch.cuda.synchronize()
    bufs = [eng._bufs.state, eng._bufs.temps, eng._bufs.tokens,
            eng._bufs.emitted, eng._bufs.tally, eng._bufs.ptab]
    if tree_bytes(eng._cache) != want_c:
        raise AssertionError(f"cache: {tree_bytes(eng._cache)} B built, "
                             f"{want_c} B predicted")
    check_allocated("cache and chunk buffers", requested() - after_req,
                    torch.cuda.memory_allocated() - after_p,
                    want_c + tree_bytes(bufs),
                    len(tensors_of(eng._cache)) + len(tensors_of(bufs)))
    for p in phase4_prompts(cfg.vocab_size, scfg.slots):
        eng.submit(p)
    eng.step()                          # admits every slot, one chunk
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng.step()                          # one chunk, nothing admitted
    torch.cuda.synchronize()
    card = torch.cuda.max_memory_allocated() - base
    card_req = torch.cuda.memory_stats()["requested_bytes.all.peak"] \
        - base_req
    log(f"[dryrun] decode chunk peak: predicted {count.peak_live_bytes} B; "
        f"the card {card} B allocated ({card_req} B asked for) above what "
        f"it held before the params: {count.peak_live_bytes / card:.4f} "
        f"of the allocated peak")
    if count.peak_live_bytes < PEAK_FLOOR * card:
        raise AssertionError(f"the dry run's decode-chunk peak is under "
                             f"{PEAK_FLOOR} of the card's")
    eng.run()
    per_step = count.flops / TRACE_STEPS / PEAK_FLOPS
    traffic = memory_traffic(want_p, count.temp_bytes // TRACE_STEPS, want_c)
    bound_ms = max(per_step, traffic / HBM_BW) * 1e3
    warm = WARM_MS_PER_STEP.get("nm")
    log(f"[dryrun] finding: predicted decode step bound {bound_ms:.4f} ms "
        f"({'compute' if per_step * 1e3 >= bound_ms else 'memory'}: "
        f"{count.flops / TRACE_STEPS:.4g} FLOPs, {traffic} B); "
        f"phase 4's warm graph step "
        + (f"{warm:.4f} ms, {warm / bound_ms:.2f}x the bound" if warm
           else "not measured in this run"))
    del eng, params
    torch.cuda.empty_cache()
    return {"param_bytes": want_p, "cache_bytes": want_c,
            "chunk_peak_bytes": count.peak_live_bytes,
            "card_chunk_peak_bytes": card, "step_bound_ms": bound_ms,
            "warm_ms_per_step": warm}


def check_cached_plans(models, paged, dev) -> float:
    """Each cached plan of (b)'s keys launched on fresh inputs against the
    plain version; returns the largest abs error."""
    from repro_torch.benchmarks import warm_autotune as W
    from repro_torch.kernels import autotune, dispatch, ref
    from repro_torch.kernels.paged_attention import PagedKV
    from repro_torch.kernels.paged_attention import paged_attention as pa
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    err = 0.0
    for fmt, (_, params) in models.items():
        for pack in W.layer_packs(params):
            for M in W.serving_ms(PHASE4_SERVE["slots"],
                                  PHASE4_SERVE["prompt_pad"], wave=True):
                d = dispatch.select(pack, M=M, device=dev)
                if d.reason != "cached":
                    raise AssertionError(f"{d.key}: no cached row")
                x = torch.randn((M, pack.K), generator=gen, device=dev
                                ).to(torch.bfloat16)
                mod = dispatch.registry()[d.kernel].module
                got = getattr(mod, d.kernel)(x, pack, use_plan=d.plan)
                err = max(err, check_close(f"{d.key} cached plan", got,
                                           dispatch.registry()[d.kernel]
                                           .run(x, pack, "ref")))
    for g in paged:
        for view in g["views"]:
            P = PHASE4_SERVE["slots"] * view + 1
            pools = [torch.randn((P, g["page_size"], g["Hk"], g["D"]),
                                 generator=gen, device=dev
                                 ).to(torch.bfloat16) for _ in range(2)]
            ptab = torch.randperm(P - 1, generator=gen, device=dev
                                  ).add(1).to(torch.int32).reshape(-1, view)
            for Q in [1] + [k + 1 for k in W.SPEC_KS]:
                lens = torch.randint(Q, view * g["page_size"] + 1,
                                     (PHASE4_SERVE["slots"],), generator=gen,
                                     device=dev, dtype=torch.int32)
                shape = (PHASE4_SERVE["slots"], g["H"], g["D"]) if Q == 1 \
                    else (PHASE4_SERVE["slots"], Q, g["H"], g["D"])
                q = torch.randn(shape, generator=gen, device=dev
                                ).to(torch.bfloat16)
                key = dispatch.paged_key(PHASE4_SERVE["slots"], g["H"],
                                         g["Hk"], Q, view, g["D"],
                                         (torch.bfloat16,) * 2,
                                         g["page_size"], g["window"])
                entry = dispatch.autotune_cache().get(key)
                if entry is None:
                    raise AssertionError(f"{key}: no cached row")
                got = pa(q, *pools, ptab, lens,
                         use_plan=autotune.plan_of(entry))
                err = max(err, check_close(
                    f"{key} cached plan", got, ref.paged_attention_ref(
                        q, *pools, ptab, lens)))
    return err


def autotune_rows(cfg, dev, counters) -> dict:
    """(b) ``warm_autotune`` on qwen3-0.6b's nm and combined MLP keys and
    its paged geometry at phase 4's serve geometry (one layer of each
    format holds every distinct key); every row written with no skipped
    candidate, each cached plan against the plain version, then a serve
    at ``AUTOTUNE_LAYERS`` layers under the cache against the same serve
    under an empty one (the tiling rule): the cached plans must be what
    ran, and the tokens equal or split only at a near tie."""
    from repro_torch.benchmarks import warm_autotune as W
    from repro_torch.configs import qwen3_0_6b
    from repro_torch.kernels import autotune, dispatch
    from repro_torch.serving import Engine, ServeConfig
    scfg = ServeConfig(max_new_tokens=64, **PHASE4_SERVE)
    models = {"nm": (cut_depth(cfg, 1), None),
              "combined": (with_format(cut_depth(qwen3_0_6b.config(), 1),
                                       "combined"), None)}
    models = {fmt: (c, sparse_model(c, dev, SEED,
                                    zero_tiles=fmt == "combined"))
              for fmt, (c, _) in models.items()}
    paged = [dict(H=cfg.n_heads, Hk=cfg.n_kv_heads, D=cfg.head_dim,
                  page_size=scfg.page_size, views=W.paged_views(scfg),
                  window=None)]
    t0 = time.perf_counter()
    out = W.run(slots=scfg.slots, prompt_pad=scfg.prompt_pad, reps=5,
                device=dev, models=models, paged=paged)
    sweep_s = time.perf_counter() - t0
    cache = dispatch.autotune_cache()
    bad = [e["key"] for e in out["entries"]
           if e["skipped"] or cache.get(e["key"]) is None]
    if bad:
        raise AssertionError(f"rows skipped candidates or are missing: {bad}")
    moved = sum(e["us"] < e["rule_us"] for e in out["entries"])
    for e in out["entries"]:
        log(f"[autotune] {e['key']}: {json.dumps(e['plan'])} "
            f"{e['us']:.3f} us (rule {e['rule_us']:.3f} us)")
    log(f"[autotune] {len(out['entries'])} rows in {sweep_s:.1f} s, none "
        f"skipped; {moved} beat the tiling rule's plan")
    err = check_cached_plans(models, paged, dev)
    log(f"[autotune] every cached plan against the plain version: max abs "
        f"err {err:.3e} (rtol {RTOL}, atol {ATOL})")
    del models

    small = cut_depth(cfg, AUTOTUNE_LAYERS)
    params = sparse_model(small, dev, SEED)
    prompts = phase4_prompts(small.vocab_size)
    warm_cache = dispatch.set_autotune_cache(dispatch.AutotuneCache(
        str(Path(cache.path).with_suffix(".empty.json"))))
    try:
        rule, rule_rep, _ = serve_prompts(Engine(small, scfg, params,
                                                 device=dev), prompts,
                                          counters)
    finally:
        dispatch.set_autotune_cache(warm_cache)
    autotune.hits.clear()
    outs, rep, launches = serve_prompts(Engine(small, scfg, params,
                                               device=dev), prompts, counters)
    hit = dict(autotune.hits)
    decode_keys = {e["key"] for e in out["entries"]
                   if e["format"] == "nm" and "|M8|" in e["key"]} | {
        e["key"] for e in out["entries"]
        if e["format"] == "paged" and "Q1w" in e["key"]}
    if not hit or not set(hit) <= set(cache.keys()) or \
            not decode_keys & set(hit):
        raise AssertionError(f"the serve did not run the cached plans: "
                             f"{hit}")
    missed = sorted(k for k in decode_keys
                    if k not in hit and k.startswith("nm_spmm|"))
    if missed:
        raise AssertionError(f"decode keys the serve did not hit: {missed}")
    log(f"[autotune] the serve under the cache ran {len(hit)} cached keys "
        f"({sum(hit.values())} launches resolved in Python, the replays "
        f"repeat them): {json.dumps(hit)}")
    log(f"[autotune] serve {AUTOTUNE_LAYERS} layers: tiling rule "
        f"{rule_rep['tok_per_s']:.1f} tok/s, cached plans "
        f"{rep['tok_per_s']:.1f} tok/s (one serve each, not a gain claim)")
    far = []
    for i, (p, a, b) in enumerate(zip(prompts, outs, rule)):
        split = first_split(a, b)
        if split is None:
            continue
        with torch.no_grad():
            _, gaps, tops = greedy(params, small, p, len(b),
                                   scfg.prompt_pad, scfg.max_len,
                                   device=dev, forced=b)
        tie = near_tie(gaps[split], tops[split], torch.bfloat16)
        log(f"[autotune] request {i}: first split at {split}, top-2 gap "
            f"{gaps[split]:.3e} at top logit {tops[split]:.4f}: "
            f"{'a near tie' if tie else 'NOT a tie'}")
        if not tie:
            far.append(i)
    same = sum(first_split(a, b) is None for a, b in zip(outs, rule))
    log(f"[autotune] {same}/{len(outs)} requests token-equal to the tiling "
        "rule's serve")
    if far:
        raise AssertionError(f"requests {far} split from the rule's serve "
                             "away from a near tie")
    return launches


def roofline_and_trend(dev) -> None:
    """(c) the dry run's cells of qwen3-0.6b through ``roofline``, and
    ``perf_trend`` between two ``run.py --json`` records of the kernels
    section (at its smoke shape)."""
    from repro_torch.benchmarks import bench_kernels, perf_trend, roofline
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.launch import dryrun
    out = ROOT / "build" / "chip_smoke"
    for cell in ("prefill_32k", "decode_32k"):
        rec = dryrun.run_cell("qwen3-0.6b", cell)
        path = Path(dryrun._out_path(str(out / "dryrun"), rec["arch"], cell))
        path.write_text(json.dumps(rec, indent=1))
    data = roofline.run(str(out / "dryrun"))
    roofline.main(data)
    if len(data["rows"]) != 2:
        raise AssertionError(f"roofline read {len(data['rows'])} records")
    records = [out / f"BENCH_{i}.json" for i in (0, 1)]
    shape = bench_kernels.SHAPE
    bench_kernels.SHAPE = bench_kernels.SMOKE_SHAPE
    try:
        for path in records:
            if bench_run.main(["--sections", "kernels", "--device", "cuda",
                               "--json", str(path)]):
                raise AssertionError(f"run.py --json {path} failed")
    finally:
        bench_kernels.SHAPE = shape
    rc = perf_trend.main(["--baseline", str(records[0]), "--current",
                          str(records[1])])
    rows = json.loads(records[1].read_text())["sections"]["kernels"][
        "data"]["rows"]
    lines, _ = perf_trend.compare(*(json.loads(r.read_text())
                                    for r in records), 0.30)
    if rc not in (0, 1) or len(lines) != len(rows):
        raise AssertionError(f"perf_trend: exit {rc}, {len(lines)} lines "
                             f"for {len(rows)} rows")
    log(f"[trend] perf_trend over two kernels records: exit {rc} (1 only "
        "when a row moved past 30%), one line per row")


def dryrun_and_autotune(dev, counters) -> tuple:
    """Phase 16: (a) ``dryrun_vs_card``, (b) ``autotune_rows``, (c)
    ``roofline_and_trend``."""
    from repro_torch.configs import qwen3_0_6b
    cfg = qwen3_0_6b.sparse()
    t0 = time.perf_counter()
    found = dryrun_vs_card(cfg, dev)
    log(f"[phase 16] (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = autotune_rows(cfg, dev, counters)
    log(f"[phase 16] (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    roofline_and_trend(dev)
    log(f"[phase 16] (c) {time.perf_counter() - t0:.1f} s")
    return launches, found


# --- phase 17: faults and chaos ---------------------------------------------

#: phase 17's depth: qwen3-0.6b ``sparse()`` at published widths, the
#: first 4 of its 28 layers (as phase 16's serves)
FAULT_LAYERS = 4
#: phase 17's serve: paged, bucketed, prefix-shared, graphs on, 8 slots
FAULT_SERVE = dict(slots=8, max_len=512, prompt_pad=128, page_size=16,
                   prompt_buckets=16, prefix_cache=True, decode_chunk=8,
                   eos_token=-1)
#: (a): 8 low-priority requests of 64 tokens (the last one short, so its
#: slot frees before the pool has room), then 2 arrivals of 128 tokens at
#: priority 5 that its pages do not cover
LO_LEN, LO_NEW, LO_SHORT_NEW = 64, 48, 8
HI_LEN, HI_NEW, HI_PRIORITY = 128, 32, 5
#: (b), (d): the chaos run: 24 requests of 16-128 tokens at priorities 0,
#: 1 and 5, no deadlines, over a pool that holds about half of them
CHAOS_SEED, CHAOS_RATE = 7, 0.05
CHAOS_REQUESTS, CHAOS_NEW, CHAOS_CHUNK, CHAOS_POOL = 24, 24, 2, 64
CHAOS_SITES = ("kernel", "drop", "delay", "nan", "pressure")
#: (c): the clean chunks a degraded engine runs before its kernels return
RECOVER_CHUNKS = 3
#: the fault layer's counters, printed per run
FAULT_COUNTERS = ("timeouts", "rejections", "preemptions", "numeric_faults",
                  "kernel_failures", "fetch_errors", "degraded",
                  "degraded_recoveries", "prefills", "prefix_hits",
                  "shared_pages", "admission_waits", "sync_count")


def fault_config():
    from repro_torch.configs import qwen3_0_6b
    return cut_depth(qwen3_0_6b.sparse(), FAULT_LAYERS)


def fault_engine(cfg, params, dev, **kw):
    from repro_torch.serving import Engine, ServeConfig
    return Engine(cfg, ServeConfig(**{**FAULT_SERVE, **kw}), params,
                  device=dev)


def fault_counters(st) -> dict:
    return {k: getattr(st, k) for k in FAULT_COUNTERS}


def drive(eng, handles, tag: str, limit: int) -> int:
    """Step ``eng`` until every handle is terminal, auditing the engine
    after every step; returns the ticks."""
    from repro_torch.serving import audit_engine
    ticks = 0
    while not all(h.done for h in handles):
        if ticks >= limit:
            raise AssertionError(f"{tag}: not terminal after {limit} ticks: "
                                 f"{[h.status.value for h in handles]}")
        eng.step()
        audit_engine(eng)
        ticks += 1
    return ticks


def split_at_tie(tag: str, params, cfg, dev, prompt, rows: int, got, want,
                 tol_dtype) -> bool:
    """``got`` equals ``want`` or splits first at a near tie of ``want``
    (read by replaying ``want`` one sequence at a time on ``dev`` at the
    engine's padded width ``rows``; ``near_tie`` in ``tol_dtype``).
    Returns whether they are equal; raises on a split away from a tie."""
    split = first_split(got, want)
    if split is None and len(got) == len(want):
        return True
    if split is None:
        raise AssertionError(f"{tag}: {len(got)} tokens against "
                             f"{len(want)}")
    _, gaps, tops = greedy(params, cfg, prompt, len(want), rows, 512,
                           device=dev, forced=want)
    tie = near_tie(gaps[split], tops[split], tol_dtype)
    log(f"[{tag}] first split at {split}, top-2 gap there "
        f"{gaps[split]:.3e} at top logit {tops[split]:.4f}: "
        f"{'a near tie' if tie else 'NOT a tie'}")
    if not tie:
        raise AssertionError(f"{tag}: split away from a near tie")
    return False


def preempt_stream(vocab: int) -> tuple:
    """(a)'s prompts and budgets: (low, their budgets, high)."""
    rng = np.random.default_rng(SEED + 17)
    lo = [rng.integers(1, vocab, size=LO_LEN).astype(np.int32)
          for _ in range(8)]
    hi = [rng.integers(1, vocab, size=HI_LEN).astype(np.int32)
          for _ in range(2)]
    return lo, [LO_NEW] * 7 + [LO_SHORT_NEW], hi


def preempt_pool(scfg, budgets) -> int:
    """The pool sized to the 8 low-priority requests: what their
    admission takes, each its reservation and its published prompt
    pages (the admission check counts both)."""
    rows = scfg.prompt_rows(LO_LEN)
    return sum(scfg.rows_pages(rows, n) + rows // scfg.page_size
               for n in budgets)


def preempt_serve(eng, lo, budgets, hi) -> tuple:
    """Serve (a)'s stream on ``eng``: the low-priority requests, one
    tick, then the high-priority ones.  Returns (handles, ticks, the
    length of ``chunk_runs`` before the tick of the first resumption, or
    ``None``)."""
    from repro_torch.serving import RequestStatus
    eng.reset_stats()
    los = [eng.submit(p, max_new=n) for p, n in zip(lo, budgets)]
    eng.step()
    eng.audit()
    his = [eng.submit(p, max_new=HI_NEW, priority=HI_PRIORITY) for p in hi]
    handles = los + his
    resumed_at, ticks = None, 1
    while not all(h.done for h in handles):
        if ticks > 200:
            raise AssertionError("(a): the serve does not drain")
        before = len(eng.stats().chunk_runs)
        eng.step()
        eng.audit()
        ticks += 1
        if resumed_at is None and any(
                h._req.history.count(RequestStatus.RUNNING) > 1
                for h in los):
            resumed_at = before
    return handles, ticks, resumed_at


def preemption(cfg, params, dev) -> dict:
    """(a): priority preemption at full width.  The pool holds the 8
    low-priority requests; when the short one finishes, its slot frees
    but not pages enough for a 128-token arrival at priority 5, so the
    youngest low-priority slot is preempted, its prompt pages kept warm.
    Gates: preemptions >= 1, every victim resumes and finishes with its
    budget, each re-admission a prefix hit; every request's tokens equal
    an uninterrupted serve's (a pool of the full capacity) or split at a
    near tie; the resumed decode captures no graph of a key that had not
    run before; the audit is clean after every tick."""
    from repro_torch.serving import ServeConfig
    lo, budgets, hi = preempt_stream(cfg.vocab_size)
    pool = preempt_pool(ServeConfig(**FAULT_SERVE), budgets)
    eng = fault_engine(cfg, params, dev, num_pages=pool)
    handles, ticks, resumed_at = preempt_serve(eng, lo, budgets, hi)
    torch.cuda.synchronize()
    st = eng.stats()
    victims = [i for i, h in enumerate(handles[:8]) if h._req.preempts]
    base_eng = fault_engine(cfg, params, dev)
    base, _, _ = preempt_serve(base_eng, lo, budgets, hi)
    rows = [eng.scfg.prompt_rows(len(p)) for p in lo + hi]
    equal = sum(split_at_tie(f"faults a: request {i}", params, cfg, dev, p,
                             r, h.tokens, b.tokens, params["embed"].dtype)
                for i, (p, r, h, b) in enumerate(zip(lo + hi, rows, handles,
                                                     base)))
    runs = st.chunk_runs
    seen = {key for key, _ in runs[:resumed_at or 0]}
    late = [key for key, how in runs[resumed_at or 0:]
            if how == "capture" and key not in seen]
    after = [how for _, how in runs[resumed_at or 0:]]
    log(f"[faults a] pool {pool} pages; {ticks} ticks; preemptions "
        f"{st.preemptions}, victims {victims} (histories "
        f"{[[s.value for s in handles[i]._req.history] for i in victims]}"
        f"); prefix hits {st.prefix_hits}, shared pages {st.shared_pages}, "
        f"admission waits {st.admission_waits}; {equal}/10 requests "
        f"token-equal to the uninterrupted serve; chunks from the first "
        f"resumption on: {after.count('replay')} replays, "
        f"{after.count('capture')} captures, {after.count('eager')} eager")
    if st.preemptions < 1 or not victims or resumed_at is None:
        raise AssertionError(f"(a): no preemption and resumption "
                             f"({st.preemptions} preemptions)")
    for i, h in enumerate(handles):
        want = (budgets + [HI_NEW] * 2)[i]
        if h.status.value != "done" or len(h.tokens) != want:
            raise AssertionError(f"(a): request {i} ended {h.status.value} "
                                 f"with {len(h.tokens)} of {want} tokens")
    if st.prefix_hits != sum(handles[i]._req.preempts for i in victims):
        raise AssertionError(f"(a): {st.prefix_hits} prefix hits for "
                             f"{len(victims)} resumed victims")
    if late:
        raise AssertionError(f"(a): the resumed decode captured new keys "
                             f"{late}")
    healthy("faults a", st)
    return fault_counters(st)


def chaos_stream(vocab: int) -> tuple:
    """(b)'s 24 prompts of 16-128 tokens and their priorities."""
    rng = np.random.default_rng(SEED + 71)
    prompts = [rng.integers(1, vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 129, size=CHAOS_REQUESTS)]
    return prompts, [(0, 1, 5)[i % 3] for i in range(CHAOS_REQUESTS)]


def chaos_serve(cfg, params, dev, prompts, prios) -> dict:
    """One chaos run on a fresh engine: ``ChaosConfig(seed=CHAOS_SEED,
    rate=CHAOS_RATE)`` attached, the monkey auditing after every step;
    ``step()`` must never raise and every request must end terminal."""
    from repro_torch.serving import ChaosConfig, ChaosMonkey
    eng = fault_engine(cfg, params, dev, decode_chunk=CHAOS_CHUNK,
                       num_pages=CHAOS_POOL)
    mk = ChaosMonkey(eng, ChaosConfig(seed=CHAOS_SEED,
                                      rate=CHAOS_RATE)).attach()
    handles = [eng.submit(p, max_new=CHAOS_NEW, priority=q)
               for p, q in zip(prompts, prios)]
    ticks = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while not all(h.done for h in handles):
            if ticks > 40 * len(prompts):
                raise AssertionError("(b): the chaos serve does not drain")
            eng.step()
            ticks += 1
    mk.detach()
    return {"schedule": list(mk.schedule),
            "status": [h.status.value for h in handles],
            "tokens": [h.tokens for h in handles],
            "rows": [h._req.rows0 for h in handles], "ticks": ticks,
            "stats": fault_counters(eng.stats())}


def chaos_run(cfg, params, dev, prompts, prios) -> dict:
    """(b): the chaos run twice, each on a fresh engine.  Gates: every
    request terminal; each of ``CHAOS_SITES`` fired; the second run's
    schedule, statuses and tokens equal the first's bit for bit."""
    a = chaos_serve(cfg, params, dev, prompts, prios)
    b = chaos_serve(cfg, params, dev, prompts, prios)
    fired = {site: sum(s == site for _, s, _ in a["schedule"])
             for site in CHAOS_SITES}
    statuses = {s: a["status"].count(s) for s in sorted(set(a["status"]))}
    log(f"[faults b] seed {CHAOS_SEED} rate {CHAOS_RATE}: {a['ticks']} "
        f"ticks, sites fired {fired}, statuses {statuses}, counters "
        f"{json.dumps(a['stats'])}")
    if any(s not in ("done", "failed") for s in a["status"]):
        raise AssertionError(f"(b): a request is not terminal: {statuses}")
    missing = [site for site, n in fired.items() if not n]
    if missing:
        raise AssertionError(f"(b): sites that never fired: {missing}")
    for key in ("schedule", "status", "tokens", "ticks"):
        if a[key] != b[key]:
            raise AssertionError(f"(b): a second engine at seed "
                                 f"{CHAOS_SEED} gave another {key}")
    return a


def fault_serve(eng, prompts, counters, monkey=None) -> tuple:
    """Serve ``prompts`` on ``eng`` (counts set to 0 just before, read
    just after): (tokens, launches, stats)."""
    eng.reset_stats()
    zero_counts(counters)
    handles = [eng.submit(p) for p in prompts]
    drive(eng, handles, "faults c", 100)
    torch.cuda.synchronize()
    return ([h.tokens for h in handles], launch_counts(counters),
            eng.stats())


def degraded_mode(cfg, params, dev, counters) -> dict:
    """(c): degraded mode.  One engine serves 8 prompts cold and warm
    (every key captured), then with a monkey at rate 0 (the warm serve's
    tokens and launches exactly), then with one kernel fault on the
    first chunk: it is retried on the plain versions and the engine
    stays degraded for ``RECOVER_CHUNKS`` clean chunks.  Gates: while
    degraded no kernel launches, the plain launches are counted and the
    chunks run as ``plain``; after recovery the kernels launch again and
    each chunk replays its key's graph, with no new capture; tokens equal
    the warm serve's or split at a near tie.  Returns the warm serve's
    launches."""
    from repro_torch.serving import ChaosConfig, ChaosMonkey
    prompts = phase4_prompts(cfg.vocab_size, requests=8)
    eng = fault_engine(cfg, params, dev, decode_chunk=4, max_new_tokens=32,
                       degraded_recover_chunks=RECOVER_CHUNKS)
    fault_serve(eng, prompts, counters)
    warm, warm_launches, warm_st = fault_serve(eng, prompts, counters)
    healthy("faults c warm", warm_st)
    mk = ChaosMonkey(eng, ChaosConfig(seed=0, rate=0.0)).attach()
    zero, zero_launches, _ = fault_serve(eng, prompts, counters)
    mk.detach()
    if (zero, zero_launches) != (warm, warm_launches):
        raise AssertionError("(c): a monkey at rate 0 changed the serve")

    eng.reset_stats()
    zero_counts(counters)
    handles = [eng.submit(p) for p in prompts]
    mk = ChaosMonkey(eng, ChaosConfig(seed=0, rate=0.0,
                                      kernel_rate=1.0)).attach()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        eng.step()          # prefills on the kernels; the chunk raises
        mk.detach()
        eng.audit()
        if not eng.degraded or eng.stats().chunk_runs[-1][1] != "plain":
            raise AssertionError("(c): the kernel fault did not degrade "
                                 "the engine onto the plain versions")
        plain_chunks, kernel_chunks = 0, []
        while not all(h.done for h in handles):
            was = eng.degraded
            before = launch_counts(counters, plain_ok=True)
            eng.step()
            eng.audit()
            after = launch_counts(counters, plain_ok=True)
            moved = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
            how = eng.stats().chunk_runs[-1][1]
            kernels = sum(n for k, n in moved.items() if " " not in k)
            plain = sum(n for k, n in moved.items() if k.endswith(" plain"))
            if was and (how != "plain" or kernels or not plain):
                raise AssertionError(f"(c): a degraded chunk ran {how} "
                                     f"with launches {moved}")
            if not was and (how != "replay" or plain or not kernels):
                raise AssertionError(f"(c): a recovered chunk ran {how} "
                                     f"with launches {moved}")
            plain_chunks += was
            if not was:
                kernel_chunks.append(moved)
    torch.cuda.synchronize()
    st = eng.stats()
    equal = sum(split_at_tie(f"faults c: request {i}", params, cfg, dev, p,
                             eng.scfg.prompt_rows(len(p)), h.tokens, w,
                             params["embed"].dtype)
                for i, (p, h, w) in enumerate(zip(prompts, handles, warm)))
    plain = {k: n for k, n in launch_counts(counters, True).items()
             if k.endswith(" plain") and n}
    log(f"[faults c] kernel failures {st.kernel_failures}, plain chunks "
        f"{plain_chunks + 1} (the retried one included), recoveries "
        f"{st.degraded_recoveries}, replayed chunks after it "
        f"{len(kernel_chunks)}, captures {len(st.graph_captures)}; plain "
        f"launches {plain}; {equal}/{len(prompts)} requests token-equal "
        "to the warm serve")
    if st.kernel_failures != 1 or st.degraded_recoveries != 1 or \
            plain_chunks < RECOVER_CHUNKS or not kernel_chunks or \
            st.graph_captures:
        raise AssertionError(f"(c): {st.kernel_failures} kernel failures, "
                             f"{st.degraded_recoveries} recoveries, "
                             f"{plain_chunks} plain and {len(kernel_chunks)} "
                             f"kernel chunks, {len(st.graph_captures)} "
                             "captures")
    if any(h.status.value != "done" for h in handles):
        raise AssertionError("(c): a request did not finish")
    return warm_launches


#: the flag of this script's own CPU-reference mode (phase 17 (d))
CPU_REFERENCE = "--faults-cpu-reference"


def chaos_small(cfg):
    """(d)'s model: ``cfg`` at 2 layers in fp32."""
    return dataclasses.replace(cfg, n_layers=2, layer_kinds=(),
                               dtype="float32")


def chaos_cpu_reference(out: str) -> int:
    """This script's CPU-reference mode: (b)'s chaos run on (d)'s model
    on the port's CPU path, its result written to ``out`` as JSON.  The
    weights are made on the CPU from the seed, as phase 17 makes the
    card's copy, so both sides hold the same values."""
    sys.path.insert(0, str(ROOT / "src"))
    cpu = torch.device("cpu")
    small = chaos_small(fault_config())
    params = sparse_model(small, cpu, SEED + 17)
    prompts, prios = chaos_stream(small.vocab_size)
    got = chaos_serve(small, params, cpu, prompts, prios)
    got["schedule"] = [list(e) for e in got["schedule"]]
    Path(out).write_text(json.dumps(got))
    return 0


def start_cpu_reference(flag: str = CPU_REFERENCE,
                        name: str = "faults_cpu.json") -> tuple:
    """Start a phase's CPU side (this script with ``flag``: phase 17
    (d)'s by default) in a process of its own, so that it runs while the
    card serves the phase's other parts: (process, its output file)."""
    out = ROOT / "build" / "chip_smoke" / name
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             flag, str(out)], cwd=str(ROOT))
    CHILDREN.append(proc)
    return proc, out


#: every process :func:`start_cpu_reference` started: the script stops
#: those still running when it exits
CHILDREN: list = []


def stop_children() -> None:
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def chaos_vs_cpu(cfg, dev, prompts, prios, proc, out: Path) -> None:
    """(d): (b)'s chaos run at 2 layers in fp32 on the card, against the
    same run on the port's CPU path (``chaos_cpu_reference``, started at
    the phase's beginning).  Gates: the same schedule, statuses and
    ticks; tokens equal or split first where the CPU's top-2 gap is
    under ``GAP_TOL`` (phase 5's rule)."""
    small = chaos_small(cfg)
    cpu_params = sparse_model(small, torch.device("cpu"), SEED + 17)
    card = chaos_serve(small, _to(cpu_params, dev), dev, prompts, prios)
    card["schedule"] = [list(e) for e in card["schedule"]]
    t0 = time.perf_counter()
    if proc.wait(timeout=600):
        raise AssertionError(f"(d): the CPU reference exited "
                             f"{proc.returncode}")
    log(f"[faults d] waited {time.perf_counter() - t0:.1f} s for the CPU "
        "reference")
    cpu = json.loads(out.read_text())
    equal = 0
    for i, (p, r, a, b) in enumerate(zip(prompts, cpu["rows"], card["tokens"],
                                         cpu["tokens"])):
        split = first_split(a, b)
        if split is None and len(a) == len(b):
            equal += 1
            continue
        if split is None:
            raise AssertionError(f"(d): request {i}: {len(a)} tokens on the "
                                 f"card, {len(b)} on the CPU")
        _, gaps, _ = greedy(cpu_params, small, p, len(b), r, 512, forced=b)
        log(f"[faults d] request {i}: first split at {split}, CPU top-2 gap "
            f"there {gaps[split]:.3e}")
        if gaps[split] >= GAP_TOL:
            raise AssertionError(f"(d): request {i} split from the CPU away "
                                 "from a near tie")
    log(f"[faults d] 2 layers fp32: {len(card['schedule'])} faults in "
        f"{card['ticks']} ticks on both; {equal}/{len(prompts)} requests "
        f"token-equal to the CPU path; card counters "
        f"{json.dumps(card['stats'])}")
    for key in ("schedule", "status", "ticks"):
        if card[key] != cpu[key]:
            raise AssertionError(f"(d): the card's {key} differs from the "
                                 "CPU path's")


def faults_and_chaos(dev, counters) -> tuple:
    """Phase 17: (a) ``preemption``, (b) ``chaos_run``, (c)
    ``degraded_mode``, (d) ``chaos_vs_cpu``.  Returns (c)'s warm launches
    and the counters of (a) and (b)."""
    proc, out = start_cpu_reference()
    try:
        cfg = fault_config()
        params = sparse_model(cfg, dev, SEED + 17)
        prompts, prios = chaos_stream(cfg.vocab_size)
        found = {}
        t0 = time.perf_counter()
        found["preemption"] = preemption(cfg, params, dev)
        log(f"[phase 17] (a) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        found["chaos"] = chaos_run(cfg, params, dev, prompts, prios)["stats"]
        log(f"[phase 17] (b) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches = degraded_mode(cfg, params, dev, counters)
        log(f"[phase 17] (c) {time.perf_counter() - t0:.1f} s")
        del params
        t0 = time.perf_counter()
        chaos_vs_cpu(cfg, dev, prompts, prios, proc, out)
        log(f"[phase 17] (d) {time.perf_counter() - t0:.1f} s")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return launches, found


# --- phase 18: the journal and the supervisor ------------------------------

#: (a): qwen3-0.6b ``sparse()`` at full width and depth on phase 17's serve
#: geometry, phase 4's 16 requests of 16-128 tokens with 32 new tokens
#: each, a pinned 64-row head (4 pages); the crash lands on monkey tick
#: ``CRASH_AT``, in the first wave's decode, with 8 requests queued
JOURNAL_NEW, HEAD_PAGES, CRASH_AT, SNAPSHOT_EVERY = 32, 4, 3, 4
#: (b): the hang on ``fault_config()``: the device wedges at monkey tick
#: ``HANG_AT``; the watchdog is ``HANG_MARGIN`` times the slowest steady
#: step of a cold journaled serve, and every later fetch stalls
#: ``STALL_MARGIN`` times the watchdog
HANG_AT, HANG_MARGIN, STALL_MARGIN = 3, 8.0, 4.0
#: (c): 2 layers in fp32, 8 requests of 16 new tokens (two chunks), the
#: crash at tick 1
EXACT_REQUESTS, EXACT_NEW, EXACT_CRASH = 8, 16, 1
#: the flag of this script's own CPU-reference mode (phase 18 (c))
EXACT_REFERENCE = "--journal-cpu-reference"


def journal_dir(name: str) -> Path:
    """A fresh directory for phase 18's journals and snapshots, inside the
    checkout (``build/`` is ignored by git)."""
    d = ROOT / "build" / "chip_smoke" / "phase18" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def head_tokens(vocab: int, rows: int) -> np.ndarray:
    return np.random.default_rng(SEED + 18).integers(
        1, vocab, size=rows).astype(np.int32)


def journal_serve(eng, prompts, head) -> tuple:
    """Register ``head``, serve ``prompts`` (``JOURNAL_NEW`` tokens each)
    on ``eng`` to the end, auditing after every step: (handles, the
    decode-loop seconds, the prefix handle).  ``eng`` is an Engine or a
    Supervisor."""
    ph = eng.register_prefix(head)
    handles = [eng.submit(p, max_new=JOURNAL_NEW) for p in prompts]
    t0 = time.perf_counter()
    ticks = 0
    while not all(h.done for h in handles):
        if ticks > 400:
            raise AssertionError("phase 18: the serve does not drain")
        eng.step()
        eng.audit()
        ticks += 1
    torch.cuda.synchronize()
    return handles, time.perf_counter() - t0, ph


def engine_allocated() -> int:
    """``memory_allocated()`` with cuBLAS's per-stream workspaces released
    first: each engine's capture stream keeps one (32 MiB on an H100) for
    the life of the process, which is not the engine's memory.  Call it
    only when no captured graph will replay again (a graph holds its
    workspace's address)."""
    import gc
    gc.collect()                    # what earlier work left in cycles
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def tokens_of(handles) -> int:
    return sum(len(h.tokens) for h in handles)


def check_streams(tag: str, handles, events) -> None:
    """Each handle's streamed events, joined, are its final tokens: the
    indices run 0..n-1, each exactly once, no token duplicated or
    dropped."""
    for h in handles:
        evs = [e for e in events if e.uid == h.uid]
        if [e.index for e in evs] != list(range(len(h.tokens))) or \
                [e.token for e in evs] != h.tokens:
            raise AssertionError(f"{tag}: request {h.uid}'s stream is not "
                                 f"its tokens: {len(evs)} events for "
                                 f"{len(h.tokens)} tokens")


def supervised_crash(cfg, params, dev, counters) -> dict:
    """(a): three serves of the same stream at full width and depth: an
    uninterrupted engine (cold, then two warm serves), a journaled one
    (cold, then two warm: the best warm tok/s against the uninterrupted
    engine's best, the fsyncs), and a
    ``Supervisor`` with a crash at ``CRASH_AT`` and snapshots every
    ``SNAPSHOT_EVERY`` ticks (launch counts set to 0 just before, read
    just after).  Gates: one restart; every stream its tokens; tokens
    equal the uninterrupted serve's or split at a near tie; the audit
    clean after every step, with one journaled pin after the restart; the
    prefix handle re-bound; the dead engine's cache freed at the restart
    and ``memory_allocated`` after the restored serve within 1% of the
    uninterrupted engine's."""
    import gc

    from repro_torch.serving import (ChaosConfig, ChaosMonkey, Engine,
                                     ServeConfig, Supervisor)
    prompts = phase4_prompts(cfg.vocab_size)
    head = head_tokens(cfg.vocab_size, HEAD_PAGES * FAULT_SERVE["page_size"])
    scfg = ServeConfig(**FAULT_SERVE)

    def serves(eng) -> tuple:
        """A cold serve, then the best of two warm ones: (the cold
        serve's tokens, the warm seconds)."""
        cold, _, ph = journal_serve(eng, prompts, head)
        ph.release()
        secs = []
        for _ in range(2):
            _, s, ph = journal_serve(eng, prompts, head)
            ph.release()
            secs.append(s)
        return [h.tokens for h in cold], min(secs)

    eng = Engine(cfg, scfg, params, device=dev)
    want, warm_s = serves(eng)
    plain_mem = engine_allocated()
    plain_cache = eng.stats().cache_bytes
    del eng
    gc.collect()

    d = journal_dir("journaled")
    eng = Engine(cfg, dataclasses.replace(
        scfg, journal_path=str(d / "wal.jsonl")), params, device=dev)
    _, jwarm_s = serves(eng)
    fsyncs = eng.journal.fsyncs
    eng.journal.close()
    del eng
    gc.collect()

    d = journal_dir("supervised")
    sup = Supervisor(cfg, scfg, params, device=dev,
                     journal_path=str(d / "wal.jsonl"),
                     snapshot_dir=str(d / "snap"),
                     snapshot_every=SNAPSHOT_EVERY)
    ChaosMonkey(sup.engine, ChaosConfig(seed=7, rate=0.0,
                                        crash_tick=CRASH_AT)).attach()
    torn = []                       # memory_allocated after the teardown
    teardown = sup._teardown

    def measured(old):
        teardown(old)
        torn.append(torch.cuda.memory_allocated())

    sup._teardown = measured
    zero_counts(counters)
    ph = sup.register_prefix(head)
    handles = [sup.submit(p, max_new=JOURNAL_NEW) for p in prompts]
    events, pins, freed, capturing = [], None, None, False
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while not all(h.done for h in handles):
            if len(events) > 10 * tokens_of(handles) + 1000:
                raise AssertionError("(a): the supervised serve does not "
                                     "drain")
            restarts = sup.restarts
            torch.cuda.synchronize()
            level = torch.cuda.memory_allocated()
            events += sup.step()
            report = sup.audit()
            if sup.restarts != restarts:
                capturing = torch.cuda.is_current_stream_capturing()
                freed = level - torn[-1]
                pins = report["journal_pins"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(counters)
    sup_mem = engine_allocated()
    st = sup.stats()
    rebound = ph._engine is sup.engine and not ph.released
    rows = [scfg.prompt_rows(len(p)) for p in prompts]
    equal = sum(split_at_tie(f"journal a: request {i}", params, cfg, dev, p,
                             r, h.tokens, w, params["embed"].dtype)
                for i, (p, r, h, w) in enumerate(zip(prompts, rows, handles,
                                                     want)))
    rec = sup.last_recovery
    caps = st.graph_captures
    found = {
        "restarts": sup.restarts, "token_equal": equal,
        "requests": len(prompts), "tokens": tokens_of(handles),
        "recovery_ms": {k: round(v, 3) for k, v in rec.items()},
        "restored_captures": len(caps),
        "restored_capture_s": round(sum(c["capture_s"] for c in caps), 4),
        "restored_instantiate_s": round(
            sum(c["instantiate_s"] for c in caps), 4),
        "plain_tok_per_s": round(tokens_of(handles) / warm_s, 1),
        "workspaces_cleared": hasattr(torch._C,
                                      "_cuda_clearCublasWorkspaces"),
        "journal_tok_per_s": round(tokens_of(handles) / jwarm_s, 1),
        "journal_fsyncs": fsyncs,
        "supervised_tok_per_s": round(tokens_of(handles) / wall, 1),
        "freed_at_restart_bytes": freed, "cache_bytes": plain_cache,
        "allocated_plain": plain_mem, "allocated_restored": sup_mem}
    log(f"[journal a] {cfg.n_layers} layers: restarts {sup.restarts}, "
        f"{equal}/{len(prompts)} requests token-equal to the uninterrupted "
        f"serve; recovery ms {json.dumps(found['recovery_ms'])}; restored "
        f"engine: {len(caps)} captures, capture "
        f"{found['restored_capture_s']} s, instantiate "
        f"{found['restored_instantiate_s']} s; warm tok/s (best of 2) plain "
        f"{found['plain_tok_per_s']}, journaled {found['journal_tok_per_s']}"
        f" ({fsyncs} fsyncs), supervised through the crash (cold) "
        f"{found['supervised_tok_per_s']}; memory_allocated freed at the "
        f"restart {freed} (the cache {plain_cache}), after the restored "
        f"serve {sup_mem} against {plain_mem} (cuBLAS workspaces cleared: "
        f"{found['workspaces_cleared']}); journal pins after the "
        f"restart {pins}; launches {json.dumps(launches)}")
    if sup.restarts != 1 or st.restarts != 1:
        raise AssertionError(f"(a): {sup.restarts} restarts, want 1")
    check_streams("(a)", handles, events)
    if pins != 1 or not rebound:
        raise AssertionError(f"(a): journal pins {pins} after the restart, "
                             f"prefix handle re-bound {rebound}")
    if capturing:
        raise AssertionError("(a): a graph capture was live at the crash")
    if freed is None or freed < plain_cache:
        raise AssertionError(f"(a): the restart freed {freed} bytes, less "
                             f"than the dead engine's cache {plain_cache}")
    if abs(sup_mem - plain_mem) > 0.01 * plain_mem:
        raise AssertionError(f"(a): {sup_mem} bytes allocated after the "
                             f"restored serve, {plain_mem} after the "
                             "uninterrupted one")
    if any(h.status.value != "done" for h in handles):
        raise AssertionError("(a): a request did not finish")
    missing = [k for k in ("nm_spmm", "paged_attention", "flash_attention")
               if not launches[k]]
    if missing:
        raise AssertionError(f"(a): kernels never launched: {missing}")
    healthy("journal a", st)
    ph.release()
    return found, launches


def step_times(eng, handles) -> list:
    """Drive ``eng`` to the end: each step's (ms, warming up or capturing
    a graph)."""
    from repro_torch.serving import Supervisor
    out = []
    while not all(h.done for h in handles):
        n = len(eng.stats().chunk_runs)
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        out.append(((time.perf_counter() - t0) * 1e3, Supervisor._warming(
            eng, eng.stats().chunk_runs[n:])))
    return out


def supervised_hang(dev) -> dict:
    """(b): a hang at ``fault_config()``: a cold uninterrupted serve
    times every step; the watchdog is ``HANG_MARGIN`` times its slowest
    steady step and the injected stall ``HANG_MARGIN`` times the
    watchdog.  Gates: the watchdog trips once (one restart, one watchdog
    warning); the tokens equal the uninterrupted serve's or split at a
    near tie; the fresh engine warms up and captures its graphs again
    and no such step trips the watchdog."""
    from repro_torch.serving import (ChaosConfig, ChaosMonkey, Engine,
                                     ServeConfig, Supervisor)
    cfg = fault_config()
    params = sparse_model(cfg, dev, SEED + 18)
    prompts = phase4_prompts(cfg.vocab_size, requests=8)
    scfg = ServeConfig(**dict(FAULT_SERVE, decode_chunk=4,
                              max_new_tokens=32))
    # the reference serve journals too: its steps pay the fsync the
    # supervised engine's steps pay
    eng = Engine(cfg, dataclasses.replace(scfg, journal_path=str(
        journal_dir("hang_reference") / "wal.jsonl")), params, device=dev)
    base = [eng.submit(p) for p in prompts]
    steps = step_times(eng, base)
    want = [h.tokens for h in base]
    eng.journal.close()
    del eng
    steady = max(ms for ms, warm in steps[2:] if not warm)
    watchdog = HANG_MARGIN * steady
    hang_s = STALL_MARGIN * watchdog / 1e3
    sup = Supervisor(cfg, scfg, params, device=dev,
                     journal_path=str(journal_dir("hang") / "wal.jsonl"),
                     watchdog_ms=watchdog)
    ChaosMonkey(sup.engine, ChaosConfig(seed=0, rate=0.0, hang_tick=HANG_AT,
                                        hang_s=hang_s)).attach()
    handles = [sup.submit(p) for p in prompts]
    fresh = []                  # the fresh engine's warm-up/capture ms
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        while not all(h.done for h in handles):
            restarted, n = sup.restarts, len(sup.engine.stats().chunk_runs)
            t0 = time.perf_counter()
            sup.step()
            ms = (time.perf_counter() - t0) * 1e3
            if restarted and Supervisor._warming(
                    sup.engine, sup.engine.stats().chunk_runs[n:]):
                fresh.append(ms)
            sup.audit()
    trips = sum("watchdog" in str(w.message) for w in caught)
    hows = [how for _, how in sup.engine.stats().chunk_runs]
    caps = sup.engine.stats().graph_captures
    rows = [scfg.prompt_rows(len(p)) for p in prompts]
    equal = sum(split_at_tie(f"journal b: request {i}", params, cfg, dev, p,
                             r, h.tokens, w, params["embed"].dtype)
                for i, (p, r, h, w) in enumerate(zip(prompts, rows, handles,
                                                     want)))
    slowest = max((ms for ms, warm in steps if warm), default=0.0)
    log(f"[journal b] {cfg.n_layers} layers: steady step <= {steady:.2f} ms, "
        f"watchdog {watchdog:.2f} ms, stall {hang_s:.3f} s a fetch from "
        f"tick {HANG_AT}; watchdog trips {trips}, restarts {sup.restarts}; "
        f"the fresh engine's chunks {hows.count('eager')} eager, "
        f"{hows.count('capture')} captures "
        f"({sum(c['capture_s'] + c['instantiate_s'] for c in caps):.3f} s "
        f"capture + instantiate), {hows.count('replay')} replays; its "
        f"warm-up and capture steps {[round(ms, 1) for ms in fresh]} ms "
        f"({sum(ms > watchdog for ms in fresh)} past the watchdog, none "
        f"tripping it); slowest warm-up or capture step of the cold serve "
        f"{slowest:.1f} ms; "
        f"{equal}/{len(prompts)} requests token-equal to the uninterrupted "
        f"serve")
    if trips != 1 or sup.restarts != 1:
        raise AssertionError(f"(b): {trips} watchdog trips, {sup.restarts} "
                             "restarts, want 1 and 1")
    if "capture" not in hows:
        raise AssertionError("(b): the fresh engine captured no graph")
    if any(h.status.value != "done" for h in handles):
        raise AssertionError("(b): a request did not finish")
    healthy("journal b", sup.stats())
    return {"steady_ms": round(steady, 3), "watchdog_ms": round(watchdog, 3),
            "hang_s": round(hang_s, 4), "trips": trips,
            "restarts": sup.restarts, "token_equal": equal,
            "fresh_captures": len(caps),
            "fresh_warming_ms": [round(ms, 3) for ms in fresh]}


def exact_setup():
    """(c)'s model, CPU params, prompts and serve config."""
    from repro_torch.configs import qwen3_0_6b
    from repro_torch.serving import ServeConfig
    small = chaos_small(qwen3_0_6b.sparse())
    cpu_params = sparse_model(small, torch.device("cpu"), SEED + 18)
    prompts = phase4_prompts(small.vocab_size, requests=EXACT_REQUESTS)
    scfg = ServeConfig(**dict(FAULT_SERVE, max_new_tokens=EXACT_NEW))
    return small, cpu_params, prompts, scfg


def exact_cpu_reference(out: str) -> int:
    """This script's CPU-reference mode for phase 18 (c): the
    uninterrupted serve of (c)'s stream on the port's CPU path, its tokens
    written to ``out`` as JSON."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.serving import Engine
    small, cpu_params, prompts, scfg = exact_setup()
    eng = Engine(small, scfg, cpu_params, device="cpu")
    handles = [eng.submit(p) for p in prompts]
    eng.run()
    Path(out).write_text(json.dumps([h.tokens for h in handles]))
    return 0


def exact_crash(dev, proc, out: Path) -> dict:
    """(c): a supervised crash at 2 layers in fp32 on ``dev`` against the
    uninterrupted serve of the port's CPU path (``exact_cpu_reference``,
    started at the phase's beginning): the tokens must be equal, every
    one."""
    from repro_torch.serving import ChaosConfig, ChaosMonkey, Supervisor
    small, cpu_params, prompts, scfg = exact_setup()
    t0 = time.perf_counter()
    if proc.wait(timeout=600):
        raise AssertionError(f"(c): the CPU reference exited "
                             f"{proc.returncode}")
    cpu_s = time.perf_counter() - t0
    cpu_tokens = json.loads(out.read_text())
    sup = Supervisor(small, scfg, _to(cpu_params, dev), device=dev,
                     journal_path=str(journal_dir("exact") / "wal.jsonl"))
    ChaosMonkey(sup.engine, ChaosConfig(seed=7, rate=0.0,
                                        crash_tick=EXACT_CRASH)).attach()
    handles = [sup.submit(p) for p in prompts]
    events = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while not all(h.done for h in handles):
            events += sup.step()
            sup.audit()
    got = [h.tokens for h in handles]
    equal = sum(a == b for a, b in zip(got, cpu_tokens))
    log(f"[journal c] 2 layers fp32: restarts {sup.restarts}; "
        f"{equal}/{len(prompts)} requests token-equal to the CPU path's "
        f"uninterrupted serve (waited {cpu_s:.1f} s for it)")
    if sup.restarts != 1:
        raise AssertionError(f"(c): {sup.restarts} restarts, want 1")
    check_streams("(c)", handles, events)
    for i, (a, b) in enumerate(zip(got, cpu_tokens)):
        if a != b:
            split = first_split(a, b)
            _, gaps, _ = greedy(cpu_params, small, prompts[i], len(b),
                                scfg.prompt_rows(len(prompts[i])), 512,
                                forced=b)
            raise AssertionError(
                f"(c): request {i} differs from the CPU path at token "
                f"{split} (CPU top-2 gap there "
                f"{gaps[split] if split is not None else None})")
    return {"restarts": sup.restarts, "token_equal": equal,
            "requests": len(prompts)}


def journal_and_supervisor(dev, counters) -> tuple:
    """Phase 18: (a) ``supervised_crash`` at 28 layers, (b)
    ``supervised_hang``, (c) ``exact_crash``.  Returns (a)'s launches and
    what each part found."""
    from repro_torch.configs import qwen3_0_6b
    proc, out = start_cpu_reference(EXACT_REFERENCE, "journal_cpu.json")
    found = {}
    try:
        t0 = time.perf_counter()
        cfg = qwen3_0_6b.sparse()
        params = sparse_model(cfg, dev, SEED + 18)
        found["crash"], launches = supervised_crash(cfg, params, dev,
                                                    counters)
        del params
        log(f"[phase 18] (a) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        found["hang"] = supervised_hang(dev)
        log(f"[phase 18] (b) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        found["exact"] = exact_crash(dev, proc, out)
        log(f"[phase 18] (c) {time.perf_counter() - t0:.1f} s")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return launches, found


def with_format(cfg, fmt: str):
    """``cfg`` with all seven projections in pack format ``fmt``."""
    from repro_torch.core.sparse_linear import SparsityConfig
    sp = SparsityConfig(**FORMATS[fmt])
    return dataclasses.replace(cfg, mlp_sparsity=sp, attn_sparsity=sp)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # a fresh autotune cache inside the checkout, before any import of the
    # port: a stale one would change the plans phases 3-15 pin
    fresh = ROOT / "build" / "chip_smoke" / "autotune.json"
    fresh.parent.mkdir(parents=True, exist_ok=True)
    for stale in fresh.parent.glob("autotune*.json"):
        stale.unlink()
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(fresh)
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import qwen3_0_6b
        from repro_torch.kernels import _build
        from repro_torch.kernels import bsr_matmul, csa_matmul, \
            flash_attention, lookahead_decode, nm_spmm, paged_attention
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run this "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # outside phase 17 an engine entering degraded mode fails the phase
    # (a kernel failure always degrades): the plain versions never stand
    # in for a kernel unseen
    warnings.filterwarnings("error", message="engine entering degraded",
                            category=RuntimeWarning)
    dev = torch.device("cuda", 0)
    log(nvidia_smi())
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    seconds = {}

    def timed(phase: str, t0: float) -> None:
        seconds[phase] = time.perf_counter() - t0
        log(f"[phase] {phase}: {seconds[phase]:.1f} s")

    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] {len(reports)} kernel libraries built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for fn, regs, spills in ptxas_table(rep):
            log(f"[build] {name}: {fn}: {regs} registers, {spills}")
    timed("2 build", t0)

    t0 = time.perf_counter()
    cfg = qwen3_0_6b.sparse()
    rows = [check_nm_spmm(cfg, dev), check_paged_attention(cfg, dev),
            check_flash_attention(cfg, dev),
            check_strip_kernel(cfg, dev, "combined", copies=8),
            check_strip_kernel(cfg, dev, "block", copies=4),
            check_lookahead(cfg, dev)]
    for fcfg in family_configs():
        check_nm_spmm(fcfg, dev, copies=1)
        check_paged_attention(fcfg, dev)
        check_flash_attention(fcfg, dev)
    for mcfg in moe_configs():
        check_moe_kernels(mcfg, dev)
    for hcfg in hybrid_configs():
        check_hybrid_kernels(hcfg, dev)
    check_encdec_kernels(encdec_config(), dev)
    for gcfg in gemma_configs():
        check_gemma_kernels(gcfg, dev)
    check_bench_kernels(dev)
    timed("3 kernels", t0)

    # each format's serve: (kernel module, kernel name, requests, tokens,
    # profiled); the paged and flash kernels run on every path
    counters = (nm_spmm, paged_attention, flash_attention, csa_matmul,
                bsr_matmul, lookahead_decode)
    attention = {"paged_attention", "flash_attention"}
    serves = {"combined": ("csa_matmul", "csa_matmul", 16, 64, True),
              "block": ("bsr_matmul", "bsr_matmul", 8, 32, False),
              "lookahead": ("lookahead_decode", "lookahead_matmul", 8, 32,
                            False)}
    t0 = time.perf_counter()
    launches = serve_full_width(cfg, dev, counters, {"nm_spmm"} | attention)
    timed("4 serve nm", t0)
    for fmt, (module, kernel, requests, max_new, profile) in serves.items():
        t0 = time.perf_counter()
        fcfg = with_format(cut_depth(qwen3_0_6b.config(), FORMAT_LAYERS),
                           fmt)
        got = serve_full_width(fcfg, dev, counters, {module} | attention,
                               requests=requests, max_new=max_new,
                               zero_tiles=True, profile=profile)
        launches[kernel] = got[module]
        timed(f"4 serve {fmt}", t0)

    t0 = time.perf_counter()
    small = dataclasses.replace(cfg, n_layers=2, layer_kinds=(),
                                dtype="float32")
    card_vs_cpu(small, dev)
    for fmt in serves:
        card_vs_cpu(with_format(small, fmt), dev, zero_tiles=True)
    timed("5 fidelity", t0)

    t0 = time.perf_counter()
    paper_layer(dev, counters)
    timed("6 paper layer", t0)

    t0 = time.perf_counter()
    got = prefix_sharing(cfg, dev, counters)
    for name in ("nm_spmm", "paged_attention", "flash_attention"):
        launches[name] += got[name]
    prefix_vs_cpu(small, dev)
    timed("7 prefix sharing", t0)

    t0 = time.perf_counter()
    got, spec_acceptance = speculation(
        dataclasses.replace(cfg, n_layers=SPEC_LAYERS, layer_kinds=()), dev,
        counters)
    for name in ("nm_spmm", "paged_attention", "flash_attention"):
        launches[name] += got[name]
    spec_vs_cpu(small, dev, counters)
    timed("8 speculation", t0)

    t0 = time.perf_counter()
    for fcfg in family_configs():
        got = family_serve(fcfg, dev, counters)
        for name in ("nm_spmm", "paged_attention", "flash_attention"):
            launches[name] += got[name]
    for fcfg in family_configs():
        family_vs_cpu(fcfg, dev, counters)
    timed("9 stablelm-12b and qwen2-vl-72b", t0)

    t0 = time.perf_counter()
    for mcfg in moe_configs():
        got = moe_serve(mcfg, dev, counters)
        for name in ("nm_spmm", "paged_attention", "flash_attention"):
            launches[name] += got[name]
    # (c)'s CPU side runs in a process of its own beside phases 11-13;
    # its check follows phase 13
    moe_ref = start_moe_reference()
    moe_cards = [(mcfg, *moe_vs_cpu(mcfg, dev, counters))
                 for mcfg in moe_configs()]
    wait_moe_drawn(*moe_ref)
    timed("10 qwen2-moe-a2.7b and dbrx-132b", t0)

    t0 = time.perf_counter()
    for hcfg in hybrid_configs():
        got = hybrid_serve(hcfg, dev, counters)
        for name in ("nm_spmm", "paged_attention", "flash_attention"):
            launches[name] += got[name]
    for hcfg in hybrid_configs():
        hybrid_vs_cpu(hcfg, dev, counters)
    got = hybrid_spec(hybrid_configs()[1], dev, counters)
    for name in ("nm_spmm", "paged_attention", "flash_attention"):
        launches[name] += got[name]
    timed("11 mamba2-130m and zamba2-1.2b", t0)

    t0 = time.perf_counter()
    ecfg = encdec_config()
    got = encdec_serve(ecfg, dev, counters)
    encdec_vs_cpu(ecfg, dev, counters)
    for more in (got, encdec_spec(ecfg, dev, counters)):
        for name in ("nm_spmm", "paged_attention", "flash_attention"):
            launches[name] += more[name]
    timed("12 seamless-m4t-large-v2", t0)

    t0 = time.perf_counter()
    for gcfg in gemma_configs():
        got = gemma_full(gcfg, dev, counters)
        for name in ("nm_spmm", "paged_attention", "flash_attention"):
            launches[name] += got[name]
    for gcfg in gemma_configs():
        gemma_vs_cpu(gcfg, dev, counters)
        got = gemma_spec(gcfg, dev, counters)
        for name in ("nm_spmm", "paged_attention", "flash_attention"):
            launches[name] += got[name]
    timed("13 gemma2-27b and gemma3-1b", t0)
    moe_check(moe_cards, *moe_ref)

    t0 = time.perf_counter()
    got, train = training(dev, counters, spec_acceptance["pack"])
    for name in ("nm_spmm", "paged_attention", "flash_attention"):
        launches[name] += got[name]
    timed("14 training", t0)

    t0 = time.perf_counter()
    got, launchers = launchers_and_cnn(dev, counters)
    for module, n in got.items():
        name = "lookahead_matmul" if module == "lookahead_decode" else module
        launches[name] += n
    timed("15 launchers and CNN training", t0)

    t0 = time.perf_counter()
    got, dryrun_found = dryrun_and_autotune(dev, counters)
    for name in ("nm_spmm", "paged_attention", "flash_attention"):
        launches[name] += got[name]
    timed("16 dry run and autotune", t0)

    t0 = time.perf_counter()
    got, faults = faults_and_chaos(dev, counters)
    for name in ("nm_spmm", "paged_attention", "flash_attention"):
        launches[name] += got[name]
    timed("17 faults and chaos", t0)

    t0 = time.perf_counter()
    got, journal = journal_and_supervisor(dev, counters)
    for name in ("nm_spmm", "paged_attention", "flash_attention"):
        launches[name] += got[name]
    timed("18 journal and supervisor", t0)

    kernels = [dict(name=r["name"], route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=launches[r["name"]],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for r in rows]
    log(f"[phase] seconds {json.dumps(seconds)}")
    log(json.dumps({"train": train}))
    log(json.dumps({"launchers": launchers}, default=str))
    log(json.dumps({"dryrun": dryrun_found}))
    log(json.dumps({"faults": faults}))
    log(json.dumps({"journal": journal}))
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [CPU_REFERENCE]:
        sys.exit(chaos_cpu_reference(sys.argv[2]))
    if sys.argv[1:2] == [EXACT_REFERENCE]:
        sys.exit(exact_cpu_reference(sys.argv[2]))
    if sys.argv[1:2] == [MOE_REFERENCE]:
        sys.exit(moe_cpu_reference(sys.argv[2]))
    try:
        rc = main()
    finally:
        stop_children()
    sys.exit(rc)
