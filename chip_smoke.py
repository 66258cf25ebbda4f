#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``apex_tpu_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA GPU
    python3 chip_smoke.py --ln-times TREE   # LayerNorm times of TREE's port
    python3 chip_smoke.py --decode-times TREE   # decode times of TREE's port
    python3 chip_smoke.py --flash-times TREE    # flash #1-#6, no masks
    python3 chip_smoke.py --o0-long-times TREE  # the O0 step at 8192
    python3 chip_smoke.py --sass TREE   # SASS counts of the flash kernels
    python3 chip_smoke.py --kernel-names   # fp32 attention kernels by name
    python3 chip_smoke.py --generate-profile   # an fp32 generate, profiled
    python3 chip_smoke.py --contrib   # the build, then phase 13 alone
    python3 chip_smoke.py --dp   # the build, then phase 14 alone
    python3 chip_smoke.py --tp   # the build, then phase 15 alone
    python3 chip_smoke.py --zero   # the build, then phase 16 alone
    python3 chip_smoke.py --pp   # the build, then phase 17 alone
    python3 chip_smoke.py --cp   # the build, then phase 18 alone
    python3 chip_smoke.py --offsets   # the build, then the ring offsets

Eighteen phases; any failure raises and exits non-zero:

1. **Build** every kernel from ``apex_tpu_torch/csrc`` with nvcc
   (``sm_90a``) and print the build seconds, the card's name and its power
   limit.
2. **Kernel vs plain**: each kernel (LayerNorm forward and backward on
   both routes, one warp per row and one CTA per row or per 32 rows: rows
   of 1001 elements, a view off 16 bytes, rows past the warp caps, 1 and
   33 rows; flash-attention forward, its dQ and dK/dV backward, paged flash-decode
   with and without its window, the K-query paged decode, the softmax
   cross-entropy forward and backward, the streamed flash forward (with its
   merge pass where a band has several splits), dQ and dK/dV with the
   sliding window, the fused scale-mask
   softmax forward and backward at the GPT-2 345M and BERT-large score
   shapes, a per-head mask, unaligned rows, fp16 and rows of 65536 and
   100003 elements on the two-pass route) against its plain PyTorch
   version on the card, at the main paths' shapes in bf16 and fp32 plus
   edge cases, each error beside its stated tolerance (the flash kernels,
   resident and streamed, the LayerNorm pair and the decode pair also each
   row's own error, the forwards' lse, a planted fault the row check must
   catch, and the resident kernels', the LayerNorm pair's and the decode
   pair's bits the same from call to call; the decode pair also at the
   split route's edges, with the route in each verdict name); then device
   times
   by CUDA-graph replay between CUDA events (kernel, plain version, one
   PyTorch library call as yardstick where one computes the same function;
   the resident flash kernels beside the streamed ones at 1024 (batch 1
   and 8) and, forward + dQ + dK/dV, at 2048-16384 tokens, the numbers
   behind STREAM_MIN_SEQ; the key tile and split length of the streamed
   bf16 forward and the split length of its backward against the values
   tried, the resident forward's schedule and tiles and the resident
   backward's schedule and dQ inner tile against the values tried, the
   softmax forward's warp route against its CTA route at 1024 and 2048
   columns, the LayerNorm pair's rows (warps) a CTA, CTAs an SM and
   warp caps, the fp32 resident backward's schedule and tiles at F =
   (4,16,1024,64), the fp32 streamed forward's split length at RP and L,
   and the decode pair's split count against the values tried) and the
   least time the card could take. The fp32 resident
   backward pair (register-blocked FMA) at F with a halved dQ tail caught
   and two calls bit-identical, at d = 6, 16, 36, 40 and 128, cross
   shapes, the fused-QKV view and views off 16 bytes (its 4-byte copies);
   the fp32 forward (the same FMA pieces, resident and split) at F with a
   halved o tail caught and two calls bit-identical, at d = 16, 36 (views
   off 16 bytes), 40 and 128, cross shapes and the fused-QKV view, and
   streamed with one split a band (no workspace, by the bytes allocated)
   and with cut split lengths (the merge). The fp32 streamed backward pair
   (the resident fp32 pair's kernels over whole bands) at d = 6, 16, 36,
   40 and 128, the fused-QKV view and views off 16 bytes, two calls
   bit-identical, and rows whose band is empty exactly 0 in memory that
   was NaN (:func:`check_fp32_stream_bwd`).
   In a child process (``--kernel-names``), the kernels by name of one
   call each of SDPA's fp32 forward and backward, of #3 and #4 fp32 at L
   (one ``dq_f32_blocked`` / ``dkv_f32_blocked`` launch each, nothing
   else), of #2 fp32 at RP (one ``fwd_f32_blocked`` launch, no
   merge), and of #9 fp32 at the decode shape and #10 fp32 at the verify
   and chunk shapes (one ``flash_decode_f32`` / ``decode_multi_f32``
   launch each, nothing else). The decode pair's fp32 split route also at
   8-, 12-, 32- and 128-token pages, d = 38 (4-byte copies), 40 and 128,
   pools off 16 bytes, lengths on a split's last page at 1, 2, 3 and 8
   splits, output memory that read NaN, a halved tail caught at the decode
   and chunk shapes and two calls bit-identical at the decode, verify and
   chunk shapes. The additive bias on the
   resident flash kernels #1, #5 and #6 (:func:`check_flash_bias`): BERT's
   padding bias from ``extended_attention_mask`` at (16,16,512,64) bf16,
   dense biases with dbias broadcast over the batch, the heads or both
   (the fixed-order finish), whole, under causal, an all -inf row, d =
   128 and the fp32 route, each output by its share of max |ref| and by
   row, halved tails of o and dbias caught, two calls bit-identical; the
   times with and without the bias beside the bounds, the plain versions
   and SDPA with the same float mask; the launch floor (an empty kernel).
   The segment ids, ``pad_id`` and the contiguous-segment bounds on all
   six flash kernels (:func:`check_flash_segments`), forward and backward,
   bf16 and fp32, resident and streamed: packed ids with a padding tail,
   causal and not, the bounds against mask-only, a causal row whose
   same-id keys lie above the diagonal (exactly 0), the window with
   segments and the window alone on the resident route, cut split lengths
   (empty partials merged), d = 128, a halved tail caught, two calls
   bit-identical, and the root bench.py selftest's streamed case. The
   ring offsets on all six (:func:`check_flash_offsets`): at shift 0 bit
   for bit the launch without it, the full band, every band empty (exactly
   0 / -1e30 in NaN-poisoned memory), partial windowed bands with dead
   rows; and the ring steps' times beside their bounds and SDPA.
3. **Serving**: fp32 gates on a small model (the monolithic engine, then
   chunked prefill, the prefix cache, speculative decoding with a
   self-draft and a 1-layer draft, and all three: every token against the
   argmax of the full-context forward, the speculative tokens also against
   the non-speculative engine's, no page leaked), then GPT-2 345M at full
   width (random weights from a seed, bf16 compute, fp32 params) serving
   16 requests three ways: monolithic prefill; the prefix cache with
   speculative decoding (spec_k 4, self-draft) on 16 prompts sharing a
   500-token prefix (15 prefix hits, at least 15 copy-on-write forks, mean
   accepted length above 1, no page leaked); and 256-token prefill chunks.
   Each run's launch count of every kernel is checked against the count
   its schedule implies; the profiled windows print the decode kernels'
   device time and launches beside the busy time, and per decode tick.
4. **Training**: an fp32 gradient gate on a small GPT (loss and every
   parameter's grad on the card through the kernels against the same model
   on the CPU through the plain versions), then the GPT-2 345M amp-O2
   training step of ``apex_tpu_torch.bench.build("O2")`` at full width and
   depth (batch 8 x 1024, random weights from a seed, one fixed batch): one
   warm-up step and 10 steps timed as one window (the step time is the
   window over 10, each step's time beside it) with the exact launch counts
   checked, a falling finite loss, no skipped step and bf16 params equal to
   their fp32 masters cast down; then the top kernels by device time of one
   profiled step, with the resident flash forward's and backward pair's
   and the LayerNorm forward's and backward's (with its dgamma/dbeta
   finish) device time and launches.
5. **ResNet-50 training** (``apex_tpu_torch.examples.imagenet.main_amp``):
   an fp32 gradient gate on a small Bottleneck ResNet (loss, every grad and
   the running stats on the card through cuDNN and the xentropy kernels
   against the same model on the CPU), then ResNet-50 at full width and
   depth under amp O2 with ``FusedSGD(lr=0.1, momentum=0.9,
   weight_decay=1e-4, nesterov=True)``, batch 256 of 224x224 images (one
   fixed synthetic batch on the card): one warm-up step and 10 timed as
   one window, the exact launch counts (each xentropy kernel once a step,
   every other kernel 0), a falling finite loss, no skipped step after the
   warm-up, bf16 conv and fc weights and fp32 ``bn*`` params each equal to
   its master cast down; images/s, the model-FLOPs share of 989 TFLOP/s
   from the model's own conv and fc shapes, peak memory, and one profiled
   step's device-busy share and top kernels.
6. **Long-context training**
   (``apex_tpu_torch.examples.longcontext.train_long_context``): an fp32
   gradient gate on a small GPT at 4096 tokens with rotary positions and a
   512-token window (card through the streamed kernels against the CPU),
   then GPT-2 345M at full width and depth under amp O2 with
   FusedAdam(lr=1e-4), full remat and lm_head_chunks=8, two ways: (A)
   batch 1 x 8192 with learned positions, (B) batch 1 x 16384 with rotary
   positions and a 4096-token window. Each: one warm-up step and 10 timed
   as one window, the exact launch counts (the streamed forward 2L a step,
   dQ and dK/dV L each, the resident flash kernels 0), a falling finite
   loss, no skipped step, bf16 params equal to their masters cast down;
   tokens/s, the model-FLOPs share, peak memory, and one profiled step
   with the streamed forward's and backward's device time.
7. **Fused softmax and the small layers** (:func:`fused_softmax_and_small_layers`):
   ``FusedScaleMaskSoftmax`` forward and backward at the GPT-2 345M causal
   and BERT-large padded score shapes (one launch of each softmax kernel a
   fused call, none on the unaligned route or with ``fused=False``); the
   explicit-scores attention it exists for (matmul, the module, matmul) at
   (8,16,1024,64) bf16 against ``flash_attention``, with both fwd+bwd
   times; ``FusedLayerNorm``, ``FusedRMSNorm``, ``FastLayerNorm``,
   ``FusedDenseGeluDense`` and ``MLP`` at GPT-2 345M width on 8192 tokens
   against a CPU copy of each; exact launch counts.
8. **BERT-large pretraining**
   (``apex_tpu_torch.examples.bert.pretrain_bert``): an fp32 gradient gate
   on a small BERT with a padded batch (card through the kernels with the
   padding bias against the CPU), then BERT-large (vocab 30592, hidden
   1024, 24 layers, 16 heads, seq 512, the binary head) under amp O2 with
   FusedLAMB(lr 2e-3, weight decay 0.01), batch 16 x 512 of the example's
   synthetic batch (one fixed batch): one warm-up step and 10 timed as one
   window, the exact launch counts, a falling finite loss, no skipped
   step; tokens/s, the model-FLOPs share, peak memory and one profiled
   step's idle share; then the JSON line of
   ``apex_tpu_torch.benchmarks.optimizer_step`` (fused Adam and fused LAMB
   against eager Adam).
9. **Packed varlen attention** (:func:`fmha_packed`): ``contrib.fmha``
   forward and backward at BERT-large width (16 heads of 64, bf16,
   non-causal) on (R) 16 sequences of seeded lengths in 32-384 (the
   resident kernels) and (S) 32 in 64-512 (the streamed ones), each with
   37 tokens past ``cu_seqlens[-1]``: the route, the launches, output and
   grads against ``fmha_reference``, the exact zeros; then each kernel's
   time with the bounds on and off, the metadata's, the bound (sum
   len_i^2 pairs) and SDPA over the padded batch and with the
   block-diagonal mask.
10. **The GPT examples** (:func:`gpt_examples`), through their entry points
   at GPT-2 345M's width and :data:`RANK_LAYERS` (8) layers, not 24 (the
   room phase 19's exact reference needs): (a) ``pretrain_gpt.run`` at amp O2, 8 x 1024 tokens a
   step as 2 micro-batches of 4, 11 steps, saving at step 11 into a
   directory under ``build/`` (removed at the end): exact launches, finite
   losses, no skipped step, the step time, tokens/s, the model-FLOPs share,
   peak memory, the checkpoint's bytes and save seconds; a second ``run``
   resumes from it (restore seconds) with every param, master, Adam moment,
   the step and the scaler bit-identical, and the next step on the
   stream's first batch (where a resumed run starts again) gives the same
   loss bits from the in-memory and the restored trainer, below that
   batch's loss at step 0 (all at lr 1e-4; the same 11 steps at the
   example's default 3e-4 are reported beside them); (b)
   ``build(opt_level="O0")`` for 3 steps on
   one batch (fp32 routes of #1, #5, #6, #7, #8: launches, a falling
   loss, the step beside the one with the fp32 backward pair on FMA
   kernels), the same 11 steps as (a) at O0 and lr 3e-4 (the first
   batch's loss before and after, reported beside O2's), then each of
   those fp32 routes at this shape against its plain version and timed
   beside the bound, the plain version and the library call (SDPA's fp32
   forward and backward, SDPA's fp32 o against the plain version), and
   #3/#4 fp32 at L32 = (1,16,8192,64) and W32 = (1,16,16384,64) window
   4096 (halved dQ and dK tails caught, two calls bit-identical); (c)
   remat_policy full, save_attn and dots: the first step's loss
   and grads against full's, exact launches (#1 L*M a step under
   save_attn), step time and peak memory; (d) ``generate_gpt.run`` (fp32)
   from the checkpoint: plain, prefix cache + speculative, 256-token
   chunks, every token against the full-context argmax, exact launches,
   TTFT/ITL p50 and tokens/s, then #9 and #10 on their fp32 routes at
   phase 2's decode shapes (#9 also with window 128 and at b = 1 over 8192
   keys); (e) ``--pos rope --window 256`` with random
   weights, monolithic and chunked + speculative, held the same way, then
   in a child process (``--generate-profile``) the chunked speculative run
   once more under the profiler (the device's busy share and the decode
   kernels' ms a tick), then #2's fp32 route at the longest prefill (one
   split a band: no workspace); (f) ``pretrain_gpt`` at O0 on one 8192-token sequence a
   step, 3 steps: the streamed kernels' fp32 routes (#2 2L, #3 and #4 L a
   step, the resident flash kernels 0), a finite falling loss, the ms a
   step.
11. **The root bench.py harness** (:func:`bench_harness`): ``python -m
   apex_tpu_torch.bench`` once in a child process at its defaults (windows
   of :data:`BENCH_STEPS` = 10 steps, 3 windows; GPT-2 345M O2 against the
   fp32 O0 leg at 8 x 1024, interleaved; ResNet-50 at 64 x 224²; BERT-large
   at 8 x 512; the canary; the optimizer ratio; the kernel selftest): the
   line must hold ``value``, ``vs_baseline`` from interleaved windows, both
   rungs, ``selftest.all_ok`` and no ``errors``; its figures and each
   selftest entry against its ``tol_norm`` are printed, every kernel but
   the decode pair must have launched in it (``launches_by_path``'s
   ``bench``, counted in the bench's processes). Then the DCGAN example
   (``apex_tpu_torch.examples.dcgan.main_amp``) 10 steps on the card:
   finite losses, bf16 params, both scalers clean, no csrc kernel; and the
   native host runtime (``csrc.available()``, a flatten round trip).
12. **The convergence probe, the rest of the optimizers and the legacy
   APIs** (:func:`optimizers_and_legacy`): (a) ``python -m
   apex_tpu_torch.benchmarks.convergence_probe`` at GPT-2 345M's width
   and 12 layers, O2, 2 x 512 tokens, lr 3e-4 warmed up over 50 steps, cut
   to 150 steps (its default 600) and a CPU replay of 1 (:data:`PROBE_ARGS`,
   to leave room for phases 16-19): exit 0, final loss <=
   6.0, the replay with no error within 0.05, the exact launch counts
   (path ``probe``); (b) ``FusedMixedPrecisionLamb`` beside
   ``MixedPrecisionOptimizer(FusedLAMB)`` at BERT-large (16 x 512, O2, 5
   steps on the same scaled grads): masters within 1e-5 of each leaf's max,
   bf16 params equal, no host sync in its step (sync debug mode "error"),
   a planted inf leaving every bit and the step count; (c)
   ``FP16_Optimizer(FusedAdam)`` beside amp O2 at GPT-2 345M (8 x 1024, 3
   steps): masters within 1e-6, a planted inf skipped with the scale
   halved; (d) every fused optimizer's ms a step on the GPT-2-124M list;
   (e) ``make_lstm(1024, 1024, 2)`` at 32 x 128 steps fp32 against the CPU.
13. **Contrib** (:func:`contrib_phase`): (a) ``SelfMultiheadAttn`` and
   ``EncdecMultiheadAttn`` at Transformer-big width (embed 1024, 16 heads
   of 64, batch 16, biases, ``include_norm_add``): self-attention on 512
   tokens with a seeded key-padding mask (lengths 128-512), then with a
   dense float ``attn_mask`` added, and 384 queries over a 512-token memory
   under the padding mask, each bf16 and fp32, forward and backward
   through ``impl="fast"`` (#1, #5, #6, #7, #8 once each) against
   ``impl="default"`` on the card: the output and every parameter's and
   input's grad by share of max |ref| and by row (phase 2's limits), q/k/v
   read in place, both routes' forward + backward ms and the attention
   alone beside SDPA with the float mask; (b) a small frozen ResNet's fp32
   gradient gate (card against the CPU), then ``ResNet50Frozen`` at 64 x
   224² under amp O2 with FusedSGD (lr 1e-3), phase 5's step, 1 + 10 steps:
   a finite falling loss, each xentropy kernel once a step, images/s; (c)
   the RNN-T joint and loss at B 16, T 256, U 64, V 1024, joint width 512
   (bf16 joint, fp32 log-probs): the loss and its grad against the CPU on
   the same log-probs (1e-5), two sequences against the float64 DP (1e-4),
   the ms; (d) ASP at GPT-2 345M O2 (phase 4's build): the 2:4 masks of
   every eligible leaf on the card equal the CPU's, a seeded channel
   permutation of layer 0's MLP pair keeps its output (1e-5), 5 steps of
   the ASP-wrapped FusedAdam under amp with every masked group of 4 holding
   >= 2 zeros in the bf16 params and the fp32 masters after each step,
   ``sparsity_ratio`` 0.5, phase 4's launches a step and a falling loss.
14. **Data parallel** (:func:`dp_phase`): (a) NCCL at world size 1 in
   this process (``multiproc.initialize_distributed`` on a free local
   port): ``pretrain_gpt``'s DP branch at GPT-2 345M (8 x 1024, 2
   micro-batches of 4), 3 O2 steps, its losses and params after each step
   bit for bit the serial run's; ``main_amp --sync-bn`` (ResNet-50 O2, 64 x
   224², 3 steps) against local BN. (b) Two gloo ranks on the one card
   (gloo stages through the host: correctness only, its times are not
   speed numbers), spawned once, every case in turn against serial
   references this process makes first: the 345M O2 step on 8 rows a rank
   of a 16-row batch (2 micro-batches of 4) against 4 micro-batches of 4
   on all 16 (losses, step 1's grads by share and by row, both ranks'
   params equal after each step); an inf in rank 1's grads alone skipping
   the step on both ranks with the scale halved (``MeshGradScaler``);
   ResNet-50 in fp32 with SyncBatchNorm over 2 x 32 at 224² against BN at
   64 (logits, running statistics, and the grads against the spread the
   serial run shows with its batch's halves swapped); the long-context
   example's ``--dp 2`` at 2 x 8192 against the serial run at batch 2.
15. **Tensor parallel** (:func:`tp_phase`): (a) NCCL at world size 1 in
   this process: ``pretrain_gpt`` on the model axis at tp = 1 (GPT-2 345M,
   8 x 1024, O2), 2 steps, its losses and params after each step bit for
   bit the serial run's. (b) Two gloo ranks on the one card (host-staged:
   correctness only), spawned once, every case against serial references
   this process makes first: ``pretrain_gpt --tp 2`` at 345M (2 O2 steps:
   losses, step 1's grads gathered to full shape by share and by row, the
   replicated leaves equal on both ranks after each step), the same under
   sequence parallelism, a checkpoint saved at tp 2 resumed serial (the
   next loss), BERT-large at tp 2 (8 x 512 with padding, O2 FusedLAMB with
   whole-tensor norms, 1 step), ``generate_gpt --tp 2`` at 345M fp32,
   monolithic and with the prefix cache and spec_k 4 (every token against
   the TP model's full-context argmax and the serial engine's tokens, 8 kv
   heads a rank); then #9 / #10 fp32 at 8 heads, times only.
16. **ZeRO** (:func:`zero_phase`): (a) NCCL at world size 1 in this
   process: ``pretrain_gpt`` at 345M (8 x 1024, O2) with ``--zero-level``
   1, 2 and 3, level 3 with ``--zero3-prefetch 1``, and
   ``--offload-optimizer --offload-buckets 2``, 2 steps each, losses and
   params after each step bit for bit the serial run's; ``BENCH_ZERO=1``'s
   O2 step against the bench's (step 1 bit for bit, the fp32 LayerNorm
   params at the bf16 gather's rounding; step 2's loss). (b) Two gloo
   ranks on the one card (host-staged: correctness only), spawned before
   (a): at 345M a 16-row batch, DP, then ZeRO-1, ZeRO-2 (against DP),
   ZeRO-3 (against ZeRO-2) and offload (bit for bit ZeRO-2), params equal
   on both ranks; at 345M width with 4 layers the bf16 param gather and
   the int8 and e5m2 grad wires tracking the fp32 wire, offload bit for
   bit, and an inf in rank 1's grads alone skipping the step on both
   ranks with masters, moments and residual unchanged; each run's peak
   memory per rank (``torch.cuda.max_memory_allocated``, reported).
17. **Pipeline parallel** (:func:`pp_phase`): (a) NCCL at world size 1 in
   this process: ``pretrain_gpt`` at 345M (8 x 1024 as 4 micro-batches of
   2, O2) through ``get_forward_backward_func(1)`` on a pipe axis of 1, 3
   steps, losses and params after each step bit for bit the serial run's.
   (b) Two gloo ranks on the one card, spawned before (a): a CUDA tensor
   through the ring shift by value (gloo carries it through the host, as
   the printout says), then ``pretrain_gpt --pp 2`` at 345M (12 layers a
   stage, 3 O2 steps) with 1f1b, interleaved ``--vpp 2`` and zerobubble
   against the serial run (losses, step 1's grads by their bf16 floor,
   each stage's layers held against the serial layers it holds, the
   non-layer params equal on both stages after each step), gpipe one step
   bit for bit the 1f1b run's first, the 1f1b run's O0 twin against the
   serial O0 step (loss, grads by share and by row, :data:`PP_O0_GRAD`)
   and ``--pp 2 --zero`` against ``--pp 2``; each stage's launches exact.
18. **Context parallel** (:func:`cp_phase`): (a) NCCL at world size 1 in
   this process, on a context axis of 1: ``ring_attention`` and
   ``ulysses_attention`` at (1,16,4096,64) bf16, causal and with a window,
   values and grads bit for bit ``flash_attention``'s. (b) Two gloo ranks
   on the one card, spawned before (a), against serial references this
   process makes meanwhile: the ring shift and the bf16 all-to-all by
   value; ``train_long_context --cp 2`` at 345M (8192 tokens, 4096 a
   rank), ring and Ulysses, 3 O2 steps (losses, step 1's grads by their
   bf16 floor); the ring's O0 twin at 4 layers, held at ~15x its
   readings; ``--seq 16384 --pos rope --window 4096`` (the window across
   the shard boundary), 1 step; BERT-large at cp 2 (8 x 512 with padding
   as segment ids riding the ring, FusedLAMB, NSP) against the serial
   bias-route step, and its O0 twin; every launch counted.

Every check with a limit is also kept for the closing verdict: one line
per check (name, worst error, limit, result, route) after phase 7, so
that the end of the output holds them all. After the verdict comes a
``{"kernels": [...]}`` JSON object (``launches_by_path``: each kernel's
count on the three serving runs, the GPT training run, the ResNet
training run, the two long-context runs and phase 7's run (``softmax``),
each counted from 0, phase 8's BERT run (``bert``), phase 9's (``fmha``)
and phase 10's (``gpt_pretrain``, ``gpt_pretrain_o0``, ``gpt_remat_*``,
``gpt_generate*``, ``gpt_pretrain_o0_long``), phase 11's (``bench``) and
phase 12's (``probe``), phase 13's (``contrib``), phase 14's (``dp``:
(a)'s runs and both ranks' of (b)), phase 15's (``tp``: the same) and
phase 16's (``zero``: the same), phase 17's (``pp``: the same) and
phase 18's (``cp``: the same);
``by_shape`` also holds phase 10's fp32 times, phase 15's at 8 heads
and phase 2's ring-step times on #2-#4;
``segments``: phase 9's times on #1-#6; ``launches``:
their sum; ``bias_route``: #1, #5 and #6 with and without the bias;
``launch_floor_ms`` on the decode and xentropy rows), the decode split-count
tuning line, then the card's name and power limit as nvidia-smi prints
them, and the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tfloat32": 495e12}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


#: group -> [(name, error, limit, passed, route)] of every check with a
#: limit, printed as the closing verdict, one line a group
VERDICTS = {}


def verdict(name, err, limit, route="cuda", group=None):
    """Hold ``err`` to ``limit`` (``err <= limit``), keep it for the
    closing verdict under ``group`` (default: its own name), and raise if
    it fails."""
    ok = err <= limit
    VERDICTS.setdefault(group or name, []).append(
        (name, err, limit, ok, route))
    check(ok, f"{name}: {err:.4g} > limit {limit:g}")


def print_verdict():
    """One line per check group: its checks' count, the error and limit of
    the one nearest its limit, the result and the routes, so that the
    whole verdict fits the end of the output."""
    def share(entry):
        _, err, limit, _, _ = entry
        return err / limit if limit > 0 else (float("inf") if err else 0.0)

    n = sum(len(v) for v in VERDICTS.values())
    print(f"verdict: {n} checks in {len(VERDICTS)} groups (group [checks] "
          f"| worst error | its limit | result | route)")
    for group, entries in VERDICTS.items():
        _, err, limit, _, _ = max(entries, key=share)
        ok = all(e[3] for e in entries)
        routes = "/".join(dict.fromkeys(e[4] for e in entries))
        print(f"  {group} [{len(entries)}] | {err:.3g} | {limit:.3g} | "
              f"{'pass' if ok else 'FAIL'} | {routes}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, reps=5, stream=None):
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    the graph replayed ``reps`` times between two CUDA events, so the
    Python cost of issuing each call is not in the number. ``stream``: the
    stream to warm up and capture on, where ``fn``'s work must run (an
    autograd backward runs on the stream of its forward)."""
    import torch

    with torch.cuda.stream(stream or torch.cuda.current_stream()):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)


def issue_ms(fn, iters=100, reps=1, stat=statistics.median):
    """Time per call of eager back-to-back calls between two CUDA events:
    the larger of the device time and the host's cost to issue the call;
    with ``reps`` > 1, ``stat`` (the median, or the least) of that many
    windows of ``iters`` calls (the host clock of a shared machine jumps
    from window to window)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return stat(times)


def host_ms(fn, iters=200, reps=9):
    """The host's own time per call to issue ``fn``: the least of ``reps``
    windows of ``iters`` back-to-back calls on the host clock, with no
    wait on the device inside a window (so a kernel longer than its issue
    does not set the number, as it does in :func:`issue_ms`)."""
    import torch

    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) / iters * 1e3)
    torch.cuda.synchronize()
    return min(times)


def bound(nbytes, flops, dtype_name):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def ln_input(torch, dev, gen, rows, hidden, dt, offset=0, scale=3.0,
             shift=0.5):
    """(rows, hidden) normal values * scale + shift in ``dt``; ``offset``
    > 0: a contiguous view that many elements into a fresh buffer, so the
    rows start off a 16-byte boundary."""
    v = (torch.randn(rows, hidden, device=dev, generator=gen) * scale
         + shift).to(dt)
    if not offset:
        return v
    buf = torch.empty(rows * hidden + offset, device=dev, dtype=dt)
    x = buf[offset:].view(rows, hidden)
    x.copy_(v)
    return x


def ln_aligned(*ts):
    """Every tensor's data on 16 bytes (``ln_route``'s ``aligned``)."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def ln_fwd_bound(rows, hidden):
    """(bound_ms, bound_by) of the bf16 forward with fp32 gamma/beta: x
    read, y written, gamma/beta read once, fp32 mean/rstd written; 8 fp32
    operations an element."""
    return bound(rows * hidden * 4 + hidden * 8 + rows * 8,
                 rows * hidden * 8, "float32")


def ln_times(torch, ops, dev):
    """Device times (ms) of the LayerNorm kernels through the port's entry
    points, bf16 rows of 1024 with fp32 gamma/beta: the forward at S (1024
    rows), at the decode shape (8 rows, with its eager issue per call: the
    least of 9 windows of 200 calls, the host's own cost with the least of
    a shared host's noise) and
    at T (8192 rows), and the backward at T (with dbeta). Takes any tree's
    ``ops``, so two trees can be compared in one run."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    hidden = 1024
    x = torch.randn(8192, hidden, device=dev, generator=gen).to(bf16)
    g = torch.randn(8192, hidden, device=dev, generator=gen).to(bf16)
    xs, x8 = x[:1024].clone(), x[:8].clone()
    w = torch.ones(hidden, device=dev)
    b = torch.zeros(hidden, device=dev)
    _, mean, rstd = ops.layer_norm_fwd(x, w, b)
    kw = dict(rms=False, has_bias=True)
    return {"S": time_ms(lambda: ops.layer_norm(xs, w, b)),
            "decode": time_ms(lambda: ops.layer_norm(x8, w, b)),
            "decode_issue": issue_ms(lambda: ops.layer_norm(x8, w, b),
                                     200, 9, min),
            "T": time_ms(lambda: ops.layer_norm(x, w, b)),
            "bwd_T": time_ms(
                lambda: ops.layer_norm_bwd(g, x, mean, rstd, w, **kw))}


def check_layer_norm(torch, ops, dev):
    """LayerNorm / RMSNorm forward kernel against its plain version on the
    same inputs. y: bf16 within one bf16 ulp of |ref| (both round the same
    fp32 value), fp32 within 1e-5; each row within the forward limit of
    :data:`ROW_TOL` (:func:`row_err`). The cases reach both routes
    (:func:`ln_route`): the warp route at 1000-2048 columns, with 1, 8 and
    33 rows (CTAs of ``LN_WARP_ROWS`` rows left part empty), RMS,
    no-bias and no-affine; the CTA route for rows of 1001 bf16 (off 16
    bytes), a view 2 bytes off a 16-byte boundary, and rows past
    ``LN_WARP_MAX_COLS`` (4096 and 8192 bf16, 16384 fp32). At T a tail of y rows
    halved must fail the row check and two calls must give the same bits.
    Then device times at S, the decode shape (with its eager issue) and T
    beside the plain version, ``F.layer_norm`` and the bound, and the warp
    route's rows a CTA and cap against the values tried
    (:func:`ln_fwd_tuning`)."""
    import importlib

    import torch.nn.functional as F

    tln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [  # rows, hidden, dtype, variant, offset (elements)
        (1024, 1024, bf16, "ln", 0), (8, 1024, bf16, "ln", 0),
        (1024, 1024, f32, "ln", 0), (1024, 1024, bf16, "rms", 0),
        (1024, 1024, bf16, "no-bias", 0), (8, 1024, f32, "no-affine", 0),
        (33, 1000, f32, "ln", 0), (5, 4096, bf16, "rms", 0),
        (8192, 1024, bf16, "ln", 0),
        # every route and edge: rows not a multiple of LN_WARP_ROWS, RMS
        # and no-affine on the warp route, unaligned rows, a view off 16
        # bytes, rows past the warp cap
        (1, 1024, bf16, "ln", 0), (33, 1024, bf16, "rms", 0),
        (33, 1024, bf16, "no-affine", 0), (33, 2048, f32, "ln", 0),
        (64, 1001, bf16, "ln", 0), (64, 1024, bf16, "ln", 1),
        (16, 8192, bf16, "ln", 0), (8, 16384, f32, "ln", 0),
    ]
    main_err = None
    for rows, hidden, dt, variant, offset in cases:
        x = ln_input(torch, dev, gen, rows, hidden, dt, offset)
        w = 1 + 0.1 * torch.randn(hidden, device=dev, generator=gen)
        b = 0.1 * torch.randn(hidden, device=dev, generator=gen)
        wv = None if variant == "no-affine" else w
        bv = b if variant == "ln" else None
        route = tln.ln_route(hidden, x.element_size(),
                             ln_aligned(x, wv, bv))
        if variant == "rms":
            got, ref = ops.rms_norm(x, w), ops.rms_norm_reference(x, w)
        else:
            got = ops.layer_norm(x, wv, bv)
            ref = ops.layer_norm_reference(x, wv, bv)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        e_row = row_err(got, ref)
        rlim = ROW_TOL[dt == bf16][0]
        label = (f"layer_norm {variant} {rows}x{hidden} {str(dt)[6:]}"
                 + (f" +{offset * x.element_size()}B" if offset else ""))
        grp = f"layer_norm_fwd {str(dt)[6:]}"
        if dt == bf16:
            # one bf16 ulp at |y|: both round the same fp32 value
            over = float(((got.float() - ref.float()).abs()
                          - ref.float().abs() * 2.0 ** -7 - 1e-6).max())
            tol = "1 bf16 ulp"
        else:
            tol = "1e-05"
        parts = [f"max_abs_err={err:.3g} (tol {tol})",
                 f"worst row {e_row:.3g} (tol {rlim:g})"]
        check(got.dtype == x.dtype, f"{label}: dtype")
        if dt == bf16:
            verdict(f"{label} over 1 bf16 ulp", max(over, 0.0), 0.0, route,
                    group=grp)
        else:
            verdict(label, err, 1e-5, route, group=grp)
        verdict(f"{label} row", e_row, rlim, route, group=grp)
        if (rows, hidden, dt, variant) == (8192, 1024, bf16, "ln"):
            # the row measure must catch a tail of rows gone half wrong
            bad = got.clone()
            bad[rows // 2:] *= 0.5
            planted = row_err(bad, ref)
            parts.append(f"y with its last {rows - rows // 2} rows halved: "
                         f"row {planted:.3g}")
            verdict(f"{label} halved y tail caught by the row check",
                    0 if planted > rlim else 1, 0, route, group=grp)
            y1, m1, r1 = ops.layer_norm_fwd(x, wv, bv)
            y2, m2, r2 = ops.layer_norm_fwd(x, wv, bv)
            torch.cuda.synchronize()
            same = (torch.equal(y1, y2) and torch.equal(m1, m2)
                    and torch.equal(r1, r2) and torch.equal(y1, got))
            parts.append(f"a second call bit-identical: {same}")
            verdict(f"{label} deterministic", 0 if same else 1, 0, route,
                    group=grp)
            del bad, y1, y2
        print(f"  {label} [{route}]: " + ", ".join(parts))
        if main_err is None:
            main_err = err
        del x, got, ref
    # timings at S (1024 rows x 1024), the decode shape and T, bf16, fp32
    # gamma/beta
    t = ln_times(torch, ops, dev)
    ms, ms8, issue8, ms_t = t["S"], t["decode"], t["decode_issue"], t["T"]
    hidden = 1024
    xt = torch.randn(8192, hidden, device=dev, generator=gen).to(bf16)
    x, x8 = xt[:1024].clone(), xt[:8].clone()
    w = torch.ones(hidden, device=dev)
    b = torch.zeros(hidden, device=dev)
    w16, b16 = w.to(bf16), b.to(bf16)
    plain = time_ms(lambda: ops.layer_norm_reference(x, w, b))
    lib = time_ms(lambda: F.layer_norm(x, (hidden,), w16, b16, 1e-5))
    lib8 = time_ms(lambda: F.layer_norm(x8, (hidden,), w16, b16, 1e-5))
    bms, by = ln_fwd_bound(1024, hidden)
    bms8, _ = ln_fwd_bound(8, hidden)
    print(f"  layer_norm timing (1024x1024 bf16): kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, F.layer_norm {lib:.4f} ms, bound {bms:.4f} ms "
          f"({by}); decode shape 8x1024: kernel {ms8:.4f} ms, eager issue (least "
          f"of 9 windows of 200 calls) "
          f"{issue8:.4f} ms per call, F.layer_norm {lib8:.4f} ms, bound "
          f"{bms8:.4f} ms")
    plain_t = time_ms(lambda: ops.layer_norm_reference(xt, w, b), 5)
    lib_t = time_ms(lambda: F.layer_norm(xt, (hidden,), w16, b16, 1e-5))
    bms_t, by_t = ln_fwd_bound(8192, hidden)
    print(f"  layer_norm timing at the training shape (8192x1024 bf16): "
          f"kernel {ms_t:.4f} ms, plain {plain_t:.4f} ms, F.layer_norm "
          f"{lib_t:.4f} ms, bound {bms_t:.4f} ms ({by_t}); {nvidia_smi()}")
    tuning = ln_fwd_tuning(torch, ops, tln, xt, w, b, gen)
    by_shape = {
        "S": dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms),
        "decode": dict(ms=ms8, issue_ms=issue8, library_ms=lib8,
                       bound_ms=bms8),
        "T": dict(ms=ms_t, plain_ms=plain_t, library_ms=lib_t,
                  bound_ms=bms_t)}
    return dict(name="layer_norm_fwd", route="cuda",
                kernel=f"ln_fwd_warp (one warp per row of up to "
                       f"LN_WARP_MAX_COLS = {tln.LN_WARP_MAX_COLS} aligned "
                       f"elements, {tln.LN_WARP_ROWS} rows a CTA), else "
                       f"ln_fwd_cta (a CTA per row)",
                source="apex_tpu_torch/csrc/layer_norm.cu",
                replaces="apex_tpu/ops/layer_norm.py:65",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib, by_shape=by_shape,
                ln_tuning=tuning)


def ln_fwd_tuning(torch, ops, tln, xt, w, b, gen, rows_tried=(2, 4, 8),
                  caps=(2048, 4096)):
    """The forward's warp route against the values tried: at T (``xt``)
    its rows a CTA (``LN_WARP_ROWS``) beside the CTA route; and its cap
    (``LN_WARP_MAX_COLS``): warp against CTA route at the same bytes as T
    with rows of 2048 and 4096 bf16 elements. One line; returned for the
    ``kernels`` line (``ln_tuning``)."""
    chosen = (tln.LN_WARP_ROWS, tln.LN_WARP_MAX_COLS)
    t_ms, cap_ms = {}, {}
    try:
        for r in rows_tried:
            tln.LN_WARP_ROWS = r
            t_ms[f"warp rows={r}"] = time_ms(lambda: ops.layer_norm(xt, w, b))
        tln.LN_WARP_ROWS = chosen[0]
        tln.LN_WARP_MAX_COLS = 0
        t_ms["cta"] = time_ms(lambda: ops.layer_norm(xt, w, b))
        for hidden in caps:
            x = torch.randn(xt.numel() // hidden, hidden, device=xt.device,
                            generator=gen).to(xt.dtype)
            wc = torch.ones(hidden, device=xt.device)
            bc = torch.zeros(hidden, device=xt.device)
            cap_ms[hidden] = {}
            for cap, route in ((max(caps), "warp"), (0, "cta")):
                tln.LN_WARP_MAX_COLS = cap
                check(tln.ln_route(hidden, 2, True) == route,
                      f"ln route {route} at {hidden}")
                cap_ms[hidden][route] = time_ms(
                    lambda: ops.layer_norm(x, wc, bc))
            del x
    finally:
        tln.LN_WARP_ROWS, tln.LN_WARP_MAX_COLS = chosen
    print(f"  LN_WARP_ROWS = {chosen[0]}, LN_WARP_MAX_COLS = {chosen[1]} "
          f"(chosen); forward ms at T (8192x1024 bf16): "
          + ", ".join(f"{k} {v:.4f}" for k, v in t_ms.items())
          + "; by route at T's bytes: " + "; ".join(
              f"{h} columns: " + ", ".join(f"{r} {v:.4f}"
                                          for r, v in t.items())
              for h, t in cap_ms.items()))
    return {"chosen": {"rows_per_cta": chosen[0], "max_cols": chosen[1]},
            "T_ms": t_ms, "cap_ms": cap_ms}


def causal_pairs(sq, sk):
    return sum(min(q + 1, sk) for q in range(sq))


def check_flash_attention(torch, ops, dev):
    """The resident forward (``flash_attention_fwd``, which
    ``flash_attention`` takes below STREAM_MIN_SEQ) against
    ``mha_reference`` / ``_lse_reference`` on the
    same inputs: o and lse, each by its share of max |ref| and by row
    (:func:`row_err`). o: 2e-2 in bf16 (P rounded to bf16 as an mma
    operand, then o) and 5e-5 in fp32, both as its largest absolute error
    and as a share of max |ref|, each row within the forward limit of
    :data:`ROW_TOL`; lse: :data:`LSE_TOL` (fp32 row statistics either
    way). The bf16 kernel is ``fwd_resident_wgmma``; the cases take
    it through ragged query tiles (sq = 1000, 130), sq > sk, sk > sq,
    d = 128, d <= 32 and d = 40 (TMA zero-fills the columns past d), d = 36
    (the wrapper's padded copy) and the strided fused-QKV view TMA reads as
    it is. At T a tail of o rows halved must fail the row check; two calls
    at T and at (1,2,300,77) must give the same bits. Then the tiles and the
    schedule against the values tried (:func:`res_fwd_tuning`) and device
    times at S and T beside the bound, the plain version, the streamed
    forward at the same shape and SDPA."""
    import importlib

    import torch.nn.functional as F

    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(2)

    def run(q, k, v, causal, label, plant=False, twice=False):
        dt = q.dtype
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        scale = q.shape[-1] ** -0.5
        o_ref = ops.mha_reference(q, k, v, causal=causal)
        lse_ref = tfa._lse_reference(q, k, causal, scale)
        check(o.dtype == dt and o.shape == q.shape and lse.shape == q.shape[:3]
              and lse.dtype == f32, f"flash_attention {label}: dtype/shape")
        grp = f"flash_attention_fwd {str(dt)[6:]}"
        tol = 2e-2 if dt == bf16 else 5e-5
        rtol = ROW_TOL[dt == bf16][0]
        # o's absolute error is held to tol as well as its share of max|ref|
        verdict(f"flash_attention {label} o", max_err(o, o_ref), tol,
                group=grp)
        parts = []
        for name, got, ref, lim, rlim, floor in (
                ("o", o, o_ref, tol, rtol, 1e-3),
                ("lse", lse[..., None], lse_ref[..., None], *LSE_TOL)):
            e, e_row = rel_err(got, ref), row_err(got, ref, floor)
            parts.append(f"{name} {max_err(got, ref):.3g} (rel {e:.3g}, tol "
                         f"{lim:g}; worst row {e_row:.3g}, tol {rlim:g})")
            verdict(f"flash_attention {label} {name} of max|ref|", e, lim,
                    group=grp)
            verdict(f"flash_attention {label} {name} row", e_row, rlim,
                    group=grp)
        if plant:
            # the row measure must catch a tail of rows gone half wrong,
            # which the share of max|ref| lets through
            sq = q.shape[2]
            bad = o.clone()
            bad[:, :, sq // 2:] *= 0.5
            planted = row_err(bad, o_ref)
            parts.append(f"o with its last {sq - sq // 2} rows halved: row "
                         f"{planted:.3g}, of max|ref| "
                         f"{rel_err(bad, o_ref):.3g}")
            verdict(f"flash_attention {label} halved o tail caught by the "
                    f"row check", 0 if planted > rtol else 1, 0, group=grp)
            del bad
        if twice:
            o2, lse2 = ops.flash_attention_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            parts.append(f"a second call bit-identical: {same}")
            verdict(f"flash_attention {label} deterministic", 0 if same else 1,
                    0, group=grp)
        print(f"  flash_attention {label}: " + ", ".join(parts))
        return max_err(o, o_ref)

    cases = [  # b, h, sq, sk, d, dtype, causal
        (1, 16, 1024, 1024, 64, bf16, True),
        (8, 16, 1024, 1024, 64, bf16, True),
        (1, 16, 1024, 1024, 64, f32, True),
        (4, 16, 1024, 1024, 64, f32, True),    # F: the O0 pretrain's
        (1, 4, 256, 256, 128, f32, True),      # the 128-wide fp32 instance
        (1, 2, 64, 64, 16, f32, True),
        (1, 16, 1024, 1024, 64, bf16, False),
        (2, 3, 1000, 1000, 64, f32, True),
        (2, 3, 1000, 1000, 64, bf16, True),    # a ragged last query tile
        (2, 3, 77, 300, 64, f32, False),
        (1, 2, 300, 77, 64, f32, True),
        (2, 4, 256, 256, 128, bf16, True),
        (1, 4, 1000, 1000, 128, bf16, True),   # d = 128, ragged
        (1, 4, 130, 130, 40, f32, True),
        (1, 4, 130, 130, 40, bf16, True),      # TMA zero-fills 40..63
        (2, 2, 100, 120, 36, bf16, False),     # 72-byte rows: the padded copy
        (1, 2, 64, 64, 16, bf16, True),
        (1, 2, 300, 77, 64, bf16, True),       # sq > sk
        (2, 3, 77, 300, 64, bf16, False),      # sk > sq
    ]
    main_err = None
    for b, h, sq, sk, d, dt, causal in cases:
        q = torch.randn(b, h, sq, d, device=dev, generator=gen).to(dt)
        k = torch.randn(b, h, sk, d, device=dev, generator=gen).to(dt)
        v = torch.randn(b, h, sk, d, device=dev, generator=gen).to(dt)
        at_t = (b, sq, dt) in ((8, 1024, bf16), (4, 1024, f32))
        ragged = (b, h, sq, sk, causal) == (1, 2, 300, 77, True)
        err = run(q, k, v, causal, f"({b},{h},{sq},{sk},{d}) {str(dt)[6:]} "
                  f"causal={causal}", plant=at_t, twice=at_t or ragged)
        if main_err is None:
            main_err = err
    # fp32 d = 36 as views one column into 40-wide rows: bases off 16 bytes,
    # so the fp32 kernel takes its 4-byte copies
    q, k, v = (torch.randn(2, 2, n, 40, device=dev, generator=gen)[..., 1:37]
               for n in (100, 120, 120))
    run(q, k, v, False, "(2,2,100,120,36) fp32 causal=False, views off 16 "
        "bytes (4-byte copies)")
    # a fused-QKV view (strided heads) goes in without a copy
    for dt in (bf16, f32):
        qkv = torch.randn(1, 128, 4, 3, 64, device=dev, generator=gen).to(dt)
        qkv = qkv.permute(0, 2, 3, 1, 4)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if dt == bf16:
            check(all(tfa._tma_ok(t) for t in (q, k, v)), "the fused-QKV "
                  "view is one TMA reads as it is")
        run(q, k, v, True, f"strided fused-QKV view (1,4,128,64) "
            f"{str(dt)[6:]} causal")
    del q, k, v, qkv

    out = {}
    for label, b in (("S", 1), ("T", 8)):
        h, s, d = 16, 1024, 64
        q, k, v = (torch.randn(b, h, s, d, device=dev, generator=gen).to(bf16)
                   for _ in range(3))
        if label == "T":
            tuning = res_fwd_tuning(torch, ops, tfa, (q, k, v))
        t = dict(ms=time_ms(lambda: ops.flash_attention_fwd(q, k, v,
                                                            causal=True)))
        t["plain_ms"] = time_ms(lambda: ops.mha_reference(q, k, v,
                                                          causal=True),
                                *((5, 5) if b == 1 else (2, 2)))
        t["stream_ms"] = time_ms(lambda: ops.flash_attention_fwd_stream(
            q, k, v, causal=True))
        t["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        flops = 4 * b * h * d * causal_pairs(s, s)
        t["bound_ms"], t["bound_by"] = bound(
            4 * b * h * s * d * 2 + b * h * s * 4, flops, "bfloat16")
        print(f"  flash_attention timing {label} ({b},{h},{s},{d}) bf16 "
              f"causal: kernel {t['ms']:.4f} ms ({flops / t['ms'] / 1e9:.1f} "
              f"TFLOP/s), bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"plain {t['plain_ms']:.4f} ms, the streamed forward "
              f"{t['stream_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms; "
              f"{nvidia_smi()}")
        out[label] = t
        del q, k, v
    torch.cuda.empty_cache()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    names = []
    for label, b in (("S", 1), ("T", 8)):
        bq, bk = tfa._res_fwd_tiles(1024, b * 16, 64, sms)
        names.append(f"{label}: fwd_resident_wgmma<64, {bk}, {bq // 64}>")
    sched = "persistent" if tfa.RES_FWD_PERSISTENT else "plain grid"
    fo, fi, _ = tfa._res_fwd_f32_tiles(64)
    f32_name = (f"fp32: fwd_f32_blocked<64, {fo // 16}, {fi}> (register-"
                f"blocked FMA fed by a cp.async ring, one CTA per whole band, "
                f"plain grid, fp32 o stored once; "
                f"csrc/flash_f32_blocked.cuh)")
    return dict(name="flash_attention_fwd", route="cuda",
                kernel=f"{'; '.join(names)} (wgmma fed by a TMA ring, one "
                       f"CTA per whole band, {sched}, o stored once by TMA); "
                       f"{f32_name}",
                source="apex_tpu_torch/csrc/flash_attention.cu",
                replaces="apex_tpu/ops/flash_attention.py:251",
                max_abs_err=main_err, by_shape=out, res_fwd_tuning=tuning,
                **{k: out["S"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")})


def res_fwd_tuning(torch, ops, tfa, args, inner=(64, 128), outer=(128, 64)):
    """The schedule and the tiles of the bf16 resident forward
    (RES_FWD_PERSISTENT, RES_FWD_OUTER_TILE / RES_FWD_INNER_TILE and
    RES_FWD_FEW_ITEMS_TILES where those items are fewer than the SMs)
    against the values tried: device times at T (``args``) and at S (its
    first batch row) for the plain grid and the persistent one, query tiles
    of 128 and 64 rows and key tiles of 64 and 128, on one line, with the
    tiles the rule takes at each; returned for the ``kernels`` line
    (``res_fwd_tuning``)."""
    chosen = (tfa.RES_FWD_PERSISTENT, tfa.RES_FWD_INNER_TILE,
              tfa.RES_FWD_OUTER_TILE, tfa.RES_FWD_FEW_ITEMS_TILES)
    shapes = {"T": args, "S": tuple(t[:1].contiguous() for t in args)}
    props = torch.cuda.get_device_properties(args[0].device)
    sms = props.multi_processor_count
    picks = {label: tfa._res_fwd_tiles(q.shape[2], q.shape[0] * q.shape[1],
                                       q.shape[3], sms)
             for label, (q, _, _) in shapes.items()}
    times = {}
    tfa.RES_FWD_FEW_ITEMS_TILES = None
    try:
        for label, (q, k, v) in shapes.items():
            t = times[label] = {}
            for persistent in (False, True):
                tfa.RES_FWD_PERSISTENT = persistent
                for bo in outer:
                    tfa.RES_FWD_OUTER_TILE = bo
                    for bn in inner:
                        tfa.RES_FWD_INNER_TILE = bn
                        key = (f"{'persistent' if persistent else 'grid'} "
                               f"q{bo} k{bn}")
                        t[key] = time_ms(lambda: ops.flash_attention_fwd(
                            q, k, v, causal=True))
    finally:
        (tfa.RES_FWD_PERSISTENT, tfa.RES_FWD_INNER_TILE,
         tfa.RES_FWD_OUTER_TILE, tfa.RES_FWD_FEW_ITEMS_TILES) = chosen
    taken = ", ".join(f"{label} q{bq} k{bk}"
                      for label, (bq, bk) in picks.items())
    print(f"  RES_FWD_PERSISTENT = {chosen[0]}, RES_FWD_OUTER_TILE = "
          f"{chosen[2]}, RES_FWD_INNER_TILE = {chosen[1]}, "
          f"RES_FWD_FEW_ITEMS_TILES = {chosen[3]} (chosen; taken: {taken}, "
          f"{sms} SMs); ms by schedule, query tile and key tile: "
          + "; ".join(f"{label}: " + ", ".join(f"{k} {v:.4f}"
                                               for k, v in t.items())
                      for label, t in times.items()))
    return {"chosen": {"persistent": chosen[0], "outer_tile": chosen[2],
                       "inner_tile": chosen[1],
                       "few_items_tiles": chosen[3]},
            "taken": {k: list(v) for k, v in picks.items()}, "ms": times}


def rel_err(got, ref):
    """max |got - ref| over max |ref|, both in fp32."""
    return max_err(got, ref) / max(float(ref.float().abs().max()), 1e-30)


def row_err(got, ref, floor=1e-3):
    """The worst row's ||got - ref||_2 / ||ref||_2 (rows along the last
    axis, heads along the one before, in fp32). A row's norm is floored at
    ``floor`` of the largest in its head, so a row whose exact value cancels
    (dQ of a query that sees one key) is held to its head's scale and not
    to its rounding noise; a row whose reference is exactly 0 must be 0."""
    g, r = got.float(), ref.float()
    den = r.norm(dim=-1)
    den = den.maximum(den.amax(dim=-1, keepdim=True) * floor)
    num = (g - r).norm(dim=-1)
    return float((num / den.clamp_min(1e-30)).max())


def check_layer_norm_bwd(torch, ops, dev):
    """LayerNorm backward kernel against ``layer_norm_bwd_reference`` on the
    same g, x and the forward kernel's mean/rstd. Tolerances, as a share of
    max |ref|: dx 2^-7 in bf16 (one bf16 ulp at the top: both round the same
    fp32 value) and 1e-5 in fp32; dgamma/dbeta 1e-4 (fp32 sums over the
    rows in another order); and each dx row within the backward limit of
    :data:`ROW_TOL` (:func:`row_err`). The cases reach both routes
    (:func:`ln_route` with ``backward=True``): the warp route at T (LN,
    RMS), with 1 and 33 rows, no-affine and no-bias; the CTA route for rows
    of 1001 bf16, a view 2 bytes off a 16-byte boundary and rows past
    ``LN_BWD_WARP_MAX_COLS`` (2048 and 8192 bf16, 16384 fp32). At T a tail
    of dx rows halved must fail the row check and two calls must give the
    same bits of dx, dgamma and dbeta. Then the device time at T (the
    kernel and its dgamma/dbeta finish) beside the plain version,
    ``aten.native_layer_norm_backward`` and the bound, and the warp route's
    warps a CTA, CTAs an SM and cap against the values tried
    (:func:`ln_bwd_tuning`)."""
    import importlib

    tln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [  # rows, hidden, dtype, variant, offset (elements)
        (8192, 1024, bf16, "ln", 0), (8192, 1024, f32, "ln", 0),
        (8192, 1024, bf16, "rms", 0), (1024, 1024, bf16, "no-affine", 0),
        (1024, 1024, bf16, "no-bias", 0), (33, 1000, f32, "ln", 0),
        (33, 1000, bf16, "rms", 0),
        # every route and edge: rows not a multiple of LN_BWD_WARP_ROWS,
        # unaligned rows, a view off 16 bytes, rows past the warp cap
        (1, 1024, bf16, "ln", 0), (33, 1024, bf16, "ln", 0),
        (33, 1024, bf16, "no-affine", 0), (64, 1001, bf16, "ln", 0),
        (64, 1024, bf16, "ln", 1), (4096, 2048, bf16, "ln", 0),
        (16, 8192, bf16, "ln", 0), (8, 16384, f32, "rms", 0),
    ]
    main_err = None
    for rows, hidden, dt, variant, offset in cases:
        x = ln_input(torch, dev, gen, rows, hidden, dt, offset)
        g = ln_input(torch, dev, gen, rows, hidden, dt, offset, 1.0, 0.0)
        w = 1 + 0.1 * torch.randn(hidden, device=dev, generator=gen)
        b = 0.1 * torch.randn(hidden, device=dev, generator=gen)
        rms = variant == "rms"
        wv = None if variant == "no-affine" else w
        bv = b if variant == "ln" else None
        route = tln.ln_route(hidden, x.element_size(), ln_aligned(x, g, wv),
                             backward=True)
        _, mean, rstd = ops.layer_norm_fwd(x, wv, bv, rms=rms)
        kw = dict(rms=rms, has_bias=bv is not None)
        got = ops.layer_norm_bwd(g, x, mean, rstd, wv, **kw)
        ref = ops.layer_norm_bwd_reference(g, x, mean, rstd, wv, **kw)
        torch.cuda.synchronize()
        tol_dx = 2.0 ** -7 if dt == bf16 else 1e-5
        rlim = ROW_TOL[dt == bf16][1]
        label = (f"layer_norm_bwd {variant} {rows}x{hidden} {str(dt)[6:]}"
                 + (f" +{offset * x.element_size()}B" if offset else ""))
        grp = f"layer_norm_bwd {str(dt)[6:]}"
        errs = []
        for name, a, r, tol in (("dx", got[0], ref[0], tol_dx),
                                ("dgamma", got[1], ref[1], 1e-4),
                                ("dbeta", got[2], ref[2], 1e-4)):
            check((a is None) == (r is None), f"{label} {name} presence")
            if a is None:
                continue
            e = rel_err(a, r)
            errs.append(f"{name} {max_err(a, r):.3g} (rel {e:.3g}, tol "
                        f"{tol:g})")
            verdict(f"{label} {name}", e, tol, route, group=grp)
        e_row = row_err(got[0], ref[0])
        errs.append(f"dx worst row {e_row:.3g} (tol {rlim:g})")
        verdict(f"{label} dx row", e_row, rlim, route, group=grp)
        check(got[0].dtype == dt, f"{label} dx dtype")
        if (rows, hidden, dt, variant) == (8192, 1024, bf16, "ln"):
            # the row measure must catch a tail of dx rows gone half wrong
            bad = got[0].clone()
            bad[rows // 2:] *= 0.5
            planted = row_err(bad, ref[0])
            errs.append(f"dx with its last {rows - rows // 2} rows halved: "
                        f"row {planted:.3g}, of max|ref| "
                        f"{rel_err(bad, ref[0]):.3g}")
            verdict(f"{label} halved dx tail caught by the row check",
                    0 if planted > rlim else 1, 0, route, group=grp)
            again = ops.layer_norm_bwd(g, x, mean, rstd, wv, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            errs.append(f"a second call bit-identical (dx, dgamma, dbeta): "
                        f"{same}")
            verdict(f"{label} deterministic", 0 if same else 1, 0, route,
                    group=grp)
            del bad, again
        print(f"  {label} [{route}]: " + ", ".join(errs))
        if main_err is None:
            main_err = max_err(got[0], ref[0])
        del x, g, got, ref
    # timing at the training shape: 8192 x 1024 bf16, fp32 gamma/beta
    rows, hidden = 8192, 1024
    x = torch.randn(rows, hidden, device=dev, generator=gen).to(bf16)
    g = torch.randn(rows, hidden, device=dev, generator=gen).to(bf16)
    w = torch.ones(hidden, device=dev)
    b = torch.zeros(hidden, device=dev)
    _, mean, rstd = ops.layer_norm_fwd(x, w, b)
    kw = dict(rms=False, has_bias=True)
    ms = time_ms(lambda: ops.layer_norm_bwd(g, x, mean, rstd, w, **kw))
    plain = time_ms(
        lambda: ops.layer_norm_bwd_reference(g, x, mean, rstd, w, **kw), 5)
    w16, b16 = w.to(bf16), b.to(bf16)
    _, amean, arstd = torch.native_layer_norm(x, (hidden,), w16, b16, 1e-5)
    lib = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        g, x, [hidden], amean, arstd, w16, b16, [True, True, True]))
    nbytes = rows * hidden * 2 * 3 + rows * 4 * 2 + hidden * 4 * 3
    bms, by = bound(nbytes, rows * hidden * 13, "float32")
    split = ln_bwd_split(torch, ops, tln, (g, x, mean, rstd, w), kw)
    print(f"  layer_norm_bwd timing (8192x1024 bf16, fp32 gamma/beta): "
          f"kernel + dgamma/dbeta finish {ms:.4f} ms ({split['line']}), "
          f"plain {plain:.4f} ms, aten.native_layer_norm_backward (bf16 "
          f"gamma) {lib:.4f} ms, bound {bms:.4f} ms ({by}); {nvidia_smi()}")
    tuning = ln_bwd_tuning(torch, ops, tln, (g, x, mean, rstd, w), kw, gen)
    tuning["T_split"] = split["ms"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return dict(name="layer_norm_bwd", route="cuda",
                kernel=f"ln_bwd_warp (one warp per row of up to "
                       f"LN_BWD_WARP_MAX_COLS = {tln.LN_BWD_WARP_MAX_COLS} "
                       f"aligned elements, {tln.LN_BWD_WARP_ROWS} warps a "
                       f"CTA, {tln.ln_bwd_grid(rows, 'warp', sms)} CTAs at "
                       f"T) + ln_bwd_finish; else ln_bwd_cta (32 rows a "
                       f"CTA) + ln_bwd_finish",
                source="apex_tpu_torch/csrc/layer_norm.cu",
                replaces="apex_tpu/ops/layer_norm.py:85",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib, ln_tuning=tuning)


def ln_bwd_split(torch, ops, tln, args, kw):
    """At T: the backward's two kernels' device times in one profiled call
    (the main kernel and ``ln_bwd_finish``), beside ``parts.sum(1)`` of
    partial rows of the same shape (the library sum the finish replaces),
    timed like the kernels."""
    from torch.profiler import ProfilerActivity, profile

    g = args[0]
    for _ in range(3):
        ops.layer_norm_bwd(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ops.layer_norm_bwd(*args, **kw)
        torch.cuda.synchronize()
    by_name = device_time_by_kernel(torch, prof)
    n_f, t_f = kernel_time(by_name, "ln_bwd_finish")
    n_k, t_k = kernel_time(by_name, "ln_bwd_warp", "ln_bwd_cta")
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    grid = tln.ln_bwd_grid(g.shape[0], tln.ln_route(
        g.shape[-1], g.element_size(), True, backward=True), sms)
    parts = torch.randn(2, grid, g.shape[-1], device=g.device)
    t_sum = time_ms(lambda: parts.sum(1))
    ms = {"kernel": t_k / max(n_k, 1), "finish": t_f / max(n_f, 1),
          "parts_sum": t_sum, "parts": grid}
    line = (f"profiled: kernel {ms['kernel']:.4f} ms + finish "
            f"{ms['finish']:.4f} ms over {grid} partial rows; parts.sum(1) "
            f"of the same {t_sum:.4f} ms")
    return {"ms": ms, "line": line}


def ln_bwd_tuning(torch, ops, tln, args, kw, gen,
                  shapes=((4, 2), (4, 3), (8, 1), (8, 2)), cap=2048):
    """The backward's warp route against the values tried, at T: warps a
    CTA and CTAs an SM (``LN_BWD_WARP_ROWS``, ``LN_BWD_CTAS_PER_SM``),
    beside the CTA route; and its cap (``LN_BWD_WARP_MAX_COLS``): warp
    against CTA route at T's bytes with rows of 2048 bf16 elements. Each
    time includes the dgamma/dbeta finish. One line; returned for the
    ``kernels`` line (``ln_tuning``)."""
    chosen = (tln.LN_BWD_WARP_ROWS, tln.LN_BWD_CTAS_PER_SM,
              tln.LN_BWD_WARP_MAX_COLS)
    g = args[0]
    t_ms, cap_ms = {}, {}
    try:
        for warps, per_sm in shapes:
            tln.LN_BWD_WARP_ROWS, tln.LN_BWD_CTAS_PER_SM = warps, per_sm
            t_ms[f"warp {warps} warps x {per_sm} CTAs/SM"] = time_ms(
                lambda: ops.layer_norm_bwd(*args, **kw))
        tln.LN_BWD_WARP_ROWS, tln.LN_BWD_CTAS_PER_SM = chosen[:2]
        tln.LN_BWD_WARP_MAX_COLS = 0
        t_ms["cta"] = time_ms(lambda: ops.layer_norm_bwd(*args, **kw))
        rows = g.numel() // cap
        x2 = torch.randn(rows, cap, device=g.device,
                         generator=gen).to(g.dtype)
        g2 = torch.randn(rows, cap, device=g.device,
                         generator=gen).to(g.dtype)
        w2 = torch.ones(cap, device=g.device)
        _, m2, r2 = ops.layer_norm_fwd(x2, w2, None)
        for c, route in ((cap, "warp"), (0, "cta")):
            tln.LN_BWD_WARP_MAX_COLS = c
            check(tln.ln_route(cap, 2, True, backward=True) == route,
                  f"ln bwd route {route} at {cap}")
            cap_ms[route] = time_ms(
                lambda: ops.layer_norm_bwd(g2, x2, m2, r2, w2, **kw))
        del x2, g2
    finally:
        (tln.LN_BWD_WARP_ROWS, tln.LN_BWD_CTAS_PER_SM,
         tln.LN_BWD_WARP_MAX_COLS) = chosen
    print(f"  LN_BWD_WARP_ROWS = {chosen[0]}, LN_BWD_CTAS_PER_SM = "
          f"{chosen[1]}, LN_BWD_WARP_MAX_COLS = {chosen[2]} (chosen); "
          f"backward ms at T (8192x1024 bf16, with the finish): "
          + ", ".join(f"{k} {v:.4f}" for k, v in t_ms.items())
          + f"; at T's bytes with {cap} columns: "
          + ", ".join(f"{r} {v:.4f}" for r, v in cap_ms.items()))
    return {"chosen": {"warps": chosen[0], "ctas_per_sm": chosen[1],
                       "max_cols": chosen[2]},
            "T_ms": t_ms, "cap_ms": {cap: cap_ms}}


def check_flash_attention_bwd(torch, ops, dev):
    """Flash backward kernels (dQ, dK/dV) against
    ``flash_attention_bwd_reference`` on the same q, k, v, dO and the
    forward kernel's o/lse. Each gradient is held twice. As a share of max
    |ref|: 1e-2 in bf16 (P and dS are rounded to bf16 as wgmma operands,
    and each output once more) and 1e-4 in fp32 (fp32 sums in another
    order). The worst row's own error (:func:`row_err`) to the backward
    limit of :data:`ROW_TOL`, as the streamed kernels are held: at T a
    tail of dQ rows halved must fail it. Two calls at T and at the ragged
    (1,2,300,77) case must give the same bits (each gradient is written
    once, with no atomics). The bf16 kernels are the resident wgmma pair;
    the cases take them through d = 128, d <= 32, d = 40 (TMA zero-fills
    the columns past d), d = 36 (the wrappers' padded copies), cross shapes
    and the fused-QKV view TMA reads as it is. Then the schedule and the
    dQ inner tile against the values tried (:func:`res_bwd_tuning`) and
    device times at T beside the bound, the plain version, the streamed
    pair, SDPA's backward and the FlashAttention-2 backward op."""
    import importlib

    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(6)

    def grads(q, k, v, do, lse, delta, kw):
        dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        return (dq, *ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 **kw))

    def run(q, k, v, causal, label, plant=False, twice=False):
        do = torch.randn(q.shape, device=dev, generator=gen).to(q.dtype)
        scale = q.shape[-1] ** -0.5
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
        delta = (o.float() * do.float()).sum(-1)
        kw = dict(causal=causal, scale=scale)
        got = grads(q, k, v, do, lse, delta, kw)
        ref = ops.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        tol = 1e-2 if q.dtype == bf16 else 1e-4
        rtol = ROW_TOL[q.dtype == bf16][1]
        grp = f"flash_attention_bwd {str(q.dtype)[6:]}"
        parts = []
        worst = 0.0
        for name, a, r in zip(("dQ", "dK", "dV"), got, ref):
            check(a.dtype == q.dtype and a.shape == r.shape,
                  f"flash bwd {label} {name} dtype/shape")
            e, e_row = rel_err(a, r), row_err(a, r)
            worst = max(worst, max_err(a, r))
            parts.append(f"{name} {max_err(a, r):.3g} (rel {e:.3g}, worst "
                         f"row {e_row:.3g})")
            verdict(f"flash_attention_bwd {label} {name}", e, tol, group=grp)
            verdict(f"flash_attention_bwd {label} {name} row", e_row, rtol,
                    group=grp)
        if plant:
            # the row measure must catch a tail of rows gone half wrong,
            # which the share of max|ref| lets through
            sq = q.shape[2]
            bad = got[0].clone()
            bad[:, :, sq // 2:] *= 0.5
            planted = row_err(bad, ref[0])
            parts.append(f"dQ with its last {sq - sq // 2} rows halved: row "
                         f"{planted:.3g}, of max|ref| "
                         f"{rel_err(bad, ref[0]):.3g}")
            verdict(f"flash_attention_bwd {label} halved dQ tail caught by "
                    f"the row check", 0 if planted > rtol else 1, 0,
                    group=grp)
            del bad
        if twice:
            again = grads(q, k, v, do, lse, delta, kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            parts.append(f"a second call bit-identical: {same}")
            verdict(f"flash_attention_bwd {label} deterministic",
                    0 if same else 1, 0, group=grp)
        print(f"  flash_attention_bwd {label} " + ", ".join(parts)
              + f" (tol {tol:g} of max|ref|, row {rtol:g})")
        return worst

    cases = [  # b, h, sq, sk, d, dtype, causal
        (8, 16, 1024, 1024, 64, bf16, True),
        (8, 16, 1024, 1024, 64, f32, True),
        (4, 16, 1024, 1024, 64, f32, True),    # F: the O0 pretrain's shape
        (2, 16, 1024, 1024, 64, bf16, False),
        (2, 3, 77, 300, 64, bf16, False),
        (1, 2, 300, 77, 64, bf16, True),
        (2, 3, 77, 300, 64, f32, True),
        (1, 2, 300, 77, 64, f32, False),
        (2, 4, 256, 256, 128, bf16, True),
        (1, 4, 130, 130, 40, bf16, True),
        (2, 2, 100, 120, 36, bf16, False),
        (1, 4, 130, 130, 40, f32, True),
        (2, 3, 200, 150, 32, bf16, True),      # d <= 32: the 64-wide kernels
        (1, 4, 256, 256, 128, f32, True),      # fp32: the 128-wide kernels
        (2, 3, 100, 120, 36, f32, False),
        (2, 3, 200, 150, 16, f32, True),
        (2, 2, 90, 70, 6, f32, True),          # fp32: 4-byte copies
    ]
    main_err = None
    for b, h, sq, sk, d, dt, causal in cases:
        q = torch.randn(b, h, sq, d, device=dev, generator=gen).to(dt)
        k = torch.randn(b, h, sk, d, device=dev, generator=gen).to(dt)
        v = torch.randn(b, h, sk, d, device=dev, generator=gen).to(dt)
        at_t = (b, sq, dt) == (8, 1024, bf16) or (b, sq, dt) == (4, 1024,
                                                                  f32)
        ragged = (b, h, sq, sk) == (1, 2, 300, 77)
        err = run(q, k, v, causal, f"b={b} h={h} sq={sq} sk={sk} d={d} "
                  f"{str(dt)[6:]} causal={causal}", plant=at_t,
                  twice=at_t or ragged)
        if main_err is None:
            main_err = err
    # a fused-QKV view (strided heads), as the model hands them over
    for dt in (bf16, f32):
        qkv = torch.randn(2, 256, 4, 3, 64, device=dev, generator=gen).to(dt)
        qkv = qkv.permute(0, 2, 3, 1, 4)
        run(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], True,
            f"strided fused-QKV view (2,4,256,64) {str(dt)[6:]} causal")
    # fp32 rows off 16 bytes (a view one element in): the 4-byte copies
    wide = torch.randn(3, 2, 2, 150, 65, device=dev, generator=gen)
    run(wide[0, ..., 1:], wide[1, ..., 1:], wide[2, ..., 1:], False,
        "views off 16 bytes (2,2,150,64) float32 non-causal")
    f32_tuning = res_bwd_f32_tuning(torch, ops, tfa, dev, gen)

    b, h, s, d = 8, 16, 1024, 64
    q, k, v, do = (torch.randn(b, h, s, d, device=dev, generator=gen).to(bf16)
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    delta = (o.float() * do.float()).sum(-1)
    kw = dict(causal=True, scale=scale)
    tuning = res_bwd_tuning(torch, ops, tfa, (q, k, v, do, lse, delta), kw)
    ms_dq = time_ms(
        lambda: ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw))
    ms_dkv = time_ms(
        lambda: ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
    plain = time_ms(lambda: ops.flash_attention_bwd_reference(
        q, k, v, o, lse, do, **kw), 2, 2)
    st_dq = time_ms(lambda: ops.flash_attention_bwd_dq_stream(
        q, k, v, do, lse, delta, **kw))
    st_dkv = time_ms(lambda: ops.flash_attention_bwd_dkv_stream(
        q, k, v, do, lse, delta, **kw))
    # yardstick: SDPA's backward, autograd.grad of one causal SDPA output
    # over q, k, v, captured and replayed like the kernels (the forward runs
    # on the capture stream, so its backward does too)
    import torch.nn.functional as F

    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    torch.cuda.synchronize()
    sdpa_grad = (lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                             retain_graph=True))
    lib_pair = time_ms(sdpa_grad, stream=side)
    backend = type(out.grad_fn).__name__
    # the same for SDPA's FlashAttention-2 backend: its backward op called
    # directly on the outputs of its forward op
    aten = torch.ops.aten
    (lo, llse, cq, ck, mq, mk, seed, off, _) = \
        aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True, False)
    flash_op = aten._scaled_dot_product_flash_attention_backward
    fa2_ms = time_ms(lambda: flash_op(do, q, k, v, lo, llse, cq, ck, mq, mk,
                                      0.0, True, seed, off))
    # host-issue figures: eager calls between CUDA events
    lib_eager = issue_ms(sdpa_grad, 20)
    pair_eager = issue_ms(lambda: (
        ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
        ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)), 20)
    pairs = causal_pairs(s, s) * b * h
    elems = b * h * s * d
    dq_bound = bound(5 * elems * 2 + 2 * b * h * s * 4, 6 * d * pairs,
                     "bfloat16")
    dkv_bound = bound(6 * elems * 2 + 2 * b * h * s * 4, 8 * d * pairs,
                      "bfloat16")
    pair_ms = ms_dq + ms_dkv
    print(f"  flash_attention_bwd timing (8,16,1024,64) bf16 causal: dQ "
          f"{ms_dq:.4f} ms ({6 * d * pairs / ms_dq / 1e9:.1f} TFLOP/s, bound "
          f"{dq_bound[0]:.4f} ms {dq_bound[1]}), dK/dV {ms_dkv:.4f} ms "
          f"({8 * d * pairs / ms_dkv / 1e9:.1f} TFLOP/s, bound "
          f"{dkv_bound[0]:.4f} ms {dkv_bound[1]}), pair {pair_ms:.4f} ms "
          f"({14 * d * pairs / pair_ms / 1e9:.1f} TFLOP/s, bound "
          f"{dq_bound[0] + dkv_bound[0]:.4f} ms), plain (both) {plain:.4f} "
          f"ms; the streamed pair {st_dq:.4f} + {st_dkv:.4f} = "
          f"{st_dq + st_dkv:.4f} ms; SDPA backward (dQ, dK, dV; "
          f"autograd.grad through {backend}) {lib_pair:.4f} ms, the "
          f"FlashAttention-2 backward op {fa2_ms:.4f} ms; eager between CUDA "
          f"events (host cost): the pair {pair_eager:.4f} ms, SDPA's "
          f"autograd.grad {lib_eager:.4f} ms; {nvidia_smi()}")
    common = dict(route="cuda", source="apex_tpu_torch/csrc/"
                  "flash_attention_bwd.cu", max_abs_err=main_err,
                  plain_ms=plain, library_ms=lib_pair,
                  res_bwd_tuning=tuning, res_bwd_f32_tuning=f32_tuning)
    f32_tiles = {p: tfa._res_bwd_tiles(False, p == "dq", 64)
                 for p in ("dq", "dkv")}
    blocked = ("register-blocked FMA fed by a cp.async ring, "
               + ("persistent" if tfa.RES_BWD_F32_PERSISTENT else "plain")
               + " grid, fp32 stored once")
    ring = ("wgmma fed by a TMA ring, one CTA per whole band, "
            + ("persistent" if tfa.RES_BWD_PERSISTENT else "plain")
            + " grid, bf16 stored once by TMA")
    return [dict(common, name="flash_attention_bwd_dq",
                 kernel=f"dq_resident_wgmma<64, {tfa.RES_BWD_DQ_INNER_TILE}>"
                        f" ({ring}); fp32 dq_f32_blocked<64, "
                        f"{f32_tiles['dq'][0] // 16}, {f32_tiles['dq'][1]}> "
                        f"({blocked})",
                 replaces="apex_tpu/ops/flash_attention.py:328", ms=ms_dq,
                 bound_ms=dq_bound[0], bound_by=dq_bound[1]),
            dict(common, name="flash_attention_bwd_dkv",
                 kernel=f"dkv_resident_wgmma<64, {tfa.BWD_INNER_TILE}> "
                        f"({ring}); fp32 dkv_f32_blocked<64, "
                        f"{f32_tiles['dkv'][0] // 16}, {f32_tiles['dkv'][1]}>"
                        f" ({blocked})",
                 replaces="apex_tpu/ops/flash_attention.py:411", ms=ms_dkv,
                 bound_ms=dkv_bound[0], bound_by=dkv_bound[1])]


#: limits of the bias checks beyond the resident kernels' own, keyed by "is
#: bf16": dbias (share of max |ref|, worst row). dS stays fp32 in both (P
#: from fp32 scores, dP from fp32 sums of exact bf16 products), so it is
#: held far tighter than the bf16 gradients: about 10x the worst readings
#: on an H100 (bf16 1.04e-6 of max |ref|, 3.15e-4 by row under causal,
#: where short rows cancel; the fp32 route gave the plain version's bits)
DBIAS_TOL = {True: (1e-5, 3e-3), False: (1e-5, 1e-5)}


def padding_bias(torch, ops, dev, gen, b, s, lo=128):
    """BERT's additive padding bias (b, 1, 1, s) from
    ``extended_attention_mask`` of a 1/0 mask whose lengths are drawn in
    [lo, s]."""
    from apex_tpu_torch.models import extended_attention_mask

    lengths = torch.randint(lo, s + 1, (b,), device=dev, generator=gen)
    mask = (torch.arange(s, device=dev)[None] < lengths[:, None]).int()
    return extended_attention_mask(mask)


def check_flash_bias(torch, ops, dev):
    """The additive bias on the resident kernels #1, #5 and #6 against the
    plain versions (``flash_attention_fwd_reference``,
    ``flash_attention_bwd_reference``) on the card, from the forward
    kernel's o and lse: BERT's padding bias (16,1,1,512) from
    ``extended_attention_mask`` at (16,16,512,64) bf16; dense biases with
    dbias broadcast over the batch (1,16,512,512), over the heads
    (16,1,512,512), over both under causal, and whole (2,16,512,512); a
    causal padding bias with dbias; an all -inf bias row (o exactly 0, lse
    kNegInf, dbias 0); the fp32 route and d = 128. o and lse, dq, dk, dv
    and dbias each by their share of max |ref| and by row, at the limits
    of the resident checks (dbias: :data:`DBIAS_TOL`). A halved tail of o
    rows at the BERT shape and of dbias rows must fail the row check; two
    calls must give the same bits at the BERT shape and with a broadcast
    dbias. Then device times at the BERT shape with and without the
    padding bias and of the dense route with dbias, beside the bounds
    (the bias counted once as stored), SDPA with the same float
    ``attn_mask`` and the launch floor (:func:`launch_floor`). Returns the
    timing dict the ``kernels`` line carries (``bias_route``)."""
    import importlib

    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(13)

    def run(label, b, h, sq, sk, d, dt, causal, kind, want_db, plant=False,
            twice=False, dead=False):
        q, k, v, do = (torch.randn(b, h, s, d, device=dev,
                                   generator=gen).to(dt)
                       for s in (sq, sk, sk, sq))
        if kind == "pad":
            raw = padding_bias(torch, ops, dev, gen, b, sk, lo=min(128, sk))
        else:
            raw = torch.randn(*kind, sq, sk, device=dev, generator=gen)
        if dead:
            raw[0, 0, 3] = float("-inf")  # a query that sees no key
        bias = tfa._canonical_bias(raw, b, h, sq, sk)
        scale = d ** -0.5
        kw = dict(causal=causal, scale=scale)
        bf = dt == bf16
        grp = f"flash bias {str(dt)[6:]}"
        o, lse = ops.flash_attention_fwd(q, k, v, bias=bias, **kw)
        ro, rlse = ops.flash_attention_fwd_reference(q, k, v, bias=bias,
                                                     **kw)
        delta = (o.float() * do.float()).sum(-1)
        got = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, bias=bias,
                                         dbias=want_db, **kw)
        dq, db = got if want_db else (got, None)
        dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                             bias=bias, **kw)
        ref = ops.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                bias=bias, **kw)
        torch.cuda.synchronize()
        if dead:
            check(bool((o[0, :, 3] == 0).all())
                  and bool((lse[0, :, 3] == tfa.NEG_INF).all())
                  and bool((ref[3][0, 0, 3] == 0).all())
                  and bool((db[0, 0, 3] == 0).all()),
                  f"flash bias {label}: the -inf row outputs exactly 0 with "
                  f"lse kNegInf and zero dbias")
            lse, rlse = lse.clone(), rlse.clone()
            lse[0, :, 3] = rlse[0, :, 3] = 0.0  # held exactly above
        tol, rtol = (2e-2, ROW_TOL[True][0]) if bf else (5e-5,
                                                         ROW_TOL[False][0])
        gtol, grtol = (1e-2, ROW_TOL[True][1]) if bf else (1e-4,
                                                          ROW_TOL[False][1])
        name = f"flash bias {label}"
        parts = [held(f"{name} o", o, ro, tol, rtol, group=grp),
                 held(f"{name} lse", lse[..., None], rlse[..., None],
                      *LSE_TOL[:2], floor=LSE_TOL[2], group=grp)]
        for gname, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            check(a.dtype == dt and a.shape == r.shape,
                  f"{name} {gname} dtype/shape")
            parts.append(held(f"{name} {gname}", a, r, gtol, grtol,
                              group=grp))
        if want_db:
            check(db.dtype == f32 and db.shape == bias.shape,
                  f"{name} dbias dtype/shape")
            parts.append(held(f"{name} dbias", db, ref[3], *DBIAS_TOL[bf],
                              group=grp))
        if plant:
            # a tail of rows gone half wrong must fail the row check
            for what, got_t, ref_t, lim in (("o", o, ro, rtol),
                                            ("dbias", db, ref[3],
                                             DBIAS_TOL[bf][1])):
                if got_t is None:
                    continue
                bad = got_t.clone()
                bad[:, :, bad.shape[2] // 2:] *= 0.5
                planted = row_err(bad, ref_t)
                parts.append(f"{what} with its last half of rows halved: "
                             f"row {planted:.3g}")
                verdict(f"{name} halved {what} tail caught by the row check",
                        0 if planted > lim else 1, 0, group=grp)
        if twice:
            o2, lse2 = ops.flash_attention_fwd(q, k, v, bias=bias, **kw)
            again = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                               bias=bias, dbias=want_db, **kw)
            dq2, db2 = again if want_db else (again, None)
            dk2, dv2 = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                   bias=bias, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in (
                (o, o2), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2)))
            if want_db:
                same = same and torch.equal(db, db2)
            parts.append(f"a second call bit-identical: {same}")
            verdict(f"{name} deterministic", 0 if same else 1, 0, group=grp)
        print(f"  {name}: " + ", ".join(parts))
        return max_err(o, ro)

    bert = (16, 16, 512, 512, 64, bf16, False)
    main_err = run("BERT padding (16,1,1,512) (16,16,512,64) bf16", *bert,
                   "pad", False, plant=True, twice=True)
    run("dense (1,16,512,512) dbias (16,16,512,64) bf16", *bert, (1, 16),
        True, plant=True, twice=True)
    run("per batch (16,1,512,512) dbias (16,16,512,64) bf16", *bert,
        (16, 1), True)
    run("whole (2,16,512,512) dbias (2,16,512,64) bf16", 2, 16, 512, 512,
        64, bf16, False, (2, 16), True)
    run("(1,1,512,512) dbias causal (2,16,512,64) bf16", 2, 16, 512, 512,
        64, bf16, True, (1, 1), True, twice=True)
    run("padding dbias causal (2,16,512,64) bf16", 2, 16, 512, 512, 64,
        bf16, True, "pad", True)
    run("-inf row (2,1,300,200) dbias (2,4,300,200,64) bf16", 2, 4, 300,
        200, 64, bf16, False, (2, 1), True, dead=True)
    run("d=128 (1,4,300,300) dbias causal (1,4,300,300,128) bf16", 1, 4,
        300, 300, 128, bf16, True, (1, 4), True)
    run("fp32 route (2,1,300,300) dbias (2,4,300,300,64)", 2, 4, 300, 300,
        64, f32, False, (2, 1), True, twice=True)
    run("fp32 route padding causal (2,4,200,330,40)", 2, 4, 200, 330, 40,
        f32, True, "pad", True)
    run("fp32 route -inf row (2,1,130,130) dbias (2,2,130,130,64)", 2, 2,
        130, 130, 64, f32, False, (2, 1), True, dead=True)
    torch.cuda.empty_cache()
    out = bias_times(torch, ops, tfa, dev, gen)
    out["max_abs_err"] = main_err
    return out


#: fp32 limits of the segment checks (share of max |ref|, worst row): the
#: fp32 kernels and their plain versions sum the same fp32 terms in
#: another order
SEG_F32_TOL = (2e-6, 1e-5)


def packed_ids(torch, b, s, lengths, pad_id):
    """(b, s) int32 non-decreasing segment ids on the CPU: segments 1, 2,
    ... of ``lengths`` (cut at s), the rest pad_id; batch row i makes the
    first segment 17 i longer so that the rows differ."""
    ids = torch.full((b, s), pad_id, dtype=torch.int32)
    for i in range(b):
        at = 0
        for n, ln in enumerate(lengths, start=1):
            ln = ln + 17 * i if n == 1 else ln
            ids[i, at:min(s, at + ln)] = n
            at += ln
            if at >= s:
                break
    return ids


def check_flash_segments(torch, ops, dev):
    """The segment ids, pad_id and contiguous-segment bounds on the six
    flash kernels (#1 #5 #6 resident, #2 #3 #4 streamed), forward and
    backward, bf16 and fp32, against the plain versions on the card:
    packed ids with a padding tail, causal and not, the bounds on and off
    (mask-only; the two must agree within the limits, and whether they are
    bit-identical is printed), a causal row whose same-id keys all lie
    above the diagonal (exactly 0, cross q/kv ids), the window with
    segments on the streamed route, the window alone and with segments on
    the resident route (stream='never'), cut split lengths so that a
    narrowed split hands the merge an empty partial, d = 128, a halved
    tail that the row check must catch, two calls bit-identical (the
    resident kernels and the streamed forward), and the root bench.py
    selftest's streamed case: (1,2,8192,64) bf16, causal, 8 equal
    segments, contiguous, stream='always', through ``flash_attention`` and
    its grads against autograd through ``mha_reference``. bf16 limits: 0.02
    of max |ref| forward, 0.01 backward, ROW_TOL by row; fp32:
    :data:`SEG_F32_TOL`; lse by LSE_TOL; rows that see no key exactly 0
    with lse NEG_INF."""
    import importlib

    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(14)
    routes = {False: (ops.flash_attention_fwd, ops.flash_attention_bwd_dq,
                      ops.flash_attention_bwd_dkv),
              True: (ops.flash_attention_fwd_stream,
                     ops.flash_attention_bwd_dq_stream,
                     ops.flash_attention_bwd_dkv_stream)}

    def plain(stream, q, k, v, o, lse, do, delta, kw):
        if stream:
            ro, rlse = ops.flash_attention_fwd_stream_reference(q, k, v, **kw)
            return (ro, rlse, ops.flash_attention_bwd_dq_stream_reference(
                q, k, v, do, lse, delta, **kw),
                *ops.flash_attention_bwd_dkv_stream_reference(
                    q, k, v, do, lse, delta, **kw))
        ro, rlse = ops.flash_attention_fwd_reference(q, k, v, **kw)
        return (ro, rlse, *ops.flash_attention_bwd_reference(
            q, k, v, o, lse, do, **kw))

    def kernels(stream, q, k, v, do, kw):
        fwd, dq_fn, dkv_fn = routes[stream]
        o, lse = fwd(q, k, v, **kw)
        delta = (o.float() * do.float()).sum(-1)
        dq = dq_fn(q, k, v, do, lse, delta, **kw)
        dk, dv = dkv_fn(q, k, v, do, lse, delta, **kw)
        return o, lse, delta, dq, dk, dv

    def run(label, b, h, sq, sk, d, dt, causal, stream, ids=None,
            lengths=(60, 90, 45, 50), pad=9, window=None, contiguous=True,
            plant=False, twice=False, both=True, zero_row=None):
        q, k, v, do = (torch.randn(b, h, n, d, device=dev,
                                   generator=gen).to(dt)
                       for n in (sq, sk, sk, sq))
        if ids is None:
            ids = (packed_ids(torch, b, sq, lengths, pad),
                   packed_ids(torch, b, sk, lengths, pad))
        seg = tuple(t.to(dev) for t in ids)
        kw = dict(causal=causal, scale=d ** -0.5, window=window,
                  segment_ids=seg, pad_id=pad,
                  contiguous_segments=contiguous)
        bf = dt == bf16
        route = ("streamed" if stream else "resident") + f" {str(dt)[6:]}"
        grp = f"flash segments {route}"
        name = f"flash segments {route} {label}"
        o, lse, delta, dq, dk, dv = kernels(stream, q, k, v, do, kw)
        ro, rlse, rdq, rdk, rdv = plain(stream, q, k, v, o, lse, do, delta,
                                        kw)
        torch.cuda.synchronize()
        dead = rlse <= tfa.NEG_INF / 2
        check(bool((lse[dead] == tfa.NEG_INF).all())
              and bool((o[dead] == 0).all()),
              f"{name}: rows that see no key are exactly 0, lse NEG_INF")
        if zero_row is not None:
            check(bool(dead[:, :, zero_row].all())
                  and bool((dq[:, :, zero_row] == 0).all()),
                  f"{name}: the row whose same-id keys lie above the "
                  f"diagonal is exactly 0 with dQ 0")
        lse, rlse = lse.masked_fill(dead, 0.0), rlse.masked_fill(dead, 0.0)
        ftol, frow = (2e-2, ROW_TOL[True][0]) if bf else SEG_F32_TOL
        btol, brow = (1e-2, ROW_TOL[True][1]) if bf else SEG_F32_TOL
        parts = [held(f"{name} o", o, ro, ftol, frow, group=grp),
                 held(f"{name} lse", lse[..., None], rlse[..., None],
                      *LSE_TOL[:2], floor=LSE_TOL[2], group=grp)]
        for gname, a, r in (("dq", dq, rdq), ("dk", dk, rdk),
                            ("dv", dv, rdv)):
            check(a.dtype == dt and a.shape == r.shape,
                  f"{name} {gname} dtype/shape")
            parts.append(held(f"{name} {gname}", a, r, btol, brow,
                              group=grp))
        if plant:
            bad = o.clone()
            bad[:, :, sq // 2:] *= 0.5
            planted = row_err(bad, ro)
            parts.append(f"o with its last half of rows halved: row "
                         f"{planted:.3g}")
            verdict(f"{name} halved o tail caught by the row check",
                    0 if planted > frow else 1, 0, group=grp)
        if twice:
            again = kernels(stream, q, k, v, do, kw)
            torch.cuda.synchronize()
            same = [torch.equal(x, y) for x, y in zip(
                (o, lse.masked_fill(dead, 0.0)),
                (again[0], again[1].masked_fill(dead, 0.0)))]
            same_bwd = all(torch.equal(x, y) for x, y in zip(
                (dq, dk, dv), again[3:]))
            parts.append(f"a second call bit-identical: forward "
                         f"{all(same)}, backward {same_bwd}")
            # the bf16 streamed backward adds its splits by atomics
            verdict(f"{name} deterministic", 0 if all(same) and (
                (stream and bf) or same_bwd) else 1, 0, group=grp)
        if both and contiguous:
            # the bounds against mask-only evaluation of the same ids
            mkw = dict(kw, contiguous_segments=False)
            m = kernels(stream, q, k, v, do, mkw)
            torch.cuda.synchronize()
            for gname, a, r, tol, rt in zip(
                    ("o", "dq", "dk", "dv"), (m[0], *m[3:]),
                    (o, dq, dk, dv), (ftol, btol, btol, btol),
                    (frow, brow, brow, brow)):
                held(f"{name} mask-only {gname} vs bounds", a, r, tol, rt,
                     group=grp)
            bits = [torch.equal(x, y) for x, y in zip(
                (m[0], *m[3:]), (o, dq, dk, dv))]
            parts.append("mask-only vs bounds bit-identical (o, dq, dk, dv): "
                         + "/".join(str(x) for x in bits))
        print(f"  {name}: " + ", ".join(parts))
        return max_err(o, ro)

    errs = {}
    for stream in (False, True):
        for dt in (bf16, f32):
            r = run("(2,4,300,300,64) pad non-causal", 2, 4, 300, 300, 64,
                    dt, False, stream, plant=dt == bf16, twice=True)
            errs[(stream, dt)] = r
            run("(2,4,300,300,64) pad causal", 2, 4, 300, 300, 64, dt, True,
                stream, twice=dt == bf16)
            # q position 0 in segment 2, every segment-2 key above it
            qid = torch.ones(2, 128, dtype=torch.int32)
            qid[:, 0] = 2
            kid = torch.tensor([1] * 64 + [2] * 64,
                               dtype=torch.int32).expand(2, 128).clone()
            run("(2,2,128,128,64) row 0 sees only keys above the diagonal",
                2, 2, 128, 128, 64, dt, True, stream, ids=(qid, kid),
                contiguous=False, zero_row=0)
        run("(1,4,777,520,128) d=128 pad causal", 1, 4, 777, 520, 128, bf16,
            True, stream, lengths=(200, 150, 120))
    for dt in (bf16, f32):
        wide = dict(lengths=(200, 150, 220))
        run("(2,4,700,700,64) window 100 pad causal", 2, 4, 700, 700, 64,
            dt, True, True, window=100, **wide)
        run("(1,4,700,700,64) window 90 pad non-causal", 1, 4, 700, 700,
            64, dt, False, True, window=90, **wide)
        run("(1,4,700,700,64) window 100 pad causal stream='never'", 1, 4,
            700, 700, 64, dt, True, False, window=100, **wide)
    # the resident window alone (no segment ids)
    for dt in (bf16, f32):
        q, k, v, do = (torch.randn(1, 4, 600, 64, device=dev,
                                   generator=gen).to(dt) for _ in range(4))
        kw = dict(causal=True, scale=0.125, window=128)
        o, lse, delta, dq, dk, dv = kernels(False, q, k, v, do, kw)
        ro, rlse, *rg = plain(False, q, k, v, o, lse, do, delta, kw)
        grp = f"flash resident window {str(dt)[6:]}"
        bf = dt == bf16
        tol = (2e-2, ROW_TOL[True][0]) if bf else SEG_F32_TOL
        parts = [held(f"{grp} o", o, ro, *tol, group=grp)]
        for gname, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), rg):
            parts.append(held(f"{grp} {gname}", a, r,
                              *((1e-2, ROW_TOL[True][1]) if bf
                                else SEG_F32_TOL), group=grp))
        print(f"  {grp} (1,4,600,64) causal window 128: " + ", ".join(parts))
    # cut split lengths: bands of several splits, narrowed ones empty
    cut = ("FWD_SPLIT_TILES", "BWD_SPLIT_TILES", "FWD_F32_SPLIT_TILES")
    chosen = [getattr(tfa, n) for n in cut]
    try:
        for n in cut:
            setattr(tfa, n, 2)
        for dt in (bf16, f32):
            run("(2,4,1100,1100,64) splits of 2 tiles pad causal", 2, 4,
                1100, 1100, 64, dt, True, True,
                lengths=(300, 90, 260, 330))
    finally:
        for n, c in zip(cut, chosen):
            setattr(tfa, n, c)
    bench_segments_case(torch, ops, dev, gen)
    return errs


def bench_segments_case(torch, ops, dev, gen):
    """The root bench.py selftest's streamed case (bench.py:1045-1058):
    (1,2,8192,64) bf16, causal, 8 equal segments, contiguous, stream=
    'always', through ``flash_attention`` (the streamed kernels, one launch
    each) and its grads: o against ``mha_reference`` in fp32 on the same
    rounded inputs and against the plain streamed forward, the grads
    against the plain streamed backward from the kernel's o and lse."""
    b, h, s, d = 1, 2, 8192, 64
    seg = torch.arange(8, device=dev, dtype=torch.int32).repeat_interleave(
        s // 8)[None]
    q, k, v = (torch.randn(b, h, s, d, device=dev, generator=gen).to(
        torch.bfloat16).requires_grad_() for _ in range(3))
    g = torch.randn(b, h, s, d, device=dev, generator=gen).to(torch.bfloat16)
    kw = dict(segment_ids=(seg, seg), causal=True, contiguous_segments=True)
    before = ops.launch_counts()
    o = ops.flash_attention(q, k, v, stream="always", **kw)
    got = torch.autograd.grad(o, (q, k, v), g)
    after = ops.launch_counts()
    ran = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    check(ran == {"flash_attention_fwd_stream": 1,
                  "flash_attention_bwd_dq_stream": 1,
                  "flash_attention_bwd_dkv_stream": 1},
          f"bench segments case: launches {ran}")
    q, k, v, o = (t.detach() for t in (q, k, v, o))
    kw["scale"] = d ** -0.5
    # the kernel's lse (the forward gives the same bits again)
    o2, lse = ops.flash_attention_fwd_stream(q, k, v, **kw)
    delta = (o2.float() * g.float()).sum(-1)
    ro, _ = ops.flash_attention_fwd_stream_reference(q, k, v, **kw)
    dense = ops.mha_reference(q.float(), k.float(), v.float(),
                              segment_ids=(seg, seg), causal=True)
    want = (ops.flash_attention_bwd_dq_stream_reference(
        q, k, v, g, lse, delta, **kw),
        *ops.flash_attention_bwd_dkv_stream_reference(
            q, k, v, g, lse, delta, **kw))
    grp = "flash segments bench.py streamed case"
    check(torch.equal(o, o2), f"{grp}: the forward's bits from call to call")
    parts = [held(f"{grp} o", o, ro, 2e-2, ROW_TOL[True][0], group=grp),
             held(f"{grp} o vs mha_reference", o, dense, 2e-2,
                  ROW_TOL[True][0], group=grp)]
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        parts.append(held(f"{grp} {name}", a, r, 1e-2, ROW_TOL[True][1],
                          group=grp))
    print(f"  {grp} (1,2,8192,64) bf16 causal, 8 segments, contiguous, "
          f"stream='always' (launches {ran}): " + ", ".join(parts))
    del dense, want


def bias_times(torch, ops, tfa, dev, gen):
    """Device times at the BERT shape (16,16,512,64) bf16, non-causal: #1
    and #5 + #6 without a bias and with BERT's padding bias, the dense
    (1,16,512,512) route with dbias, SDPA with the same float attn_mask
    (forward, and forward + backward in one captured call), each beside its
    bound (the bias counted once as stored; dbias written once), and the
    launch floor."""
    import torch.nn.functional as F

    b, h, s, d = 16, 16, 512, 64
    bf16 = torch.bfloat16
    q, k, v, do = (torch.randn(b, h, s, d, device=dev, generator=gen).to(bf16)
                   for _ in range(4))
    pad = padding_bias(torch, ops, dev, gen, b, s)
    dense = torch.randn(1, h, s, s, device=dev, generator=gen)
    kw = dict(causal=False, scale=d ** -0.5)
    elems, rows, pairs = b * h * s * d, b * h * s, b * h * s * s
    out = {}
    for label, raw in (("none", None), ("padding", pad), ("dense", dense)):
        bias = None if raw is None else tfa._canonical_bias(raw, b, h, s, s)
        bias_bytes = 0 if raw is None else raw.numel() * 4
        want_db = label == "dense"
        o, lse = ops.flash_attention_fwd(q, k, v, bias=bias, **kw)
        delta = (o.float() * do.float()).sum(-1)
        t = {"fwd_ms": time_ms(lambda: ops.flash_attention_fwd(
                 q, k, v, bias=bias, **kw)),
             "dq_ms": time_ms(lambda: ops.flash_attention_bwd_dq(
                 q, k, v, do, lse, delta, bias=bias, dbias=want_db, **kw)),
             "dkv_ms": time_ms(lambda: ops.flash_attention_bwd_dkv(
                 q, k, v, do, lse, delta, bias=bias, **kw))}
        t["fwd_bound_ms"], t["fwd_bound_by"] = bound(
            4 * elems * 2 + rows * 4 + bias_bytes, 4 * d * pairs, "bfloat16")
        t["dq_bound_ms"], t["dq_bound_by"] = bound(
            5 * elems * 2 + 2 * rows * 4 + bias_bytes * (2 if want_db else 1),
            6 * d * pairs, "bfloat16")
        t["dkv_bound_ms"], t["dkv_bound_by"] = bound(
            6 * elems * 2 + 2 * rows * 4 + bias_bytes, 8 * d * pairs,
            "bfloat16")
        if label == "padding":
            t["plain_fwd_ms"] = time_ms(
                lambda: ops.flash_attention_fwd_reference(
                    q, k, v, bias=bias, **kw), 2, 2)
            t["plain_bwd_ms"] = time_ms(
                lambda: ops.flash_attention_bwd_reference(
                    q, k, v, o, lse, do, bias=bias, **kw), 2, 2)
        out[label] = t
        del o, lse, delta
    # the dQ inner tile under the bias (RES_BWD_DQ_BIAS_INNER_TILE): 64
    # and 128 key rows, with the padding bias
    chosen = tfa.RES_BWD_DQ_BIAS_INNER_TILE
    bias = tfa._canonical_bias(pad, b, h, s, s)
    o, lse = ops.flash_attention_fwd(q, k, v, bias=bias, **kw)
    delta = (o.float() * do.float()).sum(-1)
    tiles = {}
    try:
        for tile in (64, 128):
            tfa.RES_BWD_DQ_BIAS_INNER_TILE = tile
            tiles[tile] = time_ms(lambda: ops.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, bias=bias, **kw))
    finally:
        tfa.RES_BWD_DQ_BIAS_INNER_TILE = chosen
    out["dq_bias_inner_tile"] = {"chosen": chosen, "ms": tiles}
    print(f"  RES_BWD_DQ_BIAS_INNER_TILE = {chosen} (chosen); dQ with the "
          f"padding bias at (16,16,512,64) by key tile: "
          + ", ".join(f"{t}: {ms:.4f} ms" for t, ms in tiles.items()))
    del o, lse, delta
    # yardstick: SDPA with the padding bias as a float attn_mask (q's
    # dtype, as SDPA takes it), forward alone and forward + backward in one
    # captured call
    mask = pad.to(bf16)
    out["padding"]["library_fwd_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
        return torch.autograd.grad(o, (ql, kl, vl), do)

    out["padding"]["library_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd)
    probe = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
    out["padding"]["library_backend"] = type(probe.grad_fn).__name__
    del probe
    out["launch_floor_ms"] = launch_floor(torch, dev)
    n, p_, dn = out["none"], out["padding"], out["dense"]
    print(f"  flash bias timing (16,16,512,64) bf16 non-causal: #1 no bias "
          f"{n['fwd_ms']:.4f} ms, padding bias {p_['fwd_ms']:.4f} ms (bound "
          f"{p_['fwd_bound_ms']:.4f} ms {p_['fwd_bound_by']}), dense "
          f"(1,16,512,512) {dn['fwd_ms']:.4f} ms; #5 dQ no bias "
          f"{n['dq_ms']:.4f}, padding {p_['dq_ms']:.4f} (bound "
          f"{p_['dq_bound_ms']:.4f} {p_['dq_bound_by']}), dense with dbias "
          f"{dn['dq_ms']:.4f} ms (bound {dn['dq_bound_ms']:.4f}); #6 dK/dV no "
          f"bias {n['dkv_ms']:.4f}, padding {p_['dkv_ms']:.4f} (bound "
          f"{p_['dkv_bound_ms']:.4f} {p_['dkv_bound_by']}), dense "
          f"{dn['dkv_ms']:.4f} ms; plain with the padding bias forward "
          f"{p_['plain_fwd_ms']:.4f}, backward (dq, dk, dv) "
          f"{p_['plain_bwd_ms']:.4f} ms; SDPA with the float mask forward "
          f"{p_['library_fwd_ms']:.4f} ms, forward + backward "
          f"{p_['library_fwd_bwd_ms']:.4f} ms ({p_['library_backend']}) "
          f"against the port's {p_['fwd_ms'] + p_['dq_ms'] + p_['dkv_ms']:.4f}"
          f" ms; launch floor {out['launch_floor_ms']:.4f} ms; "
          f"{nvidia_smi()}")
    return out


def attach_bias_times(rows, bias):
    """The bias route's numbers on the ``kernels`` rows of #1, #5 and #6
    (``bias_route``: ms and bound by bias kind, SDPA with the float mask on
    #1), and the launch floor on the rows read against it (#9, #10, #13,
    #14)."""
    parts = {"flash_attention_fwd": "fwd", "flash_attention_bwd_dq": "dq",
             "flash_attention_bwd_dkv": "dkv"}
    for row in rows:
        part = parts.get(row["name"])
        if part is not None:
            row["bias_route"] = {
                kind: {"ms": t[f"{part}_ms"],
                       "bound_ms": t[f"{part}_bound_ms"],
                       "bound_by": t[f"{part}_bound_by"]}
                for kind, t in bias.items()
                if kind in ("none", "padding", "dense")}
            row["bias_route"]["max_abs_err"] = bias["max_abs_err"]
            if part == "dq":
                row["bias_route"]["dq_bias_inner_tile"] = bias[
                    "dq_bias_inner_tile"]
            row["bias_route"]["plain_ms"] = bias["padding"][
                "plain_fwd_ms" if part == "fwd" else "plain_bwd_ms"]
            if part == "fwd":
                row["bias_route"]["library_ms"] = bias["padding"][
                    "library_fwd_ms"]
                row["bias_route"]["library_fwd_bwd_ms"] = bias["padding"][
                    "library_fwd_bwd_ms"]
        if row["name"] in ("flash_decode", "flash_decode_multi",
                           "xentropy_fwd", "xentropy_bwd"):
            row["launch_floor_ms"] = bias["launch_floor_ms"]


def launch_floor(torch, dev):
    """Device time per call of an empty kernel from ``csrc/`` by the same
    CUDA-graph replay as every kernel time: what a kernel at a small shape
    (the decode pair's, the xentropy pair's at 256 x 1000) is read
    against."""
    from apex_tpu_torch.csrc import build

    return time_ms(lambda: build.empty_kernel(dev.index), 100, 5)


def res_bwd_tuning(torch, ops, tfa, args, kw, tiles=(64, 128)):
    """The schedule and the dQ inner tile of the bf16 resident backward
    (RES_BWD_PERSISTENT, RES_BWD_DQ_INNER_TILE) against the values tried,
    at T: device times of dQ at each inner tile and of dK/dV (64-row tiles:
    at 128 its kernel spills) on the plain grid and the persistent one, on
    one line; returned for the ``kernels`` line (``res_bwd_tuning``)."""
    chosen = (tfa.RES_BWD_PERSISTENT, tfa.RES_BWD_DQ_INNER_TILE)
    times = {}
    try:
        for persistent in (False, True):
            tfa.RES_BWD_PERSISTENT = persistent
            t = {"dq": {}, "dkv": {}}
            for tile in tiles:
                tfa.RES_BWD_DQ_INNER_TILE = tile
                t["dq"][tile] = time_ms(
                    lambda: ops.flash_attention_bwd_dq(*args, **kw))
            t["dkv"][tfa.BWD_INNER_TILE] = time_ms(
                lambda: ops.flash_attention_bwd_dkv(*args, **kw))
            times["persistent" if persistent else "grid"] = t
    finally:
        tfa.RES_BWD_PERSISTENT, tfa.RES_BWD_DQ_INNER_TILE = chosen
    print(f"  RES_BWD_PERSISTENT = {chosen[0]}, RES_BWD_DQ_INNER_TILE = "
          f"{chosen[1]} (chosen); ms at T (8,16,1024,64) causal by "
          f"schedule: " + "; ".join(
              f"{sched}: dQ " + ", ".join(f"{k}: {v:.4f}"
                                          for k, v in t["dq"].items())
              + ", dK/dV " + ", ".join(f"{k}: {v:.4f}"
                                       for k, v in t["dkv"].items())
              for sched, t in times.items()))
    return {"chosen": {"persistent": chosen[0], "dq_inner_tile": chosen[1],
                       "dkv_inner_tile": tfa.BWD_INNER_TILE},
            "T_ms": times}


def res_bwd_f32_tuning(torch, ops, tfa, dev, gen):
    """The schedule and the outer tile of the fp32 resident backward
    (RES_BWD_F32_PERSISTENT, RES_BWD_F32_OUTER_TILE) against the values
    tried, at F = (4,16,1024,64) causal: device times of dQ and of dK/dV
    at each outer tile (over 64-row inner tiles) on the plain grid and the
    persistent one, on one line; returned for the ``kernels`` line
    (``res_bwd_f32_tuning``)."""
    q, k, v, do = (torch.randn(4, 16, 1024, 64, device=dev, generator=gen)
                   for _ in range(4))
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    args = (q, k, v, do, lse, (o * do).sum(-1))
    kw = dict(causal=True, scale=0.125)
    chosen = (tfa.RES_BWD_F32_PERSISTENT, tfa.RES_BWD_F32_OUTER_TILE)
    times = {}
    try:
        for persistent in (False, True):
            tfa.RES_BWD_F32_PERSISTENT = persistent
            t = {"dq": {}, "dkv": {}}
            for outer in (64, 128):
                tfa.RES_BWD_F32_OUTER_TILE = outer
                t["dq"][outer] = time_ms(
                    lambda: ops.flash_attention_bwd_dq(*args, **kw))
                t["dkv"][outer] = time_ms(
                    lambda: ops.flash_attention_bwd_dkv(*args, **kw))
            times["persistent" if persistent else "grid"] = t
    finally:
        tfa.RES_BWD_F32_PERSISTENT, tfa.RES_BWD_F32_OUTER_TILE = chosen
    print(f"  RES_BWD_F32_PERSISTENT = {chosen[0]}, RES_BWD_F32_OUTER_TILE "
          f"= {chosen[1]} (chosen); ms at F (4,16,1024,64) fp32 causal by "
          f"schedule and outer tile: " + "; ".join(
              f"{sched}: dQ " + ", ".join(f"{k}: {v:.4f}"
                                          for k, v in t["dq"].items())
              + ", dK/dV " + ", ".join(f"{k}: {v:.4f}"
                                       for k, v in t["dkv"].items())
              for sched, t in times.items()) + f"; {nvidia_smi()}")
    return {"chosen": {"persistent": chosen[0], "outer_tile": chosen[1]},
            "F_ms": times}


def visible_pairs(sq, sk, causal, window, shift=0):
    """(query, key) pairs the causal and window masks leave, per head, with
    query row r at position r + ``shift`` (a ring step's q_off - k_off)."""
    total = 0
    for r in range(sq):
        q = r + shift
        hi = max(0, min(q + 1, sk)) if causal else sk
        lo = 0
        if window is not None:
            lo = max(0, q - window + 1)
            if not causal:
                hi = max(0, min(sk, q + window))
        total += max(0, hi - lo)
    return total


def stream_bounds(b, h, sq, sk, d, causal, window, dtype="bfloat16",
                  shift=0):
    """(fwd, dq, dkv) bounds of the streamed kernels: each operand read
    once and each output written once (q/k/v/o/dO/dq/dk/dv in ``dtype``,
    fp32 lse/delta) against 2, 3 and 4 products of 2*d FLOPs per visible
    pair at ``dtype``'s peak (the pairs at the ring offsets' ``shift``)."""
    pairs = visible_pairs(sq, sk, causal, window, shift) * b * h
    q_el, k_el = b * h * sq * d, b * h * sk * d
    rows = b * h * sq * 4
    es = 4 if dtype == "float32" else 2
    return (bound(es * (2 * q_el + 2 * k_el) + rows, 4 * d * pairs, dtype),
            bound(es * (3 * q_el + 2 * k_el) + 2 * rows, 6 * d * pairs,
                  dtype),
            bound(es * (2 * q_el + 4 * k_el) + 2 * rows, 8 * d * pairs,
                  dtype), pairs)


# worst-row limits (row_err) of the streamed kernels, (forward, backward),
# keyed by "is bf16": twice the worst bf16 reading of the cases below on an
# H100 (0.0062 forward, 0.0075 backward; 0.0055 at the path shapes), and
# 5x the worst fp32 reading (1.9e-6); a halved tail of rows reads 0.5
ROW_TOL = {True: (1.5e-2, 1.5e-2), False: (1e-5, 1e-5)}
# lse limits of the resident forward, bf16 and fp32 alike (the lse is fp32
# statistics of fp32 scores either way): (share of max |ref|, worst row of
# row_err over single elements, floor): each element's error against
# max(|ref|, 0.1 of its head's largest), so an lse near 0 is held to its
# head's scale and not to its rounding noise
LSE_TOL = (1e-5, 1e-4, 0.1)


def poisoned_empty(torch, shape, dev):
    """Fill and free ``shape`` fp32 blocks of the caching allocator with NaN
    (two: dK and dV take one each), so that the next ``torch.empty`` of
    that shape reuses memory that is not 0; returns whether a probe
    allocation read NaN, which shows the reuse in this process."""
    junk = [torch.full(shape, float("nan"), device=dev) for _ in range(2)]
    del junk
    probe = torch.empty(shape, device=dev)
    reused = bool(torch.isnan(probe).all())
    del probe
    return reused


def check_fp32_stream_bwd(torch, ops, dev, gen):
    """The fp32 streamed backward pair (#3/#4 fp32: dq_f32_blocked /
    dkv_f32_blocked over whole bands) beyond the cases of
    :func:`check_flash_attention_stream`: d = 6, 16, 36, 40 and 128, the
    fused-QKV view and views off 16 bytes (the kernels' 4-byte copies),
    each against the plain versions (1e-5 of max |ref|, :data:`ROW_TOL` by
    row) with a second call bit-identical (each element written once),
    also at d = 128 over bands of 64 key tiles (dQ) and 128 query tiles
    (dK/dV); and rows whose band is empty -- keys that no query sees under
    a causal cross shape, queries past the keys' window, the padding tiles
    under contiguous segments -- exactly 0 in outputs the wrapper does not
    zero (the memory they reuse filled with NaN first,
    :func:`poisoned_empty`)."""
    f32 = torch.float32
    grp = "flash_attention_stream float32 backward"

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def grads(q, k, v, do, kw):
        o, lse = ops.flash_attention_fwd_stream(q, k, v, **kw)
        delta = (o * do).sum(-1)
        reused = poisoned_empty(torch, tuple(q.shape), dev)
        dq = ops.flash_attention_bwd_dq_stream(q, k, v, do, lse, delta, **kw)
        poisoned_empty(torch, tuple(k.shape), dev)
        dk, dv = ops.flash_attention_bwd_dkv_stream(q, k, v, do, lse, delta,
                                                    **kw)
        torch.cuda.synchronize()
        return (dq, dk, dv), lse, delta, reused

    def run(label, q, k, v, kw, twice=True, zero=None):
        do = rand(*q.shape)
        kw = dict(kw, scale=q.shape[-1] ** -0.5)
        got, lse, delta, reused = grads(q, k, v, do, kw)
        refs = (ops.flash_attention_bwd_dq_stream_reference(
            q, k, v, do, lse, delta, **kw),
            *ops.flash_attention_bwd_dkv_stream_reference(
                q, k, v, do, lse, delta, **kw))
        parts = []
        for name, a, r in zip(("dQ", "dK", "dV"), got, refs):
            check(a.dtype == f32 and a.shape == r.shape,
                  f"fp32 stream bwd {label} {name} dtype/shape")
            parts.append(held(f"fp32 stream bwd {label} {name}", a, r, 1e-5,
                              ROW_TOL[False][1], group=grp))
        if zero is not None:
            dead_q, dead_k = zero
            exact = bool((got[0][:, :, dead_q] == 0).all()) and all(
                bool((t[:, :, dead_k] == 0).all()) for t in got[1:])
            verdict(f"fp32 stream bwd {label}: empty-band rows exactly 0",
                    0 if exact else 1, 0, group=grp)
            parts.append(f"rows with an empty band exactly 0 (NaN-filled "
                         f"memory reused: {reused})")
        if twice:
            again, *_ = grads(q, k, v, do, kw)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            verdict(f"fp32 stream bwd {label} deterministic",
                    0 if same else 1, 0, group=grp)
            parts.append(f"a second call bit-identical: {same}")
        print(f"  fp32 stream bwd {label}: " + ", ".join(parts))

    causal_w = dict(causal=True, window=300)
    for d in (6, 16, 36, 40, 128):
        run(f"(1,2,1000,1000,{d}) causal window 300", rand(1, 2, 1000, d),
            rand(1, 2, 1000, d), rand(1, 2, 1000, d), causal_w)
    run("(1,2,4096,4096,128) causal", rand(1, 2, 4096, 128),
        rand(1, 2, 4096, 128), rand(1, 2, 4096, 128), dict(causal=True))
    qkv = rand(1, 1000, 4, 3, 64).permute(0, 2, 3, 1, 4)
    run("fused-QKV view (1,4,1000,64) causal", qkv[:, :, 0], qkv[:, :, 1],
        qkv[:, :, 2], dict(causal=True))
    off = [rand(1, 2, 700, 37)[..., 1:] for _ in range(3)]
    run("views off 16 bytes (1,2,700,36) non-causal", *off,
        dict(causal=False))
    off = [rand(1, 2, 700, 65)[..., 1:] for _ in range(3)]
    run("views off 16 bytes (1,2,700,64) causal window 200", *off,
        dict(causal=True, window=200))
    del qkv, off
    # rows whose band is empty: keys 77.. see no query; queries past
    # 77 + 15 see no key (the last 128-row query tile's band is empty);
    # the padding tiles of packed ids under the bounds
    run("(1,2,77,300,64) causal: keys no query sees", rand(1, 2, 77, 64),
        rand(1, 2, 300, 64), rand(1, 2, 300, 64), dict(causal=True),
        zero=(slice(0, 0), slice(77, None)))
    run("(1,2,300,77,64) causal window 16: queries that see no key",
        rand(1, 2, 300, 64), rand(1, 2, 77, 64), rand(1, 2, 77, 64),
        dict(causal=True, window=16), zero=(slice(92, None), slice(0, 0)))
    ids = packed_ids(torch, 2, 300, (60, 90, 45, 50), 9).to(dev)
    seg = dict(causal=True, segment_ids=(ids, ids), pad_id=9,
               contiguous_segments=True)
    check(bool((ids[0, 256:] == 9).all()), "batch row 0's last 128-row "
          "tile is padding: its band under the bounds is empty")
    run("(2,4,300,300,64) packed ids, pad tail, contiguous segments",
        rand(2, 4, 300, 64), rand(2, 4, 300, 64), rand(2, 4, 300, 64), seg,
        zero=(slice(262, None), slice(262, None)))
    torch.cuda.empty_cache()


# the ring offsets (transformer/ring.py): the cases of check_flash_offsets,
# (label, (b, h, sq, sk, d), causal, window, shift, kind); kind "zero": at
# shift 0 bit for bit the launch without it; "full": every key visible;
# "empty": nothing visible, outputs exactly 0 / NEG_INF in poisoned
# memory; "band": a partial band (dead rows exactly 0, the rest held)
OFFSET_CASES = (
    ("causal shift 0", (1, 4, 1024, 1024, 64), True, None, 0, "zero"),
    ("causal shift sk: the full band", (1, 4, 1024, 1024, 64), True, None,
     1024, "full"),
    ("causal shift -sq: every band empty", (1, 4, 1024, 1024, 64), True,
     None, -1024, "empty"),
    ("non-causal window 300 shift -700: a partial band",
     (1, 4, 1024, 1024, 64), False, 300, -700, "band"),
    ("window 4096 shift 8192: the step across a shard boundary, dead tail "
     "rows", (1, 16, 8192, 8192, 64), True, 4096, 8192, "band"),
)
#: the ring-step shapes timed (streamed, the ring's route at 4096 tokens a
#: shard): (label, s, shift, window, SDPA yardstick)
RING_STEPS = (
    ("L/2 (1,16,4096,64) causal shift 0: the diagonal step", 4096, 0, None,
     "causal"),
    ("L/2 (1,16,4096,64) causal shift 4096: the full band", 4096, 4096,
     None, "dense"),
    ("(1,16,8192,64) causal window 4096 shift 8192: the window step", 8192,
     8192, 4096, "band mask"))


def poison(torch, dev, specs):
    """Fill and free one tensor of each ``(shape, dtype)`` with NaN (every
    bit set), so that the next ``torch.empty`` of those sizes reuses memory
    that reads NaN; returns whether a probe of the first read NaN."""
    junk = [torch.full(s, float("nan"), dtype=dt, device=dev)
            for s, dt in specs]
    del junk
    probe = torch.empty(specs[0][0], dtype=specs[0][1], device=dev)
    reused = bool(torch.isnan(probe).all())
    del probe
    return reused


def check_flash_offsets(torch, ops, dev):
    """The ring offsets (``shift = q_off - k_off``) on the six flash
    kernels, bf16 and fp32, resident (#1 #5 #6) and streamed (#2 #3 #4),
    forward and backward, against the plain versions at the same shift
    (:data:`OFFSET_CASES`): at shift 0 the launch is bit for bit the
    launch without the argument; at shift sk every key is visible; at
    shift -sq nothing is, and o, lse and the grads are exactly 0 / NEG_INF
    / 0 in memory filled with NaN before the launch; a non-causal window
    at a negative shift and the window step across a shard boundary
    (partial bands with dead rows, exactly 0 with lse NEG_INF) are held
    with check_flash_segments' limits. Then the ring-step times
    (:func:`ring_step_times`). Returns those times by kernel name."""
    import importlib

    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(27)
    routes = {False: (ops.flash_attention_fwd, ops.flash_attention_bwd_dq,
                      ops.flash_attention_bwd_dkv),
              True: (ops.flash_attention_fwd_stream,
                     ops.flash_attention_bwd_dq_stream,
                     ops.flash_attention_bwd_dkv_stream)}

    def kernels(stream, q, k, v, do, kw, **shift):
        fwd, dq_fn, dkv_fn = routes[stream]
        b, h, sq, d = q.shape
        reused = poison(torch, dev, [((b, h, sq, d), q.dtype),
                                     ((b, h, sq), f32)])
        o, lse = fwd(q, k, v, **kw, **shift)
        delta = (o.float() * do.float()).sum(-1)
        poison(torch, dev, [((b, h, sq, d), q.dtype)])
        dq = dq_fn(q, k, v, do, lse, delta, **kw, **shift)
        poison(torch, dev, [(tuple(k.shape), k.dtype)] * 2)
        dk, dv = dkv_fn(q, k, v, do, lse, delta, **kw, **shift)
        torch.cuda.synchronize()
        return (o, lse, dq, dk, dv), delta, reused

    def plain(stream, q, k, v, o, lse, do, delta, kw):
        if stream:
            ro, rlse = ops.flash_attention_fwd_stream_reference(q, k, v, **kw)
            return (ro, rlse, ops.flash_attention_bwd_dq_stream_reference(
                q, k, v, do, lse, delta, **kw),
                *ops.flash_attention_bwd_dkv_stream_reference(
                    q, k, v, do, lse, delta, **kw))
        ro, rlse = ops.flash_attention_fwd_reference(q, k, v, **kw)
        return (ro, rlse, *ops.flash_attention_bwd_reference(
            q, k, v, o, lse, do, **kw))

    for stream in (False, True):
        for dt in (bf16, f32):
            route = ("streamed" if stream else "resident") + f" {str(dt)[6:]}"
            grp = f"flash ring offsets {route}"
            bf = dt == bf16
            for label, (b, h, sq, sk, d), causal, window, shift, kind in \
                    OFFSET_CASES:
                name = f"flash offsets {route} {label}"
                q, k, v, do = (torch.randn(b, h, n, d, device=dev,
                                           generator=gen).to(dt)
                               for n in (sq, sk, sk, sq))
                kw = dict(causal=causal, scale=d ** -0.5, window=window)
                got, delta, reused = kernels(stream, q, k, v, do, kw,
                                             shift=shift)
                o, lse, dq, dk, dv = got
                if kind == "zero":
                    base, _, _ = kernels(stream, q, k, v, do, kw)
                    same = [torch.equal(a, b_) for a, b_ in zip(got, base)]
                    verdict(f"{name}: bit for bit the launch without the "
                            f"shift", 0 if all(same) else 1, 0, group=grp)
                    print(f"  {name}: o, lse, dq, dk, dv bit-identical to "
                          f"the launch without the shift: {same}")
                    continue
                kw["shift"] = shift
                if kind == "empty":
                    exact = (bool((o == 0).all())
                             and bool((lse == tfa.NEG_INF).all())
                             and all(bool((g == 0).all())
                                     for g in (dq, dk, dv)))
                    verdict(f"{name}: o, dq, dk, dv exactly 0, lse NEG_INF",
                            0 if exact else 1, 0, group=grp)
                    print(f"  {name}: exactly 0 / NEG_INF {exact} (memory "
                          f"reused that read NaN: {reused})")
                    continue
                ro, rlse, rdq, rdk, rdv = plain(stream, q, k, v, o, lse, do,
                                                delta, kw)
                torch.cuda.synchronize()
                dead = rlse <= tfa.NEG_INF / 2
                exact = (bool((lse[dead] == tfa.NEG_INF).all())
                         and bool((o[dead] == 0).all())
                         and bool((dq[dead] == 0).all()))
                verdict(f"{name}: rows that see no key exactly 0, lse "
                        f"NEG_INF, dQ 0", 0 if exact else 1, 0, group=grp)
                lse_h = lse.masked_fill(dead, 0.0)[..., None]
                rlse_h = rlse.masked_fill(dead, 0.0)[..., None]
                ftol, frow = (2e-2, ROW_TOL[True][0]) if bf else SEG_F32_TOL
                btol, brow = (1e-2, ROW_TOL[True][1]) if bf else SEG_F32_TOL
                parts = [held(f"{name} o", o, ro, ftol, frow, group=grp),
                         held(f"{name} lse", lse_h, rlse_h, *LSE_TOL[:2],
                              floor=LSE_TOL[2], group=grp)]
                for gname, a, r in (("dq", dq, rdq), ("dk", dk, rdk),
                                    ("dv", dv, rdv)):
                    check(a.dtype == dt and a.shape == r.shape,
                          f"{name} {gname} dtype/shape")
                    parts.append(held(f"{name} {gname}", a, r, btol, brow,
                                      group=grp))
                print(f"  {name}: " + ", ".join(parts)
                      + f"; {int(dead.sum())} rows see no key, exactly 0 "
                      f"with lse NEG_INF (NaN memory reused: {reused})")
                del ro, rlse, rdq, rdk, rdv
            del q, k, v, do, got, o, lse, dq, dk, dv
            torch.cuda.empty_cache()
    return ring_step_times(torch, ops, dev, gen)


def ring_step_times(torch, ops, dev, gen):
    """Device times of the ring's steps at the 345M long-context shard
    shapes (:data:`RING_STEPS`), on the route the ring takes there (the
    streamed kernels): each kernel, its plain version at the same shift,
    the bound (the visible pairs at the shift) and a PyTorch yardstick
    (SDPA: causal for the diagonal, dense for the full band, with the
    boolean mask of the window step's band). Returns
    ``{kernel name: {label: {ms, plain_ms, bound_ms, bound_by,
    library_ms}}}``."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    names = {"fwd": "flash_attention_fwd_stream",
             "dq": "flash_attention_bwd_dq_stream",
             "dkv": "flash_attention_bwd_dkv_stream"}
    out = {n: {} for n in names.values()}
    for label, s, shift, window, lib in RING_STEPS:
        b, h, d = 1, 16, 64
        q, k, v, do = (torch.randn(b, h, s, d, device=dev,
                                   generator=gen).to(bf16) for _ in range(4))
        kw = dict(causal=True, scale=d ** -0.5, window=window, shift=shift)
        o, lse = ops.flash_attention_fwd_stream(q, k, v, **kw)
        delta = (o.float() * do.float()).sum(-1)
        t = {"fwd": {}, "dq": {}, "dkv": {}}
        t["fwd"]["ms"] = time_ms(
            lambda: ops.flash_attention_fwd_stream(q, k, v, **kw), 10)
        t["dq"]["ms"] = time_ms(lambda: ops.flash_attention_bwd_dq_stream(
            q, k, v, do, lse, delta, **kw), 10)
        t["dkv"]["ms"] = time_ms(lambda: ops.flash_attention_bwd_dkv_stream(
            q, k, v, do, lse, delta, **kw), 10)
        t["fwd"]["plain_ms"] = time_ms(
            lambda: ops.flash_attention_fwd_stream_reference(q, k, v, **kw),
            1, 2)
        t["dq"]["plain_ms"] = time_ms(
            lambda: ops.flash_attention_bwd_dq_stream_reference(
                q, k, v, do, lse, delta, **kw), 1, 2)
        t["dkv"]["plain_ms"] = time_ms(
            lambda: ops.flash_attention_bwd_dkv_stream_reference(
                q, k, v, do, lse, delta, **kw), 1, 2)
        fb, qb, kb, pairs = stream_bounds(b, h, s, s, d, True, window,
                                          shift=shift)
        for key, bd in (("fwd", fb), ("dq", qb), ("dkv", kb)):
            t[key]["bound_ms"], t[key]["bound_by"] = bd
        if lib == "causal":
            sdpa_kw = dict(is_causal=True)
        elif lib == "dense":
            sdpa_kw = {}
        else:  # the step's band: 0 <= (r + shift) - c < window
            i = torch.arange(s, device=dev, dtype=torch.int32)
            diff = i[:, None] + shift - i[None, :]
            sdpa_kw = dict(attn_mask=(diff >= 0) & (diff < window))
            del i, diff
        t["fwd"]["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, **sdpa_kw), 10)
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            so = F.scaled_dot_product_attention(ql, kl, vl, **sdpa_kw)
        torch.cuda.synchronize()
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            so, (ql, kl, vl), do, retain_graph=True), 10, stream=side)
        t["dq"]["library_ms"] = t["dkv"]["library_ms"] = lib_bwd
        del so, ql, kl, vl, sdpa_kw
        flops = {"fwd": 4, "dq": 6, "dkv": 8}
        for key, name in names.items():
            x = t[key]
            rate = flops[key] * d * pairs / x["ms"] / 1e9
            print(f"  ring step {label} {key}: kernel {x['ms']:.4f} ms "
                  f"({rate:.1f} TFLOP/s), bound {x['bound_ms']:.4f} ms "
                  f"({x['bound_by']}), plain {x['plain_ms']:.4f} ms, SDPA "
                  f"({lib}) {x['library_ms']:.4f} ms"
                  + (" (backward: dQ+dK+dV)" if key != "fwd" else ""))
            out[name][f"ring step {label}"] = x
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return out


def check_flash_attention_stream(torch, ops, dev):
    """The three streamed kernels (forward with its merge pass where a band
    has several splits, dQ, dK/dV) against their plain versions
    (``flash_attention_*_stream_reference``: per-split partials and the lse
    merge, split-wise dQ sums, q-split dK/dV sums) on the same inputs; the
    backward from the kernel forward's lse.
    Each output is held twice. As a share of max |ref| over the tensor:
    bf16 forward 2e-2 (P rounded to bf16 as an mma operand), bf16 backward
    1e-2 (P and dS rounded, then each output); fp32 1e-5 (fp32 sums in
    another order, and the dQ, dK, dV splits added by atomics in an order
    that changes from run to run). That max comes from the first rows,
    which see few keys and are large, so it cannot hold the long rows; the
    worst row's own error (:func:`row_err`, limits :data:`ROW_TOL`) does,
    and at the path shapes a tail of rows halved must fail it. Rows that
    see no key must give o = 0 and lse = -1e30 exactly. The bf16 kernels
    are the wgmma ones; the cases take them through d = 128, ragged
    128-row outer tiles, the fused-QKV views TMA reads as they are, rows
    TMA refuses (the wrappers' padded copies), and, with FWD_SPLIT_TILES
    cut for the case, the forward's partials and merge beside dead rows
    and query tiles with an empty band. Then device times at the
    two path shapes, at 4096 and at T = (8,16,1024,64) beside their bounds,
    the plain versions and SDPA (causal, or with the boolean band mask
    under the window), the forward's key tile and split length and the
    backward's split length against the values tried, and resident against
    streamed at 2048-16384 tokens (:func:`stream_min_seq_basis`, the
    numbers behind STREAM_MIN_SEQ)."""
    import importlib

    import torch.nn.functional as F

    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(9)

    def rand(*shape, dt):
        return torch.randn(*shape, device=dev, generator=gen).to(dt)

    def run(q, k, v, causal, window, label, fwd_split=None, twice=False):
        dt = q.dtype
        do = rand(*q.shape, dt=dt)
        scale = q.shape[-1] ** -0.5
        split_name = "FWD_SPLIT_TILES" if dt == bf16 else "FWD_F32_SPLIT_TILES"
        chosen = getattr(tfa, split_name)
        b, h, sq, d = q.shape
        try:  # a cut split length: bands of several splits, and the merge
            setattr(tfa, split_name, fwd_split or chosen)
            _, nsplit = tfa._fwd_bands(sq, k.shape[2], causal, window,
                                       tfa._fwd_tiles(dt == bf16, d))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            o, lse = ops.flash_attention_fwd_stream(q, k, v, causal=causal,
                                                    window=window)
            torch.cuda.synchronize()
            extra = (torch.cuda.max_memory_allocated() - base
                     - o.numel() * o.element_size() - lse.numel() * 4)
            o_ref, lse_ref = ops.flash_attention_fwd_stream_reference(
                q, k, v, causal=causal, window=window)
            if twice:
                o2, lse2 = ops.flash_attention_fwd_stream(
                    q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                same = torch.equal(o, o2) and torch.equal(lse, lse2)
                verdict(f"flash_attention_stream {label} deterministic",
                        0 if same else 1, 0,
                        group=f"flash_attention_stream {str(dt)[6:]}")
                del o2, lse2
        finally:
            setattr(tfa, split_name, chosen)
        if fwd_split:
            check(nsplit > 1, f"stream {label}: the cut split length leaves "
                  f"one split a band")
        if dt == f32:
            # the fp32 workspace (the partials of every split) exists only
            # where a band has several splits: a band of one is written
            # by the split pass itself, with no merge launch
            ws = max(nsplit, 1) * b * h * sq * d * 4
            check((extra >= ws // 2) == (nsplit > 1),
                  f"stream fwd {label}: {extra} bytes allocated beside o and "
                  f"lse with {nsplit} splits a band at most")
        delta = (o.float() * do.float()).sum(-1)
        kw = dict(causal=causal, scale=scale, window=window)
        dq = ops.flash_attention_bwd_dq_stream(q, k, v, do, lse, delta, **kw)
        dk, dv = ops.flash_attention_bwd_dkv_stream(q, k, v, do, lse, delta,
                                                    **kw)
        torch.cuda.synchronize()
        refs = (ops.flash_attention_bwd_dq_stream_reference(
            q, k, v, do, lse, delta, **kw),
            *ops.flash_attention_bwd_dkv_stream_reference(
                q, k, v, do, lse, delta, **kw))
        same_bwd = None
        if twice and dt == f32:  # one split a band: each element once
            again = (ops.flash_attention_bwd_dq_stream(q, k, v, do, lse,
                                                       delta, **kw),
                     *ops.flash_attention_bwd_dkv_stream(q, k, v, do, lse,
                                                         delta, **kw))
            torch.cuda.synchronize()
            same_bwd = all(torch.equal(a, b)
                           for a, b in zip((dq, dk, dv), again))
            verdict(f"flash_attention_stream {label} backward deterministic",
                    0 if same_bwd else 1, 0,
                    group=f"flash_attention_stream {str(dt)[6:]}")
            del again
        fwd_tol = 2e-2 if dt == bf16 else 1e-5
        bwd_tol = 1e-2 if dt == bf16 else 1e-5
        row_fwd, row_bwd = ROW_TOL[dt == bf16]
        check(o.dtype == dt and o.shape == q.shape, f"stream {label} o")
        dead = lse_ref <= tfa.NEG_INF / 2
        e_lse = max_err(lse[~dead], lse_ref[~dead]) if (~dead).any() else 0.0
        check(e_lse <= 1e-4 * max(1.0, float(lse_ref[~dead].abs().max())
                                  if (~dead).any() else 1.0),
              f"stream fwd {label}: lse err {e_lse:.3g}")
        n_dead = int(dead.sum())
        if n_dead:
            check(bool((o[dead] == 0).all()) and bool(
                (lse[dead] == tfa.NEG_INF).all()),
                f"stream fwd {label}: fully masked rows not exactly 0")
        parts = [f"lse {e_lse:.3g}"]
        worst = {"fwd": max_err(o, o_ref), "dq": max_err(dq, refs[0]),
                 "dkv": max(max_err(dk, refs[1]), max_err(dv, refs[2]))}
        sq = q.shape[2]
        for name, a, r, tol, rtol in zip(
                ("o", "dQ", "dK", "dV"), (o, dq, dk, dv), (o_ref, *refs),
                (fwd_tol, bwd_tol, bwd_tol, bwd_tol),
                (row_fwd, row_bwd, row_bwd, row_bwd)):
            check(a.dtype == dt and a.shape == r.shape,
                  f"stream {label} {name} dtype/shape")
            e, e_row = rel_err(a, r), row_err(a, r)
            parts.append(f"{name} {e:.3g} of max|ref| (tol {tol:g}), worst "
                         f"row {e_row:.3g} (tol {rtol:g})")
            grp = f"flash_attention_stream {str(dt)[6:]}"
            verdict(f"flash_attention_stream {label} {name}", e, tol,
                    group=grp)
            verdict(f"flash_attention_stream {label} {name} row", e_row,
                    rtol, group=grp)
            if sq >= 4096 and sq == a.shape[2]:
                # the row measure must catch a tail of rows gone half
                # wrong, which the share of max|ref| lets through
                bad = a.clone()
                bad[:, :, sq // 2:] *= 0.5
                planted = row_err(bad, r)
                check(planted > rtol, f"stream {label} {name}: the row "
                      f"measure misses a halved tail ({planted:.3g})")
                parts.append(f"halved tail: row {planted:.3g}, of max|ref| "
                             f"{rel_err(bad, r):.3g}")
                del bad
        merge = (f"; forward bands of up to {nsplit} splits, merged"
                 if nsplit > 1 else "; one split a band, no merge")
        if dt == f32:
            merge += f" ({extra} bytes allocated beside o and lse)"
        if twice:
            merge += "; a second forward bit-identical"
        if same_bwd is not None:
            merge += f", a second backward too: {same_bwd}"

        print(f"  flash_attention_stream {label}: " + ", ".join(parts)
              + f"; {n_dead} rows with no key exactly 0" + merge)
        return worst

    cases = [  # b, h, sq, sk, d, dtype, causal, window[, FWD_SPLIT_TILES]
        (1, 16, 8192, 8192, 64, bf16, True, None),
        (1, 16, 16384, 16384, 64, bf16, True, 4096),
        (1, 2, 4097, 4097, 64, f32, True, None),  # fp32: one split a band
        # fp32 with the split length cut to 2 key tiles: bands of several
        # splits and the merge; then partials beside dead rows
        (1, 2, 1000, 1000, 64, f32, True, 300, 2),
        (1, 2, 1000, 300, 64, f32, True, 100, 1),
        (1, 2, 4097, 4097, 64, bf16, True, 1000),
        (2, 3, 1000, 1000, 16, f32, False, 100),
        (2, 3, 1000, 1000, 16, bf16, True, None),
        (1, 2, 1000, 1000, 128, f32, True, 300),
        (1, 4, 1000, 1000, 128, bf16, False, 200),
        (1, 2, 300, 77, 64, f32, True, 16),     # rows past 92 see no key
        (1, 2, 300, 77, 64, bf16, True, 16),
        # d = 36: 72-byte rows, which TMA refuses: the backward's padded copy
        (2, 2, 100, 120, 36, bf16, False, 30),
        (1, 2, 77, 300, 40, f32, False, None),
        # the wide wgmma path (d = 128) and its register budget
        (1, 4, 4096, 4096, 128, bf16, True, 1024),
        # ragged 128-row outer tiles on both sides
        (1, 3, 1100, 990, 64, bf16, True, None),
        # the bf16 forward's partials and merge: bands of up to 16 splits
        # (2 key tiles each); then partials beside a dead-row tail and
        # query tiles whose band is empty
        (1, 4, 4096, 4096, 64, bf16, True, 1000, 2),
        (1, 2, 1000, 300, 64, bf16, True, 100, 1),
    ]
    main_err = None
    for b, h, sq, sk, d, dt, causal, window, *split in cases:
        q, k, v = rand(b, h, sq, d, dt=dt), rand(b, h, sk, d, dt=dt), \
            rand(b, h, sk, d, dt=dt)
        name = "FWD_SPLIT_TILES" if dt == bf16 else "FWD_F32_SPLIT_TILES"
        err = run(q, k, v, causal, window, f"b={b} h={h} sq={sq} sk={sk} "
                  f"d={d} {str(dt)[6:]} causal={causal} window={window}"
                  + (f" {name}={split[0]}" if split else ""),
                  *split, twice=dt == f32 and sk > 300)
        if main_err is None:
            main_err = err
        del q, k, v
    qkv = rand(1, 4096, 4, 3, 64, dt=bf16).permute(0, 2, 3, 1, 4)
    run(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], True, 512,
        "strided fused-QKV view (1,4,4096,64) bf16 causal window=512")
    # rows 136 bytes apart: TMA refuses the stride, so the backward wrapper
    # passes contiguous copies (tfa._tma_operands) and slices dQ back
    wide = [rand(1, 2, 1000, 68, dt=bf16) for _ in range(3)]
    strided = [t[..., :64] for t in wide]
    check(not tfa._tma_ok(strided[0]), "the 136-byte stride is one TMA "
          "refuses")
    run(*strided, True, None, "strided view (1,2,1000,64) of 68-wide rows "
        "bf16 causal: the padded copy")
    del wide, strided
    # the entry point routes: stream='always' at 1000 tokens, a window at
    # 1024, and 'auto' at 4096 all take the streamed kernels
    before = ops.launch_counts()
    q = rand(1, 2, 1000, 64, dt=bf16)
    ops.flash_attention(q, q, q, causal=True, stream="always")
    ops.flash_attention(q, q, q, causal=True, window=128)
    q = rand(1, 2, 4096, 64, dt=bf16)
    ops.flash_attention(q, q, q, causal=True)
    after = ops.launch_counts()
    check(after["flash_attention_fwd_stream"]
          - before["flash_attention_fwd_stream"] == 3
          and after["flash_attention_fwd"] == before["flash_attention_fwd"],
          "flash_attention routes always / window / auto-4096 to the "
          "streamed forward")
    del q, qkv
    torch.cuda.empty_cache()
    check_fp32_stream_bwd(torch, ops, dev, gen)

    def timings(b, h, s, d, window):
        q, k, v, do = (rand(b, h, s, d, dt=bf16) for _ in range(4))
        scale = d ** -0.5
        kw = dict(causal=True, scale=scale, window=window)
        o, lse = ops.flash_attention_fwd_stream(q, k, v, causal=True,
                                                window=window)
        delta = (o.float() * do.float()).sum(-1)
        out = {"fwd": {}, "dq": {}, "dkv": {}}
        out["fwd"]["ms"] = time_ms(lambda: ops.flash_attention_fwd_stream(
            q, k, v, causal=True, window=window), 10)
        out["dq"]["ms"] = time_ms(lambda: ops.flash_attention_bwd_dq_stream(
            q, k, v, do, lse, delta, **kw), 10)
        out["dkv"]["ms"] = time_ms(
            lambda: ops.flash_attention_bwd_dkv_stream(q, k, v, do, lse,
                                                       delta, **kw), 10)
        out["fwd"]["plain_ms"] = time_ms(
            lambda: ops.flash_attention_fwd_stream_reference(
                q, k, v, causal=True, window=window), 1, 2)
        out["dq"]["plain_ms"] = time_ms(
            lambda: ops.flash_attention_bwd_dq_stream_reference(
                q, k, v, do, lse, delta, **kw), 1, 2)
        out["dkv"]["plain_ms"] = time_ms(
            lambda: ops.flash_attention_bwd_dkv_stream_reference(
                q, k, v, do, lse, delta, **kw), 1, 2)
        fb, qb, kb, pairs = stream_bounds(b, h, s, s, d, True, window)
        for key, bd in (("fwd", fb), ("dq", qb), ("dkv", kb)):
            out[key]["bound_ms"], out[key]["bound_by"] = bd
        # SDPA as the yardstick: causal, or under a window the boolean
        # band mask (keys [p-w+1, p]), built once outside the timed call
        if window is None:
            sdpa_kw = dict(is_causal=True)
        else:
            i = torch.arange(s, device=dev, dtype=torch.int32)
            diff = i[:, None] - i[None, :]
            sdpa_kw = dict(attn_mask=(diff >= 0) & (diff < window))
            del i, diff
        out["fwd"]["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, **sdpa_kw), 10)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            so = F.scaled_dot_product_attention(ql, kl, vl, **sdpa_kw)
        torch.cuda.synchronize()
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            so, (ql, kl, vl), do, retain_graph=True), 10, stream=side)
        out["dq"]["library_ms"] = out["dkv"]["library_ms"] = lib_bwd
        del so, ql, kl, vl, sdpa_kw
        label = f"({b},{h},{s},{d}) bf16 causal" + (
            f" window {window}" if window else "")
        flops = {"fwd": 4, "dq": 6, "dkv": 8}
        for key in ("fwd", "dq", "dkv"):
            t = out[key]
            lib = (f", SDPA {t['library_ms']:.4f} ms"
                   + (" with the band mask" if window else "")
                   + (" (backward: dQ+dK+dV)" if key != "fwd" else ""))
            rate = flops[key] * d * pairs / t["ms"] / 1e9
            print(f"  flash_attention_stream timing {label} {key}: kernel "
                  f"{t['ms']:.4f} ms ({rate:.1f} TFLOP/s), bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
                  f"{t['plain_ms']:.4f} ms{lib}")
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
        return label, out

    by_shape = dict(timings(b, 16, s, 64, w)
                    for b, s, w in ((1, 8192, None), (1, 16384, 4096),
                                    (1, 4096, None), (8, 1024, None)))
    main_label = "(1,16,8192,64) bf16 causal"
    fwd_split_tuning(torch, ops, tfa, rand)
    f32_split = fwd_f32_split_tuning(torch, ops, tfa, rand)
    bwd_split_tuning(torch, ops, tfa, rand)
    stream_min_seq_basis(torch, ops, tfa, rand)
    rows = []
    fo, fi, fs = tfa._fwd_tiles(False, 64)
    bo, bi, _ = tfa._bwd_tiles(False, True, 64)
    f32_bwd = (f"; fp32: {{}}_f32_blocked<64, {bo // 16}, {{}}> (the resident "
               f"fp32 pair's register-blocked FMA fed by a cp.async ring, "
               f"over whole bands, each element written once; "
               f"csrc/flash_attention_bwd.cu)")
    for key, name, line, kernel in (
            ("fwd", "flash_attention_fwd_stream", 506,
             f"fwd_wgmma<64, {tfa.FWD_INNER_TILE}> (wgmma fed by a TMA "
             f"ring); fp32: fwd_f32_blocked<64, {fo // 16}, {fi}> split "
             f"instances (register-blocked FMA fed by a cp.async ring, "
             f"splits of up to {fs} key tiles; csrc/flash_f32_blocked.cuh); "
             f"fwd_merge only where a band has several splits"),
            ("dq", "flash_attention_bwd_dq_stream", 576,
             "dq_wgmma<64> (wgmma fed by a TMA ring)"
             + f32_bwd.format("dq", bi)),
            ("dkv", "flash_attention_bwd_dkv_stream", 637,
             "dkv_wgmma<64> (wgmma fed by a TMA ring)"
             + f32_bwd.format("dkv", tfa._bwd_tiles(False, False, 64)[1]))):
        main = by_shape[main_label][key]
        rows.append(dict(
            name=name, route="cuda", kernel=kernel,
            source="apex_tpu_torch/csrc/flash_attention_stream.cu",
            replaces=f"apex_tpu/ops/flash_attention.py:{line}",
            max_abs_err=main_err[key],
            by_shape={lab: t[key] for lab, t in by_shape.items()}, **main))
    rows[0]["fwd_f32_split_tuning"] = f32_split
    return rows


def stream_min_seq_basis(torch, ops, tfa, rand,
                         lengths=(2048, 4096, 8192, 16384)):
    """The numbers behind STREAM_MIN_SEQ: at each length (batch 1, 16 heads
    of 64, bf16, causal, no window) the device times of the resident
    forward, dQ and dK/dV beside the streamed ones, and their totals, one
    line a length."""
    for s in lengths:
        q, k, v, do = (rand(1, 16, s, 64, dt=torch.bfloat16)
                       for _ in range(4))
        kw = dict(causal=True, scale=0.125)
        t = {}
        for route, fwd, dq, dkv in (
                ("resident", ops.flash_attention_fwd,
                 ops.flash_attention_bwd_dq, ops.flash_attention_bwd_dkv),
                ("streamed", ops.flash_attention_fwd_stream,
                 ops.flash_attention_bwd_dq_stream,
                 ops.flash_attention_bwd_dkv_stream)):
            o, lse = fwd(q, k, v, causal=True)
            delta = (o.float() * do.float()).sum(-1)
            t[route] = (
                time_ms(lambda: fwd(q, k, v, causal=True), 10),
                time_ms(lambda: dq(q, k, v, do, lse, delta, **kw), 10),
                time_ms(lambda: dkv(q, k, v, do, lse, delta, **kw), 10))
            del o, lse, delta
        res, st = t["resident"], t["streamed"]
        print(f"  STREAM_MIN_SEQ basis (1,16,{s},64) bf16 causal: forward + "
              f"dQ + dK/dV resident {res[0]:.4f} + {res[1]:.4f} + "
              f"{res[2]:.4f} = {sum(res):.4f} ms, streamed {st[0]:.4f} + "
              f"{st[1]:.4f} + {st[2]:.4f} = {sum(st):.4f} ms (resident/"
              f"streamed {sum(res) / sum(st):.4f}; routed "
              f"{'streamed' if s >= tfa.STREAM_MIN_SEQ else 'resident'})")
        del q, k, v, do
        torch.cuda.empty_cache()


def fwd_split_tuning(torch, ops, tfa, rand, lengths=(16, 32, 64, 128)):
    """The key tile and the split length of the bf16 streamed forward
    (FWD_INNER_TILE rows, FWD_SPLIT_TILES key tiles a CTA) against the
    values tried, at L and W: device times on one line."""
    inner, chosen = tfa.FWD_INNER_TILE, tfa.FWD_SPLIT_TILES
    parts = []
    for label, s, window in (("L", 8192, None), ("W", 16384, 4096)):
        q, k, v = (rand(1, 16, s, 64, dt=torch.bfloat16) for _ in range(3))
        try:
            for tile in (128, 64):
                tfa.FWD_INNER_TILE = tile
                times = []
                for split in lengths:
                    tfa.FWD_SPLIT_TILES = split
                    ms = time_ms(lambda: ops.flash_attention_fwd_stream(
                        q, k, v, causal=True, window=window), 10)
                    times.append(f"{split}: {ms:.4f}")
                parts.append(f"{label} inner {tile} " + ", ".join(times))
        finally:
            tfa.FWD_INNER_TILE, tfa.FWD_SPLIT_TILES = inner, chosen
        del q, k, v
        torch.cuda.empty_cache()
    print(f"  FWD_INNER_TILE = {inner}, FWD_SPLIT_TILES = {chosen} (chosen);"
          f" forward ms by key tile and split length: " + "; ".join(parts))


def fwd_f32_split_tuning(torch, ops, tfa, rand,
                         lengths=(2, 4, 8, 16, 32, 128)):
    """The split length of the fp32 streamed forward (FWD_F32_SPLIT_TILES
    key tiles of FWD_F32_INNER_TILE rows a CTA) against the lengths tried,
    at RP = (1,16,317,64) causal, window 256 (generate_gpt's longest RoPE
    prefill) and at L = (1,16,8192,64) causal, in fp32: device times on one
    line with the splits of the longest band each takes (a length that cuts
    the same splits as a shorter one is skipped); returned for the
    ``kernels`` line (``fwd_f32_split_tuning``)."""
    chosen = tfa.FWD_F32_SPLIT_TILES
    out, parts = {}, []
    for label, s, window in (("RP", 317, 256), ("L", 8192, None)):
        q, k, v = (rand(1, 16, s, 64, dt=torch.float32) for _ in range(3))
        t = out[label] = {}
        seen = set()
        try:
            for split in lengths:
                tfa.FWD_F32_SPLIT_TILES = split
                _, ns = tfa._fwd_bands(s, s, True, window,
                                       tfa._fwd_tiles(False, 64))
                if ns in seen:
                    continue
                seen.add(ns)
                t[f"split {split} ({ns})"] = time_ms(
                    lambda: ops.flash_attention_fwd_stream(
                        q, k, v, causal=True, window=window), 10)
        finally:
            tfa.FWD_F32_SPLIT_TILES = chosen
        parts.append(f"{label}: " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in t.items()))
        del q, k, v
        torch.cuda.empty_cache()
    print(f"  FWD_F32_SPLIT_TILES = {chosen} (chosen: one split a band at RP "
          f"and L, no workspace and no merge); fp32 forward ms at "
          f"{tfa.FWD_F32_OUTER_TILE} x {tfa.FWD_F32_INNER_TILE} tiles by "
          f"split length (splits of the longest band): " + "; ".join(parts)
          + f"; {nvidia_smi()}")
    return {"chosen": {"split_tiles": chosen}, "ms": out}


def bwd_split_tuning(torch, ops, tfa, rand, lengths=(16, 32, 64, 128)):
    """The split length of the bf16 streamed backward (BWD_SPLIT_TILES
    inner tiles a CTA) against the lengths tried, at L and W: device times of
    dQ and dK/dV at each, on one line."""
    chosen = tfa.BWD_SPLIT_TILES
    parts = []
    for label, s, window in (("L", 8192, None), ("W", 16384, 4096)):
        q, k, v, do = (rand(1, 16, s, 64, dt=torch.bfloat16)
                       for _ in range(4))
        o, lse = ops.flash_attention_fwd_stream(q, k, v, causal=True,
                                                window=window)
        delta = (o.float() * do.float()).sum(-1)
        kw = dict(causal=True, scale=0.125, window=window)
        times = []
        try:
            for split in lengths:
                tfa.BWD_SPLIT_TILES = split
                dq = time_ms(lambda: ops.flash_attention_bwd_dq_stream(
                    q, k, v, do, lse, delta, **kw), 10)
                dkv = time_ms(lambda: ops.flash_attention_bwd_dkv_stream(
                    q, k, v, do, lse, delta, **kw), 10)
                times.append(f"{split}: {dq:.4f} + {dkv:.4f}")
        finally:
            tfa.BWD_SPLIT_TILES = chosen
        parts.append(f"{label} " + ", ".join(times))
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    print(f"  BWD_SPLIT_TILES = {chosen} (chosen); dQ + dK/dV ms by split "
          f"length: " + "; ".join(parts))


#: the decode timing shapes: single-query (b, h, kh, blk, d, num_blocks,
#: max_blocks, lengths), the chunk and verify K-query shapes (b, h, kh, K,
#: blk, d, num_blocks, max_blocks, lengths), and the single-slot case
DECODE_MAIN = (8, 16, 16, 16, 64, 513, 64, [700, 64, 1024, 0, 333, 17, 800,
                                            513])
DECODE_CHUNK = (1, 16, 16, 256, 16, 64, 513, 64, [756])
DECODE_VERIFY = (8, 16, 16, 5, 16, 64, 513, 64, [700, 64, 1000, 0, 333, 5,
                                                 800, 513])
DECODE_LONG = (1, 16, 16, 16, 64, 600, 512, [8192])
#: phase 10 (e)'s chunks: 128 queries of one slot with window 256, the
#: third chunk of a 317-token prompt (K-query shape as DECODE_CHUNK, then
#: the window)
DECODE_CHUNK_W = (1, 16, 16, 128, 16, 64, 513, 64, [317], 256)


def _decode_inputs(torch, dev, gen, b, h, kh, blk, d, nb, max_blocks, dt,
                   lengths):
    q = torch.randn(b, h, d, device=dev, generator=gen).to(dt)
    kp = torch.randn(nb, kh, blk, d, device=dev, generator=gen).to(dt)
    vp = torch.randn(nb, kh, blk, d, device=dev, generator=gen).to(dt)
    perm = torch.randperm(nb - 1, device=dev, generator=gen) + 1
    tables = perm[:b * max_blocks].view(b, max_blocks).to(torch.int32)
    lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
    return q, kp, vp, tables, lens


def _decode_route(ops, q, kp, vp, dt):
    """The route a decode call takes on the card, for the verdict names."""
    import importlib

    tfd = importlib.import_module("apex_tpu_torch.ops.flash_decode")
    aligned = not (q.data_ptr() | kp.data_ptr() | vp.data_ptr()) & 15
    return tfd.decode_route(dt, q.shape[-1], kp.shape[2], aligned)


def _decode_held(torch, name, got, ref, dt, group, route, blind=()):
    """Hold one decode output to its plain version: max |err| (0.02 bf16,
    5e-5 fp32), each row's own error (:func:`row_err`, :data:`ROW_TOL`),
    rows that see no key (``blind``: index tuples into ``got``) exactly 0,
    finite values of q's shape and dtype. Returns (max |err|, row err)."""
    bf16 = torch.bfloat16
    err, e_row = max_err(got, ref), row_err(got, ref)
    tol, rtol = (2e-2 if dt == bf16 else 5e-5), ROW_TOL[dt == bf16][0]
    zero = all(bool((got[i] == 0).all()) for i in blind)
    print(f"  {name} [{route}]: max_abs_err={err:.3g} (tol {tol:g}), worst "
          f"row {e_row:.3g} (tol {rtol:g}); {len(blind)} rows that see no "
          f"key exactly 0: {zero}")
    check(zero and bool(torch.isfinite(got).all())
          and got.shape == ref.shape and got.dtype == dt, f"{name} [{route}]")
    verdict(f"{name} [{route}]", err, tol, f"cuda {route}", group=group)
    verdict(f"{name} [{route}] worst row", e_row, rtol, f"cuda {route}",
            group=f"{group} rows")
    return err, e_row


def _planted_tail(torch, name, got, ref, dt, route, group):
    """Halve the last quarter of the output rows: the row check must fail
    it (a planted fault the max |err| limit alone can miss)."""
    rows = got.reshape(-1, got.shape[-1])
    bad = rows.clone()
    bad[-(rows.shape[0] // 4):] *= 0.5
    planted = row_err(bad.view_as(got), ref)
    rlim = ROW_TOL[dt == torch.bfloat16][0]
    print(f"  {name} [{route}]: planted fault (last quarter of the rows "
          f"halved) reads {planted:.3g} by row, limit {rlim:g}: caught "
          f"{planted > rlim}")
    check(planted > rlim, f"{name}: the row check misses a halved tail")
    verdict(f"{name} planted halved tail caught", 0 if planted > rlim else 1,
            0, f"cuda {route}", group=group)


def _bit_identical(torch, name, call, route, group):
    """Two calls on the same inputs give the same bits (a fixed-order
    combine, no atomics on the output)."""
    a, b = call(), call()
    torch.cuda.synchronize()
    same = torch.equal(a, b)
    print(f"  {name} [{route}]: two calls bit-identical: {same}")
    check(same, f"{name}: two calls differ")
    verdict(f"{name} two calls bit-identical", 0 if same else 1, 0,
            f"cuda {route}", group=group)


def _f32_pool(torch, pool, off):
    """A contiguous copy of ``pool`` that starts ``off`` floats past a 16-byte
    boundary (off 16 bytes for off % 4 != 0: the fp32 route's 4-byte
    copies)."""
    flat = torch.empty(pool.numel() + off, device=pool.device,
                       dtype=pool.dtype)
    return flat[off:].view(pool.shape).copy_(pool)


def _nan_filled_call(torch, name, call, ref, blind, route, group):
    """The call with its output memory NaN-filled first (the caching
    allocator's freed block of the output's shape, :func:`poisoned_empty`):
    every element finite and within the fp32 limit, the rows that see no key
    exactly 0 -- each written by the kernel, none left to the memory."""
    reused = poisoned_empty(torch, tuple(ref.shape), ref.device)
    got = call()
    torch.cuda.synchronize()
    ok = bool(torch.isfinite(got).all()) and all(
        bool((got[i] == 0).all()) for i in blind)
    err = max_err(got, ref)
    print(f"  {name} [{route}]: output memory NaN-filled first (reuse seen "
          f"{reused}): finite with {len(blind)} blind rows exactly 0: {ok}, "
          f"max_abs_err={err:.3g}")
    check(ok, f"{name}: a NaN left in the output or a blind row not 0")
    verdict(f"{name} NaN-filled output", err, 5e-5, f"cuda {route}",
            group=group)


def check_flash_decode(torch, ops, dev):
    """The paged decode kernel against ``paged_attention_reference`` at the
    serve's decode shape (b=8, 16 heads of 64 over 16-token pages), GQA,
    other pages (8, 12, 16, 32, 128 tokens) and head_dims, pools off 16
    bytes, the window, and the split routes' edges (lengths on a split
    edge, 1, a full 1024-key slot, idle slots only, one slot of 16384
    keys), bf16 and fp32: each output by max |err| and by row
    (:func:`_decode_held`), idle slots exactly 0; a halved tail of rows at
    the decode shape must fail the row check; two calls bit-identical. In
    fp32 also lengths on a split's last page at 1, 2, 3 and 8 splits and a
    call into NaN-filled output memory. Then device times and the
    split-count tuning lines (:func:`decode_split_tuning`)."""
    import importlib

    tfd = importlib.import_module("apex_tpu_torch.ops.flash_decode")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(3)
    main_lengths = DECODE_MAIN[7]  # slot 3 idle
    # lengths on the split routes' edges at the decode shape: a length that
    # ends a split's last page, one past it, 1, a full slot, a page's end
    splits = tfd.decode_splits(8, 16, 1, 64)
    edge = 16 * splits * 5
    edge_lengths = [edge, edge + 1, 1, 1024, 0, 16, 17, 16 * splits]
    f32_splits = tfd.decode_splits(8, 16, 1, 64, f32=True)
    f32_edge = [16 * f32_splits * 5, 16 * f32_splits * 5 + 1, 1, 1024, 0,
                16, 17, 16 * f32_splits]
    cases = [  # b, h, kh, blk, d, num_blocks, max_blocks, dtype, lengths
        (8, 16, 16, 16, 64, 513, 64, bf16, main_lengths),
        (8, 16, 16, 16, 64, 513, 64, f32, main_lengths),
        (8, 32, 16, 16, 64, 513, 64, bf16, main_lengths),   # GQA h = 2 kh
        (8, 32, 16, 16, 64, 513, 64, f32, main_lengths),
        (3, 8, 2, 8, 64, 40, 12, f32, [95, 0, 1]),
        (2, 4, 4, 128, 64, 9, 4, f32, [300, 512]),
        (3, 8, 2, 12, 64, 40, 12, f32, [131, 0, 12]),  # 12-token pages
        (4, 16, 16, 32, 40, 40, 8, f32, [256, 1, 200, 33]),  # d 40
        (2, 64, 4, 16, 128, 20, 8, f32, [100, 7]),  # d 128, 16 rows a group
        (2, 4, 2, 16, 38, 20, 8, f32, [100, 7]),  # d % 4: 4-byte copies
        (2, 4, 2, 16, 160, 20, 8, f32, [100, 7]),  # d 160: the gather route
        (2, 4, 2, 16, 128, 20, 8, bf16, [100, 7]),
        (2, 4, 2, 16, 36, 20, 8, bf16, [100, 7]),  # unaligned: scalar loads
        # the split routes' edges
        (8, 16, 16, 16, 64, 513, 64, bf16, edge_lengths),
        (8, 16, 16, 16, 64, 513, 64, f32, f32_edge),
        (8, 16, 16, 16, 64, 513, 64, bf16, [0] * 8),  # idle slots only
        (8, 16, 16, 16, 64, 513, 64, f32, [0] * 8),
        (1, 16, 16, 16, 64, 1100, 1024, bf16, [16384]),
        (1, 16, 16, 16, 64, 1100, 1024, f32, [16384]),
        (3, 8, 2, 8, 64, 40, 12, bf16, [95, 0, 1]),   # 8-token pages
        (2, 4, 4, 128, 64, 9, 4, bf16, [300, 512]),   # 128-token pages
        (2, 4, 2, 16, 40, 20, 8, bf16, [100, 7]),     # d 40: zero columns
    ]
    windowed = [  # the same shapes with window = 128 (and 5 at blk 8)
        (8, 16, 16, 16, 64, 513, 64, bf16, main_lengths, 128),
        (8, 16, 16, 16, 64, 513, 64, f32, main_lengths, 128),
        (8, 32, 16, 16, 64, 513, 64, bf16, main_lengths, 128),
        (3, 8, 2, 8, 64, 40, 12, f32, [95, 0, 1], 5),
        (3, 8, 2, 12, 64, 40, 12, f32, [131, 0, 12], 30),
        (2, 4, 2, 16, 36, 20, 8, bf16, [100, 7], 128),
        (8, 16, 16, 16, 64, 513, 64, bf16, edge_lengths, 128),
        (8, 16, 16, 16, 64, 513, 64, f32, f32_edge, 128),
        (3, 8, 2, 8, 64, 40, 12, bf16, [95, 0, 1], 5),
    ]
    main_err = None
    for b, h, kh, blk, d, nb, mb, dt, lengths, window in (
            [c + (None,) for c in cases] + windowed):
        q, kp, vp, tables, lens = _decode_inputs(
            torch, dev, gen, b, h, kh, blk, d, nb, mb, dt, lengths)
        got = ops.flash_decode(q, kp, vp, tables, lens, window=window)
        ref = ops.paged_attention_reference(q, kp, vp, tables, lens,
                                            window=window)
        torch.cuda.synchronize()
        route = _decode_route(ops, q, kp, vp, dt)
        name = (f"flash_decode b={b} h={h} kh={kh} blk={blk} d={d} "
                f"{str(dt)[6:]} window={window} lengths {lengths[:8]}")
        blind = [(i,) for i, n in enumerate(lengths) if n == 0]
        err, _ = _decode_held(
            torch, name, got, ref, dt, f"flash_decode {str(dt)[6:]}", route,
            blind)
        if window is not None and max(lengths) > window:
            full = ops.paged_attention_reference(q, kp, vp, tables, lens)
            check(max_err(full, ref) > (2e-2 if dt == bf16 else 5e-5),
                  "the window changes the output")
        if main_err is None:
            main_err = err
        if (b, h, d, lengths, window) == (8, 16, 64, main_lengths, None):
            _planted_tail(torch, f"flash_decode {str(dt)[6:]} decode shape",
                          got, ref, dt, route,
                          f"flash_decode {str(dt)[6:]} rows")
            _bit_identical(torch, f"flash_decode {str(dt)[6:]} decode shape",
                           lambda: ops.flash_decode(q, kp, vp, tables, lens),
                           route, f"flash_decode {str(dt)[6:]}")
        if dt == f32 and (b, d, lengths, window) == (8, 64, f32_edge, None):
            # the same edges at other split counts, then pools off 16 bytes
            # (4-byte copies) and output memory that read NaN
            for n in (1, 2, 3, 8):
                _decode_held(
                    torch, f"{name} splits={n}",
                    ops.flash_decode_fwd(q, kp, vp, tables, lens, splits=n),
                    ref, dt, "flash_decode float32", route, blind)
            kp4, vp4 = _f32_pool(torch, kp, 1), _f32_pool(torch, vp, 3)
            _decode_held(torch, f"{name} pools off 16 bytes",
                         ops.flash_decode(q, kp4, vp4, tables, lens), ref,
                         dt, "flash_decode float32", route, blind)
            del kp4, vp4
            _nan_filled_call(
                torch, "flash_decode float32 edges",
                lambda: ops.flash_decode(q, kp, vp, tables, lens), ref,
                blind, route, "flash_decode float32")
    b, h, kh, blk, d, nb, mb, lengths = DECODE_MAIN
    q, kp, vp, tables, lens = _decode_inputs(
        torch, dev, gen, b, h, kh, blk, d, nb, mb, bf16, lengths)
    t = decode_times(torch, ops, dev)
    ms, issue = t["decode"], t["decode_issue"]
    plain = time_ms(
        lambda: ops.paged_attention_reference(q, kp, vp, tables, lens), 5)
    live = sum(lengths)
    nbytes = (live * kh * d * 2 * 2 + 2 * b * h * d * 2 + b * mb * 4 + b * 4)
    bms, by = bound(nbytes, 4 * h * d * live, "bfloat16")
    print(f"  flash_decode timing (b=8 h=kh=16 blk=16 d=64 bf16, {live} live "
          f"keys, {splits} splits): kernel {ms:.4f} ms (eager issue "
          f"{issue:.4f} ms per call, least of 9 windows; host alone "
          f"{t['decode_host']:.4f} ms), plain {plain:.4f} ms, no single "
          f"PyTorch call computes paged decode, bound {bms:.4f} ms ({by})")
    # the same inputs with window 128, and through the K-query kernel at
    # K = 1 (the same function); one slot over 8192 keys: not checks
    live_w = sum(min(n, 128) for n in lengths)
    bms_w, by_w = bound(nbytes - (live - live_w) * kh * d * 2 * 2,
                        4 * h * d * live_w, "bfloat16")
    ms_k1 = time_ms(lambda: ops.flash_decode_multi(q[:, :, None], kp, vp,
                                                   tables, lens))
    b1, h1, kh1, blk1, d1, _, mb1, lengths1 = DECODE_LONG
    bms_l, by_l = bound(lengths1[0] * kh1 * d1 * 4 + 2 * h1 * d1 * 2
                        + mb1 * 4 + 4, 4 * h1 * d1 * lengths1[0], "bfloat16")
    print(f"  flash_decode timing with window 128 ({live_w} live keys): "
          f"kernel {t['window_128']:.4f} ms, bound {bms_w:.4f} ms ({by_w}); "
          f"the same unwindowed call through flash_decode_multi at K=1: "
          f"{ms_k1:.4f} ms; b=1 over 8192 keys: {t['b1_8192']:.4f} ms, "
          f"bound {bms_l:.4f} ms ({by_l})")
    tuning = decode_split_tuning(torch, ops, dev)
    by_shape = {"decode": dict(ms=ms, issue_ms=issue,
                               host_ms=t["decode_host"], bound_ms=bms,
                               bound_by=by),
                "window_128": dict(ms=t["window_128"], bound_ms=bms_w,
                                   bound_by=by_w),
                "b1_8192": dict(ms=t["b1_8192"], bound_ms=bms_l,
                                bound_by=by_l)}
    return dict(name="flash_decode", route="cuda",
                kernel="flash_decode_split (bf16), flash_decode_f32 (fp32), "
                       "flash_decode_kernel (unaligned bf16, fp32 d > 128)",
                source="apex_tpu_torch/csrc/flash_decode.cu",
                replaces="apex_tpu/ops/flash_decode.py:141",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None, by_shape=by_shape,
                decode_tuning=tuning)


def decode_split_tuning(torch, ops, dev, tried=(1, 2, 3, 4, 8)):
    """The split count against the values tried, bf16 and fp32 (labels
    ``fp32 ...``), at #9's decode shape, with window 128 and at b = 1 over
    8192 keys, and at #10's chunk and verify shapes: device ms per split
    count beside the count :func:`decode_splits` takes (bf16:
    ``DECODE_SPLIT_PAGES`` pages a split, at most ``DECODE_SPLIT_CTAS`` CTAs
    an SM; fp32: ``DECODE_F32_SPLIT_PAGES`` / ``DECODE_F32_SPLIT_CTAS``),
    printed one line a dtype and returned for the ``kernels`` line
    (``decode_tuning``)."""
    import importlib

    tfd = importlib.import_module("apex_tpu_torch.ops.flash_decode")
    gen = torch.Generator(device=dev).manual_seed(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        f32, tag = dt == torch.float32, ("fp32 " if dt == torch.float32
                                         else "")
        b, h, kh, blk, d, nb, mb, lengths = DECODE_MAIN
        q, kp, vp, tables, lens = _decode_inputs(torch, dev, gen, b, h, kh,
                                                 blk, d, nb, mb, dt, lengths)
        b1, h1, kh1, blk1, d1, nb1, mb1, lengths1 = DECODE_LONG
        q1, kp1, vp1, t1, l1 = _decode_inputs(torch, dev, gen, b1, h1, kh1,
                                              blk1, d1, nb1, mb1, dt,
                                              lengths1)
        shapes = {
            "decode": (lambda s: ops.flash_decode_fwd(q, kp, vp, tables,
                                                      lens, splits=s),
                       tfd.decode_splits(b, kh, 1, mb, sms, f32)),
            "window_128": (lambda s: ops.flash_decode_fwd(
                q, kp, vp, tables, lens, window=128, splits=s),
                tfd.decode_splits(b, kh, 1,
                                  tfd.decode_span_pages(mb, blk, 128), sms,
                                  f32)),
            "b1_8192": (lambda s: ops.flash_decode_fwd(q1, kp1, vp1, t1, l1,
                                                       splits=s),
                        tfd.decode_splits(b1, kh1, 1, mb1, sms, f32))}
        for label, (b, h, kh, kq, blk, d, nb, mb, lengths) in (
                ("chunk", DECODE_CHUNK), ("verify", DECODE_VERIFY)):
            _, kpm, vpm, tm, lm = _decode_inputs(torch, dev, gen, b, h, kh,
                                                 blk, d, nb, mb, dt, lengths)
            qm = torch.randn(b, h, kq, d, device=dev, generator=gen).to(dt)
            tiles = -(-(h // kh * kq) // tfd.DECODE_ROWS)
            shapes[label] = (
                lambda s, a=(qm, kpm, vpm, tm, lm): ops.flash_decode_multi_fwd(
                    *a, splits=s),
                tfd.decode_splits(b, kh, tiles, mb, sms, f32))
        for label, (call, chosen) in shapes.items():
            ms = {s: time_ms(lambda: call(s))
                  for s in sorted({*tried, chosen})}
            out[tag + label] = {"chosen": chosen, "ms": ms}
        consts = ((tfd.DECODE_F32_SPLIT_PAGES, tfd.DECODE_F32_SPLIT_CTAS)
                  if f32 else (tfd.DECODE_SPLIT_PAGES,
                               tfd.DECODE_SPLIT_CTAS))
        print(f"  decode split tuning {str(dt)[6:]} (pages a split "
              f"{consts[0]}, CTAs an SM {consts[1]}; ms by splits, * the "
              f"count taken): " + "; ".join(
                  f"{k} " + ", ".join(
                      f"{s}{'*' if s == v['chosen'] else ''} {t:.4f}"
                      for s, t in v["ms"].items())
                  for k, v in out.items() if k.startswith(tag)))
    return out


def decode_times(torch, ops, dev):
    """Device times (ms) of the decode kernels through the port's entry
    points, bf16: #9 at the decode shape (with its eager issue per call:
    the least of 9 windows of 200 calls, and the host's own cost per call,
    :func:`host_ms`), with window 128, and at b = 1
    over 8192 keys; #10 at the chunk and verify shapes and at
    :data:`DECODE_CHUNK_W`; then the same six in fp32 (labels ``fp32
    ...``). Takes any tree's ``ops``, so two trees can be compared in one
    run."""
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        tag = "fp32 " if dt == torch.float32 else ""
        gen = torch.Generator(device=dev).manual_seed(3)
        q, kp, vp, tables, lens = _decode_inputs(torch, dev, gen,
                                                 *DECODE_MAIN[:7], dt,
                                                 DECODE_MAIN[7])
        b, h, kh, blk, d, nb, mb, lengths = DECODE_LONG
        q1, kp1, vp1, t1, l1 = _decode_inputs(torch, dev, gen, b, h, kh, blk,
                                              d, nb, mb, dt, lengths)
        out[tag + "decode"] = time_ms(lambda: ops.flash_decode(
            q, kp, vp, tables, lens))
        if not tag:
            out["decode_issue"] = issue_ms(
                lambda: ops.flash_decode(q, kp, vp, tables, lens), 200, 9,
                min)
            out["decode_host"] = host_ms(
                lambda: ops.flash_decode(q, kp, vp, tables, lens))
        out[tag + "window_128"] = time_ms(lambda: ops.flash_decode(
            q, kp, vp, tables, lens, window=128))
        out[tag + "b1_8192"] = time_ms(lambda: ops.flash_decode(
            q1, kp1, vp1, t1, l1))
        for label, (b, h, kh, kq, blk, d, nb, mb, lengths, window) in (
                ("chunk", DECODE_CHUNK + (None,)),
                ("verify", DECODE_VERIFY + (None,)),
                ("chunk_w256", DECODE_CHUNK_W)):
            _, kp, vp, tables, lens = _decode_inputs(
                torch, dev, gen, b, h, kh, blk, d, nb, mb, dt, lengths)
            q = torch.randn(b, h, kq, d, device=dev, generator=gen).to(dt)
            out[tag + label] = time_ms(lambda: ops.flash_decode_multi(
                q, kp, vp, tables, lens, window=window))
        del q, kp, vp, q1, kp1, vp1
        torch.cuda.empty_cache()
    return out


def _visible(lengths, kq, window, s_max):
    """Per slot, per query: the count of keys it sees, and per slot the
    keys some query sees (the span the kernel must read)."""
    per_row, span = [], []
    for n in lengths:
        lo_hi = []
        for j in range(kq):
            qlen = n - (kq - 1 - j)
            hi = min(qlen, s_max)
            lo = max(qlen - window, 0) if window else 0
            lo_hi.append((lo, hi))
        per_row.append([max(0, hi - lo) for lo, hi in lo_hi])
        live = [(lo, hi) for lo, hi in lo_hi if hi > lo]
        span.append(max(h for _, h in live) - min(lo for lo, _ in live)
                    if live else 0)
    return per_row, span


def multi_bound(b, h, kh, kq, d, dt_bytes, lengths, window, blk, max_blocks,
                dtype_name):
    """(bound_ms, bound_by) of one K-query decode: q read and o written
    once, each K/V element that some query of the slot sees read once, the
    tables and lengths; 4 * d operations per visible (query, key) pair."""
    per_row, span = _visible(lengths, kq, window, blk * max_blocks)
    nbytes = (2 * b * h * kq * d * dt_bytes + sum(span) * kh * d * 2 * dt_bytes
              + b * max_blocks * 4 + b * 4)
    flops = 4 * d * h * sum(sum(r) for r in per_row)
    return bound(nbytes, flops, dtype_name)


def check_flash_decode_multi(torch, ops, dev):
    """The K-query paged decode kernel against
    ``paged_attention_multi_reference`` at the slice's two path shapes
    (chunked prefill (1,16,256,64) and speculative verify (8,16,5,64), bf16,
    over a 513-page pool of 16-token pages) and edge cases, bf16 and fp32.
    Tolerance: 0.02 in bf16 (P is rounded to bf16 as the A operand of P.V,
    which the reference kernel keeps fp32), 5e-5 in fp32, and each row's
    own error (:func:`_decode_held`). Idle slots and queries that see no
    key (a right-aligned chunk's padding rows) must be exactly 0. At the
    chunk shape a halved tail of rows must fail the row check (bf16 and
    fp32) and two calls must give the same bits (and in fp32 at the verify
    shape); in fp32 also pools off 16 bytes (4-byte copies), 12- and
    128-token pages and a call into NaN-filled output memory at the chunk
    and verify shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(8)
    verify_lengths = DECODE_VERIFY[8]  # slot 3 idle
    chunk, verify = DECODE_CHUNK[:8], DECODE_VERIFY[:8]
    cases = [  # (b, h, kh, K, blk, d, num_blocks, max_blocks), lengths, window
        (chunk, DECODE_CHUNK[8], None),
        (verify, verify_lengths, None),
        (chunk, [100], None),            # 155 padding rows see <= 0 keys
        ((8, 16, 4, 5, 16, 64, 513, 64), verify_lengths, None),  # GQA
        (verify, verify_lengths, 128),
        (chunk, [900], 128),
        ((4, 16, 16, 7, 32, 64, 300, 32), [1000, 1, 0, 517], None),  # blk 32
        ((2, 16, 4, 5, 16, 128, 200, 64), [1000, 300], None),      # d 128
        ((2, 8, 8, 70, 16, 36, 100, 16), [30, 200], 50),  # unaligned d
        # the split route's edges: one slot past the table's 1024 keys, a
        # verify batch of idle slots only, 8-token pages with a window
        ((1, 16, 16, 5, 16, 64, 1100, 1024), [16384], None),
        (verify, [0] * 8, None),
        ((3, 8, 2, 7, 8, 64, 40, 12), [95, 0, 3], 5),
        ((3, 8, 2, 9, 12, 64, 40, 12), [131, 0, 5], 40),  # 12-token pages
        ((2, 4, 4, 40, 128, 64, 9, 4), [300, 512], None),  # 128-token pages
        ((1, 16, 16, 100, 16, 128, 70, 64), [700], None),  # d 128, 7 tiles
    ]
    main_err = None
    for dt in (bf16, f32):
        for (b, h, kh, kq, blk, d, nb, mb), lengths, window in cases:
            _, kp, vp, tables, lens = _decode_inputs(
                torch, dev, gen, b, h, kh, blk, d, nb, mb, dt, lengths)
            q = torch.randn(b, h, kq, d, device=dev, generator=gen).to(dt)
            got = ops.flash_decode_multi(q, kp, vp, tables, lens,
                                         window=window)
            ref = ops.paged_attention_multi_reference(q, kp, vp, tables,
                                                      lens, window=window)
            torch.cuda.synchronize()
            per_row, _ = _visible(lengths, kq, window, mb * blk)
            blind = [(i, slice(None), j) for i, row in enumerate(per_row)
                     for j, n in enumerate(row) if n == 0]
            route = _decode_route(ops, q, kp, vp, dt)
            name = (f"flash_decode_multi b={b} h={h} kh={kh} K={kq} "
                    f"blk={blk} d={d} {str(dt)[6:]} window={window}")
            group = f"flash_decode_multi {str(dt)[6:]}"
            err, _ = _decode_held(torch, name, got, ref, dt, group, route,
                                  blind)
            if main_err is None:
                main_err = err
            if (lengths, window) == (DECODE_CHUNK[8], None):
                _planted_tail(torch, f"flash_decode_multi {str(dt)[6:]} "
                              f"chunk shape", got, ref, dt, route,
                              f"{group} rows")
            at = (None if window is not None else
                  "chunk" if lengths == DECODE_CHUNK[8] else
                  "verify" if lengths == verify_lengths else None)
            if at and (dt == f32 or at == "chunk") and (b, kh) in (
                    (1, 16), (8, 16)):
                _bit_identical(torch, f"flash_decode_multi {str(dt)[6:]} "
                               f"{at} shape", lambda: ops.flash_decode_multi(
                                   q, kp, vp, tables, lens), route, group)
            if at and dt == f32 and (b, kh) in ((1, 16), (8, 16)):
                _nan_filled_call(
                    torch, f"flash_decode_multi float32 {at} shape",
                    lambda: ops.flash_decode_multi(q, kp, vp, tables, lens),
                    ref, blind, route, group)
                kp4, vp4 = _f32_pool(torch, kp, 2), _f32_pool(torch, vp, 1)
                _decode_held(torch, f"{name} pools off 16 bytes",
                             ops.flash_decode_multi(q, kp4, vp4, tables,
                                                    lens), ref, dt, group,
                             route, blind)
                del kp4, vp4
        # K = 1 is the single-query decode
        _, kp, vp, tables, lens = _decode_inputs(
            torch, dev, gen, 8, 16, 16, 16, 64, 513, 64, dt, verify_lengths)
        q = torch.randn(8, 16, 64, device=dev, generator=gen).to(dt)
        one = ops.flash_decode(q, kp, vp, tables, lens)
        multi = ops.flash_decode_multi(q[:, :, None], kp, vp, tables,
                                       lens)[:, :, 0]
        torch.cuda.synchronize()
        err = max_err(multi, one)
        tol = 2e-2 if dt == bf16 else 5e-5
        route = _decode_route(ops, q, kp, vp, dt)
        print(f"  flash_decode_multi K=1 against flash_decode "
              f"{str(dt)[6:]} [{route}]: max_abs_err={err:.3g} (tol {tol:g})")
        verdict(f"flash_decode_multi K=1 vs flash_decode {str(dt)[6:]} "
                f"[{route}]", err, tol, f"cuda {route}",
                group=f"flash_decode_multi {str(dt)[6:]}")

    timings = {}
    for label, (b, h, kh, kq, blk, d, nb, mb), lengths in (
            ("chunk", chunk, DECODE_CHUNK[8]),
            ("verify", verify, verify_lengths)):
        _, kp, vp, tables, lens = _decode_inputs(
            torch, dev, gen, b, h, kh, blk, d, nb, mb, bf16, lengths)
        q = torch.randn(b, h, kq, d, device=dev, generator=gen).to(bf16)
        ms = time_ms(lambda: ops.flash_decode_multi(q, kp, vp, tables, lens))
        plain = time_ms(lambda: ops.paged_attention_multi_reference(
            q, kp, vp, tables, lens), 5)
        bms, by = multi_bound(b, h, kh, kq, d, 2, lengths, None, blk, mb,
                              "bfloat16")
        timings[label] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                              bound_by=by)
        print(f"  flash_decode_multi timing {label} q ({b},{h},{kq},{d}) bf16, "
              f"lengths {lengths}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {bms:.4f} ms ({by}); no single PyTorch call attends a "
              f"paged pool")
    main = timings["chunk"]
    return dict(name="flash_decode_multi", route="cuda",
                kernel="decode_multi_split (bf16), decode_multi_f32 / "
                       "decode_multi_f32_tiles (fp32), "
                       "decode_multi_mma_kernel (unaligned bf16)",
                source="apex_tpu_torch/csrc/flash_decode.cu",
                replaces="apex_tpu/ops/flash_decode.py:281",
                max_abs_err=main_err, library_ms=None, by_shape=timings,
                **main)


def check_xentropy(torch, ops, dev):
    """Softmax cross-entropy kernels against ``xentropy_fwd_reference`` /
    ``xentropy_bwd_reference`` on the same inputs (the backward from the
    same g, labels and the plain forward's lse). Tolerances, as a share of
    max |ref|: loss and lse 1e-5 (both fp32 arithmetic, sums in another
    order); dx 1e-5 from fp32 logits, 2^-8 from bf16 logits (both round
    the same fp32 value to bf16, up to one ulp). Rows whose label is
    ignore_index: loss and dx exactly 0."""
    import torch.nn.functional as F

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(8)
    ignore = -100
    cases = [  # rows, vocab, dtype, smoothing, logit scale, ignored rows
        (256, 1000, f32, 0.0, 1.0, "some"), (256, 1000, f32, 0.1, 1.0, "some"),
        (8192, 50304, bf16, 0.0, 1.0, "some"),
        (8192, 50304, bf16, 0.1, 1.0, "some"),
        (333, 1000, bf16, 0.1, 1.0, "some"), (37, 37, f32, 0.1, 1.0, "some"),
        (333, 37, bf16, 0.0, 1.0, "none"), (97, 50304, f32, 0.1, 1.0, "none"),
        (256, 1000, f32, 0.1, 1e4, "some"), (100, 37, bf16, 0.1, 1e4, "some"),
        (64, 1000, f32, 0.1, 1.0, "all"),
    ]
    main_err = None
    for rows, vocab, dt, eps, scale, ign in cases:
        x = (torch.randn(rows, vocab, device=dev, generator=gen)
             * scale).to(dt)
        y = torch.randint(0, vocab, (rows,), device=dev, generator=gen)
        if ign == "some":
            y[::7] = ignore
        elif ign == "all":
            y[:] = ignore
        g = torch.randn(rows, device=dev, generator=gen)
        loss, lse = ops.xentropy_fwd(x, y, eps, ignore)
        rloss, rlse = ops.xentropy_fwd_reference(x, y, eps, ignore)
        dx = ops.xentropy_bwd(g, x, y, rlse, eps, ignore)
        rdx = ops.xentropy_bwd_reference(g, x, y, rlse, eps, ignore)
        torch.cuda.synchronize()
        tol_dx = 2.0 ** -8 if dt == bf16 else 1e-5
        errs = []
        for name, a, r, tol in (("loss", loss, rloss, 1e-5),
                                ("lse", lse, rlse, 1e-5),
                                ("dx", dx, rdx, tol_dx)):
            check(a.dtype == r.dtype and a.shape == r.shape,
                  f"xentropy {name} dtype/shape")
            e = rel_err(a, r) if bool(r.abs().max() > 0) else max_err(a, r)
            errs.append(f"{name} {max_err(a, r):.3g} (rel {e:.3g}, tol "
                        f"{tol:g})")
            verdict(f"xentropy rows={rows} V={vocab} {str(dt)[6:]} "
                    f"eps={eps} scale={scale:g} {name}", e, tol,
                    group=f"xentropy {str(dt)[6:]}")
        skip = y == ignore
        check(bool((loss[skip] == 0).all()) and bool((dx[skip] == 0).all()),
              "ignored rows: loss and dx exactly 0")
        print(f"  xentropy rows={rows:4d} V={vocab:5d} {str(dt)[6:]:8s} "
              f"eps={eps} scale={scale:g} ignored={ign}: " + ", ".join(errs))
        if main_err is None:
            main_err = max(max_err(loss, rloss), max_err(dx, rdx))
    # a batched (4, 64, V) shape through softmax_cross_entropy's Function
    x = torch.randn(4, 64, 1000, device=dev, generator=gen)
    y = torch.randint(0, 1000, (4, 64), device=dev, generator=gen)
    y[0, :5] = ignore
    g = torch.randn(4, 64, device=dev, generator=gen)
    xk, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    before = ops.launch_counts()
    lk = ops.softmax_cross_entropy(xk, y, 0.1)
    (gk,) = torch.autograd.grad(lk, xk, g)
    after = ops.launch_counts()
    lr = ops.softmax_cross_entropy_reference(xr, y, 0.1)
    (gr,) = torch.autograd.grad(lr, xr, g)
    torch.cuda.synchronize()
    e_l, e_g = rel_err(lk.detach(), lr.detach()), rel_err(gk, gr)
    print(f"  xentropy batched (4,64,1000) f32 eps=0.1 through "
          f"softmax_cross_entropy: loss rel {e_l:.3g}, autograd dx rel "
          f"{e_g:.3g} (tol 1e-05)")
    check(lk.shape == (4, 64) and e_l <= 1e-5 and e_g <= 1e-5,
          "batched softmax_cross_entropy")
    check(after["xentropy_fwd"] - before["xentropy_fwd"] == 1
          and after["xentropy_bwd"] - before["xentropy_bwd"] == 1,
          "the batched call launched each kernel once")

    timings = {}
    for label, rows, vocab, dt in (("path", 256, 1000, f32),
                                   ("lm", 8192, 50304, bf16)):
        eps = 0.1
        x = torch.randn(rows, vocab, device=dev, generator=gen).to(dt)
        y = torch.randint(0, vocab, (rows,), device=dev, generator=gen)
        g = torch.randn(rows, device=dev, generator=gen)
        _, lse = ops.xentropy_fwd(x, y, eps)
        fwd = time_ms(lambda: ops.xentropy_fwd(x, y, eps))
        bwd = time_ms(lambda: ops.xentropy_bwd(g, x, y, lse, eps))
        pfwd = time_ms(lambda: ops.xentropy_fwd_reference(x, y, eps), 5)
        pbwd = time_ms(lambda: ops.xentropy_bwd_reference(g, x, y, lse, eps),
                       5)
        lfwd = time_ms(lambda: F.cross_entropy(
            x, y, reduction="none", label_smoothing=eps, ignore_index=ignore))
        # the library's backward: autograd.grad of one F.cross_entropy
        # output, captured and replayed on the stream of its forward
        xl = x.detach().requires_grad_()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = F.cross_entropy(xl, y, reduction="none",
                                  label_smoothing=eps, ignore_index=ignore)
        torch.cuda.synchronize()
        gl = g.to(out.dtype)
        lbwd = time_ms(lambda: torch.autograd.grad(out, xl, gl,
                                                   retain_graph=True),
                       stream=side)
        eb = x.element_size()
        n = rows * vocab
        fb = bound(n * eb + rows * 8 + rows * 8, 5 * n, "float32")
        bb = bound(2 * n * eb + rows * (8 + 4 + 4), 5 * n, "float32")
        timings[label] = dict(
            fwd=dict(ms=fwd, plain_ms=pfwd, bound_ms=fb[0], bound_by=fb[1],
                     library_ms=lfwd),
            bwd=dict(ms=bwd, plain_ms=pbwd, bound_ms=bb[0], bound_by=bb[1],
                     library_ms=lbwd))
        print(f"  xentropy timing {label} ({rows}x{vocab} {str(dt)[6:]}, "
              f"eps {eps}): forward kernel {fwd:.4f} ms, plain {pfwd:.4f} "
              f"ms, F.cross_entropy {lfwd:.4f} ms, bound {fb[0]:.4f} ms "
              f"({fb[1]}, {(n * eb) / 1e6:.1f} MB of logits); backward "
              f"kernel {bwd:.4f} ms, plain {pbwd:.4f} ms, autograd.grad of "
              f"F.cross_entropy {lbwd:.4f} ms, bound {bb[0]:.4f} ms "
              f"({bb[1]})")
    common = dict(route="cuda", source="apex_tpu_torch/csrc/xentropy.cu",
                  max_abs_err=main_err)
    return [dict(common, name="xentropy_fwd",
                 replaces="apex_tpu/ops/xentropy.py:28",
                 by_shape={k: v["fwd"] for k, v in timings.items()},
                 **timings["path"]["fwd"]),
            dict(common, name="xentropy_bwd",
                 replaces="apex_tpu/ops/xentropy.py:47",
                 by_shape={k: v["bwd"] for k, v in timings.items()},
                 **timings["path"]["bwd"])]


def ulp(value, dtype, torch):
    """One unit in the last place of ``dtype`` at |value| (> 0)."""
    import math

    return torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(abs(value)))


def padding_mask(torch, dev, gen, b, sq, sk, lo):
    """(b, 1, sq, sk) bool, True past each sequence's key length, the
    lengths drawn from [lo, sk]."""
    lengths = torch.randint(lo, sk + 1, (b,), device=dev, generator=gen)
    cols = torch.arange(sk, device=dev)
    return (cols[None, None, None, :] >= lengths[:, None, None, None]).expand(
        b, 1, sq, sk).contiguous()


def softmax_bound(torch, x, mask, causal, backward):
    """(bound_ms, bound_by) of one softmax kernel. Forward: x read where it
    can change y (not masked, not above the diagonal), the mask read once,
    y written; backward: g and y read, dx written. 5 fp32 operations an
    element either way (scale, max, exp, sum, divide; multiply, dot, two
    multiplies, subtract)."""
    b, h, sq, sk = x.shape
    n, eb = x.numel(), x.element_size()
    if backward:
        return bound(3 * n * eb, 5 * n, "float32")
    visible = torch.ones(sq, sk, dtype=torch.bool, device=x.device)
    if causal:
        visible = visible.tril()
    if mask is None:
        read = int(visible.sum()) * b * h
        mask_bytes = 0
    else:
        read = int((~mask & visible).sum()) * (h // mask.shape[1])
        mask_bytes = mask.numel()
    return bound(read * eb + mask_bytes + n * eb, 5 * n, "float32")


def check_softmax(torch, ops, dev):
    """The fused scale-mask softmax kernels against
    ``softmax_fwd_reference`` / ``softmax_bwd_reference`` on the same
    inputs (the backward from the same g and the plain forward's y), at
    the repo's score shapes: GPT-2 345M causal (8,16,1024,1024), BERT-large
    padded (8,16,512,512) with one fully masked row, the two combined, the
    root ``bench.py`` micro-bench shape, a per-head mask, unaligned rows,
    fp16 (the forward's warp route where rows are aligned and at most
    WARP_MAX_COLS long, else its CTA routes), rows of 3000 and 4096
    elements (the resident route) and of 65536 and 100003 elements (the
    two-pass route); each verdict names the route it held.
    Limits: fp32 max |err| 1e-6 and worst row (:func:`row_err`) 1e-5 for
    y, and for dx the larger of those and 4x the plain version's own
    distance from the same formula in float64 (dx = scale*y*(g - sum g*y)
    cancels where one y dominates, so two correct fp32 sum orders part by
    more than 1e-5 of such a row); bf16/fp16 2e-2 of max |ref| (the JAX
    selftest's bar,
    ``bench.py:1078``) and worst row 1e-2 for y, 1.5e-2 for dx
    (:data:`ROW_TOL`); a fully masked row is 1/sk within one ulp of the
    dtype. Then device times at the GPT and BERT shapes beside the plain
    versions, ``torch.softmax`` / ``torch._softmax_backward_data`` (no
    scale, no mask: the same bytes) and the bound, and WARP_MAX_COLS
    against the widths tried (:func:`warp_tuning`)."""
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    gen = torch.Generator(device=dev).manual_seed(12)
    cases = [  # label, (b, h, sq, sk), dtype, mask, causal, scale
        ("gpt", (8, 16, 1024, 1024), bf16, None, True, 0.125),
        ("bert", (8, 16, 512, 512), bf16, "padding+dead", False, 0.125),
        ("causal+padding", (8, 16, 512, 512), bf16, "padding", True, 1.0),
        ("per-head", (2, 4, 64, 96), f32, "heads", False, 1.0),
        ("micro-bench", (4, 8, 256, 256), bf16, None, True, 0.125),
        ("unaligned", (2, 3, 300, 77), bf16, "random", False, 1.0),
        ("unaligned", (2, 3, 300, 77), f32, "random", True, 0.5),
        ("fp16", (2, 4, 128, 512), f16, None, False, 1.0),
        # rows past WARP_MAX_COLS: a CTA a row, staged in shared memory
        ("resident", (2, 4, 64, 4096), bf16, "padding", True, 0.125),
        ("resident", (1, 2, 32, 3000), f32, "random", False, 1.0),
        ("long", (1, 2, 16, 65536), f32, "padding", False, 1.0),
        ("long", (1, 2, 16, 65536), bf16, "padding", False, 1.0),
        ("long odd", (1, 1, 8, 100003), bf16, None, False, 1.0),
    ]
    main_err, inputs = {}, {}
    for label, shape, dt, mkind, causal, scale in cases:
        b, h, sq, sk = shape
        x = (torch.randn(shape, device=dev, generator=gen) * 4).to(dt)
        mask = None
        if mkind in ("padding", "padding+dead"):
            mask = padding_mask(torch, dev, gen, b, sq, sk,
                                64 if sk <= 1024 else sk // 2)
            if mkind == "padding+dead":
                mask[0, 0, 7, :] = True  # one fully masked row
        elif mkind in ("heads", "random"):
            mh = h if mkind == "heads" else 1
            mask = torch.rand(b, mh, sq, sk, device=dev, generator=gen) < 0.3
        g = torch.randn(shape, device=dev, generator=gen).to(dt)
        route = ops.softmax_route(sk, x.element_size())
        bwd_route = "two_pass" if route == "two_pass" else "resident"
        y = ops.softmax_fwd(x, mask, scale, causal)
        y_ref = ops.softmax_fwd_reference(x, mask, scale, causal)
        dx = ops.softmax_bwd(g, y_ref, scale)
        dx_ref = ops.softmax_bwd_reference(g, y_ref, scale)
        torch.cuda.synchronize()
        name = f"softmax {label} {str(dt)[6:]}"
        check(y.dtype == dt and y.shape == x.shape and dx.dtype == dt,
              f"{name}: dtype/shape")
        parts = []
        if dt == f32:
            # dx = scale*y*(g - sum g*y) cancels where one y dominates, so
            # two correct fp32 sum orders part by more than 1e-5 of a row:
            # the dx limits are 4x the plain version's own distance from
            # the same formula in float64 (floored at the y limits)
            g64, y64 = g.double(), y_ref.double()
            exact = scale * y64 * (g64 - (g64 * y64).sum(-1, keepdim=True))
            dx_lim = (max(1e-6, 4 * max_err(dx_ref, exact)),
                      max(ROW_TOL[False][0], 4 * row_err(dx_ref, exact)))
            del g64, y64, exact
        for part, got, ref in (("y", y, y_ref), ("dx", dx, dx_ref)):
            if dt == f32:
                err, lim, unit = max_err(got, ref), 1e-6, "abs"
                rlim = ROW_TOL[False][0]
                if part == "dx":
                    lim, rlim = dx_lim
            else:
                err, lim, unit = rel_err(got, ref), 2e-2, "of max|ref|"
                rlim = 1e-2 if part == "y" else ROW_TOL[True][1]
            e_row = row_err(got, ref)
            parts.append(f"{part} {err:.3g} {unit} (limit {lim:g}), worst "
                         f"row {e_row:.3g} (limit {rlim:g})")
            rt = route if part == "y" else bwd_route
            verdict(f"{name} {part}", err, lim, rt, group=name)
            verdict(f"{name} {part} row", e_row, rlim, rt, group=name)
        if mkind == "padding+dead":
            u = ulp(1.0 / sk, dt, torch)
            e_dead = float((y[0, 0, 7].float() - 1.0 / sk).abs().max())
            parts.append(f"fully masked row |y - 1/sk| {e_dead:.3g} (limit "
                         f"1 ulp = {u:.3g}), its dx max |.| "
                         f"{float(dx[0, 0, 7].float().abs().max()):.3g}")
            verdict(f"{name} masked row = 1/sk", e_dead, u, route,
                    group=name)
        print(f"  {name} {shape} mask={mkind} causal={causal} "
              f"scale={scale:g} [forward {route}, backward {bwd_route}]: "
              + ", ".join(parts))
        if label in ("gpt", "bert"):
            inputs[label] = (x, mask, causal, scale, g, y_ref)
            main_err[label] = (max_err(y, y_ref), max_err(dx, dx_ref))
        del x, mask, g, y, y_ref, dx, dx_ref
    # the reference's mask contract: head dim 1 or h, else ValueError
    x = torch.randn(2, 4, 8, 8, device=dev, generator=gen)
    try:
        ops.softmax_fwd(x, torch.zeros(2, 2, 8, 8, dtype=torch.bool,
                                       device=dev))
        raised = 0.0
    except ValueError:
        raised = 1.0
    verdict("softmax mask heads 2 of 4 raises",
            1.0 - raised, 0.0, "-")
    torch.cuda.empty_cache()

    timings = {}
    for label, (x, mask, causal, scale, g, y) in inputs.items():
        fwd = time_ms(lambda: ops.softmax_fwd(x, mask, scale, causal))
        bwd = time_ms(lambda: ops.softmax_bwd(g, y, scale))
        pfwd = time_ms(lambda: ops.softmax_fwd_reference(x, mask, scale,
                                                         causal), 3, 2)
        pbwd = time_ms(lambda: ops.softmax_bwd_reference(g, y, scale), 3, 2)
        lfwd = time_ms(lambda: torch.softmax(x, -1))
        lbwd = time_ms(lambda: torch._softmax_backward_data(g, y, -1,
                                                            y.dtype))
        fb = softmax_bound(torch, x, mask, causal, False)
        bb = softmax_bound(torch, x, mask, causal, True)
        timings[label] = dict(
            fwd=dict(ms=fwd, plain_ms=pfwd, bound_ms=fb[0], bound_by=fb[1],
                     library_ms=lfwd),
            bwd=dict(ms=bwd, plain_ms=pbwd, bound_ms=bb[0], bound_by=bb[1],
                     library_ms=lbwd))
        print(f"  softmax timing {label} {tuple(x.shape)} "
              f"{str(x.dtype)[6:]} causal={causal} mask="
              f"{None if mask is None else tuple(mask.shape)}: forward "
              f"kernel {fwd:.4f} ms, plain {pfwd:.4f} ms, torch.softmax "
              f"(no scale, no mask) {lfwd:.4f} ms, bound {fb[0]:.4f} ms "
              f"({fb[1]}); backward kernel {bwd:.4f} ms, plain {pbwd:.4f} "
              f"ms, torch._softmax_backward_data (no scale) {lbwd:.4f} ms, "
              f"bound {bb[0]:.4f} ms ({bb[1]})")
    tuning = warp_tuning(torch, ops, inputs["gpt"][0], gen)
    del inputs
    torch.cuda.empty_cache()
    common = dict(route="cuda", source="apex_tpu_torch/csrc/softmax.cu")
    return [dict(common, name="softmax_fwd",
                 kernel=f"softmax_fwd_warp (one warp per row of up to "
                        f"WARP_MAX_COLS = {tuning['chosen']} "
                        f"elements, in registers)",
                 warp_tuning=tuning,
                 replaces="apex_tpu/ops/softmax.py:40",
                 max_abs_err=main_err["gpt"][0],
                 by_shape={k: v["fwd"] for k, v in timings.items()},
                 **timings["gpt"]["fwd"]),
            dict(common, name="softmax_bwd",
                 replaces="apex_tpu/ops/softmax.py:55",
                 max_abs_err=main_err["gpt"][1],
                 by_shape={k: v["bwd"] for k, v in timings.items()},
                 **timings["gpt"]["bwd"])]


def warp_tuning(torch, ops, x, gen, widths=(1024, 2048)):
    """WARP_MAX_COLS against the values tried: the forward's device time at
    G (``x``) and at (2,16,2048,2048) bf16 causal on the warp route and on
    the resident one (WARP_MAX_COLS patched to 0), on one line; returned
    for the ``kernels`` line (``warp_tuning``)."""
    import importlib

    sm = importlib.import_module("apex_tpu_torch.ops.softmax")
    chosen = sm.WARP_MAX_COLS
    x2 = torch.randn(2, 16, 2048, 2048, device=x.device,
                     generator=gen).to(torch.bfloat16)
    times = {}
    try:
        for label, t in (("G sk=1024", x), ("(2,16,2048,2048) sk=2048", x2)):
            times[label] = {}
            for cap, route in ((max(widths), "warp"), (0, "resident")):
                sm.WARP_MAX_COLS = cap
                check(sm.softmax_route(t.shape[-1], 2) == route,
                      f"softmax route {route} at {label}")
                times[label][route] = time_ms(
                    lambda: ops.softmax_fwd(t, None, 0.125, True))
    finally:
        sm.WARP_MAX_COLS = chosen
    del x2
    print(f"  WARP_MAX_COLS = {chosen} (chosen); forward ms by route (bf16 "
          f"causal): " + "; ".join(
              f"{label}: " + ", ".join(f"{r} {v:.4f}" for r, v in t.items())
              for label, t in times.items()))
    return {"chosen": chosen, "ms": times}


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------


def check_greedy(torch, model, res, label, ref=None):
    """Every generated token equals the argmax of one full-context forward
    over the finished sequence; where that forward's top-2 gap is below 1e-3
    the token must be in its top 2, and the check of that request stops
    there. With ``ref`` (another engine's results) each token must also
    equal ``ref``'s up to that point. Returns the tokens checked."""
    checked = 0
    for rid, req in res.items():
        seq = list(req.prompt) + req.tokens
        logits = model.apply(torch.tensor([seq], device=model.device))[0]
        logits = logits.float()
        for t in range(len(req.prompt), len(seq)):
            top2 = torch.topk(logits[t - 1], 2)
            if float(top2.values[0] - top2.values[1]) < 1e-3:
                check(seq[t] in top2.indices.tolist(),
                      f"{label}: request {rid} pos {t} not in top-2")
                break
            check(int(top2.indices[0]) == seq[t],
                  f"{label}: request {rid} pos {t}: engine {seq[t]} != "
                  f"forward argmax {int(top2.indices[0])}")
            if ref is not None:
                i = t - len(req.prompt)
                check(i < len(ref[rid].tokens)
                      and ref[rid].tokens[i] == seq[t],
                      f"{label}: request {rid} pos {t} differs from the "
                      f"non-speculative engine")
            checked += 1
    return checked


def small_fp32_model(torch, dev, layers=2, seed=5):
    from apex_tpu_torch.models import GPTConfig, GPTModel

    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=layers,
                    num_attention_heads=4, max_seq_len=256,
                    compute_dtype=torch.float32)
    return GPTModel(cfg, device=dev, seed=seed)


def greedy_gate(torch, dev):
    """fp32, small model: the monolithic engine's tokens against the
    full-context argmax (:func:`check_greedy`)."""
    import numpy as np

    from apex_tpu_torch.serve import Engine, Request, ServeConfig

    model = small_fp32_model(torch, dev)
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=list(rng.integers(0, 1024, n)),
                    max_new_tokens=m, request_id=i)
            for i, (n, m) in enumerate(((5, 16), (60, 12), (17, 20),
                                        (33, 9), (1, 16), (100, 24)))]
    eng = Engine(model, ServeConfig(max_batch=4, max_seq=128, block_size=16),
                 device=dev)
    res = eng.run(reqs)
    checked = check_greedy(torch, model, res, "gate")
    check(len(res) == len(reqs) and eng.allocator.used == 0, "gate drain")
    print(f"  fp32 greedy gate: {len(res)} requests, {checked} generated "
          f"tokens equal the full-context argmax")


def feature_gates(torch, ops, dev):
    """fp32, small model, each feature through the kernels: chunked prefill,
    the prefix cache (prompts on one 40-token prefix, so hits end mid-page
    and fork), speculative decoding with a self-draft and with a 1-layer
    draft. Every token against the full-context argmax; the speculative
    engines' tokens also against the non-speculative engine's; no page
    left after ``drop_prefix_cache``."""
    import dataclasses

    import numpy as np

    from apex_tpu_torch.serve import Engine, Request, ServeConfig

    model = small_fp32_model(torch, dev)
    draft = small_fp32_model(torch, dev, layers=1, seed=6)
    rng = np.random.default_rng(6)
    prefix = list(rng.integers(0, 1024, 40))
    spec = ((60, 12, True), (5, 16, False), (17, 20, True), (33, 9, False),
            (1, 16, True), (70, 24, False))  # suffix, new tokens, shared

    def requests():
        r = np.random.default_rng(7)
        return [Request(prompt=(prefix if shared else [])
                        + list(r.integers(0, 1024, n)),
                        max_new_tokens=m, request_id=i)
                for i, (n, m, shared) in enumerate(spec)]

    base_cfg = ServeConfig(max_batch=4, max_seq=160, block_size=16)
    base = Engine(model, base_cfg, device=dev).run(requests())
    for label, kw, dm, vs_base in (
            ("chunked prefill", dict(prefill_chunk=16), None, False),
            ("prefix cache", dict(prefix_cache=True), None, False),
            ("speculative, self-draft", dict(spec_k=3), None, True),
            ("speculative, 1-layer draft", dict(spec_k=2), draft, True),
            ("all three", dict(prefix_cache=True, prefill_chunk=24,
                               spec_k=3), None, True)):
        eng = Engine(model, dataclasses.replace(base_cfg, **kw), device=dev,
                     draft_model=dm)
        ops.reset_launch_counts()
        res = eng.run(requests())
        counts = ops.launch_counts()
        checked = check_greedy(torch, model, res, label,
                               base if vs_base else None)
        stats = eng.stats
        eng.drop_prefix_cache()
        check(len(res) == len(spec) and eng.allocator.used == 0,
              f"{label}: drained, no page leaked")
        check(counts["flash_decode_multi"] > 0
              and counts["flash_attention_fwd"] == 0,
              f"{label}: prefill went through the K-query kernel")
        if label == "prefix cache":  # each prefill done before the next
            check(stats["prefix_hits"] == 2 and stats["cow_forks"] >= 2,
                  f"{label}: prefix hits and forks")
        print(f"  fp32 {label}: {checked} tokens equal the full-context "
              f"argmax" + (" and the non-speculative engine" if vs_base
                           else "") + f"; stats {stats}")


def serve_345m(torch, ops, dev):
    import numpy as np

    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.serve import Engine, Request, ServeConfig

    cfg = GPTConfig()  # GPT-2 345M
    torch.cuda.reset_peak_memory_stats(dev)
    model = GPTModel(cfg, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    eng = Engine(model, ServeConfig(max_batch=8, max_seq=1024,
                                    block_size=16), device=dev)
    # warm-up (cuBLAS handles, allocator): one short request
    eng.run([Request(prompt=list(range(64)), max_new_tokens=4,
                     request_id="warmup")])
    reqs = mix_345m(cfg)
    p0, d0 = eng.prefills, eng.decode_steps
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    prefills, ticks = eng.prefills - p0, eng.decode_steps - d0
    L = cfg.num_layers
    expected = dict.fromkeys(counts, 0)  # the backward kernels: none
    expected.update({"flash_attention_fwd": L * prefills,
                     "flash_decode": L * ticks,
                     "layer_norm_fwd": (2 * L + 1) * (prefills + ticks)})
    print(f"  345M: {n_params / 1e6:.1f} M params, {prefills} prefills, "
          f"{ticks} decode ticks, launches {counts} (expected {expected})")
    check(prefills == len(reqs), "one prefill per request")
    check_counts(counts, expected, "serve")
    check_345m_output(torch, model, res, reqs)
    m = latency(res, wall)
    print(f"  345M serve: {m['tokens']} tokens in {wall:.3f} s = "
          f"{m['tokens_s']:.1f} tokens/s, TTFT p50 {m['ttft_ms']:.2f} ms "
          f"(min {m['ttft_min_ms']:.2f} ms), ITL p50 {m['itl_ms']:.2f} ms, "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
          f"GiB")
    rng = np.random.default_rng(1)
    device_busy(torch, eng, [
        Request(prompt=list(rng.integers(0, cfg.vocab_size, 256)),
                max_new_tokens=48, request_id=f"w{i}") for i in range(8)],
        "345M window (8 x 256-token prompts, 48 new tokens)")
    return counts, model, m


def mix_345m(cfg):
    """The 16-request serve mix: prompts of 64-768 random tokens, 64 new
    tokens each."""
    import numpy as np

    from apex_tpu_torch.serve import Request

    rng = np.random.default_rng(0)
    return [Request(prompt=list(rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(64, 769)))),
                    max_new_tokens=64, request_id=i) for i in range(16)]


def latency(res, wall):
    toks = sum(len(r.tokens) for r in res.values())
    return dict(tokens=toks, tokens_s=toks / wall,
                ttft_ms=statistics.median(x.ttft_s for x in res.values()) * 1e3,
                ttft_min_ms=min(x.ttft_s for x in res.values()) * 1e3,
                itl_ms=statistics.median(
                    v for x in res.values() for v in x.itl_s) * 1e3)


def check_345m_output(torch, model, res, reqs, new=64):
    """Every request got its tokens, in range; one request's sequence
    through the reference forward is finite and its first token is in the
    forward's top 5 (bf16)."""
    vocab = model.cfg.vocab_size
    check(len(res) == len(reqs) and all(len(r.tokens) == new
                                        for r in res.values()),
          "every request got its tokens")
    check(all(0 <= t < vocab for r in res.values() for t in r.tokens),
          "token range")
    r = res[reqs[3].request_id]
    seq = torch.tensor([list(r.prompt) + r.tokens], device=model.device)
    logits = model.apply(seq)[0].float()
    check(tuple(logits.shape) == (seq.shape[1], vocab)
          and bool(torch.isfinite(logits).all()), "345M logits finite")
    top5 = torch.topk(logits[len(r.prompt) - 1], 5).indices.tolist()
    check(r.tokens[0] in top5, "345M first token in the forward's top 5")


def serve_345m_prefix_spec(torch, ops, dev, model):
    """GPT-2 345M with the prefix cache and speculative decoding (spec_k 4,
    the target as its own draft): 16 requests on one 500-token prefix (not
    a multiple of the 16-token page, so each hit ends mid-page and forks),
    each with a unique 16-256-token suffix and 64 new tokens. Every prefill
    goes through the chunk path, so the flash forward never launches."""
    import numpy as np

    from apex_tpu_torch.serve import Engine, Request, ServeConfig

    cfg = model.cfg
    scfg = ServeConfig(max_batch=8, max_seq=1024, block_size=16,
                       prefix_cache=True, spec_k=4)
    # warm-up on its own engine, so every counter below starts from 0
    Engine(model, scfg, device=dev).run([Request(
        prompt=list(range(600)), max_new_tokens=8, request_id="warmup")])
    torch.cuda.empty_cache()
    rng = np.random.default_rng(2)
    prefix = list(rng.integers(0, cfg.vocab_size, 500))

    def requests(tag=""):
        r = np.random.default_rng(3)
        return [Request(prompt=prefix + list(r.integers(
            0, cfg.vocab_size, int(r.integers(16, 257)))),
            max_new_tokens=64, request_id=f"{tag}{i}") for i in range(16)]

    eng = Engine(model, scfg, device=dev)
    reqs = requests()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    L = Ld = cfg.num_layers  # self-draft
    K = scfg.spec_k + 1
    chunks, ticks = eng.chunks, eng.spec_ticks
    expected = dict.fromkeys(counts, 0)
    expected.update({
        "flash_decode_multi": (L + Ld) * chunks + L * ticks,
        "flash_decode": Ld * K * ticks,
        # target chunks 2L (+1 head on each request's final chunk), draft
        # chunks 2Ld, K propose steps of 2Ld+1, one verify of 2L+1
        "layer_norm_fwd": (2 * L + 2 * Ld) * chunks + len(reqs)
                          + ((2 * Ld + 1) * K + 2 * L + 1) * ticks})
    stats = eng.stats
    print(f"  345M prefix + speculative: {chunks} target chunks (and as many "
          f"draft chunks), {ticks} spec ticks, {eng.decode_steps} decode "
          f"ticks, launches {counts} (expected {expected}); stats {stats}")
    check(eng.prefills == 0 and eng.decode_steps == 0,
          "every prefill chunked, every tick speculative")
    check_counts(counts, expected, "serve_prefix_spec")
    check(stats["prefix_hits"] == 15, "15 prefix hits")
    check(stats["cow_forks"] >= 15, "at least 15 copy-on-write forks")
    check(stats["mean_accepted_len"] > 1, "mean accepted length above 1")
    check(all(r.cached_tokens >= 500 for rid, r in res.items() if rid != "0"),
          "every later request reuses the 500-token prefix")
    check_345m_output(torch, model, res, reqs)
    m = latency(res, wall)
    print(f"  345M prefix + speculative serve: {m['tokens']} tokens in "
          f"{wall:.3f} s = {m['tokens_s']:.1f} tokens/s, TTFT p50 "
          f"{m['ttft_ms']:.2f} ms (min {m['ttft_min_ms']:.2f} ms), ITL p50 "
          f"{m['itl_ms']:.2f} ms, mean accepted length "
          f"{stats['mean_accepted_len']}")
    eng.drop_prefix_cache()
    check(eng.allocator.used == 0, "no page leaked after drop_prefix_cache")
    # the same requests again under the profiler (the cache starts empty)
    device_busy(torch, eng, requests("p"), "345M prefix + speculative run")
    eng.drop_prefix_cache()
    return counts, m


def serve_345m_chunked(torch, ops, dev, model, mono):
    """GPT-2 345M serving the 16-request mix with 256-token prefill chunks,
    one per engine tick between decode steps; its TTFT and ITL p50 beside
    the monolithic run's (``mono``), not a check."""
    from apex_tpu_torch.serve import Engine, ServeConfig

    cfg = model.cfg
    eng = Engine(model, ServeConfig(max_batch=8, max_seq=1024, block_size=16,
                                    prefill_chunk=256), device=dev)
    reqs = mix_345m(cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    L = cfg.num_layers
    chunks, ticks = eng.chunks, eng.decode_steps
    expected = dict.fromkeys(counts, 0)
    expected.update({"flash_decode_multi": L * chunks,
                     "flash_decode": L * ticks,
                     "layer_norm_fwd": 2 * L * chunks + len(reqs)
                                       + (2 * L + 1) * ticks})
    print(f"  345M chunked prefill: {chunks} chunks, {ticks} decode ticks, "
          f"launches {counts} (expected {expected})")
    check(eng.prefills == 0 and chunks == sum(-(-len(r.prompt) // 256)
                                              for r in reqs),
          "every prompt in 256-token chunks")
    check_counts(counts, expected, "serve_chunked")
    check_345m_output(torch, model, res, reqs)
    check(eng.allocator.used == 0, "every page freed")
    m = latency(res, wall)
    print(f"  345M chunked serve: {m['tokens']} tokens in {wall:.3f} s = "
          f"{m['tokens_s']:.1f} tokens/s, TTFT p50 {m['ttft_ms']:.2f} ms "
          f"(monolithic {mono['ttft_ms']:.2f}), ITL p50 {m['itl_ms']:.2f} ms "
          f"(monolithic {mono['itl_ms']:.2f})")
    return counts, m


def check_counts(counts, expected, path):
    for name, n in counts.items():
        check(n == expected[name],
              f"{path}: {name}: {n} launches, expected {expected[name]}")
    verdict(f"launch counts exact, path {path}", 0, 0, "-")


def device_time_by_kernel(torch, prof):
    """``{kernel name: (launches, device us)}`` of a profiler run."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    return by_name


def kernel_time(by_name, *parts):
    """(launches, device ms) of the kernels whose names hold any of
    ``parts``, from :func:`device_time_by_kernel`."""
    hit = [(n, t) for name, (n, t) in by_name.items()
           if any(p in name for p in parts)]
    return sum(n for n, _ in hit), sum(t for _, t in hit) / 1e3


def print_top(by_name, k=10):
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:k]:
        print(f"    {t / 1e3:9.2f} ms {n:6d}x  {name[:80]}")


#: kernel-name parts of the decode kernels in a profile, #9's and #10's:
#: the bf16 and fp32 split routes', then the gather route's
DECODE_KERNELS = {"#9": ("flash_decode_split", "flash_decode_f32",
                         "flash_decode_kernel"),
                  "#10": ("decode_multi_split", "decode_multi_f32",
                          "decode_multi_mma_kernel")}


def device_busy(torch, eng, reqs, label):
    """Device busy share of a serving window: the kernels' device time from
    ``torch.profiler`` over the window's wall time, and the decode kernels'
    device time and launches beside it, per decode tick (the engine's
    decode steps and speculative ticks in the window). Not a check. The
    CUDA activity alone: the CPU activity's op events lengthen the window
    itself and about double the profile's processing, for the same
    kernel times."""
    from torch.profiler import ProfilerActivity, profile

    ticks0 = eng.decode_steps + eng.spec_ticks
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ticks = eng.decode_steps + eng.spec_ticks - ticks0
    by_name = device_time_by_kernel(torch, prof)
    busy_us = sum(t for _, t in by_name.values())
    if busy_us <= 0:
        print(f"  {label}: device busy time not measured (the profiler saw "
              f"no device events)")
        return
    print(f"  {label}, profiled: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms = {busy_us / 1e6 / wall:.3f} of the "
          f"window (idle {1 - busy_us / 1e6 / wall:.3f}); device time by "
          f"kernel:")
    print_top(by_name)
    parts = []
    for kind, names in DECODE_KERNELS.items():
        n, ms = kernel_time(by_name, *names)
        parts.append(f"{kind} {ms:.2f} ms over {n} launches")
    n, ms = kernel_time(by_name, *DECODE_KERNELS["#9"],
                        *DECODE_KERNELS["#10"])
    print(f"    decode kernels: {'; '.join(parts)}; together {ms:.2f} ms of "
          f"{busy_us / 1e3:.1f} ms busy ({ms * 1e3 / busy_us:.3f}), "
          f"{ms / max(ticks, 1):.4f} ms a decode tick over {ticks} ticks")


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------


def gradient_gate(torch, ops, dev):
    """fp32, small GPT (hidden 256, 2 layers, seq 256, lm_head_chunks=2,
    remat on): loss and every parameter's grad on the card through the
    kernels against the same parameters on the CPU through the plain
    versions. Tolerance: loss 1e-5 relative; each grad 1e-4 of its max
    |CPU grad| (fp32 sums in another order through two layers)."""
    import numpy as np

    from apex_tpu_torch.models import GPTConfig, GPTModel

    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                    num_attention_heads=4, max_seq_len=256,
                    compute_dtype=torch.float32, hidden_dropout=0.0,
                    remat=True, lm_head_chunks=2)
    card = GPTModel(cfg, device=dev, seed=7)
    host = GPTModel(cfg, device="cpu", seed=7)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)))
    targets = torch.roll(tokens, -1, dims=-1)
    ops.reset_launch_counts()
    loss_c = card.loss(tokens.to(dev), targets.to(dev))
    loss_c.backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    loss_h = host.loss(tokens, targets)
    loss_h.backward()
    loss_c, loss_h = float(loss_c.detach()), float(loss_h.detach())
    rel = abs(loss_c - loss_h) / abs(loss_h)
    print(f"  fp32 gradient gate: loss card {loss_c:.7f} cpu "
          f"{loss_h:.7f} (rel {rel:.3g}, tol 1e-05); launches "
          f"{counts}")
    verdict("GPT fp32 gradient gate loss", rel, 1e-5,
            group="GPT fp32 gradient gate")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "layer_norm_fwd",
                 "layer_norm_bwd"):
        check(counts[name] > 0, f"gradient gate never launched {name}")
    worst = (0.0, "")
    for (name, pc), ph in zip(card.named_parameters(), host.parameters()):
        check(pc.grad is not None and ph.grad is not None,
              f"gradient gate: no grad for {name}")
        e = rel_err(pc.grad.cpu(), ph.grad)
        worst = max(worst, (e, name))
        check(e <= 1e-4, f"gradient gate {name}: rel err {e:.3g} > 1e-4")
    verdict(f"GPT fp32 gradient gate worst grad ({worst[1]})", worst[0],
            1e-4, group="GPT fp32 gradient gate")
    print(f"  fp32 gradient gate: {len(list(host.parameters()))} parameter "
          f"grads within 1e-4 of max|cpu grad| (worst {worst[0]:.3g}, "
          f"{worst[1]})")


def model_flops_per_token(cfg, pairs=None):
    """Training FLOPs per token, without the remat recompute: 6 x (the
    12*L*H^2 layer weights + the V*H tied head) + 6*L*S*H for the causal
    attention products (half of 12*L*S*H). With ``pairs``, the (query, key)
    pairs a head sees in one sequence (a window), the attention term is
    12*L*H*pairs/S instead."""
    L, H, S, V = (cfg.num_layers, cfg.hidden_size, cfg.max_seq_len,
                  cfg.vocab_size)
    attn = 6 * L * S * H if pairs is None else 12 * L * H * pairs / S
    return 6 * (12 * L * H * H + V * H) + attn


def train_345m(torch, ops, dev):
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.bench import build, fixed_batch, train_steps

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    bench = build("O2", device=dev, seed=0)
    cfg, L = bench.cfg, bench.cfg.num_layers
    n_params = sum(p.numel() for p in bench.model.parameters())
    tokens, targets = fixed_batch(bench)
    n = 10
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    stats = train_steps(bench, n, tokens, targets)  # 1 warm-up + n timed
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    steps = n + 1
    per_step = dict.fromkeys(counts, 0)
    per_step.update({"flash_attention_fwd": 2 * L,
                     "flash_attention_bwd_dq": L,
                     "flash_attention_bwd_dkv": L,
                     "layer_norm_fwd": 4 * L + 1,
                     "layer_norm_bwd": 2 * L + 1})
    expected = {k: v * steps for k, v in per_step.items()}
    print(f"  345M O2 train: {n_params / 1e6:.1f} M params, batch "
          f"{bench.batch} x {cfg.max_seq_len}, {steps} steps, launches "
          f"{counts} (expected per step {per_step})")
    check_counts(counts, expected, "train")
    losses = stats["losses"]
    skipped = sum(m["found_inf"] for m in stats["metrics"])
    steps_ms = stats["step_ms"]
    ms = stats["window_ms"] / n  # the whole window: a stall counts
    tok = stats["tokens_per_step"]
    flops = model_flops_per_token(cfg) * tok
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"  345M O2 train: {n} steps in {stats['window_ms']:.2f} ms = "
          f"{ms:.2f} ms a step (per step: median "
          f"{statistics.median(steps_ms):.2f}, min {min(steps_ms):.2f}, max "
          f"{max(steps_ms):.2f}; all {[round(t, 2) for t in steps_ms]}), "
          f"{n * tok / stats['window_ms'] * 1e3:.1f} tokens/s, model FLOPs "
          f"{flops / 1e12:.2f} T/step = {flops / ms / 1e9:.1f} TFLOP/s = "
          f"{flops / ms / 1e9 / 989:.3f} of 989 TFLOP/s (6*(12*L*H^2 + V*H) "
          f"+ 6*L*S*H per token), peak memory {peak:.2f} GiB")
    print(f"  345M O2 train: loss first {losses[0]:.4f} last "
          f"{losses[-1]:.4f} ({len(losses)} steps), loss scale "
          f"{stats['metrics'][-1]['loss_scale']:g}, skipped steps {skipped}")
    check(all(np.isfinite(losses)), "every loss finite")
    check(losses[-1] < losses[0], "the loss falls on the fixed batch")
    check(skipped == 0, "no step skipped")
    for p, m in zip(bench.model.parameters(), bench.opt_state.master):
        check(torch.equal(p, m.to(p.dtype)), "bf16 params == masters cast")
    check(any(p.dtype == torch.bfloat16 for p in bench.model.parameters())
          and bench.model.ln_f.scale.dtype == torch.float32,
          "O2 dtypes: bf16 weights, fp32 norms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bench.step(tokens, targets)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = device_time_by_kernel(torch, prof)
    busy = sum(t for _, t in by_name.values()) / 1e3
    if busy <= 0:
        print("  345M O2 train: device time by kernel not measured (the "
              "profiler saw no device events)")
    else:
        ours = sum(t for name, (_, t) in by_name.items()
                   if "apex_torch" in name) / 1e3
        print(f"  345M O2 train, one profiled step: wall {wall:.1f} ms, "
              f"device busy {busy:.1f} ms = {busy / wall:.3f} (idle "
              f"{1 - busy / wall:.3f}), the port's kernels {ours:.1f} ms = "
              f"{ours / busy:.3f} of busy; device time by kernel:")
        print_top(by_name)
        n_f, t_f = kernel_time(by_name, "fwd_resident_wgmma")
        n_q, t_q = kernel_time(by_name, "dq_resident_wgmma")
        n_k, t_k = kernel_time(by_name, "dkv_resident_wgmma")
        n_lf, t_lf = kernel_time(by_name, "ln_fwd_")
        n_lb, t_lb = kernel_time(by_name, "ln_bwd_")
        print(f"  345M O2 train, profiled step: resident forward {t_f:.2f} "
              f"ms ({n_f} launches); resident backward dQ {t_q:.2f} ms "
              f"({n_q}) + dK/dV {t_k:.2f} ms ({n_k}) = {t_q + t_k:.2f} ms of "
              f"device time; LayerNorm forward {t_lf:.2f} ms ({n_lf} "
              f"launches), backward {t_lb:.2f} ms ({n_lb} launches: the "
              f"kernel and its dgamma/dbeta finish)")
    return counts


# ---------------------------------------------------------------------------
# phase 5: ResNet-50 training (the ImageNet recipe)
# ---------------------------------------------------------------------------


def resnet_gradient_gate(torch, ops, dev):
    """fp32, small ResNet (Bottleneck stages (1, 1), width 8, 32x32 images
    with the ImageNet stem, 10 classes, batch 8): the loss, every
    parameter's grad and the running stats after one step on the card
    (cuDNN convs without TF32, the xentropy kernels) against the same model
    on the CPU (the plain versions). Tolerances: loss 1e-5 relative; each
    grad 1e-4 of its max |CPU grad| and each running stat 1e-5 of its max
    (fp32 sums in another order)."""
    import numpy as np

    from apex_tpu_torch.models import Bottleneck, ResNet
    from apex_tpu_torch.ops.xentropy import softmax_cross_entropy

    kw = dict(stage_sizes=(1, 1), block_cls=Bottleneck, num_classes=10,
              width=8, stem_pool=True)
    card = ResNet(device=dev, seed=3, **kw)
    host = ResNet(device="cpu", **kw)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.normal(size=(8, 32, 32, 3)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, (8,)))
    ops.reset_launch_counts()
    loss_c = torch.mean(softmax_cross_entropy(card(images.to(dev)),
                                              labels.to(dev)))
    loss_c.backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    loss_h = torch.mean(softmax_cross_entropy(host(images), labels))
    loss_h.backward()
    lc, lh = float(loss_c.detach()), float(loss_h.detach())
    rel = abs(lc - lh) / abs(lh)
    print(f"  ResNet fp32 gradient gate: loss card {lc:.7f} cpu {lh:.7f} "
          f"(rel {rel:.3g}, tol 1e-05); launches {counts}")
    verdict("ResNet fp32 gradient gate loss", rel, 1e-5,
            group="ResNet fp32 gradient gate")
    check(counts["xentropy_fwd"] == 1 and counts["xentropy_bwd"] == 1,
          "the ResNet gate ran each xentropy kernel once")
    worst = (0.0, "")
    for (name, pc), ph in zip(card.named_parameters(), host.parameters()):
        check(pc.grad is not None and ph.grad is not None,
              f"ResNet gate: no grad for {name}")
        e = rel_err(pc.grad.cpu(), ph.grad)
        worst = max(worst, (e, name))
        check(e <= 1e-4, f"ResNet gate {name}: rel err {e:.3g} > 1e-4")
    worst_s = (0.0, "")
    for (name, bc), bh in zip(card.named_buffers(), host.buffers()):
        e = rel_err(bc.cpu(), bh) if bh.is_floating_point() else float(
            not torch.equal(bc.cpu(), bh))
        worst_s = max(worst_s, (e, name))
        check(e <= 1e-5, f"ResNet gate running stat {name}: rel err "
              f"{e:.3g} > 1e-5")
    verdict(f"ResNet fp32 gradient gate worst grad ({worst[1]})",
            worst[0], 1e-4, group="ResNet fp32 gradient gate")
    verdict(f"ResNet fp32 gradient gate worst running stat ({worst_s[1]})",
            worst_s[0], 1e-5, group="ResNet fp32 gradient gate")
    print(f"  ResNet fp32 gradient gate: {len(list(host.parameters()))} "
          f"parameter grads within 1e-4 of max|cpu grad| (worst "
          f"{worst[0]:.3g}, {worst[1]}), {len(list(host.buffers()))} "
          f"running-stat buffers within 1e-5 (worst {worst_s[0]:.3g}, "
          f"{worst_s[1]})")


def device_time_by_class(by_name):
    """``{class: device ms}`` of a profiler run's kernels: the port's
    kernels, the libraries' convolutions and matrix products (cuDNN,
    cuBLAS, CUTLASS), reductions, and the elementwise kernels and copies
    (everything else)."""
    classes = {"the port's kernels": 0.0, "convolutions and GEMMs": 0.0,
               "reductions": 0.0, "elementwise and copies": 0.0}
    gemm = ("xmma", "cudnn", "conv", "cutlass", "gemm", "nvjet", "sm90_",
            "wgrad", "dgrad", "fprop")
    for name, (_, us) in by_name.items():
        low = name.lower()
        if "apex_torch" in name:
            key = "the port's kernels"
        elif any(t in low for t in gemm):
            key = "convolutions and GEMMs"
        elif "reduce" in low:
            key = "reductions"
        else:
            key = "elementwise and copies"
        classes[key] += us / 1e3
    return classes


def conv_fc_macs(torch, model, size, dev):
    """Multiply-adds of one image's forward, counted from the model's own
    conv and fc shapes: each conv's output elements x cin x kh x kw (one
    eval-mode forward at batch 1 with hooks reads the output shapes), the
    fc's in x out."""
    from apex_tpu_torch.models.resnet import Conv, Dense

    macs = []

    def hook(mod, _inp, out):
        w = mod.weight
        per_out = w.shape[1] * w.shape[2] * w.shape[3] \
            if isinstance(mod, Conv) else w.shape[1]
        macs.append(out.numel() * per_out)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv, Dense))]
    model.eval()
    with torch.no_grad():
        model(torch.zeros(1, size, size, 3, device=dev))
    model.train()
    for h in handles:
        h.remove()
    return sum(macs), len(macs)


def train_resnet50(torch, ops, dev):
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.examples.imagenet.main_amp import (
        build, fixed_batch, train_steps)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    batch, size = 256, 224
    trainer = build("resnet50", "O2", batch_size=batch, image_size=size,
                    num_classes=1000, lr=0.1, momentum=0.9,
                    weight_decay=1e-4, device=dev, seed=0)
    model = trainer.model
    n_params = sum(p.numel() for p in model.parameters())
    macs, n_layers = conv_fc_macs(torch, model, size, dev)
    images, labels = fixed_batch(trainer)
    n = 10
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    stats = train_steps(trainer, n, images, labels)  # 1 warm-up + n timed
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    steps = n + 1
    expected = dict.fromkeys(counts, 0)
    expected.update(xentropy_fwd=steps, xentropy_bwd=steps)
    print(f"  ResNet-50 O2 train: {n_params / 1e6:.2f} M params, batch "
          f"{batch} x {size}x{size}x3, {steps} steps, launches {counts} "
          f"(expected {expected})")
    check_counts(counts, expected, "train_resnet")
    losses = stats["losses"]
    skipped = [m["found_inf"] for m in stats["metrics"]]
    steps_ms = stats["step_ms"]
    ms = stats["window_ms"] / n
    flops = 3 * 2 * macs * batch  # training step: 3 x the forward's 2*MACs
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"  ResNet-50 O2 train: {n} steps in {stats['window_ms']:.2f} ms "
          f"= {ms:.2f} ms a step (per step: median "
          f"{statistics.median(steps_ms):.2f}, min {min(steps_ms):.2f}, max "
          f"{max(steps_ms):.2f}; all {[round(t, 2) for t in steps_ms]}), "
          f"{n * batch / stats['window_ms'] * 1e3:.1f} images/s, model "
          f"FLOPs {flops / 1e12:.3f} T/step ({macs / 1e9:.4f} GMACs a "
          f"forward image over {n_layers} conv and fc layers; x2 x3 x "
          f"{batch}) = {flops / ms / 1e9:.1f} TFLOP/s = "
          f"{flops / ms / 1e9 / 989:.3f} of 989 TFLOP/s, peak memory "
          f"{peak:.2f} GiB")
    print(f"  ResNet-50 O2 train: loss first {losses[0]:.4f} last "
          f"{losses[-1]:.4f} ({[round(v, 4) for v in losses]}), loss scale "
          f"{stats['metrics'][-1]['loss_scale']:g}, skipped steps "
          f"{skipped}")
    check(all(np.isfinite(losses)), "every ResNet loss finite")
    check(losses[-1] < losses[0], "the ResNet loss falls on the fixed batch")
    check(not any(skipped[1:]), "no step skipped after the warm-up")
    st = trainer.opt_state
    for (name, p), m in zip(model.named_parameters(), st.master):
        want = torch.float32 if ".bn" in f".{name}" else torch.bfloat16
        check(p.dtype == want, f"O2 dtype of {name}: {p.dtype}")
        check(torch.equal(p, m.to(p.dtype)), f"{name} == its master cast")
    check(model.conv1.weight.dtype == torch.bfloat16
          and model.bn1.scale.dtype == torch.float32,
          "O2 dtypes: bf16 convs, fp32 bn params")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(images, labels)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = device_time_by_kernel(torch, prof)
    busy = sum(t for _, t in by_name.values()) / 1e3
    if busy <= 0:
        print("  ResNet-50 O2 train: device time by kernel not measured "
              "(the profiler saw no device events)")
    else:
        ours = sum(t for name, (_, t) in by_name.items()
                   if "apex_torch" in name) / 1e3
        print(f"  ResNet-50 O2 train, one profiled step: wall {wall:.1f} ms, "
              f"device busy {busy:.1f} ms = {busy / wall:.3f} (idle "
              f"{1 - busy / wall:.3f}), the port's kernels {ours:.3f} ms = "
              f"{ours / busy:.4f} of busy; by class: "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in
                          device_time_by_class(by_name).items())
              + "; device time by kernel:")
        print_top(by_name, 15)
    return counts


# ---------------------------------------------------------------------------
# phase 6: long-context training (the streamed flash kernels)
# ---------------------------------------------------------------------------


def long_context_gradient_gate(torch, ops, dev):
    """fp32, small GPT at s = 4096 with rotary positions and a 512-token
    window (hidden 128, 4 heads, 2 layers, lm_head_chunks=2, remat on):
    loss and every parameter's grad on the card through the streamed
    kernels against the same parameters on the CPU through their plain
    versions. Tolerance: loss 1e-5 relative; each grad 1e-4 of its max
    |CPU grad| (fp32 sums in another order, the split sums by atomics)."""
    import numpy as np

    from apex_tpu_torch.models import GPTConfig, GPTModel

    cfg = GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                    num_attention_heads=4, max_seq_len=4096,
                    compute_dtype=torch.float32, hidden_dropout=0.0,
                    remat=True, lm_head_chunks=2,
                    position_embedding="rope", attention_window=512)
    card = GPTModel(cfg, device=dev, seed=11)
    host = GPTModel(cfg, device="cpu", seed=11)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 4096)))
    targets = torch.roll(tokens, -1, dims=-1)
    ops.reset_launch_counts()
    loss_c = card.loss(tokens.to(dev), targets.to(dev))
    loss_c.backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    loss_h = host.loss(tokens, targets)
    loss_h.backward()
    loss_c, loss_h = float(loss_c.detach()), float(loss_h.detach())
    rel = abs(loss_c - loss_h) / abs(loss_h)
    print(f"  fp32 long-context gradient gate (s=4096, rope, window 512): "
          f"loss card {loss_c:.7f} cpu {loss_h:.7f} (rel {rel:.3g}, tol "
          f"1e-05); launches {counts}")
    verdict("long-context fp32 gradient gate loss", rel, 1e-5,
            group="long-context fp32 gradient gate")
    for name in ("flash_attention_fwd_stream", "flash_attention_bwd_dq_stream",
                 "flash_attention_bwd_dkv_stream"):
        check(counts[name] > 0, f"long-context gate never launched {name}")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        check(counts[name] == 0, f"long-context gate launched {name}")
    worst = (0.0, "")
    for (name, pc), ph in zip(card.named_parameters(), host.parameters()):
        check(pc.grad is not None and ph.grad is not None,
              f"long-context gate: no grad for {name}")
        e = rel_err(pc.grad.cpu(), ph.grad)
        worst = max(worst, (e, name))
        check(e <= 1e-4, f"long-context gate {name}: rel err {e:.3g} > 1e-4")
    verdict(f"long-context fp32 gradient gate worst grad ({worst[1]})",
            worst[0], 1e-4, group="long-context fp32 gradient gate")
    print(f"  fp32 long-context gradient gate: {len(list(host.parameters()))}"
          f" parameter grads within 1e-4 of max|cpu grad| (worst "
          f"{worst[0]:.3g}, {worst[1]})")


def train_long_context(torch, ops, dev, seq, window, pos):
    """GPT-2 345M (vocab 50304, hidden 1024, 24 layers, 16 heads) under amp
    O2 with FusedAdam(lr=1e-4), full remat and lm_head_chunks=8, batch 1 x
    ``seq``, through ``examples/longcontext/train_long_context.build``: one
    warm-up step and 10 timed as one window, with the exact launch counts,
    a falling finite loss, no skipped step and bf16 params equal to their
    masters cast down; then one profiled step."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.bench import fixed_batch, train_steps
    from apex_tpu_torch.examples.longcontext.train_long_context import build

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = build(seq=seq, hidden=1024, layers=24, heads=16, vocab=50304,
                    batch=1, lm_head_chunks=8, window=window, pos=pos,
                    device=dev, seed=0)
    cfg, L = trainer.cfg, trainer.cfg.num_layers
    label = f"345M O2 long-context seq {seq} {pos}" + (
        f" window {window}" if window else "")
    n_params = sum(p.numel() for p in trainer.model.parameters())
    tokens, targets = fixed_batch(trainer)
    n = 10
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    stats = train_steps(trainer, n, tokens, targets)  # 1 warm-up + n timed
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    steps = n + 1
    per_step = dict.fromkeys(counts, 0)
    per_step.update({"flash_attention_fwd_stream": 2 * L,
                     "flash_attention_bwd_dq_stream": L,
                     "flash_attention_bwd_dkv_stream": L,
                     "layer_norm_fwd": 4 * L + 1,
                     "layer_norm_bwd": 2 * L + 1})
    expected = {k: v * steps for k, v in per_step.items()}
    print(f"  {label}: {n_params / 1e6:.1f} M params, batch 1 x {seq}, "
          f"{steps} steps, launches {counts} (expected per step "
          f"{ {k: v for k, v in per_step.items() if v} }, others 0)")
    check_counts(counts, expected, label)
    losses = stats["losses"]
    skipped = sum(m["found_inf"] for m in stats["metrics"])
    steps_ms = stats["step_ms"]
    ms = stats["window_ms"] / n
    tok = stats["tokens_per_step"]
    pairs = visible_pairs(seq, seq, True, window) if window else None
    flops = model_flops_per_token(cfg, pairs) * tok
    formula = ("6*(12*L*H^2 + V*H) + 6*L*S*H per token" if pairs is None
               else f"6*(12*L*H^2 + V*H) + 12*L*H*pairs/S per token, pairs = "
               f"{pairs} visible (query, key) pairs of a head")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"  {label}: {n} steps in {stats['window_ms']:.2f} ms = {ms:.2f} "
          f"ms a step (per step: median {statistics.median(steps_ms):.2f}, "
          f"min {min(steps_ms):.2f}, max {max(steps_ms):.2f}; all "
          f"{[round(t, 2) for t in steps_ms]}), "
          f"{n * tok / stats['window_ms'] * 1e3:.1f} tokens/s, model FLOPs "
          f"{flops / 1e12:.3f} T/step = {flops / ms / 1e9:.1f} TFLOP/s = "
          f"{flops / ms / 1e9 / 989:.3f} of 989 TFLOP/s ({formula}), peak "
          f"memory {peak:.2f} GiB")
    print(f"  {label}: loss first {losses[0]:.4f} last {losses[-1]:.4f} "
          f"({[round(v, 4) for v in losses]}), loss scale "
          f"{stats['metrics'][-1]['loss_scale']:g}, skipped steps {skipped}")
    check(all(np.isfinite(losses)), f"{label}: every loss finite")
    check(losses[-1] < losses[0], f"{label}: the loss falls")
    check(skipped == 0, f"{label}: no step skipped")
    for p, m in zip(trainer.model.parameters(), trainer.opt_state.master):
        check(torch.equal(p, m.to(p.dtype)),
              f"{label}: bf16 params == masters cast")
    check(any(p.dtype == torch.bfloat16
              for p in trainer.model.parameters())
          and trainer.model.ln_f.scale.dtype == torch.float32
          and (trainer.model.position is None) == (pos != "learned"),
          f"{label}: O2 dtypes and the position table")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(tokens, targets)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = device_time_by_kernel(torch, prof)
    busy = sum(t for _, t in by_name.values()) / 1e3
    if busy <= 0:
        print(f"  {label}: device time by kernel not measured (the profiler "
              f"saw no device events)")
    else:
        ours = sum(t for name, (_, t) in by_name.items()
                   if "apex_torch" in name) / 1e3
        print(f"  {label}, one profiled step: wall {wall:.1f} ms, device "
              f"busy {busy:.1f} ms = {busy / wall:.3f} (idle "
              f"{1 - busy / wall:.3f}), the port's kernels {ours:.1f} ms = "
              f"{ours / busy:.3f} of busy; device time by kernel:")
        print_top(by_name)
        n_f, t_f = kernel_time(by_name, "fwd_wgmma", "fwd_split")
        n_m, t_m = kernel_time(by_name, "fwd_merge")
        n_b, t_b = kernel_time(by_name, "dq_wgmma", "dkv_wgmma", "dq_split",
                               "dkv_split")
        print(f"  {label}, profiled step: streamed forward {t_f:.2f} ms "
              f"({n_f} launches) + merge {t_m:.2f} ms ({n_m}) = "
              f"{t_f + t_m:.2f} ms of device time; streamed backward dQ + "
              f"dK/dV {t_b:.2f} ms ({n_b})")
    del trainer
    return counts


# ---------------------------------------------------------------------------
# phase 7: fused softmax and the small layers
# ---------------------------------------------------------------------------


def l2_err(got, ref):
    """||got - ref||_2 / ||ref||_2 over the whole tensor, in fp32."""
    g, r = got.float(), ref.float()
    return float((g - r).norm() / r.norm().clamp_min(1e-30))


def held(name, got, ref, share, row, route="cuda", floor=1e-3, group=None):
    """``got`` against ``ref``: the share of max |ref| and the worst row
    (:func:`row_err` with ``floor``), each to its limit under ``group``;
    returns the printable part."""
    e, e_row = rel_err(got, ref), row_err(got, ref, floor)
    verdict(f"{name}", e, share, route, group)
    verdict(f"{name} row", e_row, row, route, group)
    return f"{name.split()[-1]} {e:.3g} (row {e_row:.3g})"


def fused_softmax_and_small_layers(torch, ops, dev):
    """The port's ``FusedScaleMaskSoftmax`` and small layers, forward and
    backward through autograd, every launch counted from 0:

    (a) ``FusedScaleMaskSoftmax`` at the GPT-2 345M score shape
        (8,16,1024,1024) bf16, causal, scale 0.125, with both
        ``softmax_in_fp32`` settings; at the BERT-large padded shape
        (8,16,512,512) with ``AttnMaskType.padding``; on an unaligned
        (2,3,300,77) shape (the plain route) and with ``fused=False``:
        one launch of each softmax kernel per fused call, none otherwise;
    (b) the explicit-scores attention the module exists for, at q, k, v
        (8,16,1024,64) bf16: ``q @ k^T``, the module (causal, scale 0.125,
        bf16 probabilities), ``@ v``;
    (c) at GPT-2 345M width on 8192 x 1024 bf16 tokens: ``FusedLayerNorm``,
        ``FusedRMSNorm`` (fp32 params), ``FastLayerNorm(1024)`` (one launch
        of each LayerNorm kernel apiece), ``FusedDenseGeluDense(1024, 4096,
        1024)`` and ``MLP((1024, 4096, 1024))`` (cuBLAS, no kernel of ours).

    Then, outside the counted run: (a) against the same module with
    ``fused=False`` on the same inputs: y within 2e-2 of max |ref| and
    worst rows 1e-2, dx within 2e-2 of max |ref| (its worst row is
    printed, not held: the fused backward works from the bf16-rounded y,
    as the reference's VJP does, the plain route from fp32 probabilities
    through autograd, and where g - sum g*y cancels a row of two keys can
    read 0.1); the fused dx also against the VJP's formula
    (``softmax_bwd_reference``) on the module's own y, 2e-2 of max |ref|
    and worst rows 1.5e-2; (b) output and q/k/v grads against
    ``ops.flash_attention(q, k, v, causal=True)``, 2e-2 of max |ref|
    (the two round to bf16 in different places: the composite its
    scores, probabilities and dP, flash its P and dS), the output's worst
    row 4e-2 (each row floored at 1e-2 of its head's largest), each grad's
    whole-tensor relative l2 2e-2 (a grad row whose exact value cancels,
    as the first queries' dq does, holds mostly rounding noise, so its
    worst row is printed and not held), with both fwd+bwd times; (c) each module against a copy on the CPU with the
    same params: the norms in bf16 within the LayerNorm checks' limits (y
    one bf16 ulp, dx 2^-7 of max |ref|, dgamma/dbeta 1e-4), the dense
    layers in bf16 too, each output and grad within 2e-2 relative l2 of the
    whole tensor (an activation's gradient flips where a pre-activation
    lies within rounding of 0, so single elements may differ by their
    whole size between two summation orders). Returns the run's launch
    counts."""
    import copy

    from apex_tpu_torch.contrib import FastLayerNorm
    from apex_tpu_torch.models import MLP, FusedDenseGeluDense
    from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm
    from apex_tpu_torch.transformer.functional import (
        AttnMaskType, FusedScaleMaskSoftmax)

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(13)

    def rand(*shape, dt=bf16, std=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * std).to(dt)

    causal, padding = AttnMaskType.causal, AttnMaskType.padding
    gpt, bert, odd = (8, 16, 1024, 1024), (8, 16, 512, 512), (2, 3, 300, 77)
    bert_mask = padding_mask(torch, dev, gen, 8, 512, 512, 64)
    odd_mask = torch.rand(2, 1, 300, 77, device=dev, generator=gen) < 0.3
    softmax_runs = [  # label, module kwargs, shape, mask, launches each
        ("gpt fp32-out", dict(attn_mask_type=causal, scale=0.125), gpt,
         None, 1),
        ("gpt bf16-out", dict(attn_mask_type=causal, scale=0.125,
                              softmax_in_fp32=False), gpt, None, 1),
        ("bert", dict(attn_mask_type=padding, scale=0.125), bert, bert_mask,
         1),
        ("unaligned", dict(attn_mask_type=padding), odd, odd_mask, 0),
        ("bert fused=False", dict(attn_mask_type=padding, scale=0.125,
                                  fused=False), bert, bert_mask, 0),
    ]
    inputs = {label: (rand(*shape, std=4.0), mask)
              for label, _, shape, mask, _ in softmax_runs}
    q, k, v, do = (rand(8, 16, 1024, 64) for _ in range(4))
    tokens = rand(8192, 1024, std=2.0)
    modules = [  # label, module, LayerNorm launches each
        ("FusedLayerNorm", FusedLayerNorm(1024, device=dev), 1),
        ("FusedRMSNorm", FusedRMSNorm(1024, device=dev), 1),
        ("FastLayerNorm", FastLayerNorm(1024, device=dev), 1),
        ("FusedDenseGeluDense", FusedDenseGeluDense(1024, 4096, 1024,
                                                    device=dev, seed=1), 0),
        ("MLP", MLP((1024, 4096, 1024), device=dev, seed=2), 0),
    ]
    with torch.no_grad():  # affine params away from ones/zeros
        for _, mod, _ in modules[:3]:
            for p in mod.parameters():
                p.add_(0.1 * torch.randn(p.shape, device=dev, generator=gen))
    layer_g = rand(8192, 1024)

    def attention(q, k, v):
        sm = FusedScaleMaskSoftmax(causal, scale=0.125,
                                   softmax_in_fp32=False)
        return sm(q @ k.transpose(-1, -2)) @ v

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = {}
    for label, kw, _, _, n in softmax_runs:
        x, mask = inputs[label]
        x = x.detach().requires_grad_()
        before = ops.launch_counts()
        y = FusedScaleMaskSoftmax(**kw)(x, mask)
        g = torch.ones_like(y).normal_(generator=gen)
        (dx,) = torch.autograd.grad(y, x, g)
        after = ops.launch_counts()
        got[label] = (y.detach(), dx, g)
        for name in ("softmax_fwd", "softmax_bwd"):
            verdict(f"phase 7 {label}: {name} launches - {n}",
                    abs(after[name] - before[name] - n), 0, "-",
                    group=f"FusedScaleMaskSoftmax {label}")
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = attention(qg, kg, vg)
    composite = (out.detach(), *torch.autograd.grad(out, (qg, kg, vg), do))
    for label, mod, _ in modules:
        x = tokens.detach().requires_grad_()
        y = mod(x)
        grads = torch.autograd.grad(y, [x, *mod.parameters()], layer_g)
        got[label] = (y.detach(), *grads)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    expected = dict.fromkeys(counts, 0)
    expected.update(softmax_fwd=4, softmax_bwd=4, layer_norm_fwd=3,
                    layer_norm_bwd=3)
    print(f"  phase 7 launches {counts} (expected "
          f"{ {k: v for k, v in expected.items() if v} }, others 0)")
    check_counts(counts, expected, "softmax")

    # (a) against the plain route on the same inputs
    for label, kw, shape, _, n in softmax_runs:
        x, mask = inputs[label]
        x = x.detach().requires_grad_()
        y_ref = FusedScaleMaskSoftmax(**dict(kw, fused=False))(x, mask)
        y, dx, g = got[label]
        (dx_ref,) = torch.autograd.grad(y_ref, x, g)
        y_ref = y_ref.detach()
        check(y.dtype == y_ref.dtype == (torch.float32 if kw.get(
            "softmax_in_fp32", True) else bf16), f"phase 7 {label}: dtype")
        route = "kernel" if n else "plain"
        tag = f"FusedScaleMaskSoftmax {label}"
        e_dx = rel_err(dx, dx_ref)
        verdict(f"{tag} dx vs fused=False", e_dx, 2e-2, route, tag)
        parts = [held(f"{tag} y", y, y_ref, 2e-2, 1e-2, route, group=tag),
                 f"dx {e_dx:.3g} (row {row_err(dx, dx_ref):.3g}, not held)"]
        if n:
            # the reference VJP's own formula on the module's bf16 y
            xd = inputs[label][0]
            vjp = ops.softmax_bwd_reference(g.to(xd.dtype), y.to(xd.dtype),
                                            kw["scale"])
            parts.append(held(f"{tag} dx vs VJP", dx, vjp, 2e-2, 1.5e-2,
                              route, group=tag))
        print(f"  {tag} {shape} [{route}] against fused=False, of max|ref|: "
              + ", ".join(parts))
    del inputs

    # (b) the composite attention against the flash kernels
    qf, kf, vf = (t.detach().requires_grad_() for t in (q, k, v))
    of = ops.flash_attention(qf, kf, vf, causal=True, scale=0.125)
    flash = (of.detach(), *torch.autograd.grad(of, (qf, kf, vf), do))
    tag = "explicit-scores attention"
    parts = [held(f"{tag} o", composite[0], flash[0], 2e-2, 4e-2,
                  floor=1e-2, group=tag)]
    for name, a, r in zip(("dq", "dk", "dv"), composite[1:], flash[1:]):
        e, e_l2 = rel_err(a, r), l2_err(a, r)
        verdict(f"{tag} {name}", e, 2e-2, group=tag)
        verdict(f"{tag} {name} l2", e_l2, 2e-2, group=tag)
        parts.append(f"{name} {e:.3g} (l2 {e_l2:.3g}, row "
                     f"{row_err(a, r, 1e-2):.3g} not held)")

    def fwd_bwd(fn):
        # fresh leaves each call: their autograd nodes are made on the
        # stream being captured
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fn(*leaves), leaves, do)

    ms_comp = time_ms(lambda: fwd_bwd(attention), 5)
    ms_flash = time_ms(lambda: fwd_bwd(
        lambda a, b, c: ops.flash_attention(a, b, c, causal=True,
                                            scale=0.125)), 5)
    print(f"  explicit-scores attention (8,16,1024,64) bf16 causal against "
          f"flash_attention, of max|ref|: " + ", ".join(parts)
          + f"; forward + backward: matmul + FusedScaleMaskSoftmax + matmul "
          f"{ms_comp:.4f} ms, flash_attention {ms_flash:.4f} ms")
    del composite, flash, qg, kg, vg, qf, kf, vf, of

    # (c) each small layer against a copy of it on the CPU
    x_cpu = tokens.cpu()
    g_cpu = layer_g.cpu()
    for label, mod, n in modules:
        host = copy.deepcopy(mod).cpu()
        dense = n == 0
        xh = x_cpu.requires_grad_()
        yh = host(xh)
        refs = (yh.detach(), *torch.autograd.grad(
            yh, [xh, *host.parameters()], g_cpu.to(yh.dtype)))
        names = ["y", "dx"] + [f"d{p}" for p, _ in host.named_parameters()]
        parts = []
        for name, a, r in zip(names, got[label], refs):
            a = a.cpu()
            tag, grp = f"{label} {name}", f"{label} against the CPU"
            if dense:
                # ReLU/GeLU gradients flip where a pre-activation lies
                # within rounding of 0, so single elements may differ by
                # their whole size: the whole tensor's relative l2 error
                e = l2_err(a, r)
                verdict(f"{tag} l2", e, 2e-2, "cuBLAS", grp)
                parts.append(f"{name} {e:.3g} (of max|ref| "
                             f"{rel_err(a, r):.3g})")
            elif name == "y":
                # one bf16 ulp at |y|: both round the same fp32 value
                over = float(((a.float() - r.float()).abs()
                              - r.float().abs() * 2.0 ** -7 - 1e-6).max())
                verdict(f"{tag} over 1 bf16 ulp", max(over, 0.0), 0.0,
                        group=grp)
                parts.append(f"y {max_err(a, r):.3g} (within 1 bf16 ulp)")
            else:
                lim = 2.0 ** -7 if name == "dx" else 1e-4
                e = rel_err(a, r)
                verdict(tag, e, lim, group=grp)
                parts.append(f"{name} {e:.3g}")
        print(f"  {label} (8192 x 1024 bf16, fp32 params) against the CPU, "
              f"{'relative l2' if dense else 'of max|ref|'}: "
              + ", ".join(parts))
    del got, modules
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 8: BERT-large pretraining with FusedLAMB
# ---------------------------------------------------------------------------


def bert_gradient_gate(torch, ops, dev):
    """fp32, small BERT (hidden 256, 2 layers, 4 heads, seq 256, vocab
    1024) on a padded batch (lengths 256, 200, 129, 77): the loss and every
    parameter's grad on the card through the kernels (the resident flash
    kernels with the padding bias) against the same parameters on the CPU
    through the plain versions. Tolerance: loss 1e-5 relative; each grad
    1e-4 of its max |CPU grad| (fp32 sums in another order through two
    layers)."""
    import numpy as np

    from apex_tpu_torch.models import BertConfig, BertModel

    cfg = BertConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                     num_attention_heads=4, max_seq_len=256,
                     compute_dtype=torch.float32, hidden_dropout=0.0)
    card = BertModel(cfg, device=dev, seed=11)
    host = BertModel(cfg, device="cpu", seed=11)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(11)
    b, s = 4, 256
    attn = (np.arange(s)[None] < np.array([256, 200, 129, 77])[:, None])
    batch = [rng.integers(0, cfg.vocab_size, (b, s)), attn.astype(np.int32),
             (rng.random((b, s)) < 0.15).astype(np.int32),
             rng.integers(0, cfg.vocab_size, (b, s)),
             rng.integers(0, 2, (b,)), rng.integers(0, 2, (b, s))]
    batch = [torch.from_numpy(a) for a in batch]
    ops.reset_launch_counts()
    loss_c = card.loss(*(t.to(dev) for t in batch))
    loss_c.backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    loss_h = host.loss(*batch)
    loss_h.backward()
    loss_c, loss_h = float(loss_c.detach()), float(loss_h.detach())
    rel = abs(loss_c - loss_h) / abs(loss_h)
    print(f"  BERT fp32 gradient gate: loss card {loss_c:.7f} cpu "
          f"{loss_h:.7f} (rel {rel:.3g}, tol 1e-05); launches {counts}")
    verdict("BERT fp32 gradient gate loss", rel, 1e-5,
            group="BERT fp32 gradient gate")
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "layer_norm_fwd",
                 "layer_norm_bwd"):
        check(counts[name] > 0, f"BERT gradient gate never launched {name}")
    worst = (0.0, "")
    for (name, pc), ph in zip(card.named_parameters(), host.parameters()):
        check(pc.grad is not None and ph.grad is not None,
              f"BERT gradient gate: no grad for {name}")
        e = rel_err(pc.grad.cpu(), ph.grad)
        worst = max(worst, (e, name))
    verdict(f"BERT fp32 gradient gate worst grad ({worst[1]})", worst[0],
            1e-4, group="BERT fp32 gradient gate")
    print(f"  BERT fp32 gradient gate: {len(list(host.parameters()))} "
          f"parameter grads, worst {worst[0]:.3g} of max|cpu grad| "
          f"({worst[1]}; tol 1e-4)")


def bert_flops_per_token(cfg):
    """Training FLOPs per token of BERT, without the remat recompute: 6 x
    (the 12*L*H^2 layer weights + the V*H tied decode + the H^2 MLM dense)
    + 12*L*S*H for the non-causal attention products, which count every
    (query, key) pair; the pooler and the binary head (a few per
    sequence) are left out."""
    L, H, S, V = (cfg.num_layers, cfg.hidden_size, cfg.max_seq_len,
                  cfg.vocab_size)
    return 6 * (12 * L * H * H + V * H + H * H) + 12 * L * S * H


def train_bert_large(torch, ops, dev):
    """BERT-large MLM + NSP pretraining under amp O2 with FusedLAMB(lr
    2e-3, weight decay 0.01) through the example's ``build`` at 16 x 512
    (8192 tokens a step), one fixed synthetic batch: one warm-up step and
    10 timed as one window, the exact launch counts (#1 2L a step with the
    remat recompute, #5 and #6 L each, #7 4L + 2, #8 2L + 2), a falling
    finite loss, no skipped step, bf16 params equal to their fp32 masters
    cast down; tokens/s, the model-FLOPs share of 989 TFLOP/s
    (:func:`bert_flops_per_token`), peak memory, and one profiled step's
    idle share and leading kernels."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.bench import train_steps
    from apex_tpu_torch.examples.bert.pretrain_bert import (
        build,
        synthetic_batch,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = build(hidden=1024, layers=24, heads=16, seq=512, batch=16,
                    device=dev)
    cfg, L = trainer.cfg, trainer.cfg.num_layers
    n_params = sum(p.numel() for p in trainer.model.parameters())
    batch = synthetic_batch(np.random.default_rng(0), 16, 512,
                            cfg.vocab_size, dev)
    n = 10
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    stats = train_steps(trainer, n, batch=batch)  # 1 warm-up + n timed
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    steps = n + 1
    per_step = dict.fromkeys(counts, 0)
    per_step.update({"flash_attention_fwd": 2 * L,
                     "flash_attention_bwd_dq": L,
                     "flash_attention_bwd_dkv": L,
                     "layer_norm_fwd": 4 * L + 2,
                     "layer_norm_bwd": 2 * L + 2})
    expected = {k: v * steps for k, v in per_step.items()}
    print(f"  BERT-large O2 FusedLAMB: {n_params / 1e6:.1f} M params, batch "
          f"16 x 512, {steps} steps, launches {counts} (expected per step "
          f"{per_step})")
    check_counts(counts, expected, "bert")
    losses = stats["losses"]
    skipped = sum(m["found_inf"] for m in stats["metrics"])
    steps_ms = stats["step_ms"]
    ms = stats["window_ms"] / n
    tok = stats["tokens_per_step"]
    flops = bert_flops_per_token(cfg) * tok
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"  BERT-large O2 FusedLAMB: {n} steps in {stats['window_ms']:.2f} "
          f"ms = {ms:.2f} ms a step (per step: median "
          f"{statistics.median(steps_ms):.2f}, min {min(steps_ms):.2f}, max "
          f"{max(steps_ms):.2f}; all {[round(t, 2) for t in steps_ms]}), "
          f"{n * tok / stats['window_ms'] * 1e3:.1f} tokens/s, model FLOPs "
          f"{flops / 1e12:.2f} T/step = {flops / ms / 1e9:.1f} TFLOP/s = "
          f"{flops / ms / 1e9 / 989:.3f} of 989 TFLOP/s (6*(12*L*H^2 + V*H "
          f"+ H^2) + 12*L*S*H per token, every pair), peak memory "
          f"{peak:.2f} GiB")
    print(f"  BERT-large O2 FusedLAMB: loss first {losses[0]:.4f} last "
          f"{losses[-1]:.4f} ({len(losses)} steps: "
          f"{[round(x, 4) for x in losses]}), loss scale "
          f"{stats['metrics'][-1]['loss_scale']:g}, skipped steps {skipped}")
    check(all(np.isfinite(losses)), "every BERT loss finite")
    check(losses[-1] < losses[0], "the BERT loss falls on the fixed batch")
    check(skipped == 0, "no BERT step skipped")
    for p, m in zip(trainer.model.parameters(), trainer.opt_state.master):
        check(torch.equal(p, m.to(p.dtype)), "bf16 params == masters cast")
    check(trainer.model.lm_dense.kernel.dtype == torch.bfloat16
          and trainer.model.ln_emb.scale.dtype == torch.float32,
          "O2 dtypes: bf16 weights, fp32 norms")
    verdict("BERT-large loss falls, no step skipped, params == masters",
            0, 0, "-", group="BERT-large O2 FusedLAMB")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = device_time_by_kernel(torch, prof)
    busy = sum(t for _, t in by_name.values()) / 1e3
    if busy <= 0:
        print("  BERT-large O2 FusedLAMB: device time by kernel not measured "
              "(the profiler saw no device events)")
    else:
        ours = sum(t for name, (_, t) in by_name.items()
                   if "apex_torch" in name) / 1e3
        print(f"  BERT-large O2 FusedLAMB, one profiled step: wall "
              f"{wall:.1f} ms, device busy {busy:.1f} ms = {busy / wall:.3f}"
              f" (idle {1 - busy / wall:.3f}), the port's kernels "
              f"{ours:.1f} ms = {ours / busy:.3f} of busy; device time by "
              f"kernel:")
        print_top(by_name)
        n_f, t_f = kernel_time(by_name, "fwd_resident_wgmma")
        n_q, t_q = kernel_time(by_name, "dq_resident_wgmma")
        n_k, t_k = kernel_time(by_name, "dkv_resident_wgmma")
        n_lf, t_lf = kernel_time(by_name, "ln_fwd_")
        n_lb, t_lb = kernel_time(by_name, "ln_bwd_")
        n_o, t_o = kernel_time(by_name, "foreach", "multi_tensor")
        print(f"  BERT-large O2 FusedLAMB, profiled step: resident forward "
              f"with the bias {t_f:.2f} ms ({n_f} launches); dQ {t_q:.2f} ms "
              f"({n_q}) + dK/dV {t_k:.2f} ms ({n_k}); LayerNorm forward "
              f"{t_lf:.2f} ms ({n_lf}), backward {t_lb:.2f} ms ({n_lb}); "
              f"foreach (the LAMB and amp passes) {t_o:.2f} ms ({n_o})")
    del trainer
    torch.cuda.empty_cache()
    return counts


def optimizer_step_line(torch, dev):
    """``apex_tpu_torch.benchmarks.optimizer_step`` on the card: its JSON
    line (fused Adam and fused LAMB against eager Adam on the GPT-2-124M
    and BERT-large lists)."""
    from apex_tpu_torch.benchmarks import optimizer_step

    rec = optimizer_step.run(dev)
    print(json.dumps(rec))
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 10: the GPT examples (pretrain_gpt -> checkpoint -> resume ->
# generate_gpt) at GPT-2 345M
# ---------------------------------------------------------------------------

#: GPT-2 345M, the examples' model flags
GPT_345M = ["--hidden", "1024", "--layers", "24", "--heads", "16",
            "--vocab", "50304"]
#: the pretrain example at BASELINE config 4: 8 x 1024 tokens a step as 2
#: micro-batches of 4, at phase 4's lr: a workaround, since at the
#: example's default 3e-4 the first batch's loss rose over 11 steps here,
#: for no known cause (:func:`pretrain_default_lr` prints it)
PRETRAIN_345M = GPT_345M + ["--seq", "1024", "--micro-batch", "4",
                            "--num-microbatches", "2", "--lr", "1e-4"]


def with_layers(argv, layers):
    """``argv`` with its ``--layers`` set to ``layers``."""
    argv = list(argv)
    argv[argv.index("--layers") + 1] = str(layers)
    return argv


#: phases 14-18 run GPT-2 345M's width (and BERT-large's) at 8 layers, not
#: 24: each holds runs of one config against each other (a parallel run
#: against its serial twin), so both sides shrink together; the room phase
#: 19 needs in the script's 1200 s
RANK_LAYERS = 8
RANKS_PRETRAIN = with_layers(PRETRAIN_345M, RANK_LAYERS)
#: phase 10 runs the examples at 345M's width and :data:`RANK_LAYERS`
#: layers, not 24 (the room phase 19's exact reference needs): it holds
#: the examples' paths (launches, checkpoint bits, greedy tokens) whatever
#: the depth, and the 24-layer 345M step is timed in phases 4 and 11
PRETRAIN_10 = RANKS_PRETRAIN
#: the generate example's engine at 345M
GENERATE_345M = GPT_345M + ["--max-seq", "1024", "--max-batch", "8",
                            "--block-size", "16", "--max-new-tokens", "32"]
GENERATE_10 = with_layers(GENERATE_345M, RANK_LAYERS)


def pretrain_per_step(L, M, policy="full"):
    """Launches of one pretrain step: per micro-batch the forward and the
    backward of every layer, with the remat recompute (the attention
    forward not again under save_attn), LN twice a layer in the forward and
    again in the recompute plus the final LN, the backward once each."""
    return {"flash_attention_fwd": (1 if policy == "save_attn" else 2) * L * M,
            "flash_attention_bwd_dq": L * M,
            "flash_attention_bwd_dkv": L * M,
            "layer_norm_fwd": (4 * L + 1) * M,
            "layer_norm_bwd": (2 * L + 1) * M}


def expected_counts(counts, steps, per_step):
    out = dict.fromkeys(counts, 0)
    out.update({k: v * steps for k, v in per_step.items()})
    return out


def train_state_equal(torch, a, b):
    """(equal, tensors compared): every param, master, Adam moment, the
    step count and the scaler of two pretrain trainers bit for bit."""
    sa, sb = a.opt_state, b.opt_state
    pairs = list(zip(list(a.model.parameters()) + sa.master
                     + sa.inner.exp_avg + sa.inner.exp_avg_sq,
                     list(b.model.parameters()) + sb.master
                     + sb.inner.exp_avg + sb.inner.exp_avg_sq))
    same = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs)
    same = same and sa.inner.step == sb.inner.step and (
        sa.scaler.loss_scale, sa.scaler.unskipped) == (
        sb.scaler.loss_scale, sb.scaler.unskipped)
    return same, len(pairs) + 3


def pretrain_save_resume(torch, ops, dev, ckpt_dir):
    """(a): ``pretrain_gpt`` at 345M, O2, 11 steps saving at 11; its
    resume (a second ``run`` on the same directory) restores every tensor
    bit for bit; the next step on the stream's first batch (where a resumed
    run starts, as the reference's) gives the same loss bits from the
    in-memory trainer and the restored one."""
    import numpy as np

    from apex_tpu_torch.examples.gpt import pretrain_gpt

    argv = PRETRAIN_10 + ["--save-dir", ckpt_dir, "--save-every", "11"]
    steps = 11
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = pretrain_gpt.run(argv + ["--steps", str(steps)])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    bench = res["bench"]
    cfg, L, M = bench.cfg, bench.cfg.num_layers, 2
    per_step = pretrain_per_step(L, M)
    print(f"  (a) pretrain_gpt 345M O2: {steps} steps of {bench.batch} x "
          f"{cfg.max_seq_len} ({M} micro-batches), launches {counts} "
          f"(expected per step {per_step})")
    check_counts(counts, expected_counts(counts, steps, per_step),
                 "gpt_pretrain")
    losses = res["losses"]
    skipped = sum(m["found_inf"] for m in res["metrics"])
    tok = bench.batch * cfg.max_seq_len
    flops = model_flops_per_token(cfg) * tok
    step_ms = [t * 1e3 for t in res["step_s"][1:]]
    ms = statistics.median(step_ms)
    path = os.path.join(ckpt_dir, f"step_{steps}", "state.npz")
    nbytes = os.path.getsize(path)
    print(f"  (a) pretrain_gpt 345M O2: {ms:.2f} ms a step (median of steps "
          f"2-{steps}, host clock to each step's loss; min "
          f"{min(step_ms):.2f}, max {max(step_ms):.2f}), {tok / ms * 1e3:.1f}"
          f" tokens/s, model FLOPs {flops / ms / 1e9:.1f} TFLOP/s = "
          f"{flops / ms / 1e9 / 989:.3f} of 989 TFLOP/s; the example's own "
          f"window (the save included) {res['ms_per_step']:.2f} ms a step, "
          f"{res['tokens_per_s']:.1f} tokens/s; peak memory {peak:.2f} GiB "
          f"over the {base / 2 ** 30:.2f} GiB held before; "
          f"loss first "
          f"{losses[0]:.4f} last {losses[-1]:.4f}, skipped steps {skipped}; "
          f"checkpoint {nbytes} bytes ({nbytes / 2 ** 30:.3f} GiB), saved in "
          f"{res['save_s'][0]:.2f} s")
    check(all(np.isfinite(losses)), "every pretrain loss finite")
    check(skipped == 0, "no pretrain step skipped")

    resumed = pretrain_gpt.run(argv + ["--steps", "0"])
    check(resumed["start"] == steps, "the second run resumes from step 11")
    same, n = train_state_equal(torch, bench, resumed["bench"])
    print(f"  (a) resume: restored in {resumed['restore_s']:.2f} s; {n} "
          f"params, masters, Adam moments, step and scaler bit-identical "
          f"to the saved trainer's: {same}")
    verdict("gpt pretrain: restored state bit-identical", 0 if same else 1,
            0, group="gpt examples: checkpoint and resume")
    args = pretrain_gpt.parse_args(argv)
    toks, tgts = next(pretrain_gpt.batches(args, bench.batch))
    cont, _ = bench.step(toks, tgts)
    again, _ = resumed["bench"].step(toks, tgts)
    cont, again = float(cont), float(again)
    same_step, _ = train_state_equal(torch, bench, resumed["bench"])
    print(f"  (a) the step after the restore, on the stream's first batch "
          f"(a resumed run restarts the data): in-memory {cont!r}, restored "
          f"{again!r}, states after it bit-identical: {same_step}; the same "
          f"batch's loss at step 0 {losses[0]:.4f}")
    verdict("gpt pretrain: next-step loss bit-identical after restore",
            0 if cont == again and same_step else 1, 0,
            group="gpt examples: checkpoint and resume")
    check(np.isfinite(cont) and cont < losses[0],
          "the first batch's loss fell over the 11 steps")
    del res, resumed, bench
    gc.collect()
    torch.cuda.empty_cache()
    return counts, peak


def pretrain_default_lr(torch, dev, opt_level="O2", beside=None):
    """The pretrain example at ``opt_level`` and its default lr 3e-4 for 11
    steps (the batches of (a)), then the stream's first batch again: its
    loss before and after, beside ``beside`` (O2's (before, after)).
    Reported, not a check. Returns (before, after)."""
    from apex_tpu_torch.examples.gpt import pretrain_gpt

    argv = PRETRAIN_10 + ["--lr", "3e-4", "--opt-level", opt_level]
    res = pretrain_gpt.run(argv + ["--steps", "11"])
    toks, tgts = next(pretrain_gpt.batches(pretrain_gpt.parse_args(argv),
                                           res["bench"].batch))
    after = float(res["bench"].step(toks, tgts)[0])
    before = res["losses"][0]
    other = ("" if beside is None else
             f" (O2 at 3e-4: {beside[0]:.4f} before, {beside[1]:.4f} after)")
    print(f"  ({'a' if opt_level == 'O2' else 'b'}) {opt_level} at the "
          f"example's default lr 3e-4: the first batch's loss {before:.4f} "
          f"before and {after:.4f} after 11 steps{other}; the steps' losses "
          f"{[round(x, 4) for x in res['losses']]}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return before, after


#: the O0 step (host clock, 3 steps on one batch, the first included) with
#: the fp32 backward pair on the first port's FMA kernels, and with the
#: register-blocked pair beside the first port's fp32 forward (#1 on
#: flash_fwd_kernel), on an H100 80GB HBM3 at 700 W (PERF.md), printed
#: beside this run's
O0_STEP_FMA_PAIR_MS = 966.5
O0_STEP_FMA_FWD_MS = 757.7


def pretrain_o0(torch, ops, dev):
    """(b): ``pretrain_gpt.build(opt_level="O0")`` at 345M (fp32 compute and
    weights, no masters, static scale 1) for 3 steps on the stream's first
    batch: launch counts, a falling loss. Returns the counts and the fp32
    routes' times."""
    import numpy as np

    from apex_tpu_torch.examples.gpt import pretrain_gpt

    torch.cuda.empty_cache()
    args = pretrain_gpt.parse_args(PRETRAIN_10 + ["--opt-level", "O0"])
    bench = pretrain_gpt.from_args(args)
    toks, tgts = next(pretrain_gpt.batches(args, bench.batch))
    L, steps = bench.cfg.num_layers, 3
    check(bench.model.layers[0].qkv.kernel.dtype == torch.float32
          and bench.opt_state.master is None, "O0: fp32 weights, no masters")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [float(bench.step(toks, tgts)[0]) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    counts = ops.launch_counts()
    per_step = pretrain_per_step(L, 2)
    print(f"  (b) pretrain_gpt 345M O0 (fp32): {steps} steps on one batch, "
          f"{wall:.1f} ms a step (host clock, the first step included; "
          f"{O0_STEP_FMA_FWD_MS} ms with the fp32 forward on the first "
          f"port's FMA kernel, {O0_STEP_FMA_PAIR_MS} ms with the backward "
          f"pair on it too), "
          f"losses {[round(x, 4) for x in losses]}, launches {counts}")
    check_counts(counts, expected_counts(counts, steps, per_step),
                 "gpt_pretrain_o0")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "O0: a finite falling loss")
    del bench
    torch.cuda.empty_cache()
    return counts


#: (f): the pretrain example at O0 (fp32) on one 8192-token sequence a step,
#: which routes attention to the streamed kernels (STREAM_MIN_SEQ): #2, #3
#: and #4 on their fp32 routes
PRETRAIN_O0_LONG = PRETRAIN_10 + ["--opt-level", "O0", "--seq", "8192",
                                    "--micro-batch", "1",
                                    "--num-microbatches", "1"]


def o0_long_steps(torch, ops, steps=3):
    """``pretrain_gpt`` at :data:`PRETRAIN_O0_LONG` through the port that
    ``ops`` belongs to: ``steps`` steps on the stream's first batch, each
    on the host clock to its loss, with the launches counted from 0.
    Returns (losses, ms of each step, counts, layers)."""
    import importlib

    pretrain_gpt = importlib.import_module(
        ops.__name__.rsplit(".", 1)[0] + ".examples.gpt.pretrain_gpt")
    torch.cuda.empty_cache()
    args = pretrain_gpt.parse_args(PRETRAIN_O0_LONG)
    bench = pretrain_gpt.from_args(args)
    toks, tgts = next(pretrain_gpt.batches(args, bench.batch))
    check(bench.model.layers[0].qkv.kernel.dtype == torch.float32
          and tuple(toks.shape) == (1, args.seq), "(f): fp32 weights, one "
          "sequence a step")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(bench.step(toks, tgts)[0]))
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    layers = bench.cfg.num_layers
    del bench, toks, tgts
    gc.collect()
    torch.cuda.empty_cache()
    return losses, ms, counts, layers


def pretrain_o0_long(torch, ops, dev):
    """(f): ``pretrain_gpt`` at O0 on one 8192-token sequence a step
    (:data:`PRETRAIN_O0_LONG`: fp32, remat full, learned positions) for 3
    steps on the stream's first batch: the exact launches (per step the
    streamed forward 2L, its dQ and dK/dV L each, the resident flash kernels
    0), a finite falling loss, and the median ms a step (another tree's:
    ``--o0-long-times``). Returns the counts."""
    import numpy as np

    losses, ms, counts, L = o0_long_steps(torch, ops)
    per_step = {"flash_attention_fwd_stream": 2 * L,
                "flash_attention_bwd_dq_stream": L,
                "flash_attention_bwd_dkv_stream": L,
                "layer_norm_fwd": 4 * L + 1, "layer_norm_bwd": 2 * L + 1}
    print(f"  (f) pretrain_gpt 345M O0 (fp32) at 1 x 8192 tokens: 3 steps on "
          f"one batch, {statistics.median(ms):.1f} ms a step (median; host "
          f"clock, each step {[round(x, 1) for x in ms]}), losses "
          f"{[round(x, 4) for x in losses]}, launches {counts}; "
          f"{nvidia_smi()}")
    check_counts(counts, expected_counts(counts, len(losses), per_step),
                 "gpt_pretrain_o0_long")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "(f) O0 at 8192 tokens: a finite falling loss")
    return counts


def o0_long_times(torch, ops, dev):
    """``python3 chip_smoke.py --o0-long-times TREE``: (f)'s steps through
    TREE's port, the ms of each and their median, to compare two trees in
    turns on one card."""
    losses, ms, _, _ = o0_long_steps(torch, ops)
    return {"o0_long_step_ms": statistics.median(ms), "steps_ms": ms,
            "losses": losses}


#: limits of the fp32 routes as a share of max |ref|: phase 2's fp32 limits
#: (the forward's o 5e-5, the backward's grads 1e-4, LayerNorm's y 1e-5, its
#: dgamma/dbeta 1e-4, held with dx)
FP32_TOL = {"flash_attention_fwd": 5e-5, "flash_attention_bwd_dq": 1e-4,
            "flash_attention_bwd_dkv": 1e-4, "layer_norm_fwd": 1e-5,
            "layer_norm_bwd": 1e-4}


def split_tf32_bound(nbytes, flops):
    """(bound_ms, bound_by) of fp32 work done as split TF32: three TF32
    products per fp32 product at 495 TFLOP/s, or the bytes."""
    return bound(nbytes, 3 * flops, "tfloat32")


#: profiles of one call taken at most by :func:`kernels_of` while CUPTI
#: hands back no device record
PROFILE_ATTEMPTS = 5


def kernels_of(torch, fn):
    """The device kernels of one call of ``fn`` under the profiler, after
    one call outside it (:func:`device_time_by_kernel`), and the top 3 by
    time as ``["name xN (ms)", ...]``, or "not captured".

    CUPTI now and then hands back no device record at all for one short
    profiled call (#10 fp32 at the verify shape, in one whole run on the
    H100). A profile with no device event is therefore taken again, up
    to :data:`PROFILE_ATTEMPTS` times; a profile that holds any kernel is
    taken as it is, so what the callers check of it is unchanged."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name = device_time_by_kernel(torch, prof)
        if by_name:
            break
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:3]
    return by_name, [f"{name[:120]} x{n} ({t / 1e3:.4f} ms)"
                     for name, (n, t) in top] or "not captured"


def rope_prefill_inputs(torch, dev, s):
    """generate_gpt's RoPE prefill operands at (1,16,s,64) fp32 from seed
    12: q and k contiguous (as the rotation leaves them), v a strided view
    of the QKV product (as the model hands it over)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    qkv = torch.randn(1, s, 16, 3, 64, device=dev,
                      generator=gen).permute(0, 2, 3, 1, 4)
    return qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous(), qkv[:, :, 2]


def fp32_kernels_by_name(torch, ops, dev):
    """The device kernels, by name, of one call of each fp32 attention that
    phase 10 times: SDPA's forward and backward (autograd.grad) at F =
    (4,16,1024,64) causal and its backward at L = (1,16,8192,64) causal;
    #3 fp32 and #4 fp32 at L (each held to launch its dq_f32_blocked /
    dkv_f32_blocked instance once and nothing else: no memset of its
    output, no cast); at RP = (1,16,317,64) window 256, #2 fp32 (held to
    launch fwd_f32_blocked once and no fwd_merge) and SDPA with the boolean
    band mask; #9 fp32 at the decode shape and #10 fp32 at the verify and
    chunk shapes (each held to launch its fp32 split-route kernel once and
    nothing else). Run in a fresh process
    (:func:`kernels_by_name_apart`): in the process that has run the
    phases the profiler captures nothing for some of these calls. Returned
    by the rows of the ``kernels`` line they go with."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for label, (b, s) in (("F", (4, 1024)), ("L", (1, 8192))):
        q, k, v, do = (torch.randn(b, 16, s, 64, device=dev, generator=gen)
                       for _ in range(4))
        if label == "F":
            _, out["SDPA fp32 forward at F"] = kernels_of(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True))
        if label == "L":
            o, lse = ops.flash_attention_fwd_stream(q, k, v, causal=True)
            delta = (o * do).sum(-1)
            kw = dict(causal=True, scale=0.125)
            for key, fn, kernel in (
                    ("#3 fp32 at L", ops.flash_attention_bwd_dq_stream,
                     "dq_f32_blocked"),
                    ("#4 fp32 at L", ops.flash_attention_bwd_dkv_stream,
                     "dkv_f32_blocked")):
                launched, out[key] = kernels_of(
                    torch, lambda: fn(q, k, v, do, lse, delta, **kw))
                check(len(launched) == 1
                      and kernel_time(launched, kernel)[0] == 1,
                      f"{key} launches {kernel} once and nothing else: "
                      f"{out[key]}")
            del o, lse, delta
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        _, out[f"SDPA fp32 backward at {label} "
               f"({type(o.grad_fn).__name__})"] = kernels_of(
            torch, lambda: torch.autograd.grad(o, (q, k, v), do,
                                               retain_graph=True))
        del q, k, v, do, o
        torch.cuda.empty_cache()
    q, k, v = rope_prefill_inputs(torch, dev, 317)
    launched, out["#2 fp32 at RP"] = kernels_of(
        torch, lambda: ops.flash_attention_fwd_stream(q, k, v, causal=True,
                                                      window=256))
    check(kernel_time(launched, "fwd_f32_blocked")[0] == 1
          and kernel_time(launched, "fwd_merge")[0] == 0,
          f"#2 fp32 at RP launches fwd_f32_blocked once and no merge: "
          f"{out['#2 fp32 at RP']}")
    i = torch.arange(317, device=dev)
    diff = i[:, None] - i[None, :]
    band = (diff >= 0) & (diff < 256)
    _, out["SDPA with the band mask at RP"] = kernels_of(
        torch, lambda: F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=band))
    del q, k, v, band
    # #9 fp32 at the decode shape, #10 fp32 at the verify and chunk shapes:
    # one launch of the fp32 split route's kernel each, nothing else (the
    # workspace grown and zeroed by the call outside the profiler)
    f32 = torch.float32
    qd, kpd, vpd, td, ld = _decode_inputs(torch, dev, gen, *DECODE_MAIN[:7],
                                          f32, DECODE_MAIN[7])
    decode_calls = {"#9 fp32 at the decode shape": (
        lambda: ops.flash_decode(qd, kpd, vpd, td, ld), "flash_decode_f32")}
    for label, (b, h, kh, kq, blk, d, nb, mb, lengths) in (
            ("verify", DECODE_VERIFY), ("chunk", DECODE_CHUNK)):
        _, kpm, vpm, tm, lm = _decode_inputs(torch, dev, gen, b, h, kh, blk,
                                             d, nb, mb, f32, lengths)
        qm = torch.randn(b, h, kq, d, device=dev, generator=gen)
        decode_calls[f"#10 fp32 at the {label} shape"] = (
            lambda a=(qm, kpm, vpm, tm, lm): ops.flash_decode_multi(*a),
            "decode_multi_f32")
    for key, (fn, kernel) in decode_calls.items():
        launched, out[key] = kernels_of(torch, fn)
        check(len(launched) == 1 and kernel_time(launched, kernel)[0] == 1,
              f"{key} launches {kernel} once and nothing else: {out[key]}")
    del qd, kpd, vpd, decode_calls
    print("  fp32 attention and decode kernels by name (one call under the "
          "profiler): " + "; ".join(f"{k}: {v}" for k, v in out.items()))
    torch.cuda.empty_cache()
    return {"flash_decode": {k: v for k, v in out.items()
                             if k.startswith("#9 ")},
            "flash_decode_multi": {k: v for k, v in out.items()
                                   if k.startswith("#10 ")},
            "flash_attention_fwd": {
                k: out[k] for k in ("SDPA fp32 forward at F",)},
            "flash_attention_fwd_stream": {
                k: out[k] for k in ("#2 fp32 at RP",
                                    "SDPA with the band mask at RP")},
            **{name: {k: v for k, v in out.items() if "backward" in k}
               for name in ("flash_attention_bwd_dq",
                            "flash_attention_bwd_dkv")},
            **{name: {k: v for k, v in out.items()
                      if "backward" in k or k.startswith(tag)}
               for name, tag in (("flash_attention_bwd_dq_stream", "#3"),
                                 ("flash_attention_bwd_dkv_stream", "#4"))}}


def kernels_by_name_apart():
    """:func:`fp32_kernels_by_name` in a child process (``python3
    chip_smoke.py --kernel-names``, the kernels this run built), its lines
    printed here; fails if the child does."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--kernel-names"], capture_output=True, text=True,
                       timeout=600, cwd=HERE)
    check(r.returncode == 0, f"--kernel-names exited {r.returncode}: "
          f"{r.stdout[-2000:]} {r.stderr[-4000:]}")
    *lines, last = r.stdout.strip().splitlines()
    for line in lines:
        print(line)
    return json.loads(last)


def kernel_names_main(fn=None):
    """``python3 chip_smoke.py --kernel-names``: :func:`fp32_kernels_by_name`
    on the card, its result as the last line (one JSON object); with
    ``fn`` (``--generate-profile``), ``fn`` alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from apex_tpu_torch import ops
    from apex_tpu_torch.csrc import build

    build.load()
    dev = torch.device("cuda", 0)
    if fn is not None:
        return fn(torch, ops, dev)
    print(json.dumps(fp32_kernels_by_name(torch, ops, dev)))
    return 0


def fp32_train_times(torch, ops, dev):
    """The fp32 routes of #1, #5, #6, #7 and #8 at the O0 pretrain's
    shapes (attention (4,16,1024,64), LayerNorm 4096 x 1024): each against
    its plain version (share of max |ref|, :data:`FP32_TOL`), then its time by
    CUDA-graph replay beside the bound (67 TFLOP/s fp32, 3.35 TB/s; for #5
    and #6 also the same work as split TF32, three products at 495
    TFLOP/s), the plain version and the library call (SDPA forward, SDPA's
    backward by autograd.grad with its backend by name, F.layer_norm,
    aten.native_layer_norm_backward)."""
    import torch.nn.functional as F

    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(10)
    b, h, s, d = 4, 16, 1024, 64
    q, k, v, do = (torch.randn(b, h, s, d, device=dev, generator=gen)
                   for _ in range(4))
    scale = d ** -0.5
    kw = dict(causal=True, scale=scale)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    ref_o = ops.mha_reference(q, k, v, causal=True)
    delta = (o * do).sum(-1)
    dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    rq, rk, rv = ops.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                   **kw)[:3]
    errs = {"flash_attention_fwd": rel_err(o, ref_o),
            "flash_attention_bwd_dq": rel_err(dq, rq),
            "flash_attention_bwd_dkv": max(rel_err(dk, rk), rel_err(dv, rv))}
    pairs = causal_pairs(s, s) * b * h
    elems = b * h * s * d
    times = {
        "flash_attention_fwd": dict(
            ms=time_ms(lambda: ops.flash_attention_fwd(q, k, v, causal=True)),
            plain_ms=time_ms(lambda: ops.mha_reference(q, k, v, causal=True),
                             2, 2),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)),
            bound=bound(4 * elems * 4 + b * h * s * 4, 4 * d * pairs,
                        "float32")),
        "flash_attention_bwd_dq": dict(
            ms=time_ms(lambda: ops.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, **kw)),
            bound=bound(5 * elems * 4 + 2 * b * h * s * 4, 6 * d * pairs,
                        "float32"),
            bound_tf32=split_tf32_bound(5 * elems * 4 + 2 * b * h * s * 4,
                                        6 * d * pairs)),
        "flash_attention_bwd_dkv": dict(
            ms=time_ms(lambda: ops.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, **kw)),
            bound=bound(6 * elems * 4 + 2 * b * h * s * 4, 8 * d * pairs,
                        "float32"),
            bound_tf32=split_tf32_bound(6 * elems * 4 + 2 * b * h * s * 4,
                                        8 * d * pairs))}
    plain_bwd = time_ms(lambda: ops.flash_attention_bwd_reference(
        q, k, v, o, lse, do, **kw), 2, 2)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    torch.cuda.synchronize()
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (ql, kl, vl), do, retain_graph=True), stream=side)
    backend = type(out.grad_fn).__name__
    # how near SDPA's own fp32 grads come to the plain backward, beside the
    # port's: context for the limits the port is held to, not a check
    lib_grads = torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True)
    near = "; ".join(
        f"{n}: SDPA {rel_err(g, r):.3g} of max |ref|, worst row "
        f"{row_err(g, r):.3g}; the port {rel_err(p, r):.3g}, {row_err(p, r):.3g}"
        for n, g, p, r in zip(("dQ", "dK", "dV"), lib_grads, (dq, dk, dv),
                              (rq, rk, rv)))
    print(f"  (b) fp32 grads at F against the plain backward: {near}")
    del lib_grads
    # how near SDPA's fp32 o comes to the plain version beside the port's:
    # context for a split-TF32 forward, not a check (its kernels by name:
    # fp32_kernels_by_name, phase 2)
    lib_o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    times["flash_attention_fwd"].update(
        library={"call": "F.scaled_dot_product_attention(is_causal=True)"},
        library_err={"share": rel_err(lib_o, ref_o),
                     "row": row_err(lib_o, ref_o)},
        row_err=row_err(o, ref_o))
    t1 = times["flash_attention_fwd"]
    print(f"  (b) fp32 forward at F (4,16,1024,64) causal: the port "
          f"{t1['ms']:.4f} ms ({4 * d * pairs / t1['ms'] / 1e9:.1f} "
          f"TFLOP/s), bound {t1['bound'][0]:.4f} ms ({t1['bound'][1]}), "
          f"plain {t1['plain_ms']:.4f} ms, SDPA {t1['library_ms']:.4f} ms; "
          f"o against the plain version: SDPA "
          f"{t1['library_err']['share']:.3g} of max |ref|, worst row "
          f"{t1['library_err']['row']:.3g}; the port {errs['flash_attention_fwd']:.3g}, "
          f"{t1['row_err']:.3g}")
    del lib_o
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        times[name].update(plain_ms=plain_bwd, library_ms=lib_bwd,
                           library={"grad_fn": backend})
    pair = (times["flash_attention_bwd_dq"]["ms"]
            + times["flash_attention_bwd_dkv"]["ms"])
    print(f"  (b) the fp32 backward pair at F (4,16,1024,64) causal: dQ "
          f"{times['flash_attention_bwd_dq']['ms']:.4f} + dK/dV "
          f"{times['flash_attention_bwd_dkv']['ms']:.4f} = {pair:.4f} ms "
          f"against SDPA's fp32 backward (dQ, dK, dV) {lib_bwd:.4f} ms "
          f"(autograd.grad through {backend}); bounds dQ "
          f"{times['flash_attention_bwd_dq']['bound'][0]:.4f} ms as FMA at "
          f"67 TFLOP/s, "
          f"{times['flash_attention_bwd_dq']['bound_tf32'][0]:.4f} ms as "
          f"split TF32 (three products at 495); dK/dV "
          f"{times['flash_attention_bwd_dkv']['bound'][0]:.4f} / "
          f"{times['flash_attention_bwd_dkv']['bound_tf32'][0]:.4f} ms")
    del q, k, v, do, o, lse, ref_o, dq, dk, dv, rq, rk, rv, out, ql, kl, vl
    torch.cuda.empty_cache()

    rows, hidden = 4096, 1024
    x = torch.randn(rows, hidden, device=dev, generator=gen) * 3 + 1
    g = torch.randn(rows, hidden, device=dev, generator=gen)
    w = torch.randn(hidden, device=dev, generator=gen)
    bb = torch.randn(hidden, device=dev, generator=gen)
    y, mean, rstd = ops.layer_norm_fwd(x, w, bb)
    ry = ops.layer_norm_reference(x, w, bb)
    lkw = dict(rms=False, has_bias=True)
    dx, dw, db = ops.layer_norm_bwd(g, x, mean, rstd, w, **lkw)
    rdx, rdw, rdb = ops.layer_norm_bwd_reference(g, x, mean, rstd, w, **lkw)
    errs["layer_norm_fwd"] = rel_err(y, ry)
    errs["layer_norm_bwd"] = max(rel_err(dx, rdx), rel_err(dw, rdw),
                                 rel_err(db, rdb))
    _, amean, arstd = torch.native_layer_norm(x, (hidden,), w, bb, 1e-5)
    n = rows * hidden
    times["layer_norm_fwd"] = dict(
        ms=time_ms(lambda: ops.layer_norm(x, w, bb)),
        plain_ms=time_ms(lambda: ops.layer_norm_reference(x, w, bb), 5),
        library_ms=time_ms(lambda: F.layer_norm(x, (hidden,), w, bb, 1e-5)),
        bound=bound(2 * n * 4 + hidden * 8 + rows * 8, n * 8, "float32"))
    times["layer_norm_bwd"] = dict(
        ms=time_ms(lambda: ops.layer_norm_bwd(g, x, mean, rstd, w, **lkw)),
        plain_ms=time_ms(lambda: ops.layer_norm_bwd_reference(
            g, x, mean, rstd, w, **lkw), 5),
        library_ms=time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            g, x, [hidden], amean, arstd, w, bb, [True, True, True])),
        bound=bound(3 * n * 4 + rows * 8 + hidden * 4 * 3, n * 13,
                    "float32"))
    for name, t in times.items():
        t["bound_ms"], t["bound_by"] = t.pop("bound")
        if "bound_tf32" in t:
            t["bound_tf32_ms"] = t.pop("bound_tf32")[0]
        t["max_rel_err"] = errs[name]
        print(f"  (b) {name} fp32 route at the O0 pretrain shape: share of "
              f"max |ref| {errs[name]:.3g} (tol {FP32_TOL[name]:g}); kernel "
              f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms, library "
              f"{t['library_ms']:.4f} ms")
        verdict(f"{name} fp32 at the O0 pretrain shape", errs[name],
                FP32_TOL[name], group="gpt examples: fp32 routes")
    print(f"  (b) fp32 timings: {nvidia_smi()}")
    return times


def fp32_stream_bwd_times(torch, ops, dev):
    """The fp32 routes of #3 and #4 (dq_f32_blocked / dkv_f32_blocked over
    whole bands) at L32 = (1,16,8192,64) causal and W32 =
    (1,16,16384,64) causal, window 4096: against their plain versions at
    phase 2's streamed fp32 limits (1e-5 of max |ref|, :data:`ROW_TOL` by
    row, which a halved tail of dQ rows and of dK rows must fail), two
    calls bit-identical, then their times by CUDA-graph replay beside the
    bounds (67 TFLOP/s fp32, 3.35 TB/s), the plain versions and SDPA's fp32
    backward (dQ, dK, dV by ``autograd.grad``; under the window with the
    boolean band mask). Returns ``{kernel: {"fp32 L32": timing,
    "fp32 W32": timing}}``."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(13)
    b, h, d = 1, 16, 64
    times = {"flash_attention_bwd_dq_stream": {},
             "flash_attention_bwd_dkv_stream": {}}
    grp = "flash_attention_stream float32"
    for label, s, window in (("L32", 8192, None), ("W32", 16384, 4096)):
        q, k, v, do = (torch.randn(b, h, s, d, device=dev, generator=gen)
                       for _ in range(4))
        kw = dict(causal=True, scale=d ** -0.5, window=window)
        o, lse = ops.flash_attention_fwd_stream(q, k, v, causal=True,
                                                window=window)
        delta = (o * do).sum(-1)
        del o
        calls = {"flash_attention_bwd_dq_stream": (
            lambda: (ops.flash_attention_bwd_dq_stream(
                q, k, v, do, lse, delta, **kw),),
            lambda: (ops.flash_attention_bwd_dq_stream_reference(
                q, k, v, do, lse, delta, **kw),)),
            "flash_attention_bwd_dkv_stream": (
                lambda: ops.flash_attention_bwd_dkv_stream(
                    q, k, v, do, lse, delta, **kw),
                lambda: ops.flash_attention_bwd_dkv_stream_reference(
                    q, k, v, do, lse, delta, **kw))}
        _, qb, kb, pairs = stream_bounds(b, h, s, s, d, True, window,
                                         "float32")
        bounds = {"flash_attention_bwd_dq_stream": qb,
                  "flash_attention_bwd_dkv_stream": kb}
        if window is None:
            sdpa_kw = dict(is_causal=True)
        else:
            i = torch.arange(s, device=dev, dtype=torch.int32)
            diff = i[:, None] - i[None, :]
            sdpa_kw = dict(attn_mask=(diff >= 0) & (diff < window))
            del i, diff
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = F.scaled_dot_product_attention(ql, kl, vl, **sdpa_kw)
        torch.cuda.synchronize()
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl), do, retain_graph=True), 3, 2, stream=side)
        backend = type(out.grad_fn).__name__
        del out, ql, kl, vl, sdpa_kw
        for name, (fn, plain) in calls.items():
            got, ref = fn(), plain()
            again = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(a, r) for a, r in zip(got, again))
            verdict(f"{name} fp32 at {label} deterministic", 0 if same else 1,
                    0, group=grp)
            err = max(rel_err(a, r) for a, r in zip(got, ref))
            e_row = max(row_err(a, r) for a, r in zip(got, ref))
            verdict(f"{name} fp32 at {label}", err, 1e-5, group=grp)
            verdict(f"{name} fp32 at {label} row", e_row, ROW_TOL[False][1],
                    group=grp)
            # a tail of dQ rows (of dK rows) halved must fail the row check
            bad = got[0].clone()
            bad[:, :, s // 2:] *= 0.5
            planted = row_err(bad, ref[0])
            verdict(f"{name} fp32 at {label}: a halved "
                    f"{'dQ' if 'dq' in name else 'dK'} tail caught by the "
                    f"row check", 0 if planted > ROW_TOL[False][1] else 1, 0,
                    group=grp)
            del got, ref, again, bad
            bms, by = bounds[name]
            t = times[name][f"fp32 {label}"] = dict(
                ms=time_ms(fn, 3, 2), plain_ms=time_ms(plain, 1, 2),
                library_ms=lib_bwd, library={"grad_fn": backend},
                bound_ms=bms, bound_by=by, max_rel_err=err, row_err=e_row)
            flops = (6 if "dq" in name else 8) * d * pairs
            print(f"  {name} fp32 route at {label} (1,16,{s},64) causal"
                  + (f" window {window}" if window else "")
                  + f": share of max |ref| {err:.3g} (tol 1e-05), worst row "
                  f"{e_row:.3g} (tol {ROW_TOL[False][1]:g}), halved tail "
                  f"row {planted:.3g}, a second call bit-identical {same}; "
                  f"kernel {t['ms']:.4f} ms ({flops / t['ms'] / 1e9:.1f} "
                  f"TFLOP/s), bound {bms:.4f} ms ({by}), plain "
                  f"{t['plain_ms']:.4f} ms, SDPA's fp32 backward (dQ+dK+dV"
                  + (", the boolean band mask" if window else "")
                  + f") {lib_bwd:.4f} ms (autograd.grad through {backend}); "
                  f"{nvidia_smi()}")
        del calls, q, k, v, do, lse, delta
    torch.cuda.empty_cache()
    return times


def state_bytes(bench, *extra):
    """Bytes of a pretrain trainer's params, masters and Adam moments (and
    of ``extra`` tensors)."""
    st = bench.opt_state
    ts = list(bench.model.parameters()) + (st.master or []) \
        + list(st.inner.exp_avg) + list(st.inner.exp_avg_sq) + list(extra)
    return sum(t.numel() * t.element_size() for t in ts)


def remat_policies(torch, ops, dev, a_peak):
    """(c): ``pretrain_gpt.build`` at 345M, O2, under remat_policy full,
    save_attn and dots, each from the same seed on one fixed batch: the
    first step's loss and every grad against full's (bit-identical
    expected; held to a bf16 unit of the grad's max otherwise), three
    steps' losses, the exact launches (#1 L*M a step under save_attn, 2L*M
    under the others), the step time and peak memory. Each policy starts
    from a clean card: before its steps the card must hold its trainer's
    params, masters, Adam moments and batch alone (within 16 MiB); full's
    grads wait on the host; the peaks (of the three steps, and of the
    first step's micro-batches before its optimizer step) are read above
    what the card held before the trainer was built, as (a)'s
    (``a_peak``)."""
    from apex_tpu_torch.examples.gpt import pretrain_gpt

    args = pretrain_gpt.parse_args(PRETRAIN_10)
    full = None
    counts_by = {}
    for policy in ("full", "save_attn", "dots"):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        bench = pretrain_gpt.from_args(args, policy)
        toks, tgts = next(pretrain_gpt.batches(args, bench.batch))
        toks, tgts = toks.to(dev), tgts.to(dev)
        L = bench.cfg.num_layers
        # what one micro-batch's forward leaves for its backward
        mb = bench.batch // 2
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        probe = bench.model.loss(toks[:mb], tgts[:mb])
        held = (torch.cuda.memory_allocated(dev) - held) / 2 ** 30
        probe.backward()
        del probe
        for p in bench.model.parameters():
            p.grad = None
        gc.collect()
        torch.cuda.synchronize()
        state = state_bytes(bench, toks, tgts)
        extra = torch.cuda.memory_allocated(dev) - base - state
        check(abs(extra) <= 16 * 2 ** 20, f"(c) {policy}: before its steps "
              f"the card holds the trainer's state alone ({extra} bytes "
              f"besides)")
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        loss = pretrain_gpt.microbatched_backward(bench, toks, tgts, 2)
        bwd_peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        grads = [p.grad.to("cpu") for p in bench.model.parameters()]
        bench.mp_opt.step(bench.opt_state, bench.model)
        losses = [float(loss)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            losses.append(float(bench.step(toks, tgts)[0]))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 2
        counts = ops.launch_counts()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        check_counts(counts, expected_counts(
            counts, 3, pretrain_per_step(L, 2, policy)),
            f"gpt_remat_{policy}")
        counts_by[f"gpt_remat_{policy}"] = counts
        if full is None:
            full = (losses, grads)
            err, same = 0.0, True
            print(f"  (c) remat full: peak {peak:.2f} GiB against (a)'s "
                  f"{a_peak:.2f} GiB (the same trainer and step; (a) also "
                  f"builds, saves and restores)")
        else:
            same = losses == full[0] and all(
                torch.equal(a, b) for a, b in zip(grads, full[1]))
            err = max(max_err(a, b) / max(float(b.float().abs().max()),
                                          1e-30)
                      for a, b in zip(grads, full[1]))
            err = max(err, max(abs(x - y) / abs(y)
                               for x, y in zip(losses, full[0])))
            verdict(f"remat {policy}: loss and grads against full's "
                    f"(bit-identical: {same})", err, 2 ** -7,
                    group="gpt examples: remat policies")
        print(f"  (c) remat {policy}: losses {losses} (bit-identical to "
              f"full's: {same}, worst share {err:.3g}), "
              f"{counts['flash_attention_fwd']} launches of #1 in 3 steps, "
              f"{ms:.2f} ms a step (host clock, steps 2-3), state "
              f"{state / 2 ** 30:.2f} GiB, peak {peak:.2f} GiB "
              f"({peak - state / 2 ** 30:.2f} over the state), of the "
              f"first step's forwards and backwards {bwd_peak:.2f} GiB "
              f"({bwd_peak - state / 2 ** 30:.2f}); one micro-batch's "
              f"forward holds {held:.3f} GiB for its backward")
        del bench, grads, toks, tgts
    del full
    gc.collect()
    torch.cuda.empty_cache()
    return counts_by


def generate_run(torch, ops, argv, label):
    """One ``generate_gpt.run`` with the launches counted from 0 around it;
    every token checked by :func:`check_greedy`. Returns (run, counts)."""
    from apex_tpu_torch.examples.gpt import generate_gpt

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = generate_gpt.run(argv)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    eng, res = out["engine"], out["results"]
    m = latency(res, out["wall_s"])
    print(f"  {label}: {len(res)} requests, {m['tokens']} tokens in "
          f"{out['wall_s']:.3f} s = {m['tokens_s']:.1f} tokens/s, TTFT p50 "
          f"{m['ttft_ms']:.2f} ms, ITL p50 {m['itl_ms']:.2f} ms; prefills "
          f"{eng.prefills}, chunks {eng.chunks}, decode ticks "
          f"{eng.decode_steps}, spec ticks {eng.spec_ticks}; launches "
          f"{counts}")
    check(len(res) == 6 and all(len(r.tokens) == 32 for r in res.values()),
          f"{label}: every request got its 32 tokens")
    check(eng.allocator.used == 0, f"{label}: every page freed")
    out["latency"] = m
    return out, counts


def serve_expected(counts, eng, L, n_req, stream=False):
    """The launch counts of a serve: monolithic prefills through the flash
    forward (the streamed one under a window) and decode ticks through #9;
    chunks through #10, and with speculation (a self-draft: Ld = L) the
    draft's chunks, K = spec_k + 1 draft decode steps and one K-query verify
    a tick (phase 3's arithmetic)."""
    p, c, t = eng.prefills, eng.chunks, eng.decode_steps
    out = dict.fromkeys(counts, 0)
    fwd = "flash_attention_fwd_stream" if stream else "flash_attention_fwd"
    out[fwd] = L * p
    if eng.config.spec_k:
        K, st = eng.config.spec_k + 1, eng.spec_ticks
        out["flash_decode_multi"] = 2 * L * c + L * st
        out["flash_decode"] = L * K * st
        out["layer_norm_fwd"] = (4 * L * c + n_req
                                 + ((2 * L + 1) * K + 2 * L + 1) * st)
    else:
        out["flash_decode_multi"] = L * c
        out["flash_decode"] = L * t
        out["layer_norm_fwd"] = ((2 * L + 1) * (p + t) + 2 * L * c
                                 + (n_req if c else 0))
    return out


def generate_checkpoint(torch, ops, dev, ckpt_dir):
    """(d): ``generate_gpt`` at 345M (fp32 compute) from (a)'s checkpoint:
    plain, ``--prefix-cache --shared-prefix 500 --spec-k 4`` and
    ``--prefill-chunk 256``. Every token against the full-context argmax
    (:func:`check_greedy`), the speculative run's also against the plain
    run's, with exact launch counts."""
    argv = GENERATE_10 + ["--load-dir", ckpt_dir]
    counts_by = {}
    plain, counts = generate_run(torch, ops, argv, "(d) generate 345M fp32")
    L = plain["model"].cfg.num_layers
    check(plain["model"].layers[0].qkv.kernel.dtype == torch.float32,
          "generate: fp32 weights")
    check_counts(counts, serve_expected(counts, plain["engine"], L, 6),
                 "gpt_generate")
    n = check_greedy(torch, plain["model"], plain["results"], "generate")
    counts_by["gpt_generate"] = counts
    print(f"  (d) generate: {n} tokens equal the full-context argmax")
    del plain
    torch.cuda.empty_cache()
    spec, counts = generate_run(
        torch, ops, argv + ["--prefix-cache", "--shared-prefix", "500",
                            "--spec-k", "4"],
        "(d) generate 345M fp32, prefix cache + speculative")
    eng = spec["engine"]
    check_counts(counts, serve_expected(counts, eng, L, 6),
                 "gpt_generate_prefix_spec")
    st = eng.stats
    check(eng.prefills == 0 and eng.decode_steps == 0,
          "generate: every prefill chunked, every tick speculative")
    check(st["prefix_hits"] == 5 and st["mean_accepted_len"] > 1,
          "generate: 5 prefix hits and accepted drafts")
    n = check_greedy(torch, spec["model"], spec["results"],
                     "generate prefix+spec")
    counts_by["gpt_generate_prefix_spec"] = counts
    print(f"  (d) generate prefix + speculative: stats {st}; {n} tokens "
          f"equal the full-context argmax")
    del spec
    torch.cuda.empty_cache()
    chunked, counts = generate_run(
        torch, ops, argv + ["--prefill-chunk", "256"],
        "(d) generate 345M fp32, 256-token prefill chunks")
    check_counts(counts, serve_expected(counts, chunked["engine"], L, 6),
                 "gpt_generate_chunked")
    n = check_greedy(torch, chunked["model"], chunked["results"],
                     "generate chunked")
    counts_by["gpt_generate_chunked"] = counts
    print(f"  (d) generate chunked: {n} tokens equal the full-context argmax")
    del chunked
    torch.cuda.empty_cache()
    return counts_by


def generate_rope(torch, ops, dev):
    """(e): ``generate_gpt --pos rope --window 256`` at 345M with random
    weights, prompts behind a 300-token shared prefix so every stream runs
    past the window: monolithic (the prefill on the streamed forward, the
    window on #9) and with 128-token chunks and speculation (#10 with the
    window), each token against the full-context argmax, the second's also
    against the first's."""
    argv = GENERATE_10 + ["--pos", "rope", "--window", "256",
                          "--shared-prefix", "300"]
    counts_by = {}
    mono, counts = generate_run(torch, ops, argv,
                                "(e) generate 345M rope window 256")
    L = mono["model"].cfg.num_layers
    check(mono["model"].position is None, "rope: no position table")
    check(min(len(r.prompt) for r in mono["results"].values()) > 256,
          "rope: every prompt past the window")
    check_counts(counts, serve_expected(counts, mono["engine"], L, 6, True),
                 "gpt_generate_rope")
    n = check_greedy(torch, mono["model"], mono["results"], "rope")
    counts_by["gpt_generate_rope"] = counts
    print(f"  (e) rope + window: {n} tokens equal the full-context argmax; "
          f"#9 launched {counts['flash_decode']} times with the window")
    spec, counts = generate_run(
        torch, ops, argv + ["--prefill-chunk", "128", "--spec-k", "4"],
        "(e) generate 345M rope window 256, chunks + speculative")
    check_counts(counts, serve_expected(counts, spec["engine"], L, 6),
                 "gpt_generate_rope_spec")
    n = check_greedy(torch, spec["model"], spec["results"], "rope spec",
                     ref=mono["results"])
    counts_by["gpt_generate_rope_spec"] = counts
    print(f"  (e) rope + window, chunks + speculative: {n} tokens equal the "
          f"full-context argmax and the monolithic run's; #10 launched "
          f"{counts['flash_decode_multi']} times with the window")
    longest = max(len(r.prompt) for r in mono["results"].values())
    del mono, spec
    torch.cuda.empty_cache()
    return counts_by, longest


#: (e)'s chunked speculative run (gRS): RoPE, window 256, 128-token chunks,
#: spec_k 4, random weights
GENERATE_ROPE_SPEC = GENERATE_10 + ["--pos", "rope", "--window", "256",
                                    "--shared-prefix", "300",
                                    "--prefill-chunk", "128",
                                    "--spec-k", "4"]


def generate_profile(torch, ops, dev):
    """``python3 chip_smoke.py --generate-profile``: (e)'s fp32 generate
    with chunks and speculation (:data:`GENERATE_ROPE_SPEC`) once, then
    its requests again on the same engine under the profiler
    (:func:`device_busy`): the device's busy share of an fp32 generate
    window and the decode kernels' ms a tick, measured."""
    from apex_tpu_torch.serve import Request

    out, _ = generate_run(torch, ops, GENERATE_ROPE_SPEC,
                          "(e) generate 345M rope window 256, chunks + "
                          "speculative (before the profiled window)")
    reqs = [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                    request_id=f"w{r.request_id}") for r in out["requests"]]
    device_busy(torch, out["engine"], reqs,
                "(e) generate 345M fp32 rope window 256, chunks + "
                "speculative, the same 6 requests again")
    return 0


def generate_profile_apart():
    """:func:`generate_profile` in a child process (``python3 chip_smoke.py
    --generate-profile``): late in this process the profiler captures no
    kernels (PERF.md); its lines printed here, the per-request lines of
    the example left out. Fails if the child does."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--generate-profile"], capture_output=True,
                       text=True, timeout=600, cwd=HERE)
    check(r.returncode == 0, f"--generate-profile exited {r.returncode}: "
          f"{r.stdout[-2000:]} {r.stderr[-4000:]}")
    for line in r.stdout.splitlines():
        if line.startswith(("  (", "    ")) and not line.startswith(
                "  tokens:"):
            print(line)


def fp32_rope_prefill_times(torch, ops, dev, s, window=256):
    """#2's fp32 route at (e)'s longest monolithic prefill, (1,16,s,64)
    causal with the window: q and k contiguous (as the rotation leaves
    them), v a strided view of the QKV product (as the model hands it
    over). Against its plain version at phase 2's fp32 limits (o 1e-5 of
    max |ref|, its worst row 1e-5, lse 1e-4 of max(1, max |lse|)), then its
    time by CUDA-graph replay beside the bound (67 TFLOP/s fp32, 3.35
    TB/s), the plain version and SDPA with the boolean band mask (the
    kernels of both by name: fp32_kernels_by_name, phase 2)."""
    import importlib

    import torch.nn.functional as F

    b, h, d = 1, 16, 64
    q, k, v = rope_prefill_inputs(torch, dev, s)
    kw = dict(causal=True, window=window)
    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    _, nsplit = tfa._fwd_bands(s, s, True, window, tfa._fwd_tiles(False, d))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    o, lse = ops.flash_attention_fwd_stream(q, k, v, **kw)
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base - o.numel() * 4
             - lse.numel() * 4)
    # a band of one split: one launch, written by the split pass with no
    # fp32 workspace (which would hold b h s d floats a split) and no merge
    check(nsplit == 1 and extra < b * h * s * d * 4,
          f"#2 fp32 at the rope prefill: {nsplit} splits a band, {extra} "
          f"bytes beside o and lse")
    ro, rlse = ops.flash_attention_fwd_stream_reference(q, k, v, **kw)
    err, e_row = rel_err(o, ro), row_err(o, ro)
    e_lse = max_err(lse, rlse) / max(1.0, float(rlse.abs().max()))
    check(o.dtype == torch.float32 and o.shape == q.shape,
          "#2 fp32 at the rope prefill: o dtype and shape")
    grp = "gpt examples: fp32 routes"
    label = f"fp32 rope prefill ({b},{h},{s},{d}) window {window}"
    verdict(f"flash_attention_fwd_stream {label} o", err, 1e-5, group=grp)
    verdict(f"flash_attention_fwd_stream {label} o row", e_row,
            ROW_TOL[False][0], group=grp)
    verdict(f"flash_attention_fwd_stream {label} lse", e_lse, 1e-4,
            group=grp)
    i = torch.arange(s, device=dev)
    diff = i[:, None] - i[None, :]
    band = (diff >= 0) & (diff < window)
    (bms, by), _, _, pairs = stream_bounds(b, h, s, s, d, True, window,
                                           "float32")
    t = dict(
        ms=time_ms(lambda: ops.flash_attention_fwd_stream(q, k, v, **kw)),
        plain_ms=time_ms(lambda: ops.flash_attention_fwd_stream_reference(
            q, k, v, **kw), 5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=band)),
        bound_ms=bms, bound_by=by, max_rel_err=err, workspace_bytes=extra)
    print(f"  (e) flash_attention_fwd_stream {label}, {pairs} visible "
          f"pairs: share of max |ref| {err:.3g} (tol 1e-05), worst row "
          f"{e_row:.3g} (tol {ROW_TOL[False][0]:g}), lse {e_lse:.3g} (tol "
          f"1e-04); {nsplit} split a band, {extra} bytes beside o and lse; "
          f"kernel {t['ms']:.4f} ms, bound {bms:.4f} ms ({by}), plain "
          f"{t['plain_ms']:.4f} ms, SDPA with the band mask "
          f"{t['library_ms']:.4f} ms; {nvidia_smi()}")
    del q, k, v, o, lse, ro, rlse, band
    torch.cuda.empty_cache()
    return {"flash_attention_fwd_stream": {label: t}}


def fp32_decode_times(torch, ops, dev):
    """The fp32 routes of #9 and #10 at phase 2's decode shape (and with
    window 128, and at b = 1 over 8192 keys), chunk and verify shapes (the
    generate example's pools, 16 heads of 64, 16-token pages), beside the
    bf16 rows: each against its plain version (share of max |ref|, 5e-5:
    phase 2's fp32 decode limit), its time, the plain version's and the
    bound."""
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {"flash_decode": {}}
    b, h, kh, blk, d, nb, mb, lengths = DECODE_MAIN
    q, kp, vp, tables, lens = _decode_inputs(
        torch, dev, gen, b, h, kh, blk, d, nb, mb, f32, lengths)
    b1, h1, kh1, blk1, d1, nb1, mb1, lengths1 = DECODE_LONG
    long_in = _decode_inputs(torch, dev, gen, b1, h1, kh1, blk1, d1, nb1,
                             mb1, f32, lengths1)
    for label, (qq, kk, vv, tt, ll), window, (bb, hh, kkh, dd, mbb, lst) in (
            ("fp32 decode", (q, kp, vp, tables, lens), None,
             (b, h, kh, d, mb, lengths)),
            ("fp32 window_128", (q, kp, vp, tables, lens), 128,
             (b, h, kh, d, mb, lengths)),
            ("fp32 b1_8192", long_in, None,
             (b1, h1, kh1, d1, mb1, lengths1))):
        err = rel_err(ops.flash_decode(qq, kk, vv, tt, ll, window=window),
                      ops.paged_attention_reference(qq, kk, vv, tt, ll,
                                                    window=window))
        live = sum(min(n, window or n) for n in lst)
        bms, by = bound(live * kkh * dd * 4 * 2 + 2 * bb * hh * dd * 4
                        + bb * mbb * 4 + bb * 4, 4 * hh * dd * live,
                        "float32")
        out["flash_decode"][label] = dict(
            ms=time_ms(lambda: ops.flash_decode(qq, kk, vv, tt, ll,
                                                window=window)),
            plain_ms=time_ms(lambda: ops.paged_attention_reference(
                qq, kk, vv, tt, ll, window=window), 5),
            bound_ms=bms, bound_by=by, max_rel_err=err)
        verdict(f"flash_decode fp32 at the {label[5:]} shape", err, 5e-5,
                group="gpt examples: fp32 routes")
    del long_in
    out["flash_decode_multi"] = {}
    for label, shape in (("fp32 chunk", DECODE_CHUNK),
                         ("fp32 verify", DECODE_VERIFY)):
        b, h, kh, kq, blk, d, nb, mb, lengths = shape
        _, kp, vp, tables, lens = _decode_inputs(
            torch, dev, gen, b, h, kh, blk, d, nb, mb, f32, lengths)
        q = torch.randn(b, h, kq, d, device=dev, generator=gen)
        err = rel_err(ops.flash_decode_multi(q, kp, vp, tables, lens),
                      ops.paged_attention_multi_reference(q, kp, vp, tables,
                                                          lens))
        bms, by = multi_bound(b, h, kh, kq, d, 4, lengths, None, blk, mb,
                              "float32")
        out["flash_decode_multi"][label] = dict(
            ms=time_ms(lambda: ops.flash_decode_multi(q, kp, vp, tables,
                                                      lens)),
            plain_ms=time_ms(lambda: ops.paged_attention_multi_reference(
                q, kp, vp, tables, lens), 5),
            bound_ms=bms, bound_by=by, max_rel_err=err)
        verdict(f"flash_decode_multi fp32 at the {label[5:]} shape", err,
                5e-5, group="gpt examples: fp32 routes")
    for name, by_label in out.items():
        for label, t in by_label.items():
            print(f"  (d) {name} {label}: share of max |ref| "
                  f"{t['max_rel_err']:.3g} (tol 5e-05); kernel "
                  f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms; no "
                  f"single PyTorch call attends a paged pool")
    torch.cuda.empty_cache()
    return out


def gpt_examples(torch, ops, dev):
    """Phase 10: (a) pretrain, save, resume; (b) O0 and the fp32 training
    routes; (c) the remat policies; (d) generate from the checkpoint, fp32,
    three ways, and the fp32 decode routes; (e) RoPE + window serving and
    the streamed forward's fp32 route at its prefill; (f) O0 at 8192
    tokens, the streamed kernels' fp32 routes on a main path. The
    checkpoint lives in a directory under the build directory, removed at
    the end. Returns the launch counts by path and the fp32 times by
    kernel (``{kernel: {label: timing}}``)."""
    import shutil
    import tempfile

    from apex_tpu_torch.csrc import build

    t0 = time.perf_counter()
    parts = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = round(time.perf_counter() - t, 1)
        return out

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="gpt_ckpt-", dir=build.BUILD_DIR)
    try:
        counts, a_peak = part("pretrain_save_resume", pretrain_save_resume,
                              torch, ops, dev, ckpt)
        by_path = {"gpt_pretrain": counts}
        o2_lr = part("default_lr O2", pretrain_default_lr, torch, dev)
        by_path["gpt_pretrain_o0"] = part("pretrain_o0", pretrain_o0, torch,
                                          ops, dev)
        part("default_lr O0", pretrain_default_lr, torch, dev, "O0", o2_lr)
        fp32 = {k: {"fp32 O0 pretrain": v} for k, v in part(
            "fp32_train_times", fp32_train_times, torch, ops, dev).items()}
        fp32.update(part("fp32_stream_bwd_times", fp32_stream_bwd_times,
                         torch, ops, dev))
        by_path.update(part("remat_policies", remat_policies, torch, ops,
                            dev, a_peak))
        by_path.update(part("generate_checkpoint", generate_checkpoint,
                            torch, ops, dev, ckpt))
        fp32.update(part("fp32_decode_times", fp32_decode_times, torch, ops,
                         dev))
        rope_counts, longest = part("generate_rope", generate_rope, torch,
                                    ops, dev)
        by_path.update(rope_counts)
        part("generate_profile_apart", generate_profile_apart)
        fp32.update(part("fp32_rope_prefill_times", fp32_rope_prefill_times,
                         torch, ops, dev, longest))
        by_path["gpt_pretrain_o0_long"] = part(
            "pretrain_o0_long", pretrain_o0_long, torch, ops, dev)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"  phase 10 parts (s): {json.dumps(parts)}")
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s")
    return by_path, fp32


# ---------------------------------------------------------------------------
# phase 11: the root bench.py harness (python -m apex_tpu_torch.bench), the
# DCGAN example and the native host runtime
# ---------------------------------------------------------------------------

#: steps per timed window of the bench run (its default, BENCH_STEPS)
BENCH_STEPS = 10
#: the kernels the bench's path does not run: the paged decode pair serves
DECODE_ONLY = ("flash_decode", "flash_decode_multi")


def bench_harness(torch, ops, dev):
    """Phase 11: ``python -m apex_tpu_torch.bench`` once in a child process
    at its defaults (windows of 10 steps, 3 windows, GPT batch 8 x 1024,
    ResNet-50 64 x 224², BERT-large 8 x 512): the line must hold ``value``
    and ``vs_baseline`` from interleaved windows, both rungs, the canary,
    the optimizer ratio and ``selftest.all_ok``, and no ``errors``; its
    figures and each selftest entry (a verdict against its ``tol_norm``)
    are printed, and every kernel but the decode pair must have launched
    in it. Then the DCGAN example for 10 steps on the card (finite losses,
    bf16 params, both scalers clean, no kernel of csrc/ launched) and the
    native runtime (``csrc.available()``, a flatten round trip). Returns
    the bench's launch counts by kernel."""
    import numpy as np

    from apex_tpu_torch import bench, csrc
    from apex_tpu_torch.examples.dcgan import main_amp as dcgan

    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if k not in bench.MONITOR_VARS and not k.startswith("BENCH_")}
    env["PYTHONPATH"] = HERE + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["BENCH_STEPS"] = str(BENCH_STEPS)
    out = subprocess.run([sys.executable, "-m", "apex_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=900,
                         env=env, cwd=HERE)
    dt = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    check(out.returncode == 0 and lines,
          f"bench exited {out.returncode}: {out.stderr[-3000:]}")
    rec = json.loads(lines[-1])
    for line in out.stderr.splitlines():
        if line.startswith(("O0 leg:", "headline:", "platform:")):
            print(f"  bench stderr: {line}")
    check("errors" not in rec, f"bench errors: {rec.get('errors')}; "
          f"stderr {out.stderr[-2000:]}")
    sp = rec.get("spread", {})
    check(rec.get("value") and rec.get("vs_baseline")
          and sp.get("interleaved") is True,
          f"bench headline: value {rec.get('value')} vs_baseline "
          f"{rec.get('vs_baseline')} interleaved {sp.get('interleaved')}")
    st = rec["selftest"]
    for name, e in st.items():
        if isinstance(e, dict):
            worst = max(v for k, v in e.items() if k.endswith("norm_err"))
            verdict(f"bench selftest {name} (fwd + bwd, error / max |plain|)",
                    worst, e["tol_norm"], group="bench selftest")
    check(st.get("all_ok") is True, f"bench selftest: {st}")
    resnet = rec["resnet50_o2_imgs_per_sec"]
    bert = rec["bert_large_lamb_tokens_per_sec"]
    check(isinstance(resnet, dict) and isinstance(bert, dict)
          and "degraded" not in bert and rec.get("fused_opt_step_vs_eager"),
          f"bench rungs: resnet {resnet}, bert {bert}")
    print(f"  bench (python -m apex_tpu_torch.bench, {dt:.1f} s, windows of "
          f"{BENCH_STEPS} steps): GPT-2 345M O2 {rec['value']} tokens/s "
          f"(min {sp['o2']['min']}, max {sp['o2']['max']}, batch "
          f"{rec.get('effective_batch', 8)}), O0 {sp['o0']['median']} "
          f"(min {sp['o0']['min']}, max {sp['o0']['max']}), vs_baseline "
          f"{rec['vs_baseline']}, interleaved; rungs O2 {sp['o2']['rung']}, "
          f"O0 {sp['o0']['rung']}")
    print(f"  bench: ResNet-50 O2 {resnet['median']} imgs/s (min "
          f"{resnet['min']}, max {resnet['max']}, batch {resnet['batch']}, "
          f"canary TF/s {resnet['canary_tf_s']}); BERT-large LAMB "
          f"{bert['median']} tokens/s (min {bert['min']}, max {bert['max']}"
          f", batch {bert['batch']}, canary TF/s {bert['canary_tf_s']}); "
          f"fused_opt_step_vs_eager {rec['fused_opt_step_vs_eager']}; "
          f"selftest all_ok {st['all_ok']} on {st['device']}; "
          f"{nvidia_smi()}")
    print("  bench selftest: " + "; ".join(
        f"{k} fwd {v['fwd_norm_err']:.2e} bwd {v.get('bwd_norm_err', 0):.2e}"
        f" (tol {v['tol_norm']})" for k, v in st.items()
        if isinstance(v, dict)))
    counts = rec["kernel_launches"]["total"]
    by_stage = rec["kernel_launches"]["by_stage"]
    print(f"  bench launches by stage: " + "; ".join(
        f"{k} { {n: c for n, c in v.items() if c} }"
        for k, v in by_stage.items()))
    for name in ops.KERNEL_WRAPPERS:
        n = counts.get(name, 0)
        if name in DECODE_ONLY:
            check(n == 0, f"bench: {name} launched {n} times")
        else:
            verdict(f"bench: {name} launches (none is a failure)",
                    0 if n else 1, 0, group="bench launches")
    print(f"  phase 11 bench took {dt:.1f} s")

    # the DCGAN example, 10 steps on the card
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    res = dcgan.run(["--steps", "10"])
    torch.cuda.synchronize()
    tr, hist = res["trainer"], res["history"]
    check(all(np.isfinite([h["loss_d"], h["loss_g"]]).all() for h in hist)
          and len(hist) == 10, f"dcgan losses {hist}")
    check(all(p.dtype == torch.bfloat16 and p.is_cuda
              for m in (tr.G, tr.D) for p in m.parameters()),
          "dcgan: params bf16 on the card")
    check(not any(h["skipped_d"] or h["skipped_g"] for h in hist)
          and tr.ds.scaler.loss_scale == tr.gs.scaler.loss_scale == 2.0 ** 16
          and tr.ds.inner.step == tr.gs.inner.step == 10,
          f"dcgan scalers: D {tr.ds.scaler.state_dict()} G "
          f"{tr.gs.scaler.state_dict()}")
    dc = ops.launch_counts()
    check(not any(dc.values()), f"dcgan launched csrc kernels: {dc}")
    print(f"  dcgan (examples/dcgan/main_amp.py, 10 steps, batch 32, "
          f"{time.perf_counter() - t1:.1f} s): loss_D "
          f"{hist[0]['loss_d']:.4f} -> {hist[-1]['loss_d']:.4f}, loss_G "
          f"{hist[0]['loss_g']:.4f} -> {hist[-1]['loss_g']:.4f}, scales "
          f"D {tr.ds.scaler.loss_scale:.0f} G {tr.gs.scaler.loss_scale:.0f},"
          f" no step skipped, bf16 params")

    # the native host runtime
    arrays = [np.arange(10, dtype=np.int32), np.ones((3, 5), np.float32)]
    back = csrc.unflatten(csrc.flatten(arrays), arrays)
    check(csrc.available() and all(np.array_equal(a, b)
                                   for a, b in zip(arrays, back)),
          "csrc: the native runtime is not available on the card's host")
    lib = os.path.relpath(csrc.runtime.library_path(), HERE)
    print(f"  csrc native runtime: available ({lib}), flatten round trip "
          f"exact")
    return {name: counts.get(name, 0) for name in ops.KERNEL_WRAPPERS}


# ---------------------------------------------------------------------------
# phase 12: the convergence probe, the rest of the optimizers and the legacy
# APIs
# ---------------------------------------------------------------------------

#: the probe's arguments beyond its defaults (GPT-2 345M, 2 x 512 tokens,
#: lr 3e-4 warmed up over 50 steps): 150 steps, not the default 600, and
#: the CPU replay cut from 6 steps to 1 (the first step's loss, before any
#: update; the card's update is held in phases 4 and 10) -- a replay step
#: of the 345M bf16 model takes about 32 s on the card's host after about
#: 37 s of set-up (PERF.md) -- so that phases 16, 17 and 18 fit the
#: script's time limit: the 300-step curve read 0.0225 at step 150
#: against the bar of 6.0 (PERF.md); and at 12 of the 24 layers (345M's
#: width), which halves both the card's steps and the replay, for phase
#: 19's room
PROBE_ARGS = ["--cpu-check-steps", "1", "--steps", "150", "--layers", "12"]
PROBE_OUTPUT = os.path.join(HERE, "build", "convergence_probe.json")


def convergence_probe(torch, ops, dev):
    """Phase 12 (a): ``python -m apex_tpu_torch.benchmarks.convergence_probe``
    at its defaults but :data:`PROBE_ARGS`, in this process (its ``main``):
    GPT-2 345M's width at 12 layers, O2 (full remat, the 8-chunk LM head,
    FusedAdam with a 50-step warm-up) trains 150 steps on 2 fixed batches of 2 x 512
    tokens, then replays the first on the CPU in a subprocess. Requires
    exit 0 and ``ok``, a final loss
    <= 6.0, a replay with no ``error`` within its band (0.05), and the
    exact launch counts of the card's steps (#1 2L a step with the remat
    recompute, #5 and #6 L, #7 4L + 1, #8 2L + 1; the replay runs the plain
    versions in its own process). Prints the overflow count, the final
    scale, the curve every 50 steps and the wall times. Returns the launch
    counts (path ``probe``)."""
    from apex_tpu_torch.benchmarks import convergence_probe as cp

    if os.path.exists(PROBE_OUTPUT):
        os.unlink(PROBE_OUTPUT)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cp.main(PROBE_ARGS + ["--output", PROBE_OUTPUT])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    dt = time.perf_counter() - t0
    with open(PROBE_OUTPUT) as f:
        rec = json.load(f)
    L, steps = rec["layers"], rec["steps"]
    per_step = dict.fromkeys(counts, 0)
    per_step.update({"flash_attention_fwd": 2 * L,
                     "flash_attention_bwd_dq": L,
                     "flash_attention_bwd_dkv": L,
                     "layer_norm_fwd": 4 * L + 1,
                     "layer_norm_bwd": 2 * L + 1})
    print(f"  probe: {steps} steps, launches {counts} (expected per step "
          f"{per_step})")
    check_counts(counts, {k: v * steps for k, v in per_step.items()},
                 "probe")
    cc = rec.get("cpu_check", {})
    check("error" not in cc and "cpu_curve_max_rel_dev" in cc,
          f"probe CPU replay failed: {cc}")
    curve = rec["curve_every_10"]
    print(f"  probe (GPT-2 345M's width at {L} layers, O2, {rec['batch']} x "
          f"{rec['seq']}, lr "
          f"{rec['lr']} warmed up over {rec['warmup_steps']} steps): loss "
          f"{rec['loss_first']} -> {rec['loss_final']} (bar "
          f"{cp.LOSS_BAR}), max after warm-up {rec['loss_max_after_warmup']}"
          f", overflow steps {rec['overflow_steps']}, final scale "
          f"{rec['final_loss_scale']:g}, wall {rec['wall_seconds']} s (phase "
          f"{dt:.1f} s); {rec['card']}")
    print(f"  probe curve every 50 steps: {curve[::5]}")
    print(f"  probe CPU replay: {cc['steps']} steps in {cc['seconds']} s, "
          f"device {cc['device_curve']}, cpu {cc['cpu_curve']}, max rel dev "
          f"{cc['cpu_curve_max_rel_dev']} (band {cc['band']})")
    verdict("probe final loss (bar 6.0)", rec["loss_final"], cp.LOSS_BAR,
            group="convergence probe")
    verdict("probe CPU replay max rel dev", cc["cpu_curve_max_rel_dev"],
            cc["band"], "cuda/cpu", group="convergence probe")
    check(rc == 0 and rec["ok"] is True and rec["platform"] == dev.type,
          f"probe: exit {rc}, record {rec}")
    return counts


def mp_lamb_bert(torch, ops, dev, steps=5):
    """Phase 12 (b): BERT-large (phase 8's build: O2, 16 x 512, FusedLAMB
    lr 2e-3, weight decay 0.01) steps ``steps`` times through
    ``amp.MixedPrecisionOptimizer(FusedLAMB)``; before each step the scaled
    grads are cloned and fed to a ``FusedMixedPrecisionLamb`` that started
    from the same bf16 weights, its ``lr`` and ``scale`` device tensors,
    its step run under ``torch.cuda.set_sync_debug_mode("error")`` (any
    host sync raises). After each step every master must lie within 1e-5 of
    its leaf's max |master| of amp's, and the bf16 params must be equal.
    Then an inf planted in one grad: masters, moments, the bf16 params and
    the step count keep their bits."""
    import numpy as np

    from apex_tpu_torch.examples.bert.pretrain_bert import (
        build,
        synthetic_batch,
    )
    from apex_tpu_torch.optimizers import FusedMixedPrecisionLamb

    torch.cuda.empty_cache()
    trainer = build(hidden=1024, layers=24, heads=16, seq=512, batch=16,
                    device=dev)
    model, mp_opt, st = trainer.model, trainer.mp_opt, trainer.opt_state
    params = list(model.parameters())
    twin = [p.detach().clone() for p in params]
    opt = FusedMixedPrecisionLamb(lr=2e-3, weight_decay=0.01,
                                  reduced_precision_dtype=torch.bfloat16)
    ms = opt.init(twin)
    lr_t = torch.full((), 2e-3, device=dev)
    batch = synthetic_batch(np.random.default_rng(0), 16, 512,
                            trainer.cfg.vocab_size, dev)
    worst, diff = (0.0, -1), 0
    t0 = time.perf_counter()
    for i in range(steps):
        loss = model.loss(*batch)
        scale = st.scaler.loss_scale
        mp_opt.scale_loss(loss, st).backward()
        grads = [p.grad.clone() if p.grad is not None
                 else torch.zeros_like(p) for p in params]
        scale_t = torch.full((), scale, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ms = opt.step(ms, twin, grads, lr=lr_t, scale=scale_t)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        metrics = mp_opt.step(st, model)
        check(not metrics["found_inf"], f"mp-LAMB check: step {i} skipped")
        for j, (a, b) in enumerate(zip(ms.master, st.master)):
            worst = max(worst, (rel_err(a, b), j))
        diff = max(diff, sum(int((a != b).sum()) for a, b in
                             zip(twin, params)))
    dt = time.perf_counter() - t0
    names = [n for n, _ in model.named_parameters()]
    check(int(ms.step) == steps, f"mp-LAMB step {int(ms.step)} != {steps}")
    print(f"  mp-LAMB at BERT-large (16 x 512, {len(params)} leaves, "
          f"{sum(p.numel() for p in params) / 1e6:.1f} M params): {steps} "
          f"steps beside MixedPrecisionOptimizer(FusedLAMB) in {dt:.1f} s, "
          f"loss {float(loss.detach()):.4f}, scale "
          f"{st.scaler.loss_scale:g}; worst master {worst[0]:.3g} of its "
          f"leaf's max ({names[worst[1]]}; tol 1e-5), bf16 params "
          f"differing {diff}; no host sync in its step")
    verdict("mp-LAMB masters vs MixedPrecisionOptimizer(FusedLAMB), BERT-"
            "large (error / leaf max)", worst[0], 1e-5, group="mp-LAMB")
    verdict("mp-LAMB bf16 params differing from amp's (elements)", diff, 0,
            group="mp-LAMB")
    bad = [g.clone() for g in grads]
    bad[5].view(-1)[7] = float("inf")
    before = [t.clone() for t in [*ms.master, *ms.exp_avg, *ms.exp_avg_sq,
                                  *twin]]
    step0 = ms.step.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ms = opt.step(ms, twin, bad, lr=lr_t, scale=scale_t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = [*ms.master, *ms.exp_avg, *ms.exp_avg_sq, *twin]
    changed = sum(not torch.equal(a, b) for a, b in zip(before, after))
    check(torch.equal(ms.step, step0), "mp-LAMB step advanced on an inf")
    verdict("mp-LAMB overflow skip: tensors whose bits changed", changed, 0,
            group="mp-LAMB")
    print(f"  mp-LAMB planted inf ({names[5]}): step stays {int(ms.step)}, "
          f"{len(before)} masters, moments and params bit-identical")
    del trainer, model, params, twin, ms, grads, bad, before, after
    torch.cuda.empty_cache()


def fp16_optimizer_gpt(torch, ops, dev, steps=3, batch=8):
    """Phase 12 (c): GPT-2 345M (``convert_network``: bf16, norms fp32; full
    remat, the 8-chunk LM head) on one batch of ``batch`` x 1024 tokens:
    ``FP16_Optimizer(FusedAdam(1e-4))`` with a dynamic scale starting at
    2^16 steps a copy of the params from the same scaled grads as
    ``amp.MixedPrecisionOptimizer(FusedAdam(1e-4))`` at O2, ``steps``
    steps: the masters within 1e-6 of each leaf's max, the bf16 params
    equal. Then an inf planted in one grad: the step is skipped (masters
    and moments keep their bits) and the scale halves."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.fp16_utils import FP16_Optimizer, convert_network
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.precision import name_is_norm

    torch.cuda.empty_cache()
    cfg = GPTConfig(hidden_dropout=0.0, compute_dtype=torch.bfloat16,
                    remat=True, lm_head_chunks=8)
    model = GPTModel(cfg, device=dev, seed=0)
    convert_network(model)
    check(all(p.dtype == (torch.float32 if name_is_norm(n)
                          else torch.bfloat16)
              for n, p in model.named_parameters()),
          "convert_network: bf16 weights, fp32 norms")
    params = list(model.parameters())
    twin = [p.detach().clone() for p in params]
    mpo = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-4),
                                      amp.get_policy("O2"))
    st = mpo.init(model)
    legacy = FP16_Optimizer(FusedAdam(lr=1e-4), dynamic_loss_scale=True,
                            dynamic_loss_args={"init_scale": 2.0 ** 16})
    fs = legacy.init(twin)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                           generator=gen, device=dev)
    targets = torch.roll(tokens, -1, dims=-1)
    worst, diff = (0.0, -1), 0
    t0 = time.perf_counter()
    for i in range(steps):
        loss = model.loss(tokens, targets)
        check(fs.scaler.loss_scale == st.scaler.loss_scale,
              "FP16_Optimizer and amp scale alike")
        mpo.scale_loss(loss, st).backward()
        grads = [p.grad.clone() for p in params]
        info = legacy.step(fs, twin, grads)
        metrics = mpo.step(st, model)
        check(not info["overflow"] and not metrics["found_inf"],
              f"FP16_Optimizer check: step {i} overflowed")
        for j, (a, b) in enumerate(zip(fs.master, st.master)):
            worst = max(worst, (rel_err(a, b), j))
        diff = max(diff, sum(int((a != b).sum()) for a, b in
                             zip(twin, params)))
    dt = time.perf_counter() - t0
    names = [n for n, _ in model.named_parameters()]
    print(f"  FP16_Optimizer(FusedAdam) at GPT-2 345M ({batch} x "
          f"{cfg.max_seq_len}): {steps} steps beside amp O2 in {dt:.1f} s, "
          f"loss {float(loss.detach()):.4f}; worst master {worst[0]:.3g} of "
          f"its leaf's max ({names[worst[1]]}; tol 1e-6), bf16 params "
          f"differing {diff}")
    verdict("FP16_Optimizer masters vs amp O2 FusedAdam, GPT-2 345M (error "
            "/ leaf max)", worst[0], 1e-6, group="FP16_Optimizer")
    verdict("FP16_Optimizer bf16 params differing from amp's (elements)",
            diff, 0, group="FP16_Optimizer")
    bad = [g.clone() for g in grads]
    bad[3].view(-1)[11] = float("inf")
    before = [t.clone() for t in [*fs.master, *fs.inner.exp_avg,
                                  *fs.inner.exp_avg_sq, *twin]]
    scale0, inner_step = fs.scaler.loss_scale, fs.inner.step
    info = legacy.step(fs, twin, bad)
    after = [*fs.master, *fs.inner.exp_avg, *fs.inner.exp_avg_sq, *twin]
    changed = sum(not torch.equal(a, b) for a, b in zip(before, after))
    check(info["overflow"] and fs.inner.step == inner_step
          and fs.scaler.loss_scale == scale0 / 2,
          f"FP16_Optimizer overflow: {info}, step {fs.inner.step}")
    verdict("FP16_Optimizer overflow skip: tensors whose bits changed",
            changed, 0, group="FP16_Optimizer")
    print(f"  FP16_Optimizer planted inf ({names[3]}): skipped, scale "
          f"{scale0:g} -> {fs.scaler.loss_scale:g}")
    del model, params, twin, st, fs, grads, bad, before, after
    torch.cuda.empty_cache()


def optimizer_ms_line(torch, dev):
    """Phase 12 (d): ``optimizer_step.per_optimizer_ms`` on the GPT-2-124M
    list: every fused optimizer's ms a step, one JSON line; reported
    only."""
    from apex_tpu_torch.benchmarks import optimizer_step

    params = optimizer_step.gpt2_like_params(device=dev)
    ms = optimizer_step.per_optimizer_ms(params)
    print(json.dumps({"per_optimizer_ms": {"gpt2_124m": ms},
                      "leaves": len(params),
                      "params": sum(p.numel() for p in params),
                      "card": nvidia_smi()}))
    del params
    torch.cuda.empty_cache()
    return ms


#: (e)'s tolerance: each output, final state and grad within this share of
#: its max |CPU value| (fp32 GEMMs in another order through 128 steps)
LSTM_TOL = 1e-4


def lstm_card_vs_cpu(torch, dev, batch=32, steps=128):
    """Phase 12 (e): ``make_lstm(1024, 1024, 2)`` on the card against the
    same weights on the CPU, fp32 with TF32 off: the outputs, both layers'
    final (h, c), and the grads of every weight and of the input under a
    fixed random projection of the outputs, each within
    :data:`LSTM_TOL` of its max |CPU value|."""
    from apex_tpu_torch.rnn import make_lstm

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    card = make_lstm(1024, 1024, 2, device=dev, seed=3)
    host = make_lstm(1024, 1024, 2, device="cpu", seed=3)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(batch, steps, 1024, generator=gen)
    proj = torch.randn(batch, steps, 1024, generator=gen)
    results = {}
    for label, net, d in (("card", card, dev), ("cpu", host, "cpu")):
        xd = x.to(d).requires_grad_()
        t0 = time.perf_counter()
        out, finals = net(xd)
        (out * proj.to(d)).sum().backward()
        if d != "cpu":
            torch.cuda.synchronize()
        results[label] = (time.perf_counter() - t0, [
            ("output", out.detach()), ("h0", finals[0][0].detach()),
            ("c0", finals[0][1].detach()), ("h1", finals[1][0].detach()),
            ("c1", finals[1][1].detach()), ("grad x", xd.grad)] + [
            (f"grad {n}", p.grad) for n, p in net.named_parameters()])
    worst = (0.0, "")
    for (name, got), (_, ref) in zip(results["card"][1], results["cpu"][1]):
        worst = max(worst, (rel_err(got.cpu(), ref), name))
    print(f"  make_lstm(1024, 1024, 2), {batch} x {steps} steps fp32: "
          f"forward + backward {results['card'][0]:.2f} s on the card, "
          f"{results['cpu'][0]:.2f} s on the CPU; worst {worst[0]:.3g} of "
          f"its max |cpu| ({worst[1]}; tol {LSTM_TOL:g}) over the output, "
          f"the final states and {len(results['cpu'][1]) - 5} grads")
    verdict(f"LSTM card vs CPU, worst ({worst[1]})", worst[0], LSTM_TOL,
            "cuda/cpu", group="LSTM card vs CPU")
    del card, host
    torch.cuda.empty_cache()


def optimizers_and_legacy(torch, ops, dev):
    """Phase 12: the convergence probe (a, its launch counts returned as
    path ``probe``), mp-LAMB at BERT-large (b), FP16_Optimizer at GPT-2
    345M (c), the optimizers' ms a step (d) and the LSTM (e)."""
    t0 = time.perf_counter()
    counts = convergence_probe(torch, ops, dev)
    torch.cuda.empty_cache()
    mp_lamb_bert(torch, ops, dev)
    fp16_optimizer_gpt(torch, ops, dev)
    optimizer_ms_line(torch, dev)
    lstm_card_vs_cpu(torch, dev)
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s")
    return counts


#: each phase's seconds, start to the next phase's start (main's run)
PHASE_S = {}
_PHASE_AT = []


def phase_start(n, title):
    """Print phase ``n``'s title and close the previous phase's clock
    (``n`` None closes the last)."""
    now = time.perf_counter()
    if _PHASE_AT:
        k, t = _PHASE_AT.pop()
        PHASE_S[k] = now - t
    if n is not None:
        print(f"phase {n}: {title}")
        _PHASE_AT.append((n, now))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from apex_tpu_torch import ops
    from apex_tpu_torch.csrc import build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase_start(1, "build")
    t0 = time.perf_counter()
    build.load()
    print(f"  kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.last_build_seconds:.2f} s) -> "
          f"{os.path.relpath(build.library_path(), HERE)}")
    with open(build.library_path() + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("   ", line.rstrip())

    phase_start(2, "kernels against their plain versions")
    rows = [check_layer_norm(torch, ops, dev),
            check_layer_norm_bwd(torch, ops, dev),
            check_flash_attention(torch, ops, dev),
            *check_flash_attention_bwd(torch, ops, dev),
            *check_flash_attention_stream(torch, ops, dev),
            check_flash_decode(torch, ops, dev),
            check_flash_decode_multi(torch, ops, dev),
            *check_xentropy(torch, ops, dev),
            *check_softmax(torch, ops, dev)]
    by_name = kernels_by_name_apart()
    for row in rows:
        if row["name"] in by_name:
            row["kernels_by_name"] = by_name[row["name"]]
    bias = check_flash_bias(torch, ops, dev)
    attach_bias_times(rows, bias)
    torch.cuda.empty_cache()
    check_flash_segments(torch, ops, dev)
    torch.cuda.empty_cache()
    ring_times = check_flash_offsets(torch, ops, dev)
    for row in rows:
        if row["name"] in ring_times:
            row.setdefault("by_shape", {}).update(ring_times[row["name"]])
    torch.cuda.empty_cache()

    phase_start(3, "serving")
    greedy_gate(torch, dev)
    feature_gates(torch, ops, dev)
    serve_counts, model, mono = serve_345m(torch, ops, dev)
    spec_counts, _ = serve_345m_prefix_spec(torch, ops, dev, model)
    chunk_counts, _ = serve_345m_chunked(torch, ops, dev, model, mono)
    del model
    torch.cuda.empty_cache()

    phase_start(4, "training")
    gradient_gate(torch, ops, dev)
    train_counts = train_345m(torch, ops, dev)
    torch.cuda.empty_cache()

    phase_start(5, "ResNet-50 training")
    resnet_gradient_gate(torch, ops, dev)
    resnet_counts = train_resnet50(torch, ops, dev)
    torch.cuda.empty_cache()

    phase_start(6, "long-context training")
    long_context_gradient_gate(torch, ops, dev)
    long_counts = train_long_context(torch, ops, dev, 8192, None, "learned")
    window_counts = train_long_context(torch, ops, dev, 16384, 4096, "rope")
    torch.cuda.empty_cache()

    phase_start(7, "fused softmax and the small layers")
    softmax_counts = fused_softmax_and_small_layers(torch, ops, dev)
    torch.cuda.empty_cache()

    phase_start(8, "BERT-large pretraining with FusedLAMB")
    bert_gradient_gate(torch, ops, dev)
    bert_counts = train_bert_large(torch, ops, dev)
    optimizer_step_line(torch, dev)
    torch.cuda.empty_cache()

    phase_start(9, "packed varlen attention (contrib.fmha) at BERT-large "
          "width")
    fmha_counts, fmha_rows = fmha_packed(torch, ops, dev)
    torch.cuda.empty_cache()

    phase_start(10, "the GPT examples (pretrain_gpt -> checkpoint -> resume "
          "-> generate_gpt) at GPT-2 345M's width, 8 layers")
    gpt_counts, fp32_rows = gpt_examples(torch, ops, dev)
    torch.cuda.empty_cache()

    phase_start(11, "the root bench.py harness (python -m "
          "apex_tpu_torch.bench), the DCGAN example, the native runtime")
    gpt_counts["bench"] = bench_harness(torch, ops, dev)
    torch.cuda.empty_cache()

    phase_start(12, "the convergence probe, the rest of the optimizers and "
          "the legacy APIs")
    gpt_counts["probe"] = optimizers_and_legacy(torch, ops, dev)
    torch.cuda.empty_cache()

    phase_start(13, "contrib (fused multi-head attention, ResNet50Frozen, "
          "the RNN-T transducer, ASP 2:4 sparsity)")
    gpt_counts["contrib"] = contrib_phase(torch, ops, dev)
    torch.cuda.empty_cache()

    phase_start(14, "data parallel (NCCL at world size 1; two gloo ranks "
          "on the card)")
    gpt_counts["dp"] = dp_phase(torch, ops, dev)
    torch.cuda.empty_cache()

    phase_start(15, "tensor parallel (NCCL at world size 1; two gloo ranks "
          "on the card)")
    gpt_counts["tp"], heads8 = tp_phase(torch, ops, dev)
    torch.cuda.empty_cache()

    phase_start(16, "ZeRO 1/2/3, the quantized wires and host offload (NCCL "
          "at world size 1; two gloo ranks on the card)")
    gpt_counts["zero"] = zero_phase(torch, ops, dev)
    torch.cuda.empty_cache()

    phase_start(17, "pipeline parallel (NCCL at world size 1; two gloo "
          "ranks on the card)")
    gpt_counts["pp"] = pp_phase(torch, ops, dev)
    torch.cuda.empty_cache()

    phase_start(18, "context parallel (NCCL at world size 1; two gloo "
          "ranks on the card)")
    gpt_counts["cp"] = cp_phase(torch, ops, dev)
    torch.cuda.empty_cache()

    phase_start(19, "mixture of experts (routed-expert FFNs: 345M-MoE "
                "training and serving; expert parallelism at NCCL world size "
                "1 and over two gloo ranks on the card)")
    gpt_counts["moe"] = moe_phase(torch, ops, dev)
    torch.cuda.empty_cache()
    phase_start(None, None)
    print("phase seconds: " + json.dumps(
        {str(k): round(v, 1) for k, v in PHASE_S.items()}))
    for row in rows:
        if row["name"] in fp32_rows:
            row.setdefault("by_shape", {}).update(fp32_rows[row["name"]])
        row.setdefault("by_shape", {}).update(
            {k: v for k, v in heads8.items() if k.split()[0] == row["name"]})
        by_path = {"serve": serve_counts[row["name"]],
                   "serve_prefix_spec": spec_counts[row["name"]],
                   "serve_chunked": chunk_counts[row["name"]],
                   "train": train_counts[row["name"]],
                   "train_resnet": resnet_counts[row["name"]],
                   "train_long": long_counts[row["name"]],
                   "train_long_window": window_counts[row["name"]],
                   "softmax": softmax_counts[row["name"]],
                   "bert": bert_counts[row["name"]],
                   "fmha": fmha_counts[row["name"]]}
        by_path.update({path: c[row["name"]]
                        for path, c in gpt_counts.items()})
        if row["name"] in fmha_rows:
            row["segments"] = fmha_rows[row["name"]]
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        verdict(f"{row['name']} launched on the main paths",
                0 if row["launches"] else 1, 0, row["route"],
                group="every kernel launched on a main path")
    print_verdict()
    keys = ("name", "route", "kernel", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "by_shape", "bias_route",
            "launch_floor_ms", "segments", "res_fwd_tuning", "res_bwd_tuning",
            "res_bwd_f32_tuning", "fwd_f32_split_tuning", "kernels_by_name",
            "warp_tuning", "ln_tuning", "decode_tuning")
    print(json.dumps({"kernels": [{k: row[k] for k in keys if k in row}
                                  for row in rows]}))
    tuning = next(r["decode_tuning"] for r in rows
                  if r["name"] == "flash_decode")
    print("decode split tuning (ms by splits; chosen): " + "; ".join(
        f"{k} {v['chosen']}: " + ", ".join(f"{n} {t:.4f}"
                                          for n, t in v["ms"].items())
        for k, v in tuning.items()))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 9: packed varlen attention (contrib.fmha) at BERT-large width
# ---------------------------------------------------------------------------

FMHA_KERNELS = {False: ("flash_attention_fwd", "flash_attention_bwd_dq",
                        "flash_attention_bwd_dkv"),
                True: ("flash_attention_fwd_stream",
                       "flash_attention_bwd_dq_stream",
                       "flash_attention_bwd_dkv_stream")}


def fmha_case(torch, ops, dev, label, lengths, tail=37, h=16, d=64):
    """One packed batch through ``contrib.fmha`` (non-causal, bf16, 16 heads
    of 64): the route 'auto' takes, the main path's launches (forward +
    backward, counted from 0), output and grads against ``fmha_reference``
    (per sequence, fp32, autograd), exact zeros past ``cu_seqlens[-1]``;
    then each kernel's device time by CUDA-graph replay with the bounds on
    and off, the metadata reductions alone, the bound (sum len_i^2 visible
    pairs as operations, the operands as bytes) and two SDPA yardsticks.
    Returns (launch counts, timing rows)."""
    import importlib

    import torch.nn.functional as F

    from apex_tpu_torch.contrib import (fmha, fmha_reference,
                                        segment_ids_from_cu_seqlens)

    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    bf16 = torch.bfloat16
    n, total = len(lengths), sum(lengths)
    t = total + tail
    stream = t >= tfa.STREAM_MIN_SEQ
    gen = torch.Generator(device=dev).manual_seed(9)
    qkv = torch.randn(t, 3, h, d, device=dev, generator=gen).to(bf16)
    qkv.requires_grad_()
    g = torch.randn(t, h, d, device=dev, generator=gen).to(bf16)
    cu = torch.tensor([0] + [sum(lengths[:i + 1]) for i in range(n)],
                      dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    out = fmha(qkv, cu, 512)
    out.backward(g)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    expected = {name: int(name in FMHA_KERNELS[stream]) for name in counts}
    check_counts(counts, expected, f"fmha {label}")
    rq = qkv.detach().float().requires_grad_()
    ref = fmha_reference(rq, cu)
    (rgrad,) = torch.autograd.grad(ref, rq, g.float())
    grp = f"fmha {label}"
    check(bool((out[total:] == 0).all())
          and bool((qkv.grad[total:] == 0).all()),
          f"{grp}: the {tail} tokens past cu_seqlens[-1] are exactly 0 "
          f"with zero grads")
    parts = [held(f"{grp} out", out.detach(), ref.detach(), 2e-2,
                  ROW_TOL[True][0], group=grp)]
    for i, name in enumerate("qkv"):
        parts.append(held(f"{grp} d{name}", qkv.grad[:, i], rgrad[:, i],
                          1e-2, ROW_TOL[True][1], group=grp))
    route = "streamed" if stream else "resident"
    print(f"  {grp}: {n} sequences, lengths {min(lengths)}-{max(lengths)}, "
          f"{total} tokens + {tail} past cu_seqlens[-1] -> (1,{h},{t},{d}) "
          f"bf16 non-causal, 'auto' took the {route} kernels; launches "
          f"{ {k: v for k, v in counts.items() if v} }; " + ", ".join(parts)
          + f"; tail exactly 0")
    del ref, rgrad, rq

    # device times of the three kernels, the bounds on and off
    q, k, v = (qkv.detach()[:, i].transpose(0, 1)[None] for i in range(3))
    do = g.transpose(0, 1)[None]
    ids = segment_ids_from_cu_seqlens(cu, t)[None]
    fwd, dq_fn, dkv_fn = (getattr(ops, name) for name in FMHA_KERNELS[stream])
    scale = d ** -0.5
    ms = {}
    for contiguous in (True, False):
        seg = tfa._as_seg((ids, ids), n + 1, contiguous, q, k)
        kw = dict(causal=False, scale=scale, segment_ids=seg)
        o, lse = fwd(q, k, v, **kw)
        delta = (o.float() * do.float()).sum(-1)
        dq_fn(q, k, v, do, lse, delta, **kw)
        dkv_fn(q, k, v, do, lse, delta, **kw)  # the tables, before capture
        tag = "bounds" if contiguous else "mask_only"
        ms[tag] = {"fwd": time_ms(lambda: fwd(q, k, v, **kw)),
                   "dq": time_ms(lambda: dq_fn(q, k, v, do, lse, delta,
                                               **kw)),
                   "dkv": time_ms(lambda: dkv_fn(q, k, v, do, lse, delta,
                                                 **kw))}
    outer = tfa.FWD_OUTER_TILE if stream else tfa.RES_FWD_OUTER_TILE
    inner = tfa.FWD_INNER_TILE if stream else tfa.RES_FWD_INNER_TILE
    meta_ms = time_ms(lambda: tfa._seg_args(
        tfa._as_seg((ids, ids), n + 1, True, q, k), outer, inner, True))
    # the host reads of a call: contiguous_segments' monotone check and
    # fmha's envelope check, eager between CUDA events
    check_seg = tfa._as_seg((ids, ids), n + 1, True, q, k)
    host = {"monotone_check": issue_ms(
                lambda: tfa._check_monotone(check_seg), 20),
            "envelope_check": issue_ms(
                lambda: int((cu[1:] - cu[:-1]).max()), 20)}
    pairs = h * sum(x * x for x in lengths)
    elems, rows = t * h * d, t * h
    bounds = {"fwd": bound(4 * elems * 2 + rows * 4 + 2 * t * 4,
                           4 * d * pairs, "bfloat16"),
              "dq": bound(5 * elems * 2 + 2 * rows * 4 + 2 * t * 4,
                          6 * d * pairs, "bfloat16"),
              "dkv": bound(6 * elems * 2 + 2 * rows * 4 + 2 * t * 4,
                           8 * d * pairs, "bfloat16")}
    # the plain forward, eager between CUDA events (the streamed one reads
    # its bounds on the host, so it cannot be captured)
    seg = tfa._as_seg((ids, ids), n + 1, True, q, k)
    kw = dict(causal=False, scale=scale, segment_ids=seg)
    plain = {"fwd": issue_ms(lambda: (
        ops.flash_attention_fwd_stream_reference if stream
        else ops.flash_attention_fwd_reference)(q, k, v, **kw), 2)}
    # yardstick 1: SDPA at the packed shape with the dense block-diagonal
    # boolean mask (pad rows see nothing: their output is not read)
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    pad_id = n + 1
    mask = ((ids[0][:, None] == ids[0][None, :])
            & (ids[0] != pad_id)[None, :])[None, None]
    lib = {"packed_fwd": time_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, attn_mask=mask))}
    ql, kl, vl = (x.detach().requires_grad_() for x in (qc, kc, vc))
    dc = do.contiguous()

    def packed_fwd_bwd():
        o = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
        return torch.autograd.grad(o, (ql, kl, vl), dc)

    lib["packed_fwd_bwd"] = time_ms(packed_fwd_bwd)
    del mask
    # yardstick 2: SDPA over the padded batch (n, h, 512, d) with a
    # key-padding mask, the layout the packing avoids
    pq, pk, pv, pdo = (torch.zeros(n, h, 512, d, device=dev, dtype=bf16)
                       for _ in range(4))
    for i, ln in enumerate(lengths):
        s0 = sum(lengths[:i])
        for dst, src in ((pq, q), (pk, k), (pv, v), (pdo, do)):
            dst[i, :, :ln] = src[0, :, s0:s0 + ln]
    kmask = (torch.arange(512, device=dev)[None]
             < torch.tensor(lengths, device=dev)[:, None])[:, None, None]
    lib["padded_fwd"] = time_ms(lambda: F.scaled_dot_product_attention(
        pq, pk, pv, attn_mask=kmask))
    pql, pkl, pvl = (x.requires_grad_() for x in (pq, pk, pv))

    def padded_fwd_bwd():
        o = F.scaled_dot_product_attention(pql, pkl, pvl, attn_mask=kmask)
        return torch.autograd.grad(o, (pql, pkl, pvl), pdo)

    lib["padded_fwd_bwd"] = time_ms(padded_fwd_bwd)
    del pq, pk, pv, pdo, pql, pkl, pvl
    names = FMHA_KERNELS[stream]
    rows_out = {}
    for part, name in zip(("fwd", "dq", "dkv"), names):
        rows_out[name] = {
            "case": label, "shape": [1, h, t, d], "sequences": n,
            "tokens": total, "ms": ms["bounds"][part],
            "mask_only_ms": ms["mask_only"][part],
            "bound_ms": bounds[part][0], "bound_by": bounds[part][1],
            "metadata_ms": meta_ms, "host_checks_ms": host}
    rows_out[names[0]]["plain_ms"] = plain["fwd"]
    rows_out[names[0]]["library_ms"] = lib["packed_fwd"]
    rows_out[names[0]]["library"] = lib
    port = sum(ms["bounds"].values())
    print(f"  {grp} times (ms by CUDA-graph replay; the wrapper with its "
          f"tables, bounds on / mask-only): "
          + ", ".join(f"{p} {ms['bounds'][p]:.4f} / "
                      f"{ms['mask_only'][p]:.4f} (bound {bounds[p][0]:.4f} "
                      f"{bounds[p][1]})" for p in ("fwd", "dq", "dkv"))
          + f"; the metadata reductions of one kernel's tiles {meta_ms:.4f}"
          f", the monotone check {host['monotone_check']:.4f} and the "
          f"envelope check {host['envelope_check']:.4f} (eager)"
          f"; plain forward (eager) {plain['fwd']:.4f}; SDPA packed "
          f"block-diagonal "
          f"mask forward {lib['packed_fwd']:.4f}, forward + backward "
          f"{lib['packed_fwd_bwd']:.4f}; SDPA padded ({n},{h},512,{d}) "
          f"key-padding mask forward {lib['padded_fwd']:.4f}, forward + "
          f"backward {lib['padded_fwd_bwd']:.4f}; the port forward + "
          f"backward {port:.4f}; {nvidia_smi()}")
    return counts, rows_out


def fmha_packed(torch, ops, dev):
    """Phase 9: (R) 16 sequences of seeded lengths in 32-384 (total under
    STREAM_MIN_SEQ: the resident kernels) and (S) 32 in 64-512 (above it:
    the streamed kernels), each with 37 tokens past ``cu_seqlens[-1]``.
    Returns the summed launch counts and the timing rows by kernel."""
    gen = torch.Generator().manual_seed(21)
    r = torch.randint(32, 385, (16,), generator=gen).tolist()
    s = torch.randint(64, 513, (32,), generator=gen).tolist()
    check(sum(r) + 37 < 4096 < sum(s),
          f"fmha lengths: {sum(r)} and {sum(s)} tokens")
    counts_r, rows_r = fmha_case(torch, ops, dev, "R (16 x 32-384)", r)
    torch.cuda.empty_cache()
    counts_s, rows_s = fmha_case(torch, ops, dev, "S (32 x 64-512)", s)
    torch.cuda.empty_cache()
    counts = {k: counts_r[k] + counts_s[k] for k in counts_r}
    return counts, {**rows_r, **rows_s}


def flash_times(torch, ops, dev):
    """The times of the flash kernels with no bias and no segment ids in
    bf16: the resident #1 at S = (1,16,1024,64) and T = (8,16,1024,64)
    causal, #5 and #6 at T, all three at BERT's (16,16,512,64)
    non-causal, and the streamed #2-#4 at L = (1,16,8192,64) causal; #1,
    #5 and #6 in fp32 at F = (4,16,1024,64) causal and #2 in fp32 at RP =
    (1,16,317,64) causal, window 256, and #3 and #4 in fp32 at L32 =
    (1,16,8192,64) causal (``python3 chip_smoke.py --flash-times TREE``:
    the port of TREE; run it for the parent and this tree in turns to
    compare them on one card)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    q, k, v, do = (torch.randn(1, 16, 8192, 64, device=dev, generator=gen)
                   for _ in range(4))
    kw = dict(causal=True, scale=0.125)
    o, lse = ops.flash_attention_fwd_stream(q, k, v, **kw)
    delta = (o * do).sum(-1)
    out["dq_stream_L32"] = time_ms(lambda: ops.flash_attention_bwd_dq_stream(
        q, k, v, do, lse, delta, **kw), 5, 2)
    out["dkv_stream_L32"] = time_ms(
        lambda: ops.flash_attention_bwd_dkv_stream(q, k, v, do, lse, delta,
                                                   **kw), 5, 2)
    del q, k, v, do, o, lse, delta
    q, k, v = (torch.randn(1, 16, 317, 64, device=dev, generator=gen)
               for _ in range(3))
    out["fwd_stream_f32_RP"] = time_ms(lambda: ops.flash_attention_fwd_stream(
        q, k, v, causal=True, window=256))
    q, k, v, do = (torch.randn(4, 16, 1024, 64, device=dev, generator=gen)
                   for _ in range(4))
    kw = dict(causal=True, scale=0.125)
    out["fwd_f32_F"] = time_ms(lambda: ops.flash_attention_fwd(q, k, v, **kw))
    o, lse = ops.flash_attention_fwd(q, k, v, **kw)
    delta = (o * do).sum(-1)
    out["dq_f32_F"] = time_ms(lambda: ops.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, **kw))
    out["dkv_f32_F"] = time_ms(lambda: ops.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, **kw))
    del q, k, v, do, o, lse, delta
    q, k, v, do = (torch.randn(1, 16, 8192, 64, device=dev,
                               generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    kw = dict(causal=True, scale=0.125)
    o, lse = ops.flash_attention_fwd_stream(q, k, v, **kw)
    delta = (o.float() * do.float()).sum(-1)
    out["fwd_stream_L"] = time_ms(lambda: ops.flash_attention_fwd_stream(
        q, k, v, **kw))
    out["dq_stream_L"] = time_ms(lambda: ops.flash_attention_bwd_dq_stream(
        q, k, v, do, lse, delta, **kw))
    out["dkv_stream_L"] = time_ms(
        lambda: ops.flash_attention_bwd_dkv_stream(q, k, v, do, lse, delta,
                                                   **kw))
    del q, k, v, do, o, lse, delta
    for label, b, s, causal in (("S", 1, 1024, True), ("T", 8, 1024, True),
                                ("B", 16, 512, False)):
        q, k, v, do = (torch.randn(b, 16, s, 64, device=dev,
                                   generator=gen).to(torch.bfloat16)
                       for _ in range(4))
        kw = dict(causal=causal, scale=0.125)
        out[f"fwd_{label}"] = time_ms(lambda: ops.flash_attention_fwd(
            q, k, v, **kw))
        if label != "S":
            o, lse = ops.flash_attention_fwd(q, k, v, **kw)
            delta = (o.float() * do.float()).sum(-1)
            out[f"dq_{label}"] = time_ms(lambda: ops.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, **kw))
            out[f"dkv_{label}"] = time_ms(
                lambda: ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                    **kw))
    return out


def sass_counts(tree):
    """``python3 chip_smoke.py --sass TREE``: per flash wgmma kernel and
    fp32 register-blocked kernel of TREE's built library, its SASS instruction
    count and the MUFU (exp2), LDG, HMMA, FFMA and local-memory (LDL, STL)
    instructions among them, from
    ``cuobjdump -sass``: how a change's instances compare with the parent's
    instruction for instruction (a layout change of an argument struct has
    changed ptxas's code duplication and cost 15%; PERF.md)."""
    import collections
    import re

    sys.path.insert(0, os.path.abspath(tree))
    from apex_tpu_torch.csrc import build

    check(os.path.abspath(build.__file__).startswith(os.path.abspath(tree)),
          f"apex_tpu_torch imported from {build.__file__}, not {tree}")
    build.load()
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", build.library_path()],
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if ("wgmma" in m.group(1)
                                or "f32_blocked" in m.group(1)) else None
            if fn:
                counts[fn] = collections.Counter()
            continue
        m = re.match(
            r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\d+\s+)?([A-Z][A-Z0-9_]*)",
            line)
        if fn and m:
            counts[fn]["instructions"] += 1
            if m.group(2) in ("MUFU", "LDG", "HMMA", "FFMA", "LDL", "STL"):
                counts[fn][m.group(2)] += 1
    print(json.dumps({"tree": tree, "sass": {k: dict(v) for k, v in
                                             counts.items()}}))
    return 0


def times_of_tree(tree, fn):
    """``python3 chip_smoke.py --ln-times TREE`` (:func:`ln_times`) or
    ``--decode-times TREE`` (:func:`decode_times`): the times through the
    port of the checkout at TREE (its kernels built there), printed as one
    JSON line with the card's name and power limit. Run it for two trees
    in turns (parent, change, change, parent) to compare them on one
    card."""
    import importlib

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(tree))
    ops = importlib.import_module("apex_tpu_torch.ops")
    check(os.path.abspath(ops.__file__).startswith(os.path.abspath(tree)),
          f"apex_tpu_torch imported from {ops.__file__}, not {tree}")
    times = fn(torch, ops, torch.device("cuda", 0))
    print(json.dumps({"tree": tree, "card": nvidia_smi(), "ms": times}))
    return 0


# ---------------------------------------------------------------------------
# phase 13: contrib (the fused multi-head attention, the frozen-BN
# ResNet-50, the RNN-T transducer, ASP 2:4 sparsity)
# ---------------------------------------------------------------------------

#: (a): Transformer-big width, which is also BERT-large's attention shape:
#: batch, tokens, encoder-decoder queries, embed, heads, least key length
MHA_WIDTH = dict(batch=16, seq=512, queries=384, embed=1024, heads=16,
                 min_len=128)
#: (b): ResNet50Frozen through phase 5's amp O2 FusedSGD step
FROZEN_RUN = dict(batch_size=64, image_size=224, num_classes=1000, lr=1e-3,
                  steps=10)
#: (c): a speech-sized lattice: batch, frames, labels, vocabulary, joint
#: width
TRANSDUCER = dict(B=16, T=256, U=64, V=1024, H=512)
#: (d): ``bench.build``'s width and depth overrides (none: GPT-2 345M)
ASP_BUILD = {}
ASP_STEPS = 5


def counted(torch, ops, fn, expected, label, total):
    """Run ``fn`` with the launch counts set to 0 just before and read just
    after, hold them to ``expected`` (kernel -> count, others 0) and add
    them to ``total`` (path ``contrib``); returns ``fn()``."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name, n in counts.items():
        check(n == expected.get(name, 0), f"contrib {label}: {name}: {n} "
              f"launches, expected {expected.get(name, 0)}")
    verdict(f"launch counts exact, {label}", 0, 0, "-",
            group="launch counts exact, path contrib")
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n
    return out


def held2d(name, got, ref, share, row, group):
    """:func:`held` for a tensor of any rank: a 1-D one as one row."""
    if got.dim() < 2:
        got, ref = got.reshape(1, -1), ref.reshape(1, -1)
    return held(name, got, ref, share, row, group=group)


def mha_case(torch, ops, dev, gen, dtype, cross, dense, total):
    """Phase 13 (a), one case: ``SelfMultiheadAttn`` (or
    ``EncdecMultiheadAttn`` with ``cross``) with ``bias=True`` and
    ``include_norm_add=True``, fp32 params, ``dtype`` activations, a
    key-padding mask of seeded lengths (and with ``dense`` a float
    (seq, seq) ``attn_mask`` added), forward + backward through
    ``impl="fast"`` (the kernels; its launches counted: #1, #5, #6, #7,
    #8 once each) against ``impl="default"`` (the explicit attention) on
    the same inputs: the output and every parameter's and input's grad by
    share of max |ref| and by row (phase 2's limits). Returns the label
    and both routes' forward + backward ms by CUDA-graph replay."""
    import importlib

    from apex_tpu_torch.contrib import EncdecMultiheadAttn, SelfMultiheadAttn

    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    w = MHA_WIDTH
    b, s, e, h = w["batch"], w["seq"], w["embed"], w["heads"]
    sq = w["queries"] if cross else s
    bf16 = dtype == torch.bfloat16
    label = (f"{'encdec' if cross else 'self'} "
             f"{'pad+dense' if dense else 'pad'} "
             f"{'bf16' if bf16 else 'fp32'}")
    cls = EncdecMultiheadAttn if cross else SelfMultiheadAttn
    mod = cls(e, h, bias=True, include_norm_add=True, device=dev, seed=21)
    with torch.no_grad():  # biases and LN params away from 0 and 1
        for name, p in mod.named_parameters():
            if "bias" in name or "ln" in name:
                p.add_(0.1 * torch.randn(p.shape, device=dev, generator=gen))
    inputs = [torch.randn(b, sq, e, device=dev, generator=gen).to(dtype)]
    if cross:
        inputs.append(torch.randn(b, s, e, device=dev, generator=gen)
                      .to(dtype))
    lengths = torch.randint(w["min_len"], s + 1, (b,), device=dev,
                            generator=gen)
    kw = {"key_padding_mask": torch.arange(s, device=dev)[None]
          >= lengths[:, None]}
    if dense:
        kw["attn_mask"] = torch.randn(s, s, device=dev, generator=gen)
    g = torch.randn(b, sq, e, device=dev, generator=gen).to(dtype)

    def run(impl):
        mod.impl = impl
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = mod(*leaves, **kw)
        grads = torch.autograd.grad(out, [*mod.parameters(), *leaves], g)
        return out.detach(), grads

    fast = counted(torch, ops, lambda: run("fast"), {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1, "layer_norm_fwd": 1,
        "layer_norm_bwd": 1}, f"MHA {label}", total)
    plain = run("default")
    share = 2e-2 if bf16 else 1e-5
    fwd_row, bwd_row = ROW_TOL[bf16]
    group = f"contrib MHA {label}"
    names = ["out", *(f"d{n}" for n, _ in mod.named_parameters()),
             *(("dquery", "dmemory") if cross else ("dx",))]
    parts = []
    for name, got, ref in zip(names, (fast[0], *fast[1]),
                              (plain[0], *plain[1])):
        check(bool(torch.isfinite(got).all()), f"{group} {name} finite")
        parts.append(held2d(f"{group} {name}", got, ref, share,
                            fwd_row if name == "out" else bwd_row, group))
    # q, k, v are strided views of the packed projections: the kernels
    # read them in place (bf16: through TMA, no padded copy)
    with torch.no_grad():
        hq = ops.layer_norm(inputs[0], mod.ln_scale, mod.ln_bias)
        if cross:
            q = hq @ mod.q_weight.to(dtype)
            k, v = (inputs[1] @ mod.kv_weight.to(dtype)).split(e, dim=-1)
        else:
            q, k, v = (hq @ mod.in_weight.to(dtype)).split(e, dim=-1)
        views = [mod._heads(t) for t in (q, k, v)]
    in_place = all(tfa._tma_ok(t) for t in views) if bf16 else all(
        t.stride(-1) == 1 for t in views)
    verdict(f"{group} q/k/v views read in place", 0 if in_place else 1, 0,
            group=group)
    ms = {impl: time_ms(lambda: run(impl), 3, 3)
          for impl in ("fast", "default")}
    print(f"  MHA {label} ({b} x {sq}{f' over {s}' if cross else ''} "
          f"tokens, E {e}, {h} heads, norm-add, biases; lengths "
          f"{int(lengths.min())}-{int(lengths.max())}) fast against "
          f"default, of max|ref|: " + ", ".join(parts)
          + f"; q/k/v read in place: {in_place}; forward + backward "
          f"fast {ms['fast']:.4f} ms, default {ms['default']:.4f} ms")
    out = {"label": label, "ms": ms}
    if bf16 and not cross:
        out["attention"] = mha_attention_times(torch, views, kw, g.shape)
    return out


def mha_attention_times(torch, views, kw, shape):
    """The attention call alone at (a)'s shape (16,16,512,64) bf16 on the
    packed projection's views, forward + backward by CUDA-graph replay:
    ``flash_attention`` with the module's bias against SDPA with the same
    bias as a float ``attn_mask``, beside PERF.md's BB rows."""
    import torch.nn.functional as F

    from apex_tpu_torch.contrib.multihead_attn import _mask_bias, _padding_bias
    from apex_tpu_torch.ops import flash_attention

    bias = _padding_bias(kw["key_padding_mask"])
    if "attn_mask" in kw:
        bias = bias + _mask_bias(kw["attn_mask"])
    do = torch.randn_like(views[0])
    mask = bias.to(views[0].dtype)

    def fwd_bwd(fn):
        leaves = [t.detach().requires_grad_() for t in views]
        return torch.autograd.grad(fn(*leaves), leaves, do)

    return {"flash_ms": time_ms(lambda: fwd_bwd(
                lambda q, k, v: flash_attention(q, k, v, bias)), 5, 3),
            "sdpa_ms": time_ms(lambda: fwd_bwd(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask)), 5, 3)}


def mha_transformer_big(torch, ops, dev, total):
    """Phase 13 (a): the six cases of :func:`mha_case` (self-attention
    with the key-padding mask, then with a dense float mask added, and
    encoder-decoder 384 queries over 512 keys, each bf16 and fp32)."""
    gen = torch.Generator(device=dev).manual_seed(22)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for cross, dense in ((False, False), (False, True), (True, False)):
            rows.append(mha_case(torch, ops, dev, gen, dtype, cross, dense,
                                 total))
            torch.cuda.empty_cache()
    att = "; ".join(f"{r['label']}: flash_attention {r['attention']['flash_ms']:.4f}"
                    f" ms, SDPA with the float mask "
                    f"{r['attention']['sdpa_ms']:.4f} ms"
                    for r in rows if "attention" in r)
    print(f"  MHA attention alone (16,16,512,64) bf16, forward + backward: "
          f"{att}; {nvidia_smi()}")
    return rows


def frozen_gradient_gate(torch, ops, dev):
    """Phase 13 (b) gate: fp32, a small frozen ResNet (FastBottleneck
    stages (1, 1), width 8, 32x32 images with the ImageNet stem, 10
    classes, batch 8, the frozen norms' scale and bias drawn away from 1
    and 0): the loss and every parameter's grad on the card (cuDNN without
    TF32, the xentropy kernels) against the same model on the CPU.
    Tolerances as :func:`resnet_gradient_gate`'s: loss 1e-5 relative, each
    grad 1e-4 of its max |CPU grad|."""
    import numpy as np

    from apex_tpu_torch.models.resnet import _frozen_resnet
    from apex_tpu_torch.ops.xentropy import softmax_cross_entropy

    kw = dict(num_classes=10, width=8, stem_pool=True)
    card = _frozen_resnet((1, 1), device=dev, seed=3, **kw)
    gen = torch.Generator(device=dev).manual_seed(4)
    with torch.no_grad():
        for name, p in card.named_parameters():
            if ".bn" in f".{name}":
                p.add_(0.2 * torch.randn(p.shape, device=dev, generator=gen))
    host = _frozen_resnet((1, 1), device="cpu", **kw)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    check(not list(card.buffers()), "the frozen net holds no running stats")
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.normal(size=(8, 32, 32, 3)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, (8,)))
    loss_c = torch.mean(softmax_cross_entropy(card(images.to(dev)),
                                              labels.to(dev)))
    loss_c.backward()
    loss_h = torch.mean(softmax_cross_entropy(host(images), labels))
    loss_h.backward()
    lc, lh = float(loss_c.detach()), float(loss_h.detach())
    rel = abs(lc - lh) / abs(lh)
    group = "contrib frozen ResNet fp32 gradient gate"
    verdict(f"{group} loss", rel, 1e-5, group=group)
    worst = (0.0, "")
    for (name, pc), ph in zip(card.named_parameters(), host.parameters()):
        worst = max(worst, (rel_err(pc.grad.cpu(), ph.grad), name))
    verdict(f"{group} worst grad ({worst[1]})", worst[0], 1e-4, group=group)
    print(f"  frozen ResNet fp32 gradient gate: loss card {lc:.7f} cpu "
          f"{lh:.7f} (rel {rel:.3g}, tol 1e-05); "
          f"{len(list(host.parameters()))} grads, worst {worst[0]:.3g} "
          f"({worst[1]}, tol 1e-4)")


def train_resnet50_frozen(torch, ops, dev, total):
    """Phase 13 (b): ``ResNet50Frozen`` at :data:`FROZEN_RUN` (64 x 224²
    NHWC) under amp O2 with ``FusedSGD(momentum 0.9, weight decay 1e-4,
    Nesterov)``, phase 5's step (``main_amp``'s ``Trainer`` and
    ``train_steps``): one warm-up step and 10 timed, each xentropy kernel
    once a step and nothing else, a finite falling loss, no skipped step
    after the warm-up, bf16 convs and fp32 frozen-norm params, images/s."""
    import numpy as np

    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.imagenet.main_amp import (
        Trainer, fixed_batch, train_steps)
    from apex_tpu_torch.models import ResNet50Frozen
    from apex_tpu_torch.ops.xentropy import softmax_cross_entropy
    from apex_tpu_torch.optimizers import FusedSGD

    run = FROZEN_RUN
    policy = amp.get_policy("O2")
    model = ResNet50Frozen(num_classes=run["num_classes"],
                           dtype=policy.op_dtype("conv"), device=dev, seed=0)
    amp.cast_params(model, policy)
    mp_opt = amp.MixedPrecisionOptimizer(
        FusedSGD(lr=run["lr"], momentum=0.9, weight_decay=1e-4,
                 nesterov=True), policy)
    opt_state = mp_opt.init(model)

    def step(images, labels):
        loss = torch.mean(softmax_cross_entropy(model(images), labels))
        mp_opt.scale_loss(loss, opt_state).backward()
        return loss.detach(), mp_opt.step(opt_state, model)

    trainer = Trainer(step, model, mp_opt, opt_state, policy,
                      run["batch_size"], run["image_size"],
                      run["num_classes"])
    images, labels = fixed_batch(trainer)
    n = run["steps"]
    stats = counted(torch, ops, lambda: train_steps(trainer, n, images,
                                                    labels),
                    {"xentropy_fwd": n + 1, "xentropy_bwd": n + 1},
                    "ResNet50Frozen", total)
    losses = stats["losses"]
    skipped = [m["found_inf"] for m in stats["metrics"]]
    ms = stats["window_ms"] / n if stats["window_ms"] else float("nan")
    print(f"  ResNet50Frozen O2 train ({run['batch_size']} x "
          f"{run['image_size']}² NHWC, FusedSGD lr {run['lr']}): {n} steps "
          f"{ms:.2f} ms a step, "
          f"{run['batch_size'] / ms * 1e3:.1f} images/s; loss "
          f"{[round(v, 4) for v in losses]}, skipped {skipped}; "
          f"{nvidia_smi()}")
    check(all(np.isfinite(losses)), "every ResNet50Frozen loss finite")
    check(losses[-1] < losses[0], "the ResNet50Frozen loss falls")
    check(not any(skipped[1:]), "no ResNet50Frozen step skipped after the "
          "warm-up")
    check(model.conv1.weight.dtype == torch.bfloat16
          and model.bn1.scale.dtype == torch.float32
          and not list(model.buffers()),
          "ResNet50Frozen O2: bf16 convs, fp32 frozen norms, no stats")
    return {"ms": ms, "images_s": run["batch_size"] / ms * 1e3,
            "losses": losses}


def transducer_lattice(torch, ops, dev, total):
    """Phase 13 (c): the RNN-T joint and loss at :data:`TRANSDUCER` (B 16,
    T 256, U 64, V 1024, joint width 512): the bf16 joint with ReLU, a bf16
    projection to V, fp32 log-probs, ``transducer_loss`` and its gradients
    (no kernel of ours: counted 0). Then the loss and its grad on those
    log-probs against the port's CPU run on the same log-probs (1e-5 of
    max |ref|), sequences 0 and 1 against the float64 DP (1e-4, the JAX
    test's rtol), and the ms of the loss's forward + backward (CUDA-graph
    replay) and of the whole joint -> loss step."""
    from apex_tpu_torch.contrib import (
        transducer_joint, transducer_loss, transducer_loss_reference)

    c = TRANSDUCER
    B, T, U, V, H = c["B"], c["T"], c["U"], c["V"], c["H"]
    gen = torch.Generator(device=dev).manual_seed(23)
    bf16 = torch.bfloat16
    f = torch.randn(B, T, H, device=dev, generator=gen).to(bf16)
    g = torch.randn(B, U + 1, H, device=dev, generator=gen).to(bf16)
    w = (torch.randn(H, V, device=dev, generator=gen) * H ** -0.5).to(bf16)
    targets = torch.randint(1, V, (B, U), device=dev, generator=gen)
    f_len = torch.randint(T // 2, T + 1, (B,), device=dev, generator=gen)
    y_len = torch.randint(U // 2, U + 1, (B,), device=dev, generator=gen)
    f_len[0], y_len[0] = T, U
    lens = (targets, f_len, y_len)

    def step():
        leaves = [t.detach().requires_grad_() for t in (f, g, w)]
        logits = transducer_joint(leaves[0], leaves[1], relu=True) @ leaves[2]
        lp = torch.log_softmax(logits.float(), dim=-1)
        loss = transducer_loss(lp, *lens).mean()
        return (lp.detach(), loss.detach(),
                torch.autograd.grad(loss, leaves))

    lp, loss, grads = counted(torch, ops, step, {}, "transducer", total)
    group = "contrib transducer"
    for name, t in zip(("df", "dg", "dw"), grads):
        check(bool(torch.isfinite(t).all()), f"{group} {name} finite")
    lp_c = lp.clone().requires_grad_()
    loss_c = transducer_loss(lp_c, *lens)
    (dlp_c,) = torch.autograd.grad(loss_c.sum(), lp_c)
    lp_h = lp.cpu().requires_grad_()
    loss_h = transducer_loss(lp_h, *(t.cpu() for t in lens))
    (dlp_h,) = torch.autograd.grad(loss_h.sum(), lp_h)
    e_loss = rel_err(loss_c.detach().cpu(), loss_h.detach())
    e_grad = rel_err(dlp_c.cpu(), dlp_h)
    verdict(f"{group} loss card vs cpu", e_loss, 1e-5, "cuda/cpu",
            group=group)
    verdict(f"{group} dlog_probs card vs cpu", e_grad, 1e-5, "cuda/cpu",
            group=group)
    dp = transducer_loss_reference(lp[:2].cpu(), targets[:2].cpu(),
                                   f_len[:2].cpu(), y_len[:2].cpu())
    got = loss_c.detach()[:2].cpu().double().numpy()
    e_dp = float(abs(got - dp).max() / abs(dp).max())
    verdict(f"{group} 2 sequences vs the float64 DP", e_dp, 1e-4,
            "cuda/cpu", group=group)
    del lp_h, loss_h, dlp_h, dlp_c, grads
    lp_t = lp.clone().requires_grad_()
    loss_ms = time_ms(lambda: torch.autograd.grad(
        transducer_loss(lp_t, *lens).sum(), lp_t), 1, 3)
    step_ms = time_ms(step, 1, 3)
    print(f"  transducer (B {B}, T {T}, U {U}, V {V}, joint {H}, bf16 joint, "
          f"fp32 log-probs): mean loss {float(loss):.4f}; card vs cpu loss "
          f"{e_loss:.3g}, dlog_probs {e_grad:.3g} (tol 1e-5), 2 sequences "
          f"vs the float64 DP {e_dp:.3g} (tol 1e-4); loss forward + "
          f"backward {loss_ms:.3f} ms ({T + U} anti-diagonals), joint -> "
          f"loss step {step_ms:.3f} ms; {nvidia_smi()}")
    return {"loss_ms": loss_ms, "step_ms": step_ms}


def zeros_per_group(torch, tree, masks):
    """The least count of zeros in a group of 4 along dim -2 over every
    masked leaf of ``tree`` (a JAX-layout tree; ``masks`` the mask tree
    of its structure), and the number of masked leaves."""
    from apex_tpu_torch.contrib import sparsity

    worst, n = 4, 0
    paths = []
    sparsity.tree_map_with_path(lambda path, m: paths.append((path, m)),
                                masks)
    for path, m in paths:
        if m is None:
            continue
        leaf = tree
        for key in path:
            leaf = leaf[key]
        z = (leaf == 0).movedim(-2, -1)
        z = z.reshape(*z.shape[:-1], -1, 4).sum(-1)
        worst = min(worst, int(z.min()))
        n += 1
    return worst, n


def asp_gpt_345m(torch, ops, dev, total):
    """Phase 13 (d): ASP at phase 4's configuration (GPT-2 345M O2,
    ``bench.build``, 8 x 1024 tokens, one fixed batch): the 2:4 masks of
    every eligible leaf of the model's JAX-layout tree on the card equal
    the CPU's from the same weights; one seeded channel permutation of
    layer 0's MLP pair (fc1's outputs, fc2's inputs) keeps the pair's
    output (fp32, 1e-5 of max |ref|); then ``ASP.init_optimizer_for_pruning
    (FusedAdam(lr 1e-4))`` inside amp's ``MixedPrecisionOptimizer`` for
    :data:`ASP_STEPS` steps: after every step each masked group of 4 along
    the contraction dim holds >= 2 zeros in the bf16 params and in the fp32
    masters, ``sparsity_ratio`` is 0.5, the launches are phase 4's a step;
    the loss is finite and falls."""
    import numpy as np
    import torch.nn.functional as F

    from apex_tpu_torch import amp
    from apex_tpu_torch._params import module_tree
    from apex_tpu_torch.bench import build, fixed_batch
    from apex_tpu_torch.contrib import sparsity
    from apex_tpu_torch.contrib.sparsity import ASP
    from apex_tpu_torch.contrib.sparsity import permutation as plib
    from apex_tpu_torch.optimizers import FusedAdam

    group = "contrib ASP GPT-2 345M"
    bench = build("O2", device=dev, seed=0, **ASP_BUILD)
    model, cfg, L = bench.model, bench.cfg, bench.cfg.num_layers
    bench.opt_state = None  # phase 4's optimizer state: not used here
    tree = sparsity.jax_layout_tree(model)
    t0 = time.perf_counter()
    masks = sparsity.compute_sparse_masks(tree)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = sparsity.compute_sparse_masks(
        sparsity.tree_map_with_path(lambda _, t: t.cpu(), tree))
    t_cpu = time.perf_counter() - t0
    differ = eligible = 0
    for a, b in zip(sparsity.tree_leaves(masks), sparsity.tree_leaves(host)):
        check((a is None) == (b is None), f"{group}: eligibility differs")
        if a is not None:
            eligible += 1
            differ += int((a.cpu() != b).sum())
    verdict(f"{group} masks card vs cpu (elements differing)", differ, 0,
            "cuda/cpu", group=group)
    del tree, host
    # one seeded channel permutation of layer 0's MLP pair
    lay = model.layers[0]
    pair = {"fc1": {"kernel": lay.fc1.kernel.float(),
                    "bias": lay.fc1.bias.float()},
            "fc2": {"kernel": lay.fc2.kernel.float(),
                    "bias": lay.fc2.bias.float()}}
    perm = np.random.default_rng(7).permutation(pair["fc2"]["kernel"].shape[0])
    permuted = plib.apply_channel_permutation(
        pair, plib.ChannelGroup(consumers=["fc2"], producers=["fc1"]), perm)
    x = torch.randn(2048, cfg.hidden_size, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(24))

    def mlp(p):
        hdn = F.gelu(x @ p["fc1"]["kernel"] + p["fc1"]["bias"],
                     approximate="tanh")
        return hdn @ p["fc2"]["kernel"] + p["fc2"]["bias"]

    with torch.no_grad():
        e_perm = rel_err(mlp(permuted), mlp(pair))
    verdict(f"{group} permuted MLP pair output", e_perm, 1e-5, group=group)
    del pair, permuted, x
    # the ASP-wrapped FusedAdam under amp O2
    ASP.reset()
    ASP.init_model_for_pruning(model, "m4n2_1d")
    mp = amp.MixedPrecisionOptimizer(
        ASP.init_optimizer_for_pruning(FusedAdam(lr=1e-4)), bench.mp_opt.policy)
    _, per_param = ASP.compute_sparse_masks(model)
    state = mp.init(model)
    tokens, targets = fixed_batch(bench)

    def step():
        loss = model.loss(tokens, targets)
        mp.scale_loss(loss, state).backward()
        return float(loss.detach()), mp.step(state, model)

    per_step = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L, "layer_norm_fwd": 4 * L + 1,
                "layer_norm_bwd": 2 * L + 1}
    losses, worst_p, worst_m = [], 4, 4
    t0 = time.perf_counter()
    for i in range(ASP_STEPS):
        loss, metrics = counted(torch, ops, step, per_step, "ASP steps",
                                total)
        check(not metrics["found_inf"], f"{group}: step {i} skipped")
        losses.append(loss)
        zp, n = zeros_per_group(torch, sparsity.jax_layout_tree(model), masks)
        zm, _ = zeros_per_group(
            torch, module_tree(model, state.master, device=dev), masks)
        worst_p, worst_m = min(worst_p, zp), min(worst_m, zm)
        ratio = sparsity.sparsity_ratio(list(model.parameters()), per_param)
        verdict(f"{group} sparsity_ratio - 0.5", abs(ratio - 0.5), 0,
                group=group)
    wall = time.perf_counter() - t0
    verdict(f"{group} 2 - least zeros of a group (bf16 params)",
            max(0, 2 - worst_p), 0, group=group)
    verdict(f"{group} 2 - least zeros of a group (fp32 masters)",
            max(0, 2 - worst_m), 0, group=group)
    check(all(np.isfinite(losses)), f"{group}: every loss finite")
    check(losses[-1] < losses[0], f"{group}: the loss falls")
    print(f"  ASP GPT-2 345M O2 ({cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, {bench.batch} x {cfg.max_seq_len}): masks of "
          f"{eligible} eligible leaves on the card ({t_card:.2f} s) equal the "
          f"CPU's ({t_cpu:.2f} s): {differ} differ; permuted MLP pair "
          f"{e_perm:.3g} (tol 1e-5); {ASP_STEPS} steps of ASP FusedAdam "
          f"under amp ({wall:.1f} s with the checks): loss "
          f"{[round(v, 4) for v in losses]}, least zeros in a group of 4: "
          f"params {worst_p}, masters {worst_m} ({n} masked leaves), "
          f"sparsity_ratio {ratio}")
    ASP.reset()
    return {"losses": losses}


def contrib_phase(torch, ops, dev):
    """Phase 13: (a) :func:`mha_transformer_big`, (b)
    :func:`frozen_gradient_gate` and :func:`train_resnet50_frozen`, (c)
    :func:`transducer_lattice`, (d) :func:`asp_gpt_345m`. Returns the
    launches of its counted runs (path ``contrib``)."""
    t0 = time.perf_counter()
    total = {}
    mha_transformer_big(torch, ops, dev, total)
    torch.cuda.empty_cache()
    frozen_gradient_gate(torch, ops, dev)
    train_resnet50_frozen(torch, ops, dev, total)
    gc.collect()
    torch.cuda.empty_cache()
    transducer_lattice(torch, ops, dev, total)
    gc.collect()
    torch.cuda.empty_cache()
    asp_gpt_345m(torch, ops, dev, total)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 13 launches {total}; phase 13 took "
          f"{time.perf_counter() - t0:.1f} s")
    return total


def contrib_main():
    """``python3 chip_smoke.py --contrib``: phase 13 alone after the
    build, with its verdict."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from apex_tpu_torch import ops
    from apex_tpu_torch.csrc import build

    print(f"card: {nvidia_smi()}; torch {torch.__version__}")
    build.load()
    contrib_phase(torch, ops, torch.device("cuda", 0))
    print_verdict()
    return 0


# ---------------------------------------------------------------------------
# phase 14: data parallel (NCCL at world size 1; two gloo ranks on the card)
# ---------------------------------------------------------------------------

#: (b)'s 345M run: each of 2 ranks takes 2 micro-batches of 4 of a 16-row
#: global batch; the serial reference takes all 16 as 4 micro-batches of 4
DP_345M = with_layers(GPT_345M, RANK_LAYERS) + [
    "--seq", "1024", "--micro-batch", "4",
                      "--num-microbatches", "2", "--lr", "1e-4"]
SERIAL_16 = with_layers(GPT_345M, RANK_LAYERS) + [
    "--seq", "1024", "--micro-batch", "4",
                        "--num-microbatches", "4", "--lr", "1e-4"]
#: ResNet-50 at 64 x 224^2: (a) O2, --sync-bn at world 1 against local BN;
#: (b) in fp32 (O0), 2 x 32 a rank against 64 serial, so that the check
#: reads the synchronised statistics and not bf16 rounding (in O2 the
#: logits of the two runs part by 0.055 of max |ref| through 53 BNs)
DP_RESNET = dict(arch="resnet50", opt_level="O2", batch_size=64,
                 image_size=224, num_classes=1000, seed=0)
DP_RESNET_B = dict(DP_RESNET, opt_level="O0")
DP_LONG = dict(seq=8192, hidden=1024, layers=RANK_LAYERS, heads=16,
               vocab=50304,
               batch=2, lm_head_chunks=8, seed=0)
DP_STEPS = 2
#: limits of (b): losses relative; grads by share of max |ref| and by row
#: (phase 2's bf16 limits); the fp32 ResNet's logits (share of max |ref|
#: and by row) and running statistics (share of max), and its worst grad
#: leaf's L2 distance from the serial run's over the distance the same
#: serial run reaches with its batch's two halves swapped (the same math
#: summed in another order: a random-init ResNet-50's BN backward
#: amplifies the order to 0.05 of some leaves, on the CPU as on the card)
DP_LOSS_REL = 2e-3
DP_GRAD = (0.02, 0.015)
DP_RESNET_TOL = dict(logits=1e-4, stats=1e-4, grads=3.0)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def param_fingerprint(torch, params):
    """Per tensor: the sums of its 16- or 32-bit patterns, their squares
    and their products with the element index (int64, wrapping): equal
    tensors give equal rows, and a one-bit change moves the row."""
    rows = []
    for p in params:
        bits = p.detach().reshape(-1).view(
            torch.int16 if p.element_size() == 2 else torch.int32).long()
        idx = torch.arange(bits.numel(), device=bits.device)
        rows.append(torch.stack([bits.sum(), (bits * bits).sum(),
                                 (bits * idx).sum()]))
    return torch.stack(rows)


def capture_grads(torch, trainer, into):
    """Keep the grads (scaled, reduced) ``trainer``'s first optimizer step
    is given."""
    real = trainer.mp_opt.step

    def step(state, model, **kw):
        if not into:
            into.extend(p.grad.detach().clone() for p in model.parameters())
        return real(state, model, **kw)

    trainer.mp_opt.step = step


def pretrain_steps(torch, ops, argv, steps, snap=False, axis=None,
                   snap_to=None, hook=None, fixed=False, **config):
    """``pretrain_gpt.build`` from ``argv`` on the stream's first ``steps``
    batches: (bench, losses, each step's params when ``snap``, first
    step's grads, launches). ``axis="model"`` builds on the model axis at
    the argv's ``--tp`` (1 too); ``config`` (``sequence_parallel``,
    ``compute_dtype``) goes into the example's config, which has no flag
    for them. ``snap_to`` puts the snapshots on that device; ``hook(bench)``
    runs after the build; ``fixed`` takes the stream's first batch at every
    step."""
    from apex_tpu_torch.examples.gpt import pretrain_gpt

    args = pretrain_gpt.parse_args(argv)
    real = pretrain_gpt.GPTConfig
    if config:
        pretrain_gpt.GPTConfig = lambda **c: real(**dict(c, **config))
    try:
        bench = pretrain_gpt.build(
            vocab=args.vocab, hidden=args.hidden, layers=args.layers,
            heads=args.heads, seq=args.seq, micro_batch=args.micro_batch,
            num_microbatches=args.num_microbatches, lr=args.lr,
            opt_level=args.opt_level, tp=args.tp, axis=axis, pp=args.pp,
            vpp=args.vpp, pp_schedule=args.pp_schedule,
            zero_level=args.zero_level if args.zero else None,
            zero_gather=args.zero_gather, reduce_dtype=args.reduce_dtype,
            zero3_prefetch=args.zero3_prefetch,
            offload=args.offload_optimizer,
            offload_buckets=args.offload_buckets,
            moe_experts=args.moe_experts, moe_top_k=args.moe_top_k,
            moe_capacity_factor=args.moe_capacity_factor,
            moe_dispatch_dtype=args.moe_dispatch_dtype, device=args.device)
    finally:
        pretrain_gpt.GPTConfig = real
    grads, losses, snaps = [], [], []
    capture_grads(torch, bench, grads)
    if hook is not None:
        hook(bench)
    batches = pretrain_gpt.batches(args, bench.batch)
    if fixed:
        first = next(batches)
        batches = iter(lambda: first, None)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for _ in range(steps):
        loss, m = bench.step(*next(batches))
        check(not m["found_inf"], "no 345M pretrain step skipped")
        losses.append(float(loss))
        if snap:  # at ZeRO-3 the full params gathered from the chunks
            full = (bench.mp_opt.zero3_materialize(bench.zero3)
                    if bench.zero3 is not None else
                    [p.detach() for p in bench.model.parameters()])
            snaps.append([p.to(snap_to or p.device, copy=True)
                          for p in full])
            del full
    torch.cuda.synchronize()
    return bench, losses, snaps, grads, ops.launch_counts()


def resnet_run(torch, ops, cfg, steps, sync_bn, logits=None, grads=None,
               swap=False):
    """``main_amp.build(**cfg)`` ``steps`` steps on its fixed batch (its
    two halves swapped with ``swap``): (trainer, losses, launches);
    ``logits`` / ``grads`` collect the first step's (this rank's rows)."""
    from apex_tpu_torch.examples.imagenet import main_amp

    trainer = main_amp.build(**cfg, sync_bn=sync_bn)
    if logits is not None:
        trainer.model.fc.register_forward_hook(
            lambda m, i, o: logits.append(o.detach().clone())
            if not logits else None)
    if grads is not None:
        capture_grads(torch, trainer, grads)
    images, labels = main_amp.fixed_batch(trainer)
    if swap:
        images, labels = (torch.cat(t.chunk(2)[::-1]) for t in (images,
                                                                 labels))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses = [float(trainer.step(images, labels)[0]) for _ in range(steps)]
    torch.cuda.synchronize()
    return trainer, losses, ops.launch_counts()


def bn_stats(trainer):
    from apex_tpu_torch.parallel import SyncBatchNorm

    return [t.detach().clone() for m in trainer.model.modules()
            if isinstance(m, SyncBatchNorm) for t in (m.mean, m.var)]


def long_run(torch, ops, dp, steps):
    """``train_long_context.build`` (345M, 8192 tokens a row, the global
    batch of 2 rows) ``steps`` steps: (losses, launches, per-step ms)."""
    from apex_tpu_torch.bench import fixed_batch
    from apex_tpu_torch.examples.longcontext import train_long_context

    trainer = train_long_context.build(**DP_LONG, dp=dp)
    tokens, targets = fixed_batch(trainer)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, m = trainer.step(tokens, targets)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        check(not m["found_inf"], "no long-context DP step skipped")
    torch.cuda.synchronize()
    return losses, ops.launch_counts(), ms


def long_per_step(L):
    return {"flash_attention_fwd_stream": 2 * L,
            "flash_attention_bwd_dq_stream": L,
            "flash_attention_bwd_dkv_stream": L,
            "layer_norm_fwd": 4 * L + 1, "layer_norm_bwd": 2 * L + 1}


def grads_err(torch, got, ref):
    """The worst leaf's share of max |ref| and worst row (phase 2's
    measures) of two grad lists."""
    worst, worst_row = 0.0, 0.0
    for g, r in zip(got, ref):
        r = r.to(g.device)
        worst = max(worst, rel_err(g, r))
        worst_row = max(worst_row, row_err(g if g.dim() else g[None],
                                           r if r.dim() else r[None]))
    return worst, worst_row


def _dp_rank(rank, world, port, ref_dir, out_path):
    """One gloo rank of (b) on the card: every case in turn; the errors
    and counts go back to the parent in ``out_path``."""
    import pickle
    import traceback

    import torch

    sys.path.insert(0, HERE)
    res = {"rank": rank}
    try:
        from apex_tpu_torch import ops
        from apex_tpu_torch.parallel import collectives, mesh, multiproc
        from apex_tpu_torch.transformer.amp import MeshGradScaler
        import torch.distributed as dist

        multiproc.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                         backend="gloo", timeout_s=600)
        mesh.initialize_model_parallel()
        dev = torch.device("cuda", 0)
        probe = {}
        for name, fn in (
                ("all_reduce bf16", lambda: dist.all_reduce(
                    torch.ones(4, dtype=torch.bfloat16, device=dev))),
                ("all_reduce fp32 max", lambda: dist.all_reduce(
                    torch.ones(4, device=dev), op=dist.ReduceOp.MAX)),
                ("broadcast", lambda: dist.broadcast(
                    torch.ones(4, device=dev), 0))):
            try:
                fn()
                probe[name] = "ok"
            except RuntimeError as e:
                probe[name] = f"refused: {str(e)[:80]}"
        res["gloo"] = probe
        ref = torch.load(os.path.join(ref_dir, "ref.pt"), map_location=dev)

        # 1. the 345M O2 DP step
        t0 = time.perf_counter()
        bench, losses, snaps, grads, counts = pretrain_steps(
            torch, ops, DP_345M, DP_STEPS, snap=True)
        res["gpt_s"] = time.perf_counter() - t0
        res["gpt_losses"], res["gpt_counts"] = losses, counts
        res["gpt_batch"], res["L"] = bench.batch, bench.cfg.num_layers
        res["gpt_grad_err"] = grads_err(torch, grads, ref["gpt_grads"])
        del grads
        fps = [param_fingerprint(torch, s) for s in snaps]
        del snaps
        same = []
        for fp in fps:
            both = collectives.all_gather(fp, "data", tiled=False)
            same.append(bool(torch.equal(both[0], both[1])))
        flat = torch.cat([p.detach().reshape(-1).view(torch.uint8)
                          for p in bench.model.parameters()])
        first = collectives.broadcast(flat, "data", src=0)
        same.append(bool(torch.equal(first, flat)))
        del flat, first
        res["gpt_ranks_equal"] = same

        # 2. the overflow vote: an inf in rank 1's grads only
        model, st = bench.model, bench.opt_state
        before = param_fingerprint(torch, model.parameters())
        scale = st.scaler.loss_scale
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        if rank == 1:
            next(model.parameters()).grad.view(-1)[0] = float("inf")
        m = bench.mp_opt.step(st, model, found_inf_reducer=MeshGradScaler(
            mesh.AXIS_DATA).found_inf_reducer)
        res["vote"] = {"found_inf": m["found_inf"], "scale": scale,
                       "scale_after": st.scaler.loss_scale,
                       "unchanged": bool(torch.equal(before, (
                           param_fingerprint(torch, model.parameters()))))}
        del bench, model, st
        gc.collect()
        torch.cuda.empty_cache()

        # 3. ResNet-50 with SyncBatchNorm over both ranks
        logits, rgrads = [], []
        trainer, rlosses, rcounts = resnet_run(torch, ops, DP_RESNET_B, 1,
                                               True, logits, rgrads)
        n = DP_RESNET_B["batch_size"] // world
        res["resnet"] = {
            "losses": rlosses, "counts": rcounts,
            "logits": rel_err(logits[0], ref["resnet_logits"][
                rank * n:(rank + 1) * n]),
            "logits_row": row_err(logits[0], ref["resnet_logits"][
                rank * n:(rank + 1) * n]),
            "stats": max(rel_err(a, b) for a, b in zip(
                bn_stats(trainer), ref["resnet_stats"])),
            "grads": max(l2_err(a, b) for a, b in zip(
                rgrads, ref["resnet_grads"])),
            "grads_l2": sorted(
                ((l2_err(a, b), rel_err(a, b), n) for a, b, (n, _) in zip(
                    rgrads, ref["resnet_grads"],
                    trainer.model.named_parameters())), reverse=True)[:3]}
        del trainer, logits, rgrads
        gc.collect()
        torch.cuda.empty_cache()

        # 4. the long-context example at --dp 2
        t0 = time.perf_counter()
        llosses, lcounts, lms = long_run(torch, ops, world, DP_STEPS)
        res["long"] = {"losses": llosses, "counts": lcounts, "ms": lms,
                       "s": time.perf_counter() - t0}
    except Exception:  # noqa: BLE001 - reported by the parent
        res["error"] = traceback.format_exc()
    finally:
        try:
            from apex_tpu_torch.parallel import multiproc

            multiproc.shutdown()
        except Exception as e:  # noqa: BLE001
            res.setdefault("error", f"shutdown: {e}")
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def dp_world1(torch, ops, dev, total):
    """(a): NCCL at world size 1 in this process. ``pretrain_gpt``'s DP
    branch at 345M (RANKS_PRETRAIN), 3 O2 steps, bit for bit the serial
    run's losses and params after every step; ``main_amp --sync-bn``
    (ResNet-50, 64 x 224^2, 3 steps) against the serial local-BN run."""
    from apex_tpu_torch.parallel import multiproc

    _, slosses, ssnaps, _, _ = pretrain_steps(torch, ops, RANKS_PRETRAIN, 3,
                                              snap=True)
    gc.collect()
    torch.cuda.empty_cache()
    _, rlocal, _ = resnet_run(torch, ops, DP_RESNET, 3, False)
    gc.collect()
    torch.cuda.empty_cache()
    check(multiproc.initialize_distributed(
        f"127.0.0.1:{free_port()}", 1, 0), "NCCL world 1 initialized")
    import torch.distributed as dist

    backend = dist.get_backend()
    try:
        bench, losses, snaps, _, counts = pretrain_steps(
            torch, ops, RANKS_PRETRAIN, 3, snap=True)
        L = bench.cfg.num_layers
        check_counts(counts, expected_counts(counts, 3, pretrain_per_step(
            L, 2)), "dp")
        total.update({k: total.get(k, 0) + v for k, v in counts.items()})
        same = [losses == slosses] + [
            all(torch.equal(a, b) for a, b in zip(s, t))
            for s, t in zip(snaps, ssnaps)]
        print(f"  (a) pretrain_gpt 345M O2 DP branch on {backend} at world "
              f"size 1, 3 steps of {bench.batch} x 1024: losses "
              f"{losses} (serial {slosses}); losses and params after each "
              f"step bit-identical to the serial run: {same}")
        verdict("dp (a) 345M DP world 1 bit for bit the serial run",
                0 if all(same) else 1, 0, group="data parallel (a) NCCL "
                "world 1")
        del bench, snaps, ssnaps
        gc.collect()
        torch.cuda.empty_cache()
        trainer, rsync, rcounts = resnet_run(torch, ops, DP_RESNET, 3,
                                             True)
        check(trainer.model.bn1.axis_name == "data", "sync BN built")
        expected = dict.fromkeys(rcounts, 0)
        expected.update(xentropy_fwd=3, xentropy_bwd=3)
        check_counts(rcounts, expected, "dp")
        total.update({k: total.get(k, 0) + v for k, v in rcounts.items()})
        rel = max(abs(a - b) / abs(b) for a, b in zip(rsync, rlocal))
        print(f"  (a) main_amp --sync-bn ResNet-50 O2 64 x 224^2 on "
              f"{backend} at world size 1, 3 steps: losses {rsync} against "
              f"local BN {rlocal} (worst rel {rel:.3g}; first step's "
              f"equal: {rsync[0] == rlocal[0]})")
        verdict("dp (a) ResNet-50 --sync-bn world 1 vs local BN loss rel",
                rel, DP_LOSS_REL, group="data parallel (a) NCCL world 1")
        del trainer
    finally:
        multiproc.shutdown()
    gc.collect()
    torch.cuda.empty_cache()


def dp_two_ranks(torch, ops, dev, total, smi):
    """(b): two gloo ranks on the one card (host-staged; correctness only),
    spawned once, every case in turn, against the serial references made
    here first."""
    import multiprocessing
    import pickle
    import shutil

    ref_dir = os.path.join(HERE, "build", "dp_check")
    os.makedirs(ref_dir, exist_ok=True)
    try:
        t0 = time.perf_counter()
        _, glosses, _, ggrads, _ = pretrain_steps(torch, ops, SERIAL_16,
                                                  DP_STEPS)
        gc.collect()
        torch.cuda.empty_cache()
        logits, rgrads, again = [], [], []
        trainer, rlosses, _ = resnet_run(torch, ops, DP_RESNET_B, 1, False,
                                         logits, rgrads)
        # the same math in another order: the batch's halves swapped
        resnet_run(torch, ops, DP_RESNET_B, 1, False, None, again,
                   swap=True)
        floor = sorted(((l2_err(a, b), rel_err(a, b), n) for a, b, (n, _)
                        in zip(again, rgrads,
                               trainer.model.named_parameters())),
                       reverse=True)[:3]
        del again
        ref = {"gpt_grads": [g.cpu() for g in ggrads],
               "resnet_logits": logits[0].cpu(),
               "resnet_stats": [t.cpu() for t in bn_stats(trainer)],
               "resnet_grads": [g.cpu() for g in rgrads]}
        del trainer, logits, rgrads, ggrads
        gc.collect()
        torch.cuda.empty_cache()
        llosses, _, lms = long_run(torch, ops, 1, DP_STEPS)
        gc.collect()
        torch.cuda.empty_cache()
        torch.save(ref, os.path.join(ref_dir, "ref.pt"))
        del ref
        print(f"  (b) serial references (345M 16 x 1024 as 4 x 4, "
              f"ResNet-50 64, long context 2 x 8192) in "
              f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        outs = [os.path.join(ref_dir, f"rank{r}.pkl") for r in range(2)]
        procs = [ctx.Process(target=_dp_rank,
                             args=(r, 2, port, ref_dir, outs[r]))
                 for r in range(2)]
        for p in procs:
            p.start()
        end = time.monotonic() + 600
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        check(not alive, "the two gloo ranks finished within 600 s")
        res = []
        for r, path in enumerate(outs):
            check(os.path.exists(path), f"gloo rank {r} left no result")
            with open(path, "rb") as f:
                res.append(pickle.load(f))
        for r in res:
            check("error" not in r,
                  f"gloo rank {r['rank']}: {r.get('error', '')[-3000:]}")
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)

    print(f"  (b) 345M O2 DP, 2 ranks x 8 rows of a 16 x 1024 batch, "
          f"{DP_STEPS} steps: losses {[r['gpt_losses'] for r in res]} "
          f"(serial 16 rows {glosses}); step-1 grads (share, row) "
          f"{[r['gpt_grad_err'] for r in res]}; ranks' params equal after "
          f"each step and at the end {[r['gpt_ranks_equal'] for r in res]}; "
          f"{res[0]['gpt_s']:.1f} s for build and steps (host-staged gloo, "
          f"not a speed number)")
    print(f"  (b) overflow vote (inf in rank 1's grads only): "
          f"{[r['vote'] for r in res]}")
    errs = [tuple(float(f"{r['resnet'][k]:.3g}") for k in (
        "logits", "logits_row", "stats", "grads")) for r in res]
    def leaves(rows):
        return [(f"{a:.3g}", f"{b:.3g}", n) for a, b, n in rows]

    print(f"  (b) ResNet-50 fp32 grads, the 3 leaves furthest from the "
          f"serial run's by L2 (L2, share of max, name): DP "
          f"{leaves(res[0]['resnet']['grads_l2'])}; the serial run with "
          f"its batch's halves swapped {leaves(floor)}")
    print(f"  (b) ResNet-50 fp32 (O0) sync BN over 2 ranks x 32 at 224^2 "
          f"against serial BN at 64: losses "
          f"{[r['resnet']['losses'] for r in res]} (serial {rlosses}); "
          f"logits (share, row), running stats, worst grad leaf (L2): "
          f"{errs}")
    print(f"  (b) long context --dp 2, 345M 2 x 8192 (1 a rank), "
          f"{DP_STEPS} steps: losses {[r['long']['losses'] for r in res]} "
          f"(serial at batch 2 {llosses}, {[round(t, 1) for t in lms]} ms a "
          f"step); DP ms a step {[r['long']['ms'] for r in res]} "
          f"(host-staged gloo, not a speed number); launches per rank "
          f"{res[0]['long']['counts']}")
    group = "data parallel (b) 2 gloo ranks on the card"
    print(f"  (b) gloo on CUDA tensors: {res[0]['gloo']}")
    for r in res:
        L = r["L"]
        check(r["gpt_batch"] == 16, "the DP global batch is 16 rows")
        check_counts(r["gpt_counts"], expected_counts(
            r["gpt_counts"], DP_STEPS, pretrain_per_step(L, 2)), "dp")
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["gpt_losses"],
                                                    glosses))
        verdict(f"dp (b) 345M rank {r['rank']} losses rel", rel,
                DP_LOSS_REL, group=group)
        e, e_row = r["gpt_grad_err"]
        verdict(f"dp (b) 345M rank {r['rank']} step-1 grads", e,
                DP_GRAD[0], group=group)
        verdict(f"dp (b) 345M rank {r['rank']} step-1 grads row", e_row,
                DP_GRAD[1], group=group)
        verdict(f"dp (b) 345M rank {r['rank']} params equal across ranks",
                0 if all(r["gpt_ranks_equal"]) else 1, 0, group=group)
        v = r["vote"]
        verdict(f"dp (b) overflow vote rank {r['rank']} skips, scale "
                f"halved", 0 if (v["found_inf"] and v["unchanged"]
                                 and v["scale_after"] == v["scale"] / 2)
                else 1, 0, group=group)
        rn = r["resnet"]
        expected = dict.fromkeys(rn["counts"], 0)
        expected.update(xentropy_fwd=1, xentropy_bwd=1)
        check_counts(rn["counts"], expected, "dp")
        for key in ("logits", "stats"):
            verdict(f"dp (b) ResNet-50 sync BN rank {r['rank']} {key}",
                    rn[key], DP_RESNET_TOL[key], group=group)
        verdict(f"dp (b) ResNet-50 sync BN rank {r['rank']} worst grad "
                f"leaf L2 over the swapped serial run's", rn["grads"]
                / max(floor[0][0], 1e-6), DP_RESNET_TOL["grads"],
                group=group)
        verdict(f"dp (b) ResNet-50 sync BN rank {r['rank']} logits row",
                rn["logits_row"], DP_RESNET_TOL["logits"], group=group)
        lg = r["long"]
        check_counts(lg["counts"], expected_counts(
            lg["counts"], DP_STEPS, long_per_step(L)), "dp")
        rel = max(abs(a - b) / abs(b) for a, b in zip(lg["losses"],
                                                    llosses))
        verdict(f"dp (b) long context --dp 2 rank {r['rank']} losses rel",
                rel, DP_LOSS_REL, group=group)
        for counts in (r["gpt_counts"], rn["counts"], lg["counts"]):
            total.update({k: total.get(k, 0) + v
                          for k, v in counts.items()})
    print(f"  (b) the two ranks took {spawn_s:.1f} s, spawn to join; "
          f"card: {smi}")


def dp_phase(torch, ops, dev):
    """Phase 14: (a) :func:`dp_world1`, (b) :func:`dp_two_ranks`. Returns
    the launches of the data-parallel runs (path ``dp``: (a)'s in this
    process, (b)'s in both ranks)."""
    t0 = time.perf_counter()
    smi = nvidia_smi()
    total = {}
    dp_world1(torch, ops, dev, total)
    dp_two_ranks(torch, ops, dev, total, smi)
    print(f"  phase 14 launches {total}; phase 14 took "
          f"{time.perf_counter() - t0:.1f} s; card: {smi}")
    return total


def dp_main():
    """``python3 chip_smoke.py --dp``: phase 14 alone after the build,
    with its verdict."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from apex_tpu_torch import ops
    from apex_tpu_torch.csrc import build

    print(f"card: {nvidia_smi()}; torch {torch.__version__}")
    build.load()
    dp_phase(torch, ops, torch.device("cuda", 0))
    print_verdict()
    return 0


# ---------------------------------------------------------------------------
# phase 15: tensor parallel (NCCL at world size 1; two gloo ranks on the
# card)
# ---------------------------------------------------------------------------

#: (b)'s GPT runs: ``pretrain_gpt --tp 2`` at config 4 (8 x 1024 as 2
#: micro-batches of 4, O2, FusedAdam, full remat), the serial run on the
#: same 8 rows as its reference
TP_345M = RANKS_PRETRAIN + ["--tp", "2"]
#: 2 steps (and BERT's 1): the room phase 18 needs in the time limit
TP_STEPS = 2
#: (b)'s BERT-large: 8 x 512, O2, FusedLAMB; the padding bias from row i's
#: length 512 - 37 i
BERT_TP = dict(hidden=1024, layers=RANK_LAYERS, heads=16, seq=512, batch=8)
BERT_TP_STEPS = 1
#: (b)'s serving: ``generate_gpt`` at 345M fp32 (random weights, seed 0)
#: on prompts behind a 500-token shared prefix, monolithic, then with the
#: prefix cache and spec_k 4; the serial reference monolithic
GENERATE_SHARED = with_layers(GENERATE_345M, RANK_LAYERS) + [
    "--shared-prefix", "500"]
GENERATE_TP = GENERATE_SHARED + ["--tp", "2"]
GENERATE_TP_SPEC = ["--prefix-cache", "--spec-k", "4"]
#: limits of (b), phase 14's: losses relative; step-1 grads by share of
#: max |ref| and by row, held on the fp32-compute twins of the TP steps
#: (and SP's O2 grads against TP's); the O2 grads' worst leaf L2 at most
#: 3x the serial run's own bf16 distance from its fp32-compute twin (each
#: rank rounds its partial row-parallel products and input grads to bf16
#: before the bf16 sum, so the O2 activations part by bf16 units: 0.026 of
#: max and 0.030 by row at 345M; PERF.md)
TP_LOSS_REL = DP_LOSS_REL
TP_GRAD = DP_GRAD
TP_FLOOR = DP_RESNET_TOL["grads"]


def bert_tp_batch(torch, vocab):
    """(b)'s BERT batch on the CPU: the example's synthetic batch with row
    i padded from 512 - 37 i on (the padding bias reaches every layer)."""
    import numpy as np

    from apex_tpu_torch.examples.bert.pretrain_bert import synthetic_batch

    b, s = BERT_TP["batch"], BERT_TP["seq"]
    batch = synthetic_batch(np.random.default_rng(0), b, s, vocab,
                            torch.device("cpu"))
    for i in range(b):
        batch[1][i, s - 37 * i:] = 0
    return batch


def bert_tp_steps(torch, ops, batch, tp_axis=None, steps=BERT_TP_STEPS,
                  opt_level="O2", o2_values=False, **config):
    """BERT-large O2 FusedLAMB (``pretrain_bert.build`` at :data:`BERT_TP`)
    ``steps`` steps on ``batch``: (trainer, losses, first step's grads
    over the loss scale, launches). With ``tp_axis`` the model is built on it and the
    step votes on overflow over it and hands FusedLAMB the sharded flags,
    so its norms are the whole tensors'; ``config`` goes into the
    example's config, ``opt_level`` into its ``build``; ``o2_values``
    rounds the params O2 casts to bf16 through bf16 (their O2 values in
    the O0 step's fp32)."""
    from apex_tpu_torch.examples.bert import pretrain_bert
    from apex_tpu_torch.parallel import collectives

    real = pretrain_bert.BertConfig
    if tp_axis is not None:
        config = dict(config, axis=tp_axis)
    if config:
        pretrain_bert.BertConfig = lambda **c: real(**dict(c, **config))
    try:
        trainer = pretrain_bert.build(**BERT_TP, opt_level=opt_level)
    finally:
        pretrain_bert.BertConfig = real
    model, mp_opt, st = trainer.model, trainer.mp_opt, trainer.opt_state
    if o2_values:
        from apex_tpu_torch.precision import name_is_norm

        with torch.no_grad():
            for name, p in model.named_parameters():
                if not name_is_norm(name):
                    p.copy_(p.to(torch.bfloat16).float())
    kw = {}
    if tp_axis is not None:
        kw = dict(found_inf_reducer=lambda f: collectives.found_inf_max(
            f, tp_axis), sharded=model.sharded_flags(), axis=tp_axis)
    batch = [t.to(model.device) for t in batch]
    grads, losses = [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for _ in range(steps):
        loss = model.loss(*batch)
        mp_opt.scale_loss(loss, st).backward()
        if not grads:
            grads.extend(p.grad.detach() / st.scaler.loss_scale
                         for p in model.parameters())
        m = mp_opt.step(st, model, **kw)
        check(not m["found_inf"], "no BERT TP step skipped")
        losses.append(float(loss))
    torch.cuda.synchronize()
    return trainer, losses, grads, ops.launch_counts()


def bert_per_step(L):
    """Phase 8's launches of one BERT step (#1 2L with the recompute)."""
    return {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "layer_norm_fwd": 4 * L + 2,
            "layer_norm_bwd": 2 * L + 2}


def full_grads(torch, model, grads):
    """Local grads (``parameters()`` order) gathered to full shape over the
    model axis, in the same order: the serial model's."""
    from apex_tpu_torch._params import module_tree, tensors_of_tree
    from apex_tpu_torch.transformer import tensor_parallel as tp

    tree = tp.gather_params(module_tree(model, grads, device=grads[0].device),
                            model.specs(), model.cfg.axis)
    return tensors_of_tree(model, tree)


def leaf_errs(torch, model, got, ref):
    """Per parameter of ``model`` (its names): the share of max |ref|, the
    row error and the L2 distance of ``got`` from ``ref`` (grad lists in
    ``parameters()`` order, full shapes)."""
    out = []
    for (name, _), g, r in zip(model.named_parameters(), got, ref):
        r = r.to(g.device)
        out.append((name, rel_err(g, r), row_err(g if g.dim() else g[None],
                                                 r if r.dim() else r[None]),
                    l2_err(g, r)))
    return out


def worst_leaves(errs, k=3):
    """The ``k`` leaves of :func:`leaf_errs` furthest by share, by row and
    by L2."""
    return {key: [(e[0], float(f"{e[i]:.3g}"))
                  for e in sorted(errs, key=lambda e: -e[i])[:k]]
            for i, key in ((1, "share"), (2, "row"), (3, "l2"))}


def replicated_equal(torch, model, snaps):
    """Per snapshot: whether the model's replicated leaves are bit-identical
    on every rank of its axis."""
    from apex_tpu_torch.parallel import collectives

    flags = model.sharded_flags()
    out = []
    for snap in snaps:
        fp = param_fingerprint(torch, [p for p, f in zip(snap, flags)
                                       if not f])
        both = collectives.all_gather(fp, model.cfg.axis, tiled=False)
        out.append(all(torch.equal(both[0], x) for x in both[1:]))
    return out


def tp_fp32_decode_heads(torch, ops, dev, heads=8):
    """#9 and #10 fp32 at the generate pools' shapes with ``heads`` heads
    and kv heads (a tp = 2 rank's share of 345M's 16): each against its
    plain version and its time, the plain version's and the bound (times
    only: the split count is the 16-head rule's)."""
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    b, _, _, blk, d, nb, mb, lengths = DECODE_MAIN
    q, kp, vp, tables, lens = _decode_inputs(
        torch, dev, gen, b, heads, heads, blk, d, nb, mb, f32, lengths)
    err = rel_err(ops.flash_decode(q, kp, vp, tables, lens),
                  ops.paged_attention_reference(q, kp, vp, tables, lens))
    bms, by = bound(sum(lengths) * heads * d * 4 * 2 + 2 * b * heads * d * 4
                    + b * mb * 4 + b * 4, 4 * heads * d * sum(lengths),
                    "float32")
    out["flash_decode fp32 decode h8"] = dict(
        ms=time_ms(lambda: ops.flash_decode(q, kp, vp, tables, lens)),
        plain_ms=time_ms(lambda: ops.paged_attention_reference(
            q, kp, vp, tables, lens), 5), bound_ms=bms, bound_by=by,
        max_rel_err=err)
    for label, shape in (("chunk", DECODE_CHUNK), ("verify", DECODE_VERIFY)):
        b, _, _, kq, blk, d, nb, mb, lengths = shape
        _, kp, vp, tables, lens = _decode_inputs(
            torch, dev, gen, b, heads, heads, blk, d, nb, mb, f32, lengths)
        q = torch.randn(b, heads, kq, d, device=dev, generator=gen)
        err = rel_err(ops.flash_decode_multi(q, kp, vp, tables, lens),
                      ops.paged_attention_multi_reference(q, kp, vp, tables,
                                                          lens))
        bms, by = multi_bound(b, heads, heads, kq, d, 4, lengths, None, blk,
                              mb, "float32")
        out[f"flash_decode_multi fp32 {label} h8"] = dict(
            ms=time_ms(lambda: ops.flash_decode_multi(q, kp, vp, tables,
                                                      lens)),
            plain_ms=time_ms(lambda: ops.paged_attention_multi_reference(
                q, kp, vp, tables, lens), 5), bound_ms=bms, bound_by=by,
            max_rel_err=err)
    for label, t in out.items():
        verdict(f"{label} against its plain version", t["max_rel_err"],
                5e-5, group="tensor parallel: 8 local heads")
        print(f"  {label}: share of max |ref| {t['max_rel_err']:.3g} (tol "
              f"5e-05); kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} "
              f"ms ({t['bound_by']}), plain {t['plain_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return out


def wait_for_references(torch, ref_dir, timeout_s=600):
    """The parent's serial references, once it has written them."""
    path = os.path.join(ref_dir, "ref.pt")
    end = time.monotonic() + timeout_s
    while not os.path.exists(path):
        check(time.monotonic() < end, "the serial references never came")
        time.sleep(0.5)
    return torch.load(path)


def _tp_rank(rank, world, port, ref_dir, out_path):
    """One gloo rank of phase 15 (b) on the card: every case in turn; the
    errors and counts go back to the parent in ``out_path``."""
    import pickle
    import traceback
    import types

    import torch

    sys.path.insert(0, HERE)
    res = {"rank": rank}
    try:
        from apex_tpu_torch import checkpoint, ops
        from apex_tpu_torch.examples.gpt import pretrain_gpt
        from apex_tpu_torch.parallel import mesh, multiproc
        import torch.distributed as dist

        multiproc.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                         backend="gloo", timeout_s=600)
        dev = torch.device("cuda", 0)
        probe = {}
        for name, fn in (
                ("all_reduce bf16", lambda: dist.all_reduce(
                    torch.ones(4, dtype=torch.bfloat16, device=dev))),
                ("all_gather bf16", lambda: dist.all_gather(
                    [torch.empty(4, dtype=torch.bfloat16, device=dev)
                     for _ in range(world)],
                    torch.ones(4, dtype=torch.bfloat16, device=dev))),
                ("reduce_scatter_tensor bf16",
                 lambda: dist.reduce_scatter_tensor(
                     torch.empty(4, dtype=torch.bfloat16, device=dev),
                     torch.ones(4 * world, dtype=torch.bfloat16,
                                device=dev))),
                ("reduce_scatter_tensor fp32",
                 lambda: dist.reduce_scatter_tensor(
                     torch.empty(4, device=dev),
                     torch.ones(4 * world, device=dev)))):
            try:
                fn()
                probe[name] = "ok"
            except RuntimeError as e:
                probe[name] = f"refused: {str(e)[:120]}"
        res["gloo"] = probe
        mesh.initialize_model_parallel(tensor_model_parallel_size=world)

        # 1. pretrain_gpt --tp 2, then its checkpoint and the next loss
        t0 = time.perf_counter()
        bench, losses, snaps, grads, counts = pretrain_steps(
            torch, ops, TP_345M, TP_STEPS, snap=True)
        res["L"] = bench.cfg.num_layers
        res["heads"] = bench.model.layers[0].qkv.kernel.shape[1] // (
            3 * bench.cfg.head_dim)
        ref = wait_for_references(torch, ref_dir)
        tp_grads = full_grads(torch, bench.model, grads)
        res["gpt"] = {"losses": losses, "counts": counts,
                      "errs": leaf_errs(torch, bench.model, tp_grads,
                                        ref["gpt_grads"]),
                      "ranks_equal": replicated_equal(torch, bench.model,
                                                      snaps)}
        del grads, snaps
        ck_dir = os.path.join(ref_dir, "ckpt")
        checkpoint.save_checkpoint(
            ck_dir, TP_STEPS, pretrain_gpt.train_state(bench, device=dev),
            specs=pretrain_gpt.train_state_specs(bench))
        dist.barrier()
        args = pretrain_gpt.parse_args(TP_345M)
        toks, tgts = next(pretrain_gpt.batches(args, bench.batch))
        with torch.no_grad():
            res["gpt"]["next_loss"] = float(sum(
                bench.model.loss(t, g) for t, g in zip(
                    toks.chunk(args.num_microbatches),
                    tgts.chunk(args.num_microbatches)))
                / args.num_microbatches)
        res["gpt"]["s"] = time.perf_counter() - t0
        del bench
        gc.collect()
        torch.cuda.empty_cache()
        # its fp32-compute twin, one step: the parallel math without bf16
        # rounding, against the serial fp32-compute grads
        bench, _, _, grads, counts = pretrain_steps(
            torch, ops, TP_345M, 1, compute_dtype=torch.float32)
        res["gpt_f32"] = {"counts": counts, "errs": leaf_errs(
            torch, bench.model, full_grads(torch, bench.model, grads),
            ref["gpt_grads_f32"])}
        del bench, grads
        gc.collect()
        torch.cuda.empty_cache()

        # 2. the same under sequence parallelism
        t0 = time.perf_counter()
        bench, losses, snaps, grads, counts = pretrain_steps(
            torch, ops, TP_345M, TP_STEPS, snap=True,
            sequence_parallel=True)
        check(bench.model._sp, "the SP model is sequence parallel")
        sp_grads = full_grads(torch, bench.model, grads)
        res["sp"] = {"losses": losses, "counts": counts,
                     "errs": leaf_errs(torch, bench.model, sp_grads,
                                       ref["gpt_grads"]),
                     "vs_tp": grads_err(torch, sp_grads, tp_grads),
                     "ranks_equal": replicated_equal(torch, bench.model,
                                                     snaps),
                     "s": time.perf_counter() - t0}
        del bench, grads, snaps, sp_grads, tp_grads
        gc.collect()
        torch.cuda.empty_cache()

        # 3. BERT-large at tp 2
        t0 = time.perf_counter()
        trainer, losses, grads, counts = bert_tp_steps(
            torch, ops, ref["bert_batch"], tp_axis=mesh.AXIS_MODEL)
        res["bert"] = {"losses": losses, "counts": counts,
                       "errs": leaf_errs(torch, trainer.model, full_grads(
                           torch, trainer.model, grads), ref["bert_grads"]),
                       "s": time.perf_counter() - t0}
        del trainer, grads
        gc.collect()
        torch.cuda.empty_cache()
        trainer, _, grads, counts = bert_tp_steps(
            torch, ops, ref["bert_batch"], tp_axis=mesh.AXIS_MODEL, steps=1,
            compute_dtype=torch.float32)
        res["bert_f32"] = {"counts": counts, "errs": leaf_errs(
            torch, trainer.model, full_grads(torch, trainer.model, grads),
            ref["bert_grads_f32"])}
        del trainer, grads
        gc.collect()
        torch.cuda.empty_cache()

        # 4. generate_gpt --tp 2, monolithic, then prefix cache + spec_k 4;
        # each token against the full-context argmax of this TP model and
        # the serial engine's tokens
        serial = {rid: types.SimpleNamespace(tokens=t)
                  for rid, t in ref["generate"].items()}
        res["generate"] = {}
        for label, extra in (("gen", []), ("gen_spec", GENERATE_TP_SPEC)):
            out, counts = generate_run(torch, ops, GENERATE_TP + extra,
                                       f"(b) rank {rank} generate --tp 2 "
                                       f"{label}")
            mesh.initialize_model_parallel(tensor_model_parallel_size=world)
            eng = out["engine"]
            n = check_greedy(torch, out["model"], out["results"],
                             f"generate --tp 2 {label} rank {rank}",
                             ref=serial)
            res["generate"][label] = {
                "counts": counts, "checked": n, "kv_heads":
                    eng.kv_config.kv_heads, "stats": eng.stats,
                "expected": serve_expected(counts, eng, res["L"], 6),
                "tokens_s": out["latency"]["tokens_s"]}
            del out, eng
            gc.collect()
            torch.cuda.empty_cache()
    except Exception:  # noqa: BLE001 - reported by the parent
        res["error"] = traceback.format_exc()
    finally:
        try:
            from apex_tpu_torch.parallel import multiproc

            multiproc.shutdown()
        except Exception as e:  # noqa: BLE001
            res.setdefault("error", f"shutdown: {e}")
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def tp_world1(torch, ops, dev, total):
    """(a): NCCL at world size 1 in this process: ``pretrain_gpt`` on the
    model axis at tp = 1 (345M, 8 x 1024, O2), 3 steps, its losses and
    params after every step bit for bit the serial run's. Returns the
    serial run's losses and first step's grads ((b)'s references)."""
    from apex_tpu_torch.parallel import multiproc

    _, slosses, ssnaps, sgrads, _ = pretrain_steps(
        torch, ops, RANKS_PRETRAIN, TP_STEPS, snap=True)
    sgrads = [g.cpu() for g in sgrads]
    gc.collect()
    torch.cuda.empty_cache()
    check(multiproc.initialize_distributed(
        f"127.0.0.1:{free_port()}", 1, 0), "NCCL world 1 initialized")
    import torch.distributed as dist

    backend = dist.get_backend()
    try:
        bench, losses, snaps, _, counts = pretrain_steps(
            torch, ops, RANKS_PRETRAIN, TP_STEPS, snap=True, axis="model")
        check(bench.cfg.axis == "model", "(a) built on the model axis")
        L = bench.cfg.num_layers
        check_counts(counts, expected_counts(counts, TP_STEPS,
                                             pretrain_per_step(L, 2)), "tp")
        total.update({k: total.get(k, 0) + v for k, v in counts.items()})
        same = [losses == slosses] + [
            all(torch.equal(a, b) for a, b in zip(s, t))
            for s, t in zip(snaps, ssnaps)]
        print(f"  (a) pretrain_gpt 345M O2 on the model axis at tp 1 over "
              f"{backend} (world size 1), {TP_STEPS} steps of {bench.batch} "
              f"x 1024: losses {losses} (serial {slosses}); losses and "
              f"params after each step bit-identical to the serial run: "
              f"{same}")
        verdict("tp (a) 345M at tp 1 bit for bit the serial run",
                0 if all(same) else 1, 0,
                group="tensor parallel (a) NCCL world 1")
        del bench, snaps, ssnaps
    finally:
        multiproc.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return slosses, sgrads


def tp_spawn(ref_dir, world=2):
    """Start (b)'s gloo ranks: ``(processes, result paths)``."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(ref_dir, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_tp_rank,
                         args=(r, world, port, ref_dir, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs


def tp_two_ranks(torch, ops, dev, total, smi, slosses, sgrads, ref_dir,
                 procs, outs):
    """(b): two gloo ranks on the one card (host-staged; correctness only),
    spawned before (a), every case in turn against the serial references
    made here (they wait for ``ref.pt``)."""
    import pickle

    from apex_tpu_torch.examples.gpt import pretrain_gpt

    t_spawn = time.perf_counter()
    t0 = time.perf_counter()
    from apex_tpu_torch.models import BertConfig

    bert_batch = bert_tp_batch(torch, BertConfig().vocab_size)
    _, blosses, bgrads, _ = bert_tp_steps(torch, ops, bert_batch)
    bgrads = [g.cpu() for g in bgrads]
    gc.collect()
    torch.cuda.empty_cache()
    # the rounding floor of the bf16 grads: the serial runs' step-1
    # grads in fp32 compute on the same bf16 params
    # (the fp32-compute twins' references too)
    floor = {}
    _, _, _, fgrads, _ = pretrain_steps(
        torch, ops, RANKS_PRETRAIN, 1, compute_dtype=torch.float32)
    gpt_f32 = [f.cpu() for f in fgrads]
    floor["gpt"] = [l2_err(f, g) for f, g in zip(gpt_f32, sgrads)]
    _, _, fgrads, _ = bert_tp_steps(torch, ops, bert_batch, steps=1,
                                    compute_dtype=torch.float32)
    bert_f32 = [f.cpu() for f in fgrads]
    floor["bert"] = [l2_err(f, g) for f, g in zip(bert_f32, bgrads)]
    del fgrads
    gc.collect()
    torch.cuda.empty_cache()
    gen, _ = generate_run(torch, ops, GENERATE_SHARED,
                          "(b) serial generate 345M fp32")
    ref = {"gpt_grads": sgrads, "bert_batch": bert_batch,
           "bert_grads": bgrads, "gpt_grads_f32": gpt_f32,
           "bert_grads_f32": bert_f32,
           "generate": {rid: r.tokens
                        for rid, r in gen["results"].items()}}
    del gen
    gc.collect()
    torch.cuda.empty_cache()
    torch.save(ref, os.path.join(ref_dir, "ref.tmp"))  # whole, or absent
    os.replace(os.path.join(ref_dir, "ref.tmp"),
               os.path.join(ref_dir, "ref.pt"))
    del ref
    print(f"  (b) serial references (BERT-large 8 x 512 O2 FusedLAMB, "
          f"a 345M fp32 generate; 345M 8 x 1024 from (a)) in "
          f"{time.perf_counter() - t0:.1f} s")

    end = time.monotonic() + 600
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    check(not alive, "the two gloo ranks finished within 600 s")
    res = []
    for r, path in enumerate(outs):
        check(os.path.exists(path), f"gloo rank {r} left no result")
        with open(path, "rb") as f:
            res.append(pickle.load(f))
    for r in res:
        check("error" not in r,
              f"gloo rank {r['rank']}: {r.get('error', '')[-3000:]}")
    spawn_s = time.perf_counter() - t_spawn

    # the tp 2 checkpoint resumed serial: its first loss (batch 0)
    t0 = time.perf_counter()
    resumed = pretrain_gpt.run(RANKS_PRETRAIN + [
        "--save-dir", os.path.join(ref_dir, "ckpt"), "--steps", "1",
        "--save-every", "1000000"])
    check(resumed["start"] == TP_STEPS, "resumed at the tp 2 save's step")
    resumed_loss = resumed["losses"][0]
    resume_s = time.perf_counter() - t0
    del resumed
    gc.collect()
    torch.cuda.empty_cache()

    group = "tensor parallel (b) 2 gloo ranks on the card"
    print(f"  (b) gloo on CUDA tensors: {res[0]['gloo']}")
    for r in res:
        for key in ("gpt", "sp", "bert", "gpt_f32", "bert_f32"):
            x = r[key]
            x["grad_err"] = (max(e[1] for e in x["errs"]),
                             max(e[2] for e in x["errs"]))
        for key in ("gpt", "sp", "bert"):  # L2 over the bf16 rounding floor
            fl = floor["bert" if key == "bert" else "gpt"]
            x = r[key]
            x["floor_ratio"] = sorted(
                ((e[3] / max(f, 1e-12), e[0]) for e, f in zip(x["errs"], fl)),
                reverse=True)[:3]
    for key, label in (("gpt", "pretrain_gpt --tp 2"),
                       ("sp", "pretrain_gpt --tp 2, sequence parallel"),
                       ("bert", "BERT-large at tp 2, 8 x 512 with padding, "
                                "O2 FusedLAMB")):
        x, f32 = res[0][key], res[0].get(f"{key}_f32")
        print(f"  (b) {label}: losses {[r[key]['losses'] for r in res]} "
              f"(serial {blosses if key == 'bert' else slosses}); O2 step-1 "
              f"grads gathered, worst (share, row) "
              f"{[r[key]['grad_err'] for r in res]}, leaves furthest "
              f"{worst_leaves(x['errs'])}; L2 over the serial run's "
              f"fp32-compute distance, worst "
              f"{[(round(v, 3), n) for v, n in x['floor_ratio']]}; "
              f"{x['s']:.1f} s (host-staged gloo, not a speed number)")
        if f32 is not None:
            print(f"  (b) {label}, its fp32-compute twin (1 step) against "
                  f"the serial fp32-compute grads: worst (share, row) "
                  f"{[r[key + '_f32']['grad_err'] for r in res]}, leaves "
                  f"furthest {worst_leaves(f32['errs'])}")
        if key == "sp":
            print(f"  (b) {label}: O2 step-1 grads against the TP run's "
                  f"(share, row) {[r['sp']['vs_tp'] for r in res]}")
        if key != "bert":
            print(f"  (b) {label}: replicated leaves equal across the ranks "
                  f"after each step {[r[key]['ranks_equal'] for r in res]}")
    print(f"  (b) the serial runs' bf16 grads' L2 distance from their "
          f"fp32-compute twins', largest: gpt "
          f"{sorted((round(v, 4) for v in floor['gpt']), reverse=True)[:3]}, "
          f"bert {sorted((round(v, 4) for v in floor['bert']), reverse=True)[:3]}")
    print(f"  (b) checkpoint at tp 2 after {TP_STEPS} steps, resumed serial "
          f"in {resume_s:.1f} s: next loss on batch 0 {resumed_loss} (tp 2 "
          f"ranks {[r['gpt']['next_loss'] for r in res]})")
    for label in ("gen", "gen_spec"):
        g = [r["generate"][label] for r in res]
        print(f"  (b) generate_gpt --tp 2 {label}: {[x['checked'] for x in g]}"
              f" tokens equal the full-context argmax and the serial "
              f"engine's; kv heads a rank {g[0]['kv_heads']}; stats "
              f"{g[0]['stats']}; {[round(x['tokens_s'], 1) for x in g]} "
              f"tokens/s (host-staged gloo)")
    print(f"  (b) the two ranks took {spawn_s:.1f} s from (a)'s end to their "
          f"join, spawned before (a); card: {smi}")
    for r in res:
        L, rk = r["L"], r["rank"]
        check(r["heads"] == 8, "8 local heads a rank")
        for key in ("gpt", "sp", "bert", "gpt_f32", "bert_f32"):
            x = r[key]
            bert = key.startswith("bert")
            steps = (1 if key.endswith("f32")
                     else BERT_TP_STEPS if bert else TP_STEPS)
            check_counts(x["counts"], expected_counts(
                x["counts"], steps,
                bert_per_step(L) if bert else pretrain_per_step(L, 2)), "tp")
            if key.endswith("f32"):
                e, e_row = x["grad_err"]
                verdict(f"tp (b) {key} rank {rk} step-1 grads", e,
                        TP_GRAD[0], group=group)
                verdict(f"tp (b) {key} rank {rk} step-1 grads row", e_row,
                        TP_GRAD[1], group=group)
                continue
            ref_losses = blosses if bert else slosses
            rel = max(abs(a - b) / abs(b) for a, b in zip(x["losses"],
                                                        ref_losses))
            verdict(f"tp (b) {key} rank {rk} losses rel", rel, TP_LOSS_REL,
                    group=group)
            verdict(f"tp (b) {key} rank {rk} worst grad leaf L2 over the "
                    f"serial fp32-compute distance", x["floor_ratio"][0][0],
                    TP_FLOOR, group=group)
            if not bert:
                verdict(f"tp (b) {key} rank {rk} replicated leaves equal "
                        f"across the ranks",
                        0 if all(x["ranks_equal"]) else 1, 0, group=group)
        e, e_row = r["sp"]["vs_tp"]
        verdict(f"tp (b) sp rank {rk} step-1 grads against tp's", e,
                TP_GRAD[0], group=group)
        verdict(f"tp (b) sp rank {rk} step-1 grads against tp's row", e_row,
                TP_GRAD[1], group=group)
        verdict(f"tp (b) checkpoint at tp 2 resumed serial, rank {rk} next "
                f"loss rel", abs(resumed_loss - r["gpt"]["next_loss"])
                / abs(resumed_loss), TP_LOSS_REL, group=group)
        for label, g in r["generate"].items():
            check(g["kv_heads"] == 8, "the TP engine's pools hold 8 heads")
            check_counts(g["counts"], g["expected"], "tp")
            verdict(f"tp (b) generate --tp 2 {label} rank {rk} tokens "
                    f"checked", 0 if g["checked"] else 1, 0, group=group)
        for c in ([r[k]["counts"] for k in ("gpt", "gpt_f32", "sp", "bert",
                                            "bert_f32")]
                  + [g["counts"] for g in r["generate"].values()]):
            total.update({k: total.get(k, 0) + v for k, v in c.items()})
    check(res[0]["generate"]["gen_spec"]["stats"]["mean_accepted_len"] > 1,
          "generate --tp 2 accepted drafts")


def tp_phase(torch, ops, dev):
    """Phase 15: (a) :func:`tp_world1`, (b) :func:`tp_two_ranks`, #9 / #10
    fp32 at 8 local heads. Returns the launches of the tensor-parallel
    runs (path ``tp``: (a)'s in this process, (b)'s in both ranks) and the
    8-head times."""
    import shutil

    t0 = time.perf_counter()
    smi = nvidia_smi()
    total = {}
    ref_dir = os.path.join(HERE, "build", "tp_check")
    shutil.rmtree(ref_dir, ignore_errors=True)
    os.makedirs(ref_dir)
    procs = []
    try:
        # the ranks start first: their first case runs while this process
        # makes (a) and the serial references
        procs, outs = tp_spawn(ref_dir)
        slosses, sgrads = tp_world1(torch, ops, dev, total)
        tp_two_ranks(torch, ops, dev, total, smi, slosses, sgrads, ref_dir,
                     procs, outs)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(ref_dir, ignore_errors=True)
    heads8 = tp_fp32_decode_heads(torch, ops, dev)
    print(f"  phase 15 launches {total}; phase 15 took "
          f"{time.perf_counter() - t0:.1f} s; card: {smi}")
    return total, heads8


def tp_main():
    """``python3 chip_smoke.py --tp``: phase 15 alone after the build, with
    its verdict."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from apex_tpu_torch import ops
    from apex_tpu_torch.csrc import build

    print(f"card: {nvidia_smi()}; torch {torch.__version__}")
    build.load()
    tp_phase(torch, ops, torch.device("cuda", 0))
    print_verdict()
    return 0



# ---------------------------------------------------------------------------
# phase 16: ZeRO 1/2/3, the quantized wires and host offload (NCCL at world
# size 1; two gloo ranks on the card)
# ---------------------------------------------------------------------------

#: 2 steps: the room phase 18 needs in the script's time limit
ZERO_STEPS = 2
#: (a)'s variants of RANKS_PRETRAIN at world size 1, each bit for bit the
#: serial run: at n = 1 the scatter and the gather are identities and Adam
#: is elementwise on the chunks
ZERO_WORLD1 = (
    ("ZeRO-1", ["--zero-level", "1"]),
    ("ZeRO-2", ["--zero-level", "2"]),
    ("ZeRO-3", ["--zero-level", "3"]),
    ("ZeRO-3 prefetch 1", ["--zero-level", "3", "--zero3-prefetch", "1",
                           "--unroll"]),
    ("offload 2 buckets", ["--zero-level", "2", "--offload-optimizer",
                           "--offload-buckets", "2"]),
)
#: (b)'s wire and offload cases: 345M width at 4 layers, the DP batch
ZERO_WIRE_LAYERS = 4
#: limits of (b): params after each step against the DP run (and ZeRO-3's
#: against ZeRO-2's) by share of max |ref| and by row: phase 14's grad
#: limits (the DP run sums bf16 grads in bf16, ZeRO sums their fp32
#: unscaled values in fp32; Adam moves an element by about lr whatever
#: its grad, so a near-zero grad rounded the other way flips a step);
#: the quantized wires track the fp32 wire within the JAX tests' band
#: (``tests/test_quantized_comm.py:213``: params within 5e-2) and the
#: losses within phase 14's relative limit
ZERO_LOSS_REL = DP_LOSS_REL
ZERO_WIRE_BAND = 5e-2
#: two runs whose reductions round differently (DP sums bf16 grads in
#: bf16, ZeRO-2 their unscaled fp32 values in fp32, ZeRO-3 in bf16 at its
#: gather's wire): step 1's reduced grads by share of max and by row
#: (phase 14's DP limits); the params after step 1, where Adam's step is
#: lr times the grad's sign, at most 2% of a leaf's elements (one of a
#: leaf under 200) further apart than lr / 5: a grad whose two ranks'
#: halves cancel within a bf16 unit takes either sign, about 2**-8 of
#: random-signed halves (0.39% for ZeRO-3 against ZeRO-2 on an H100),
#: where a chunk in the wrong place moves about half of a leaf; after
#: every step none further than 2.5 lr a step (Adam's m / sqrt(v)
#: normalizes a near-zero grad's rounding noise into a full step, so from
#: step 2 on the share is only reported: 6-20% of a random-init 345M's
#: small leaves on an H100, PERF.md); each distance beyond one bf16 unit of
#: the reference where the param is bf16
ZERO_GRAD = DP_GRAD
ZERO_DRIFT = (0.02, 1.0)


def zero_argv(base, flags, layers=None):
    argv = list(base) + list(flags)
    if layers is not None:
        i = argv.index("--layers")
        argv[i + 1] = str(layers)
    return argv


def zero_steps(torch, ops, argv, steps, snap=True):
    """:func:`pretrain_steps` of a ZeRO (or DP) argv from a clean
    allocator: (bench, losses, each step's full params on the host,
    launches, the run's peak bytes above its start, step 1's reduced
    unscaled fp32 grads on the host: ZeRO's chunks gathered, DP's
    all-reduced grads)."""
    from apex_tpu_torch.amp.frontend import _flat_shapes
    from apex_tpu_torch.optimizers.distributed import gather_leaf

    first = []

    def hook(bench):
        mp = bench.mp_opt
        if mp.zero_axis is None:
            return
        real = mp._metrics

        def metrics(state, found_inf, g_chunks, base):
            if not first:
                first.append([c.detach().clone() for c in g_chunks])
            return real(state, found_inf, g_chunks, base)

        mp._metrics = metrics

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bench, losses, snaps, grads, counts = pretrain_steps(
        torch, ops, argv, steps, snap=snap, snap_to="cpu", hook=hook)
    peak = torch.cuda.max_memory_allocated() - base
    if first:
        shapes = ([sh.shape for sh in _flat_shapes(bench.zero3.meta)]
                  if bench.zero3 is not None else
                  [p.shape for p in bench.model.parameters()])
        grads = [gather_leaf(c, sh, torch.float32, "data").cpu()
                 for c, sh in zip(first[0], shapes)]
    else:  # DP: the scaled all-reduced grads, at step 1's scale 2**16
        grads = [g.float().cpu() / 2.0 ** 16 for g in grads]
    return bench, losses, snaps, counts, peak, grads


def params_drift(torch, got, ref, lr, steps):
    """(the worst leaf's share of elements further than lr / 5 apart, the
    worst element's distance over 2.5 lr x ``steps``), each distance less
    one bf16 unit (2**-7 |ref|) of a bf16 reference: the
    :data:`ZERO_DRIFT` measures of two param lists."""
    share, worst = 0.0, 0.0
    for a, b in zip(got, ref):
        d = (a.float() - b.float()).abs()
        if b.dtype == torch.bfloat16:
            d = (d - b.float().abs() * 2.0 ** -7).clamp_min(0)
        n = int((d > lr / 5).sum())
        share = max(share, 0.0 if n <= (1 if d.numel() < 200 else 0)
                    else n / d.numel())
        worst = max(worst, float(d.max()) / (2.5 * lr * steps))
    return share, worst


def state_fingerprint(torch, st):
    """:func:`param_fingerprint` of a ZeRO state's masters, moments and
    residual."""
    ts = list(st.master) + list(st.inner.exp_avg) + list(
        st.inner.exp_avg_sq)
    if st.residual is not None:
        ts += [e for e in st.residual["err"] if e.numel()]
    return param_fingerprint(torch, ts)


def zero_bench_legs(torch, ops):
    """``BENCH_ZERO=1``'s O2 step and the bench's own, 2 steps each on the
    fixed batch. The ZeRO leg gathers the params at bf16, as the
    reference's does (``bench.py:355``), so its fp32 LayerNorm params are
    the bf16 rounding of their masters: (step 1's loss bit for bit, every
    param after step 1 bit for bit that of the bench's step -- the fp32
    ones at their bf16 rounding, step 2's loss relative error, the two
    runs' losses, the ZeRO leg's launches)."""
    from apex_tpu_torch import bench as bench_mod

    out = {}
    for label, env in (("plain", None), ("zero", "1")):
        if env:
            os.environ["BENCH_ZERO"] = env
        try:
            gc.collect()
            torch.cuda.empty_cache()
            b = bench_mod.build("O2")
        finally:
            os.environ.pop("BENCH_ZERO", None)
        toks, tgts = bench_mod.fixed_batch(b)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        losses, first = [], None
        for _ in range(2):
            loss, m = b.step(toks, tgts)
            check(not m["found_inf"], "no bench step skipped")
            losses.append(float(loss))
            if first is None:
                first = [p.detach().clone() for p in b.model.parameters()]
        torch.cuda.synchronize()
        out[label] = (losses, first, ops.launch_counts(), b.mp_opt.zero_axis)
        del b
    check(out["zero"][3] == "data", "BENCH_ZERO built the ZeRO leg")
    (pl, pp, _, _), (zl, zp, counts, _) = out["plain"], out["zero"]
    same = all(torch.equal(z, p if p.dtype == torch.bfloat16 else
                           p.to(torch.bfloat16).to(p.dtype))
               for z, p in zip(zp, pp))
    return (zl[0] == pl[0], same, abs(zl[1] - pl[1]) / abs(pl[1]), pl, zl,
            counts)


def zero_world1(torch, ops, dev, total, smi):
    """(a): NCCL at world size 1 in this process: ``pretrain_gpt --zero*``
    at 345M (RANKS_PRETRAIN), each variant of :data:`ZERO_WORLD1` 3 O2
    steps, its losses and params after every step bit for bit the serial
    run's; then ``BENCH_ZERO=1``'s step against the bench's."""
    from apex_tpu_torch.parallel import multiproc

    _, slosses, ssnaps, _, _ = pretrain_steps(torch, ops, RANKS_PRETRAIN,
                                              ZERO_STEPS, snap=True)
    check(multiproc.initialize_distributed(
        f"127.0.0.1:{free_port()}", 1, 0), "NCCL world 1 initialized")
    import torch.distributed as dist

    backend = dist.get_backend()
    group = "ZeRO (a) NCCL world 1"
    try:
        for label, flags in ZERO_WORLD1:
            t0 = time.perf_counter()
            bench, losses, snaps, counts, peak, _ = zero_steps(
                torch, ops, RANKS_PRETRAIN + flags, ZERO_STEPS)
            L = bench.cfg.num_layers
            check_counts(counts, expected_counts(
                counts, ZERO_STEPS, pretrain_per_step(L, 2)), "zero")
            total.update({k: total.get(k, 0) + v for k, v in counts.items()})
            same = [losses == slosses] + [
                all(torch.equal(a.to(b.device), b) for a, b in zip(s, t))
                for s, t in zip(snaps, ssnaps)]
            print(f"  (a) pretrain_gpt 345M O2 {' '.join(flags)} on "
                  f"{backend} at world size 1, {ZERO_STEPS} steps of "
                  f"{bench.batch} x 1024: losses {losses}; losses and "
                  f"params after each step bit-identical to the serial "
                  f"run's {slosses}: {same}; {time.perf_counter() - t0:.1f} s")
            verdict(f"zero (a) {label} world 1 bit for bit the serial run",
                    0 if all(same) else 1, 0, group=group)
            del bench, snaps
        del ssnaps
        gc.collect()
        torch.cuda.empty_cache()
        loss1, same, rel2, plain, zl, counts = zero_bench_legs(torch, ops)
        total.update({k: total.get(k, 0) + v for k, v in counts.items()})
        print(f"  (a) the bench's O2 step (345M, 8 x 1024, 2 steps): losses "
              f"{plain}; with BENCH_ZERO=1 {zl}: step 1's loss bit for bit "
              f"{loss1}, the params after it bit for bit (the fp32 "
              f"LayerNorm params at the bf16 gather's rounding) {same}, "
              f"step 2's loss rel {rel2:.3g}")
        verdict("zero (a) BENCH_ZERO=1 step 1 bit for bit the bench's",
                0 if (loss1 and same) else 1, 0, group=group)
        verdict("zero (a) BENCH_ZERO=1 step 2 loss rel", rel2,
                ZERO_LOSS_REL, group=group)
    finally:
        multiproc.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (a) card: {smi}")


def _zero_rank(rank, world, port, out_path):
    """One gloo rank of phase 16 (b) on the card: every case in turn; the
    errors, counts and peak memory go back to the parent."""
    import pickle
    import traceback

    import torch

    sys.path.insert(0, HERE)
    res = {"rank": rank, "memory": {}, "counts": []}
    try:
        from apex_tpu_torch import ops
        from apex_tpu_torch.parallel import collectives, mesh, multiproc
        from apex_tpu_torch.transformer.amp import MeshGradScaler
        import torch.distributed as dist

        multiproc.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                         backend="gloo", timeout_s=600)
        dev = torch.device("cuda", 0)
        probe = {}
        for name, fn in (
                ("all_to_all (list) int8", lambda: dist.all_to_all(
                    [torch.empty(2, dtype=torch.int8, device=dev)
                     for _ in range(world)],
                    [torch.ones(2, dtype=torch.int8, device=dev)
                     for _ in range(world)])),
                ("all_to_all_single int8", lambda: dist.all_to_all_single(
                    torch.empty(2 * world, dtype=torch.int8, device=dev),
                    torch.ones(2 * world, dtype=torch.int8, device=dev))),
                ("all_to_all_single uint8 (e5m2 bytes)",
                 lambda: dist.all_to_all_single(
                     torch.empty(2 * world, dtype=torch.uint8, device=dev),
                     torch.ones(2 * world, dtype=torch.uint8, device=dev))),
                ("all_to_all_single fp32", lambda: dist.all_to_all_single(
                    torch.empty(2 * world, device=dev),
                    torch.ones(2 * world, device=dev))),
                ("all_gather async bf16", lambda: dist.all_gather(
                    [torch.empty(4, dtype=torch.bfloat16, device=dev)
                     for _ in range(world)],
                    torch.ones(4, dtype=torch.bfloat16, device=dev),
                    async_op=True).wait())):
            try:
                fn()
                probe[name] = "ok"
            except RuntimeError as e:
                probe[name] = f"refused: {str(e)[:120]}"
        res["gloo"] = probe
        mesh.initialize_model_parallel()

        def same_on_ranks(ts):
            fp = param_fingerprint(torch, ts)
            both = collectives.all_gather(fp, "data", tiled=False)
            return bool(torch.equal(both[0], both[1]))

        def run(label, argv, steps, snap=True):
            t0 = time.perf_counter()
            bench, losses, snaps, counts, peak, grads = zero_steps(
                torch, ops, argv, steps, snap=snap)
            res["memory"][label] = peak
            res["counts"].append((steps, bench.cfg.num_layers, counts))
            res.setdefault("s", {})[label] = time.perf_counter() - t0
            return bench, losses, snaps, grads

        lr = float(DP_345M[DP_345M.index("--lr") + 1])

        def against(snaps, ref, grads, ref_grads):
            return {"drift": [params_drift(torch, a, b, lr, k + 1)
                              for k, (a, b) in enumerate(zip(snaps, ref))],
                    "grads": grads_err(torch, grads, ref_grads),
                    "ranks_equal": [same_on_ranks(a) for a in snaps]}

        # 1. 345M: DP, then ZeRO-1/2/3 and offload, against DP
        b, dlosses, dsnaps, dgrads = run("DP", DP_345M, ZERO_STEPS)
        res["dp_losses"], res["L"] = dlosses, b.cfg.num_layers
        del b
        b, l1, _, _ = run("ZeRO-1", DP_345M + ["--zero-level", "1"], 1,
                          snap=False)
        res["zero1_losses"] = l1
        del b
        b, l2, z2, g2 = run("ZeRO-2", DP_345M + ["--zero-level", "2"],
                            ZERO_STEPS)
        res["zero2"] = dict(against(z2, dsnaps, g2, dgrads), losses=l2)
        del b, dsnaps, dgrads
        b, l3, z3, g3 = run("ZeRO-3", DP_345M + ["--zero-level", "3"],
                            ZERO_STEPS)
        res["zero3"] = dict(against(z3, z2, g3, g2), losses=l3,
                            chunks=sum(c.numel() for c in b.zero3.params))
        del b, z3, g3, g2
        b, lo, zo, _ = run("offload", DP_345M + [
            "--zero-level", "2", "--offload-optimizer",
            "--offload-buckets", "2"], 1)
        res["offload"] = {"losses": lo, "same": lo[0] == l2[0] and all(
            torch.equal(a, c) for a, c in zip(zo[0], z2[0]))}
        del b, zo, z2
        gc.collect()
        torch.cuda.empty_cache()

        # 2. the wires and offload at 345M width, 4 layers
        base = zero_argv(DP_345M, ["--zero-level", "2"], ZERO_WIRE_LAYERS)
        b, wl, ws, _ = run("4 layers fp32 wire", base, ZERO_STEPS)
        del b
        res["wire"] = {"fp32": wl}
        b, losses, snaps, _ = run("4 layers offload", base + [
            "--offload-optimizer", "--offload-buckets", "2"], ZERO_STEPS)
        res["wire"]["offload"] = {
            "losses": losses, "same": losses == wl and all(
                torch.equal(a, c) for s, t in zip(snaps, ws)
                for a, c in zip(s, t))}
        del b, snaps
        # the bf16 param gather rounds the fp32 LayerNorm params to bf16
        # (the reference's wire, amp/frontend.py:213-231): step 1's bf16
        # params bit for bit, the fp32 ones at their bf16 rounding, then
        # it tracks the fp32 wire as the quantized grad wires do
        for wire, flags in (("gather bf16", ["--zero-gather", "bf16"]),
                            ("int8", ["--reduce-dtype", "int8"]),
                            ("e5m2", ["--reduce-dtype", "e5m2"])):
            b, losses, snaps, _ = run(f"4 layers {wire}", base + flags,
                                      ZERO_STEPS)
            res["wire"][wire] = {
                "losses": losses,
                "loss_rel": max(abs(a - c) / abs(c)
                                for a, c in zip(losses, wl)),
                "params_abs": max(float((a.float() - c.float()).abs().max())
                                  for s, t in zip(snaps, ws)
                                  for a, c in zip(s, t)),
                "ranks_equal": [same_on_ranks(s) for s in snaps]}
            if wire == "gather bf16":
                res["wire"][wire]["step1"] = all(torch.equal(
                    a, c if c.dtype == torch.bfloat16 else
                    c.to(torch.bfloat16).to(c.dtype))
                    for a, c in zip(snaps[0], ws[0]))
            if wire == "int8":
                # 3. an inf in rank 1's grads alone: both ranks skip
                st, model = b.opt_state, b.model
                before = state_fingerprint(torch, st)
                pbefore = param_fingerprint(torch, model.parameters())
                scale = st.scaler.loss_scale
                grads = [torch.zeros_like(p) for p in model.parameters()]
                if rank == 1:
                    grads[0].view(-1)[0] = float("inf")
                m = b.mp_opt.apply_gradients(
                    st, list(model.parameters()), grads,
                    found_inf_reducer=MeshGradScaler().found_inf_reducer)
                res["vote"] = {
                    "found_inf": m["found_inf"], "scale": scale,
                    "scale_after": st.scaler.loss_scale,
                    "unchanged": bool(torch.equal(
                        before, state_fingerprint(torch, st))
                        and torch.equal(pbefore, param_fingerprint(
                            torch, model.parameters()))),
                    "residual": st.residual is not None}
            del b, snaps
            gc.collect()
            torch.cuda.empty_cache()
    except Exception:  # noqa: BLE001 - reported by the parent
        res["error"] = traceback.format_exc()
    finally:
        try:
            from apex_tpu_torch.parallel import multiproc

            multiproc.shutdown()
        except Exception as e:  # noqa: BLE001
            res.setdefault("error", f"shutdown: {e}")
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def zero_spawn(ref_dir, world=2):
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(ref_dir, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_zero_rank, args=(r, world, port, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs


def zero_two_ranks(torch, total, smi, procs, outs):
    """(b): the two gloo ranks' results, each case's verdicts."""
    import pickle

    end = time.monotonic() + 900
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    check(not alive, "the two gloo ranks finished within 900 s")
    res = []
    for r, path in enumerate(outs):
        check(os.path.exists(path), f"gloo rank {r} left no result")
        with open(path, "rb") as f:
            res.append(pickle.load(f))
    for r in res:
        check("error" not in r,
              f"gloo rank {r['rank']}: {r.get('error', '')[-3000:]}")
    group = "ZeRO (b) 2 gloo ranks on the card"
    print(f"  (b) gloo on CUDA tensors: {res[0]['gloo']}")
    print(f"  (b) 345M O2, 2 ranks x 8 rows of a 16 x 1024 batch: DP losses "
          f"{[r['dp_losses'] for r in res]}; ZeRO-1 (1 step) "
          f"{[r['zero1_losses'] for r in res]}; ZeRO-2 "
          f"{[r['zero2']['losses'] for r in res]}, step 1's reduced grads "
          f"against DP's (share, row) {[r['zero2']['grads'] for r in res]}, "
          f"params after each step (share of a leaf beyond lr/5, worst "
          f"element over 2.5 lr a step) {[r['zero2']['drift'] for r in res]}"
          f"; ZeRO-3 {[r['zero3']['losses'] for r in res]}, against ZeRO-2: "
          f"grads {[r['zero3']['grads'] for r in res]}, params "
          f"{[r['zero3']['drift'] for r in res]}; offload 2 buckets (1 step) "
          f"bit for bit ZeRO-2: {[r['offload']['same'] for r in res]}; "
          f"seconds {res[0]['s']} (host-staged gloo, not speed numbers)")
    w = res[0]["wire"]
    g = w["gather bf16"]
    print(f"  (b) 345M width, {ZERO_WIRE_LAYERS} layers, ZeRO-2: fp32 wire "
          f"losses {w['fp32']}; offload bit for bit "
          f"{[r['wire']['offload']['same'] for r in res]}; --zero-gather "
          f"bf16 step 1 bit for bit at the bf16 rounding "
          f"{[r['wire']['gather bf16']['step1'] for r in res]}, then "
          f"{g['losses']} (loss rel {g['loss_rel']:.3g}, params max abs "
          f"{g['params_abs']:.3g}); int8 "
          f"{w['int8']['losses']} (loss rel {w['int8']['loss_rel']:.3g}, "
          f"params max abs {w['int8']['params_abs']:.3g}); e5m2 "
          f"{w['e5m2']['losses']} (loss rel {w['e5m2']['loss_rel']:.3g}, "
          f"params max abs {w['e5m2']['params_abs']:.3g})")
    print(f"  (b) overflow vote (inf in rank 1's grads only, int8 wire): "
          f"{[r['vote'] for r in res]}")
    for r in res:
        mem = ", ".join(f"{k} {v / 2**30:.2f} GiB"
                        for k, v in r["memory"].items())
        print(f"  (b) rank {r['rank']} peak memory "
              f"(torch.cuda.max_memory_allocated): {mem}; card: {smi}")
    for r in res:
        rk = r["rank"]
        for steps, L, counts in r["counts"]:
            check_counts(counts, expected_counts(
                counts, steps, pretrain_per_step(L, 2)), "zero")
            total.update({k: total.get(k, 0) + v for k, v in counts.items()})
        for label, losses in (("ZeRO-1", r["zero1_losses"]),
                              ("ZeRO-2", r["zero2"]["losses"])):
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                        r["dp_losses"]))
            verdict(f"zero (b) {label} rank {rk} losses rel to DP", rel,
                    ZERO_LOSS_REL, group=group)
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            r["zero3"]["losses"], r["zero2"]["losses"]))
        verdict(f"zero (b) ZeRO-3 rank {rk} losses rel to ZeRO-2", rel,
                ZERO_LOSS_REL, group=group)
        for key, ref in (("zero2", "DP"), ("zero3", "ZeRO-2")):
            x = r[key]
            verdict(f"zero (b) {key} rank {rk} step-1 grads vs {ref}",
                    x["grads"][0], ZERO_GRAD[0], group=group)
            verdict(f"zero (b) {key} rank {rk} step-1 grads vs {ref} row",
                    x["grads"][1], ZERO_GRAD[1], group=group)
            verdict(f"zero (b) {key} rank {rk} step-1 params vs {ref}, "
                    f"share beyond lr/5", x["drift"][0][0], ZERO_DRIFT[0],
                    group=group)
            verdict(f"zero (b) {key} rank {rk} params vs {ref}, worst over "
                    f"2.5 lr a step", max(e[1] for e in x["drift"]),
                    ZERO_DRIFT[1], group=group)
            verdict(f"zero (b) {key} rank {rk} params equal across ranks",
                    0 if all(r[key]["ranks_equal"]) else 1, 0, group=group)
        verdict(f"zero (b) offload rank {rk} bit for bit ZeRO-2",
                0 if r["offload"]["same"] else 1, 0, group=group)
        w = r["wire"]
        verdict(f"zero (b) 4 layers offload rank {rk} bit for bit",
                0 if w["offload"]["same"] else 1, 0, group=group)
        verdict(f"zero (b) 4 layers gather bf16 rank {rk} step 1 bit for "
                f"bit at the bf16 rounding",
                0 if w["gather bf16"]["step1"] else 1, 0, group=group)
        for wire in ("gather bf16", "int8", "e5m2"):
            verdict(f"zero (b) {wire} wire rank {rk} losses rel to fp32",
                    w[wire]["loss_rel"], ZERO_LOSS_REL, group=group)
            verdict(f"zero (b) {wire} wire rank {rk} params vs fp32 abs",
                    w[wire]["params_abs"], ZERO_WIRE_BAND, group=group)
            verdict(f"zero (b) {wire} wire rank {rk} params equal across "
                    f"ranks", 0 if all(w[wire]["ranks_equal"]) else 1, 0,
                    group=group)
        v = r["vote"]
        verdict(f"zero (b) overflow vote rank {rk} skips, state and residual "
                f"unchanged, scale halved",
                0 if (v["found_inf"] and v["unchanged"] and v["residual"]
                      and v["scale_after"] == v["scale"] / 2) else 1, 0,
                group=group)
    return res


def zero_phase(torch, ops, dev):
    """Phase 16: (b)'s ranks spawned first, (a) :func:`zero_world1` in this
    process meanwhile, then (b)'s verdicts. Returns the launches of the
    ZeRO runs (path ``zero``: (a)'s and both ranks')."""
    import shutil

    t0 = time.perf_counter()
    smi = nvidia_smi()
    total = {}
    ref_dir = os.path.join(HERE, "build", "zero_check")
    shutil.rmtree(ref_dir, ignore_errors=True)
    os.makedirs(ref_dir)
    procs = []
    try:
        procs, outs = zero_spawn(ref_dir)
        zero_world1(torch, ops, dev, total, smi)
        zero_two_ranks(torch, total, smi, procs, outs)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(ref_dir, ignore_errors=True)
    print(f"  phase 16 launches {total}; phase 16 took "
          f"{time.perf_counter() - t0:.1f} s; card: {smi}")
    return total


def zero_main():
    """``python3 chip_smoke.py --zero``: phase 16 alone after the build,
    with its verdict."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from apex_tpu_torch import ops
    from apex_tpu_torch.csrc import build

    print(f"card: {nvidia_smi()}; torch {torch.__version__}")
    build.load()
    zero_phase(torch, ops, torch.device("cuda", 0))
    print_verdict()
    return 0


# ---------------------------------------------------------------------------
# phase 17: pipeline parallelism (NCCL at world size 1; two gloo ranks on
# the card)
# ---------------------------------------------------------------------------

PP_STEPS = 3
#: BASELINE config 4 as 4 micro-batches of 2 (8 x 1024 a step): the serial
#: run, (a)'s world-1 run and (b)'s reference; (b) adds ``--pp 2``
PP_SERIAL = with_layers(GPT_345M, RANK_LAYERS) + [
    "--seq", "1024", "--micro-batch", "2",
                        "--num-microbatches", "4", "--lr", "1e-4"]
PP_345M = PP_SERIAL + ["--pp", "2"]
#: (label, flags, steps): gpipe and 1f1b both run the autograd ring in
#: ``pretrain_gpt`` (the reference's example does the same), so gpipe runs
#: one step, held bit for bit against the 1f1b run's first
PP_1F1B = ["--pp-schedule", "1f1b"]
PP_CASES = (("1f1b", PP_1F1B, PP_STEPS),
            ("gpipe", ["--pp-schedule", "gpipe"], 1),
            ("interleaved", ["--pp-schedule", "interleaved", "--vpp", "2"],
             PP_STEPS),
            ("zerobubble", ["--pp-schedule", "zerobubble"], PP_STEPS))
#: limits of (b), phase 15's: the losses relative; the O2 step-1 grads by
#: their floor (each leaf's L2 distance from the serial run's over the
#: serial run's own distance from its fp32-compute twin: the pipelined step
#: sums each layer's grads over its ticks inside one backward in the param
#: dtype, bf16, as the reference's scan does, where the serial one sums in
#: fp32 and rounds once, and its sharded head projects 4 rows a stage where
#: the serial one projects 2 a micro-batch; on an H100 the position grad
#: read 0.0157 by row against phase 14's 0.015, PERF.md);
#: the 1f1b run's O0 twin (fp32 params and compute: the parallel math with
#: no bf16 rounding) against the serial O0 run: its step-1 loss relative
#: and its grads by share of max |ref| and by row, at about 15x what an
#: H100 read (grads 6.8e-6 by share and 5.0e-6 by row, PERF.md), so a
#: lost micro-batch or a head share off by a factor of M or S fails;
#: ``--zero`` against the same run without it as phase 16 holds ZeRO-2
#: against DP
PP_LOSS_REL = DP_LOSS_REL
PP_FLOOR = TP_FLOOR
PP_O0_LOSS_REL = 2e-5
PP_O0_GRAD = (1e-4, 1e-4)


def pp_per_step(L, M, S, vpp, schedule, last):
    """Launches of one pipelined step on one stage of ``L / S`` layers.
    The ring (gpipe, 1f1b, interleaved) runs its chunk of ``L / (S vpp)``
    layers on every one of its ``vpp M + S - 1`` ticks, each a checkpointed
    layer (the forward, its recompute, the backward; LN twice a layer each
    way), and the sharded head once (the final LN). The zero-bubble
    executor runs per micro-batch a forward with no graph, then the
    input-grad and the weight-grad slots, each a forward under autograd,
    its recompute and the backward; the last stage's head chained onto
    both slots."""
    n = L // S
    if schedule == "zerobubble":
        head = 2 * M if last else 0
        return {"flash_attention_fwd": 5 * n * M,
                "flash_attention_bwd_dq": 2 * n * M,
                "flash_attention_bwd_dkv": 2 * n * M,
                "layer_norm_fwd": 10 * n * M + head,
                "layer_norm_bwd": 4 * n * M + head}
    apps = n * (vpp * M + S - 1) // vpp
    return {"flash_attention_fwd": 2 * apps,
            "flash_attention_bwd_dq": apps,
            "flash_attention_bwd_dkv": apps,
            "layer_norm_fwd": 4 * apps + 1,
            "layer_norm_bwd": 2 * apps + 1}


def pp_world1(torch, ops, dev, total):
    """(a): NCCL at world size 1 in this process: the serial run of
    :data:`PP_SERIAL`, then the same through ``get_forward_backward_func(1)``
    (no pipelining) on a pipe axis of 1, 3 steps, losses and params after
    each step bit for bit. Returns the serial run's losses and (b)'s
    references: step 1's grads, each leaf's floor, the O0 run's step-1
    grads and the parameter names."""
    from apex_tpu_torch.parallel import mesh, multiproc
    from apex_tpu_torch.transformer import pipeline_parallel as ppl

    bench, slosses, ssnaps, sgrads, _ = pretrain_steps(
        torch, ops, PP_SERIAL, PP_STEPS, snap=True)
    names = [n for n, _ in bench.model.named_parameters()]
    sgrads = [g.cpu() for g in sgrads]
    del bench
    gc.collect()
    torch.cuda.empty_cache()
    # each leaf's bf16 rounding floor: the serial step-1 grads in fp32
    # compute on the same bf16 params; and the O0 twin's reference
    _, _, _, fgrads, _ = pretrain_steps(torch, ops, PP_SERIAL, 1,
                                        compute_dtype=torch.float32)
    floor = [l2_err(f.cpu(), g) for f, g in zip(fgrads, sgrads)]
    del fgrads
    _, olosses, _, ograds, _ = pretrain_steps(
        torch, ops, PP_SERIAL + ["--opt-level", "O0"], 1)
    o0 = [g.cpu() for g in ograds]
    del ograds
    gc.collect()
    torch.cuda.empty_cache()
    check(multiproc.initialize_distributed(
        f"127.0.0.1:{free_port()}", 1, 0), "NCCL world 1 initialized")
    import torch.distributed as dist

    backend = dist.get_backend()
    try:
        mesh.initialize_model_parallel(pipeline_model_parallel_size=1)
        check(ppl.get_forward_backward_func(1)
              is ppl.forward_backward_no_pipelining,
              "pp 1 dispatches to forward_backward_no_pipelining")
        bench, losses, snaps, _, counts = pretrain_steps(
            torch, ops, PP_SERIAL, PP_STEPS, snap=True)
        check(mesh.get_pipeline_model_parallel_world_size() == 1,
              "(a) on a pipe axis of 1")
        L = bench.cfg.num_layers
        check_counts(counts, expected_counts(counts, PP_STEPS,
                                             pretrain_per_step(L, 4)), "pp")
        total.update({k: total.get(k, 0) + v for k, v in counts.items()})
        same = [losses == slosses] + [
            all(torch.equal(a, b) for a, b in zip(s, t))
            for s, t in zip(snaps, ssnaps)]
        print(f"  (a) pretrain_gpt 345M O2 through get_forward_backward_func"
              f"(1) over {backend} (world size 1), {PP_STEPS} steps of "
              f"{bench.batch} x 1024 as 4 micro-batches of 2: losses "
              f"{losses} (serial {slosses}); losses and params after each "
              f"step bit-identical to the serial run: {same}")
        verdict("pp (a) 345M no pipelining at world 1 bit for bit the "
                "serial run", 0 if all(same) else 1, 0,
                group="pipeline parallel (a) NCCL world 1")
        del bench, snaps, ssnaps
    finally:
        multiproc.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return slosses, {"grads": sgrads, "grads_o0": o0, "floor": floor,
                     "names": names, "loss_o0": olosses[0]}


def pp_wire_check(torch, dev):
    """The ring shift on this backend, by value: each rank sends a CUDA
    tensor of its rank's values to the next; returns (the wire, whether
    what arrived on the card is the sender's exactly)."""
    from apex_tpu_torch.parallel import collectives
    import torch.distributed as dist

    rank = collectives.axis_rank("pipe")
    n = collectives.axis_size("pipe")
    x = torch.arange(1 << 20, device=dev, dtype=torch.float32) + 1e6 * rank
    got = collectives.ppermute_shift(x.to(torch.bfloat16), "pipe", 1)
    src = (rank - 1) % n
    want = (torch.arange(1 << 20, device=dev, dtype=torch.float32)
            + 1e6 * src).to(torch.bfloat16)
    wire = ("host-staged (gloo's point-to-point reads host memory: the CUDA "
            "payload crosses as a host copy and lands back on the card)"
            if dist.get_backend() == "gloo" else "device (NCCL)")
    return wire, bool(got.device == x.device and torch.equal(got, want))


def pp_stage_errs(torch, model, grads, ref, names):
    """Per parameter of this stage: the share of max |ref|, the row error
    and the L2 distance of its step-1 grads from the serial run's, each
    local layer held against the serial layer it holds (the stage's block
    of the interleaved stack: together the stages cover the serial
    stack)."""
    from apex_tpu_torch.parallel import collectives
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        stage_layer_ids,
    )

    c = model.cfg
    ids = stage_layer_ids(c.num_layers, collectives.axis_size("pipe"),
                          c.virtual_pipeline_size,
                          collectives.axis_rank("pipe"))
    index = {n: i for i, n in enumerate(names)}
    out = []
    for (name, _), g in zip(model.named_parameters(), grads):
        parts = name.split(".")
        if parts[0] == "layers":
            parts[1] = str(ids[int(parts[1])])
        r = ref[index[".".join(parts)]].to(g.device)
        out.append((".".join(parts), rel_err(g, r),
                    row_err(g if g.dim() else g[None],
                            r if r.dim() else r[None]), l2_err(g, r)))
    return out


def replicated_over_pipe(torch, model, snaps):
    """Per snapshot: whether the non-layer params are bit-identical on
    both stages."""
    from apex_tpu_torch.parallel import collectives

    rest = [i for i, (n, _) in enumerate(model.named_parameters())
            if not n.startswith("layers.")]
    out = []
    for snap in snaps:
        fp = param_fingerprint(torch, [snap[i] for i in rest])
        both = collectives.all_gather(fp, "pipe", tiled=False)
        out.append(all(torch.equal(both[0], x) for x in both[1:]))
    return out


def _pp_rank(rank, world, port, ref_dir, out_path):
    """One gloo rank of phase 17 (b) on the card: the wire check, every
    schedule at pp 2 against the serial references (gpipe also bit for bit
    against the 1f1b run's first step), then ``--zero`` against the 1f1b
    run; the errors and counts go back to the parent."""
    import pickle
    import traceback

    import torch

    sys.path.insert(0, HERE)
    res = {"rank": rank, "counts": []}
    try:
        from apex_tpu_torch import ops
        from apex_tpu_torch.examples.gpt import pretrain_gpt
        from apex_tpu_torch.parallel import mesh, multiproc

        multiproc.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                         backend="gloo", timeout_s=600)
        dev = torch.device("cuda", 0)
        mesh.initialize_model_parallel(pipeline_model_parallel_size=world)
        res["wire"] = pp_wire_check(torch, dev)
        ref = wait_for_references(torch, ref_dir)
        lr = float(PP_345M[PP_345M.index("--lr") + 1])
        base = None
        for label, flags, steps in PP_CASES + (("zero", ["--zero"],
                                                 PP_STEPS),):
            t0 = time.perf_counter()
            bench, losses, snaps, grads, counts = pretrain_steps(
                torch, ops, PP_345M + flags, steps, snap=True,
                snap_to="cpu")
            c = bench.cfg
            args = pretrain_gpt.parse_args(PP_345M + flags)
            res["counts"].append((label, steps, counts, pp_per_step(
                c.num_layers, args.num_microbatches, world,
                c.virtual_pipeline_size, args.pp_schedule,
                rank == world - 1)))
            x = {"losses": losses, "layers": len(bench.model.layers),
                 "ranks_equal": replicated_over_pipe(torch, bench.model,
                                                     snaps)}
            if label == "zero":
                x["drift"] = [params_drift(torch, a, b, lr, k + 1)
                              for k, (a, b) in enumerate(zip(snaps, base))]
            else:
                x["errs"] = pp_stage_errs(torch, bench.model, grads,
                                          ref["grads"], ref["names"])
                floor = dict(zip(ref["names"], ref["floor"]))
                x["floor_ratio"] = sorted(
                    ((e[3] / max(floor[e[0]], 1e-12), e[0])
                     for e in x["errs"]), reverse=True)[:3]
            if label == "1f1b":
                base, base_loss = snaps, losses[0]
                base_grads = [g.cpu() for g in grads]
            if label == "gpipe":
                x["same_as_1f1b"] = [
                    losses[0] == base_loss,
                    all(torch.equal(g.cpu(), b)
                        for g, b in zip(grads, base_grads)),
                    all(torch.equal(a, b) for a, b in zip(snaps[0],
                                                          base[0]))]
            x["s"] = time.perf_counter() - t0
            res[label] = x
            del bench, grads, snaps
            gc.collect()
            torch.cuda.empty_cache()
        del base_grads
        # the 1f1b run's O0 twin, one step
        bench, losses, _, grads, counts = pretrain_steps(
            torch, ops, PP_345M + PP_1F1B + ["--opt-level", "O0"], 1)
        res["counts"].append(("1f1b O0", 1, counts, pp_per_step(
            bench.cfg.num_layers, 4, world, 1, "1f1b", rank == world - 1)))
        res["o0"] = {"loss": losses[0],
                     "errs": pp_stage_errs(torch, bench.model, grads,
                                           ref["grads_o0"], ref["names"])}
        del bench, grads
        gc.collect()
        torch.cuda.empty_cache()
    except Exception:  # noqa: BLE001 - reported by the parent
        res["error"] = traceback.format_exc()
    finally:
        try:
            from apex_tpu_torch.parallel import multiproc

            multiproc.shutdown()
        except Exception as e:  # noqa: BLE001
            res.setdefault("error", f"shutdown: {e}")
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def pp_spawn(ref_dir, world=2):
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(ref_dir, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_pp_rank,
                         args=(r, world, port, ref_dir, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs


def pp_two_ranks(torch, total, smi, slosses, o0_loss, procs, outs):
    """(b): the two gloo ranks' results, each case's verdicts."""
    import pickle

    end = time.monotonic() + 600
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    check(not alive, "the two gloo ranks finished within 600 s")
    res = []
    for r, path in enumerate(outs):
        check(os.path.exists(path), f"gloo rank {r} left no result")
        with open(path, "rb") as f:
            res.append(pickle.load(f))
    for r in res:
        check("error" not in r,
              f"gloo rank {r['rank']}: {r.get('error', '')[-3000:]}")
    group = "pipeline parallel (b) 2 gloo ranks on the card"
    print(f"  (b) the ring shift of a CUDA tensor: "
          f"{[r['wire'] for r in res]}")
    for r in res:
        verdict(f"pp (b) rank {r['rank']} ring shift of a CUDA tensor "
                f"arrives exact", 0 if r["wire"][1] else 1, 0, group=group)
    for label, _, _ in PP_CASES:
        xs = [r[label] for r in res]
        errs = [max(e[1] for e in x["errs"]) for x in xs]
        rows = [max(e[2] for e in x["errs"]) for x in xs]
        print(f"  (b) pretrain_gpt --pp 2 --pp-schedule {label} (345M O2, "
              f"{[x['layers'] for x in xs]} layers a stage, 8 x 1024 as 4 "
              f"micro-batches of 2): losses {[x['losses'] for x in xs]} "
              f"(serial {slosses}); step 1's grads against the serial run's "
              f"by share {errs}, by row {rows}, worst leaves "
              f"{[worst_leaves(x['errs']) for x in xs]}; L2 over the "
              f"floor, worst {[x['floor_ratio'] for x in xs]}; non-layer "
              f"params equal on both stages {[x['ranks_equal'] for x in xs]}; "
              f"{[round(x['s'], 1) for x in xs]} s (host-staged gloo, not "
              f"speed numbers)")
        for r, x in zip(res, xs):
            rk = r["rank"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(x["losses"],
                                                        slosses))
            verdict(f"pp (b) {label} rank {rk} losses rel to serial", rel,
                    PP_LOSS_REL, group=group)
            verdict(f"pp (b) {label} rank {rk} worst grad leaf L2 over the "
                    f"serial fp32-compute distance", x["floor_ratio"][0][0],
                    PP_FLOOR, group=group)
            verdict(f"pp (b) {label} rank {rk} non-layer params equal on "
                    f"both stages", 0 if all(x["ranks_equal"]) else 1, 0,
                    group=group)
    same = [r["gpipe"]["same_as_1f1b"] for r in res]
    print(f"  (b) gpipe's step against 1f1b's first (both the autograd "
          f"ring in pretrain_gpt): loss, step-1 grads, params after the "
          f"step bit-identical {same}")
    for r, x in zip(res, same):
        verdict(f"pp (b) gpipe rank {r['rank']} step 1 bit for bit the "
                f"1f1b run's", 0 if all(x) else 1, 0, group=group)
    fs = [r["o0"]["errs"] for r in res]
    f_share = [max(e[1] for e in x) for x in fs]
    f_row = [max(e[2] for e in x) for x in fs]
    print(f"  (b) the 1f1b run's O0 twin (1 step, fp32 params and compute) "
          f"against the serial O0 run: losses {[r['o0']['loss'] for r in res]}"
          f" (serial {o0_loss}); grads by share {f_share}, by row "
          f"{f_row}, worst leaves {[worst_leaves(x) for x in fs]}")
    for r, e, w in zip(res, f_share, f_row):
        verdict(f"pp (b) 1f1b O0 rank {r['rank']} step-1 loss rel to serial",
                abs(r["o0"]["loss"] - o0_loss) / abs(o0_loss),
                PP_O0_LOSS_REL, group=group)
        verdict(f"pp (b) 1f1b O0 rank {r['rank']} step-1 grads", e,
                PP_O0_GRAD[0], group=group)
        verdict(f"pp (b) 1f1b O0 rank {r['rank']} step-1 grads row", w,
                PP_O0_GRAD[1], group=group)
    zs = [r["zero"] for r in res]
    print(f"  (b) pretrain_gpt --pp 2 --zero (level 2) against --pp 2: "
          f"losses {[z['losses'] for z in zs]} (1f1b "
          f"{[r['1f1b']['losses'] for r in res]}); params after each step "
          f"(share of a leaf beyond lr/5, worst element over 2.5 lr a step) "
          f"{[z['drift'] for z in zs]}; card: {smi}")
    for r, z in zip(res, zs):
        rk = r["rank"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            z["losses"], r["1f1b"]["losses"]))
        verdict(f"pp (b) --zero rank {rk} losses rel to --pp 2", rel,
                ZERO_LOSS_REL, group=group)
        verdict(f"pp (b) --zero rank {rk} step-1 params vs --pp 2, share "
                f"beyond lr/5", z["drift"][0][0], ZERO_DRIFT[0], group=group)
        verdict(f"pp (b) --zero rank {rk} params vs --pp 2, worst over 2.5 "
                f"lr a step", max(e[1] for e in z["drift"]), ZERO_DRIFT[1],
                group=group)
        verdict(f"pp (b) --zero rank {rk} non-layer params equal on both "
                f"stages", 0 if all(z["ranks_equal"]) else 1, 0, group=group)
    for r in res:
        for label, steps, counts, per_step in r["counts"]:
            check_counts(counts, expected_counts(counts, steps, per_step),
                         "pp")
            total.update({k: total.get(k, 0) + v for k, v in counts.items()})
    return res


def pp_phase(torch, ops, dev):
    """Phase 17: (b)'s ranks spawned first, (a) :func:`pp_world1` in this
    process meanwhile (its serial run is (b)'s reference), then (b)'s
    verdicts. Returns the launches of the pipeline runs (path ``pp``: (a)'s
    and both ranks')."""
    import shutil

    t0 = time.perf_counter()
    smi = nvidia_smi()
    total = {}
    ref_dir = os.path.join(HERE, "build", "pp_check")
    shutil.rmtree(ref_dir, ignore_errors=True)
    os.makedirs(ref_dir)
    procs = []
    try:
        procs, outs = pp_spawn(ref_dir)
        slosses, ref = pp_world1(torch, ops, dev, total)
        torch.save(ref, os.path.join(ref_dir, "ref.tmp"))  # whole, or absent
        os.replace(os.path.join(ref_dir, "ref.tmp"),
                   os.path.join(ref_dir, "ref.pt"))
        print(f"  (b) the serial run's bf16 grads' L2 distance from its "
              f"fp32-compute twin's (the floor), largest "
              f"{sorted((round(v, 4) for v in ref['floor']), reverse=True)[:3]}")
        o0_loss = ref["loss_o0"]
        del ref
        pp_two_ranks(torch, total, smi, slosses, o0_loss, procs, outs)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(ref_dir, ignore_errors=True)
    print(f"  phase 17 launches {total}; phase 17 took "
          f"{time.perf_counter() - t0:.1f} s; card: {smi}")
    return total


def offsets_main():
    """``python3 chip_smoke.py --offsets``: the build, then phase 2's ring
    offset cases and ring-step times alone, with their verdict."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from apex_tpu_torch import ops
    from apex_tpu_torch.csrc import build

    print(f"card: {nvidia_smi()}; torch {torch.__version__}")
    t0 = time.perf_counter()
    build.load()
    print(f"  kernels built in {time.perf_counter() - t0:.2f} s")
    check_flash_offsets(torch, ops, torch.device("cuda", 0))
    print_verdict()
    return 0


def pp_main():
    """``python3 chip_smoke.py --pp``: phase 17 alone after the build, with
    its verdict."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from apex_tpu_torch import ops
    from apex_tpu_torch.csrc import build

    print(f"card: {nvidia_smi()}; torch {torch.__version__}")
    build.load()
    pp_phase(torch, ops, torch.device("cuda", 0))
    print_verdict()
    return 0


# ---------------------------------------------------------------------------
# phase 18: context parallel (NCCL at world size 1; two gloo ranks on the
# card)
# ---------------------------------------------------------------------------

CP_STEPS = 3
#: phase 6's configuration: GPT-2 345M at full width and depth, one row of
#: 8192 tokens, the chunked LM-head CE, O2; 4096 tokens a rank at cp 2
CP_LONG = dict(seq=8192, hidden=1024, layers=RANK_LAYERS, heads=16,
               vocab=50304,
               batch=1, lm_head_chunks=8, seed=0)
#: phase 6's second configuration: RoPE and a window of 4096 at 16384
#: tokens, the window crossing the shard boundary at cp 2
CP_WINDOW = dict(CP_LONG, seq=16384, pos="rope", window=4096)
CP_WINDOW_STEPS = 1
#: the O0 twin of the ring (fp32 params and compute): CP_LONG at this
#: depth, one step
CP_TWIN_LAYERS = 4
#: limits of (b), phase 15/17's: the losses relative; the O2 step-1 grads
#: by their floor (each leaf's L2 distance from the serial run's over the
#: serial run's own distance from its fp32-compute twin; for BERT over the
#: larger of that and its distance from the serial O0 step on the same
#: (bf16-rounded) values, whose grads are fp32 too: BERT's tokentype row
#: sums every token's grad in the bf16 grad, and that sum's rounding is in
#: both serial bf16-param runs alike, so their fp32-compute distance does
#: not see it; on an H100 the leaf read 3.31 times that floor at cp 2 in
#: O2 and, with fp32 compute on the same bf16 params, 0.0599 of its L2
#: from the serial run's); the O0 twins
#: (fp32 params and compute: the ring's merge order and the mean over the
#: ranks are all that differ from the serial pass) by its step-1 loss and
#: its grads' share of max |ref| and worst row, about 15x what an H100
#: 80GB HBM3 at 700 W read (grads 2.86e-6 by share and 3.45e-6 by row, the
#: loss equal; PERF.md), so that a lost ring step or a wrong offset fails
CP_LOSS_REL = DP_LOSS_REL
CP_FLOOR = TP_FLOOR

CP_TWIN_LOSS_REL = 1e-6
CP_TWIN_GRAD = (4.5e-5, 5e-5)
#: BERT-large's O0 twin at cp 2 (grads by share and by row), about 15x
#: what an H100 80GB HBM3 at 700 W read (2.42e-6 by share, 1.60e-4 by
#: row: a row at the floor of its leaf's largest; the loss within 8.3e-8)
CP_BERT_TWIN_GRAD = (4e-5, 2.5e-3)
#: (a)'s attention shape (the ring's 345M shard) and window
CP_A_SHAPE = (1, 16, 4096, 64)
CP_A_WINDOW = 1024


def cp_per_step(L, rank, impl):
    """Launches of one long-context step on context rank ``rank`` at cp 2:
    the ring runs a causal step for each K/V shard at or before its own
    (``rank + 1``; the later one is skipped: nothing visible), each layer's
    forward twice (the remat recompute); Ulysses one streamed attention a
    layer on the whole sequence, as the serial step (:func:`long_per_step`
    for the norms)."""
    n = rank + 1 if impl == "ring" else 1
    per = long_per_step(L)
    return dict(per, flash_attention_fwd_stream=2 * L * n,
                flash_attention_bwd_dq_stream=L * n,
                flash_attention_bwd_dkv_stream=L * n)


def bert_cp_per_step(L, cp):
    """One BERT step at cp ranks, the ring over segment ids (non-causal:
    every step visible, the resident kernels at 256 tokens a shard)."""
    return dict(bert_per_step(L), flash_attention_fwd=2 * L * cp,
                flash_attention_bwd_dq=L * cp,
                flash_attention_bwd_dkv=L * cp)


def long_cp_steps(torch, ops, cfg, steps, cp=1, sp_impl="ring",
                  opt_level="O2", compute_dtype=None):
    """``train_long_context.build(**cfg)`` (at ``cp`` context ranks with
    ``sp_impl``, at ``opt_level``, its config's compute dtype replaced by
    ``compute_dtype`` where given) ``steps`` steps on ``fixed_batch``'s
    global batch: (losses, the first step's reduced scaled grads on the
    CPU, launches, parameter names, layers)."""
    from apex_tpu_torch.bench import fixed_batch
    from apex_tpu_torch.examples.longcontext import train_long_context

    real = train_long_context.GPTConfig
    if compute_dtype is not None:
        train_long_context.GPTConfig = lambda **c: real(
            **dict(c, compute_dtype=compute_dtype))
    try:
        trainer = train_long_context.build(**cfg, cp=cp, sp_impl=sp_impl,
                                           opt_level=opt_level)
    finally:
        train_long_context.GPTConfig = real
    tokens, targets = fixed_batch(trainer)
    grads = []
    capture_grads(torch, trainer, grads)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses = []
    for _ in range(steps):
        loss, m = trainer.step(tokens, targets)
        losses.append(float(loss))
        check(not m["found_inf"], "no long-context step skipped")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    names = [n for n, _ in trainer.model.named_parameters()]
    L = trainer.cfg.num_layers
    grads = [g.cpu() for g in grads]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return losses, grads, counts, names, L


def bert_cp_batch(torch, vocab):
    """(b)'s BERT batch (phase 15's, rows padded from 512 - 37 i on) with
    the loss mask zero on the padding: under a context axis a padded query
    row attends nothing (output 0) where the bias route mixes it, and the
    masked-LM loss reads neither."""
    batch = list(bert_tp_batch(torch, vocab))
    batch[2] = batch[2] * batch[1]
    return tuple(batch)


def bert_cp_steps(torch, ops, batch, cp, steps=1, opt_level="O2",
                  **config):
    """BERT-large O2 FusedLAMB (:data:`BERT_TP`) on the context axis at
    ``cp`` ranks (at ``opt_level``), ring attention over the padding as
    segment ids: this rank's ``s / cp`` tokens of every (b, s) input, the
    grads reduced over the context axis before the step, the loss
    ``pmean``-ed. Returns (losses, the first step's reduced grads over the
    loss scale on the CPU, launches, layers)."""
    from apex_tpu_torch.parallel import collectives, mesh
    from apex_tpu_torch.parallel.distributed import (
        allreduce_gradients_by_spec,
    )

    config = dict(config, context_axis=mesh.AXIS_CONTEXT,
                  sequence_parallel_impl="ring")
    from apex_tpu_torch.examples.bert import pretrain_bert

    real = pretrain_bert.BertConfig
    pretrain_bert.BertConfig = lambda **c: real(**dict(c, **config))
    try:
        trainer = pretrain_bert.build(**BERT_TP, opt_level=opt_level)
    finally:
        pretrain_bert.BertConfig = real
    model, mp_opt, st = trainer.model, trainer.mp_opt, trainer.opt_state
    r = collectives.axis_rank(mesh.AXIS_CONTEXT)
    s = BERT_TP["seq"] // cp
    local = [t if t.dim() == 1 else t[:, r * s:(r + 1) * s] for t in batch]
    local = [t.to(model.device) for t in local]
    params = list(model.parameters())
    grads, losses = [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for _ in range(steps):
        loss = model.loss(*local)
        mp_opt.scale_loss(loss, st).backward()
        reduced = allreduce_gradients_by_spec([p.grad for p in params],
                                              [()] * len(params))
        for p, g in zip(params, reduced):
            p.grad = g
        if not grads:
            grads.extend((g.detach() / st.scaler.loss_scale).cpu()
                         for g in reduced)
        m = mp_opt.step(st, model)
        check(not m["found_inf"], "no BERT CP step skipped")
        losses.append(float(collectives.pmean(loss.detach(),
                                              mesh.AXIS_CONTEXT)))
    torch.cuda.synchronize()
    L = trainer.cfg.num_layers
    del trainer, model, st
    gc.collect()
    torch.cuda.empty_cache()
    return losses, grads, ops.launch_counts(), L


def floor_ratios(names, grads, ref, floor):
    """Each leaf's L2 distance from ``ref`` over its ``floor``, the worst
    three: [(ratio, name)]."""
    return sorted(((l2_err(g, r) / max(f, 1e-12), n)
                   for n, g, r, f in zip(names, grads, ref, floor)),
                  reverse=True)[:3]


def cp_wire_check(torch, dev):
    """The context axis's two wires on this backend, by value: the ring
    shift of a bf16 CUDA tensor, and the all-to-all of one (which gloo
    takes as its bytes): every rank builds every rank's input from its
    seed, so each can hold what arrives against what was sent. Returns
    (the backend, shift exact, all-to-all exact)."""
    from apex_tpu_torch.parallel import collectives
    import torch.distributed as dist

    rank = collectives.axis_rank("context")
    n = collectives.axis_size("context")

    def x_of(r):
        g = torch.Generator(device=dev).manual_seed(100 + r)
        return torch.randn(1, 2 * n, 64, 64, device=dev,
                           generator=g).to(torch.bfloat16)

    got = collectives.ppermute_shift(x_of(rank), "context", 1)
    shift_ok = bool(torch.equal(got, x_of((rank - 1) % n)))
    got = collectives.all_to_all(x_of(rank), "context", split_axis=1,
                                 concat_axis=2)
    want = torch.cat([x_of(r)[:, 2 * rank:2 * rank + 2] for r in range(n)],
                     dim=2)
    return dist.get_backend(), shift_ok, bool(torch.equal(got, want))


def _cp_rank(rank, world, port, ref_dir, out_path):
    """One gloo rank of phase 18 (b) on the card: the wire check, then
    ``train_long_context --cp 2`` ring and Ulysses at 345M, the fp32
    twin, the window at 16384 and BERT-large, each run first and held
    against the parent's serial references after all of them ran (the
    parent computes those meanwhile)."""
    import pickle
    import traceback

    import torch

    sys.path.insert(0, HERE)
    res = {"rank": rank, "counts": []}
    try:
        from apex_tpu_torch import ops
        from apex_tpu_torch.parallel import mesh, multiproc

        multiproc.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                         backend="gloo", timeout_s=600)
        dev = torch.device("cuda", 0)
        mesh.initialize_model_parallel(context_parallel_size=world)
        res["wire"] = cp_wire_check(torch, dev)
        got = {}
        for impl in ("ring", "ulysses"):
            t0 = time.perf_counter()
            losses, grads, counts, names, L = long_cp_steps(
                torch, ops, CP_LONG, CP_STEPS, cp=world, sp_impl=impl)
            res["counts"].append((impl, CP_STEPS, counts,
                                  cp_per_step(L, rank, impl)))
            got[impl] = grads
            res[impl] = {"losses": losses, "s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        losses, got["twin"], counts, _, L = long_cp_steps(
            torch, ops, dict(CP_LONG, layers=CP_TWIN_LAYERS), 1, cp=world,
            opt_level="O0")
        res["counts"].append(("O0 twin", 1, counts,
                              cp_per_step(L, rank, "ring")))
        res["twin"] = {"loss": losses[0], "s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        losses, got["window"], counts, wnames, L = long_cp_steps(
            torch, ops, CP_WINDOW, CP_WINDOW_STEPS, cp=world)
        res["counts"].append(("window", CP_WINDOW_STEPS, counts,
                              cp_per_step(L, rank, "ring")))
        res["window"] = {"losses": losses, "s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        bert = bert_cp_batch(torch, 30592)
        losses, got["bert"], counts, L = bert_cp_steps(torch, ops, bert,
                                                       world)
        res["counts"].append(("bert", 1, counts, bert_cp_per_step(L, world)))
        res["bert"] = {"losses": losses, "s": time.perf_counter() - t0}
        losses, got["bert_o0"], counts, L = bert_cp_steps(
            torch, ops, bert, world, opt_level="O0")
        res["counts"].append(("bert O0", 1, counts,
                              bert_cp_per_step(L, world)))
        res["bert_o0"] = {"loss": losses[0]}

        ref = wait_for_references(torch, ref_dir)
        for impl in ("ring", "ulysses"):
            res[impl]["floor_ratio"] = floor_ratios(
                names, got[impl], ref["grads"], ref["floor"])
            res[impl]["errs"] = grads_err(torch, got[impl], ref["grads"])
        res["twin"]["errs"] = grads_err(torch, got["twin"],
                                        ref["twin_grads"])
        res["window"]["floor_ratio"] = floor_ratios(
            wnames, got["window"], ref["window_grads"], ref["window_floor"])
        res["bert"]["floor_ratio"] = floor_ratios(
            ref["bert_names"], got["bert"], ref["bert_grads"],
            ref["bert_floor"])
        res["bert_o0"]["errs"] = grads_err(torch, got["bert_o0"],
                                           ref["bert_o0_grads"])
    except Exception:  # noqa: BLE001 - reported by the parent
        res["error"] = traceback.format_exc()
    finally:
        try:
            from apex_tpu_torch.parallel import multiproc

            multiproc.shutdown()
        except Exception as e:  # noqa: BLE001
            res.setdefault("error", f"shutdown: {e}")
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def cp_spawn(ref_dir, world=2):
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(ref_dir, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_cp_rank,
                         args=(r, world, port, ref_dir, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs


def cp_references(torch, ops):
    """(b)'s serial references, in this process: the 345M run at 8192
    (its losses, step-1 grads and their floor against its fp32-compute
    twin), the O0 run at :data:`CP_TWIN_LAYERS`, the window run
    at 16384 (losses, grads, floor) and BERT-large's bias-route step
    (losses, grads, floor)."""
    ref = {}
    ref["losses"], ref["grads"], _, _, _ = long_cp_steps(
        torch, ops, CP_LONG, CP_STEPS)
    _, fgrads, _, _, _ = long_cp_steps(torch, ops, CP_LONG, 1,
                                       compute_dtype=torch.float32)
    ref["floor"] = [l2_err(f, g) for f, g in zip(fgrads, ref["grads"])]
    del fgrads
    twin, ref["twin_grads"], _, _, _ = long_cp_steps(
        torch, ops, dict(CP_LONG, layers=CP_TWIN_LAYERS), 1, opt_level="O0")
    ref["twin_loss"] = twin[0]
    ref["window_losses"], ref["window_grads"], _, _, _ = long_cp_steps(
        torch, ops, CP_WINDOW, CP_WINDOW_STEPS)
    _, fgrads, _, _, _ = long_cp_steps(torch, ops, CP_WINDOW, 1,
                                       compute_dtype=torch.float32)
    ref["window_floor"] = [l2_err(f, g)
                           for f, g in zip(fgrads, ref["window_grads"])]
    del fgrads
    batch = bert_cp_batch(torch, 30592)
    trainer, ref["bert_losses"], grads, _ = bert_tp_steps(torch, ops, batch,
                                                          steps=1)
    ref["bert_names"] = [n for n, _ in trainer.model.named_parameters()]
    ref["bert_grads"] = [g.cpu() for g in grads]
    del trainer, grads
    _, _, fgrads, _ = bert_tp_steps(torch, ops, batch, steps=1,
                                    compute_dtype=torch.float32)
    ref["bert_floor"] = [l2_err(f.cpu(), g)
                         for f, g in zip(fgrads, ref["bert_grads"])]
    del fgrads
    _, _, o0, _ = bert_tp_steps(torch, ops, batch, steps=1,
                                opt_level="O0", o2_values=True)
    o0 = [g.cpu() for g in o0]
    ref["bert_o0_over"] = sorted(
        (round(l2_err(g, r) / max(f, 1e-12), 2), n) for n, g, r, f in zip(
            ref["bert_names"], o0, ref["bert_grads"], ref["bert_floor"])
        if l2_err(g, r) > f)[-3:]
    ref["bert_floor"] = [max(f, l2_err(g, r)) for f, g, r in zip(
        ref["bert_floor"], o0, ref["bert_grads"])]
    _, ref["bert_o0_losses"], o0, _ = bert_tp_steps(torch, ops, batch,
                                                    steps=1, opt_level="O0")
    ref["bert_o0_grads"] = [g.cpu() for g in o0]
    del o0
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def cp_world1(torch, ops, dev, total):
    """(a): NCCL at world size 1 in this process, on a context axis of 1:
    ``ring_attention`` and ``ulysses_attention`` at the ring's shard shape
    (:data:`CP_A_SHAPE`, bf16), causal and with a window
    (:data:`CP_A_WINDOW`), forward and grads bit for bit
    ``flash_attention``'s."""
    from apex_tpu_torch.ops import flash_attention
    from apex_tpu_torch.parallel import mesh, multiproc
    from apex_tpu_torch.transformer import ring

    check(multiproc.initialize_distributed(
        f"127.0.0.1:{free_port()}", 1, 0), "NCCL world 1 initialized")
    import torch.distributed as dist

    backend = dist.get_backend()
    group = "context parallel (a) NCCL world 1"
    gen = torch.Generator(device=dev).manual_seed(18)
    try:
        mesh.initialize_model_parallel(context_parallel_size=1)
        q, k, v, do = (torch.randn(*CP_A_SHAPE, device=dev,
                                   generator=gen).to(torch.bfloat16)
                       for _ in range(4))

        def run(fn, **kw):
            xs = [t.detach().requires_grad_() for t in (q, k, v)]
            o = fn(*xs, causal=True, **kw)
            o.backward(do)
            return [o.detach()] + [x.grad for x in xs]

        for window in (None, CP_A_WINDOW):
            ops.reset_launch_counts()
            want = run(flash_attention, window=window)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            total.update({k_: total.get(k_, 0) + c
                          for k_, c in counts.items()})
            for name, fn in (("ring", ring.ring_attention),
                             ("ulysses", ring.ulysses_attention)):
                ops.reset_launch_counts()
                got = run(fn, window=window)
                torch.cuda.synchronize()
                c = ops.launch_counts()
                check(c == counts, f"(a) {name} launches {c} as "
                      f"flash_attention's {counts}")
                total.update({k_: total.get(k_, 0) + n
                              for k_, n in c.items()})
                same = [torch.equal(a, b) for a, b in zip(got, want)]
                label = f"window {window}" if window else "causal"
                print(f"  (a) {name}_attention over {backend} (world size "
                      f"1), {CP_A_SHAPE} bf16 {label}: o, dq, dk, dv "
                      f"bit-identical to flash_attention's {same}")
                verdict(f"cp (a) {name} {label} bit for bit "
                        f"flash_attention", 0 if all(same) else 1, 0,
                        group=group)
        del q, k, v, do
    finally:
        multiproc.shutdown()
    gc.collect()
    torch.cuda.empty_cache()


def cp_two_ranks(torch, total, smi, ref, procs, outs):
    """(b): the two gloo ranks' results, each case's verdicts."""
    import pickle

    end = time.monotonic() + 900
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    check(not alive, "the two gloo ranks finished within 900 s")
    res = []
    for r, path in enumerate(outs):
        check(os.path.exists(path), f"gloo rank {r} left no result")
        with open(path, "rb") as f:
            res.append(pickle.load(f))
    for r in res:
        check("error" not in r,
              f"gloo rank {r['rank']}: {r.get('error', '')[-3000:]}")
    group = "context parallel (b) 2 gloo ranks on the card"
    print(f"  (b) the wires (backend, ring shift exact, bf16 all-to-all "
          f"exact): {[r['wire'] for r in res]}")
    for r in res:
        verdict(f"cp (b) rank {r['rank']} ring shift and all-to-all of "
                f"bf16 CUDA tensors arrive exact",
                0 if all(r["wire"][1:]) else 1, 0, group=group)

    def losses_rel(got, want):
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))

    for impl in ("ring", "ulysses"):
        xs = [r[impl] for r in res]
        print(f"  (b) train_long_context --cp 2 --sp-impl {impl} (345M O2, "
              f"8192 tokens, 4096 a rank, --lm-head-chunks 8): losses "
              f"{[x['losses'] for x in xs]} (serial {ref['losses']}); "
              f"step 1's grads by share and row {[x['errs'] for x in xs]}, "
              f"L2 over the floor, worst {[x['floor_ratio'] for x in xs]}; "
              f"{[round(x['s'], 1) for x in xs]} s (host-staged gloo, not "
              f"speed numbers)")
        for r, x in zip(res, xs):
            rk = r["rank"]
            verdict(f"cp (b) {impl} rank {rk} losses rel to serial",
                    losses_rel(x["losses"], ref["losses"]), CP_LOSS_REL,
                    group=group)
            verdict(f"cp (b) {impl} rank {rk} worst grad leaf L2 over the "
                    f"serial fp32-compute distance", x["floor_ratio"][0][0],
                    CP_FLOOR, group=group)
    ts = [r["twin"] for r in res]
    print(f"  (b) the ring's O0 twin ({CP_TWIN_LAYERS} layers, fp32 params "
          f"and compute, 8192 tokens, 1 step): losses "
          f"{[t['loss'] for t in ts]} (serial "
          f"{ref['twin_loss']}); grads by share and row "
          f"{[t['errs'] for t in ts]}")
    for r, t in zip(res, ts):
        rk = r["rank"]
        verdict(f"cp (b) O0 twin rank {rk} step-1 loss rel to serial",
                abs(t["loss"] - ref["twin_loss"]) / abs(ref["twin_loss"]),
                CP_TWIN_LOSS_REL, group=group)
        verdict(f"cp (b) O0 twin rank {rk} step-1 grads", t["errs"][0],
                CP_TWIN_GRAD[0], group=group)
        verdict(f"cp (b) O0 twin rank {rk} step-1 grads row", t["errs"][1],
                CP_TWIN_GRAD[1], group=group)
    ws = [r["window"] for r in res]
    print(f"  (b) train_long_context --cp 2 --seq 16384 --pos rope --window "
          f"4096 (ring, the window across the shard boundary): losses "
          f"{[w['losses'] for w in ws]} (serial {ref['window_losses']}); "
          f"step 1's grads L2 over the floor, worst "
          f"{[w['floor_ratio'] for w in ws]}")
    for r, w in zip(res, ws):
        rk = r["rank"]
        verdict(f"cp (b) window rank {rk} losses rel to serial",
                losses_rel(w["losses"], ref["window_losses"]), CP_LOSS_REL,
                group=group)
        verdict(f"cp (b) window rank {rk} worst grad leaf L2 over the "
                f"serial fp32-compute distance", w["floor_ratio"][0][0],
                CP_FLOOR, group=group)
    bs = [r["bert"] for r in res]
    print(f"  (b) BERT-large O2 FusedLAMB, 8 x 512 with padding as segment "
          f"ids, ring at cp 2, NSP included: losses "
          f"{[b['losses'] for b in bs]} (serial bias route "
          f"{ref['bert_losses']}); step 1's grads L2 over the floor, worst "
          f"{[b['floor_ratio'] for b in bs]} (the floor from the O0 step "
          f"where it is above the fp32-compute one, by their ratio: "
          f"{ref['bert_o0_over']}); card: {smi}")
    os_ = [r["bert_o0"] for r in res]
    print(f"  (b) BERT-large at cp 2, its O0 twin (fp32 params and compute, "
          f"1 step) against the serial O0 step: losses "
          f"{[o['loss'] for o in os_]} (serial {ref['bert_o0_losses'][0]}); "
          f"grads (share, row) {[o['errs'] for o in os_]}")
    for r, o in zip(res, os_):
        rk = r["rank"]
        verdict(f"cp (b) BERT O0 twin rank {rk} step-1 loss rel to serial",
                abs(o["loss"] - ref["bert_o0_losses"][0])
                / abs(ref["bert_o0_losses"][0]), CP_TWIN_LOSS_REL,
                group=group)
        verdict(f"cp (b) BERT O0 twin rank {rk} step-1 grads",
                o["errs"][0], CP_BERT_TWIN_GRAD[0], group=group)
        verdict(f"cp (b) BERT O0 twin rank {rk} step-1 grads row",
                o["errs"][1], CP_BERT_TWIN_GRAD[1], group=group)
    for r, b in zip(res, bs):
        rk = r["rank"]
        verdict(f"cp (b) BERT rank {rk} loss rel to serial",
                losses_rel(b["losses"], ref["bert_losses"]), CP_LOSS_REL,
                group=group)
        verdict(f"cp (b) BERT rank {rk} worst grad leaf L2 over the serial "
                f"fp32-compute distance", b["floor_ratio"][0][0], CP_FLOOR,
                group=group)
    for r in res:
        for label, steps, counts, per_step in r["counts"]:
            check_counts(counts, expected_counts(counts, steps, per_step),
                         "cp")
            total.update({k: total.get(k, 0) + v for k, v in counts.items()})
    return res


def cp_phase(torch, ops, dev):
    """Phase 18: (b)'s ranks spawned first; this process computes their
    serial references (:func:`cp_references`) and runs (a)
    (:func:`cp_world1`) meanwhile, then (b)'s verdicts. Returns the
    launches of the context-parallel runs (path ``cp``: (a)'s and both
    ranks')."""
    import shutil

    t0 = time.perf_counter()
    smi = nvidia_smi()
    total = {}
    ref_dir = os.path.join(HERE, "build", "cp_check")
    shutil.rmtree(ref_dir, ignore_errors=True)
    os.makedirs(ref_dir)
    procs = []
    try:
        procs, outs = cp_spawn(ref_dir)
        ref = cp_references(torch, ops)
        torch.save(ref, os.path.join(ref_dir, "ref.tmp"))  # whole, or absent
        os.replace(os.path.join(ref_dir, "ref.tmp"),
                   os.path.join(ref_dir, "ref.pt"))
        top = sorted((round(v, 4) for v in ref["floor"]), reverse=True)[:3]
        print(f"  (b) the serial references in {time.perf_counter() - t0:.1f}"
              f" s; the 345M run's bf16 grads' L2 distance from its "
              f"fp32-compute twin's (the floor), largest {top}")
        small = {k: v for k, v in ref.items()
                 if "loss" in k or k == "bert_o0_over"}
        del ref
        gc.collect()
        cp_world1(torch, ops, dev, total)
        cp_two_ranks(torch, total, smi, small, procs, outs)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(ref_dir, ignore_errors=True)
    print(f"  phase 18 launches {total}; phase 18 took "
          f"{time.perf_counter() - t0:.1f} s; card: {smi}")
    return total


def cp_main():
    """``python3 chip_smoke.py --cp``: phase 18 alone after the build, with
    its verdict."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from apex_tpu_torch import ops
    from apex_tpu_torch.csrc import build

    print(f"card: {nvidia_smi()}; torch {torch.__version__}")
    build.load()
    torch.empty(1, device="cuda")
    cp_phase(torch, ops, torch.device("cuda", 0))
    print_verdict()
    return 0


# ---------------------------------------------------------------------------
# phase 19: mixture of experts (routed-expert FFNs; expert parallelism over
# the data axis: NCCL at world size 1, two gloo ranks on the card; serving)
# ---------------------------------------------------------------------------

#: GPT-2 345M-MoE: phase 10's pretrain argv with 8 experts in every layer,
#: top-2 at capacity factor 1.25 (the MoE example's defaults): vocab 50304,
#: hidden 1024, 24 layers, 16 heads, seq 1024, O2, FusedAdam, full remat
MOE_345M = PRETRAIN_345M + ["--moe-experts", "8"]
MOE_STEPS = 4
#: (d): NCCL at world size 1, the experts on the data axis of 1
MOE_WORLD1_STEPS = 2
#: (e)'s exact comparison at full width and depth: capacity factor E / k
#: = 4 (C = N: neither side drops a token) and one micro-batch of (b)'s 8
#: rows a step, so the router statistics of the serial run's micro-batch
#: and of the two ranks' micro-batches (4 rows each, pmean'd) cover the
#: same rows: ep 2 is then the serial run up to rounding (argparse keeps
#: the last --micro-batch)
MOE_EXACT_345M = MOE_345M + ["--moe-capacity-factor", "4", "--micro-batch",
                             "8", "--num-microbatches", "1"]
MOE_EP_345M = MOE_EXACT_345M + ["--micro-batch", "4"]
MOE_EP_STEPS = 2
#: (e)'s wire, ZeRO and pipeline cases: 345M-MoE width at 4 layers, cf
#: 1.25, 2 rows a micro-batch a rank: (b)'s global batch of 8 rows
MOE_LAYERS = 4
MOE_SMALL_EP = MOE_345M + ["--micro-batch", "2"]
MOE_SMALL_STEPS = 2
#: (a)'s gradient gate and (c)'s greedy gate: a small MoE GPT in fp32
MOE_GATE = dict(vocab_size=1024, hidden_size=256, num_layers=2,
                num_attention_heads=4, max_seq_len=256, hidden_dropout=0.0,
                moe_num_experts=8)
#: (c)'s and (e)'s engines: GPT-2 345M's width (the config's defaults)
MOE_SERVE = {}
MOE_GATE_CASES = (("top-1", dict(moe_top_k=1)),
                  ("top-2", dict(moe_top_k=2)),
                  ("top-2 congested (cf 0.5)",
                   dict(moe_top_k=2, moe_capacity_factor=0.5)))
#: limits: (a) phase 4's gate (loss 1e-5 relative, each grad 1e-4 of its
#: max |CPU grad|), the dropped fraction equal; (e) at full width the
#: losses against the serial run of :data:`MOE_EXACT_345M` by phase 14's
#: relative limit and its step-1 grads by their floor as phases 15-17
#: hold theirs (each leaf's L2 distance from the serial grad, an expert
#: leaf from its rank's experts' rows, over the serial run's own distance
#: from its fp32-compute twin, at most :data:`TP_FLOOR`); at 4 layers and
#: cf 1.25 the losses against the serial run by phase 14's limit (the EP
#: run caps capacity per rank and groups a micro-batch's router statistics
#: over both ranks' rows, the serial run over its own: the reference's
#: documented divergence, reported), the 1-byte wires within phase 16's
#: band of the exact wire, ZeRO-2 against the replicated optimizer by
#: phase 16's limits, pp 2 against serial by phase 17's
MOE_LOSS_REL = DP_LOSS_REL


def moe_gradient_gate(torch, ops, dev):
    """(a): the small MoE GPT in fp32 on the card through the kernels and
    on the CPU through the plain versions, top-1, top-2 and top-2 under
    congestion (tokens dropped): the loss, every grad (the router's and the
    experts' included) and the dropped fraction; then two calls of one
    ``MoEMLP`` on the card bit for bit equal."""
    import numpy as np

    from apex_tpu_torch.models import GPTConfig, GPTModel

    group = "MoE (a) fp32 gradient gate"
    for label, over in MOE_GATE_CASES:
        cfg = GPTConfig(compute_dtype=torch.float32, **MOE_GATE, **over)
        card = GPTModel(cfg, device=dev, seed=7)
        host = GPTModel(cfg, device="cpu", seed=7)
        host.load_state_dict({k: v.cpu()
                              for k, v in card.state_dict().items()})
        rng = np.random.default_rng(7)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)))
        targets = torch.roll(tokens, -1, dims=-1)
        ops.reset_launch_counts()
        loss_c = card.loss(tokens.to(dev), targets.to(dev))
        loss_c.backward()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        loss_h = host.loss(tokens, targets)
        loss_h.backward()
        with torch.no_grad():
            drop_c = float(card.run_layers(card.embed(tokens.to(dev)),
                                           return_aux=True)[1][
                "dropped_fraction"])
            drop_h = float(host.run_layers(host.embed(tokens),
                                           return_aux=True)[1][
                "dropped_fraction"])
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv", "layer_norm_fwd",
                     "layer_norm_bwd"):
            check(counts[name] > 0, f"MoE gate {label} never launched {name}")
        lc, lh = float(loss_c.detach()), float(loss_h.detach())
        rel = abs(lc - lh) / abs(lh)
        worst, router = (0.0, ""), 0.0
        for (name, pc), ph in zip(card.named_parameters(),
                                  host.parameters()):
            check(pc.grad is not None and ph.grad is not None,
                  f"MoE gate {label}: no grad for {name}")
            e = rel_err(pc.grad.cpu(), ph.grad)
            worst = max(worst, (e, name))
            if "router" in name:
                router = max(router, e)
        print(f"  (a) fp32 MoE gate {label}: loss card {lc:.7f} cpu "
              f"{lh:.7f} (rel {rel:.3g}); dropped fraction (summed over "
              f"the layers) card {drop_c} cpu {drop_h}; worst grad "
              f"{worst[0]:.3g} ({worst[1]}), "
              f"router {router:.3g}; launches {counts}")
        verdict(f"MoE gate {label} loss", rel, 1e-5, group=group)
        verdict(f"MoE gate {label} worst grad ({worst[1]})", worst[0], 1e-4,
                group=group)
        verdict(f"MoE gate {label} dropped fraction card vs cpu",
                abs(drop_c - drop_h), 0, group=group)
        if "congested" in label:
            check(drop_c > 0, "the congested gate drops tokens")
            moe = card.layers[0].moe
            gen = torch.Generator(device=dev)
            gen.manual_seed(3)
            x = torch.randn(512, cfg.hidden_size, device=dev, generator=gen)
            with torch.no_grad():
                a, aux_a = moe.apply(x)
                b, aux_b = moe.apply(x)
            same = bool(torch.equal(a, b)) and all(
                torch.equal(aux_a[k], aux_b[k]) for k in aux_a)
            print(f"  (a) two calls of MoEMLP on the card (512 tokens, "
                  f"dropped {float(aux_a['dropped_fraction']):.4f}): "
                  f"bit-identical {same}")
            verdict("MoE MoEMLP two calls on the card bit-identical",
                    0 if same else 1, 0, group=group)
        del card, host


def moe_aux_hook(into):
    """A ``pretrain_steps`` hook recording every router-aux fold of the
    model (one a micro-batch) as floats."""
    def hook(bench):
        real = bench.model.aux_to_loss

        def record(aux):
            into.append({k: float(v.detach()) for k, v in aux.items()})
            return real(aux)

        bench.model.aux_to_loss = record
    return hook


def moe_345m(torch, ops, dev, total):
    """(b): ``pretrain_gpt --moe-experts 8`` at 345M width and depth, O2,
    :data:`MOE_STEPS` steps on the example stream's first batch (one batch:
    a fall over a few steps is not lost in the batches' spread): the
    losses fall, no
    step skipped, the launches exact by the dense schedule (MoE adds no
    kernel), the router losses and dropped fraction, the step ms (one more
    step, untraced), the peak memory and the device's idle share (one
    traced step: its kernels' device time over the untraced step's
    wall time). Returns the losses and the params' fingerprints after each
    step ((d)'s reference)."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.examples.gpt import pretrain_gpt

    aux = []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    bench, losses, snaps, _, counts = pretrain_steps(
        torch, ops, MOE_345M, MOE_STEPS, snap=True, snap_to="cpu",
        hook=moe_aux_hook(aux), fixed=True)
    fps = [param_fingerprint(torch, s) for s in snaps]
    del snaps
    c = bench.cfg
    n_params = sum(p.numel() for p in bench.model.parameters())
    L, M = c.num_layers, 2
    check(c.moe_num_experts == 8 and c.moe_top_k == 2
          and c.moe_capacity_factor == 1.25 and c.moe_expert_axis is None,
          "(b) 345M-MoE: 8 experts top-2 cf 1.25, serial")
    check_counts(counts, expected_counts(counts, MOE_STEPS,
                                         pretrain_per_step(L, M)), "moe")
    total.update({k: total.get(k, 0) + v for k, v in counts.items()})
    args = pretrain_gpt.parse_args(MOE_345M)
    batch = next(pretrain_gpt.batches(args, bench.batch))
    batch = tuple(t.to(dev) for t in batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = bench.step(*batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    idle = "not measured"
    try:
        # the CUDA activity alone, as device_busy: the busy time is the
        # kernels' (over the untraced step's wall time)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bench.step(*batch)
            torch.cuda.synchronize()
        busy = sum(t for _, t in device_time_by_kernel(torch,
                                                       prof).values()) / 1e3
        if busy > 0:
            idle = f"{1 - busy / step_ms:.3f} ({busy:.1f} ms of kernels)"
    except Exception as e:  # noqa: BLE001 - the profiler is reported only
        idle = f"not measured ({type(e).__name__})"
    lb = [a["load_balancing_loss"] / L for a in aux[:MOE_STEPS * M]]
    z = [a["router_z_loss"] / L for a in aux[:MOE_STEPS * M]]
    drop = [a["dropped_fraction"] / L for a in aux[:MOE_STEPS * M]]
    tokens = bench.batch * c.max_seq_len
    print(f"  (b) pretrain_gpt --moe-experts 8 (345M-MoE: {n_params / 1e9:.3f}"
          f" B params, top-2, cf 1.25, O2, full remat), {MOE_STEPS} steps of "
          f"{bench.batch} x 1024 as 2 micro-batches: losses {losses}; per "
          f"micro-batch the mean per layer of the load-balancing loss "
          f"{[round(v, 4) for v in lb]}, the z-loss "
          f"{[round(v, 3) for v in z]}, the dropped fraction "
          f"{[round(v, 4) for v in drop]}; step {step_ms:.1f} ms "
          f"({tokens / step_ms * 1e3:.0f} tokens/s), peak "
          f"{peak:.2f} GiB, device idle share {idle}; launches {counts}")
    check(not m["found_inf"], "the timed 345M-MoE step not skipped")
    check(all(math.isfinite(v) for v in losses + lb + z), "(b) finite")
    verdict("MoE (b) 345M-MoE loss falls (last - first)",
            0 if losses[-1] < losses[0] else losses[-1] - losses[0], 0,
            group="MoE (b) 345M-MoE training")
    del bench, batch
    gc.collect()
    torch.cuda.empty_cache()
    return losses, fps


def moe_world1(torch, ops, dev, total, slosses, sfps):
    """(d): NCCL at world size 1: the 345M-MoE run with its experts on the
    data axis (size 1), so the dispatch and combine are all-to-alls over
    NCCL and the expert grads reduce by spec, :data:`MOE_WORLD1_STEPS`
    steps: losses and params after each step bit for bit (b)'s."""
    from apex_tpu_torch.parallel import multiproc

    check(multiproc.initialize_distributed(
        f"127.0.0.1:{free_port()}", 1, 0), "NCCL world 1 initialized")
    import torch.distributed as dist

    backend = dist.get_backend()
    try:
        bench, losses, snaps, _, counts = pretrain_steps(
            torch, ops, MOE_345M, MOE_WORLD1_STEPS, snap=True,
            snap_to="cpu", fixed=True, moe_expert_axis="data")
        check(bench.cfg.moe_expert_axis == "data", "(d) experts on data")
        L = bench.cfg.num_layers
        check_counts(counts, expected_counts(
            counts, MOE_WORLD1_STEPS, pretrain_per_step(L, 2)), "moe")
        total.update({k: total.get(k, 0) + v for k, v in counts.items()})
        same = [losses == slosses[:MOE_WORLD1_STEPS]] + [
            bool(torch.equal(param_fingerprint(torch, s), f))
            for s, f in zip(snaps, sfps)]
        print(f"  (d) 345M-MoE with its experts on the data axis over "
              f"{backend} (world size 1), {MOE_WORLD1_STEPS} steps: losses "
              f"{losses} (serial {slosses[:MOE_WORLD1_STEPS]}); losses and "
              f"params after each step bit-identical to (b): {same}")
        verdict("MoE (d) EP at world 1 bit for bit the serial run",
                0 if all(same) else 1, 0, group="MoE (d) NCCL world 1")
        del bench, snaps
    finally:
        multiproc.shutdown()
    gc.collect()
    torch.cuda.empty_cache()


def moe_serving(torch, ops, dev, total):
    """(c): the small fp32 MoE engine's greedy tokens against the
    full-context argmax (at a capacity that drops nothing); then 16 requests at 345M-MoE width (phase 3's mix:
    64-768-token prompts, 64 new tokens, 8 slots): the launches exact,
    the output checks of phase 3, no page left."""
    import numpy as np

    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.serve import Engine, Request, ServeConfig

    # capacity factor E / k: C = ceil(k N cf / E) = N tokens, so no call
    # drops a token and each token's output is its own (the engine routes
    # a prefill's, a decode tick's slots' tokens together, the full-context
    # forward the whole sequence's: with drops the two would differ)
    small = GPTModel(GPTConfig(compute_dtype=torch.float32, remat=False,
                               **dict(MOE_GATE, moe_top_k=2,
                                      moe_capacity_factor=8 / 2)),
                     device=dev, seed=5)
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=list(rng.integers(0, 1024, n)),
                    max_new_tokens=m, request_id=i)
            for i, (n, m) in enumerate(((5, 16), (60, 12), (17, 20),
                                        (33, 9), (1, 16), (100, 24)))]
    eng = Engine(small, ServeConfig(max_batch=4, max_seq=128, block_size=16),
                 device=dev)
    res = eng.run(reqs)
    checked = check_greedy(torch, small, res, "MoE gate")
    check(len(res) == len(reqs) and eng.allocator.used == 0,
          "MoE gate drain")
    print(f"  (c) fp32 MoE greedy gate: {len(res)} requests, {checked} "
          f"generated tokens equal the full-context argmax")
    del small, eng
    cfg = GPTConfig(moe_num_experts=8, **MOE_SERVE)  # 345M-MoE, top-2
    model = GPTModel(cfg, device=dev, seed=0)
    eng = Engine(model, ServeConfig(max_batch=8, max_seq=1024,
                                    block_size=16), device=dev)
    eng.run([Request(prompt=list(range(64)), max_new_tokens=4,
                     request_id="warmup")])
    reqs = mix_345m(cfg)
    p0, d0 = eng.prefills, eng.decode_steps
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    prefills, ticks = eng.prefills - p0, eng.decode_steps - d0
    L = cfg.num_layers
    expected = dict.fromkeys(counts, 0)
    expected.update({"flash_attention_fwd": L * prefills,
                     "flash_decode": L * ticks,
                     "layer_norm_fwd": (2 * L + 1) * (prefills + ticks)})
    check(prefills == len(reqs), "MoE serve: one prefill per request")
    check_counts(counts, expected, "moe")
    total.update({k: total.get(k, 0) + v for k, v in counts.items()})
    check_moe_serve_output(torch, model, eng, res, reqs)
    check(eng.allocator.used == 0, "MoE serve: every page freed")
    m = latency(res, wall)
    print(f"  (c) 345M-MoE serve: {len(res)} requests, {prefills} prefills, "
          f"{ticks} decode ticks, {m['tokens']} tokens in {wall:.3f} s = "
          f"{m['tokens_s']:.1f} tokens/s, TTFT p50 {m['ttft_ms']:.2f} ms, "
          f"ITL p50 {m['itl_ms']:.2f} ms; launches {counts}")
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()


def check_moe_serve_output(torch, model, eng, res, reqs, new=64):
    """Phase 3's output checks for an MoE engine: every request got its
    tokens, in range; one request's first token is in the top 5 (bf16) of
    a full forward over what its prefill routed -- the prompt padded to
    ``prefill_len`` -- since an MoE layer's capacity drops depend on the
    tokens routed together (a forward over prompt + generated tokens
    drops others and moves near-tied logits past the top 5)."""
    vocab = model.cfg.vocab_size
    check(len(res) == len(reqs) and all(len(r.tokens) == new
                                        for r in res.values()),
          "MoE serve: every request got its tokens")
    check(all(0 <= t < vocab for r in res.values() for t in r.tokens),
          "MoE serve: token range")
    r = res[reqs[3].request_id]
    plen = len(r.prompt)
    seq = list(r.prompt) + [0] * (eng.config.prefill_len - plen)
    logits = model.apply(torch.tensor([seq], device=model.device))[0].float()
    check(bool(torch.isfinite(logits).all()), "345M-MoE logits finite")
    top5 = torch.topk(logits[plen - 1], 5).indices.tolist()
    check(r.tokens[0] in top5, "345M-MoE first token in the top 5 of the "
          "forward over its padded prompt")


def moe_small_argv(flags=(), layers=MOE_LAYERS):
    return zero_argv(MOE_SMALL_EP, flags, layers)


def moe_exact_reference(torch, ops, total):
    """(e)'s exact reference: the serial run of :data:`MOE_EXACT_345M`,
    :data:`MOE_EP_STEPS` steps on the stream's first batch (launches exact,
    nothing dropped), its step-1 grads on the host, and each leaf's bf16
    floor: its L2 distance from the same step's grads in fp32 compute on
    the same bf16 params."""
    aux = []
    bench, losses, _, grads, counts = pretrain_steps(
        torch, ops, MOE_EXACT_345M, MOE_EP_STEPS, hook=moe_aux_hook(aux),
        fixed=True)
    c = bench.cfg
    check(c.moe_capacity_factor == 4.0 and c.moe_expert_axis is None
          and bench.batch == 8, "(e) exact reference: serial, cf 4, 8 rows")
    check(all(a["dropped_fraction"] == 0 for a in aux),
          "(e) exact reference drops no token")
    check_counts(counts, expected_counts(
        counts, MOE_EP_STEPS, pretrain_per_step(c.num_layers, 1)), "moe")
    total.update({k: total.get(k, 0) + v for k, v in counts.items()})
    names = [n for n, _ in bench.model.named_parameters()]
    grads = [g.cpu() for g in grads]
    del bench
    gc.collect()
    torch.cuda.empty_cache()
    _, flosses, _, fgrads, _ = pretrain_steps(
        torch, ops, MOE_EXACT_345M, 1, fixed=True,
        compute_dtype=torch.float32)
    floor = [l2_err(f.cpu(), g) for f, g in zip(fgrads, grads)]
    del fgrads
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "loss_f32": flosses[0], "grads": grads,
            "names": names, "floor": floor}


def moe_floor_ratios(torch, model, grads, ref, rank):
    """Each step-1 grad's L2 distance from the serial run's over its
    floor, the worst three [(ratio, name)]: an expert-sharded leaf (dim 0
    this rank's experts) against its rows of the serial grad."""
    names = [n for n, _ in model.named_parameters()]
    check(names == ref["names"], "(e) the EP model's leaves are serial's")
    out = []
    for n, g, r, f in zip(names, grads, ref["grads"], ref["floor"]):
        if g.shape != r.shape:
            e = g.shape[0]
            r = r[rank * e:(rank + 1) * e]
        out.append((l2_err(g.cpu(), r) / max(f, 1e-12), n))
    return sorted(out, reverse=True)[:3]


def _moe_rank(rank, world, port, ref_dir, out_path):
    """One gloo rank of phase 19 (e) on the card: at 4 layers the exact,
    int8 and e5m2 wires, ``--zero`` (level 2) and ``--pp 2``, then the EP
    engine against the serial engine, then ep 2 at full width and depth
    against the parent's exact reference; the results go back to the
    parent in ``out_path``."""
    import pickle
    import traceback

    import torch

    sys.path.insert(0, HERE)
    res = {"rank": rank, "counts": []}
    try:
        from apex_tpu_torch import ops
        from apex_tpu_torch.models import GPTConfig, GPTModel
        from apex_tpu_torch.parallel import mesh, multiproc
        from apex_tpu_torch.serve import Engine, Request, ServeConfig

        multiproc.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                         backend="gloo", timeout_s=600)
        dev = torch.device("cuda", 0)
        mesh.initialize_model_parallel()
        # 1. the 4-layer cases (cf 1.25), while the parent runs the exact
        # reference
        lr = float(MOE_345M[MOE_345M.index("--lr") + 1])
        base = None
        for label, flags in (("exact", ()),
                             ("int8", ("--moe-dispatch-dtype", "int8")),
                             ("e5m2", ("--moe-dispatch-dtype", "e5m2")),
                             ("zero", ("--zero-level", "2")),
                             ("pp 2", ("--pp", "2", "--micro-batch", "4"))):
            if label == "pp 2":
                mesh.destroy_model_parallel()
            bench, losses, snaps, _, counts = pretrain_steps(
                torch, ops, moe_small_argv(flags), MOE_SMALL_STEPS,
                snap=label in ("exact", "zero"), snap_to="cpu", fixed=True)
            c = bench.cfg
            x = {"losses": losses, "axis": c.moe_expert_axis}
            if label == "pp 2":
                per = pp_per_step(c.num_layers, 2, world, 1, "1f1b",
                                  rank == world - 1)
                x["layers_here"] = len(bench.model.layers)
            else:
                per = pretrain_per_step(c.num_layers, 2)
            if label == "exact":
                base = snaps
            if label == "zero":
                x["drift"] = [params_drift(torch, a, b, lr, k + 1)
                              for k, (a, b) in enumerate(zip(snaps, base))]
            res["counts"].append((label, MOE_SMALL_STEPS, counts, per))
            res[label] = x
            del bench, snaps
            gc.collect()
            torch.cuda.empty_cache()
        del base
        # 2. the EP engine against the serial engine (fp32, 4 layers)
        mesh.destroy_model_parallel()
        mesh.initialize_model_parallel()
        cfg = GPTConfig(**dict(MOE_SERVE, num_layers=MOE_LAYERS),
                        moe_num_experts=8, compute_dtype=torch.float32)
        ep = GPTModel(dataclasses.replace(cfg, moe_expert_axis="data"),
                      device=dev, seed=0)
        serial = GPTModel(cfg, device=dev, seed=0)
        import numpy as np

        rng = np.random.default_rng(9)
        reqs = [(list(rng.integers(0, cfg.vocab_size, n)), 16)
                for n in (40, 200, 7, 513, 96, 300, 64, 128)]
        toks = {}
        for name, model, kw in (("ep", ep, {"mesh": mesh.get_mesh()}),
                                ("serial", serial, {})):
            eng = Engine(model, ServeConfig(max_batch=4, max_seq=1024,
                                            block_size=16), device=dev, **kw)
            out = eng.run([Request(prompt=p, max_new_tokens=m,
                                   request_id=i)
                           for i, (p, m) in enumerate(reqs)])
            toks[name] = {i: r.tokens for i, r in out.items()}
            toks[name + "_used"] = eng.allocator.used
            del eng
        res["engine"] = toks
        del ep, serial
        gc.collect()
        torch.cuda.empty_cache()
        # 3. ep 2 at 345M-MoE width and depth against the exact reference,
        # once the parent has written it (and freed its card memory)
        ref = wait_for_references(torch, ref_dir)
        aux = []
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        bench, losses, _, grads, counts = pretrain_steps(
            torch, ops, MOE_EP_345M, MOE_EP_STEPS, hook=moe_aux_hook(aux),
            fixed=True)
        c = bench.cfg
        res["full"] = {
            "losses": losses, "s": time.perf_counter() - t0,
            "peak": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "axis": c.moe_expert_axis, "batch": bench.batch,
            "cf": c.moe_capacity_factor,
            "experts_here": bench.model.layers[0].moe.fc1.kernel.shape[0],
            "dropped": [a["dropped_fraction"] / c.num_layers for a in aux],
            "floor_ratio": moe_floor_ratios(torch, bench.model, grads, ref,
                                            rank)}
        res["counts"].append(("ep 2 345M-MoE", MOE_EP_STEPS, counts,
                              pretrain_per_step(c.num_layers, 1)))
        del bench, grads, ref
    except Exception:  # noqa: BLE001 - reported by the parent
        res["error"] = traceback.format_exc()
    finally:
        try:
            from apex_tpu_torch.parallel import multiproc

            multiproc.shutdown()
        except Exception as e:  # noqa: BLE001
            res.setdefault("error", f"shutdown: {e}")
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def moe_spawn(ref_dir, world=2):
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    outs = [os.path.join(ref_dir, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_moe_rank,
                         args=(r, world, port, ref_dir, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs


def moe_two_ranks(torch, total, smi, exact, small, procs, outs):
    """(e): the two gloo ranks' results, each case's verdicts."""
    import pickle

    end = time.monotonic() + 900
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    check(not alive, "the two gloo ranks finished within 900 s")
    res = []
    for r, path in enumerate(outs):
        check(os.path.exists(path), f"gloo rank {r} left no result")
        with open(path, "rb") as f:
            res.append(pickle.load(f))
    for r in res:
        check("error" not in r,
              f"gloo rank {r['rank']}: {r.get('error', '')[-3000:]}")
    group = "MoE (e) 2 gloo ranks on the card"
    fs = [r["full"] for r in res]
    ref = exact["losses"]
    rels = [[abs(a - b) / abs(b) for a, b in zip(f["losses"], ref)]
            for f in fs]
    top = sorted(((round(v, 4), n) for v, n in zip(exact["floor"],
                                                  exact["names"])),
                 reverse=True)[:3]
    print(f"  (e) pretrain_gpt --moe-experts 8 --moe-capacity-factor 4 at "
          f"dp 2 (ep 2: {[f['experts_here'] for f in fs]} experts a rank, "
          f"345M-MoE, {fs[0]['batch']} x 1024 a step as one micro-batch of "
          f"4 a rank): losses {[f['losses'] for f in fs]} (serial, one "
          f"micro-batch of 8: {ref}; its step 1 in fp32 compute "
          f"{exact['loss_f32']}), relative gaps {rels}; step 1's grads L2 "
          f"over the floor, worst {[f['floor_ratio'] for f in fs]} (the "
          f"serial run's distance from its fp32-compute twin, largest "
          f"{top}); dropped fraction {[f['dropped'] for f in fs]}; peak "
          f"{[round(f['peak'], 2) for f in fs]} GiB a rank; "
          f"{[round(f['s'], 1) for f in fs]} s (host-staged gloo, not "
          f"speed numbers)")
    for r, f, rel in zip(res, fs, rels):
        rk = r["rank"]
        check(f["axis"] == "data" and f["experts_here"] == 4
              and f["batch"] == 8 and f["cf"] == 4.0,
              f"(e) rank {rk}: ep 2, 4 experts here, cf 4")
        check(all(v == 0 for v in f["dropped"]),
              f"(e) rank {rk}: cf 4 drops no token")
        verdict(f"MoE (e) ep 2 345M-MoE cf 4 rank {rk} losses rel to serial",
                max(rel), MOE_LOSS_REL, group=group)
        verdict(f"MoE (e) ep 2 345M-MoE cf 4 rank {rk} step-1 grads L2 over "
                f"the serial fp32-compute distance", f["floor_ratio"][0][0],
                TP_FLOOR, group=group)
    ex = [r["exact"] for r in res]
    print(f"  (e) at {MOE_LAYERS} layers, cf 1.25: ep 2 exact wire losses "
          f"{[x['losses'] for x in ex]} (serial {small}: relative gap "
          f"{[max(abs(a - b) / abs(b) for a, b in zip(x['losses'], small)) for x in ex]}, "
          f"the per-rank capacity and router grouping); int8 "
          f"{[r['int8']['losses'] for r in res]}, e5m2 "
          f"{[r['e5m2']['losses'] for r in res]}; --zero (level 2) "
          f"{[r['zero']['losses'] for r in res]}, params against the exact "
          f"run (share beyond lr/5, worst over 2.5 lr a step) "
          f"{[r['zero']['drift'] for r in res]}; --pp 2 (experts serial, "
          f"{[r['pp 2']['layers_here'] for r in res]} layers a stage) "
          f"{[r['pp 2']['losses'] for r in res]}; card: {smi}")
    for r in res:
        rk = r["rank"]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(r["exact"]["losses"], small))
        verdict(f"MoE (e) ep 2 {MOE_LAYERS} layers rank {rk} losses rel to "
                f"serial", rel, MOE_LOSS_REL, group=group)
        for wire in ("int8", "e5m2"):
            ls = r[wire]["losses"]
            check(all(math.isfinite(v) for v in ls), f"(e) {wire} finite")
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(ls, r["exact"]["losses"]))
            verdict(f"MoE (e) {wire} dispatch wire rank {rk} losses rel to "
                    f"the exact wire", rel, ZERO_WIRE_BAND, group=group)
        z = r["zero"]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(z["losses"], r["exact"]["losses"]))
        verdict(f"MoE (e) --zero rank {rk} losses rel to replicated", rel,
                ZERO_LOSS_REL, group=group)
        verdict(f"MoE (e) --zero rank {rk} step-1 params, share beyond "
                f"lr/5", z["drift"][0][0], ZERO_DRIFT[0], group=group)
        verdict(f"MoE (e) --zero rank {rk} params, worst over 2.5 lr a step",
                max(e[1] for e in z["drift"]), ZERO_DRIFT[1], group=group)
        p = r["pp 2"]
        check(p["axis"] is None, "(e) pp 2 leaves dp 1: experts serial")
        rel = max(abs(a - b) / abs(b) for a, b in zip(p["losses"], small))
        verdict(f"MoE (e) --pp 2 rank {rk} losses rel to serial", rel,
                PP_LOSS_REL, group=group)
        e = r["engine"]
        same = e["ep"] == e["serial"]
        verdict(f"MoE (e) EP engine rank {rk} tokens equal the serial "
                f"engine's", 0 if same else 1, 0, group=group)
        check(e["ep_used"] == 0 and e["serial_used"] == 0,
              "(e) engines freed every page")
    print(f"  (e) the EP engine (fp32, {MOE_LAYERS} layers, 8 requests of 16 "
          f"tokens) against the serial engine: tokens equal "
          f"{[r['engine']['ep'] == r['engine']['serial'] for r in res]}")
    for r in res:
        for label, steps, counts, per_step in r["counts"]:
            check_counts(counts, expected_counts(counts, steps, per_step),
                         "moe")
            total.update({k: total.get(k, 0) + v for k, v in counts.items()})
    return res


def moe_phase(torch, ops, dev):
    """Phase 19: (a) the fp32 gradient gate; (b) 345M-MoE training; (d)
    NCCL at world size 1 against (b); the serial 4-layer reference; then
    (e)'s two gloo ranks spawned while (e)'s exact reference and then (c)
    serving run here, then (e)'s verdicts. Returns the launches of the MoE
    runs (path ``moe``)."""
    import shutil

    t0 = time.perf_counter()
    smi = nvidia_smi()
    total = {}
    moe_gradient_gate(torch, ops, dev)
    slosses, sfps = moe_345m(torch, ops, dev, total)
    moe_world1(torch, ops, dev, total, slosses, sfps)
    del sfps
    _, small, _, _, counts = pretrain_steps(
        torch, ops, zero_argv(MOE_345M, (), MOE_LAYERS), MOE_SMALL_STEPS,
        fixed=True)
    check_counts(counts, expected_counts(counts, MOE_SMALL_STEPS,
                                         pretrain_per_step(MOE_LAYERS, 2)),
                 "moe")
    total.update({k: total.get(k, 0) + v for k, v in counts.items()})
    gc.collect()
    torch.cuda.empty_cache()
    ref_dir = os.path.join(HERE, "build", "moe_check")
    shutil.rmtree(ref_dir, ignore_errors=True)
    os.makedirs(ref_dir)
    procs = []
    try:
        procs, outs = moe_spawn(ref_dir)
        exact = moe_exact_reference(torch, ops, total)
        torch.save({k: exact[k] for k in ("grads", "names", "floor")},
                   os.path.join(ref_dir, "ref.tmp"))  # whole, or absent
        os.replace(os.path.join(ref_dir, "ref.tmp"),
                   os.path.join(ref_dir, "ref.pt"))
        del exact["grads"]
        moe_serving(torch, ops, dev, total)
        moe_two_ranks(torch, total, smi, exact, small, procs, outs)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(ref_dir, ignore_errors=True)
    print(f"  phase 19 launches {total}; phase 19 took "
          f"{time.perf_counter() - t0:.1f} s; card: {smi}")
    return total


def moe_main():
    """``python3 chip_smoke.py --moe``: phase 19 alone after the build,
    with its verdict."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from apex_tpu_torch import ops
    from apex_tpu_torch.csrc import build

    print(f"card: {nvidia_smi()}; torch {torch.__version__}")
    build.load()
    torch.empty(1, device="cuda")
    moe_phase(torch, ops, torch.device("cuda", 0))
    print_verdict()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ln-times"]:
        sys.exit(times_of_tree(sys.argv[2], ln_times))
    if sys.argv[1:2] == ["--decode-times"]:
        sys.exit(times_of_tree(sys.argv[2], decode_times))
    if sys.argv[1:2] == ["--flash-times"]:
        sys.exit(times_of_tree(sys.argv[2], flash_times))
    if sys.argv[1:2] == ["--o0-long-times"]:
        sys.exit(times_of_tree(sys.argv[2], o0_long_times))
    if sys.argv[1:2] == ["--kernel-names"]:
        sys.exit(kernel_names_main())
    if sys.argv[1:2] == ["--generate-profile"]:
        sys.exit(kernel_names_main(generate_profile))
    if sys.argv[1:2] == ["--sass"]:
        sys.exit(sass_counts(sys.argv[2]))
    if sys.argv[1:2] == ["--contrib"]:
        sys.exit(contrib_main())
    if sys.argv[1:2] == ["--dp"]:
        sys.exit(dp_main())
    if sys.argv[1:2] == ["--tp"]:
        sys.exit(tp_main())
    if sys.argv[1:2] == ["--zero"]:
        sys.exit(zero_main())
    if sys.argv[1:2] == ["--pp"]:
        sys.exit(pp_main())
    if sys.argv[1:2] == ["--offsets"]:
        sys.exit(offsets_main())
    if sys.argv[1:2] == ["--cp"]:
        sys.exit(cp_main())
    if sys.argv[1:2] == ["--moe"]:
        sys.exit(moe_main())
    sys.exit(main())
