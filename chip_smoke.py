#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``apex_tpu_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA GPU
    python3 chip_smoke.py --ln-times TREE   # LayerNorm times of TREE's port
    python3 chip_smoke.py --decode-times TREE   # decode times of TREE's port
    python3 chip_smoke.py --flash-times TREE    # flash #1-#6, no masks
    python3 chip_smoke.py --o0-long-times TREE  # the O0 step at 8192
    python3 chip_smoke.py --sass TREE   # SASS counts of the flash kernels
    python3 chip_smoke.py --kernel-names   # fp32 attention kernels by name

Ten phases; any failure raises and exits non-zero:

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
   else) and of #2 fp32 at RP (one ``fwd_f32_blocked`` launch, no
   merge). The additive bias on the
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
   bit-identical, and the root bench.py selftest's streamed case.
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
   at GPT-2 345M: (a) ``pretrain_gpt.run`` at amp O2, 8 x 1024 tokens a
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
   phase 2's decode shapes; (e) ``--pos rope --window 256`` with random
   weights, monolithic and chunked + speculative, held the same way, then
   #2's fp32 route at the longest prefill (one split a band: no
   workspace); (f) ``pretrain_gpt`` at O0 on one 8192-token sequence a
   step, 3 steps: the streamed kernels' fp32 routes (#2 2L, #3 and #4 L a
   step, the resident flash kernels 0), a finite falling loss, the ms a
   step.

Every check with a limit is also kept for the closing verdict: one line
per check (name, worst error, limit, result, route) after phase 7, so
that the end of the output holds them all. After the verdict comes a
``{"kernels": [...]}`` JSON object (``launches_by_path``: each kernel's
count on the three serving runs, the GPT training run, the ResNet
training run, the two long-context runs and phase 7's run (``softmax``),
each counted from 0, phase 8's BERT run (``bert``), phase 9's (``fmha``)
and phase 10's (``gpt_pretrain``, ``gpt_pretrain_o0``, ``gpt_remat_*``,
``gpt_generate*``, ``gpt_pretrain_o0_long``); ``by_shape`` also holds phase 10's fp32 times;
``segments``: phase 9's times on #1-#6; ``launches``:
their sum; ``bias_route``: #1, #5 and #6 with and without the bias;
``launch_floor_ms`` on the decode and xentropy rows), the decode split-count
tuning line, then the card's name and power limit as nvidia-smi prints
them, and the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import gc
import json
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


def visible_pairs(sq, sk, causal, window):
    """(query, key) pairs the causal and window masks leave, per head."""
    total = 0
    for q in range(sq):
        hi = min(q + 1, sk) if causal else sk
        lo = 0
        if window is not None:
            lo = max(0, q - window + 1)
            if not causal:
                hi = min(sk, q + window)
        total += max(0, hi - lo)
    return total


def stream_bounds(b, h, sq, sk, d, causal, window, dtype="bfloat16"):
    """(fwd, dq, dkv) bounds of the streamed kernels: each operand read
    once and each output written once (q/k/v/o/dO/dq/dk/dv in ``dtype``,
    fp32 lse/delta) against 2, 3 and 4 products of 2*d FLOPs per visible
    pair at ``dtype``'s peak."""
    pairs = visible_pairs(sq, sk, causal, window) * b * h
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


def check_flash_decode(torch, ops, dev):
    """The paged decode kernel against ``paged_attention_reference`` at the
    serve's decode shape (b=8, 16 heads of 64 over 16-token pages), GQA,
    other pages and head_dims, the window, and the split route's edges
    (lengths on a split edge, 1, a full 1024-key slot, idle slots only, one
    slot of 16384 keys), bf16 and fp32: each output by max |err| and by row
    (:func:`_decode_held`), idle slots exactly 0; a halved tail of rows at
    the decode shape must fail the row check; two calls bit-identical.
    Then device times and the split-count tuning line
    (:func:`decode_split_tuning`)."""
    import importlib

    tfd = importlib.import_module("apex_tpu_torch.ops.flash_decode")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(3)
    main_lengths = DECODE_MAIN[7]  # slot 3 idle
    # lengths on the split route's edges at the decode shape: a length that
    # ends a split's last page, one past it, 1, a full slot, a page's end
    splits = tfd.decode_splits(8, 16, 1, 64)
    edge = 16 * splits * 5
    edge_lengths = [edge, edge + 1, 1, 1024, 0, 16, 17, 16 * splits]
    cases = [  # b, h, kh, blk, d, num_blocks, max_blocks, dtype, lengths
        (8, 16, 16, 16, 64, 513, 64, bf16, main_lengths),
        (8, 16, 16, 16, 64, 513, 64, f32, main_lengths),
        (8, 32, 16, 16, 64, 513, 64, bf16, main_lengths),   # GQA h = 2 kh
        (3, 8, 2, 8, 64, 40, 12, f32, [95, 0, 1]),
        (2, 4, 4, 128, 64, 9, 4, f32, [300, 512]),
        (2, 4, 2, 16, 128, 20, 8, bf16, [100, 7]),
        (2, 4, 2, 16, 36, 20, 8, bf16, [100, 7]),  # unaligned: scalar loads
        # the split route's edges
        (8, 16, 16, 16, 64, 513, 64, bf16, edge_lengths),
        (8, 16, 16, 16, 64, 513, 64, f32, edge_lengths),
        (8, 16, 16, 16, 64, 513, 64, bf16, [0] * 8),  # idle slots only
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
        (2, 4, 2, 16, 36, 20, 8, bf16, [100, 7], 128),
        (8, 16, 16, 16, 64, 513, 64, bf16, edge_lengths, 128),
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
        err, _ = _decode_held(
            torch, name, got, ref, dt, f"flash_decode {str(dt)[6:]}", route,
            [(i,) for i, n in enumerate(lengths) if n == 0])
        if window is not None and max(lengths) > window:
            full = ops.paged_attention_reference(q, kp, vp, tables, lens)
            check(max_err(full, ref) > (2e-2 if dt == bf16 else 5e-5),
                  "the window changes the output")
        if main_err is None:
            main_err = err
        if (b, h, d, dt, lengths, window) == (8, 16, 64, bf16, main_lengths,
                                              None):
            _planted_tail(torch, "flash_decode decode shape", got, ref, dt,
                          route, "flash_decode bfloat16 rows")
            _bit_identical(torch, "flash_decode decode shape", lambda: (
                ops.flash_decode(q, kp, vp, tables, lens)), route,
                "flash_decode bfloat16")
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
                kernel="flash_decode_split (bf16), flash_decode_kernel "
                       "(fp32, unaligned bf16)",
                source="apex_tpu_torch/csrc/flash_decode.cu",
                replaces="apex_tpu/ops/flash_decode.py:141",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None, by_shape=by_shape,
                decode_tuning=tuning)


def decode_split_tuning(torch, ops, dev, tried=(1, 2, 3, 4, 8)):
    """The split count against the values tried, bf16, at #9's decode
    shape, with window 128 and at b = 1 over 8192 keys, and at #10's chunk
    and verify shapes: device ms per split count beside the count
    :func:`decode_splits` takes (``DECODE_SPLIT_PAGES`` pages a split, at
    most ``DECODE_SPLIT_CTAS`` CTAs an SM), printed on one line and
    returned for the ``kernels`` line (``decode_tuning``)."""
    import importlib

    tfd = importlib.import_module("apex_tpu_torch.ops.flash_decode")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    b, h, kh, blk, d, nb, mb, lengths = DECODE_MAIN
    q, kp, vp, tables, lens = _decode_inputs(torch, dev, gen, b, h, kh, blk,
                                             d, nb, mb, bf16, lengths)
    b1, h1, kh1, blk1, d1, nb1, mb1, lengths1 = DECODE_LONG
    q1, kp1, vp1, t1, l1 = _decode_inputs(torch, dev, gen, b1, h1, kh1,
                                          blk1, d1, nb1, mb1, bf16, lengths1)
    shapes = {
        "decode": (lambda s: ops.flash_decode_fwd(q, kp, vp, tables, lens,
                                                  splits=s),
                   tfd.decode_splits(b, kh, 1, mb, sms)),
        "window_128": (lambda s: ops.flash_decode_fwd(
            q, kp, vp, tables, lens, window=128, splits=s),
            tfd.decode_splits(b, kh, 1, tfd.decode_span_pages(mb, blk, 128),
                              sms)),
        "b1_8192": (lambda s: ops.flash_decode_fwd(q1, kp1, vp1, t1, l1,
                                                   splits=s),
                    tfd.decode_splits(b1, kh1, 1, mb1, sms))}
    for label, (b, h, kh, kq, blk, d, nb, mb, lengths) in (
            ("chunk", DECODE_CHUNK), ("verify", DECODE_VERIFY)):
        _, kpm, vpm, tm, lm = _decode_inputs(torch, dev, gen, b, h, kh, blk,
                                             d, nb, mb, bf16, lengths)
        qm = torch.randn(b, h, kq, d, device=dev, generator=gen).to(bf16)
        tiles = -(-(h // kh * kq) // tfd.DECODE_ROWS)
        shapes[label] = (
            lambda s, a=(qm, kpm, vpm, tm, lm): ops.flash_decode_multi_fwd(
                *a, splits=s), tfd.decode_splits(b, kh, tiles, mb, sms))
    for label, (call, chosen) in shapes.items():
        ms = {s: time_ms(lambda: call(s)) for s in sorted({*tried, chosen})}
        out[label] = {"chosen": chosen, "ms": ms}
    print(f"  decode split tuning (DECODE_SPLIT_PAGES = "
          f"{tfd.DECODE_SPLIT_PAGES}, DECODE_SPLIT_CTAS = "
          f"{tfd.DECODE_SPLIT_CTAS}; ms by splits, * the count taken): "
          + "; ".join(f"{k} " + ", ".join(
              f"{s}{'*' if s == v['chosen'] else ''} {t:.4f}"
              for s, t in v["ms"].items()) for k, v in out.items()))
    return out


def decode_times(torch, ops, dev):
    """Device times (ms) of the decode kernels through the port's entry
    points, bf16: #9 at the decode shape (with its eager issue per call:
    the least of 9 windows of 200 calls, and the host's own cost per call,
    :func:`host_ms`), with window 128, and at b = 1
    over 8192 keys; #10 at the chunk and verify shapes. Takes any tree's
    ``ops``, so two trees can be compared in one run."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    q, kp, vp, tables, lens = _decode_inputs(torch, dev, gen,
                                             *DECODE_MAIN[:7], bf16,
                                             DECODE_MAIN[7])
    b, h, kh, blk, d, nb, mb, lengths = DECODE_LONG
    q1, kp1, vp1, t1, l1 = _decode_inputs(torch, dev, gen, b, h, kh, blk, d,
                                          nb, mb, bf16, lengths)
    out = {"decode": time_ms(lambda: ops.flash_decode(q, kp, vp, tables,
                                                      lens)),
           "decode_issue": issue_ms(
               lambda: ops.flash_decode(q, kp, vp, tables, lens), 200, 9,
               min),
           "decode_host": host_ms(
               lambda: ops.flash_decode(q, kp, vp, tables, lens)),
           "window_128": time_ms(lambda: ops.flash_decode(
               q, kp, vp, tables, lens, window=128)),
           "b1_8192": time_ms(lambda: ops.flash_decode(q1, kp1, vp1, t1,
                                                       l1))}
    for label, (b, h, kh, kq, blk, d, nb, mb, lengths) in (
            ("chunk", DECODE_CHUNK), ("verify", DECODE_VERIFY)):
        _, kp, vp, tables, lens = _decode_inputs(
            torch, dev, gen, b, h, kh, blk, d, nb, mb, bf16, lengths)
        q = torch.randn(b, h, kq, d, device=dev, generator=gen).to(bf16)
        out[label] = time_ms(lambda: ops.flash_decode_multi(q, kp, vp, tables,
                                                            lens))
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
    chunk shape a halved tail of rows must fail the row check and two
    calls must give the same bits."""
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
            if (dt, lengths, window) == (bf16, DECODE_CHUNK[8], None):
                _planted_tail(torch, "flash_decode_multi chunk shape", got,
                              ref, dt, route, f"{group} rows")
                _bit_identical(torch, "flash_decode_multi chunk shape",
                               lambda: ops.flash_decode_multi(
                                   q, kp, vp, tables, lens), route, group)
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
                kernel="decode_multi_split (bf16), decode_multi_f32_kernel "
                       "(fp32), decode_multi_mma_kernel (unaligned bf16)",
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
#: the split route's, then the gather and fp32 routes'
DECODE_KERNELS = {"#9": ("flash_decode_split", "flash_decode_kernel"),
                  "#10": ("decode_multi_split", "decode_multi_mma_kernel",
                          "decode_multi_f32_kernel")}


def device_busy(torch, eng, reqs, label):
    """Device busy share of a serving window: the kernels' device time from
    ``torch.profiler`` over the window's wall time, and the decode kernels'
    device time and launches beside it, per decode tick (the engine's
    decode steps and speculative ticks in the window). Not a check."""
    from torch.profiler import ProfilerActivity, profile

    ticks0 = eng.decode_steps + eng.spec_ticks
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
#: the generate example's engine at 345M
GENERATE_345M = GPT_345M + ["--max-seq", "1024", "--max-batch", "8",
                            "--block-size", "16", "--max-new-tokens", "32"]


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

    argv = PRETRAIN_345M + ["--save-dir", ckpt_dir, "--save-every", "11"]
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

    argv = PRETRAIN_345M + ["--lr", "3e-4", "--opt-level", opt_level]
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
    args = pretrain_gpt.parse_args(PRETRAIN_345M + ["--opt-level", "O0"])
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
PRETRAIN_O0_LONG = PRETRAIN_345M + ["--opt-level", "O0", "--seq", "8192",
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


def kernels_of(torch, fn):
    """The device kernels of one call of ``fn`` under the profiler, after
    one call outside it (:func:`device_time_by_kernel`), and the top 3 by
    time as ``["name xN (ms)", ...]``, or "not captured"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = device_time_by_kernel(torch, prof)
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
    band mask. Run in a fresh process
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
    print("  fp32 attention kernels by name (one call under the profiler): "
          + "; ".join(f"{k}: {v}" for k, v in out.items()))
    del q, k, v, band
    torch.cuda.empty_cache()
    return {"flash_attention_fwd": {
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


def kernel_names_main():
    """``python3 chip_smoke.py --kernel-names``: :func:`fp32_kernels_by_name`
    on the card, its result as the last line (one JSON object)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from apex_tpu_torch import ops
    from apex_tpu_torch.csrc import build

    build.load()
    print(json.dumps(fp32_kernels_by_name(torch, ops,
                                          torch.device("cuda", 0))))
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

    args = pretrain_gpt.parse_args(PRETRAIN_345M)
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
    argv = GENERATE_345M + ["--load-dir", ckpt_dir]
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
    argv = GENERATE_345M + ["--pos", "rope", "--window", "256",
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
    """The fp32 routes of #9 and #10 at phase 2's decode, chunk and verify
    shapes (the generate example's pools, 16 heads of 64, 16-token pages),
    beside the bf16 rows: each against its plain version (share of max
    |ref|, 5e-5: phase 2's fp32 decode limit), its time, the plain
    version's and the bound."""
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    b, h, kh, blk, d, nb, mb, lengths = DECODE_MAIN
    q, kp, vp, tables, lens = _decode_inputs(
        torch, dev, gen, b, h, kh, blk, d, nb, mb, f32, lengths)
    err = rel_err(ops.flash_decode(q, kp, vp, tables, lens),
                  ops.paged_attention_reference(q, kp, vp, tables, lens))
    live = sum(lengths)
    bms, by = bound(live * kh * d * 4 * 2 + 2 * b * h * d * 4 + b * mb * 4
                    + b * 4, 4 * h * d * live, "float32")
    out["flash_decode"] = {"fp32 decode": dict(
        ms=time_ms(lambda: ops.flash_decode(q, kp, vp, tables, lens)),
        plain_ms=time_ms(lambda: ops.paged_attention_reference(
            q, kp, vp, tables, lens), 5),
        bound_ms=bms, bound_by=by, max_rel_err=err)}
    verdict("flash_decode fp32 at the decode shape", err, 5e-5,
            group="gpt examples: fp32 routes")
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
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="gpt_ckpt-", dir=build.BUILD_DIR)
    try:
        counts, a_peak = pretrain_save_resume(torch, ops, dev, ckpt)
        by_path = {"gpt_pretrain": counts}
        o2_lr = pretrain_default_lr(torch, dev)
        by_path["gpt_pretrain_o0"] = pretrain_o0(torch, ops, dev)
        pretrain_default_lr(torch, dev, "O0", o2_lr)
        fp32 = {k: {"fp32 O0 pretrain": v}
                for k, v in fp32_train_times(torch, ops, dev).items()}
        fp32.update(fp32_stream_bwd_times(torch, ops, dev))
        by_path.update(remat_policies(torch, ops, dev, a_peak))
        by_path.update(generate_checkpoint(torch, ops, dev, ckpt))
        fp32.update(fp32_decode_times(torch, ops, dev))
        rope_counts, longest = generate_rope(torch, ops, dev)
        by_path.update(rope_counts)
        fp32.update(fp32_rope_prefill_times(torch, ops, dev, longest))
        by_path["gpt_pretrain_o0_long"] = pretrain_o0_long(torch, ops, dev)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s")
    return by_path, fp32


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

    print("phase 1: build")
    t0 = time.perf_counter()
    build.load()
    print(f"  kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.last_build_seconds:.2f} s) -> "
          f"{os.path.relpath(build.library_path(), HERE)}")
    with open(build.library_path() + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("   ", line.rstrip())

    print("phase 2: kernels against their plain versions")
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

    print("phase 3: serving")
    greedy_gate(torch, dev)
    feature_gates(torch, ops, dev)
    serve_counts, model, mono = serve_345m(torch, ops, dev)
    spec_counts, _ = serve_345m_prefix_spec(torch, ops, dev, model)
    chunk_counts, _ = serve_345m_chunked(torch, ops, dev, model, mono)
    del model
    torch.cuda.empty_cache()

    print("phase 4: training")
    gradient_gate(torch, ops, dev)
    train_counts = train_345m(torch, ops, dev)
    torch.cuda.empty_cache()

    print("phase 5: ResNet-50 training")
    resnet_gradient_gate(torch, ops, dev)
    resnet_counts = train_resnet50(torch, ops, dev)
    torch.cuda.empty_cache()

    print("phase 6: long-context training")
    long_context_gradient_gate(torch, ops, dev)
    long_counts = train_long_context(torch, ops, dev, 8192, None, "learned")
    window_counts = train_long_context(torch, ops, dev, 16384, 4096, "rope")
    torch.cuda.empty_cache()

    print("phase 7: fused softmax and the small layers")
    softmax_counts = fused_softmax_and_small_layers(torch, ops, dev)
    torch.cuda.empty_cache()

    print("phase 8: BERT-large pretraining with FusedLAMB")
    bert_gradient_gate(torch, ops, dev)
    bert_counts = train_bert_large(torch, ops, dev)
    optimizer_step_line(torch, dev)
    torch.cuda.empty_cache()

    print("phase 9: packed varlen attention (contrib.fmha) at BERT-large "
          "width")
    fmha_counts, fmha_rows = fmha_packed(torch, ops, dev)
    torch.cuda.empty_cache()

    print("phase 10: the GPT examples (pretrain_gpt -> checkpoint -> resume "
          "-> generate_gpt) at GPT-2 345M")
    gpt_counts, fp32_rows = gpt_examples(torch, ops, dev)
    for row in rows:
        if row["name"] in fp32_rows:
            row.setdefault("by_shape", {}).update(fp32_rows[row["name"]])
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
    if sys.argv[1:2] == ["--sass"]:
        sys.exit(sass_counts(sys.argv[2]))
    sys.exit(main())
