#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``apex_tpu_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Seven phases; any failure raises and exits non-zero:

1. **Build** every kernel from ``apex_tpu_torch/csrc`` with nvcc
   (``sm_90a``) and print the build seconds, the card's name and its power
   limit.
2. **Kernel vs plain**: each kernel (LayerNorm forward and backward,
   flash-attention forward, its dQ and dK/dV backward, paged flash-decode
   with and without its window, the K-query paged decode, the softmax
   cross-entropy forward and backward, the streamed flash forward with its
   merge pass, dQ and dK/dV with the sliding window, the fused scale-mask
   softmax forward and backward at the GPT-2 345M and BERT-large score
   shapes, a per-head mask, unaligned rows, fp16 and rows of 65536 and
   100003 elements on the two-pass route) against its plain PyTorch
   version on the card, at the main paths' shapes in bf16 and fp32 plus
   edge cases, each error beside its stated tolerance; then device times
   by CUDA-graph replay between CUDA events (kernel, plain version, one
   PyTorch library call as yardstick where one computes the same function;
   the resident flash kernels beside the streamed ones at 1024 (batch 8),
   4096 and 8192 tokens; the split length of the streamed bf16 backward
   against the lengths tried) and the least time the card could take.
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
   its schedule implies.
4. **Training**: an fp32 gradient gate on a small GPT (loss and every
   parameter's grad on the card through the kernels against the same model
   on the CPU through the plain versions), then the GPT-2 345M amp-O2
   training step of ``apex_tpu_torch.bench.build("O2")`` at full width and
   depth (batch 8 x 1024, random weights from a seed, one fixed batch): one
   warm-up step and 10 steps timed as one window (the step time is the
   window over 10, each step's time beside it) with the exact launch counts
   checked, a falling finite loss, no skipped step and bf16 params equal to
   their fp32 masters cast down; then the top kernels by device time of one
   profiled step.
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
   tokens/s, the model-FLOPs share, peak memory, and one profiled step.
7. **Fused softmax and the small layers** (:func:`fused_softmax_and_small_layers`):
   ``FusedScaleMaskSoftmax`` forward and backward at the GPT-2 345M causal
   and BERT-large padded score shapes (one launch of each softmax kernel a
   fused call, none on the unaligned route or with ``fused=False``); the
   explicit-scores attention it exists for (matmul, the module, matmul) at
   (8,16,1024,64) bf16 against ``flash_attention``, with both fwd+bwd
   times; ``FusedLayerNorm``, ``FusedRMSNorm``, ``FastLayerNorm``,
   ``FusedDenseGeluDense`` and ``MLP`` at GPT-2 345M width on 8192 tokens
   against a CPU copy of each; exact launch counts.

Every check with a limit is also kept for the closing verdict: one line
per check (name, worst error, limit, result, route) after phase 7, so
that the end of the output holds them all. After the verdict comes a
``{"kernels": [...]}`` JSON object (``launches_by_path``: each kernel's
count on the three serving runs, the GPT training run, the ResNet
training run, the two long-context runs and phase 7's run (``softmax``),
each counted from 0; ``launches``: their sum), then the card's name and
power limit as nvidia-smi prints them, and the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


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


def issue_ms(fn, iters=100):
    """Time per call of eager back-to-back calls between two CUDA events:
    the larger of the device time and the host's cost to issue the call."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


def check_layer_norm(torch, ops, dev):
    import torch.nn.functional as F

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [  # rows, hidden, dtype, variant
        (1024, 1024, bf16, "ln"), (8, 1024, bf16, "ln"),
        (1024, 1024, f32, "ln"), (1024, 1024, bf16, "rms"),
        (1024, 1024, bf16, "no-bias"), (8, 1024, f32, "no-affine"),
        (33, 1000, f32, "ln"), (5, 4096, bf16, "rms"),
    ]
    main_err = None
    for rows, hidden, dt, variant in cases:
        x = (torch.randn(rows, hidden, device=dev, generator=gen) * 3
             + 0.5).to(dt)
        w = 1 + 0.1 * torch.randn(hidden, device=dev, generator=gen)
        b = 0.1 * torch.randn(hidden, device=dev, generator=gen)
        if variant == "rms":
            got, ref = ops.rms_norm(x, w), ops.rms_norm_reference(x, w)
        else:
            wv = None if variant == "no-affine" else w
            bv = b if variant == "ln" else None
            got = ops.layer_norm(x, wv, bv)
            ref = ops.layer_norm_reference(x, wv, bv)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        name = f"layer_norm {variant} {rows}x{hidden} {str(dt)[6:]}"
        if dt == bf16:
            # one bf16 ulp at |y|: both round the same fp32 value
            over = float(((got.float() - ref.float()).abs()
                          - ref.float().abs() * 2.0 ** -7 - 1e-6).max())
            tol = "1 bf16 ulp"
        else:
            tol = "1e-05"
        print(f"  layer_norm {variant:9s} rows={rows:4d} hidden={hidden} "
              f"{str(dt)[6:]:8s} max_abs_err={err:.3g} (tol {tol})")
        check(got.dtype == x.dtype, f"{name}: dtype")
        if dt == bf16:
            verdict(f"{name} over 1 bf16 ulp", max(over, 0.0), 0.0,
                    group="layer_norm_fwd bfloat16")
        else:
            verdict(name, err, 1e-5, group="layer_norm_fwd float32")
        if main_err is None:
            main_err = err
    # timing at the prefill shape: 1024 rows x 1024, bf16, fp32 gamma/beta
    rows, hidden = 1024, 1024
    x = torch.randn(rows, hidden, device=dev, generator=gen).to(bf16)
    w = torch.ones(hidden, device=dev)
    b = torch.zeros(hidden, device=dev)
    w16, b16 = w.to(bf16), b.to(bf16)
    ms = time_ms(lambda: ops.layer_norm(x, w, b))
    plain = time_ms(lambda: ops.layer_norm_reference(x, w, b))
    lib = time_ms(lambda: F.layer_norm(x, (hidden,), w16, b16, 1e-5))
    x8 = x[:8].clone()
    ms8 = time_ms(lambda: ops.layer_norm(x8, w, b))
    issue8 = issue_ms(lambda: ops.layer_norm(x8, w, b))
    nbytes = rows * hidden * 2 * 2 + hidden * 4 * 2 + rows * 4 * 2
    bms, by = bound(nbytes, rows * hidden * 8, "float32")
    print(f"  layer_norm timing (1024x1024 bf16): kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, F.layer_norm {lib:.4f} ms, bound {bms:.4f} ms "
          f"({by}); decode shape 8x1024: kernel {ms8:.4f} ms, eager issue "
          f"{issue8:.4f} ms per call")
    xt = torch.randn(8192, hidden, device=dev, generator=gen).to(bf16)
    ms_t = time_ms(lambda: ops.layer_norm(xt, w, b))
    plain_t = time_ms(lambda: ops.layer_norm_reference(xt, w, b), 5)
    lib_t = time_ms(lambda: F.layer_norm(xt, (hidden,), w16, b16, 1e-5))
    bms_t, by_t = bound(8192 * hidden * 4 + hidden * 8 + 8192 * 8,
                        8192 * hidden * 8, "float32")
    print(f"  layer_norm timing at the training shape (8192x1024 bf16): "
          f"kernel {ms_t:.4f} ms, plain {plain_t:.4f} ms, F.layer_norm "
          f"{lib_t:.4f} ms, bound {bms_t:.4f} ms ({by_t})")
    return dict(name="layer_norm_fwd", route="cuda",
                source="apex_tpu_torch/csrc/layer_norm.cu",
                replaces="apex_tpu/ops/layer_norm.py:65",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def causal_pairs(sq, sk):
    return sum(min(q + 1, sk) for q in range(sq))


def check_flash_attention(torch, ops, dev):
    import torch.nn.functional as F

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [  # b, h, sq, sk, d, dtype, causal
        (1, 16, 1024, 1024, 64, bf16, True),
        (1, 16, 1024, 1024, 64, f32, True),
        (1, 16, 1024, 1024, 64, bf16, False),
        (2, 3, 1000, 1000, 64, f32, True),
        (2, 3, 77, 300, 64, f32, False),
        (1, 2, 300, 77, 64, f32, True),
        (2, 4, 256, 256, 128, bf16, True),
        (1, 4, 130, 130, 40, f32, True),
        (1, 4, 130, 130, 40, bf16, True),      # head_dim padded to 64
        (2, 2, 100, 120, 36, bf16, False),     # unaligned: scalar loads
        (1, 2, 64, 64, 16, bf16, True),
        (1, 2, 300, 77, 64, bf16, True),       # sq > sk
        (2, 3, 77, 300, 64, bf16, False),
    ]
    main_err = None
    for b, h, sq, sk, d, dt, causal in cases:
        q = torch.randn(b, h, sq, d, device=dev, generator=gen).to(dt)
        k = torch.randn(b, h, sk, d, device=dev, generator=gen).to(dt)
        v = torch.randn(b, h, sk, d, device=dev, generator=gen).to(dt)
        got = ops.flash_attention(q, k, v, causal=causal)
        ref = ops.mha_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = 2e-2 if dt == bf16 else 5e-5
        print(f"  flash_attention b={b} h={h} sq={sq} sk={sk} d={d} "
              f"{str(dt)[6:]:8s} causal={causal!s:5s} max_abs_err={err:.3g} "
              f"(tol {tol:g})")
        check(got.dtype == dt and got.shape == q.shape,
              f"flash_attention {(b, h, sq, sk, d, dt, causal)}: dtype/shape")
        verdict(f"flash_attention ({b},{h},{sq},{sk},{d}) {str(dt)[6:]} "
                f"causal={causal}", err, tol,
                group=f"flash_attention_fwd {str(dt)[6:]}")
        if main_err is None:
            main_err = err
    # a fused-QKV view (strided heads) goes in without a copy
    qkv = torch.randn(1, 128, 4, 3, 64, device=dev, generator=gen).to(bf16)
    qkv = qkv.permute(0, 2, 3, 1, 4)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    err = max_err(ops.flash_attention(q, k, v, causal=True),
                  ops.mha_reference(q, k, v, causal=True))
    print(f"  flash_attention strided fused-QKV view max_abs_err={err:.3g}")
    verdict("flash_attention strided fused-QKV view", err, 2e-2,
            group="flash_attention_fwd bfloat16")

    b, h, s, d = 1, 16, 1024, 64
    q, k, v = (torch.randn(b, h, s, d, device=dev, generator=gen).to(bf16)
               for _ in range(3))
    ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    plain = time_ms(lambda: ops.mha_reference(q, k, v, causal=True), 5)
    lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=True))
    flops = 4 * b * h * d * causal_pairs(s, s)
    nbytes = 4 * b * h * s * d * 2 + b * h * s * 4
    bms, by = bound(nbytes, flops, "bfloat16")
    print(f"  flash_attention timing (1,16,1024,64) bf16 causal: kernel "
          f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} "
          f"ms, SDPA {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    b = 8
    q, k, v = (torch.randn(b, h, s, d, device=dev, generator=gen).to(bf16)
               for _ in range(3))
    ms_t = time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    plain_t = time_ms(lambda: ops.mha_reference(q, k, v, causal=True), 2, 2)
    lib_t = time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                            is_causal=True))
    flops_t = 4 * b * h * d * causal_pairs(s, s)
    bms_t, by_t = bound(4 * b * h * s * d * 2 + b * h * s * 4, flops_t,
                        "bfloat16")
    print(f"  flash_attention timing at the training shape (8,16,1024,64) "
          f"bf16 causal: kernel {ms_t:.4f} ms ({flops_t / ms_t / 1e9:.1f} "
          f"TFLOP/s), plain {plain_t:.4f} ms, SDPA {lib_t:.4f} ms, bound "
          f"{bms_t:.4f} ms ({by_t})")
    return dict(name="flash_attention_fwd", route="cuda",
                source="apex_tpu_torch/csrc/flash_attention.cu",
                replaces="apex_tpu/ops/flash_attention.py:251",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


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
    rows in another order)."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [  # rows, hidden, dtype, variant
        (8192, 1024, bf16, "ln"), (8192, 1024, f32, "ln"),
        (8192, 1024, bf16, "rms"), (1024, 1024, bf16, "no-affine"),
        (1024, 1024, bf16, "no-bias"), (33, 1000, f32, "ln"),
        (33, 1000, bf16, "rms"),
    ]
    main_err = None
    for rows, hidden, dt, variant in cases:
        x = (torch.randn(rows, hidden, device=dev, generator=gen) * 3
             + 0.5).to(dt)
        g = torch.randn(rows, hidden, device=dev, generator=gen).to(dt)
        w = 1 + 0.1 * torch.randn(hidden, device=dev, generator=gen)
        b = 0.1 * torch.randn(hidden, device=dev, generator=gen)
        rms = variant == "rms"
        wv = None if variant == "no-affine" else w
        bv = b if variant == "ln" else None
        _, mean, rstd = ops.layer_norm_fwd(x, wv, bv, rms=rms)
        kw = dict(rms=rms, has_bias=bv is not None)
        got = ops.layer_norm_bwd(g, x, mean, rstd, wv, **kw)
        ref = ops.layer_norm_bwd_reference(g, x, mean, rstd, wv, **kw)
        torch.cuda.synchronize()
        tol_dx = 2.0 ** -7 if dt == bf16 else 1e-5
        errs = []
        for name, a, r, tol in (("dx", got[0], ref[0], tol_dx),
                                ("dgamma", got[1], ref[1], 1e-4),
                                ("dbeta", got[2], ref[2], 1e-4)):
            check((a is None) == (r is None), f"ln bwd {name} presence")
            if a is None:
                continue
            e = rel_err(a, r)
            errs.append(f"{name} {max_err(a, r):.3g} (rel {e:.3g}, tol "
                        f"{tol:g})")
            verdict(f"layer_norm_bwd {variant} {rows}x{hidden} "
                    f"{str(dt)[6:]} {name}", e, tol,
                    group=f"layer_norm_bwd {str(dt)[6:]}")
        check(got[0].dtype == dt, "ln bwd dx dtype")
        print(f"  layer_norm_bwd {variant:9s} rows={rows:4d} hidden={hidden} "
              f"{str(dt)[6:]:8s} " + ", ".join(errs))
        if main_err is None:
            main_err = max_err(got[0], ref[0])
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
    print(f"  layer_norm_bwd timing (8192x1024 bf16, fp32 gamma/beta): "
          f"kernel + partial sum {ms:.4f} ms, plain {plain:.4f} ms, "
          f"aten.native_layer_norm_backward (bf16 gamma) {lib:.4f} ms, bound "
          f"{bms:.4f} ms ({by})")
    return dict(name="layer_norm_bwd", route="cuda",
                source="apex_tpu_torch/csrc/layer_norm.cu",
                replaces="apex_tpu/ops/layer_norm.py:85",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def check_flash_attention_bwd(torch, ops, dev):
    """Flash backward kernels (dQ, dK/dV) against
    ``flash_attention_bwd_reference`` on the same q, k, v, dO and the
    forward kernel's o/lse. Tolerance, as a share of max |ref| of each
    gradient: 1e-2 in bf16 (P and dS are rounded to bf16 as mma operands,
    and each output once more) and 1e-4 in fp32 (fp32 sums in another
    order)."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(6)

    def run(q, k, v, causal, label):
        do = torch.randn(q.shape, device=dev, generator=gen).to(q.dtype)
        scale = q.shape[-1] ** -0.5
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
        delta = (o.float() * do.float()).sum(-1)
        kw = dict(causal=causal, scale=scale)
        dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        ref = ops.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        tol = 1e-2 if q.dtype == bf16 else 1e-4
        parts = []
        worst = 0.0
        for name, a, r in zip(("dQ", "dK", "dV"), (dq, dk, dv), ref):
            check(a.dtype == q.dtype and a.shape == r.shape,
                  f"flash bwd {label} {name} dtype/shape")
            e = rel_err(a, r)
            worst = max(worst, max_err(a, r))
            parts.append(f"{name} {max_err(a, r):.3g} (rel {e:.3g})")
            verdict(f"flash_attention_bwd {label} {name}", e, tol,
                    group=f"flash_attention_bwd {str(q.dtype)[6:]}")
        print(f"  flash_attention_bwd {label} " + ", ".join(parts)
              + f" (tol {tol:g} of max|ref|)")
        return worst

    cases = [  # b, h, sq, sk, d, dtype, causal
        (8, 16, 1024, 1024, 64, bf16, True),
        (8, 16, 1024, 1024, 64, f32, True),
        (2, 16, 1024, 1024, 64, bf16, False),
        (2, 3, 77, 300, 64, bf16, False),
        (1, 2, 300, 77, 64, bf16, True),
        (2, 3, 77, 300, 64, f32, True),
        (1, 2, 300, 77, 64, f32, False),
        (2, 4, 256, 256, 128, bf16, True),
        (1, 4, 130, 130, 40, bf16, True),
        (2, 2, 100, 120, 36, bf16, False),
        (1, 4, 130, 130, 40, f32, True),
    ]
    main_err = None
    for b, h, sq, sk, d, dt, causal in cases:
        q = torch.randn(b, h, sq, d, device=dev, generator=gen).to(dt)
        k = torch.randn(b, h, sk, d, device=dev, generator=gen).to(dt)
        v = torch.randn(b, h, sk, d, device=dev, generator=gen).to(dt)
        err = run(q, k, v, causal, f"b={b} h={h} sq={sq} sk={sk} d={d} "
                  f"{str(dt)[6:]} causal={causal}")
        if main_err is None:
            main_err = err
    # a fused-QKV view (strided heads), as the model hands them over
    qkv = torch.randn(2, 256, 4, 3, 64, device=dev, generator=gen).to(bf16)
    qkv = qkv.permute(0, 2, 3, 1, 4)
    run(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], True,
        "strided fused-QKV view (2,4,256,64) bf16 causal")

    b, h, s, d = 8, 16, 1024, 64
    q, k, v, do = (torch.randn(b, h, s, d, device=dev, generator=gen).to(bf16)
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    delta = (o.float() * do.float()).sum(-1)
    kw = dict(causal=True, scale=scale)
    ms_dq = time_ms(
        lambda: ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw))
    ms_dkv = time_ms(
        lambda: ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
    plain = time_ms(lambda: ops.flash_attention_bwd_reference(
        q, k, v, o, lse, do, **kw), 2, 2)
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
    print(f"  flash_attention_bwd timing (8,16,1024,64) bf16 causal: dQ "
          f"{ms_dq:.4f} ms ({6 * d * pairs / ms_dq / 1e9:.1f} TFLOP/s, bound "
          f"{dq_bound[0]:.4f} ms {dq_bound[1]}), dK/dV {ms_dkv:.4f} ms "
          f"({8 * d * pairs / ms_dkv / 1e9:.1f} TFLOP/s, bound "
          f"{dkv_bound[0]:.4f} ms {dkv_bound[1]}), plain (both) {plain:.4f} "
          f"ms; SDPA backward (dQ, dK, dV; autograd.grad through "
          f"{backend}) {lib_pair:.4f} ms, the FlashAttention-2 backward op "
          f"{fa2_ms:.4f} ms; eager between CUDA events (host issue): the "
          f"pair {pair_eager:.4f} ms, SDPA's autograd.grad {lib_eager:.4f} "
          f"ms")
    common = dict(route="cuda", source="apex_tpu_torch/csrc/"
                  "flash_attention_bwd.cu", max_abs_err=main_err,
                  plain_ms=plain, library_ms=lib_pair)
    return [dict(common, name="flash_attention_bwd_dq",
                 replaces="apex_tpu/ops/flash_attention.py:328", ms=ms_dq,
                 bound_ms=dq_bound[0], bound_by=dq_bound[1]),
            dict(common, name="flash_attention_bwd_dkv",
                 replaces="apex_tpu/ops/flash_attention.py:411", ms=ms_dkv,
                 bound_ms=dkv_bound[0], bound_by=dkv_bound[1])]


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


def stream_bounds(b, h, sq, sk, d, causal, window):
    """(fwd, dq, dkv) bounds of the streamed kernels: each operand read
    once and each output written once (bf16 q/k/v/o/dO/dq/dk/dv, fp32
    lse/delta) against 2, 3 and 4 products of 2*d FLOPs per visible pair."""
    pairs = visible_pairs(sq, sk, causal, window) * b * h
    q_el, k_el = b * h * sq * d, b * h * sk * d
    rows = b * h * sq * 4
    return (bound(2 * (2 * q_el + 2 * k_el) + rows, 4 * d * pairs,
                  "bfloat16"),
            bound(2 * (3 * q_el + 2 * k_el) + 2 * rows, 6 * d * pairs,
                  "bfloat16"),
            bound(2 * (2 * q_el + 4 * k_el) + 2 * rows, 8 * d * pairs,
                  "bfloat16"), pairs)


# worst-row limits (row_err) of the streamed kernels, (forward, backward),
# keyed by "is bf16": twice the worst bf16 reading of the cases below on an
# H100 (0.0062 forward, 0.0075 backward; 0.0055 at the path shapes), and
# 5x the worst fp32 reading (1.9e-6); a halved tail of rows reads 0.5
ROW_TOL = {True: (1.5e-2, 1.5e-2), False: (1e-5, 1e-5)}


def check_flash_attention_stream(torch, ops, dev):
    """The three streamed kernels (forward with its merge pass, dQ, dK/dV)
    against their plain versions (``flash_attention_*_stream_reference``:
    per-split partials and the lse merge, split-wise dQ sums, q-split dK/dV
    sums) on the same inputs; the backward from the kernel forward's lse.
    Each output is held twice. As a share of max |ref| over the tensor:
    bf16 forward 2e-2 (P rounded to bf16 as an mma operand), bf16 backward
    1e-2 (P and dS rounded, then each output); fp32 1e-5 (fp32 sums in
    another order, and the dQ, dK, dV splits added by atomics in an order
    that changes from run to run). That max comes from the first rows,
    which see few keys and are large, so it cannot hold the long rows; the
    worst row's own error (:func:`row_err`, limits :data:`ROW_TOL`) does,
    and at the path shapes a tail of rows halved must fail it. Rows that
    see no key must give o = 0 and lse = -1e30 exactly. The bf16 backward
    is the wgmma kernels; the cases take it through d = 128, ragged
    128-row outer tiles, the fused-QKV views TMA reads as they are and
    rows TMA refuses (the wrapper's padded copy). Then device times at the
    two path shapes beside their bounds, the plain versions, the resident
    kernels (unwindowed shapes) and SDPA (causal, or with the boolean band
    mask under the window), resident against streamed at 4096 and 8192
    (the numbers behind STREAM_MIN_SEQ) and at T = (8,16,1024,64), and the
    backward's split length against the lengths tried."""
    import importlib

    import torch.nn.functional as F

    tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(9)

    def rand(*shape, dt):
        return torch.randn(*shape, device=dev, generator=gen).to(dt)

    def run(q, k, v, causal, window, label):
        dt = q.dtype
        do = rand(*q.shape, dt=dt)
        scale = q.shape[-1] ** -0.5
        o, lse = ops.flash_attention_fwd_stream(q, k, v, causal=causal,
                                                window=window)
        delta = (o.float() * do.float()).sum(-1)
        kw = dict(causal=causal, scale=scale, window=window)
        dq = ops.flash_attention_bwd_dq_stream(q, k, v, do, lse, delta, **kw)
        dk, dv = ops.flash_attention_bwd_dkv_stream(q, k, v, do, lse, delta,
                                                    **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = ops.flash_attention_fwd_stream_reference(
            q, k, v, causal=causal, window=window)
        refs = (ops.flash_attention_bwd_dq_stream_reference(
            q, k, v, do, lse, delta, **kw),
            *ops.flash_attention_bwd_dkv_stream_reference(
                q, k, v, do, lse, delta, **kw))
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
        print(f"  flash_attention_stream {label}: " + ", ".join(parts)
              + f"; {n_dead} rows with no key exactly 0")
        return worst

    cases = [  # b, h, sq, sk, d, dtype, causal, window
        (1, 16, 8192, 8192, 64, bf16, True, None),
        (1, 16, 16384, 16384, 64, bf16, True, 4096),
        (1, 2, 4097, 4097, 64, f32, True, None),
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
    ]
    main_err = None
    for b, h, sq, sk, d, dt, causal, window in cases:
        q, k, v = rand(b, h, sq, d, dt=dt), rand(b, h, sk, d, dt=dt), \
            rand(b, h, sk, d, dt=dt)
        err = run(q, k, v, causal, window, f"b={b} h={h} sq={sq} sk={sk} "
                  f"d={d} {str(dt)[6:]} causal={causal} window={window}")
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
        if window is None:
            # the resident kernels beside the streamed ones
            ro, rlse = ops.flash_attention_fwd(q, k, v, causal=True)
            rdelta = (ro.float() * do.float()).sum(-1)
            rkw = dict(causal=True, scale=scale)
            out["fwd"]["resident_ms"] = time_ms(
                lambda: ops.flash_attention_fwd(q, k, v, causal=True), 10)
            out["dq"]["resident_ms"] = time_ms(
                lambda: ops.flash_attention_bwd_dq(q, k, v, do, rlse, rdelta,
                                                   **rkw), 10)
            out["dkv"]["resident_ms"] = time_ms(
                lambda: ops.flash_attention_bwd_dkv(q, k, v, do, rlse,
                                                    rdelta, **rkw), 10)
        label = f"({b},{h},{s},{d}) bf16 causal" + (
            f" window {window}" if window else "")
        flops = {"fwd": 4, "dq": 6, "dkv": 8}
        for key in ("fwd", "dq", "dkv"):
            t = out[key]
            res = (f", resident {t['resident_ms']:.4f} ms"
                   if "resident_ms" in t else "")
            lib = (f", SDPA {t['library_ms']:.4f} ms"
                   + (" with the band mask" if window else "")
                   + (" (backward: dQ+dK+dV)" if key != "fwd" else ""))
            rate = flops[key] * d * pairs / t["ms"] / 1e9
            print(f"  flash_attention_stream timing {label} {key}: kernel "
                  f"{t['ms']:.4f} ms ({rate:.1f} TFLOP/s), bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
                  f"{t['plain_ms']:.4f} ms{res}{lib}")
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
        return label, out

    by_shape = dict(timings(b, 16, s, 64, w)
                    for b, s, w in ((1, 8192, None), (1, 16384, 4096),
                                    (1, 4096, None), (8, 1024, None)))
    main_label = "(1,16,8192,64) bf16 causal"
    t = by_shape["(8,16,1024,64) bf16 causal"]
    print(f"  streamed backward at T (8,16,1024,64) causal: dQ + dK/dV "
          f"{t['dq']['ms'] + t['dkv']['ms']:.4f} ms, resident pair "
          f"{t['dq']['resident_ms'] + t['dkv']['resident_ms']:.4f} ms, SDPA "
          f"backward {t['dq']['library_ms']:.4f} ms")
    bwd_split_tuning(torch, ops, tfa, rand)
    for s_label in (main_label, "(1,16,4096,64) bf16 causal"):
        t = by_shape[s_label]
        stream_sum = sum(t[k]["ms"] for k in ("fwd", "dq", "dkv"))
        res_sum = sum(t[k]["resident_ms"] for k in ("fwd", "dq", "dkv"))
        print(f"  STREAM_MIN_SEQ basis {s_label}: forward + dQ + dK/dV "
              f"streamed {stream_sum:.4f} ms, resident {res_sum:.4f} ms")
    rows = []
    for key, name, line in (
            ("fwd", "flash_attention_fwd_stream", 506),
            ("dq", "flash_attention_bwd_dq_stream", 576),
            ("dkv", "flash_attention_bwd_dkv_stream", 637)):
        main = dict(by_shape[main_label][key])
        main.pop("resident_ms", None)
        rows.append(dict(
            name=name, route="cuda",
            source="apex_tpu_torch/csrc/flash_attention_stream.cu",
            replaces=f"apex_tpu/ops/flash_attention.py:{line}",
            max_abs_err=main_err[key],
            by_shape={lab: t[key] for lab, t in by_shape.items()}, **main))
    return rows


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


def _decode_inputs(torch, dev, gen, b, h, kh, blk, d, nb, max_blocks, dt,
                   lengths):
    q = torch.randn(b, h, d, device=dev, generator=gen).to(dt)
    kp = torch.randn(nb, kh, blk, d, device=dev, generator=gen).to(dt)
    vp = torch.randn(nb, kh, blk, d, device=dev, generator=gen).to(dt)
    perm = torch.randperm(nb - 1, device=dev, generator=gen) + 1
    tables = perm[:b * max_blocks].view(b, max_blocks).to(torch.int32)
    lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
    return q, kp, vp, tables, lens


def check_flash_decode(torch, ops, dev):
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(3)
    main_lengths = [700, 64, 1024, 0, 333, 17, 800, 513]  # slot 3 idle
    cases = [  # b, h, kh, blk, d, num_blocks, max_blocks, dtype, lengths
        (8, 16, 16, 16, 64, 513, 64, bf16, main_lengths),
        (8, 16, 16, 16, 64, 513, 64, f32, main_lengths),
        (8, 32, 16, 16, 64, 513, 64, bf16, main_lengths),   # GQA h = 2 kh
        (3, 8, 2, 8, 64, 40, 12, f32, [95, 0, 1]),
        (2, 4, 4, 128, 64, 9, 4, f32, [300, 512]),
        (2, 4, 2, 16, 128, 20, 8, bf16, [100, 7]),
        (2, 4, 2, 16, 36, 20, 8, bf16, [100, 7]),  # unaligned: scalar loads
    ]
    windowed = [  # the same shapes with window = 128 (and 5 at blk 8)
        (8, 16, 16, 16, 64, 513, 64, bf16, main_lengths, 128),
        (8, 16, 16, 16, 64, 513, 64, f32, main_lengths, 128),
        (8, 32, 16, 16, 64, 513, 64, bf16, main_lengths, 128),
        (3, 8, 2, 8, 64, 40, 12, f32, [95, 0, 1], 5),
        (2, 4, 2, 16, 36, 20, 8, bf16, [100, 7], 128),
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
        err = max_err(got, ref)
        tol = 2e-2 if dt == bf16 else 5e-5
        idle = [i for i, n in enumerate(lengths) if n == 0]
        zero = all(bool((got[i] == 0).all()) for i in idle)
        print(f"  flash_decode b={b} h={h} kh={kh} blk={blk} d={d} "
              f"{str(dt)[6:]:8s} window={window} max_abs_err={err:.3g} "
              f"(tol {tol:g}) idle slots exactly 0: {zero}")
        check(zero, f"flash_decode {(b, h, kh, blk, d, dt, window)}: idle "
              f"slots not 0")
        verdict(f"flash_decode b={b} h={h} kh={kh} blk={blk} d={d} "
                f"{str(dt)[6:]} window={window}", err, tol,
                group=f"flash_decode {str(dt)[6:]}")
        if window is not None and max(lengths) > window:
            full = ops.paged_attention_reference(q, kp, vp, tables, lens)
            check(max_err(full, ref) > tol, "the window changes the output")
        if main_err is None:
            main_err = err
    b, h, kh, blk, d, nb, mb = 8, 16, 16, 16, 64, 513, 64
    q, kp, vp, tables, lens = _decode_inputs(
        torch, dev, gen, b, h, kh, blk, d, nb, mb, bf16, main_lengths)
    ms = time_ms(lambda: ops.flash_decode(q, kp, vp, tables, lens))
    issue = issue_ms(lambda: ops.flash_decode(q, kp, vp, tables, lens))
    plain = time_ms(
        lambda: ops.paged_attention_reference(q, kp, vp, tables, lens), 5)
    live = sum(main_lengths)
    nbytes = (live * kh * d * 2 * 2 + 2 * b * h * d * 2 + b * mb * 4 + b * 4)
    bms, by = bound(nbytes, 4 * h * d * live, "bfloat16")
    print(f"  flash_decode timing (b=8 h=kh=16 blk=16 d=64 bf16, "
          f"{live} live keys): kernel {ms:.4f} ms (eager issue {issue:.4f} "
          f"ms per call), plain {plain:.4f} ms, no "
          f"single PyTorch call computes paged decode, bound {bms:.4f} ms "
          f"({by})")
    # the same inputs with window 128, and through the K-query kernel at
    # K = 1 (the same function): not checks
    ms_w = time_ms(lambda: ops.flash_decode(q, kp, vp, tables, lens,
                                            window=128))
    live_w = sum(min(n, 128) for n in main_lengths)
    bms_w, by_w = bound(nbytes - (live - live_w) * kh * d * 2 * 2,
                        4 * h * d * live_w, "bfloat16")
    ms_k1 = time_ms(lambda: ops.flash_decode_multi(q[:, :, None], kp, vp,
                                                   tables, lens))
    print(f"  flash_decode timing with window 128 ({live_w} live keys): "
          f"kernel {ms_w:.4f} ms, bound {bms_w:.4f} ms ({by_w}); the same "
          f"unwindowed call through flash_decode_multi at K=1: "
          f"{ms_k1:.4f} ms")
    return dict(name="flash_decode", route="cuda",
                source="apex_tpu_torch/csrc/flash_decode.cu",
                replaces="apex_tpu/ops/flash_decode.py:141",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None)


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
    which the reference kernel keeps fp32), 5e-5 in fp32. Idle slots and
    queries that see no key (a right-aligned chunk's padding rows) must be
    exactly 0."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(8)
    verify_lengths = [700, 64, 1000, 0, 333, 5, 800, 513]  # slot 3 idle
    chunk = (1, 16, 16, 256, 16, 64, 513, 64)
    verify = (8, 16, 16, 5, 16, 64, 513, 64)
    cases = [  # (b, h, kh, K, blk, d, num_blocks, max_blocks), lengths, window
        (chunk, [756], None),
        (verify, verify_lengths, None),
        (chunk, [100], None),            # 155 padding rows see <= 0 keys
        ((8, 16, 4, 5, 16, 64, 513, 64), verify_lengths, None),  # GQA
        (verify, verify_lengths, 128),
        (chunk, [900], 128),
        ((4, 16, 16, 7, 32, 64, 300, 32), [1000, 1, 0, 517], None),  # blk 32
        ((2, 16, 4, 5, 16, 128, 200, 64), [1000, 300], None),      # d 128
        ((2, 8, 8, 70, 16, 36, 100, 16), [30, 200], 50),  # unaligned d
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
            err = max_err(got, ref)
            tol = 2e-2 if dt == bf16 else 5e-5
            per_row, _ = _visible(lengths, kq, window, mb * blk)
            blind = [(i, j) for i, row in enumerate(per_row)
                     for j, n in enumerate(row) if n == 0]
            zero = all(bool((got[i, :, j] == 0).all()) for i, j in blind)
            print(f"  flash_decode_multi b={b} h={h} kh={kh} K={kq} blk={blk} "
                  f"d={d} {str(dt)[6:]:8s} window={window} max_abs_err="
                  f"{err:.3g} (tol {tol:g}); {len(blind)} queries that see "
                  f"no key exactly 0: {zero}")
            check(zero and bool(torch.isfinite(got).all())
                  and got.shape == q.shape and got.dtype == dt,
                  f"flash_decode_multi {(b, h, kh, kq, blk, d, dt, window)}")
            verdict(f"flash_decode_multi b={b} h={h} kh={kh} K={kq} "
                    f"blk={blk} d={d} {str(dt)[6:]} window={window}", err,
                    tol, group=f"flash_decode_multi {str(dt)[6:]}")
            if main_err is None:
                main_err = err
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
        print(f"  flash_decode_multi K=1 against flash_decode "
              f"{str(dt)[6:]}: max_abs_err={err:.3g} (tol {tol:g})")
        verdict(f"flash_decode_multi K=1 vs flash_decode {str(dt)[6:]}",
                err, tol, group=f"flash_decode_multi {str(dt)[6:]}")

    timings = {}
    for label, (b, h, kh, kq, blk, d, nb, mb), lengths in (
            ("chunk", chunk, [756]), ("verify", verify, verify_lengths)):
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
                source="apex_tpu_torch/csrc/flash_decode.cu",
                replaces="apex_tpu/ops/flash_decode.py:331",
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
    fp16, and rows of 65536 and 100003 elements (the two-pass route).
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
    scale, no mask: the same bytes) and the bound."""
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
        route = ops.softmax_route(sk)
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
            verdict(f"{name} {part}", err, lim, route, group=name)
            verdict(f"{name} {part} row", e_row, rlim, route, group=name)
        if mkind == "padding+dead":
            u = ulp(1.0 / sk, dt, torch)
            e_dead = float((y[0, 0, 7].float() - 1.0 / sk).abs().max())
            parts.append(f"fully masked row |y - 1/sk| {e_dead:.3g} (limit "
                         f"1 ulp = {u:.3g}), its dx max |.| "
                         f"{float(dx[0, 0, 7].float().abs().max()):.3g}")
            verdict(f"{name} masked row = 1/sk", e_dead, u, route,
                    group=name)
        print(f"  {name} {shape} mask={mkind} causal={causal} "
              f"scale={scale:g} [{route}]: " + ", ".join(parts))
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
    del inputs
    torch.cuda.empty_cache()
    common = dict(route="cuda", source="apex_tpu_torch/csrc/softmax.cu")
    return [dict(common, name="softmax_fwd",
                 replaces="apex_tpu/ops/softmax.py:40",
                 max_abs_err=main_err["gpt"][0],
                 by_shape={k: v["fwd"] for k, v in timings.items()},
                 **timings["gpt"]["fwd"]),
            dict(common, name="softmax_bwd",
                 replaces="apex_tpu/ops/softmax.py:55",
                 max_abs_err=main_err["gpt"][1],
                 by_shape={k: v["bwd"] for k, v in timings.items()},
                 **timings["gpt"]["bwd"])]


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


def print_top(by_name, k=10):
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:k]:
        print(f"    {t / 1e3:9.2f} ms {n:6d}x  {name[:80]}")


def device_busy(torch, eng, reqs, label):
    """Device busy share of a serving window: the kernels' device time from
    ``torch.profiler`` over the window's wall time. Not a check."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    for row in rows:
        by_path = {"serve": serve_counts[row["name"]],
                   "serve_prefix_spec": spec_counts[row["name"]],
                   "serve_chunked": chunk_counts[row["name"]],
                   "train": train_counts[row["name"]],
                   "train_resnet": resnet_counts[row["name"]],
                   "train_long": long_counts[row["name"]],
                   "train_long_window": window_counts[row["name"]],
                   "softmax": softmax_counts[row["name"]]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        verdict(f"{row['name']} launched on the main paths",
                0 if row["launches"] else 1, 0, row["route"],
                group="every kernel launched on a main path")
    print_verdict()
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "by_shape")
    print(json.dumps({"kernels": [{k: row[k] for k in keys if k in row}
                                  for row in rows]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
