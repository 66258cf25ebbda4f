#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``apex_tpu_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Five phases; any failure raises and exits non-zero:

1. **Build** every kernel from ``apex_tpu_torch/csrc`` with nvcc
   (``sm_90a``) and print the build seconds, the card's name and its power
   limit.
2. **Kernel vs plain**: each kernel (LayerNorm forward and backward,
   flash-attention forward, its dQ and dK/dV backward, paged flash-decode
   with and without its window, the K-query paged decode, the softmax
   cross-entropy forward and backward) against its plain PyTorch version
   on the card, at the main paths' shapes in bf16 and fp32 plus edge
   cases, each error beside its stated tolerance; then device
   times by CUDA-graph replay between CUDA events (kernel, plain version,
   one PyTorch library call as yardstick where one computes the same
   function) and the least time the card could take.
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

The line before the last is the card's name and power limit as nvidia-smi
prints them, the one before that a ``{"kernels": [...]}`` JSON object
(``launches_by_path``: each kernel's count on the three serving runs, the
GPT training run and the ResNet training run, each counted from 0;
``launches``: their sum), and the last line ``{"ok": true, "device":
{...}}``. Imports nothing of JAX.
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
        if dt == bf16:
            # one bf16 ulp at |y|: both round the same fp32 value
            ok = bool(((got.float() - ref.float()).abs()
                       <= ref.float().abs() * 2.0 ** -7 + 1e-6).all())
            tol = "1 bf16 ulp"
        else:
            ok, tol = err <= 1e-5, "1e-05"
        print(f"  layer_norm {variant:9s} rows={rows:4d} hidden={hidden} "
              f"{str(dt)[6:]:8s} max_abs_err={err:.3g} (tol {tol})")
        check(ok and got.dtype == x.dtype, f"layer_norm {variant} {dt}")
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
        check(err <= tol and got.dtype == dt and got.shape == q.shape,
              f"flash_attention {(b, h, sq, sk, d, dt, causal)}")
        if main_err is None:
            main_err = err
    # a fused-QKV view (strided heads) goes in without a copy
    qkv = torch.randn(1, 128, 4, 3, 64, device=dev, generator=gen).to(bf16)
    qkv = qkv.permute(0, 2, 3, 1, 4)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    err = max_err(ops.flash_attention(q, k, v, causal=True),
                  ops.mha_reference(q, k, v, causal=True))
    print(f"  flash_attention strided fused-QKV view max_abs_err={err:.3g}")
    check(err <= 2e-2, "flash_attention on a strided view")

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
            check(e <= tol, f"layer_norm_bwd {variant} {rows}x{hidden} {dt} "
                  f"{name}: rel err {e:.3g} > {tol:g}")
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
            check(e <= tol, f"flash bwd {label} {name}: rel err {e:.3g} > "
                  f"{tol:g}")
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
        check(err <= tol and zero,
              f"flash_decode {(b, h, kh, blk, d, dt, window)}")
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
            check(err <= tol and zero and bool(torch.isfinite(got).all())
                  and got.shape == q.shape and got.dtype == dt,
                  f"flash_decode_multi {(b, h, kh, kq, blk, d, dt, window)}")
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
        check(err <= tol, f"flash_decode_multi K=1 {dt}")

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
            check(e <= tol, f"xentropy rows={rows} V={vocab} {dt} eps={eps} "
                  f"scale={scale:g} {name}: rel err {e:.3g} > {tol:g}")
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
    check_counts(counts, expected)
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
    check_counts(counts, expected)
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
    check_counts(counts, expected)
    check_345m_output(torch, model, res, reqs)
    check(eng.allocator.used == 0, "every page freed")
    m = latency(res, wall)
    print(f"  345M chunked serve: {m['tokens']} tokens in {wall:.3f} s = "
          f"{m['tokens_s']:.1f} tokens/s, TTFT p50 {m['ttft_ms']:.2f} ms "
          f"(monolithic {mono['ttft_ms']:.2f}), ITL p50 {m['itl_ms']:.2f} ms "
          f"(monolithic {mono['itl_ms']:.2f})")
    return counts, m


def check_counts(counts, expected):
    for name, n in counts.items():
        check(n == expected[name] and (n > 0) == (expected[name] > 0),
              f"{name}: {n} launches, expected {expected[name]}")


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
    check(rel <= 1e-5, "gradient gate loss")
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
    print(f"  fp32 gradient gate: {len(list(host.parameters()))} parameter "
          f"grads within 1e-4 of max|cpu grad| (worst {worst[0]:.3g}, "
          f"{worst[1]})")


def model_flops_per_token(cfg):
    """Training FLOPs per token, without the remat recompute: 6 x (the
    12*L*H^2 layer weights + the V*H tied head) + 6*L*S*H for the causal
    attention products (half of 12*L*S*H)."""
    L, H, S, V = (cfg.num_layers, cfg.hidden_size, cfg.max_seq_len,
                  cfg.vocab_size)
    return 6 * (12 * L * H * H + V * H) + 6 * L * S * H


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
    per_step = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L, "layer_norm_fwd": 4 * L + 1,
                "layer_norm_bwd": 2 * L + 1, "flash_decode": 0,
                "flash_decode_multi": 0, "xentropy_fwd": 0,
                "xentropy_bwd": 0}
    expected = {k: v * steps for k, v in per_step.items()}
    print(f"  345M O2 train: {n_params / 1e6:.1f} M params, batch "
          f"{bench.batch} x {cfg.max_seq_len}, {steps} steps, launches "
          f"{counts} (expected per step {per_step})")
    check_counts(counts, expected)
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
    check(rel <= 1e-5, "ResNet gradient gate loss")
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
    check_counts(counts, expected)
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
            check_flash_decode(torch, ops, dev),
            check_flash_decode_multi(torch, ops, dev),
            *check_xentropy(torch, ops, dev)]
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
    for row in rows:
        by_path = {"serve": serve_counts[row["name"]],
                   "serve_prefix_spec": spec_counts[row["name"]],
                   "serve_chunked": chunk_counts[row["name"]],
                   "train": train_counts[row["name"]],
                   "train_resnet": resnet_counts[row["name"]]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
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
