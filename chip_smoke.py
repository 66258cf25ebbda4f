#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``apex_tpu_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Three phases; any failure raises and exits non-zero:

1. **Build** every kernel of the serving path from ``apex_tpu_torch/csrc``
   with nvcc (``sm_90a``) and print the build seconds, the card's name and
   its power limit.
2. **Kernel vs plain**: each kernel (LayerNorm forward, flash-attention
   forward, paged flash-decode) against its plain PyTorch version on the
   card, at the serving path's shapes in bf16 and fp32 plus edge cases,
   each error beside its stated tolerance; then device times by CUDA-graph
   replay between CUDA events (kernel, plain version, one PyTorch library
   call as yardstick where one computes the same function) and the least
   time the card could take.
3. **Serving**: an fp32 greedy gate on a small model (the engine's tokens
   against the argmax of the full-context forward at every generated
   position), then GPT-2 345M at full width (random weights from a seed,
   bf16 compute, fp32 params) serving 16 requests, with every kernel's
   launch count on that run checked against the count the path implies.

The line before the last is the card's name and power limit as nvidia-smi
prints them, the one before that a ``{"kernels": [...]}`` JSON object, and
the last line ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
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


def time_ms(fn, iters=20, reps=5):
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    the graph replayed ``reps`` times between two CUDA events, so the
    Python cost of issuing each call is not in the number."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
    return dict(name="flash_attention_fwd", route="cuda",
                source="apex_tpu_torch/csrc/flash_attention.cu",
                replaces="apex_tpu/ops/flash_attention.py:251",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


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
    main_err = None
    for b, h, kh, blk, d, nb, mb, dt, lengths in cases:
        q, kp, vp, tables, lens = _decode_inputs(
            torch, dev, gen, b, h, kh, blk, d, nb, mb, dt, lengths)
        got = ops.flash_decode(q, kp, vp, tables, lens)
        ref = ops.paged_attention_reference(q, kp, vp, tables, lens)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        tol = 2e-2 if dt == bf16 else 5e-5
        idle = [i for i, n in enumerate(lengths) if n == 0]
        zero = all(bool((got[i] == 0).all()) for i in idle)
        print(f"  flash_decode b={b} h={h} kh={kh} blk={blk} d={d} "
              f"{str(dt)[6:]:8s} max_abs_err={err:.3g} (tol {tol:g}) "
              f"idle slots exactly 0: {zero}")
        check(err <= tol and zero, f"flash_decode {(b, h, kh, blk, d, dt)}")
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
    return dict(name="flash_decode", route="cuda",
                source="apex_tpu_torch/csrc/flash_decode.cu",
                replaces="apex_tpu/ops/flash_decode.py:141",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None)


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------


def greedy_gate(torch, dev):
    """fp32, small model: every generated token equals the argmax of one
    full-context forward over the finished sequence; where that forward's
    top-2 gap is below 1e-3 the token must be in its top 2 (and the check
    of that request stops there)."""
    import numpy as np

    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.serve import Engine, Request, ServeConfig

    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                    num_attention_heads=4, max_seq_len=256,
                    compute_dtype=torch.float32)
    model = GPTModel(cfg, device=dev, seed=5)
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=list(rng.integers(0, cfg.vocab_size, n)),
                    max_new_tokens=m, request_id=i)
            for i, (n, m) in enumerate(((5, 16), (60, 12), (17, 20),
                                        (33, 9), (1, 16), (100, 24)))]
    eng = Engine(model, ServeConfig(max_batch=4, max_seq=128, block_size=16),
                 device=dev)
    res = eng.run(reqs)
    checked = 0
    for req in res.values():
        seq = list(req.prompt) + req.tokens
        logits = model.apply(torch.tensor([seq], device=dev))[0].float()
        for t in range(len(req.prompt), len(seq)):
            row = logits[t - 1]
            top2 = torch.topk(row, 2)
            if float(top2.values[0] - top2.values[1]) < 1e-3:
                check(seq[t] in top2.indices.tolist(),
                      f"gate: request {req.request_id} pos {t} not in top-2")
                break
            check(int(top2.indices[0]) == seq[t],
                  f"gate: request {req.request_id} pos {t}: engine "
                  f"{seq[t]} != forward argmax {int(top2.indices[0])}")
            checked += 1
    check(len(res) == len(reqs) and eng.allocator.used == 0, "gate drain")
    print(f"  fp32 greedy gate: {len(res)} requests, {checked} generated "
          f"tokens equal the full-context argmax")


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
    rng = np.random.default_rng(0)
    new = 64
    reqs = [Request(prompt=list(rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(64, 769)))),
                    max_new_tokens=new, request_id=i) for i in range(16)]
    p0, d0 = eng.prefills, eng.decode_steps
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    prefills, ticks = eng.prefills - p0, eng.decode_steps - d0
    L = cfg.num_layers
    expected = {"flash_attention_fwd": L * prefills,
                "flash_decode": L * ticks,
                "layer_norm_fwd": (2 * L + 1) * (prefills + ticks)}
    print(f"  345M: {n_params / 1e6:.1f} M params, {prefills} prefills, "
          f"{ticks} decode ticks, launches {counts} (expected {expected})")
    check(prefills == len(reqs), "one prefill per request")
    for name, n in counts.items():
        check(n > 0 and n == expected[name],
              f"{name}: {n} launches, expected {expected[name]}")
    toks = [t for r in res.values() for t in r.tokens]
    check(len(res) == len(reqs) and all(len(r.tokens) == new
                                        for r in res.values()),
          "every request got its tokens")
    check(all(0 <= t < cfg.vocab_size for t in toks), "token range")
    check(eng.allocator.used == 0, "every page freed")
    # the output against the reference forward: one request's sequence
    r = res[3]
    seq = torch.tensor([list(r.prompt) + r.tokens], device=dev)
    logits = model.apply(seq)[0].float()
    check(tuple(logits.shape) == (seq.shape[1], cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "345M logits finite")
    top5 = torch.topk(logits[len(r.prompt) - 1], 5).indices.tolist()
    check(r.tokens[0] in top5, "345M first token in the forward's top 5")
    ttft = statistics.median(x.ttft_s for x in res.values())
    ttft_min = min(x.ttft_s for x in res.values())
    itl = statistics.median(v for x in res.values() for v in x.itl_s)
    print(f"  345M serve: {len(toks)} tokens in {wall:.3f} s = "
          f"{len(toks) / wall:.1f} tokens/s, TTFT p50 {ttft * 1e3:.2f} ms "
          f"(min {ttft_min * 1e3:.2f} ms), "
          f"ITL p50 {itl * 1e3:.2f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    device_busy(torch, eng, cfg)
    return counts


def device_busy(torch, eng, cfg):
    """Device busy share of a decode-heavy serving window (8 requests of
    256 prompt tokens, 48 new tokens each): the kernels' device time from
    ``torch.profiler`` over the window's wall time. Not a check."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.serve import Request

    rng = np.random.default_rng(1)
    reqs = [Request(prompt=list(rng.integers(0, cfg.vocab_size, 256)),
                    max_new_tokens=48, request_id=f"w{i}") for i in range(8)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    busy_us = sum(t for _, t in by_name.values())
    if busy_us <= 0:
        print("  345M window: device busy time not measured (the profiler "
              "saw no device events)")
        return
    print(f"  345M window (8 x 256-token prompts, 48 new tokens): wall "
          f"{wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms = "
          f"{busy_us / 1e6 / wall:.3f} of the window (idle "
          f"{1 - busy_us / 1e6 / wall:.3f}); device time by kernel:")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"    {t / 1e3:9.2f} ms {n:6d}x  {name[:80]}")


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
            check_flash_attention(torch, ops, dev),
            check_flash_decode(torch, ops, dev)]

    print("phase 3: serving")
    greedy_gate(torch, dev)
    counts = serve_345m(torch, ops, dev)
    for row in rows:
        row["launches"] = counts[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
