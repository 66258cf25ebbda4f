"""Optimizer-step benchmark: the fused steps against an eager per-parameter
Adam (port of ``benchmarks/optimizer_step.py``; BASELINE.md target 3,
"fused-optimizer step >= 3x an unfused eager Adam").

    python -m apex_tpu_torch.benchmarks.optimizer_step          # the card
    python -m apex_tpu_torch.benchmarks.optimizer_step --device cpu

The two sides, as the reference frames them:

- **fused**: ``FusedAdam.update_`` and ``FusedLAMB.update_``, whose
  ``torch._foreach_*`` passes batch the whole parameter list into few
  launches (the multi-tensor-apply equivalent);
- **eager**: the same Adam math one parameter at a time, each op its own
  launch, as an eager ``torch.optim.Adam`` loop issues them.

Two parameter lists: the reference's GPT-2-124M-shaped tree (148 leaves,
:func:`gpt2_like_params`) and BERT-large's (``BertModel(BertConfig())``,
fp32). Each side is timed in interleaved windows (fused Adam, fused LAMB,
eager Adam, again ``windows`` times) between CUDA events (the host clock on
the CPU), and each ratio is the median of the same-window ratios. Prints
one JSON line with both ratios per list, the card's name and power limit.
The ratio is reported; nothing is claimed.

The command line adds :func:`per_optimizer_ms`: the ms a step of every
fused optimizer of the port on the GPT-2-124M list (FusedAdam, FusedLAMB,
FusedAdagrad, FusedNovoGrad, LARC around FusedSGD with momentum, and
FusedMixedPrecisionLamb stepping bf16 copies of the list through fp32
masters from grads scaled by 2^16, with no host read), in interleaved
windows; reported only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from typing import Callable, Dict, List

import torch

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.optimizers import (
    LARC,
    FusedAdagrad,
    FusedAdam,
    FusedLAMB,
    FusedMixedPrecisionLamb,
    FusedNovoGrad,
    FusedSGD,
)


def gpt2_like_params(hidden: int = 768, layers: int = 12, vocab: int = 50304,
                     seq: int = 1024, device: DeviceLike = None,
                     seed: int = 0) -> List[torch.Tensor]:
    """The reference's GPT-2-124M-shaped fp32 parameter list
    (``gpt2_like_param_tree``: 4 + 12 per layer leaves, ~124M values),
    normal(0, 0.02) weights and unit/zero norms from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen) * 0.02

    def ln():
        return [torch.ones(hidden, device=dev), torch.zeros(hidden,
                                                            device=dev)]

    out = [rnd(vocab, hidden), rnd(seq, hidden), *ln()]
    for _ in range(layers):
        out += ln()
        out += [rnd(hidden, 3 * hidden), torch.zeros(3 * hidden, device=dev),
                rnd(hidden, hidden), torch.zeros(hidden, device=dev)]
        out += ln()
        out += [rnd(hidden, 4 * hidden), torch.zeros(4 * hidden, device=dev),
                rnd(4 * hidden, hidden), torch.zeros(hidden, device=dev)]
    return out


def bert_large_params(device: DeviceLike = None) -> List[torch.Tensor]:
    """BERT-large's fp32 parameter list (``BertModel(BertConfig())``)."""
    from apex_tpu_torch.models import BertConfig, BertModel

    model = BertModel(BertConfig(), device=device)
    return [p.detach() for p in model.parameters()]


@torch.no_grad()
def eager_adam_step(params, m, v, grads, t: int, lr: float = 1e-3,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Unfused eager Adam: a Python loop over the parameters, each op its
    own launch (``eager_adam_step``, ``optimizer_step.py:74-99``), in
    place."""
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    for p, g, mi, vi in zip(params, grads, m, v):
        mi.mul_(b1).add_(g, alpha=1.0 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (vi / bc2).sqrt_().add_(eps)
        p.addcdiv_(mi, denom, value=-lr / bc1)


def _window_ms(fn: Callable[[], None], steps: int, on_card: bool) -> float:
    """Time per step of ``steps`` back-to-back calls: between CUDA events on
    the card (the host's issue included where the device waits on it), on
    the host clock on the CPU."""
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    return (time.perf_counter() - t0) / steps * 1e3


def measure(params: List[torch.Tensor], fused_steps: int = 10,
            eager_steps: int = 3, windows: int = 3) -> Dict[str, float]:
    """One step of fused Adam, fused LAMB and eager Adam on ``params``
    (grads of 1e-4, as the reference's), in interleaved windows; the
    speedups are medians of the same-window ratios."""
    on_card = params[0].device.type == "cuda"
    grads = [torch.full_like(p, 1e-4) for p in params]
    sides = {}
    for name, opt in (("fused_adam", FusedAdam(lr=1e-3)),
                      ("fused_lamb", FusedLAMB(lr=1e-3))):
        ps = [p.clone() for p in params]
        box = [opt.init(ps)]

        def step(opt=opt, ps=ps, box=box):
            box[0] = opt.update_(ps, grads, box[0])

        sides[name] = (step, fused_steps)
    ep = [p.clone() for p in params]
    em = [torch.zeros_like(p) for p in params]
    ev = [torch.zeros_like(p) for p in params]
    count = [0]

    def eager():
        count[0] += 1
        eager_adam_step(ep, em, ev, grads, count[0])

    sides["eager_adam"] = (eager, eager_steps)
    for fn, _ in sides.values():  # warm-up
        fn()
    if on_card:
        torch.cuda.synchronize()
    samples: Dict[str, List[float]] = {k: [] for k in sides}
    for _ in range(windows):
        for name, (fn, n) in sides.items():
            samples[name].append(_window_ms(fn, n, on_card))
    out = {f"{k}_ms": statistics.median(v) for k, v in samples.items()}
    for k in ("fused_adam", "fused_lamb"):
        out[f"{k.split('_')[1]}_speedup"] = statistics.median(
            e / f for f, e in zip(samples[k], samples["eager_adam"]))
    out["leaves"] = len(params)
    out["params"] = sum(p.numel() for p in params)
    return out


def per_optimizer_ms(params: List[torch.Tensor], steps: int = 10,
                     windows: int = 3) -> Dict[str, float]:
    """The ms a step of each fused optimizer on its own copy of ``params``
    (grads of 1e-4), windows of ``steps`` steps interleaved across the
    optimizers, the median window of each. FusedMixedPrecisionLamb steps
    bf16 copies from bf16 grads of 1e-4 x 2^16 with ``scale`` and ``lr`` as
    device tensors."""
    on_card = params[0].device.type == "cuda"
    grads = [torch.full_like(p, 1e-4) for p in params]
    scale = 2.0 ** 16
    sides = {}
    for name, opt in (("fused_adam", FusedAdam(lr=1e-3)),
                      ("fused_lamb", FusedLAMB(lr=1e-3)),
                      ("fused_adagrad", FusedAdagrad(lr=1e-3)),
                      ("fused_novograd", FusedNovoGrad(lr=1e-3)),
                      ("larc_fused_sgd",
                       LARC(FusedSGD(lr=1e-3, momentum=0.9)))):
        ps = [p.clone() for p in params]
        box = [opt.init(ps)]

        def step(opt=opt, ps=ps, box=box):
            box[0] = opt.update_(ps, grads, box[0])

        sides[name] = step
    mp = FusedMixedPrecisionLamb(lr=1e-3,
                                 reduced_precision_dtype=torch.bfloat16)
    mps = [p.to(torch.bfloat16) for p in params]
    mpg = [torch.full_like(p, 1e-4 * scale) for p in mps]
    dev = params[0].device
    kw = dict(scale=torch.full((), scale, device=dev),
              lr=torch.full((), 1e-3, device=dev))
    mbox = [mp.init(mps)]

    def mp_step():
        mbox[0] = mp.step(mbox[0], mps, mpg, **kw)

    sides["fused_mixed_precision_lamb"] = mp_step
    for fn in sides.values():  # warm-up
        fn()
    if on_card:
        torch.cuda.synchronize()
    samples: Dict[str, List[float]] = {k: [] for k in sides}
    for _ in range(windows):
        for name, fn in sides.items():
            samples[name].append(_window_ms(fn, steps, on_card))
    return {k: statistics.median(v) for k, v in samples.items()}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "not read"


def run(device: DeviceLike = None, gpt2=None, bert: bool = True,
        windows: int = 3) -> Dict:
    """The benchmark's record: both lists' times and ratios."""
    dev = resolve_device(device)
    lists = {"gpt2_124m": gpt2_like_params(**(gpt2 or {}), device=dev)}
    if bert:
        lists["bert_large"] = bert_large_params(dev)
    trees = {}
    for name, params in lists.items():
        trees[name] = measure(params, windows=windows)
        del params
    return {"metric": "fused_optimizer_step_vs_eager_adam_step",
            "unit": "x", "platform": "gpu" if dev.type == "cuda" else "cpu",
            "card": card_line() if dev.type == "cuda" else None,
            "trees": trees}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args(argv)
    rec = run(args.device, windows=args.windows)
    rec["per_optimizer_ms"] = {"gpt2_124m": per_optimizer_ms(
        gpt2_like_params(device=args.device), windows=args.windows)}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
