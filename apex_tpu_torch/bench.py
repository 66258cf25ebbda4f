"""GPT-2 345M amp-O2 training step on one card (port of the serial,
non-ZeRO branch of ``bench.py``'s ``build``, ``bench.py:293-420``).

    from apex_tpu_torch.bench import build, train_steps
    bench = build("O2")                      # on the card, random weights
    stats = train_steps(bench, n=10)         # one warm-up step, 10 timed

The config is ``bench.py:325-343``: vocab 50304, hidden 1024, 24 layers, 16
heads, seq 1024, ``hidden_dropout=0``, serial, bf16 compute with fp32
masters and dynamic loss scaling (``get_policy("O2")``), full remat per
layer, the chunked LM-head CE with 8 chunks, ``FusedAdam(lr=1e-4)`` inside
``MixedPrecisionOptimizer``. Only the ``hidden`` / ``layers`` / ``batch``
arguments resize it; ``BENCH_ZERO`` and ``BENCH_QCOMM`` raise (ZeRO is
ROADMAP Queue 1 item 11), and the O0 fp32 baseline leg is a later PR.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional

import torch

from apex_tpu_torch import amp
from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam

SEQ = 1024
VOCAB = 50304


@dataclasses.dataclass
class Bench:
    """What :func:`build` returns: ``step(tokens, targets) -> (loss,
    metrics)`` runs one training step (the unscaled mean loss, detached, and
    the optimizer's metrics), over ``model`` / ``mp_opt`` / ``opt_state``."""

    step: Callable
    model: GPTModel
    mp_opt: amp.MixedPrecisionOptimizer
    opt_state: amp.MPOptState
    cfg: GPTConfig
    batch: int


def build(policy_level: str = "O2", *, remat_policy: Optional[str] = None,
          hidden: int = 1024, layers: int = 24, batch: int = 8,
          seed: int = 0, device: DeviceLike = None) -> Bench:
    """The reference's ``build("O2", ...)`` on one device (the card unless
    ``device="cpu"``), with random weights from ``seed``."""
    if os.environ.get("BENCH_ZERO") or os.environ.get("BENCH_QCOMM"):
        raise NotImplementedError(
            "BENCH_ZERO / BENCH_QCOMM: the ZeRO optimizer path is not in this "
            "slice of the port; it comes with ROADMAP Queue 1 item 11")
    if policy_level != "O2":
        raise NotImplementedError(
            f"build({policy_level!r}): only the O2 leg is ported; the O0 "
            f"fp32 baseline leg comes with a later PR (ROADMAP Queue 1 "
            f"item 8)")
    dev = resolve_device(device)
    policy = amp.get_policy(policy_level)
    cfg = GPTConfig(
        vocab_size=VOCAB,
        hidden_size=hidden,
        num_layers=layers,
        num_attention_heads=16,
        max_seq_len=SEQ,
        hidden_dropout=0.0,
        axis=None,
        compute_dtype=policy.compute_dtype,
        remat=True,
        remat_policy=remat_policy,
        lm_head_chunks=8,
    )
    model = GPTModel(cfg, device=dev, seed=seed)
    amp.cast_params(model, policy)
    mp_opt = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-4), policy)
    opt_state = mp_opt.init(model)

    def step(tokens: torch.Tensor, targets: torch.Tensor):
        loss = model.loss(tokens, targets)
        mp_opt.scale_loss(loss, opt_state).backward()
        metrics = mp_opt.step(opt_state, model)
        return loss.detach(), metrics

    return Bench(step, model, mp_opt, opt_state, cfg, batch)


def fixed_batch(bench: Bench, seed: int = 1):
    """One ``(batch, 1024)`` token batch from ``seed`` and its next-token
    targets (``jnp.roll(tokens, -1)``, as the reference's bench)."""
    dev = bench.model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tokens = torch.randint(0, bench.cfg.vocab_size,
                           (bench.batch, bench.cfg.max_seq_len),
                           generator=gen, device=dev)
    return tokens, torch.roll(tokens, -1, dims=-1)


def train_steps(bench: Bench, n: int = 10, tokens=None, targets=None, *,
                batch=None) -> Dict[str, Any]:
    """One warm-up step, then ``n`` steps on one fixed batch, timed with
    CUDA events between the steps (each reading includes the host's issue
    and its one wait per step, on the overflow flag and the loss). Returns
    the per-step losses (floats, the warm-up's first), the optimizer
    metrics, ``window_ms`` (the ``n`` timed steps from the first event to
    the last), ``step_ms`` (each timed step; both None on the CPU, where
    nothing is timed) and ``tokens_per_step``. ``batch``: the step's whole
    argument tuple (token ids first), for a step that takes more than
    ``(tokens, targets)``, as BERT's does."""
    if batch is None:
        if tokens is None:
            tokens, targets = fixed_batch(bench)
        batch = (tokens, targets)
    tokens = batch[0]
    losses: List[float] = []
    metrics: List[Dict[str, Any]] = []
    on_card = tokens.device.type == "cuda"
    events = []
    for i in range(n + 1):
        if on_card and i > 0:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        loss, m = bench.step(*batch)
        losses.append(float(loss))
        metrics.append(m)
    window_ms = step_ms = None
    if on_card:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        events[-1].synchronize()
        window_ms = events[0].elapsed_time(events[-1])
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return {"losses": losses, "metrics": metrics, "window_ms": window_ms,
            "step_ms": step_ms, "tokens_per_step": tokens.numel()}
