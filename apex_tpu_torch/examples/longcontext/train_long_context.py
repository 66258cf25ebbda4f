"""Long-context GPT training on one card: the serial mode (``--cp 1 --dp
1``) of ``examples/longcontext/train_long_context.py``.

    python -m apex_tpu_torch.examples.longcontext.train_long_context \\
        --seq 8192 --hidden 1024 --layers 24 --heads 16 --vocab 50304 \\
        --batch 1 --lm-head-chunks 8 --steps 11
    ... --seq 16384 --pos rope --window 4096   # rotary + sliding window

The moving parts are the reference's: ``GPTConfig(max_seq_len=seq,
hidden_dropout=0, bf16 compute, remat=True, lm_head_chunks,
attention_window, position_embedding)``, ``amp.get_policy("O2")`` +
``cast_params`` + ``MixedPrecisionOptimizer(FusedAdam(lr=1e-4))`` with the
dynamic loss scale, ``model.loss`` on one fixed random batch and its
next-token targets. At these lengths (``STREAM_MIN_SEQ``), or with a
window, every layer's attention runs the streamed flash kernels on the card.

Ring and Ulysses context parallelism (``--cp`` > 1) and data parallelism
(``--dp`` > 1) come with ROADMAP Queue 1 items 15 and 9 and raise;
``--sp-impl`` is accepted and unused, as in the reference's serial mode.
``--cp`` and ``--dp`` default to 1 here (the reference defaults to a 4 x 2
mesh). ``--device cpu`` runs the plain versions of the kernels on the CPU;
the default is the card. ``--output`` writes the reference's JSON record,
with its keys.

:func:`build` returns an ``apex_tpu_torch.bench.Bench``, so
``bench.fixed_batch`` / ``bench.train_steps`` drive it as ``chip_smoke.py``
does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import torch

from apex_tpu_torch import amp
from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.bench import Bench, fixed_batch
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam

_PARALLEL_LATER = ("--cp {cp} --dp {dp}: context parallelism (ring/Ulysses "
                   "attention over a process group) comes with ROADMAP Queue "
                   "1 item 15 and data parallelism with item 9; this slice "
                   "runs the serial mode (--cp 1 --dp 1)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cp", type=int, default=1, help="context-parallel size")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel size")
    ap.add_argument("--seq", type=int, default=4096,
                    help="GLOBAL context length")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: dp)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--sp-impl", choices=["ring", "ulysses"], default="ring",
                    help="context-parallel attention (unused when serial)")
    ap.add_argument("--lm-head-chunks", type=int, default=None,
                    help="chunked LM-head CE: the (tokens, vocab) logits are "
                         "never whole")
    ap.add_argument("--window", type=int, default=None,
                    help="sliding-window attention (GPTConfig."
                         "attention_window): O(s*window) attention cost")
    ap.add_argument("--pos", choices=["learned", "rope", "none"],
                    default="learned",
                    help="position encoding; rope has no position table")
    ap.add_argument("--output", default=None,
                    help="write a JSON measurement record")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv)


def build(*, seq: int = 4096, hidden: int = 256, layers: int = 4,
          heads: int = 8, vocab: int = 32768, batch: int = 1,
          lm_head_chunks: Optional[int] = None,
          window: Optional[int] = None, pos: str = "learned",
          cp: int = 1, dp: int = 1, seed: int = 0,
          device: DeviceLike = None) -> Bench:
    """The reference's serial config and O2 state (``:83-111``) on one
    device (the card unless ``device="cpu"``), random weights from
    ``seed``; ``step(tokens, targets)`` is its serial step (``:113-121``):
    the scaled loss's backward, then the O2 FusedAdam step, which skips the
    update and halves the scale on an overflow."""
    if cp != 1 or dp != 1:
        raise NotImplementedError(_PARALLEL_LATER.format(cp=cp, dp=dp))
    dev = resolve_device(device)
    policy = amp.get_policy("O2")
    cfg = GPTConfig(
        vocab_size=vocab,
        hidden_size=hidden,
        num_layers=layers,
        num_attention_heads=heads,
        max_seq_len=seq,
        hidden_dropout=0.0,
        axis=None,
        compute_dtype=policy.compute_dtype,
        remat=True,
        lm_head_chunks=lm_head_chunks,
        attention_window=window,
        position_embedding=pos,
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


def main(argv=None) -> int:
    args = parse_args(argv)
    batch = args.batch or args.dp
    trainer = build(seq=args.seq, hidden=args.hidden, layers=args.layers,
                    heads=args.heads, vocab=args.vocab, batch=batch,
                    lm_head_chunks=args.lm_head_chunks, window=args.window,
                    pos=args.pos, cp=args.cp, dp=args.dp,
                    device=args.device)
    tokens, targets = fixed_batch(trainer)
    on_card = tokens.device.type == "cuda"
    loss = None
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss, _ = trainer.step(tokens, targets)
        loss_val = float(loss)  # device->host fetch: the step's barrier
        if i == 0:
            t0 = time.perf_counter()  # exclude the warm-up step
        print(f"step {i}: loss {loss_val:.4f}", file=sys.stderr)
    steps_timed = max(args.steps - 1, 1)
    dt = (time.perf_counter() - t0) / steps_timed
    tok_s = batch * args.seq / dt
    print(f"{tok_s:.0f} tokens/s at context {args.seq} "
          f"(cp={args.cp}, dp={args.dp}, serial)")
    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with open(args.output, "w") as f:
            json.dump({
                "metric": "longcontext_train_tokens_per_sec",
                "platform": "gpu" if on_card else "cpu",
                "seq": args.seq, "cp": args.cp, "dp": args.dp,
                "mode": "serial", "batch": batch,
                "hidden": args.hidden, "layers": args.layers,
                "lm_head_chunks": args.lm_head_chunks,
                "window": args.window,
                "position_embedding": args.pos,
                "steps_timed": steps_timed,
                "tokens_per_sec": round(tok_s, 1),
                "loss_final": round(float(loss), 4),
            }, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
