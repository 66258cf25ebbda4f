"""Long-context GPT training: ``examples/longcontext/train_long_context.py``,
serial, data parallel and context parallel.

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

``--cp C --dp N`` is the reference's sharded branch (``:122-153``): launch
C x N processes (``torchrun --nproc_per_node C*N``; the world must have
that many ranks) on the mesh of ``initialize_model_parallel(
context_parallel_size=C)``. The targets are rolled on the global sequence
first (``:110-111``); each rank takes its rows of the global batch
(``--batch``, default N) and its ``seq / C`` tokens of them, attention
runs as the ring or Ulysses (``--sp-impl``, ``GPTConfig.
sequence_parallel_impl``), each rank's loss is its local mean, its grads go
through ``allreduce_gradients_by_spec`` over the gradient-reduction axes
(data and context) and the loss is their ``pmean``. ``--sp-impl`` is
unused at ``--cp 1``. ``--cp`` and ``--dp`` default to 1 here (the
reference defaults to a 4 x 2 mesh). ``--device cpu`` runs the plain
versions of the kernels on the CPU; the default is the card.
``--output`` writes the reference's JSON record, with its keys.

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
import torch.distributed as dist

from apex_tpu_torch import amp
from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.bench import Bench, fixed_batch
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import collectives, mesh, multiproc
from apex_tpu_torch.parallel.distributed import (
    allreduce_gradients_by_spec,
    data_parallel_world,
    local_rows,
)


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
                    help="context-parallel attention (unused at --cp 1)")
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


def context_world(cp: int, dp: int = 1):
    """``(size, rank)`` of this process along the context axis: with
    ``torch.distributed`` initialized, the installed mesh's (the mesh of
    ``context_parallel_size=cp`` is installed first when there is none);
    else ``(1, 0)``. ``cp`` must equal the size: ``--cp`` without its
    processes raises, as ``--dp`` does."""
    if dist.is_available() and dist.is_initialized():
        if not mesh.model_parallel_is_initialized():
            mesh.initialize_model_parallel(context_parallel_size=cp)
        size = mesh.get_context_parallel_world_size()
        rank = mesh.get_context_parallel_rank()
    else:
        size, rank = 1, 0
    if int(cp) != size:
        n = int(cp) * int(dp)
        raise RuntimeError(
            f"--cp {cp} but the context axis has {size} rank(s): launch "
            f"{n} processes (torchrun --nproc_per_node {n}) and call "
            f"multiproc.initialize_distributed first")
    return size, rank


def build(*, seq: int = 4096, hidden: int = 256, layers: int = 4,
          heads: int = 8, vocab: int = 32768, batch: int = 1,
          lm_head_chunks: Optional[int] = None,
          window: Optional[int] = None, pos: str = "learned",
          cp: int = 1, dp: int = 1, sp_impl: str = "ring", seed: int = 0,
          device: DeviceLike = None, opt_level: str = "O2") -> Bench:
    """The reference's config and O2 state (``:83-111``) on one device (the
    card unless ``device="cpu"``), random weights from ``seed``;
    ``step(tokens, targets)`` takes the global batch (``batch`` rows of
    ``seq`` tokens, the targets already rolled on it): with ``cp`` = ``dp``
    = 1 the serial step (``:113-121``), the scaled loss's backward, then
    the O2 FusedAdam step, which skips the update and halves the scale on
    an overflow; else (the context and data axes of the launched world:
    :func:`context_world`, ``data_parallel_world``; anything else raises)
    this rank's rows and its ``seq / cp`` tokens of them, ring or Ulysses
    attention (``sp_impl``), the local mean loss, the grads through
    ``allreduce_gradients_by_spec`` and the loss ``pmean``-ed over the
    gradient-reduction axes (``:122-153``) before that step.
    ``opt_level`` replaces the reference's O2 (O0: fp32 params and
    compute)."""
    cp, crank = context_world(cp, dp)
    dp, rank = data_parallel_world(dp)
    if seq % cp:
        raise ValueError(f"--seq ({seq}) must divide by --cp ({cp})")
    dev = resolve_device(device)
    policy = amp.get_policy(opt_level)
    cfg = GPTConfig(
        vocab_size=vocab,
        hidden_size=hidden,
        num_layers=layers,
        num_attention_heads=heads,
        max_seq_len=seq,
        hidden_dropout=0.0,
        axis=None,
        context_axis=mesh.AXIS_CONTEXT if cp > 1 else None,
        sequence_parallel_impl=sp_impl,
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

    s_local = seq // cp

    def local(x: torch.Tensor) -> torch.Tensor:
        return local_rows(x, dp, rank)[:, crank * s_local:
                                       (crank + 1) * s_local]

    def step(tokens: torch.Tensor, targets: torch.Tensor):
        loss = model.loss(local(tokens), local(targets))
        mp_opt.scale_loss(loss, opt_state).backward()
        loss = loss.detach()
        if dp * cp > 1:
            params = list(model.parameters())
            grads = allreduce_gradients_by_spec(
                [p.grad for p in params], [()] * len(params))
            for p, g in zip(params, grads):
                p.grad = g
            loss = collectives.pmean(loss, mesh.get_gradient_reduction_axes())
        metrics = mp_opt.step(opt_state, model)
        return loss, metrics

    return Bench(step, model, mp_opt, opt_state, cfg, batch)


def main(argv=None) -> int:
    args = parse_args(argv)
    started = (args.dp * args.cp > 1 and not dist.is_initialized()
               and multiproc.initialize_distributed(device=args.device))
    try:
        return _main(args)
    finally:
        if started:
            multiproc.shutdown()


def _main(args) -> int:
    batch = args.batch or args.dp
    lead = not dist.is_initialized() or dist.get_rank() == 0
    trainer = build(seq=args.seq, hidden=args.hidden, layers=args.layers,
                    heads=args.heads, vocab=args.vocab, batch=batch,
                    lm_head_chunks=args.lm_head_chunks, window=args.window,
                    pos=args.pos, cp=args.cp, dp=args.dp,
                    sp_impl=args.sp_impl, device=args.device)
    tokens, targets = fixed_batch(trainer)
    on_card = tokens.device.type == "cuda"
    loss = None
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss, _ = trainer.step(tokens, targets)
        loss_val = float(loss)  # device->host fetch: the step's barrier
        if i == 0:
            t0 = time.perf_counter()  # exclude the warm-up step
        if lead:
            print(f"step {i}: loss {loss_val:.4f}", file=sys.stderr)
    steps_timed = max(args.steps - 1, 1)
    dt = (time.perf_counter() - t0) / steps_timed
    tok_s = batch * args.seq / dt
    mode = ("serial" if args.dp * args.cp == 1 else
            "data parallel" if args.cp == 1 else args.sp_impl)
    if lead:
        print(f"{tok_s:.0f} tokens/s at context {args.seq} "
              f"(cp={args.cp}, dp={args.dp}, {mode})")
    if args.output and lead:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with open(args.output, "w") as f:
            json.dump({
                "metric": "longcontext_train_tokens_per_sec",
                "platform": "gpu" if on_card else "cpu",
                "seq": args.seq, "cp": args.cp, "dp": args.dp,
                "mode": mode, "batch": batch,
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
