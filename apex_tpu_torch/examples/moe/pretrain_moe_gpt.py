"""MoE GPT pretraining with expert parallelism over the data axis (port of
``examples/moe/pretrain_moe_gpt.py``).

    python -m apex_tpu_torch.examples.moe.pretrain_moe_gpt --experts 8 \\
        --ep 1 --steps 10          # serial: every expert on this card
    torchrun --nproc_per_node N -m apex_tpu_torch.examples.moe.\\
        pretrain_moe_gpt --experts 8 --steps 10   # EP over the N ranks

A GPT whose FFNs are top-k routed expert layers
(``apex_tpu_torch.transformer.moe.MoEMLP``), O2 mixed precision with
FusedAdam, the Switch load-balancing and router z losses folded into the
loss, trained on one fixed batch of ``--batch`` rows from
``np.random.default_rng(0)`` with next-token targets (the reference's
recipe). ``--ep 1`` runs serial; otherwise (``--ep 0``: every rank; or
``--ep N`` equal to the world size) the experts shard over the data axis:
each rank takes its ``batch / N`` rows, the dispatch and combine are
all-to-alls, the loss is the local mean, and the grads are reduced by
their specs (``allreduce_gradients_by_spec``: replicated grads averaged,
the expert grads only divided by N; ``:112-121``). ``--device cpu`` runs
the plain versions on the CPU (gloo between ranks).
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import amp
from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.amp.frontend import _specs_of
from apex_tpu_torch.bench import Bench
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import collectives, mesh, multiproc
from apex_tpu_torch.parallel.distributed import (
    allreduce_gradients_by_spec,
    local_rows,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--top-k", type=int, default=2)
    p.add_argument("--capacity-factor", type=float, default=1.25)
    p.add_argument("--ep", type=int, default=0,
                   help="expert-parallel size (0 = every rank; 1 = serial)")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--vocab", type=int, default=2048)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def fixed_batch(vocab: int, batch: int, seq: int):
    """The reference's one batch: ``rng(0)`` tokens, ``roll(-1)``
    targets."""
    toks = np.random.default_rng(0).integers(0, vocab, (batch, seq))
    return (torch.from_numpy(toks),
            torch.from_numpy(np.roll(toks, -1, axis=-1)))


def build(*, experts: int = 8, top_k: int = 2, capacity_factor: float = 1.25,
          ep: int = 0, hidden: int = 256, layers: int = 4, heads: int = 8,
          vocab: int = 2048, seq: int = 256, batch: int = 8,
          lr: float = 3e-4, seed: int = 0,
          device: DeviceLike = None) -> Bench:
    """The reference's model and O2 optimizer on one device, random weights
    from ``seed``. ``ep`` 1 is serial; otherwise the experts shard over the
    data axis of every rank (``ep`` 0, or the world size; a pure
    data-parallel topology is installed when none is).
    ``step(tokens, targets)`` takes the whole batch."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    size = world if ep == 0 else ep
    if size not in (1, world):
        raise RuntimeError(
            f"--ep {ep} but the world has {world} rank(s): expert "
            f"parallelism spans every rank (launch {ep} processes), or run "
            f"serial with --ep 1")
    serial = size == 1
    if not serial and not mesh.model_parallel_is_initialized():
        mesh.initialize_model_parallel()
    cfg = GPTConfig(
        vocab_size=vocab, hidden_size=hidden, num_layers=layers,
        num_attention_heads=heads, max_seq_len=seq, hidden_dropout=0.0,
        compute_dtype=torch.bfloat16, remat=True,
        moe_num_experts=experts, moe_top_k=top_k,
        moe_capacity_factor=capacity_factor,
        moe_expert_axis=None if serial else mesh.AXIS_DATA)
    model = GPTModel(cfg, device=dev, seed=seed)
    policy = amp.get_policy("O2")
    amp.cast_params(model, policy)
    mp_opt = amp.MixedPrecisionOptimizer(FusedAdam(lr=lr), policy)
    opt_state = mp_opt.init(model)
    rank = 0 if serial else collectives.axis_rank(mesh.AXIS_DATA)
    params = list(model.parameters())
    leaf_specs = _specs_of(model, len(params))

    def step(tokens: torch.Tensor, targets: torch.Tensor):
        toks = local_rows(tokens, size, rank).to(dev)
        tgts = local_rows(targets, size, rank).to(dev)
        loss = model.loss(toks, tgts)
        mp_opt.scale_loss(loss, opt_state).backward()
        loss = loss.detach()
        if not serial:
            # local-mean loss, spec-aware reduction (:112-121)
            grads = allreduce_gradients_by_spec(
                [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params], leaf_specs,
                data_axes=(mesh.AXIS_DATA,))
            for p, g in zip(params, grads):
                p.grad = g
            loss = collectives.pmean(loss, mesh.AXIS_DATA)
        return loss, mp_opt.step(opt_state, model)

    return Bench(step, model, mp_opt, opt_state, cfg, batch)


def run(argv=None) -> Dict[str, Any]:
    """:func:`main`'s run: the trainer (``bench``), each step's loss and
    metrics and the seconds of the loop."""
    args = parse_args(argv)
    started = (args.ep != 1 and not dist.is_initialized()
               and multiproc.initialize_distributed(device=args.device))
    try:
        return _run(args)
    finally:
        if started:
            multiproc.shutdown()


def _run(args) -> Dict[str, Any]:
    bench = build(experts=args.experts, top_k=args.top_k,
                  capacity_factor=args.capacity_factor, ep=args.ep,
                  hidden=args.hidden, layers=args.layers, heads=args.heads,
                  vocab=args.vocab, seq=args.seq, batch=args.batch,
                  lr=args.lr, device=args.device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    toks, tgts = fixed_batch(args.vocab, args.batch, args.seq)
    out: Dict[str, Any] = {"bench": bench, "losses": [], "metrics": []}
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss, metrics = bench.step(toks, tgts)
        out["losses"].append(float(loss))
        out["metrics"].append(metrics)
        if lead and (i % max(1, args.steps // 5) == 0
                     or i == args.steps - 1):
            print(f"step {i:3d} loss {float(loss):.4f} "
                  f"scale {float(metrics['loss_scale']):.0f}")
    out["seconds"] = time.perf_counter() - t0
    ep = bench.cfg.moe_expert_axis
    mode = ("serial" if ep is None
            else f"expert-parallel x{collectives.axis_size(ep)}")
    if lead:
        print(f"{args.steps} steps in {out['seconds']:.1f}s ({mode}, "
              f"{args.experts} experts, top-{args.top_k})")
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
