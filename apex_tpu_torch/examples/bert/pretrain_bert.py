"""BERT pretraining with FusedLAMB + the fused LayerNorm on one card: the
serial mode of ``examples/bert/pretrain_bert.py`` (BASELINE.md config 3).

    python -m apex_tpu_torch.examples.bert.pretrain_bert --steps 10
    python -m apex_tpu_torch.examples.bert.pretrain_bert --hidden 1024 \\
        --layers 24 --heads 16 --seq 512 --batch 16 --steps 11  # BERT-large

The moving parts are the reference's: ``BertConfig(hidden, layers, heads,
max_seq_len=seq, hidden_dropout=0, axis=None, remat=True)`` (vocab 30592,
2 token types, the binary head), bf16 compute unless ``--opt-level O0``,
``amp.get_policy(opt_level)`` + ``cast_params`` +
``MixedPrecisionOptimizer(FusedLAMB(lr, weight_decay=0.01))`` with the
dynamic loss scale, and the MLM + NSP loss on the reference's
``synthetic_batch`` (all-ones attention mask, 15% of positions masked, NSP
labels), a fresh batch a step from ``np.random.default_rng(0)``. The
padding bias reaches every layer's attention, which runs the resident flash
kernels with the bias on the card.

ZeRO (``--zero``, ``--zero-level``, ``--reduce-dtype``) for BERT is ROADMAP
Queue 1 item 24, the two-tier mesh (``--mesh-islands`` > 1) item 16, and the
journal, ledger, trace and flight recorder (``--journal``, ``--ledger``,
``--trace``, ``--flight``) item 21: each raises. ``--dcn-wire`` is accepted
and unused, as in the reference without islands. ``--device cpu`` runs the
plain versions of the kernels on the CPU; the default is the card.

:func:`build` returns an ``apex_tpu_torch.bench.Bench`` whose ``step``
takes :func:`synthetic_batch`'s six tensors, so ``bench.train_steps(...,
batch=...)`` drives it as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from apex_tpu_torch import amp
from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.bench import Bench
from apex_tpu_torch.models import BertConfig, BertModel
from apex_tpu_torch.optimizers import FusedLAMB

#: flags of the reference that later slices bring, with their ROADMAP items
_LATER = {
    "zero": "BERT under ZeRO (ROADMAP Queue 1 item 24)",
    "zero_level": "BERT under ZeRO (ROADMAP Queue 1 item 24)",
    "reduce_dtype": "BERT's quantized ZeRO wire (ROADMAP Queue 1 item 24)",
    "mesh_islands": "the two-tier mesh (ROADMAP Queue 1 item 16)",
    "journal": "the metrics journal (ROADMAP Queue 1 item 21)",
    "ledger": "the run ledger (ROADMAP Queue 1 item 21)",
    "trace": "the span tracer (ROADMAP Queue 1 item 21)",
    "flight": "the flight recorder (ROADMAP Queue 1 item 21)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--opt-level", default="O2")
    p.add_argument("--zero", action="store_true")
    p.add_argument("--zero-level", type=int, default=None, choices=(1, 2, 3))
    p.add_argument("--reduce-dtype", default=None, choices=["int8", "e5m2"])
    p.add_argument("--mesh-islands", type=int, default=1, metavar="N")
    p.add_argument("--dcn-wire", default="int8",
                   choices=["int8", "e5m2", "none"])
    p.add_argument("--journal", default=None, metavar="PATH")
    p.add_argument("--ledger", nargs="?", const="out/ledger.jsonl",
                   default=None, metavar="PATH")
    p.add_argument("--trace", default=None, metavar="PATH")
    p.add_argument("--flight", nargs="?", const="auto", default=None,
                   metavar="PATH")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def _check_serial(args) -> None:
    for name, where in _LATER.items():
        val = getattr(args, name)
        if val and not (name == "mesh_islands" and val == 1):
            flag = "--" + name.replace("_", "-")
            raise NotImplementedError(
                f"{flag}: {where} is a later slice of the port; this "
                f"example runs the serial mode")


def synthetic_batch(rng: np.random.Generator, batch: int, seq: int,
                    vocab: int, device: torch.device):
    """The reference's synthetic batch (``pretrain_bert.py:118-125``), on
    ``device``: tokens, the all-ones attention mask, the 15% loss mask,
    the MLM labels, the NSP labels and zero token types."""
    toks = rng.integers(0, vocab, (batch, seq))
    attn = np.ones((batch, seq), np.int32)
    lmask = (rng.random((batch, seq)) < 0.15).astype(np.int32)
    labels = rng.integers(0, vocab, (batch, seq))
    nsp = rng.integers(0, 2, (batch,))
    types = np.zeros((batch, seq), np.int64)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (toks, attn, lmask, labels, nsp, types))


def build(*, hidden: int = 256, layers: int = 4, heads: int = 8,
          seq: int = 128, batch: int = 16, lr: float = 2e-3,
          opt_level: str = "O2", seed: int = 0,
          device: DeviceLike = None) -> Bench:
    """The reference's serial config and state (``:144-150``, ``:241-246``)
    on one device (the card unless ``device="cpu"``), random weights from
    ``seed``; ``step(toks, attn, lmask, labels, nsp, types)`` is its serial
    step (``:248-256``): the scaled loss's backward, then the FusedLAMB step
    under the policy, which skips the update and halves the scale on an
    overflow. Returns the unscaled loss (detached) and the metrics."""
    dev = resolve_device(device)
    policy = amp.get_policy(opt_level)
    cfg = BertConfig(
        hidden_size=hidden, num_layers=layers, num_attention_heads=heads,
        max_seq_len=seq, hidden_dropout=0.0, axis=None,
        compute_dtype=(torch.bfloat16 if opt_level != "O0"
                       else torch.float32),
        remat=True)
    model = BertModel(cfg, device=dev, seed=seed)
    amp.cast_params(model, policy)
    mp_opt = amp.MixedPrecisionOptimizer(
        FusedLAMB(lr=lr, weight_decay=0.01), policy)
    opt_state = mp_opt.init(model)

    def step(toks, attn, lmask, labels, nsp, types):
        loss = model.loss(toks, attn, lmask, labels, nsp, types)
        mp_opt.scale_loss(loss, opt_state).backward()
        metrics = mp_opt.step(opt_state, model)
        return loss.detach(), metrics

    return Bench(step, model, mp_opt, opt_state, cfg, batch)


def main(argv=None) -> int:
    args = parse_args(argv)
    _check_serial(args)
    if args.steps < 2:
        raise SystemExit("--steps must be >= 2 (step 0 is the warm-up)")
    trainer = build(hidden=args.hidden, layers=args.layers, heads=args.heads,
                    seq=args.seq, batch=args.batch, lr=args.lr,
                    opt_level=args.opt_level, device=args.device)
    dev = trainer.model.device
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = synthetic_batch(rng, args.batch, args.seq,
                                trainer.cfg.vocab_size, dev)
        loss, metrics = trainer.step(*batch)
        if i == 0:
            float(loss)  # the warm-up step's barrier
            t0 = time.perf_counter()
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} mlm+nsp loss {float(loss):.4f} "
                  f"scale {float(metrics['loss_scale']):.0f}")
    float(loss)
    dt = (time.perf_counter() - t0) / (args.steps - 1)
    print(f"{args.batch * args.seq / dt:.0f} tokens/s "
          f"({args.opt_level}, FusedLAMB, {dt * 1e3:.1f} ms/step, "
          f"{'card' if dev.type == 'cuda' else 'cpu'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
