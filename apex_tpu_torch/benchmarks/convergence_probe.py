"""GPT-2 345M convergence probe: warm-up, a discriminating endpoint and a
CPU replay band (port of ``benchmarks/convergence_probe.py``).

    python -m apex_tpu_torch.benchmarks.convergence_probe        # the card
    python -m apex_tpu_torch.benchmarks.convergence_probe --device cpu \\
        --hidden 64 --layers 2 --heads 4 --vocab 256 --seq 32 --steps 4 \\
        --warmup 2 --cpu-check-steps 2

GPT-2 345M at amp O2 (bf16 compute, fp32 masters, dynamic loss scaling,
full remat, the 8-chunk LM head, FusedAdam) memorizes a corpus of 2 fixed
batches of ``batch x seq`` tokens, step ``i`` on batch ``i % 2``, with the
lr warmed up linearly, ``lr * min(1, (i + 1) / warmup)``, handed to the
inner optimizer each step (``apply_gradients(..., lr=)``). It passes when
the final loss is <= 6.0 (a random init sits near 10.8), and when a replay
of the first ``--cpu-check-steps`` steps on the CPU, in a subprocess
through the plain versions of the kernels, stays within ``--cpu-band`` of
the card's curve (the largest relative per-step difference,
``cpu_curve_max_rel_dev``). Both legs start from the same bits: the
weights are made on the CPU from seed 0 and then moved, and so is the
corpus (seed 1), as the reference seeds its ``PRNGKey(0)`` / ``(1)``.

The record keeps the reference's keys (``convergence_probe.py:134-147``);
``platform`` is the torch device type, and :data:`ADDED_KEYS` are new:
the card's name and power limit as nvidia-smi gives them, and the width
and depth. In ``cpu_check`` the card's curve is ``device_curve`` (the
reference's ``tpu_curve``) and ``seconds`` is the replay's wall time. A
replay that fails leaves its ``error`` there and makes ``ok`` false (the
reference keeps ``ok`` on the loss alone then). Exit code 0 when ``ok``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch import amp
from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.benchmarks.optimizer_step import card_line
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils.io import atomic_write_json

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

METRIC = "gpt2_345m_o2_convergence"
#: the final loss that passes (a random init sits near ln 50304 = 10.8)
LOSS_BAR = 6.0
#: the record's keys beyond the reference's
ADDED_KEYS = ("card", "hidden", "layers", "heads", "vocab")


def run_probe(steps: int, *, lr: float, warmup: int, batch: int, seq: int,
              hidden: int = 1024, layers: int = 24, heads: int = 16,
              vocab: int = 50304, device: DeviceLike = None,
              compute_dtype: torch.dtype = torch.bfloat16,
              params: Optional[Dict[str, Any]] = None, corpus=None
              ) -> Tuple[List[float], int, float]:
    """Train the O2 stack ``steps`` steps on the 2-batch corpus
    (``convergence_probe.py:50-97``); returns ``(losses, overflow_steps,
    final_loss_scale)``, each loss the unscaled mean loss before its
    step. ``params``: a JAX-layout tree to load in place of the seeded
    init; ``corpus``: ``(2, batch, seq)`` token ids in place of the seeded
    ones (the parity tests pass the JAX package's). The init comes from
    seed 0 on the CPU (moved to the card), the corpus from seed 1."""
    dev = resolve_device(device)
    cfg = GPTConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
                    num_attention_heads=heads, max_seq_len=seq,
                    hidden_dropout=0.0, axis=None,
                    compute_dtype=compute_dtype, remat=True,
                    lm_head_chunks=8)
    model = GPTModel(cfg, device="cpu", seed=0)
    if params is not None:
        model.params_from_numpy(params)
    if dev.type != "cpu":  # the CPU's init bits, moved
        host = model
        model = GPTModel(cfg, device=dev)
        model.load_state_dict(host.state_dict())
        del host
    policy = amp.get_policy("O2")
    amp.cast_params(model, policy)
    mp_opt = amp.MixedPrecisionOptimizer(FusedAdam(lr=lr), policy)
    state = mp_opt.init(model)
    if corpus is None:
        gen = torch.Generator().manual_seed(1)
        corpus = torch.randint(0, vocab, (2, batch, seq), generator=gen)
    if not isinstance(corpus, torch.Tensor):
        corpus = torch.from_numpy(np.array(corpus))
    corpus = corpus.long().to(dev)
    losses: List[float] = []
    overflows = 0
    for i in range(steps):
        tokens = corpus[i % 2]
        targets = torch.roll(tokens, -1, dims=-1)
        lr_t = lr * min(1.0, (i + 1) / max(warmup, 1))
        loss = model.loss(tokens, targets)
        mp_opt.scale_loss(loss, state).backward()
        metrics = mp_opt.step(state, model, lr=lr_t)
        losses.append(float(loss.detach()))
        overflows += int(metrics["found_inf"])
        if i % 50 == 0:
            print(f"step {i}: loss {losses[-1]:.4f} scale "
                  f"{metrics['loss_scale']:.0f}", file=sys.stderr)
    return losses, overflows, float(state.scaler.loss_scale)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--cpu-check-steps", type=int, default=6,
                    help="first-K-step CPU replay; 0 disables")
    ap.add_argument("--cpu-band", type=float, default=0.05,
                    help="accepted max relative per-step loss deviation")
    ap.add_argument("--emit-curve", type=int, default=0,
                    help="internal: run N steps, print the loss list, exit"
                         " (the CPU replay's entry)")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=50304)
    return ap.parse_args(argv)


def _model_args(args) -> List[str]:
    return ["--lr", repr(args.lr), "--warmup", str(args.warmup),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--hidden", str(args.hidden), "--layers", str(args.layers),
            "--heads", str(args.heads), "--vocab", str(args.vocab)]


def cpu_replay(args, device_curve: List[float]) -> Dict[str, Any]:
    """The first ``--cpu-check-steps`` steps again in a subprocess on the
    CPU (``--emit-curve K --device cpu``), held against ``device_curve``:
    the ``cpu_check`` entry of the record. A failure raises."""
    k = args.cpu_check_steps
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "apex_tpu_torch.benchmarks.convergence_probe",
           "--emit-curve", str(k), "--device", "cpu", *_model_args(args)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=3600, cwd=ROOT)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise RuntimeError(f"the CPU replay exited {out.returncode}: "
                           f"{out.stderr.strip()[-300:]}")
    cpu_curve = json.loads(out.stdout.strip().splitlines()[-1])
    if len(cpu_curve) != k:
        raise RuntimeError(f"the CPU replay gave {len(cpu_curve)} losses, "
                           f"not {k}")
    dev = max(abs(a - b) / max(abs(b), 1e-6)
              for a, b in zip(device_curve[:k], cpu_curve))
    return {"steps": k,
            "device_curve": [round(x, 4) for x in device_curve[:k]],
            "cpu_curve": [round(x, 4) for x in cpu_curve],
            "cpu_curve_max_rel_dev": round(dev, 5), "band": args.cpu_band,
            "ok": bool(dev <= args.cpu_band), "seconds": round(seconds, 1)}


def probe_record(args) -> Dict[str, Any]:
    """Run the probe and its CPU replay; the record
    (``convergence_probe.py:131-165``)."""
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    losses, overflows, final_scale = run_probe(
        args.steps, lr=args.lr, warmup=args.warmup, batch=args.batch,
        seq=args.seq, hidden=args.hidden, layers=args.layers,
        heads=args.heads, vocab=args.vocab, device=dev)
    wall = time.perf_counter() - t0
    after = losses[args.warmup:]
    record = {
        "metric": METRIC, "platform": dev.type,
        "steps": args.steps, "lr": args.lr, "warmup_steps": args.warmup,
        "batch": args.batch, "seq": args.seq,
        "loss_first": round(losses[0], 4),
        "loss_final": round(losses[-1], 4),
        "loss_max_after_warmup": round(max(after), 4) if after else None,
        "overflow_steps": overflows,
        "final_loss_scale": final_scale,
        "wall_seconds": round(wall, 1),
        "curve_every_10": [round(x, 4) for x in losses[::10]],
        "ok": bool(losses[-1] <= LOSS_BAR),
        "card": card_line() if dev.type == "cuda" else None,
        "hidden": args.hidden, "layers": args.layers, "heads": args.heads,
        "vocab": args.vocab,
    }
    if args.cpu_check_steps:
        try:
            record["cpu_check"] = cpu_replay(args, losses)
            record["ok"] = record["ok"] and record["cpu_check"]["ok"]
        except Exception as e:  # noqa: BLE001 - kept in the record
            record["cpu_check"] = {"error": str(e)[:300]}
            record["ok"] = False
    return record


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.emit_curve:
        losses, _, _ = run_probe(
            args.emit_curve, lr=args.lr, warmup=args.warmup,
            batch=args.batch, seq=args.seq, hidden=args.hidden,
            layers=args.layers, heads=args.heads, vocab=args.vocab,
            device=args.device)
        print(json.dumps(losses))
        return 0
    record = probe_record(args)
    print(json.dumps(record))
    if args.output:
        # temp file + rename: a crash mid-write leaves no torn record
        atomic_write_json(args.output, record)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
