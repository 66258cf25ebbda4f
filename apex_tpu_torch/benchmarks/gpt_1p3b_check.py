"""GPT-3-1.3B-width functional check under TP x PP interleaved, loss-matched
against the serial model (port of ``benchmarks/gpt_1p3b_check.py``;
BASELINE.md target #5).

The reference frames the target as "GPT-3 1.3B, TP=8 x PP=4 interleaved:
runs, loss-match vs no-pipelining" and runs the REAL WIDTH (h = 2048, 32
heads, vocab 50304: the dimension that stresses the sharded GEMMs) at
reduced depth and sequence (8 layers, seq 256): tp 2 x pp 4 with
interleaved vpp 2, one fp32 loss of the pipelined model against the serial
model on the same batch and the same weights (random, from a seed: a
stage model holds the serial model's layers, cut). Every parallel
mechanism runs at production width: the column/row-parallel GEMMs, the
vocab-parallel embedding and cross entropy, the pipeline ring with
virtual chunks and the pipe-sharded head.

This process computes the serial loss, then spawns ``tp x pp`` gloo ranks
(``torch.distributed``, gloo over ``tcp://127.0.0.1``), each building its
stage and computing the pipelined loss on the same device kind; on the
card gloo carries CUDA tensors through host copies, so the ranks' times
are not speed numbers. Prints one JSON line; exits 1 when the relative
error is 1e-4 or more.

    python -m apex_tpu_torch.benchmarks.gpt_1p3b_check        # the card
    python -m apex_tpu_torch.benchmarks.gpt_1p3b_check --device cpu \\
        --hidden 64 --heads 4 --vocab 128 --seq 32   # a small CPU run
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import pickle
import socket
import sys
import tempfile
import time
import traceback


def _config(args, tp: bool, pp: bool):
    import torch

    from apex_tpu_torch.models import GPTConfig

    return GPTConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        num_layers=args.layers, num_attention_heads=args.heads,
        max_seq_len=args.seq, hidden_dropout=0.0,
        axis="model" if tp else None,
        pipeline_axis="pipe" if pp else None,
        virtual_pipeline_size=args.vpp if pp else 1,
        compute_dtype=torch.float32, remat=True)


def _batch(args, device):
    import torch

    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, args.vocab, (args.micro, args.seq),
                         generator=gen)
    return toks.to(device), torch.roll(toks, -1, dims=-1).to(device)


def _rank(rank, world, port, args, out_path):
    res = {"rank": rank}
    try:
        import torch

        from apex_tpu_torch.models import GPTModel
        from apex_tpu_torch.parallel import mesh, multiproc
        from apex_tpu_torch.transformer.pipeline_parallel import (
            prepare_pipelined_model,
        )

        multiproc.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                         backend="gloo", device="cpu",
                                         timeout_s=1200)
        device = torch.device(args.device)
        mesh.initialize_model_parallel(
            tensor_model_parallel_size=args.tp,
            pipeline_model_parallel_size=args.pp,
            virtual_pipeline_model_parallel_size=(
                args.vpp if args.vpp > 1 else None))
        model = GPTModel(_config(args, args.tp > 1, True), device=device,
                         seed=0)
        _, layers, pipe_loss = prepare_pipelined_model(
            model, num_microbatches=args.micro)
        toks, tgts = _batch(args, device)
        t0 = time.perf_counter()
        with torch.no_grad():
            loss = pipe_loss(layers, toks, tgts)
        res["loss"] = float(loss)
        res["s"] = time.perf_counter() - t0
    except Exception:  # noqa: BLE001 - reported by the parent
        res["error"] = traceback.format_exc()
    finally:
        try:
            from apex_tpu_torch.parallel import multiproc

            multiproc.shutdown()
        except Exception as e:  # noqa: BLE001
            res.setdefault("error", f"shutdown: {e}")
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(args) -> dict:
    """The check: ``{"serial_loss", "pipelined_loss", "rel_err", "ok",
    ...}``."""
    import torch

    from apex_tpu_torch._device import resolve_device
    from apex_tpu_torch.models import GPTModel

    device = resolve_device(args.device)
    args.device = str(device)
    serial = GPTModel(_config(args, False, False), device=device, seed=0)
    toks, tgts = _batch(args, device)
    t0 = time.perf_counter()
    with torch.no_grad():
        serial_loss = float(serial.loss(toks, tgts))
    t_serial = time.perf_counter() - t0
    del serial
    if device.type == "cuda":
        torch.cuda.empty_cache()
    world = args.tp * args.pp
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank,
                             args=(r, world, port, args, outs[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        end = time.monotonic() + args.timeout
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        if hung:
            raise RuntimeError(f"ranks {hung} still running after "
                               f"{args.timeout} s; killed")
        ranks = []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} left no result")
            with open(path, "rb") as f:
                ranks.append(pickle.load(f))
    for r in ranks:
        if "error" in r:
            raise RuntimeError(f"rank {r['rank']}: {r['error']}")
    losses = [r["loss"] for r in ranks]
    piped = losses[0]
    rel = abs(piped - serial_loss) / max(abs(serial_loss), 1e-9)
    return {
        "metric": f"gpt_h{args.hidden}_L{args.layers}_tp{args.tp}"
                  f"_pp{args.pp}_vpp{args.vpp}_loss_match",
        "hidden": args.hidden, "heads": args.heads, "layers": args.layers,
        "seq": args.seq, "vocab": args.vocab, "tp": args.tp, "pp": args.pp,
        "vpp": args.vpp, "microbatches": args.micro, "ranks": world,
        "device": args.device, "backend": "gloo",
        "serial_loss": serial_loss, "pipelined_loss": piped,
        "rank_losses": losses, "rel_err": rel,
        "ranks_agree": len(set(losses)) == 1,
        "serial_s": t_serial, "pipelined_s": max(r["s"] for r in ranks),
        "ok": bool(rel < 1e-4 and len(set(losses)) == 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hidden", type=int, default=2048)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--layers", type=int, default=8,
                    help="must divide pp*vpp; the reference's cut from 24")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=50304)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--pp", type=int, default=4)
    ap.add_argument("--vpp", type=int, default=2)
    ap.add_argument("--micro", type=int, default=4,
                    help="micro-batches of one row (the interleaved "
                         "schedule needs a multiple of pp)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    record = run(args)
    print(json.dumps(record))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(record, f)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
