"""GPT serving: prompts -> tokens through the paged-KV engine, from a
training checkpoint or random weights (``examples/gpt/generate_gpt.py``).

    python -m apex_tpu_torch.examples.gpt.generate_gpt --hidden 1024 \\
        --layers 24 --heads 16 --max-seq 1024 --max-batch 8 --load-dir D
    ... --prefix-cache --shared-prefix 500 --spec-k 4
    ... --prefill-chunk 256
    ... --pos rope --window 256          # rotary positions, sliding window
    torchrun --nproc_per_node 2 -m apex_tpu_torch.examples.gpt.generate_gpt \\
        ... --tp 2                        # tensor parallel over 2 ranks

As the reference (``:157-255``): an fp32 GPT without remat
(``compute_dtype=float32``, ``--window``, ``--pos``), random weights from
``--seed`` or ``{"params": ...}`` restored from ``--load-dir``
(``apex_tpu_torch.checkpoint``, either package's; an O2 checkpoint's bf16
arrays go into the fp32 params exactly), an
``apex_tpu_torch.serve.Engine`` (``--max-batch``, ``--block-size``,
``--temperature``, ``--top-k``, ``--prefix-cache``, ``--prefill-chunk``,
``--spec-k`` with a self-draft or a ``--draft-layers`` draft from seed + 1),
the reference's synthetic prompts (or ``--prompt-file``) cut to
``max_seq - max_new_tokens``, and its per-request lines. Greedy tokens
equal the JAX example's on the same checkpoint; sampled ones come from
torch generators, not JAX keys.

``--tp N`` (``:157-170``) runs under a launcher: the mesh of
``initialize_model_parallel(tensor_model_parallel_size=N)`` (one process,
or a world that does not divide by N, raises naming the world size), the
model and any draft on the model axis, the checkpoint's full tree cut to
this rank's shard, and an engine over the mesh whose ranks run in
lockstep; rank 0 prints. The monitoring options (ROADMAP Queue 1 item 21)
raise ``NotImplementedError``. ``--device cpu`` runs the plain versions of
the kernels on the CPU; the default is the card. :func:`run` is
:func:`main` returning the engine, the model and the results.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import checkpoint
from apex_tpu_torch._params import load_tree_, module_tree
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.parallel import mesh as mesh_lib
from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.serve import Engine, Request, ServeConfig

#: the reference's monitoring options (ROADMAP Queue 1 item 21)
_MONITOR = ("journal", "trace", "flight", "slo_ttft_ms", "slo_itl_ms",
            "ledger")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--vocab", type=int, default=50304)
    p.add_argument("--max-seq", type=int, default=256)
    p.add_argument("--window", type=int, default=None)
    p.add_argument("--pos", default="learned",
                   choices=["learned", "rope", "none"])
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--prefix-cache", action="store_true")
    p.add_argument("--prefill-chunk", type=int, default=None, metavar="N")
    p.add_argument("--spec-k", type=int, default=0, metavar="K")
    p.add_argument("--draft-layers", type=int, default=None, metavar="L")
    p.add_argument("--shared-prefix", type=int, default=0, metavar="N")
    p.add_argument("--prompt-file", default=None)
    p.add_argument("--load-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--journal", default=None, metavar="PATH")
    p.add_argument("--trace", default=None, metavar="PATH")
    p.add_argument("--flight", nargs="?", const="auto", default=None,
                   metavar="PATH")
    p.add_argument("--slo-ttft-ms", type=float, default=None)
    p.add_argument("--slo-itl-ms", type=float, default=None)
    p.add_argument("--trace-sample-n", type=int, default=16, metavar="N")
    p.add_argument("--ledger", nargs="?", const="out/ledger.jsonl",
                   default=None, metavar="PATH")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    args.ledger = args.ledger or os.environ.get("APEX_TPU_LEDGER")
    for name in _MONITOR:
        if getattr(args, name):
            raise NotImplementedError(
                f"--{name.replace('_', '-')}: the monitoring hooks are not "
                f"in this slice of the port; they come with ROADMAP Queue 1 "
                f"item 21")
    return args


def load_prompts(args) -> List[List[int]]:
    """The reference's prompts (``:142-154``): the prompt file's lines, or
    six synthetic prompts from ``--seed`` behind a shared prefix."""
    if args.prompt_file:
        prompts = []
        with open(args.prompt_file) as f:
            for line in f:
                toks = [int(t) % args.vocab for t in line.split()]
                if toks:
                    prompts.append(toks)
        return prompts
    rng = np.random.default_rng(args.seed)
    shared = list(rng.integers(0, args.vocab, args.shared_prefix))
    return [shared + list(rng.integers(0, args.vocab, n))
            for n in (5, 12, 3, 9, 17, 7)]


def build(args):
    """``(engine, model)``: the fp32 model (restored from ``--load-dir``
    when given) and its engine, with the draft model of ``--spec-k
    --draft-layers``; with ``--tp`` > 1 on the dp x tp mesh it installs."""
    mesh = None
    if args.tp > 1:
        mesh = mesh_lib.initialize_model_parallel(
            tensor_model_parallel_size=args.tp)
    cfg = GPTConfig(
        vocab_size=args.vocab,
        hidden_size=args.hidden,
        num_layers=args.layers,
        num_attention_heads=args.heads,
        max_seq_len=args.max_seq,
        hidden_dropout=0.0,
        compute_dtype=torch.float32,
        remat=False,
        attention_window=args.window,
        position_embedding=args.pos,
        axis=mesh_lib.AXIS_MODEL if mesh is not None else None,
    )
    model = GPTModel(cfg, device=args.device, seed=args.seed)
    if args.load_dir:
        specs = {"params": model.specs()} if mesh is not None else None
        restored = checkpoint.restore_checkpoint(
            args.load_dir, {"params": module_tree(model, device="meta")},
            specs=specs)
        load_tree_(model, restored["params"])
        print(f"restored params from {args.load_dir}")
    draft = None
    if args.spec_k and args.draft_layers:
        draft = GPTModel(dataclasses.replace(cfg,
                                             num_layers=args.draft_layers),
                         device=model.device, seed=args.seed + 1)
    engine = Engine(model, ServeConfig(
        max_batch=args.max_batch, max_seq=args.max_seq,
        block_size=args.block_size, temperature=args.temperature,
        top_k=args.top_k, seed=args.seed, prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk, spec_k=args.spec_k),
        device=model.device, draft_model=draft, mesh=mesh)
    return engine, model


def requests(args) -> List[Request]:
    budget = args.max_seq - args.max_new_tokens
    return [Request(prompt=pr[:max(budget, 1)],
                    max_new_tokens=args.max_new_tokens, request_id=i)
            for i, pr in enumerate(load_prompts(args))]


def run(argv=None) -> Dict[str, Any]:
    """:func:`main`'s run; returns ``engine``, ``model``, the ``requests``,
    the ``results`` (``{request_id: Request}``) and the serve's ``wall_s``
    (host clock around ``engine.run``)."""
    args = parse_args(argv)
    started = (args.tp > 1 and not dist.is_initialized()
               and multiproc.initialize_distributed(device=args.device))
    try:
        return _run(args)
    finally:
        if started:
            multiproc.shutdown()
        elif args.tp > 1:
            mesh_lib.destroy_model_parallel()


def _run(args) -> Dict[str, Any]:
    engine, model = build(args)
    reqs = requests(args)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    wall = time.perf_counter() - t0
    if not dist.is_initialized() or dist.get_rank() == 0:
        report(args, engine, results)
    engine.drop_prefix_cache()
    return {"engine": engine, "model": model, "requests": reqs,
            "results": results, "wall_s": wall}


def report(args, engine, results) -> None:
    """The reference's per-request and summary lines."""
    for rid in sorted(results):
        r = results[rid]
        itl_ms = (1e3 * float(np.median(r.itl_s)) if r.itl_s else None)
        cached = f" | cached {r.cached_tokens} tok" if r.cached_tokens else ""
        print(f"request {rid}: prompt {len(r.prompt)} tok -> "
              f"{len(r.tokens)} new | ttft {1e3 * r.ttft_s:.1f} ms | "
              f"itl p50 {itl_ms and round(itl_ms, 2)} ms{cached}")
        print(f"  tokens: {r.tokens}")
    print(f"{len(results)} request(s) in {engine.ticks} decode tick(s) | "
          f"mesh tp={args.tp} | pool "
          f"{engine.allocator.num_blocks - 1} x {args.block_size} tokens")
    if args.prefix_cache or args.spec_k:
        print("serving stats: " + ", ".join(
            f"{k}={v}" for k, v in engine.stats.items()))


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
