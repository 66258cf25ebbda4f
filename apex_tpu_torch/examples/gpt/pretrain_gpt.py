"""GPT pretraining with checkpoint and resume: the serial, data-,
tensor- and pipeline-parallel branches of ``examples/gpt/pretrain_gpt.py``.

    python -m apex_tpu_torch.examples.gpt.pretrain_gpt --hidden 1024 \\
        --layers 24 --heads 16 --seq 1024 --micro-batch 4 \\
        --num-microbatches 2 --steps 11 --save-dir D
    # the same command again resumes from the latest step under D
    torchrun --nproc_per_node N -m apex_tpu_torch.examples.gpt.pretrain_gpt \\
        ...   # data parallel over N ranks (NCCL; gloo with --device cpu)
    torchrun --nproc_per_node N -m ... --tp T   # a dp (N / T) x tp T mesh
    torchrun --nproc_per_node N -m ... --pp P --pp-schedule interleaved

The moving parts are the reference's (``:391-510``): ``GPTConfig(
hidden_dropout=0, remat=True, bf16 compute under O1-O3, else fp32)``,
``amp.get_policy(--opt-level)`` + ``cast_params`` +
``MixedPrecisionOptimizer(FusedAdam(lr=--lr))`` with its loss scaler, a
batch of ``micro_batch x num_microbatches`` rows, and the loss of
``pipelined_loss_fn`` at one stage: the mean over the batch, its grads
summed over the micro-batches (each micro-batch's scaled loss over M runs
its own backward). Batches are the reference's: synthetic tokens from
``np.random.default_rng(0)`` with next-token targets (``roll(-1)``), or
``--data DIR`` through :class:`apex_tpu_torch.csrc.TokenLoader` with rows
of ``seq + 1`` tokens ``% vocab``.

Data parallelism (``:375``, ``:464``, ``:505-514``): under a launcher
(:func:`apex_tpu_torch.parallel.multiproc.initialize_distributed`) ``dp``
is the world size, the global batch is ``micro_batch x dp x
num_microbatches`` rows of which rank r takes ``[r B / dp, (r + 1) B /
dp)``, the local micro-batched backward runs as in the serial branch, and
then the non-layer grads go through ``allreduce_gradients_by_spec`` and the
layers' through ``allreduce_gradients`` over the gradient-reduction axes
(``data``, ``context``), and the loss is the ``pmean`` of the local means.
The parameters start equal on every rank (the same seed). Checkpoints are
written by rank 0 and read by all; rank 0 prints.

Tensor parallelism (``--tp T``, ``:369-440``): the mesh of
``initialize_model_parallel(tensor_model_parallel_size=T)`` (data-parallel
size world / T; a world that does not divide raises), a GPT on the model
axis holding this rank's shard (the full init from the seed, cut), the TP
ranks of a data shard taking the same rows, the grads reduced over the
data axis by each leaf's spec (``allreduce_gradients_by_spec`` with the
model's specs), and the overflow vote over the model axis, so every rank
skips or steps together. A checkpoint holds the full tree: its model-
sharded leaves are gathered over the model axis at a save (every rank
calls it) and cut to this rank's shard at a restore, so a run resumes at
another ``--tp``. The run resumes from
``latest_step(--save-dir)``, saves every ``--save-every`` steps
(``apex_tpu_torch.checkpoint``, the JAX package's npz layout: a checkpoint
of either package resumes in the other) and prints the reference's lines.
As in the reference, a resumed run's data stream starts again at its
first batch: the generator and the loader are built anew at every start.

ZeRO (``--zero``, ``--zero-level 1|2|3``, ``:400-420``, ``:516-600``): the
optimizer shards over the data axis through
``transformer.amp.build_zero_train_step``; ``--zero-gather bf16|int8`` is
the param-gather wire, ``--reduce-dtype int8|e5m2`` the grad
reduce-scatter's, ``--zero3-prefetch N`` double-buffers the level-3 layer
gathers, ``--offload-optimizer`` keeps the sharded state in host memory
(``--offload-buckets``). A ZeRO checkpoint holds each chunk leaf as its
global array (the JAX package's layout), so it resumes in either package
at the same data-parallel size.

Pipeline parallelism (``--pp P``, ``--pp-schedule``, ``--vpp``,
``:298-318``, ``:430-510``): the mesh of ``initialize_model_parallel(
tensor_model_parallel_size=T, pipeline_model_parallel_size=P)`` (dp =
world / (T P)), each rank a stage model holding its ``layers / P`` layers
(``GPTConfig(pipeline_axis="pipe")``; in the interleaved order of
``--vpp`` chunks, which the interleaved schedule defaults to 2). gpipe,
1f1b and interleaved run the autograd ring
(``transformer.pipeline_parallel.pipelined_loss_fn`` over the
``--num-microbatches`` micro-batches); zerobubble runs the plan executor
(``zero_bubble_grads_fn``; needs ``--pp`` >= 2, ``--tp 1`` and a ZeRO
level below 3). The non-layer grads are summed over the pipe axis by their
specs, and the overflow vote spans the model and pipe axes. A checkpoint
holds the whole layer stack in the interleaved order the JAX example
writes (gathered over ``("model", "pipe")``); ZeRO level 3 over a pipe
axis and a ZeRO checkpoint of a pipelined run raise naming ROADMAP Queue 1
item 25.

``--unroll`` is accepted and changes nothing: the port always drives the
layers one by one. The two-tier mesh, MoE and monitoring options raise
``NotImplementedError`` with the ROADMAP item that brings them; the
reference's own argument-consistency errors are kept. ``--device cpu``
runs the plain versions of the kernels on the CPU; the default is the card.

:func:`build` returns an ``apex_tpu_torch.bench.Bench`` whose ``step``
is the training step; :func:`run` is :func:`main` returning what it
measured.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from apex_tpu_torch import amp, checkpoint
from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch._params import load_tree_, module_tree
from apex_tpu_torch.bench import Bench
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import collectives, mesh, multiproc
from apex_tpu_torch.parallel.distributed import (
    allreduce_gradients,
    allreduce_gradients_by_spec,
    data_parallel_world,
    local_rows,
)
from apex_tpu_torch.transformer import amp as tamp
from apex_tpu_torch.transformer.amp import (
    MeshGradScaler,
    build_zero_train_step,
)

#: options of the reference outside this slice -> the ROADMAP Queue 1 item
#: that brings them
_LATER = {
    "mesh_islands": ("the two-tier mesh", 16),
    "moe_experts": ("MoE FFNs", 16),
    "moe_dispatch_dtype": ("MoE FFNs", 16),
    "plan": ("the placement search", 21),
    "journal": ("the metrics journal", 21),
    "trace": ("span tracing", 21),
    "ledger": ("the run ledger", 21),
    "flight": ("the flight recorder", 21),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--vocab", type=int, default=50304)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--micro-batch", type=int, default=2)
    p.add_argument("--num-microbatches", type=int, default=2)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--opt-level", default="O2")
    p.add_argument("--pp-schedule", default="1f1b",
                   choices=["gpipe", "1f1b", "interleaved", "zerobubble"])
    p.add_argument("--vpp", type=int, default=None)
    p.add_argument("--zero3-prefetch", type=int, default=0, metavar="N")
    p.add_argument("--unroll", action="store_true",
                   help="accepted; the port always drives the layers one "
                        "by one")
    p.add_argument("--zero", action="store_true")
    p.add_argument("--zero-level", type=int, default=None, choices=(1, 2, 3))
    p.add_argument("--zero-gather", default=None, choices=["bf16", "int8"])
    p.add_argument("--reduce-dtype", default=None, choices=["int8", "e5m2"])
    p.add_argument("--mesh-islands", type=int, default=1, metavar="N")
    p.add_argument("--dcn-wire", default="int8",
                   choices=["int8", "e5m2", "none"])
    p.add_argument("--offload-optimizer", action="store_true")
    p.add_argument("--offload-buckets", type=int, default=2, metavar="N")
    p.add_argument("--moe-experts", type=int, default=None, metavar="E")
    p.add_argument("--moe-top-k", type=int, default=2)
    p.add_argument("--moe-capacity-factor", type=float, default=1.25)
    p.add_argument("--moe-dispatch-dtype", default=None,
                   choices=["int8", "e5m2"])
    p.add_argument("--plan", default=None, metavar="auto")
    p.add_argument("--plan-hbm-gb", type=float, default=16.0)
    p.add_argument("--data", default=None,
                   help="dir of .bin int32 token files")
    p.add_argument("--save-dir", default=None)
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--journal", default=None, metavar="PATH")
    p.add_argument("--trace", default=None, metavar="PATH")
    p.add_argument("--ledger", nargs="?", const="out/ledger.jsonl",
                   default=None, metavar="PATH")
    p.add_argument("--flight", nargs="?", const="auto", default=None,
                   metavar="PATH")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    # the reference's argument-consistency errors (:289-361)
    if args.zero_level is not None:
        args.zero = True
    elif args.zero:
        args.zero_level = 2
    if args.zero_gather and not args.zero:
        p.error("--zero-gather requires --zero")
    if args.reduce_dtype and not args.zero:
        p.error("--reduce-dtype requires --zero (it is the ZeRO grad "
                "reduce-scatter wire dtype)")
    if args.vpp is None:
        args.vpp = 2 if args.pp_schedule == "interleaved" else 1
    if args.vpp > 1 and args.pp_schedule != "interleaved":
        p.error("--vpp > 1 is the interleaved schedule's knob")
    if args.pp_schedule == "interleaved" and args.vpp < 2:
        p.error("--pp-schedule interleaved needs --vpp >= 2")
    if args.pp_schedule == "zerobubble" and (args.pp < 2 or args.tp > 1):
        p.error("--pp-schedule zerobubble needs --pp >= 2 and --tp 1 (the "
                "explicit-backward executor drives the pipe axis only)")
    if args.pp_schedule == "zerobubble" and (args.zero_level or 0) >= 3:
        p.error("--pp-schedule zerobubble composes with ZeRO levels 1/2 "
                "only (level 3 rebuilds the pipelined loss)")
    if args.zero3_prefetch:
        if (args.zero_level or 0) < 3:
            p.error("--zero3-prefetch requires --zero-level 3 (it "
                    "double-buffers the per-layer chunk gathers)")
        if not args.unroll:
            p.error("--zero3-prefetch requires --unroll (the prefetch "
                    "schedule is a static unrolled structure)")
    if args.mesh_islands > 1:
        if not args.zero or (args.zero_level or 0) >= 3:
            p.error("--mesh-islands > 1 requires --zero at levels 1/2: "
                    "the hierarchical grad path is the ZeRO optimizer's "
                    "dcn_axis")
        if args.reduce_dtype:
            p.error("--reduce-dtype is the FLAT quantized wire; on a "
                    "two-tier mesh the grad wire is per TIER -- use "
                    "--dcn-wire for the inter-island hop")
        if args.moe_experts:
            p.error("--mesh-islands does not compose with --moe-experts")
    if args.offload_optimizer:
        if not args.zero or (args.zero_level or 0) >= 3:
            p.error("--offload-optimizer requires --zero at levels 1/2 "
                    "(the offloaded state IS the ZeRO chunk tree; at "
                    "level 3 grads arrive inside the backward, not in "
                    "one apply phase)")
        if args.moe_experts:
            p.error("--offload-optimizer requires every param replicated "
                    "over the zero group -- expert-sharded MoE masters "
                    "are the local shard and stay resident")
        if args.save_dir:
            p.error("--offload-optimizer does not checkpoint: the "
                    "optimizer state is host-resident, outside the device "
                    "checkpoint tree")
    if args.moe_dispatch_dtype and not args.moe_experts:
        p.error("--moe-dispatch-dtype requires --moe-experts (it is the "
                "expert-parallel dispatch wire dtype)")
    if args.moe_experts and (args.zero_level or 0) >= 3:
        p.error("--moe-experts composes with ZeRO levels 1/2 only "
                "(level 3's chunk drive has no expert-shard story)")
    return args


def check_slice(args) -> None:
    """Raise ``NotImplementedError`` for an option outside the serial,
    data-, tensor- and pipeline-parallel branches and ZeRO, naming the
    ROADMAP item that brings it."""
    if args.pp > 1 and args.zero and (args.zero_level >= 3
                                      or args.save_dir):
        raise NotImplementedError(
            "--pp with --zero-level 3, or a ZeRO checkpoint of a pipelined "
            "run (--save-dir): ZeRO over a pipe axis at level 3 and its "
            "chunk checkpoint come with ROADMAP Queue 1 item 25")
    on = {
        "mesh_islands": args.mesh_islands > 1,
        "moe_experts": bool(args.moe_experts),
        "moe_dispatch_dtype": bool(args.moe_dispatch_dtype),
        "plan": bool(args.plan), "journal": bool(args.journal),
        "trace": bool(args.trace),
        "ledger": bool(args.ledger or os.environ.get("APEX_TPU_LEDGER")),
        "flight": bool(args.flight)}
    for name, set_ in on.items():
        if set_:
            what, item = _LATER[name]
            raise NotImplementedError(
                f"--{name.replace('_', '-')}: {what} is not in this slice of "
                f"the port (the serial, data-, tensor- and pipeline-parallel "
                f"branches and ZeRO); it comes with ROADMAP Queue 1 item "
                f"{item}")


def microbatched_backward(bench: Bench, tokens: torch.Tensor,
                          targets: torch.Tensor,
                          num_microbatches: int) -> torch.Tensor:
    """The loss of ``pipelined_loss_fn`` at one stage: each of the M
    micro-batches' mean loss, scaled by the loss scale over M, runs its own
    backward, so the grads sum to those of the batch mean. Each
    micro-batch's grads are added into fp32 buffers and the sum is rounded
    once to each param's dtype. Returns the batch mean (detached)."""
    return _microbatched_backward(bench.model, bench.mp_opt, bench.opt_state,
                                  tokens, targets, num_microbatches)


def _microbatched_backward(model, mp_opt, state, tokens, targets,
                           num_microbatches):
    tokens, targets = tokens.to(model.device), targets.to(model.device)
    return tamp.microbatched_backward(model.loss, list(model.parameters()),
                                      mp_opt, state, tokens, targets,
                                      num_microbatches)


def reduce_data_parallel(model: GPTModel,
                         loss: torch.Tensor) -> torch.Tensor:
    """The reference's data-parallel reduction (``:505-514``) on the
    parameters' ``.grad``: the non-layer grads through
    ``allreduce_gradients_by_spec`` by the model's specs (which also sums
    them over the pipe axis), the layers' through ``allreduce_gradients``
    over the gradient-reduction axes.
    Returns the ``pmean`` of ``loss``."""
    axes = mesh.get_gradient_reduction_axes()
    named = list(model.named_parameters())
    rest = [(n, p) for n, p in named if not n.startswith("layers.")]
    layers = [p for n, p in named if n.startswith("layers.")]
    specs = model.specs()

    def spec_of(name):
        leaf = specs
        for key in name.split("."):
            leaf = leaf[key]
        return leaf

    def grads(ps):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in ps]

    rest_g = allreduce_gradients_by_spec(grads([p for _, p in rest]),
                                         [spec_of(n) for n, _ in rest])
    layer_g = allreduce_gradients(grads(layers), axes)
    for p, g in zip([p for _, p in rest] + layers, rest_g + layer_g):
        p.grad = g
    return collectives.pmean(loss, axes)


def build(*, vocab: int = 50304, hidden: int = 256, layers: int = 4,
          heads: int = 8, seq: int = 256, micro_batch: int = 2,
          num_microbatches: int = 2, lr: float = 3e-4,
          opt_level: str = "O2", remat_policy: Optional[str] = None,
          seed: int = 0, tp: int = 1, axis: Optional[str] = None,
          pp: int = 1, vpp: int = 1, pp_schedule: str = "1f1b",
          zero_level: Optional[int] = None,
          zero_gather: Optional[str] = None,
          reduce_dtype: Optional[str] = None, zero3_prefetch: int = 0,
          offload: bool = False, offload_buckets: int = 2,
          device: DeviceLike = None) -> Bench:
    """The reference's model and optimizer state (``:391-424``) on one
    device (the card unless ``device="cpu"``), random weights from
    ``seed``. ``step(tokens, targets)`` is the training step on the global
    batch: this rank's rows (all of them without ``torch.distributed``)
    through the micro-batched backward (:func:`microbatched_backward`),
    the data-parallel reduction (:func:`reduce_data_parallel`, when
    ``torch.distributed`` is initialized), then the optimizer step, which
    skips the update and lowers the scale on an overflow.
    ``remat_policy``: the checkpointing policy of every layer (the
    reference's config field; its example keeps the default). The Bench's
    ``batch`` is the global batch, ``micro_batch x dp x
    num_microbatches``. ``tp`` > 1 installs the dp x tp mesh
    (``initialize_model_parallel(tensor_model_parallel_size=tp)``) unless
    one of that tp size is installed, and builds the model on the model
    axis; ``axis="model"`` does so at ``tp`` = 1 too. ``pp`` > 1 installs
    the dp x pp x tp mesh and builds this rank's stage (``vpp`` chunks a
    stage): the step runs the autograd ring, or the zero-bubble executor
    with ``pp_schedule="zerobubble"``
    (:func:`~apex_tpu_torch.transformer.amp.pipelined_backward`), and
    :func:`reduce_data_parallel` sums the non-layer grads over the pipe
    axis.

    ``zero_level`` (1, 2 or 3; ``--zero``) shards the optimizer over the
    data axis (``:400-420``, ``:516-600``): ``MixedPrecisionOptimizer(
    zero_axis="data", gather_dtype=zero_gather, reduce_dtype=...)`` and
    :func:`~apex_tpu_torch.transformer.amp.build_zero_train_step`, whose
    reduce-scatter is the data-parallel reduction; at level 3 the
    params persist as chunks (``Bench.zero3``) and ``zero3_prefetch``
    double-buffers the layer gathers; ``offload`` keeps the sharded state
    in host memory in ``offload_buckets`` buckets (``Bench.offload``)."""
    dev = resolve_device(device)
    zero = zero_level is not None
    if zero and not mesh.model_parallel_is_initialized() and tp == 1 \
            and axis is None and pp == 1:
        mesh.initialize_model_parallel()
    if tp > 1 or axis is not None:
        axis = axis or mesh.AXIS_MODEL
    if tp > 1 or axis is not None or pp > 1:
        if not (mesh.model_parallel_is_initialized()
                and mesh.get_tensor_model_parallel_world_size() == tp
                and mesh.get_pipeline_model_parallel_world_size() == pp):
            mesh.initialize_model_parallel(
                tensor_model_parallel_size=tp,
                pipeline_model_parallel_size=pp)
    dp, rank = data_parallel_world()
    distributed = dist.is_available() and dist.is_initialized()
    policy = amp.get_policy(opt_level)
    cfg = GPTConfig(
        vocab_size=vocab,
        hidden_size=hidden,
        num_layers=layers,
        num_attention_heads=heads,
        max_seq_len=seq,
        hidden_dropout=0.0,
        compute_dtype=(torch.bfloat16 if opt_level in ("O1", "O2", "O3")
                       else torch.float32),
        remat=True,
        remat_policy=remat_policy,
        axis=axis,
        pipeline_axis=mesh.AXIS_PIPE if pp > 1 else None,
        virtual_pipeline_size=vpp,
        zero3_prefetch=zero3_prefetch,
    )
    model = GPTModel(cfg, device=dev, seed=seed)
    amp.cast_params(model, policy)
    mp_opt = amp.MixedPrecisionOptimizer(
        FusedAdam(lr=lr), policy,
        zero_axis=mesh.AXIS_DATA if zero else None,
        zero_level=zero_level or 2, gather_dtype=zero_gather,
        reduce_dtype=reduce_dtype)
    pipe_vg = None
    if pp > 1 and pp_schedule == "zerobubble":
        from apex_tpu_torch.transformer.pipeline_parallel import (
            zero_bubble_grads_fn,
        )

        pipe_vg = zero_bubble_grads_fn(model, num_microbatches, pp)
    if zero:
        return _build_zero(model, mp_opt, cfg, num_microbatches, offload,
                           offload_buckets,
                           micro_batch * dp * num_microbatches, dp, rank,
                           vpp, pipe_vg)
    opt_state = mp_opt.init(model)

    vote = None
    if pp > 1:  # every rank of the model and pipe axes skips or steps
        vote = MeshGradScaler().found_inf_reducer
    elif axis is not None:  # every rank of the model axis skips or steps
        def vote(found):
            return collectives.found_inf_max(found, axis)

    def step(tokens: torch.Tensor, targets: torch.Tensor):
        # over the parts, not the Bench: no cycle keeps a dropped trainer
        toks, tgts = (local_rows(tokens, dp, rank),
                      local_rows(targets, dp, rank))
        if pp > 1:
            loss = tamp.pipelined_backward(
                mp_opt, opt_state, model, toks.to(dev), tgts.to(dev),
                num_microbatches, pipe_vg)
        else:
            loss = _microbatched_backward(model, mp_opt, opt_state, toks,
                                          tgts, num_microbatches)
        if distributed:
            loss = reduce_data_parallel(model, loss)
        metrics = mp_opt.step(opt_state, model, found_inf_reducer=vote)
        return loss, metrics

    return Bench(step, model, mp_opt, opt_state, cfg,
                 micro_batch * dp * num_microbatches)


def _build_zero(model, mp_opt, cfg, num_microbatches, offload,
                offload_buckets, batch, dp, rank, vpp=1,
                pipe_vg=None) -> Bench:
    """:func:`build`'s ZeRO branch: the sharded state (resident, level-3
    chunks or host-offloaded) and the step of ``build_zero_train_step`` on
    this rank's rows."""
    zero3 = off = None
    if offload:
        from apex_tpu_torch.optimizers.offload import HostOffloadedZero

        off = HostOffloadedZero(
            mp_opt, num_buckets=offload_buckets,
            found_inf_reducer=MeshGradScaler().found_inf_reducer)
        opt_state = off.init(model)
    elif mp_opt.zero_level >= 3:
        zero3 = mp_opt.zero3_init(model)
        opt_state = zero3.opt_state
    else:
        opt_state = mp_opt.init(model)
    zstep = build_zero_train_step(mp_opt, model, opt_state,
                                  num_microbatches=num_microbatches,
                                  zero3=zero3, offload=off,
                                  virtual_pipeline_size=vpp,
                                  pipe_value_and_grad=pipe_vg)

    def step(tokens: torch.Tensor, targets: torch.Tensor):
        return zstep(local_rows(tokens, dp, rank),
                     local_rows(targets, dp, rank))

    return Bench(step, model, mp_opt, opt_state, cfg, batch, zero3, off)


def from_args(args, remat_policy: Optional[str] = None) -> Bench:
    """:func:`build` from :func:`parse_args`'s namespace."""
    return build(vocab=args.vocab, hidden=args.hidden, layers=args.layers,
                 heads=args.heads, seq=args.seq,
                 micro_batch=args.micro_batch,
                 num_microbatches=args.num_microbatches, lr=args.lr,
                 opt_level=args.opt_level, remat_policy=remat_policy,
                 tp=args.tp, pp=args.pp, vpp=args.vpp,
                 pp_schedule=args.pp_schedule,
                 zero_level=args.zero_level if args.zero else None,
                 zero_gather=args.zero_gather, reduce_dtype=args.reduce_dtype,
                 zero3_prefetch=args.zero3_prefetch,
                 offload=args.offload_optimizer,
                 offload_buckets=args.offload_buckets, device=args.device)


def train_state(bench: Bench, device="cpu") -> Dict[str, Any]:
    """``{"params", "opt"}`` in the JAX example's checkpoint layout
    (``:850-851``): this rank's shards under tensor parallelism.
    ``device="meta"``: the structure alone (a restore target), with no
    copy. Under ZeRO the optimizer state (and at level 3 the params) are
    the global chunk arrays, which every rank must call to gather."""
    mp = bench.mp_opt
    if mp.zero_axis is None:
        return {"params": module_tree(bench.model, device=device),
                "opt": amp.state_tree(bench.opt_state, bench.model,
                                      device=device)}
    dev = "cpu" if device == "meta" else device
    params = (mp.zero3_params_tree(bench.zero3, bench.model, dev)
              if bench.zero3 is not None
              else module_tree(bench.model, device=dev))
    return {"params": params,
            "opt": mp.zero_state_tree(bench.opt_state, bench.model, dev)}


def train_state_specs(bench: Bench) -> Optional[Dict[str, Any]]:
    """The split of each leaf of :func:`train_state` over the model and
    pipe axes (the masters and moments split as their params; the step
    count and the scaler replicated), or None for a serial model. ZeRO's
    global chunk arrays are whole on every rank (None)."""
    c = bench.model.cfg
    if c.axis is None and c.pipeline_axis is None:
        return None
    specs = bench.model.specs()
    if bench.mp_opt.zero_axis is not None:
        return {"params": None if bench.zero3 is not None else specs,
                "opt": None}
    opt = train_state(bench, device="meta")["opt"]
    return {"params": specs, "opt": {
        "inner": {k: specs if isinstance(v, dict) else None
                  for k, v in opt["inner"].items()},
        "master": specs if "master" in opt else None, "scaler": None}}


def load_train_state_(bench: Bench, tree: Dict[str, Any]) -> None:
    """Copy a ``{"params", "opt"}`` tree (this rank's shards) into the
    model and its optimizer state in place."""
    mp = bench.mp_opt
    if mp.zero_axis is None:
        load_tree_(bench.model, tree["params"])
        amp.load_state_tree_(bench.opt_state, bench.model, tree["opt"])
        return
    if bench.zero3 is not None:
        mp.zero3_load_params_tree_(bench.zero3, bench.model, tree["params"])
    else:
        load_tree_(bench.model, tree["params"])
    mp.zero_load_state_tree_(bench.opt_state, bench.model, tree["opt"])


def batches(args, batch: int) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """The reference's batches (``:624-640``), from their first."""
    if args.data:
        from apex_tpu_torch.csrc import TokenLoader

        files = sorted(os.path.join(args.data, f)
                       for f in os.listdir(args.data) if f.endswith(".bin"))
        for arr in TokenLoader(files, (batch, args.seq + 1), loop=True):
            arr = torch.from_numpy(arr % args.vocab).long()
            yield arr[:, :-1], arr[:, 1:]
        return
    rng = np.random.default_rng(0)
    while True:
        toks = rng.integers(0, args.vocab, (batch, args.seq))
        yield (torch.from_numpy(toks),
               torch.from_numpy(np.roll(toks, -1, axis=-1)))


def run(argv=None) -> Dict[str, Any]:
    """:func:`main`'s run; returns the trainer (``bench``), the first step
    (``start``), each step's loss and metrics, each step's host seconds to
    its loss (``step_s``, saves excluded), ``ms_per_step`` and
    ``tokens_per_s`` (the reference's window: every step after the first,
    saves included, ending in a device sync) and the seconds of each save
    and of the restore."""
    args = parse_args(argv)
    check_slice(args)
    started = (not dist.is_initialized()
               and multiproc.initialize_distributed(device=args.device))
    try:
        return _run(args)
    finally:
        if started:
            multiproc.shutdown()


def _run(args) -> Dict[str, Any]:
    bench = from_args(args)
    batch = bench.batch
    dp, _ = data_parallel_world()
    distributed = dist.is_initialized()
    lead = dist.get_rank() == 0 if distributed else True
    dev = bench.model.device
    specs = train_state_specs(bench)
    axes = (mesh.AXIS_MODEL, mesh.AXIS_PIPE)
    out: Dict[str, Any] = {"bench": bench, "losses": [], "metrics": [],
                           "step_s": [], "save_s": [], "restore_s": None}
    next_batch = batches(args, batch)
    start = 0
    if args.save_dir and (
            step := checkpoint.latest_step(args.save_dir)) is not None:
        t0 = time.perf_counter()
        load_train_state_(bench, checkpoint.restore_checkpoint(
            args.save_dir, train_state(bench, device="meta"), specs=specs,
            axis=axes))
        out["restore_s"] = time.perf_counter() - t0
        start = step
        if lead:
            print(f"resumed from step {step}")
    out["start"] = start
    if args.pp_schedule == "zerobubble" and lead:
        from apex_tpu_torch.transformer.pipeline_parallel import (
            plan_schedule,
        )

        zb = plan_schedule("zero-bubble", args.num_microbatches, args.pp)
        f1 = plan_schedule("1f1b", args.num_microbatches, args.pp)
        print(f"pp-schedule zerobubble: {zb.ticks} ticks, "
              f"{zb.idle_slots()[0]} idle/rank (plan bubble "
              f"{zb.bubble_fraction():.4f} vs 1f1b "
              f"{f1.bubble_fraction():.4f})")

    t0 = time.perf_counter()
    for i in range(start, start + args.steps):
        s0 = time.perf_counter()
        toks, tgts = next(next_batch)
        loss, metrics = bench.step(toks, tgts)
        out["losses"].append(float(loss))  # waits for the step's loss
        out["step_s"].append(time.perf_counter() - s0)
        out["metrics"].append(metrics)
        if i == start:
            t0 = time.perf_counter()  # exclude the first step
        if lead and (i % 5 == 0 or i == start + args.steps - 1):
            print(f"step {i:5d} loss {float(loss):.4f} "
                  f"scale {float(metrics['loss_scale']):.0f}")
        if args.save_dir and (i + 1) % args.save_every == 0:
            s0 = time.perf_counter()
            if specs is not None:  # gathered over model and pipe: all call
                checkpoint.save_checkpoint(
                    args.save_dir, i + 1, train_state(bench, device=dev),
                    specs=specs, axis=axes)
            elif bench.mp_opt.zero_axis is not None:
                state = train_state(bench)  # ZeRO's chunks: all gather
                if lead:
                    checkpoint.save_checkpoint(args.save_dir, i + 1, state)
                del state
            elif lead:  # the state is the same on every rank
                checkpoint.save_checkpoint(args.save_dir, i + 1,
                                           train_state(bench))
            if distributed:
                dist.barrier()
            out["save_s"].append(time.perf_counter() - s0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n_done = max(args.steps - 1, 1)
    dt = (time.perf_counter() - t0) / n_done
    out["ms_per_step"] = dt * 1e3
    out["tokens_per_s"] = batch * args.seq / dt
    if args.steps and lead:
        print(f"{batch * args.seq / dt:.0f} tokens/s | mesh: tp={args.tp} "
              f"pp={args.pp} dp={dp} | {dt * 1e3:.1f} ms/step")
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
