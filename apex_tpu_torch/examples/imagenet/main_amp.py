"""ImageNet-style ResNet training with amp and data parallelism: the port
of ``examples/imagenet/main_amp.py``.

    python -m apex_tpu_torch.examples.imagenet.main_amp --arch resnet50 \\
        --opt-level O2 --batch-size 256 --steps 20
    torchrun --nproc_per_node N -m apex_tpu_torch.examples.imagenet.main_amp \\
        --sync-bn ...   # N ranks (NCCL; gloo with --device cpu)

The moving parts are the reference's: ``ResNet50`` (NHWC images) built in
``policy.op_dtype("conv")``, ``get_policy(opt_level, keep_batchnorm_fp32=,
loss_scale=)`` + ``cast_params`` + ``MixedPrecisionOptimizer`` around
``FusedSGD(lr, momentum, weight_decay, nesterov=True)``, local BatchNorm
(running stats updated once a step, in the forward) and the loss
``mean(softmax_cross_entropy(logits, labels))`` over the batch through the
port's xentropy kernels. Data is synthetic ImageNet-shaped from a seeded
generator by default, or ``--data-dir``: ``.npz`` files (keys
``images``/``labels``) streamed by the prefetching loader.

Data parallelism (``:95-150``): under a launcher
(:func:`apex_tpu_torch.parallel.multiproc.initialize_distributed`) the data
axis is the whole world, ``--batch-size`` is the global batch of which
rank r takes rows ``[r B / dp, (r + 1) B / dp)``, the grads are averaged
over ``data`` (``allreduce_gradients``) after the backward, and the loss is
the ``pmean`` of the local means. ``--sync-bn`` makes every BN a
SyncBatchNorm over ``data`` (the running statistics then agree on every
rank; under local BN each rank keeps its own). The parameters start equal
on every rank (the same seed); rank 0 prints. ``--device cpu`` runs the
plain versions of the kernels on the CPU; the default is the card.

:func:`build` and :func:`train_steps` are what ``chip_smoke.py`` drives, as
``apex_tpu_torch/bench.py`` is for GPT: ``train_steps`` takes one fixed
batch already on the device, so its timed window holds no host-to-device
copy.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from apex_tpu_torch import amp
from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.models import resnet as resnet_mod
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import collectives, mesh, multiproc
from apex_tpu_torch.parallel.distributed import (
    allreduce_gradients,
    data_parallel_world,
    local_rows,
)

ARCHS = {
    "resnet18": resnet_mod.ResNet18,
    "resnet34": resnet_mod.ResNet34,
    "resnet50": resnet_mod.ResNet50,
    "resnet101": resnet_mod.ResNet101,
}

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="resnet50", choices=sorted(ARCHS))
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--batch-size", type=int, default=64, help="global batch")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--sync-bn", action="store_true",
                   help="SyncBatchNorm over the data axis "
                        "(convert_syncbn_model)")
    p.add_argument("--keep-batchnorm-fp32", default=None)
    p.add_argument("--loss-scale", default=None)
    p.add_argument("--data-dir", default=None,
                   help="dir of .npz batch files (images/labels keys)")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


@dataclasses.dataclass
class Trainer:
    """What :func:`build` returns: ``step(images, labels) -> (loss,
    metrics)`` runs one training step on the global batch (this rank's
    rows of it) and returns the unscaled mean loss (detached; the
    ``pmean`` over the ranks) and the optimizer's metrics, over ``model`` /
    ``mp_opt`` / ``opt_state``. ``batch_size`` is the global batch, ``dp``
    the data-parallel size."""

    step: Callable
    model: resnet_mod.ResNet
    mp_opt: amp.MixedPrecisionOptimizer
    opt_state: amp.MPOptState
    policy: amp.Policy
    batch_size: int
    image_size: int
    num_classes: int
    dp: int = 1


def build(arch: str = "resnet50", opt_level: str = "O2", *,
          batch_size: int = 64, image_size: int = 224,
          num_classes: int = 1000, lr: float = 0.1, momentum: float = 0.9,
          weight_decay: float = 1e-4,
          keep_batchnorm_fp32: Optional[bool] = None,
          loss_scale: Optional[Union[str, float]] = None,
          sync_bn: bool = False, seed: int = 0,
          device: DeviceLike = None) -> Trainer:
    """The recipe's model, policy and optimizer on one device (the card
    unless ``device="cpu"``), random weights from ``seed``;
    ``keep_batchnorm_fp32`` / ``loss_scale`` override the policy when not
    None. With ``torch.distributed`` initialized the step is the
    reference's data-parallel one; ``sync_bn`` synchronises every BN over
    ``data`` (one rank without a process group: the local statistics)."""
    if sync_bn and not mesh.model_parallel_is_initialized():
        mesh.initialize_model_parallel()
    dp, rank = data_parallel_world()
    distributed = torch.distributed.is_initialized()
    dev = resolve_device(device)
    policy = amp.get_policy(opt_level,
                            keep_batchnorm_fp32=keep_batchnorm_fp32,
                            loss_scale=loss_scale)
    model = ARCHS[arch](num_classes=num_classes,
                        axis_name=mesh.AXIS_DATA if sync_bn else None,
                        dtype=policy.op_dtype("conv"), device=dev,
                        seed=seed)
    amp.cast_params(model, policy)
    opt = FusedSGD(lr=lr, momentum=momentum, weight_decay=weight_decay,
                   nesterov=True)
    mp_opt = amp.MixedPrecisionOptimizer(opt, policy)
    opt_state = mp_opt.init(model)

    def step(images: torch.Tensor, labels: torch.Tensor):
        logits = model(local_rows(images, dp, rank))
        loss = torch.mean(softmax_cross_entropy(
            logits, local_rows(labels, dp, rank)))
        mp_opt.scale_loss(loss, opt_state).backward()
        loss = loss.detach()
        if distributed:
            params = list(model.parameters())
            for p, g in zip(params, allreduce_gradients(
                    [p.grad for p in params], (mesh.AXIS_DATA,))):
                p.grad = g
            loss = collectives.pmean(loss, (mesh.AXIS_DATA,))
        metrics = mp_opt.step(opt_state, model)
        return loss, metrics

    return Trainer(step, model, mp_opt, opt_state, policy, batch_size,
                   image_size, num_classes, dp)


def fixed_batch(trainer: Trainer, seed: int = 1):
    """One synthetic global ``(batch, size, size, 3)`` fp32 image batch
    (standard normal) and its int64 labels, made on the model's device
    from ``seed`` (the same on every rank)."""
    dev = trainer.model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    s = trainer.image_size
    images = torch.randn((trainer.batch_size, s, s, 3), generator=gen,
                         device=dev)
    labels = torch.randint(0, trainer.num_classes, (trainer.batch_size,),
                           generator=gen, device=dev)
    return images, labels


def train_steps(trainer: Trainer, n: int = 10, images=None, labels=None
                ) -> Dict[str, Any]:
    """One warm-up step, then ``n`` steps on one fixed batch, timed with
    CUDA events between the steps (each reading includes the host's issue
    and its one wait per step, on the overflow flag and the loss). Returns
    the per-step losses (floats, the warm-up's first), the optimizer
    metrics, ``window_ms`` (the ``n`` timed steps from the first event to
    the last), ``step_ms`` (each timed step; both None on the CPU, where
    nothing is timed) and ``images_per_step``."""
    if images is None:
        images, labels = fixed_batch(trainer)
    losses: List[float] = []
    metrics: List[Dict[str, Any]] = []
    on_card = images.device.type == "cuda"
    events = []
    for i in range(n + 1):
        if on_card and i > 0:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        loss, m = trainer.step(images, labels)
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
            "step_ms": step_ms, "images_per_step": int(images.shape[0])}


def main(argv=None) -> Optional[int]:
    args = parse_args(argv)
    started = (not torch.distributed.is_initialized()
               and multiproc.initialize_distributed(device=args.device))
    try:
        return _main(args)
    finally:
        if started:
            multiproc.shutdown()


def _main(args) -> int:
    keep_bn = (None if args.keep_batchnorm_fp32 is None
               else args.keep_batchnorm_fp32 == "True")
    scale = (None if args.loss_scale is None else "dynamic"
             if args.loss_scale == "dynamic" else float(args.loss_scale))
    trainer = build(args.arch, args.opt_level, batch_size=args.batch_size,
                    image_size=args.image_size, num_classes=args.num_classes,
                    lr=args.lr, momentum=args.momentum,
                    weight_decay=args.weight_decay,
                    keep_batchnorm_fp32=keep_bn, loss_scale=scale,
                    sync_bn=args.sync_bn, device=args.device)
    dev = trainer.model.device
    lead = (not torch.distributed.is_initialized()
            or torch.distributed.get_rank() == 0)
    shape = (args.batch_size, args.image_size, args.image_size, 3)
    if args.data_dir:
        from apex_tpu_torch.data import NpyBatchLoader
        batches = iter(NpyBatchLoader(args.data_dir, batch_shape=shape,
                                      loop=True))
    else:
        rng = np.random.default_rng(0)

        def synthetic():
            while True:
                yield (rng.standard_normal(shape, dtype=np.float32),
                       rng.integers(0, args.num_classes, (args.batch_size,)))
        batches = synthetic()

    t0 = time.perf_counter()
    seen = 0
    loss = None
    for i, (images, labels) in zip(range(args.steps), batches):
        images = torch.from_numpy(np.asarray(images, np.float32)).to(dev)
        labels = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
        loss, metrics = trainer.step(images, labels)
        if i == 0:  # exclude the first step (warm-up) from throughput
            float(loss)
            t0 = time.perf_counter()
        else:
            seen += args.batch_size
        if lead and i % 5 == 0:
            print(f"step {i:4d} loss {float(loss):.4f} "
                  f"loss_scale {metrics['loss_scale']:.0f}")
    if loss is not None:
        float(loss)  # stop the clock on a device->host fetch
    dt = time.perf_counter() - t0
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    where = (f"one device: {name}" if trainer.dp == 1
             else f"{trainer.dp}-way DP on {name}")
    if lead:
        print(f"{seen / max(dt, 1e-9):.1f} imgs/sec ({args.arch}, "
              f"{args.opt_level}, batch {args.batch_size}, {where})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
