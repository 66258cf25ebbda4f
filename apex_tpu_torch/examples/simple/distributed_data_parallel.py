"""Minimal data-parallel training example (port of
``examples/simple/distributed_data_parallel.py``; reference:
examples/simple/distributed/distributed_data_parallel.py).

    torchrun --nproc_per_node 2 -m \\
        apex_tpu_torch.examples.simple.distributed_data_parallel
    python -m apex_tpu_torch.examples.simple.distributed_data_parallel \\
        --device cpu   # one process

The reference's 10-line model, ``tanh(x @ w1) @ w2`` with ``w1`` (16, 32)
and ``w2`` (32, 1) drawn at 0.1 deviation, trains on 64 rows of ``x`` and
``y = sum(x) + 0.1 noise`` with ``FusedSGD(lr=0.05, momentum=0.9)`` for 20
steps, wrapped in :class:`apex_tpu_torch.parallel.DistributedDataParallel`:
each rank takes its rows of the batch, and the grads come back averaged.
The loss printed is the mean over the ranks of the local mean losses. The
weights and data come from ``numpy.random.default_rng(seed)`` (the JAX
example draws them with ``jax.random``; :func:`train` takes any).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import collectives, mesh, multiproc
from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel,
    data_parallel_world,
    local_rows,
)


class Model(nn.Module):
    """``tanh(x @ w1) @ w2``."""

    def __init__(self, w1: np.ndarray, w2: np.ndarray, device):
        super().__init__()
        self.w1 = nn.Parameter(torch.as_tensor(w1, device=device))
        self.w2 = nn.Parameter(torch.as_tensor(w2, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x @ self.w1) @ self.w2


def make_inputs(seed: int = 0) -> Dict[str, np.ndarray]:
    """``w1``, ``w2``, ``x`` (64, 16) and ``y`` (64, 1), fp32."""
    rng = np.random.default_rng(seed)
    w1 = (rng.standard_normal((16, 32)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((32, 1)) * 0.1).astype(np.float32)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    y = (x.sum(1, keepdims=True)
         + 0.1 * rng.standard_normal((64, 1))).astype(np.float32)
    return {"w1": w1, "w2": w2, "x": x, "y": y}


def train(inputs: Dict[str, np.ndarray], steps: int = 20,
          device: DeviceLike = None, log: bool = True) -> List[float]:
    """The example's loop on ``inputs`` (global ``x`` / ``y``; the same on
    every rank); returns each step's loss (the pmean of the local
    means)."""
    dev = resolve_device(device)
    dp, rank = data_parallel_world()
    distributed = dist.is_initialized()
    model = Model(inputs["w1"], inputs["w2"], dev)
    if distributed:
        model = DistributedDataParallel(model, mesh.AXIS_DATA)
    params = list(model.parameters())
    opt = FusedSGD(lr=0.05, momentum=0.9)
    state = opt.init(params)
    x = local_rows(torch.as_tensor(inputs["x"], device=dev), dp, rank)
    y = local_rows(torch.as_tensor(inputs["y"], device=dev), dp, rank)
    lead = not distributed or dist.get_rank() == 0
    losses = []
    for i in range(steps):
        loss = torch.mean(torch.square(model(x) - y))
        loss.backward()  # DDP: the grads come back averaged
        with torch.no_grad():
            state = opt.update_(params, [p.grad for p in params], state)
        for p in params:
            p.grad = None
        loss = loss.detach()
        if distributed:
            loss = collectives.pmean(loss, mesh.AXIS_DATA)
        losses.append(float(loss))
        if log and lead and i % 5 == 0:
            print(f"step {i:3d} loss {losses[-1]:.5f}")
    if log and lead:
        print(f"final loss {losses[-1]:.5f} over {dp}-way DP")
    return losses


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    started = (not dist.is_initialized()
               and multiproc.initialize_distributed(device=args.device))
    try:
        train(make_inputs(args.seed), args.steps, args.device)
    finally:
        if started:
            multiproc.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
