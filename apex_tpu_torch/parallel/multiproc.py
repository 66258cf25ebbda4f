"""Launch glue (port of ``apex_tpu/parallel/multiproc.py``; reference:
apex/parallel/multiproc.py).

Launch the port's programs with ``torchrun --nproc_per_node N -m ...``
(which exports ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
and ``LOCAL_RANK``) and call :func:`initialize_distributed` first: it
resolves the world the reference's way (explicit arguments, then those
variables), initializes ``torch.distributed`` with a stated timeout, and on
the card selects the ``LOCAL_RANK``-th device. One process with no address
is the single-device run and a no-op, so scripts run with or without a
launcher. A world above one without an address raises, and so does a
failed initialization: nothing falls back to one rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import mesh

#: ``init_process_group``'s timeout, and so every collective's
DEFAULT_TIMEOUT_S = 300.0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Initialize ``torch.distributed`` when a multi-process world is
    configured (``multiproc.py:21-62``). Returns True when it ran, False
    for one process with no address.

    The address is ``coordinator_address`` (``host:port``), else
    ``MASTER_ADDR:MASTER_PORT`` (port 1234 if unset); the world size
    ``num_processes``, else ``WORLD_SIZE`` (1); the rank ``process_id``,
    else ``RANK`` (0). ``init_method`` (say ``file://...``) replaces the
    address. ``backend`` defaults to NCCL on the card and gloo for
    ``device="cpu"``; gloo on the card is taken only when asked for. On the
    card the current device becomes ``cuda:LOCAL_RANK``."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '1234')}")
    world = int(num_processes or env.get("WORLD_SIZE", "1"))
    rank = int(process_id if process_id is not None
               else env.get("RANK", "0"))
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    if coordinator_address is None and init_method is None:
        if world <= 1:
            return False
        raise RuntimeError(
            f"WORLD_SIZE={world} but no coordinator address (set "
            f"MASTER_ADDR[:MASTER_PORT], or launch with torchrun)")
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_distributed on the card, but CUDA is not "
                "available; pass device='cpu' for gloo on the CPU")
        torch.cuda.set_device(local_rank())
    if init_method is None:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", local_rank())
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return True


def local_rank() -> int:
    """The node-local rank the launcher exports (``LOCAL_RANK``, 0 when
    unset), ``multiproc.py:65-71``."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def shutdown() -> None:
    """Tear ``torch.distributed`` down if it is up (every process group the
    mesh built goes with it)."""
    from apex_tpu_torch.parallel import mesh

    mesh.destroy_model_parallel()
    if dist.is_initialized():
        dist.destroy_process_group()
