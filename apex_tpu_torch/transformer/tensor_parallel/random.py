"""Parallel RNG and activation checkpointing (port of
``apex_tpu/transformer/tensor_parallel/random.py``; reference:
apex/transformer/tensor_parallel/random.py).

The reference's ``CudaRNGStatesTracker`` keeps CUDA RNG states so that
dropout inside tensor-parallel regions draws DIFFERENT randomness per TP
rank while replicated regions draw the SAME (random.py:113-220; seeds at
``:174-191``: data-parallel seed = base, model-parallel seed = base + 2718
+ tp_rank). The JAX package folds keys; here each stream is an explicit
``torch.Generator`` seeded from the base seed:

- :func:`model_parallel_generator`: base + 2718 + tp rank;
- :func:`sequence_parallel_generator`: base + 1414 + tp rank, for dropout
  in sequence-sharded regions (each rank holds different tokens there),
  never the model-parallel stream;
- :func:`data_parallel_generator`: the base seed, the same on every rank.

The bits are torch's, not JAX's: parity with the JAX package runs at
dropout 0, and the streams' rank properties are tested on their own.
:func:`checkpoint` is ``torch.utils.checkpoint`` with the RNG state saved
and restored around the recompute (``CheckpointFunction``,
random.py:224-294).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.parallel.mesh import AXIS_MODEL
from apex_tpu_torch.transformer.tensor_parallel.mappings import axis_world

#: the reference's model-parallel seed offset (random.py:182)
_MODEL_PARALLEL_OFFSET = 2718
#: the sequence-parallel regions' own offset (the JAX package's)
_SEQUENCE_PARALLEL_OFFSET = 1414

#: the remat policies of the model zoo (``models/_transformer.py``), the
#: names of the reference's ``checkpoint_policies`` the port keeps
checkpoint_policies = ("full", "save_attn", "dots")


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device or "cpu"))
    g.manual_seed(int(seed))
    return g


def model_parallel_generator(seed: int, axis: str = AXIS_MODEL,
                             device=None) -> torch.Generator:
    """A generator that differs per TP rank (the tracker's
    "model-parallel-rng"): seed + 2718 + the rank along ``axis``."""
    rank, _ = axis_world(axis)
    return _generator(seed + _MODEL_PARALLEL_OFFSET + rank, device)


def sequence_parallel_generator(seed: int, axis: str = AXIS_MODEL,
                                device=None) -> torch.Generator:
    """A generator that differs per TP rank for dropout in sequence-sharded
    regions (between a row-parallel reduce-scatter and the next column
    gather): seed + 1414 + the rank along ``axis``, a stream apart from the
    model-parallel one."""
    rank, _ = axis_world(axis)
    return _generator(seed + _SEQUENCE_PARALLEL_OFFSET + rank, device)


def data_parallel_generator(seed: int, device=None) -> torch.Generator:
    """The base stream, identical on every TP rank (the reference's default
    CUDA state)."""
    return _generator(seed, device)


class RNGStatesTracker:
    """The named streams of ``get_cuda_rng_tracker()`` (the JAX package's
    ``key(name)``): ``generator(name)`` gives a fresh generator of the
    stream. ``axis=None`` (serial) gives each rank-offset stream at rank
    0's seed."""

    MODEL_PARALLEL = "model-parallel-rng"
    SEQUENCE_PARALLEL = "sequence-parallel-rng"

    def __init__(self, seed: int, axis: Optional[str] = AXIS_MODEL,
                 device=None):
        self._seed = int(seed)
        self._axis = axis
        self._device = device

    def generator(self, name: str = MODEL_PARALLEL) -> torch.Generator:
        offset = {self.MODEL_PARALLEL: _MODEL_PARALLEL_OFFSET,
                  self.SEQUENCE_PARALLEL: _SEQUENCE_PARALLEL_OFFSET}.get(name)
        if offset is None:
            return data_parallel_generator(self._seed, self._device)
        rank = axis_world(self._axis)[0] if self._axis is not None else 0
        return _generator(self._seed + offset + rank, self._device)


def checkpoint(function: Callable, *args, use_reentrant: bool = False,
               **kwargs):
    """Activation checkpointing: ``function(*args)`` recomputed in the
    backward with the RNG state it ran under (``preserve_rng_state``), so a
    dropout draws the same masks twice."""
    return torch.utils.checkpoint.checkpoint(
        function, *args, use_reentrant=use_reentrant,
        preserve_rng_state=True, **kwargs)
