"""The layer layout of a pipeline stage: which serial layers a stage holds
and in which order (port of the layout half of ``apex_tpu/transformer/
pipeline_parallel/schedules.py``).

Under interleaved virtual pipelining stage ``s`` chunk ``c`` holds the
serial layer slab ``c*S + s``; the stacked layer tree is permuted so that,
cut into ``S`` equal blocks, block ``s`` is stage ``s``'s layers in its
local order. The stage models (``models/_transformer.py``) and the
schedules (``transformer/pipeline_parallel/schedules.py``) share it.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch


def interleave_order(num_layers: int, pipeline_size: int,
                     virtual_pipeline_size: int) -> np.ndarray:
    """The serial layer index at each position of the interleaved stack:
    stage ``s``'s block holds its chunks ``c = 0 .. vpp-1``, chunk ``c``
    the serial slab ``c*S + s``."""
    L, S, vpp = num_layers, pipeline_size, virtual_pipeline_size
    if L % (S * vpp):
        raise ValueError(f"num_layers ({L}) must divide by pp*vpp "
                         f"({S * vpp})")
    per = L // (S * vpp)
    return np.concatenate(
        [np.arange(per) + (c * S + s) * per for s in range(S)
         for c in range(vpp)])


def _permute(layers: Any, order: np.ndarray) -> Any:
    if isinstance(layers, dict):
        return {k: _permute(v, order) for k, v in layers.items()}
    if isinstance(layers, torch.Tensor):
        return layers[torch.as_tensor(order, device=layers.device)]
    return np.asarray(layers)[order]


def _num_layers(layers: Any) -> int:
    while isinstance(layers, dict):
        layers = next(iter(layers.values()))
    return layers.shape[0]


def interleave_stack(layers: Any, pipeline_size: int,
                     virtual_pipeline_size: int) -> Any:
    """Permute a stacked layer tree (dicts of arrays or tensors, layers on
    the leading dim) so that, cut over ``pipe``, stage ``s``'s local chunk
    ``c`` holds serial layer slab ``c*S + s`` — the interleaved-schedule
    placement (reference parallel_state.py:104-111 + build_model's virtual
    chunks, schedules/common.py:52-65). Training and checkpointing in the
    permuted order is self-consistent; :func:`deinterleave_stack` restores
    serial order."""
    return _permute(layers, interleave_order(
        _num_layers(layers), pipeline_size, virtual_pipeline_size))


def deinterleave_stack(layers: Any, pipeline_size: int,
                       virtual_pipeline_size: int) -> Any:
    return _permute(layers, np.argsort(interleave_order(
        _num_layers(layers), pipeline_size, virtual_pipeline_size)))


def stage_layer_ids(num_layers: int, pipeline_size: int,
                    virtual_pipeline_size: int, stage: int) -> List[int]:
    """The serial indices of stage ``stage``'s layers, in its local order
    (its block of the interleaved stack)."""
    per = num_layers // pipeline_size
    order = interleave_order(num_layers, pipeline_size,
                             virtual_pipeline_size)
    return [int(i) for i in order[stage * per:(stage + 1) * per]]
