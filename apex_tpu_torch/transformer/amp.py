"""Model-parallel-aware grad scaling (port of ``apex_tpu/transformer/
amp.py:31-57``; reference: apex/transformer/amp/grad_scaler.py:8-106).

The reference's ``GradScaler`` all-reduces ``found_inf`` (MAX) over the
model-parallel group so every TP/PP rank takes the same skip decision
(``grad_scaler.py:25-36``). The scaler state machine is
:class:`apex_tpu_torch.amp.LossScaler`; the reduction plugs into
``MixedPrecisionOptimizer.apply_gradients(found_inf_reducer=...)``, which
applies it on the card before the step's one host read of the flag.

``build_zero_train_step`` (the ZeRO-sharded train step, ``amp.py:60``)
comes with ZeRO, ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

from typing import Callable

import torch

from apex_tpu_torch.parallel import collectives
from apex_tpu_torch.parallel.mesh import AXIS_MODEL, AXIS_PIPE, AxisNames


def model_parallel_found_inf_reducer(
    axes: AxisNames = (AXIS_MODEL, AXIS_PIPE),
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The overflow flag OR-reduced over ``axes``: an ``all_reduce`` MAX of
    the 0-d flag as fp32 on their group (``grad_scaler.py:25-36``)."""
    axes_t = (axes,) if isinstance(axes, str) else tuple(axes)

    def reduce(found_inf: torch.Tensor) -> torch.Tensor:
        return collectives.found_inf_max(found_inf, axes_t)

    return reduce


class MeshGradScaler:
    """Pass ``scaler.found_inf_reducer`` to
    ``MixedPrecisionOptimizer.apply_gradients`` (or ``step``) when training
    over model-parallel axes.

    >>> scaler = MeshGradScaler()                     # ('model', 'pipe')
    >>> mp_opt.step(state, model, found_inf_reducer=scaler.found_inf_reducer)
    """

    def __init__(self, axes: AxisNames = (AXIS_MODEL, AXIS_PIPE)):
        self.axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self.found_inf_reducer = model_parallel_found_inf_reducer(self.axes)

