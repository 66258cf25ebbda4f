"""FastLayerNorm (port of ``apex_tpu/contrib/layer_norm.py``).

The same LayerNorm kernels as :func:`apex_tpu_torch.ops.layer_norm` behind
the contrib name, with the reference constructor's hidden-size envelope
(a multiple of 8 in (0, 65536]) kept, so migrating code fails in the same
places. Parameters ``weight`` and ``bias`` as in the JAX tree.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch._params import copy_array_
from apex_tpu_torch.ops.layer_norm import layer_norm


class FastLayerNorm(nn.Module):
    """``FastLayerNorm(hidden_size)``: ``weight`` ones and ``bias`` zeros
    in ``dtype`` (``layer_norm.py:31-53``)."""

    def __init__(self, hidden_size: int, eps: float = 1e-5, *,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        if hidden_size % 8 != 0 or not 0 < hidden_size <= 65536:
            raise ValueError(f"hidden_size {hidden_size} unsupported: must "
                             f"be a multiple of 8 in (0, 65536]")
        dev = resolve_device(device)
        self.hidden_size = hidden_size
        self.epsilon = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, dtype=dtype,
                                              device=dev))
        self.bias = nn.Parameter(torch.zeros(hidden_size, dtype=dtype,
                                             device=dev))

    def params_from_numpy(self, params: Dict[str, Any]) -> "FastLayerNorm":
        """Load the JAX ``init`` tree ``{"weight", "bias"}`` given as numpy
        arrays."""
        copy_array_(self.weight, params["weight"], "weight")
        copy_array_(self.bias, params["bias"], "bias")
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.epsilon)
