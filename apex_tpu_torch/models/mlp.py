"""Fused MLP (port of ``apex_tpu/models/mlp.py``).

A chain of ``x @ kernel + bias`` layers, each followed by the activation,
the last one included (the reference kernel's epilogue placement,
``mlp.py:68-75``). The products go to ``torch.matmul`` (cuBLAS on the
card); the reference leaves the chain to XLA and has no Pallas kernel here.
Kernels keep the JAX layout ``(in, out)``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.models.fused_dense import FusedDense

_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
}


class MLP(nn.Module):
    """Drop-in MLP (``apex/mlp/mlp.py:44-79``). ``mlp_sizes`` lists the
    widths including the input, e.g. (480, 1024, 960); ``activation`` is
    'none', 'relu' or 'sigmoid'. Each layer's init is nn.Linear's uniform
    +-1/sqrt(fan_in), from a generator seeded with ``seed``."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu",
                 params_dtype: torch.dtype = torch.float32, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        if len(mlp_sizes) < 2:
            raise ValueError("need at least input and one layer size")
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.mlp_sizes = tuple(mlp_sizes)
        self.activation = activation
        self.layers = nn.ModuleList(
            FusedDense(n_in, n_out, params_dtype, bias=bias, device=dev,
                       generator=gen)
            for n_in, n_out in zip(mlp_sizes[:-1], mlp_sizes[1:]))

    def params_from_numpy(self, params: Sequence[Dict[str, Any]]) -> "MLP":
        """Load the JAX ``init`` list of ``{"kernel"[, "bias"]}`` layers."""
        if len(params) != len(self.layers):
            raise ValueError(f"{len(params)} layers in the tree, "
                             f"{len(self.layers)} in the module")
        for layer, p in zip(self.layers, params):
            layer.params_from_numpy(p)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = _ACTIVATIONS[self.activation]
        for layer in self.layers:
            x = act(layer(x))
        return x
