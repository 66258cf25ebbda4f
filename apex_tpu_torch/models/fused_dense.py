"""Fused dense layers (port of ``apex_tpu/models/fused_dense.py``).

``FusedDense`` is GEMM + bias; ``FusedDenseGeluDense`` is GEMM + bias +
GeLU + GEMM + bias. The reference leaves the epilogues to XLA's fusion; the
port leaves the products to ``torch.matmul`` (cuBLAS on the card) and runs
the bias and GeLU as PyTorch elementwise ops. No Pallas kernel stands
behind these layers, so none is written here.

Layout: the kernels keep the JAX tree's ``(in_features, out_features)``
and apply as ``x @ kernel``, so a JAX tree loads leaf for leaf. Params are
cast to the input's dtype at use. The GeLU is the tanh approximation,
``jax.nn.gelu``'s default (``F.gelu(approximate="tanh")``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch._params import copy_array_
from apex_tpu_torch.transformer.tensor_parallel.layers import cast_param


class FusedDense(nn.Module):
    """GEMM + bias (``fused_dense.py:6-35``). Init as the reference's
    ``_linear_init``: kernel and bias uniform in +-1/sqrt(in_features),
    drawn from ``generator`` (or a generator seeded with ``seed``); the
    numbers differ from JAX's, so parity runs load the JAX tree with
    :meth:`params_from_numpy`. ``bias=False`` (the MLP's option) drops the
    bias."""

    def __init__(self, in_features: int, out_features: int,
                 params_dtype: torch.dtype = torch.float32, *,
                 bias: bool = True, device: DeviceLike = None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(int(seed))
        bound = in_features ** -0.5
        self.kernel = nn.Parameter(torch.empty(
            in_features, out_features, dtype=params_dtype, device=dev))
        self.bias = None
        with torch.no_grad():
            self.kernel.uniform_(-bound, bound, generator=generator)
            if bias:
                self.bias = nn.Parameter(torch.empty(
                    out_features, dtype=params_dtype, device=dev))
                self.bias.uniform_(-bound, bound, generator=generator)

    def params_from_numpy(self, params: Dict[str, Any]) -> "FusedDense":
        """Load the JAX tree ``{"kernel", "bias"}`` (numpy arrays)."""
        copy_array_(self.kernel, params["kernel"], "kernel")
        if self.bias is not None:
            copy_array_(self.bias, params["bias"], "bias")
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ cast_param(self.kernel, x.dtype)
        if self.bias is not None:
            y = y + cast_param(self.bias, x.dtype)
        return y


class FusedDenseGeluDense(nn.Module):
    """GEMM + bias + GeLU (tanh) + GEMM + bias (``fused_dense.py:38-85``),
    parameters ``dense1`` and ``dense2``."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int,
                 params_dtype: torch.dtype = torch.float32, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.dense1 = FusedDense(in_features, intermediate_features,
                                 params_dtype, device=dev, generator=gen)
        self.dense2 = FusedDense(intermediate_features, out_features,
                                 params_dtype, device=dev, generator=gen)

    def params_from_numpy(self, params: Dict[str, Any]
                          ) -> "FusedDenseGeluDense":
        """Load the JAX tree ``{"dense1": {...}, "dense2": {...}}``."""
        self.dense1.params_from_numpy(params["dense1"])
        self.dense2.params_from_numpy(params["dense2"])
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense2(F.gelu(self.dense1(x), approximate="tanh"))
