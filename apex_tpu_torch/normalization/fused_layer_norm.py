"""Fused normalization modules (port of
``apex_tpu/normalization/fused_layer_norm.py``).

The reference normalizes over a trailing ``normalized_shape`` tuple; the
kernels normalize over one trailing dim, so inputs are flattened to
``(..., prod(normalized_shape))`` and restored, and a trailing shape that
does not match raises ``ValueError``. Everything goes through
:func:`apex_tpu_torch.ops.layer_norm` / :func:`~apex_tpu_torch.ops.rms_norm`:
the LayerNorm kernels (forward and backward) on CUDA tensors, their plain
versions on CPU ones. Parameters default to fp32 whatever the input dtype
(the MixedFused contract), under the reference's names ``scale`` and
``bias``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple, Union

import torch
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch._params import copy_array_
from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm

Shape = Union[int, Sequence[int]]


def _canon_shape(normalized_shape: Shape) -> Tuple[int, ...]:
    if isinstance(normalized_shape, int):
        return (normalized_shape,)
    return tuple(int(s) for s in normalized_shape)


def _flatten(x: torch.Tensor, nshape: Tuple[int, ...]):
    n = 1
    for s in nshape:
        n *= s
    if tuple(x.shape[-len(nshape):]) != nshape:
        raise ValueError(f"input trailing dims {tuple(x.shape[-len(nshape):])}"
                         f" != normalized_shape {nshape}")
    return x.reshape(x.shape[:-len(nshape)] + (n,)), x.shape


def fused_layer_norm_affine(x, weight, bias, normalized_shape: Shape,
                            eps: float = 1e-5) -> torch.Tensor:
    x2, orig = _flatten(x, _canon_shape(normalized_shape))
    return layer_norm(x2, weight.reshape(-1), bias.reshape(-1),
                      eps).reshape(orig)


def fused_layer_norm(x, normalized_shape: Shape,
                     eps: float = 1e-5) -> torch.Tensor:
    x2, orig = _flatten(x, _canon_shape(normalized_shape))
    return layer_norm(x2, None, None, eps).reshape(orig)


def fused_rms_norm_affine(x, weight, normalized_shape: Shape,
                          eps: float = 1e-5) -> torch.Tensor:
    x2, orig = _flatten(x, _canon_shape(normalized_shape))
    return rms_norm(x2, weight.reshape(-1), eps).reshape(orig)


def fused_rms_norm(x, normalized_shape: Shape,
                   eps: float = 1e-5) -> torch.Tensor:
    x2, orig = _flatten(x, _canon_shape(normalized_shape))
    return rms_norm(x2, None, eps).reshape(orig)


class _Norm(nn.Module):
    has_bias = True

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.normalized_shape = _canon_shape(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.scale = self.bias = None
        if elementwise_affine:
            self.scale = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype, device=dev))
            if self.has_bias:
                self.bias = nn.Parameter(torch.zeros(
                    self.normalized_shape, dtype=param_dtype, device=dev))

    def params_from_numpy(self, variables: Dict[str, Any]):
        """Load the flax module's ``{"params": {"scale", "bias"}}`` tree
        given as numpy arrays."""
        params = variables["params"]
        for name in ("scale", "bias"):
            param = getattr(self, name)
            if param is not None:
                copy_array_(param, params[name], name)
        return self


class FusedLayerNorm(_Norm):
    """Drop-in FusedLayerNorm (``fused_layer_norm.py:204-297``); with half
    inputs and the default fp32 params this is the MixedFused variant."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.elementwise_affine:
            return fused_layer_norm_affine(x, self.scale, self.bias,
                                           self.normalized_shape, self.eps)
        return fused_layer_norm(x, self.normalized_shape, self.eps)


class FusedRMSNorm(_Norm):
    """Drop-in FusedRMSNorm (``fused_layer_norm.py:300-396``): ``scale``
    only."""

    has_bias = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.elementwise_affine:
            return fused_rms_norm_affine(x, self.scale, self.normalized_shape,
                                         self.eps)
        return fused_rms_norm(x, self.normalized_shape, self.eps)


# The Mixed variants differ from the base ones only in fp32 affine params
# with half activations, the default here; the aliases keep the reference's
# import surface.
MixedFusedLayerNorm = FusedLayerNorm
MixedFusedRMSNorm = FusedRMSNorm
