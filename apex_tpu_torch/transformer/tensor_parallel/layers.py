"""Tensor-parallel layers, serial half (port of
``apex_tpu/transformer/tensor_parallel/layers.py``).

Parameters keep the JAX tree's names and layouts -- ``kernel`` is
``(in_features, out_features)`` with ``y = x @ kernel + bias`` -- so a JAX
parameter tree loads leaf for leaf. Tensor parallelism (an ``axis``) is a
later slice of the port: these layers raise if given one.

Initializers take an explicit ``torch.Generator``: the JAX and torch
generators give different numbers from one seed, so parity tests load the
JAX tree instead of re-drawing it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


def _no_axis(axis, layer: str) -> None:
    if axis is not None:
        raise NotImplementedError(
            f"{layer}(axis={axis!r}): tensor parallelism is a later slice of "
            f"the port (ROADMAP Queue 1 item 10); build the layer serial "
            f"(axis=None)")


def scaled_normal(sigma: float) -> Callable:
    """Megatron's ``init.normal_(std=sigma)``: ``init(tensor, generator)``
    fills ``tensor`` in place."""

    def init(tensor: torch.Tensor, generator: Optional[torch.Generator]):
        with torch.no_grad():
            return tensor.normal_(0.0, sigma, generator=generator)

    return init


def cast_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p.to(dtype)``, computed once per parameter version outside autograd.

    The reference casts each weight to the compute dtype at every use
    (``_transformer.py:382-383``); the numbers are the same, so inference
    keeps the cast beside the parameter and redoes it only when the
    parameter is written (its ``_version`` moves)."""
    if p.dtype == dtype:
        return p
    if torch.is_grad_enabled() and p.requires_grad:
        return p.to(dtype)
    key = (dtype, p._version, p.device)
    cached = getattr(p, "_apex_cast", None)
    if cached is None or cached[0] != key:
        cached = (key, p.detach().to(dtype))
        p._apex_cast = cached
    return cached[1]


class ColumnParallelLinear(nn.Module):
    """``Y = XA + b`` with ``A`` ``(in, out)`` (serial: the whole matrix)."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, axis: Optional[str] = None,
                 params_dtype: torch.dtype = torch.float32,
                 init_method: Optional[Callable] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        _no_axis(axis, type(self).__name__)
        self.kernel = nn.Parameter(torch.empty(
            in_features, out_features, dtype=params_dtype, device=device))
        (init_method or scaled_normal(0.02))(self.kernel, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=params_dtype,
                                              device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ cast_param(self.kernel, x.dtype)
        if self.bias is not None:
            y = y + cast_param(self.bias, y.dtype)
        return y


class RowParallelLinear(ColumnParallelLinear):
    """``Y = XA + b`` with ``A`` split row-wise under TP (serial here: the
    same product; the bias is added once, after the would-be reduce)."""


class VocabParallelEmbedding(nn.Module):
    """Token embedding table ``(vocab, hidden)`` (serial: a lookup)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 axis: Optional[str] = None,
                 params_dtype: torch.dtype = torch.float32,
                 init_method: Optional[Callable] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        _no_axis(axis, type(self).__name__)
        self.embedding = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, dtype=params_dtype, device=device))
        (init_method or scaled_normal(0.02))(self.embedding, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]
