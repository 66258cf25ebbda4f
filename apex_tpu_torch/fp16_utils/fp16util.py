"""Conversion helpers of the legacy API (port of
``apex_tpu/fp16_utils/fp16util.py``).

Each helper takes an ``nn.Module`` (its parameters change IN PLACE, as the
reference's ``network.half()`` does) or a parameter tree: nested dicts,
lists or tuples of tensors, as :func:`apex_tpu_torch._params.module_tree`
gives them (a new tree comes back). Norm parameters are found by the
port's name rule (:func:`apex_tpu_torch.precision.name_is_norm`) on the
qualified parameter name, or on the tree path joined with dots.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch import nn

from apex_tpu_torch.precision import name_is_norm


def _map(fn: Callable[[str, torch.Tensor], Any], tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict / list / tuple of tensors; the
    path joins the keys and indices with dots."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}.{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{path}.{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@torch.no_grad()
def _cast_module(module: nn.Module, dtype_of: Callable) -> nn.Module:
    for name, p in module.named_parameters():
        if p.is_floating_point():
            dtype = dtype_of(name)
            if p.dtype != dtype:
                p.data = p.data.to(dtype)
    return module


def tofp16(params):
    """Every floating parameter in fp16 (``tofp16``, ``fp16util.py:18-23``).
    bf16 through :func:`convert_network` is the usual choice on the card."""
    if isinstance(params, nn.Module):
        return _cast_module(params, lambda name: torch.float16)
    return _map(lambda path, a: a.to(torch.float16)
                if a.is_floating_point() else a, params)


def convert_network(params, dtype: torch.dtype = torch.bfloat16,
                    keep_norms_fp32: bool = True):
    """Cast the floating parameters to ``dtype``, norm parameters fp32 where
    ``keep_norms_fp32`` (``convert_network``, ``fp16util.py:26-34``: the
    reference skips its BatchNorm modules)."""
    def dtype_of(name):
        return torch.float32 if keep_norms_fp32 and name_is_norm(name) \
            else dtype

    if isinstance(params, nn.Module):
        return _cast_module(params, dtype_of)
    return _map(lambda path, a: a.to(dtype_of(path))
                if a.is_floating_point() else a, params)


def prep_param_lists(params) -> Tuple[Any, Any]:
    """``(model_params, master_params)``: the model's parameters (a list for
    a module) and detached fp32 copies of the floating ones, other leaves
    cloned (``prep_param_lists``, ``fp16util.py:37-44``; no flattening)."""
    if isinstance(params, nn.Module):
        params = list(params.parameters())

    def master(path, a):
        a = a.detach()
        return a.to(torch.float32, copy=True) if a.is_floating_point() \
            else a.clone()

    return params, _map(master, params)


def model_grads_to_master_grads(model_grads):
    """fp32 copies of the floating grads (``fp16util.py:47-52``)."""
    return _map(lambda path, g: g.to(torch.float32, copy=True)
                if g.is_floating_point() else g, model_grads)


@torch.no_grad()
def master_params_to_model_params(master_params, model_params):
    """Copy the masters into the model's tensors IN PLACE, in each model
    dtype (``fp16util.py:55-60``); returns ``model_params``."""
    for m, p in zip(_leaves(master_params), _leaves(model_params)):
        p.copy_(m)
    return model_params
