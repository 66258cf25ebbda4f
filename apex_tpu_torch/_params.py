"""Loading a JAX parameter tree, given as numpy arrays, into the port's
modules (the ``params_from_numpy`` methods).

:func:`load_tree_` is the one loader of the transformer models (GPT and
BERT): the JAX tree's keys are the modules' attribute names, and the layer
stack (``layers``, each leaf stacked on a leading ``num_layers`` dim) maps
onto the ``nn.ModuleList`` of per-layer modules.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def copy_array_(param: torch.Tensor, arr, name: str) -> None:
    """Copy ``arr`` into ``param`` in place, in ``param``'s dtype and on its
    device. ``arr`` may be an ml_dtypes bfloat16 array (torch reads it as
    fp32 first). Shapes must match."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{name}: tree shape {tuple(arr.shape)} != module "
                         f"shape {tuple(param.shape)}")
    param.copy_(torch.from_numpy(np.array(arr)).to(param.dtype))


def _slice(tree: Dict[str, Any], i: int, n: int, path: str):
    """Layer ``i`` of a stacked subtree (every leaf ``(n, ...)``)."""
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            out[key] = _slice(sub, i, n, f"{path}.{key}")
            continue
        sub = np.asarray(sub)
        if sub.shape[0] != n:
            raise ValueError(f"{path}.{key}: {sub.shape[0]} layers in the "
                             f"tree, {n} in the model")
        out[key] = sub[i]
    return out


@torch.no_grad()
def load_tree_(module: nn.Module, tree: Dict[str, Any],
               prefix: str = "") -> nn.Module:
    """Copy a JAX parameter tree (nested dicts of numpy arrays) into
    ``module`` by name: a key names a parameter or a submodule; under an
    ``nn.ModuleList`` (the layer stack) every leaf is stacked on a leading
    dim, one slice per module. Shapes must match; a key the module lacks
    raises. Returns the module."""
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        target = getattr(module, key, None)
        if target is None:
            raise ValueError(f"{path}: the model has no such parameter")
        if isinstance(target, nn.ModuleList):
            for i, layer in enumerate(target):
                load_tree_(layer, _slice(sub, i, len(target), path),
                           f"{path}.{i}.")
        elif isinstance(sub, dict):
            load_tree_(target, sub, f"{path}.")
        else:
            copy_array_(target, sub, path)
    return module
