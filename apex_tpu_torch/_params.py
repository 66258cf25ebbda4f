"""Moving parameter trees between the JAX layout and the port's modules.

:func:`load_tree_` is the one loader of the transformer models (GPT and
BERT, their ``params_from_numpy`` methods): the JAX tree's keys are the
modules' attribute names, and the layer stack (``layers``, each leaf
stacked on a leading ``num_layers`` dim) maps onto the ``nn.ModuleList`` of
per-layer modules. :func:`module_tree` is its inverse, and
:func:`tensors_of_tree` reads a tree back into a list aligned with
``module.parameters()`` (the layout of the optimizer's masters and moments,
``amp.frontend.state_tree``). Together they carry weights and optimizer
state across the two packages' checkpoints (``apex_tpu_torch.checkpoint``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def copy_array_(param: torch.Tensor, arr, name: str) -> None:
    """Copy ``arr`` into ``param`` in place, in ``param``'s dtype and on its
    device. ``arr`` is a tensor (any device and dtype: a bf16 leaf of a
    checkpoint goes into an fp32 param exactly) or an array; an ml_dtypes
    bfloat16 array is read as fp32 first. Shapes must match."""
    if isinstance(arr, torch.Tensor):
        src = arr.detach()
    else:
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        src = torch.from_numpy(np.array(arr))
    if tuple(src.shape) != tuple(param.shape):
        raise ValueError(f"{name}: tree shape {tuple(src.shape)} != module "
                         f"shape {tuple(param.shape)}")
    param.copy_(src.to(param.dtype))


def _slice(tree: Dict[str, Any], i: int, n: int, path: str):
    """Layer ``i`` of a stacked subtree (every leaf ``(n, ...)``)."""
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            out[key] = _slice(sub, i, n, f"{path}.{key}")
            continue
        if not isinstance(sub, torch.Tensor):
            sub = np.asarray(sub)
        if sub.shape[0] != n:
            raise ValueError(f"{path}.{key}: {sub.shape[0]} layers in the "
                             f"tree, {n} in the model")
        out[key] = sub[i]
    return out


@torch.no_grad()
def load_tree_(module: nn.Module, tree: Dict[str, Any],
               prefix: str = "") -> nn.Module:
    """Copy a JAX parameter tree (nested dicts of arrays or tensors) into
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


def _tree_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """``(("layers", "qkv", "kernel"), 3)`` for ``"layers.3.qkv.kernel"``:
    the JAX tree's path of a parameter name and its layer index (None
    outside the layer stack)."""
    parts = name.split(".")
    idx = [j for j, p in enumerate(parts) if p.isdigit()]
    if not idx:
        return tuple(parts), None
    if len(idx) > 1:
        raise ValueError(f"{name}: nested layer stacks have no JAX layout")
    j = idx[0]
    return tuple(parts[:j] + parts[j + 1:]), int(parts[j])


@torch.no_grad()
def module_tree(module: nn.Module,
                tensors: Optional[Sequence[torch.Tensor]] = None,
                device="cpu") -> Dict[str, Any]:
    """The JAX tree of ``module``'s parameters, or of ``tensors`` (a list
    aligned with ``module.parameters()``: masters, Adam moments): nested
    dicts keyed by attribute names, the layer stack stacked on a leading
    dim. The leaves are copies on ``device`` (CPU tensors in their own
    dtypes: numpy has no bfloat16 without ml_dtypes, so a bf16 leaf stays a
    tensor; ``"meta"`` gives the structure alone). The inverse of
    :func:`load_tree_` and :func:`tensors_of_tree`."""
    named = list(module.named_parameters())
    if tensors is None:
        tensors = [p for _, p in named]
    tensors = list(tensors)
    if len(tensors) != len(named):
        raise ValueError(f"{len(tensors)} tensors for {len(named)} "
                         f"parameters")
    tree: Dict[str, Any] = {}
    stacks: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}
    for (name, _), t in zip(named, tensors):
        path, i = _tree_path(name)
        if i is None:
            _set(tree, path, t.detach().to(device, copy=True))
        else:
            stacks.setdefault(path, {})[i] = t.detach()
    for path, by_layer in stacks.items():
        _set(tree, path, torch.stack(
            [by_layer[i].to(device) for i in range(len(by_layer))]))
    return tree


def tensors_of_tree(module: nn.Module, tree: Dict[str, Any]
                    ) -> List[torch.Tensor]:
    """The leaves of a JAX-layout ``tree`` as a list aligned with
    ``module.parameters()`` (a layer's slice of each stacked leaf); a
    missing leaf raises ``KeyError``."""
    out = []
    for name, _ in module.named_parameters():
        path, i = _tree_path(name)
        leaf = tree
        for key in path:
            if not isinstance(leaf, dict) or key not in leaf:
                raise KeyError(f"tree missing leaf {'/'.join(path)!r}")
            leaf = leaf[key]
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.from_numpy(np.asarray(leaf))
        out.append(leaf if i is None else leaf[i])
    return out


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value
