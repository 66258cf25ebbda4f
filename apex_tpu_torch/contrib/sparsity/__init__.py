"""ASP, automatic 2:4 structured sparsity (port of
``apex_tpu/contrib/sparsity/__init__.py``, the counterpart of apex's
``sparse_masklib.py``).

Per weight, a magnitude mask keeps ``n`` of every ``m`` contiguous elements
along the contraction dim (2 of 4 for the default ``m4n2_1d``); pruning
zeroes the rest, and the optimizer keeps them zero
(:class:`~apex_tpu_torch.contrib.sparsity.asp.ASP`)::

    masks = compute_sparse_masks(tree)      # once, after pretraining
    tree = apply_masks(tree, masks)

A tree is nested dicts (or lists) of tensors in the JAX package's layout
(``(in, out)`` kernels, HWIO convs, a transformer's layers stacked on a
leading dim), None-free; a mask tree has the same structure, with None for
a leaf that is not pruned. The mask axis is -2 of that layout, the
contraction dim. A module's parameters need not keep that layout (a torch
conv weight is OIHW, where -2 is kh): :func:`jax_layout_tree` gives a
module's tree in the JAX layout and :func:`module_masks` takes a mask tree
back to one mask per parameter, in the parameter's own layout, so that
eligibility and masks follow the JAX layout.

Ranks within a group come from a **stable** sort (``torch.argsort(...,
stable=True)``, as ``jnp.argsort`` is stable): bf16 weights tie within
groups of 4, and an unstable sort would keep other survivors.

The channel-permutation search lives in
:mod:`apex_tpu_torch.contrib.sparsity.permutation`; :class:`ASP` loads
lazily (``from apex_tpu_torch.contrib.sparsity import ASP``). Masked
weights stay dense: the port computes no sparse product.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch._params import _tree_path
from apex_tpu_torch.contrib.sparsity.permutation import (  # noqa: F401
    ChannelGroup,
    apply_channel_permutation,
    magnitude_after_mask,
    search_and_permute,
    search_for_good_permutation,
    sequential_groups,
    sum_after_2_to_4,
)

Path = Tuple[str, ...]


def __getattr__(name):
    if name == "ASP":
        from apex_tpu_torch.contrib.sparsity.asp import ASP

        return ASP
    raise AttributeError(name)


# -- trees ------------------------------------------------------------------

def tree_map_with_path(fn: Callable, tree: Any, path: Path = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (a path is
    the tuple of its keys as strings); None is a leaf."""
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree in order (dicts in insertion order), None
    included: a mask tree's leaves line up with its params tree's."""
    out: List[Any] = []
    tree_map_with_path(lambda _, leaf: out.append(leaf), tree)
    return out


def _tree_map(fn: Callable, tree: Any, other: Any) -> Any:
    """``fn(a, b)`` over two trees of one structure (the first's)."""
    leaves = iter(tree_leaves(other))
    return tree_map_with_path(lambda _, a: fn(a, next(leaves)), tree)


# -- masks ------------------------------------------------------------------

def mn_mask_1d(w: torch.Tensor, m: int, n: int, axis: int = -2
               ) -> torch.Tensor:
    """n-of-m magnitude mask along ``axis`` (``mn_1d_best``): in every
    aligned group of ``m`` elements keep the ``n`` largest, ties to the
    later element (a stable ascending sort)."""
    axis = axis % w.dim()
    if w.shape[axis] % m:
        raise ValueError(f"dim {axis} of size {w.shape[axis]} not "
                         f"divisible by {m}")
    wm = w.detach().movedim(axis, -1)
    groups = wm.abs().reshape(*wm.shape[:-1], -1, m)
    order = torch.argsort(groups, dim=-1, stable=True)  # ascending
    ranks = torch.argsort(order, dim=-1, stable=True)
    mask = (ranks >= m - n).reshape(wm.shape)
    return mask.movedim(-1, axis)


def m4n2_mask_1d(w: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """2-of-4 magnitude mask along ``axis`` (``m4n2_1d``). The default
    -2 is the contraction dim of the JAX layout's ``(in, out)`` kernels,
    the dim apex prunes (a torch ``(out, in)`` weight along dim 1)."""
    return mn_mask_1d(w, 4, 2, axis=axis)


def shape_eligible(leaf: Any, m: int = 4) -> bool:
    """A floating tensor of rank 2 or more whose dim -2 divides by the
    pattern's group size ``m``."""
    return (isinstance(leaf, torch.Tensor) and leaf.dim() >= 2
            and leaf.shape[-2] % m == 0 and leaf.is_floating_point())


def _default_allow(path: Path, leaf: Any) -> bool:
    return shape_eligible(leaf)


def compute_sparse_masks(params: Any, allow: Optional[Callable] = None
                         ) -> Any:
    """Mask tree: a 2:4 mask for each leaf ``allow(path, leaf)`` admits
    (default: :func:`shape_eligible`), None elsewhere
    (``compute_sparse_masks``). Masks lie on their leaves' devices."""
    allow = allow or _default_allow
    return tree_map_with_path(
        lambda path, leaf: m4n2_mask_1d(leaf) if allow(path, leaf)
        else None, params)


def apply_masks(params: Any, masks: Any) -> Any:
    """A new tree with masked-out weights zeroed (the re-mask after an
    update)."""
    return _tree_map(lambda p, m: p if m is None
                     else torch.where(m, p, torch.zeros_like(p)),
                     params, masks)


def sparsity_ratio(params: Any, masks: Any) -> float:
    """Fraction of weights pruned across the masked leaves (a reporting
    helper: one read to the host)."""
    masks = [m for m in tree_leaves(masks) if m is not None]
    total = sum(m.numel() for m in masks)
    if not total:
        return 0.0
    pruned = torch.stack([(~m).sum().to("cpu", torch.float64)
                          for m in masks]).sum()
    return float(pruned) / total


# -- modules ----------------------------------------------------------------

def _layouts(module: nn.Module):
    """``(param, JAX path, layer index or None, dims)`` of each parameter:
    ``param.permute(dims)`` is its JAX layout (None: as it is). The
    ResNet's convs keep OIHW (HWIO in JAX) and its classifier ``(out,
    in)`` (``kernel`` ``(in, out)``); every other module of the port keeps
    the JAX layout."""
    from apex_tpu_torch.models.resnet import Conv, Dense

    owners = dict(module.named_modules())
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        dims = None
        if isinstance(owners[owner], Conv):
            dims, leaf = (2, 3, 1, 0), "kernel"
        elif isinstance(owners[owner], Dense) and leaf == "weight":
            dims, leaf = (1, 0), "kernel"
        path, i = _tree_path(f"{owner}.{leaf}" if owner else leaf)
        yield p, path, i, dims


def jax_layout_tree(module: nn.Module) -> Dict[str, Any]:
    """The module's parameters as a tree in the JAX layout, on their
    device: permuted views, and the layer stack stacked on a leading dim
    (a copy). Read-only: pruning a module goes through
    :func:`module_masks`."""
    tree: Dict[str, Any] = {}
    stacks: Dict[Path, Dict[int, torch.Tensor]] = {}
    for p, path, i, dims in _layouts(module):
        view = p.detach() if dims is None else p.detach().permute(dims)
        if i is None:
            _set(tree, path, view)
        else:
            stacks.setdefault(path, {})[i] = view
    for path, by_layer in stacks.items():
        _set(tree, path, torch.stack([by_layer[i]
                                      for i in range(len(by_layer))]))
    return tree


def module_masks(module: nn.Module, masks: Any
                 ) -> List[Optional[torch.Tensor]]:
    """One mask per parameter of ``module`` (aligned with
    ``module.parameters()``, each in its parameter's own layout, None where
    unmasked) from a mask tree of :func:`jax_layout_tree`'s structure."""
    out: List[Optional[torch.Tensor]] = []
    for p, path, i, dims in _layouts(module):
        m = masks
        for key in path:
            m = m[key]
        if m is not None:
            m = m if i is None else m[i]
            if dims is not None:
                m = m.permute([dims.index(j) for j in range(len(dims))])
            if m.shape != p.shape:
                raise ValueError(f"mask of {'/'.join(path)}: shape "
                                 f"{tuple(m.shape)} != {tuple(p.shape)}")
        out.append(m)
    return out


def _set(tree: Dict[str, Any], path: Path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value
