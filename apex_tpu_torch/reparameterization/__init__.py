"""Weight-norm reparameterization (port of
``apex_tpu/reparameterization/__init__.py``).

A weight ``w`` becomes the pair ``{"v": w, "g": ||w||}`` with ``w = g * v /
||v||``, the norm taken over every dim but ``dim`` and computed in fp32
whatever the weights' dtype (the reference's fp16-safe norm), then cast
back. The functions work on the nested dict of tensors that
:func:`apex_tpu_torch._params.module_tree` gives (or any nested dict of
tensors) and return new trees: :func:`apply_weight_norm` splits the
matching leaves, :func:`materialize_weight_norm` rebuilds dense weights
before a forward pass, and gradients reach ``v`` and ``g`` through it.
``torch.nn.utils.weight_norm`` is not used: it hooks modules, and these
are trees.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

_WN_KEYS = ("v", "g")


def _other_dims(t: torch.Tensor, dim: int) -> Tuple[int, ...]:
    return tuple(d for d in range(t.ndim) if d != dim)


def weight_norm(v: torch.Tensor, g: torch.Tensor,
                dim: int = 0) -> torch.Tensor:
    """``g * v / ||v||`` in fp32, cast back to ``v``'s dtype
    (``__init__.py:23-30``)."""
    v32 = v.float()
    norm = torch.sqrt(torch.sum(v32 * v32, dim=_other_dims(v, dim),
                                keepdim=True))
    return (g.float().reshape(norm.shape) * v32 / norm).to(v.dtype)


def norm_along(w: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The fp32 norm of ``w`` over every dim but ``dim``
    (``__init__.py:33-36``)."""
    w32 = w.float()
    return torch.sqrt(torch.sum(w32 * w32, dim=_other_dims(w, dim)))


def _default_match(path: Tuple[Any, ...], leaf: torch.Tensor) -> bool:
    """A leaf of >= 2 dims whose nearest key names a weight or a kernel
    (``__init__.py:39-49``)."""
    name = next((str(k) for k in reversed(path) if isinstance(k, str)), "")
    return leaf.ndim >= 2 and ("weight" in name or "kernel" in name)


def _map_leaves(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def apply_weight_norm(params: Any, match: Optional[Callable] = None,
                      dim: int = 0) -> Any:
    """Each leaf ``match(path, leaf)`` takes becomes ``{"v": w, "g":
    norm_along(w, dim)}`` (``g`` fp32; ``__init__.py:52-69``). ``path`` is
    the tuple of keys (and list indices) from the root."""
    match = match or _default_match

    def convert(path, leaf):
        if isinstance(leaf, torch.Tensor) and match(path, leaf):
            return {"v": leaf, "g": norm_along(leaf, dim)}
        return leaf

    return _map_leaves(convert, params)


def _is_wn_pair(x) -> bool:
    return isinstance(x, dict) and set(x) == set(_WN_KEYS)


def materialize_weight_norm(params: Any, dim: int = 0) -> Any:
    """Dense weights rebuilt from the ``(v, g)`` pairs
    (``__init__.py:76-85``): run it on entry to the forward pass."""
    if _is_wn_pair(params):
        return weight_norm(params["v"], params["g"], dim)
    if isinstance(params, dict):
        return {k: materialize_weight_norm(v, dim) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(materialize_weight_norm(v, dim) for v in params)
    return params


def remove_weight_norm(params: Any, dim: int = 0) -> Any:
    """Collapse the pairs back to plain weights (``__init__.py:88-91``)."""
    return materialize_weight_norm(params, dim)
