"""The ASP class workflow (port of ``apex_tpu/contrib/sparsity/asp.py``,
the counterpart of apex's ``asp.py``).

Class-level state, as in the reference (``asp.py:61-242``)::

    ASP.init_model_for_pruning(model, "m4n2_1d",
                               allowed_layer_names=..., allow_permutation=True)
    opt = ASP.init_optimizer_for_pruning(FusedAdam(lr=...))  # masked updates
    model, masks = ASP.compute_sparse_masks(model)            # enable sparsity
    ... train with opt: updates to pruned slots are zero, so the 2:4
        pattern survives every step ...
    ASP.restore_pruned_weights(model)                         # if recompute

``params`` is a tree of tensors in the JAX layout (the reference's pytree:
it comes back pruned as a new tree, with a mask tree) or an ``nn.Module``
(pruned in place, as apex prunes a torch model; its masks are one per
parameter, aligned with ``module.parameters()``, each in its parameter's
own layout, computed on the module's JAX-layout tree:
:func:`~apex_tpu_torch.contrib.sparsity.jax_layout_tree`). Name filters
match whole components of a parameter's JAX path (``layers/fc1/kernel``).
Call :meth:`ASP.reset` between independent uses.

The optimizer that :meth:`ASP.init_optimizer_for_pruning` returns wraps any
of the port's optimizers (``init(params)`` / ``update_(params, grads,
state, ...)``): the inner step runs on every element (its moments see
every grad, as the reference's inner ``update`` does), then each pruned
slot gets its value from before the step back, which is the reference's
zero update. Under :class:`~apex_tpu_torch.amp.MixedPrecisionOptimizer`
the params it steps are the fp32 masters, so the masters stay masked and
the bf16 params copied from them too. The masks it applies are, in order,
the ``masks=`` argument of ``update_`` (``amp``'s ``apply_gradients`` /
``step`` pass it through) and the class state; either is a list aligned
with the params stepped, or a tree whose leaves (:func:`tree_leaves`) are.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from apex_tpu_torch.contrib import sparsity as _sp
from apex_tpu_torch.contrib.sparsity import permutation as _plib

_PATTERN_RE = re.compile(r"^m(\d+)n(\d+)_1d$")


def _calculator_from_pattern(pattern: str) -> Tuple[Callable, int]:
    """``"m4n2_1d"``-style pattern -> (mask function, group size m)."""
    m = _PATTERN_RE.match(pattern)
    if not m:
        raise ValueError(f"unsupported mask pattern {pattern!r} "
                         "(expected 'm<M>n<N>_1d')")
    mm, nn_ = int(m.group(1)), int(m.group(2))
    if not 0 < nn_ < mm:
        raise ValueError(
            f"pattern {pattern!r}: need 0 < n < m (n=m keeps everything, "
            f"n=0 zeroes everything — neither is structured sparsity)")

    def calc(w):
        return _sp.mn_mask_1d(w, mm, nn_)

    return calc, mm


class _PruningOptimizer:
    """An optimizer whose step leaves every pruned slot as it was."""

    def __init__(self, inner: Any, asp: type):
        self.inner = inner
        self._asp = asp

    def init(self, params):
        return self.inner.init(params)

    @torch.no_grad()
    def update_(self, params, grads, state, masks=None, **kwargs):
        masks = masks if masks is not None else self._asp._masks()
        if masks is None:
            return self.inner.update_(params, grads, state, **kwargs)
        params = list(params)
        masks = _sp.tree_leaves(masks)
        if len(masks) != len(params):
            raise ValueError(f"{len(masks)} masks for {len(params)} params")
        kept = [(p, ~m, p.masked_select(~m)) for p, m in zip(params, masks)
                if m is not None]
        state = self.inner.update_(params, grads, state, **kwargs)
        for p, pruned, old in kept:
            p.masked_scatter_(pruned, old)
        return state


class ASP:
    """Automatic SParsity: the reference's class-level workflow
    (``asp.py:61-242``)."""

    __calculate_mask: Optional[Callable] = None
    __group_size: int = 4  # the pattern's m: drives shape eligibility
    __masks: Any = None
    __allow_permutation: bool = True
    __allowed_names: Optional[Sequence[str]] = None
    __disallowed_names: Sequence[str] = ()
    __pruned_values: Any = None  # dense minus sparse (allow_recompute)
    __allow_recompute: bool = False

    @classmethod
    def init_model_for_pruning(
            cls, params: Any, mask_calculator: Any = "m4n2_1d",
            verbosity: int = 3, whitelist: Any = None,
            allowed_layer_names: Optional[Sequence[str]] = None,
            disallowed_layer_names: Sequence[str] = (),
            allow_recompute_mask: bool = False,
            custom_layer_dict: Optional[Dict] = None,
            allow_permutation: bool = True) -> None:
        """Record the mask calculator (a pattern string or a function) and
        the name filters (``asp.py:39-161``). ``whitelist`` and
        ``custom_layer_dict`` name module types in apex; eligibility here
        is by shape and name, as in the reference."""
        if cls.__calculate_mask is not None:
            raise RuntimeError("ASP has been initialized already.")
        del verbosity, whitelist, custom_layer_dict, params
        if callable(mask_calculator):
            cls.__calculate_mask = mask_calculator
            cls.__group_size = 4
        else:
            cls.__calculate_mask, cls.__group_size = \
                _calculator_from_pattern(mask_calculator)
        cls.__allowed_names = allowed_layer_names
        cls.__disallowed_names = tuple(disallowed_layer_names)
        cls.__allow_recompute = allow_recompute_mask
        cls.__allow_permutation = allow_permutation

    @classmethod
    def already_init_asp_model(cls) -> bool:
        return cls.__calculate_mask is not None

    @classmethod
    def _masks(cls) -> Any:
        return cls.__masks

    @classmethod
    def _eligible(cls, path: str, leaf: Any) -> bool:
        if not _sp.shape_eligible(leaf, cls.__group_size):
            return False
        # whole path components, as the reference's exact layer names:
        # a substring match would make "fc1" cover "fc10"
        segments = set(path.split("/"))
        if cls.__allowed_names is not None and not segments.intersection(
                cls.__allowed_names):
            return False
        return not segments.intersection(cls.__disallowed_names)

    @classmethod
    def compute_sparse_masks(
            cls, params: Any,
            permutation_groups: Optional[Sequence[_plib.ChannelGroup]] = None
    ) -> Tuple[Any, Any]:
        """Compute the masks and zero the pruned weights
        (``asp.py:204-255``): ``(pruned tree, mask tree)`` for a tree, or
        ``(module, masks)`` for a module pruned in place. With
        ``allow_permutation`` and ``permutation_groups`` (a tree only: the
        groups name its flat layers), the channel-permutation search runs
        first."""
        if cls.__calculate_mask is None:
            raise RuntimeError("call init_model_for_pruning first")
        module = params if isinstance(params, nn.Module) else None
        if cls.__allow_permutation and permutation_groups:
            if module is not None:
                raise ValueError(
                    "permutation_groups name the layers of a flat tree: "
                    "permute the tree (search_and_permute), load it into "
                    "the module, then compute the module's masks")
            params, _ = _plib.search_and_permute(params, permutation_groups)
        tree = _sp.jax_layout_tree(module) if module is not None else params
        masks = _sp.tree_map_with_path(
            lambda path, leaf: cls.__calculate_mask(leaf)
            if cls._eligible("/".join(path), leaf) else None, tree)
        if module is None:
            if cls.__allow_recompute:
                cls.__pruned_values = _sp._tree_map(
                    lambda p, m: None if m is None
                    else torch.where(m, torch.zeros_like(p), p), params,
                    masks)
            cls.__masks = masks
            return _sp.apply_masks(params, masks), masks
        masks = _sp.module_masks(module, masks)
        with torch.no_grad():
            if cls.__allow_recompute:
                cls.__pruned_values = [
                    None if m is None
                    else torch.where(m, torch.zeros_like(p), p)
                    for p, m in zip(module.parameters(), masks)]
            for p, m in zip(module.parameters(), masks):
                if m is not None:
                    p.masked_fill_(~m, 0)
        cls.__masks = masks
        return module, masks

    @classmethod
    def init_optimizer_for_pruning(cls, optimizer: Any) -> _PruningOptimizer:
        """Wrap ``optimizer`` so that updates to pruned slots are zero
        (``asp.py:176-202``); compose it inside
        ``amp.MixedPrecisionOptimizer`` so the masters stay masked. Before
        :meth:`compute_sparse_masks` (and with no ``masks=``) it steps
        every slot: sparsity is off until the masks exist."""
        return _PruningOptimizer(optimizer, cls)

    @classmethod
    def restore_pruned_weights(cls, params: Any) -> Any:
        """Disable sparsity: add back the stashed pruned values
        (``asp.py:257-270``; needs ``allow_recompute_mask=True``): a new
        tree, or the module restored in place."""
        if not cls.__allow_recompute or cls.__pruned_values is None:
            raise RuntimeError(
                "restore_pruned_weights needs init_model_for_pruning("
                "allow_recompute_mask=True) and computed masks")
        if isinstance(params, nn.Module):
            with torch.no_grad():
                for p, v in zip(params.parameters(), cls.__pruned_values):
                    if v is not None:
                        p.add_(v.to(p.dtype))
            restored = params
        else:
            restored = _sp._tree_map(
                lambda p, v: p if v is None else p + v.to(p.dtype), params,
                cls.__pruned_values)
        cls.__masks = None
        cls.__pruned_values = None  # a second restore must not re-add
        return restored

    @classmethod
    def is_sparsity_enabled(cls) -> bool:
        return cls.__masks is not None

    @classmethod
    def prune_trained_model(
            cls, params: Any, optimizer: Any,
            permutation_groups: Optional[Sequence[_plib.ChannelGroup]] = None
    ) -> Tuple[Any, Any, _PruningOptimizer]:
        """One call: init, the masked optimizer, the masks
        (``asp.py:293-298``)."""
        cls.init_model_for_pruning(
            params, mask_calculator="m4n2_1d",
            allow_permutation=permutation_groups is not None)
        opt = cls.init_optimizer_for_pruning(optimizer)
        pruned, masks = cls.compute_sparse_masks(params, permutation_groups)
        return pruned, masks, opt

    @classmethod
    def reset(cls) -> None:
        """Clear the class state (the tests do; the reference asserts one
        initialisation a process)."""
        cls.__calculate_mask = None
        cls.__masks = None
        cls.__pruned_values = None
        cls.__allowed_names = None
        cls.__disallowed_names = ()
        cls.__allow_recompute = False
        cls.__allow_permutation = True
