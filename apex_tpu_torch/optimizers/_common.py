"""Shared optimizer plumbing (port of the part of
``apex_tpu/optimizers/_common.py`` that FusedAdam and FusedSGD need).

The JAX optimizers are optax transforms over pytrees; here an optimizer
works on lists of tensors: ``init(params)`` builds its state and
``update_(params, grads, state)`` steps the params IN PLACE.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def tree_zeros_like(params: Sequence[torch.Tensor],
                    dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """fp32 zeros beside every param (the moments' initial state)."""
    return [torch.zeros_like(p, dtype=dtype) for p in params]


def apply_updates_(params: Sequence[torch.Tensor],
                   updates: Sequence[torch.Tensor]) -> None:
    """``p += u`` in place, the update cast to each param's dtype first
    (``cast_like`` then ``optax.apply_updates``)."""
    same = [(p, u) for p, u in zip(params, updates) if p.dtype == u.dtype]
    if same:
        torch._foreach_add_([p for p, _ in same], [u for _, u in same])
    for p, u in zip(params, updates):
        if p.dtype != u.dtype:
            p.add_(u.to(p.dtype))
