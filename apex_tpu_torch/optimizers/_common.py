"""Shared optimizer plumbing (port of the part of
``apex_tpu/optimizers/_common.py`` that the port's optimizers need).

The JAX optimizers are optax transforms over pytrees; here an optimizer
works on lists of tensors: ``init(params)`` builds its state and
``update_(params, grads, state)`` steps the params IN PLACE. The maps over
the tree are ``torch._foreach_*`` passes over the lists.
"""

from __future__ import annotations

from typing import List, Sequence, Union

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


def div_like_scalar(ts: List[torch.Tensor],
                    d: Union[float, torch.Tensor]) -> List[torch.Tensor]:
    """``ts / d``. A float goes to ``torch._foreach_div`` as it is; a
    float64 0-d tensor on the lists' device gives the bits that float would
    give there: on the card PyTorch's division by a Python scalar is a
    product with the fp32 rounding of the scalar's float64 reciprocal, on
    the CPU a true division by its fp32 rounding. So a step count kept on
    the card (``FusedMixedPrecisionLamb``) divides as FusedLAMB's host
    count does."""
    if not isinstance(d, torch.Tensor):
        return torch._foreach_div(ts, d)
    if ts and ts[0].is_cuda:
        return torch._foreach_mul(ts, torch.reciprocal(d).float())
    return torch._foreach_div(ts, d.float())


def lamb_leaf_update(g32: List[torch.Tensor], p32: Sequence[torch.Tensor],
                     m: List[torch.Tensor], v: List[torch.Tensor], *,
                     beta1: float, beta2: float, beta1_grad: float,
                     bc1: Union[float, torch.Tensor],
                     bc2: Union[float, torch.Tensor], eps: float,
                     weight_decay: float, use_nvlamb: bool,
                     sumsq_reduce=None) -> List[torch.Tensor]:
    """The per-leaf LAMB math (``lamb_leaf_update``, ``_common.py:95-136``;
    ``csrc/multi_tensor_lamb.cu`` stages 1 and 2) over every leaf of the
    lists at once, fp32: the moments ``m = beta1 m + beta1_grad g`` and
    ``v = beta2 v + (1 - beta2) g^2`` (updated IN PLACE), ``upd = (m / bc1)
    / (sqrt(v / bc2) + eps) + weight_decay p``, then each leaf's trust
    ratio ``||p|| / ||upd||`` (1 where either norm is 0, and everywhere
    when ``weight_decay == 0`` without ``use_nvlamb``). ``bc1`` / ``bc2``
    are floats or float64 0-d tensors on the lists' device (the sync-free
    ``FusedMixedPrecisionLamb`` keeps its step count there); a tensor
    holding a float's value gives that float's bits
    (:func:`div_like_scalar`). ``sumsq_reduce`` (tensor parallelism) maps
    the stacked per-leaf squared norms of the local shards to those of the
    whole tensors; the norms are then its square roots. Returns the
    trust-scaled updates; the parameter step is ``p - lr * update``."""
    torch._foreach_mul_(m, beta1)
    torch._foreach_add_(m, g32, alpha=beta1_grad)
    torch._foreach_mul_(v, beta2)
    torch._foreach_addcmul_(v, g32, g32, value=1.0 - beta2)
    denom = div_like_scalar(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = div_like_scalar(m, bc1)
    torch._foreach_div_(upd, denom)
    if weight_decay != 0.0:
        torch._foreach_add_(upd, list(p32), alpha=weight_decay)
    if (weight_decay == 0.0 and not use_nvlamb) or not upd:
        return upd
    w_norm = torch.stack(torch._foreach_norm(list(p32)))
    u_norm = torch.stack(torch._foreach_norm(upd))
    if sumsq_reduce is not None:
        w_norm = torch.sqrt(sumsq_reduce(w_norm * w_norm))
        u_norm = torch.sqrt(sumsq_reduce(u_norm * u_norm))
    ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                        torch.ones_like(w_norm))
    torch._foreach_mul_(upd, list(ratio.unbind()))
    return upd
