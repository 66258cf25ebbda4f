"""LARC, layer-wise adaptive rate control (port of
``apex_tpu/optimizers/larc.py``).

A wrapper around any of the port's optimizers (``init`` / ``update_``):
before the inner step each param's gradient is rescaled by the adaptive
rate ``trust_coefficient * ||p|| / (||g|| + weight_decay * ||p|| + eps)``
(``larc.py:21-99``; ``weight_decay * p`` joins the gradient first). With
``clip`` the rate is divided by the learning rate that is live this step
(the ``lr=`` of ``update_``, else the base lr) and capped at 1; without it
the rate multiplies the gradient. A param whose norm or gradient norm is 0
keeps its gradient untouched. The norms and the arithmetic are fp32.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch


class LARC:
    """``LARC(optimizer, ...)``: the base lr defaults to ``optimizer.lr``
    (so ``LARC(LARC(FusedSGD(lr=0.3))).lr == 0.3``); ``init`` is the inner
    optimizer's, ``update_(params, grads, state, lr=None, **extra)``
    rescales the grads and steps the inner optimizer with the same ``lr``
    and ``extra``. Clip mode without a base lr raises ``ValueError``."""

    def __init__(self, optimizer, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8,
                 weight_decay: float = 0.0, base_lr: Optional[float] = None):
        if base_lr is None:
            base_lr = getattr(optimizer, "lr", None)
        if clip and base_lr is None:
            raise ValueError(
                "LARC(clip=True) needs base_lr (the inner optimizer's "
                "learning rate) to form min(adaptive_lr / lr, 1); pass "
                "base_lr= or wrap an optimizer that has an lr")
        self.inner = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps
        self.weight_decay = weight_decay
        self.lr = base_lr

    def init(self, params: Sequence[torch.Tensor]) -> Any:
        return self.inner.init(params)

    @torch.no_grad()
    def rescale(self, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], lr: Optional[float] = None):
        """The rescaled grads, each in its own dtype (``larc.py:58-71``)."""
        lr = self.lr if lr is None else lr
        wd = self.weight_decay
        g32 = [g.float() for g in grads]
        p32 = [p.float() for p in params]
        if not g32:
            return []
        pnorm = torch.stack(torch._foreach_norm(p32))
        gnorm = torch.stack(torch._foreach_norm(g32))
        rate = self.trust_coefficient * pnorm / (gnorm + wd * pnorm
                                                 + self.eps)
        if self.clip:
            rate = torch.clamp(rate / lr, max=1.0)
        active = (pnorm > 0) & (gnorm > 0)
        scaled = torch._foreach_add(g32, p32, alpha=wd) if wd != 0.0 \
            else [g.clone() for g in g32]
        torch._foreach_mul_(scaled, list(rate.unbind()))
        return [torch.where(a, s, g32_).to(g.dtype) for a, s, g32_, g in
                zip(active.unbind(), scaled, g32, grads)]

    def update_(self, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: Any,
                lr: Optional[float] = None, **extra) -> Any:
        return self.inner.update_(params, self.rescale(params, grads, lr),
                                  state, lr=lr, **extra)


def larc(inner, trust_coefficient: float = 0.02, clip: bool = True,
         eps: float = 1e-8, weight_decay: float = 0.0,
         base_lr: Optional[float] = None) -> LARC:
    """The reference's function spelling (``larc.py:21-79``): ``base_lr``
    is not read from ``inner``, so ``larc(opt, clip=True)`` without it
    raises ``ValueError``; the :class:`LARC` class reads it."""
    if clip and base_lr is None:
        raise ValueError(
            "larc(clip=True) needs base_lr (the inner optimizer's learning "
            "rate) to form min(adaptive_lr / lr, 1); pass base_lr= or use "
            "the LARC class")
    return LARC(inner, trust_coefficient=trust_coefficient, clip=clip,
                eps=eps, weight_decay=weight_decay, base_lr=base_lr)
