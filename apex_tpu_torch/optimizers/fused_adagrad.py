"""FusedAdagrad (port of ``apex_tpu/optimizers/fused_adagrad.py``).

Adagrad as ``fused_adagrad.py:29-67`` computes it: ``h += g^2``, then
``p -= lr * g / (sqrt(h) + eps)``; weight decay goes into the gradient
(L2), or with ``adagrad_w_mode`` is applied beside the step, decoupled
(``p -= lr * weight_decay * p``). The sums of squares are fp32 and the
arithmetic fp32, in ``torch._foreach_*`` passes over the param list (the
reference's update is one XLA computation, not a Pallas kernel).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from apex_tpu_torch.optimizers._common import apply_updates_, tree_zeros_like


class FusedAdagradState(NamedTuple):
    step: int
    sum_sq: List[torch.Tensor]  # fp32, one per param


class FusedAdagrad:
    """``init(params) -> state``; ``update_(params, grads, state, lr=None)
    -> state`` steps ``params`` in place and returns the new state (the sums
    of squares are updated in place too)."""

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, adagrad_w_mode: bool = False):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.adagrad_w_mode = adagrad_w_mode

    def init(self, params: Sequence[torch.Tensor]) -> FusedAdagradState:
        return FusedAdagradState(0, tree_zeros_like(params))

    @torch.no_grad()
    def update_(self, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: FusedAdagradState,
                lr: Optional[float] = None) -> FusedAdagradState:
        lr = self.lr if lr is None else lr
        wd = self.weight_decay
        g32 = [g.float() for g in grads]
        p32 = [p.float() for p in params]
        if wd != 0.0 and not self.adagrad_w_mode:
            g32 = torch._foreach_add(g32, p32, alpha=wd)
        h = state.sum_sq
        torch._foreach_addcmul_(h, g32, g32)
        denom = torch._foreach_sqrt(h)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_mul(g32, -lr)
        torch._foreach_div_(upd, denom)
        if wd != 0.0 and self.adagrad_w_mode:
            torch._foreach_add_(upd, p32, alpha=-lr * wd)
        apply_updates_(params, upd)
        return FusedAdagradState(state.step + 1, h)
