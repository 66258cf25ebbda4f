"""FusedNovoGrad (port of ``apex_tpu/optimizers/fused_novograd.py``).

Adam with a layer-wise second moment (``fused_novograd.py:31-114``): ``v``
is ONE fp32 scalar per tensor, the running mean of ``||g||^2``, and the
first step sets it to ``||g||^2`` itself unless ``init_zero``. Per tensor:
``g / (sqrt(v / bc2) + eps)``, plus ``weight_decay * p`` inside the moment
with ``reg_inside_moment``, goes into ``m = beta1 m + beta1_grad (...)``
(``beta1_grad`` is ``1 - beta1`` with ``grad_averaging``, else 1); the
step is ``m / bc1``, plus ``weight_decay * p`` outside the moment without
``reg_inside_moment``. The arithmetic is fp32, in ``torch._foreach_*``
passes over the param list (the reference's update is one XLA
computation, not a Pallas kernel).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.optimizers._common import apply_updates_, tree_zeros_like


class FusedNovoGradState(NamedTuple):
    step: int
    exp_avg: List[torch.Tensor]     # first moment, fp32, one per param
    exp_avg_sq: List[torch.Tensor]  # fp32 0-d: one scalar per param


class FusedNovoGrad:
    """``init(params) -> state``; ``update_(params, grads, state, lr=None)
    -> state`` steps ``params`` in place and returns the new state (the
    moments are updated in place too)."""

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_averaging: bool = True, init_zero: bool = False,
                 reg_inside_moment: bool = False):
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.grad_averaging = grad_averaging
        self.init_zero = init_zero
        self.reg_inside_moment = reg_inside_moment

    def init(self, params: Sequence[torch.Tensor]) -> FusedNovoGradState:
        return FusedNovoGradState(
            0, tree_zeros_like(params),
            [torch.zeros((), dtype=torch.float32, device=p.device)
             for p in params])

    @torch.no_grad()
    def update_(self, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: FusedNovoGradState,
                lr: Optional[float] = None) -> FusedNovoGradState:
        beta1, beta2 = self.betas
        step = state.step + 1
        lr = self.lr if lr is None else lr
        if self.bias_correction:
            bc1 = 1.0 - beta1 ** step
            bc2 = 1.0 - beta2 ** step
        else:
            bc1 = bc2 = 1.0
        wd = self.weight_decay
        g32 = [g.float() for g in grads]
        p32 = [p.float() for p in params]
        if not g32:
            return FusedNovoGradState(step, state.exp_avg, state.exp_avg_sq)
        gsq = torch.stack([torch.sum(g * g) for g in g32])
        v = torch.stack(state.exp_avg_sq)
        if self.init_zero or state.step > 0:
            v = beta2 * v + (1.0 - beta2) * gsq
        else:  # the first step takes ||g||^2 itself (:65-68)
            v = gsq
        torch._foreach_copy_(state.exp_avg_sq, list(v.unbind()))
        denom = torch.sqrt(v / bc2) + self.eps
        gn = torch._foreach_div(g32, list(denom.unbind()))
        if wd != 0.0 and self.reg_inside_moment:
            torch._foreach_add_(gn, p32, alpha=wd)
        m = state.exp_avg
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, gn, alpha=(1.0 - beta1)
                            if self.grad_averaging else 1.0)
        upd = torch._foreach_div(m, bc1)
        if wd != 0.0 and not self.reg_inside_moment:
            torch._foreach_add_(upd, p32, alpha=wd)
        torch._foreach_mul_(upd, -lr)
        apply_updates_(params, upd)
        return FusedNovoGradState(step, m, state.exp_avg_sq)
