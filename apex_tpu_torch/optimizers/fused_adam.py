"""FusedAdam (port of ``apex_tpu/optimizers/fused_adam.py``).

Adam/AdamW with apex's knobs (``fused_adam.py:31-108``): bias correction,
``adam_w_mode`` (decoupled weight decay; False puts L2 into the gradient),
``weight_decay``; ``amsgrad`` raises. The moments are fp32 and the update
arithmetic fp32, applied with ``torch._foreach_*`` over the param list (the
reference's update is one XLA computation, not a Pallas kernel). Under amp
O2 the params it steps are the fp32 masters.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.optimizers._common import apply_updates_, tree_zeros_like


class FusedAdamState(NamedTuple):
    step: int
    exp_avg: List[torch.Tensor]     # first moment, fp32
    exp_avg_sq: List[torch.Tensor]  # second moment, fp32


class FusedAdam:
    """``init(params) -> state``; ``update_(params, grads, state, lr=None)
    -> state`` steps ``params`` in place and returns the new state (the
    moment tensors are updated in place too); ``updates(...)`` returns the
    fp32 updates with the new state and leaves ``params`` as they are
    (optax's ``update``, which ``optimizers.distributed`` gathers)."""

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, adam_w_mode: bool = True,
                 weight_decay: float = 0.0, amsgrad: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> FusedAdamState:
        return FusedAdamState(0, tree_zeros_like(params),
                              tree_zeros_like(params))

    @torch.no_grad()
    def update_(self, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: FusedAdamState,
                lr: Optional[float] = None) -> FusedAdamState:
        upd, state = self.updates(params, grads, state, lr)
        apply_updates_(params, upd)
        return state

    @torch.no_grad()
    def updates(self, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: FusedAdamState,
                lr: Optional[float] = None
                ) -> Tuple[List[torch.Tensor], FusedAdamState]:
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
        if not self.adam_w_mode and wd != 0.0:
            g32 = torch._foreach_add(g32, p32, alpha=wd)
        m, v = state.exp_avg, state.exp_avg_sq
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, g32, alpha=1.0 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, g32, g32, value=1.0 - beta2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -lr)
        if self.adam_w_mode and wd != 0.0:
            torch._foreach_add_(upd, p32, alpha=-lr * wd)
        return upd, FusedAdamState(step, m, v)
