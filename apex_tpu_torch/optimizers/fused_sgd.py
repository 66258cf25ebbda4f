"""FusedSGD (port of ``apex_tpu/optimizers/fused_sgd.py``).

SGD with momentum, dampening, Nesterov and weight decay before or after the
momentum (``wd_after_momentum``), as ``fused_sgd.py:32-101``: the first
step's momentum buffer is the (decayed) gradient itself, as apex's
``first_run`` flag sets it; Nesterov needs a momentum and no dampening.
Weight decay applies to every param, norms included, as in the reference.
The buffers are fp32 and the update arithmetic fp32, applied with
``torch._foreach_*`` over the param list (the reference's update is one
XLA computation, not a Pallas kernel). Under amp O2 the params it steps are
the fp32 masters.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.optimizers._common import apply_updates_, tree_zeros_like


class FusedSGDState(NamedTuple):
    step: int
    momentum_buf: List[torch.Tensor]  # fp32, one per param


class FusedSGD:
    """``init(params) -> state``; ``update_(params, grads, state, lr=None)
    -> state`` steps ``params`` in place and returns the new state (the
    momentum buffers are updated in place too); ``updates(...)`` returns
    the updates and the new state instead."""

    def __init__(self, lr: float = 1e-3, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, wd_after_momentum: bool = False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        self.lr = lr
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.wd_after_momentum = wd_after_momentum

    def init(self, params: Sequence[torch.Tensor]) -> FusedSGDState:
        return FusedSGDState(0, tree_zeros_like(params))

    @torch.no_grad()
    def update_(self, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: FusedSGDState,
                lr: Optional[float] = None) -> FusedSGDState:
        upd, state = self.updates(params, grads, state, lr)
        apply_updates_(params, upd)
        return state

    @torch.no_grad()
    def updates(self, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: FusedSGDState,
                lr: Optional[float] = None
                ) -> Tuple[List[torch.Tensor], FusedSGDState]:
        """The fp32 updates and the new state; ``params`` unchanged."""
        lr = self.lr if lr is None else lr
        wd, mom = self.weight_decay, self.momentum
        d = [g.float() for g in grads]
        p32 = [p.float() for p in params]
        if wd != 0.0 and not self.wd_after_momentum:
            d = torch._foreach_add(d, p32, alpha=wd)
        buf = state.momentum_buf
        if mom != 0.0:
            if state.step == 0:
                torch._foreach_copy_(buf, d)
            else:
                torch._foreach_mul_(buf, mom)
                torch._foreach_add_(buf, d, alpha=1.0 - self.dampening)
            d = torch._foreach_add(d, buf, alpha=mom) if self.nesterov \
                else list(buf)
        if wd != 0.0 and self.wd_after_momentum:
            d = torch._foreach_add(d, p32, alpha=wd)
        return torch._foreach_mul(d, -lr), FusedSGDState(state.step + 1,
                                                         buf)
