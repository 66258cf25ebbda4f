"""FusedLAMB (port of ``apex_tpu/optimizers/fused_lamb.py``).

The layer-wise adaptive large-batch optimizer with apex's knobs
(``fused_lamb.py:36-159``): phase 1, the global gradient norm and the clip
factor ``max(1, ||g|| / max_grad_norm)``; phase 2, per leaf the Adam-style
moments with ``grad_averaging`` and ``bias_correction``, decoupled weight
decay and the trust ratio ``||p|| / ||update||`` (``use_nvlamb`` applies
it where ``weight_decay == 0`` too; :func:`~apex_tpu_torch.optimizers.
_common.lamb_leaf_update`). The moments and the arithmetic are fp32, in
``torch._foreach_*`` passes over the param list (the reference's update is
one XLA computation, not a Pallas kernel), in the ``init`` / ``update_``
shape of ``FusedAdam`` so ``amp.MixedPrecisionOptimizer`` takes it as it
is. ``adam_w_mode=False`` raises as in the reference.

``norm_psum_axis`` (ZeRO, ``optimizers.distributed``): every leaf is this
rank's 1-D chunk of a tensor sharded over that mesh axis, so the squared
norms of every leaf -- the global clip norm's and each trust ratio's --
are summed over the axis (``fused_lamb.py:46-60``).

Under tensor parallelism a leaf may be this rank's shard of a tensor split
over the model axis: ``update_(..., sharded=flags, axis="model")`` sums
the squared norms of the flagged leaves over the axis, so the global clip
norm and each trust ratio are those of the whole tensors, as the JAX
optimizer computes them on the global arrays.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.ops.multi_tensor import tree_l2norm
from apex_tpu_torch.optimizers._common import (
    apply_updates_,
    lamb_leaf_update,
    tree_zeros_like,
)


class FusedLAMBState(NamedTuple):
    step: int
    exp_avg: List[torch.Tensor]     # first moment, fp32
    exp_avg_sq: List[torch.Tensor]  # second moment, fp32


class FusedLAMB:
    """``init(params) -> state``; ``update_(params, grads, state, lr=None)
    -> state`` steps ``params`` in place and returns the new state (the
    moment tensors are updated in place too)."""

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 grad_averaging: bool = True, adam_w_mode: bool = True,
                 max_grad_norm: float = 1.0, use_nvlamb: bool = False,
                 norm_psum_axis: Optional[str] = None):
        if not adam_w_mode:
            raise RuntimeError("FusedLAMB only supports adam_w_mode "
                               "(decoupled wd), as the reference kernel "
                               "does.")
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.norm_psum_axis = norm_psum_axis

    def init(self, params: Sequence[torch.Tensor]) -> FusedLAMBState:
        return FusedLAMBState(0, tree_zeros_like(params),
                              tree_zeros_like(params))

    @torch.no_grad()
    def update_(self, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: FusedLAMBState,
                lr: Optional[float] = None,
                sharded: Optional[Sequence[bool]] = None,
                axis: Optional[str] = None) -> FusedLAMBState:
        upd, state = self.updates(params, grads, state, lr, sharded, axis)
        apply_updates_(params, upd)
        return state

    @torch.no_grad()
    def updates(self, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: FusedLAMBState,
                lr: Optional[float] = None,
                sharded: Optional[Sequence[bool]] = None,
                axis: Optional[str] = None
                ) -> Tuple[List[torch.Tensor], FusedLAMBState]:
        """The fp32 updates and the new state; ``params`` unchanged."""
        beta1, beta2 = self.betas
        step = state.step + 1
        lr = self.lr if lr is None else lr
        if self.bias_correction:
            bc1 = 1.0 - beta1 ** step
            bc2 = 1.0 - beta2 ** step
        else:
            bc1 = bc2 = 1.0
        g32 = [g.float() for g in grads]
        reduce = None
        if (axis is not None and sharded is not None and any(sharded)) \
                or self.norm_psum_axis is not None:
            reduce = _sumsq_reduce(sharded, axis, self.norm_psum_axis)
        if self.max_grad_norm and self.max_grad_norm > 0 and g32:
            # phase 1: the global norm and the clip factor, on the device
            if reduce is None:
                norm = tree_l2norm(g32)
            else:
                sq = torch.stack(torch._foreach_norm(g32)) ** 2
                norm = torch.sqrt(reduce(sq).sum())
            clip = torch.clamp(norm / self.max_grad_norm, min=1.0)
            g32 = torch._foreach_div(g32, clip)
        upd = lamb_leaf_update(
            g32, [p.float() for p in params], state.exp_avg,
            state.exp_avg_sq, beta1=beta1, beta2=beta2,
            beta1_grad=(1.0 - beta1) if self.grad_averaging else 1.0,
            bc1=bc1, bc2=bc2, eps=self.eps, weight_decay=self.weight_decay,
            use_nvlamb=self.use_nvlamb, sumsq_reduce=reduce)
        torch._foreach_mul_(upd, -lr)
        return upd, FusedLAMBState(step, state.exp_avg, state.exp_avg_sq)


def _sumsq_reduce(sharded: Optional[Sequence[bool]], axis: Optional[str],
                  psum_axis: Optional[str] = None):
    """Per-leaf squared norms -> those of the whole tensors: every entry
    summed over ``psum_axis`` (the ZeRO chunks), then the flagged entries
    over ``axis`` (one all-reduce of the vector each)."""
    from apex_tpu_torch.parallel import collectives

    def reduce(sq: torch.Tensor) -> torch.Tensor:
        if psum_axis is not None:
            sq = collectives.psum(sq, psum_axis)
        if axis is None or sharded is None or not any(sharded):
            return sq
        mask = torch.tensor(list(sharded), device=sq.device)
        return torch.where(mask, collectives.psum(sq, axis), sq)

    return reduce
