"""FusedMixedPrecisionLamb (port of
``apex_tpu/optimizers/fused_mixed_precision_lamb.py``).

LAMB that owns its fp32 master weights and steps with no host sync
(``fused_mixed_precision_lamb.py:47-191``):

- :meth:`~FusedMixedPrecisionLamb.init` clones an fp32 master of every
  param of ``reduced_precision_dtype``; any other param is its own master
  and is stepped in place;
- :meth:`~FusedMixedPrecisionLamb.step` takes the grads of the SCALED
  loss; ``lr``, ``scale`` and ``found_inf`` may be 0-d tensors on the
  params' device, and the step count is an int32 0-d tensor there that
  advances only on clean steps (``:132``), so the bias corrections are
  device tensors too;
- the clip compares the global norm of the scaled grads with
  ``max_grad_norm * scale`` (``:144-149``), the unscaled clip;
- under ``found_inf`` every master, moment and the step keep their bits:
  each leaf takes ``torch.where(found_inf, old, new)`` (the reference's
  ``lax.cond``, ``:171-177``). A blend ``old * f + new * (1 - f)`` would
  carry the inf/NaN of a bad step into the masters, and a Python ``if`` on
  the flag would read it on the host;
- the masters are written back to the model params in the model dtype.

Its per-leaf math is FusedLAMB's (``optimizers._common.lamb_leaf_update``)
in the same order, so on the same scaled grads it gives the masters of
``amp.MixedPrecisionOptimizer(FusedLAMB)`` bit for bit where the scale is
a power of two.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops.multi_tensor import tree_l2norm, tree_nonfinite
from apex_tpu_torch.optimizers._common import (
    lamb_leaf_update,
    tree_zeros_like,
)

Number = Union[float, torch.Tensor]


class FusedMixedPrecisionLambState(NamedTuple):
    step: torch.Tensor              # int32 0-d on the params' device
    exp_avg: List[torch.Tensor]     # first moment, fp32
    exp_avg_sq: List[torch.Tensor]  # second moment, fp32
    #: fp32 masters of the reduced-precision params; any other param is
    #: its own master (the same tensor)
    master: List[torch.Tensor]


def _params(params) -> List[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return list(params)


class FusedMixedPrecisionLamb:
    """Sync-free mixed-precision LAMB::

        opt = FusedMixedPrecisionLamb(lr=1e-3,
                                      reduced_precision_dtype=torch.bfloat16)
        state = opt.init(model)                 # fp32 masters
        state = opt.step(state, model, scaled_grads, scale=scale)

    :meth:`step` updates the masters, the moments and the model params IN
    PLACE and returns the state with its new step count."""

    def __init__(self, lr: float = 1e-3, step: int = 0,
                 bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 amsgrad: bool = False, adam_w_mode: bool = True,
                 grad_averaging: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False,
                 reduced_precision_dtype: Optional[torch.dtype] = None):
        if amsgrad:
            raise RuntimeError(
                "FusedLAMB does not support the AMSGrad variant.")
        if not adam_w_mode:
            raise RuntimeError(
                "FusedMixedPrecisionLamb only supports adam_w_mode "
                "(decoupled wd), as the reference kernel does.")
        self.lr = lr
        self._step0 = int(step)
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.reduced_precision_dtype = reduced_precision_dtype

    def _is_reduced(self, p: torch.Tensor) -> bool:
        return (self.reduced_precision_dtype is not None
                and p.dtype == self.reduced_precision_dtype)

    @torch.no_grad()
    def init(self, model_params) -> FusedMixedPrecisionLambState:
        params = _params(model_params)
        dev = params[0].device if params else torch.device("cpu")
        master = [p.detach().to(torch.float32, copy=True)
                  if self._is_reduced(p) else p for p in params]
        return FusedMixedPrecisionLambState(
            step=torch.full((), self._step0, dtype=torch.int32, device=dev),
            exp_avg=tree_zeros_like(params),
            exp_avg_sq=tree_zeros_like(params), master=master)

    @torch.no_grad()
    def step(self, state: FusedMixedPrecisionLambState, model_params,
             grads: Sequence[torch.Tensor], *, lr: Optional[Number] = None,
             scale: Optional[Number] = None,
             found_inf: Optional[Any] = None
             ) -> FusedMixedPrecisionLambState:
        """One LAMB step from ``grads`` of the ``scale``-scaled loss
        (``scale=None``: unscaled grads); ``found_inf`` defaults to the
        grads' own non-finite flag. Reads nothing back to the host."""
        params = _params(model_params)
        grads = list(grads)
        dev = state.step.device
        beta1, beta2 = self.betas
        lr = self.lr if lr is None else lr
        if found_inf is None:
            found_inf = tree_nonfinite(grads)
        elif isinstance(found_inf, torch.Tensor):
            found_inf = found_inf.to(torch.bool)
        else:
            found_inf = torch.full((), bool(found_inf), dtype=torch.bool,
                                   device=dev)
        new_step = state.step + torch.logical_not(found_inf).to(torch.int32)
        if self.bias_correction:  # float64, as FusedLAMB's host floats
            t = new_step.double()
            bc1 = 1.0 - torch.pow(beta1, t)
            bc2 = 1.0 - torch.pow(beta2, t)
        else:
            bc1 = bc2 = 1.0
        g32 = [g.float() for g in grads]
        clip = None
        if self.max_grad_norm and self.max_grad_norm > 0 and g32:
            # the scaled norm against max_grad_norm * scale (:144-149):
            # divided by max_grad_norm first as FusedLAMB divides the
            # unscaled norm, then by the scale, a power of two
            norm = tree_l2norm(g32) / self.max_grad_norm
            clip = torch.clamp(norm if scale is None else norm / scale,
                               min=1.0)
        if scale is not None:
            inv = torch.reciprocal(scale) if isinstance(scale, torch.Tensor) \
                else 1.0 / scale
            g32 = torch._foreach_mul(g32, inv)
        if clip is not None:
            g32 = torch._foreach_div(g32, clip)
        m_new = [m.clone() for m in state.exp_avg]
        v_new = [v.clone() for v in state.exp_avg_sq]
        upd = lamb_leaf_update(
            g32, state.master, m_new, v_new, beta1=beta1, beta2=beta2,
            beta1_grad=(1.0 - beta1) if self.grad_averaging else 1.0,
            bc1=bc1, bc2=bc2, eps=self.eps, weight_decay=self.weight_decay,
            use_nvlamb=self.use_nvlamb)
        torch._foreach_mul_(upd, -lr)
        new_master = list(torch._foreach_add(state.master, upd))
        # the skip: each leaf keeps its bits under found_inf (:171-177)
        for old, new in zip([*state.master, *state.exp_avg,
                             *state.exp_avg_sq], new_master + m_new + v_new):
            old.copy_(torch.where(found_inf, old, new))
        for p, m in zip(params, state.master):
            if p is not m:
                p.copy_(m)
        return state._replace(step=new_step)
