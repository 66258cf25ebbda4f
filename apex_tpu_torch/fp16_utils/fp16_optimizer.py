"""FP16_Optimizer, the legacy master-weight wrapper (port of
``apex_tpu/fp16_utils/fp16_optimizer.py``).

It wraps one of the port's optimizers (``init`` / ``update_``) and keeps
the state ``(inner, master, scaler)``: fp32 masters of the model's
parameters, the inner optimizer's state over them, and a static or dynamic
loss scaler (:mod:`~apex_tpu_torch.fp16_utils.loss_scaler`). A step
unscales the grads into fp32, optionally clips them by their global norm
(``clip_master_grads``), steps the masters, copies them out to the model in
its dtypes and updates the scaler (``fp16_optimizer.py:89-129``). A dynamic
scaler skips a step with a non-finite grad, leaving masters and the inner
state untouched; the static one never skips, as the reference's has no
overflow check. The overflow flag is read on the host once a step, as
``amp.MixedPrecisionOptimizer`` reads it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.amp.scaler import LossScaler as _AmpScaler
from apex_tpu_torch.fp16_utils.fp16util import (
    master_params_to_model_params,
    prep_param_lists,
)
from apex_tpu_torch.fp16_utils.loss_scaler import (
    DynamicLossScaler,
    LossScaler,
)
from apex_tpu_torch.ops.multi_tensor import (
    tree_clip_by_global_norm,
    tree_l2norm,
)


class FP16OptState:
    """``inner``: the wrapped optimizer's state; ``master``: the fp32
    masters (a list aligned with the model's parameters); ``scaler``."""

    def __init__(self, inner: Any, master: List[torch.Tensor],
                 scaler: _AmpScaler):
        self.inner = inner
        self.master = master
        self.scaler = scaler


def _params(model_params) -> List[torch.Tensor]:
    if isinstance(model_params, torch.nn.Module):
        return list(model_params.parameters())
    return list(model_params)


class FP16_Optimizer:
    """The legacy wrapper (``fp16_optimizer.py:41-68``: ``static_loss_scale``,
    ``dynamic_loss_scale``, ``dynamic_loss_args``)::

        opt = FP16_Optimizer(FusedAdam(lr=1e-3), dynamic_loss_scale=True)
        state = opt.init(model)              # after convert_network(model)
        opt.scale_loss(loss, state).backward()
        info = opt.step(state, model, [p.grad for p in model.parameters()],
                        max_norm=1.0)
    """

    def __init__(self, optimizer, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None):
        self.inner = optimizer
        self.dynamic = dynamic_loss_scale
        self._scaler_args = dict(dynamic_loss_args or {}) \
            if dynamic_loss_scale else {"scale": static_loss_scale}

    def init(self, model_params) -> FP16OptState:
        _, master = prep_param_lists(_params(model_params))
        scaler = DynamicLossScaler(**self._scaler_args) if self.dynamic \
            else LossScaler(**self._scaler_args)
        return FP16OptState(self.inner.init(master), master, scaler)

    def scale_loss(self, loss: torch.Tensor,
                   state: FP16OptState) -> torch.Tensor:
        """The scaling half of the reference's ``backward(loss)``
        (``fp16_optimizer.py:78-81``): differentiate what this returns."""
        return state.scaler.scale(loss)

    def clip_master_grads(self, grads32: Sequence[torch.Tensor],
                          max_norm: float
                          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Clip by the global norm (``fp16_optimizer.py:83-87``); returns
        ``(clipped, total_norm)``."""
        return tree_clip_by_global_norm(grads32, max_norm)

    @torch.no_grad()
    def step(self, state: FP16OptState, model_params,
             scaled_grads: Sequence[torch.Tensor],
             max_norm: Optional[float] = None) -> Dict[str, Any]:
        """Unscale, clip where ``max_norm`` is given, step the masters
        (skipped on an overflow under a dynamic scaler), copy them out to
        ``model_params`` IN PLACE and update the scaler. Returns ``info``:
        ``overflow`` (bool), ``loss_scale`` (after the update) and
        ``grad_norm`` (the unscaled grads' norm before any clip)."""
        params = _params(model_params)
        grads32, found = state.scaler.unscale(scaled_grads,
                                              out_dtype=torch.float32)
        if max_norm is not None:
            grads32, grad_norm = self.clip_master_grads(grads32, max_norm)
        else:
            grad_norm = tree_l2norm(grads32)
        overflow = bool(found)  # the one host read of the step
        if not (self.dynamic and overflow):
            state.inner = self.inner.update_(state.master, grads32,
                                             state.inner)
        master_params_to_model_params(state.master, params)
        state.scaler.update(overflow)
        return {"overflow": overflow,
                "loss_scale": state.scaler.loss_scale,
                "grad_norm": grad_norm}

    # -- checkpointing (fp16_optimizer.py:131-145) --------------------------

    def state_dict(self, state: FP16OptState) -> Dict[str, Any]:
        """The inner state, the masters and the scaler's numbers (the
        tensors themselves, as ``torch.optim``'s ``state_dict``)."""
        return {"inner": state.inner, "master": state.master,
                "scaler": state.scaler.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: FP16OptState,
                        payload: Dict[str, Any]) -> FP16OptState:
        """Copy ``payload`` (a :meth:`state_dict`) into ``state`` IN
        PLACE: tensors keep their storage, the step count takes the
        payload's. The inner state's structure must match the wrapped
        optimizer's. Returns ``state``."""
        ints = {}
        for field, value in state.inner._asdict().items():
            src = getattr(payload["inner"], field)
            if isinstance(value, (list, tuple)):
                for dst, s in zip(value, src):
                    dst.copy_(s)
            else:
                ints[field] = int(src)
        state.inner = state.inner._replace(**ints)
        for dst, src in zip(state.master, payload["master"]):
            dst.copy_(src)
        state.scaler.load_state_dict(payload["scaler"])
        return state
