"""The mixed-precision optimizer and ``amp.initialize`` (port of
``apex_tpu/amp/frontend.py``: ``MixedPrecisionOptimizer`` without ZeRO,
``frontend.py:126-560``, the non-``zero_axis`` branch; ``AmpTrainState``
and ``initialize``, ``frontend.py:1106-1217``).

Per step (the reference's ``apply_gradients``):

1. unscale the grads by 1/loss_scale into fp32, detecting non-finites;
2. on overflow skip: masters, moments and the step count are left
   bit-identical (nothing touches them); otherwise step the inner optimizer
   on the fp32 masters (or on the params themselves without masters);
3. copy the masters out to the model params in the model's dtypes;
4. update the loss scaler.

The JAX step chooses with ``lax.cond`` on the device; here the overflow flag
is read on the host once per step (one device sync), and the skipped branch
simply does not run. State is explicit, as in the reference
(:class:`MPOptState`), but updated in place. :func:`state_tree` /
:func:`load_state_tree_` map it to and from the JAX ``MPOptState``'s tree
(the checkpoint layout, ``apex_tpu_torch.checkpoint``).

:func:`initialize` is the call apex users start from, in PyTorch's idiom:
it casts the module's parameters in place and returns an
:class:`AmpTrainState` (a step counter over the module and its optimizer
state, updated in place), ``(module, mp_optimizer)`` or ``(module,
policy)``, as the reference returns its three forms.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from apex_tpu_torch import precision as _precision
from apex_tpu_torch._params import module_tree, tensors_of_tree
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.ops.multi_tensor import tree_l2norm

_ZERO_LATER = ("ZeRO and its wires are not in this slice of the port; they "
               "come with ROADMAP Queue 1 item 11")


class MPOptState:
    """``inner``: the wrapped optimizer's state; ``master``: fp32 master
    copies of the params when the policy keeps them, else None;
    ``scaler``: the loss scaler."""

    def __init__(self, inner: Any, master: Optional[List[torch.Tensor]],
                 scaler: LossScaler):
        self.inner = inner
        self.master = master
        self.scaler = scaler


def state_tree(state: MPOptState, module: nn.Module,
               device="cpu") -> Dict[str, Any]:
    """The JAX ``MPOptState`` tree of ``state`` (``apex_tpu/amp/
    frontend.py:39``) for the params of ``module``: ``inner`` (the inner
    optimizer's NamedTuple state under its field names, ``FusedAdamState``'s
    ``step`` / ``exp_avg`` / ``exp_avg_sq``), ``master`` (absent without
    masters, as JAX's None) and ``scaler`` (``loss_scale`` fp32,
    ``unskipped`` int32). Per-parameter lists take the JAX params' layout
    (:func:`apex_tpu_torch._params.module_tree`); an int is an int32 0-d
    leaf. Leaves are copies on ``device`` (``"meta"``: the structure
    alone)."""
    inner = {}
    for field, value in state.inner._asdict().items():
        if isinstance(value, int):
            inner[field] = torch.tensor(value, dtype=torch.int32,
                                        device=device)
        elif isinstance(value, (list, tuple)):
            inner[field] = module_tree(module, value, device)
        elif value is not None:
            raise TypeError(f"inner state field {field!r}: "
                            f"{type(value).__name__} has no JAX layout")
    tree = {"inner": inner, "scaler": {
        "loss_scale": torch.tensor(state.scaler.loss_scale,
                                   dtype=torch.float32, device=device),
        "unskipped": torch.tensor(state.scaler.unskipped,
                                  dtype=torch.int32, device=device)}}
    if state.master is not None:
        tree["master"] = module_tree(module, state.master, device)
    return tree


@torch.no_grad()
def load_state_tree_(state: MPOptState, module: nn.Module,
                     tree: Dict[str, Any]) -> MPOptState:
    """Copy a JAX-layout ``MPOptState`` tree (:func:`state_tree`'s, or one
    restored from either package's checkpoint) into ``state`` IN PLACE:
    the masters and moment tensors keep their storage, the step count and
    the scaler take the tree's values. Returns ``state``."""
    ints = {}
    for field, value in state.inner._asdict().items():
        if isinstance(value, int):
            ints[field] = int(tree["inner"][field])
        elif isinstance(value, (list, tuple)):
            for dst, src in zip(value, tensors_of_tree(
                    module, tree["inner"][field])):
                dst.copy_(src)
    state.inner = state.inner._replace(**ints)
    if state.master is not None:
        for dst, src in zip(state.master,
                            tensors_of_tree(module, tree["master"])):
            dst.copy_(src)
    state.scaler.loss_scale = float(tree["scaler"]["loss_scale"])
    state.scaler.unskipped = int(tree["scaler"]["unskipped"])
    return state


def _param_list(params) -> List[torch.Tensor]:
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return list(params)


class MixedPrecisionOptimizer:
    """Wraps an optimizer with ``init(params)`` / ``update_(params, grads,
    state)`` (``apex_tpu_torch.optimizers.FusedAdam``) with amp semantics.

    ``zero_axis``, ``dcn_axis``, ``gather_dtype``, ``reduce_dtype`` and
    ``stochastic_rounding`` raise ``NotImplementedError``: ZeRO is ROADMAP
    Queue 1 item 11."""

    def __init__(self, optimizer, policy: _precision.Policy,
                 log_grad_norm: bool = False,
                 zero_axis: Optional[str] = None,
                 dcn_axis: Optional[str] = None,
                 gather_dtype: Optional[Any] = None,
                 reduce_dtype: Optional[str] = None,
                 stochastic_rounding: bool = False,
                 **scaler_kwargs):
        later = [name for name, val in (
            ("zero_axis", zero_axis), ("dcn_axis", dcn_axis),
            ("gather_dtype", gather_dtype), ("reduce_dtype", reduce_dtype),
            ("stochastic_rounding", stochastic_rounding or None))
            if val is not None]
        if later:
            raise NotImplementedError(f"MixedPrecisionOptimizer({later}): "
                                      f"{_ZERO_LATER}")
        self.inner = optimizer
        self.policy = policy
        self.log_grad_norm = bool(log_grad_norm)
        self._scaler_kwargs = scaler_kwargs

    def init(self, model_params) -> MPOptState:
        """State for ``model_params`` (a module or a list of tensors):
        fp32 masters when the policy asks for them, the inner state over
        the fp32 view, a fresh scaler."""
        params = _param_list(model_params)
        master = (_precision.upcast_params(params)
                  if self.policy.master_weights else None)
        inner = self.inner.init(master if master is not None else params)
        scaler = LossScaler.create(loss_scale=self.policy.loss_scale,
                                   **self._scaler_kwargs)
        return MPOptState(inner, master, scaler)

    def scale_loss(self, loss: torch.Tensor,
                   state: MPOptState) -> torch.Tensor:
        """``loss.float() * loss_scale`` (``with amp.scale_loss``)."""
        return state.scaler.scale(loss)

    @torch.no_grad()
    def apply_gradients(self, state: MPOptState, model_params,
                        scaled_grads: Sequence[torch.Tensor], *,
                        found_inf_reducer: Optional[
                            Callable[[torch.Tensor], torch.Tensor]] = None,
                        **update_kwargs) -> Dict[str, Any]:
        """Step ``model_params`` IN PLACE from the grads of the SCALED
        loss; returns the metrics ``found_inf`` (bool), ``loss_scale`` (the
        scale after the update) and, with ``log_grad_norm``, ``grad_norm``
        (the fp32 L2 norm of the unscaled grads, a 0-d tensor).

        ``found_inf_reducer`` maps this rank's 0-d overflow flag to the
        flag every rank acts on (``frontend.py:473-511``), for example
        :class:`apex_tpu_torch.transformer.amp.MeshGradScaler`'s vote over
        the model-parallel axes, so that all ranks skip a step together.
        It runs on the card before the step's one host read of the flag."""
        params = _param_list(model_params)
        grads32, found = state.scaler.unscale(scaled_grads,
                                              out_dtype=torch.float32)
        if found_inf_reducer is not None:
            found = found_inf_reducer(found)
        found_inf = bool(found)  # the one host sync of the step
        if not found_inf:
            step_params = state.master if state.master is not None \
                else params
            state.inner = self.inner.update_(step_params, grads32,
                                             state.inner, **update_kwargs)
            if state.master is not None:
                # master -> model copy-out in the model dtypes
                for p, m in zip(params, state.master):
                    p.copy_(m)
        state.scaler.update(found_inf)
        metrics = {"found_inf": found_inf,
                   "loss_scale": state.scaler.loss_scale}
        if self.log_grad_norm:
            metrics["grad_norm"] = tree_l2norm(grads32)
        return metrics

    def step(self, state: MPOptState, model_params, *,
             found_inf_reducer: Optional[
                 Callable[[torch.Tensor], torch.Tensor]] = None,
             **update_kwargs) -> Dict[str, Any]:
        """:meth:`apply_gradients` from each param's ``.grad`` (after
        ``scale_loss(loss).backward()``), then the grads are cleared. A
        param without a grad gets a zero grad."""
        params = _param_list(model_params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        metrics = self.apply_gradients(state, params, grads,
                                       found_inf_reducer=found_inf_reducer,
                                       **update_kwargs)
        for p in params:
            p.grad = None
        return metrics


class AmpTrainState:
    """The train state :func:`initialize` bundles (``AmpTrainState``,
    ``frontend.py:1106-1150``): ``module`` (the parameters live in it),
    ``opt_state``, ``apply_fn`` (``apply_fn(module, *inputs)``),
    ``mp_optimizer`` and ``step``, the count of :meth:`apply_gradients`
    calls (skipped overflow steps included, as the reference's). The
    reference returns a new state; this one updates itself in place."""

    def __init__(self, *, apply_fn: Callable, module: nn.Module,
                 mp_optimizer: MixedPrecisionOptimizer):
        self.step = 0
        self.module = module
        self.apply_fn = apply_fn
        self.mp_optimizer = mp_optimizer
        self.opt_state = mp_optimizer.init(module)

    @property
    def scaler(self) -> LossScaler:
        return self.opt_state.scaler

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return self.mp_optimizer.scale_loss(loss, self.opt_state)

    def apply_gradients(self, scaled_grads: Optional[Sequence[torch.Tensor]]
                        = None, *, found_inf_reducer: Optional[
                            Callable[[torch.Tensor], torch.Tensor]] = None,
                        **update_kwargs) -> Dict[str, Any]:
        """Step the module from the grads of the scaled loss (a list
        aligned with ``module.parameters()``, or None: each parameter's
        ``.grad``, cleared after) and count the step; returns the
        optimizer's metrics. ``found_inf_reducer``: as
        :meth:`MixedPrecisionOptimizer.apply_gradients`'s
        (``frontend.py:1136-1141``)."""
        if scaled_grads is None:
            metrics = self.mp_optimizer.step(
                self.opt_state, self.module,
                found_inf_reducer=found_inf_reducer, **update_kwargs)
        else:
            metrics = self.mp_optimizer.apply_gradients(
                self.opt_state, self.module, scaled_grads,
                found_inf_reducer=found_inf_reducer, **update_kwargs)
        self.step += 1
        return metrics


def initialize(module: nn.Module, optimizers=None, opt_level: str = "O1", *,
               apply_fn: Optional[Callable] = None,
               cast_model_type=None, keep_batchnorm_fp32=None,
               master_weights=None,
               loss_scale: Optional[Union[str, float]] = None,
               min_loss_scale: Optional[float] = None,
               max_loss_scale: float = 2.0 ** 24,
               half_dtype=torch.bfloat16, verbosity: int = 1):
    """``amp.initialize`` (reference: apex/amp/frontend.py:195-358;
    ``apex_tpu/amp/frontend.py:1153-1217``): the policy of ``opt_level``
    with the reference's overrides, the O1 function registries armed
    (:func:`apex_tpu_torch.amp.functions.set_active_policy`) and
    ``module``'s parameters cast IN PLACE (:func:`precision.cast_params`).
    ``optimizers``: one optimizer with ``init`` / ``update_``
    (``FusedAdam``, ``FusedSGD``, ...), or None for inference casting.

    Returns an :class:`AmpTrainState` with an optimizer and ``apply_fn``;
    ``(module, mp_optimizer)`` with an optimizer alone; ``(module,
    policy)`` with none. ``apply_fn`` without an optimizer raises
    ``ValueError``."""
    policy = _precision.get_policy(
        opt_level, half_dtype=half_dtype, cast_model_type=cast_model_type,
        keep_batchnorm_fp32=keep_batchnorm_fp32,
        master_weights=master_weights, loss_scale=loss_scale)
    if verbosity:
        from apex_tpu_torch.utils.log_util import maybe_print

        maybe_print(
            f"apex_tpu_torch.amp: opt_level={policy.opt_level} "
            f"cast_model_type={policy.cast_model_type} "
            f"master_weights={policy.master_weights} "
            f"loss_scale={policy.loss_scale}", rank0=True)
    # arm the O1-style function registries (amp.py:68-177's patch install)
    from apex_tpu_torch.amp.functions import set_active_policy

    set_active_policy(policy)
    _precision.cast_params(module, policy)
    if optimizers is None:
        if apply_fn is not None:
            raise ValueError(
                "apply_fn without an optimizer has nothing to train; call "
                "initialize(module, opt_level=...) for inference casting, "
                "or pass an optimizer to build an AmpTrainState.")
        return module, policy
    mp_opt = MixedPrecisionOptimizer(optimizers, policy,
                                     min_loss_scale=min_loss_scale,
                                     max_loss_scale=max_loss_scale)
    if apply_fn is not None:
        return AmpTrainState(apply_fn=apply_fn, module=module,
                             mp_optimizer=mp_opt)
    return module, mp_opt
