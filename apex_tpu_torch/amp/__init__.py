"""Automatic mixed precision (port of ``apex_tpu/amp``): policies, the loss
scaler, the mixed-precision optimizer with its ZeRO levels 1-3,
``initialize`` with its ``AmpTrainState``, and the O1 function registries
(``functions``)."""

from apex_tpu_torch.amp.frontend import (
    AmpTrainState,
    MixedPrecisionOptimizer,
    MPOptState,
    Zero3Setup,
    initialize,
    load_state_tree_,
    state_tree,
)
from apex_tpu_torch.amp.functions import (
    disable_casts,
    float_function,
    half_function,
    promote_function,
    set_active_policy,
)
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.precision import (
    Policy,
    cast_params,
    get_policy,
    upcast_params,
)

__all__ = [
    "AmpTrainState",
    "LossScaler",
    "MPOptState",
    "MixedPrecisionOptimizer",
    "Zero3Setup",
    "Policy",
    "cast_params",
    "disable_casts",
    "float_function",
    "get_policy",
    "half_function",
    "initialize",
    "load_state_tree_",
    "promote_function",
    "set_active_policy",
    "state_tree",
    "upcast_params",
]
