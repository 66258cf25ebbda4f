"""Automatic mixed precision (port of ``apex_tpu/amp``): policies, the loss
scaler and the mixed-precision optimizer without ZeRO."""

from apex_tpu_torch.amp.frontend import (
    MixedPrecisionOptimizer,
    MPOptState,
    load_state_tree_,
    state_tree,
)
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.precision import (
    Policy,
    cast_params,
    get_policy,
    upcast_params,
)

__all__ = [
    "LossScaler",
    "MPOptState",
    "MixedPrecisionOptimizer",
    "Policy",
    "cast_params",
    "get_policy",
    "load_state_tree_",
    "state_tree",
    "upcast_params",
]
