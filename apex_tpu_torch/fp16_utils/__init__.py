"""The legacy manual mixed-precision API (port of ``apex_tpu/fp16_utils``):
``FP16_Optimizer``, the static and dynamic loss scalers under their legacy
names, and the conversion helpers. New code uses ``apex_tpu_torch.amp``."""

from apex_tpu_torch.fp16_utils.fp16_optimizer import (
    FP16_Optimizer,
    FP16OptState,
)
from apex_tpu_torch.fp16_utils.fp16util import (
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    prep_param_lists,
    tofp16,
)
from apex_tpu_torch.fp16_utils.loss_scaler import (
    DynamicLossScaler,
    LossScaler,
)

__all__ = ["DynamicLossScaler", "FP16OptState", "FP16_Optimizer",
           "LossScaler", "convert_network", "master_params_to_model_params",
           "model_grads_to_master_grads", "prep_param_lists", "tofp16"]
