"""Optimizers of the port (``apex_tpu/optimizers``): FusedAdam, FusedSGD,
FusedLAMB, FusedAdagrad, FusedNovoGrad, the LARC wrapper and the sync-free
FusedMixedPrecisionLamb. The ZeRO optimizers (``distributed``,
``offload``) come with ROADMAP Queue 1 item 11."""

from apex_tpu_torch.optimizers.fused_adagrad import (
    FusedAdagrad,
    FusedAdagradState,
)
from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamState
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB, FusedLAMBState
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (
    FusedMixedPrecisionLamb,
    FusedMixedPrecisionLambState,
)
from apex_tpu_torch.optimizers.fused_novograd import (
    FusedNovoGrad,
    FusedNovoGradState,
)
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD, FusedSGDState
from apex_tpu_torch.optimizers.larc import LARC, larc

__all__ = ["FusedAdagrad", "FusedAdagradState", "FusedAdam",
           "FusedAdamState", "FusedLAMB", "FusedLAMBState",
           "FusedMixedPrecisionLamb", "FusedMixedPrecisionLambState",
           "FusedNovoGrad", "FusedNovoGradState", "FusedSGD",
           "FusedSGDState", "LARC", "larc"]
