"""Optimizers of the port (``apex_tpu/optimizers``): FusedAdam, FusedSGD
and FusedLAMB so far."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamState
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB, FusedLAMBState
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD, FusedSGDState

__all__ = ["FusedAdam", "FusedAdamState", "FusedLAMB", "FusedLAMBState",
           "FusedSGD", "FusedSGDState"]
