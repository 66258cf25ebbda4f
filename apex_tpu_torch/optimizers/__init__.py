"""Optimizers of the port (``apex_tpu/optimizers``): FusedAdam and
FusedSGD so far."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamState
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD, FusedSGDState

__all__ = ["FusedAdam", "FusedAdamState", "FusedSGD", "FusedSGDState"]
