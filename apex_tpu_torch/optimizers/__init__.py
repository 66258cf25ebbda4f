"""Optimizers of the port (``apex_tpu/optimizers``): FusedAdam so far."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamState

__all__ = ["FusedAdam", "FusedAdamState"]
