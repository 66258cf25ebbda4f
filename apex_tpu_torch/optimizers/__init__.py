"""Optimizers of the port (``apex_tpu/optimizers``): FusedAdam, FusedSGD,
FusedLAMB, FusedAdagrad, FusedNovoGrad, the LARC wrapper, the sync-free
FusedMixedPrecisionLamb, the ZeRO-sharded ``distributed`` optimizers and
the host-offloaded ZeRO state (``offload``)."""

from apex_tpu_torch.optimizers.fused_adagrad import (
    FusedAdagrad,
    FusedAdagradState,
)
from apex_tpu_torch.optimizers.distributed import (
    DistributedFusedAdam,
    DistributedFusedLAMB,
    DistributedFusedSGD,
    distributed_fused,
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
from apex_tpu_torch.optimizers.offload import (
    HostOffloadedZero,
    HostOffloadState,
)

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB",
           "DistributedFusedSGD", "HostOffloadState", "HostOffloadedZero",
           "distributed_fused", "FusedAdagrad", "FusedAdagradState", "FusedAdam",
           "FusedAdamState", "FusedLAMB", "FusedLAMBState",
           "FusedMixedPrecisionLamb", "FusedMixedPrecisionLambState",
           "FusedNovoGrad", "FusedNovoGradState", "FusedSGD",
           "FusedSGDState", "LARC", "larc"]
