"""Functional transformer ops of the port (port of
``apex_tpu/transformer/functional/``)."""

from apex_tpu_torch.transformer.functional.fused_softmax import (
    AttnMaskType,
    FusedScaleMaskSoftmax,
)

__all__ = ["AttnMaskType", "FusedScaleMaskSoftmax"]
