"""Fused LayerNorm / RMSNorm modules of the port (port of
``apex_tpu/normalization/``), over the LayerNorm kernels of
``apex_tpu_torch.ops.layer_norm``."""

from apex_tpu_torch.normalization.fused_layer_norm import (
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    MixedFusedRMSNorm,
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
)

__all__ = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "MixedFusedRMSNorm", "fused_layer_norm", "fused_layer_norm_affine",
           "fused_rms_norm", "fused_rms_norm_affine"]
