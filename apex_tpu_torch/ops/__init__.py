"""Operators of the port: each kernel wrapper beside its plain version.

:func:`launch_counts` / :func:`reset_launch_counts` read and zero the
per-wrapper launch counters, so a run can show that its path went through
the kernels.
"""

from typing import Dict

from apex_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_stream,
    flash_attention_bwd_dkv_stream_reference,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_stream,
    flash_attention_bwd_dq_stream_reference,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
    flash_attention_fwd_stream,
    flash_attention_fwd_stream_reference,
    mha_reference,
)
from apex_tpu_torch.ops.flash_decode import (
    flash_decode,
    flash_decode_fwd,
    flash_decode_multi,
    flash_decode_multi_fwd,
    paged_attention_multi_reference,
    paged_attention_reference,
)
from apex_tpu_torch.ops.layer_norm import (
    FusedNorm,
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_reference,
    rms_norm,
    rms_norm_reference,
)
from apex_tpu_torch.ops.lm_head_loss import (
    lm_head_cross_entropy,
    lm_head_cross_entropy_reference,
)
from apex_tpu_torch.ops.softmax import (
    ScaledMaskedSoftmax,
    scaled_masked_softmax,
    scaled_masked_softmax_reference,
    scaled_upper_triang_masked_softmax,
    softmax_bwd,
    softmax_bwd_reference,
    softmax_fwd,
    softmax_fwd_reference,
    softmax_route,
)
from apex_tpu_torch.ops.xentropy import (
    SoftmaxXentropy,
    softmax_cross_entropy,
    softmax_cross_entropy_reference,
    xentropy_bwd,
    xentropy_bwd_reference,
    xentropy_fwd,
    xentropy_fwd_reference,
)

#: kernel name -> its launching wrapper (the holder of the launch count)
KERNEL_WRAPPERS = {
    "flash_attention_fwd": flash_attention_fwd,
    "flash_attention_bwd_dq": flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
    "flash_attention_fwd_stream": flash_attention_fwd_stream,
    "flash_attention_bwd_dq_stream": flash_attention_bwd_dq_stream,
    "flash_attention_bwd_dkv_stream": flash_attention_bwd_dkv_stream,
    "layer_norm_fwd": layer_norm_fwd,
    "layer_norm_bwd": layer_norm_bwd,
    "flash_decode": flash_decode_fwd,
    "flash_decode_multi": flash_decode_multi_fwd,
    "xentropy_fwd": xentropy_fwd,
    "xentropy_bwd": xentropy_bwd,
    "softmax_fwd": softmax_fwd,
    "softmax_bwd": softmax_bwd,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "FlashAttention",
    "FusedNorm",
    "KERNEL_WRAPPERS",
    "ScaledMaskedSoftmax",
    "SoftmaxXentropy",
    "flash_attention",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dkv_stream",
    "flash_attention_bwd_dkv_stream_reference",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dq_stream",
    "flash_attention_bwd_dq_stream_reference",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_fwd_reference",
    "flash_attention_fwd_stream",
    "flash_attention_fwd_stream_reference",
    "flash_decode",
    "flash_decode_fwd",
    "flash_decode_multi",
    "flash_decode_multi_fwd",
    "launch_counts",
    "layer_norm",
    "layer_norm_bwd",
    "layer_norm_bwd_reference",
    "layer_norm_fwd",
    "layer_norm_reference",
    "lm_head_cross_entropy",
    "lm_head_cross_entropy_reference",
    "mha_reference",
    "paged_attention_multi_reference",
    "paged_attention_reference",
    "reset_launch_counts",
    "rms_norm",
    "rms_norm_reference",
    "scaled_masked_softmax",
    "scaled_masked_softmax_reference",
    "scaled_upper_triang_masked_softmax",
    "softmax_cross_entropy",
    "softmax_bwd",
    "softmax_bwd_reference",
    "softmax_cross_entropy_reference",
    "softmax_fwd",
    "softmax_fwd_reference",
    "softmax_route",
    "xentropy_bwd",
    "xentropy_bwd_reference",
    "xentropy_fwd",
    "xentropy_fwd_reference",
]
