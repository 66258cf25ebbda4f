"""Contrib modules of the port (port of ``apex_tpu/contrib/``, apex's
``apex.contrib``): ``multihead_attn`` (fused self / encoder-decoder
attention, with the pre-LayerNorm and residual epilogue), ``fmha`` (packed
varlen attention), ``layer_norm`` (``FastLayerNorm``), ``bottleneck`` (the
frozen-BN bottleneck), ``groupbn`` (NHWC BatchNorm), ``transducer`` (the
RNN-T joint and loss) and ``sparsity`` (ASP 2:4 masks with the
channel-permutation search). The xentropy kernels live in
``apex_tpu_torch.ops.xentropy``, as the reference's live in
``apex_tpu.ops``."""

from apex_tpu_torch.contrib.bottleneck import (
    FastBottleneck,
    FrozenBatchNorm,
    fold_batchnorm,
)
from apex_tpu_torch.contrib.fmha import (
    fmha,
    fmha_reference,
    segment_ids_from_cu_seqlens,
)
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC, batch_norm_add_relu
from apex_tpu_torch.contrib.layer_norm import FastLayerNorm
from apex_tpu_torch.contrib.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
    mha_naive_reference,
)
from apex_tpu_torch.contrib.transducer import (
    transducer_joint,
    transducer_loss,
    transducer_loss_reference,
)

__all__ = ["BatchNorm2d_NHWC", "EncdecMultiheadAttn", "FastBottleneck",
           "FastLayerNorm", "FrozenBatchNorm", "SelfMultiheadAttn",
           "batch_norm_add_relu", "fmha", "fmha_reference", "fold_batchnorm",
           "mha_naive_reference", "segment_ids_from_cu_seqlens",
           "transducer_joint", "transducer_loss",
           "transducer_loss_reference"]
