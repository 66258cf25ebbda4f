"""Tensor-parallel layers of the port (serial in this slice)."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    cast_param,
    scaled_normal,
)

__all__ = [
    "ColumnParallelLinear",
    "RowParallelLinear",
    "VocabParallelEmbedding",
    "cast_param",
    "scaled_normal",
    "vocab_parallel_cross_entropy",
]
