"""Tensor and sequence parallelism (port of
``apex_tpu/transformer/tensor_parallel``; reference:
apex/transformer/tensor_parallel/)."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.data import broadcast_data
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    cast_param,
    gather_params,
    scaled_normal,
    shard_params,
    xavier_normal,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    RNGStatesTracker,
    checkpoint,
    checkpoint_policies,
    data_parallel_generator,
    model_parallel_generator,
    sequence_parallel_generator,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    divide,
    ensure_divisibility,
    split_tensor_along_last_dim,
)

__all__ = [
    "ColumnParallelLinear",
    "RNGStatesTracker",
    "RowParallelLinear",
    "VocabParallelEmbedding",
    "VocabUtility",
    "broadcast_data",
    "cast_param",
    "checkpoint",
    "checkpoint_policies",
    "copy_to_tensor_model_parallel_region",
    "data_parallel_generator",
    "divide",
    "ensure_divisibility",
    "gather_from_sequence_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "gather_params",
    "model_parallel_generator",
    "reduce_from_tensor_model_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "scaled_normal",
    "scatter_to_sequence_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "sequence_parallel_generator",
    "shard_params",
    "split_tensor_along_last_dim",
    "vocab_parallel_cross_entropy",
    "xavier_normal",
]
