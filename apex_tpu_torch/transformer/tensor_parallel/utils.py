"""Shape and vocab utilities (port of
``apex_tpu/transformer/tensor_parallel/utils.py``; reference:
apex/transformer/tensor_parallel/utils.py)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def ensure_divisibility(numerator: int, denominator: int) -> None:
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    """Exact integer division with the divisibility check."""
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(x: torch.Tensor, num_partitions: int
                                ) -> Sequence[torch.Tensor]:
    """``num_partitions`` equal chunks (views) of the last dim."""
    return torch.split(x, divide(x.shape[-1], num_partitions), dim=-1)


class VocabUtility:
    """Vocab range arithmetic of the vocab-parallel embedding and cross
    entropy: rank ``r`` holds rows ``[first, last)``."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank: int) -> Tuple[int, int]:
        first = rank * per_partition_vocab_size
        return first, first + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(
            global_vocab_size: int, rank: int,
            world_size: int) -> Tuple[int, int]:
        per = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per, rank)
