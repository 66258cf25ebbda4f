"""Pretraining batch samplers + microbatch slicing (port of
``apex_tpu/transformer/data.py``; reference: apex/transformer/_data/_batchsampler.py:38+ and
pipeline_parallel/utils.py:122+ ``get_kth_microbatch``).

The reference's samplers yield *index lists* for a torch DataLoader, sharded
so each data-parallel rank sees a disjoint contiguous (or shuffled) slice of
every global batch. Functionally identical here: iterators over index arrays,
parameterized by (dp_rank, dp_size), usable with any indexable dataset or as
``torch.index_select`` indices. The per-epoch permutation is numpy's
``default_rng(epoch)``, so the index streams are the JAX package's element
for element.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class MegatronPretrainingSampler:
    """Contiguous DP shards of sequential global batches
    (_batchsampler.py:38-91: each rank takes
    ``[start + rank*mbs : start + (rank+1)*mbs]`` of the consumed range).

    ``micro_batch_times_data_parallel_size`` consumed per step; supports
    resume via ``consumed_samples`` and an optional incomplete last batch.
    """

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        micro_batch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
        drop_last: bool = True,
    ):
        if total_samples <= 0:
            raise RuntimeError(f"no sample to consume: {total_samples}")
        if consumed_samples >= total_samples:
            raise RuntimeError("no samples left to consume")
        if data_parallel_rank >= data_parallel_size:
            raise RuntimeError(
                f"data_parallel_rank {data_parallel_rank} "
                f"out of range (size {data_parallel_size})"
            )
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size
        )
        self.drop_last = drop_last

    def __len__(self) -> int:
        return self.total_samples

    def get_start_end_idx(self):
        start = self.data_parallel_rank * self.micro_batch_size
        return start, start + self.micro_batch_size

    def __iter__(self) -> Iterator[np.ndarray]:
        batch = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.micro_batch_times_data_parallel_size:
                s, e = self.get_start_end_idx()
                yield np.asarray(batch[s:e])
                batch = []
        if batch and not self.drop_last:
            s, e = self.get_start_end_idx()
            yield np.asarray(batch[s:e])


class MegatronPretrainingRandomSampler:
    """Shuffled epoch-bucketed sampler (_batchsampler.py:94-149): epoch =
    consumed // active-samples, per-epoch permutation seeded by the epoch,
    each DP rank permutes its own contiguous bucket."""

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        micro_batch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
    ):
        if total_samples <= 0:
            raise RuntimeError(f"no sample to consume: {total_samples}")
        if data_parallel_rank >= data_parallel_size:
            raise RuntimeError("data_parallel_rank out of range")
        if total_samples < micro_batch_size * data_parallel_size:
            raise RuntimeError(
                f"total_samples {total_samples} smaller than one global step "
                f"(micro_batch_size*dp = {micro_batch_size * data_parallel_size})"
            )
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size
        )
        self.last_batch_size = (
            self.total_samples % self.micro_batch_times_data_parallel_size
        )

    def __len__(self) -> int:
        return self.total_samples

    def __iter__(self) -> Iterator[np.ndarray]:
        active = self.total_samples - self.last_batch_size
        self.epoch = self.consumed_samples // active
        bucket = active // self.data_parallel_size
        offset = self.data_parallel_rank * bucket
        current_epoch_samples = self.consumed_samples % active
        assert current_epoch_samples % self.micro_batch_times_data_parallel_size == 0

        g = np.random.default_rng(self.epoch)
        shuffled = g.permutation(bucket) + offset
        start = current_epoch_samples // self.data_parallel_size
        batch = []
        for idx in shuffled[start:]:
            batch.append(int(idx))
            if len(batch) == self.micro_batch_size:
                self.consumed_samples += self.micro_batch_times_data_parallel_size
                yield np.asarray(batch)
                batch = []


def get_kth_microbatch(batch, k: int, num_microbatches: int):
    """Slice microbatch ``k`` out of a global batch tree (dicts, lists and
    tuples of arrays or tensors) along dim 0
    (pipeline_parallel/utils.py:122+)."""
    if not 0 <= k < num_microbatches:
        raise ValueError(f"k={k} out of range for {num_microbatches} microbatches")

    def _slice(x):
        if x.shape[0] % num_microbatches:
            raise ValueError(
                f"batch dim {x.shape[0]} not divisible by "
                f"num_microbatches {num_microbatches}"
            )
        m = x.shape[0] // num_microbatches
        return x[k * m : (k + 1) * m]

    def walk(t):
        if isinstance(t, dict):
            return {key: walk(v) for key, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return _slice(t)

    return walk(batch)
