"""Microbatch calculators (port of ``apex_tpu/transformer/microbatches.py``;
reference: apex/transformer/microbatches.py:21-172).

Host-side schedule arithmetic: how many microbatches per step, with optional
linear global-batch-size ramp-up. Pure Python, the reference's errors and
ramp arithmetic, consumed by the pipeline schedules and the data samplers.
"""

from __future__ import annotations

from typing import List, Optional


def build_num_microbatches_calculator(
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
    rampup_batch_size: Optional[List[int]] = None,
):
    """Factory (reference :21-56): returns Constant or Rampup calculator.

    ``rampup_batch_size`` = [start_size, increment, ramp_samples].
    """
    if rampup_batch_size is None:
        return ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size
        )
    start, incr, samples = rampup_batch_size
    return RampupBatchsizeNumMicroBatches(
        start, incr, samples, global_batch_size, micro_batch_size,
        data_parallel_size,
    )


class NumMicroBatchesCalculator:
    num_micro_batches: int
    current_global_batch_size: int

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples: int, consistency_check: bool) -> None:
        raise NotImplementedError


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    """reference :59-84."""

    def __init__(self, global_batch_size, micro_batch_size, data_parallel_size):
        micro_times_dp = micro_batch_size * data_parallel_size
        if global_batch_size % micro_times_dp != 0:
            raise ValueError(
                f"global batch size ({global_batch_size}) is not divisible by "
                f"micro batch size ({micro_batch_size}) times data parallel "
                f"size ({data_parallel_size})"
            )
        self.num_micro_batches = global_batch_size // micro_times_dp
        if self.num_micro_batches < 1:
            raise ValueError("number of microbatches must be at least 1")
        self.current_global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size

    def update(self, consumed_samples, consistency_check):
        pass


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    """Linear global-batch ramp (reference :87-172): batch grows from
    ``start_batch_size`` by ``batch_size_increment`` per
    ``rampup_samples / steps`` consumed samples."""

    def __init__(
        self,
        start_batch_size,
        batch_size_increment,
        ramup_samples,
        global_batch_size,
        micro_batch_size,
        data_parallel_size,
    ):
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.global_batch_size = global_batch_size
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size
        )
        if start_batch_size % self.micro_batch_times_data_parallel_size != 0:
            raise ValueError("start batch size not divisible by mb*dp")
        if global_batch_size % self.micro_batch_times_data_parallel_size != 0:
            raise ValueError(
                f"global batch size ({global_batch_size}) not divisible by "
                f"micro-batch size x data-parallel size "
                f"({self.micro_batch_times_data_parallel_size})"
            )
        diff = global_batch_size - start_batch_size
        if diff < 0 or diff % batch_size_increment != 0:
            raise ValueError(
                "global batch size must be start + k*increment for integer k"
            )
        num_increments = diff // batch_size_increment
        self.rampup_samples_per_increment = (
            self.ramup_samples / num_increments if num_increments > 0 else 0
        )
        self.update(0, False)

    def update(self, consumed_samples, consistency_check):
        if consumed_samples > self.ramup_samples or self.rampup_samples_per_increment == 0:
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment
            )
            self.current_global_batch_size = min(
                self.current_global_batch_size, self.global_batch_size
            )
        mbdp = self.micro_batch_times_data_parallel_size
        # consistency check BEFORE rounding (reference :158-165 raises when
        # the ramped size is not a multiple of mb*dp and checking is on).
        if consistency_check and self.current_global_batch_size % mbdp != 0:
            raise RuntimeError(
                f"ramped global batch size ({self.current_global_batch_size}) "
                f"is not divisible by micro-batch size x data-parallel size "
                f"({mbdp})"
            )
        # otherwise round down to a multiple of mb*dp
        self.current_global_batch_size = max(
            mbdp, (self.current_global_batch_size // mbdp) * mbdp
        )
        self.num_micro_batches = self.current_global_batch_size // mbdp
