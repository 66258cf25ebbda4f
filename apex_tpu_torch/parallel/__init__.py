"""Parallel layers of the port (``apex_tpu/parallel``): the local path of
SyncBatchNorm so far; process groups and ``convert_syncbn_model`` come
with data parallelism (ROADMAP Queue 1 item 9)."""

from apex_tpu_torch.parallel.sync_batchnorm import (
    BatchNormFn,
    SyncBatchNorm,
    sync_batch_norm,
    sync_moments,
)

__all__ = ["BatchNormFn", "SyncBatchNorm", "sync_batch_norm",
           "sync_moments"]
