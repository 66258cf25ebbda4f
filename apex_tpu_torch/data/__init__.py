"""Data loading of the port (``apex_tpu/data``)."""

from apex_tpu_torch.data.loader import NpyBatchLoader, PrefetchIterator

__all__ = ["NpyBatchLoader", "PrefetchIterator"]
