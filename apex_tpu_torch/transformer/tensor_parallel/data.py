"""Input-data broadcast over the tensor-parallel axis (port of
``apex_tpu/transformer/tensor_parallel/data.py``; reference:
apex/transformer/tensor_parallel/data.py ``broadcast_data``).

Every rank along the axis ends with the ``src`` rank's copy of the tree
(one ``broadcast`` a leaf over the axis's process group), so the tensor-
parallel ranks of one data shard consume identical batches."""

from __future__ import annotations

from typing import Any

from apex_tpu_torch.parallel import collectives
from apex_tpu_torch.parallel.mesh import AXIS_MODEL


def broadcast_data(tree: Any, axis: str = AXIS_MODEL, src: int = 0) -> Any:
    """``src``'s leaves of ``tree`` on every rank of ``axis``."""
    return collectives.broadcast(tree, axis, src=src)
