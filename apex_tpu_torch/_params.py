"""Loading a JAX parameter tree, given as numpy arrays, into the port's
modules (the ``params_from_numpy`` methods)."""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def copy_array_(param: torch.Tensor, arr, name: str) -> None:
    """Copy ``arr`` into ``param`` in place, in ``param``'s dtype and on its
    device. ``arr`` may be an ml_dtypes bfloat16 array (torch reads it as
    fp32 first). Shapes must match."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{name}: tree shape {tuple(arr.shape)} != module "
                         f"shape {tuple(param.shape)}")
    param.copy_(torch.from_numpy(np.array(arr)).to(param.dtype))
