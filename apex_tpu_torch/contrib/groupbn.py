"""NHWC BatchNorm with the BN + add + ReLU epilogue (port of
``apex_tpu/contrib/groupbn.py``, the surface of apex's
``apex.contrib.groupbn``).

The implementation is the port's :class:`~apex_tpu_torch.parallel.
SyncBatchNorm` with ``channel_last=True`` (NHWC: the channels on the last
dim) and ``fuse_relu``; this module keeps the reference's constructor
(``BatchNorm2d_NHWC(planes, fuse_relu=..., bn_group=...)``) and the
``batch_norm_add_relu`` epilogue. Plain PyTorch, as the reference is plain
XLA: no kernel.

``bn_group > 1`` synchronises the statistics over blocks of ``bn_group``
ranks along the mesh axis ``axis_name`` (the CUDA-IPC peer group of the
reference's ``bnp`` becomes a ``torch.distributed`` sub-group). It needs
``axis_name``: without one it raises ``ValueError``, as the reference
does. With ``bn_group == 1`` the reference drops ``axis_name`` and the
statistics stay local; so does the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch._device import DeviceLike
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm


def BatchNorm2d_NHWC(planes: int, fuse_relu: bool = False, bn_group: int = 1,
                     axis_name: Optional[str] = None, eps: float = 1e-5,
                     momentum: float = 0.1,
                     device: DeviceLike = None) -> SyncBatchNorm:
    """The reference's factory (``batch_norm.py:BatchNorm2d_NHWC``): an
    NHWC :class:`SyncBatchNorm` of ``planes`` channels, on the card unless
    ``device="cpu"``."""
    if bn_group > 1 and axis_name is None:
        raise ValueError(
            "bn_group > 1 requires axis_name (the mesh axis carrying the "
            "peer group); without it stats would silently stay device-local")
    return SyncBatchNorm(
        num_features=planes,
        eps=eps,
        momentum=momentum,
        axis_name=axis_name if bn_group > 1 else None,
        group_size=bn_group if bn_group > 1 else None,
        channel_last=True,
        fuse_relu=fuse_relu,
        device=device,
    )


def batch_norm_add_relu(bn_out: torch.Tensor,
                        residual: torch.Tensor) -> torch.Tensor:
    """The BN + add + ReLU epilogue (``bnAddRelu``) on a BN output made
    without ``fuse_relu``."""
    return torch.relu(bn_out + residual)
