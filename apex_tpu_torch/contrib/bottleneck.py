"""The frozen-BatchNorm ResNet bottleneck (port of
``apex_tpu/contrib/bottleneck.py``, the counterpart of apex's
``fast_bottleneck`` extension).

The reference module serves detection backbones whose BatchNorm is
frozen: each BN collapses into a per-channel scale and bias
(:func:`fold_batchnorm`), applied by :class:`FrozenBatchNorm`.
:class:`FastBottleneck` is the port's :class:`~apex_tpu_torch.models.
resnet.Bottleneck` with the norm pinned to :class:`FrozenBatchNorm`: the
same v1.5 stride placement, downsample rule and parameter names, so the two
cannot drift. The scale/bias epilogues, the ReLUs and the residual add are
plain PyTorch here, as they are plain XLA in the reference (no Pallas
kernel).

:class:`SpatialBottleneck` is the spatially parallel block (apex's
``SpatialBottleneck``): each rank of a mesh axis holds a strip of rows (H)
of the activations, and before the 3x3 conv it swaps one halo row with
each neighbour through ``collectives.ppermute_shift``; the strips at the
ends pad with zeros, as the serial conv does. The reference gets the same
split from GSPMD, which inserts the halo exchange itself
(``tests/test_bottleneck.py:111-131``).

Not ported here: ``assert_epilogues_fused``, which reads XLA's compiled
HLO (the port has no counterpart of that IR; ROADMAP Queue 1 item 21,
with ``lint/``'s jaxpr analyzers as ``torch.fx`` / ``torch.export`` graph
passes).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.models.resnet import Bottleneck
from apex_tpu_torch.parallel import collectives

__all__ = ["FrozenBatchNorm", "FastBottleneck", "SpatialBottleneck",
           "fold_batchnorm"]


def fold_batchnorm(scale: torch.Tensor, bias: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trained BN statistics as an inference scale and bias
    (``FrozenBatchNorm2d.get_scale_bias``): ``y = x * s + b`` with
    ``s = scale / sqrt(var + eps)`` and ``b = bias - mean * s``."""
    s = scale * torch.rsqrt(var + eps)
    return s, bias - mean * s


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine parameters
    (``FrozenBatchNorm2d``): ``x * scale + bias`` per channel, computed
    **in x's dtype** (bf16 under O2, unlike the live BN's fp32), then the
    ReLU with ``fuse_relu``. ``scale`` ones and ``bias`` zeros, fp32.

    Takes the port's :class:`~apex_tpu_torch.parallel.SyncBatchNorm`
    surface, so it fits the ResNet's ``norm_cls``: ``channel_last`` picks
    the channel dim as there (the last dim, else dim 1: the port's ResNet
    runs NCHW views); ``momentum``, ``axis_name`` and ``group_size`` are
    accepted and ignored (frozen statistics have no momentum and nothing
    to synchronise), and so is ``use_running_average``. Module names carry
    the ``bn`` marker, so amp's ``cast_params`` keeps the parameters fp32
    as it keeps a live BN's."""

    affine = True  # SyncBatchNorm's flags, as the ResNet's loaders read them
    track_running_stats = False

    def __init__(self, num_features: int, fuse_relu: bool = False,
                 momentum: float = 0.1, axis_name: Optional[str] = None,
                 group_size: Optional[int] = None, channel_last: bool = True,
                 device: DeviceLike = None):
        super().__init__()
        del momentum, axis_name, group_size  # frozen: nothing to update
        dev = resolve_device(device)
        self.num_features = int(num_features)
        self.fuse_relu = fuse_relu
        self.channel_last = channel_last
        self.scale = nn.Parameter(torch.ones(num_features, device=dev))
        self.bias = nn.Parameter(torch.zeros(num_features, device=dev))

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        c_ax = (x.dim() - 1) if self.channel_last else min(1, x.dim() - 1)
        if x.shape[c_ax] != self.num_features:
            raise ValueError(f"channel dim {x.shape[c_ax]} != num_features "
                             f"{self.num_features}")
        shape = [1] * x.dim()
        shape[c_ax] = self.num_features
        y = x * self.scale.to(x.dtype).reshape(shape) \
            + self.bias.to(x.dtype).reshape(shape)
        return torch.relu(y) if self.fuse_relu else y


class FastBottleneck(Bottleneck):
    """The 1x1 -> 3x3 -> 1x1 bottleneck with frozen-BN epilogues and the
    residual add + ReLU (apex's ``Bottleneck``), over NCHW activations as
    the port's ResNet passes them. A passed ``norm`` (the ResNet's block
    wiring always passes one) is ignored: the block is frozen by
    construction. Standalone, it runs on the card unless ``device="cpu"``,
    its weights drawn from ``gen`` or, without one, from seed 0."""

    def __init__(self, cin: int, filters: int, strides: int = 1, norm=None,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 gen: Optional[torch.Generator] = None):
        del norm  # documented: ignored, always frozen
        dev = resolve_device(device)
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(0)
        super().__init__(cin, filters, strides,
                         partial(FrozenBatchNorm, channel_last=False,
                                 device=dev),
                         dtype, dev, gen)


class SpatialBottleneck(FastBottleneck):
    """:class:`FastBottleneck` over a strip of rows: ``forward(x)`` takes
    this rank's rows ``[r * h, (r + 1) * h)`` of the NCHW activations, the
    ranks of ``spatial_axis`` (a mesh axis) holding consecutive strips in
    axis order, and returns the same rows of the serial block's output.
    The 1x1 convs, the frozen norms and the residual are per pixel; the
    3x3 conv reads one row past each edge of the strip, which the
    neighbours send (two ``ppermute_shift`` calls a block). Stride 1 only:
    a strided 3x3 conv would need strips aligned to the stride."""

    def __init__(self, cin: int, filters: int, strides: int = 1, norm=None,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 gen: Optional[torch.Generator] = None,
                 spatial_axis: str = "data"):
        if strides != 1:
            raise ValueError("SpatialBottleneck takes stride 1 only")
        super().__init__(cin, filters, strides, norm, dtype, device, gen)
        self.spatial_axis = spatial_axis

    def forward(self, x, use_running_average: Optional[bool] = None):
        axis = self.spatial_axis
        y = self.bn1(self.conv1(x))
        # rank i gets rank i-1's last row and rank i+1's first row
        above = collectives.ppermute_shift(y[:, :, -1:], axis, 1)
        below = collectives.ppermute_shift(y[:, :, :1], axis, -1)
        idx, n = collectives.axis_rank(axis), collectives.axis_size(axis)
        if idx == 0:
            above = torch.zeros_like(above)
        if idx == n - 1:
            below = torch.zeros_like(below)
        y = torch.cat([above, y, below], dim=2)
        y = F.conv2d(y, self.conv2.weight.to(self.conv2.dtype), None, 1,
                     (0, 1))
        y = self.bn3(self.conv3(self.bn2(y)))
        residual = x
        if self.conv_ds is not None:
            residual = self.bn_ds(self.conv_ds(x))
        return torch.relu(y + residual)
