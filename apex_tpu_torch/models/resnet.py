"""ResNet v1.5 (port of ``apex_tpu/models/resnet.py``), the convnet of the
ImageNet recipe (``examples/imagenet/main_amp.py``, BASELINE configs 1-2).

``ResNet.forward(images)`` takes NHWC images, as the JAX model does, and
returns fp32 logits. ``images.permute(0, 3, 1, 2)`` of a contiguous NHWC
tensor is a ``channels_last`` NCHW view, so the convolutions run
channels-last on cuDNN; the conv weights are kept channels-last too. The
blocks, stride placement (stride 2 on the bottleneck's 3x3 conv), stem,
BN + ReLU fusion and the fp32 classifier are the reference's
(``resnet.py:46-165``):

- ``dtype`` is the compute dtype (flax's ``dtype``): the images and every
  conv weight are cast to it inside ``forward``, so O1 (fp32 params, bf16
  convs) works; under O2 the weights already are bf16. BatchNorm computes
  in fp32 and returns the conv's dtype; the global mean over H, W runs in
  the compute dtype; ``fc`` computes in fp32 on an fp32-cast input even
  when its weight is bf16.
- Module names are the reference's (``conv1``, ``bn1``, ``layer{i}_{j}``,
  ``conv_ds``, ``bn_ds``, ``fc``), so ``precision.cast_params`` keeps every
  ``bn*`` parameter fp32 under O2, as ``cast_params`` does in JAX.
- Weights come from the reference's initialisers: flax ``lecun_normal``
  (truncated normal at two deviations, variance 1/fan_in) for convs and
  ``fc``, zero ``fc`` bias, BN scale 1 and bias 0.
- :meth:`ResNet.params_from_numpy` loads a flax ``{"params",
  "batch_stats"}`` tree given as numpy (HWIO conv kernels, an ``(in, out)``
  Dense kernel) and :meth:`ResNet.to_numpy` gives it back.

``norm_cls`` swaps the norm wholesale, as the reference's does: it takes
the :class:`~apex_tpu_torch.parallel.SyncBatchNorm` constructor surface
(``momentum``, ``axis_name``, ``group_size``, ``channel_last``, ``device``
and ``fuse_relu``). :data:`ResNet50Frozen` / :data:`ResNet101Frozen` build
every block as ``contrib.bottleneck.FastBottleneck`` with
``norm_cls=FrozenBatchNorm`` (``resnet.py:168-180``): a tree with no
``batch_stats``, which ``params_from_numpy`` / ``to_numpy`` carry as the
reference's ``{"params"}``.

``axis_name`` / ``bn_group_size`` pass through to every norm: BN
statistics synchronised over that mesh axis (blocks of ``bn_group_size``
ranks along it), the reference's ``--sync-bn``. The downsample branch
is built when a block changes the channel count or has stride 2, which is
where the reference's shape test (``residual.shape != y.shape``) puts it for
every feature map larger than 1 x 1.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch._params import copy_array_
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

_CL = torch.channels_last


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int,
                  gen: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal()``: a normal truncated at +-2 deviations, scaled
    so the variance is ``1 / fan_in`` (``variance_scaling(1, "fan_in",
    "truncated_normal")``), sampled in place by the inverse CDF."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa: E731
    lo, hi = 2 * cdf(-2.0) - 1, 2 * cdf(2.0) - 1
    u = torch.rand(w.shape, generator=gen, device=w.device,
                   dtype=torch.float32)
    z = torch.special.erfinv(u * (hi - lo) + lo) * math.sqrt(2.0)
    w.copy_(z.clamp_(-2.0, 2.0) * std)
    return w


class Conv(nn.Module):
    """``nn.Conv(use_bias=False)`` over NCHW (channels-last) activations:
    ``weight`` (cout, cin, k, k), kept channels-last on the card, computed
    in ``dtype``.
    ``padding`` is symmetric; the reference's default ``"SAME"`` on its 1x1
    convs pads nothing."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32,
                 device=None, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        w = torch.empty(cout, cin, k, k, device=device)
        lecun_normal_(w, cin * k * k, gen)
        if w.is_cuda:
            w = w.contiguous(memory_format=_CL)
        self.weight = nn.Parameter(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(self.dtype), None, self.stride,
                        self.padding)


class Dense(nn.Module):
    """The fp32 classifier (``nn.Dense(dtype=jnp.float32)``): ``weight``
    (out, in) and ``bias``, both cast to fp32 with the input."""

    def __init__(self, cin: int, cout: int, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        w = torch.empty(cout, cin, device=device)
        lecun_normal_(w, cin, gen)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight.float(), self.bias.float())


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, strides: int = 1,
                 norm=None, dtype: torch.dtype = torch.float32,
                 device=None, gen: Optional[torch.Generator] = None):
        super().__init__()
        conv = partial(Conv, dtype=dtype, device=device, gen=gen)
        self.conv1 = conv(cin, filters, 3, strides, 1)
        self.bn1 = norm(filters, fuse_relu=True)
        self.conv2 = conv(filters, filters, 3, 1, 1)
        self.bn2 = norm(filters)
        self.conv_ds = self.bn_ds = None
        if strides != 1 or cin != filters:
            self.conv_ds = conv(cin, filters, 1, strides)
            self.bn_ds = norm(filters)

    def forward(self, x, use_running_average: Optional[bool] = None):
        y = self.bn1(self.conv1(x), use_running_average)
        y = self.bn2(self.conv2(y), use_running_average)
        residual = x
        if self.conv_ds is not None:
            residual = self.bn_ds(self.conv_ds(x), use_running_average)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here: v1.5) -> 1x1 residual block (ResNet-50+)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, strides: int = 1,
                 norm=None, dtype: torch.dtype = torch.float32,
                 device=None, gen: Optional[torch.Generator] = None):
        super().__init__()
        conv = partial(Conv, dtype=dtype, device=device, gen=gen)
        out = filters * self.expansion
        self.conv1 = conv(cin, filters, 1)
        self.bn1 = norm(filters, fuse_relu=True)
        self.conv2 = conv(filters, filters, 3, strides, 1)
        self.bn2 = norm(filters, fuse_relu=True)
        self.conv3 = conv(filters, out, 1)
        self.bn3 = norm(out)
        self.conv_ds = self.bn_ds = None
        if strides != 1 or cin != out:
            self.conv_ds = conv(cin, out, 1, strides)
            self.bn_ds = norm(out)

    def forward(self, x, use_running_average: Optional[bool] = None):
        y = self.bn1(self.conv1(x), use_running_average)
        y = self.bn2(self.conv2(y), use_running_average)
        y = self.bn3(self.conv3(y), use_running_average)
        residual = x
        if self.conv_ds is not None:
            residual = self.bn_ds(self.conv_ds(x), use_running_average)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """ResNet over NHWC images; ``forward(images) -> fp32 logits``.

    ``stage_sizes`` blocks of ``block_cls`` per stage at widths
    ``width * 2**i``; ``stem_pool`` chooses the ImageNet stem (7x7 stride 2
    and a 3x3 max pool) or the small-image one (3x3, no pool). BN momentum
    is 0.1; ``axis_name`` / ``bn_group_size`` synchronise every BN over
    that mesh axis (local BN without them). ``norm_cls`` is the
    norm's constructor (``SyncBatchNorm``'s surface). The images have 3
    channels (flax infers the count from the first input; the port builds
    its weights up front). Runs on the card unless ``device="cpu"``;
    weights from ``seed``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, width: int = 64,
                 axis_name: Optional[str] = None,
                 bn_group_size: Optional[int] = None,
                 norm_cls=SyncBatchNorm,
                 dtype: torch.dtype = torch.float32, stem_pool: bool = True,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.device, self.dtype, self.stem_pool = dev, dtype, stem_pool
        self.stage_sizes = tuple(stage_sizes)
        norm = partial(norm_cls, momentum=0.1, axis_name=axis_name,
                       group_size=bn_group_size, channel_last=False,
                       device=dev)
        if stem_pool:
            self.conv1 = Conv(3, width, 7, 2, 3, dtype, dev, gen)
        else:
            self.conv1 = Conv(3, width, 3, 1, 1, dtype, dev, gen)
        self.bn1 = norm(width, fuse_relu=True)
        self.block_names = []
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                strides = 2 if (i > 0 and j == 0) else 1
                filters = width * 2 ** i
                name = f"layer{i + 1}_{j}"
                self.add_module(name, block_cls(cin, filters, strides, norm,
                                                dtype, dev, gen))
                self.block_names.append(name)
                cin = filters * block_cls.expansion
        self.fc = Dense(cin, num_classes, dev, gen)

    def forward(self, images: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 3, 1, 2)  # NCHW, channels-last
        if x.device.type == "cpu":
            # PyTorch's CPU backward of a strided 1x1 conv on a channels-last
            # fp32 input crashes (torch 2.13): the CPU runs NCHW-contiguous,
            # with contiguous weights
            x = x.contiguous()
        x = self.bn1(self.conv1(x), use_running_average)
        if self.stem_pool:
            x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf
        for name in self.block_names:
            x = getattr(self, name)(x, use_running_average)
        x = x.mean(dim=(2, 3))  # global average pool, in the compute dtype
        return self.fc(x)

    # -- parameters ---------------------------------------------------------

    def _tree_modules(self):
        """``(flax path, module)`` of every conv, norm and the
        classifier."""
        from apex_tpu_torch.contrib.bottleneck import FrozenBatchNorm

        for name, mod in self.named_modules():
            if isinstance(mod, (Conv, Dense, SyncBatchNorm,
                                FrozenBatchNorm)):
                yield tuple(name.split(".")), mod

    @torch.no_grad()
    def params_from_numpy(self, variables: Dict[str, Any]) -> "ResNet":
        """Load the JAX model's ``{"params", "batch_stats"}`` tree given as
        numpy arrays: HWIO conv kernels, the Dense kernel ``(in, out)``, BN
        ``scale``/``bias`` and ``mean``/``var``/``num_batches_tracked``
        (a frozen norm's ``scale``/``bias`` only: the frozen models' tree
        has no ``batch_stats``). Each tensor keeps its dtype and memory
        format; shapes must match."""
        params, stats = variables["params"], variables.get("batch_stats", {})

        def leaf(tree, path, key):
            for p in path:
                tree = tree[p]
            return np.asarray(tree[key])

        for path, mod in self._tree_modules():
            what = "/".join(path)
            if isinstance(mod, Conv):
                copy_array_(mod.weight, leaf(params, path, "kernel").transpose(
                    3, 2, 0, 1), what)
            elif isinstance(mod, Dense):
                copy_array_(mod.weight, leaf(params, path, "kernel").T, what)
                copy_array_(mod.bias, leaf(params, path, "bias"), what)
            else:
                if mod.affine:
                    copy_array_(mod.scale, leaf(params, path, "scale"), what)
                    copy_array_(mod.bias, leaf(params, path, "bias"), what)
                if mod.track_running_stats:
                    for key in ("mean", "var", "num_batches_tracked"):
                        copy_array_(getattr(mod, key),
                                    leaf(stats, path, key), what)
        return self

    @torch.no_grad()
    def to_numpy(self) -> Dict[str, Any]:
        """The ``{"params", "batch_stats"}`` tree in the reference's layout,
        as fp32 numpy (``num_batches_tracked`` int32); ``{"params"}`` alone
        where no norm tracks statistics (the frozen models)."""
        params: Dict[str, Any] = {}
        stats: Dict[str, Any] = {}

        def node(tree, path):
            for p in path:
                tree = tree.setdefault(p, {})
            return tree

        f32 = lambda t: t.detach().float().cpu().numpy()  # noqa: E731

        for path, mod in self._tree_modules():
            if isinstance(mod, Conv):
                node(params, path)["kernel"] = f32(mod.weight).transpose(
                    2, 3, 1, 0)
            elif isinstance(mod, Dense):
                node(params, path).update(kernel=f32(mod.weight).T,
                                          bias=f32(mod.bias))
            else:
                if mod.affine:
                    node(params, path).update(scale=f32(mod.scale),
                                              bias=f32(mod.bias))
                if mod.track_running_stats:
                    node(stats, path).update(
                        mean=f32(mod.mean), var=f32(mod.var),
                        num_batches_tracked=mod.num_batches_tracked.cpu()
                        .numpy())
        return {"params": params, "batch_stats": stats} if stats \
            else {"params": params}


def _resnet(stage_sizes, block_cls, **kw) -> ResNet:
    return ResNet(stage_sizes, block_cls, **kw)


ResNet18 = partial(_resnet, (2, 2, 2, 2), BasicBlock)
ResNet34 = partial(_resnet, (3, 4, 6, 3), BasicBlock)
ResNet50 = partial(_resnet, (3, 4, 6, 3), Bottleneck)
ResNet101 = partial(_resnet, (3, 4, 23, 3), Bottleneck)
ResNet152 = partial(_resnet, (3, 8, 36, 3), Bottleneck)


def _frozen_resnet(stage_sizes, **kw) -> ResNet:
    """ResNet with every BN frozen to a per-channel scale and bias, the
    detection-backbone configuration of apex's fast_bottleneck extension:
    ``FastBottleneck`` blocks and a frozen stem norm (``_frozen_resnet``)."""
    from apex_tpu_torch.contrib.bottleneck import (
        FastBottleneck,
        FrozenBatchNorm,
    )

    return ResNet(stage_sizes, FastBottleneck, norm_cls=FrozenBatchNorm,
                  **kw)


ResNet50Frozen = partial(_frozen_resnet, (3, 4, 6, 3))
ResNet101Frozen = partial(_frozen_resnet, (3, 4, 23, 3))
