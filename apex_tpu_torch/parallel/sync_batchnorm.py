"""Batch normalization, the local path of
``apex_tpu/parallel/sync_batchnorm.py``.

:func:`sync_moments` / :func:`sync_batch_norm` and :class:`SyncBatchNorm`
(``sync_batchnorm.py:57-194``) with ``axis_name=None``: the statistics of the
batch on this device. Synchronising them over a process group
(``axis_name`` / ``group_size``, which raise ``NotImplementedError`` here)
and ``convert_syncbn_model`` come with data parallelism (ROADMAP Queue 1
item 9).

As in the reference, the moments are ``E[x]`` and ``E[x^2] - E[x]^2`` in
fp32 (clamped at 0; not Welford), the output is computed in fp32 with the
ReLU (``fuse_relu``) before the cast back to the input's dtype, and the
running variance takes the *unbiased* batch variance.

Training-mode BN is the :class:`BatchNormFn` autograd Function: autograd
through that formula in eager PyTorch would keep several fp32 copies of
every activation; the Function saves only the input (in its own dtype) and
the fp32 per-channel mean and rstd, and its backward is the closed form
``dx = rstd * gamma * (dy - mean(dy) - x^ * mean(dy * x^))`` per channel,
with the ReLU mask recomputed from the saved input. The reference is plain
XLA here, so this is plain PyTorch: no kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device

_DP_LATER = ("BatchNorm statistics synchronised over a process group "
             "(axis_name / group_size) come with data parallelism, ROADMAP "
             "Queue 1 item 9")


def _check_local(axis_name, group_size) -> None:
    if axis_name is not None or group_size is not None:
        raise NotImplementedError(f"axis_name={axis_name!r}, group_size="
                                  f"{group_size!r}: {_DP_LATER}")


def sync_moments(x: torch.Tensor, reduce_dims: Sequence[int],
                 axis_name: Optional[str] = None,
                 group_size: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """``(mean, var, count)`` over ``reduce_dims`` in fp32 (``sync_moments``,
    ``sync_batchnorm.py:57-82``); the variance is ``E[x^2] - E[x]^2``
    clamped at 0. Local only: a mesh axis raises."""
    _check_local(axis_name, group_size)
    dims = tuple(reduce_dims)
    count = 1
    for d in dims:
        count *= x.shape[d]
    mean, var = _moments(x.float(), dims, count)
    return mean, var, float(count)


def _moments(x32: torch.Tensor, dims, count: int):
    """fp32 ``(E[x], max(E[x^2] - E[x]^2, 0))`` over ``dims``."""
    mean = x32.sum(dims) / count
    var = torch.clamp_min(x32.square().sum(dims) / count - mean.square(),
                          0.0)
    return mean, var


def _f32_copy(t: torch.Tensor) -> torch.Tensor:
    """A fresh fp32 copy (``.float()`` of an fp32 tensor is the tensor)."""
    return t.clone() if t.dtype == torch.float32 else t.float()


def _bshape(x: torch.Tensor, channel_axis: int):
    shape = [1] * x.dim()
    shape[channel_axis] = x.shape[channel_axis]
    return shape


def sync_batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                    weight: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], eps: float,
                    channel_axis: int, fuse_relu: bool = False
                    ) -> torch.Tensor:
    """Normalize + affine + optional ReLU in fp32, cast back to x's dtype
    (``sync_batch_norm``, ``sync_batchnorm.py:85-107``); differentiable by
    autograd (eval mode uses it with the running stats)."""
    shape = _bshape(x, channel_axis)
    y = (x.float() - mean.reshape(shape)) * torch.rsqrt(
        var.reshape(shape) + eps)
    if weight is not None:
        y = y * weight.float().reshape(shape)
    if bias is not None:
        y = y + bias.float().reshape(shape)
    if fuse_relu:
        y = torch.relu(y)
    return y.to(x.dtype)


class BatchNormFn(torch.autograd.Function):
    """Training-mode BN over the batch's own moments. Returns ``(y, mean,
    var)``; only y is differentiable (the reference stops the gradient at
    the running-stat update). Saves x and the fp32 mean and rstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, channel_axis, fuse_relu):
        dims = tuple(d for d in range(x.dim()) if d != channel_axis)
        shape = _bshape(x, channel_axis)
        count = x.numel() // x.shape[channel_axis]
        # sync_moments and sync_batch_norm on one fp32 copy of x, in place
        x32 = _f32_copy(x)
        mean, var = _moments(x32, dims, count)
        rstd = torch.rsqrt(var + eps)
        y = x32.sub_(mean.reshape(shape)).mul_(rstd.reshape(shape))
        if weight is not None:
            y.mul_(weight.float().reshape(shape))
        if bias is not None:
            y.add_(bias.float().reshape(shape))
        if fuse_relu:
            y.relu_()
        y = y.to(x.dtype)
        ctx.save_for_backward(x, mean, rstd, weight, bias)
        ctx.channel_axis = channel_axis
        ctx.fuse_relu = fuse_relu
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, mean, rstd, weight, bias = ctx.saved_tensors
        c_ax = ctx.channel_axis
        shape = _bshape(x, c_ax)
        dims = tuple(d for d in range(x.dim()) if d != c_ax)
        count = x.numel() // x.shape[c_ax]
        xhat = _f32_copy(x).sub_(mean.reshape(shape)).mul_(
            rstd.reshape(shape))
        g = _f32_copy(gy)
        if ctx.fuse_relu:
            pre = xhat
            if weight is not None:
                pre = pre * weight.float().reshape(shape)
            if bias is not None:
                pre = pre + bias.float().reshape(shape)
            g.masked_fill_(~(pre > 0), 0.0)  # jax.nn.relu: grad where x > 0
            del pre
        sum_g = g.sum(dims)
        sum_gx = (g * xhat).sum(dims)
        scale = rstd if weight is None else rstd * weight.float()
        dx = None
        if ctx.needs_input_grad[0]:
            # rstd * gamma * (g - mean(g) - x^ * mean(g * x^)), in place
            dx = g.sub_(xhat.mul_((sum_gx / count).reshape(shape)))
            dx.sub_((sum_g / count).reshape(shape))
            dx = dx.mul_(scale.reshape(shape)).to(x.dtype)
        dw = sum_gx.to(weight.dtype) if weight is not None \
            and ctx.needs_input_grad[1] else None
        db = sum_g.to(bias.dtype) if bias is not None \
            and ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None


class SyncBatchNorm(nn.Module):
    """BatchNorm with the reference's surface (``SyncBatchNorm``,
    ``sync_batchnorm.py:110-194``), local statistics only.

    Parameters ``scale`` / ``bias`` (``affine``) in ``param_dtype``; buffers
    ``mean``, ``var`` (fp32) and ``num_batches_tracked`` (int32) when
    ``track_running_stats``. ``channel_last`` puts the channels on the last
    dim (NHWC), else on dim 1. ``forward(x, use_running_average=None)``:
    None means ``not self.training``; the running stats are used only when
    tracked, as in the reference. Unlike flax, the width is needed up
    front: ``num_features`` is required."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: Optional[float] = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name: Optional[str] = None,
                 group_size: Optional[int] = None,
                 channel_last: bool = False, fuse_relu: bool = False,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        _check_local(axis_name, group_size)
        if num_features is None:
            raise ValueError("the port's SyncBatchNorm needs num_features")
        dev = resolve_device(device)
        self.num_features = int(num_features)
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.channel_last = channel_last
        self.fuse_relu = fuse_relu
        if affine:
            self.scale = nn.Parameter(torch.ones(
                num_features, dtype=param_dtype, device=dev))
            self.bias = nn.Parameter(torch.zeros(
                num_features, dtype=param_dtype, device=dev))
        else:
            self.register_parameter("scale", None)
            self.register_parameter("bias", None)
        if track_running_stats:
            self.register_buffer("mean", torch.zeros(
                num_features, dtype=torch.float32, device=dev))
            self.register_buffer("var", torch.ones(
                num_features, dtype=torch.float32, device=dev))
            self.register_buffer("num_batches_tracked", torch.zeros(
                (), dtype=torch.int32, device=dev))
        else:
            self.mean = self.var = self.num_batches_tracked = None

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        c_ax = (x.dim() - 1) if self.channel_last else min(1, x.dim() - 1)
        if x.shape[c_ax] != self.num_features:
            raise ValueError(f"channel dim {x.shape[c_ax]} != num_features "
                             f"{self.num_features}")
        if use_running_average is None:
            use_running_average = not self.training
        if use_running_average and self.track_running_stats:
            return sync_batch_norm(x, self.mean, self.var, self.scale,
                                   self.bias, self.eps, c_ax, self.fuse_relu)
        y, mean, var = BatchNormFn.apply(x, self.scale, self.bias, self.eps,
                                         c_ax, self.fuse_relu)
        if self.track_running_stats:
            self._update_running(mean, var, x.numel() // x.shape[c_ax])
        return y

    @torch.no_grad()
    def _update_running(self, mean, var, count: int) -> None:
        """torch semantics: ``running <- (1-m) running + m batch`` with the
        unbiased batch variance; ``momentum=None`` is the cumulative
        average keyed on ``num_batches_tracked``."""
        if self.momentum is None:
            m = 1.0 / (self.num_batches_tracked.float() + 1.0)
        else:
            m = self.momentum
        unbias = count / max(count - 1.0, 1.0)
        self.mean.copy_((1 - m) * self.mean + m * mean)
        self.var.copy_((1 - m) * self.var + m * (var * unbias))
        self.num_batches_tracked.add_(1)
