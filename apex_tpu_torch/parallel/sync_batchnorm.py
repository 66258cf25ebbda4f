"""Batch normalization with statistics synchronised over a process group
(port of ``apex_tpu/parallel/sync_batchnorm.py``; reference:
apex/parallel/sync_batchnorm.py and optimized_sync_batchnorm.py).

:func:`sync_moments` / :func:`sync_batch_norm`, :class:`SyncBatchNorm`
(``sync_batchnorm.py:57-194``) and :func:`convert_syncbn_model`
(``:197-269``). ``axis_name`` names the mesh axis (or axes) whose ranks
share the statistics (``process_group``); ``group_size`` cuts it into
contiguous blocks of that many ranks (``create_syncbn_process_group``,
``_index_groups``); without ``axis_name`` the statistics are the local
batch's.

As in the reference, the moments are ``E[x]`` and ``E[x^2] - E[x]^2`` in
fp32 (clamped at 0; not Welford), combined across ranks by one
``all_reduce`` of (sum, sum of squares, count) -- the count-weighted merge
that handles uneven per-rank batches exactly. The output is computed in
fp32 with the ReLU (``fuse_relu``) before the cast back to the input's
dtype, and the running variance takes the *unbiased* variance of the
global batch: under sync BN the running statistics are the same on every
rank, under local BN each rank keeps its own.

Training-mode BN is the :class:`BatchNormFn` autograd Function: autograd
through that formula in eager PyTorch would keep several fp32 copies of
every activation; the Function saves only the input (in its own dtype) and
the fp32 per-channel mean and rstd, and its backward is the closed form
``dx = rstd * gamma * (dy - mean(dy) - x^ * mean(dy * x^))`` per channel,
the two means over the whole group: one ``all_reduce`` of (sum dy, sum dy
x^), the transpose of the forward's (the reference differentiates through
its psum; ``optimized_sync_batchnorm_kernel.py:99-111``). The parameter
grads are this rank's own sums, which data parallelism then averages. The
ReLU mask is recomputed from the saved input. Plain PyTorch and
collectives: the reference is plain XLA, no kernel.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.parallel import collectives


def _index_groups(axis_name, group_size: Optional[int]
                  ) -> Optional[List[List[int]]]:
    """The axis's positions cut into contiguous blocks of ``group_size``
    (``sync_batchnorm.py:42-55``: ``world_size % group_size == 0``)."""
    if group_size is None:
        return None
    world = collectives.axis_size(axis_name)
    if world % group_size != 0:
        raise ValueError(f"axis size {world} not divisible by group_size "
                         f"{group_size}")
    return [list(range(g * group_size, (g + 1) * group_size))
            for g in range(world // group_size)]


def _group_sums(parts: Sequence[torch.Tensor], axis_name, group_size):
    """``parts`` (fp32, 1-d) summed over the group by one ``all_reduce``;
    as they are without ``axis_name``."""
    if axis_name is None:
        return list(parts)
    _index_groups(axis_name, group_size)  # the divisibility check
    flat = collectives.psum(torch.cat(parts), axis_name,
                            group_size=group_size)
    return list(flat.split([p.numel() for p in parts]))


def sync_moments(x: torch.Tensor, reduce_dims: Sequence[int],
                 axis_name=None, group_size: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mean, var, count)`` in fp32 over ``reduce_dims`` and the group
    (``sync_moments``, ``sync_batchnorm.py:57-82``); the variance is
    ``E[x^2] - E[x]^2`` clamped at 0, ``count`` a 0-d fp32 tensor."""
    return _moments(x.float(), tuple(reduce_dims), axis_name, group_size)


def _moments(x32: torch.Tensor, dims, axis_name, group_size):
    """fp32 ``(E[x], max(E[x^2] - E[x]^2, 0), count)`` over ``dims`` and
    the group: one ``all_reduce`` of (sum, sum of squares, count)."""
    n = 1
    for d in dims:
        n *= x32.shape[d]
    s, sq, count = _group_sums(
        [x32.sum(dims), x32.square().sum(dims),
         torch.full((1,), float(n), device=x32.device)],
        axis_name, group_size)
    mean = s / count
    var = torch.clamp_min(sq / count - mean.square(), 0.0)
    return mean, var, count.reshape(())


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
    """Training-mode BN over the moments of the group's batch (this rank's
    alone without ``axis_name``). Returns ``(y, mean, var, count)``; only y
    is differentiable (the reference stops the gradient at the running-stat
    update). Saves x, the fp32 mean and rstd and the group's count."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, channel_axis, fuse_relu,
                axis_name=None, group_size=None):
        dims = tuple(d for d in range(x.dim()) if d != channel_axis)
        shape = _bshape(x, channel_axis)
        # sync_moments and sync_batch_norm on one fp32 copy of x, in place
        x32 = _f32_copy(x)
        mean, var, count = _moments(x32, dims, axis_name, group_size)
        rstd = torch.rsqrt(var + eps)
        y = x32.sub_(mean.reshape(shape)).mul_(rstd.reshape(shape))
        if weight is not None:
            y.mul_(weight.float().reshape(shape))
        if bias is not None:
            y.add_(bias.float().reshape(shape))
        if fuse_relu:
            y.relu_()
        y = y.to(x.dtype)
        ctx.save_for_backward(x, mean, rstd, weight, bias, count)
        ctx.channel_axis = channel_axis
        ctx.fuse_relu = fuse_relu
        ctx.group = (axis_name, group_size)
        ctx.mark_non_differentiable(mean, var, count)
        return y, mean, var, count

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar, _gcount):
        x, mean, rstd, weight, bias, count = ctx.saved_tensors
        c_ax = ctx.channel_axis
        shape = _bshape(x, c_ax)
        dims = tuple(d for d in range(x.dim()) if d != c_ax)
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
        dw = sum_gx.to(weight.dtype) if weight is not None \
            and ctx.needs_input_grad[1] else None
        db = sum_g.to(bias.dtype) if bias is not None \
            and ctx.needs_input_grad[2] else None
        # the means of dy and dy * x^ over the group's batch
        sum_g, sum_gx = _group_sums([sum_g, sum_gx], *ctx.group)
        scale = rstd if weight is None else rstd * weight.float()
        dx = None
        if ctx.needs_input_grad[0]:
            # rstd * gamma * (g - mean(g) - x^ * mean(g * x^)), in place
            dx = g.sub_(xhat.mul_((sum_gx / count).reshape(shape)))
            dx.sub_((sum_g / count).reshape(shape))
            dx = dx.mul_(scale.reshape(shape)).to(x.dtype)
        return dx, dw, db, None, None, None, None, None


class SyncBatchNorm(nn.Module):
    """BatchNorm with the reference's surface (``SyncBatchNorm``,
    ``sync_batchnorm.py:110-194``): statistics over the group of
    ``axis_name`` (blocks of ``group_size`` ranks along it), or local
    without it. The group is looked up at each call, on the installed mesh.

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
        if num_features is None:
            raise ValueError("the port's SyncBatchNorm needs num_features")
        dev = resolve_device(device)
        self.num_features = int(num_features)
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.axis_name = axis_name
        self.group_size = group_size
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
        y, mean, var, count = BatchNormFn.apply(
            x, self.scale, self.bias, self.eps, c_ax, self.fuse_relu,
            self.axis_name, self.group_size)
        if self.track_running_stats:
            self._update_running(mean, var, count)
        return y

    @torch.no_grad()
    def _update_running(self, mean, var, count: torch.Tensor) -> None:
        """torch semantics: ``running <- (1-m) running + m batch`` with the
        unbiased variance of the group's batch (``count`` values);
        ``momentum=None`` is the cumulative average keyed on
        ``num_batches_tracked``."""
        if self.momentum is None:
            m = 1.0 / (self.num_batches_tracked.float() + 1.0)
        else:
            m = self.momentum
        unbias = count / torch.clamp_min(count - 1.0, 1.0)
        self.mean.copy_((1 - m) * self.mean + m * mean)
        self.var.copy_((1 - m) * self.var + m * (var * unbias))
        self.num_batches_tracked.add_(1)


def convert_syncbn_model(module: nn.Module, axis_name=None,
                         group_size: Optional[int] = None,
                         channel_last: Optional[bool] = None) -> nn.Module:
    """Every ``torch.nn`` BatchNorm in ``module`` (and every
    :class:`SyncBatchNorm`) synchronised over ``axis_name`` / ``group_size``
    (apex/parallel/__init__.py:21-56; ``sync_batchnorm.py:197-269``).

    A ``torch.nn`` ``BatchNorm1d/2d/3d`` becomes a :class:`SyncBatchNorm`
    on its device with its eps, momentum, affine and tracking flags, its
    weight, bias and running statistics copied (channels on dim 1, or
    last with ``channel_last=True``); a :class:`SyncBatchNorm` takes the
    new group in place (and ``channel_last`` when given). Returns the
    module, converted in place; a BatchNorm passed alone comes back as
    its replacement."""

    def convert(m: nn.Module) -> nn.Module:
        if isinstance(m, SyncBatchNorm):
            m.axis_name, m.group_size = axis_name, group_size
            if channel_last is not None:
                m.channel_last = channel_last
            return m
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            ref = m.weight if m.weight is not None else m.running_mean
            dev = ref.device if ref is not None else "cpu"
            out = SyncBatchNorm(
                m.num_features, eps=m.eps, momentum=m.momentum,
                affine=m.affine, track_running_stats=m.track_running_stats,
                axis_name=axis_name, group_size=group_size,
                channel_last=bool(channel_last),
                param_dtype=(m.weight.dtype if m.weight is not None
                             else torch.float32), device=dev)
            with torch.no_grad():
                if m.affine:
                    out.scale.copy_(m.weight)
                    out.bias.copy_(m.bias)
                if m.track_running_stats:
                    out.mean.copy_(m.running_mean)
                    out.var.copy_(m.running_var)
                    out.num_batches_tracked.copy_(m.num_batches_tracked)
            out.train(m.training)
            return out
        for name, child in m.named_children():
            new = convert(child)
            if new is not child:
                setattr(m, name, new)
        return m

    return convert(module)
