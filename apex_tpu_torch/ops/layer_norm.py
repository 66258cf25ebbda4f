"""Fused LayerNorm / RMSNorm (port of ``apex_tpu/ops/layer_norm.py``).

``layer_norm`` and ``rms_norm`` keep the reference's contract: stats and
math are always fp32 whatever the input dtype, gamma/beta may be fp32 with
bf16 activations (the MixedFused contract), eps defaults to 1e-5, and the
affine-free and bias-free variants exist.

Both go through :class:`FusedNorm`, a ``torch.autograd.Function`` (the
reference's ``_fused_norm`` custom VJP). Its forward and backward each
dispatch by device: on a CUDA tensor they launch the hand-written kernels of
``csrc/layer_norm.cu`` (which replace ``_ln_fwd_kernel`` and
``_ln_bwd_kernel``) or raise; on a CPU tensor they take the plain versions
(:func:`layer_norm_reference` / :func:`layer_norm_bwd_reference`), so the
CPU tests run the same Function. Without a gradient to track (inference,
``no_grad``) the forward runs on its own, with no autograd bookkeeping: the
serving path issues 49 of these per decode tick.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch._device import check_device
from apex_tpu_torch.csrc import build


def _norm_stats_reference(x, w, b, eps, rms):
    """Plain forward: ``(y, mean, rstd)``, mean/rstd fp32 of shape
    ``x.shape[:-1]`` (mean is 0 for RMS), y in x's dtype (``_norm_xla``)."""
    x32 = x.float()
    if rms:
        mu = torch.zeros_like(x32[..., :1])
        var = x32.square().mean(-1, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        xhat = x32 * rstd
    else:
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        xhat = (x32 - mu) * rstd
    y = xhat
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype), mu[..., 0], rstd[..., 0]


def _norm_reference(x, w, b, eps, rms):
    return _norm_stats_reference(x, w, b, eps, rms)[0]


def layer_norm_reference(x, weight=None, bias=None, eps=1e-5):
    """Plain PyTorch LayerNorm over the last dim (fp32 stats)."""
    return _norm_reference(x, weight, bias, eps, rms=False)


def rms_norm_reference(x, weight=None, eps=1e-5):
    return _norm_reference(x, weight, None, eps, rms=True)


def layer_norm_bwd_reference(g, x, mean, rstd, weight=None, *,
                             rms: bool = False, has_bias: bool = False):
    """Plain backward, the arithmetic of ``_ln_bwd_kernel``
    (``layer_norm.py:85-107``): ``(dx, dgamma, dbeta)`` with dx in x's
    dtype and dgamma/dbeta fp32 sums over every row (None when there is no
    gamma / no beta)."""
    hidden = x.shape[-1]
    g32 = g.reshape(-1, hidden).float()
    x32 = x.reshape(-1, hidden).float()
    mu = mean.reshape(-1, 1)
    rs = rstd.reshape(-1, 1)
    xhat = (x32 - mu) * rs
    wg = g32 if weight is None else g32 * weight.float()
    c1 = (wg * xhat).mean(-1, keepdim=True)
    if rms:
        dx = rs * (wg - xhat * c1)
    else:
        c2 = wg.mean(-1, keepdim=True)
        dx = rs * (wg - c2 - xhat * c1)
    dw = (g32 * xhat).sum(0) if weight is not None else None
    db = g32.sum(0) if has_bias else None
    return dx.to(x.dtype).reshape(x.shape), dw, db


def _launch(x: torch.Tensor, weight: Optional[torch.Tensor],
            bias: Optional[torch.Tensor], eps: float, rms: bool):
    """Launch the forward kernel: ``(y, stats)`` with ``stats`` = mean rows
    then rstd rows, fp32. Kept lean: a decode tick issues 49 of these."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_fwd launches a CUDA kernel; x lies on "
                         f"{x.device}")
    dtype = build.DTYPES.get(x.dtype)
    if dtype is None:
        raise TypeError(f"layer_norm kernel takes float32/bfloat16, got "
                        f"{x.dtype}")
    dev = x.get_device()
    hidden = x.shape[-1]
    if not x.is_contiguous():
        x = x.contiguous()
    rows = x.numel() // hidden if hidden else 0
    ptrs = []
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None:
            ptrs.append(None)
            continue
        if t.get_device() != dev or t.dim() != 1 or t.shape[0] != hidden:
            raise ValueError(f"{name} must be ({hidden},) on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            t = t.float().contiguous()
        ptrs.append(t.data_ptr())
    y = torch.empty_like(x)
    stats = torch.empty(2 * rows, device=x.device, dtype=torch.float32)
    if rows:
        mean_ptr = stats.data_ptr()
        err = build.load().apex_ln_fwd(
            x.data_ptr(), ptrs[0], ptrs[1], y.data_ptr(), mean_ptr,
            mean_ptr + 4 * rows, rows, hidden, eps, int(rms), dtype,
            build.current_stream(dev))
        if err:
            build.check(err, "apex_ln_fwd")
        layer_norm_fwd.launches += 1
    return y, stats


def layer_norm_fwd(x: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], eps: float = 1e-5,
                   rms: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on a CUDA tensor: ``(y, mean, rstd)`` with
    ``mean``/``rstd`` fp32 of shape ``x.shape[:-1]``. Counts its launches
    in ``layer_norm_fwd.launches``."""
    y, stats = _launch(x, weight, bias, eps, rms)
    lead = x.shape[:-1]
    mean, rstd = stats.view(2, y.numel() // max(x.shape[-1], 1))
    return y, mean.view(lead), rstd.view(lead)


layer_norm_fwd.launches = 0


def layer_norm_bwd(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, weight: Optional[torch.Tensor], *,
                   rms: bool = False, has_bias: bool = False):
    """Launch the backward kernel on CUDA tensors: ``(dx, dgamma, dbeta)``
    as :func:`layer_norm_bwd_reference` gives them (dgamma/dbeta fp32, the
    kernel's per-CTA partial rows summed here). Counts its launches in
    ``layer_norm_bwd.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd launches a CUDA kernel; x lies on "
                         f"{x.device}")
    dtype = build.DTYPES.get(x.dtype)
    if dtype is None or g.dtype != x.dtype:
        raise TypeError(f"layer_norm_bwd kernel takes matching "
                        f"float32/bfloat16 g and x, got {g.dtype}/{x.dtype}")
    hidden = x.shape[-1]
    rows = x.numel() // hidden if hidden else 0
    if g.shape != x.shape or mean.numel() != rows or rstd.numel() != rows:
        raise ValueError(f"g {tuple(g.shape)}, mean/rstd {mean.numel()}/"
                         f"{rstd.numel()} do not match x {tuple(x.shape)}")
    lib = build.load()
    x = x.contiguous()
    g = g.contiguous()
    mean = mean.float().contiguous()
    rstd = rstd.float().contiguous()
    w = None
    if weight is not None:
        if weight.dim() != 1 or weight.shape[0] != hidden \
                or weight.device != x.device:
            raise ValueError(f"weight must be ({hidden},) on {x.device}")
        w = weight.float().contiguous()
    dx = torch.empty_like(x)
    blocks = -(-rows // lib.apex_ln_bwd_rows_per_block())
    parts = torch.empty((int(weight is not None) + int(has_bias), blocks,
                         hidden), device=x.device, dtype=torch.float32)
    dw_part = parts[0] if weight is not None else None
    db_part = parts[-1] if has_bias else None
    if rows:
        err = lib.apex_ln_bwd(
            g.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            None if w is None else w.data_ptr(), dx.data_ptr(),
            None if dw_part is None else dw_part.data_ptr(),
            None if db_part is None else db_part.data_ptr(),
            rows, hidden, int(rms), dtype, build.current_stream(x.get_device()))
        build.check(err, "apex_ln_bwd")
        layer_norm_bwd.launches += 1
    sums = parts.sum(1)
    dw = sums[0] if weight is not None else None
    db = sums[-1] if has_bias else None
    return dx, dw, db


layer_norm_bwd.launches = 0


class FusedNorm(torch.autograd.Function):
    """LayerNorm / RMSNorm with the fused backward (``_fused_norm``,
    ``layer_norm.py:262-293``). Saves x, the fp32 mean/rstd and gamma.
    Output dtypes follow ``_fused_norm_bwd``: dx in x's dtype, dgamma and
    dbeta in their parameter's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, rms):
        if x.device.type == "cuda":
            y, mean, rstd = layer_norm_fwd(x, weight, bias, eps, rms)
        else:
            y, mean, rstd = _norm_stats_reference(x, weight, bias, eps, rms)
        ctx.save_for_backward(x, mean, rstd, weight)
        ctx.rms = rms
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        x, mean, rstd, weight = ctx.saved_tensors
        has_b = ctx.bias_dtype is not None
        fn = layer_norm_bwd if x.device.type == "cuda" \
            else layer_norm_bwd_reference
        dx, dw, db = fn(gy, x, mean, rstd, weight, rms=ctx.rms,
                        has_bias=has_b)
        if dw is not None:
            dw = dw.to(weight.dtype)
        if db is not None:
            db = db.to(ctx.bias_dtype)
        return dx, dw, db, None, None


def _norm(x, weight, bias, eps, rms):
    on = check_device(x, "x")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return FusedNorm.apply(x, weight, bias, eps, rms)
    if on == "cpu":
        return _norm_reference(x, weight, bias, eps, rms)
    return _launch(x, weight, bias, eps, rms)[0]


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Fused LayerNorm over the last dimension (fp32 stats, y in x's
    dtype): the kernels on a CUDA tensor, the plain versions on a CPU
    one; differentiable through :class:`FusedNorm`."""
    return _norm(x, weight, bias, eps, rms=False)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-5) -> torch.Tensor:
    """Fused RMSNorm: the same kernels with the mean term dropped."""
    return _norm(x, weight, None, eps, rms=True)
