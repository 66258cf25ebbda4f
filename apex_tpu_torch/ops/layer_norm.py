"""Fused LayerNorm / RMSNorm forward (port of ``apex_tpu/ops/layer_norm.py``).

``layer_norm`` and ``rms_norm`` keep the reference's contract: stats and
math are always fp32 whatever the input dtype, gamma/beta may be fp32 with
bf16 activations (the MixedFused contract), eps defaults to 1e-5, and the
affine-free and bias-free variants exist. On a CUDA tensor they launch the
hand-written kernel ``csrc/layer_norm.cu`` (which replaces ``_ln_fwd_kernel``)
or raise; on a CPU tensor they take the plain version, the counterpart of
``_norm_xla`` (``layer_norm.py:240-254``). The backward kernel is the
training slice's work.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch._device import check_device
from apex_tpu_torch.csrc import build



def _norm_reference(x, w, b, eps, rms):
    x32 = x.float()
    if rms:
        var = x32.square().mean(-1, keepdim=True)
        xhat = x32 * torch.rsqrt(var + eps)
    else:
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        xhat = (x32 - mu) * torch.rsqrt(var + eps)
    y = xhat
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def layer_norm_reference(x, weight=None, bias=None, eps=1e-5):
    """Plain PyTorch LayerNorm over the last dim (fp32 stats)."""
    return _norm_reference(x, weight, bias, eps, rms=False)


def rms_norm_reference(x, weight=None, eps=1e-5):
    return _norm_reference(x, weight, None, eps, rms=True)


def _launch(x: torch.Tensor, weight: Optional[torch.Tensor],
            bias: Optional[torch.Tensor], eps: float, rms: bool):
    """Launch the kernel: ``(y, stats)`` with ``stats`` = mean rows then
    rstd rows, fp32. Kept lean: a decode tick issues 49 of these."""
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


def _norm(x, weight, bias, eps, rms):
    if check_device(x, "x") == "cpu":
        return _norm_reference(x, weight, bias, eps, rms)
    return _launch(x, weight, bias, eps, rms)[0]


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Fused LayerNorm over the last dimension (fp32 stats, y in x's
    dtype): the kernel on a CUDA tensor, the plain version on a CPU one."""
    return _norm(x, weight, bias, eps, rms=False)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-5) -> torch.Tensor:
    """Fused RMSNorm: the same kernel with the mean term dropped."""
    return _norm(x, weight, None, eps, rms=True)
