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

Each kernel has two routes (:func:`ln_route`): rows that start on 16 bytes
and hold at most :data:`LN_WARP_MAX_COLS` (forward) or
:data:`LN_BWD_WARP_MAX_COLS` (backward) elements go one warp per row, the
row in the warp's registers; other rows (unaligned, or wider) go to a CTA
per row (forward) or per 32 rows (backward). Both backward routes leave
one fp32 partial row of dgamma/dbeta per CTA, summed on the card in a
fixed order, so two calls give the same bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch._device import check_device
from apex_tpu_torch.csrc import build

#: the forward holds a row in one warp's registers (hidden / 32 fp32 values
#: a lane) up to this many elements, where the row starts on 16 bytes;
#: chosen on the card (PERF.md), at most the kernel's 4096
LN_WARP_MAX_COLS = 2048

#: the backward's warp route up to this many elements (a lane holds its
#: columns of g and x packed, and of gamma, dgamma and dbeta in fp32);
#: chosen on the card where ptxas reports no spill, at most the kernel's
#: 2048
LN_BWD_WARP_MAX_COLS = 1024

#: rows (warps) a CTA of the forward's warp route (1-8)
LN_WARP_ROWS = 4

#: warps a CTA of the backward's warp route (1-8), and its CTAs an SM: the
#: grid is sized to the card, each warp walking rows
LN_BWD_WARP_ROWS = 8
LN_BWD_CTAS_PER_SM = 1

#: rows a CTA of the backward's CTA route (``kLnBwdRows`` in the kernel)
LN_BWD_CTA_ROWS = 32

#: route codes of ``apex_ln_fwd`` / ``apex_ln_bwd``
ROUTES = {"cta": 0, "warp": 1}

_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}


def ln_route(hidden: int, itemsize: int, aligned: bool,
             backward: bool = False) -> str:
    """The kernel's route for rows of ``hidden`` elements of ``itemsize``
    bytes: ``"warp"`` (one warp per row, the row in registers) where every
    pointer is ``aligned`` to 16 bytes, ``hidden * itemsize`` is a multiple
    of 16 and ``hidden`` is at most :data:`LN_WARP_MAX_COLS` (backward:
    :data:`LN_BWD_WARP_MAX_COLS`); else ``"cta"``."""
    cap = LN_BWD_WARP_MAX_COLS if backward else LN_WARP_MAX_COLS
    if aligned and hidden <= cap and hidden * itemsize % 16 == 0:
        return "warp"
    return "cta"


def ln_bwd_grid(rows: int, route: str, sms: int) -> int:
    """CTAs of the backward, which is also its count of partial rows: on
    the warp route as many as the card holds at once
    (``sms * LN_BWD_CTAS_PER_SM``) or fewer where the rows do not fill
    them (each warp takes at least one row); on the CTA route one per
    :data:`LN_BWD_CTA_ROWS` rows."""
    if route == "warp":
        return max(1, min(-(-rows // LN_BWD_WARP_ROWS),
                          sms * LN_BWD_CTAS_PER_SM))
    return -(-rows // LN_BWD_CTA_ROWS)


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
    dt = x.dtype
    dtype = build.DTYPES.get(dt)
    if dtype is None:
        raise TypeError(f"layer_norm kernel takes float32/bfloat16, got "
                        f"{dt}")
    dev = x.get_device()
    hidden = x.shape[-1]
    if not x.is_contiguous():
        x = x.contiguous()
    rows = x.numel() // hidden if hidden else 0
    xp = x.data_ptr()
    ptrs = []
    any_ptr = xp
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
        any_ptr |= ptrs[-1]
    y = torch.empty_like(x)
    stats = torch.empty(2 * rows, device=x.device, dtype=torch.float32)
    if rows:
        route = ln_route(hidden, _ITEMSIZE[dt], not any_ptr & 15)
        mean_ptr = stats.data_ptr()
        err = build.load().apex_ln_fwd(
            xp, ptrs[0], ptrs[1], y.data_ptr(), mean_ptr,
            mean_ptr + 4 * rows, rows, hidden, eps, int(rms), dtype,
            ROUTES[route], LN_WARP_ROWS, build.current_stream(dev))
        if err:
            build.check(err, "apex_ln_fwd")
        layer_norm_fwd.launches += 1
    return y, stats


def layer_norm_fwd(x: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], eps: float = 1e-5,
                   rms: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on a CUDA tensor: ``(y, mean, rstd)`` with
    ``mean``/``rstd`` fp32 of shape ``x.shape[:-1]``, on the route
    :func:`ln_route` gives: one warp per row (``LN_WARP_ROWS`` rows a CTA)
    or one CTA per row. Counts its launches in
    ``layer_norm_fwd.launches``."""
    y, stats = _launch(x, weight, bias, eps, rms)
    lead = x.shape[:-1]
    mean, rstd = stats.view(2, y.numel() // max(x.shape[-1], 1))
    return y, mean.view(lead), rstd.view(lead)


layer_norm_fwd.launches = 0


def layer_norm_bwd(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, weight: Optional[torch.Tensor], *,
                   rms: bool = False, has_bias: bool = False):
    """Launch the backward kernel on CUDA tensors: ``(dx, dgamma, dbeta)``
    as :func:`layer_norm_bwd_reference` gives them (dgamma/dbeta fp32, None
    where not wanted), on the route :func:`ln_route` gives. The kernel
    leaves one partial row of each sum per CTA (:func:`ln_bwd_grid`) and
    sums them in the same launch call, in a fixed order. Counts its
    launches in ``layer_norm_bwd.launches``."""
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
    n_sums = int(weight is not None) + int(has_bias)
    sums = torch.empty((n_sums, hidden), device=x.device,
                       dtype=torch.float32)
    if rows:
        dev = x.get_device()
        wp = 0 if w is None else w.data_ptr()
        route = ln_route(hidden, x.element_size(),
                         not (g.data_ptr() | x.data_ptr() | wp) & 15,
                         backward=True)
        grid = ln_bwd_grid(
            rows, route,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        parts = torch.empty((n_sums, grid, hidden), device=x.device,
                            dtype=torch.float32)
        # (dgamma, dbeta): their index in parts / sums, None if not wanted
        at = (0 if weight is not None else None,
              n_sums - 1 if has_bias else None)
        part_p = [None if i is None else parts[i].data_ptr() for i in at]
        sum_p = [None if i is None else sums[i].data_ptr() for i in at]
        err = build.load().apex_ln_bwd(
            g.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            None if w is None else wp, dx.data_ptr(), *part_p, *sum_p, rows,
            hidden, int(rms), dtype, ROUTES[route], grid, LN_BWD_WARP_ROWS,
            build.current_stream(dev))
        build.check(err, "apex_ln_bwd")
        layer_norm_bwd.launches += 1
    else:
        sums.zero_()
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
