"""Fused softmax cross-entropy with label smoothing (port of
``apex_tpu/ops/xentropy.py``).

Per row of logits (vocab V) with label y and smoothing e:
``loss = (1-e)(lse - x_y) + e(lse - mean x)``, 0 where y is
``ignore_index``; the backward rebuilds ``softmax - target`` from the saved
logits and fp32 lse, so the (rows, V) probabilities are never stored.

:class:`SoftmaxXentropy` is the reference's custom VJP
(``xentropy.py:121-138``): it saves logits, labels and lse. Its forward and
backward dispatch by device: on CUDA tensors they launch the hand-written
kernels of ``csrc/xentropy.cu`` (which replace ``_xent_fwd_kernel`` and
``_xent_bwd_kernel``) through :func:`xentropy_fwd` / :func:`xentropy_bwd`,
or raise; on CPU tensors they take the plain versions
(:func:`xentropy_fwd_reference` / :func:`xentropy_bwd_reference`). The
kernels take int64 labels, torch's default; other integer labels are cast
to int64 once in the wrapper.
"""

from __future__ import annotations

from typing import Tuple

import torch

from apex_tpu_torch._device import check_device
from apex_tpu_torch.csrc import build


def xentropy_fwd_reference(logits: torch.Tensor, labels: torch.Tensor,
                           smoothing: float = 0.0, ignore_index: int = -100
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward on (rows, V) logits: ``(loss, lse)``, both fp32
    ``(rows,)``. The label's logit is gathered at the label clipped into
    [0, V), as ``_xla_xentropy`` (``xentropy.py:141-152``) does."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    idx = labels.long().clamp(0, x.shape[-1] - 1)
    x_y = torch.gather(x, -1, idx[:, None])[:, 0]
    nll = lse - x_y
    if smoothing > 0.0:
        loss = (1.0 - smoothing) * nll + smoothing * (lse - x.mean(-1))
    else:
        loss = nll
    return torch.where(labels != ignore_index, loss,
                       torch.zeros_like(loss)), lse


def xentropy_bwd_reference(g: torch.Tensor, logits: torch.Tensor,
                           labels: torch.Tensor, lse: torch.Tensor,
                           smoothing: float = 0.0, ignore_index: int = -100
                           ) -> torch.Tensor:
    """Plain backward, the arithmetic of ``_xent_bwd_kernel``
    (``xentropy.py:47-57``): ``dx = (exp(x - lse) - (1-e) onehot - e/V) * g``,
    0 on ignored rows, in the logits' dtype."""
    x = logits.float()
    vocab = x.shape[-1]
    probs = torch.exp(x - lse.reshape(-1, 1))
    cols = torch.arange(vocab, device=x.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    dx = probs - (1.0 - smoothing) * onehot - smoothing / vocab
    valid = (labels != ignore_index).float()[:, None]
    return (dx * g.float().reshape(-1, 1) * valid).to(logits.dtype)


def _prepare(logits: torch.Tensor, labels: torch.Tensor, name: str):
    if logits.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; logits lie on "
                         f"{logits.device}")
    dtype = build.DTYPES.get(logits.dtype)
    if dtype is None:
        raise TypeError(f"{name} takes float32/bfloat16 logits, got "
                        f"{logits.dtype}")
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"{name}: logits must be (rows, vocab) and labels "
                         f"(rows,), got {tuple(logits.shape)} and "
                         f"{tuple(labels.shape)}")
    if labels.device != logits.device:
        raise ValueError(f"{name}: labels lie on {labels.device}, logits on "
                         f"{logits.device}")
    if labels.dtype != torch.int64:
        if labels.is_floating_point() or labels.dtype == torch.bool:
            raise TypeError(f"{name} takes integer labels, got "
                            f"{labels.dtype}")
        labels = labels.long()
    return logits.contiguous(), labels.contiguous(), dtype


def xentropy_fwd(logits: torch.Tensor, labels: torch.Tensor,
                 smoothing: float = 0.0, ignore_index: int = -100
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA (rows, V) logits: ``(loss, lse)``
    as :func:`xentropy_fwd_reference` gives them. Counts its launches in
    ``xentropy_fwd.launches``."""
    logits, labels, dtype = _prepare(logits, labels, "xentropy_fwd")
    rows, vocab = logits.shape
    loss = torch.empty(rows, device=logits.device, dtype=torch.float32)
    lse = torch.empty(rows, device=logits.device, dtype=torch.float32)
    if rows:
        err = build.load().apex_xent_fwd(
            logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), rows, vocab, float(smoothing), int(ignore_index),
            dtype, build.current_stream(logits.get_device()))
        build.check(err, "apex_xent_fwd")
        xentropy_fwd.launches += 1
    return loss, lse


xentropy_fwd.launches = 0


def xentropy_bwd(g: torch.Tensor, logits: torch.Tensor, labels: torch.Tensor,
                 lse: torch.Tensor, smoothing: float = 0.0,
                 ignore_index: int = -100) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors: dx as
    :func:`xentropy_bwd_reference` gives it. Counts its launches in
    ``xentropy_bwd.launches``."""
    logits, labels, dtype = _prepare(logits, labels, "xentropy_bwd")
    rows, vocab = logits.shape
    if g.numel() != rows or lse.numel() != rows:
        raise ValueError(f"xentropy_bwd: g {tuple(g.shape)} and lse "
                         f"{tuple(lse.shape)} need {rows} rows")
    g = g.reshape(rows).float().contiguous()
    lse = lse.reshape(rows).float().contiguous()
    dx = torch.empty_like(logits)
    if rows:
        err = build.load().apex_xent_bwd(
            g.data_ptr(), logits.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), dx.data_ptr(), rows, vocab, float(smoothing),
            int(ignore_index), dtype,
            build.current_stream(logits.get_device()))
        build.check(err, "apex_xent_bwd")
        xentropy_bwd.launches += 1
    return dx


xentropy_bwd.launches = 0


class SoftmaxXentropy(torch.autograd.Function):
    """Per-row losses of (rows, V) logits with the fused backward
    (``_softmax_xentropy``). Saves logits, labels and the fp32 lse."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing, ignore_index):
        fn = xentropy_fwd if logits.device.type == "cuda" \
            else xentropy_fwd_reference
        loss, lse = fn(logits, labels, smoothing, ignore_index)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing = smoothing
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        fn = xentropy_bwd if logits.device.type == "cuda" \
            else xentropy_bwd_reference
        dx = fn(g, logits, labels, lse, ctx.smoothing, ctx.ignore_index)
        return dx, None, None, None


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          smoothing: float = 0.0,
                          ignore_index: int = -100) -> torch.Tensor:
    """Per-row fused CE loss (``softmax_cross_entropy``): ``logits``
    (..., V), ``labels`` (...,) int; returns fp32 losses in the labels'
    shape, 0 for ignored rows. The kernels on CUDA tensors, the plain
    versions on CPU ones; differentiable in the logits."""
    check_device(logits, "logits")
    shape = labels.shape
    l2 = logits.reshape(-1, logits.shape[-1])
    y = labels.reshape(-1)
    if torch.is_grad_enabled() and logits.requires_grad:
        out = SoftmaxXentropy.apply(l2, y, float(smoothing),
                                    int(ignore_index))
    elif logits.device.type == "cuda":
        out = xentropy_fwd(l2, y, float(smoothing), int(ignore_index))[0]
    else:
        out = xentropy_fwd_reference(l2, y, float(smoothing),
                                     int(ignore_index))[0]
    return out.reshape(shape)


def softmax_cross_entropy_reference(logits: torch.Tensor,
                                    labels: torch.Tensor,
                                    smoothing: float = 0.0,
                                    ignore_index: int = -100) -> torch.Tensor:
    """The plain version of :func:`softmax_cross_entropy` (``_xla_xentropy``
    over the flattened rows), differentiable by autograd."""
    shape = labels.shape
    out = xentropy_fwd_reference(logits.reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1), smoothing,
                                 ignore_index)[0]
    return out.reshape(shape)
