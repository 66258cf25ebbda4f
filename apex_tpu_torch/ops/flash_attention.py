"""Flash attention (port of ``apex_tpu/ops/flash_attention.py``).

Layout ``(batch, heads, seq, head_dim)``, as in the reference. On CUDA
tensors :func:`flash_attention` goes through :class:`FlashAttention`, a
``torch.autograd.Function`` mirroring the reference's custom VJP ``_flash``
(``flash_attention.py:1395-1429``): the forward launches
``csrc/flash_attention.cu`` (which replaces ``_fwd_kernel``) and saves q, k,
v, o and the fp32 lse; the backward computes ``delta = rowsum(dO * O)`` in
fp32 (``_flash_bwd``, ``:1210``) and launches the two kernels of
``csrc/flash_attention_bwd.cu`` (which replace ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``). The card takes causal or non-causal attention, any
sq/sk, head_dim <= 128, bf16 or fp32; the additive ``bias``,
``segment_ids``/``pad_id`` and ``window`` masks on the card are later work
(ROADMAP Queue 2 item 4) and raise there.

On CPU tensors the same Function runs the plain versions
(:func:`mha_reference` with its lse, :func:`flash_attention_bwd_reference`);
with a mask the card does not take, the CPU runs :func:`mha_reference`, the
plain version ported whole from ``flash_attention.py:1518-1556`` with every
mask and the exact-zero rule for fully-masked rows, under its own autograd.

The TPU layout rules (VMEM budgets, the resident/streamed crossover, the
8-alignment fallbacks) are not behaviour and are not carried over.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch._device import check_device
from apex_tpu_torch.csrc import build

NEG_INF = -1e30
MAX_HEAD_DIM = 128


def _dense_pos_masks(s, q_pos, k_pos, causal, window, neg=NEG_INF):
    """Causal and/or sliding-window masks on a dense score tensor
    (``_dense_pos_masks``, ``flash_attention.py:103-114``)."""
    if causal:
        s = torch.where(k_pos > q_pos, neg, s)
    if window is not None:
        s = torch.where(q_pos - k_pos >= window, neg, s)
        if not causal:
            s = torch.where(k_pos - q_pos >= window, neg, s)
    return s


def mha_reference(q, k, v, bias=None, *, causal: bool = False,
                  scale: Optional[float] = None,
                  segment_ids: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                  pad_id: Optional[int] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """Unfused attention, the plain version of the forward kernel."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    # a cross-shape window can fully mask rows too, like segment masks
    masked = segment_ids is not None or window is not None
    if segment_ids is not None:
        q_seg, kv_seg = segment_ids
        valid = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        if pad_id is not None:
            valid = valid & (kv_seg != pad_id)[:, None, None, :]
        s = torch.where(valid, s, NEG_INF)
    if causal or window is not None:
        sq, sk = s.shape[-2], s.shape[-1]
        s = _dense_pos_masks(s, torch.arange(sq, device=s.device)[:, None],
                             torch.arange(sk, device=s.device)[None, :],
                             causal, window)
    p = torch.softmax(s, dim=-1)
    if masked:
        # rows with no visible key output exactly zero (softmax of an
        # all-masked row would be uniform), decided after every mask
        fully_masked = s.amax(-1, keepdim=True) <= NEG_INF / 2
        p = p.masked_fill(fully_masked, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors: ``(o, lse)``, o
    ``(b, h, sq, d)`` in q's dtype and lse ``(b, h, sq)`` fp32. Counts its
    launches in ``flash_attention_fwd.launches``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd launches a CUDA kernel; q "
                         f"lies on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (batch, heads, seq, head_dim)")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in build.DTYPES:
        raise TypeError(f"flash kernel takes matching float32/bfloat16 q/k/v,"
                        f" got {q.dtype}/{k.dtype}/{v.dtype}")
    if d > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash kernel supports head_dim <= {MAX_HEAD_DIM}, got {d}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    scale = (d ** -0.5) if scale is None else float(scale)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((b, h, sq, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    if o.numel() == 0:
        return o, lse
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    err = build.load().apex_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, sq, sk, d, q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        scale, int(causal), build.DTYPES[q.dtype],
        build.current_stream(q.get_device()))
    build.check(err, "apex_flash_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _mask_scores(s, causal):
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        s = _dense_pos_masks(s, torch.arange(sq, device=s.device)[:, None],
                             torch.arange(sk, device=s.device)[None, :],
                             True, None)
    return s


def _lse_reference(q, k, causal, scale):
    """fp32 per-row logsumexp of the masked scores, as the forward kernel
    writes it (NEG_INF for a row with no visible key)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    return torch.logsumexp(_mask_scores(s, causal), dim=-1)


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, causal: bool,
                                  scale: float):
    """Plain backward, the arithmetic of the two backward kernels:
    ``P = exp(S - lse)`` (0 where masked or where ``lse <= NEG_INF / 2``),
    ``dS = P * (dO V^T - delta)`` with ``delta = rowsum(dO * O)``; returns
    ``(dq, dk, dv)`` in q/k/v's dtypes, computed in fp32."""
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    delta = (o.float() * do32).sum(-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * scale
    sq, sk = s.shape[-2], s.shape[-1]
    lse = lse.float()[..., None]
    visible = torch.ones(sq, sk, dtype=torch.bool, device=s.device)
    if causal:
        visible = torch.arange(sk, device=s.device)[None, :] \
            <= torch.arange(sq, device=s.device)[:, None]
    live = visible & (lse > NEG_INF / 2)
    p = torch.where(live, torch.exp(s - lse), 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v32)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k32) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_args(q, k, v, do, lse, delta, name):
    if q.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; q lies on "
                         f"{q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape or do.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} dO {tuple(do.shape)} disagree")
    if not (q.dtype == k.dtype == v.dtype == do.dtype) \
            or q.dtype not in build.DTYPES:
        raise TypeError(f"flash backward takes matching float32/bfloat16 "
                        f"q/k/v/dO, got {q.dtype}/{k.dtype}/{v.dtype}/"
                        f"{do.dtype}")
    if d > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash kernel supports head_dim <= {MAX_HEAD_DIM}, got {d}")
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    if lse.shape != (b, h, sq) or delta.shape != (b, h, sq):
        raise ValueError(f"lse/delta must be {(b, h, sq)}")
    ts = [t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, do)]
    stats = [t.float().contiguous() for t in (lse, delta)]
    for t in ts + stats:
        if t.device != q.device:
            raise ValueError("q, k, v, dO, lse, delta must lie on one device")
    strides = [st for t in ts for st in t.stride()[:3]]
    return ts, stats, strides, (b, h, sq, sk, d)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool,
                           scale: float) -> torch.Tensor:
    """Launch the dQ kernel on CUDA tensors: dQ ``(b, h, sq, d)`` in q's
    dtype from the forward's fp32 lse and ``delta = rowsum(dO * O)`` (both
    ``(b, h, sq)``). Counts its launches in
    ``flash_attention_bwd_dq.launches``."""
    (q, k, v, do), (lse, delta), strides, (b, h, sq, sk, d) = _bwd_args(
        q, k, v, do, lse, delta, "flash_attention_bwd_dq")
    dq = torch.empty((b, h, sq, d), device=q.device, dtype=q.dtype)
    if dq.numel() == 0:
        return dq
    err = build.load().apex_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq, sk, d,
        *strides, float(scale), int(causal), build.DTYPES[q.dtype],
        build.current_stream(q.get_device()))
    build.check(err, "apex_flash_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool,
                            scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel on CUDA tensors: ``(dk, dv)``, each
    ``(b, h, sk, d)`` in k's dtype. Counts its launches in
    ``flash_attention_bwd_dkv.launches``."""
    (q, k, v, do), (lse, delta), strides, (b, h, sq, sk, d) = _bwd_args(
        q, k, v, do, lse, delta, "flash_attention_bwd_dkv")
    dk = torch.empty((b, h, sk, d), device=q.device, dtype=k.dtype)
    dv = torch.empty_like(dk)
    if dk.numel() == 0 or sq == 0:
        return dk.zero_(), dv.zero_()
    err = build.load().apex_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
        sq, sk, d, *strides, float(scale), int(causal),
        build.DTYPES[q.dtype], build.current_stream(q.get_device()))
    build.check(err, "apex_flash_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """Causal or non-causal attention without bias/segment/window masks,
    with the two-pass flash backward (``_flash_vjp_fwd`` /
    ``_flash_vjp_bwd``). Kernels on CUDA tensors, plain versions on CPU
    ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.device.type == "cuda":
            o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        else:
            o = mha_reference(q, k, v, causal=causal, scale=scale)
            lse = _lse_reference(q, k, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        if q.device.type != "cuda":
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                       **kw)
            return dq, dk, dv, None, None
        delta = (o.float() * do.float()).sum(-1)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    segment_ids: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    pad_id: Optional[int] = None, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Fused multi-head attention on ``(batch, heads, seq, head_dim)``.

    Same arguments and semantics as the reference's ``flash_attention``
    (minus its TPU tiling knobs): ``causal`` is the top-left-aligned
    upper-triangular mask, ``window`` the sliding window, ``bias`` an
    additive bias broadcastable to ``(b, h, sq, sk)``, ``segment_ids`` the
    packed-varlen equality mask. Without those masks both devices go
    through :class:`FlashAttention` (kernels on the card, plain versions on
    the CPU); CUDA tensors with a mask raise, CPU tensors with one take
    :func:`mha_reference` and its own autograd.
    """
    sq, sk = q.shape[2], k.shape[2]
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be a positive int, got {window}")
        if window >= max(sq, sk):
            window = None  # the band covers everything: dense attention
    on = check_device(q, "q")
    masked = [name for name, val in (("bias", bias),
                                     ("segment_ids", segment_ids),
                                     ("window", window))
              if val is not None]
    if masked:
        if on == "cpu":
            return mha_reference(q, k, v, bias, causal=causal, scale=scale,
                                 segment_ids=segment_ids, pad_id=pad_id,
                                 window=window)
        raise NotImplementedError(
            f"flash_attention on CUDA does not take {masked} yet: the "
            f"mask extensions of the flash kernels are a later slice "
            f"(ROADMAP Queue 2 item 4)")
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale)
    if on == "cpu":
        return mha_reference(q, k, v, causal=causal, scale=scale)
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
