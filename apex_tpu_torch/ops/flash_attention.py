"""Flash attention forward (port of ``apex_tpu/ops/flash_attention.py``).

Layout ``(batch, heads, seq, head_dim)``, as in the reference. On a CUDA
tensor :func:`flash_attention` launches the hand-written forward kernel
``csrc/flash_attention.cu`` (which replaces ``_fwd_kernel``): causal or not,
any sq/sk, head_dim <= 128, bf16 or fp32, O in q's dtype and the per-row
fp32 lse beside it for the training slice's backward. The additive ``bias``,
``segment_ids``/``pad_id`` and ``window`` masks on the card are later work
(ROADMAP Queue 2 item 4) and raise there. On a CPU tensor it takes
:func:`mha_reference`, the plain version, ported whole from
``flash_attention.py:1518-1556`` with every mask and the exact-zero rule for
fully-masked rows.

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
    packed-varlen equality mask. CUDA tensors go through the kernel, which
    takes causal/non-causal only; CPU tensors through :func:`mha_reference`.
    """
    sq, sk = q.shape[2], k.shape[2]
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be a positive int, got {window}")
        if window >= max(sq, sk):
            window = None  # the band covers everything: dense attention
    if check_device(q, "q") == "cpu":
        return mha_reference(q, k, v, bias, causal=causal, scale=scale,
                             segment_ids=segment_ids, pad_id=pad_id,
                             window=window)
    unsupported = [name for name, val in (("bias", bias),
                                          ("segment_ids", segment_ids),
                                          ("window", window))
                   if val is not None]
    if unsupported:
        raise NotImplementedError(
            f"flash_attention on CUDA does not take {unsupported} yet: the "
            f"mask extensions of the forward kernel are a later slice "
            f"(ROADMAP Queue 2 item 4)")
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
