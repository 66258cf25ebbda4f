"""FMHA -- fused multi-head attention for variable-length batches (port of
``apex_tpu/contrib/fmha.py``, the counterpart of apex's
``apex.contrib.fmha``).

A batch of unequal sequences is packed into one ``(total_tokens, 3, heads,
head_dim)`` qkv tensor with ``cu_seqlens`` boundaries and attended in place:
the packed row is one sequence for the flash kernels, with per-token
segment ids from ``cu_seqlens`` and ``contiguous_segments=True``, so each
query tile walks only the key tiles of its own sequences and a batch costs
about ``sum(len_i^2)`` score blocks, not ``batch * max_seqlen^2``. No
padding is computed and nothing is gathered or scattered.

The reference pads the packed total up to a multiple of 128 tokens (the
TPU's lane width) before the call. That is a layout rule of the TPU, not
behaviour: the port's kernels take any length, so the pad is dropped and
the call sees the caller's ``total_tokens``. Tokens past
``cu_seqlens[-1]`` take the padding id ``batch + 1`` and come back exactly 0.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.flash_attention import flash_attention


def segment_ids_from_cu_seqlens(cu_seqlens: torch.Tensor,
                                total: int) -> torch.Tensor:
    """Per-token segment ids (1..batch, padding = batch + 1) of a packed
    ``cu_seqlens`` layout, int32 on ``cu_seqlens``' device. The ids are
    non-decreasing, so block skipping applies."""
    pos = torch.arange(total, device=cu_seqlens.device,
                       dtype=cu_seqlens.dtype)
    return (torch.searchsorted(cu_seqlens[1:], pos, right=True) + 1).to(
        torch.int32)


def fmha(qkv: torch.Tensor, cu_seqlens: torch.Tensor, max_seqlen: int, *,
         causal: bool = False) -> torch.Tensor:
    """Packed varlen attention (``FMHAFun``, apex's fmha.py:33-60).

    Args:
      qkv: ``(total_tokens, 3, heads, head_dim)`` packed sequences.
      cu_seqlens: ``(batch + 1,)`` cumulative sequence boundaries
        (``cu_seqlens[i]``..``cu_seqlens[i+1]`` is sequence ``i``).
      max_seqlen: the envelope bound, checked against the boundaries (one
        host read of them) except while a CUDA graph is captured, where the
        caller owns it, as the reference's caller does under ``jit``.

    Returns the packed ``(total_tokens, heads, head_dim)`` context, a view
    of the kernel's ``(1, heads, total_tokens, head_dim)`` output; tokens
    past ``cu_seqlens[-1]`` are exactly 0.
    """
    total, three, h, d = qkv.shape
    if three != 3:
        raise ValueError(f"expected packed qkv with dim-1 == 3, got {three}")
    b = cu_seqlens.shape[0] - 1
    capturing = cu_seqlens.is_cuda and torch.cuda.is_current_stream_capturing()
    if not capturing and b > 0:
        max_len = int((cu_seqlens[1:] - cu_seqlens[:-1]).max())
        if max_len > max_seqlen:
            raise ValueError(
                f"sequence length {max_len} exceeds max_seqlen {max_seqlen}")
    seg = segment_ids_from_cu_seqlens(cu_seqlens.to(qkv.device), total)[None]
    # (T, 3, h, d) -> three (1, h, T, d) views: the packed row is the sequence
    q, k, v = (qkv[:, i].transpose(0, 1)[None] for i in range(3))
    ctx = flash_attention(q, k, v, segment_ids=(seg, seg), pad_id=b + 1,
                          causal=causal, contiguous_segments=True)
    return ctx[0].transpose(0, 1)


def fmha_reference(qkv: torch.Tensor, cu_seqlens: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """Per-sequence unfused attention in fp32, sequence by sequence (the
    reference's ``fmha_reference``): ``(total_tokens, heads, head_dim)``,
    zeros past ``cu_seqlens[-1]``."""
    qkv = qkv.float()
    cu = [int(c) for c in cu_seqlens.tolist()]
    total, _, h, d = qkv.shape
    out = torch.zeros(total, h, d, device=qkv.device)
    for s, e in zip(cu[:-1], cu[1:]):
        q, k, v = qkv[s:e, 0], qkv[s:e, 1], qkv[s:e, 2]  # (L, h, d)
        scores = torch.einsum("qhd,khd->hqk", q, k) / d ** 0.5
        if causal:
            n = e - s
            keep = torch.ones(n, n, dtype=torch.bool,
                              device=qkv.device).tril()
            scores = scores.masked_fill(~keep, float("-inf"))
        out[s:e] = torch.einsum("hqk,khd->qhd", scores.softmax(-1), v)
    return out
