"""Paged flash-decode (port of ``apex_tpu/ops/flash_decode.py``).

Single-query attention over a paged KV pool: each slot's one query (the
token being decoded, already written to the pool so it attends itself)
attends the first ``lengths[b]`` positions of its sequence, whose keys live
in pages ``block_tables[b, p // block]`` at offset ``p % block``. Pages are
``(num_blocks, kv_heads, block, head_dim)``, the layout of the JAX pool;
``heads % kv_heads == 0`` and each kv head serves its query-head group (GQA).
A slot with length 0 (idle) outputs exactly 0. ``window`` keeps keys
``[length - window, length)``.

:func:`flash_decode_multi` attends K TRAILING queries per slot over the same
pages: query ``j`` of slot ``b`` sees ``lengths[b] - (K - 1 - j)`` keys (and,
with ``window``, only the last ``window`` of them), which is the context a
sequential decode would have seen at that position. Chunked prefill drives
it with one slot and K = chunk, speculative verify with every slot and
K = drafts + 1. A query with no visible key outputs exactly 0.

On CUDA tensors :func:`flash_decode` launches ``csrc/flash_decode.cu``'s
single-query kernel (which replaces ``_decode_kernel``) and
:func:`flash_decode_multi` its K-query kernel (which replaces
``_decode_multi_kernel``), both with the window. On CPU tensors they take
the plain versions :func:`paged_attention_reference` (``flash_decode.py:
62-98``) and :func:`paged_attention_multi_reference` (``:101-138``). Like
the reference kernels they have no backward: with grad mode on, inputs that
require grad raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch._device import check_device
from apex_tpu_torch.csrc import build
from apex_tpu_torch.ops.flash_attention import MAX_HEAD_DIM, NEG_INF


def _dense_pages(pages, tbl, b, s_max, kh, d):
    # (b, nb, kh, blk, d) -> (b, s_max, kh, d): positions contiguous
    return pages[tbl].permute(0, 1, 3, 2, 4).reshape(b, s_max, kh, d)


def paged_attention_reference(q, k_pages, v_pages, block_tables, lengths, *,
                              scale: Optional[float] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """Gather the pages dense, mask by length/window, one-pass softmax."""
    b, h, d = q.shape
    _, kh, blk, _ = k_pages.shape
    g = h // kh
    scale = (d ** -0.5) if scale is None else float(scale)
    s_max = block_tables.shape[1] * blk
    tbl = block_tables.long()
    k = _dense_pages(k_pages, tbl, b, s_max, kh, d)
    v = _dense_pages(v_pages, tbl, b, s_max, kh, d)
    qg = q.reshape(b, kh, g, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    pos = torch.arange(s_max, device=q.device)
    lens = lengths.to(device=q.device, dtype=torch.long)
    valid = pos[None, :] < lens[:, None]
    if window is not None:
        valid = valid & (pos[None, :] >= lens[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # rows with no visible key (idle slots) output exactly 0
    fully_masked = s.amax(-1, keepdim=True) <= NEG_INF / 2
    p = p.masked_fill(fully_masked, 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(b, h, d).to(q.dtype)


def paged_attention_multi_reference(q, k_pages, v_pages, block_tables,
                                    lengths, *,
                                    scale: Optional[float] = None,
                                    window: Optional[int] = None
                                    ) -> torch.Tensor:
    """Gather the pages dense, mask each query by its own trailing length
    (and window), one-pass softmax. ``q`` is ``(batch, heads, K, d)``."""
    b, h, kq, d = q.shape
    _, kh, blk, _ = k_pages.shape
    g = h // kh
    scale = (d ** -0.5) if scale is None else float(scale)
    s_max = block_tables.shape[1] * blk
    tbl = block_tables.long()
    k = _dense_pages(k_pages, tbl, b, s_max, kh, d)
    v = _dense_pages(v_pages, tbl, b, s_max, kh, d)
    qg = q.reshape(b, kh, g, kq, d).float()
    s = torch.einsum("bkgqd,bskd->bkgqs", qg, k.float()) * scale
    pos = torch.arange(s_max, device=q.device)
    lens = lengths.to(device=q.device, dtype=torch.long)
    qlen = lens[:, None] - (kq - 1 - torch.arange(kq, device=q.device))
    valid = pos[None, None, :] < qlen[:, :, None]  # (b, K, s)
    if window is not None:
        valid = valid & (pos[None, None, :] >= qlen[:, :, None] - window)
    s = torch.where(valid[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    fully_masked = s.amax(-1, keepdim=True) <= NEG_INF / 2
    p = p.masked_fill(fully_masked, 0.0)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return o.reshape(b, h, kq, d).to(q.dtype)


def _launch_args(fn_name, q, k_pages, v_pages, block_tables, lengths):
    """Check what a decode kernel takes; the int32 tables and lengths."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn_name} launches a CUDA kernel; q lies on "
                         f"{q.device}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) \
            or q.dtype not in build.DTYPES:
        raise TypeError(f"decode kernels take matching float32/bfloat16 "
                        f"q/pages, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("page pools must be contiguous")
    b = q.shape[0]
    if block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")
    return (block_tables.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous())


def _window_arg(window: Optional[int]) -> int:
    return 0 if window is None else int(window)  # 0: no window


def flash_decode_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor, *,
                     scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Launch the paged decode kernel on CUDA tensors; ``(b, h, d)`` in q's
    dtype. Counts its launches in ``flash_decode_fwd.launches``."""
    tables, lens = _launch_args("flash_decode_fwd", q, k_pages, v_pages,
                                block_tables, lengths)
    b, h, d = q.shape
    _, kh, blk, _ = k_pages.shape
    scale = (d ** -0.5) if scale is None else float(scale)
    q = q.contiguous()
    o = torch.empty_like(q)
    if b == 0:
        return o
    err = build.load().apex_flash_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), o.data_ptr(), b, h, kh, blk, d,
        tables.shape[1], scale, _window_arg(window), build.DTYPES[q.dtype],
        build.current_stream(q.get_device()))
    build.check(err, "apex_flash_decode")
    flash_decode_fwd.launches += 1
    return o


flash_decode_fwd.launches = 0


def flash_decode_multi_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """Launch the K-query paged decode kernel on CUDA tensors;
    ``(b, h, K, d)`` in q's dtype, any K, head_dim <= 128. Counts its
    launches in ``flash_decode_multi_fwd.launches``."""
    tables, lens = _launch_args("flash_decode_multi_fwd", q, k_pages,
                                v_pages, block_tables, lengths)
    b, h, kq, d = q.shape
    _, kh, blk, _ = k_pages.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the K-query decode kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    scale = (d ** -0.5) if scale is None else float(scale)
    q = q.contiguous()
    o = torch.empty_like(q)
    if b == 0 or kq == 0:
        return o
    err = build.load().apex_flash_decode_multi(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), o.data_ptr(), b, h, kh, kq, blk,
        d, tables.shape[1], scale, _window_arg(window),
        build.DTYPES[q.dtype], build.current_stream(q.get_device()))
    build.check(err, "apex_flash_decode_multi")
    flash_decode_multi_fwd.launches += 1
    return o


flash_decode_multi_fwd.launches = 0


def _check_args(name, q, k_pages, v_pages, window) -> None:
    """The reference's validation (``flash_decode.py:223-232``,
    ``:358-369``) and the no-backward rule."""
    d = q.shape[-1]
    h = q.shape[1]
    _, kh, _, d2 = k_pages.shape
    if d2 != d or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"page shapes {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do "
            f"not match q head_dim {d}")
    if h % kh:
        raise ValueError(f"heads ({h}) must be a multiple of kv_heads ({kh})")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be a positive int, got {window}")
    if torch.is_grad_enabled() and (q.requires_grad or k_pages.requires_grad
                                    or v_pages.requires_grad):
        raise RuntimeError(
            f"{name} has no backward: the reference's kernel has no VJP "
            f"(serving only); call it under torch.no_grad() or on tensors "
            f"that do not require grad")


def flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 lengths: torch.Tensor, *, scale: Optional[float] = None,
                 window: Optional[int] = None) -> torch.Tensor:
    """Single-query attention over a paged KV cache.

    ``q`` ``(batch, heads, head_dim)``; ``k_pages``/``v_pages``
    ``(num_blocks, kv_heads, block, head_dim)``; ``block_tables``
    ``(batch, max_blocks)`` int page ids; ``lengths`` ``(batch,)`` keys per
    slot (0 = idle slot, output exactly 0); ``window`` keeps keys
    ``[length - window, length)``. Returns ``(batch, heads, head_dim)`` in
    q's dtype."""
    _check_args("flash_decode", q, k_pages, v_pages, window)
    if check_device(q, "q") == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         lengths, scale=scale, window=window)
    return flash_decode_fwd(q, k_pages, v_pages, block_tables, lengths,
                            scale=scale, window=window)


def flash_decode_multi(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *,
                       scale: Optional[float] = None,
                       window: Optional[int] = None) -> torch.Tensor:
    """K-query attention over a paged KV cache (trailing-query semantics).

    ``q`` ``(batch, heads, K, head_dim)``: query ``j`` sits at position
    ``lengths[b] - K + j`` (already written to the pool) and sees
    ``lengths[b] - (K - 1 - j)`` keys; ``lengths[b]`` counts the keys of the
    FINAL query (0 = idle slot, all K outputs exactly 0). Pages, tables,
    ``scale`` and ``window`` as in :func:`flash_decode`. Returns
    ``(batch, heads, K, head_dim)`` in q's dtype."""
    _check_args("flash_decode_multi", q, k_pages, v_pages, window)
    if check_device(q, "q") == "cpu":
        return paged_attention_multi_reference(
            q, k_pages, v_pages, block_tables, lengths, scale=scale,
            window=window)
    return flash_decode_multi_fwd(q, k_pages, v_pages, block_tables, lengths,
                                  scale=scale, window=window)
