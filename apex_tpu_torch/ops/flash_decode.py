"""Paged flash-decode (port of ``apex_tpu/ops/flash_decode.py``).

Single-query attention over a paged KV pool: each slot's one query (the
token being decoded, already written to the pool so it attends itself)
attends the first ``lengths[b]`` positions of its sequence, whose keys live
in pages ``block_tables[b, p // block]`` at offset ``p % block``. Pages are
``(num_blocks, kv_heads, block, head_dim)``, the layout of the JAX pool;
``heads % kv_heads == 0`` and each kv head serves its query-head group (GQA).
A slot with length 0 (idle) outputs exactly 0.

On a CUDA tensor :func:`flash_decode` launches ``csrc/flash_decode.cu``
(which replaces ``_decode_kernel``); its ``window`` on the card is later work
and raises. On a CPU tensor it takes :func:`paged_attention_reference`, the
plain version (``flash_decode.py:62-98``). Like ``_decode_kernel``, it has
no backward: with grad mode on, inputs that require grad raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch._device import check_device
from apex_tpu_torch.csrc import build
from apex_tpu_torch.ops.flash_attention import NEG_INF



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
    # (b, nb, kh, blk, d) -> (b, s_max, kh, d): positions contiguous
    k = k_pages[tbl].permute(0, 1, 3, 2, 4).reshape(b, s_max, kh, d)
    v = v_pages[tbl].permute(0, 1, 3, 2, 4).reshape(b, s_max, kh, d)
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


def flash_decode_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Launch the paged decode kernel on CUDA tensors; ``(b, h, d)`` in q's
    dtype. Counts its launches in ``flash_decode_fwd.launches``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_fwd launches a CUDA kernel; q lies "
                         f"on {q.device}")
    b, h, d = q.shape
    _, kh, blk, _ = k_pages.shape
    if not (q.dtype == k_pages.dtype == v_pages.dtype) \
            or q.dtype not in build.DTYPES:
        raise TypeError(f"decode kernel takes matching float32/bfloat16 "
                        f"q/pages, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("page pools must be contiguous")
    if block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")
    scale = (d ** -0.5) if scale is None else float(scale)
    q = q.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    if b == 0:
        return o
    err = build.load().apex_flash_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), o.data_ptr(), b, h, kh, blk, d,
        tables.shape[1], scale, build.DTYPES[q.dtype],
        build.current_stream(q.get_device()))
    build.check(err, "apex_flash_decode")
    flash_decode_fwd.launches += 1
    return o


flash_decode_fwd.launches = 0


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
    b, h, d = q.shape
    n_pages, kh, blk, d2 = k_pages.shape
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
            "flash_decode has no backward: the reference's _decode_kernel "
            "has no VJP (serving only); call it under torch.no_grad() or "
            "on tensors that do not require grad")
    if check_device(q, "q") == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         lengths, scale=scale, window=window)
    if window is not None:
        raise NotImplementedError(
            "flash_decode on CUDA does not take window yet: the windowed "
            "decode kernel is a later slice (ROADMAP Queue 2)")
    return flash_decode_fwd(q, k_pages, v_pages, block_tables, lengths,
                            scale=scale)
