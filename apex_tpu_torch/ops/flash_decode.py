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

Routes on the card (:func:`decode_route`): bf16 with ``head_dim % 8 == 0``
(up to 128), ``block % 8 == 0`` and 16-byte-aligned q, o and pools takes
the **split** route: each (slot, kv head, tile of ``DECODE_ROWS`` rows)'s
visible pages are cut into
:func:`decode_splits` runs, one CTA each, fed by a TMA ring of pages and
merged in split order by the last CTA of the group (:func:`split_keys`
says which keys a CTA takes). fp32 with ``head_dim <= 128`` (any block,
any alignment) takes the **f32_split** route: the same split and combine
in fp32 (``DECODE_F32_SPLIT_PAGES`` / ``DECODE_F32_SPLIT_CTAS``; tiles of
``DECODE_ROWS`` rows, of which the kernel computes the live ones), a ring
of pages filled row by row by bulk copies and FMA products. The split
count is a function of shapes only: nothing is read back from the device.
Other shapes take the **gather** route (the first port's kernels: bf16 off
the split route's terms, fp32 single-query decode with ``head_dim >
128``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from apex_tpu_torch._device import check_device
from apex_tpu_torch.csrc import build
from apex_tpu_torch.ops.flash_attention import (
    MAX_HEAD_DIM,
    NEG_INF,
    _sm_count,
)

#: pages a split of the split route aims at: about 8 stages of 64 keys
#: (16-key pages), enough to pay for the partial's round trip and merge
DECODE_SPLIT_PAGES = 32
#: CTAs an SM the splits may fill at most: past about two a CTA's fixed
#: latency (table, TMA, counter, merge) costs more than its keys save
DECODE_SPLIT_CTAS = 2
#: most splits of a group (the kernel's kDecMaxSplits)
DECODE_MAX_SPLITS = 256
#: rows of one (slot, kv head) a split-route CTA holds: one m16 tile, its
#: four warps splitting each stage's keys (the kernel's kDecRows)
DECODE_ROWS = 16
#: the fp32 route's pages a split and CTAs an SM, as DECODE_SPLIT_PAGES and
#: DECODE_SPLIT_CTAS for its pages of twice the bytes: the card holds two
#: of its CTAs an SM at once, and splits worth three let a batch's long
#: slots spread while its short and idle slots' CTAs end at once (the
#: verify 16% faster than at two; one slot over 8192 keys, all CTAs equal,
#: loses to two; chip_smoke.py's decode_split_tuning, PERF.md)
DECODE_F32_SPLIT_PAGES = 16
DECODE_F32_SPLIT_CTAS = 3


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


def decode_route(dtype: torch.dtype, d: int, blk: int, aligned: bool) -> str:
    """The kernel route of a decode call on the card: ``"split"`` (bf16,
    ``d % 8 == 0``, ``d <= 128``, ``blk % 8 == 0``, q, o and both pools on
    16 bytes: TMA's terms), ``"f32_split"`` (fp32, ``d <= 128``, any block
    and alignment) or ``"gather"`` (other bf16; fp32 with ``d > 128``, which
    only the single-query entry point takes: ``flash_decode_kernel``)."""
    if dtype != torch.bfloat16:
        return "f32_split" if d <= MAX_HEAD_DIM else "gather"
    if d % 8 == 0 and d <= MAX_HEAD_DIM and blk % 8 == 0 and aligned:
        return "split"
    return "gather"


def decode_span_pages(max_blocks: int, blk: int, window: Optional[int],
                      kq: int = 1) -> int:
    """Most pages one row tile can see: the table's ``max_blocks``, or
    with a window the pages its ``window + K - 1`` keys can cross."""
    if window is None:
        return max_blocks
    return min(max_blocks, -(-(window + kq - 1) // blk) + 1)


def decode_splits(b: int, kh: int, row_tiles: int, span_pages: int,
                  sms: int = 132, f32: bool = False) -> int:
    """Splits of each (slot, kv head, row tile) group on a split route,
    from static shapes only: one split per ``DECODE_SPLIT_PAGES`` of the
    ``span_pages`` a group can see, while the ``b * kh * row_tiles``
    groups' CTAs stay within ``DECODE_SPLIT_CTAS`` an SM (``f32``: the
    fp32 route's ``DECODE_F32_SPLIT_PAGES`` / ``DECODE_F32_SPLIT_CTAS``);
    never more than the pages (so no split is empty at full length) nor
    ``DECODE_MAX_SPLITS``, at least 1."""
    pages, ctas = ((DECODE_F32_SPLIT_PAGES, DECODE_F32_SPLIT_CTAS) if f32
                   else (DECODE_SPLIT_PAGES, DECODE_SPLIT_CTAS))
    groups = max(1, b * kh * row_tiles)
    want = -(-span_pages // pages)
    fit = ctas * sms // groups
    return max(1, min(want, fit, span_pages, DECODE_MAX_SPLITS))


def row_keys(length: int, r: int, kq: int, window: Optional[int],
             s_max: int):
    """Visible key positions ``[lo, hi)`` of row ``r`` of a (slot, kv
    head) (its query ``j = r % kq``): the kernels' ``row_range``. Empty
    when ``hi <= lo``."""
    qlen = length - (kq - 1 - r % kq)
    lo = max(qlen - window, 0) if window else 0
    return lo, min(qlen, s_max)


def tile_keys(length: int, r0: int, r1: int, kq: int,
              window: Optional[int], s_max: int):
    """``[lo, hi)`` over the rows ``[r0, r1)`` that see any key, ``(0, 0)``
    when none does: the kernels' ``tile_range``."""
    live = [row_keys(length, r, kq, window, s_max) for r in range(r0, r1)]
    live = [(lo, hi) for lo, hi in live if hi > lo]
    if not live:
        return 0, 0
    return min(lo for lo, _ in live), max(hi for _, hi in live)


def split_keys(length: int, split: int, splits: int, blk: int,
               window: Optional[int] = None, kq: int = 1, rows=(0, 1),
               s_max: Optional[int] = None):
    """Key positions ``[ka, kb)`` that split ``split`` of ``splits`` of
    the row tile ``rows = (r0, r1)`` reads, as the split kernel derives
    them on the device: the tile's visible keys in whole pages of ``blk``,
    cut into nearly equal runs of pages (``split_page``). ``(0, 0)`` for a
    split with no page. Each row takes the keys of its own range inside
    ``[ka, kb)``."""
    if s_max is None:
        s_max = 1 << 30
    lo, hi = tile_keys(length, rows[0], rows[1], kq, window, s_max)
    p0 = lo // blk
    n = -(-hi // blk) - p0 if hi > lo else 0
    pa, pb = p0 + split * n // splits, p0 + (split + 1) * n // splits
    return (pa * blk, pb * blk) if pb > pa else (0, 0)


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


@functools.lru_cache(maxsize=256)
def _plan(dtype, b, h, kh, kq, blk, d, mb, window, aligned, splits, sms):
    """(splits, workspace floats, counters) of a decode call, from its
    shapes: the same every tick, so worked out once; 0 splits off the split
    routes."""
    route = decode_route(dtype, d, blk, aligned)
    if route not in ("split", "f32_split"):
        if splits:
            raise ValueError(f"splits apply to the split routes only; this "
                             f"call takes the {route} route")
        return 0, 0, 0
    tiles = -(-(h // kh * kq) // DECODE_ROWS)
    n_split = splits or decode_splits(
        b, kh, tiles, decode_span_pages(mb, blk, window, kq), sms,
        f32=route == "f32_split")
    groups = b * kh * tiles
    dp = 64 if d <= 64 else 128
    return n_split, groups * n_split * DECODE_ROWS * (dp + 2), groups


#: (device index, stream) -> (fp32 workspace, int32 counters, their
#: pointers) of the split routes, grown on demand; each kernel leaves its
#: counters at 0, so the zeros are written once. One pair a stream: calls
#: on one stream run in order.
_SCRATCH = {}


def _scratch(q, stream, n_ws, n_cnt):
    """The pointers of a workspace of ``n_ws`` floats and ``n_cnt`` zeroed
    counters on q's device for ``stream``."""
    key = (q.get_device(), stream)
    got = _SCRATCH.get(key)
    if got is None or got[0].numel() < n_ws or got[1].numel() < n_cnt:
        if got is not None:  # never shrink: shapes alternate tick to tick
            n_ws, n_cnt = max(n_ws, got[0].numel()), max(n_cnt,
                                                         got[1].numel())
        ws = torch.empty(n_ws, device=q.device, dtype=torch.float32)
        cnt = torch.zeros(n_cnt, device=q.device, dtype=torch.int32)
        got = _SCRATCH[key] = (ws, cnt, (ws.data_ptr(), cnt.data_ptr()))
    return got[2]


def _launch(entry, q, k_pages, v_pages, tables, lens, o, kq, scale, window,
            splits):
    """One decode kernel launch on q's current stream: the route, and on
    a split route the split count and scratch (:func:`_plan`)."""
    b, h, d = q.shape[0], q.shape[1], q.shape[-1]
    nb, kh, blk, _ = k_pages.shape
    dev = q.get_device()
    stream = build.current_stream(dev)
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lens.data_ptr(), o.data_ptr())
    aligned = not (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[5]) & 15
    mb = tables.shape[1]
    n_split, n_ws, n_cnt = _plan(q.dtype, b, h, kh, kq, blk, d, mb, window,
                                 aligned, splits, _sm_count(dev))
    scratch = _scratch(q, stream, n_ws, n_cnt) if n_split else (None, None)
    shape = ((b, h, kh, blk, d, mb, nb) if entry == "apex_flash_decode"
             else (b, h, kh, kq, blk, d, mb, nb))
    err = getattr(build.load(), entry)(
        *ptrs, *scratch, *shape, scale, _window_arg(window), n_split,
        build.DTYPES[q.dtype], stream)
    build.check(err, entry)


def flash_decode_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor, *,
                     scale: Optional[float] = None,
                     window: Optional[int] = None,
                     splits: Optional[int] = None) -> torch.Tensor:
    """Launch the paged decode kernel on CUDA tensors; ``(b, h, d)`` in q's
    dtype. ``splits`` overrides :func:`decode_splits` on a split route
    (for tuning). Counts its launches in ``flash_decode_fwd.launches``."""
    tables, lens = _launch_args("flash_decode_fwd", q, k_pages, v_pages,
                                block_tables, lengths)
    b, h, d = q.shape
    scale = (d ** -0.5) if scale is None else float(scale)
    q = q.contiguous()
    o = torch.empty_like(q)
    if b == 0:
        return o
    _launch("apex_flash_decode", q, k_pages, v_pages, tables, lens, o, 1,
            scale, window, splits)
    flash_decode_fwd.launches += 1
    return o


flash_decode_fwd.launches = 0


def flash_decode_multi_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None,
                           window: Optional[int] = None,
                           splits: Optional[int] = None) -> torch.Tensor:
    """Launch the K-query paged decode kernel on CUDA tensors;
    ``(b, h, K, d)`` in q's dtype, any K, head_dim <= 128. ``splits`` as
    in :func:`flash_decode_fwd`. Counts its launches in
    ``flash_decode_multi_fwd.launches``."""
    tables, lens = _launch_args("flash_decode_multi_fwd", q, k_pages,
                                v_pages, block_tables, lengths)
    b, h, kq, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the K-query decode kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    scale = (d ** -0.5) if scale is None else float(scale)
    q = q.contiguous()
    o = torch.empty_like(q)
    if b == 0 or kq == 0:
        return o
    _launch("apex_flash_decode_multi", q, k_pages, v_pages, tables, lens, o,
            kq, scale, window, splits)
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
