"""Flash attention (port of ``apex_tpu/ops/flash_attention.py``).

Layout ``(batch, heads, seq, head_dim)``, as in the reference. On CUDA
tensors :func:`flash_attention` goes through :class:`FlashAttention`, a
``torch.autograd.Function`` mirroring the reference's custom VJP ``_flash``
(``flash_attention.py:1395-1429``), with its ``stream`` flag: a streamed
forward is always followed by the streamed backward.

- Resident (``stream=False``): the forward launches
  ``csrc/flash_attention.cu`` (replaces ``_fwd_kernel``; in bf16 a wgmma
  kernel fed by TMA, one CTA per query tile over its whole band of key
  tiles, :func:`_res_fwd_tiles` / :func:`_res_fwd_bands`, persistent where
  :data:`RES_FWD_PERSISTENT`; in fp32 a register-blocked FMA kernel fed by
  a cp.async ring, :func:`_res_fwd_f32_tiles`) and saves q, k, v, o
  and the fp32 lse; the backward computes ``delta = rowsum(dO * O)`` in
  fp32 (``_flash_bwd``, ``:1210``) and launches the two kernels of
  ``csrc/flash_attention_bwd.cu`` (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``):
  in bf16 wgmma kernels fed by TMA, one CTA per outer tile over its whole
  band (:func:`_res_bwd_bands`), writing each gradient once with no
  workspace and no atomics; in fp32 register-blocked FMA kernels fed by a
  cp.async ring (:func:`_res_bwd_tiles`), also writing each gradient
  once. Causal or non-causal, with
  the additive ``bias`` (read in place, 0 strides on its broadcast dims) and
  its gradient from the dQ pass (:func:`flash_attention_bwd_dq`).
- Streamed (``stream=True``): the kernels of
  ``csrc/flash_attention_stream.cu`` (``_fwd_kernel_stream`` with its merge
  pass; in bf16 ``_bwd_dq_kernel_stream``, ``_bwd_dkv_kernel_stream``)
  split each row's K/V loop (or each key tile's Q loop) across CTAs, over
  the band the causal limit and the sliding ``window`` leave. In bf16 they
  are wgmma kernels fed by TMA (operands TMA cannot read go in as
  contiguous copies, :func:`_tma_operands`): the forward with CTAs of
  :data:`FWD_OUTER_TILE` queries streaming at most :data:`FWD_SPLIT_TILES`
  key tiles of :data:`FWD_INNER_TILE` rows, a band of one split written
  with no merge (:func:`_fwd_merges`); the backward with CTAs of
  :data:`BWD_OUTER_TILE` rows streaming at most :data:`BWD_SPLIT_TILES`
  tiles of :data:`BWD_INNER_TILE` rows. In fp32 the forward is the
  resident route's register-blocked FMA kernel over splits
  (:data:`FWD_F32_OUTER_TILE` queries, at most :data:`FWD_F32_SPLIT_TILES`
  key tiles of :data:`FWD_F32_INNER_TILE` rows, a band of one split
  written with no merge), and the backward the resident fp32 pair of
  ``csrc/flash_attention_bwd.cu`` over whole bands, as the JAX streamed
  kernels carry a whole band along their grid's sequential axis
  (:func:`_bwd_tiles`): each gradient written once, no zeroed buffer, no
  atomics.

Every kernel takes the sliding ``window`` and the packed-varlen masks of
the reference (``segment_ids``, ``pad_id``, ``contiguous_segments``:
``_seg_mask_if_needed`` and ``_seg_metadata``, ``flash_attention.py:
214-249``, ``:756-799``): a query sees a key only where their ids are
equal and the key's id is not ``pad_id``, a row that sees no key outputs
exactly 0, and with ``contiguous_segments`` each outer tile's band of inner
tiles is narrowed to the ``[lo, hi)`` its ids can meet
(:func:`_seg_metadata`, computed by plain reductions at the tiles each
kernel walks and read on the card), so packed sequences cost
``sum(len_i^2)`` score blocks. The streamed kernels keep their static
splits and narrow each one.

The ring offsets of ``apex_tpu/transformer/ring.py`` (the reference's
``offsets`` pair, ``off_ref`` in all six kernels): a q shard and a k shard
that sit at global positions ``q_off`` and ``k_off``. The causal and window
masks see the pair (row, col) at ``(row + q_off) - (col + k_off)``, so every
kernel wrapper and plain version takes the one signed ``shift = q_off -
k_off`` (0: unsharded) and moves its masks and its bands
(:func:`_window_k_range`, :func:`_window_q_range`) by it; a shift that
leaves a tile, or the whole call, with nothing visible gives o = 0, lse =
NEG_INF and zero gradients, as any row that sees no key does.

``stream='auto'`` streams when ``max(sq, sk) >= STREAM_MIN_SEQ`` or a window
is set; a dense bias never streams. Both devices route alike; the card takes
any sq/sk, head_dim <= 128, bf16 or fp32.

On CPU tensors the same Function runs the plain versions: for the resident
kernels :func:`mha_reference` with its lse (with a bias, a window or
segment ids, :func:`flash_attention_fwd_reference`) and
:func:`flash_attention_bwd_reference`; for the streamed ones the per-split
partials and the lse merge (:func:`flash_attention_fwd_stream_reference`),
the split-wise dQ sums and the q-split dK/dV sums, each split narrowed by the
same segment bounds the kernels read. :func:`mha_reference` is the plain
version ported whole from ``flash_attention.py:1518-1556`` with every mask
and the exact-zero rule for fully-masked rows.

The TPU layout rules (VMEM budgets, the 8-alignment fallbacks) are not
behaviour and are not carried over.
"""

from __future__ import annotations

import functools
import warnings
from typing import List, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch._device import check_device
from apex_tpu_torch.csrc import build

NEG_INF = -1e30
MAX_HEAD_DIM = 128

#: stream='auto' takes the streamed kernels at max(sq, sk) >= this (or with a
#: window). A routing choice on the card's numbers, not a memory limit: the
#: resident kernels take any length; see PERF.md for the times behind it.
STREAM_MIN_SEQ = 4096
#: the streamed forward in bf16 (fwd_wgmma): a CTA keeps FWD_OUTER_TILE
#: queries and streams key tiles of FWD_INNER_TILE rows (64 or 128), at most
#: FWD_SPLIT_TILES of them (kFwdOuter / BN in
#: csrc/flash_attention_stream.cu). The plain version of the forward splits
#: alike. The inner tile and the split length were chosen on the card
#: (PERF.md): one split a band at the long-context path shapes.
FWD_OUTER_TILE = 128
FWD_INNER_TILE = 128
FWD_SPLIT_TILES = 128
#: the streamed backward in bf16 (the wgmma kernels): a CTA keeps
#: BWD_OUTER_TILE rows (queries for dQ, keys for dK/dV) and streams tiles of
#: BWD_INNER_TILE rows of the other side, at most BWD_SPLIT_TILES of them
#: (kOuter / kInner in csrc/flash_attention_stream.cu). The plain versions
#: of the backward split alike. The split length was tuned on the card
#: (PERF.md).
BWD_OUTER_TILE = 128
BWD_INNER_TILE = 64
BWD_SPLIT_TILES = 128
#: the resident backward in bf16 (dq_resident_wgmma / dkv_resident_wgmma in
#: csrc/flash_attention_bwd.cu): a CTA keeps BWD_OUTER_TILE rows (the
#: streamed backward's outer tile, kOuter) and streams every inner tile its
#: band holds, with no split (:func:`_res_bwd_bands`): key tiles of
#: RES_BWD_DQ_INNER_TILE rows for dQ (64 where d > 64), query tiles of
#: BWD_INNER_TILE rows for dK/dV (at 128 its kernel spills registers).
#: RES_BWD_PERSISTENT launches one CTA per SM walking the (outer tile,
#: head) items longest band first, else one CTA per item in that order.
#: Both chosen on the card (PERF.md).
RES_BWD_DQ_INNER_TILE = 128
RES_BWD_PERSISTENT = True
#: the resident backward in fp32 (dq_f32_blocked / dkv_f32_blocked in
#: csrc/flash_attention_bwd.cu: register-blocked FMA; the streamed fp32
#: backward launches them too): a CTA keeps
#: RES_BWD_F32_OUTER_TILE rows (16 a warp; 64 where d > 64) and streams the
#: 64-row inner tiles of its band (32-row query tiles for dK/dV where
#: d > 64: its registers) through a two-stage cp.async ring.
#: RES_BWD_F32_PERSISTENT launches as many CTAs as the card holds, walking
#: the items longest band first, else one CTA per item in that order. Both
#: chosen on the card (PERF.md).
RES_BWD_F32_OUTER_TILE = 128
RES_BWD_F32_PERSISTENT = False
#: the dQ inner tile where an additive bias joins S (d <= 64): its kernel
#: instance holds the bias values of a tile in registers too, and at 128
#: rows it spills (chosen on the card, PERF.md)
RES_BWD_DQ_BIAS_INNER_TILE = 64
#: the resident forward in bf16 (fwd_resident_wgmma in
#: csrc/flash_attention.cu): a CTA keeps RES_FWD_OUTER_TILE queries (two
#: consumer warpgroups) and streams every key tile of RES_FWD_INNER_TILE rows
#: its causal band holds, with no split (:func:`_res_fwd_bands`). Where
#: those items would be fewer than the card's SMs (the serving prefill at
#: 1024 tokens: 128 items on 132 SMs), items of RES_FWD_FEW_ITEMS_TILES
#: (64 queries: one consumer warpgroup, two CTAs an SM; 64-row key tiles);
#: above head_dim 64, 128 queries over 64-row key tiles
#: (:func:`_res_fwd_tiles`).
#: RES_FWD_PERSISTENT launches as many CTAs as fit on the card, walking the
#: (query tile, head) items longest band first (:func:`_res_fwd_items`),
#: else one CTA per item in that order. All chosen on the card (PERF.md).
RES_FWD_OUTER_TILE = 128
RES_FWD_INNER_TILE = 128
RES_FWD_FEW_ITEMS_TILES: Optional[Tuple[int, int]] = (64, 64)
RES_FWD_PERSISTENT = True
#: the resident forward in fp32 (fwd_f32_blocked in
#: csrc/flash_f32_blocked.cuh: register-blocked FMA fed by a two-stage
#: cp.async ring): one CTA an item keeps RES_FWD_F32_OUTER_TILE queries (16
#: a warp) and streams every key tile of RES_FWD_F32_INNER_TILE rows its
#: band holds, with no split; above d = 64, 64 queries over 32-row key
#: tiles (:func:`_f32_fwd_tiles`). The card's kernel takes these tiles
#: alone: 128-query CTAs, 32-row key tiles at d <= 64 and the persistent
#: grid were slower there (PERF.md); the plain version cuts its bands at
#: whatever they are set to.
RES_FWD_F32_OUTER_TILE = 64
RES_FWD_F32_INNER_TILE = 64
#: the streamed forward in fp32 (the split instances of the same kernel, at
#: the same tiles): a CTA keeps FWD_F32_OUTER_TILE queries and streams at
#: most FWD_F32_SPLIT_TILES key tiles of FWD_F32_INNER_TILE rows; a band of
#: one split is written with no workspace and no merge (:func:`_fwd_merges`).
#: 128 makes every band up to 8192 keys one split. That is the fastest at L
#: = (1,16,8192,64) causal, and at RP = (1,16,317,64) window 256
#: (generate_gpt's RoPE prefill) it keeps the one launch and no workspace,
#: but there it costs about a quarter of the time: 3 splits a band (length
#: 2) read 0.0311 ms against 0.0409 on the card, since 80 items leave most
#: of its 132 SMs idle (PERF.md).
FWD_F32_OUTER_TILE = 64
FWD_F32_INNER_TILE = 64
FWD_F32_SPLIT_TILES = 128


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
                  window: Optional[int] = None,
                  shift: int = 0) -> torch.Tensor:
    """Unfused attention, the plain version of the forward kernel; ``shift``
    the ring offsets' ``q_off - k_off``."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    # a cross-shape window or a ring shift can fully mask rows too, like
    # segment masks
    masked = segment_ids is not None or window is not None or shift != 0
    if segment_ids is not None:
        q_seg, kv_seg = segment_ids
        valid = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        if pad_id is not None:
            valid = valid & (kv_seg != pad_id)[:, None, None, :]
        s = torch.where(valid, s, NEG_INF)
    s = _mask_scores(s, causal, window, shift=shift)
    p = torch.softmax(s, dim=-1)
    if masked:
        # rows with no visible key output exactly zero (softmax of an
        # all-masked row would be uniform), decided after every mask
        fully_masked = s.amax(-1, keepdim=True) <= NEG_INF / 2
        p = p.masked_fill(fully_masked, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


class _Segments(NamedTuple):
    """Segment ids as the kernels and the plain versions take them: int32
    ``(b, sq)`` / ``(b, sk)`` on q's device, ``pad_id``, whether the ids
    are non-decreasing (``contiguous_segments``: the bounds apply), and the
    metadata tables computed so far, by tiles (:func:`_seg_tables`), so
    that a forward and its backward compute each once."""
    q: torch.Tensor
    k: torch.Tensor
    pad_id: Optional[int]
    contiguous: bool
    tables: dict


def _as_seg(segment_ids, pad_id, contiguous_segments, q, k
            ) -> Optional[_Segments]:
    """The checked :class:`_Segments` of a call, or None without ids: the
    shapes ``(b, sq)`` / ``(b, sk)`` as the reference checks them
    (``flash_attention.py:1628-1631``), the ids as int32 on q's device. A
    :class:`_Segments` passed as ``segment_ids`` (with its tables) is taken
    as it is."""
    if segment_ids is None:
        return None
    if isinstance(segment_ids, _Segments):
        return segment_ids
    q_seg, kv_seg = segment_ids
    b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
    if tuple(q_seg.shape) != (b, sq) or tuple(kv_seg.shape) != (b, sk):
        raise ValueError(
            f"segment_ids shapes {tuple(q_seg.shape)}/{tuple(kv_seg.shape)} "
            f"do not match (batch, seq) = ({b}, {sq})/({b}, {sk})")
    ids = [t.to(device=q.device, dtype=torch.int32).contiguous()
           for t in (q_seg, kv_seg)]
    return _Segments(*ids, None if pad_id is None else int(pad_id),
                     bool(contiguous_segments), {})


def _tile_min_max(ids: torch.Tensor, blk: int):
    """Each ``blk``-row tile's (min, max) id of ``ids`` (b, s); a ragged end
    is filled for the reductions with one more than the largest id, which
    keeps non-decreasing ids so and matches no real id."""
    b, s = ids.shape
    n = _cdiv(s, blk)
    if n * blk != s:
        fill = (ids.amax() + 1).expand(b, n * blk - s)
        ids = torch.cat([ids, fill], dim=1)
    return torch.aminmax(ids.reshape(b, n, blk), dim=-1)


def _seg_metadata(q_seg: torch.Tensor, kv_seg: torch.Tensor, blk_q: int,
                  blk_k: int, pad_id: Optional[int] = None):
    """Per-tile metadata of non-decreasing segment ids (the reference's
    ``_seg_metadata``, ``flash_attention.py:756-799``, as plain
    reductions): ``(bounds_q, bounds_k, qmm, kmm)``, int32 ``(b, 2, n)``
    each. ``bounds_q[b, :, i]`` is the ``[lo, hi)`` of the ``blk_k``-row key
    tiles that query tile ``i`` (``blk_q`` rows) can share an id with,
    ``bounds_k`` the same over query tiles for each key tile; ``qmm`` /
    ``kmm`` each tile's (min, max) id. With ``pad_id``, all-padding tiles
    get empty ranges and no range reaches into the padding suffix. Ragged
    ends take any length (:func:`_tile_min_max`)."""
    qmin, qmax = _tile_min_max(q_seg, blk_q)
    kmin, kmax = _tile_min_max(kv_seg, blk_k)
    nq, nk = qmin.shape[1], kmin.shape[1]
    start_q = (kmax[:, None, :] < qmin[:, :, None]).sum(-1)
    end_q = nk - (kmin[:, None, :] > qmax[:, :, None]).sum(-1)
    start_k = (qmax[:, None, :] < kmin[:, :, None]).sum(-1)
    end_k = nq - (qmin[:, None, :] > kmax[:, :, None]).sum(-1)
    if pad_id is not None:
        pad_q, pad_k = qmin == pad_id, kmin == pad_id
        real_q = nq - pad_q.sum(-1, keepdim=True)
        real_k = nk - pad_k.sum(-1, keepdim=True)
        end_q = torch.minimum(end_q, real_k).masked_fill(pad_q, 0)
        start_q = start_q.masked_fill(pad_q, 0)
        end_k = torch.minimum(end_k, real_q).masked_fill(pad_k, 0)
        start_k = start_k.masked_fill(pad_k, 0)

    def pair(lo, hi):
        return torch.stack([lo, hi], dim=1).to(torch.int32).contiguous()

    return (pair(start_q, end_q), pair(start_k, end_k), pair(qmin, qmax),
            pair(kmin, kmax))


def _seg_tables(seg: _Segments, outer: int, inner: int, inner_is_k: bool):
    """(bounds, outer (min, max), inner (min, max)) of a kernel whose outer
    tiles of ``outer`` rows (queries where ``inner_is_k``, else keys) walk
    inner tiles of ``inner`` rows: :func:`_seg_metadata` at those tiles,
    computed once per :class:`_Segments` and tiles."""
    key = (outer, inner, inner_is_k)
    if key not in seg.tables:
        blk_q, blk_k = (outer, inner) if inner_is_k else (inner, outer)
        bq, bk, qmm, kmm = _seg_metadata(seg.q, seg.k, blk_q, blk_k,
                                         seg.pad_id)
        seg.tables[key] = (bq, qmm, kmm) if inner_is_k else (bk, kmm, qmm)
    return seg.tables[key]


def _seg_ranges(seg: _Segments, own_is_q: bool) -> torch.Tensor:
    """``(b, 2, n)`` int32 for contiguous ids: for each row of one side
    (queries where ``own_is_q``, else keys) the ``[lo, hi)`` of the other
    side's rows that share its id, empty for the pad id -- the equality
    mask as two compares in the kernels (``SegRows``). Computed once per
    :class:`_Segments` and side."""
    key = ("ranges", own_is_q)
    if key not in seg.tables:
        own, other = (seg.q, seg.k) if own_is_q else (seg.k, seg.q)
        lo = torch.searchsorted(other, own)
        hi = torch.searchsorted(other, own, right=True)
        if seg.pad_id is not None:
            hi = torch.where(own == seg.pad_id, lo, hi)
        seg.tables[key] = torch.stack([lo, hi], dim=1).to(
            torch.int32).contiguous()
    return seg.tables[key]


def _seg_args(seg: Optional[_Segments], outer: int, inner: int,
              inner_is_k: bool):
    """The segment arguments of a launch (``SegArgs`` in
    ``csrc/flash_bwd_wgmma.cuh``): the id pointers, the bounds (null where
    the ids are not contiguous: mask only), the outer and inner (min, max)
    tables at the kernel's tiles, the outer rows' ranges (null with the
    bounds), pad_id and has_pad; and the tensors that must live until the
    launch."""
    if seg is None:
        return (None,) * 6 + (0, 0), ()
    bounds, omm, imm = _seg_tables(seg, outer, inner, inner_is_k)
    ranges = _seg_ranges(seg, inner_is_k) if seg.contiguous else None
    keep = (seg.q, seg.k, bounds if seg.contiguous else None, omm, imm,
            ranges)
    ptrs = tuple(None if t is None else t.data_ptr() for t in keep)
    pad = seg.pad_id
    return ptrs + (0 if pad is None else pad, int(pad is not None)), keep


def _seg_valid(seg: _Segments, q0: int, k0: int, nq: int, nk: int,
               rows=slice(None)) -> torch.Tensor:
    """``(b, 1, nq, nk)`` bool: the pairs of queries ``[q0, q0 + nq)`` and
    keys ``[k0, k0 + nk)`` (batch rows ``rows``) that share a non-pad id."""
    qi = seg.q[rows, q0:q0 + nq]
    ki = seg.k[rows, k0:k0 + nk]
    valid = qi[:, :, None] == ki[:, None, :]
    if seg.pad_id is not None:
        valid = valid & (ki != seg.pad_id)[:, None, :]
    return valid[:, None]


def _reach(seg: _Segments, sq: int, sk: int, outer: int, inner: int,
           inner_is_k: bool) -> torch.Tensor:
    """``(b, 1, sq, sk)`` bool: the pairs whose (outer tile, inner tile) lies
    in the contiguous-segment bounds of a resident kernel with those tiles,
    so that the dense plain versions skip what the kernels skip."""
    bounds, _, _ = _seg_tables(seg, outer, inner, inner_is_k)
    n_out, n_in = (sq, sk) if inner_is_k else (sk, sq)
    dev = seg.q.device
    t = torch.arange(n_out, device=dev) // outer
    i = torch.arange(n_in, device=dev) // inner
    lo = bounds[:, 0].long()[:, t, None]
    hi = bounds[:, 1].long()[:, t, None]
    r = (lo <= i) & (i < hi)
    return (r if inner_is_k else r.transpose(1, 2))[:, None]


def _res_seg_valid(seg: _Segments, sq: int, sk: int, fwd: bool):
    """The pairs the resident plain versions keep: equal non-pad ids and,
    with contiguous ids, the bounds at the kernels' tiles (the forward's
    RES_FWD_OUTER_TILE / RES_FWD_INNER_TILE; both backward passes'
    otherwise)."""
    valid = _seg_valid(seg, 0, 0, sq, sk)
    if seg.contiguous:
        if fwd:
            valid = valid & _reach(seg, sq, sk, RES_FWD_OUTER_TILE,
                                   RES_FWD_INNER_TILE, True)
        else:
            valid = valid & _reach(seg, sq, sk, BWD_OUTER_TILE,
                                   RES_BWD_DQ_INNER_TILE, True) & _reach(
                seg, sq, sk, BWD_OUTER_TILE, BWD_INNER_TILE, False)
    return valid


def _fwd_args(q, k, v, name):
    """Check q/k/v for a forward kernel; returns them with a contiguous
    head_dim and ``(b, h, sq, sk, d)``."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; q lies on "
                         f"{q.device}")
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
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    return q, k, v, (b, h, sq, sk, d)


def _res_fwd_tiles(sq: int, bh: int, d: int,
                   sms: int) -> Tuple[int, int]:
    """(query rows of an item, key rows of a tile) of the resident bf16
    forward over ``bh`` heads of ``sq`` queries at the head_dim ``d`` the
    kernel sees, on a card of ``sms`` SMs: RES_FWD_OUTER_TILE /
    RES_FWD_INNER_TILE, or RES_FWD_FEW_ITEMS_TILES where those items would
    be fewer than the SMs; above d = 64 always 128 / 64 (one warpgroup's
    registers and 128-row tiles of 128 columns with the output staging
    overflow)."""
    if d > 64:
        return 128, 64
    if RES_FWD_FEW_ITEMS_TILES and bh * _cdiv(sq, RES_FWD_OUTER_TILE) < sms:
        return RES_FWD_FEW_ITEMS_TILES
    return RES_FWD_OUTER_TILE, RES_FWD_INNER_TILE


def _f32_fwd_tiles(outer: int, inner: int, d: int) -> Tuple[int, int]:
    """(query rows of a CTA, key rows of a tile) of the fp32 forward
    (``fwd_f32_blocked``) at head_dim ``d`` from the route's constants:
    ``(outer, inner)`` up to d = 64, else 64 / 32 (the 128-wide instances'
    registers and shared memory; ``fwd_f32_tiles_ok``)."""
    return (outer, inner) if d <= 64 else (64, 32)


def _res_fwd_f32_tiles(d: int) -> Tuple[int, int, int]:
    """The resident fp32 forward's launch tiles at head_dim ``d``:
    (RES_FWD_F32_OUTER_TILE, RES_FWD_F32_INNER_TILE) through
    :func:`_f32_fwd_tiles`, and 0: the plain grid."""
    return (*_f32_fwd_tiles(RES_FWD_F32_OUTER_TILE, RES_FWD_F32_INNER_TILE,
                            d), 0)


@functools.lru_cache(maxsize=16)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _bias_args(bias: Optional[torch.Tensor], q: torch.Tensor, sq: int,
               sk: int) -> Tuple:
    """The bias as the kernels read it: ``(pointer, stride_b, stride_h,
    stride_q, stride_k)`` in elements, 0 on a broadcast (size-1 or
    expanded) dim, or a null pointer and zeros without one. The bias must be
    fp32 ``(b|1, h|1, sq, sk)`` on q's device (:func:`flash_attention`
    expands a size-1 sq/sk dim); it is never materialised."""
    if bias is None:
        return (None, 0, 0, 0, 0)
    b, h = q.shape[0], q.shape[1]
    if (bias.dim() != 4 or bias.shape[0] not in (1, b)
            or bias.shape[1] not in (1, h) or bias.shape[2:] != (sq, sk)):
        raise ValueError(f"the kernels take a bias (b|1, h|1, sq, sk) = "
                         f"({b}|1, {h}|1, {sq}, {sk}), got "
                         f"{tuple(bias.shape)}")
    if bias.dtype != torch.float32:
        raise TypeError(f"the kernels take an fp32 bias, got {bias.dtype}")
    if bias.device != q.device:
        raise ValueError("the bias must lie on q's device")
    return (bias.data_ptr(), *(0 if n == 1 else st
                               for n, st in zip(bias.shape, bias.stride())))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None,
                        bias: Optional[torch.Tensor] = None,
                        window: Optional[int] = None,
                        segment_ids=None, pad_id: Optional[int] = None,
                        contiguous_segments: bool = False, shift: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors: ``(o, lse)``, o
    ``(b, h, sq, d)`` in q's dtype and lse ``(b, h, sq)`` fp32. bf16 takes
    the wgmma kernel (operands TMA can read, :func:`_tma_operands`; the
    RES_FWD_* tiles and schedule), which writes each row once (two calls
    give the same bits); fp32 the register-blocked FMA kernel at
    :func:`_res_fwd_f32_tiles`, which writes each row once too. A
    ``bias`` (fp32 ``(b|1, h|1, sq, sk)``, :func:`_bias_args`) joins the
    scores after the scale; the ``window`` and the segment masks as
    :func:`flash_attention` takes them, the bounds at the kernel's tiles
    (:func:`_seg_args`). ``shift``: the ring offsets, passed as their
    difference ``q_off - k_off`` (the one number the masks read), moving
    the causal and window masks and the bands; 0 launches what a call
    without it launches. Counts its launches in
    ``flash_attention_fwd.launches``."""
    seg = _as_seg(segment_ids, pad_id, contiguous_segments, q, k)
    shift = _shift_arg(shift, causal, window)
    q, k, v, (b, h, sq, sk, d) = _fwd_args(q, k, v, "flash_attention_fwd")
    bargs = _bias_args(bias, q, sq, sk)
    scale = (d ** -0.5) if scale is None else float(scale)
    dk_ = d
    if q.dtype == torch.bfloat16:
        (q, k, v), dk_ = _tma_operands([q, k, v])
        tiles = (*_res_fwd_tiles(sq, b * h, dk_, _sm_count(q.get_device())),
                 int(RES_FWD_PERSISTENT))
    else:
        tiles = _res_fwd_f32_tiles(d)
    sargs, _keep = _seg_args(seg, tiles[0], tiles[1], True)
    o = torch.empty((b, h, sq, dk_), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    if o.numel() == 0:
        return o[..., :d], lse
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    err = build.load().apex_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, sq, sk, dk_, q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), *bargs,
        scale, int(causal), _window_arg(window), shift, *tiles,
        build.DTYPES[q.dtype], *sargs, build.current_stream(q.get_device()))
    build.check(err, "apex_flash_fwd")
    flash_attention_fwd.launches += 1
    return (o if dk_ == d else o[..., :d].contiguous()), lse


flash_attention_fwd.launches = 0


def _mask_scores(s, causal, window=None, q0=0, k0=0, seg=None,
                 rows=slice(None), shift=0):
    """The segment, causal and window masks on scores whose first row and
    column sit at rows ``q0`` and ``k0`` (batch rows ``rows`` of ``seg``),
    the causal and window masks with the rows at ``shift`` past the
    columns (the ring offsets' ``q_off - k_off``)."""
    if seg is not None:
        s = torch.where(_seg_valid(seg, q0, k0, s.shape[-2], s.shape[-1],
                                   rows), s, NEG_INF)
    if causal or window is not None:
        sq, sk = s.shape[-2], s.shape[-1]
        q0 = q0 + shift
        s = _dense_pos_masks(
            s, torch.arange(q0, q0 + sq, device=s.device)[:, None],
            torch.arange(k0, k0 + sk, device=s.device)[None, :], causal,
            window)
    return s


def _lse_reference(q, k, causal, scale, window=None, shift=0):
    """fp32 per-row logsumexp of the masked scores, as the forward kernel
    writes it (NEG_INF for a row with no visible key)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    return torch.logsumexp(_mask_scores(s, causal, window, shift=shift),
                           dim=-1)


def flash_attention_fwd_reference(q, k, v, *, causal: bool, scale: float,
                                  bias: Optional[torch.Tensor] = None,
                                  window: Optional[int] = None,
                                  segment_ids=None,
                                  pad_id: Optional[int] = None,
                                  contiguous_segments: bool = False,
                                  shift: int = 0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain resident forward with the kernel's arithmetic, in fp32:
    ``S = scale * Q K^T + bias``, the segment, causal and window masks
    (with contiguous ids also the kernel's bounds, :func:`_res_seg_valid`),
    then ``(o, lse)`` with o in q's dtype. A row whose every score is at
    most NEG_INF / 2 (an all -inf bias row, a row that sees no key) gives
    o = 0 exactly and lse = NEG_INF, as ``_fwd_kernel`` gives for its
    ``l == 0`` rows (``flash_attention.py:313``). ``shift``: the ring
    offsets' ``q_off - k_off`` (:func:`_mask_scores`)."""
    seg = _as_seg(segment_ids, pad_id, contiguous_segments, q, k)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if seg is not None:
        s = torch.where(_res_seg_valid(seg, q.shape[2], k.shape[2], True), s,
                        NEG_INF)
    s = _mask_scores(s, causal, window, shift=shift)
    m = s.amax(-1, keepdim=True)
    dead = m <= NEG_INF / 2
    p = torch.where(dead, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l_safe, v.float())
    lse = torch.where(dead, NEG_INF, m + torch.log(l_safe))
    return o.to(q.dtype), lse[..., 0]


def _sum_to_bias(ds: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """dS ``(b, h, sq, sk)`` summed over the dims ``bias`` broadcasts (its
    size-1 b and h): dbias in fp32, the bias's ``(b|1, h|1, sq, sk)``."""
    dims = [i for i in (0, 1) if bias.shape[i] == 1 and ds.shape[i] != 1]
    return ds.sum(dims, keepdim=True) if dims else ds


def _probs(s, lse, causal, window, q0=0, k0=0, seg=None, rows=slice(None),
           shift=0):
    """``P = exp(S - lse)`` as the backward kernels recompute it: 0 where
    masked and on rows whose ``lse <= NEG_INF / 2`` (no visible key)."""
    s = _mask_scores(s, causal, window, q0, k0, seg, rows, shift)
    lse = lse[..., None]
    return torch.where(lse <= NEG_INF / 2, 0.0, torch.exp(s - lse))


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, causal: bool,
                                  scale: float,
                                  window: Optional[int] = None,
                                  bias: Optional[torch.Tensor] = None,
                                  segment_ids=None,
                                  pad_id: Optional[int] = None,
                                  contiguous_segments: bool = False,
                                  shift: int = 0):
    """Plain backward, the arithmetic of the backward kernels:
    ``P = exp(S - lse)`` with ``S = scale * Q K^T [+ bias]`` (0 where the
    segment, causal or window mask hides the key (the latter two at the
    ring offsets' ``shift``), outside the kernels' contiguous-segment
    bounds, or where ``lse <= NEG_INF / 2``),
    ``dS = P * (dO V^T - delta)`` with ``delta = rowsum(dO * O)``; returns
    ``(dq, dk, dv)`` in q/k/v's dtypes, computed in fp32, and with a
    ``bias`` also dbias = dS summed over its broadcast b/h dims, fp32
    (:func:`_sum_to_bias`)."""
    seg = _as_seg(segment_ids, pad_id, contiguous_segments, q, k)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    delta = (o.float() * do32).sum(-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * scale
    if bias is not None:
        s = s + bias.float()
    if seg is not None:
        s = torch.where(_res_seg_valid(seg, q.shape[2], k.shape[2], False),
                        s, NEG_INF)
    p = _probs(s, lse.float(), causal, window, shift=shift)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v32)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k32) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale
    grads = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    return grads if bias is None else (*grads, _sum_to_bias(ds, bias))


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


def _res_bwd_inner(inner_is_k: bool, d: int, bias: bool = False) -> int:
    """The inner tile of a resident bf16 pass (dQ when ``inner_is_k``) at
    the head_dim ``d`` the kernel sees: RES_BWD_DQ_INNER_TILE for dQ where
    d <= 64 (RES_BWD_DQ_BIAS_INNER_TILE with a bias), else
    BWD_INNER_TILE."""
    if inner_is_k and d <= 64:
        return RES_BWD_DQ_BIAS_INNER_TILE if bias else RES_BWD_DQ_INNER_TILE
    return BWD_INNER_TILE


def _res_bwd_tiles(bf16: bool, inner_is_k: bool, d: int,
                   bias: bool = False) -> Tuple[int, int, int]:
    """The launch arguments after ``causal``, before the dtype, of a
    resident pass (dQ when ``inner_is_k``) at the head_dim ``d`` the kernel
    sees: (outer tile, inner tile, persistent). bf16: BWD_OUTER_TILE, the
    pass's inner tile (:func:`_res_bwd_inner`), RES_BWD_PERSISTENT; fp32:
    RES_BWD_F32_OUTER_TILE (64 where d > 64), 64 (32 for dK/dV where
    d > 64), RES_BWD_F32_PERSISTENT."""
    if bf16:
        return (BWD_OUTER_TILE, _res_bwd_inner(inner_is_k, d, bias),
                int(RES_BWD_PERSISTENT))
    wide = d <= 64
    inner = 64 if inner_is_k or wide else 32
    return (RES_BWD_F32_OUTER_TILE if wide else 64, inner,
            int(RES_BWD_F32_PERSISTENT))


def _res_bwd_launch(q, k, v, do, lse, delta, name, inner_is_k, bias=False):
    """Check the operands of a resident backward kernel and pick its route:
    bf16 takes the wgmma kernels (operands TMA can read,
    :func:`_tma_operands`), fp32 the register-blocked FMA kernels; both at
    :func:`_res_bwd_tiles`. Returns the operands, lse/delta, the head_dim
    the kernel sees, the strides and the launch arguments after
    ``causal``, before the dtype: (outer tile, inner tile, persistent)."""
    (q, k, v, do), (lse, delta), _, (b, h, sq, sk, d) = _bwd_args(
        q, k, v, do, lse, delta, name)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        (q, k, v, do), d = _tma_operands([q, k, v, do])
    tiles = _res_bwd_tiles(bf16, inner_is_k, d, bias)
    strides = [st for t in (q, k, v, do) for st in t.stride()[:3]]
    return (q, k, v, do), (lse, delta), d, strides, tiles


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool,
                           scale: float,
                           bias: Optional[torch.Tensor] = None,
                           dbias: bool = False,
                           window: Optional[int] = None, segment_ids=None,
                           pad_id: Optional[int] = None,
                           contiguous_segments: bool = False,
                           shift: int = 0):
    """Launch the dQ kernel on CUDA tensors: dQ ``(b, h, sq, d)`` in q's
    dtype from the forward's fp32 lse and ``delta = rowsum(dO * O)`` (both
    ``(b, h, sq)``), written once by the kernel (no workspace, no atomics:
    two calls give the same bits). With a ``bias`` (as
    :func:`flash_attention_fwd` takes it) it joins S; with ``dbias`` the
    kernel also writes dS, fp32, and the call returns ``(dq, dbias)``,
    dbias in the bias's ``(b|1, h|1, sq, sk)``: written directly where the
    bias is ``(b, h, ...)``, else as per-(b, h) partials that the same
    launch call's ``dbias_finish`` sums in a fixed order. The ``window``,
    the segment masks and the ring offsets' ``shift`` (``q_off - k_off``)
    as :func:`flash_attention_fwd` takes them: a query tile the shift
    leaves no key gets dQ = 0. Counts its launches in
    ``flash_attention_bwd_dq.launches``."""
    seg = _as_seg(segment_ids, pad_id, contiguous_segments, q, k)
    return _bwd_dq(q, k, v, do, lse, delta, causal, scale, bias, dbias,
                   window, seg, flash_attention_bwd_dq, shift)


def _bwd_dq(q, k, v, do, lse, delta, causal, scale, bias, dbias, window,
            seg, wrapper, shift=0):
    """The launch of the resident dQ kernel for ``wrapper`` (the entry point
    that counts it: :func:`flash_attention_bwd_dq`, or the streamed one for
    fp32 operands)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    shift = _shift_arg(shift, causal, window)
    (q, k, v, do), (lse, delta), dk_, strides, tiles = _res_bwd_launch(
        q, k, v, do, lse, delta, wrapper.__name__, True, bias is not None)
    bargs = _bias_args(bias, q, sq, sk)
    sargs, _keep = _seg_args(seg, tiles[0], tiles[1], True)
    if dbias and bias is None:
        raise ValueError("dbias needs the bias")
    ws = out = None
    bb, bh = (b, h) if bias is None else bias.shape[:2]
    if dbias:
        # tiles outside a band (past the causal diagonal, the window or the
        # segment bounds) are never visited: their dS is 0
        skips = causal or window is not None or (seg is not None
                                                  and seg.contiguous)
        alloc = torch.zeros if skips else torch.empty
        ws = alloc((b, h, sq, sk), device=q.device, dtype=torch.float32)
        out = ws if (bb, bh) == (b, h) else torch.empty(
            (bb, bh, sq, sk), device=q.device, dtype=torch.float32)
    dq = torch.empty((b, h, sq, dk_), device=q.device, dtype=q.dtype)
    if dq.numel() == 0:
        return (dq[..., :d], out.zero_()) if dbias else dq[..., :d]
    err = build.load().apex_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bargs[0],
        None if ws is None else ws.data_ptr(),
        None if out is None else out.data_ptr(), b, h, sq, sk, dk_,
        *strides, *bargs[1:], bb, bh, float(scale), int(causal),
        _window_arg(window), shift, *tiles, build.DTYPES[q.dtype], *sargs,
        build.current_stream(q.get_device()))
    build.check(err, "apex_flash_bwd_dq")
    wrapper.launches += 1
    dq = dq if dk_ == d else dq[..., :d].contiguous()
    return (dq, out) if dbias else dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool,
                            scale: float,
                            bias: Optional[torch.Tensor] = None,
                            window: Optional[int] = None, segment_ids=None,
                            pad_id: Optional[int] = None,
                            contiguous_segments: bool = False,
                            shift: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel on CUDA tensors: ``(dk, dv)``, each
    ``(b, h, sk, d)`` in k's dtype, written once by the kernel (a key no
    query sees gets 0); a ``bias``, the ``window``, the segment masks and
    the ring offsets' ``shift`` as in the forward. Counts its launches in
    ``flash_attention_bwd_dkv.launches``."""
    seg = _as_seg(segment_ids, pad_id, contiguous_segments, q, k)
    return _bwd_dkv(q, k, v, do, lse, delta, causal, scale, bias, window,
                    seg, flash_attention_bwd_dkv, shift)


def _bwd_dkv(q, k, v, do, lse, delta, causal, scale, bias, window, seg,
             wrapper, shift=0):
    """The launch of the resident dK/dV kernel for ``wrapper``, as
    :func:`_bwd_dq`."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    shift = _shift_arg(shift, causal, window)
    (q, k, v, do), (lse, delta), dk_, strides, tiles = _res_bwd_launch(
        q, k, v, do, lse, delta, wrapper.__name__, False)
    bargs = _bias_args(bias, q, sq, sk)
    sargs, _keep = _seg_args(seg, tiles[0], tiles[1], False)
    dk = torch.empty((b, h, sk, dk_), device=q.device, dtype=k.dtype)
    dv = torch.empty_like(dk)
    if dk.numel() == 0 or sq == 0:
        return dk.zero_()[..., :d], dv.zero_()[..., :d]
    err = build.load().apex_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bargs[0], b, h, sq, sk, dk_, *strides, *bargs[1:], float(scale),
        int(causal), _window_arg(window), shift, *tiles,
        build.DTYPES[q.dtype], *sargs, build.current_stream(q.get_device()))
    build.check(err, "apex_flash_bwd_dkv")
    wrapper.launches += 1
    if dk_ != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


flash_attention_bwd_dkv.launches = 0


# ---------------------------------------------------------------------------
# streamed kernels: the band of tiles, split across CTAs
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _window_k_range(qt: int, nk: int, causal: bool, window: Optional[int],
                    blk_q: int = BWD_INNER_TILE,
                    blk_k: int = BWD_INNER_TILE,
                    shift: int = 0) -> Tuple[int, int]:
    """``[lo, hi)`` of the key tiles (``blk_k`` rows) that query tile ``qt``
    (``blk_q`` rows) sees: the causal limit (``flash_attention.py:
    304-309``), then the window (``_window_k_range``, ``:117-130``), with
    the ring offsets' ``shift = q_off - k_off`` (``k_tiles`` in
    ``csrc/flash_bwd_wgmma.cuh``). ``hi < lo`` where the window starts past
    the last tile: an empty band."""
    lo, hi = 0, nk
    if causal:
        hi = min(hi, max(0, (shift + (qt + 1) * blk_q + blk_k - 1) // blk_k))
    if window is not None:
        lo = max(lo, (shift + qt * blk_q - window + 1) // blk_k)
        if not causal:
            hi = max(0, min(hi, (shift + (qt + 1) * blk_q + window - 2)
                            // blk_k + 1))
    return lo, hi


def _window_q_range(kt: int, nq: int, causal: bool, window: Optional[int],
                    blk_q: int = BWD_INNER_TILE,
                    blk_k: int = BWD_INNER_TILE,
                    shift: int = 0) -> Tuple[int, int]:
    """``[lo, hi)`` of the query tiles (``blk_q`` rows) that see key tile
    ``kt`` (``blk_k`` rows): the causal start (``flash_attention.py:478``)
    and the window (``_window_q_range``, ``:133-143``), with the ring
    offsets' ``shift`` (``q_tiles``)."""
    lo, hi = 0, nq
    if causal:
        lo = min(max(0, (kt * blk_k - shift) // blk_q), nq)
    if window is not None:
        hi = max(0, min(hi, ((kt + 1) * blk_k - shift + window - 2) // blk_q
                        + 1))
        if not causal:
            lo = max(lo, (kt * blk_k - shift - window + 1) // blk_q)
    return lo, hi


def _splits(lo: int, hi: int, split_tiles: int) -> List[Tuple[int, int]]:
    """The band ``[lo, hi)`` cut into ``ceil(n / split_tiles)`` pieces of
    equal length (the last may be shorter): one CTA each (``split_of`` in
    ``csrc/flash_bwd_wgmma.cuh``)."""
    n = hi - lo
    if n <= 0:
        return []
    ns = _cdiv(n, split_tiles)
    per = _cdiv(n, ns)
    return [(lo + s * per, min(hi, lo + (s + 1) * per)) for s in range(ns)
            if lo + s * per < hi]


@functools.lru_cache(maxsize=64)
def _bands(n_outer: int, n_inner: int, causal: bool, window: Optional[int],
           inner_is_k: bool, split_tiles: int, blk_q: int, blk_k: int,
           shift: int = 0):
    """Per outer tile its list of splits, and the most splits of any: the
    grid's split extent (0 where the ring offsets' ``shift`` leaves every
    band empty)."""
    rng = _window_k_range if inner_is_k else _window_q_range
    bands = tuple(tuple(_splits(*rng(i, n_inner, causal, window, blk_q,
                                     blk_k, shift), split_tiles))
                  for i in range(n_outer))
    return bands, max((len(b) for b in bands), default=0)


def _fwd_tiles(bf16: bool, d: int) -> Tuple[int, int, int]:
    """(query rows of a CTA, key rows of a tile, key tiles of a split) of
    the streamed forward's route at head_dim ``d``: bf16 FWD_OUTER_TILE /
    FWD_INNER_TILE / FWD_SPLIT_TILES; fp32 FWD_F32_OUTER_TILE /
    FWD_F32_INNER_TILE through :func:`_f32_fwd_tiles`, FWD_F32_SPLIT_TILES."""
    if bf16:
        return FWD_OUTER_TILE, FWD_INNER_TILE, FWD_SPLIT_TILES
    return (*_f32_fwd_tiles(FWD_F32_OUTER_TILE, FWD_F32_INNER_TILE, d),
            FWD_F32_SPLIT_TILES)


def _fwd_bands(sq, sk, causal, window, tiles=None, shift=0):
    """The forward's bands, as the kernel and the plain version cut them at
    ``tiles`` (:func:`_fwd_tiles`; the bf16 route's by default): query
    tiles of ``tiles[0]`` rows, key tiles of ``tiles[1]`` rows, splits of
    ``tiles[2]`` key tiles; at the ring offsets' ``shift``."""
    o, i, split = tiles or _fwd_tiles(True, 0)
    return _bands(_cdiv(sq, o), _cdiv(sk, i), causal, window, True, split,
                  o, i, shift)


def _fwd_merges(nsplit: int) -> bool:
    """Whether a streamed forward launches the merge pass and needs its fp32
    workspace (partials of ``nsplit`` splits): only where some band has
    several splits, in either dtype (a band of one is written by the split
    pass)."""
    return nsplit > 1


def _bwd_tiles(bf16: bool, inner_is_k: bool,
               d: int) -> Tuple[int, int, Optional[int]]:
    """(outer rows of a CTA, inner rows of a tile, inner tiles of a split or
    None: whole bands) of the streamed backward's pass (dQ when
    ``inner_is_k``) on its dtype's route at head_dim ``d``: bf16
    BWD_OUTER_TILE / BWD_INNER_TILE / BWD_SPLIT_TILES; fp32 the resident
    fp32 pair's tiles (:func:`_res_bwd_tiles`) over whole bands."""
    if bf16:
        return BWD_OUTER_TILE, BWD_INNER_TILE, BWD_SPLIT_TILES
    return (*_res_bwd_tiles(False, inner_is_k, d)[:2], None)


def _bwd_bands(sq, sk, causal, window, inner_is_k, tiles=None, shift=0):
    """The backward kernels' bands, as the kernels and the plain versions
    cut them at ``tiles`` (:func:`_bwd_tiles`; the bf16 route's by
    default): outer tiles of ``tiles[0]`` rows (queries when
    ``inner_is_k``, else keys), inner tiles of ``tiles[1]`` rows, splits of
    ``tiles[2]`` inner tiles (None: one piece a band); at the ring
    offsets' ``shift``."""
    o, i, split = tiles or _bwd_tiles(True, inner_is_k, 0)
    n_out, n_in = ((_cdiv(sq, o), _cdiv(sk, i)) if inner_is_k
                   else (_cdiv(sk, o), _cdiv(sq, i)))
    split = split or max(n_in, 1)
    if inner_is_k:
        return _bands(n_out, n_in, causal, window, True, split, o, i, shift)
    return _bands(n_out, n_in, causal, window, False, split, i, o, shift)


def _res_bwd_bands(sq: int, sk: int, causal: bool, inner_is_k: bool,
                   outer: Optional[int] = None,
                   inner: Optional[int] = None,
                   window: Optional[int] = None,
                   shift: int = 0) -> Tuple[Tuple[int, int], ...]:
    """The resident kernels' bands, one piece each: per outer tile of
    ``outer`` rows (BWD_OUTER_TILE; queries when ``inner_is_k``, the dQ
    pass, else keys) the ``[lo, hi)`` of the ``inner``-row inner tiles (the
    pass's at d <= 64, :func:`_res_bwd_inner`) its CTA streams -- the
    causal limit and the window for dQ, the causal start and the window
    for dK/dV (``k_tiles`` / ``q_tiles`` in ``csrc/flash_bwd_wgmma.cuh``),
    at the ring offsets' ``shift``, before the segment bounds narrow
    them."""
    o = BWD_OUTER_TILE if outer is None else outer
    i = _res_bwd_inner(inner_is_k, 64) if inner is None else inner
    if inner_is_k:
        nk = _cdiv(sk, i)
        return tuple(_window_k_range(t, nk, causal, window, o, i, shift)
                     for t in range(_cdiv(sq, o)))
    nq = _cdiv(sq, i)
    return tuple(_window_q_range(t, nq, causal, window, i, o, shift)
                 for t in range(_cdiv(sk, o)))


def _res_fwd_bands(sq: int, sk: int, causal: bool,
                   outer: Optional[int] = None,
                   inner: Optional[int] = None,
                   window: Optional[int] = None,
                   shift: int = 0) -> Tuple[Tuple[int, int], ...]:
    """The resident forward's bands, one piece each: per query tile of
    ``outer`` rows (RES_FWD_OUTER_TILE) the ``[lo, hi)`` of the
    ``inner``-row key tiles (RES_FWD_INNER_TILE; the tiles of a launch:
    :func:`_res_fwd_tiles`) its CTA streams -- the causal limit and the
    window (``k_tiles`` in ``csrc/flash_bwd_wgmma.cuh``) at the ring
    offsets' ``shift``, before the segment bounds narrow them."""
    o = RES_FWD_OUTER_TILE if outer is None else outer
    i = RES_FWD_INNER_TILE if inner is None else inner
    nk = _cdiv(sk, i)
    return tuple(_window_k_range(t, nk, causal, window, o, i, shift)
                 for t in range(_cdiv(sq, o)))


def _res_fwd_items(sq: int, bh: int,
                   outer: Optional[int] = None) -> Tuple[Tuple[int, int],
                                                         ...]:
    """The resident forward's items in launch order, ``(query tile, b*h
    index)``: item w is query tile ``n_outer - 1 - w // bh`` of head
    ``w % bh``, so under causal the longest bands go first; a persistent
    CTA c takes items c, c + grid, ... (``fwd_resident_wgmma``)."""
    o = RES_FWD_OUTER_TILE if outer is None else outer
    n_outer = _cdiv(sq, o)
    return tuple((n_outer - 1 - w // bh, w % bh)
                 for w in range(n_outer * bh))


def _tma_ok(t: torch.Tensor) -> bool:
    """Whether TMA reads ``t`` (b, h, s, d) bf16 as it is: d a multiple of 8
    (the kernels add pairs of columns), a 16-byte-aligned base and every
    (b, h, s) stride a positive multiple of 16 bytes where its size is
    above 1 (``encode_rows_map`` in ``csrc/hopper.cuh``)."""
    if t.shape[-1] % 8 or t.data_ptr() % 16:
        return False
    return all(st > 0 and st % 8 == 0
               for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _pad_head_dim(t: torch.Tensor, dp: int) -> torch.Tensor:
    """A contiguous copy of ``t`` with its head_dim zero-padded to ``dp``."""
    out = t.new_zeros(*t.shape[:-1], dp)
    out[..., :t.shape[-1]] = t
    return out


def _tma_operands(ts):
    """The operands of a bf16 wgmma kernel (every bf16 flash kernel: q, k,
    v, and dO for a backward) as the kernel reads
    them, and their head_dim: as they are where TMA takes them all, else
    each one TMA refuses (and all of them when d is not a multiple of 8)
    as a contiguous copy with d zero-padded to a multiple of 8. Padded
    columns add 0 to every score and give 0 output and gradient columns,
    which the caller slices off."""
    d = ts[0].shape[-1]
    if all(_tma_ok(t) for t in ts):
        return ts, d
    dp = _cdiv(d, 8) * 8
    return [t if dp == d and _tma_ok(t) else _pad_head_dim(t, dp)
            for t in ts], dp


def _stream_rows(seg: Optional[_Segments], b: int) -> List[slice]:
    """The batch rows a streamed plain version walks at once: each row on
    its own where contiguous segment bounds narrow the splits (the bounds
    differ from row to row), else all rows together."""
    if seg is not None and seg.contiguous:
        return [slice(i, i + 1) for i in range(b)]
    return [slice(None)]


def _stream_bounds(seg: Optional[_Segments], outer: int, inner: int,
                   inner_is_k: bool):
    """The contiguous-segment bounds a streamed kernel with these tiles
    reads, as nested lists ``[b][2][n_outer]``, or None (mask only)."""
    if seg is None or not seg.contiguous:
        return None
    return _seg_tables(seg, outer, inner, inner_is_k)[0].tolist()


def _narrow(bounds, rows: slice, t: int, a: int, e: int) -> Tuple[int, int]:
    """Split ``[a, e)`` of outer tile ``t`` narrowed by the bounds of batch
    row ``rows`` (as each split CTA narrows its own)."""
    if bounds is None:
        return a, e
    lo, hi = bounds[rows.start][0][t], bounds[rows.start][1][t]
    return max(a, lo), min(e, hi)


def flash_attention_fwd_stream_reference(q, k, v, *, causal: bool,
                                         scale: Optional[float] = None,
                                         window: Optional[int] = None,
                                         segment_ids=None,
                                         pad_id: Optional[int] = None,
                                         contiguous_segments: bool = False,
                                         shift: int = 0
                                         ) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Plain streamed forward, the kernel's arithmetic in fp32: per query
    tile, each split of its band (:func:`_fwd_bands`), narrowed by the
    contiguous-segment
    bounds as the kernel narrows it, gives a partial (unnormalised acc, row
    max m, row sum l; a split left empty gives acc 0, m NEG_INF, l 0), and
    the lse merge combines them: ``m* = max m_i``,
    ``l* = sum l_i e^(m_i - m*)``, ``o = sum acc_i e^(m_i - m*) / l*``,
    ``lse = m* + log l*`` (a band of one split is that split's own
    normalisation). A row with no visible key gives o = 0 exactly and lse =
    NEG_INF. Returns ``(o, lse)`` as the kernels do, at the tiles of q's
    dtype's route (:func:`_fwd_tiles`); ``shift``: the ring offsets' ``q_off
    - k_off``."""
    seg = _as_seg(segment_ids, pad_id, contiguous_segments, q, k)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = (d ** -0.5) if scale is None else float(scale)
    tiles = _fwd_tiles(q.dtype == torch.bfloat16, d)
    to, ti = tiles[:2]
    q32, k32, v32 = q.float(), k.float(), v.float()
    o = torch.zeros(b, h, sq, d, device=q.device)
    lse = torch.full((b, h, sq), NEG_INF, device=q.device)
    bands, _ = _fwd_bands(sq, sk, causal, window, tiles, shift)
    bounds = _stream_bounds(seg, to, ti, True)
    for rows in _stream_rows(seg, b):
        for qt, splits in enumerate(bands):
            if not splits:
                continue
            r0, r1 = qt * to, min(sq, (qt + 1) * to)
            parts = []
            for a, e in splits:
                a, e = _narrow(bounds, rows, qt, a, e)
                if a >= e:
                    m = torch.full_like(lse[rows, :, r0:r1], NEG_INF)
                    parts.append((torch.zeros_like(o[rows, :, r0:r1]), m,
                                  torch.zeros_like(m)))
                    continue
                c0, c1 = a * ti, min(sk, e * ti)
                s = torch.einsum("bhqd,bhkd->bhqk", q32[rows, :, r0:r1],
                                 k32[rows, :, c0:c1]) * scale
                s = _mask_scores(s, causal, window, r0, c0, seg, rows, shift)
                m = s.amax(-1)
                p = torch.where((m <= NEG_INF / 2)[..., None], 0.0,
                                torch.exp(s - m[..., None]))
                parts.append((torch.einsum("bhqk,bhkd->bhqd", p,
                                           v32[rows, :, c0:c1]), m,
                              p.sum(-1)))
            m_star = torch.stack([m for _, m, _ in parts]).amax(0)
            acc = torch.zeros_like(o[rows, :, r0:r1])
            l_star = torch.zeros_like(m_star)
            for acc_i, m_i, l_i in parts:
                w = torch.exp(m_i - m_star)
                acc += acc_i * w[..., None]
                l_star += l_i * w
            l_safe = torch.where(l_star == 0.0, 1.0, l_star)
            o[rows, :, r0:r1] = acc / l_safe[..., None]
            lse[rows, :, r0:r1] = m_star + torch.log(l_safe)
    return o.to(q.dtype), lse


def flash_attention_bwd_dq_stream_reference(q, k, v, do, lse, delta, *,
                                            causal: bool, scale: float,
                                            window: Optional[int] = None,
                                            segment_ids=None,
                                            pad_id: Optional[int] = None,
                                            contiguous_segments: bool = False,
                                            shift: int = 0
                                            ) -> torch.Tensor:
    """Plain streamed dQ: per query tile, each split of its band of key
    tiles (at the tiles of q's dtype's route, :func:`_bwd_tiles`: in fp32
    the whole band), narrowed by the segment bounds (an empty one adds
    nothing), adds ``scale * dS K`` over its keys into an fp32 sum (the
    bf16 kernel's atomics), ``dS = P * (dO V^T - delta)``; dQ in q's
    dtype; at the ring offsets' ``shift``."""
    seg = _as_seg(segment_ids, pad_id, contiguous_segments, q, k)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    tiles = _bwd_tiles(q.dtype == torch.bfloat16, True, d)
    to, ti = tiles[:2]
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    lse, delta = lse.float(), delta.float()
    dq = torch.zeros(b, h, sq, d, device=q.device)
    bands, _ = _bwd_bands(sq, sk, causal, window, True, tiles, shift)
    bounds = _stream_bounds(seg, to, ti, True)
    for rows in _stream_rows(seg, b):
        for qt, splits in enumerate(bands):
            r0, r1 = qt * to, min(sq, (qt + 1) * to)
            for a, e in splits:
                a, e = _narrow(bounds, rows, qt, a, e)
                if a >= e:
                    continue
                c0, c1 = a * ti, min(sk, e * ti)
                s = torch.einsum("bhqd,bhkd->bhqk", q32[rows, :, r0:r1],
                                 k32[rows, :, c0:c1]) * scale
                p = _probs(s, lse[rows, :, r0:r1], causal, window, r0, c0,
                           seg, rows, shift)
                dp = torch.einsum("bhqd,bhkd->bhqk", do32[rows, :, r0:r1],
                                  v32[rows, :, c0:c1])
                ds = p * (dp - delta[rows, :, r0:r1, None])
                dq[rows, :, r0:r1] += scale * torch.einsum(
                    "bhqk,bhkd->bhqd", ds, k32[rows, :, c0:c1])
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_stream_reference(q, k, v, do, lse, delta, *,
                                             causal: bool, scale: float,
                                             window: Optional[int] = None,
                                             segment_ids=None,
                                             pad_id: Optional[int] = None,
                                             contiguous_segments: bool = False,
                                             shift: int = 0
                                             ) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Plain streamed dK/dV: per key tile, each split of the query tiles
    that see it (at the tiles of q's dtype's route, :func:`_bwd_tiles`: in
    fp32 the whole band), narrowed by the segment bounds (an empty one adds
    nothing), adds ``scale * dS^T Q`` and ``P^T dO`` into fp32 sums;
    ``(dk, dv)`` in k's dtype; at the ring offsets' ``shift``."""
    seg = _as_seg(segment_ids, pad_id, contiguous_segments, q, k)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    tiles = _bwd_tiles(q.dtype == torch.bfloat16, False, d)
    to, ti = tiles[:2]
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    lse, delta = lse.float(), delta.float()
    dk = torch.zeros(b, h, sk, d, device=q.device)
    dv = torch.zeros_like(dk)
    bands, _ = _bwd_bands(sq, sk, causal, window, False, tiles, shift)
    bounds = _stream_bounds(seg, to, ti, False)
    for rows in _stream_rows(seg, b):
        for kt, splits in enumerate(bands):
            c0, c1 = kt * to, min(sk, (kt + 1) * to)
            for a, e in splits:
                a, e = _narrow(bounds, rows, kt, a, e)
                if a >= e:
                    continue
                r0, r1 = a * ti, min(sq, e * ti)
                s = torch.einsum("bhqd,bhkd->bhqk", q32[rows, :, r0:r1],
                                 k32[rows, :, c0:c1]) * scale
                p = _probs(s, lse[rows, :, r0:r1], causal, window, r0, c0,
                           seg, rows, shift)
                dp = torch.einsum("bhqd,bhkd->bhqk", do32[rows, :, r0:r1],
                                  v32[rows, :, c0:c1])
                ds = p * (dp - delta[rows, :, r0:r1, None])
                dv[rows, :, c0:c1] += torch.einsum("bhqk,bhqd->bhkd", p,
                                                   do32[rows, :, r0:r1])
                dk[rows, :, c0:c1] += scale * torch.einsum(
                    "bhqk,bhqd->bhkd", ds, q32[rows, :, r0:r1])
    return dk.to(k.dtype), dv.to(v.dtype)


def _window_arg(window: Optional[int]) -> int:
    return 0 if window is None else int(window)


def _shift_arg(shift: int, causal: bool, window: Optional[int]) -> int:
    """The ring offsets' ``q_off - k_off`` as a launch takes it: 0 where
    neither the causal nor the window mask reads it (and the launch is the
    one a call without it makes)."""
    return int(shift) if causal or window is not None else 0


def flash_attention_fwd_stream(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = False,
                               scale: Optional[float] = None,
                               window: Optional[int] = None,
                               segment_ids=None,
                               pad_id: Optional[int] = None,
                               contiguous_segments: bool = False,
                               shift: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the streamed forward on CUDA tensors: ``(o, lse)`` as
    :func:`flash_attention_fwd`, with the sliding ``window``, the segment
    masks and the ring offsets' ``shift`` (``q_off - k_off``). bf16 takes
    the wgmma kernel (operands TMA can read: :func:`_tma_operands`), fp32 the register-blocked FMA kernel, each at
    its route's tiles (:func:`_fwd_tiles`), with the merge pass and its
    fp32 workspace only where a band has several splits
    (:func:`_fwd_merges`). The splits come from shapes alone; the segment
    bounds narrow each on the card. Counts its launches in
    ``flash_attention_fwd_stream.launches``."""
    seg = _as_seg(segment_ids, pad_id, contiguous_segments, q, k)
    shift = _shift_arg(shift, causal, window)
    q, k, v, (b, h, sq, sk, d) = _fwd_args(q, k, v,
                                           "flash_attention_fwd_stream")
    scale = (d ** -0.5) if scale is None else float(scale)
    bf16 = q.dtype == torch.bfloat16
    dk_ = d
    if bf16:
        (q, k, v), dk_ = _tma_operands([q, k, v])
    route = _fwd_tiles(bf16, d)
    _, nsplit = _fwd_bands(sq, sk, causal, window, route, shift)
    tiles = (*route, nsplit)
    sargs, _keep = _seg_args(seg, tiles[0], tiles[1], True)
    o = torch.empty((b, h, sq, dk_), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    if o.numel() == 0:
        return o[..., :d], lse
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    acc = ml = None
    if _fwd_merges(nsplit):
        acc = torch.empty((nsplit, b * h, sq, dk_), device=q.device,
                          dtype=torch.float32)
        ml = torch.empty((2, nsplit, b * h, sq), device=q.device,
                         dtype=torch.float32)
    ptrs = (0, 0, 0) if acc is None else (
        acc.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr())
    err = build.load().apex_flash_fwd_stream(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, o.data_ptr(),
        lse.data_ptr(), b, h, sq, sk, dk_, q.stride(0), q.stride(1),
        q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), scale, int(causal),
        _window_arg(window), shift, *tiles, build.DTYPES[q.dtype], *sargs,
        build.current_stream(q.get_device()))
    build.check(err, "apex_flash_fwd_stream")
    flash_attention_fwd_stream.launches += 1
    if dk_ != d:
        o = o[..., :d].contiguous()
    return o, lse


flash_attention_fwd_stream.launches = 0


def _bwd_stream_launch(q, k, v, do, lse, delta, causal, window, name,
                       inner_is_k, shift=0):
    """Check the bf16 operands of a streamed backward kernel (the wgmma
    kernels: operands TMA can read, :func:`_tma_operands`). Returns the
    operands, lse/delta, the head_dim the kernel sees, the strides and the
    launch arguments after ``window``, before the dtype: (outer tile, inner
    tile, split tiles, splits)."""
    (q, k, v, do), (lse, delta), _, (b, h, sq, sk, d) = _bwd_args(
        q, k, v, do, lse, delta, name)
    (q, k, v, do), d = _tma_operands([q, k, v, do])
    route = _bwd_tiles(True, inner_is_k, d)
    _, nsplit = _bwd_bands(sq, sk, causal, window, inner_is_k, route, shift)
    tiles = (*route, nsplit)
    strides = [st for t in (q, k, v, do) for st in t.stride()[:3]]
    return (q, k, v, do), (lse, delta), d, strides, tiles


def flash_attention_bwd_dq_stream(q, k, v, do, lse, delta, *, causal: bool,
                                  scale: float,
                                  window: Optional[int] = None,
                                  segment_ids=None,
                                  pad_id: Optional[int] = None,
                                  contiguous_segments: bool = False,
                                  shift: int = 0
                                  ) -> torch.Tensor:
    """Launch the streamed dQ kernel on CUDA tensors: dQ in q's dtype. In
    bf16 its CTAs add into a zeroed fp32 accumulator (a split the segment
    bounds leave empty adds nothing), cast to bf16 after; in fp32 it is the
    resident fp32 kernel over whole bands (:func:`flash_attention_bwd_dq`
    with no bias), which writes each element once. The ring offsets'
    ``shift`` as :func:`flash_attention_fwd_stream` takes it. Counts its
    launches in ``flash_attention_bwd_dq_stream.launches``."""
    seg = _as_seg(segment_ids, pad_id, contiguous_segments, q, k)
    if q.dtype == torch.float32:
        return _bwd_dq(q, k, v, do, lse, delta, causal, scale, None, False,
                       window, seg, flash_attention_bwd_dq_stream, shift)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    shift = _shift_arg(shift, causal, window)
    (q, k, v, do), (lse, delta), dk_, strides, tiles = _bwd_stream_launch(
        q, k, v, do, lse, delta, causal, window,
        "flash_attention_bwd_dq_stream", True, shift)
    sargs, _keep = _seg_args(seg, tiles[0], tiles[1], True)
    dq = torch.zeros((b, h, sq, dk_), device=q.device, dtype=torch.float32)
    if dq.numel() == 0:
        return dq[..., :d].to(q.dtype)
    err = build.load().apex_flash_bwd_dq_stream(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq, sk, dk_,
        *strides, float(scale), int(causal), _window_arg(window), shift,
        *tiles, build.DTYPES[q.dtype], *sargs,
        build.current_stream(q.get_device()))
    build.check(err, "apex_flash_bwd_dq_stream")
    flash_attention_bwd_dq_stream.launches += 1
    return dq[..., :d].to(q.dtype)


flash_attention_bwd_dq_stream.launches = 0


def flash_attention_bwd_dkv_stream(q, k, v, do, lse, delta, *, causal: bool,
                                   scale: float,
                                   window: Optional[int] = None,
                                   segment_ids=None,
                                   pad_id: Optional[int] = None,
                                   contiguous_segments: bool = False,
                                   shift: int = 0
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the streamed dK/dV kernel on CUDA tensors: ``(dk, dv)`` in
    k's dtype, as :func:`flash_attention_bwd_dq_stream` gives dQ (in fp32
    the resident fp32 kernel, :func:`flash_attention_bwd_dkv`: a key no
    query sees gets 0). Counts its launches in
    ``flash_attention_bwd_dkv_stream.launches``."""
    seg = _as_seg(segment_ids, pad_id, contiguous_segments, q, k)
    if q.dtype == torch.float32:
        return _bwd_dkv(q, k, v, do, lse, delta, causal, scale, None, window,
                        seg, flash_attention_bwd_dkv_stream, shift)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    shift = _shift_arg(shift, causal, window)
    (q, k, v, do), (lse, delta), dk_, strides, tiles = _bwd_stream_launch(
        q, k, v, do, lse, delta, causal, window,
        "flash_attention_bwd_dkv_stream", False, shift)
    sargs, _keep = _seg_args(seg, tiles[0], tiles[1], False)
    dk = torch.zeros((b, h, sk, dk_), device=q.device, dtype=torch.float32)
    dv = torch.zeros_like(dk)
    if dk.numel() == 0 or sq == 0:
        return dk[..., :d].to(k.dtype), dv[..., :d].to(v.dtype)
    err = build.load().apex_flash_bwd_dkv_stream(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
        sq, sk, dk_, *strides, float(scale), int(causal), _window_arg(window),
        shift, *tiles, build.DTYPES[q.dtype], *sargs,
        build.current_stream(q.get_device()))
    build.check(err, "apex_flash_bwd_dkv_stream")
    flash_attention_bwd_dkv_stream.launches += 1
    return dk[..., :d].to(k.dtype), dv[..., :d].to(v.dtype)


flash_attention_bwd_dkv_stream.launches = 0


def _forward(q, k, v, causal, scale, stream, window, bias=None, seg=None,
             shift=0):
    """``(o, lse)``: the kernel on a CUDA tensor, its plain version on a
    CPU one. A bias never streams (:func:`use_stream`). ``shift``: the ring
    offsets' ``q_off - k_off``."""
    kw = dict(causal=causal, scale=scale, window=window, segment_ids=seg,
              shift=shift)
    if stream:
        fn = (flash_attention_fwd_stream if q.device.type == "cuda"
              else flash_attention_fwd_stream_reference)
        return fn(q, k, v, **kw)
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, bias=bias, **kw)
    if bias is None and seg is None and window is None:
        return (mha_reference(q, k, v, causal=causal, scale=scale,
                              shift=shift),
                _lse_reference(q, k, causal, scale, shift=shift))
    return flash_attention_fwd_reference(q, k, v, bias=bias, **kw)


def _backward(q, k, v, o, lse, do, causal, scale, stream, window, bias=None,
              want_db=False, seg=None, shift=0, delta=None):
    """``(dq, dk, dv, dbias or None)`` of the two-pass backward from the
    forward's ``o`` and fp32 ``lse``: the kernels on CUDA tensors, their
    plain versions on CPU ones; dbias from the dQ pass where ``want_db``.
    ``delta`` (``rowsum(dO * O)`` in fp32) is computed from ``o`` unless
    given; ``shift``: the ring offsets' ``q_off - k_off``."""
    kw = dict(causal=causal, scale=scale, window=window, segment_ids=seg,
              shift=shift)
    cuda = q.device.type == "cuda"
    if not stream and not cuda:
        dq, dk, dv, *db = flash_attention_bwd_reference(
            q, k, v, o, lse, do, bias=bias, **kw)
        return dq, dk, dv, (db[0] if want_db else None)
    if delta is None:
        delta = (o.float() * do.float()).sum(-1)
    if stream:
        dq_fn, dkv_fn = ((flash_attention_bwd_dq_stream,
                          flash_attention_bwd_dkv_stream) if cuda else
                         (flash_attention_bwd_dq_stream_reference,
                          flash_attention_bwd_dkv_stream_reference))
        dq = dq_fn(q, k, v, do, lse, delta, **kw)
        dk, dv = dkv_fn(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None
    got = flash_attention_bwd_dq(q, k, v, do, lse, delta, bias=bias,
                                 dbias=want_db, **kw)
    dq, db = got if want_db else (got, None)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, bias=bias,
                                     **kw)
    return dq, dk, dv, db


class FlashAttention(torch.autograd.Function):
    """Causal or non-causal attention with an optional additive bias (fp32
    ``(b|1, h|1, sq, sk)``, resident only), the sliding window and the
    segment masks (``seg``: :class:`_Segments` or None), resident or
    streamed, with the two-pass flash backward (``_flash_vjp_fwd`` /
    ``_flash_vjp_bwd``): a streamed forward is followed by the streamed
    backward. dbias comes from the dQ pass, and only where the bias requires
    grad. Kernels on CUDA tensors, plain versions on CPU ones."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, stream, window, seg):
        o, lse = _forward(q, k, v, causal, scale, stream, window, bias, seg)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.stream, ctx.window, ctx.seg = stream, window, seg
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        want_db = bias is not None and ctx.needs_input_grad[3]
        grads = _backward(q, k, v, o, lse, do, ctx.causal, ctx.scale,
                          ctx.stream, ctx.window, bias, want_db, ctx.seg)
        return (*grads, *(None,) * 5)


_STREAM_CHOICES = ("auto", "never", "always")


def use_stream(stream: str, sq: int, sk: int, window: Optional[int],
               has_bias: bool) -> bool:
    """The ``stream=`` decision (the reference's at
    ``flash_attention.py:1722-1739``, with the port's own 'auto' rule):
    'auto' streams at ``max(sq, sk) >= STREAM_MIN_SEQ`` or with a window
    (``window`` already reset to None where it covers everything); a dense
    bias never streams, and 'always' with one raises."""
    if stream not in _STREAM_CHOICES:
        raise ValueError(f"stream must be auto|never|always, got {stream!r}")
    do = stream == "always" or (stream == "auto" and (
        max(sq, sk) >= STREAM_MIN_SEQ or window is not None))
    if do and has_bias:
        if stream == "always":
            raise ValueError("stream='always' does not support dense bias; "
                             "use segment_ids/causal for long sequences")
        do = False
    return do


#: whether the one-time hint to pass contiguous_segments=True has fired
_WARNED_PACKED_OPT_IN = False


def _check_monotone(seg: _Segments) -> None:
    """The reference's check of packed ids (``flash_attention.py:
    1632-1664``): with ``contiguous_segments`` ids that are not
    non-decreasing raise ``ValueError`` (block skipping would drop valid
    pairs); without it, non-decreasing ids give a one-time hint to opt in.
    It costs a reduction and one host read per call (none once the hint has
    fired on mask-only calls). While a CUDA graph is being captured the
    check is skipped and the caller owns the guarantee, as the reference's
    caller does under ``jit``."""
    global _WARNED_PACKED_OPT_IN
    if not seg.contiguous and _WARNED_PACKED_OPT_IN:
        return
    if seg.q.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    down = torch.stack([(seg.q.diff(dim=-1) < 0).any(),
                        (seg.k.diff(dim=-1) < 0).any()]).tolist()
    if seg.contiguous:
        for name, bad in zip(("q", "kv"), down):
            if bad:
                raise ValueError(
                    f"{name} segment ids are not non-decreasing; pass "
                    "contiguous_segments=False for non-packed layouts "
                    "(mask-only, no block skipping)")
    elif not any(down):
        _WARNED_PACKED_OPT_IN = True
        warnings.warn(
            "flash_attention: segment ids are non-decreasing (packed "
            "layout) but contiguous_segments=False; pass "
            "contiguous_segments=True to enable block skipping (cost "
            "sum(len_i^2) instead of total^2)", stacklevel=3)


def _canonical_bias(bias: torch.Tensor, b: int, h: int, sq: int,
                    sk: int) -> torch.Tensor:
    """The reference's checks and canonical form of a bias
    (``flash_attention.py:1711-1721``): rank 4, batch and head dims 1 or
    b / h, and size-1 sq/sk dims broadcast away -- here an fp32 ``expand``
    outside the autograd Function, so autograd's sum of the expand gives
    the caller's dbias shape, as ``broadcast_to``'s VJP does."""
    if bias.dim() != 4:
        raise ValueError(f"bias must be rank-4 broadcastable, got shape "
                         f"{tuple(bias.shape)}")
    bb, bh, bq, bk = bias.shape
    if bb not in (1, b) or bh not in (1, h) or bq not in (1, sq) \
            or bk not in (1, sk):
        raise ValueError(f"bias shape {tuple(bias.shape)} not broadcastable "
                         f"to ({b}, {h}, {sq}, {sk})")
    return bias.float().expand(bb, bh, sq, sk)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    segment_ids: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    pad_id: Optional[int] = None,
                    contiguous_segments: bool = False, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    stream: str = "auto") -> torch.Tensor:
    """Fused multi-head attention on ``(batch, heads, seq, head_dim)``.

    Same arguments and semantics as the reference's ``flash_attention``
    (minus its TPU tiling knobs): ``causal`` is the top-left-aligned
    upper-triangular mask, ``window`` the sliding window, ``bias`` an
    additive bias broadcastable to ``(b, h, sq, sk)``, ``segment_ids`` the
    packed-varlen equality mask ``(b, sq)`` / ``(b, sk)`` with ``pad_id``
    keys never attended, ``contiguous_segments`` the caller's statement that
    the ids are non-decreasing, which turns on block skipping (checked:
    :func:`_check_monotone`), ``stream`` 'auto' | 'never' | 'always'
    (:func:`use_stream`). Both devices go through :class:`FlashAttention`
    (kernels on the card, plain versions on the CPU), streamed or
    resident, with every mask; the bias (:func:`_canonical_bias`) on the
    resident route. Rows that see no key output exactly 0.
    """
    sq, sk = q.shape[2], k.shape[2]
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be a positive int, got {window}")
        if window >= max(sq, sk):
            window = None  # the band covers everything: dense attention
    on = check_device(q, "q")
    if bias is not None:
        bias = _canonical_bias(bias, q.shape[0], q.shape[1], sq, sk)
    seg = _as_seg(segment_ids, pad_id, contiguous_segments, q, k)
    if seg is not None:
        _check_monotone(seg)
    do_stream = use_stream(stream, sq, sk, window, bias is not None)
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return FlashAttention.apply(q, k, v, bias, causal, scale, do_stream,
                                    window, seg)
    if on == "cpu" and not do_stream and bias is None and seg is None \
            and window is None:
        return mha_reference(q, k, v, causal=causal, scale=scale)
    return _forward(q, k, v, causal, scale, do_stream, window, bias, seg)[0]
