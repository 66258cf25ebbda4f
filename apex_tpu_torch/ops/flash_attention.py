"""Flash attention (port of ``apex_tpu/ops/flash_attention.py``).

Layout ``(batch, heads, seq, head_dim)``, as in the reference. On CUDA
tensors :func:`flash_attention` goes through :class:`FlashAttention`, a
``torch.autograd.Function`` mirroring the reference's custom VJP ``_flash``
(``flash_attention.py:1395-1429``), with its ``stream`` flag: a streamed
forward is always followed by the streamed backward.

- Resident (``stream=False``): the forward launches
  ``csrc/flash_attention.cu`` (replaces ``_fwd_kernel``) and saves q, k, v,
  o and the fp32 lse; the backward computes ``delta = rowsum(dO * O)`` in
  fp32 (``_flash_bwd``, ``:1210``) and launches the two kernels of
  ``csrc/flash_attention_bwd.cu`` (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``).
  Causal or non-causal, no masks on the card.
- Streamed (``stream=True``): the three kernels of
  ``csrc/flash_attention_stream.cu`` (``_fwd_kernel_stream`` with its merge
  pass, ``_bwd_dq_kernel_stream``, ``_bwd_dkv_kernel_stream``) split each
  row's K/V loop (or each key tile's Q loop) across CTAs, over the band the
  causal limit and the sliding ``window`` leave: the forward (and the fp32
  backward) in splits of at most :data:`STREAM_SPLIT_TILES` tiles of
  :data:`STREAM_TILE` rows; the bf16 backward, wgmma kernels fed by TMA, with
  CTAs of :data:`BWD_OUTER_TILE` rows streaming at most
  :data:`BWD_SPLIT_TILES` tiles of :data:`BWD_INNER_TILE` rows (operands TMA
  cannot read go in as contiguous copies, :func:`_tma_operands`). The window
  lives only here.

``stream='auto'`` streams when ``max(sq, sk) >= STREAM_MIN_SEQ`` or a window
is set. Both devices route alike; the card takes any sq/sk, head_dim <= 128,
bf16 or fp32. The additive ``bias`` and ``segment_ids``/``pad_id`` masks on
the card, and the window on the resident kernels, are later work and raise
there (ROADMAP Queue 2 items 4 and 5).

On CPU tensors the same Function runs the plain versions: for the resident
kernels :func:`mha_reference` with its lse and
:func:`flash_attention_bwd_reference`; for the streamed ones the per-split
partials and the lse merge (:func:`flash_attention_fwd_stream_reference`),
the split-wise dQ sums and the q-split dK/dV sums. With a mask the card does
not take, the CPU runs :func:`mha_reference`, the plain version ported whole
from ``flash_attention.py:1518-1556`` with every mask and the exact-zero
rule for fully-masked rows, under its own autograd.

The TPU layout rules (VMEM budgets, the 8-alignment fallbacks) are not
behaviour and are not carried over.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from apex_tpu_torch._device import check_device
from apex_tpu_torch.csrc import build

NEG_INF = -1e30
MAX_HEAD_DIM = 128

#: stream='auto' takes the streamed kernels at max(sq, sk) >= this (or with a
#: window). A routing choice on the card's numbers, not a memory limit: the
#: resident kernels take any length; see PERF.md for the times behind it.
STREAM_MIN_SEQ = 4096
#: rows of every q/k tile of the streamed kernels (kTile in common.cuh)
STREAM_TILE = 64
#: the longest split of a band, in tiles: one CTA's share of a row's K/V
#: loop (or of a key tile's Q loop). Shared by the kernels' wrappers and the
#: plain versions: the forward's, and the backward's in fp32.
STREAM_SPLIT_TILES = 16
#: the streamed backward in bf16 (the wgmma kernels): a CTA keeps
#: BWD_OUTER_TILE rows (queries for dQ, keys for dK/dV) and streams tiles of
#: BWD_INNER_TILE rows of the other side, at most BWD_SPLIT_TILES of them
#: (kOuter / kInner in csrc/flash_attention_stream.cu). The plain versions
#: of the backward split alike. The split length was tuned on the card
#: (PERF.md).
BWD_OUTER_TILE = 128
BWD_INNER_TILE = 64
BWD_SPLIT_TILES = 128


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
    s = _mask_scores(s, causal, window)
    p = torch.softmax(s, dim=-1)
    if masked:
        # rows with no visible key output exactly zero (softmax of an
        # all-masked row would be uniform), decided after every mask
        fully_masked = s.amax(-1, keepdim=True) <= NEG_INF / 2
        p = p.masked_fill(fully_masked, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors: ``(o, lse)``, o
    ``(b, h, sq, d)`` in q's dtype and lse ``(b, h, sq)`` fp32. Counts its
    launches in ``flash_attention_fwd.launches``."""
    q, k, v, (b, h, sq, sk, d) = _fwd_args(q, k, v, "flash_attention_fwd")
    scale = (d ** -0.5) if scale is None else float(scale)
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


def _mask_scores(s, causal, window=None, q0=0, k0=0):
    """The causal and window masks on scores whose first row and column sit
    at positions ``q0`` and ``k0``."""
    if causal or window is not None:
        sq, sk = s.shape[-2], s.shape[-1]
        s = _dense_pos_masks(
            s, torch.arange(q0, q0 + sq, device=s.device)[:, None],
            torch.arange(k0, k0 + sk, device=s.device)[None, :], causal,
            window)
    return s


def _lse_reference(q, k, causal, scale, window=None):
    """fp32 per-row logsumexp of the masked scores, as the forward kernel
    writes it (NEG_INF for a row with no visible key)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    return torch.logsumexp(_mask_scores(s, causal, window), dim=-1)


def _probs(s, lse, causal, window, q0=0, k0=0):
    """``P = exp(S - lse)`` as the backward kernels recompute it: 0 where
    masked and on rows whose ``lse <= NEG_INF / 2`` (no visible key)."""
    s = _mask_scores(s, causal, window, q0, k0)
    lse = lse[..., None]
    return torch.where(lse <= NEG_INF / 2, 0.0, torch.exp(s - lse))


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, causal: bool,
                                  scale: float,
                                  window: Optional[int] = None):
    """Plain backward, the arithmetic of the backward kernels:
    ``P = exp(S - lse)`` (0 where the causal or window mask hides the key,
    or where ``lse <= NEG_INF / 2``), ``dS = P * (dO V^T - delta)`` with
    ``delta = rowsum(dO * O)``; returns ``(dq, dk, dv)`` in q/k/v's dtypes,
    computed in fp32."""
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    delta = (o.float() * do32).sum(-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * scale
    p = _probs(s, lse.float(), causal, window)
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


# ---------------------------------------------------------------------------
# streamed kernels: the band of tiles, split across CTAs
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _window_k_range(qt: int, nk: int, causal: bool, window: Optional[int],
                    blk_q: int = STREAM_TILE,
                    blk_k: int = STREAM_TILE) -> Tuple[int, int]:
    """``[lo, hi)`` of the key tiles (``blk_k`` rows) that query tile ``qt``
    (``blk_q`` rows) sees: the causal limit, then the window
    (``_window_k_range``, ``flash_attention.py:117-130``, with no ring
    offsets)."""
    lo, hi = 0, nk
    if causal:
        hi = min(hi, _cdiv((qt + 1) * blk_q, blk_k))
    if window is not None:
        lo = max(lo, (qt * blk_q - window + 1) // blk_k)
        if not causal:
            hi = max(0, min(hi, ((qt + 1) * blk_q + window - 2) // blk_k + 1))
    return lo, hi


def _window_q_range(kt: int, nq: int, causal: bool, window: Optional[int],
                    blk_q: int = STREAM_TILE,
                    blk_k: int = STREAM_TILE) -> Tuple[int, int]:
    """``[lo, hi)`` of the query tiles (``blk_q`` rows) that see key tile
    ``kt`` (``blk_k`` rows) (``_window_q_range``, ``flash_attention.py:
    133-143``)."""
    lo, hi = 0, nq
    if causal:
        lo = min(kt * blk_k // blk_q, nq)
    if window is not None:
        hi = max(0, min(hi, ((kt + 1) * blk_k + window - 2) // blk_q + 1))
        if not causal:
            lo = max(lo, (kt * blk_k - window + 1) // blk_q)
    return lo, hi


def _splits(lo: int, hi: int, split_tiles: int) -> List[Tuple[int, int]]:
    """The band ``[lo, hi)`` cut into ``ceil(n / split_tiles)`` pieces of
    equal length (the last may be shorter): one CTA each (``split_of`` in
    ``csrc/flash_attention_stream.cu``)."""
    n = hi - lo
    if n <= 0:
        return []
    ns = _cdiv(n, split_tiles)
    per = _cdiv(n, ns)
    return [(lo + s * per, min(hi, lo + (s + 1) * per)) for s in range(ns)
            if lo + s * per < hi]


@functools.lru_cache(maxsize=64)
def _bands(n_outer: int, n_inner: int, causal: bool, window: Optional[int],
           inner_is_k: bool, split_tiles: int, blk_q: int, blk_k: int):
    """Per outer tile its list of splits, and the most splits of any: the
    grid's split extent."""
    rng = _window_k_range if inner_is_k else _window_q_range
    bands = tuple(tuple(_splits(*rng(i, n_inner, causal, window, blk_q,
                                     blk_k), split_tiles))
                  for i in range(n_outer))
    return bands, max((len(b) for b in bands), default=0)


def _stream_bands(sq, sk, causal, window, inner_is_k):
    """The forward's bands (and the fp32 backward kernels'): STREAM_TILE
    rows on both sides, splits of STREAM_SPLIT_TILES."""
    t = STREAM_TILE
    nq, nk = _cdiv(sq, t), _cdiv(sk, t)
    if inner_is_k:
        return _bands(nq, nk, causal, window, True, STREAM_SPLIT_TILES, t, t)
    return _bands(nk, nq, causal, window, False, STREAM_SPLIT_TILES, t, t)


def _bwd_bands(sq, sk, causal, window, inner_is_k):
    """The bf16 backward kernels' bands: outer tiles of BWD_OUTER_TILE rows
    (queries when ``inner_is_k``, else keys), inner tiles of BWD_INNER_TILE
    rows, splits of BWD_SPLIT_TILES inner tiles."""
    o, i = BWD_OUTER_TILE, BWD_INNER_TILE
    if inner_is_k:
        return _bands(_cdiv(sq, o), _cdiv(sk, i), causal, window, True,
                      BWD_SPLIT_TILES, o, i)
    return _bands(_cdiv(sk, o), _cdiv(sq, i), causal, window, False,
                  BWD_SPLIT_TILES, i, o)


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
    """q, k, v, dO as the bf16 backward kernels read them, and their
    head_dim: as they are where TMA takes all four, else each one TMA
    refuses (and all four when d is not a multiple of 8) as a contiguous
    copy with d zero-padded to a multiple of 8. Padded columns add 0 to
    every score and give 0 gradient columns, which the caller slices off."""
    d = ts[0].shape[-1]
    if all(_tma_ok(t) for t in ts):
        return ts, d
    dp = _cdiv(d, 8) * 8
    return [t if dp == d and _tma_ok(t) else _pad_head_dim(t, dp)
            for t in ts], dp


def flash_attention_fwd_stream_reference(q, k, v, *, causal: bool,
                                         scale: Optional[float] = None,
                                         window: Optional[int] = None
                                         ) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Plain streamed forward, the kernel's arithmetic in fp32: per query
    tile, each split of its band gives a partial (unnormalised acc, row max
    m, row sum l), and the lse merge combines them: ``m* = max m_i``,
    ``l* = sum l_i e^(m_i - m*)``, ``o = sum acc_i e^(m_i - m*) / l*``,
    ``lse = m* + log l*``. A row with no visible key gives o = 0 exactly
    and lse = NEG_INF. Returns ``(o, lse)`` as the kernel does."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = (d ** -0.5) if scale is None else float(scale)
    t = STREAM_TILE
    q32, k32, v32 = q.float(), k.float(), v.float()
    o = torch.zeros(b, h, sq, d, device=q.device)
    lse = torch.full((b, h, sq), NEG_INF, device=q.device)
    bands, _ = _stream_bands(sq, sk, causal, window, True)
    for qt, splits in enumerate(bands):
        if not splits:
            continue
        r0, r1 = qt * t, min(sq, (qt + 1) * t)
        parts = []
        for a, e in splits:
            c0, c1 = a * t, min(sk, e * t)
            s = torch.einsum("bhqd,bhkd->bhqk", q32[:, :, r0:r1],
                             k32[:, :, c0:c1]) * scale
            s = _mask_scores(s, causal, window, r0, c0)
            m = s.amax(-1)
            p = torch.where((m <= NEG_INF / 2)[..., None], 0.0,
                            torch.exp(s - m[..., None]))
            parts.append((torch.einsum("bhqk,bhkd->bhqd", p,
                                       v32[:, :, c0:c1]), m, p.sum(-1)))
        m_star = torch.stack([m for _, m, _ in parts]).amax(0)
        acc = torch.zeros_like(o[:, :, r0:r1])
        l_star = torch.zeros_like(m_star)
        for acc_i, m_i, l_i in parts:
            w = torch.exp(m_i - m_star)
            acc += acc_i * w[..., None]
            l_star += l_i * w
        l_safe = torch.where(l_star == 0.0, 1.0, l_star)
        o[:, :, r0:r1] = acc / l_safe[..., None]
        lse[:, :, r0:r1] = m_star + torch.log(l_safe)
    return o.to(q.dtype), lse


def flash_attention_bwd_dq_stream_reference(q, k, v, do, lse, delta, *,
                                            causal: bool, scale: float,
                                            window: Optional[int] = None
                                            ) -> torch.Tensor:
    """Plain streamed dQ: per query tile of BWD_OUTER_TILE rows, each split
    of its band (BWD_INNER_TILE-row key tiles) adds ``scale * dS K`` over
    its keys into an fp32 sum (the kernel's atomics),
    ``dS = P * (dO V^T - delta)``; dQ in q's dtype."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    to, ti = BWD_OUTER_TILE, BWD_INNER_TILE
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    lse, delta = lse.float(), delta.float()
    dq = torch.zeros(b, h, sq, d, device=q.device)
    bands, _ = _bwd_bands(sq, sk, causal, window, True)
    for qt, splits in enumerate(bands):
        r0, r1 = qt * to, min(sq, (qt + 1) * to)
        for a, e in splits:
            c0, c1 = a * ti, min(sk, e * ti)
            s = torch.einsum("bhqd,bhkd->bhqk", q32[:, :, r0:r1],
                             k32[:, :, c0:c1]) * scale
            p = _probs(s, lse[:, :, r0:r1], causal, window, r0, c0)
            dp = torch.einsum("bhqd,bhkd->bhqk", do32[:, :, r0:r1],
                              v32[:, :, c0:c1])
            ds = p * (dp - delta[:, :, r0:r1, None])
            dq[:, :, r0:r1] += scale * torch.einsum(
                "bhqk,bhkd->bhqd", ds, k32[:, :, c0:c1])
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_stream_reference(q, k, v, do, lse, delta, *,
                                             causal: bool, scale: float,
                                             window: Optional[int] = None
                                             ) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Plain streamed dK/dV: per key tile of BWD_OUTER_TILE rows, each split
    of the BWD_INNER_TILE-row query tiles that see it adds
    ``scale * dS^T Q`` and ``P^T dO`` into fp32 sums; ``(dk, dv)`` in k's
    dtype."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    to, ti = BWD_OUTER_TILE, BWD_INNER_TILE
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    lse, delta = lse.float(), delta.float()
    dk = torch.zeros(b, h, sk, d, device=q.device)
    dv = torch.zeros_like(dk)
    bands, _ = _bwd_bands(sq, sk, causal, window, False)
    for kt, splits in enumerate(bands):
        c0, c1 = kt * to, min(sk, (kt + 1) * to)
        for a, e in splits:
            r0, r1 = a * ti, min(sq, e * ti)
            s = torch.einsum("bhqd,bhkd->bhqk", q32[:, :, r0:r1],
                             k32[:, :, c0:c1]) * scale
            p = _probs(s, lse[:, :, r0:r1], causal, window, r0, c0)
            dp = torch.einsum("bhqd,bhkd->bhqk", do32[:, :, r0:r1],
                              v32[:, :, c0:c1])
            ds = p * (dp - delta[:, :, r0:r1, None])
            dv[:, :, c0:c1] += torch.einsum("bhqk,bhqd->bhkd", p,
                                            do32[:, :, r0:r1])
            dk[:, :, c0:c1] += scale * torch.einsum(
                "bhqk,bhqd->bhkd", ds, q32[:, :, r0:r1])
    return dk.to(k.dtype), dv.to(v.dtype)


def _window_arg(window: Optional[int]) -> int:
    return 0 if window is None else int(window)


def flash_attention_fwd_stream(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = False,
                               scale: Optional[float] = None,
                               window: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the streamed forward on CUDA tensors (its split pass, then
    its merge pass): ``(o, lse)`` as :func:`flash_attention_fwd`, with the
    sliding ``window``. Counts its launches in
    ``flash_attention_fwd_stream.launches``."""
    q, k, v, (b, h, sq, sk, d) = _fwd_args(q, k, v,
                                           "flash_attention_fwd_stream")
    scale = (d ** -0.5) if scale is None else float(scale)
    o = torch.empty((b, h, sq, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    if o.numel() == 0:
        return o, lse
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    _, nsplit = _stream_bands(sq, sk, causal, window, True)
    acc = torch.empty((nsplit, b * h, sq, d), device=q.device,
                      dtype=torch.float32)
    ml = torch.empty((2, nsplit, b * h, sq), device=q.device,
                     dtype=torch.float32)
    err = build.load().apex_flash_fwd_stream(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
        ml[0].data_ptr(), ml[1].data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, sq, sk, d, q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), scale, int(causal),
        _window_arg(window), STREAM_SPLIT_TILES, nsplit,
        build.DTYPES[q.dtype], build.current_stream(q.get_device()))
    build.check(err, "apex_flash_fwd_stream")
    flash_attention_fwd_stream.launches += 1
    return o, lse


flash_attention_fwd_stream.launches = 0


def _bwd_stream_launch(q, k, v, do, lse, delta, causal, window, name,
                       inner_is_k):
    """Check the operands of a streamed backward kernel and pick its route:
    bf16 takes the wgmma kernels (BWD_* tiles, operands TMA can read:
    :func:`_tma_operands`), fp32 the FMA kernels (STREAM_* tiles). Returns
    the operands, lse/delta, the head_dim the kernel sees and the launch
    arguments after ``d``, before ``scale``."""
    (q, k, v, do), (lse, delta), _, (b, h, sq, sk, d) = _bwd_args(
        q, k, v, do, lse, delta, name)
    if q.dtype == torch.bfloat16:
        (q, k, v, do), d = _tma_operands([q, k, v, do])
        _, nsplit = _bwd_bands(sq, sk, causal, window, inner_is_k)
        tiles = (BWD_OUTER_TILE, BWD_INNER_TILE, BWD_SPLIT_TILES, nsplit)
    else:
        _, nsplit = _stream_bands(sq, sk, causal, window, inner_is_k)
        tiles = (STREAM_TILE, STREAM_TILE, STREAM_SPLIT_TILES, nsplit)
    strides = [st for t in (q, k, v, do) for st in t.stride()[:3]]
    return (q, k, v, do), (lse, delta), d, strides, tiles


def flash_attention_bwd_dq_stream(q, k, v, do, lse, delta, *, causal: bool,
                                  scale: float,
                                  window: Optional[int] = None
                                  ) -> torch.Tensor:
    """Launch the streamed dQ kernel on CUDA tensors: its CTAs add into a
    zeroed fp32 accumulator, cast to q's dtype after. Counts its launches in
    ``flash_attention_bwd_dq_stream.launches``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    (q, k, v, do), (lse, delta), dk_, strides, tiles = _bwd_stream_launch(
        q, k, v, do, lse, delta, causal, window,
        "flash_attention_bwd_dq_stream", True)
    dq = torch.zeros((b, h, sq, dk_), device=q.device, dtype=torch.float32)
    if dq.numel() == 0:
        return dq[..., :d].to(q.dtype)
    err = build.load().apex_flash_bwd_dq_stream(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq, sk, dk_,
        *strides, float(scale), int(causal), _window_arg(window), *tiles,
        build.DTYPES[q.dtype], build.current_stream(q.get_device()))
    build.check(err, "apex_flash_bwd_dq_stream")
    flash_attention_bwd_dq_stream.launches += 1
    return dq[..., :d].to(q.dtype)


flash_attention_bwd_dq_stream.launches = 0


def flash_attention_bwd_dkv_stream(q, k, v, do, lse, delta, *, causal: bool,
                                   scale: float,
                                   window: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the streamed dK/dV kernel on CUDA tensors: its CTAs add into
    zeroed fp32 accumulators, cast to k's dtype after. Counts its launches
    in ``flash_attention_bwd_dkv_stream.launches``."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    (q, k, v, do), (lse, delta), dk_, strides, tiles = _bwd_stream_launch(
        q, k, v, do, lse, delta, causal, window,
        "flash_attention_bwd_dkv_stream", False)
    dk = torch.zeros((b, h, sk, dk_), device=q.device, dtype=torch.float32)
    dv = torch.zeros_like(dk)
    if dk.numel() == 0 or sq == 0:
        return dk[..., :d].to(k.dtype), dv[..., :d].to(v.dtype)
    err = build.load().apex_flash_bwd_dkv_stream(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
        sq, sk, dk_, *strides, float(scale), int(causal), _window_arg(window),
        *tiles, build.DTYPES[q.dtype], build.current_stream(q.get_device()))
    build.check(err, "apex_flash_bwd_dkv_stream")
    flash_attention_bwd_dkv_stream.launches += 1
    return dk[..., :d].to(k.dtype), dv[..., :d].to(v.dtype)


flash_attention_bwd_dkv_stream.launches = 0


def _forward(q, k, v, causal, scale, stream, window):
    """``(o, lse)``: the kernel on a CUDA tensor, its plain version on a
    CPU one."""
    if stream:
        fn = (flash_attention_fwd_stream if q.device.type == "cuda"
              else flash_attention_fwd_stream_reference)
        return fn(q, k, v, causal=causal, scale=scale, window=window)
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    return (mha_reference(q, k, v, causal=causal, scale=scale),
            _lse_reference(q, k, causal, scale))


class FlashAttention(torch.autograd.Function):
    """Causal or non-causal attention without bias/segment masks, resident
    or streamed (with the window), with the two-pass flash backward
    (``_flash_vjp_fwd`` / ``_flash_vjp_bwd``): a streamed forward is
    followed by the streamed backward. Kernels on CUDA tensors, plain
    versions on CPU ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, stream, window):
        o, lse = _forward(q, k, v, causal, scale, stream, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.stream, ctx.window = stream, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        cuda = q.device.type == "cuda"
        if not ctx.stream and not cuda:
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                       **kw)
            return dq, dk, dv, None, None, None, None
        delta = (o.float() * do.float()).sum(-1)
        if ctx.stream:
            kw["window"] = ctx.window
            dq_fn, dkv_fn = ((flash_attention_bwd_dq_stream,
                              flash_attention_bwd_dkv_stream) if cuda else
                             (flash_attention_bwd_dq_stream_reference,
                              flash_attention_bwd_dkv_stream_reference))
        else:
            dq_fn, dkv_fn = flash_attention_bwd_dq, flash_attention_bwd_dkv
        dq = dq_fn(q, k, v, do, lse, delta, **kw)
        dk, dv = dkv_fn(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None


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


def _card_refusal(bias, segment_ids, stream: bool) -> str:
    """What the card does not take yet, and the ROADMAP item that brings
    it: a bias or segment ids on the resident kernels and the window there
    (Queue 2 item 4), segment ids on the streamed kernels (item 5)."""
    if bias is not None:
        what, item = "a dense bias", 4
    elif segment_ids is not None:
        what, item = ("segment_ids on the streamed kernels", 5) if stream \
            else ("segment_ids on the resident kernels", 4)
    else:
        what, item = "the window on the resident kernels (stream='never')", 4
    return (f"flash_attention on CUDA does not take {what} yet: a later "
            f"slice of the port (ROADMAP Queue 2 item {item})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    segment_ids: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    pad_id: Optional[int] = None, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    stream: str = "auto") -> torch.Tensor:
    """Fused multi-head attention on ``(batch, heads, seq, head_dim)``.

    Same arguments and semantics as the reference's ``flash_attention``
    (minus its TPU tiling knobs): ``causal`` is the top-left-aligned
    upper-triangular mask, ``window`` the sliding window, ``bias`` an
    additive bias broadcastable to ``(b, h, sq, sk)``, ``segment_ids`` the
    packed-varlen equality mask, ``stream`` 'auto' | 'never' | 'always'
    (:func:`use_stream`). Without bias or segment ids both devices go
    through :class:`FlashAttention` (kernels on the card, plain versions on
    the CPU), streamed or resident; the window needs the streamed path.
    CUDA tensors with what the kernels do not take yet raise
    ``NotImplementedError``; CPU tensors take :func:`mha_reference` and its
    own autograd.
    """
    sq, sk = q.shape[2], k.shape[2]
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be a positive int, got {window}")
        if window >= max(sq, sk):
            window = None  # the band covers everything: dense attention
    on = check_device(q, "q")
    do_stream = use_stream(stream, sq, sk, window, bias is not None)
    plain = (bias is not None or segment_ids is not None
             or (window is not None and not do_stream))
    if plain:
        if on == "cpu":
            return mha_reference(q, k, v, bias, causal=causal, scale=scale,
                                 segment_ids=segment_ids, pad_id=pad_id,
                                 window=window)
        raise NotImplementedError(_card_refusal(bias, segment_ids,
                                                do_stream))
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale, do_stream,
                                    window)
    if on == "cpu" and not do_stream:
        return mha_reference(q, k, v, causal=causal, scale=scale)
    return _forward(q, k, v, causal, scale, do_stream, window)[0]
