"""Ring and Ulysses context parallelism (port of
``apex_tpu/transformer/ring.py``).

The sequence is sharded over the ``context`` axis of the installed mesh
(``parallel.mesh.initialize_model_parallel(context_parallel_size=N)``):
each rank holds ``(batch, heads, s / N, head_dim)`` of q, k and v, and gets
back its shard of the attention output. Two schemes on the port's flash
kernels (``apex_tpu_torch.ops.flash_attention``):

- :func:`ring_attention`: K/V rotate one hop around the ring each step
  (``collectives.ppermute_shift``), and each step runs the flash forward of
  the local queries against the K/V shard now resident, at that step's
  global offsets (:func:`_step_offsets`): the kernels take the causal and
  window masks at ``shift = q_off - k_off``, so masking is exact across
  shards. The partial results merge through their log-sum-exps
  (:func:`_combine`). :class:`_Ring` is the reference's custom VJP
  ``_ring`` (``ring.py:142-167``): its backward is a second ring in which
  dQ sums locally against the GLOBAL lse and ``delta = rowsum(dO * O)``,
  and the dK/dV sums travel the ring with their K/V shard, shifted after
  every step so that after N shifts each shard and its gradient are home.
  The offsets are host integers here, so a step in which no query sees any
  key (under the causal mask, every K/V shard from a later rank; with a
  window, shards wholly outside it) is skipped: it would add o = 0 at lse
  = -1e30, which the merge leaves exactly as it was, and zero gradients.
  Every rank still runs every shift of the ring.
- :func:`ulysses_attention`: an all-to-all reshards seq-sharded heads into
  head-sharded whole sequences, ``flash_attention`` runs on those, and the
  inverse all-to-all brings the output back (``tensor_parallel.mappings.
  all_to_all``, whose backward is the inverse all-to-all).

Segment ids (``(q_seg, kv_seg)``, each rank's ``(b, s / N)`` slices) ride
the ring with their K/V shard, mask only (``contiguous_segments=False``:
padding ids are not the packed layout), or are all-gathered for Ulysses.
The stream decision is made per shard with the port's own ``use_stream``
on the local shapes; a window that covers the GLOBAL sequence
(``window >= max(sq, sk) * N``) is dropped, as the reference decides at
``ring.py:270-274`` (``flash_attention``'s own check sees only local
lengths, so the ring calls below it). The reference's TPU tiling knobs
(``block_q`` / ``block_k``) and its ``impl`` switch are not carried over:
CUDA tensors launch the kernels, CPU tensors take their plain versions.
:func:`ring_attention_reference` is the plain ring (``_partial_attn_xla``
/ ``_ring_xla``, ``ring.py:176-216``): dense attention a step, plain
autograd through the rotation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch._device import check_device
from apex_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _as_seg,
    _backward,
    _dense_pos_masks,
    _forward,
    flash_attention,
    use_stream,
)
from apex_tpu_torch.parallel import collectives
from apex_tpu_torch.parallel.mesh import AXIS_CONTEXT
from apex_tpu_torch.transformer.tensor_parallel import mappings


def _combine(o, lse, o_s, lse_s):
    """Merge two partial softmax results through their logsumexps (fp32;
    lse ``(b, h, s)``)."""
    lse_new = torch.logaddexp(lse, lse_s)
    o_new = (o * torch.exp(lse - lse_new)[..., None]
             + o_s * torch.exp(lse_s - lse_new)[..., None])
    return o_new, lse_new


def _step_offsets(rank: int, step: int, n: int, sq: int,
                  sk: int) -> Tuple[int, int]:
    """Global position offsets ``(q_off, k_off)`` at ring step ``step``:
    after ``step`` shifts this rank holds the K/V shard of ``rank - step``."""
    return rank * sq, ((rank - step) % n) * sk


def _step_visible(shift: int, sq: int, sk: int, causal: bool,
                  window: Optional[int]) -> bool:
    """Whether any query of a step sees any key: some ``q - k`` in
    ``[shift - sk + 1, shift + sq - 1]`` passes the causal test (``>= 0``)
    and the window's (``< window``, and ``> -window`` without causal)."""
    lo, hi = shift - sk + 1, shift + sq - 1
    if causal:
        lo = max(lo, 0)
    if window is not None:
        hi = min(hi, window - 1)
        if not causal:
            lo = max(lo, 1 - window)
    return lo <= hi


def _global_window(window: Optional[int], sq: int, sk: int,
                   n: int) -> Optional[int]:
    """The window as the ring takes it: a positive int, or None where it
    covers the global sequence of ``n`` shards (``ring.py:264-274``)."""
    if window is None:
        return None
    window = int(window)
    if window < 1:
        raise ValueError(f"window must be a positive int, got {window}")
    return None if window >= max(sq, sk) * n else window


def _seg_of(q_seg, kv_seg, pad_id, q, k):
    if q_seg is None:
        return None
    return _as_seg((q_seg, kv_seg), pad_id, False, q, k)


class _Ring(torch.autograd.Function):
    """The ring over ``axis``: the forward ring, then the backward ring
    (the reference's ``_ring_fwd`` / ``_ring_bwd``, ``ring.py:83-139``)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, axis, causal, scale, pad_id,
                stream, window):
        n = collectives.axis_size(axis)
        rank = collectives.axis_rank(axis)
        sq, sk = q.shape[2], k.shape[2]
        o = torch.zeros(q.shape, device=q.device, dtype=torch.float32)
        lse = torch.full(q.shape[:3], NEG_INF, device=q.device,
                         dtype=torch.float32)
        kv = (k, v) if q_seg is None else (k, v, kv_seg)
        need_offs = causal or window is not None
        for s in range(n):
            q_off, k_off = _step_offsets(rank, s, n, sq, sk)
            shift = q_off - k_off if need_offs else 0
            if _step_visible(shift, sq, sk, causal, window):
                seg = _seg_of(q_seg, kv[2] if q_seg is not None else None,
                              pad_id, q, kv[0])
                o_s, lse_s = _forward(q, kv[0], kv[1], causal, scale,
                                         stream, window, None, seg, shift)
                o, lse = _combine(o, lse, o_s.float(), lse_s)
            if s != n - 1:
                kv = collectives.ppermute_shift(kv, axis, 1)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
        ctx.axis, ctx.causal, ctx.scale = axis, causal, scale
        ctx.pad_id, ctx.stream, ctx.window = pad_id, stream, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, o, lse = ctx.saved_tensors
        axis, causal, window = ctx.axis, ctx.causal, ctx.window
        n = collectives.axis_size(axis)
        rank = collectives.axis_rank(axis)
        sq, sk = q.shape[2], k.shape[2]
        delta = (o.float() * do.float()).sum(-1)
        dq = torch.zeros(q.shape, device=q.device, dtype=torch.float32)
        ring = (k, v, torch.zeros(k.shape, device=k.device,
                                  dtype=torch.float32),
                torch.zeros(v.shape, device=v.device, dtype=torch.float32))
        if q_seg is not None:
            ring = ring + (kv_seg,)
        need_offs = causal or window is not None
        for s in range(n):
            k_s, v_s, dk_acc, dv_acc = ring[:4]
            q_off, k_off = _step_offsets(rank, s, n, sq, sk)
            shift = q_off - k_off if need_offs else 0
            if _step_visible(shift, sq, sk, causal, window):
                seg = _seg_of(q_seg, ring[4] if q_seg is not None else None,
                              ctx.pad_id, q, k_s)
                dq_s, dk_s, dv_s, _ = _backward(
                    q, k_s, v_s, o, lse, do, causal, ctx.scale, ctx.stream,
                    window, seg=seg, shift=shift, delta=delta)
                dq = dq + dq_s.float()
                ring = (k_s, v_s, dk_acc + dk_s.float(),
                        dv_acc + dv_s.float()) + ring[4:]
            # after every step, the last included: after n shifts each K/V
            # shard, and the dK/dV summed along its way, is home
            ring = collectives.ppermute_shift(ring, axis, 1)
        dk, dv = ring[2], ring[3]
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                *(None,) * 8)


def _ids(segment_ids):
    if segment_ids is None:
        return None, None
    return tuple(s.to(torch.int32).contiguous() for s in segment_ids)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis: str = AXIS_CONTEXT, causal: bool = False,
                   scale: Optional[float] = None, segment_ids=None,
                   pad_id: Optional[int] = None,
                   window: Optional[int] = None) -> torch.Tensor:
    """Exact attention over a sequence sharded on ``axis``.

    q/k/v are this rank's ``(batch, heads, local_seq, head_dim)`` shards,
    rank r holding global positions ``[r * local_seq, (r + 1) *
    local_seq)``; returns this rank's shard of the output, in q's dtype.
    Causal masking and the sliding ``window`` are exact across shards
    (global positions). ``segment_ids``: optional ``(q_seg, kv_seg)``
    LOCAL ``(b, local_seq)`` shards; the kv ids rotate with their K/V
    shard, so a token attends only equal-id keys anywhere in the global
    sequence, never ``pad_id`` keys (BERT's padding under context
    parallelism with no bias). Steps in which no query sees any key are
    skipped (module docstring). Differentiable in q, k, v through the
    backward ring."""
    check_device(q, "q")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    n = collectives.axis_size(axis)
    scale = (d ** -0.5) if scale is None else float(scale)
    window = _global_window(window, sq, sk, n)
    q_seg, kv_seg = _ids(segment_ids)
    pad_id = None if pad_id is None else int(pad_id)
    stream = use_stream("auto", sq, sk, window, False)
    return _Ring.apply(q, k, v, q_seg, kv_seg, axis, bool(causal), scale,
                       pad_id, stream, window)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis: str = AXIS_CONTEXT, causal: bool = False,
                      scale: Optional[float] = None, segment_ids=None,
                      pad_id: Optional[int] = None,
                      window: Optional[int] = None) -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): ``(b, h, s/n,
    d)`` -> ``(b, h/n, s, d)`` over ``axis``, ``flash_attention`` on the
    assembled sequence, then the inverse reshard. Needs ``heads % n ==
    0`` (``ValueError`` otherwise). ``segment_ids``: local shards as
    :func:`ring_attention` takes them, all-gathered into the global ids."""
    n = collectives.axis_size(axis)
    if q.shape[1] % n != 0:
        raise ValueError(
            f"ulysses_attention needs heads ({q.shape[1]}) divisible by the "
            f"'{axis}' axis size ({n})")
    qg, kg, vg = (mappings.all_to_all(x, axis, split_axis=1, concat_axis=2)
                  for x in (q, k, v))
    seg_g = None
    if segment_ids is not None:
        seg_g = tuple(collectives.all_gather(s.to(torch.int32), axis,
                                             gather_axis=1)
                      for s in segment_ids)
    o = flash_attention(qg, kg, vg, causal=causal, scale=scale,
                           segment_ids=seg_g, pad_id=pad_id, window=window)
    return mappings.all_to_all(o, axis, split_axis=2, concat_axis=1)


# ---------------------------------------------------------------------------
# the plain ring: dense attention a step, plain autograd through the rotation
# ---------------------------------------------------------------------------


def _partial_attn_plain(q, k, v, q_off, k_off, causal, scale, q_seg=None,
                        kv_seg=None, pad_id=None, window=None):
    """One shard pair's partial attention, ``(o normalised, lse)`` in fp32
    (``_partial_attn_xla``, ``ring.py:176-198``): a row that sees no key
    gives o = 0 and lse = NEG_INF."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if q_seg is not None:
        valid = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        if pad_id is not None:
            valid = valid & (kv_seg != pad_id)[:, None, None, :]
        s = torch.where(valid, s, NEG_INF)
    if causal or window is not None:
        s = _dense_pos_masks(
            s, q_off + torch.arange(q.shape[2], device=q.device)[:, None],
            k_off + torch.arange(k.shape[2], device=q.device)[None, :],
            causal, window)
    m = s.amax(-1, keepdim=True)
    p = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    l_safe = torch.where(l == 0.0, 1.0, l)
    return o / l_safe, (m + torch.log(l_safe))[..., 0]


def ring_attention_reference(q, k, v, *, axis: str = AXIS_CONTEXT,
                             causal: bool = False,
                             scale: Optional[float] = None,
                             segment_ids=None, pad_id: Optional[int] = None,
                             window: Optional[int] = None) -> torch.Tensor:
    """The plain version of :func:`ring_attention` (``_ring_xla``,
    ``ring.py:201-216``): every step's dense partial at its offsets, the
    lse merge, K/V (and kv ids) rotated by ``mappings.ring_shift``, whose
    backward shifts back; differentiable by plain autograd. Any device."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    n = collectives.axis_size(axis)
    rank = collectives.axis_rank(axis)
    scale = (d ** -0.5) if scale is None else float(scale)
    window = _global_window(window, sq, sk, n)
    q_seg, kv_seg = _ids(segment_ids)
    o = torch.zeros(q.shape, device=q.device, dtype=torch.float32)
    lse = torch.full(q.shape[:3], NEG_INF, device=q.device,
                     dtype=torch.float32)
    ks, vs, ids = k, v, kv_seg
    for s in range(n):
        q_off, k_off = _step_offsets(rank, s, n, sq, sk)
        o_s, lse_s = _partial_attn_plain(q, ks, vs, q_off, k_off, causal,
                                         scale, q_seg, ids, pad_id, window)
        o, lse = _combine(o, lse, o_s, lse_s)
        if s != n - 1:
            ks, vs = mappings.ring_shift(ks, axis), mappings.ring_shift(
                vs, axis)
            if ids is not None:
                ids = collectives.ppermute_shift(ids, axis, 1)
    return o.to(q.dtype)


__all__ = ["ring_attention", "ring_attention_reference",
           "ulysses_attention"]
