"""Vocab-parallel cross entropy (port of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``; reference:
apex/transformer/tensor_parallel/cross_entropy.py:23-103).

Each tensor-parallel rank holds a vocab shard of the logits; the loss needs
the reference's three reductions over the axis: the global max for
stability (a ``pmax``, a constant in the backward), the target logit
(masked on the owning shard, then a ``psum``) and the sum of exp (a
``psum``), plus, with label smoothing, the ``psum`` of the logits. The sums
go out as one ``psum`` of their tree. The forward and the closed-form local
backward are the reference's (``cross_entropy.py:29-108``): an fp32
per-token loss ``lse - x[target]`` (with label smoothing ``(1 - e) loss +
e (lse - mean(x))``), and ``dlogits = (softmax - (1 - e) onehot - e / V) *
g`` on the local shard in the logits' dtype, with the fp32 softmax saved
instead of the logits. With ``axis=None`` the whole vocab lies on one
device and the reductions are local. It is plain PyTorch, as the
reference's is plain XLA: no Pallas kernel stands behind it.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.parallel import collectives as _coll
from apex_tpu_torch.transformer.tensor_parallel.mappings import axis_world


class _VocabCrossEntropy(torch.autograd.Function):
    """The reference's custom VJP (``_ce_fwd`` / ``_ce_bwd``)."""

    @staticmethod
    def forward(ctx, logits, target, axis, label_smoothing):
        per = logits.shape[-1]
        rank, n = axis_world(axis) if axis is not None else (0, 1)
        vocab = per * n
        m = logits.amax(-1).float()
        if axis is not None:
            m = _coll.pmax(m, axis)
        # the stability max, a constant; fp32 (the subtraction promotes)
        x = logits - m[..., None]
        e = torch.exp(x)
        local = target.long() - rank * per
        in_range = (local >= 0) & (local < per)
        safe = torch.where(in_range, local, torch.zeros_like(local))
        target_logit = torch.gather(x, -1, safe[..., None])[..., 0]
        sums = [e.sum(-1), target_logit.masked_fill(~in_range, 0.0)]
        if label_smoothing > 0.0:
            sums.append(x.sum(-1))
        if axis is not None:
            sums = _coll.psum(sums, axis)
        del x
        lse = torch.log(sums[0])
        loss = lse - sums[1]
        if label_smoothing > 0.0:
            mean_log_prob = sums[2] / vocab - lse
            loss = (1.0 - label_smoothing) * loss \
                + label_smoothing * (-mean_log_prob)
        ctx.save_for_backward(e.div_(sums[0][..., None]), safe, in_range)
        ctx.eps, ctx.vocab, ctx.dtype = label_smoothing, vocab, logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, safe, in_range = ctx.saved_tensors
        eps = ctx.eps
        grad = softmax.clone()
        grad.scatter_add_(-1, safe[..., None],
                          -(1.0 - eps) * in_range[..., None].to(grad.dtype))
        if eps > 0.0:
            grad -= eps / ctx.vocab
        return (grad * g[..., None]).to(ctx.dtype), None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                                 axis: Optional[str] = None,
                                 label_smoothing: float = 0.0
                                 ) -> torch.Tensor:
    """Per-token cross entropy over ``(..., vocab_local)`` logits: this
    rank's vocab shard along ``axis`` (the whole vocab when ``axis`` is
    None). ``target`` holds GLOBAL int token ids. Returns ``(...)`` fp32
    losses, not reduced (``cross_entropy.py:70-72``), the same on every rank
    of the axis."""
    return _VocabCrossEntropy.apply(logits, target, axis,
                                    float(label_smoothing))
