"""Vocab-parallel cross entropy, serial half (port of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``).

With ``axis=None`` the whole vocab lies on one device, and the reference's
three collectives (the global max, the target logit, the sum of exp) reduce
to their local forms. The forward and the closed-form backward are the
reference's (``cross_entropy.py:29-108``): an fp32 per-token loss
``lse - x[target]`` (with label smoothing ``(1 - e) loss + e (lse -
mean(x))``), and ``dlogits = (softmax - (1 - e) onehot - e / V) * g`` in
the logits' dtype, with the fp32 softmax saved instead of the logits. It is
plain PyTorch: the reference's is plain XLA, not a Pallas kernel. A
non-None ``axis`` raises (tensor parallelism is ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Optional

import torch

_TP_LATER = ("vocab_parallel_cross_entropy(axis={axis!r}): the vocab-sharded "
             "form is tensor parallelism, a later slice of the port (ROADMAP "
             "Queue 1 item 10); pass axis=None")


class _VocabCrossEntropy(torch.autograd.Function):
    """The reference's custom VJP (``_ce_fwd`` / ``_ce_bwd``), serial."""

    @staticmethod
    def forward(ctx, logits, target, label_smoothing):
        x = logits.float()
        vocab = x.shape[-1]
        x = x - x.amax(-1, keepdim=True)  # the stability max, a constant
        e = torch.exp(x)
        sum_exp = e.sum(-1)
        lse = torch.log(sum_exp)
        target = target.long()
        loss = lse - torch.gather(x, -1, target[..., None])[..., 0]
        if label_smoothing > 0.0:
            mean_log_prob = x.sum(-1) / vocab - lse
            loss = (1.0 - label_smoothing) * loss \
                + label_smoothing * (-mean_log_prob)
        ctx.save_for_backward(e / sum_exp[..., None], target)
        ctx.eps, ctx.dtype = label_smoothing, logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, target = ctx.saved_tensors
        eps = ctx.eps
        grad = softmax.clone()
        grad.scatter_add_(-1, target[..., None],
                          torch.full_like(grad[..., :1], -(1.0 - eps)))
        if eps > 0.0:
            grad -= eps / softmax.shape[-1]
        return (grad * g[..., None]).to(ctx.dtype), None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                                 axis: Optional[str] = None,
                                 label_smoothing: float = 0.0
                                 ) -> torch.Tensor:
    """Per-token cross entropy over ``(..., vocab)`` logits: ``(...)`` fp32
    losses, not reduced (the reference returns per-token loss too,
    ``cross_entropy.py:70-72``). ``target`` holds int token ids."""
    if axis is not None:
        raise NotImplementedError(_TP_LATER.format(axis=axis))
    return _VocabCrossEntropy.apply(logits, target, float(label_smoothing))
