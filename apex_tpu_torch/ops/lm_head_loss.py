"""Chunked LM-head cross-entropy (port of ``apex_tpu/ops/lm_head_loss.py``).

``loss = xent(h @ W^T, targets)`` per token without materializing the
``(tokens, vocab)`` logits: the forward runs an online logsumexp (running
max and sum) over vocab chunks and picks each target's logit from its
chunk; the backward recomputes each chunk's logits and accumulates

    dh   = sum_c (g * p_c) @ W_c  -  g * W[targets]
    dW_c = (g * p_c)^T @ h        -  index_add(targets in c, g * h)

as ``lm_head_loss.py:42-128`` does. Peak logits memory is
``tokens x vocab / num_chunks``. The reference is plain XLA code, so this
is plain torch code. Every chunk product takes its operands in the input
dtype and gives an fp32 result, as the reference's
``preferred_element_type=jnp.float32`` does: the logits, dh and dW chunk
products are never rounded to bf16. Only ``g * p`` is, as the reference's
``gp`` is. The logsumexp arithmetic is fp32.
"""

from __future__ import annotations

import torch


def _chunked(wte: torch.Tensor, num_chunks: int) -> torch.Tensor:
    V, H = wte.shape
    if V % num_chunks:
        raise ValueError(f"vocab {V} not divisible by num_chunks {num_chunks}")
    return wte.reshape(num_chunks, V // num_chunks, H)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, one dtype) with an fp32 result. On the card a bf16
    product writes its fp32 accumulators out as they are (``out_dtype``).
    The CPU has no such product, so there the operands go up to fp32 first:
    a product of two bf16 values is exact in fp32, so this is the same sum."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunk_logits(h2d, w):
    return _mm32(h2d, w.to(h2d.dtype).t())


class LMHeadCrossEntropy(torch.autograd.Function):
    """``jax.custom_vjp`` of ``lm_head_cross_entropy`` as a Function."""

    @staticmethod
    def forward(ctx, h, wte, targets, num_chunks):
        wte_c = _chunked(wte, num_chunks)
        C, Vc, _ = wte_c.shape
        h2d = h.reshape(-1, h.shape[-1])
        t = targets.reshape(-1).long()
        n = h2d.shape[0]
        m = torch.full((n,), -float("inf"), device=h.device)
        s = torch.zeros(n, device=h.device)
        tlogit = torch.zeros(n, device=h.device)
        for c in range(C):
            logits = _chunk_logits(h2d, wte_c[c])
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(-1)
            m = m_new
            local = t - c * Vc
            in_chunk = (local >= 0) & (local < Vc)
            picked = logits.gather(1, local.clamp(0, Vc - 1)[:, None])[:, 0]
            tlogit = torch.where(in_chunk, picked, tlogit)
        lse = m + torch.log(s)
        ctx.save_for_backward(h, wte, t, lse)
        ctx.num_chunks = num_chunks
        return (lse - tlogit).reshape(targets.shape)

    @staticmethod
    def backward(ctx, g):
        h, wte, t, lse = ctx.saved_tensors
        wte_c = _chunked(wte, ctx.num_chunks)
        C, Vc, H = wte_c.shape
        h2d = h.reshape(-1, H)
        g32 = g.reshape(-1).float()
        gh = h2d.float() * g32[:, None]  # (N, H)
        dh = -wte[t].float() * g32[:, None]
        dwte = torch.empty((C * Vc, H), device=wte.device, dtype=torch.float32)
        for c in range(C):
            wt = wte_c[c].to(h2d.dtype)
            p = torch.exp(_chunk_logits(h2d, wt) - lse[:, None])
            gp = (p * g32[:, None]).to(h2d.dtype)
            dh += _mm32(gp, wt)
            dw = _mm32(gp.t(), h2d)  # (Vc, H)
            # subtract the one-hot target rows that live in this chunk
            local = t - c * Vc
            in_chunk = (local >= 0) & (local < Vc)
            dw.index_add_(0, local[in_chunk], -gh[in_chunk])
            dwte[c * Vc:(c + 1) * Vc] = dw
        return (dh.reshape(h.shape).to(h.dtype), dwte.to(wte.dtype), None,
                None)


def lm_head_cross_entropy(h: torch.Tensor, wte: torch.Tensor,
                          targets: torch.Tensor,
                          num_chunks: int = 8) -> torch.Tensor:
    """Per-token ``xent(h @ wte^T, targets)`` (fp32, shape of ``targets``)
    without materializing the logits. ``h`` is ``(..., H)``, ``wte`` the
    ``(V, H)`` tied embedding, ``targets`` int ids; ``V % num_chunks``
    must be 0."""
    _chunked(wte, num_chunks)  # raise before any work on a bad split
    return LMHeadCrossEntropy.apply(h, wte, targets, int(num_chunks))


def lm_head_cross_entropy_reference(h, wte, targets):
    """Materialized ground truth (fp32 logits)."""
    logits = h.float() @ wte.float().t()
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, targets.long()[..., None])[..., 0]
    return lse - tl
