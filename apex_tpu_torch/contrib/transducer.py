"""RNN-T transducer joint and loss (port of
``apex_tpu/contrib/transducer.py``, the counterpart of apex's
``apex.contrib.transducer``).

- :func:`transducer_joint`: the broadcast add of the encoder (f) and
  predictor (g) streams into the ``(B, T, U, H)`` joint lattice, with the
  optional ReLU and dropout (``TransducerJoint``).
- :func:`transducer_loss`: the RNN-T negative log likelihood by the forward
  algorithm in log space (``TransducerLoss``). Each cell takes the
  reference's two terms (``transducer.py:48-123``)::

      alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                              alpha[t, u-1] + emit[t, u-1])

  with ``alpha[0, 0] = 0``, the t = 0 row seeded from ``-1e30`` (not
  -inf, so gradients through unreachable cells stay finite) and the u = 0
  column from the first term alone. The reference scans rows and, inside a
  row, the columns: T * U sequential steps, which on the card would be a
  launch or more a cell. Every cell of an anti-diagonal ``t + u = d``
  depends only on the diagonal before it, so the port walks the T + U
  diagonals, each one vectorized ``logaddexp`` over the batch and the
  diagonal. The loss is ``-(alpha[f_len-1, y_len] + blank[f_len-1,
  y_len])`` with ``t_last = max(f_len - 1, 0)``. Gradients come from
  autograd through the walk, as the reference's come from AD through its
  scans.
- :func:`transducer_loss_reference`: the float64 numpy DP of the
  reference's tests.

Plain PyTorch, as the reference is plain XLA: no kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex_tpu_torch.utils.nn import inverted_dropout

#: the log-probability of an unreachable cell (``neg_inf``)
NEG_INF = -1e30


def transducer_joint(f: torch.Tensor, g: torch.Tensor, *, relu: bool = False,
                     generator: Optional[torch.Generator] = None,
                     dropout: float = 0.0) -> torch.Tensor:
    """``(B, T, H) + (B, U, H) -> (B, T, U, H)`` (``TransducerJoint``):
    ``f + g`` broadcast, then the optional ReLU and inverted dropout drawn
    from ``generator`` (none without one)."""
    out = f[:, :, None, :] + g[:, None, :, :]
    if relu:
        out = torch.relu(out)
    return inverted_dropout(out, dropout, generator)


def _diagonals(x: torch.Tensor, t_shift: int, u_shift: int) -> torch.Tensor:
    """``(B, D, T)`` with ``out[:, d, t] = x[:, t - t_shift, d - t -
    u_shift]`` where that index lies in ``x`` (``(B, T', U')``), else
    :data:`NEG_INF`: the lattice read along its anti-diagonals."""
    b, tx, ux = x.shape
    steps = tx + ux + t_shift + u_shift
    t = torch.arange(tx + t_shift, device=x.device)
    d = torch.arange(steps, device=x.device)
    ti = t - t_shift
    ui = d[:, None] - t[None, :] - u_shift
    ok = (ti >= 0)[None, :] & (ui >= 0) & (ui < ux)
    if x.numel() == 0:  # no labels (U = 0): no emit term anywhere
        return x.new_full((b, *ok.shape), NEG_INF)
    flat = ti.clamp(0, tx - 1)[None, :] * ux + ui.clamp(0, ux - 1)
    got = x.reshape(b, -1)[:, flat.reshape(-1)].reshape(b, *flat.shape)
    return got.masked_fill(~ok, NEG_INF)


def transducer_loss(log_probs: torch.Tensor, targets: torch.Tensor,
                    f_len: torch.Tensor, y_len: torch.Tensor,
                    blank_idx: int = 0) -> torch.Tensor:
    """Per-sequence RNN-T negative log likelihood, ``(B,)`` fp32.

    Args:
      log_probs: ``(B, T, U+1, V)`` log-softmax over the vocabulary at each
        lattice node (any float dtype; computed in fp32).
      targets: ``(B, U)`` label ids.
      f_len: ``(B,)`` valid encoder lengths (<= T).
      y_len: ``(B,)`` valid target lengths (<= U).
      blank_idx: the blank id.
    """
    b, t_max, u1, _ = log_probs.shape
    u_max = u1 - 1
    dev = log_probs.device
    lp = log_probs.float()
    blank = lp[..., blank_idx]                                # (B, T, U+1)
    emit = lp[:, :, :u_max, :].gather(
        -1, targets[:, None, :, None].expand(b, t_max, u_max, 1).long()
    )[..., 0]                                                 # (B, T, U)
    # blank[t-1, u] and emit[t, u-1] of cell (t, u = d - t), by diagonal
    blank_in = _diagonals(blank, 1, 0)[:, :, :t_max]
    emit_in = _diagonals(emit, 0, 1)
    t_idx = torch.arange(t_max, device=dev)
    seed_row = torch.full((b, 1), NEG_INF, device=dev)
    diags = []
    prev = None
    for d in range(t_max + u_max):
        u = d - t_idx
        if prev is None:
            below = torch.zeros(b, t_max, device=dev)  # alpha[0, 0] = 0
        else:
            # alpha[t-1, u] on the diagonal before, one t lower; the t = 0
            # row has no cell below it: -1e30 seeds it (0 only at (0, 0))
            below = torch.cat([seed_row, prev[:, :-1] + blank_in[:, d, 1:]],
                              dim=1)
            left = prev + emit_in[:, d]                  # alpha[t, u-1]
            below = torch.where(u == 0, below,
                                torch.logaddexp(below, left))
        cur = below.masked_fill(~((u >= 0) & (u <= u_max)), NEG_INF)
        diags.append(cur)
        prev = cur
    alphas = torch.stack(diags, dim=1)                        # (B, D, T)
    t_last = (f_len.long() - 1).clamp_min(0)
    yl = y_len.long()
    rows = torch.arange(b, device=dev)
    a_final = alphas[rows, t_last + yl, t_last]
    b_final = blank[rows, t_last, yl]
    return -(a_final + b_final)


def transducer_loss_reference(log_probs, targets, f_len, y_len,
                              blank_idx: int = 0) -> np.ndarray:
    """The O(T * U) float64 DP ground truth of the reference's tests
    (``transducer_loss_reference``), on arrays or CPU tensors."""
    as_np = (lambda a: a.detach().cpu().numpy()
             if isinstance(a, torch.Tensor) else np.asarray(a))
    lp = as_np(log_probs).astype(np.float64)
    targets, f_len, y_len = as_np(targets), as_np(f_len), as_np(y_len)
    n = lp.shape[0]
    out = np.zeros((n,))
    for b in range(n):
        tb, ub = int(f_len[b]), int(y_len[b])
        alpha = np.full((tb, ub + 1), -np.inf)
        alpha[0, 0] = 0.0
        for t in range(tb):
            for u in range(ub + 1):
                cands = []
                if t > 0:
                    cands.append(alpha[t - 1, u] + lp[b, t - 1, u, blank_idx])
                if u > 0:
                    cands.append(alpha[t, u - 1]
                                 + lp[b, t, u - 1, targets[b, u - 1]])
                if cands:
                    alpha[t, u] = np.logaddexp.reduce(cands)
        out[b] = -(alpha[tb - 1, ub] + lp[b, tb - 1, ub, blank_idx])
    return out
