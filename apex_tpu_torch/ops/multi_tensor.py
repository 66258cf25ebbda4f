"""Multi-tensor ops over lists of tensors (port of
``apex_tpu/ops/multi_tensor.py``).

The reference expresses apex's ``multi_tensor_apply`` kernels
(``amp_C.multi_tensor_scale``/``axpby``/``l2norm``) as pytree maps that XLA
fuses. Here a "tree" is a list of tensors and the maps are PyTorch's
``torch._foreach_*`` ops, which batch a list into few launches on the card.
Overflow flags are 0-d bool tensors on the tensors' device, so computing
one does not wait for the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def _float(ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [t for t in ts if t.is_floating_point()]


def tree_nonfinite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-d bool: any inf or NaN in any floating tensor of the list (the
    ``found_inf`` signal of the reference). The max-abs norm of a tensor is
    inf or NaN exactly when one of its values is, and never overflows."""
    ts = _float(tensors)
    if not ts:
        return torch.tensor(False)
    norms = torch._foreach_norm(ts, float("inf"))
    return torch.logical_not(torch.isfinite(torch.stack(
        [n.float() for n in norms])).all())


def tree_scale(tensors: Sequence[torch.Tensor], scale: float,
               out_dtype: Optional[torch.dtype] = None
               ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``out = in * scale`` (fp32 arithmetic) in ``out_dtype`` or each
    input's dtype, plus the non-finite flag of the INPUT (an overflow is
    seen even where scaling would map it to 0)."""
    found_inf = tree_nonfinite(tensors)
    out = list(tensors)
    idx = [i for i, t in enumerate(tensors) if t.is_floating_point()]
    if idx:
        scaled = torch._foreach_mul([tensors[i].float() for i in idx],
                                    float(scale))
        for i, s in zip(idx, scaled):
            out[i] = s.to(out_dtype or tensors[i].dtype)
    return out, found_inf


def tree_axpby(a: float, xs: Sequence[torch.Tensor], b: float,
               ys: Sequence[torch.Tensor],
               out_dtype: Optional[torch.dtype] = None
               ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``out = a * x + b * y`` elementwise (fp32 arithmetic) plus the
    non-finite flag of both inputs."""
    found_inf = tree_nonfinite(xs) | tree_nonfinite(ys)
    out = []
    for x, y in zip(xs, ys):
        if not x.is_floating_point():
            out.append(x)
            continue
        r = a * x.float() + b * y.float()
        out.append(r.to(out_dtype or x.dtype))
    return out, found_inf


def tree_l2norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm over every floating tensor (fp32)."""
    ts = _float(tensors)
    if not ts:
        return torch.tensor(0.0)
    norms = torch._foreach_norm([t.float() for t in ts], 2)
    return torch.stack(norms).square().sum().sqrt()


def tree_clip_by_global_norm(tensors: Sequence[torch.Tensor],
                             max_norm: float
                             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale the list by ``min(1, max_norm / (norm + 1e-6))``; returns the
    clipped tensors (in their dtypes) and the global norm."""
    gnorm = tree_l2norm(tensors)
    factor = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    out = [(t * factor).to(t.dtype) if t.is_floating_point() else t
           for t in tensors]
    return out, gnorm
