"""FusedScaleMaskSoftmax (port of
``apex_tpu/transformer/functional/fused_softmax.py``).

The module serves Megatron model code that applies softmax to explicit
score tensors ``(b, np, sq, sk)``; for whole attention,
:func:`apex_tpu_torch.ops.flash_attention` does more in one pass. It routes
as the reference does (``fused_softmax.py:60-76``): with ``fused`` and an
8-aligned ``sq``/``sk`` (:meth:`FusedScaleMaskSoftmax.is_kernel_available`)
it takes the fused op, whose softmax kernels launch on CUDA scores (the
plain versions on CPU ones); otherwise the plain
:func:`~apex_tpu_torch.ops.softmax.scaled_masked_softmax_reference`. The
kernels themselves take every shape: the 8-alignment is the reference's
route choice, kept so that both packages route alike.

The softmax is computed in fp32 and returned in the scores' dtype;
``softmax_in_fp32=True`` casts that result to fp32 afterwards, so bf16
probabilities stay bf16-rounded, as in the reference.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

import torch

from apex_tpu_torch.ops.softmax import (
    scaled_masked_softmax,
    scaled_masked_softmax_reference,
    scaled_upper_triang_masked_softmax,
)


class AttnMaskType(enum.Enum):
    """reference: apex/transformer/enums.py AttnMaskType."""

    padding = 1
    causal = 2


@dataclasses.dataclass
class FusedScaleMaskSoftmax:
    """Drop-in FusedScaleMaskSoftmax, a plain callable with the
    reference's fields: ``fused`` (False forces the plain route),
    ``mask_func`` (applied to a given mask; the result is boolean, True =
    masked), ``softmax_in_fp32`` (True returns fp32 probabilities, False the
    scores' dtype) and ``scale`` (None = 1)."""

    attn_mask_type: AttnMaskType = AttnMaskType.padding
    fused: bool = True
    mask_func: Optional[Callable] = None
    softmax_in_fp32: bool = True
    scale: Optional[float] = None

    def __call__(self, x: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        scale = 1.0 if self.scale is None else self.scale
        causal = self.attn_mask_type == AttnMaskType.causal
        if self.mask_func is not None and mask is not None:
            mask = self.mask_func(mask)
        out_dtype = torch.float32 if self.softmax_in_fp32 else x.dtype
        sq, sk = x.shape[-2], x.shape[-1]
        if not (self.fused and self.is_kernel_available(sq, sk)):
            y = scaled_masked_softmax_reference(x, mask, scale, causal=causal)
        elif causal and mask is None:
            y = scaled_upper_triang_masked_softmax(x, scale)
        else:
            # padding, and causal with padding in one fused pass
            y = scaled_masked_softmax(x, mask, scale, causal=causal)
        return y.to(out_dtype)

    @staticmethod
    def is_kernel_available(sq: int, sk: int) -> bool:
        """The reference's route choice for the fused path
        (``fused_softmax.py:78-82``)."""
        return sq % 8 == 0 and sk % 8 == 0
