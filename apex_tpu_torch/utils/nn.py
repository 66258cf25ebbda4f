"""Small shared nn helpers (port of ``apex_tpu/utils/nn.py``): the inverted
dropout the transformer layers and the RNN stack share."""

from __future__ import annotations

from typing import Optional

import torch


def inverted_dropout(x: torch.Tensor, rate: float,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the rest by
    ``1 / (1 - rate)`` (``utils/nn.py:17-26``); identity without a
    generator or at rate 0. The masks come from ``generator`` alone."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)
