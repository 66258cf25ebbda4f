"""Loss scaling (port of ``apex_tpu/amp/scaler.py``).

Dynamic or static scale (init 2**16, x2 after ``scale_window`` clean steps,
/2 on overflow, floored at ``min_loss_scale``, capped at ``max_loss_scale``;
``scaler.py:22-100``). The JAX scaler is carried functional state; this one
updates itself in place, as apex's ``LossScaler`` does. The scale and the
clean-step counter are host numbers: the optimizer step reads the overflow
flag on the host anyway to decide whether to skip.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from apex_tpu_torch.ops.multi_tensor import tree_scale


class LossScaler:
    """Loss-scale state machine. ``LossScaler.create(...)`` mirrors the
    reference's constructor; the fields are ``loss_scale`` (float),
    ``unskipped`` (int) and the static config."""

    def __init__(self, loss_scale: float, unskipped: int = 0, *,
                 dynamic: bool = False, scale_factor: float = 2.0,
                 scale_window: int = 2000,
                 min_loss_scale: Optional[float] = None,
                 max_loss_scale: float = 2.0 ** 24):
        self.loss_scale = float(loss_scale)
        self.unskipped = int(unskipped)
        self.dynamic = dynamic
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_loss_scale = min_loss_scale
        self.max_loss_scale = max_loss_scale

    @classmethod
    def create(cls, loss_scale: Union[str, float] = "dynamic",
               init_scale: float = 2.0 ** 16, scale_factor: float = 2.0,
               scale_window: int = 2000,
               min_loss_scale: Optional[float] = None,
               max_loss_scale: float = 2.0 ** 24) -> "LossScaler":
        dynamic = loss_scale == "dynamic"
        return cls(init_scale if dynamic else float(loss_scale), 0,
                   dynamic=dynamic, scale_factor=scale_factor,
                   scale_window=scale_window, min_loss_scale=min_loss_scale,
                   max_loss_scale=max_loss_scale)

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss.float() * loss_scale``."""
        return loss.float() * self.loss_scale

    def unscale(self, grads: Sequence[torch.Tensor],
                out_dtype: Optional[torch.dtype] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """``(grads / loss_scale, found_inf)``; found_inf is a 0-d bool
        tensor on the grads' device."""
        return tree_scale(grads, 1.0 / self.loss_scale, out_dtype=out_dtype)

    def update(self, found_inf) -> "LossScaler":
        """Post-step adjustment (``scaler.py:78-100``); returns self."""
        if not self.dynamic:
            return self
        found_inf = bool(found_inf)
        unskipped = 0 if found_inf else self.unskipped + 1
        grown = unskipped >= self.scale_window
        floor = self.min_loss_scale if self.min_loss_scale is not None \
            else 0.0
        if found_inf:
            self.loss_scale = max(self.loss_scale / self.scale_factor, floor)
        elif grown:
            self.loss_scale = min(self.loss_scale * self.scale_factor,
                                  self.max_loss_scale)
        self.unskipped = 0 if grown else unskipped
        return self

    def state_dict(self):
        return {"loss_scale": self.loss_scale, "unskipped": self.unskipped}

    def load_state_dict(self, state) -> "LossScaler":
        self.loss_scale = float(state["loss_scale"])
        self.unskipped = int(state["unskipped"])
        return self

