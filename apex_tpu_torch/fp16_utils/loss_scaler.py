"""Static and dynamic loss scalers under their legacy names (port of
``apex_tpu/fp16_utils/loss_scaler.py``).

Both build the port's amp :class:`~apex_tpu_torch.amp.scaler.LossScaler`,
so legacy code and amp share one state machine, with the legacy defaults:
the dynamic scaler starts at 2^32 with a growth window of 1000 and no
growth cap (amp's: 2^16, 2000, capped at 2^24).
"""

from __future__ import annotations

from apex_tpu_torch.amp.scaler import LossScaler as _AmpScaler


def LossScaler(scale: float = 1.0) -> _AmpScaler:
    """Static scaler (``loss_scaler.py:15-17``): a fixed ``scale`` that
    never updates."""
    return _AmpScaler.create(loss_scale=float(scale))


def DynamicLossScaler(init_scale: float = 2.0 ** 32,
                      scale_factor: float = 2.0,
                      scale_window: int = 1000) -> _AmpScaler:
    """Dynamic scaler with the legacy defaults (``loss_scaler.py:20-33``)."""
    return _AmpScaler.create(loss_scale="dynamic", init_scale=init_scale,
                             scale_factor=scale_factor,
                             scale_window=scale_window,
                             max_loss_scale=float("inf"))
