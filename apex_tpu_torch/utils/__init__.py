"""Utilities (port of ``apex_tpu/utils``): rank-aware logging."""

from apex_tpu_torch.utils.log_util import get_logger, maybe_print

__all__ = ["get_logger", "maybe_print"]
