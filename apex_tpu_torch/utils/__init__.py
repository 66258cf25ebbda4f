"""Utilities (port of ``apex_tpu/utils``): rank-aware logging, atomic JSON
writes and the shared inverted dropout. ``utils/compat.py`` is JAX
version glue and has no counterpart here."""

from apex_tpu_torch.utils.io import atomic_write_json
from apex_tpu_torch.utils.log_util import get_logger, maybe_print
from apex_tpu_torch.utils.nn import inverted_dropout

__all__ = ["atomic_write_json", "get_logger", "inverted_dropout",
           "maybe_print"]
