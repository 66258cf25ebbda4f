"""Rank-aware library logging (port of ``apex_tpu/utils/log_util.py``).

Reference: apex/__init__.py:27-39 installs a ``RankInfoFormatter`` injecting
the rank into every record (apex/amp/_amp_state.py:39-51 for
``maybe_print``). Here the rank is ``torch.distributed``'s where a process
group is initialized, else 0; the (dp, tp, pp, vpp) rank tuple comes with the
parallel state (ROADMAP Queue 1 item 10) and is empty until then.
"""

from __future__ import annotations

import logging


def _rank() -> int:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:  # noqa: BLE001 - logging must not fail
        pass
    return 0


class RankInfoFilter(logging.Filter):
    def filter(self, record):
        record.rank = _rank()
        record.rank_info = ""
        return True


def get_logger(name: str = "apex_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s [proc %(rank)s%(rank_info)s] "
            "%(name)s: %(message)s"))
        handler.addFilter(RankInfoFilter())
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def maybe_print(msg: str, rank0: bool = False) -> None:
    """Print ``msg``; with ``rank0``, only on rank 0."""
    if rank0 and _rank() != 0:
        return
    print(msg, flush=True)
