"""Rank-aware library logging (port of ``apex_tpu/utils/log_util.py``).

Reference: apex/__init__.py:27-39 installs a ``RankInfoFormatter`` injecting
the rank and the (dp, tp, pp, vpp) rank tuple into every record
(apex/transformer/parallel_state.py:186-195, apex/amp/_amp_state.py:39-51
for ``maybe_print``). Here the rank is ``torch.distributed``'s where a
process group is initialized, else 0; the tuple is this process's
coordinates on the installed topology
(:mod:`apex_tpu_torch.parallel.mesh`), and empty without one.
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


def rank_info() -> str:
    """`` (dp, tp, pp, vpp)=(d, t, p, v)`` on the installed topology (vpp
    None outside the interleaved schedule), or ``""`` without one or on a
    virtual mesh."""
    try:
        from apex_tpu_torch.parallel import mesh

        if not mesh.model_parallel_is_initialized() \
                or mesh.get_mesh().rank is None:
            return ""
        ranks = (mesh.get_data_parallel_rank(),
                 mesh.get_tensor_model_parallel_rank(),
                 mesh.get_pipeline_model_parallel_rank(),
                 mesh.get_virtual_pipeline_model_parallel_rank())
    except Exception:  # noqa: BLE001 - logging must not fail
        return ""
    return f" (dp, tp, pp, vpp)=({', '.join(str(r) for r in ranks)})"


class RankInfoFilter(logging.Filter):
    def filter(self, record):
        record.rank = _rank()
        record.rank_info = rank_info()
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
