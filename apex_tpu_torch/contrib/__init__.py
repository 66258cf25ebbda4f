"""Contrib modules of the port (port of ``apex_tpu/contrib/``): so far
``FastLayerNorm`` and the packed varlen ``fmha``; the rest is ROADMAP
Queue 1 item 20."""

from apex_tpu_torch.contrib.fmha import (
    fmha,
    fmha_reference,
    segment_ids_from_cu_seqlens,
)
from apex_tpu_torch.contrib.layer_norm import FastLayerNorm

__all__ = ["FastLayerNorm", "fmha", "fmha_reference",
           "segment_ids_from_cu_seqlens"]
