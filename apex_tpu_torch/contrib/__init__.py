"""Contrib modules of the port (port of ``apex_tpu/contrib/``): so far
``FastLayerNorm``; the rest is ROADMAP Queue 1 item 20."""

from apex_tpu_torch.contrib.layer_norm import FastLayerNorm

__all__ = ["FastLayerNorm"]
