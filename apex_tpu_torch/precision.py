"""Precision policies (port of ``apex_tpu/precision.py``).

A policy is a frozen dataclass with the four presets O0-O3 of apex's opt
levels (``precision.py:153-226``), consumed by
``apex_tpu_torch.amp.MixedPrecisionOptimizer`` (master weights, loss
scaling) and by :func:`cast_params`:

====== ==================== ================= ============== ===========
level  cast_model_type      compute_dtype     master_weights loss_scale
====== ==================== ================= ============== ===========
O0     None (fp32)          fp32              False          1.0
O1     None (fp32 params)   bf16              False          "dynamic"
O2     bf16 (norms fp32)    bf16              True           "dynamic"
O3     bf16                 bf16              False          1.0
====== ==================== ================= ============== ===========

The JAX package casts a parameter pytree; here :func:`cast_params` casts an
``nn.Module``'s parameters IN PLACE, keeping norm parameters fp32 by the same
name rule (``_BN_TOKEN_RE``, ``precision.py:238-256``) applied to the
qualified parameter names (``layers.3.ln1.scale``, ``ln_f.bias``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Union

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Policy:
    """A mixed-precision policy (apex ``Properties``): see the module
    docstring for the presets; fields as in the reference."""

    opt_level: str = "O0"
    cast_model_type: Optional[torch.dtype] = None
    compute_dtype: torch.dtype = torch.float32
    keep_batchnorm_fp32: bool = True
    master_weights: bool = False
    loss_scale: Union[str, float] = 1.0

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == "dynamic"

    @property
    def param_dtype(self) -> torch.dtype:
        return self.cast_model_type or torch.float32


_PRESETS = {
    "O0": dict(cast_model_type=None, compute_dtype=torch.float32,
               keep_batchnorm_fp32=True, master_weights=False,
               loss_scale=1.0),
    "O1": dict(cast_model_type=None, compute_dtype=torch.bfloat16,
               keep_batchnorm_fp32=True, master_weights=False,
               loss_scale="dynamic"),
    "O2": dict(cast_model_type=torch.bfloat16, compute_dtype=torch.bfloat16,
               keep_batchnorm_fp32=True, master_weights=True,
               loss_scale="dynamic"),
    "O3": dict(cast_model_type=torch.bfloat16, compute_dtype=torch.bfloat16,
               keep_batchnorm_fp32=False, master_weights=False,
               loss_scale=1.0),
}


def get_policy(opt_level: Union[str, Policy] = "O1") -> Policy:
    """The Policy of an opt level (``get_policy``); a Policy passes through.
    The reference's per-field overrides and O1 op lists wait for a slice
    that reads them."""
    if isinstance(opt_level, Policy):
        return opt_level
    if opt_level not in _PRESETS:
        raise ValueError(f"Unexpected optimization level {opt_level!r}; "
                         f"options are 'O0', 'O1', 'O2', 'O3'.")
    return Policy(opt_level=opt_level, **_PRESETS[opt_level])


# any name containing "norm", or a standalone bn/ln token ("bn1", "ln_f")
_BN_TOKEN_RE = re.compile(r"(^|[._/])(bn|ln)\d*([._/]|$)")


def name_is_norm(name: str) -> bool:
    """The reference's norm-path rule on a qualified parameter name."""
    n = name.lower()
    return "norm" in n or _BN_TOKEN_RE.search(n) is not None


@torch.no_grad()
def cast_params(module: nn.Module, policy: Policy) -> nn.Module:
    """Cast ``module``'s floating parameters IN PLACE to
    ``policy.param_dtype``, keeping norm parameters fp32 under
    ``keep_batchnorm_fp32`` (``cast_params``, ``precision.py:274-288``).
    Returns the module."""
    if policy.cast_model_type is None:
        return module
    for name, p in module.named_parameters():
        if not p.is_floating_point():
            continue
        keep = policy.keep_batchnorm_fp32 and name_is_norm(name)
        dtype = torch.float32 if keep else policy.cast_model_type
        if p.dtype != dtype:
            p.data = p.data.to(dtype)
    return module


def upcast_params(params: Any, dtype: torch.dtype = torch.float32
                  ) -> List[torch.Tensor]:
    """Detached copies of the floating parameters (a module's, or a list)
    in ``dtype``: the master-weight init (``upcast_params``)."""
    if isinstance(params, nn.Module):
        params = list(params.parameters())
    return [p.detach().to(dtype, copy=True) if p.is_floating_point()
            else p.detach().clone() for p in params]
