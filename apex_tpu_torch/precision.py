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

``get_policy(level, **overrides)`` takes the reference's per-field
overrides and ``half_dtype`` (``precision.py:152-230``): ``None`` values
are skipped, an unknown key raises, and the O1 op lists (``fp32_ops`` /
``half_ops``) raise on a cast model. :meth:`Policy.op_dtype` gives an op
family's compute dtype (``precision.py:121-143``).

The JAX package casts a parameter pytree; here :func:`cast_params` casts an
``nn.Module``'s parameters IN PLACE, keeping norm parameters fp32 by the same
name rule (``_BN_TOKEN_RE``, ``precision.py:238-256``) applied to the
qualified parameter names (``layers.3.ln1.scale``, ``ln_f.bias``,
``layer1_0.bn2.scale``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, FrozenSet, List, Optional, Union

import torch
from torch import nn


# Op families kept fp32 under an O1-style policy: the reference's FP32
# blacklist (precision.py:43-67) -- softmax-like, exp/log, norms, losses.
_DEFAULT_FP32_OPS: FrozenSet[str] = frozenset({
    "softmax", "log_softmax", "layer_norm", "rms_norm", "batch_norm",
    "group_norm", "cross_entropy", "mse_loss", "l1_loss", "exp", "log",
    "pow", "sum", "mean", "norm", "cumsum", "erf", "softplus",
    "sigmoid_loss",
})

# Normalization families: fp32 under keep_batchnorm_fp32 even in a cast
# model (precision.py:69-71).
_NORM_OPS: FrozenSet[str] = frozenset(
    {"batch_norm", "layer_norm", "rms_norm", "group_norm"})

# Op families computed in the half dtype under O1, the FP16 whitelist
# (precision.py:73-78): matmuls and convolutions.
_DEFAULT_HALF_OPS: FrozenSet[str] = frozenset(
    {"matmul", "conv", "dense", "attention", "einsum", "mlp"})


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
    fp32_ops: FrozenSet[str] = _DEFAULT_FP32_OPS
    half_ops: FrozenSet[str] = _DEFAULT_HALF_OPS

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == "dynamic"

    @property
    def param_dtype(self) -> torch.dtype:
        return self.cast_model_type or torch.float32

    def op_dtype(self, op_family: str) -> torch.dtype:
        """Compute dtype of an op family (``Policy.op_dtype``). Uncast
        params (O0/O1): fp32 for the fp32 list, ``compute_dtype`` for the
        half list, fp32 for the rest. A cast model (O2/O3): everything in
        ``compute_dtype`` except the norm families under
        ``keep_batchnorm_fp32``."""
        if self.cast_model_type is None:
            if op_family in self.fp32_ops:
                return torch.float32
            if op_family in self.half_ops:
                return self.compute_dtype
            return torch.float32
        if self.keep_batchnorm_fp32 and op_family in _NORM_OPS:
            return torch.float32
        return self.compute_dtype


_HALF = object()  # the preset's half dtype, ``half_dtype`` of get_policy

_PRESETS = {
    "O0": dict(cast_model_type=None, compute_dtype=torch.float32,
               keep_batchnorm_fp32=True, master_weights=False,
               loss_scale=1.0),
    "O1": dict(cast_model_type=None, compute_dtype=_HALF,
               keep_batchnorm_fp32=True, master_weights=False,
               loss_scale="dynamic"),
    "O2": dict(cast_model_type=_HALF, compute_dtype=_HALF,
               keep_batchnorm_fp32=True, master_weights=True,
               loss_scale="dynamic"),
    "O3": dict(cast_model_type=_HALF, compute_dtype=_HALF,
               keep_batchnorm_fp32=False, master_weights=False,
               loss_scale=1.0),
}


_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def _canon(dt: Any) -> Optional[torch.dtype]:
    """A torch dtype from a dtype or its name (``"bfloat16"``)."""
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    name = str(dt).replace("torch.", "")
    if name not in _DTYPE_NAMES:
        raise ValueError(f"unsupported dtype {dt!r}")
    return _DTYPE_NAMES[name]


def get_policy(opt_level: Union[str, Policy] = "O1", **overrides) -> Policy:
    """The Policy of an opt level plus overrides (``get_policy``,
    ``precision.py:152-230``). ``half_dtype`` (default bf16) is the cast
    and compute dtype of O1-O3; every other override names a field, a
    ``None`` value is skipped, an unknown key raises, and ``fp32_ops`` /
    ``half_ops`` raise on a cast model (O2/O3). A Policy passes through and
    takes no override but ``half_dtype``."""
    if isinstance(opt_level, Policy):
        live = {k: v for k, v in overrides.items()
                if v is not None and k != "half_dtype"}
        if live:
            raise ValueError(
                f"Overrides {sorted(live)} cannot be combined with a "
                f"pre-built Policy; pass an opt-level string, or "
                f"dataclasses.replace the Policy.")
        return opt_level
    if opt_level not in _PRESETS:
        raise ValueError(f"Unexpected optimization level {opt_level!r}; "
                         f"options are 'O0', 'O1', 'O2', 'O3'.")
    half = _canon(overrides.pop("half_dtype", None) or torch.bfloat16)
    cfg = {k: (half if v is _HALF else v)
           for k, v in _PRESETS[opt_level].items()}
    for k, v in overrides.items():
        if v is None:
            continue
        if k not in cfg and k not in ("fp32_ops", "half_ops"):
            raise ValueError(f"Unknown policy override {k!r}")
        cfg[k] = v
    if cfg.get("cast_model_type") is not None and (
            overrides.get("fp32_ops") is not None
            or overrides.get("half_ops") is not None):
        raise ValueError(
            "fp32_ops/half_ops only govern uncast-model policies (O0/O1); a "
            "cast model (O2/O3) runs wholesale in compute_dtype -- use "
            "keep_batchnorm_fp32 for fp32 norms.")
    cfg["cast_model_type"] = _canon(cfg["cast_model_type"])
    cfg["compute_dtype"] = _canon(cfg["compute_dtype"])
    for k in ("fp32_ops", "half_ops"):
        if k in cfg:
            cfg[k] = frozenset(cfg[k])
    return Policy(opt_level=opt_level, **cfg)


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
