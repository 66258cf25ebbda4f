"""User-registered precision-cast wrappers: the O1 decorator surface (port of
``apex_tpu/amp/functions.py``; reference: apex/amp/amp.py:29-64
``register_half_function`` / ``register_float_function`` /
``register_promote_function`` and the ``half_function`` /
``float_function`` / ``promote_function`` decorators).

apex monkey-patches torch functions at ``amp.init``; here, as in the JAX
package, a wrapper applied at call sites casts the floating tensors among
its nested args and kwargs (``torch.utils._pytree``) on entry. Complex
tensors, integers and non-tensors pass untouched. Policies with a cast model
(O2/O3) or fp32 compute make :func:`half_function` a no-op (the network
already runs in the compute dtype), as the reference installs the O1
patcher only under ``patch_torch_functions``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils import _pytree

from apex_tpu_torch import precision as _precision

# The active policy, set by amp.initialize (the _amp_state analog).
_active_policy: Optional[_precision.Policy] = None


def set_active_policy(policy: Optional[_precision.Policy]) -> None:
    global _active_policy
    _active_policy = policy


class disable_casts:
    """Context manager suspending the registered-function casts
    (``amp.disable_casts``, apex/amp/handle.py:163-167)."""

    def __enter__(self):
        global _active_policy
        self._saved = _active_policy
        _active_policy = None
        return self

    def __exit__(self, *exc):
        global _active_policy
        _active_policy = self._saved
        return False


def _cast_floats(args, kwargs, dtype: torch.dtype):
    def cast(a):
        # real floating only: casting complex would drop imaginary parts
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.to(dtype)
        return a

    return _pytree.tree_map(cast, (args, kwargs))


def half_function(fn: Callable) -> Callable:
    """Run ``fn`` in the policy's compute dtype (FP16 whitelist;
    amp.py:38-41)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        p = _active_policy
        # active only for uncast-model policies (O1): with a cast model
        # (O2/O3) deliberately-fp32 tensors (keep_batchnorm_fp32) pass
        if (p is None or p.cast_model_type is not None
                or p.compute_dtype == torch.float32):
            return fn(*args, **kwargs)
        args, kwargs = _cast_floats(args, kwargs, p.compute_dtype)
        return fn(*args, **kwargs)

    return wrapped


def float_function(fn: Callable) -> Callable:
    """Run ``fn`` in fp32 (FP32 blacklist: losses, norms, exp/log families;
    amp.py:43-46)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _active_policy is None:
            return fn(*args, **kwargs)
        args, kwargs = _cast_floats(args, kwargs, torch.float32)
        return fn(*args, **kwargs)

    return wrapped


def promote_function(fn: Callable) -> Callable:
    """Promote the floating args to the widest floating or complex dtype
    among them (``torch.promote_types``; amp.py:48-51,
    torch_overrides.py:86-115)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _active_policy is None:
            return fn(*args, **kwargs)
        dts = [a.dtype for a in _pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)
               and (a.is_floating_point() or a.is_complex())]
        if not dts:
            return fn(*args, **kwargs)
        widest = functools.reduce(torch.promote_types, dts)
        args, kwargs = _cast_floats(args, kwargs, widest)
        return fn(*args, **kwargs)

    return wrapped
