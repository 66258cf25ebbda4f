"""Hand-written CUDA C++ kernels of the port (built by ``build.py``) and the
native host runtime (``apex_runtime.cpp``, built by ``runtime.py``), with the
public surface of ``apex_tpu/csrc/__init__.py``:

- :func:`flatten` / :func:`unflatten`: contiguous bucket packing;
- :class:`TokenLoader`: the threaded binary batch streamer;
- :func:`available`: whether the native runtime loaded (else the Python
  paths run).
"""

from apex_tpu_torch.csrc.runtime import available, flatten, unflatten
from apex_tpu_torch.csrc.token_loader import TokenLoader

__all__ = ["TokenLoader", "available", "flatten", "unflatten"]
