"""Hand-written CUDA C++ kernels of the port (built by ``build.py``) and the
host-side token reader (``TokenLoader``, ``token_loader.py``)."""

from apex_tpu_torch.csrc.token_loader import TokenLoader

__all__ = ["TokenLoader"]
