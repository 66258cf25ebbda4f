"""apex_tpu_torch -- the PyTorch/CUDA port of ``apex_tpu``.

The JAX package ``apex_tpu`` is the reference; this package mirrors its
module paths so that each file here has one counterpart there. Plain tensor
code is PyTorch; every Pallas kernel on a ported path is a CUDA C++ kernel
written by hand for Hopper (``csrc/``), built with ``nvcc`` at first use.

The first slice serves GPT-2 345M: ``models.GPTModel`` and
``serve.Engine`` through three kernels -- the flash-attention forward
(prefill), the LayerNorm forward (every LN) and the paged flash-decode
(decode ticks). Entry points default to the card; ``device="cpu"`` runs
the plain PyTorch versions of the kernels instead.

The package imports ``torch``, numpy and the standard library only.
"""

from apex_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
