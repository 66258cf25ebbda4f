"""apex_tpu_torch -- the PyTorch/CUDA port of ``apex_tpu``.

The JAX package ``apex_tpu`` is the reference; this package mirrors its
module paths so that each file here has one counterpart there. Plain tensor
code is PyTorch; every Pallas kernel on a ported path is a CUDA C++ kernel
written by hand for Hopper (``csrc/``), built with ``nvcc`` at first use.

It serves GPT-2 345M (``models.GPTModel``, ``serve.Engine``), trains it
with amp O2 (``bench``), and trains ResNet-50 with the ImageNet recipe
(``models.ResNet50``, ``examples.imagenet.main_amp``) through the
hand-written kernels of ``csrc/`` (flash attention and its backward,
LayerNorm and its backward, paged decode, softmax cross-entropy and its
backward, the fused scale-mask softmax and its backward behind
``transformer.functional.FusedScaleMaskSoftmax``). The small layers
(``normalization``, ``contrib.FastLayerNorm``, ``models.MLP`` and the fused
dense layers) run over the LayerNorm kernels and ``torch.matmul``. The
root ``bench.py`` of the JAX package runs as ``python -m
apex_tpu_torch.bench``; ``amp.initialize`` and the O1 function registries,
the DCGAN example and the native host runtime (``csrc``) come with it.
Entry points default to the card; ``device="cpu"`` runs the
plain PyTorch versions of the kernels instead.

The package imports ``torch``, numpy and the standard library only.
"""

from apex_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
