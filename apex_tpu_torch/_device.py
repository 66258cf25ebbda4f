"""Device resolution for the PyTorch/CUDA port.

Counterpart of ``apex_tpu/ops/layer_norm.py:36-49`` (``_on_tpu`` /
``_resolve_impl``), with the opposite stance on fallbacks: the port's entry
points run on the card unless the caller names the CPU. A machine without a
GPU makes the default raise; nothing quietly runs on the CPU.

Float32 on the card means float32: importing the package turns TF32 off for
both cuBLAS matrix products and cuDNN convolutions (cuDNN defaults to TF32,
which keeps about three decimal digits).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. Only an explicit ``"cpu"`` gives the CPU,
    where every kernel wrapper takes its plain PyTorch version."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; apex_tpu_torch runs on the "
                "card by default -- pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def check_device(t: torch.Tensor, name: str) -> str:
    """``"cpu"`` or ``"cuda"`` for a kernel wrapper's dispatch; any other
    device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} lies on {t.device}; the port runs on "
                         f"'cuda' (kernels) or 'cpu' (plain versions)")
    return t.device.type
