"""Models of the port: the serial GPT, the ResNets, the fused dense
layers and the MLP."""

from apex_tpu_torch.models.fused_dense import FusedDense, FusedDenseGeluDense
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.models.mlp import MLP
from apex_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)

__all__ = ["BasicBlock", "Bottleneck", "FusedDense", "FusedDenseGeluDense",
           "GPTConfig", "GPTModel", "MLP", "ResNet", "ResNet18", "ResNet34",
           "ResNet50", "ResNet101", "ResNet152"]
