"""Models of the port: the serial GPT and the ResNets."""

from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
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

__all__ = ["BasicBlock", "Bottleneck", "GPTConfig", "GPTModel", "ResNet",
           "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152"]
