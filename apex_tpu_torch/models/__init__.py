"""Models of the port: the serial GPT and BERT, the ResNets, the fused
dense layers and the MLP."""

from apex_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
    extended_attention_mask,
)
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
    ResNet50Frozen,
    ResNet101,
    ResNet101Frozen,
    ResNet152,
)

__all__ = ["BasicBlock", "BertConfig", "BertModel", "Bottleneck",
           "FusedDense", "FusedDenseGeluDense", "extended_attention_mask",
           "GPTConfig", "GPTModel", "MLP", "ResNet", "ResNet18", "ResNet34",
           "ResNet50", "ResNet50Frozen", "ResNet101", "ResNet101Frozen",
           "ResNet152"]
