"""Models of the port (the serial GPT in this slice)."""

from apex_tpu_torch.models.gpt import GPTConfig, GPTModel

__all__ = ["GPTConfig", "GPTModel"]
