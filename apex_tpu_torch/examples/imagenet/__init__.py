"""ImageNet-style ResNet training with amp on one card (``main_amp``)."""
