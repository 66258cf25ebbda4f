"""Long-context GPT training on one card (``train_long_context``)."""
