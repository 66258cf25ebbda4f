"""The GPT examples on one card: training with checkpoint and resume
(``pretrain_gpt``) and serving a checkpoint (``generate_gpt``)."""
