"""The MoE GPT example: routed-expert FFNs, serial or expert-parallel over
the data axis (``pretrain_moe_gpt``)."""
