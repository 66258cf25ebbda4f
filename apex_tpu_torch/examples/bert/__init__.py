"""BERT pretraining with FusedLAMB on one card (``pretrain_bert``)."""
