"""Serving of the port: paged KV cache, continuous batching, sampling."""

from apex_tpu_torch.serve.cache import (
    NULL_BLOCK,
    BlockAllocator,
    CacheOutOfBlocks,
    KVCacheConfig,
    PrefixCache,
    blocks_for,
    init_kv_cache,
    kv_heads,
)
from apex_tpu_torch.serve.engine import Engine, ServeConfig
from apex_tpu_torch.serve.sampler import sample_tokens, slot_generator
from apex_tpu_torch.serve.scheduler import ContinuousBatcher, Request

__all__ = [
    "NULL_BLOCK",
    "BlockAllocator",
    "CacheOutOfBlocks",
    "ContinuousBatcher",
    "Engine",
    "KVCacheConfig",
    "PrefixCache",
    "Request",
    "ServeConfig",
    "blocks_for",
    "init_kv_cache",
    "kv_heads",
    "sample_tokens",
    "slot_generator",
]
