"""Paged KV cache: device page pools + a host-side block allocator
(port of ``apex_tpu/serve/cache.py``; the prefix cache is a later slice).

The pools keep the JAX layout, layer-stacked
``(L, num_blocks, kv_heads, block, head_dim)``, with ONE block table shared
by all layers. Block 0 is the reserved NULL page: idle slots and padding
rows write there, and table slots beyond a sequence's allocation point
there. The allocator never hands it out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import torch

#: the reserved scratch page every table defaults to (never allocated)
NULL_BLOCK = 0


class CacheOutOfBlocks(RuntimeError):
    """The page pool is exhausted -- admission must wait for retirements."""


class BlockAllocator:
    """Refcounted free-list allocator over the page pool (host-side, O(1)).

    Block 0 is never handed out; a block is never handed out twice without
    an intervening release; ``free`` of an unallocated, out-of-range or null
    block raises (double-free detection). ``free`` drops one reference and
    returns the page to the free list at zero."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (one null page + one usable), "
                f"got {num_blocks}")
        self.num_blocks = int(num_blocks)
        # LIFO free list: recently-freed pages are reused first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._refcount = [0] * self.num_blocks

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    def refcount(self, block: int) -> int:
        return self._refcount[int(block)]

    def _check_id(self, b: int) -> int:
        b = int(b)
        if not 0 < b < self.num_blocks:
            raise ValueError(f"block {b} out of range (null page is never "
                             f"ref-counted)")
        return b

    def alloc(self) -> int:
        if not self._free:
            raise CacheOutOfBlocks(
                f"page pool exhausted ({self.num_blocks - 1} usable blocks)")
        b = self._free.pop()
        self._refcount[b] = 1
        return b

    def alloc_many(self, n: int) -> List[int]:
        if n > len(self._free):
            raise CacheOutOfBlocks(
                f"need {n} blocks, {len(self._free)} available")
        return [self.alloc() for _ in range(n)]

    def incref(self, block: int) -> int:
        b = self._check_id(block)
        if not self._refcount[b]:
            raise ValueError(f"incref of unallocated block {b}")
        self._refcount[b] += 1
        return b

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            b = self._check_id(b)
            if not self._refcount[b]:
                raise ValueError(f"double free of block {b}")
            self._refcount[b] -= 1
            if not self._refcount[b]:
                self._free.append(b)


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Pages needed to hold ``n_tokens`` (ceil division)."""
    return -(-int(n_tokens) // int(block_size))


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Page-pool geometry. ``num_blocks`` INCLUDES the null page."""

    num_layers: int
    kv_heads: int
    head_dim: int
    block_size: int = 16
    num_blocks: int = 64
    dtype: Any = None  # resolved by init_kv_cache (model compute dtype)

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got "
                             f"{self.block_size}")

    @property
    def page_shape(self):
        return (self.num_layers, self.num_blocks, self.kv_heads,
                self.block_size, self.head_dim)


def init_kv_cache(cfg: KVCacheConfig, device: torch.device):
    """Zero-filled ``(k_pages, v_pages)`` pools on ``device``."""
    k = torch.zeros(cfg.page_shape, dtype=cfg.dtype or torch.bfloat16,
                    device=device)
    return k, torch.zeros_like(k)
