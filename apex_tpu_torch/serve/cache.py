"""Paged KV cache: device page pools, a host-side block allocator and the
prefix cache (port of ``apex_tpu/serve/cache.py``).

The pools keep the JAX layout, layer-stacked
``(L, num_blocks, kv_heads, block, head_dim)``, with ONE block table shared
by all layers; under tensor parallelism a rank's pools hold its
``heads / tp`` kv heads (:func:`kv_heads`). Block 0 is the reserved NULL
page: idle slots and padding rows write there, and table slots beyond a
sequence's allocation point there. The allocator never hands it out.

:class:`PrefixCache` is the sharing trie of the prefix cache: one node per
FULL block of a prefilled prompt, each holding one allocator reference on
its page, so a request whose prompt starts with a cached chain takes the
pages by reference and prefills only from the divergence point.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

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

    def is_shared(self, block: int) -> bool:
        """More than one holder: writes must COW-fork first."""
        return self._refcount[int(block)] > 1

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


class _PrefixNode:
    """One cached FULL block of the trie: its page, its own block's tokens
    (the chain, not the node, spells the prefix) and the trie links."""

    __slots__ = ("block", "tokens", "parent", "children", "by_first", "lru")

    def __init__(self, block: int, tokens: Tuple[int, ...],
                 parent: Optional["_PrefixNode"]):
        self.block = block
        self.tokens = tokens
        self.parent = parent
        # child block-token tuple -> node: one dict probe per chain step
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        # first token -> children starting with it: the partial-match step
        # only looks at children whose first token agrees
        self.by_first: Dict[int, Set["_PrefixNode"]] = {}
        self.lru = 0


class PrefixCache:
    """Token prefix -> cached block chains (host-side, the sharing trie).

    :meth:`lookup` walks the longest chain of exact full-block matches, then
    tries one PARTIAL match inside a child block; that partially matched
    block is the copy-on-write case (the engine forks it before writing past
    the match). Each node holds one allocator reference, so a cached page
    outlives the request that filled it; :meth:`evict` releases the least
    recently used leaves whose page only the cache holds. The caller owns
    one reference per block ``lookup`` returns.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self._alloc = allocator
        self.block_size = int(block_size)
        self._root = _PrefixNode(NULL_BLOCK, (), None)  # sentinel, no page
        self._nodes: Set[_PrefixNode] = set()
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def _touch(self, node: _PrefixNode) -> None:
        self._tick += 1
        node.lru = self._tick

    def lookup(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of ``prompt``: ``(blocks, n_cached)``.
        ``blocks`` fill table slots ``0..len(blocks)-1`` and hold valid k/v
        for positions ``[0, n_cached)``, which may end mid-block."""
        blk = self.block_size
        prompt = [int(t) for t in prompt]
        blocks: List[int] = []
        n = 0
        node = self._root
        while n + blk <= len(prompt):
            child = node.children.get(tuple(prompt[n:n + blk]))
            if child is None:
                break
            blocks.append(child.block)
            node = child
            n += blk
            self._touch(child)
        rem = prompt[n:]
        if rem:
            best, best_m = None, 0
            for child in node.by_first.get(rem[0], ()):
                toks = child.tokens
                m = 0
                while m < len(rem) and m < len(toks) and rem[m] == toks[m]:
                    m += 1
                if m > best_m:
                    best, best_m = child, m
            if best is not None:
                blocks.append(best.block)
                n += best_m
                self._touch(best)
        for b in blocks:
            self._alloc.incref(b)
        if n:
            self.hits += 1
            self.tokens_reused += n
        else:
            self.misses += 1
        return blocks, n

    def insert(self, prompt: Sequence[int], table_row: Sequence[int]) -> int:
        """Register the prompt's FULL blocks (their pages in ``table_row``
        must hold the prompt's k/v: call after its prefill). Existing nodes
        are kept; each new node takes one reference. Returns the number of
        nodes added."""
        blk = self.block_size
        prompt = [int(t) for t in prompt]
        added = 0
        node = self._root
        for i in range(len(prompt) // blk):
            toks = tuple(prompt[i * blk:(i + 1) * blk])
            child = node.children.get(toks)
            if child is None:
                b = int(table_row[i])
                if b == NULL_BLOCK:
                    break
                self._alloc.incref(b)
                child = _PrefixNode(b, toks, node)
                node.children[toks] = child
                node.by_first.setdefault(toks[0], set()).add(child)
                self._nodes.add(child)
                self._touch(child)
                added += 1
            node = child
        return added

    def _evictable(self, node: _PrefixNode) -> bool:
        # leaf-first (a parent's removal would strand its children), and
        # only pages no live sequence still shares
        return not node.children and self._alloc.refcount(node.block) == 1

    def _remove(self, node: _PrefixNode) -> None:
        parent = node.parent
        del parent.children[node.tokens]
        sibs = parent.by_first.get(node.tokens[0])
        if sibs is not None:
            sibs.discard(node)
            if not sibs:
                del parent.by_first[node.tokens[0]]
        self._nodes.discard(node)
        self._alloc.free([node.block])

    def evict(self, n_blocks: int) -> int:
        """Release up to ``n_blocks`` pages, least recently used evictable
        leaves first (removing leaves exposes their parents). Returns the
        number of pages released."""
        released = 0
        while released < n_blocks:
            victims = heapq.nsmallest(
                n_blocks - released,
                (nd for nd in self._nodes if self._evictable(nd)),
                key=lambda nd: nd.lru)
            if not victims:
                break
            for nd in victims:
                self._remove(nd)
                released += 1
        return released

    def drop(self) -> None:
        """Release every cache-held reference (shutdown / leak checks)."""
        for nd in self._nodes:
            self._alloc.free([nd.block])
        self._nodes.clear()
        self._root.children.clear()
        self._root.by_first.clear()


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

    def max_blocks_per_seq(self, max_seq: int) -> int:
        return blocks_for(max_seq, self.block_size)


def kv_heads(model_cfg, mesh=None) -> int:
    """The kv heads one rank's pools hold: all of the model's, or under
    tensor parallelism (``model_cfg.axis`` over ``mesh``) ``heads / tp`` --
    a rank owns whole heads, the serving twin of the training head split
    (``kv_cache_spec``, ``cache.py:370-376``)."""
    n = model_cfg.num_attention_heads
    if getattr(model_cfg, "axis", None) is None:
        return n
    tp = mesh.shape[model_cfg.axis]
    if n % tp:
        raise ValueError(f"{n} heads do not split over {tp} "
                         f"tensor-parallel ranks")
    return n // tp


def init_kv_cache(cfg: KVCacheConfig, device: torch.device):
    """Zero-filled ``(k_pages, v_pages)`` pools on ``device``."""
    k = torch.zeros(cfg.page_shape, dtype=cfg.dtype or torch.bfloat16,
                    device=device)
    return k, torch.zeros_like(k)
