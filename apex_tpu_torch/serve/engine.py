"""Serving engine: paged KV cache with continuous batching, prefix sharing,
chunked prefill and speculative decoding (port of
``apex_tpu/serve/engine.py``).

A host loop over a fixed ``max_batch`` slot array: each tick admits queued
requests into free slots, advances at most one prefill chunk, runs one
decode step (or one speculative propose/verify step) for every active slot,
and retires finished requests. The KV pages live in the layer-stacked pools
of :mod:`.cache`; one block table row per slot addresses them.

Admission is reservation-based (``engine.py:751-768``): a request is seated
only when its whole-lifetime page need (prompt + max_new_tokens) fits under
the pool minus every active slot's reservation, so growth during decode
never finds the allocator empty. TTFT and ITL are stamped on the host clock
after the device-to-host token fetch.

The three features of ``ServeConfig`` (``engine.py:32-52``):

- ``prefix_cache``: a prompt whose prefix matches a cached block chain
  (:class:`~.cache.PrefixCache`) takes those pages by reference and
  prefills only from the divergence point; a write into a shared page
  copy-on-write forks it first (:meth:`Engine._prepare_write_range`).
- ``prefill_chunk``: prompts run in chunks of that many tokens, one chunk
  per engine tick between decode steps, so a long prompt does not stall the
  running streams.
- ``spec_k``: a draft model proposes ``spec_k`` tokens per slot per tick;
  the target verifies them all in one K-query forward
  (``GPTModel.serve_layers_multi``) and commits the longest greedy
  agreement plus one token. Greedy only, and exact: the output equals the
  non-speculative engine's.

Any of the three routes EVERY prefill through the chunk path (K-query
attention over the pages, ``flash_decode_multi``); without them a prompt
takes one monolithic prefill (``flash_attention``).

Tensor-parallel serving (``engine.py:176-260``): a model built with
``axis="model"`` needs the mesh (``mesh=``, the topology
``initialize_model_parallel`` installed), its pools hold ``heads / tp`` kv
heads (a rank owns whole heads, ``cache.py:370-376``), and a draft model
must share the target's axis. Every rank of the axis runs this same host
loop in lockstep on the same requests: the gathered logits are the same on
every rank (``GPTModel.serve_head``), so greedy picks agree, and a sampled
pick draws from generators seeded by (seed, slot, tick), the same on every
rank. Sequence-parallel models are refused (``GPTModel.check_servable``).
A model with routed experts serves serial, or expert-parallel
(``moe_expert_axis``, ``engine.py:185-194``: it too needs ``mesh=``): the
ranks of the expert axis run this loop in lockstep on the same requests,
each routes every token and computes its own experts' share, and one
``psum`` adds them (``MoEMLP.apply_expert_sharded``), so every rank holds
the serial engine's logits.

Not in this port yet (ROADMAP Queue 1 item 14): SLO windows, request traces
(``serve/reqtrace.py``), journals and tracer spans, and a CUDA graph of
the decode tick. ``examples/gpt/generate_gpt.py`` drives
it from a checkpoint (``apex_tpu_torch.examples.gpt.generate_gpt``). The
reference's ``decode_impl`` has no counterpart: the port picks the kernel
or the plain version by the device of the tensors.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import DeviceLike, resolve_device
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
from apex_tpu_torch.serve.sampler import sample_tokens, slot_generator
from apex_tpu_torch.serve.scheduler import ContinuousBatcher, Request

#: minimum pages reclaimed per prefix-cache eviction (amortizes the scan)
_EVICT_BATCH = 8


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine geometry, sampling and the three serving features."""

    max_batch: int = 4
    max_seq: int = 128          # prompt + generation cap per request
    prefill_len: Optional[int] = None  # prompt pad length (default max_seq)
    block_size: int = 16
    num_blocks: Optional[int] = None   # default: worst-case fit + null page
    temperature: float = 0.0    # 0 = greedy
    top_k: int = 0              # 0 = full distribution
    seed: int = 0
    eos_id: Optional[int] = None
    # prefix sharing: cache prefilled prompt blocks (refcounts + COW) and
    # start a matching prompt's prefill at its divergence point
    prefix_cache: bool = False
    # chunked prefill: prompts run in chunks of this many tokens, one chunk
    # per engine tick between decode steps (None: whole prompt at admission)
    prefill_chunk: Optional[int] = None
    # speculative decoding: draft tokens per slot per tick (0 = off; > 0
    # needs temperature == 0, since verification is greedy-exact)
    spec_k: int = 0

    def resolved(self) -> "ServeConfig":
        pf = min(self.prefill_len or self.max_seq, self.max_seq)
        nb = self.num_blocks
        if nb is None:
            nb = self.max_batch * blocks_for(self.max_seq,
                                             self.block_size) + 1
        pc = self.prefill_chunk
        if pc is not None:
            pc = max(1, min(int(pc), pf))
        if self.spec_k and self.temperature != 0.0:
            raise ValueError(
                "spec_k > 0 requires temperature == 0: speculative "
                "verification is greedy-exact (argmax agreement); exact "
                "speculative sampling needs rejection sampling the engine "
                "does not implement")
        return dataclasses.replace(self, prefill_len=pf, num_blocks=nb,
                                   prefill_chunk=pc)


class Engine:
    """Paged-KV serving engine over a port ``GPTModel``.

    >>> eng = Engine(model, ServeConfig(max_batch=4, max_seq=128))
    >>> results = eng.run([Request(prompt=[1, 2, 3], max_new_tokens=16)])

    ``device`` defaults to the card and must be the model's device.
    ``draft_model`` (with ``spec_k``) defaults to the target itself; its
    pools have its own geometry but share the target's block tables and
    allocator, so one block id addresses both caches. ``mesh``: the
    installed topology, required by a tensor- or expert-parallel model."""

    def __init__(self, model, config: ServeConfig,
                 device: DeviceLike = None, draft_model=None, mesh=None):
        self.device = dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"on {dev}")
        model.check_servable()
        c = model.cfg
        self.model = model
        self.mesh = mesh
        self.axis = c.axis
        # expert-parallel decode: every rank routes the same tokens and
        # adds its local experts' shares (GPTModel._serve_ffn); per-tick
        # routing is data, not shapes
        self.expert_axis = getattr(c, "moe_expert_axis", None)
        if (self.axis is not None or self.expert_axis is not None) \
                and mesh is None:
            raise ValueError(
                "a sharded model (cfg.axis or cfg.moe_expert_axis set) "
                "needs the mesh -- pass mesh= (initialize_model_parallel's), "
                "or build the serve model serial (axis=None, "
                "moe_expert_axis=None)")
        self.config = cfg = config.resolved()
        if cfg.max_seq > c.max_seq_len:
            raise ValueError(
                f"max_seq ({cfg.max_seq}) exceeds the model's max_seq_len "
                f"({c.max_seq_len})")
        self.kv_config = KVCacheConfig(
            num_layers=c.num_layers, kv_heads=kv_heads(c, mesh),
            head_dim=c.head_dim, block_size=cfg.block_size,
            num_blocks=cfg.num_blocks, dtype=c.compute_dtype)
        self._nb_per_seq = self.kv_config.max_blocks_per_seq(cfg.max_seq)
        self.allocator = BlockAllocator(cfg.num_blocks)
        self.batcher = ContinuousBatcher(cfg.max_batch)
        self.prefix_cache = (PrefixCache(self.allocator, cfg.block_size)
                             if cfg.prefix_cache else None)
        self.k_pages, self.v_pages = init_kv_cache(self.kv_config, dev)

        # -- draft model (speculative decoding) -----------------------------
        self.draft_model = None
        self.dk_pages = self.dv_pages = None
        if cfg.spec_k:
            dm = draft_model if draft_model is not None else model
            if dm.device != dev:
                raise ValueError(f"the draft model lies on {dm.device}, the "
                                 f"engine on {dev}")
            dm.check_servable()
            if dm.cfg.axis != c.axis:
                raise ValueError(
                    "the draft model must share the target's tensor-"
                    "parallel axis (both run on the same ranks in "
                    "lockstep)")
            if cfg.max_seq > dm.cfg.max_seq_len:
                raise ValueError(
                    f"max_seq ({cfg.max_seq}) exceeds the draft model's "
                    f"max_seq_len ({dm.cfg.max_seq_len})")
            dc = dm.cfg
            self.draft_model = dm
            self.draft_kv_config = KVCacheConfig(
                num_layers=dc.num_layers, kv_heads=kv_heads(dc, mesh),
                head_dim=dc.head_dim, block_size=cfg.block_size,
                num_blocks=cfg.num_blocks, dtype=dc.compute_dtype)
            self.dk_pages, self.dv_pages = init_kv_cache(
                self.draft_kv_config, dev)

        # -- host state (one row per slot) ----------------------------------
        B = cfg.max_batch
        self._tables = np.full((B, self._nb_per_seq), NULL_BLOCK, np.int32)
        self._lengths = np.zeros((B,), np.int64)
        self._active = np.zeros((B,), bool)
        self._last_token = np.zeros((B,), np.int64)
        self._slot_blocks: List[List[int]] = [[] for _ in range(B)]
        self._last_tok_t: List[Optional[float]] = [None] * B
        # worst-case page reservations per active slot (admission control)
        self._slot_reserved = [0] * B
        self._reserved_blocks = 0
        # absolute write ceiling per slot (prompt + max_new): speculative
        # writes past it go to the null page, inside the reservation
        self._write_cap = np.zeros((B,), np.int64)
        # slots seated but still prefilling through chunks: slot -> progress
        self._prefilling: Dict[int, Dict[str, Any]] = {}
        self.ticks = 0
        self.prefills = 0       # monolithic prefill launches
        self.chunks = 0         # target prefill-chunk launches
        self.decode_steps = 0   # decode launches (ticks with active slots)
        self.cow_forks = 0
        self.accepted_total = 0
        self.accept_events = 0  # (slot, tick) commits: the mean's divisor
        self.spec_ticks = 0
        # any of the three features routes prefill through the chunk path;
        # its default width bounds the K of one K-query launch
        self._chunk_armed = bool(cfg.prefix_cache or cfg.prefill_chunk
                                 or cfg.spec_k)
        self._chunk_width = cfg.prefill_chunk or min(cfg.prefill_len, 256)

    # -- requests -----------------------------------------------------------

    def _worst_case_blocks(self, request: Request) -> int:
        return blocks_for(len(request.prompt) + request.max_new_tokens,
                          self.config.block_size)

    def submit(self, request: Request) -> None:
        cfg = self.config
        if len(request.prompt) > cfg.prefill_len:
            raise ValueError(
                f"prompt length {len(request.prompt)} exceeds prefill_len "
                f"{cfg.prefill_len}")
        if len(request.prompt) + request.max_new_tokens > cfg.max_seq:
            raise ValueError(
                f"prompt + max_new_tokens exceeds max_seq ({cfg.max_seq})")
        usable = self.allocator.num_blocks - 1
        if self._worst_case_blocks(request) > usable:
            raise ValueError(
                f"request needs {self._worst_case_blocks(request)} pages "
                f"worst-case but the pool has {usable}; grow num_blocks or "
                f"shrink prompt/max_new_tokens")
        if request.arrival_s is None:
            request.arrival_s = time.perf_counter()
        self.batcher.submit(request)

    @property
    def stats(self) -> Dict[str, Any]:
        """Host-side feature counters (prefix sharing, COW, speculation)."""
        s: Dict[str, Any] = {"cow_forks": self.cow_forks}
        if self.prefix_cache is not None:
            pc = self.prefix_cache
            s.update(prefix_hits=pc.hits, prefix_misses=pc.misses,
                     tokens_reused=pc.tokens_reused,
                     cached_blocks=len(pc))
        if self.config.spec_k:
            s.update(spec_ticks=self.spec_ticks,
                     accepted_total=self.accepted_total,
                     mean_accepted_len=(
                         round(self.accepted_total / self.accept_events, 4)
                         if self.accept_events else None))
        return s

    def drop_prefix_cache(self) -> None:
        """Release every prefix-cache page reference (shutdown and leak
        checks: after this, ``allocator.used`` counts live slots only)."""
        if self.prefix_cache is not None:
            self.prefix_cache.drop()

    # -- device steps -------------------------------------------------------

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _generators(self, slots: Sequence[int], tick_fold: int):
        if self.config.temperature == 0.0:
            return None
        return [slot_generator(self.config.seed, s, tick_fold, self.device)
                for s in slots]

    def _sample(self, logits: torch.Tensor, slots: Sequence[int],
                tick_fold: int) -> torch.Tensor:
        cfg = self.config
        return sample_tokens(logits, self._generators(slots, tick_fold),
                             temperature=cfg.temperature, top_k=cfg.top_k)

    def _prefill(self, slot: int, row: np.ndarray, prompt: List[int]):
        """One monolithic prefill: the prompt padded to ``prefill_len`` runs
        through the layers, its k/v rows land in the slot's pages (padding
        rows in the null page, never read), and the first token is sampled
        from the last prompt position. Returns the token on the device."""
        cfg, model = self.config, self.model
        pf, plen, blk = cfg.prefill_len, len(prompt), cfg.block_size
        tokens = np.zeros((1, pf), np.int64)
        tokens[0, :plen] = prompt
        pos = np.arange(pf)
        flat = np.where(pos < plen, row[pos // blk] * blk + pos % blk,
                        NULL_BLOCK)
        flat_t = self._to_dev(flat)
        with torch.no_grad():
            h = model.embed_at(self._to_dev(tokens), self._to_dev(pos)[None])
            h, ks, vs = model.serve_layers_prefill(h)
            # (L, 1, heads, P, d) -> (P, L, heads, d): the per-position
            # write rows; kp[:, bi, :, off] is (P, L, kh, d) (advanced
            # indices split by slices move to the front)
            ks = ks[:, 0].permute(2, 0, 1, 3)
            vs = vs[:, 0].permute(2, 0, 1, 3)
            bi, off = flat_t // blk, flat_t % blk
            self.k_pages[:, bi, :, off] = ks.to(self.k_pages.dtype)
            self.v_pages[:, bi, :, off] = vs.to(self.v_pages.dtype)
            logits = model.serve_head(h[:, plen - 1:plen])[:, 0]
            tok = self._sample(logits, [slot], 2 * self.ticks + 1)
        self.prefills += 1
        return tok[0]

    def _chunk(self, model, k_pages, v_pages, slot: int, tokens: np.ndarray,
               start: int, n_valid: int, sample: bool):
        """One prefill chunk (``_build_chunk``, ``engine.py:420-453``): the
        ``(1, C)`` tokens arrive RIGHT-ALIGNED (the ``n_valid`` real ones in
        the last columns, column ``C-1`` at position ``start + n_valid -
        1``), their k/v go through the slot's table row (padding columns to
        the null page), and attention is the K-query decode with trailing
        queries, so a prefix hit's mid-prompt start is one more chunk.
        ``sample`` also samples the first token from the last column (the
        final chunk only; mid chunks skip the LM head). Returns the token on
        the device, or None."""
        C, blk = self._chunk_width, self.config.block_size
        row = self._tables[slot]
        ci = np.arange(C)
        pos = np.clip(start + n_valid - C + ci, 0, model.cfg.max_seq_len - 1)
        write_flat = np.where(ci >= C - n_valid,
                              row[pos // blk] * blk + pos % blk, NULL_BLOCK)
        with torch.no_grad():
            pos_t = self._to_dev(pos)[None]
            h = model.embed_at(self._to_dev(tokens), pos_t)
            h, _, _ = model.serve_layers_multi(
                h, k_pages, v_pages, self._to_dev(row)[None],
                self._to_dev(write_flat)[None],
                self._to_dev(np.array([start + n_valid])), pos_t)
            if not sample:
                return None
            logits = model.serve_head(h[:, C - 1:])[:, 0]
            return self._sample(logits, [slot], 2 * self.ticks + 1)[0]

    def _decode(self):
        """One decode step for every slot (idle slots attend nothing and
        write into the null page); returns the ``(max_batch,)`` tokens on
        the device."""
        cfg, model = self.config, self.model
        blk = cfg.block_size
        B = cfg.max_batch
        pos = self._lengths  # the new token's position (cache holds [0, pos))
        blk_ids = self._tables[np.arange(B), pos // blk]
        write_flat = np.where(self._active, blk_ids * blk + pos % blk,
                              NULL_BLOCK)
        attend = np.where(self._active, pos + 1, 0)
        pos_t = self._to_dev(pos)
        with torch.no_grad():
            h = model.embed_at(self._to_dev(self._last_token)[:, None],
                               pos_t[:, None])
            h, _, _ = model.serve_layers_decode(
                h, self.k_pages, self.v_pages, self._to_dev(self._tables),
                self._to_dev(write_flat), self._to_dev(attend), pos_t)
            logits = model.serve_head(h)[:, 0]
            tok = self._sample(logits, range(B), 2 * self.ticks)
            tok = torch.where(self._to_dev(self._active), tok,
                              torch.zeros_like(tok))
        self.decode_steps += 1
        return tok

    def _spec_positions(self, n: int):
        """Positions ``lengths + j`` for ``j < n`` ``(B, n)`` and their flat
        write positions (the null page past the slot's write cap, for idle
        slots, and for table slots past the table)."""
        blk = self.config.block_size
        pos = self._lengths[:, None] + np.arange(n)[None, :]
        bi = np.clip(pos // blk, 0, self._nb_per_seq - 1)
        blk_ids = np.take_along_axis(self._tables, bi, axis=1)
        ok = self._active[:, None] & (pos < self._write_cap[:, None])
        return pos, np.where(ok, blk_ids * blk + pos % blk, NULL_BLOCK)

    def _propose(self) -> torch.Tensor:
        """K = spec_k + 1 greedy draft-decode steps (the reference's
        ``lax.scan``, ``engine.py:485-511``, as a loop): step i feeds token
        x_i at position ``lengths + i`` and writes its draft k/v, so the
        draft cache has no holes whatever the acceptance; x_0 is the pending
        token. Returns the fed tokens ``(B, K)`` on the device."""
        dm = self.draft_model
        K = self.config.spec_k + 1
        pos, write_flat = self._spec_positions(K)
        attend = np.where(self._active[:, None], pos + 1, 0)
        pos_c = self._to_dev(np.clip(pos, 0, dm.cfg.max_seq_len - 1))
        write_flat, attend = self._to_dev(write_flat), self._to_dev(attend)
        tables = self._to_dev(self._tables)
        active = self._to_dev(self._active)
        tok = self._to_dev(self._last_token)
        fed = []
        with torch.no_grad():
            for i in range(K):
                fed.append(tok)
                p = pos_c[:, i]
                h = dm.embed_at(tok[:, None], p[:, None])
                h, _, _ = dm.serve_layers_decode(
                    h, self.dk_pages, self.dv_pages, tables, write_flat[:, i],
                    attend[:, i], p)
                nxt = torch.argmax(dm.serve_head(h)[:, 0], -1)
                tok = torch.where(active, nxt, torch.zeros_like(nxt))
        return torch.stack(fed, 1)

    def _verify(self, xs: torch.Tensor) -> torch.Tensor:
        """The target over all K fed tokens in one K-query forward
        (``engine.py:513-527``): per-position greedy argmax ``(B, K)``."""
        model = self.model
        K = self.config.spec_k + 1
        pos, write_flat = self._spec_positions(K)
        attend = np.where(self._active, self._lengths + K, 0)
        pos_t = self._to_dev(np.clip(pos, 0, model.cfg.max_seq_len - 1))
        with torch.no_grad():
            h = model.embed_at(xs, pos_t)
            h, _, _ = model.serve_layers_multi(
                h, self.k_pages, self.v_pages, self._to_dev(self._tables),
                self._to_dev(write_flat), self._to_dev(attend), pos_t)
            y = torch.argmax(model.serve_head(h), -1)
            return torch.where(self._to_dev(self._active)[:, None], y,
                               torch.zeros_like(y))

    # -- pages --------------------------------------------------------------

    def _alloc_blocks(self, n: int) -> List[int]:
        """Allocate ``n`` pages, evicting least recently used prefix-cache
        entries under pool pressure (cache-held pages are opportunistic, so
        they never break the reservation invariant)."""
        try:
            return self.allocator.alloc_many(n)
        except CacheOutOfBlocks:
            if self.prefix_cache is None:
                raise
            self.prefix_cache.evict(
                max(n - self.allocator.available, _EVICT_BATCH))
            return self.allocator.alloc_many(n)

    def _cow_copy_many(self, pairs: List[Tuple[int, int]]) -> None:
        """Copy forked pages (every layer, target and draft pools): one
        indexed copy ``pool[:, dst] = pool[:, src]`` per pool."""
        src = self._to_dev(np.array([s for s, _ in pairs], np.int64))
        dst = self._to_dev(np.array([d for _, d in pairs], np.int64))
        pools = [self.k_pages, self.v_pages]
        if self.dk_pages is not None:
            pools += [self.dk_pages, self.dv_pages]
        with torch.no_grad():
            for pool in pools:
                pool[:, dst] = pool[:, src]

    def _prepare_write_range(self, slot: int, pos0: int, n: int) -> None:
        """Every position in ``[pos0, pos0 + n)`` (cut at the slot's write
        cap) gets a writable page before the step runs: a missing table
        entry allocates (cannot fail: the admission reservation covers the
        slot's lifetime), and a SHARED page (a prefix-cache entry or another
        stream holds it too) copy-on-write forks: a fresh page, the device
        copy, the table swap, and this slot's reference on the original
        dropped. No shared page is written in place."""
        blk = self.config.block_size
        end = min(pos0 + n, int(self._write_cap[slot]))
        if end <= pos0:
            return
        forks: List[Tuple[int, int]] = []
        for bi in range(pos0 // blk, (end - 1) // blk + 1):
            b = int(self._tables[slot, bi])
            if b == NULL_BLOCK:
                nb = self._alloc_blocks(1)[0]
                self._slot_blocks[slot].append(nb)
                self._tables[slot, bi] = nb
            elif self.allocator.is_shared(b):
                nb = self._alloc_blocks(1)[0]
                forks.append((b, nb))
                self._tables[slot, bi] = nb
                self._slot_blocks[slot].append(nb)
                self._slot_blocks[slot].remove(b)
                self.allocator.free([b])
                self.cow_forks += 1
        if forks:
            self._cow_copy_many(forks)

    # -- the serving loop ---------------------------------------------------

    def _seat(self, slot: int, req: Request, first: int, t: float) -> None:
        """The first token is out: the slot decodes from the next tick."""
        plen = len(req.prompt)
        req.tokens.append(first)
        req.ttft_s = (t - req.arrival_s
                      if req.arrival_s is not None else None)
        self._lengths[slot] = plen
        self._last_token[slot] = first
        self._active[slot] = True
        self._last_tok_t[slot] = t

    def _admit(self) -> None:
        """Fill free slots from the queue.

        A request enters only when its worst-case lifetime page need fits
        under the pool minus every active slot's reservation; otherwise it
        and every later placement go back to the queue head, in order, and
        wait for retirements (a seated slot without its prefill would decode
        garbage forever). With a feature armed the prefill goes through the
        chunk path from the prompt's divergence point; otherwise it is one
        monolithic prefill."""
        cfg = self.config
        placements = self.batcher.admit()
        for i, (slot, req) in enumerate(placements):
            usable = self.allocator.num_blocks - 1
            need = self._worst_case_blocks(req)
            if need > usable - self._reserved_blocks:
                for s2, r2 in reversed(placements[i:]):
                    self.batcher.slots[s2] = None
                    self.batcher.queue.appendleft(r2)
                break
            self._slot_reserved[slot] = need
            self._reserved_blocks += need
            plen = len(req.prompt)
            self._write_cap[slot] = plen + req.max_new_tokens
            if self._chunk_armed:
                self._admit_chunked(slot, req)
                continue
            blocks = self._alloc_blocks(blocks_for(plen + 1, cfg.block_size))
            self._slot_blocks[slot] = blocks
            row = np.full((self._nb_per_seq,), NULL_BLOCK, np.int32)
            row[:len(blocks)] = blocks
            self._tables[slot] = row
            tok = self._prefill(slot, row, req.prompt)
            first = int(tok.item())  # device fetch = TTFT barrier
            self._seat(slot, req, first, time.perf_counter())

    def _admit_chunked(self, slot: int, req: Request) -> None:
        """Seat a request on the chunk path (``engine.py:835-873``): the
        prefix-cache lookup first (matched pages enter the table by
        reference and their prefill is skipped), then either every chunk
        now (``prefill_chunk`` unset) or one per engine tick
        (:meth:`_chunk_tick`)."""
        plen = len(req.prompt)
        cached_blocks: List[int] = []
        n_cached = 0
        if self.prefix_cache is not None:
            cached_blocks, n_cached = self.prefix_cache.lookup(req.prompt)
            # a fully cached prompt still recomputes its LAST position (the
            # first token needs its logits); the reuse count drops it too
            clipped = min(n_cached, plen - 1)
            self.prefix_cache.tokens_reused -= n_cached - clipped
            n_cached = clipped
        req.cached_tokens = n_cached
        row = np.full((self._nb_per_seq,), NULL_BLOCK, np.int32)
        row[:len(cached_blocks)] = cached_blocks
        self._tables[slot] = row
        self._slot_blocks[slot] = list(cached_blocks)
        self._prefilling[slot] = {"req": req, "plen": plen, "pos": n_cached}
        if self.config.prefill_chunk is None:
            while slot in self._prefilling:
                self._advance_prefill(slot)

    def _advance_prefill(self, slot: int) -> None:
        """ONE chunk of the slot's prompt (target and, with speculation,
        draft pools); on the last chunk the first token is sampled, the slot
        turns active and the prompt's full blocks enter the prefix cache."""
        st = self._prefilling[slot]
        req, plen, pos = st["req"], st["plen"], st["pos"]
        C = self._chunk_width
        n = min(C, plen - pos)
        self._prepare_write_range(slot, pos, n)
        buf = np.zeros((1, C), np.int64)
        buf[0, C - n:] = req.prompt[pos:pos + n]
        final = pos + n >= plen
        tok = self._chunk(self.model, self.k_pages, self.v_pages, slot, buf,
                          pos, n, sample=final)
        self.chunks += 1
        if self.draft_model is not None:
            self._chunk(self.draft_model, self.dk_pages, self.dv_pages, slot,
                        buf, pos, n, sample=False)
        st["pos"] = pos + n
        if not final:
            return
        first = int(tok.item())  # device fetch = TTFT barrier
        del self._prefilling[slot]
        self._seat(slot, req, first, time.perf_counter())
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt, self._tables[slot])

    def _chunk_tick(self) -> None:
        """Advance ONE prefilling slot by one chunk (FIFO over seating
        order): each engine tick costs at most one chunk of prefill on top
        of the decode step."""
        if self._prefilling:
            self._advance_prefill(next(iter(self._prefilling)))

    def _finished(self, req: Request) -> bool:
        eos = self.config.eos_id
        return (len(req.tokens) >= req.max_new_tokens
                or (eos is not None and bool(req.tokens)
                    and req.tokens[-1] == eos))

    def _decoding(self) -> Dict[int, Request]:
        """Seated slots past their prefill that still owe tokens (a request
        whose last chunk gave its whole budget waits for the retire)."""
        return {s: r for s, r in self.batcher.active.items()
                if self._active[s] and not self._finished(r)}

    def _decode_tick(self) -> None:
        active = self._decoding()
        if not active:
            return
        for slot in active:
            self._prepare_write_range(slot, int(self._lengths[slot]), 1)
        toks_host = self._decode().cpu().numpy()  # fetch stops the clock
        t = time.perf_counter()
        for slot, req in active.items():
            tok = int(toks_host[slot])
            self._lengths[slot] += 1  # the fed token is now cached
            req.tokens.append(tok)
            self._last_token[slot] = tok
            if self._last_tok_t[slot] is not None:
                req.itl_s.append(t - self._last_tok_t[slot])
            self._last_tok_t[slot] = t

    def _spec_tick(self) -> None:
        """One speculative tick (``engine.py:1335-1409``): the draft
        proposes, the target verifies all K fed tokens in one K-query
        forward, and each slot commits y_0 and every further y_j whose draft
        x_j agreed with y_{j-1} (1..K tokens; EOS and the budget cut it).
        Rejected positions leave stale k/v past the committed length, which
        the lengths mask and later writes overwrite."""
        active = self._decoding()
        if not active:
            return
        K = self.config.spec_k + 1
        for slot in active:
            self._prepare_write_range(slot, int(self._lengths[slot]), K)
        xs = self._propose()
        ys = self._verify(xs)
        xs_h, ys_h = torch.stack([xs, ys]).cpu().numpy()  # fetch
        t = time.perf_counter()
        eos = self.config.eos_id
        accepted = []
        for slot, req in active.items():
            a = 1
            while a < K and xs_h[slot, a] == ys_h[slot, a - 1]:
                a += 1
            a = min(a, req.max_new_tokens - len(req.tokens))
            toks = [int(v) for v in ys_h[slot, :a]]
            if eos is not None and eos in toks:
                toks = toks[:toks.index(eos) + 1]
                a = len(toks)
            self._lengths[slot] += a
            req.tokens.extend(toks)
            self._last_token[slot] = toks[-1]
            if self._last_tok_t[slot] is not None:
                dt = t - self._last_tok_t[slot]
                req.itl_s.extend([dt / a] * a)
            self._last_tok_t[slot] = t
            accepted.append(a)
        self.accepted_total += sum(accepted)
        self.accept_events += len(accepted)
        self.spec_ticks += 1

    def _retire_finished(self, results: Dict[Any, Request],
                         now: float) -> None:
        for slot, req in list(self.batcher.active.items()):
            if not self._finished(req):
                continue
            self.batcher.retire(slot)
            # one reference per held page: fresh pages return to the pool,
            # prefix-shared ones stay pinned by their other holders
            self.allocator.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self._reserved_blocks -= self._slot_reserved[slot]
            self._slot_reserved[slot] = 0
            self._tables[slot] = NULL_BLOCK
            self._lengths[slot] = 0
            self._active[slot] = False
            self._last_token[slot] = 0
            self._last_tok_t[slot] = None
            self._write_cap[slot] = 0
            req.finished_s = now
            results[req.request_id] = req

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> Dict[Any, Request]:
        """Serve until the queue and all slots drain (``engine.py:
        1448-1465``): admit, retire, one prefill chunk, one speculative or
        decode step, retire. Returns ``{request_id: Request}`` with tokens
        and latency stamps."""
        for r in requests or ():
            self.submit(r)
        results: Dict[Any, Request] = {}
        while not self.batcher.idle:
            self._admit()
            # a 1-token request is complete straight out of prefill
            self._retire_finished(results, time.perf_counter())
            self._chunk_tick()
            if self.config.spec_k:
                self._spec_tick()
            else:
                self._decode_tick()
            self._retire_finished(results, time.perf_counter())
            self.ticks += 1
        return results
