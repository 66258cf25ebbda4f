"""Serving engine: monolithic prefill + paged decode with continuous
batching (port of ``apex_tpu/serve/engine.py``, first slice).

A host loop over a fixed ``max_batch`` slot array: each tick admits queued
requests into free slots (one prefill each), runs one decode step for every
active slot, and retires finished requests. The KV pages live in the
layer-stacked pools of :mod:`.cache`; one block table row per slot addresses
them, and the decode step's shapes are the same every tick.

Admission is reservation-based (``engine.py:751-768``): a request is seated
only when its whole-lifetime page need (prompt + max_new_tokens) fits under
the pool minus every active slot's reservation, so growth during decode
never finds the allocator empty. TTFT and ITL are stamped on the host clock
after the device-to-host token fetch.

Not in this slice (later work): the prefix cache, chunked prefill,
speculative decoding, SLO windows, journals and tracing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.serve.cache import (
    NULL_BLOCK,
    BlockAllocator,
    KVCacheConfig,
    blocks_for,
    init_kv_cache,
)
from apex_tpu_torch.serve.sampler import sample_tokens, slot_generator
from apex_tpu_torch.serve.scheduler import ContinuousBatcher, Request


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine geometry + sampling knobs."""

    max_batch: int = 4
    max_seq: int = 128          # prompt + generation cap per request
    prefill_len: Optional[int] = None  # prompt pad length (default max_seq)
    block_size: int = 16
    num_blocks: Optional[int] = None   # default: worst-case fit + null page
    temperature: float = 0.0    # 0 = greedy
    top_k: int = 0              # 0 = full distribution
    seed: int = 0
    eos_id: Optional[int] = None

    def resolved(self) -> "ServeConfig":
        pf = min(self.prefill_len or self.max_seq, self.max_seq)
        nb = self.num_blocks
        if nb is None:
            nb = self.max_batch * blocks_for(self.max_seq,
                                             self.block_size) + 1
        return dataclasses.replace(self, prefill_len=pf, num_blocks=nb)


class Engine:
    """Paged-KV serving engine over a port ``GPTModel``.

    >>> eng = Engine(model, ServeConfig(max_batch=4, max_seq=128))
    >>> results = eng.run([Request(prompt=[1, 2, 3], max_new_tokens=16)])

    ``device`` defaults to the card and must be the model's device."""

    def __init__(self, model, config: ServeConfig,
                 device: DeviceLike = None):
        self.device = dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"on {dev}")
        model.check_servable()
        c = model.cfg
        self.model = model
        self.config = cfg = config.resolved()
        if cfg.max_seq > c.max_seq_len:
            raise ValueError(
                f"max_seq ({cfg.max_seq}) exceeds the model's max_seq_len "
                f"({c.max_seq_len})")
        self._nb_per_seq = blocks_for(cfg.max_seq, cfg.block_size)
        self.kv_config = KVCacheConfig(
            num_layers=c.num_layers, kv_heads=c.num_attention_heads,
            head_dim=c.head_dim, block_size=cfg.block_size,
            num_blocks=cfg.num_blocks, dtype=c.compute_dtype)
        self.allocator = BlockAllocator(cfg.num_blocks)
        self.batcher = ContinuousBatcher(cfg.max_batch)
        self.k_pages, self.v_pages = init_kv_cache(self.kv_config, dev)

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
        self.ticks = 0
        self.prefills = 0       # prefill launches (one per admitted request)
        self.decode_steps = 0   # decode launches (ticks with active slots)

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

    # -- device steps -------------------------------------------------------

    def _generators(self, slots: Sequence[int], tick_fold: int):
        if self.config.temperature == 0.0:
            return None
        return [slot_generator(self.config.seed, s, tick_fold, self.device)
                for s in slots]

    def _prefill(self, slot: int, row: np.ndarray, prompt: List[int]):
        """One prefill: the prompt padded to ``prefill_len`` runs through
        the layers, its k/v rows land in the slot's pages (padding rows in
        the null page, never read), and the first token is sampled from the
        last prompt position. Returns the token on the device."""
        cfg, model, dev = self.config, self.model, self.device
        pf, plen, blk = cfg.prefill_len, len(prompt), cfg.block_size
        tokens = np.zeros((1, pf), np.int64)
        tokens[0, :plen] = prompt
        pos = np.arange(pf)
        flat = np.where(pos < plen, row[pos // blk] * blk + pos % blk,
                        NULL_BLOCK)
        tok_t = torch.from_numpy(tokens).to(dev)
        pos_t = torch.from_numpy(pos).to(dev)
        flat_t = torch.from_numpy(flat).to(dev)
        with torch.no_grad():
            h = model.embed_at(tok_t, pos_t[None])
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
            gens = self._generators([slot], 2 * self.ticks + 1)
            tok = sample_tokens(logits, gens, temperature=cfg.temperature,
                                top_k=cfg.top_k)
        self.prefills += 1
        return tok[0]

    def _decode(self):
        """One decode step for every slot (idle slots attend nothing and
        write into the null page); returns the ``(max_batch,)`` tokens on
        the device."""
        cfg, model, dev = self.config, self.model, self.device
        blk = cfg.block_size
        B = cfg.max_batch
        pos = self._lengths  # the new token's position (cache holds [0, pos))
        blk_ids = self._tables[np.arange(B), pos // blk]
        write_flat = np.where(self._active, blk_ids * blk + pos % blk,
                              NULL_BLOCK).astype(np.int64)
        attend = np.where(self._active, pos + 1, 0).astype(np.int32)
        tables = torch.from_numpy(self._tables).to(dev)
        pos_t = torch.from_numpy(pos).to(dev)
        write_t = torch.from_numpy(write_flat).to(dev)
        attend_t = torch.from_numpy(attend).to(dev)
        tokens = torch.from_numpy(self._last_token).to(dev)
        with torch.no_grad():
            h = model.embed_at(tokens[:, None], pos_t[:, None])
            h, _, _ = model.serve_layers_decode(
                h, self.k_pages, self.v_pages, tables, write_t, attend_t,
                pos_t)
            logits = model.serve_head(h)[:, 0]
            gens = self._generators(range(B), 2 * self.ticks)
            tok = sample_tokens(logits, gens, temperature=cfg.temperature,
                                top_k=cfg.top_k)
            active = torch.from_numpy(self._active).to(dev)
            tok = torch.where(active, tok, torch.zeros_like(tok))
        self.decode_steps += 1
        return tok

    # -- the serving loop ---------------------------------------------------

    def _admit(self) -> None:
        """Fill free slots from the queue; one monolithic prefill each.

        A request enters only when its worst-case lifetime page need fits
        under the pool minus every active slot's reservation; otherwise it
        and every later placement go back to the queue head, in order, and
        wait for retirements (a seated slot without its prefill would decode
        garbage forever)."""
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
            blocks = self.allocator.alloc_many(
                blocks_for(plen + 1, cfg.block_size))
            self._slot_blocks[slot] = blocks
            row = np.full((self._nb_per_seq,), NULL_BLOCK, np.int32)
            row[:len(blocks)] = blocks
            self._tables[slot] = row
            tok = self._prefill(slot, row, req.prompt)
            first = int(tok.item())  # device fetch = TTFT barrier
            t = time.perf_counter()
            req.tokens.append(first)
            req.ttft_s = (t - req.arrival_s
                          if req.arrival_s is not None else None)
            self._lengths[slot] = plen
            self._last_token[slot] = first
            self._active[slot] = True
            self._last_tok_t[slot] = t

    def _ensure_page(self, slot: int) -> None:
        """The next write position gets a page. Cannot fail: the admission
        reservation covers the slot's whole lifetime."""
        bi = int(self._lengths[slot]) // self.config.block_size
        if self._tables[slot, bi] == NULL_BLOCK:
            b = self.allocator.alloc()
            self._slot_blocks[slot].append(b)
            self._tables[slot, bi] = b

    def _finished(self, req: Request) -> bool:
        eos = self.config.eos_id
        return (len(req.tokens) >= req.max_new_tokens
                or (eos is not None and bool(req.tokens)
                    and req.tokens[-1] == eos))

    def _decoding(self) -> Dict[int, Request]:
        return {s: r for s, r in self.batcher.active.items()
                if self._active[s] and not self._finished(r)}

    def _decode_tick(self) -> None:
        active = self._decoding()
        if not active:
            return
        for slot in active:
            self._ensure_page(slot)
        toks = self._decode()
        toks_host = toks.cpu().numpy()  # device fetch stops the clock
        t = time.perf_counter()
        for slot, req in active.items():
            tok = int(toks_host[slot])
            self._lengths[slot] += 1  # the fed token is now cached
            req.tokens.append(tok)
            self._last_token[slot] = tok
            if self._last_tok_t[slot] is not None:
                req.itl_s.append(t - self._last_tok_t[slot])
            self._last_tok_t[slot] = t

    def _retire_finished(self, results: Dict[Any, Request],
                         now: float) -> None:
        for slot, req in list(self.batcher.active.items()):
            if not self._finished(req):
                continue
            self.batcher.retire(slot)
            self.allocator.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self._reserved_blocks -= self._slot_reserved[slot]
            self._slot_reserved[slot] = 0
            self._tables[slot] = NULL_BLOCK
            self._lengths[slot] = 0
            self._active[slot] = False
            self._last_token[slot] = 0
            self._last_tok_t[slot] = None
            req.finished_s = now
            results[req.request_id] = req

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> Dict[Any, Request]:
        """Serve until the queue and all slots drain. Returns
        ``{request_id: Request}`` with tokens and latency stamps."""
        for r in requests or ():
            self.submit(r)
        results: Dict[Any, Request] = {}
        while not self.batcher.idle:
            self._admit()
            # a 1-token request is complete straight out of prefill
            self._retire_finished(results, time.perf_counter())
            self._decode_tick()
            self._retire_finished(results, time.perf_counter())
            self.ticks += 1
        return results
