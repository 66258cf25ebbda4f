"""Continuous batching: a FIFO request queue over a fixed slot array
(port of ``apex_tpu/serve/scheduler.py``; pure host-side bookkeeping).

Requests queue, free decode slots admit the queue head each tick, finished
requests retire and their slot is immediately reusable.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request plus its lifecycle record."""

    prompt: List[int]
    max_new_tokens: int
    request_id: Any = None
    arrival_s: Optional[float] = None  # host clock; engine stamps if None
    # -- filled in by the engine --------------------------------------------
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    itl_s: List[float] = dataclasses.field(default_factory=list)
    finished_s: Optional[float] = None
    # prompt tokens whose k/v came from the prefix cache (prefill skipped
    # to the divergence point; 0 = no hit or no cache)
    cached_tokens: int = 0

    def __post_init__(self):
        if self.request_id is None:
            self.request_id = next(_ids)
        self.prompt = [int(t) for t in self.prompt]
        if not self.prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


class ContinuousBatcher:
    """Slot occupancy + FIFO admission."""

    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = int(max_slots)
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * self.max_slots

    def submit(self, request: Request) -> None:
        self.queue.append(request)

    @property
    def active(self) -> Dict[int, Request]:
        return {i: r for i, r in enumerate(self.slots) if r is not None}

    def admit(self) -> List[Tuple[int, Request]]:
        """Place queued requests into free slots, FIFO, lowest slot first."""
        placed = []
        for i in range(self.max_slots):
            if not self.queue:
                break
            if self.slots[i] is None:
                req = self.queue.popleft()
                self.slots[i] = req
                placed.append((i, req))
        return placed

    def retire(self, slot: int) -> Request:
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not occupied")
        self.slots[slot] = None
        return req

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slots)
