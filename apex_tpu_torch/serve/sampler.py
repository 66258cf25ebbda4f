"""Token sampling for the decode step: greedy, temperature, top-k
(port of ``apex_tpu/serve/sampler.py``).

Greedy is ``argmax``, which takes the FIRST maximum as ``jnp.argmax`` does.
Temperature/top-k draws use one ``torch.Generator`` per slot, seeded from
``(seed, slot)`` with the engine tick folded in, so a tick's randomness is
independent per request and reproducible per (seed, slot, tick). JAX's
random bits cannot be reproduced, so only the distribution matches.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def slot_generator(seed: int, slot: int, tick: int,
                   device: torch.device) -> torch.Generator:
    """The generator of one slot at one tick: ``(seed, slot, tick)`` mixed
    through numpy's SeedSequence into a 63-bit torch seed."""
    state = np.random.SeedSequence([int(seed), int(slot), int(tick)])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0]) >> 1)
    return g


def sample_tokens(logits: torch.Tensor,
                  generators: Optional[Sequence[torch.Generator]] = None, *,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Next-token ids ``(b,)`` int32 from ``logits`` ``(b, vocab)``.

    ``temperature == 0`` is greedy argmax and uses no randomness. Otherwise
    ``generators`` (one per row) drive a categorical draw over
    ``logits / temperature``, truncated to the ``top_k`` highest logits when
    ``top_k > 0``."""
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generators is None or len(generators) != logits.shape[0]:
        raise ValueError("temperature > 0 needs one generator per row")
    scaled = logits.float() / float(temperature)
    if top_k:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(scaled, k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    draws = [torch.multinomial(probs[i], 1, generator=g)
             for i, g in enumerate(generators)]
    return torch.cat(draws).to(torch.int32)
