"""apex_tpu_torch.serve against apex_tpu.serve on the CPU.

The port's Engine, on the JAX model's parameters (fp32), gives the same
greedy tokens as the JAX Engine; where the JAX top-2 logit gap is below
1e-3 (a near tie that fp32 summation order may flip), the port's token
must lie in the JAX top-2 instead, and the two streams are compared only
up to that point. Beside it: allocator and reservation invariants (every
page freed after ``run``), and top-k draws that stay in the top-k set and
reproduce from the seed.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.serve import Engine as JaxEngine
from apex_tpu.serve import Request as JaxRequest
from apex_tpu.serve import ServeConfig as JaxServeConfig
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.serve import (
    NULL_BLOCK,
    BlockAllocator,
    CacheOutOfBlocks,
    ContinuousBatcher,
    Engine,
    Request,
    ServeConfig,
    sample_tokens,
    slot_generator,
)

SMALL = dict(vocab_size=61, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_seq_len=64)
SPEC = ((5, 6), (11, 5), (3, 7), (17, 4))


def _requests(cls):
    rng = np.random.default_rng(7)
    return [cls(prompt=[int(t) for t in rng.integers(0, 61, n)],
                max_new_tokens=m, request_id=i)
            for i, (n, m) in enumerate(SPEC)]


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPTModel(JaxGPTConfig(axis=None, hidden_dropout=0.0,
                                  compute_dtype=jnp.float32, remat=False,
                                  **SMALL))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = GPTModel(GPTConfig(compute_dtype=torch.float32, **SMALL),
                  device="cpu")
    tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm


def test_greedy_tokens_match_the_jax_engine(pair):
    jm, jp, tm = pair
    geometry = dict(max_batch=2, max_seq=32, block_size=8)
    ref = JaxEngine(jm, jp, JaxServeConfig(**geometry)).run(
        _requests(JaxRequest))
    eng = Engine(tm, ServeConfig(**geometry), device="cpu")
    got = eng.run(_requests(Request))
    assert sorted(got) == sorted(ref)
    for rid, r in ref.items():
        seq = list(r.prompt) + list(r.tokens)
        logits = np.asarray(jm.apply(jp, jnp.asarray([seq], jnp.int32)))[0]
        for i, tok in enumerate(got[rid].tokens):
            row = logits[len(r.prompt) - 1 + i]
            top2 = np.argsort(row)[-2:]
            if row[top2[1]] - row[top2[0]] < 1e-3:
                assert tok in top2, (rid, i)
                break  # the streams may part at a near tie
            assert tok == r.tokens[i], (rid, i, tok, r.tokens[i])
        else:
            assert len(got[rid].tokens) == len(r.tokens)
    assert eng.prefills == len(SPEC)
    assert all(r.ttft_s is not None and r.ttft_s >= 0 for r in got.values())
    assert all(len(r.itl_s) == len(r.tokens) - 1 for r in got.values())


def test_eos_stops_a_request(pair):
    _, _, tm = pair
    geometry = dict(max_batch=2, max_seq=32, block_size=8)
    free = Engine(tm, ServeConfig(**geometry), device="cpu").run(
        _requests(Request))
    eos = free[0].tokens[2]
    cut = Engine(tm, ServeConfig(eos_id=eos, **geometry),
                 device="cpu").run(_requests(Request))
    for rid, r in free.items():
        stop = r.tokens.index(eos) + 1 if eos in r.tokens else len(r.tokens)
        assert cut[rid].tokens == r.tokens[:stop]


def test_every_page_is_freed_and_reservations_hold(pair):
    _, _, tm = pair
    # a pool that holds only one request's worst case at a time: the
    # second waits for the first to retire instead of running out
    eng = Engine(tm, ServeConfig(max_batch=2, max_seq=32, block_size=8,
                                 num_blocks=4), device="cpu")
    seen = []
    orig = eng._decode_tick

    def watched():
        assert eng._reserved_blocks <= eng.allocator.num_blocks - 1
        for slot, blocks in enumerate(eng._slot_blocks):
            assert len(blocks) <= eng._slot_reserved[slot]
        seen.append(len(eng.batcher.active))
        orig()

    eng._decode_tick = watched
    res = eng.run([Request(prompt=list(range(10)), max_new_tokens=12,
                           request_id="a"),
                   Request(prompt=list(range(20, 30)), max_new_tokens=12,
                           request_id="b")])
    assert sorted(res) == ["a", "b"]
    assert max(seen) == 1  # never seated together
    assert eng.allocator.used == 0 and eng._reserved_blocks == 0
    assert (eng._tables == NULL_BLOCK).all()
    with pytest.raises(ValueError, match="pages"):
        eng.submit(Request(prompt=list(range(20)), max_new_tokens=12))


def test_allocator_invariants():
    a = BlockAllocator(5)
    got = a.alloc_many(4)
    assert NULL_BLOCK not in got and len(set(got)) == 4
    with pytest.raises(CacheOutOfBlocks):
        a.alloc()
    a.incref(got[0])
    a.free([got[0]])
    assert a.refcount(got[0]) == 1 and a.available == 0
    a.free(got)
    assert a.available == 4 and a.used == 0
    for bad in (got[1], NULL_BLOCK, 99):
        with pytest.raises(ValueError):
            a.free([bad])


def test_batcher_fifo_and_slot_reuse():
    b = ContinuousBatcher(2)
    for r in _requests(Request):
        b.submit(r)
    assert [(s, r.request_id) for s, r in b.admit()] == [(0, 0), (1, 1)]
    b.retire(0)
    assert [(s, r.request_id) for s, r in b.admit()] == [(0, 2)]
    with pytest.raises(ValueError):
        Request(prompt=[], max_new_tokens=1)


def test_top_k_draws_stay_in_the_top_k_and_reproduce():
    logits = torch.from_numpy(
        np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32))
    cpu = torch.device("cpu")

    def draw(tick):
        gens = [slot_generator(5, s, tick, cpu) for s in range(4)]
        return sample_tokens(logits, gens, temperature=1.0, top_k=3)

    first = draw(0)
    assert torch.equal(first, draw(0))  # reproducible from (seed, slot, tick)
    top3 = torch.topk(logits, 3).indices
    for tick in range(20):
        for i, t in enumerate(draw(tick).tolist()):
            assert t in top3[i].tolist()
    assert any(not torch.equal(first, draw(t)) for t in range(1, 20))
    greedy = sample_tokens(torch.tensor([[0.1, 2.0, 2.0], [3.0, 0.0, 3.0]]))
    assert greedy.tolist() == [1, 0]  # first max, as jnp.argmax
    with pytest.raises(ValueError):
        sample_tokens(logits, temperature=1.0)


def test_sampled_engine_reproduces_from_the_seed(pair):
    _, _, tm = pair
    cfg = ServeConfig(max_batch=2, max_seq=32, block_size=8,
                      temperature=0.8, top_k=5, seed=11)
    runs = [Engine(tm, cfg, device="cpu").run(_requests(Request))
            for _ in range(2)]
    assert {k: v.tokens for k, v in runs[0].items()} == \
        {k: v.tokens for k, v in runs[1].items()}
