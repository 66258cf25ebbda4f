"""Prefix sharing, chunked prefill and speculative decoding of
apex_tpu_torch.serve against apex_tpu.serve on the CPU.

On the JAX model's parameters (fp32) the port's chunked, prefix-cached and
speculative engines give the JAX engines' greedy tokens; where the
full-context top-2 logit gap is below 1e-3 (a near tie that fp32 summation
order may flip) the port's token must lie in the top 2 instead, and the
streams are compared only up to there. ``serve_layers_multi`` matches the
JAX one in h and in the pools it writes. Beside them: the prefix cache's
lookup/insert/evict and the allocator's refcounts, interleaving of chunks
with decode, prefix hits to the divergence point, copy-on-write isolation,
speculative exactness with a self-draft and a 1-layer draft (window None
and 8), the greedy-only rule, the one-token budget through every path and
eviction under pool pressure, each ending with no page leaked.
"""

import dataclasses

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
    Engine,
    PrefixCache,
    Request,
    ServeConfig,
)

SMALL = dict(vocab_size=61, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_seq_len=64)
GEOMETRY = dict(max_batch=2, max_seq=48, block_size=8)
SPEC = ((5, 6), (11, 5), (3, 7), (17, 4))


def _requests(cls, spec=SPEC):
    rng = np.random.default_rng(7)
    return [cls(prompt=[int(t) for t in rng.integers(0, 61, n)],
                max_new_tokens=m, request_id=i)
            for i, (n, m) in enumerate(spec)]


def _prefix_requests(cls):
    """Four prompts on one 12-token prefix: full-block hits, a hit that
    ends mid-block (the copy-on-write case) and a prompt that is the prefix
    itself."""
    rng = np.random.default_rng(5)
    base = [int(t) for t in rng.integers(0, 61, 12)]
    tails = ([1, 2, 3, 4, 5], [4, 5], [], [9, 9, 9, 9, 9, 9])
    return [cls(prompt=base + t, max_new_tokens=5 + i % 2, request_id=i)
            for i, t in enumerate(tails)]


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


@pytest.fixture(scope="module")
def jax_runs(pair):
    """The JAX engines' results, each engine built once: chunked prefill,
    and prefix cache + speculative decoding with the self-draft."""
    jm, jp, _ = pair
    chunked = JaxEngine(jm, jp, JaxServeConfig(prefill_chunk=4, **GEOMETRY))
    spec = JaxEngine(jm, jp, JaxServeConfig(prefix_cache=True, spec_k=2,
                                            **GEOMETRY))
    return {"chunked": chunked.run(_requests(JaxRequest)),
            "spec": spec.run(_prefix_requests(JaxRequest)),
            "spec_stats": spec.stats}


def _full_logits(tm, seq):
    return tm.apply(torch.tensor([seq]))[0].float().numpy()


def _assert_same_tokens(got, ref, tm):
    """``got`` gives ``ref``'s tokens under the top-2-gap rule, judged by
    the full-context forward over ``ref``'s sequence."""
    assert sorted(got) == sorted(ref)
    for rid, r in ref.items():
        seq = list(r.prompt) + list(r.tokens)
        logits = _full_logits(tm, seq)
        for i, tok in enumerate(got[rid].tokens):
            row = logits[len(r.prompt) - 1 + i]
            top2 = np.argsort(row)[-2:]
            if row[top2[1]] - row[top2[0]] < 1e-3:
                assert tok in top2, (rid, i)
                break  # the streams may part at a near tie
            assert tok == r.tokens[i], (rid, i, tok, r.tokens[i])
        else:
            assert len(got[rid].tokens) == len(r.tokens)


def _assert_greedy_matches_oracle(tm, results):
    """Every generated token is the argmax of one full-context forward over
    the finished sequence, up to the first near tie (top-2 gap < 1e-3)."""
    for req in results.values():
        seq = list(req.prompt) + req.tokens
        logits = _full_logits(tm, seq)
        for t in range(len(req.prompt), len(seq)):
            row = logits[t - 1]
            top2 = np.argsort(row)[-2:]
            if row[top2[1]] - row[top2[0]] < 1e-3:
                assert seq[t] in top2, (req.request_id, t)
                break
            assert int(top2[1]) == seq[t], (req.request_id, t)


def _drained(eng):
    eng.drop_prefix_cache()
    return (eng.allocator.used == 0 and eng.batcher.idle
            and eng._reserved_blocks == 0
            and (eng._tables == NULL_BLOCK).all())


# ---------------------------------------------------------------------------
# host side: refcounts and the prefix cache
# ---------------------------------------------------------------------------


def test_refcounts_share_and_release():
    a = BlockAllocator(6)
    b = a.alloc()
    assert a.refcount(b) == 1 and not a.is_shared(b)
    a.incref(b)
    assert a.is_shared(b)
    a.free([b])  # one holder left: the page stays out of the pool
    assert a.refcount(b) == 1 and a.available == 4
    a.free([b])
    assert a.available == 5
    with pytest.raises(ValueError, match="double free"):
        a.free([b])
    with pytest.raises(ValueError):
        a.incref(b)
    with pytest.raises(ValueError):
        a.incref(NULL_BLOCK)


def test_prefix_cache_full_and_partial_lookup():
    a = BlockAllocator(16)
    pc = PrefixCache(a, block_size=4)
    prompt = list(range(10))  # 2 full blocks + a ragged tail
    blocks = a.alloc_many(3)
    assert pc.insert(prompt, blocks) == 2  # full blocks only
    assert all(a.refcount(b) == 2 for b in blocks[:2])
    assert a.refcount(blocks[2]) == 1
    got, n = pc.lookup(list(range(8)) + [99, 98])
    assert n == 8 and got == blocks[:2]
    assert all(a.refcount(b) == 3 for b in blocks[:2])
    a.free(got)
    # a partial match inside the second block: the copy-on-write case
    got, n = pc.lookup([0, 1, 2, 3, 4, 5, 77])
    assert n == 6 and got == blocks[:2]
    a.free(got)
    got, n = pc.lookup([9, 9, 9, 9])
    assert n == 0 and got == []
    assert (pc.hits, pc.misses, pc.tokens_reused) == (2, 1, 14)
    assert pc.insert(prompt, blocks) == 0  # no second reference
    assert len(pc) == 2


def test_prefix_cache_eviction_is_leaf_first_and_drop_releases():
    a = BlockAllocator(16)
    pc = PrefixCache(a, block_size=4)
    blocks = a.alloc_many(3)
    pc.insert(list(range(12)), blocks)
    a.free(blocks)  # the cache is the only holder now
    assert a.used == 3
    assert pc.evict(1) == 1  # the deepest entry, never a parent
    got, n = pc.lookup(list(range(12)))
    assert n == 8 and got == blocks[:2]
    assert pc.evict(5) == 0  # a live holder pins the chain
    a.free(got)
    pc.drop()
    assert a.used == 0 and len(pc) == 0


def test_randomized_admit_retire_leaks_no_page(pair):
    """Random churn over the allocator's alloc/incref/free, then a
    randomized engine run whose prompts share prefixes (prefix cache,
    chunks and speculation all on): every page comes back."""
    rng = np.random.default_rng(0)
    a = BlockAllocator(17)
    held = []
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0 and a.available:
            held.append(a.alloc())
        elif op == 1 and held:
            held.append(a.incref(int(rng.choice(held))))
        elif op == 2 and held:
            a.free([held.pop(int(rng.integers(0, len(held))))])
    a.free(held)
    assert a.available == 16 and a.used == 0

    _, _, tm = pair
    heads = [[int(t) for t in rng.integers(0, 61, 10)] for _ in range(2)]
    reqs = [Request(prompt=heads[int(rng.integers(0, 2))][:int(n)]
                    + [int(t) for t in rng.integers(0, 61, int(m))],
                    max_new_tokens=int(rng.integers(1, 6)), request_id=i)
            for i, (n, m) in enumerate(rng.integers(1, 11, (8, 2)))]
    eng = Engine(tm, ServeConfig(max_batch=3, max_seq=32, block_size=4,
                                 num_blocks=18, prefix_cache=True,
                                 prefill_chunk=5, spec_k=2), device="cpu")
    res = eng.run(reqs)
    assert len(res) == 8 and eng.stats["prefix_hits"] > 0
    _assert_greedy_matches_oracle(tm, res)
    assert _drained(eng)


# ---------------------------------------------------------------------------
# the model's K-query drive
# ---------------------------------------------------------------------------


def test_serve_layers_multi_matches_jax(pair):
    """h and both pools after one K-query drive, against the JAX
    ``serve_layers_multi`` on the same inputs (one masked column writes to
    the null page; the port updates the pools in place)."""
    jm, jp, tm = pair
    rng = np.random.default_rng(3)
    L, nb, kh, blk, d = 2, 9, 4, 8, 8
    b, K = 2, 3
    h = rng.normal(size=(b, K, 32)).astype(np.float32)
    kp = rng.normal(size=(L, nb, kh, blk, d)).astype(np.float32)
    vp = rng.normal(size=(L, nb, kh, blk, d)).astype(np.float32)
    tables = np.array([[3, 5, 0], [7, 2, 0]], np.int32)
    lengths = np.array([11, 14], np.int32)  # last query's keys per slot
    pos = lengths[:, None] - K + np.arange(K)[None, :]
    write = tables[np.arange(b)[:, None], pos // blk] * blk + pos % blk
    write[1, 0] = NULL_BLOCK  # a masked column
    ref_h, ref_k, ref_v = jm.serve_layers_multi(
        jp["layers"], jnp.asarray(h), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(write), jnp.asarray(lengths),
        jnp.asarray(pos, jnp.int32))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got_h, got_k, got_v = tm.serve_layers_multi(
        torch.from_numpy(h), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(write), torch.from_numpy(lengths),
        torch.from_numpy(pos))
    assert got_k is tk and got_v is tv  # in place
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=1e-5)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(ref_k), atol=1e-5)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=1e-5)
    assert not np.allclose(got_k.numpy(), kp)  # the drive wrote the pools


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


def test_chunked_prefill_matches_monolithic_and_jax(pair, jax_runs):
    _, _, tm = pair
    mono = Engine(tm, ServeConfig(**GEOMETRY), device="cpu").run(
        _requests(Request))
    eng = Engine(tm, ServeConfig(prefill_chunk=4, **GEOMETRY), device="cpu")
    res = eng.run(_requests(Request))
    _assert_same_tokens(res, jax_runs["chunked"], tm)
    _assert_same_tokens(res, mono, tm)
    # 4-token chunks: ceil(plen / 4) launches per prompt, no monolithic one
    assert eng.chunks == sum(-(-n // 4) for n, _ in SPEC)
    assert eng.prefills == 0
    assert _drained(eng)


def test_chunked_prefill_interleaves_with_decode(pair):
    """A long prompt seated beside a short one does not stall it: the short
    stream's tokens keep arriving while the long prompt's chunks run."""
    _, _, tm = pair
    eng = Engine(tm, ServeConfig(prefill_chunk=4, **GEOMETRY), device="cpu")
    rng = np.random.default_rng(3)
    short = Request(prompt=[int(t) for t in rng.integers(0, 61, 4)],
                    max_new_tokens=12, request_id="short")
    long_p = Request(prompt=[int(t) for t in rng.integers(0, 61, 30)],
                     max_new_tokens=4, request_id="long")
    seen = []
    orig = eng._decode_tick

    def watched():
        seen.append((len(short.tokens), bool(eng._prefilling)))
        orig()

    eng._decode_tick = watched
    res = eng.run([short, long_p])
    _assert_greedy_matches_oracle(tm, res)
    progressed = [n for n, prefilling in seen if prefilling]
    assert len(progressed) >= 6 and progressed[-1] > progressed[0], seen
    assert _drained(eng)


def test_prefix_sharing_skips_to_the_divergence_point(pair):
    _, _, tm = pair
    eng = Engine(tm, ServeConfig(prefix_cache=True, **GEOMETRY),
                 device="cpu")
    rng = np.random.default_rng(5)
    base = [int(t) for t in rng.integers(0, 61, 16)]
    res = eng.run([Request(prompt=base + [1, 2, 3], max_new_tokens=5,
                           request_id="a"),
                   Request(prompt=base + [4, 5], max_new_tokens=5,
                           request_id="b")])
    _assert_greedy_matches_oracle(tm, res)
    assert res["a"].cached_tokens == 0
    assert res["b"].cached_tokens == 16
    s = eng.stats
    assert (s["prefix_hits"], s["prefix_misses"], s["tokens_reused"]) \
        == (1, 1, 16)
    assert eng.allocator.used > 0  # the cache keeps the prompt blocks
    assert _drained(eng)


def test_cow_isolates_diverging_streams(pair):
    """Divergence inside a cached block forks it: a request diverging
    mid-block and one that recomputes a fully cached prompt's last
    position both fork, so a stream sharing those pages emits exactly its
    solo tokens."""
    _, _, tm = pair
    eng = Engine(tm, ServeConfig(max_batch=3, max_seq=48, block_size=8,
                                 prefix_cache=True), device="cpu")
    rng = np.random.default_rng(11)
    A = [int(t) for t in rng.integers(0, 61, 16)]
    solo = eng.run([Request(prompt=A, max_new_tokens=8, request_id="A")])
    res = eng.run([
        Request(prompt=A, max_new_tokens=8, request_id="A2"),
        Request(prompt=A[:12] + [7, 9], max_new_tokens=6, request_id="B"),
        Request(prompt=A, max_new_tokens=6, request_id="C"),
    ])
    _assert_greedy_matches_oracle(tm, res)
    assert res["A2"].tokens == solo["A"].tokens  # never perturbed
    assert res["B"].cached_tokens == 12
    assert res["A2"].cached_tokens == res["C"].cached_tokens == 15
    assert eng.cow_forks >= 2, eng.cow_forks
    assert _drained(eng)


def test_speculative_prefix_engine_matches_jax(pair, jax_runs):
    """Prefix cache + speculation (self-draft) against the JAX engine with
    the same knobs on shared-prefix prompts: the same tokens, the same
    prefix hits, the whole k + 1 accepted by a perfect draft."""
    _, _, tm = pair
    eng = Engine(tm, ServeConfig(prefix_cache=True, spec_k=2, **GEOMETRY),
                 device="cpu")
    res = eng.run(_prefix_requests(Request))
    _assert_same_tokens(res, jax_runs["spec"], tm)
    ref = jax_runs["spec_stats"]
    s = eng.stats
    for key in ("prefix_hits", "prefix_misses", "tokens_reused",
                "cow_forks"):
        assert s[key] == ref[key], (key, s, ref)
    assert s["prefix_hits"] == 3 and s["mean_accepted_len"] > 2.0, s
    assert [r.cached_tokens for r in res.values()] == [0, 12, 11, 12]
    assert _drained(eng)


@pytest.mark.parametrize("window", [None, 8])
def test_speculative_greedy_is_exact(window):
    """Greedy speculative output equals the non-speculative engine's and the
    full-context argmax, with and without the window, for a perfect
    (self) draft and a disagreeing 1-layer draft."""
    cfg = GPTConfig(compute_dtype=torch.float32, attention_window=window,
                    **SMALL)
    tm = GPTModel(cfg, device="cpu", seed=0)
    scfg = ServeConfig(**GEOMETRY)
    base = Engine(tm, scfg, device="cpu").run(_requests(Request))
    spec = Engine(tm, dataclasses.replace(scfg, spec_k=3), device="cpu")
    res = spec.run(_requests(Request))
    _assert_greedy_matches_oracle(tm, res)
    _assert_same_tokens(res, base, tm)
    assert spec.stats["mean_accepted_len"] > 1.5, spec.stats
    draft = GPTModel(dataclasses.replace(cfg, num_layers=1), device="cpu",
                     seed=9)
    spec2 = Engine(tm, dataclasses.replace(scfg, spec_k=2), device="cpu",
                   draft_model=draft)
    res2 = spec2.run(_requests(Request))
    _assert_same_tokens(res2, base, tm)
    assert spec2.dk_pages.shape[0] == 1  # the draft's own pool geometry
    assert _drained(spec) and _drained(spec2)


def test_spec_requires_greedy(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="temperature"):
        Engine(tm, ServeConfig(spec_k=2, temperature=0.7), device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        ServeConfig(spec_k=1, temperature=1.0).resolved()


def test_one_token_budget_through_every_path(pair):
    """A max_new_tokens=1 request completes straight out of its last chunk
    and is never decoded past its budget, with every feature on."""
    _, _, tm = pair
    eng = Engine(tm, ServeConfig(prefix_cache=True, prefill_chunk=4,
                                 spec_k=2, **GEOMETRY), device="cpu")
    res = eng.run([Request(prompt=list(range(9)), max_new_tokens=1,
                           request_id="one"),
                   Request(prompt=[2, 7], max_new_tokens=4,
                           request_id="more")])
    assert len(res["one"].tokens) == 1
    assert len(res["more"].tokens) == 4
    _assert_greedy_matches_oracle(tm, res)
    assert _drained(eng)


def test_pool_pressure_evicts_the_cache_not_correctness(pair):
    """A pool where the second request fits only by reclaiming cache-held
    pages: allocation evicts and goes on, and the tokens stay exact."""
    _, _, tm = pair
    eng = Engine(tm, ServeConfig(max_batch=1, max_seq=32, block_size=8,
                                 num_blocks=5, prefix_cache=True),
                 device="cpu")
    r1 = eng.run([Request(prompt=list(range(9)), max_new_tokens=4,
                          request_id="a")])
    assert eng.allocator.used > 0  # the cache keeps the prompt block
    r2 = eng.run([Request(prompt=list(range(40, 57)), max_new_tokens=9,
                          request_id="b")])  # writes into all 4 pages
    _assert_greedy_matches_oracle(tm, {**r1, **r2})
    # "a"'s block was evicted to make room; "b"'s two full blocks stay
    assert len(eng.prefix_cache) == 2 and eng.stats["prefix_hits"] == 0
    assert _drained(eng)
