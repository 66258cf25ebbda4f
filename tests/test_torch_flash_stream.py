"""apex_tpu_torch's streamed flash attention against the JAX package's
streamed Pallas kernels on the CPU.

``flash_attention(stream="always")`` on CPU tensors runs the plain versions
of the three streamed kernels (per-split partials and the lse merge, the
split-wise dQ sums, the q-split dK/dV sums) through ``FlashAttention``; the
JAX side runs ``flash_attention(stream="always", impl="pallas")`` with
64-row blocks, whose ``_fwd_kernel_stream`` / ``_bwd_dq_kernel_stream`` /
``_bwd_dkv_kernel_stream`` run in Pallas interpret mode here (as
``tests/test_flash_attention.py`` runs them). The split length is cut to
one or two 64-key tiles so that rows span several splits and the merge
runs; the backward's own tiles (``BWD_OUTER_TILE`` / ``BWD_INNER_TILE`` /
``BWD_SPLIT_TILES``, 128 / 64 / 128 on the card) are cut alike, with unequal
outer and inner tiles. fp32: values within 1e-5, q/k/v grads within 1e-4
(the same fp32 math summed in another order). The CUDA kernels are held
against the same plain versions by ``chip_smoke.py``.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.ops.flash_attention import flash_attention as jax_flash
from apex_tpu.ops.flash_attention import mha_reference as jax_mha

# the package re-exports a function named like this module
tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

VAL_TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(seed, sq=256, sk=256, b=1, h=2, d=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for s in (sq, sk, sk))
    g = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    return q, k, v, g


def _jax(q, k, v, g, **kw):
    kw = dict(kw, impl="pallas", stream="always", block_q=64, block_k=64)
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    out = jax_flash(*args, **kw)
    grads = jax.grad(lambda *a: jnp.sum(jax_flash(*a, **kw) * g),
                     argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _torch(q, k, v, g, **kw):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, stream="always", **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def _compare(q, k, v, g, **kw):
    out, grads = _torch(q, k, v, g, **kw)
    jout, jgrads = _jax(q, k, v, g, **kw)
    np.testing.assert_allclose(out, jout, atol=VAL_TOL)
    for name, a, r in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a, r, atol=GRAD_TOL, err_msg=f"d{name}")
    return out, grads


def _small_bwd_tiles(monkeypatch, split_tiles):
    """The backward's tiles cut to 64-row outer and 32-row inner tiles."""
    monkeypatch.setattr(tfa, "BWD_OUTER_TILE", 64)
    monkeypatch.setattr(tfa, "BWD_INNER_TILE", 32)
    monkeypatch.setattr(tfa, "BWD_SPLIT_TILES", split_tiles)


@pytest.mark.parametrize("split_tiles", [1, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_streamed_matches_jax_streamed_kernels(monkeypatch, causal,
                                               split_tiles):
    monkeypatch.setattr(tfa, "STREAM_SPLIT_TILES", split_tiles)
    _small_bwd_tiles(monkeypatch, split_tiles)
    _, most = tfa._stream_bands(256, 256, causal, None, True)
    assert most == 4 // split_tiles  # the last rows span several splits
    for inner_is_k in (True, False):
        _, most = tfa._bwd_bands(256, 256, causal, None, inner_is_k)
        assert most == 8 // split_tiles
    _compare(*_inputs(5), causal=causal)


@pytest.mark.parametrize("causal", [False, True])
def test_window_matches_jax_streamed_kernels(monkeypatch, causal):
    monkeypatch.setattr(tfa, "STREAM_SPLIT_TILES", 1)
    _compare(*_inputs(22), causal=causal, window=48)


@pytest.mark.parametrize("causal", [False, True])
def test_band_restricted_window(monkeypatch, causal):
    """sq = 512, window 16: each tile's band is 2-3 tiles of 8, so most
    tiles are never visited (the _window_grid case of the JAX tests)."""
    monkeypatch.setattr(tfa, "STREAM_SPLIT_TILES", 1)
    bands, most = tfa._stream_bands(512, 512, causal, 16, True)
    assert most == (2 if causal else 3)
    assert sum(len(b) for b in bands) < 8 * 8 // 2
    _compare(*_inputs(28, sq=512, sk=512), causal=causal, window=16)


def test_cross_shape_window_fully_masked_rows_are_zero(monkeypatch):
    """sq != sk: queries past sk + window - 1 see no key; their outputs and
    their dq are exactly 0, as in the JAX kernels."""
    monkeypatch.setattr(tfa, "STREAM_SPLIT_TILES", 1)
    out, grads = _compare(*_inputs(3, sq=320, sk=128), causal=True,
                          window=40)
    dead = slice(128 + 40 - 1, None)
    assert np.all(out[:, :, dead] == 0.0) and np.all(grads[0][:, :, dead]
                                                      == 0.0)
    assert np.any(out[:, :, :dead.start] != 0.0)


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("causal", [False, True])
def test_merge_matches_the_dense_plain_version(monkeypatch, causal, window):
    """The per-split partials and their lse merge give the dense softmax:
    o and lse against mha_reference and the dense logsumexp, at split
    lengths 1 and 16 (one split a row), on a ragged cross shape."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(9, sq=200, sk=150))
    ref = tfa.mha_reference(q, k, v, causal=causal, window=window)
    lse = tfa._lse_reference(q, k, causal, 0.25, window)
    for split in (1, 16):
        monkeypatch.setattr(tfa, "STREAM_SPLIT_TILES", split)
        o, l = tfa.flash_attention_fwd_stream_reference(
            q, k, v, causal=causal, window=window)
        np.testing.assert_allclose(o.numpy(), ref.numpy(), atol=VAL_TOL)
        live = lse > tfa.NEG_INF / 2
        np.testing.assert_allclose(l[live].numpy(), lse[live].numpy(),
                                   atol=VAL_TOL)
        assert torch.all(l[~live] == tfa.NEG_INF)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_takes_the_window(causal):
    """flash_attention_bwd_reference (the plain version of the resident
    backward kernels) and _lse_reference take the window: grads against
    jax.grad of the JAX mha_reference with the same window."""
    q, k, v, g = _inputs(11, sq=96, sk=96)
    w, scale = 20, 0.25
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o = tfa.mha_reference(tq, tk, tv, causal=causal, window=w)
    lse = tfa._lse_reference(tq, tk, causal, scale, w)
    got = tfa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tg,
                                            causal=causal, scale=scale,
                                            window=w)
    want = jax.grad(lambda *a: jnp.sum(jax_mha(
        *a, causal=causal, window=w) * g), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=GRAD_TOL)


def test_window_band_ranges_match_the_reference_helpers():
    from apex_tpu.ops.flash_attention import _window_k_range as jk
    from apex_tpu.ops.flash_attention import _window_q_range as jq

    t = tfa.STREAM_TILE
    for causal in (False, True):
        for window in (1, 16, 48, 100):
            for i in range(10):
                lo, hi = jk(0, 10, i, t, t, 0, 0, causal, window)
                if causal:
                    hi = min(hi, i + 1)
                want = (max(int(lo), 0), int(hi))
                assert tfa._window_k_range(i, 10, causal, window) == want
                lo, hi = jq(min(i, 10) if causal else 0, 10, i, t, t, 0, 0,
                            causal, window)
                assert tfa._window_q_range(i, 10, causal, window) == (
                    max(int(lo), 0), int(hi))


@pytest.mark.parametrize("window", [None, 1, 16, 48, 100, 300])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("blk_q,blk_k", [(64, 128), (128, 64)])
def test_unequal_tile_bands_match_the_reference_helpers(blk_q, blk_k,
                                                        causal, window):
    """The band helpers with blk_q != blk_k (the backward's 128-row outer
    and 64-row inner tiles) against the JAX package's, plus the causal
    limit, which the JAX kernels apply in their loop bounds."""
    from apex_tpu.ops.flash_attention import _window_k_range as jk
    from apex_tpu.ops.flash_attention import _window_q_range as jq

    nq, nk = 24 * 64 // blk_q, 24 * 64 // blk_k
    for i in range(nq):
        lo, hi = jk(0, nk, i, blk_q, blk_k, 0, 0, causal, window)
        if causal:
            hi = min(int(hi), -(-(i + 1) * blk_q // blk_k))
        assert tfa._window_k_range(i, nk, causal, window, blk_q, blk_k) == (
            max(int(lo), 0), int(hi))
    for i in range(nk):
        lo0 = min(i * blk_k // blk_q, nq) if causal else 0
        lo, hi = jq(lo0, nq, i, blk_q, blk_k, 0, 0, causal, window)
        assert tfa._window_q_range(i, nq, causal, window, blk_q, blk_k) == (
            max(int(lo), 0), int(hi))


@pytest.mark.parametrize("inner_is_k", [True, False])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (8192, 8192, True, None), (16384, 16384, True, 4096),
    (1100, 990, True, None), (300, 77, True, 16), (1000, 1000, False, 200)])
def test_bwd_splits_cover_every_band_once(sq, sk, causal, window,
                                          inner_is_k):
    """At the backward's own tiles (BWD_*), each outer tile's splits cut its
    band into contiguous pieces of at most BWD_SPLIT_TILES inner tiles, and
    the band holds every inner tile with a visible pair."""
    o, i = tfa.BWD_OUTER_TILE, tfa.BWD_INNER_TILE
    assert (o, i) == (128, 64)
    bands, most = tfa._bwd_bands(sq, sk, causal, window, inner_is_k)
    s_out, s_in = (sq, sk) if inner_is_k else (sk, sq)
    assert len(bands) == -(-s_out // o)
    pos = np.arange(max(sq, sk))
    for t, splits in enumerate(bands):
        assert len(splits) <= most
        rows = pos[t * o:min(s_out, (t + 1) * o)]
        cols = pos[:s_in]
        qq, kk = ((rows[:, None], cols[None, :]) if inner_is_k
                  else (cols[None, :], rows[:, None]))
        vis = np.ones(np.broadcast_shapes(qq.shape, kk.shape), bool)
        if causal:
            vis &= kk <= qq
        if window is not None:
            vis &= qq - kk < window
            if not causal:
                vis &= kk - qq < window
        hit = np.nonzero(vis.any(axis=0))[0] // i  # inner tiles with a pair
        if not splits:
            assert hit.size == 0
            continue
        assert all(a < b <= a + tfa.BWD_SPLIT_TILES for a, b in splits)
        assert all(p[1] == n[0] for p, n in zip(splits, splits[1:]))
        if hit.size:  # the floor-division band may hold only empty tiles
            assert splits[0][0] <= hit.min() and hit.max() < splits[-1][1]


def test_tma_operands_pass_what_tma_reads_and_copy_the_rest():
    """_tma_ok / _tma_operands: the fused-QKV views (strides of 1536 and
    384 bytes in bf16) go in as they are; 72-byte rows (d = 36), rows 136
    bytes apart and a base 2 bytes off are refused, and come back as
    contiguous copies with d padded to a multiple of 8."""
    qkv = torch.zeros(1, 64, 4, 3, 64, dtype=torch.bfloat16).permute(
        0, 2, 3, 1, 4)
    views = [qkv[:, :, j] for j in (0, 1, 2, 0)]
    got, d = tfa._tma_operands(views)
    assert d == 64 and all(a is b for a, b in zip(got, views))
    narrow = torch.zeros(1, 2, 64, 36, dtype=torch.bfloat16)
    wide = torch.zeros(1, 2, 64, 68, dtype=torch.bfloat16)
    shifted = torch.zeros(1, 2, 64, 72, dtype=torch.bfloat16)[..., 1:65]
    assert not tfa._tma_ok(narrow)
    assert not tfa._tma_ok(wide[..., :64])
    assert not tfa._tma_ok(shifted)
    got, d = tfa._tma_operands([narrow] * 4)
    assert d == 40 and all(t.shape[-1] == 40 and t.is_contiguous()
                           for t in got)
    got, d = tfa._tma_operands([wide[..., :64], views[0], views[1], shifted])
    assert d == 64 and got[1] is views[0] and got[2] is views[1]
    assert got[0].is_contiguous() and got[3].is_contiguous()


@pytest.mark.parametrize("causal,window", [(True, None), (False, 30),
                                           (True, 16)])
def test_padded_copy_round_trip_matches_the_strided_input(causal, window):
    """The plain backward on the wrapper's padded contiguous copies, sliced
    back to d, equals the plain backward on the unpadded strided views
    within 1e-6 in fp32: zero columns add nothing to the scores and give
    zero gradient columns."""
    rng = np.random.default_rng(31)
    d, scale = 36, 36 ** -0.5
    full = [torch.from_numpy(rng.normal(size=(2, 2, n, 44)).astype(
        np.float32)) for n in (100, 120, 120, 100)]
    q, k, v, do = (t[..., 3:3 + d] for t in full)  # strided, 4-byte offset
    lse = tfa._lse_reference(q, k, causal, scale, window)
    o = tfa.mha_reference(q, k, v, causal=causal, scale=scale, window=window)
    delta = (o * do).sum(-1)
    kw = dict(causal=causal, scale=scale, window=window)
    (pq, pk, pv, pdo), dp = tfa._tma_operands([q, k, v, do])
    assert dp == 40 and all(t.is_contiguous() for t in (pq, pk, pv, pdo))
    want = (tfa.flash_attention_bwd_dq_stream_reference(
        q, k, v, do, lse, delta, **kw),
        *tfa.flash_attention_bwd_dkv_stream_reference(
            q, k, v, do, lse, delta, **kw))
    got = (tfa.flash_attention_bwd_dq_stream_reference(
        pq, pk, pv, pdo, lse, delta, **kw),
        *tfa.flash_attention_bwd_dkv_stream_reference(
            pq, pk, pv, pdo, lse, delta, **kw))
    for g, w in zip(got, want):
        assert torch.all(g[..., d:] == 0)
        np.testing.assert_allclose(g[..., :d].numpy(), w.numpy(), atol=1e-6)


def test_splits_cover_the_band_once():
    for lo, hi, split in ((0, 65, 16), (3, 4, 16), (0, 16, 16), (5, 38, 4)):
        parts = tfa._splits(lo, hi, split)
        assert parts[0][0] == lo and parts[-1][1] == hi
        assert all(a < b <= a + split for a, b in parts)
        assert all(p[1] == n[0] for p, n in zip(parts, parts[1:]))
    assert tfa._splits(4, 4, 16) == [] and tfa._splits(5, 2, 16) == []


def test_auto_routing_rule():
    use = tfa.use_stream
    assert tfa.STREAM_MIN_SEQ == 4096
    assert use("auto", 4096, 4096, None, False)
    assert use("auto", 1024, 4096, None, False)  # max(sq, sk)
    assert not use("auto", 1024, 1024, None, False)
    assert use("auto", 1024, 1024, 32, False)  # a window streams
    assert not use("never", 8192, 8192, None, False)
    assert use("always", 64, 64, None, False)
    assert not use("auto", 8192, 8192, None, True)  # bias stays resident
    with pytest.raises(ValueError, match="bias"):
        use("always", 64, 64, None, True)
    with pytest.raises(ValueError, match="auto|never|always"):
        use("sometimes", 64, 64, None, False)


def test_routing_on_cpu_tensors(monkeypatch):
    calls = []
    real = tfa.flash_attention_fwd_stream_reference

    def counted(*a, **kw):
        calls.append(kw.get("window"))
        return real(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention_fwd_stream_reference", counted)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, sq=128, sk=128))
    tfa.flash_attention(q, k, v, causal=True)  # 128 < STREAM_MIN_SEQ
    assert calls == []
    tfa.flash_attention(q, k, v, causal=True, window=32)
    assert calls == [32]
    monkeypatch.setattr(tfa, "STREAM_MIN_SEQ", 128)
    tfa.flash_attention(q.requires_grad_(), k, v, causal=True)
    assert calls == [32, None]
    # 'never' with a window: the CPU keeps mha_reference's own autograd
    out = tfa.flash_attention(q, k, v, causal=True, window=32,
                              stream="never")
    assert type(out.grad_fn).__name__ != "FlashAttentionBackward"
    assert calls == [32, None]
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention(q, k, v, torch.zeros(1, 1, 128, 128),
                            stream="always")


def test_card_refusals_name_their_roadmap_items():
    bias, seg = torch.zeros(1), (torch.zeros(1), torch.zeros(1))
    assert "Queue 2 item 4" in tfa._card_refusal(bias, None, False)
    assert "Queue 2 item 4" in tfa._card_refusal(None, seg, False)
    assert "Queue 2 item 5" in tfa._card_refusal(None, seg, True)
    msg = tfa._card_refusal(None, None, False)
    assert "window" in msg and "Queue 2 item 4" in msg


def test_stream_wrappers_never_take_the_plain_version():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(0, sq=64, sk=64))
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfa.flash_attention_fwd_stream(q, k, v, causal=True)
    for fn in (tfa.flash_attention_bwd_dq_stream,
               tfa.flash_attention_bwd_dkv_stream):
        with pytest.raises(ValueError, match="CUDA kernel"):
            fn(q, k, v, q, lse, lse, causal=True, scale=0.25, window=8)
    from apex_tpu_torch import ops

    for name in ("flash_attention_fwd_stream",
                 "flash_attention_bwd_dq_stream",
                 "flash_attention_bwd_dkv_stream"):
        assert name in ops.KERNEL_WRAPPERS and name in ops.launch_counts()
