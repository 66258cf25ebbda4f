"""apex_tpu_torch's streamed flash attention against the JAX package's
streamed Pallas kernels on the CPU.

``flash_attention(stream="always")`` on CPU tensors runs the plain versions
of the three streamed kernels (per-split partials and the lse merge, the
split-wise dQ sums, the q-split dK/dV sums) through ``FlashAttention``; the
JAX side runs ``flash_attention(stream="always", impl="pallas")`` with
64-row blocks, whose ``_fwd_kernel_stream`` / ``_bwd_dq_kernel_stream`` /
``_bwd_dkv_kernel_stream`` run in Pallas interpret mode here (as
``tests/test_flash_attention.py`` runs them). The forward's tiles
(``FWD_OUTER_TILE`` / ``FWD_INNER_TILE`` / ``FWD_SPLIT_TILES``, 128 / 128 /
128 on the card) are cut to 64 / 32 and splits of one or two key tiles so
that rows span several splits and the merge runs; the backward's own tiles
(``BWD_OUTER_TILE`` / ``BWD_INNER_TILE`` / ``BWD_SPLIT_TILES``, 128 / 64 /
128 on the card) are cut alike, with unequal outer and inner tiles; the
fp32 backward takes whole bands at the resident fp32 pair's tiles
(``RES_BWD_F32_OUTER_TILE`` rows kept, cut to 64). fp32:
values within 1e-5, q/k/v grads within 1e-4 (the same fp32 math summed in
another order). The CUDA kernels are held against the same plain versions
by ``chip_smoke.py``.
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


def _small_fwd_tiles(monkeypatch, split_tiles):
    """The forward's tiles cut to 64-row query and 32-row key tiles, on
    both routes (bf16 FWD_*, fp32 FWD_F32_*)."""
    for route in ("FWD", "FWD_F32"):
        monkeypatch.setattr(tfa, f"{route}_OUTER_TILE", 64)
        monkeypatch.setattr(tfa, f"{route}_INNER_TILE", 32)
        monkeypatch.setattr(tfa, f"{route}_SPLIT_TILES", split_tiles)


def _small_bwd_tiles(monkeypatch, split_tiles):
    """The backward's tiles cut: bf16 (BWD_*) to 64-row outer and 32-row
    inner tiles in splits of ``split_tiles``, fp32 (whole bands at the
    resident fp32 pair's tiles) to 64 rows kept over its 64-row tiles."""
    monkeypatch.setattr(tfa, "BWD_OUTER_TILE", 64)
    monkeypatch.setattr(tfa, "BWD_INNER_TILE", 32)
    monkeypatch.setattr(tfa, "BWD_SPLIT_TILES", split_tiles)
    monkeypatch.setattr(tfa, "RES_BWD_F32_OUTER_TILE", 64)


@pytest.mark.parametrize("split_tiles", [1, 2, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_streamed_matches_jax_streamed_kernels(monkeypatch, causal,
                                               split_tiles):
    """Splits of 1 and 2 tiles (the last rows span several splits) and of 8
    (one split a band) on the bf16 route's tiles; the fp32 backward, which
    these fp32 inputs run, in whole bands of up to 4 tiles."""
    _small_fwd_tiles(monkeypatch, split_tiles)
    _small_bwd_tiles(monkeypatch, split_tiles)
    _, most = tfa._fwd_bands(256, 256, causal, None)
    assert most == 8 // split_tiles
    for inner_is_k in (True, False):
        _, most = tfa._bwd_bands(256, 256, causal, None, inner_is_k,
                                 tfa._bwd_tiles(True, inner_is_k, 16))
        assert most == 8 // split_tiles
        bands, most = tfa._bwd_bands(256, 256, causal, None, inner_is_k,
                                     tfa._bwd_tiles(False, inner_is_k, 16))
        assert most == 1
        assert max(e - a for b in bands for a, e in b) == 4
    _compare(*_inputs(5), causal=causal)


@pytest.mark.parametrize("causal", [False, True])
def test_window_matches_jax_streamed_kernels(monkeypatch, causal):
    _small_fwd_tiles(monkeypatch, 1)
    _compare(*_inputs(22), causal=causal, window=48)


@pytest.mark.parametrize("causal", [False, True])
def test_band_restricted_window(monkeypatch, causal):
    """sq = 512, window 16: each tile's band is 2-3 tiles of 8, so most
    tiles are never visited (the _window_grid case of the JAX tests); the
    fp32 backward at 64-row tiles both ways, each band whole."""
    _small_bwd_tiles(monkeypatch, 1)
    _small_fwd_tiles(monkeypatch, 1)
    bands, most = tfa._bwd_bands(512, 512, causal, 16, True,
                                 tfa._bwd_tiles(False, True, 16))
    lengths = [e - a for b in bands for a, e in b]
    assert most == 1 and max(lengths) == (2 if causal else 3)
    assert sum(lengths) < 8 * 8 // 2
    bands, most = tfa._fwd_bands(512, 512, causal, 16)
    assert most == (3 if causal else 4)  # 64 queries over 32-key tiles
    assert sum(len(b) for b in bands) < 8 * 16 // 2
    _compare(*_inputs(28, sq=512, sk=512), causal=causal, window=16)


def test_cross_shape_window_fully_masked_rows_are_zero(monkeypatch):
    """sq != sk: queries past sk + window - 1 see no key; their outputs and
    their dq are exactly 0, as in the JAX kernels."""
    _small_fwd_tiles(monkeypatch, 1)
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
    lengths 1 and 16 (one split a row) of 64-query x 32-key tiles, on a
    ragged cross shape."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(9, sq=200, sk=150))
    ref = tfa.mha_reference(q, k, v, causal=causal, window=window)
    lse = tfa._lse_reference(q, k, causal, 0.25, window)
    for split in (1, 16):
        _small_fwd_tiles(monkeypatch, split)
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

    t = tfa.BWD_INNER_TILE
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


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48), (False, 40)])
@pytest.mark.parametrize("split_tiles", [1, 2, 8])
def test_forward_tiles_match_jax_streamed_forward(monkeypatch, split_tiles,
                                                  causal, window):
    """The plain forward at the bf16 kernel's tiles cut to 64-query x
    32-key tiles, in splits of 1 and 2 key tiles (rows span several
    splits: the partials and the merge) and of 8 (one split a band: the
    kernel's direct epilogue), against the JAX package's _fwd_kernel_stream
    in interpret mode; o within 1e-5, lse against the dense logsumexp."""
    _small_fwd_tiles(monkeypatch, split_tiles)
    bands, most = tfa._fwd_bands(256, 256, causal, window)
    if split_tiles == 8:
        assert most == 1
    else:
        assert most > 1 and any(len(b) > 1 for b in bands)
    q, k, v, _ = _inputs(17)
    o, lse = tfa.flash_attention_fwd_stream_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window)
    jout = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                     window=window, impl="pallas", stream="always",
                     block_q=64, block_k=64)
    np.testing.assert_allclose(o.numpy(), np.asarray(jout), atol=VAL_TOL)
    want = tfa._lse_reference(*(torch.from_numpy(a) for a in (q, k)),
                              causal, 0.25, window)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=VAL_TOL)


@pytest.mark.parametrize("outer,inner", [(128, 64), (64, 128), (128, 128)])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (8192, 8192, True, None), (16384, 16384, True, 4096),
    (1100, 990, True, None), (300, 77, True, 16), (1000, 1000, False, 200),
    (700, 900, False, None)])
def test_fwd_splits_cover_every_band_once(monkeypatch, sq, sk, causal,
                                          window, outer, inner):
    """_fwd_bands at unequal tiles: each query tile's band is the JAX
    helper's _window_k_range (with the causal limit the JAX kernels put in
    their loop bounds), cut into contiguous splits of at most
    FWD_SPLIT_TILES key tiles that cover it exactly once."""
    from apex_tpu.ops.flash_attention import _window_k_range as jk

    monkeypatch.setattr(tfa, "FWD_OUTER_TILE", outer)
    monkeypatch.setattr(tfa, "FWD_INNER_TILE", inner)
    for split in (2, 5, tfa.FWD_SPLIT_TILES):
        monkeypatch.setattr(tfa, "FWD_SPLIT_TILES", split)
        bands, most = tfa._fwd_bands(sq, sk, causal, window)
        nq, nk = -(-sq // outer), -(-sk // inner)
        assert len(bands) == nq
        for t, splits in enumerate(bands):
            lo, hi = jk(0, nk, t, outer, inner, 0, 0, causal, window)
            lo, hi = max(int(lo), 0), int(hi)
            if causal:
                hi = min(hi, -(-(t + 1) * outer // inner))
            assert len(splits) <= most
            if hi <= lo:
                assert not splits
                continue
            assert splits[0][0] == lo and splits[-1][1] == hi
            assert all(a < b <= a + split for a, b in splits)
            assert all(p[1] == n[0] for p, n in zip(splits, splits[1:]))


@pytest.mark.parametrize("inner", [64, 128])
def test_merge_and_workspace_only_where_a_band_has_several_splits(
        monkeypatch, inner):
    """At the card's constants the long-context shapes (L: 8192 causal; W:
    16384 causal, window 4096) have one split a band on the bf16 route, and
    RP (317 causal, window 256: generate_gpt's longest RoPE prefill) on the
    fp32 route, so the forward launches no merge and allocates no workspace
    in either dtype; a cut split length brings both back."""
    monkeypatch.setattr(tfa, "FWD_INNER_TILE", inner)
    assert (tfa.FWD_OUTER_TILE, tfa.FWD_SPLIT_TILES) == (128, 128)
    for sq, window in ((8192, None), (16384, 4096)):
        _, nsplit = tfa._fwd_bands(sq, sq, True, window)
        assert nsplit == 1
        assert not tfa._fwd_merges(nsplit)
    f32 = tfa._fwd_tiles(False, 64)
    _, nsplit = tfa._fwd_bands(317, 317, True, 256, f32)
    assert nsplit == 1 and not tfa._fwd_merges(nsplit)
    monkeypatch.setattr(tfa, "FWD_SPLIT_TILES", 2)
    _, nsplit = tfa._fwd_bands(8192, 8192, True, None)
    assert nsplit == 8192 // inner // 2
    assert tfa._fwd_merges(nsplit)
    monkeypatch.setattr(tfa, "FWD_F32_SPLIT_TILES", 2)
    _, nsplit = tfa._fwd_bands(8192, 8192, True, None,
                               tfa._fwd_tiles(False, 64))
    assert nsplit == 8192 // f32[1] // 2 and tfa._fwd_merges(nsplit)
    assert not tfa._fwd_merges(1) and not tfa._fwd_merges(0)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48), (False, 40)])
@pytest.mark.parametrize("split_tiles", [1, 2, 16])
def test_fp32_streamed_forward_at_its_own_splits_matches_jax(
        monkeypatch, split_tiles, causal, window):
    """The plain forward on fp32 inputs cuts its bands at the fp32 route's
    own tiles (FWD_F32_*: here 32-query x 16-key tiles, the bf16 route's
    left at the card's), in splits of 1 and 2 key tiles (the partials and
    the merge) and of 16 (one split a band: the kernel's direct epilogue),
    and matches the JAX package's _fwd_kernel_stream in interpret mode; o
    within 1e-5, lse against the dense logsumexp."""
    monkeypatch.setattr(tfa, "FWD_F32_OUTER_TILE", 32)
    monkeypatch.setattr(tfa, "FWD_F32_INNER_TILE", 16)
    monkeypatch.setattr(tfa, "FWD_F32_SPLIT_TILES", split_tiles)
    tiles = tfa._fwd_tiles(False, 16)
    assert tiles == (32, 16, split_tiles)
    assert tfa._fwd_tiles(True, 16) == (128, 128, 128)
    bands, most = tfa._fwd_bands(256, 256, causal, window, tiles)
    if split_tiles == 16:
        assert most == 1
    else:
        assert most > 1 and any(len(b) > 1 for b in bands)
    seen = []
    real = tfa._fwd_bands

    def recorded(*a):
        seen.append(a[4])
        return real(*a)

    monkeypatch.setattr(tfa, "_fwd_bands", recorded)
    q, k, v, _ = _inputs(19)
    o, lse = tfa.flash_attention_fwd_stream_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window)
    assert seen == [tiles]
    jout = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                     window=window, impl="pallas", stream="always",
                     block_q=64, block_k=64)
    np.testing.assert_allclose(o.numpy(), np.asarray(jout), atol=VAL_TOL)
    want = tfa._lse_reference(*(torch.from_numpy(a) for a in (q, k)),
                              causal, 0.25, window)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=VAL_TOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (8192, 8192, True, None), (317, 317, True, 256), (1100, 990, True, None),
    (300, 77, True, 16), (1000, 1000, False, 200), (700, 900, False, None)])
def test_fp32_forward_splits_at_the_cards_tiles(sq, sk, causal, window, d):
    """At the fp32 route's tiles (FWD_F32_*, 64 / 32 above d = 64) each
    query tile's band is the JAX helper's _window_k_range with the causal
    limit, cut into contiguous splits of at most FWD_F32_SPLIT_TILES key
    tiles that cover it exactly once."""
    from apex_tpu.ops.flash_attention import _window_k_range as jk

    outer, inner, split = tfa._fwd_tiles(False, d)
    if d > 64:
        assert (outer, inner) == (64, 32)
    else:
        assert (outer, inner) == (tfa.FWD_F32_OUTER_TILE,
                                  tfa.FWD_F32_INNER_TILE)
    bands, most = tfa._fwd_bands(sq, sk, causal, window,
                                 (outer, inner, split))
    nq, nk = -(-sq // outer), -(-sk // inner)
    assert len(bands) == nq
    for t, splits in enumerate(bands):
        lo, hi = jk(0, nk, t, outer, inner, 0, 0, causal, window)
        lo, hi = max(int(lo), 0), int(hi)
        if causal:
            hi = min(hi, -(-(t + 1) * outer // inner))
        assert len(splits) <= most
        if hi <= lo:
            assert not splits
            continue
        assert splits[0][0] == lo and splits[-1][1] == hi
        assert all(a < b <= a + split for a, b in splits)
        assert all(p[1] == n[0] for p, n in zip(splits, splits[1:]))


# packed ids of 48 tokens: three segments, then a padding tail (id 9)
SEG48 = np.repeat([1, 2, 3, 9], [15, 12, 13, 8]).astype(np.int32)


@pytest.mark.parametrize("mask", ["causal", "full", "window", "segments"])
@pytest.mark.parametrize("outer,inner", [(16, 8), (16, 16), (32, 8)])
def test_fp32_streamed_backward_at_its_own_tiles_matches_jax(
        monkeypatch, outer, inner, mask):
    """The plain streamed dQ and dK/dV on fp32 inputs cut their bands at the
    fp32 route's own tiles (the resident fp32 pair's, _res_bwd_tiles: here
    cut to 16 or 32 rows kept over 8- or 16-row tiles; the bf16 route's
    left at the card's), one piece a band as the kernel takes it, and match
    the JAX package's streamed kernels in interpret mode (16-row blocks)
    through FlashAttention: causal, non-causal, a window of 10 and packed
    ids with pad_id and the contiguous-segment bounds; values within 1e-5,
    grads within 1e-4."""
    real_tiles = tfa._res_bwd_tiles

    def cut(bf16, inner_is_k, d, bias=False):
        if bf16:
            return real_tiles(bf16, inner_is_k, d, bias)
        return outer, inner, 0

    monkeypatch.setattr(tfa, "_res_bwd_tiles", cut)
    for inner_is_k in (True, False):
        tiles = tfa._bwd_tiles(False, inner_is_k, 16)
        assert tiles == (outer, inner, None)
        assert tfa._bwd_tiles(True, inner_is_k, 16) == (128, 64, 128)
        bands, most = tfa._bwd_bands(48, 48, False, None, inner_is_k, tiles)
        assert most == 1 and tuple(bands[0]) == ((0, 48 // inner),)
    seen = []
    real = tfa._bwd_bands

    def recorded(*a):
        seen.append(a[5])
        return real(*a)

    monkeypatch.setattr(tfa, "_bwd_bands", recorded)
    kw = {"causal": dict(causal=True), "full": dict(causal=False),
          "window": dict(causal=True, window=10),
          "segments": dict(causal=True, pad_id=9)}[mask]
    q, k, v, g = _inputs(43, sq=48, sk=48, b=2, d=16)
    tkw, jkw = dict(kw), dict(kw, impl="pallas", stream="always",
                              block_q=16, block_k=16)
    if mask == "segments":
        ids = np.stack([SEG48, np.repeat([4, 5, 9], [20, 20, 8])]).astype(
            np.int32)
        tkw.update(segment_ids=(torch.from_numpy(ids),) * 2,
                   contiguous_segments=True)
        jkw.update(segment_ids=(jnp.asarray(ids),) * 2,
                   contiguous_segments=True)
    out, grads = _torch(q, k, v, g, **tkw)
    assert seen == [(outer, inner, None)] * 2
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    jout = jax_flash(*args, **jkw)
    jgrads = jax.grad(lambda *a: jnp.sum(jax_flash(*a, **jkw) * g),
                      argnums=(0, 1, 2))(*args)
    np.testing.assert_allclose(out, np.asarray(jout), atol=VAL_TOL)
    for name, a, r in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a, np.asarray(r), atol=GRAD_TOL,
                                   err_msg=f"d{name}")
    if mask == "segments":  # padded queries and keys: exactly 0
        assert np.all(grads[0][:, :, 40:] == 0.0)
        assert np.all(grads[1][:, :, 40:] == 0.0)


@pytest.mark.parametrize("inner_is_k", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (8192, 8192, True, None), (16384, 16384, True, 4096),
    (1100, 990, True, None), (300, 77, True, 16), (1000, 1000, False, 200),
    (77, 300, False, None)])
def test_fp32_bwd_splits_at_the_cards_tiles(sq, sk, causal, window, d,
                                            inner_is_k):
    """At the fp32 backward's tiles (_bwd_tiles: the resident fp32 pair's,
    128 rows kept over 64-row tiles, 64 over 64 / 32 above d = 64) each
    outer tile's band is the JAX helpers' range with the causal limit, in
    one piece (the kernel's k_tiles / q_tiles, no split)."""
    from apex_tpu.ops.flash_attention import _window_k_range as jk
    from apex_tpu.ops.flash_attention import _window_q_range as jq

    outer, inner, split = tiles = tfa._bwd_tiles(False, inner_is_k, d)
    assert split is None
    bands, most = tfa._bwd_bands(sq, sk, causal, window, inner_is_k, tiles)
    s_out, s_in = (sq, sk) if inner_is_k else (sk, sq)
    n_out, n_in = -(-s_out // outer), -(-s_in // inner)
    assert len(bands) == n_out
    for t, splits in enumerate(bands):
        if inner_is_k:
            lo, hi = jk(0, n_in, t, outer, inner, 0, 0, causal, window)
            if causal:
                hi = min(int(hi), -(-(t + 1) * outer // inner))
        else:
            lo0 = min(t * outer // inner, n_in) if causal else 0
            lo, hi = jq(lo0, n_in, t, inner, outer, 0, 0, causal, window)
        lo, hi = max(int(lo), 0), int(hi)
        assert len(splits) <= most <= 1
        if hi <= lo:
            assert not splits
            continue
        assert tuple(splits) == ((lo, hi),)


def test_fp32_bwd_one_split_a_band_at_the_path_shapes(monkeypatch):
    """Every band of L32 = (1,16,8192,64) causal and W32 = (1,16,16384,64)
    causal, window 4096 is one piece on the fp32 route, at d = 64 and 128,
    in both passes: the kernel writes each gradient once, with no split
    length to cut (a cut BWD_SPLIT_TILES splits the bf16 route's bands and
    leaves the fp32 route's whole)."""
    for cut in (None, 16):
        if cut:
            monkeypatch.setattr(tfa, "BWD_SPLIT_TILES", cut)
        for inner_is_k in (True, False):
            for s, window in ((8192, None), (16384, 4096)):
                for d in (64, 128):
                    _, nsplit = tfa._bwd_bands(
                        s, s, True, window, inner_is_k,
                        tfa._bwd_tiles(False, inner_is_k, d))
                    assert nsplit == 1
            _, nsplit = tfa._bwd_bands(8192, 8192, True, None, inner_is_k,
                                       tfa._bwd_tiles(True, inner_is_k, 64))
            assert nsplit == (1 if cut is None else 8192 // 64 // cut)


@pytest.mark.parametrize("sq,sk,d,causal,window", [
    (300, 77, 64, True, 16), (520, 400, 128, False, 90),
    (700, 700, 64, True, None)])
def test_bf16_plain_forward_at_the_card_tiles(sq, sk, d, causal, window):
    """bf16 inputs through the plain forward at the card's tiles against
    mha_reference on the same rounded values, within phase 2's bf16 limits
    (2e-2 of max |ref|, each row within 1.5e-2); rows that see no key give
    o = 0 exactly and lse = NEG_INF."""
    rng = np.random.default_rng(41)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, s, d)).astype(
        np.float32)).to(torch.bfloat16) for s in (sq, sk, sk))
    o, lse = tfa.flash_attention_fwd_stream_reference(
        q, k, v, causal=causal, window=window)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = tfa.mha_reference(q.float(), k.float(), v.float(), causal=causal,
                            window=window)
    err = (o.float() - ref).abs()
    assert float(err.max()) <= 2e-2 * float(ref.abs().max())
    den = ref.norm(dim=-1)
    den = den.maximum(den.amax(dim=-1, keepdim=True) * 1e-3)
    assert float((err.norm(dim=-1) / den.clamp_min(1e-30)).max()) <= 1.5e-2
    want = tfa._lse_reference(q, k, causal, d ** -0.5, window)
    dead = want <= tfa.NEG_INF / 2
    assert bool(dead.any()) == (sq > sk + (window or sk))
    assert torch.all(o[dead] == 0) and torch.all(lse[dead] == tfa.NEG_INF)
    np.testing.assert_allclose(lse[~dead].numpy(), want[~dead].numpy(),
                               atol=1e-4)


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
    # 'never' with a window: FlashAttention's resident route (the plain
    # resident versions with the window), not the streamed one
    out = tfa.flash_attention(q, k, v, causal=True, window=32,
                              stream="never")
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert calls == [32, None]
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention(q, k, v, torch.zeros(1, 1, 128, 128),
                            stream="always")


def test_card_refusals_name_their_roadmap_items(monkeypatch):
    # the card refuses no flash mask any more: segment ids with pad_id on
    # the streamed route and the window on the resident one reach
    # FlashAttention (tests/test_torch_package.py has the bias); what is
    # left is the ring's global offsets, with context parallelism (Queue 1
    # item 15), which the long-context example names
    monkeypatch.setattr(tfa, "check_device", lambda t, name: "cuda")
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(0, sq=64, sk=64))
    q.requires_grad_()
    seg = torch.tensor([[1] * 20 + [2] * 30 + [7] * 14] * q.shape[0],
                       dtype=torch.int32)
    for kw in (dict(segment_ids=(seg, seg), pad_id=7, stream="always",
                    contiguous_segments=True),
               dict(window=16, stream="never")):
        out = tfa.flash_attention(q, k, v, causal=True, **kw)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        ref = tfa.mha_reference(q, k, v, causal=True,
                                **{x: kw[x] for x in kw
                                   if x in ("segment_ids", "pad_id",
                                            "window")})
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    assert not hasattr(tfa, "_card_refusal")
    from apex_tpu_torch.examples.longcontext import train_long_context as lc

    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        lc.main(["--device", "cpu", "--cp", "2"])


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
