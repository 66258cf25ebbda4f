"""apex_tpu_torch.ops.flash_attention.mha_reference against the JAX
``mha_reference`` on the CPU (fp32, atol 2e-5: the same fp32 math with
another summation order).

Every mask of the reference is covered -- causal and non-causal, additive
bias, segment ids with a pad id, the sliding window -- and rows whose every
key is masked must be exactly 0 on both sides. ``flash_attention`` on a CPU
tensor is the plain version; its CUDA kernel is held against it by
``chip_smoke.py``.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from apex_tpu.ops.flash_attention import mha_reference as jax_mha

# the package re-exports a function named like this module
tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

ATOL = 2e-5


def _qkv(b=2, h=3, sq=24, sk=24, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, s, d)).astype(np.float32)
                 for s in (sq, sk, sk))


def _both(q, k, v, bias=None, seg=None, **kw):
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    jb = None if bias is None else jnp.asarray(bias)
    tseg = None if seg is None else tuple(torch.from_numpy(s) for s in seg)
    jseg = None if seg is None else tuple(jnp.asarray(s) for s in seg)
    ref = np.asarray(jax_mha(jq, jk, jv, jb, segment_ids=jseg, **kw))
    got = tfa.mha_reference(tq, tk, tv, tb, segment_ids=tseg, **kw)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    return got.numpy(), ref


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(24, 24), (16, 40), (40, 16)])
def test_plain_matches_jax(causal, shape):
    q, k, v = _qkv(sq=shape[0], sk=shape[1])
    _both(q, k, v, causal=causal)
    _both(q, k, v, causal=causal, scale=0.3)


@pytest.mark.parametrize("causal", [False, True])
def test_additive_bias(causal):
    q, k, v = _qkv()
    rng = np.random.default_rng(1)
    bias = rng.normal(size=(2, 1, 24, 24)).astype(np.float32)
    bias[:, :, :, 5] = -10000.0  # a masked key column
    _both(q, k, v, bias=bias, causal=causal)


@pytest.mark.parametrize("causal", [False, True])
def test_segment_ids_pad_id_and_exact_zero_rows(causal):
    q, k, v = _qkv()
    q_seg = np.array([[0] * 10 + [1] * 10 + [9] * 4,
                      [2] * 24], np.int32)
    kv_seg = q_seg.copy()
    got, ref = _both(q, k, v, seg=(q_seg, kv_seg), pad_id=9, causal=causal)
    # pad queries see only pad keys, which are never attended: exact zeros
    assert np.all(got[0, :, 20:] == 0.0) and np.all(ref[0, :, 20:] == 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_window(causal):
    q, k, v = _qkv()
    _both(q, k, v, causal=causal, window=5)


def test_cross_shape_window_fully_masked_rows_are_zero():
    # queries past sk + window see no key at all
    q, k, v = _qkv(sq=40, sk=8)
    got, ref = _both(q, k, v, causal=True, window=4)
    assert np.all(got[:, :, 11:] == 0.0) and np.all(ref[:, :, 11:] == 0.0)
    assert np.any(got[:, :, :11] != 0.0)


def test_flash_attention_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    out = tfa.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, tfa.mha_reference(q, k, v, causal=True))
    # a window covering everything is dense attention (reference rule)
    assert torch.equal(tfa.flash_attention(q, k, v, causal=True, window=24),
                       out)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, window=0)


def test_kernel_wrapper_never_takes_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfa.flash_attention_fwd(q, k, v, causal=True)


# ---------------------------------------------------------------------------
# backward: FlashAttention (plain backward on the CPU) against jax.grad of
# the JAX flash attention, whose backward runs _bwd_dq_kernel and
# _bwd_dkv_kernel in Pallas interpret mode (impl="pallas", 16x16 blocks, as
# tests/test_flash_attention.py:36), and against jax.grad of mha_reference
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from apex_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402,E501

GRAD_TOL = 1e-4


def _loss_grads_torch(fn, q, k, v, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out, [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(32, 32), (16, 48), (48, 16)])
def test_grads_match_jax_pallas_backward(causal, shape):
    q, k, v = _qkv(b=1, h=2, sq=shape[0], sk=shape[1], d=16, seed=4)
    g = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    out, got = _loss_grads_torch(
        lambda a, b, c: tfa.flash_attention(a, b, c, causal=causal),
        q, k, v, g)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"

    def jloss(fn):
        return lambda a, b, c: jnp.sum(fn(a, b, c) * g)

    args = tuple(jnp.asarray(a) for a in (q, k, v))
    pallas = jax.grad(jloss(lambda a, b, c: jax_flash(
        a, b, c, causal=causal, impl="pallas", block_q=16, block_k=16)),
        argnums=(0, 1, 2))(*args)
    plain = jax.grad(jloss(lambda a, b, c: jax_mha(a, b, c, causal=causal)),
                     argnums=(0, 1, 2))(*args)
    for a, rp, rx in zip(got, pallas, plain):
        np.testing.assert_allclose(a, np.asarray(rp), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)
        np.testing.assert_allclose(a, np.asarray(rx), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_autograd_through_mha_reference(causal):
    """flash_attention_bwd_reference (the kernels' arithmetic from lse and
    delta) equals autograd through mha_reference (fp32, 1e-5)."""
    q, k, v = _qkv(b=2, h=2, sq=20, sk=28, d=8, seed=6)
    g = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    scale = 8 ** -0.5
    out, want = _loss_grads_torch(
        lambda a, b, c: tfa.mha_reference(a, b, c, causal=causal), q, k, v,
        g)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    lse = tfa._lse_reference(tq, tk, causal, scale)
    got = tfa.flash_attention_bwd_reference(
        tq, tk, tv, out.detach(), lse, torch.from_numpy(g), causal=causal,
        scale=scale)
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), r, atol=1e-5)


def test_masked_cpu_inputs_keep_mha_reference_autograd():
    # every mask goes through FlashAttention on the CPU, as on the card: a
    # bias on the resident route, segment ids on the route 'auto' takes
    # (the plain versions of the kernels), the window on the streamed path;
    # the grads agree with autograd through mha_reference
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv())
    bias = torch.zeros(1, 1, 24, 24)
    out = tfa.flash_attention(q, k, v, bias, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    seg = torch.tensor([[0] * 10 + [1] * 14, [2] * 24], dtype=torch.int32)
    q.grad = None
    out = tfa.flash_attention(q, k, v, segment_ids=(seg, seg), causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.sum().backward()
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    tfa.mha_reference(qr, kr, vr, segment_ids=(seg, seg),
                      causal=True).sum().backward()
    torch.testing.assert_close(q.grad, qr.grad, atol=1e-5, rtol=1e-5)


def test_backward_wrappers_never_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    lse = torch.zeros(q.shape[:3])
    for fn in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA kernel"):
            fn(q, k, v, q, lse, lse, causal=True, scale=0.25)


# ---------------------------------------------------------------------------
# the resident kernels' bands, operands and bf16 through the plain backward
# ---------------------------------------------------------------------------


def _jax_loop_limits(sq, sk, causal, blk_q, blk_k, dq_pass):
    """The loop limits of the JAX resident backward kernels, per outer
    tile: ``_bwd_dq_kernel``'s causal ``lim`` (apex_tpu/ops/
    flash_attention.py:403) over key tiles, ``_bwd_dkv_kernel``'s causal
    ``start`` (:478) over query tiles, each then through the kernels' own
    ``_window_k_range`` / ``_window_q_range`` with no window. ``sq``/``sk``
    may be ragged: the tile counts round up."""
    from apex_tpu.ops.flash_attention import _window_k_range as jk
    from apex_tpu.ops.flash_attention import _window_q_range as jq

    nq, nk = -(-sq // blk_q), -(-sk // blk_k)
    out = []
    if dq_pass:
        for qi in range(nq):
            n = nk
            if causal:
                lim = ((qi + 1) * blk_q + blk_k - 1) // blk_k
                n = int(np.clip(lim, 0, n))
            lo, hi = jk(0, n, qi, blk_q, blk_k, 0, 0, causal, None)
            out.append((int(lo), int(hi)))
    else:
        for ki in range(nk):
            start = int(np.clip(ki * blk_k // blk_q, 0, nq)) if causal else 0
            lo, hi = jq(start, nq, ki, blk_q, blk_k, 0, 0, causal, None)
            out.append((int(lo), int(hi)))
    return tuple(out)


@pytest.mark.parametrize("dq_pass", [True, False])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("outer,inner", [(128, 64), (64, 128)])
@pytest.mark.parametrize("sq,sk", [(256, 256), (300, 77), (77, 300),
                                   (1100, 990), (130, 130)])
def test_resident_bands_match_the_jax_kernels_loop_limits(sq, sk, outer,
                                                          inner, causal,
                                                          dq_pass):
    """_res_bwd_bands (one piece a band: the resident kernels' loop over
    inner tiles) at unequal tiles equals the JAX kernels' loop limits, and
    every visible (query, key) pair lies in exactly one (outer tile, inner
    tile of its band) in each pass."""
    blk_q, blk_k = (outer, inner) if dq_pass else (inner, outer)
    bands = tfa._res_bwd_bands(sq, sk, causal, dq_pass, outer, inner)
    assert bands == _jax_loop_limits(sq, sk, causal, blk_q, blk_k, dq_pass)
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    visible = np.broadcast_to(k <= q, (sq, sk)) if causal else \
        np.ones((sq, sk), bool)
    covered = np.zeros((sq, sk), np.int32)
    for t, (lo, hi) in enumerate(bands):
        assert 0 <= lo and hi <= -(-(sk if dq_pass else sq) // inner)
        for i in range(lo, hi):
            rows = slice(t * outer, (t + 1) * outer)
            cols = slice(i * inner, (i + 1) * inner)
            if dq_pass:
                covered[rows, cols] += 1
            else:
                covered[cols, rows] += 1
    assert np.all(covered[visible] == 1)
    assert covered.max() <= 1


def test_resident_bands_at_the_cards_tiles():
    """With the card's constants the dQ pass streams key tiles of
    RES_BWD_DQ_INNER_TILE rows and the dK/dV pass query tiles of
    BWD_INNER_TILE, both under BWD_OUTER_TILE-row outer tiles; above
    d = 64 both passes take 64-row tiles."""
    o = tfa.BWD_OUTER_TILE
    assert tfa._res_bwd_bands(1024, 1024, True, True) == tuple(
        (0, -(-(t + 1) * o // tfa.RES_BWD_DQ_INNER_TILE))
        for t in range(1024 // o))
    assert tfa._res_bwd_bands(1024, 1024, True, False) == tuple(
        (t * o // tfa.BWD_INNER_TILE, 1024 // tfa.BWD_INNER_TILE)
        for t in range(1024 // o))
    assert tfa._res_bwd_inner(True, 128) == tfa._res_bwd_inner(False, 128) \
        == 64


def test_fp32_route_tiles_follow_their_own_constants(monkeypatch):
    """The fp32 resident pair's launch tiles come from its own constants
    (RES_BWD_F32_OUTER_TILE and RES_BWD_F32_PERSISTENT; 64-row inner
    tiles, and above d = 64 64 rows kept and 32-row query tiles for
    dK/dV), not from the streamed bf16 kernels' BWD_* constants; bf16
    keeps its own."""
    def tiles():
        return [tfa._res_bwd_tiles(False, dq, d) for d in (64, 128)
                for dq in (True, False)]

    o, p = tfa.RES_BWD_F32_OUTER_TILE, int(tfa.RES_BWD_F32_PERSISTENT)
    assert tiles() == [(o, 64, p), (o, 64, p), (64, 64, p), (64, 32, p)]
    for name in ("BWD_OUTER_TILE", "BWD_INNER_TILE", "BWD_SPLIT_TILES"):
        monkeypatch.setattr(tfa, name, 16)
    assert tiles() == [(o, 64, p), (o, 64, p), (64, 64, p), (64, 32, p)]
    monkeypatch.setattr(tfa, "RES_BWD_F32_OUTER_TILE", 192 - o)
    monkeypatch.setattr(tfa, "RES_BWD_F32_PERSISTENT", not p)
    assert tiles() == [(192 - o, 64, 1 - p), (192 - o, 64, 1 - p),
                       (64, 64, 1 - p), (64, 32, 1 - p)]
    assert tfa._res_bwd_tiles(True, True, 64) == (
        tfa.BWD_OUTER_TILE, tfa.RES_BWD_DQ_INNER_TILE,
        int(tfa.RES_BWD_PERSISTENT))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dq_pass", [True, False])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(1024, 1024), (300, 77), (77, 300),
                                   (200, 150)])
def test_fp32_resident_bands_at_the_cards_tiles(sq, sk, causal, dq_pass, d):
    """At the fp32 pair's tiles (_res_bwd_tiles, the card's constants) the
    bands the kernels walk (_res_bwd_bands, k_tiles / q_tiles in
    csrc/flash_bwd_wgmma.cuh) equal the JAX kernels' loop limits at those
    tiles, and every visible pair lies in exactly one (outer tile, inner
    tile of its band)."""
    outer, inner, _ = tfa._res_bwd_tiles(False, dq_pass, d)
    blk_q, blk_k = (outer, inner) if dq_pass else (inner, outer)
    bands = tfa._res_bwd_bands(sq, sk, causal, dq_pass, outer, inner)
    assert bands == _jax_loop_limits(sq, sk, causal, blk_q, blk_k, dq_pass)
    covered = np.zeros((sq, sk), np.int32)
    for t, (lo, hi) in enumerate(bands):
        for i in range(lo, hi):
            rows = slice(t * outer, (t + 1) * outer)
            cols = slice(i * inner, (i + 1) * inner)
            if dq_pass:
                covered[rows, cols] += 1
            else:
                covered[cols, rows] += 1
    visible = np.tril(np.ones((sq, sk), bool)) if causal else \
        np.ones((sq, sk), bool)
    assert np.all(covered[visible] == 1) and covered.max() <= 1


def _check_seg_tables(d, dq_pass, pad, outer, inner):
    """The segment arguments _seg_args builds at (outer, inner) tiles
    (contiguous ids with a pad suffix, ragged ends) against _seg_valid:
    every pair with equal non-pad ids lies in its outer tile's bounds; a
    block whose (min, max) tables name one non-pad id on both sides (the
    kernels' seg_uniform: no test) holds only valid pairs; and each own
    row's range is exactly the other side's rows it may see."""
    sq, sk = 128, 100
    q_ids = torch.from_numpy(_seg_ids(sq))
    k_ids = torch.from_numpy(_seg_ids(sk))
    q = torch.zeros(2, 1, sq, d)
    k = torch.zeros(2, 1, sk, d)
    seg = tfa._as_seg((q_ids, k_ids), pad, True, q, k)
    ptrs, keep = tfa._seg_args(seg, outer, inner, dq_pass)
    assert ptrs[-2:] == (0 if pad is None else pad, int(pad is not None))
    _, _, bounds, omm, imm, ranges = keep
    valid = tfa._seg_valid(seg, 0, 0, sq, sk)[:, 0]
    if not dq_pass:
        valid = valid.transpose(1, 2)  # (b, own rows = keys, queries)
    n_own, n_other = valid.shape[1:]
    assert bounds.shape == omm.shape == (2, 2, -(-n_own // outer))
    assert imm.shape == (2, 2, -(-n_other // inner))
    assert ranges.shape == (2, 2, n_own)
    own_ids = seg.q if dq_pass else seg.k
    for b in range(2):
        for t in range(-(-n_own // outer)):
            rows = valid[b, t * outer:(t + 1) * outer]
            lo, hi = int(bounds[b, 0, t]), int(bounds[b, 1, t])
            tiles = torch.arange(n_other) // inner
            assert not (rows & ((tiles < lo) | (tiles >= hi))).any()
            for i in range(-(-n_other // inner)):
                ids = {int(omm[b, 0, t]), int(omm[b, 1, t]),
                       int(imm[b, 0, i]), int(imm[b, 1, i])}
                if len(ids) == 1 and ids != {pad}:
                    own_n = min(outer, n_own - t * outer)
                    block = rows[:, i * inner:(i + 1) * inner]
                    assert block[:own_n].all()
        for r in range(n_own):
            lo, hi = int(ranges[b, 0, r]), int(ranges[b, 1, r])
            want = valid[b, r]
            assert want[lo:hi].all() and want.sum() == max(hi - lo, 0), \
                (b, r, int(own_ids[b, r]))




@pytest.mark.parametrize("pad", [None, 9])
@pytest.mark.parametrize("dq_pass", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_fp32_segment_tables_at_the_cards_tiles(d, dq_pass, pad):
    """_check_seg_tables at the fp32 pair's tiles (_res_bwd_tiles)."""
    outer, inner, _ = tfa._res_bwd_tiles(False, dq_pass, d)
    _check_seg_tables(d, dq_pass, pad, outer, inner)


@pytest.mark.parametrize("pad", [None, 9])
@pytest.mark.parametrize("dq_pass", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_fp32_streamed_backward_segment_tables_at_the_cards_tiles(
        d, dq_pass, pad):
    """_check_seg_tables at the streamed fp32 backward's tiles (_bwd_tiles:
    the resident fp32 pair's, 128 rows kept over 64-row tiles, 64 over 64 /
    32 above d = 64, over whole bands), as its wrappers build them."""
    outer, inner, split = tfa._bwd_tiles(False, dq_pass, d)
    assert (outer, inner, split) == (
        *tfa._res_bwd_tiles(False, dq_pass, d)[:2], None)
    assert (outer, inner) == ((128, 64) if d <= 64 else
                              (64, 64 if dq_pass else 32))
    _check_seg_tables(d, dq_pass, pad, outer, inner)


def test_fp32_streamed_backward_tiles_follow_their_own_constants(
        monkeypatch):
    """The streamed fp32 backward runs at the resident fp32 pair's tiles
    (RES_BWD_F32_OUTER_TILE; 64 rows kept above d = 64, over 32-row query
    tiles for dK/dV) over whole bands (no split length), not at the bf16
    route's BWD_* constants nor the resident bf16 pair's; bf16 keeps
    BWD_*."""
    def tiles():
        return [tfa._bwd_tiles(False, dq, d) for d in (64, 128)
                for dq in (True, False)]

    o = tfa.RES_BWD_F32_OUTER_TILE
    want = [(o, 64, None), (o, 64, None), (64, 64, None), (64, 32, None)]
    assert tiles() == want
    for name in ("BWD_OUTER_TILE", "BWD_INNER_TILE", "BWD_SPLIT_TILES",
                 "RES_BWD_DQ_INNER_TILE", "RES_BWD_DQ_BIAS_INNER_TILE"):
        monkeypatch.setattr(tfa, name, 16)
    monkeypatch.setattr(tfa, "RES_BWD_F32_PERSISTENT",
                        not tfa.RES_BWD_F32_PERSISTENT)
    assert tiles() == want
    assert tfa._bwd_tiles(True, True, 64) == (16, 16, 16)
    monkeypatch.setattr(tfa, "RES_BWD_F32_OUTER_TILE", 192 - o)
    assert tiles() == [(192 - o, 64, None), (192 - o, 64, None),
                       (64, 64, None), (64, 32, None)]


@pytest.mark.parametrize("pad", [None, 9])
@pytest.mark.parametrize("route", ["resident", "streamed"])
@pytest.mark.parametrize("d", [64, 128])
def test_fp32_forward_segment_tables_at_the_cards_tiles(d, route, pad):
    """_check_seg_tables at the fp32 forward's tiles, resident
    (_res_fwd_f32_tiles) and streamed (_fwd_tiles): the query side
    outer, as the forward wrappers build them."""
    outer, inner = (tfa._res_fwd_f32_tiles(d) if route == "resident"
                    else tfa._fwd_tiles(False, d))[:2]
    _check_seg_tables(d, True, pad, outer, inner)


def test_fp32_forward_tiles_follow_their_own_constants(monkeypatch):
    """The fp32 forward's launch tiles come from its own constants, resident
    (RES_FWD_F32_OUTER_TILE / _INNER_TILE, on the plain grid) and streamed
    (FWD_F32_OUTER_TILE / _INNER_TILE / _SPLIT_TILES), 64 / 32 above
    d = 64, not from the fp32 backward's RES_BWD_F32_OUTER_TILE nor the
    bf16 routes' constants."""
    def tiles():
        return [f(d) for d in (64, 128)
                for f in (tfa._res_fwd_f32_tiles,
                          lambda d: tfa._fwd_tiles(False, d))]

    ro, ri = tfa.RES_FWD_F32_OUTER_TILE, tfa.RES_FWD_F32_INNER_TILE
    so, si, ss = (tfa.FWD_F32_OUTER_TILE, tfa.FWD_F32_INNER_TILE,
                  tfa.FWD_F32_SPLIT_TILES)
    want = [(ro, ri, 0), (so, si, ss), (64, 32, 0), (64, 32, ss)]
    assert tiles() == want
    for name in ("RES_BWD_F32_OUTER_TILE", "BWD_SPLIT_TILES",
                 "RES_FWD_OUTER_TILE", "RES_FWD_INNER_TILE", "FWD_OUTER_TILE",
                 "FWD_INNER_TILE", "FWD_SPLIT_TILES"):
        monkeypatch.setattr(tfa, name, 16)
    monkeypatch.setattr(tfa, "RES_FWD_PERSISTENT", not tfa.RES_FWD_PERSISTENT)
    assert tiles() == want
    monkeypatch.setattr(tfa, "RES_FWD_F32_OUTER_TILE", 192 - ro)
    monkeypatch.setattr(tfa, "RES_FWD_F32_INNER_TILE", 96 - ri)
    monkeypatch.setattr(tfa, "FWD_F32_OUTER_TILE", 192 - so)
    monkeypatch.setattr(tfa, "FWD_F32_INNER_TILE", 96 - si)
    monkeypatch.setattr(tfa, "FWD_F32_SPLIT_TILES", ss + 3)
    assert tiles() == [(192 - ro, 96 - ri, 0),
                       (192 - so, 96 - si, ss + 3), (64, 32, 0),
                       (64, 32, ss + 3)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window", [None, 40, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(1024, 1024), (300, 77), (77, 300),
                                   (317, 317)])
def test_fp32_resident_forward_bands_at_the_cards_tiles(sq, sk, causal,
                                                        window, d):
    """At the resident fp32 forward's tiles (_res_fwd_f32_tiles, the card's
    constants) the bands its CTAs walk (_res_fwd_bands, k_tiles in
    csrc/flash_bwd_wgmma.cuh) equal the JAX _fwd_kernel's loop limit at
    those tiles through its _window_k_range, and every visible pair lies in
    exactly one (query tile, key tile of its band)."""
    from apex_tpu.ops.flash_attention import _window_k_range as jk

    outer, inner, _ = tfa._res_fwd_f32_tiles(d)
    bands = tfa._res_fwd_bands(sq, sk, causal, outer, inner, window)
    nq, nk = -(-sq // outer), -(-sk // inner)
    want = []
    for qi in range(nq):
        n = nk
        if causal:
            n = int(np.clip(((qi + 1) * outer + inner - 1) // inner, 0, n))
        lo, hi = jk(0, n, qi, outer, inner, 0, 0, causal, window)
        want.append((int(lo), int(hi)))
    # the kernels clip an empty band to hi = lo (seg_band, max(0, ...))
    assert [(lo, max(lo, hi)) for lo, hi in bands] == [
        (lo, max(lo, hi)) for lo, hi in want]
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    visible = np.ones((sq, sk), bool)
    if causal:
        visible &= k <= q
    if window is not None:
        visible &= q - k < window
        if not causal:
            visible &= k - q < window
    covered = np.zeros((sq, sk), np.int32)
    for t, (lo, hi) in enumerate(bands):
        for i in range(lo, hi):
            covered[t * outer:(t + 1) * outer, i * inner:(i + 1) * inner] += 1
    assert np.all(covered[visible] == 1) and covered.max() <= 1


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", ["d36", "d36_strided", "stride_refused"])
def test_resident_operands_padded_copy_round_trip(case, causal):
    """The resident wrappers' operand preparation (_tma_operands) gives
    contiguous padded copies for d = 36 and for a row stride TMA refuses;
    the plain backward on the copies, sliced back to d, equals the plain
    backward on the inputs as given within 1e-6 (fp32)."""
    rng = np.random.default_rng(41)
    d = 64 if case == "stride_refused" else 36
    width = {"d36": 36, "d36_strided": 44, "stride_refused": 68}[case]
    off = 3 if case == "d36_strided" else 0
    full = [torch.from_numpy(rng.normal(size=(2, 2, n, width)).astype(
        np.float32)) for n in (100, 120, 120, 100)]
    q, k, v, do = (t[..., off:off + d] for t in full)
    scale = d ** -0.5
    ops_in, dp = tfa._tma_operands([q, k, v, do])
    assert dp == (40 if d == 36 else 64)
    assert all(t.is_contiguous() and t.shape[-1] == dp for t in ops_in)
    assert not any(a is b for a, b in zip(ops_in, (q, k, v, do)))
    lse = tfa._lse_reference(q, k, causal, scale)
    o = tfa.mha_reference(q, k, v, causal=causal, scale=scale)
    want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=causal, scale=scale)
    pq, pk, pv, pdo = ops_in
    got = tfa.flash_attention_bwd_reference(
        pq, pk, pv, tfa._pad_head_dim(o, dp), lse, pdo, causal=causal,
        scale=scale)
    for g, w in zip(got, want):
        assert torch.all(g[..., d:] == 0)
        np.testing.assert_allclose(g[..., :d].numpy(), w.numpy(), atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(40, 24), (24, 40)])
def test_bf16_grads_through_the_plain_backward_match_jax(causal, shape):
    """bf16 inputs through FlashAttention on the CPU (the plain backward)
    come back as bf16 grads that match jax.grad of the JAX mha_reference
    on the same rounded values within 1e-2 of max |ref|."""
    rng = np.random.default_rng(43)
    q, k, v = (rng.normal(size=(1, 2, s, 16)).astype(np.float32)
               for s in (shape[0], shape[1], shape[1]))
    g = rng.normal(size=q.shape).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    tg = torch.from_numpy(g).to(torch.bfloat16)
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(tg)
    rounded = [t.detach().float().numpy() for t in (tq, tk, tv)]
    jg = jnp.asarray(tg.float().numpy())
    want = jax.grad(lambda a, b, c: jnp.sum(jax_mha(a, b, c, causal=causal)
                                            * jg), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in rounded))
    for t, w in zip((tq, tk, tv), want):
        assert t.grad.dtype == torch.bfloat16
        w = np.asarray(w)
        err = np.abs(t.grad.float().numpy() - w).max()
        assert err <= 1e-2 * np.abs(w).max(), err


# ---------------------------------------------------------------------------
# the resident forward's bands, items and operands, bf16 through its plain
# version against the interpret-mode Pallas forward
# ---------------------------------------------------------------------------


def _jax_fwd_loop_limits(sq, sk, causal, blk_q, blk_k):
    """The key-tile loop of the JAX resident forward ``_fwd_kernel`` per
    query tile (apex_tpu/ops/flash_attention.py:304-309 with the ring
    offsets 0): nk tiles, the causal ``lim``, then the kernel's own
    ``_window_k_range`` with no window. ``sq``/``sk`` may be ragged: the
    tile counts round up."""
    from apex_tpu.ops.flash_attention import _window_k_range as jk

    out = []
    for qi in range(-(-sq // blk_q)):
        nk = -(-sk // blk_k)
        lo = 0
        if causal:
            lim = (0 - 0 + (qi + 1) * blk_q + blk_k - 1) // blk_k
            nk = int(np.clip(lim, 0, nk))
        lo, nk = jk(lo, nk, qi, blk_q, blk_k, 0, 0, causal, None)
        out.append((int(lo), int(nk)))
    return tuple(out)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("outer,inner", [(128, 128), (128, 64), (64, 128)])
@pytest.mark.parametrize("sq,sk", [(256, 256), (300, 77), (77, 300),
                                   (1024, 1024)])
def test_resident_forward_bands_match_the_jax_kernels_loop_limit(
        sq, sk, outer, inner, causal):
    """_res_fwd_bands (one piece a band: the resident forward's loop over
    key tiles) equals the JAX _fwd_kernel's loop limit at the same tiles,
    and every visible (query, key) pair lies in exactly one (query tile,
    key tile of its band)."""
    bands = tfa._res_fwd_bands(sq, sk, causal, outer, inner)
    assert bands == _jax_fwd_loop_limits(sq, sk, causal, outer, inner)
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    visible = np.broadcast_to(k <= q, (sq, sk)) if causal else \
        np.ones((sq, sk), bool)
    covered = np.zeros((sq, sk), np.int32)
    for t, (lo, hi) in enumerate(bands):
        assert 0 <= lo and hi <= -(-sk // inner)
        for i in range(lo, hi):
            covered[t * outer:(t + 1) * outer, i * inner:(i + 1) * inner] += 1
    assert np.all(covered[visible] == 1)
    assert covered.max() <= 1


def test_resident_forward_bands_at_the_cards_tiles():
    """With the card's constants a query tile of RES_FWD_OUTER_TILE rows
    streams key tiles of RES_FWD_INNER_TILE rows up to the causal limit.
    _res_fwd_tiles takes those at the training shape T (1024 items on an
    H100's 132 SMs), RES_FWD_FEW_ITEMS_TILES at the serving prefill S (128
    items), and 128 queries over 64-row key tiles above d = 64."""
    o, i = tfa.RES_FWD_OUTER_TILE, tfa.RES_FWD_INNER_TILE
    assert tfa._res_fwd_bands(1024, 1024, True) == tuple(
        (0, -(-(t + 1) * o // i)) for t in range(1024 // o))
    assert tfa._res_fwd_bands(1024, 1024, False) == ((0, 1024 // i),) * (
        1024 // o)
    assert tfa._res_fwd_tiles(1024, 8 * 16, 64, 132) == (o, i)
    assert tfa._res_fwd_tiles(1024, 16, 64, 132) == \
        tuple(tfa.RES_FWD_FEW_ITEMS_TILES)
    assert tfa._res_fwd_tiles(1024, 16, 128, 132) == (128, 64)
    assert tfa._res_fwd_tiles(1024, 8 * 16, 128, 132) == (128, 64)


@pytest.mark.parametrize("outer", [128, 64])
@pytest.mark.parametrize("sq,bh", [(1024, 16), (1000, 3), (77, 2)])
def test_resident_forward_items_cover_every_tile_longest_band_first(
        sq, bh, outer):
    """_res_fwd_items: every (query tile, head) exactly once, in an order
    whose causal band lengths never grow -- so a persistent CTA c, taking
    items c, c + grid, ..., meets its longest band first."""
    items = tfa._res_fwd_items(sq, bh, outer)
    n_outer = -(-sq // outer)
    assert sorted(items) == [(t, h) for t in range(n_outer)
                             for h in range(bh)]
    bands = tfa._res_fwd_bands(sq, sq, True, outer, 64)
    lengths = [bands[t][1] - bands[t][0] for t, _ in items]
    assert lengths == sorted(lengths, reverse=True)
    assert items[:bh] == tuple((n_outer - 1, h) for h in range(bh))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(32, 32), (16, 48), (48, 16)])
def test_bf16_plain_forward_matches_the_jax_pallas_forward(causal, shape):
    """bf16 q/k/v through the resident forward's plain version (what
    FlashAttention runs on the CPU: mha_reference and its lse) against the
    JAX _flash_fwd with _fwd_kernel in interpret mode (16-row tiles) on the
    same rounded values: o within phase 2's bf16 limits (2e-2 of max |ref|,
    each row within 1.5e-2), lse within 1e-5 of max |ref|."""
    from apex_tpu.ops.flash_attention import _flash_fwd

    rng = np.random.default_rng(47)
    sq, sk = shape
    q, k, v = (rng.normal(size=(1, 2, s, 16)).astype(np.float32)
               for s in (sq, sk, sk))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    scale = 16 ** -0.5
    o, lse = tfa._forward(tq, tk, tv, causal, scale, False, None)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    jo, jlse = _flash_fwd(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                            for t in (tq, tk, tv)), None, None, scale=scale,
                          causal=causal, blk_q=16, blk_k=16)
    ref = np.asarray(jo.astype(jnp.float32))
    got = o.float().numpy()
    err = np.abs(got - ref)
    assert err.max() <= 2e-2 * np.abs(ref).max()
    den = np.linalg.norm(ref, axis=-1)
    den = np.maximum(den, den.max(axis=-1, keepdims=True) * 1e-3)
    assert (np.linalg.norm(err, axis=-1) / den).max() <= 1.5e-2
    want = np.asarray(jlse).reshape(lse.shape)
    assert np.abs(lse.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", ["d36", "d36_strided", "stride_refused"])
def test_resident_forward_operands_padded_copy_round_trip(case, causal):
    """The resident forward's operand preparation (_tma_operands, as
    flash_attention_fwd calls it) gives contiguous padded copies for d = 36
    and for a row stride TMA refuses; the plain forward on the copies, o
    sliced back to d, and its lse equal the plain forward on the inputs as
    given within 1e-6 (fp32)."""
    rng = np.random.default_rng(45)
    d = 64 if case == "stride_refused" else 36
    width = {"d36": 36, "d36_strided": 44, "stride_refused": 68}[case]
    off = 3 if case == "d36_strided" else 0
    full = [torch.from_numpy(rng.normal(size=(2, 2, n, width)).astype(
        np.float32)) for n in (100, 120, 120)]
    q, k, v = (t[..., off:off + d] for t in full)
    scale = d ** -0.5
    ops_in, dp = tfa._tma_operands([q, k, v])
    assert dp == (40 if d == 36 else 64)
    assert all(t.is_contiguous() and t.shape[-1] == dp for t in ops_in)
    want_o, want_lse = tfa._forward(q, k, v, causal, scale, False, None)
    got_o, got_lse = tfa._forward(*ops_in, causal, scale, False, None)
    assert torch.all(got_o[..., d:] == 0)
    np.testing.assert_allclose(got_o[..., :d].numpy(), want_o.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the additive bias through FlashAttention (the card's route: the same
# Function, the plain versions on the CPU) against jax.grad of the JAX
# flash attention with impl="pallas" in interpret mode (8-row blocks at 24
# tokens), dbias included
# ---------------------------------------------------------------------------


def _bias(kind, seed=11):
    """(bias, its label): batch-only (2,1,24,24), head-only (1,2,24,24),
    BERT's padding row (2,1,1,24) with -10000 keys (dbias summed back
    through the expand), and a (2,1,24,24) bias with an all -inf row (that
    row outputs exactly 0)."""
    rng = np.random.default_rng(seed)
    shape = {"b": (2, 1, 24, 24), "h": (1, 2, 24, 24), "pad": (2, 1, 1, 24),
             "ninf": (2, 1, 24, 24)}[kind]
    bias = rng.normal(size=shape).astype(np.float32)
    if kind == "pad":
        bias[0, 0, 0, 19:] = -10000.0
        bias[1, 0, 0, 11:] = -10000.0
    if kind == "ninf":
        bias[0, 0, 5, :] = -np.inf
    return bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["b", "h", "pad", "ninf"])
def test_bias_values_and_grads_match_jax_pallas(kind, causal, dtype):
    """o, dq, dk, dv and dbias of flash_attention(q, k, v, bias) against
    jax.grad of the JAX Pallas kernels (interpret mode), on the same numpy
    inputs. fp32: 1e-4 absolute and relative (fp32 sums in another order).
    bf16 (q/k/v/g bf16, the bias fp32): each output within 2e-2 of its max
    |ref| (both round o and the grads to bf16 once, and delta reads the
    rounded o), dbias within 1e-2. An all -inf bias row gives o = 0 and
    zero grads on both sides."""
    q, k, v = _qkv(b=2, h=2, sq=24, sk=24, d=16, seed=12)
    g = np.random.default_rng(13).normal(size=q.shape).astype(np.float32)
    bias = _bias(kind)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    tb = torch.from_numpy(bias).requires_grad_()
    out = tfa.flash_attention(*ts, tb, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(g).to(tdt))
    got = [out.detach()] + [t.grad for t in ts] + [tb.grad]
    assert tb.grad.shape == tb.shape and tb.grad.dtype == torch.float32
    # the inputs as the torch side rounded them
    jin = [jnp.asarray(t.detach().float().numpy(), jdt) for t in ts]
    jg = jnp.asarray(torch.from_numpy(g).to(tdt).float().numpy(), jdt)
    jb = jnp.asarray(bias)

    def fwd(a, b_, c, bb):
        return jax_flash(a, b_, c, bb, causal=causal, impl="pallas",
                         block_q=16, block_k=16)

    jo, vjp = jax.vjp(fwd, *jin, jb)
    want = [jo] + list(vjp(jg))
    names = ("o", "dq", "dk", "dv", "dbias")
    for name, a, r in zip(names, got, want):
        a = a.float().numpy()
        r = np.asarray(r.astype(jnp.float32))
        assert a.shape == r.shape, name
        assert np.isfinite(a).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(a, r, atol=1e-4, rtol=1e-4,
                                       err_msg=name)
        else:
            lim = 1e-2 if name == "dbias" else 2e-2
            assert np.abs(a - r).max() <= lim * np.abs(r).max(), name
    if kind == "ninf":
        o = got[0].float().numpy()
        assert np.all(o[0, :, 5] == 0.0)
        assert np.all(tb.grad.numpy()[0, 0, 5] == 0.0)


def test_bias_without_grad_skips_dbias_and_no_grad_runs_the_plain_forward():
    """A bias that needs no grad gets none (the kernels skip the dbias
    work); under no_grad the CPU bias route is the plain forward with the
    kernel's arithmetic, which agrees with mha_reference (fp32, 1e-6)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed=3))
    bias = torch.from_numpy(_bias("pad"))
    qg = q.clone().requires_grad_()
    out = tfa.flash_attention(qg, k, v, bias)
    out.sum().backward()
    assert qg.grad is not None and bias.grad is None
    with torch.no_grad():
        plain = tfa.flash_attention(q, k, v, bias, causal=True)
    want = tfa.mha_reference(q, k, v, bias, causal=True)
    torch.testing.assert_close(plain, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", [(24, 24), (3, 1, 24, 24), (2, 3, 24, 24),
                                   (2, 1, 5, 24), (2, 1, 24, 7)])
def test_bias_shape_errors_match_the_reference(shape):
    """The reference's checks (flash_attention.py:1711-1721): rank 4, and
    b/h dims 1 or b/h (its words); a wrong sq/sk raises ValueError on both
    sides (broadcast_to's own error in JAX)."""
    q, k, v = _qkv(b=2, h=2, sq=24, sk=24, d=16)
    bias = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as jerr:
        jax_flash(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(bias),
                  impl="pallas", block_q=16, block_k=16)
    with pytest.raises(ValueError) as terr:
        tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            torch.from_numpy(bias))
    if len(shape) != 4 or shape[2:] == (24, 24):
        assert str(terr.value) == str(jerr.value)


def test_bias_kernel_arguments():
    """The pointer and element strides the kernels read: 0 on a size-1 or
    expanded dim, the bias never copied; a wrong shape or dtype raises."""
    q = torch.zeros(2, 3, 8, 16)
    pad = torch.zeros(2, 1, 1, 8)
    bias = tfa._canonical_bias(pad, 2, 3, 8, 8)
    args = tfa._bias_args(bias, q, 8, 8)
    assert args == (pad.data_ptr(), 8, 0, 0, 1)
    dense = torch.zeros(1, 3, 8, 8)
    assert tfa._bias_args(dense, q, 8, 8) == (dense.data_ptr(), 0, 64, 8, 1)
    assert tfa._bias_args(None, q, 8, 8) == (None, 0, 0, 0, 0)
    with pytest.raises(ValueError):
        tfa._bias_args(pad, q, 8, 8)
    with pytest.raises(TypeError):
        tfa._bias_args(dense.double(), q, 8, 8)


# ---------------------------------------------------------------------------
# segment ids, pad_id and the contiguous-segment bounds (the plain versions
# the kernels are held to on the card), and the window on the resident route
# ---------------------------------------------------------------------------

SEG_ROWS = (np.repeat([1, 2, 3, 9], [40, 30, 38, 20]),
            np.repeat([5, 9], [100, 28]))


def _seg_ids(s=128):
    return np.stack([r[:s] for r in SEG_ROWS]).astype(np.int32)


def _jax_and_port_grads(q, k, v, g, jfn, tfn):
    """Output and (dq, dk, dv) of the JAX function (jax.vjp) and of the
    port's (autograd) on the same numpy inputs."""
    jo, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    jg = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfn(*ts)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(g))
    return ([np.asarray(jo)] + [np.asarray(x) for x in jg],
            [out.detach().numpy()] + [t.grad.numpy() for t in ts])


@pytest.mark.parametrize("contiguous", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("stream", ["never", "always"])
def test_segment_ids_through_flash_attention_match_jax_pallas_and_xla(
        stream, causal, contiguous):
    """Segment ids with a pad id through FlashAttention on both plain routes
    (resident, streamed; bounds on or off) against the JAX kernels in
    interpret mode (impl="pallas", the same stream choice, 64/128 blocks)
    and the XLA mask (impl="xla"): outputs 2e-5, grads 1e-4; rows that see
    no key exactly 0 on every side."""
    q, k, v = _qkv(b=2, h=2, sq=128, sk=128, d=16, seed=31)
    g = np.random.default_rng(32).normal(size=q.shape).astype(np.float32)
    ids = _seg_ids()
    kw = dict(pad_id=9, causal=causal)
    tseg = (torch.from_numpy(ids),) * 2
    jseg = (jnp.asarray(ids),) * 2
    port = lambda a, b, c: tfa.flash_attention(  # noqa: E731
        a, b, c, segment_ids=tseg, contiguous_segments=contiguous,
        stream=stream, **kw)
    for impl in ("pallas", "xla"):
        want, got = _jax_and_port_grads(q, k, v, g, lambda a, b, c: jax_flash(
            a, b, c, segment_ids=jseg, contiguous_segments=contiguous,
            impl=impl, stream=stream, block_q=64, block_k=128, **kw), port)
        for name, a, r in zip(("o", "dq", "dk", "dv"), got, want):
            tol = ATOL if name == "o" else GRAD_TOL
            np.testing.assert_allclose(a, r, atol=tol, rtol=tol,
                                       err_msg=f"{impl} {name}")
    assert np.all(got[0][0, :, 108:] == 0.0) and np.all(got[0][1, :, 100:]
                                                        == 0.0)
    assert np.all(got[1][0, :, 108:] == 0.0)


@pytest.mark.parametrize("stream", ["never", "always"])
def test_contiguous_segments_equal_mask_only(stream, monkeypatch):
    """contiguous_segments=True (the bounds narrow every band) computes the
    same function as mask-only evaluation, values and grads (fp32, 1e-6),
    also with split lengths of one tile, where narrowed splits are empty
    and the forward merges empty partials (the fp32 backward takes whole
    bands, here of 32 rows kept)."""
    for name in ("FWD_SPLIT_TILES", "BWD_SPLIT_TILES",
                 "FWD_F32_SPLIT_TILES"):
        monkeypatch.setattr(tfa, name, 1)
    monkeypatch.setattr(tfa, "FWD_OUTER_TILE", 32)
    monkeypatch.setattr(tfa, "FWD_INNER_TILE", 16)
    monkeypatch.setattr(tfa, "FWD_F32_OUTER_TILE", 32)
    monkeypatch.setattr(tfa, "FWD_F32_INNER_TILE", 16)
    monkeypatch.setattr(tfa, "BWD_OUTER_TILE", 32)
    monkeypatch.setattr(tfa, "BWD_INNER_TILE", 16)
    monkeypatch.setattr(tfa, "RES_BWD_F32_OUTER_TILE", 32)
    monkeypatch.setattr(tfa, "RES_FWD_OUTER_TILE", 32)
    monkeypatch.setattr(tfa, "RES_FWD_INNER_TILE", 16)
    monkeypatch.setattr(tfa, "RES_BWD_DQ_INNER_TILE", 16)
    q, k, v = _qkv(b=2, h=2, sq=128, sk=128, d=16, seed=33)
    g = torch.from_numpy(
        np.random.default_rng(34).normal(size=q.shape).astype(np.float32))
    seg = (torch.from_numpy(_seg_ids()),) * 2
    outs = []
    for contiguous in (True, False):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = tfa.flash_attention(*ts, segment_ids=seg, pad_id=9,
                                  causal=True, stream=stream,
                                  contiguous_segments=contiguous)
        out.backward(g)
        outs.append([out.detach()] + [t.grad for t in ts])
    want = tfa.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                             segment_ids=seg, pad_id=9, causal=True)
    torch.testing.assert_close(outs[0][0], want, atol=2e-5, rtol=2e-5)
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("pad", [None, 9])
@pytest.mark.parametrize("blk_q,blk_k", [(16, 16), (32, 16), (16, 64),
                                         (128, 128), (64, 32)])
def test_seg_metadata_matches_jax(blk_q, blk_k, pad):
    """The ported _seg_metadata equals the JAX one at equal tile sizes:
    bounds both ways and each tile's (min, max) ids, with a pad-id suffix
    (all-padding tiles get empty ranges; no range reaches the suffix)."""
    from apex_tpu.ops.flash_attention import _seg_metadata as jmeta

    q_seg = _seg_ids()
    kv_seg = np.stack([np.repeat([1, 2, 3, 9], [20, 50, 26, 32]),
                       np.repeat([4, 5, 9], [64, 32, 32])]).astype(np.int32)
    want = jmeta(jnp.asarray(q_seg), jnp.asarray(kv_seg), blk_q, blk_k, pad)
    got = tfa._seg_metadata(torch.from_numpy(q_seg),
                            torch.from_numpy(kv_seg), blk_q, blk_k, pad)
    for a, r in zip(got, want):
        assert a.dtype == torch.int32 and a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


@pytest.mark.parametrize("pad", [None, 9])
@pytest.mark.parametrize("sq,sk,blk_q,blk_k", [(100, 77, 32, 16),
                                               (77, 100, 64, 64),
                                               (128, 50, 16, 128)])
def test_seg_metadata_ragged_ends_keep_every_valid_pair(sq, sk, blk_q,
                                                        blk_k, pad):
    """Ragged ends (lengths the tiles do not divide): the tile (min, max) of
    the real rows are exact but for the last tile's max, which takes one
    more than the largest id (monotone, no real id); every pair with equal
    non-pad ids lies inside both bounds."""
    q_seg = torch.from_numpy(_seg_ids()[:, :sq].copy())
    kv_seg = torch.from_numpy(_seg_ids()[:, :sk].copy())
    bq, bk, qmm, kmm = tfa._seg_metadata(q_seg, kv_seg, blk_q, blk_k, pad)
    for ids, mm, blk in ((q_seg, qmm, blk_q), (kv_seg, kmm, blk_k)):
        n = -(-ids.shape[1] // blk)
        for t in range(n):
            tile = ids[:, t * blk:(t + 1) * blk]
            assert torch.equal(mm[:, 0, t], tile.amin(-1))
            if tile.shape[1] == blk:
                assert torch.equal(mm[:, 1, t], tile.amax(-1))
    valid = q_seg[:, :, None] == kv_seg[:, None, :]
    if pad is not None:
        valid &= (kv_seg != pad)[:, None, :]
    qt = torch.arange(sq) // blk_q
    kt = torch.arange(sk) // blk_k
    for b in range(2):
        lo_q, hi_q = bq[b, 0][qt][:, None], bq[b, 1][qt][:, None]
        lo_k, hi_k = bk[b, 0][kt][None, :], bk[b, 1][kt][None, :]
        inside = ((lo_q <= kt[None, :]) & (kt[None, :] < hi_q)
                  & (lo_k <= qt[:, None]) & (qt[:, None] < hi_k))
        assert not (valid[b] & ~inside).any()


def test_contiguous_segments_check_ids_and_warn_once(monkeypatch):
    """With contiguous_segments, ids that are not non-decreasing raise the
    reference's ValueError (both sides); without it, non-decreasing ids
    give the one-time hint to opt in (both sides), and a wrong ids shape
    raises the reference's ValueError."""
    import apex_tpu.ops.flash_attention as jfa

    q, k, v = _qkv(b=1, h=1, sq=16, sk=16, d=8)
    bad = np.array([[1, 2, 1] + [3] * 13], np.int32)
    good = np.array([[1] * 8 + [2] * 8], np.int32)
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    for fn, args, mk in ((jax_flash, jargs, jnp.asarray),
                         (tfa.flash_attention, targs, torch.from_numpy)):
        with pytest.raises(ValueError, match="q segment ids are not "
                           "non-decreasing"):
            fn(*args, segment_ids=(mk(bad), mk(good)),
               contiguous_segments=True)
        with pytest.raises(ValueError, match="kv segment ids are not "
                           "non-decreasing"):
            fn(*args, segment_ids=(mk(good), mk(bad)),
               contiguous_segments=True)
        with pytest.raises(ValueError, match="do not match"):
            fn(*args, segment_ids=(mk(good[:, :8]), mk(good)))
    monkeypatch.setattr(jfa, "_WARNED_PACKED_OPT_IN", False)
    monkeypatch.setattr(tfa, "_WARNED_PACKED_OPT_IN", False)
    for fn, args, mk in ((jax_flash, jargs, jnp.asarray),
                         (tfa.flash_attention, targs, torch.from_numpy)):
        with pytest.warns(UserWarning, match="contiguous_segments=True"):
            fn(*args, segment_ids=(mk(good), mk(good)))
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("error")
            fn(*args, segment_ids=(mk(good), mk(good)))  # once only
            fn(*args, segment_ids=(mk(bad), mk(bad)))  # mask-only: fine


@pytest.mark.parametrize("stream", ["never", "always"])
def test_causal_row_whose_same_segment_keys_lie_above_is_zero(stream):
    """tests/test_flash_attention.py:353 on the port: query 0 in segment 2,
    every segment-2 key above the diagonal: its output and dQ are exactly 0
    on both plain routes, as on the JAX kernel and XLA path."""
    q, k, v = _qkv(b=2, h=2, sq=128, sk=128, d=16, seed=35)
    q_seg = np.r_[[2], np.ones(127, int)][None].repeat(2, 0).astype(np.int32)
    kv_seg = np.repeat([1, 2], [64, 64])[None].repeat(2, 0).astype(np.int32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(
        *ts, segment_ids=(torch.from_numpy(q_seg), torch.from_numpy(kv_seg)),
        causal=True, stream=stream)
    out.sum().backward()
    assert torch.all(out[:, :, 0] == 0.0) and torch.all(ts[0].grad[:, :, 0]
                                                        == 0.0)
    want = np.asarray(jax_flash(
        *(jnp.asarray(a) for a in (q, k, v)),
        segment_ids=(jnp.asarray(q_seg), jnp.asarray(kv_seg)), causal=True,
        impl="pallas", block_q=64, block_k=128, stream=stream))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("stream", ["never", "always"])
def test_window_composes_with_segments(stream, causal):
    """Window + packed ids (tests/test_flash_attention.py:461) on both
    plain routes, with the bounds, against the JAX XLA mask: values 2e-5,
    grads 1e-4."""
    q, k, v = _qkv(b=2, h=2, sq=128, sk=128, d=16, seed=36)
    g = np.random.default_rng(37).normal(size=q.shape).astype(np.float32)
    ids = _seg_ids()
    kw = dict(pad_id=9, causal=causal, window=24)
    want, got = _jax_and_port_grads(
        q, k, v, g,
        lambda a, b, c: jax_flash(a, b, c, segment_ids=(jnp.asarray(ids),) * 2,
                                  impl="xla", **kw),
        lambda a, b, c: tfa.flash_attention(
            a, b, c, segment_ids=(torch.from_numpy(ids),) * 2, stream=stream,
            contiguous_segments=True, **kw))
    for name, a, r in zip(("o", "dq", "dk", "dv"), got, want):
        tol = ATOL if name == "o" else GRAD_TOL
        np.testing.assert_allclose(a, r, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_resident_window_matches_jax_pallas(causal):
    """stream='never' with a window: FlashAttention's resident route (the
    plain forward and backward with the window, as the resident kernels
    take it on the card) against the JAX resident kernels in interpret mode
    with the same window: values 2e-5, grads 1e-4."""
    q, k, v = _qkv(b=1, h=2, sq=48, sk=48, d=16, seed=38)
    g = np.random.default_rng(39).normal(size=q.shape).astype(np.float32)
    kw = dict(causal=causal, window=10, stream="never")
    want, got = _jax_and_port_grads(
        q, k, v, g,
        lambda a, b, c: jax_flash(a, b, c, impl="pallas", block_q=16,
                                  block_k=16, **kw),
        lambda a, b, c: tfa.flash_attention(a, b, c, **kw))
    for name, a, r in zip(("o", "dq", "dk", "dv"), got, want):
        tol = ATOL if name == "o" else GRAD_TOL
        np.testing.assert_allclose(a, r, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("window", [1, 40, 200])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(256, 256), (300, 77), (77, 300)])
def test_resident_bands_take_the_window(sq, sk, causal, window):
    """_res_fwd_bands / _res_bwd_bands with a window equal the JAX kernels'
    loop limits through their _window_k_range / _window_q_range at the
    same tiles, as k_tiles / q_tiles compute them on the card."""
    from apex_tpu.ops.flash_attention import _window_k_range as jk
    from apex_tpu.ops.flash_attention import _window_q_range as jq

    for outer, inner in ((128, 128), (128, 64)):
        nq, nk = -(-sq // outer), -(-sk // inner)
        want = []
        for qi in range(nq):
            n = nk
            if causal:
                n = int(np.clip(((qi + 1) * outer + inner - 1) // inner, 0,
                                n))
            lo, hi = jk(0, n, qi, outer, inner, 0, 0, causal, window)
            want.append((int(lo), int(hi)))
        got = tfa._res_fwd_bands(sq, sk, causal, outer, inner, window)
        # the kernels clip an empty band to hi = lo (seg_band)
        assert [(lo, max(lo, hi)) for lo, hi in got] == [
            (lo, max(lo, hi)) for lo, hi in want]
        assert tfa._res_bwd_bands(sq, sk, causal, True, outer, inner,
                                  window) == got
        nq_i = -(-sq // inner)
        want = []
        for ki in range(-(-sk // outer)):
            start = int(np.clip(ki * outer // inner, 0, nq_i)) if causal \
                else 0
            lo, hi = jq(start, nq_i, ki, inner, outer, 0, 0, causal, window)
            want.append((int(lo), int(max(lo, hi))))
        got = tfa._res_bwd_bands(sq, sk, causal, False, outer, inner, window)
        assert [(lo, max(lo, hi)) for lo, hi in got] == want


@pytest.mark.parametrize("pad", [None, 9])
def test_seg_ranges_are_the_equality_mask_of_contiguous_ids(pad):
    """_seg_ranges (what the kernels test on contiguous ids: each row sees
    the other side's rows [lo, hi)) gives exactly the equality-and-pad mask
    of _seg_valid, both ways, with unequal q and kv ids and lengths."""
    q_seg = torch.from_numpy(_seg_ids())
    kv_seg = torch.from_numpy(np.stack(
        [np.repeat([1, 2, 3, 9], [20, 50, 26, 4]),
         np.repeat([4, 5, 9], [64, 30, 6])]).astype(np.int32))
    seg = tfa._as_seg((q_seg, kv_seg), pad, True, torch.zeros(2, 1, 128, 8),
                      torch.zeros(2, 1, 100, 8))
    valid = tfa._seg_valid(seg, 0, 0, 128, 100)[:, 0]
    for own_is_q, mask in ((True, valid), (False, valid.transpose(1, 2))):
        r = tfa._seg_ranges(seg, own_is_q)
        pos = torch.arange(mask.shape[2])
        got = (r[:, 0, :, None] <= pos) & (pos < r[:, 1, :, None])
        assert torch.equal(got, mask)
