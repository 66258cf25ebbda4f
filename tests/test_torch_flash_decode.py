"""apex_tpu_torch.ops.flash_decode against the JAX package on the CPU.

The single-query plain version against the JAX ``paged_attention_reference``
(fp32, atol 2e-5): random block tables, GQA head groups, the window, and an
idle slot (length 0) that must be exactly 0. The K-query plain version
against the JAX ``paged_attention_multi_reference`` and the JAX
``flash_decode_multi`` Pallas kernel in interpret mode (fp32, atol 1e-5),
with the window and GQA heads; K = 1 equals the single-query decode, rows
that see no key are exactly 0, and the wrappers validate and never fall
back. The CUDA kernels are held against the plain versions by
``chip_smoke.py``.

The split routes' host-side rules: :func:`decode_splits` over fixed cases
and as a property (at least one split, never more than the pages), with
the bf16 and the fp32 constants, :func:`decode_route`,
:func:`decode_span_pages`, the key ranges the
kernel derives on the device (:func:`split_keys`: every row's visible keys
in exactly one split, for random lengths, windows, K and split counts), a
plain split-then-combine of those ranges against the JAX references (fp32,
atol 2e-5; at both routes' split counts), and the launch arguments the
wrapper hands the kernel on both split routes, with lengths and tables
that raise if the host reads them.
"""

import importlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

from apex_tpu.ops.flash_decode import (
    flash_decode_multi as jax_flash_decode_multi,
    paged_attention_multi_reference as jax_paged_multi,
    paged_attention_reference as jax_paged,
)
from apex_tpu_torch.ops.flash_attention import mha_reference

# the package re-exports a function named like this module
tfd = importlib.import_module("apex_tpu_torch.ops.flash_decode")

ATOL = 2e-5


def _case(h=4, kh=2, d=16, blk=8, n=13, b=3, seed=3):
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(n, kh, blk, d)).astype(np.float32)
    vp = rng.normal(size=(n, kh, blk, d)).astype(np.float32)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n))[:b * 4].reshape(b, 4)
    tables = tables.astype(np.int32)
    lengths = np.array([17, 0, 32][:b], np.int32)  # incl. an idle slot
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4), (6, 2)])
def test_plain_matches_jax(window, heads):
    h, kh = heads
    arrs = _case(h=h, kh=kh)
    ref = np.asarray(jax_paged(*(jnp.asarray(a) for a in arrs),
                               window=window))
    got = tfd.flash_decode(*(torch.from_numpy(a) for a in arrs),
                           window=window)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    assert np.all(got.numpy()[1] == 0.0) and np.all(ref[1] == 0.0)


def test_plain_is_the_last_row_of_dense_attention():
    q, kp, vp, tables, _ = _case(h=4, kh=2, b=1)
    L = 19
    out = tfd.paged_attention_reference(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.tensor([L]))
    # (nb, kh, blk, d) -> positions-major (nb*blk, kh, d), GQA-broadcast
    k = kp[tables[0]].transpose(0, 2, 1, 3).reshape(-1, 2, 16)[:L]
    v = vp[tables[0]].transpose(0, 2, 1, 3).reshape(-1, 2, 16)[:L]
    k = np.repeat(k, 2, axis=1).transpose(1, 0, 2)[None]
    v = np.repeat(v, 2, axis=1).transpose(1, 0, 2)[None]
    dense = mha_reference(torch.from_numpy(q)[:, :, None, :],
                          torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), dense[:, :, 0].numpy(),
                               atol=ATOL)


def test_validation_and_no_fallback_from_the_kernel_wrapper():
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _case())
    with pytest.raises(ValueError):
        tfd.flash_decode(q[:, :3], kp, vp, tables, lengths)  # 3 % 2 != 0
    with pytest.raises(ValueError):
        tfd.flash_decode(q, kp, vp, tables, lengths, window=0)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfd.flash_decode_fwd(q, kp, vp, tables, lengths)


MULTI_ATOL = 1e-5


def _multi_case(h=4, kh=2, kq=3, d=16, blk=8, n=13, seed=6,
                lengths=(17, 0, 32)):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    kp = rng.normal(size=(n, kh, blk, d)).astype(np.float32)
    vp = rng.normal(size=(n, kh, blk, d)).astype(np.float32)
    q = rng.normal(size=(b, h, kq, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n))[:b * 4].reshape(b, 4)
    return q, kp, vp, tables.astype(np.int32), np.array(lengths, np.int32)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4), (6, 2)])
def test_multi_plain_matches_jax_reference_and_pallas(window, heads):
    h, kh = heads
    arrs = _multi_case(h=h, kh=kh)
    jarrs = [jnp.asarray(a) for a in arrs]
    ref = np.asarray(jax_paged_multi(*jarrs, window=window))
    ker = np.asarray(jax_flash_decode_multi(*jarrs, window=window,
                                            impl="pallas"))
    got = tfd.flash_decode_multi(*(torch.from_numpy(a) for a in arrs),
                                 window=window).numpy()
    np.testing.assert_allclose(got, ref, atol=MULTI_ATOL)
    np.testing.assert_allclose(got, ker, atol=MULTI_ATOL)
    assert np.all(got[1] == 0.0)  # idle slot: every query exactly 0


@pytest.mark.parametrize("window", [None, 5])
def test_multi_rows_equal_single_query_decode_at_their_lengths(window):
    """Query j of a slot equals a single-query decode at length
    ``lengths - (K-1-j)``: the exactness speculative verify rests on."""
    q, kp, vp, tables, lengths = (torch.from_numpy(a)
                                  for a in _multi_case(kq=4))
    multi = tfd.flash_decode_multi(q, kp, vp, tables, lengths, window=window)
    for j in range(4):
        lj = torch.clamp(lengths - (4 - 1 - j), min=0)
        single = tfd.flash_decode(q[:, :, j].contiguous(), kp, vp, tables,
                                  lj, window=window)
        np.testing.assert_allclose(multi[:, :, j].numpy(), single.numpy(),
                                   atol=MULTI_ATOL)


def test_multi_k1_equals_flash_decode():
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _multi_case(
        kq=1, lengths=(19, 11, 1)))
    one = tfd.flash_decode(q[:, :, 0].contiguous(), kp, vp, tables, lengths)
    multi = tfd.flash_decode_multi(q, kp, vp, tables, lengths)[:, :, 0]
    np.testing.assert_allclose(multi.numpy(), one.numpy(), atol=1e-6)


@pytest.mark.parametrize("window", [None, 3])
def test_multi_rows_with_no_visible_key_are_exactly_zero(window):
    """A right-aligned chunk's padding rows see <= 0 keys (here 8 queries
    over lengths 3, 0 and 7): they output exactly 0, never NaN."""
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _multi_case(
        kq=8, lengths=(3, 0, 7)))
    out = tfd.flash_decode_multi(q, kp, vp, tables, lengths, window=window)
    assert torch.isfinite(out).all()
    assert torch.all(out[0, :, :5] == 0.0)  # visible counts -4 .. 0
    assert torch.all(out[0, :, 5:] != 0.0)
    assert torch.all(out[1] == 0.0)
    assert torch.all(out[2, :, 0] == 0.0)  # 7 - 7 = 0 keys; j >= 1 see some
    assert torch.all(out[2, :, 1:] != 0.0)


def test_multi_validation_and_no_fallback():
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _multi_case())
    with pytest.raises(ValueError, match="multiple of kv_heads"):
        tfd.flash_decode_multi(q[:, :3], kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="head_dim"):
        tfd.flash_decode_multi(q[..., :8], kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="head_dim"):
        tfd.flash_decode_multi(q, kp, vp[..., :8], tables, lengths)
    with pytest.raises(ValueError, match="window"):
        tfd.flash_decode_multi(q, kp, vp, tables, lengths, window=0)
    with pytest.raises(RuntimeError, match="no backward"):
        tfd.flash_decode_multi(q.clone().requires_grad_(), kp, vp, tables,
                               lengths)
    # the kernel wrapper launches or raises: a CPU tensor never falls back
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfd.flash_decode_multi_fwd(q, kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfd.flash_decode_fwd(q[:, :, 0], kp, vp, tables, lengths, window=4)
    from apex_tpu_torch import ops

    assert ops.KERNEL_WRAPPERS["flash_decode_multi"] \
        is tfd.flash_decode_multi_fwd
    assert "flash_decode_multi" in ops.launch_counts()


# --- the split route: split count, routes, key ranges, combine -------------


@pytest.mark.parametrize("shape,want", [
    ((8, 16, 1, 64), 2),     # the serve's decode: 128 groups, 64 pages
    ((8, 16, 1, 9), 1),      # window 128 over 16-token pages: 9 pages
    ((1, 16, 16, 64), 1),    # the 256-row chunk: 256 groups fill the card
    ((1, 16, 1, 512), 16),   # one slot over 8192 keys
    ((1, 16, 1, 1024), 16),  # one slot over 16384 keys: the CTA cap
    ((1, 1, 1, 3), 1),       # fewer pages than a split's share
    ((1, 1, 1, 100000), 256),  # the split cap
])
def test_decode_splits_fixed_cases(shape, want):
    assert tfd.decode_splits(*shape, sms=132) == want


@settings(max_examples=200, deadline=None, derandomize=True)
@given(b=st.integers(1, 64), kh=st.integers(1, 32), tiles=st.integers(1, 32),
       pages=st.integers(1, 4096), sms=st.integers(1, 264))
def test_decode_splits_property(b, kh, tiles, pages, sms):
    """At least one split; never more than the pages a group can see (no
    split is empty at full length) nor the kernel's cap."""
    n = tfd.decode_splits(b, kh, tiles, pages, sms)
    assert 1 <= n <= min(pages, tfd.DECODE_MAX_SPLITS)
    if n > 1:  # splitting keeps within the CTAs the card is meant to hold
        assert b * kh * tiles * n <= tfd.DECODE_SPLIT_CTAS * sms


@pytest.mark.parametrize("dtype,d,blk,aligned,route", [
    (torch.bfloat16, 64, 16, True, "split"),
    (torch.bfloat16, 128, 8, True, "split"),
    (torch.bfloat16, 36, 16, True, "gather"),   # d % 8
    (torch.bfloat16, 64, 12, True, "gather"),   # blk % 8
    (torch.bfloat16, 64, 16, False, "gather"),  # off 16 bytes
    (torch.float32, 64, 16, True, "f32_split"),
])
def test_decode_route(dtype, d, blk, aligned, route):
    assert tfd.decode_route(dtype, d, blk, aligned) == route


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("blk", [8, 12, 16])
@pytest.mark.parametrize("d", [64, 36, 128])
def test_decode_route_f32(d, blk, aligned):
    """fp32 up to head_dim 128 takes the fp32 split route whatever the
    block size and alignment (4-byte copies where 16-byte ones do not
    apply); head_dim 160 the first port's single-query kernel."""
    assert tfd.decode_route(torch.float32, d, blk, aligned) == "f32_split"
    assert tfd.decode_route(torch.float32, 160, blk, aligned) == "gather"


@pytest.mark.parametrize("shape,want", [
    ((8, 16, 1, 64), 3),    # the decode: 128 groups, 3 CTAs an SM
    ((8, 16, 1, 17), 2),    # window 256 over 16-token pages: 17 pages
    ((1, 16, 16, 64), 1),   # the chunk: 16 tiles of 16 rows, 256 groups
    ((1, 16, 2, 64), 4),    # a 32-row chunk: 32 groups, 4 splits of 16
    ((1, 16, 1, 512), 24),  # one slot over 8192 keys: the CTA cap
    ((1, 1, 1, 3), 1),
])
def test_decode_splits_f32_fixed_cases(shape, want):
    assert tfd.decode_splits(*shape, sms=132, f32=True) == want


@settings(max_examples=100, deadline=None, derandomize=True)
@given(b=st.integers(1, 64), kh=st.integers(1, 32), tiles=st.integers(1, 32),
       pages=st.integers(1, 4096), sms=st.integers(1, 264))
def test_decode_splits_f32_property(b, kh, tiles, pages, sms):
    n = tfd.decode_splits(b, kh, tiles, pages, sms, f32=True)
    assert 1 <= n <= min(pages, tfd.DECODE_MAX_SPLITS)
    if n > 1:
        assert b * kh * tiles * n <= tfd.DECODE_F32_SPLIT_CTAS * sms


def test_decode_span_pages():
    assert tfd.decode_span_pages(64, 16, None) == 64
    assert tfd.decode_span_pages(64, 16, 128) == 9   # 128 keys cross <= 9
    assert tfd.decode_span_pages(64, 16, 128, kq=5) == 10
    assert tfd.decode_span_pages(4, 16, 1000) == 4


def _row_sets(length, kq, rows, window, s_max, splits, blk, tile):
    """Per row: its visible keys, and the keys each split gives it."""
    out = []
    for r0 in range(0, rows, tile):
        r1 = min(r0 + tile, rows)
        ranges = [tfd.split_keys(length, s, splits, blk, window, kq,
                                 (r0, r1), s_max) for s in range(splits)]
        for r in range(r0, r1):
            lo, hi = tfd.row_keys(length, r, kq, window, s_max)
            mine = [set(range(max(lo, ka), min(hi, kb))) for ka, kb in ranges]
            out.append((set(range(lo, hi)), mine, ranges))
    return out


@settings(max_examples=150, deadline=None, derandomize=True)
@given(blk=st.sampled_from([8, 16, 24, 32, 128]), mb=st.integers(1, 40),
       frac=st.floats(0, 1), window=st.one_of(st.none(), st.integers(1, 300)),
       kq=st.integers(1, 40), g=st.integers(1, 4),
       splits=st.integers(1, 70))
def test_split_keys_cover_each_row_once(blk, mb, frac, window, kq, g,
                                        splits):
    """For random lengths (0 to max_blocks * blk), windows, K and split
    counts, the splits' key ranges give each row its visible keys exactly
    once; ranges are whole pages inside the table, and in order."""
    s_max = mb * blk
    length = int(round(frac * s_max))
    for seen, mine, ranges in _row_sets(length, kq, g * kq, window, s_max,
                                        splits, blk, tfd.DECODE_ROWS):
        assert sum(len(m) for m in mine) == len(seen)
        assert set().union(*mine) == seen
        live = [(ka, kb) for ka, kb in ranges if kb > ka]
        assert all(ka % blk == 0 and kb % blk == 0 and kb <= s_max
                   for ka, kb in live)
        assert all(a[1] <= b[0] for a, b in zip(live, live[1:]))
        pages = (live[-1][1] - live[0][0]) // blk if live else 0
        assert len(live) == min(splits, pages)  # no empty split in between


def _split_combine(q, kp, vp, tables, lengths, window, splits, kq=None):
    """The split kernel's arithmetic in fp32 numpy: for each (slot, kv
    head, 16-row tile), each split's (m, l, acc) over its keys
    (:func:`split_keys`), merged in split order; a row with no key is 0."""
    single = kq is None
    if single:
        q = q[:, :, None]
        kq = 1
    b, h, _, d = q.shape
    _, kh, blk, _ = kp.shape
    g = h // kh
    s_max = tables.shape[1] * blk
    scale = d ** -0.5
    out = np.zeros(q.shape, np.float32)
    for bi in range(b):
        n = int(lengths[bi])
        pos = np.arange(s_max)
        kd = kp[tables[bi]].transpose(1, 0, 2, 3).reshape(kh, s_max, d)
        vd = vp[tables[bi]].transpose(1, 0, 2, 3).reshape(kh, s_max, d)
        for ki in range(kh):
            rows = q[bi, ki * g:(ki + 1) * g].reshape(g * kq, d)
            for r0 in range(0, g * kq, tfd.DECODE_ROWS):
                r1 = min(r0 + tfd.DECODE_ROWS, g * kq)
                parts = [tfd.split_keys(n, s, splits, blk, window, kq,
                                        (r0, r1), s_max)
                         for s in range(splits)]
                for r in range(r0, r1):
                    lo, hi = tfd.row_keys(n, r, kq, window, s_max)
                    m, l, acc = -np.inf, np.float32(0), np.zeros(d, np.float32)
                    for ka, kb in parts:  # split order
                        sel = (pos >= max(lo, ka)) & (pos < min(hi, kb))
                        if not sel.any():
                            continue
                        sc = (kd[ki, sel] @ rows[r]) * scale
                        ms = sc.max()
                        p = np.exp(sc - ms)
                        mn = max(m, ms)
                        a_old, a_new = np.exp(m - mn), np.exp(ms - mn)
                        l = l * a_old + p.sum() * a_new
                        acc = acc * a_old + (p @ vd[ki, sel]) * a_new
                        m = mn
                    gi, j = divmod(r, kq)
                    out[bi, ki * g + gi, j] = acc / l if l > 0 else 0.0
    return out[:, :, 0] if single else out


@pytest.mark.parametrize("splits", [1, 2, 7, 50])
@pytest.mark.parametrize("window,heads", [(None, (4, 4)), (5, (4, 4)),
                                          (None, (6, 2)), (7, (6, 2))])
def test_split_then_combine_matches_jax(splits, window, heads):
    """1, 2, 7 splits and more splits than live pages, with and without the
    window, GQA: the same as the JAX reference (fp32, atol 2e-5); the idle
    slot exactly 0."""
    h, kh = heads
    q, kp, vp, tables, lengths = _case(h=h, kh=kh)
    got = _split_combine(q, kp, vp, tables, lengths, window, splits)
    ref = np.asarray(jax_paged(*(jnp.asarray(a) for a in
                                 (q, kp, vp, tables, lengths)),
                               window=window))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert np.all(got[1] == 0.0)


@pytest.mark.parametrize("splits", [1, 2, 7, 50])
@pytest.mark.parametrize("window", [None, 5])
def test_multi_split_then_combine_matches_jax(splits, window):
    """K = 9 queries of a GQA group of 2: 18 rows, two 16-row tiles, some
    rows with no key; against the JAX K-query reference (fp32, atol
    2e-5)."""
    arrs = _multi_case(h=4, kh=2, kq=9, n=17, lengths=(17, 0, 32, 5))
    q, kp, vp, tables, lengths = arrs
    got = _split_combine(q, kp, vp, tables, lengths, window, splits, kq=9)
    ref = np.asarray(jax_paged_multi(*(jnp.asarray(a) for a in arrs),
                                     window=window))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert np.all(got[1] == 0.0) and np.all(got[3, :, :4] == 0.0)


def _long_case(h, kh, kq, lengths, d=16, blk=8, mb=12, seed=9):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    n = b * mb + 1
    kp = rng.normal(size=(n, kh, blk, d)).astype(np.float32)
    vp = rng.normal(size=(n, kh, blk, d)).astype(np.float32)
    q = rng.normal(size=(b, h, kq, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n))[:b * mb].reshape(b, mb)
    return q, kp, vp, tables.astype(np.int32), np.array(lengths, np.int32)


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 9])
@pytest.mark.parametrize("window,heads", [(None, (2, 2)), (30, (2, 2)),
                                          (None, (4, 2)), (11, (4, 2))])
def test_f32_split_then_combine_matches_jax(splits, window, heads):
    """The fp32 route's split counts (3 at the generate's decode and verify
    shapes, 4 over a window) on longer rows: K = 40 trailing queries over
    12 pages of 8 keys (40 or 80 rows a (slot, kv head): 16-row tiles
    with a short last one), GQA, an idle slot, rows that see no key (a slot
    of 20 keys: its first 20 queries), the window; against the JAX K-query
    reference (fp32, atol 2e-5), blind rows exactly 0."""
    h, kh = heads
    arrs = _long_case(h, kh, 40, (90, 0, 20, 57))
    q, kp, vp, tables, lengths = arrs
    got = _split_combine(q, kp, vp, tables, lengths, window, splits, kq=40)
    ref = np.asarray(jax_paged_multi(*(jnp.asarray(a) for a in arrs),
                                     window=window))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert np.all(got[1] == 0.0) and np.all(got[2, :, :20] == 0.0)
    assert np.all(got[2, :, 20:] != 0.0)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("window,heads", [(None, (4, 4)), (17, (4, 4)),
                                          (None, (8, 2)), (5, (8, 2))])
def test_f32_single_query_split_then_combine_matches_jax(splits, window,
                                                         heads):
    """The fp32 decode: 16-row tiles of the group's g rows over 12 pages of
    8 keys (a length on a page's end, one past it, 1, idle), against the
    JAX single-query reference (fp32, atol 2e-5)."""
    h, kh = heads
    q, kp, vp, tables, lengths = _long_case(h, kh, 1, (96, 33, 1, 0, 64))
    q = q[:, :, 0]
    got = _split_combine(q, kp, vp, tables, lengths, window, splits)
    ref = np.asarray(jax_paged(*(jnp.asarray(a) for a in
                                 (q, kp, vp, tables, lengths)),
                               window=window))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert np.all(got[3] == 0.0)


class _NoHostRead(torch.Tensor):
    """A tensor whose values the host must not read (a device value)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.item, torch.Tensor.tolist,
                    torch.Tensor.cpu, torch.Tensor.numpy,
                    torch.Tensor.__bool__, torch.Tensor.__int__,
                    torch.Tensor.__index__):
            raise AssertionError(f"the wrapper read a device value "
                                 f"({func.__name__})")
        return super().__torch_function__(func, types, args, kwargs or {})


@pytest.mark.parametrize("entry,kq,window,route,splits", [
    ("apex_flash_decode", 1, None, "split", 2),
    ("apex_flash_decode", 1, 128, "split", 1),
    ("apex_flash_decode_multi", 5, None, "split", 2),
    ("apex_flash_decode_multi", 256, None, "split", 1),
])
def test_launch_arguments_from_shapes_only(monkeypatch, entry, kq, window,
                                           route, splits):
    """The wrapper's launch (``_launch``) on the serve's shapes: the split
    count from :func:`decode_splits`, a workspace of groups x splits x 16
    rows x (64 + 2) floats and a counter a group; the lengths and tables
    are never read on the host."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(tfd.build, "load", lambda: Lib())
    monkeypatch.setattr(tfd.build, "current_stream", lambda dev: 7)
    monkeypatch.setattr(tfd, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(tfd, "_SCRATCH", {})
    b, h, kh, blk, d, nb, mb = (8 if kq != 256 else 1), 16, 16, 16, 64, 40, 64
    q = torch.zeros(b, h, kq, d, dtype=torch.bfloat16)
    if kq == 1:
        q = q[:, :, 0].contiguous()
    kp = torch.zeros(nb, kh, blk, d, dtype=torch.bfloat16)
    tables = torch.zeros(b, mb, dtype=torch.int32).as_subclass(_NoHostRead)
    lens = torch.full((b,), 700, dtype=torch.int32).as_subclass(_NoHostRead)
    o = torch.empty_like(q)
    with pytest.raises(AssertionError, match="device value"):
        lens.item()
    tfd._launch(entry, q, kp, kp, tables, lens, o, kq, 0.125, window, None)
    (name, args), = calls
    assert name == entry
    n_split, dtype_code = args[-3], args[-2]
    assert n_split == splits and dtype_code == tfd.build.DTYPES[q.dtype]
    tiles = -(-(h // kh * kq) // tfd.DECODE_ROWS)
    ws, cnt, _ = tfd._SCRATCH[(q.get_device(), 7)]
    assert ws.numel() == b * kh * tiles * splits * tfd.DECODE_ROWS * (64 + 2)
    assert cnt.numel() == b * kh * tiles and not cnt.any()
    assert args[6] == ws.data_ptr() and args[7] == cnt.data_ptr()
    assert tfd.decode_route(q.dtype, d, blk, True) == route


def test_scratch_grows_never_shrinks_and_counters_start_at_zero(
        monkeypatch):
    monkeypatch.setattr(tfd, "_SCRATCH", {})
    q = torch.zeros(2, 4, 16)
    first = tfd._scratch(q, 7, 100, 10)
    assert tfd._scratch(q, 7, 50, 5) == first  # fits: the same buffers
    grown = tfd._scratch(q, 7, 200, 3)
    ws, cnt, ptrs = tfd._SCRATCH[(q.get_device(), 7)]
    assert ptrs == grown != first
    assert ws.numel() == 200 and cnt.numel() == 10 and not cnt.any()
    assert tfd._scratch(q, 8, 1, 1) != grown  # another stream, its own


def test_split_override_only_on_the_split_route(monkeypatch):
    monkeypatch.setattr(tfd.build, "current_stream", lambda dev: 7)
    monkeypatch.setattr(tfd, "_sm_count", lambda dev: 132)
    q = torch.zeros(2, 4, 36, dtype=torch.bfloat16)  # d % 8: the gather route
    kp = torch.zeros(9, 4, 16, 36, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="split route"):
        tfd._launch("apex_flash_decode", q, kp, kp,
                    torch.zeros(2, 4, dtype=torch.int32),
                    torch.zeros(2, dtype=torch.int32), q, 1, 0.25, None, 3)


@pytest.mark.parametrize("entry,b,kq,window,splits", [
    ("apex_flash_decode", 8, 1, None, 3),   # the decode
    ("apex_flash_decode", 8, 1, 256, 2),    # RoPE serving's window
    ("apex_flash_decode_multi", 8, 5, None, 3),   # the verify
    ("apex_flash_decode_multi", 1, 256, None, 1),  # the chunk: 256 groups
])
def test_f32_launch_arguments_from_shapes_only(monkeypatch, entry, b, kq,
                                               window, splits):
    """The fp32 route's launch on the generate example's shapes (16 heads
    of 64 over 16-token pages, 64-page tables): the split count from
    :func:`decode_splits` with the fp32 constants, a workspace of groups x
    splits x 16 rows x (64 + 2) floats and one zeroed counter a group; the
    lengths and tables are never read on the host."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(tfd.build, "load", lambda: Lib())
    monkeypatch.setattr(tfd.build, "current_stream", lambda dev: 7)
    monkeypatch.setattr(tfd, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(tfd, "_SCRATCH", {})
    h, kh, blk, d, nb, mb = 16, 16, 16, 64, 40, 64
    q = torch.zeros(b, h, kq, d)
    if kq == 1:
        q = q[:, :, 0].contiguous()
    kp = torch.zeros(nb, kh, blk, d)
    tables = torch.zeros(b, mb, dtype=torch.int32).as_subclass(_NoHostRead)
    lens = torch.full((b,), 700, dtype=torch.int32).as_subclass(_NoHostRead)
    tfd._launch(entry, q, kp, kp, tables, lens, torch.empty_like(q), kq,
                0.125, window, None)
    (name, args), = calls
    assert name == entry
    assert args[-3:-1] == (splits, tfd.build.DTYPES[torch.float32])
    groups = b * kh * -(-(h // kh * kq) // tfd.DECODE_ROWS)
    ws, cnt, _ = tfd._SCRATCH[(q.get_device(), 7)]
    assert ws.numel() == groups * splits * tfd.DECODE_ROWS * (64 + 2)
    assert cnt.numel() == groups and not cnt.any()
    assert args[6] == ws.data_ptr() and args[7] == cnt.data_ptr()
