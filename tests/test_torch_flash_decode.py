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
"""

import importlib

import numpy as np
import pytest

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
