"""apex_tpu_torch.ops.flash_decode.paged_attention_reference against the
JAX ``paged_attention_reference`` on the CPU (fp32, atol 2e-5): random
block tables, GQA head groups, the window, and an idle slot (length 0)
that must be exactly 0. The CUDA kernel is held against the plain version
by ``chip_smoke.py``.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from apex_tpu.ops.flash_decode import (
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
