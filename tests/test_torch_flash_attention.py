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
