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
    # a bias (no kernel takes one yet) keeps mha_reference's autograd; the
    # window goes through FlashAttention's streamed path
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv())
    bias = torch.zeros(1, 1, 24, 24)
    out = tfa.flash_attention(q, k, v, bias, causal=True)
    assert type(out.grad_fn).__name__ != "FlashAttentionBackward"
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_backward_wrappers_never_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    lse = torch.zeros(q.shape[:3])
    for fn in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA kernel"):
            fn(q, k, v, q, lse, lse, causal=True, scale=0.25)
