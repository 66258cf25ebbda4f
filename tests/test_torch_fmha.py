"""apex_tpu_torch.contrib.fmha against the JAX ``apex_tpu.contrib.fmha`` on
the CPU, on identical numpy inputs (the cases of
tests/test_flash_attention.py:179-234 and
tests/test_inventory_parity.py:94-105 at tiny sizes).

The packed output matches the JAX fmha within 2e-5 (fp32: the same math
summed in another order), its grads ``jax.grad`` of the JAX fmha within
2e-4, and tokens past ``cu_seqlens[-1]`` are exactly 0 on both sides. On
the CPU the port runs the plain versions of the flash kernels through
``FlashAttention``, with the contiguous-segment bounds narrowing them as on
the card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# both packages re-export a function named like the module
jfmha = importlib.import_module("apex_tpu.contrib.fmha")
tfmha = importlib.import_module("apex_tpu_torch.contrib.fmha")

ATOL = 2e-5
GRAD_TOL = 2e-4


def _packed(lengths, h=2, d=16, tail=0, seed=0):
    """(qkv (total + tail, 3, h, d) fp32, cu_seqlens int32) as numpy."""
    rng = np.random.default_rng(seed)
    total = sum(lengths) + tail
    qkv = rng.normal(size=(total, 3, h, d)).astype(np.float32)
    cu = np.cumsum([0] + list(lengths)).astype(np.int32)
    return qkv, cu


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lengths,tail", [([5, 9, 3], 0), ([40, 17, 61], 0),
                                          ([128], 0), ([8, 8, 96], 11),
                                          ([30, 70], 37)])
def test_fmha_matches_jax(lengths, tail, causal):
    qkv, cu = _packed(lengths, tail=tail)
    want = np.asarray(jfmha.fmha(jnp.asarray(qkv), jnp.asarray(cu), 128,
                                 causal=causal))
    got = tfmha.fmha(torch.from_numpy(qkv), torch.from_numpy(cu), 128,
                     causal=causal)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    ref = tfmha.fmha_reference(torch.from_numpy(qkv), torch.from_numpy(cu),
                               causal=causal)
    np.testing.assert_allclose(
        ref.numpy(), jfmha.fmha_reference(qkv, cu, causal=causal),
        atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL,
                               rtol=ATOL)


def test_fmha_trailing_padding_rows_are_zero():
    """Tokens past cu_seqlens[-1] are padding: output exactly 0, on both
    sides, and their grads are exactly 0."""
    qkv, cu = _packed([100, 80], h=4, d=16, tail=76, seed=1)
    want = np.asarray(jfmha.fmha(jnp.asarray(qkv), jnp.asarray(cu), 512))
    t = torch.from_numpy(qkv).requires_grad_()
    got = tfmha.fmha(t, torch.from_numpy(cu), 512)
    assert np.all(want[180:] == 0.0)
    assert torch.all(got[180:] == 0.0)
    got.sum().backward()
    assert torch.all(t.grad[180:] == 0.0)
    assert torch.any(t.grad[:180] != 0.0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lengths,tail", [([12, 30, 20], 0),
                                          ([33, 15], 9)])
def test_fmha_grads_match_jax_grad(lengths, tail, causal):
    qkv, cu = _packed(lengths, tail=tail, seed=2)
    w = np.random.default_rng(3).normal(
        size=(qkv.shape[0], 2, 16)).astype(np.float32)

    def jloss(x):
        return jnp.sum(jfmha.fmha(x, jnp.asarray(cu), 128, causal=causal)
                       * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(qkv)))
    t = torch.from_numpy(qkv).requires_grad_()
    out = tfmha.fmha(t, torch.from_numpy(cu), 128, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, atol=GRAD_TOL,
                               rtol=GRAD_TOL)


def test_fmha_goes_through_flash_attention_with_contiguous_segments(
        monkeypatch):
    """fmha calls flash_attention with the packed ids, pad_id = b + 1 and
    contiguous_segments=True, on (1, h, T, d) views of qkv (no copy, no
    pad up to 128 tokens), and its grad goes through FlashAttention."""
    qkv, cu = _packed([7, 20, 5], tail=3)
    seen = {}
    real = tfmha.flash_attention

    def spy(q, k, v, **kw):
        seen.update(kw, shape=tuple(q.shape), view=q._base is not None)
        return real(q, k, v, **kw)

    monkeypatch.setattr(tfmha, "flash_attention", spy)
    t = torch.from_numpy(qkv).requires_grad_()
    out = tfmha.fmha(t, torch.from_numpy(cu), 32)
    assert seen["shape"] == (1, 2, 35, 16) and seen["view"]
    assert seen["pad_id"] == 4 and seen["contiguous_segments"] is True
    q_ids, k_ids = seen["segment_ids"]
    assert q_ids.tolist() == [[1] * 7 + [2] * 20 + [3] * 5 + [4] * 3]
    assert out.shape == (35, 2, 16)
    names, todo = set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        names.add(type(node).__name__)
        todo += [n for n, _ in node.next_functions if n is not None]
    assert "FlashAttentionBackward" in names


@pytest.mark.parametrize("total", [32, 35, 40])
def test_segment_ids_from_cu_seqlens_match_jax(total):
    cu = np.array([0, 7, 27, 32], np.int32)
    want = np.asarray(jfmha.segment_ids_from_cu_seqlens(jnp.asarray(cu),
                                                        total))
    got = tfmha.segment_ids_from_cu_seqlens(torch.from_numpy(cu), total)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fmha_envelope_and_shape_errors_match_jax():
    qkv, cu = _packed([5, 40])
    for fn, x, c in ((jfmha.fmha, jnp.asarray(qkv), jnp.asarray(cu)),
                     (tfmha.fmha, torch.from_numpy(qkv),
                      torch.from_numpy(cu))):
        with pytest.raises(ValueError, match="exceeds max_seqlen 32"):
            fn(x, c, 32)
        with pytest.raises(ValueError, match="dim-1 == 3"):
            fn(x[:, :2], c, 64)
