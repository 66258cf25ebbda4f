"""apex_tpu_torch.ops.lm_head_loss against apex_tpu.ops.lm_head_loss on the
CPU: the per-token loss and its gradients dh and dW, from the same numpy
inputs, at 1, 2 and 4 vocab chunks. fp32: tolerance 2e-5 (the same fp32
math, another summation order). bf16 h and W, as the O2 step gives them:
the loss within 2e-5 of JAX's and of the fp32 reference on the same
bf16 values (the chunk products keep fp32 results, so no logit is rounded
to bf16), dh and dW within one bf16 ulp (2^-7 relative, both sides round
the same fp32 sums once more to bf16).
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

jlm = importlib.import_module("apex_tpu.ops.lm_head_loss")
tlm = importlib.import_module("apex_tpu_torch.ops.lm_head_loss")

TOL = 2e-5


def _inputs(n=2, s=6, h=16, v=32, seed=0):
    rng = np.random.default_rng(seed)
    hid = rng.normal(size=(n, s, h)).astype(np.float32)
    wte = (0.3 * rng.normal(size=(v, h))).astype(np.float32)
    tgt = rng.integers(0, v, (n, s)).astype(np.int32)
    g = rng.uniform(0.5, 1.5, size=(n, s)).astype(np.float32)
    return hid, wte, tgt, g


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_loss_and_grads_match_jax(chunks):
    hid, wte, tgt, g = _inputs(seed=chunks)

    def jf(h, w):
        return jnp.sum(jlm.lm_head_cross_entropy(h, w, jnp.asarray(tgt),
                                                 chunks) * g)

    jloss = jlm.lm_head_cross_entropy(jnp.asarray(hid), jnp.asarray(wte),
                                      jnp.asarray(tgt), chunks)
    jdh, jdw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(hid),
                                             jnp.asarray(wte))
    th = torch.from_numpy(hid).requires_grad_()
    tw = torch.from_numpy(wte).requires_grad_()
    loss = tlm.lm_head_cross_entropy(th, tw, torch.from_numpy(tgt), chunks)
    assert loss.shape == (2, 6) and loss.dtype == torch.float32
    (loss * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("chunks", [1, 4])
def test_bf16_loss_and_grads_match_jax(chunks):
    hid, wte, tgt, g = _inputs(seed=10 + chunks)
    jh = jnp.asarray(hid, jnp.bfloat16)
    jw = jnp.asarray(wte, jnp.bfloat16)

    def jf(h, w):
        return jnp.sum(jlm.lm_head_cross_entropy(h, w, jnp.asarray(tgt),
                                                 chunks) * g)

    jloss = jlm.lm_head_cross_entropy(jh, jw, jnp.asarray(tgt), chunks)
    jdh, jdw = jax.grad(jf, argnums=(0, 1))(jh, jw)
    th = torch.from_numpy(hid).bfloat16().requires_grad_()
    tw = torch.from_numpy(wte).bfloat16().requires_grad_()
    loss = tlm.lm_head_cross_entropy(th, tw, torch.from_numpy(tgt), chunks)
    assert loss.dtype == torch.float32
    (loss * torch.from_numpy(g)).sum().backward()
    assert th.grad.dtype == tw.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               atol=TOL, rtol=TOL)
    ref = tlm.lm_head_cross_entropy_reference(th.detach(), tw.detach(),
                                              torch.from_numpy(tgt))
    np.testing.assert_allclose(loss.detach().numpy(), ref.numpy(), atol=TOL,
                               rtol=TOL)
    for got, want in ((th.grad, jdh), (tw.grad, jdw)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2.0 ** -7, atol=1e-6)


def test_matches_materialized_reference():
    hid, wte, tgt, _ = _inputs(seed=9)
    t = [torch.from_numpy(a) for a in (hid, wte, tgt)]
    got = tlm.lm_head_cross_entropy(*t, num_chunks=4)
    ref = tlm.lm_head_cross_entropy_reference(*t)
    jref = jlm.lm_head_cross_entropy_reference(
        *(jnp.asarray(a) for a in (hid, wte, tgt)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=TOL)


def test_vocab_that_does_not_divide_raises():
    hid, wte, tgt, _ = _inputs(v=30)
    with pytest.raises(ValueError, match="divisible"):
        tlm.lm_head_cross_entropy(torch.from_numpy(hid),
                                  torch.from_numpy(wte),
                                  torch.from_numpy(tgt), 4)
