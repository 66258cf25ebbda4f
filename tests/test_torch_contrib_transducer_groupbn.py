"""contrib.transducer and contrib.groupbn of the port against the JAX
package's, on the CPU.

The transducer: the joint (broadcast add, ReLU, dropout from a
``torch.Generator``) against ``transducer_joint``; the loss over the
anti-diagonal walk against the JAX row scans and the float64 DP, at
lengths shorter than T and U, a sequence with no labels, T = 1 and
``blank_idx`` other than 0; its grads through a log-softmax against
``jax.grad``. Tolerances: fp32 losses 1e-5 relative to JAX (the same
terms a cell, ``logaddexp`` in another library), 1e-4 relative to the
float64 DP (the JAX test's ``rtol``), grads 1e-5 of max |JAX grad|.

groupbn: ``test_groupbn_nhwc_surface`` of ``tests/test_inventory_parity.py``
on the port, the NHWC BN's output, grads and running stats against the
JAX ``BatchNorm2d_NHWC`` (1e-5), and the two raises: ``bn_group > 1``
without ``axis_name`` (``ValueError``, as the reference) and with one
(``NotImplementedError``: data parallelism, ROADMAP Queue 1 item 9).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.contrib import groupbn as jgbn
from apex_tpu.contrib import transducer as jtr
from apex_tpu_torch.contrib import (
    BatchNorm2d_NHWC,
    batch_norm_add_relu,
    transducer_joint,
    transducer_loss,
    transducer_loss_reference,
)


def _lattice(seed, b, t, u, v):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, t, u + 1, v)).astype(np.float32)
    targets = rng.integers(1, v, (b, u)).astype(np.int32)
    return rng, logits, targets


# -- the joint ----------------------------------------------------------------

@pytest.mark.parametrize("relu", [False, True])
def test_joint_against_jax(relu):
    rng = np.random.default_rng(0)
    f = rng.normal(size=(2, 3, 4)).astype(np.float32)
    g = rng.normal(size=(2, 5, 4)).astype(np.float32)
    out = transducer_joint(torch.from_numpy(f), torch.from_numpy(g),
                           relu=relu)
    ref = jtr.transducer_joint(jnp.asarray(f), jnp.asarray(g), relu=relu)
    assert out.shape == (2, 3, 5, 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_allclose(out[1, 2, 3].numpy(), np.maximum(
        f[1, 2] + g[1, 3], 0) if relu else f[1, 2] + g[1, 3], rtol=1e-6)


def test_joint_dropout_from_a_generator():
    f, g = torch.ones(2, 3, 8), torch.ones(2, 4, 8)
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a = transducer_joint(f, g, dropout=0.5, generator=gen(1))
    b = transducer_joint(f, g, dropout=0.5, generator=gen(1))
    c = transducer_joint(f, g, dropout=0.5, generator=gen(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert set(a.unique().tolist()) <= {0.0, 4.0}  # (1 + 1) / (1 - 0.5)
    torch.testing.assert_close(transducer_joint(f, g, dropout=0.5),
                               f[:, :, None] + g[:, None])


# -- the loss -----------------------------------------------------------------

LOSS_CASES = {  # B, T, U, V, f_len, y_len, blank
    "reference_test": (3, 6, 4, 8, [6, 4, 5], [4, 2, 3], 0),
    "full_lengths": (2, 5, 3, 6, [5, 5], [3, 3], 0),
    "no_labels_and_one_frame": (3, 4, 3, 5, [1, 4, 2], [2, 0, 3], 0),
    "one_time_step": (2, 1, 3, 5, [1, 1], [3, 1], 0),
    "blank_last": (2, 7, 5, 9, [7, 3], [5, 4], 8),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_against_jax_and_the_dp(case):
    b, t, u, v, f_len, y_len, blank = LOSS_CASES[case]
    _, logits, targets = _lattice(1, b, t, u, v)
    if blank:
        targets = targets % blank  # labels other than the blank id
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    fl, yl = np.asarray(f_len), np.asarray(y_len)
    got = transducer_loss(torch.from_numpy(lp), torch.from_numpy(targets),
                          torch.from_numpy(fl), torch.from_numpy(yl),
                          blank_idx=blank)
    ref = jtr.transducer_loss(jnp.asarray(lp), jnp.asarray(targets),
                              jnp.asarray(fl), jnp.asarray(yl),
                              blank_idx=blank)
    dp = transducer_loss_reference(lp, targets, fl, yl, blank_idx=blank)
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), dp, rtol=1e-4)
    np.testing.assert_allclose(
        dp, jtr.transducer_loss_reference(lp, targets, fl, yl, blank), rtol=0)


@pytest.mark.parametrize("case", ["reference_test", "no_labels_and_one_frame"])
def test_loss_grads_against_jax(case):
    b, t, u, v, f_len, y_len, blank = LOSS_CASES[case]
    _, logits, targets = _lattice(2, b, t, u, v)
    fl, yl = np.asarray(f_len), np.asarray(y_len)

    def jloss(lg):
        lp = jax.nn.log_softmax(lg, axis=-1)
        return jnp.mean(jtr.transducer_loss(lp, jnp.asarray(targets),
                                            jnp.asarray(fl), jnp.asarray(yl)))

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    lg = torch.from_numpy(logits).requires_grad_()
    loss = torch.mean(transducer_loss(
        torch.log_softmax(lg, -1), torch.from_numpy(targets),
        torch.from_numpy(fl), torch.from_numpy(yl)))
    loss.backward()
    assert torch.isfinite(lg.grad).all()
    assert float(lg.grad.abs().max()) > 0
    assert np.abs(lg.grad.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()


def test_loss_in_bf16_log_probs_computes_in_fp32():
    _, logits, targets = _lattice(3, 2, 5, 3, 6)
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    fl, yl = torch.tensor([5, 4]), torch.tensor([3, 2])
    got = transducer_loss(lp.to(torch.bfloat16), torch.from_numpy(targets),
                          fl, yl)
    want = transducer_loss(lp.to(torch.bfloat16).float(),
                           torch.from_numpy(targets), fl, yl)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- groupbn ------------------------------------------------------------------

def test_groupbn_nhwc_surface():
    bn = BatchNorm2d_NHWC(8, fuse_relu=True, device="cpu")
    x = torch.randn(2, 4, 4, 8, generator=torch.Generator().manual_seed(0))
    y = bn(x)
    assert y.shape == x.shape
    assert float(y.min()) >= 0.0  # fused relu
    bn2 = BatchNorm2d_NHWC(8, device="cpu")
    out = bn2(x)
    z = batch_norm_add_relu(out, -out)
    torch.testing.assert_close(z, torch.zeros_like(z), rtol=0, atol=1e-6)


@pytest.mark.parametrize("fuse_relu", [False, True])
def test_groupbn_against_jax(fuse_relu):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 5, 3, 8)) * 2 + 1).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jbn = jgbn.BatchNorm2d_NHWC(8, fuse_relu=fuse_relu)
    variables = jbn.init(jax.random.PRNGKey(1), jnp.asarray(x))

    def jloss(params, xx):
        y, new = jbn.apply({**variables, "params": params}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(y * g), (y, new)

    (_, (jy, jnew)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"],
                                             jnp.asarray(x))
    bn = BatchNorm2d_NHWC(8, fuse_relu=fuse_relu, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    for name, p in (("scale", bn.scale), ("bias", bn.bias)):
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jgp[name]),
                                   rtol=1e-5, atol=1e-5)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(jnew["batch_stats"][name]),
                                   rtol=1e-5, atol=1e-6)


def test_groupbn_group_raises():
    with pytest.raises(ValueError, match="axis_name"):
        BatchNorm2d_NHWC(8, bn_group=2, device="cpu")
    with pytest.raises(ValueError, match="axis_name"):
        jgbn.BatchNorm2d_NHWC(8, bn_group=2)
    # bn_group 2: NHWC statistics over blocks of 2 ranks along "data"
    # (held on 4 gloo ranks in tests/test_torch_sync_batchnorm_dp.py); a
    # one-rank mesh has no block of 2
    bn = BatchNorm2d_NHWC(8, bn_group=2, axis_name="data", device="cpu")
    assert (bn.axis_name, bn.group_size, bn.channel_last) == ("data", 2, True)
    from apex_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel()
    try:
        with pytest.raises(ValueError, match="not divisible by group_size"):
            bn(torch.zeros(2, 3, 3, 8))
    finally:
        mesh.destroy_model_parallel()
    # bn_group 1 drops axis_name, as the reference does: statistics local
    bn = BatchNorm2d_NHWC(8, axis_name="data", device="cpu")
    assert bn.channel_last and bn.num_features == 8
