"""apex_tpu_torch.ops.xentropy against apex_tpu.ops.xentropy on the CPU.

The same numpy logits and labels go through the JAX function (the Pallas
kernel in interpret mode, ``impl="pallas"``, as ``tests/test_kernels.py``
runs it, and the plain ``softmax_cross_entropy_reference``) and through the
port's ``softmax_cross_entropy``, which on CPU tensors runs the
``SoftmaxXentropy`` Function over the plain forward and backward. Labels
stay in [0, V) or equal ``ignore_index`` (the JAX kernel and its XLA path
disagree on other labels). Tolerances: against the XLA path, fp32 losses
1e-5 relative (the same fp32 math in another summation order) and grads
1e-6 absolute; against the Pallas path, the JAX package's own bar for that
path against its XLA path, 2e-5 absolute and relative
(``tests/test_kernels.py`` ``_assert_close``: in some processes the
interpret-mode kernel's grads move by up to about that much while the
XLA path's do not); with bf16 logits the bf16 dx within 2^-8 of max |dx|
(both round the same fp32 value to bf16). The CUDA kernels themselves are
held against the plain versions by ``chip_smoke.py``.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

jxe = importlib.import_module("apex_tpu.ops.xentropy")
txe = importlib.import_module("apex_tpu_torch.ops.xentropy")
from apex_tpu_torch import ops  # noqa: E402


def _inputs(shape=(37,), vocab=101, seed=0, scale=3.0, ignored=(5, 11)):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=shape + (vocab,)) * scale).astype(np.float32)
    labels = rng.integers(0, vocab, size=shape).astype(np.int64)
    flat = labels.reshape(-1)
    for i in ignored:
        if i < flat.size:
            flat[i] = -100
    g = rng.normal(size=shape).astype(np.float32)
    return logits, labels, g


def _jax_loss_and_grad(logits, labels, g, smoothing, impl, dtype):
    lj = jnp.asarray(logits).astype(dtype)
    yj = jnp.asarray(labels)
    if impl == "pallas":
        fn = lambda a: jxe.softmax_cross_entropy(  # noqa: E731
            a, yj, smoothing, impl="pallas")
    else:
        fn = lambda a: jxe.softmax_cross_entropy_reference(  # noqa: E731
            a, yj, smoothing)
    loss = fn(lj)
    grad = jax.grad(lambda a: jnp.sum(fn(a) * jnp.asarray(g)))(lj)
    return (np.asarray(loss, np.float32),
            np.asarray(grad.astype(jnp.float32)))


def _assert_matches(tl, tg, jl, jg, impl):
    if impl == "pallas":  # the JAX package's Pallas-vs-XLA tolerance
        np.testing.assert_allclose(tl, jl, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(tg, jg, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6)


def _port_loss_and_grad(logits, labels, g, smoothing, dtype):
    x = torch.from_numpy(logits).to(dtype).requires_grad_(True)
    loss = txe.softmax_cross_entropy(x, torch.from_numpy(labels), smoothing)
    (loss * torch.from_numpy(g)).sum().backward()
    assert loss.dtype == torch.float32 and x.grad.dtype == dtype
    return loss.detach().numpy(), x.grad.float().numpy()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_fp32_loss_and_grad_match_jax(impl, smoothing):
    logits, labels, g = _inputs()
    jl, jg = _jax_loss_and_grad(logits, labels, g, smoothing, impl,
                                jnp.float32)
    tl, tg = _port_loss_and_grad(logits, labels, g, smoothing,
                                 torch.float32)
    _assert_matches(tl, tg, jl, jg, impl)
    # ignored rows: exactly 0 loss and 0 grad
    assert tl[5] == 0.0 and tl[11] == 0.0
    assert not tg[5].any() and not tg[11].any()


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_bf16_logits_match_jax_pallas(smoothing):
    logits, labels, g = _inputs(shape=(24,), vocab=128, seed=1)
    jl, jg = _jax_loss_and_grad(logits, labels, g, smoothing, "pallas",
                                jnp.bfloat16)
    tl, tg = _port_loss_and_grad(logits, labels, g, smoothing,
                                 torch.bfloat16)
    np.testing.assert_allclose(tl, jl, rtol=2e-5, atol=2e-5)
    assert np.abs(tg - jg).max() <= 2.0 ** -8 * np.abs(jg).max()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_batched_shape_matches_jax(impl):
    logits, labels, g = _inputs(shape=(4, 9), vocab=64, seed=2,
                                ignored=(3,))
    jl, jg = _jax_loss_and_grad(logits, labels, g, 0.1, impl, jnp.float32)
    tl, tg = _port_loss_and_grad(logits, labels, g, 0.1, torch.float32)
    assert tl.shape == (4, 9) and tg.shape == (4, 9, 64)
    _assert_matches(tl, tg, jl, jg, impl)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_large_logits_and_all_ignored_rows(impl):
    logits, labels, g = _inputs(shape=(16,), vocab=37, seed=3, scale=1e4,
                                ignored=())
    jl, jg = _jax_loss_and_grad(logits, labels, g, 0.1, impl, jnp.float32)
    tl, tg = _port_loss_and_grad(logits, labels, g, 0.1, torch.float32)
    _assert_matches(tl, tg, jl, jg, impl)
    none = np.full_like(labels, -100)
    tl, tg = _port_loss_and_grad(logits, none, g, 0.1, torch.float32)
    assert not tl.any() and not tg.any()


def test_plain_backward_is_autograd_of_plain_forward():
    logits, labels, g = _inputs(shape=(20,), vocab=50, seed=4)
    x = torch.from_numpy(logits).requires_grad_(True)
    y, gt = torch.from_numpy(labels), torch.from_numpy(g)
    loss, lse = txe.xentropy_fwd_reference(x, y, 0.1)
    (auto,) = torch.autograd.grad((loss * gt).sum(), x)
    plain = txe.xentropy_bwd_reference(gt, x.detach(), y, lse.detach(), 0.1)
    torch.testing.assert_close(plain, auto, rtol=0, atol=1e-6)
    # no grad to track: the plain forward directly, as under no_grad
    with torch.no_grad():
        out = txe.softmax_cross_entropy(x, y, 0.1)
    assert torch.equal(out, loss.detach())


def test_kernel_wrappers_are_counted_and_refuse_cpu_tensors():
    assert ops.KERNEL_WRAPPERS["xentropy_fwd"] is txe.xentropy_fwd
    assert ops.KERNEL_WRAPPERS["xentropy_bwd"] is txe.xentropy_bwd
    before = ops.launch_counts()
    x = torch.zeros(4, 8)
    y = torch.zeros(4, dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA kernel"):
        txe.xentropy_fwd(x, y)
    with pytest.raises(ValueError, match="CUDA kernel"):
        txe.xentropy_bwd(torch.ones(4), x, y, torch.zeros(4))
    txe.softmax_cross_entropy(x.requires_grad_(True), y).sum().backward()
    assert ops.launch_counts() == before  # the CPU runs the plain versions
