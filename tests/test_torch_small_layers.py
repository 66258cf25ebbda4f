"""The port's small layers against the JAX package's, on the CPU.

``MLP``, ``FusedDense``, ``FusedDenseGeluDense``
(``apex_tpu_torch.models``), ``FusedLayerNorm`` / ``FusedRMSNorm`` and the
functional forms (``apex_tpu_torch.normalization``) and ``FastLayerNorm``
(``apex_tpu_torch.contrib``): each module loads the JAX module's parameter
tree with ``params_from_numpy``, then the same numpy input goes through
both, and a cotangent through ``jax.grad`` and ``torch.autograd``. The
norms run the LayerNorm Function over its plain versions here (its kernels
on the card, ``chip_smoke.py`` phase 7). Tolerances: fp32 1e-5 relative
and 1e-6 absolute for the products (the same fp32 math, sums in another
order), 2e-5 for the norms (the JAX package's Pallas bar in
``tests/test_kernels.py``); bf16 LayerNorm outputs within 2e-2 (the JAX
package's mixed-dtype bar). Mirrors ``tests/test_models.py`` (MLP and
fused dense) and ``tests/test_kernels.py`` (the LayerNorm modules).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.contrib.layer_norm import FastLayerNorm as JFastLayerNorm
from apex_tpu.models import MLP as JMLP
from apex_tpu.models import FusedDense as JFusedDense
from apex_tpu.models import FusedDenseGeluDense as JFusedDenseGeluDense
from apex_tpu.normalization import FusedLayerNorm as JFusedLayerNorm
from apex_tpu.normalization import FusedRMSNorm as JFusedRMSNorm
from apex_tpu_torch import ops
from apex_tpu_torch.contrib import FastLayerNorm
from apex_tpu_torch.models import MLP, FusedDense, FusedDenseGeluDense
from apex_tpu_torch.normalization import (
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    MixedFusedRMSNorm,
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol, atol=atol)


def _port_grads(module, x, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = module(xt)
    grads = torch.autograd.grad(y, [xt, *module.parameters()],
                                torch.from_numpy(g))
    return y.detach().numpy(), [t.numpy() for t in grads]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
@pytest.mark.parametrize("bias", [True, False])
def test_mlp_matches_jax(activation, bias):
    """``test_mlp_matches_sequential_reference``'s MLP, on identical
    params: output, input grad and every layer's grads."""
    sizes = (12, 24, 8)
    jmlp = JMLP(sizes, bias=bias, activation=activation)
    params = jmlp.init(jax.random.PRNGKey(0))
    x, g = _rand((5, 12), 1), _rand((5, 8), 2)
    mlp = MLP(sizes, bias=bias, activation=activation,
              device="cpu").params_from_numpy(_np(params))
    y, grads = _port_grads(mlp, x, g)
    _close(y, jmlp.apply(params, jnp.asarray(x)))
    jx, jp = jax.grad(lambda a, p: jnp.sum(jmlp.apply(p, a) * g),
                      argnums=(0, 1))(jnp.asarray(x), params)
    _close(grads[0], jx)
    leaves = [p[k] for p in jp for k in ("kernel", "bias") if k in p]
    assert len(leaves) == len(grads) - 1
    for a, b in zip(grads[1:], leaves):
        _close(a, b)


def test_mlp_activation_after_the_last_layer_and_its_errors():
    mlp = MLP((4, 4), bias=False, activation="sigmoid", device="cpu")
    with torch.no_grad():
        y = mlp(torch.ones(2, 4))
    assert y.shape == (2, 4) and float(y.min()) > 0 and float(y.max()) < 1
    relu = MLP((4, 6, 3), device="cpu")
    with torch.no_grad():
        assert float(relu(torch.randn(64, 4)).min()) == 0.0  # after last
    with pytest.raises(ValueError, match="at least"):
        MLP((4,), device="cpu")
    with pytest.raises(ValueError, match="unknown activation"):
        MLP((4, 4), activation="tanh", device="cpu")
    with pytest.raises(ValueError, match="layers in the tree"):
        MLP((4, 4, 4), device="cpu").params_from_numpy(
            _np(JMLP((4, 4)).init(jax.random.PRNGKey(0))))


def test_fused_dense_layers_match_jax():
    """``test_fused_dense_layers`` on identical params, with grads; the
    GeLU is the tanh form (``jax.nn.gelu``'s default)."""
    jfd = JFusedDense(8, 16)
    p = jfd.init(jax.random.PRNGKey(0))
    x, g = _rand((3, 8), 1), _rand((3, 16), 2)
    fd = FusedDense(8, 16, device="cpu").params_from_numpy(_np(p))
    assert tuple(fd.kernel.shape) == (8, 16)  # the JAX (in, out) layout
    y, grads = _port_grads(fd, x, g)
    _close(y, jfd.apply(p, jnp.asarray(x)))
    jx, jp = jax.grad(lambda a, q: jnp.sum(jfd.apply(q, a) * g),
                      argnums=(0, 1))(jnp.asarray(x), p)
    for a, b in zip(grads, (jx, jp["kernel"], jp["bias"])):
        _close(a, b)

    jfgd = JFusedDenseGeluDense(8, 32, 8)
    p2 = jfgd.init(jax.random.PRNGKey(2))
    g2 = _rand((3, 8), 3)
    fgd = FusedDenseGeluDense(8, 32, 8, device="cpu").params_from_numpy(
        _np(p2))
    y2, grads2 = _port_grads(fgd, x, g2)
    _close(y2, jfgd.apply(p2, jnp.asarray(x)))
    jx2, jp2 = jax.grad(lambda a, q: jnp.sum(jfgd.apply(q, a) * g2),
                        argnums=(0, 1))(jnp.asarray(x), p2)
    want = [jx2] + [jp2[d][k] for d in ("dense1", "dense2")
                    for k in ("kernel", "bias")]
    for a, b in zip(grads2, want):
        _close(a, b)
    # the erf GeLU differs: the port is held to the tanh form
    with torch.no_grad():
        h = torch.from_numpy(x) @ fgd.dense1.kernel + fgd.dense1.bias
        erf = torch.nn.functional.gelu(h) @ fgd.dense2.kernel \
            + fgd.dense2.bias
    assert float((erf - torch.from_numpy(y2)).abs().max()) > 1e-6


def test_fused_dense_bf16_input_casts_params():
    jfd = JFusedDense(16, 8)
    p = jfd.init(jax.random.PRNGKey(4))
    x = _rand((4, 16), 5)
    fd = FusedDense(16, 8, device="cpu").params_from_numpy(_np(p))
    y = fd(torch.from_numpy(x).to(torch.bfloat16))
    jy = jfd.apply(p, jnp.asarray(x).astype(jnp.bfloat16))
    assert y.dtype == torch.bfloat16 and fd.kernel.dtype == torch.float32
    _close(y.float().detach(), jy.astype(jnp.float32), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("rms", [False, True])
def test_norm_modules_match_jax(rms):
    """``test_layer_norm_module`` on identical (non-trivial) params, with
    grads: fp32 params named ``scale``/``bias``, RMS without a bias."""
    jcls, tcls = (JFusedRMSNorm, FusedRMSNorm) if rms else \
        (JFusedLayerNorm, FusedLayerNorm)
    jm = jcls(normalized_shape=64, impl="pallas")
    x, g = _rand((4, 7, 64), 0, 2.0), _rand((4, 7, 64), 1)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(2), a.shape),
        variables)
    m = tcls(64, device="cpu").params_from_numpy(_np(variables))
    assert m.scale.dtype == torch.float32
    assert (m.bias is None) == rms == ("bias" not in variables["params"])
    y, grads = _port_grads(m, x, g)
    _close(y, jm.apply(variables, jnp.asarray(x)), 2e-5, 2e-5)
    jx, jv = jax.grad(lambda a, v: jnp.sum(jm.apply(v, a) * g),
                      argnums=(0, 1))(jnp.asarray(x), variables)
    want = [jx, jv["params"]["scale"]] + ([] if rms
                                          else [jv["params"]["bias"]])
    for a, b in zip(grads, want):
        _close(a, b, 2e-5, 2e-5)


def test_norm_module_without_affine_and_mixed_aliases():
    x = _rand((3, 5, 32), 3)
    m = FusedLayerNorm(32, elementwise_affine=False, device="cpu")
    assert list(m.parameters()) == []
    _close(m(torch.from_numpy(x)).numpy(),
           JFusedLayerNorm(32, elementwise_affine=False).apply(
               {}, jnp.asarray(x)), 2e-5, 2e-5)
    _close(fused_rms_norm(torch.from_numpy(x), 32).numpy(),
           ops.rms_norm_reference(torch.from_numpy(x)).numpy())
    _close(fused_layer_norm(torch.from_numpy(x), (5, 32)).numpy(),
           ops.layer_norm_reference(torch.from_numpy(x).reshape(3, 160))
           .reshape(3, 5, 32).numpy())
    assert MixedFusedLayerNorm is FusedLayerNorm
    assert MixedFusedRMSNorm is FusedRMSNorm


def test_norm_mixed_dtype():
    """bf16 input, fp32 affine (the MixedFused contract): bf16 output."""
    x = _rand((16, 128), 4)
    m = FusedLayerNorm(128, device="cpu")
    y = m(torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    jm = JFusedLayerNorm(128, impl="pallas")
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jy = jm.apply(jm.init(jax.random.PRNGKey(0), jx), jx)
    _close(y.detach().float(), jy.astype(jnp.float32), 2e-2, 2e-2)


def test_layer_norm_multidim_normalized_shape():
    """``test_layer_norm_multidim_normalized_shape``: a (4, 8) trailing
    shape flattens to 32; a mismatching one raises."""
    from apex_tpu.normalization import fused_layer_norm_affine as jfn

    x = _rand((5, 3, 4, 8), 5)
    w, b = np.full((4, 8), 1.5, np.float32), np.full((4, 8), 0.25, np.float32)
    y = fused_layer_norm_affine(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), (4, 8))
    _close(y.numpy(), jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          (4, 8), impl="pallas"), 2e-5, 2e-5)
    with pytest.raises(ValueError, match="normalized_shape"):
        fused_layer_norm_affine(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), (8, 4))


def test_fast_layer_norm_matches_jax():
    jm = JFastLayerNorm(64)
    params = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(3), a.shape),
        jm.init(jax.random.PRNGKey(0)))
    m = FastLayerNorm(64, device="cpu").params_from_numpy(_np(params))
    x, g = _rand((6, 64), 6, 3.0), _rand((6, 64), 7)
    y, grads = _port_grads(m, x, g)
    _close(y, jm.apply(params, jnp.asarray(x)), 2e-5, 2e-5)
    jx, jp = jax.grad(lambda a, p: jnp.sum(jm.apply(p, a) * g),
                      argnums=(0, 1))(jnp.asarray(x), params)
    for a, b in zip(grads, (jx, jp["weight"], jp["bias"])):
        _close(a, b, 2e-5, 2e-5)


@pytest.mark.parametrize("hidden", [0, 12, 65544])
def test_fast_layer_norm_envelope(hidden):
    """The reference constructor's envelope: a multiple of 8 in
    (0, 65536], in both packages."""
    with pytest.raises(ValueError, match="unsupported"):
        JFastLayerNorm(hidden)
    with pytest.raises(ValueError, match="unsupported"):
        FastLayerNorm(hidden, device="cpu")


def test_layers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: MLP((4, 4)), lambda: FusedDense(4, 4),
                 lambda: FusedDenseGeluDense(4, 8, 4),
                 lambda: FusedLayerNorm(8), lambda: FastLayerNorm(8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
