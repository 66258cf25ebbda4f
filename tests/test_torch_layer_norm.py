"""apex_tpu_torch.ops.layer_norm against apex_tpu.ops.layer_norm on the CPU.

The same numpy inputs go through the JAX reference (``impl="xla"``) and the
port's plain version, which the port's ``layer_norm`` takes for CPU
tensors. fp32 agrees to 1e-5 (same fp32 math, another summation order);
bf16 activations with fp32 gamma/beta agree to one bf16 ulp (both round
the same fp32 result, which may straddle a rounding boundary). The CUDA
kernel itself is held against the plain version by ``chip_smoke.py``.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

# the packages re-export functions named like these modules
jln = importlib.import_module("apex_tpu.ops.layer_norm")
tln = importlib.import_module("apex_tpu_torch.ops.layer_norm")


def _inputs(rows=6, hidden=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, rows, hidden)).astype(np.float32) * 3 + 0.5
    w = (1 + 0.1 * rng.normal(size=(hidden,))).astype(np.float32)
    b = (0.1 * rng.normal(size=(hidden,))).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("affine", ["wb", "w", "none"])
def test_fp32_matches_jax_reference(rms, affine):
    x, w, b = _inputs()
    w = w if affine in ("wb", "w") else None
    b = b if affine == "wb" and not rms else None
    t = (lambda a: None if a is None else torch.from_numpy(a))
    j = (lambda a: None if a is None else jnp.asarray(a))
    if rms:
        ref = jln.rms_norm(j(x), j(w), impl="xla")
        got = tln.rms_norm(t(x), t(w))
        plain = tln.rms_norm_reference(t(x), t(w))
    else:
        ref = jln.layer_norm(j(x), j(w), j(b), impl="xla")
        got = tln.layer_norm(t(x), t(w), t(b))
        plain = tln.layer_norm_reference(t(x), t(w), t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert torch.equal(got, plain)  # CPU tensors take the plain version


@pytest.mark.parametrize("rms", [False, True])
def test_bf16_activations_fp32_affine_within_one_ulp(rms):
    x, w, b = _inputs(rows=16, hidden=64, seed=1)
    xj = jnp.asarray(x, jnp.bfloat16)
    # identical bf16 inputs on both sides (the values are representable)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    if rms:
        ref = jln.rms_norm_reference(xj, jnp.asarray(w))
        got = tln.rms_norm(xt, torch.from_numpy(w))
    else:
        ref = jln.layer_norm_reference(xj, jnp.asarray(w), jnp.asarray(b))
        got = tln.layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    got32 = got.float().numpy()
    # one bf16 ulp at |y|: 2^(floor(log2|y|) - 7)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref32), 1e-30))) - 7)
    assert np.all(np.abs(got32 - ref32) <= ulp), np.max(
        np.abs(got32 - ref32) / ulp)


def test_stats_are_fp32_and_eps_default():
    x = np.full((3, 8), 2.0, np.float32)  # zero variance: y = beta exactly
    b = np.arange(8, dtype=np.float32)
    y = tln.layer_norm(torch.from_numpy(x), None, torch.from_numpy(b))
    np.testing.assert_array_equal(y.numpy(), np.broadcast_to(b, (3, 8)))


def test_kernel_wrapper_never_takes_the_plain_version():
    """The kernel wrapper launches or raises: a CPU tensor does not
    quietly get the plain version from it."""
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tln.layer_norm_fwd(x, None, None)
