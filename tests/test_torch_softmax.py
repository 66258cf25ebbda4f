"""apex_tpu_torch.ops.softmax against apex_tpu.ops.softmax on the CPU.

The same numpy scores, masks and cotangents go through both packages.

- The port's kernel route (``scaled_masked_softmax`` with a gradient to
  track: the ``ScaledMaskedSoftmax`` Function, here over the plain
  ``softmax_fwd_reference`` / ``softmax_bwd_reference``) against the JAX
  op with ``impl="pallas"`` (the Pallas kernels in interpret mode, as
  ``tests/test_kernels.py`` runs them): values and ``jax.grad`` under a
  random cotangent. Both backwards work from y alone, so a fully masked
  row gets the same nonzero gradient in both.
- The port's plain route (``scaled_masked_softmax_reference``) against the
  JAX op with ``impl="xla"``: there a fully masked row's gradient is 0.

Tolerances: fp32 1e-5 absolute, values and grads (the same fp32 formula;
exp and the sums differ by an ulp or so between XLA and PyTorch); bf16 y
within 2^-8 (both round the same fp32 probability to bf16, one ulp of 1
apart at most) and bf16 dx within 2e-2 of max |dx| (the JAX package's own
bf16 bar, ``tests/test_flash_attention.py``). The CUDA kernels are held
against the plain versions on the card by ``chip_smoke.py``.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

jsm = importlib.import_module("apex_tpu.ops.softmax")
tsm = importlib.import_module("apex_tpu_torch.ops.softmax")
from apex_tpu_torch import ops  # noqa: E402

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}

CASES = {  # (b, h, sq, sk), mask heads (0: none), causal, scale
    "mask": ((2, 3, 16, 32), 1, False, 1.0),
    "mask-scaled": ((2, 3, 16, 32), 1, False, 0.125),
    "per-head-mask": ((2, 3, 16, 32), 3, False, 0.125),
    "causal": ((1, 2, 24, 24), 0, True, 0.5),
    "causal+mask": ((2, 2, 16, 16), 1, True, 0.125),
    "causal-sq<sk": ((1, 2, 8, 24), 0, True, 1.0),
    "causal-sq>sk+mask": ((1, 2, 40, 16), 1, True, 1.0),
    "sq17-sk33": ((2, 2, 17, 33), 1, False, 1.0),
}


def _inputs(shape, heads, seed=0, dead_row=None):
    rng = np.random.default_rng(seed)
    b, h, sq, sk = shape
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    mask = None
    if heads:
        mask = rng.random((b, heads, sq, sk)) < 0.3
        if dead_row is not None:
            mask[0, 0, dead_row] = True
    g = rng.normal(size=shape).astype(np.float32)
    return x, mask, g


def _jax(x, mask, g, scale, causal, impl, dtype):
    xj = jnp.asarray(x).astype(dtype)
    mj = None if mask is None else jnp.asarray(mask)

    def f(a):
        return jsm.scaled_masked_softmax(a, mj, scale, causal=causal,
                                         impl=impl)

    y = f(xj)
    dx = jax.grad(lambda a: jnp.sum(f(a).astype(jnp.float32)
                                    * jnp.asarray(g)))(xj)
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(dx.astype(jnp.float32)), y.dtype, dx.dtype)


def _port(x, mask, g, scale, causal, route, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    mt = None if mask is None else torch.from_numpy(mask)
    fn = tsm.scaled_masked_softmax if route == "kernel" else \
        tsm.scaled_masked_softmax_reference
    y = fn(xt, mt, scale, causal=causal)
    (y.float() * torch.from_numpy(g)).sum().backward()
    return y.detach().float().numpy(), xt.grad.float().numpy(), y, xt.grad


def _assert_matches(ty, tdx, jy, jdx, dt):
    if dt == "fp32":
        np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tdx, jdx, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(ty, jy, rtol=0, atol=2.0 ** -8)
        np.testing.assert_allclose(tdx, jdx, rtol=0,
                                   atol=2e-2 * np.abs(jdx).max())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_route_matches_jax_pallas(case, dt):
    shape, heads, causal, scale = CASES[case]
    x, mask, g = _inputs(shape, heads)
    tdt, jdt = DTYPES[dt]
    ty, tdx, y, dx = _port(x, mask, g, scale, causal, "kernel", tdt)
    assert type(y.grad_fn).__name__ == "ScaledMaskedSoftmaxBackward"
    assert y.dtype == tdt and dx.dtype == tdt
    jy, jdx, jy_dt, _ = _jax(x, mask, g, scale, causal, "pallas", jdt)
    assert jy_dt == jdt
    _assert_matches(ty, tdx, jy, jdx, dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", ["mask-scaled", "per-head-mask",
                                  "causal+mask", "causal-sq>sk+mask"])
def test_reference_route_matches_jax_xla(case, dt):
    shape, heads, causal, scale = CASES[case]
    x, mask, g = _inputs(shape, heads, seed=1)
    tdt, jdt = DTYPES[dt]
    ty, tdx, y, _ = _port(x, mask, g, scale, causal, "reference", tdt)
    assert y.dtype == tdt
    jy, jdx, _, _ = _jax(x, mask, g, scale, causal, "xla", jdt)
    _assert_matches(ty, tdx, jy, jdx, dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fully_masked_row_kernel_route_is_the_pallas_vjp(dt):
    """Row 5 fully masked: uniform 1/sk forward in both packages; the
    kernel route's gradient there is the Pallas VJP's, nonzero."""
    x, mask, g = _inputs((1, 2, 8, 16), 1, seed=2, dead_row=5)
    tdt, jdt = DTYPES[dt]
    ty, tdx, _, _ = _port(x, mask, g, 0.5, True, "kernel", tdt)
    np.testing.assert_allclose(ty[0, :, 5], 1.0 / 16, rtol=0, atol=0)
    jy, jdx, _, _ = _jax(x, mask, g, 0.5, True, "pallas", jdt)
    _assert_matches(ty, tdx, jy, jdx, dt)
    assert np.abs(tdx[0, :, 5]).max() > 1e-3
    # the plain route: the same forward, a zero gradient on that row
    ry, rdx, _, _ = _port(x, mask, g, 0.5, True, "reference", tdt)
    xy, xdx, _, _ = _jax(x, mask, g, 0.5, True, "xla", jdt)
    np.testing.assert_allclose(ry[0, :, 5], 1.0 / 16, rtol=0, atol=0)
    assert np.all(rdx[0, :, 5] == 0) and np.all(xdx[0, :, 5] == 0)
    _assert_matches(ry, rdx, xy, xdx, dt)


def test_upper_triang_variant_matches_jax():
    x, _, g = _inputs((2, 2, 24, 24), 0, seed=3)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tsm.scaled_upper_triang_masked_softmax(xt, 0.5)
    (y * torch.from_numpy(g)).sum().backward()
    f = lambda a: jsm.scaled_upper_triang_masked_softmax(  # noqa: E731
        a, 0.5, impl="pallas")
    jy = f(jnp.asarray(x))
    jdx = jax.grad(lambda a: jnp.sum(f(a) * jnp.asarray(g)))(jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=1e-5)
    assert float(y.detach()[0, 0, 0, 1]) < 1e-4


def test_no_grad_forward_is_the_plain_version():
    x, mask, _ = _inputs((2, 3, 16, 32), 3, seed=4)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        y = ops.scaled_masked_softmax(xt, mt, 0.125)
    assert y.grad_fn is None
    assert torch.equal(y, ops.softmax_fwd_reference(xt, mt, 0.125))


@pytest.mark.parametrize("route", ["kernel", "reference", "pallas"])
def test_mask_head_dim_must_be_1_or_h(route):
    x, mask, _ = _inputs((2, 4, 8, 8), 4, seed=5)
    with pytest.raises(ValueError, match="head dim must be 1 or 4"):
        if route == "pallas":
            jsm.scaled_masked_softmax(jnp.asarray(x), jnp.asarray(mask[:, :2]),
                                      1.0, impl="pallas")
        else:
            fn = ops.scaled_masked_softmax if route == "kernel" else \
                ops.scaled_masked_softmax_reference
            fn(torch.from_numpy(x), torch.from_numpy(mask[:, :2]), 1.0)


def test_plain_backward_is_the_kernel_formula():
    """softmax_bwd_reference computes scale * y * (g - sum g*y) from y, in
    y's dtype; softmax_fwd_reference gives x's dtype."""
    rng = np.random.default_rng(6)
    y = torch.softmax(torch.from_numpy(rng.normal(size=(3, 5, 7))), -1)
    g = torch.from_numpy(rng.normal(size=(3, 5, 7)))
    dx = ops.softmax_bwd_reference(g.float(), y.float(), 0.25)
    y64, g64 = y.double(), g.double()
    want = 0.25 * y64 * (g64 - (g64 * y64).sum(-1, keepdim=True))
    assert dx.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), want.numpy(), atol=1e-6)
    x = torch.zeros(1, 1, 2, 3, dtype=torch.float16)
    assert ops.softmax_fwd_reference(x).dtype == torch.float16


@pytest.mark.parametrize("sk,itemsize,aligned,route", [
    (77, 2, True, "resident"), (8192, 2, True, "resident"),
    (8193, 2, True, "two_pass"), (65536, 2, True, "two_pass"),
    (1024, 2, True, "warp"), (512, 2, True, "warp"), (96, 4, True, "warp"),
    (8, 2, True, "warp"), (1000, 2, True, "warp"),
    (1004, 2, True, "resident"), (1024, 2, False, "resident"),
    (4096, 2, True, "resident")])
def test_route_by_row_length(sk, itemsize, aligned, route):
    """Rows of at most WARP_MAX_COLS elements whose bytes are a multiple of
    16 (the tensors aligned to 16) take the warp route; unaligned rows keep
    the CTA route with scalar loads; longer rows the resident route up to
    RESIDENT_MAX_COLS, then the two-pass one."""
    assert tsm.WARP_MAX_COLS >= 1024
    assert ops.softmax_route(sk, itemsize, aligned) == route
    if (itemsize, aligned) == (2, True):
        assert ops.softmax_route(sk) == route
