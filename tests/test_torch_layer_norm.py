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


# ---------------------------------------------------------------------------
# backward: the port's FusedNorm (plain backward on the CPU) against
# jax.grad of the JAX package's fused norm, whose backward is _ln_bwd_kernel
# run in Pallas interpret mode (impl="pallas", as tests/test_kernels.py:28)
# ---------------------------------------------------------------------------

import jax  # noqa: E402


def _bwd_case(variant, rows=6, hidden=48, seed=3):
    x, w, b = _inputs(rows, hidden, seed)
    g = np.random.default_rng(seed + 1).normal(size=x.shape).astype(
        np.float32)
    w = None if variant == "none" else w
    b = b if variant == "wb" else None
    return x, w, b, g


def _torch_grads(x, w, b, g, rms, dtype=torch.float32):
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    tw = None if w is None else torch.from_numpy(w).requires_grad_()
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    y = tln.rms_norm(tx, tw) if rms else tln.layer_norm(tx, tw, tb)
    assert type(y.grad_fn).__name__ == "FusedNormBackward"
    y.backward(torch.from_numpy(g).to(dtype))
    return [None if t is None else t.grad for t in (tx, tw, tb)]


def _jax_grads(x, w, b, g, rms, impl, dtype=jnp.float32):
    def f(x, w, b):
        xx = x.astype(dtype)
        y = (jln.rms_norm(xx, w, impl=impl) if rms
             else jln.layer_norm(xx, w, b, impl=impl))
        return jnp.sum(y.astype(jnp.float32) * g)

    args = tuple(None if a is None else jnp.asarray(a) for a in (x, w, b))
    argnums = tuple(i for i, a in enumerate(args) if a is not None)
    grads = jax.grad(f, argnums=argnums)(*args)
    out = [None, None, None]
    for i, gr in zip(argnums, grads):
        out[i] = np.asarray(gr)
    return out


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("variant", ["wb", "w", "none"])
def test_backward_matches_jax_pallas_kernel_fp32(rms, variant):
    """dx/dgamma/dbeta at fp32 within 2e-5 (same fp32 math, another
    summation order) of the interpret-mode Pallas backward and of jax.grad
    through the plain JAX norm."""
    x, w, b, g = _bwd_case(variant)
    if rms:
        b = None
    got = _torch_grads(x, w, b, g, rms)
    for impl in ("pallas", "xla"):
        ref = _jax_grads(x, w, b, g, rms, impl)
        for a, r in zip(got, ref):
            assert (a is None) == (r is None)
            if a is not None:
                np.testing.assert_allclose(a.numpy(), r, atol=2e-5,
                                           rtol=2e-5)


@pytest.mark.parametrize("rms", [False, True])
def test_backward_bf16_activations_fp32_affine(rms):
    """bf16 x and dy with fp32 gamma/beta (the O2 case): dx in bf16 within
    2 bf16 ulps of |dx| plus 1e-3 (both round fp32 values computed in
    another order), dgamma/dbeta fp32 within 1e-3 relative (sums of bf16
    inputs over the rows)."""
    x, w, b, g = _bwd_case("wb", rows=16, hidden=64, seed=5)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    gb = np.array(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    if rms:
        b = None
    got = _torch_grads(xb, w, b, gb, rms, dtype=torch.bfloat16)
    ref = _jax_grads(xb, w, b, gb, rms, "pallas", dtype=jnp.bfloat16)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    dx, rdx = got[0].float().numpy(), np.asarray(ref[0], np.float32)
    assert np.all(np.abs(dx - rdx) <= np.abs(rdx) * 2.0 ** -7 + 1e-3)
    for a, r in zip(got[1:], ref[1:]):
        if a is not None:
            np.testing.assert_allclose(a.numpy(), r, rtol=1e-3,
                                       atol=1e-3 * np.abs(r).max())


def test_plain_backward_matches_autograd_of_plain_forward():
    """layer_norm_bwd_reference equals autograd through the plain forward
    (fp32, 2e-5)."""
    x, w, b, g = _bwd_case("wb", rows=5, hidden=40, seed=9)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    tln.layer_norm_reference(tx, tw, tb).backward(torch.from_numpy(g))
    _, mean, rstd = tln._norm_stats_reference(tx.detach(), tw, tb, 1e-5,
                                              False)
    dx, dw, db = tln.layer_norm_bwd_reference(
        torch.from_numpy(g), tx.detach(), mean, rstd, tw.detach(),
        has_bias=True)
    for a, r in ((dx, tx.grad), (dw, tw.grad), (db, tb.grad)):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=2e-5)


def test_backward_wrapper_never_takes_the_plain_version():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tln.layer_norm_bwd(x, x, torch.zeros(2), torch.ones(2), None)


# ---------------------------------------------------------------------------
# routing: which kernel route a row takes on the card (pure Python, so the
# CPU holds it), the backward's grid, and parity at the routes' edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hidden,itemsize,aligned,backward,route", [
    # forward: aligned rows up to LN_WARP_MAX_COLS take the warp route
    (1024, 2, True, False, "warp"), (2048, 2, True, False, "warp"),
    (2056, 2, True, False, "cta"), (4096, 2, True, False, "cta"),
    (8192, 2, True, False, "cta"), (8, 2, True, False, "warp"),
    (1000, 2, True, False, "warp"), (1001, 2, True, False, "cta"),
    (1004, 2, True, False, "cta"), (1024, 2, False, False, "cta"),
    (4, 4, True, False, "warp"), (2, 4, True, False, "cta"),
    (1001, 4, True, False, "cta"), (2048, 4, True, False, "warp"),
    (2052, 4, True, False, "cta"), (16384, 4, True, False, "cta"),
    # backward: the same rule with LN_BWD_WARP_MAX_COLS
    (1024, 2, True, True, "warp"), (1000, 2, True, True, "warp"),
    (1032, 2, True, True, "cta"), (2048, 2, True, True, "cta"),
    (1001, 2, True, True, "cta"), (1024, 2, False, True, "cta"),
    (1024, 4, True, True, "warp"), (1028, 4, True, True, "cta"),
    (8192, 2, True, True, "cta"), (16384, 4, True, True, "cta"),
])
def test_ln_route(hidden, itemsize, aligned, backward, route):
    """Rows whose bytes are a multiple of 16, with every pointer on 16
    bytes, take the warp route up to the cap chosen on the card (2048
    columns forward, 1024 backward); unaligned or wider rows the CTA
    route."""
    assert (tln.LN_WARP_MAX_COLS, tln.LN_BWD_WARP_MAX_COLS) == (2048, 1024)
    assert tln.ln_route(hidden, itemsize, aligned, backward) == route
    if not backward:
        assert tln.ln_route(hidden, itemsize, aligned) == route


@pytest.mark.parametrize("rows,route,sms,grid", [
    (8192, "warp", 132, 132), (8192, "cta", 132, 256),
    (1, "warp", 132, 1), (1, "cta", 132, 1),
    (33, "warp", 132, 5), (33, "cta", 132, 2),
    (1056, "warp", 132, 132), (1057, "warp", 132, 132),
    (100, "warp", 8, 8),
])
def test_ln_bwd_grid(rows, route, sms, grid):
    """The backward's CTAs, and so its partial rows: on the warp route as
    many as the card holds (LN_BWD_CTAS_PER_SM an SM) or fewer where the
    rows do not give each warp one; on the CTA route one per 32 rows."""
    assert (tln.LN_BWD_WARP_ROWS, tln.LN_BWD_CTAS_PER_SM,
            tln.LN_BWD_CTA_ROWS) == (8, 1, 32)
    assert tln.ln_bwd_grid(rows, route, sms) == grid


def test_ln_bwd_grid_gives_every_warp_a_row_and_fits_the_card():
    warps = tln.LN_BWD_WARP_ROWS
    for sms in (1, 8, 132):
        for rows in range(1, 3000, 37):
            grid = tln.ln_bwd_grid(rows, "warp", sms)
            assert 1 <= grid <= sms * tln.LN_BWD_CTAS_PER_SM
            assert (grid - 1) * warps < rows  # no CTA without a row
            cta = tln.ln_bwd_grid(rows, "cta", sms)
            assert (cta - 1) * tln.LN_BWD_CTA_ROWS < rows <= \
                cta * tln.LN_BWD_CTA_ROWS


@pytest.mark.parametrize("hidden", [1001, 2056])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_norm_at_route_edges_matches_jax(hidden, rms, dtype):
    """FusedNorm at the routes' edges (rows of 1001 elements: unaligned on
    the card; 2056: past both warp caps), 2 rows: y against the JAX
    package's ``impl="xla"`` norm, dx/dgamma/dbeta against ``jax.grad`` of
    the interpret-mode Pallas kernels. fp32 within 1e-5 (y) and 2e-5 (grads);
    bf16 within one bf16 ulp (y), two ulps + 1e-3 (dx) and 1e-3 relative
    (dgamma/dbeta), as the tests above."""
    for backward in (False, True):
        for itemsize in (2, 4):
            assert tln.ln_route(hidden, itemsize, True, backward) == "cta"
    x, w, b, g = _bwd_case("wb", rows=1, hidden=hidden, seed=11)
    if rms:
        b = None
    bf16 = dtype == "bfloat16"
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                else (torch.float32, jnp.float32))
    if bf16:  # identical bf16 values on both sides
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        g = np.array(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    tx = torch.from_numpy(x).to(tdt)
    tw = torch.from_numpy(w)
    tb = None if b is None else torch.from_numpy(b)
    xj = jnp.asarray(x, jdt)
    if rms:
        got = tln.rms_norm(tx, tw)
        ref = jln.rms_norm(xj, jnp.asarray(w), impl="xla")
    else:
        got = tln.layer_norm(tx, tw, tb)
        ref = jln.layer_norm(xj, jnp.asarray(w), jnp.asarray(b), impl="xla")
    assert got.dtype == tdt
    ref32 = np.asarray(ref.astype(jnp.float32))
    got32 = got.float().numpy()
    if bf16:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref32), 1e-30)))
                      - 7)
        assert np.all(np.abs(got32 - ref32) <= ulp)
    else:
        np.testing.assert_allclose(got32, ref32, atol=1e-5)
    grads = _torch_grads(x, w, b, g, rms, dtype=tdt)
    refs = _jax_grads(x, w, b, g, rms, "pallas", dtype=jdt)
    for i, (a, r) in enumerate(zip(grads, refs)):
        assert (a is None) == (r is None)
        if a is None:
            continue
        a, r = a.float().numpy(), np.asarray(r, np.float32)
        if not bf16:
            np.testing.assert_allclose(a, r, atol=2e-5, rtol=2e-5)
        elif i == 0:
            assert np.all(np.abs(a - r) <= np.abs(r) * 2.0 ** -7 + 1e-3)
        else:
            np.testing.assert_allclose(a, r, rtol=1e-3,
                                       atol=1e-3 * np.abs(r).max())
