"""FusedScaleMaskSoftmax of the port against the JAX package's, on the CPU.

The same numpy scores and masks go through
``apex_tpu.transformer.functional.FusedScaleMaskSoftmax`` (on the CPU its
``impl="auto"`` resolves to the XLA path) and
``apex_tpu_torch.transformer.functional.FusedScaleMaskSoftmax`` (on CPU
tensors its fused route is the ``ScaledMaskedSoftmax`` Function over the
plain versions of the kernels). Outputs and dtypes are compared, and grads
on inputs with no fully masked row: there the two backwards (the Pallas
VJP from y, and autograd through the XLA softmax) agree up to rounding.
Tolerances: fp32 1e-5 absolute; bf16 scores 2^-8 on probabilities (both
round the same fp32 value) and 2e-2 of max |dx| on grads (the port's fused
backward works from the bf16-rounded y, the XLA route's from fp32
probabilities). Mirrors ``tests/test_flash_attention.py``
(``test_fused_scale_mask_softmax_module``) and the softmax cases of
``tests/test_kernels.py``.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from apex_tpu.transformer.functional import AttnMaskType as JMask
from apex_tpu.transformer.functional import FusedScaleMaskSoftmax as JSoftmax
from apex_tpu_torch.transformer.functional import AttnMaskType, \
    FusedScaleMaskSoftmax

tsm = importlib.import_module("apex_tpu_torch.ops.softmax")

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -8, 2e-2)}


def _pair(kind, **kw):
    jkind = JMask.causal if kind == "causal" else JMask.padding
    tkind = AttnMaskType.causal if kind == "causal" else AttnMaskType.padding
    return JSoftmax(attn_mask_type=jkind, **kw), \
        FusedScaleMaskSoftmax(attn_mask_type=tkind, **kw)


def _inputs(shape, mask_p=0.3, seed=0):
    rng = np.random.default_rng(seed)
    b, h, sq, sk = shape
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    mask = rng.random((b, 1, sq, sk)) < mask_p if mask_p else None
    if mask is not None:
        mask[..., 0] = False  # no fully masked row
    g = rng.normal(size=shape).astype(np.float32)
    return x, mask, g


def _run_both(jmod, tmod, x, mask, g, tdt, grads=True):
    import jax

    jdt = jnp.float32 if tdt == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    mj = None if mask is None else jnp.asarray(mask)
    jy = jmod(xj, mj)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    mt = None if mask is None else torch.from_numpy(mask)
    ty = tmod(xt, mt)
    assert str(ty.dtype).split(".")[-1] == str(jy.dtype)
    out = [np.asarray(jy.astype(jnp.float32)), ty.detach().float().numpy()]
    if grads:
        jdx = jax.grad(lambda a: jnp.sum(
            jmod(a, mj).astype(jnp.float32) * jnp.asarray(g)))(xj)
        (ty.float() * torch.from_numpy(g)).sum().backward()
        out += [np.asarray(jdx.astype(jnp.float32)),
                xt.grad.float().numpy()]
    return out


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind,kw,mask_p", [
    ("padding", dict(scale=0.5), 0.3),
    ("causal", dict(softmax_in_fp32=False), 0.0),
    ("causal", dict(scale=0.125), 0.3),
    ("padding", dict(fused=False, scale=0.5), 0.3),
    ("causal", dict(softmax_in_fp32=False, scale=0.125), 0.3),
], ids=["padding", "causal-bf16-out", "causal+padding", "unfused",
        "causal+padding-out-dtype"])
def test_module_matches_jax(kind, kw, mask_p, tdt):
    jmod, tmod = _pair(kind, **kw)
    x, mask, g = _inputs((2, 4, 16, 16), mask_p)
    jy, ty, jdx, tdx = _run_both(jmod, tmod, x, mask, g, tdt)
    y_tol, dx_tol = TOL[tdt]
    np.testing.assert_allclose(ty, jy, rtol=0, atol=y_tol)
    if tdt == torch.bfloat16:
        dx_tol *= np.abs(jdx).max()
    np.testing.assert_allclose(tdx, jdx, rtol=0, atol=dx_tol)


def test_module_contract_as_the_reference_tests_it():
    """``test_fused_scale_mask_softmax_module``'s checks on the port."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, 4, 16, 16)).astype(
        np.float32)).to(torch.bfloat16)
    mask = torch.from_numpy(rng.random((2, 1, 16, 16)) < 0.3)
    sm = FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.padding,
                               scale=0.5)
    y = sm(x, mask)
    assert y.dtype == torch.float32  # softmax_in_fp32 default
    ref = FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.padding,
                                scale=0.5, fused=False)(x, mask)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=2e-2, atol=2e-2)
    yc = FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.causal,
                               softmax_in_fp32=False)(x)
    assert yc.dtype == torch.bfloat16
    s = yc.float().sum(-1).numpy()
    np.testing.assert_allclose(s, np.ones_like(s), rtol=2e-2)
    assert float(yc.float()[0, 0, 0, 1:].max()) == 0.0
    both = FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.causal)(x, mask)
    ref_both = FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.causal,
                                     fused=False)(x, mask)
    np.testing.assert_allclose(both.numpy(), ref_both.numpy(), rtol=2e-2,
                               atol=2e-2)


def _counting(monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tsm.softmax_fwd_reference, tsm.softmax_bwd_reference

    def f(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def b(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(tsm, "softmax_fwd_reference", f)
    monkeypatch.setattr(tsm, "softmax_bwd_reference", b)
    return calls


@pytest.mark.parametrize("shape,kw,fused_route", [
    ((2, 2, 16, 16), dict(), True),
    ((2, 2, 12, 30), dict(), False),   # unaligned sk: the plain route
    ((2, 2, 17, 16), dict(), False),   # unaligned sq
    ((2, 2, 16, 16), dict(fused=False), False),
])
def test_routing(monkeypatch, shape, kw, fused_route):
    """The reference's route choice: the fused op (whose Function on the
    card launches the kernels, here their plain versions) only with
    ``fused`` and 8-aligned sq, sk; else ``scaled_masked_softmax_reference``
    and plain autograd."""
    calls = _counting(monkeypatch)
    x = torch.randn(shape, requires_grad=True)
    y = FusedScaleMaskSoftmax(**kw)(x)
    y.sum().backward()
    assert calls == ({"fwd": 1, "bwd": 1} if fused_route
                     else {"fwd": 0, "bwd": 0})
    assert FusedScaleMaskSoftmax.is_kernel_available(*shape[2:]) == (
        shape[2] % 8 == 0 and shape[3] % 8 == 0)


def test_unaligned_matches_jax():
    """An unaligned sk takes the plain route in both packages."""
    jmod, tmod = _pair("padding")
    x, _, g = _inputs((2, 2, 12, 30), 0.0, seed=8)
    jy, ty, jdx, tdx = _run_both(jmod, tmod, x, None, g, torch.float32)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tdx, jdx, rtol=0, atol=1e-5)


def test_mask_func_and_per_head_mask():
    """``mask_func`` preprocesses the mask; a (b, h, sq, sk) mask is
    honoured per head; a head dim other than 1 or h raises."""
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(2, 3, 16, 32)) * 3).astype(np.float32)
    keep = rng.random((2, 3, 16, 32)) > 0.3  # True = keep
    keep[..., 0] = True
    jmod = JSoftmax(mask_func=lambda m: ~m)
    tmod = FusedScaleMaskSoftmax(mask_func=lambda m: ~m)
    jy = jmod(jnp.asarray(x), jnp.asarray(keep))
    ty = tmod(torch.from_numpy(x), torch.from_numpy(keep))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    assert float(ty[torch.from_numpy(~keep)].max()) < 1e-3
    with pytest.raises(ValueError, match="head dim"):
        tmod(torch.from_numpy(x), torch.from_numpy(keep[:, :2]))


def test_fp16_scores_keep_their_dtype():
    x = torch.randn(1, 2, 8, 16).to(torch.float16)
    y = FusedScaleMaskSoftmax(softmax_in_fp32=False)(x)
    assert y.dtype == torch.float16
    ref = FusedScaleMaskSoftmax(softmax_in_fp32=False, fused=False)(x)
    assert torch.equal(y, ref)
