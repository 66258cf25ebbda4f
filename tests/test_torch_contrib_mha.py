"""contrib.multihead_attn of the port against the JAX package's, on the CPU.

The port's ``SelfMultiheadAttn`` / ``EncdecMultiheadAttn`` load the JAX
modules' ``init`` trees (``params_from_numpy``), the same numpy inputs go
through both, and a cotangent through ``jax.grad`` and
``torch.autograd``: the output, every parameter's grad and the inputs'.
The JAX modules run ``impl="default"`` (the XLA route of the CPU); the
port runs both of its routes: ``impl="default"`` (the explicit
``mha_reference``) and ``impl="fast"`` (``flash_attention``'s autograd
Function, the card's route, over its plain versions here). Cases: with and
without biases, ``include_norm_add``, a key-padding mask, bool and float
``attn_mask``,
enc-dec with sq != sk, rows whose every key is masked (their own
tolerance, stated in the test), and the explicit-scores path that dropout takes
(dropout made the identity on both sides, so the arithmetic is compared)
in fp32 and bf16. Tolerances: fp32 2e-5 relative and absolute (the JAX
package's own bar in ``tests/test_multihead_attn.py``; the same fp32
math, sums in another order); bf16 2e-2 of max |ref| (bf16 products
rounded in another order). Then the six cases of
``tests/test_multihead_attn.py`` on the port, the dropout case with a
``torch.Generator`` in place of the key.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.contrib import multihead_attn as jmha
from apex_tpu_torch.contrib import multihead_attn as pmha
from apex_tpu_torch.contrib import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
    mha_naive_reference,
)

E, H = 32, 4


def _np(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


def _close(a, b, rtol=2e-5, atol=2e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol, atol=atol)


def _masks(rng, b, sq, sk, pad, attn_mask, dead=False):
    """Key-padding mask and attn_mask. Every query row keeps key 0 unless
    ``dead``: then the last sequence is fully padded and, with a bool
    mask, query row 0 masks every key."""
    kpm = None
    if pad:
        lengths = rng.integers(1, sk, b)
        if dead:
            lengths[-1] = 0
        kpm = np.arange(sk)[None, :] >= lengths[:, None]
    am = None
    if attn_mask == "bool":
        am = rng.random((sq, sk)) < 0.3
        am[:, 0] = dead
        if dead:
            am[0] = True
    elif attn_mask == "float":
        am = rng.normal(size=(sq, sk)).astype(np.float32)
    return kpm, am


def _jax_run(jm, params, inputs, kw, g):
    def f(p, *xs):
        return jnp.sum(jm.apply(p, *xs, **kw) * g)

    out = jm.apply(params, *inputs, **kw)
    grads = jax.grad(f, argnums=tuple(range(1 + len(inputs))))(
        params, *inputs)
    return np.asarray(out), grads


def _port_run(tm, inputs, kw, g):
    xs = [torch.from_numpy(np.asarray(x)).requires_grad_() for x in inputs]
    out = tm(*xs, **kw)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(out, [*tm.parameters(), *xs],
                                torch.from_numpy(g))
    return (out.detach().numpy(), dict(zip(names, grads[:len(names)])),
            grads[len(names):])


def _compare(jm, tm, inputs, jkw, tkw, g, grad_share=None):
    """Output and grads of the port against JAX at 2e-5; with
    ``grad_share``, the grads to that share of each one's max |JAX|."""
    params = jm.init(jax.random.PRNGKey(0))
    # affine LN params away from ones/zeros, biases away from zero
    rng = np.random.default_rng(5)
    params = {k: v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
              if k.endswith("bias") or k.startswith("ln") else v
              for k, v in _np(params).items()}
    tm.params_from_numpy(params)
    jout, jgrads = _jax_run(jm, params, inputs, jkw, g)
    tout, tgrads, txgrads = _port_run(tm, inputs, tkw, g)
    assert np.isfinite(tout).all()
    _close(tout, jout)
    assert set(tgrads) == set(params)
    pairs = [(t.numpy(), np.asarray(jgrads[0][name]))
             for name, t in tgrads.items()]
    pairs += [(t.numpy(), np.asarray(j)) for t, j in zip(txgrads, jgrads[1:])]
    for t, j in pairs:
        assert np.isfinite(t).all()
        if grad_share is None:
            _close(t, j)
        else:
            assert np.abs(t - j).max() <= grad_share * np.abs(j).max()


SELF_CASES = {  # bias, include_norm_add, key padding, attn_mask
    "plain": (False, False, False, None),
    "bias": (True, False, False, None),
    "norm_add_padding": (True, True, True, None),
    "padding_bool_mask": (False, False, True, "bool"),
    "norm_add_padding_float_mask": (True, True, True, "float"),
}


@pytest.mark.parametrize("impl", ["default", "fast"])
@pytest.mark.parametrize("case", sorted(SELF_CASES))
def test_self_attn_against_jax(case, impl):
    bias, norm, pad, attn_mask = SELF_CASES[case]
    rng = np.random.default_rng(1)
    b, s = 3, 12
    x = rng.normal(size=(b, s, E)).astype(np.float32)
    kpm, am = _masks(rng, b, s, s, pad, attn_mask)
    g = rng.normal(size=(b, s, E)).astype(np.float32)
    jm = jmha.SelfMultiheadAttn(E, H, bias=bias, include_norm_add=norm,
                                impl="default")
    tm = SelfMultiheadAttn(E, H, bias=bias, include_norm_add=norm, impl=impl,
                           device="cpu")
    jkw = dict(key_padding_mask=None if kpm is None else jnp.asarray(kpm),
               attn_mask=None if am is None else jnp.asarray(am))
    tkw = dict(key_padding_mask=None if kpm is None else torch.from_numpy(kpm),
               attn_mask=None if am is None else torch.from_numpy(am))
    _compare(jm, tm, [x], jkw, tkw, g)


@pytest.mark.parametrize("impl", ["default", "fast"])
@pytest.mark.parametrize("bias,norm,pad", [(False, False, False),
                                           (True, True, True)])
def test_encdec_attn_against_jax(bias, norm, pad, impl):
    rng = np.random.default_rng(2)
    b, sq, sk = 2, 7, 13
    q = rng.normal(size=(b, sq, E)).astype(np.float32)
    mem = rng.normal(size=(b, sk, E)).astype(np.float32)
    kpm, _ = _masks(rng, b, sq, sk, pad, None)
    g = rng.normal(size=(b, sq, E)).astype(np.float32)
    jm = jmha.EncdecMultiheadAttn(E, H, bias=bias, include_norm_add=norm,
                                  impl="default")
    tm = EncdecMultiheadAttn(E, H, bias=bias, include_norm_add=norm,
                             impl=impl, device="cpu")
    jkw = dict(key_padding_mask=None if kpm is None else jnp.asarray(kpm))
    tkw = dict(key_padding_mask=None if kpm is None else torch.from_numpy(kpm))
    _compare(jm, tm, [q, mem], jkw, tkw, g)


@pytest.mark.parametrize("impl", ["default", "fast"])
def test_rows_with_every_key_masked(impl):
    """A fully padded sequence and a query row whose every key the bool
    mask hides: every score is near -1e4 (or -2e4), so the row attends
    uniformly and nothing is NaN. The output and the explicit route's
    grads hold at 2e-5. The flash route's backward recomputes P =
    exp(S - lse) from the forward's fp32 lse, and an fp32 lse near -1e4
    carries an ulp of 2^-10 (~1e-3): its grads hold to 2e-3 of each
    grad's max |JAX| (the card's kernels keep the same fp32 lse)."""
    rng = np.random.default_rng(6)
    b, s = 3, 12
    x = rng.normal(size=(b, s, E)).astype(np.float32)
    kpm, am = _masks(rng, b, s, s, True, "bool", dead=True)
    g = rng.normal(size=(b, s, E)).astype(np.float32)
    jm = jmha.SelfMultiheadAttn(E, H, bias=True, include_norm_add=True,
                                impl="default")
    tm = SelfMultiheadAttn(E, H, bias=True, include_norm_add=True,
                           impl=impl, device="cpu")
    _compare(jm, tm, [x],
             dict(key_padding_mask=jnp.asarray(kpm),
                  attn_mask=jnp.asarray(am)),
             dict(key_padding_mask=torch.from_numpy(kpm),
                  attn_mask=torch.from_numpy(am)), g,
             grad_share=None if impl == "default" else 2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_explicit_scores_path_against_jax(monkeypatch, dtype):
    """With a dropout generator and dropout > 0 both take the explicit
    scores (einsum in q's dtype, fp32 softmax, cast): dropout made the
    identity on both sides, the outputs agree."""
    monkeypatch.setattr(jmha, "_dropout", lambda x, key, rate: x)
    monkeypatch.setattr(pmha, "inverted_dropout", lambda x, rate, gen: x)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 10, E)).astype(np.float32)
    kpm, am = _masks(rng, 2, 10, 10, True, "float")
    jm = jmha.SelfMultiheadAttn(E, H, dropout=0.5, bias=True,
                                include_norm_add=True, impl="default")
    params = _np(jm.init(jax.random.PRNGKey(0)))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tm = SelfMultiheadAttn(E, H, dropout=0.5, bias=True,
                           include_norm_add=True, device="cpu")
    tm.params_from_numpy(params)
    jout = jm.apply(params, jnp.asarray(x).astype(jdt),
                    key_padding_mask=jnp.asarray(kpm),
                    attn_mask=jnp.asarray(am),
                    dropout_key=jax.random.PRNGKey(7))
    tout = tm(torch.from_numpy(x).to(tdt),
              key_padding_mask=torch.from_numpy(kpm),
              attn_mask=torch.from_numpy(am),
              generator=torch.Generator().manual_seed(7))
    assert tout.dtype == tdt
    jout = np.asarray(jout.astype(jnp.float32))
    tout = tout.detach().float().numpy()
    if dtype == "float32":
        _close(tout, jout)
    else:
        err = np.abs(tout - jout).max() / np.abs(jout).max()
        assert err < 2e-2, err


def test_masks_are_minus_10000_not_inf():
    kpm = torch.tensor([[False, True, True]])
    bias = pmha._padding_bias(kpm)
    assert bias.shape == (1, 1, 1, 3) and bias.dtype == torch.float32
    assert bias.flatten().tolist() == [0.0, -10000.0, -10000.0]
    extra = pmha._mask_bias(torch.tensor([[True, False]]))
    assert extra.shape == (1, 1, 1, 2)
    assert extra.flatten().tolist() == [-10000.0, 0.0]
    f = torch.tensor([[0.5, -1.5]], dtype=torch.float64)
    assert pmha._mask_bias(f).dtype == torch.float32


def test_params_round_trip_and_checks():
    jm = jmha.EncdecMultiheadAttn(E, H, bias=True, include_norm_add=True)
    params = _np(jm.init(jax.random.PRNGKey(4)))
    tm = EncdecMultiheadAttn(E, H, bias=True, include_norm_add=True,
                             device="cpu")
    tm.params_from_numpy(params)
    back = tm.to_numpy()
    assert set(back) == set(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
    with pytest.raises(ValueError, match="names"):
        tm.params_from_numpy({k: v for k, v in params.items()
                              if k != "ln_bias"})
    with pytest.raises(ValueError, match="divisible"):
        SelfMultiheadAttn(30, 4, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        SelfMultiheadAttn(E, H, impl="xla", device="cpu")


# -- the cases of tests/test_multihead_attn.py --------------------------------

def _x(shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _params(m):
    return dict(m.named_parameters())


def test_self_attn_matches_naive():
    mha = SelfMultiheadAttn(embed_dim=32, num_heads=4, device="cpu")
    x = _x((2, 16, 32))
    with torch.no_grad():
        out = mha(x)
        ref = mha_naive_reference(_params(mha), x, num_heads=4)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


def test_self_attn_bias_and_grads():
    mha = SelfMultiheadAttn(embed_dim=32, num_heads=4, bias=True,
                            device="cpu")
    x = _x((2, 8, 32))
    loss = mha(x).square().sum()
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in mha.parameters())
    assert mha.in_bias.grad.shape == (96,)


@pytest.mark.parametrize("impl", ["default", "fast"])
def test_self_attn_key_padding_mask(impl):
    """Masked keys do not move the output at unmasked queries."""
    mha = SelfMultiheadAttn(embed_dim=16, num_heads=2, impl=impl,
                            device="cpu")
    x = _x((1, 8, 16))
    pad = torch.zeros(1, 8, dtype=torch.bool)
    pad[:, -2:] = True
    with torch.no_grad():
        out1 = mha(x, key_padding_mask=pad)
        x2 = x.clone()
        x2[:, -1] += 3.0
        out2 = mha(x2, key_padding_mask=pad)
    torch.testing.assert_close(out1[:, :6], out2[:, :6], rtol=1e-5,
                               atol=1e-5)


def test_norm_add_residual_path():
    mha = SelfMultiheadAttn(embed_dim=16, num_heads=2, include_norm_add=True,
                            device="cpu")
    assert hasattr(mha, "ln_scale")
    x = _x((2, 8, 16))
    with torch.no_grad():
        out = mha(x)
        mha.out_weight.zero_()  # no attention output: the residual alone
        torch.testing.assert_close(mha(x), x, rtol=1e-6, atol=1e-6)
    assert out.shape == x.shape


def test_encdec_attn_shapes_and_memory_dependence():
    mha = EncdecMultiheadAttn(embed_dim=16, num_heads=2, bias=True,
                              device="cpu")
    q, mem = _x((2, 6, 16), 1), _x((2, 10, 16), 2)
    with torch.no_grad():
        out = mha(q, mem)
        out2 = mha(q, mem + 1.0)
    assert out.shape == (2, 6, 16)
    assert float((out - out2).abs().max()) > 1e-4


def test_attn_dropout_determinism():
    mha = SelfMultiheadAttn(embed_dim=16, num_heads=2, dropout=0.5,
                            device="cpu")
    x = _x((2, 8, 16))
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    with torch.no_grad():
        o1 = mha(x, generator=gen(3))
        o2 = mha(x, generator=gen(3))
        o3 = mha(x, generator=gen(4))
        oe = mha(x)  # no generator: no dropout
        ref = mha_naive_reference(_params(mha), x, num_heads=2)
    torch.testing.assert_close(o1, o2, rtol=0, atol=0)
    assert float((o1 - o3).abs().max()) > 1e-5
    torch.testing.assert_close(oe, ref, rtol=2e-5, atol=2e-5)
