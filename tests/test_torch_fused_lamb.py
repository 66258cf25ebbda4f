"""apex_tpu_torch FusedLAMB against apex_tpu's ``fused_lamb`` on the CPU,
from the same numpy params and grads (mirrors the LAMB cases of
tests/test_optimizers.py:94-110 and :190-239).

- several plain (fp32) steps with the global-norm clip, weight decay, the
  trust ratio, ``use_nvlamb``, no bias correction and no grad averaging:
  params and both moments within 1e-6 of JAX's (fp32 arithmetic in
  another order; the norms are sums of squares in another order);
- ``weight_decay=0`` without ``use_nvlamb`` is plain clipped Adam (the
  trust ratio is 1): equal to the port's FusedAdam within 1e-6;
- under ``MixedPrecisionOptimizer`` O2 with a skipped overflow step:
  masters and moments within 1e-6 of JAX's, the skipped step leaves them
  bit-identical and halves the scale, and the bf16 params equal the
  masters cast down;
- ``adam_w_mode=False`` raises as in the reference, ``norm_psum_axis``
  names its ROADMAP item;
- the optimizer-step benchmark runs on the CPU at a tiny size and its
  eager Adam takes the fused Adam's step (1e-6).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu import amp as jamp
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.optimizers import fused_lamb as jax_fused_lamb
from apex_tpu_torch import amp as tamp
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB

TOL = 1e-6


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(6, 5)).astype(np.float32),
            rng.normal(size=(5,)).astype(np.float32),
            np.zeros((4,), np.float32),  # a zero leaf: trust ratio 1
            (1 + 0.1 * rng.normal(size=(7,))).astype(np.float32)]


def _grads(tree, steps, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return [[(scale * rng.normal(size=p.shape)).astype(np.float32)
             for p in tree] for _ in range(steps)]


def _run_both(kw, steps=4, grad_scale=1.0):
    tree = _tree()
    gs = _grads(tree, steps, scale=grad_scale)
    jopt = jax_fused_lamb(**kw)
    jp = [jnp.asarray(p) for p in tree]
    js = jopt.init(jp)
    topt = FusedLAMB(**kw)
    tp = [torch.from_numpy(p.copy()) for p in tree]
    ts = topt.init(tp)
    for g in gs:
        upd, js = jopt.update([jnp.asarray(a) for a in g], js, jp)
        jp = [a + u for a, u in zip(jp, upd)]
        ts = topt.update_(tp, [torch.from_numpy(a) for a in g], ts)
    assert ts.step == int(js.step) == steps
    return tp, ts, jp, js


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2, weight_decay=0.01),                        # clip active
    dict(lr=1e-2, weight_decay=0.01, max_grad_norm=0.0),     # no clip
    dict(lr=5e-3, weight_decay=0.0, use_nvlamb=True),
    dict(lr=1e-2, weight_decay=0.1, bias_correction=False),
    dict(lr=1e-2, weight_decay=0.01, grad_averaging=False,
         betas=(0.8, 0.99), eps=1e-8),
], ids=["clip", "no_clip", "nvlamb", "no_bias_correction",
        "no_grad_averaging"])
def test_steps_match_jax(kw):
    tp, ts, jp, js = _run_both(kw, grad_scale=3.0)
    for got, ref in ((tp, jp), (ts.exp_avg, js.exp_avg),
                     (ts.exp_avg_sq, js.exp_avg_sq)):
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=TOL,
                                       atol=TOL)


def test_no_wd_no_nvlamb_is_clipped_adam():
    """weight_decay=0 without use_nvlamb: the trust ratio is 1, so LAMB
    with the clip off steps as Adam (tests/test_optimizers.py:103)."""
    tree = _tree(3)
    gs = _grads(tree, 5, seed=4)
    lamb = FusedLAMB(lr=1e-3, weight_decay=0.0, max_grad_norm=0.0, eps=1e-8)
    adam = FusedAdam(lr=1e-3, weight_decay=0.0, eps=1e-8)
    pl = [torch.from_numpy(p.copy()) for p in tree]
    pa = [torch.from_numpy(p.copy()) for p in tree]
    sl, sa = lamb.init(pl), adam.init(pa)
    for g in gs:
        sl = lamb.update_(pl, [torch.from_numpy(a) for a in g], sl)
        sa = adam.update_(pa, [torch.from_numpy(a) for a in g], sa)
    for a, b in zip(pl, pa):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=TOL)


def test_o2_fused_lamb_matches_jax_with_a_skipped_step():
    tree = _tree(5)
    names = [f"p{i}" for i in range(len(tree))]
    grads = _grads(tree, 5, seed=6, scale=1000.0)
    grads[2][1][1] = np.inf
    kw = dict(lr=1e-2, weight_decay=0.01)
    jpol = jamp.get_policy("O2")
    jparams = jamp.cast_params({n: jnp.asarray(p) for n, p in
                                zip(names, tree)}, jpol)
    jmp = jamp.MixedPrecisionOptimizer(JaxFusedLAMB(**kw), jpol)
    jstate = jmp.init(jparams)
    tpol = tamp.get_policy("O2")
    params = [torch.from_numpy(p.copy()).to(torch.bfloat16) for p in tree]
    tmp = tamp.MixedPrecisionOptimizer(FusedLAMB(**kw), tpol)
    tstate = tmp.init(params)
    for m, n in zip(tstate.master, names):  # the same masters both sides
        np.testing.assert_array_equal(
            m.numpy(), np.asarray(jparams[n].astype(jnp.float32)))
    for i, g in enumerate(grads):
        jg = {n: jnp.asarray(a).astype(jnp.bfloat16)
              for n, a in zip(names, g)}
        jparams, jstate, jm = jmp.apply_gradients(jstate, jparams, jg)
        before = [t.clone() for t in tstate.master] + [
            t.clone() for t in tstate.inner.exp_avg + tstate.inner.exp_avg_sq]
        tg = [torch.from_numpy(np.array(jg[n].astype(jnp.float32))).to(
            torch.bfloat16) for n in names]
        tm = tmp.apply_gradients(tstate, params, tg)
        assert tm["found_inf"] == bool(jm["found_inf"]) == (i == 2)
        assert tm["loss_scale"] == float(jm["loss_scale"])
        if i == 2:
            after = list(tstate.master) + list(
                tstate.inner.exp_avg + tstate.inner.exp_avg_sq)
            assert all(torch.equal(a, b) for a, b in zip(before, after))
            assert tm["loss_scale"] == 2.0 ** 15
        for got, ref in ((tstate.master, jstate.master),
                         (tstate.inner.exp_avg, jstate.inner.exp_avg),
                         (tstate.inner.exp_avg_sq, jstate.inner.exp_avg_sq)):
            for a, n in zip(got, names):
                np.testing.assert_allclose(a.numpy(), np.asarray(ref[n]),
                                           rtol=TOL, atol=TOL)
        for p, m in zip(params, tstate.master):
            assert torch.equal(p, m.to(p.dtype))
    assert tstate.inner.step == int(jstate.inner.step) == 4


def test_options_outside_the_reference_raise():
    with pytest.raises(RuntimeError, match="adam_w_mode"):
        FusedLAMB(adam_w_mode=False)
    with pytest.raises(RuntimeError, match="adam_w_mode"):
        jax_fused_lamb(adam_w_mode=False)
    # the ZeRO-sharded norms are in the port now (optimizers.distributed)
    assert FusedLAMB(norm_psum_axis="data").norm_psum_axis == "data"


def test_optimizer_step_benchmark_on_the_cpu():
    from apex_tpu_torch.benchmarks import optimizer_step as bench

    params = bench.gpt2_like_params(hidden=16, layers=2, vocab=64, seq=8,
                                    device="cpu")
    assert len(params) == 4 + 12 * 2
    out = bench.measure(params, fused_steps=2, eager_steps=1, windows=2)
    assert out["leaves"] == 28 and out["adam_speedup"] > 0
    assert out["lamb_speedup"] > 0
    rec = bench.run("cpu", gpt2=dict(hidden=16, layers=1, vocab=32, seq=8),
                    bert=False, windows=1)
    assert rec["platform"] == "cpu" and "gpt2_124m" in rec["trees"]
    # the eager loop is Adam: one step equals FusedAdam's
    ps = [p.clone() for p in params]
    gs = [torch.randn_like(p) for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    bench.eager_adam_step(ps, m, v, gs, 1)
    fa = FusedAdam(lr=1e-3, eps=1e-8)
    qs = [p.clone() for p in params]
    fa.update_(qs, gs, fa.init(qs))
    for a, b in zip(ps, qs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
