"""The rest of the port's optimizers against the JAX package on the CPU:
FusedAdagrad, FusedNovoGrad, LARC and the sync-free FusedMixedPrecisionLamb.

The cases of ``tests/test_optimizers.py:112-250`` are mirrored (novograd
differs from adam, adagrad against its manual step, LARC's clip, base lr and
live lr, mp-LAMB against ``MixedPrecisionOptimizer(FusedLAMB)`` and its
overflow skip). Each optimizer also steps 4 times beside its JAX
counterpart on the same params and grads (numpy, from a seed), with ``lr=``
overrides: params and state within 1e-6 relative (fp32 arithmetic in
another order), NovoGrad's moments within 1e-4 (the port's bias
corrections are float64 rounded once, the JAX ones fp32, and ``1 - 0.999``
in fp32 is off by 1.3e-5), mp-LAMB's masters and moments within 1e-5.
mp-LAMB's step reads nothing back to the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu import optimizers as jopt
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import optimizers as topt
from apex_tpu_torch.optimizers._common import lamb_leaf_update

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"a": (6, 5), "b": (5,), "c": (3, 4, 2)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _list(tree):
    """The port's list in the order of ``jax.tree.leaves``."""
    return [torch.from_numpy(np.array(tree[k])) for k in sorted(tree)]


def _close(got, ref, rtol=RTOL, atol=ATOL):
    ref = [np.asarray(r, np.float32) for r in jax.tree.leaves(ref)]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().float().numpy(), r, rtol=rtol,
                                   atol=atol)


def _step_both(jtx, topt_, steps=4, lrs=(None, 0.5e-2, None, 2e-2),
               grad_scale=0.1):
    """``steps`` steps of the JAX transform and the port's optimizer on the
    same params and grads, ``lrs[i]`` the step's lr override; returns both
    params and states."""
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = _list(_tree(0))
    js, ts = jtx.init(jp), topt_.init(tp)
    for i in range(steps):
        g = _tree(10 + i, grad_scale)
        extra = {} if lrs[i] is None else {"lr_t": jnp.float32(lrs[i])}
        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp, **extra)
        jp = optax.apply_updates(jp, upd)
        ts = topt_.update_(tp, _list(g), ts, lr=lrs[i])
    return jp, js, tp, ts


# -- the mirrored cases (tests/test_optimizers.py:112-250) ------------------

def _run(opt, params, steps=5):
    state = opt.init(params)
    for i in range(steps):
        state = opt.update_(params, _list(_tree(20 + i, 0.1)), state)
    return params


def test_fused_novograd_runs_and_differs_from_adam():
    p1 = _run(topt.FusedNovoGrad(lr=1e-2), _list(_tree(0)))
    p2 = _run(topt.FusedAdam(lr=1e-2), _list(_tree(0)))
    assert all(torch.isfinite(p).all() for p in p1)
    assert not torch.allclose(p1[0], p2[0])


def test_fused_adagrad_matches_manual():
    lr, eps = 0.1, 1e-10
    p = [torch.tensor([1.0, 2.0])]
    opt = topt.FusedAdagrad(lr=lr, eps=eps)
    state = opt.init(p)
    state = opt.update_(p, [torch.tensor([0.5, -0.5])], state)
    expected = np.array([1.0, 2.0]) - lr * np.array([0.5, -0.5]) / (
        np.sqrt(0.25) + eps)
    np.testing.assert_allclose(p[0].numpy(), expected, rtol=1e-6)
    assert state.step == 1


def test_larc_clips_adaptive_lr():
    opt = topt.larc(topt.FusedSGD(lr=0.1), trust_coefficient=0.02, clip=True,
                    base_lr=0.1)
    p = _run(opt, _list(_tree(0)))
    assert all(torch.isfinite(x).all() for x in p)


def test_larc_clip_requires_base_lr():
    with pytest.raises(ValueError, match="base_lr"):
        topt.larc(topt.FusedSGD(lr=0.1), clip=True)
    wrapped = topt.LARC(topt.FusedSGD(lr=0.1))  # the lr of the optimizer
    assert wrapped.lr == 0.1
    p = [torch.ones(4)]
    s = wrapped.init(p)
    wrapped.update_(p, [torch.full((4,), 0.01)], s)
    assert torch.isfinite(p[0]).all() and not torch.equal(p[0],
                                                          torch.ones(4))

    class NoLr:
        def init(self, params):
            return None

    with pytest.raises(ValueError, match="base_lr"):
        topt.LARC(NoLr())
    assert topt.LARC(NoLr(), clip=False).lr is None


def test_larc_clip_tracks_lr():
    """A runtime ``lr=`` drives the clip denominator: tiny grads make the
    adaptive rate huge, it clips to 1 at either lr, and the inner step gets
    the same grads and the lr applied (so its update scales with it)."""

    class Recorder(topt.FusedSGD):
        seen = []

        def update_(self, params, grads, state, lr=None):
            self.seen.append(([g.clone() for g in grads],
                              self.lr if lr is None else lr))
            return super().update_(params, grads, state, lr=lr)

    g = [torch.full((4,), 1e-6)]
    wrapped = topt.LARC(Recorder(lr=1.0))
    for lr in (None, 0.5):
        p = [torch.full((4,), 10.0)]
        wrapped.update_(p, g, wrapped.init(p), lr=lr)
    (g_base, lr_base), (g_small, lr_small) = Recorder.seen
    assert torch.equal(g_base[0], g[0]) and torch.equal(g_small[0], g[0])
    assert (lr_base, lr_small) == (1.0, 0.5)
    # at clip 1 the rate no longer depends on lr: without the clip it
    # would, and with lr=1e-9 the adaptive rate / lr stays clipped too
    out = wrapped.rescale([torch.full((4,), 10.0)], g, lr=1e-9)
    assert torch.equal(out[0], g[0])
    big = [torch.full((4,), 1.0)]
    small = wrapped.rescale([torch.full((4,), 1e-3)], big, lr=1.0)
    torch.testing.assert_close(small[0], big[0] * 0.02 * 1e-3, rtol=1e-5,
                               atol=0)
    assert topt.LARC(topt.LARC(topt.FusedSGD(lr=0.3))).lr == 0.3


def _bf16_pair(tree):
    """The model copies of ``tree`` in bf16 (port list, JAX tree)."""
    tp = [t.to(torch.bfloat16) for t in _list(tree)]
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    return tp, jp


def test_fused_mixed_precision_lamb_matches_fused_lamb_with_masters():
    """Masters inside the optimizer from scaled grads equal FusedLAMB under
    ``MixedPrecisionOptimizer``'s O2 masters: masters within 1e-5, bf16
    model copies equal (here: bit for bit, the same math in the same
    order)."""
    lr, wd, scale = 1e-2, 0.01, 1024.0
    model, _ = _bf16_pair(_tree(0))
    twin = [p.clone() for p in model]
    mp = topt.FusedMixedPrecisionLamb(lr=lr, weight_decay=wd,
                                      reduced_precision_dtype=torch.bfloat16)
    st = mp.init(twin)
    ref = tamp.MixedPrecisionOptimizer(topt.FusedLAMB(lr=lr, weight_decay=wd),
                                       tamp.get_policy("O2", loss_scale=scale))
    ref_st = ref.init(model)
    for i in range(4):
        scaled = [(g * scale).to(torch.bfloat16)
                  for g in _list(_tree(30 + i, 0.1))]
        st = mp.step(st, twin, [g.clone() for g in scaled], scale=scale)
        ref.apply_gradients(ref_st, model, scaled)
    assert int(st.step) == 4
    for a, b in zip(st.master, ref_st.master):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(a, b)
    for a, b in zip(twin, model):
        assert torch.equal(a, b)


def test_fused_mixed_precision_lamb_skips_on_overflow():
    mp = topt.FusedMixedPrecisionLamb(lr=1e-2,
                                      reduced_precision_dtype=torch.bfloat16)
    model, _ = _bf16_pair(_tree(0))
    st = mp.init(model)
    before = [t.clone() for t in [*model, *st.master, *st.exp_avg,
                                  *st.exp_avg_sq]]
    bad = _list(_tree(40, 0.1))
    bad[0][0, 0] = float("inf")
    st = mp.step(st, model, bad, scale=2.0)
    assert int(st.step) == 0  # the step does not advance on overflow
    after = [*model, *st.master, *st.exp_avg, *st.exp_avg_sq]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    # a NaN as well, with found_inf given as a device tensor
    bad[1][2] = float("nan")
    st = mp.step(st, model, bad, found_inf=torch.tensor(True))
    assert int(st.step) == 0
    assert all(torch.equal(a, b) for a, b in zip(
        before, [*model, *st.master, *st.exp_avg, *st.exp_avg_sq]))


# -- each optimizer against its JAX counterpart, 4 steps --------------------

@pytest.mark.parametrize("wd,w_mode", [(0.0, False), (0.05, False),
                                        (0.05, True)])
def test_fused_adagrad_matches_jax(wd, w_mode):
    jp, js, tp, ts = _step_both(
        jopt.fused_adagrad(lr=1e-2, weight_decay=wd, adagrad_w_mode=w_mode),
        topt.FusedAdagrad(lr=1e-2, weight_decay=wd, adagrad_w_mode=w_mode))
    _close(tp, jp)
    _close(ts.sum_sq, js.sum_sq)
    assert ts.step == int(js.step) == 4


@pytest.mark.parametrize("kw", [
    {},
    {"init_zero": True},
    {"weight_decay": 0.05, "reg_inside_moment": True},
    {"weight_decay": 0.05, "reg_inside_moment": False,
     "grad_averaging": False},
    {"bias_correction": False, "betas": (0.95, 0.98)},
])
def test_fused_novograd_matches_jax(kw):
    jp, js, tp, ts = _step_both(jopt.fused_novograd(lr=1e-2, **kw),
                                topt.FusedNovoGrad(lr=1e-2, **kw))
    _close(tp, jp)
    # the moments within 1e-4: the JAX bias correction is fp32, and 1 -
    # 0.999 ** 1 there is off by 1.3e-5 of the port's float64 one
    _close(ts.exp_avg, js.exp_avg, rtol=1e-4)
    _close(ts.exp_avg_sq, js.exp_avg_sq, rtol=1e-4)
    assert all(v.shape == () for v in ts.exp_avg_sq)  # a scalar per tensor
    assert ts.step == int(js.step) == 4


def test_fused_novograd_first_step_takes_the_grad_norm():
    """``v = ||g||^2`` on the first step unless ``init_zero``
    (``fused_novograd.py:65-68``)."""
    g = [torch.tensor([3.0, 4.0])]
    for init_zero, v in ((False, 25.0), (True, 25.0 * 0.001)):
        opt = topt.FusedNovoGrad(lr=1e-3, init_zero=init_zero)
        st = opt.update_([torch.ones(2)], g, opt.init([torch.ones(2)]))
        assert float(st.exp_avg_sq[0]) == pytest.approx(v, rel=1e-6)


@pytest.mark.parametrize("clip,wd", [(True, 0.0), (True, 0.01),
                                     (False, 0.01)])
def test_larc_matches_jax(clip, wd):
    kw = dict(trust_coefficient=0.02, clip=clip, weight_decay=wd)
    jinner = jopt.FusedSGD(lr=0.1, momentum=0.9)
    jp, js, tp, ts = _step_both(
        jopt.LARC(jinner, **kw).transform,
        topt.LARC(topt.FusedSGD(lr=0.1, momentum=0.9), **kw),
        lrs=(None, 0.05, None, 0.2))
    _close(tp, jp)
    _close(ts.momentum_buf, js.momentum_buf)


def test_larc_leaves_zero_norm_grads_untouched():
    """A param of norm 0 or a grad of norm 0 keeps its grad (LARC.py:92)."""
    opt = topt.LARC(topt.FusedSGD(lr=1.0), clip=False)
    params = [torch.zeros(3), torch.ones(3), torch.ones(2)]
    grads = [torch.full((3,), 0.5), torch.zeros(3), torch.full((2,), 0.5)]
    out = opt.rescale(params, grads)
    assert torch.equal(out[0], grads[0]) and torch.equal(out[1], grads[1])
    assert not torch.equal(out[2], grads[2])


@pytest.mark.parametrize("nvlamb,max_norm", [(False, 1.0), (True, 0.0)])
def test_fused_mixed_precision_lamb_matches_jax(nvlamb, max_norm):
    """4 steps beside the JAX optimizer: scaled bf16 grads, an fp32 leaf
    stepped in place (its own master), ``lr`` and ``scale`` as tensors, the
    third step an overflow (skipped on both sides)."""
    kw = dict(lr=1e-2, weight_decay=0.01, use_nvlamb=nvlamb,
              max_grad_norm=max_norm)
    tree = _tree(0)
    tp, jp = _bf16_pair(tree)
    tp[1] = _list(tree)[1]  # "b" stays fp32
    jp["b"] = jnp.asarray(tree["b"])
    jm = jopt.FusedMixedPrecisionLamb(reduced_precision_dtype=jnp.bfloat16,
                                      **kw)
    tm = topt.FusedMixedPrecisionLamb(reduced_precision_dtype=torch.bfloat16,
                                      **kw)
    js, ts = jm.init(jp), tm.init(tp)
    assert ts.master[1] is tp[1]
    scale = 256.0
    for i in range(4):
        g = {k: v * scale for k, v in _tree(50 + i, 0.1).items()}
        if i == 2:
            g["c"][0, 0, 0] = np.inf
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
        lr = 1e-2 if i != 3 else 5e-3
        jp, js = jm.step(js, jp, jg, lr_t=lr, scale=scale)
        ts = tm.step(ts, tp, [torch.from_numpy(np.array(
            jg[k].astype(jnp.float32))).to(p.dtype)
            for k, p in zip(sorted(jg), tp)],
            lr=torch.tensor(lr), scale=torch.tensor(scale))
    assert int(ts.step) == int(js.step) == 3
    _close(ts.master, js.master, rtol=1e-5, atol=1e-6)
    _close(ts.exp_avg, js.exp_avg, rtol=1e-5, atol=1e-7)
    _close(ts.exp_avg_sq, js.exp_avg_sq, rtol=1e-5, atol=1e-9)
    for a, b in zip(tp, jax.tree.leaves(jp)):
        assert a.dtype == {jnp.bfloat16: torch.bfloat16,
                           jnp.float32: torch.float32}[b.dtype.type]


def test_fused_mixed_precision_lamb_step_reads_nothing_back(monkeypatch):
    """No Python read of a tensor's value inside the step: with ``lr`` and
    ``scale`` as tensors and ``found_inf`` computed inside, ``item``,
    ``__bool__``, ``__float__``, ``__int__``, ``__index__``, ``tolist``
    and ``numpy`` all raise if called (on the card each would be a host
    sync; ``chip_smoke.py`` runs the step there under
    ``torch.cuda.set_sync_debug_mode("error")``)."""
    tp, _ = _bf16_pair(_tree(0))
    opt = topt.FusedMixedPrecisionLamb(lr=1e-2,
                                       reduced_precision_dtype=torch.bfloat16)
    st = opt.init(tp)
    grads = [(g * 64).to(torch.bfloat16) for g in _list(_tree(60, 0.1))]
    lr, scale = torch.tensor(1e-2), torch.tensor(64.0)

    def read(*a, **k):
        raise AssertionError("a tensor's value was read on the host")

    for name in ("item", "__bool__", "__float__", "__int__", "__index__",
                 "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, read)
    for _ in range(2):
        st = opt.step(st, tp, grads, lr=lr, scale=scale)
    monkeypatch.undo()
    assert int(st.step) == 2


def test_lamb_leaf_update_takes_tensor_bias_corrections():
    """float64 0-d tensors holding a float give that float's bits, so
    FusedLAMB's host floats and mp-LAMB's device step agree (on the card
    ``chip_smoke.py`` phase 12 (b) holds it at BERT-large)."""
    rng = np.random.default_rng(7)
    g = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in SHAPES.values()]
    p = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for s in SHAPES.values()]
    step = 3
    out = []
    for bc in ((1 - 0.9 ** step, 1 - 0.999 ** step),
               (torch.tensor(1 - 0.9 ** step, dtype=torch.float64),
                torch.tensor(1 - 0.999 ** step, dtype=torch.float64))):
        m = [torch.full_like(x, 0.01) for x in g]
        v = [torch.full_like(x, 0.02) for x in g]
        upd = lamb_leaf_update(g, p, m, v, beta1=0.9, beta2=0.999,
                               beta1_grad=0.1, bc1=bc[0], bc2=bc[1],
                               eps=1e-6, weight_decay=0.01,
                               use_nvlamb=False)
        out.append([*upd, *m, *v])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_options_raise_and_names_are_exported():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        topt.FusedMixedPrecisionLamb(amsgrad=True)
    with pytest.raises(RuntimeError, match="adam_w_mode"):
        topt.FusedMixedPrecisionLamb(adam_w_mode=False)
    for name in ("FusedAdagrad", "FusedNovoGrad", "LARC", "larc",
                 "FusedMixedPrecisionLamb", "FusedMixedPrecisionLambState"):
        assert name in topt.__all__ and hasattr(topt, name)
