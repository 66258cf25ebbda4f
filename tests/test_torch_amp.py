"""apex_tpu_torch amp (policies, loss scaler, the O2 mixed-precision
optimizer with FusedAdam, the multi-tensor ops) against apex_tpu's on the
CPU, from the same numpy inputs.

- the scaler's (scale, clean-step count) trajectory over a seeded overflow
  sequence equals JAX's exactly (powers of two);
- the O0-O3 policy fields equal JAX's;
- ``cast_params`` keeps the norm parameters (``ln1``/``ln2``/``ln_f``) fp32
  and casts the rest to bf16 under O2;
- ``MixedPrecisionOptimizer(FusedAdam)`` under O2 over 5 fixed grad trees,
  one holding an inf: masters and moments equal JAX's within 1e-6 (fp32
  arithmetic in another order), the skipped step leaves them bit-identical
  and halves the scale, and the model params equal the masters cast down.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch import nn

from apex_tpu import amp as jamp
from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.ops import multi_tensor as jmt
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import amp as tamp
from apex_tpu_torch.ops import multi_tensor as tmt
from apex_tpu_torch.optimizers import FusedAdam


def test_scaler_trajectory_matches_jax():
    rng = np.random.default_rng(0)
    flags = rng.random(60) < 0.2
    flags[:3] = True  # drive the floor
    kw = dict(init_scale=2.0 ** 4, scale_window=3, min_loss_scale=2.0,
              max_loss_scale=2.0 ** 6)
    js = JaxLossScaler.create(**kw)
    ts = tamp.LossScaler.create(**kw)
    seen = set()
    for f in flags:
        js = js.update(jnp.asarray(bool(f)))
        ts.update(bool(f))
        assert ts.loss_scale == float(js.loss_scale)
        assert ts.unskipped == int(js.unskipped)
        seen.add(ts.loss_scale)
    assert {2.0, 2.0 ** 6} <= seen  # the sequence reaches both caps
    state = ts.state_dict()
    again = tamp.LossScaler.create(**kw).load_state_dict(state)
    assert again.state_dict() == state
    static = tamp.LossScaler.create(loss_scale=128.0)
    assert static.update(True).loss_scale == 128.0


def test_scaler_scale_and_unscale():
    ts = tamp.LossScaler.create()
    assert float(ts.scale(torch.tensor(1.5, dtype=torch.bfloat16))) == \
        1.5 * 65536
    grads = [torch.tensor([65536.0, 2.0 ** 17]), torch.tensor([1.0])]
    out, found = ts.unscale(grads)
    assert not bool(found) and out[0].tolist() == [1.0, 2.0]
    _, found = ts.unscale([torch.tensor([float("inf")])])
    assert bool(found)


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_policy_fields_match_jax(level):
    jp, tp = jamp.get_policy(level), tamp.get_policy(level)
    name = (lambda d: None if d is None else str(jnp.dtype(d)))
    tname = (lambda d: None if d is None else str(d).replace("torch.", ""))
    assert tname(tp.cast_model_type) == name(jp.cast_model_type)
    assert tname(tp.compute_dtype) == name(jp.compute_dtype)
    assert tname(tp.param_dtype) == name(jp.param_dtype)
    for f in ("opt_level", "keep_batchnorm_fp32", "master_weights",
              "loss_scale", "dynamic_loss_scale"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tamp.get_policy(tp) is tp
    with pytest.raises(ValueError):
        tamp.get_policy("O4")
    # overrides as the reference takes them
    over = tamp.get_policy(level, keep_batchnorm_fp32=False)
    assert over.keep_batchnorm_fp32 is False \
        == jamp.get_policy(level, keep_batchnorm_fp32=False).keep_batchnorm_fp32


def test_cast_params_keeps_norms_fp32():
    from apex_tpu_torch.models import GPTConfig, GPTModel

    m = GPTModel(GPTConfig(vocab_size=61, hidden_size=32, num_layers=2,
                           num_attention_heads=4, max_seq_len=64),
                 device="cpu")
    tamp.cast_params(m, tamp.get_policy("O2"))
    for name, p in m.named_parameters():
        norm = any(t in name for t in (".ln1.", ".ln2.", "ln_f."))
        assert p.dtype == (torch.float32 if norm else torch.bfloat16), name
    masters = tamp.upcast_params(m)
    assert all(t.dtype == torch.float32 for t in masters)
    tamp.cast_params(m, tamp.get_policy("O0"))  # no cast model: untouched
    assert m.embedding.embedding.dtype == torch.bfloat16


class _Toy(nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.dense = nn.Module()
        self.dense.kernel = nn.Parameter(torch.from_numpy(
            tree["dense"]["kernel"]))
        self.dense.bias = nn.Parameter(torch.from_numpy(
            tree["dense"]["bias"]))
        self.ln = nn.Module()
        self.ln.scale = nn.Parameter(torch.from_numpy(tree["ln"]["scale"]))


_NAMES = (("dense", "kernel"), ("dense", "bias"), ("ln", "scale"))


def _flat(tree):
    return [np.asarray(tree[a][b], np.float32) for a, b in _NAMES]


def test_o2_fused_adam_matches_jax_with_a_skipped_step():
    rng = np.random.default_rng(1)
    tree = {"dense": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                      "bias": rng.normal(size=(3,)).astype(np.float32)},
            "ln": {"scale": (1 + 0.1 * rng.normal(size=(3,))).astype(
                np.float32)}}
    grads = []
    for i in range(5):
        g = {a: {b: (1000.0 * rng.normal(size=tree[a][b].shape)).astype(
            np.float32) for b in tree[a]} for a in tree}
        if i == 2:
            g["dense"]["bias"][1] = np.inf
        grads.append(g)
    kw = dict(lr=1e-2, weight_decay=0.01)
    jpol = jamp.get_policy("O2")
    jparams = jamp.cast_params(jax.tree.map(jnp.asarray, tree), jpol)
    jmp = jamp.MixedPrecisionOptimizer(JaxFusedAdam(**kw), jpol)
    jstate = jmp.init(jparams)

    tpol = tamp.get_policy("O2")
    model = tamp.cast_params(_Toy(tree), tpol)
    params = [getattr(getattr(model, a), b) for a, b in _NAMES]
    assert [p.dtype for p in params] == [torch.bfloat16, torch.bfloat16,
                                         torch.float32]
    tmp = tamp.MixedPrecisionOptimizer(FusedAdam(**kw), tpol,
                                       log_grad_norm=True)
    tstate = tmp.init(params)
    for i, g in enumerate(grads):
        # the scaled grads in each param's dtype, identical on both sides
        jg = jax.tree.map(lambda a, p: jnp.asarray(a).astype(p.dtype),
                          g, jparams)
        jparams, jstate, jm = jmp.apply_gradients(jstate, jparams, jg)
        before = [t.clone() for t in tstate.master] + [
            t.clone() for t in tstate.inner.exp_avg + tstate.inner.exp_avg_sq]
        tg = [torch.from_numpy(np.array(jg[a][b].astype(jnp.float32))).to(
            p.dtype) for (a, b), p in zip(_NAMES, params)]
        tm = tmp.apply_gradients(tstate, params, tg)
        assert tm["found_inf"] == bool(jm["found_inf"]) == (i == 2)
        assert tm["loss_scale"] == float(jm["loss_scale"])
        if i == 2:
            after = list(tstate.master) + list(
                tstate.inner.exp_avg + tstate.inner.exp_avg_sq)
            assert all(torch.equal(a, b) for a, b in zip(before, after))
            assert tm["loss_scale"] == 2.0 ** 15
        else:
            assert torch.isfinite(tm["grad_norm"])
        for got, ref in ((tstate.master, _flat(jstate.master)),
                         (tstate.inner.exp_avg,
                          _flat(jstate.inner.exp_avg)),
                         (tstate.inner.exp_avg_sq,
                          _flat(jstate.inner.exp_avg_sq))):
            for a, r in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), r, rtol=1e-6,
                                           atol=1e-6)
        for p, m in zip(params, tstate.master):
            assert torch.equal(p.detach(), m.to(p.dtype))
    assert tstate.inner.step == int(jstate.inner.step) == 4


def test_zero_options_raise():
    """ZeRO constructs now; the two-tier dcn axis raises naming item 16,
    and the reference's argument checks raise ValueError."""
    pol = tamp.get_policy("O2")
    z = tamp.MixedPrecisionOptimizer(FusedAdam(), pol, zero_axis="data",
                                     gather_dtype="bf16",
                                     reduce_dtype="int8",
                                     stochastic_rounding=True)
    assert (z.zero_axis, z.gather_dtype, z.reduce_dtype) == (
        "data", torch.bfloat16, "int8")
    with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
        tamp.MixedPrecisionOptimizer(FusedAdam(), pol, zero_axis="data",
                                     dcn_axis="dcn")
    for kw in (dict(gather_dtype="bf16"), dict(reduce_dtype="int8"),
               dict(stochastic_rounding=True)):
        with pytest.raises(ValueError):
            tamp.MixedPrecisionOptimizer(FusedAdam(), pol, **kw)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(amsgrad=True)


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_o0_matches_jax(adam_w_mode):
    rng = np.random.default_rng(2)
    ps = [rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=(3,)).astype(np.float32)]
    gs = [[rng.normal(size=p.shape).astype(np.float32) for p in ps]
          for _ in range(3)]
    kw = dict(lr=1e-2, weight_decay=0.05, adam_w_mode=adam_w_mode)
    jopt = JaxFusedAdam(**kw)
    jp = [jnp.asarray(p) for p in ps]
    js = jopt.init(jp)
    topt = FusedAdam(**kw)
    tp = [torch.from_numpy(p.copy()) for p in ps]
    ts = topt.init(tp)
    for g in gs:
        upd, js = jopt.update([jnp.asarray(a) for a in g], js, jp)
        jp = [a + u for a, u in zip(jp, upd)]
        ts = topt.update_(tp, [torch.from_numpy(a) for a in g], ts)
        for a, r in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-6)


def test_multi_tensor_ops_match_jax():
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(4, 3)).astype(np.float32),
          rng.normal(size=(7,)).astype(np.float32)]
    ys = [rng.normal(size=a.shape).astype(np.float32) for a in xs]
    tx = [torch.from_numpy(a) for a in xs]
    ty = [torch.from_numpy(a) for a in ys]
    jx = [jnp.asarray(a) for a in xs]
    jy = [jnp.asarray(a) for a in ys]
    np.testing.assert_allclose(float(tmt.tree_l2norm(tx)),
                               float(jmt.tree_l2norm(jx)), rtol=1e-6)
    out, f = tmt.tree_axpby(0.5, tx, -2.0, ty)
    jout, jf = jmt.tree_axpby(0.5, jx, -2.0, jy)
    assert bool(f) == bool(jf) is False
    for a, r in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-6)
    clipped, gn = tmt.tree_clip_by_global_norm(tx, 1.0)
    jclipped, jgn = jmt.tree_clip_by_global_norm(jx, 1.0)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    for a, r in zip(clipped, jclipped):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-6)
    bad = [torch.tensor([1.0, float("nan")])]
    assert bool(tmt.tree_nonfinite(bad)) and bool(jmt.tree_nonfinite(
        [jnp.asarray([1.0, np.nan])]))
    assert not bool(tmt.tree_nonfinite([torch.tensor([3e38, -3e38])]))
