"""The legacy ``fp16_utils`` API of the port against the JAX package on the
CPU.

The 7 cases of ``tests/test_fp16_utils.py`` are mirrored (norms kept fp32,
the prep/copy helpers, the legacy scalers, a step with an overflow skip,
the static scale that never skips, the master-grad clip, the state_dict
round trip), on trees of tensors and on modules. ``FP16_Optimizer``
around ``FusedAdam`` then steps beside the JAX ``FP16_Optimizer`` on the
same params and grads, a skipped overflow step among them: masters and
moments within 1e-6 of each leaf's max |value|, the fp32 params within
1e-6 relative and the bf16 ones equal (fp32 arithmetic in another order;
the port's bias corrections are float64 rounded once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from apex_tpu import fp16_utils as jfp
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.fp16_utils import (
    FP16_Optimizer,
    DynamicLossScaler,
    LossScaler,
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    prep_param_lists,
    tofp16,
)
from apex_tpu_torch.optimizers import FusedAdam


def _params():
    gen = torch.Generator().manual_seed(0)
    return {
        "dense": {"kernel": torch.randn(8, 8, generator=gen).to(
            torch.bfloat16), "bias": torch.zeros(8, dtype=torch.bfloat16)},
        "bn": {"scale": torch.ones(8)},
        "step": torch.zeros((), dtype=torch.int32),  # survives untouched
    }


def test_convert_network_keeps_norms_fp32():
    p = convert_network({"dense": {"kernel": torch.zeros(2, 2)},
                         "bn": {"scale": torch.ones(2)}})
    assert p["dense"]["kernel"].dtype == torch.bfloat16
    assert p["bn"]["scale"].dtype == torch.float32
    # a module, in place, by the qualified names
    net = nn.Sequential(nn.Linear(4, 4), nn.LayerNorm(4))
    net.add_module("bn1", nn.BatchNorm1d(4))
    assert convert_network(net) is net
    dtypes = {n: p.dtype for n, p in net.named_parameters()}
    assert dtypes["0.weight"] == dtypes["0.bias"] == torch.bfloat16
    assert dtypes["bn1.weight"] == torch.float32
    # nn.Sequential names the LayerNorm "1": the name rule cannot see it,
    # as the reference's path rule cannot
    assert dtypes["1.weight"] == torch.bfloat16
    assert convert_network({"ln_f": {"scale": torch.ones(2)}},
                           keep_norms_fp32=False)["ln_f"]["scale"].dtype \
        == torch.bfloat16
    half = tofp16({"w": torch.ones(2), "i": torch.zeros(2,
                                                        dtype=torch.int64)})
    assert half["w"].dtype == torch.float16 and half["i"].dtype == \
        torch.int64
    assert all(p.dtype == torch.float16
               for p in tofp16(nn.Linear(2, 2)).parameters())


def test_prep_and_copy_helpers_roundtrip():
    model = _params()
    model2, master = prep_param_lists(model)
    assert model2 is model
    assert master["dense"]["kernel"].dtype == torch.float32
    assert master["step"].dtype == torch.int32
    g = {k: {kk: torch.ones_like(vv) for kk, vv in v.items()}
         if isinstance(v, dict) else v for k, v in model.items()}
    g32 = model_grads_to_master_grads(g)
    assert g32["dense"]["bias"].dtype == torch.float32
    kernel = model["dense"]["kernel"].clone()
    master["dense"]["kernel"] += 1.0
    back = master_params_to_model_params(master, model)
    assert back["dense"]["kernel"].dtype == torch.bfloat16
    torch.testing.assert_close(back["dense"]["kernel"].float(),
                               (kernel.float() + 1.0).to(torch.bfloat16)
                               .float())
    # a module's parameters: a list and its fp32 masters
    net = nn.Linear(3, 2).to(torch.bfloat16)
    params, masters = prep_param_lists(net)
    assert [m.dtype for m in masters] == [torch.float32, torch.float32]
    assert all(torch.equal(p.float(), m) for p, m in zip(params, masters))


def test_legacy_scalers():
    s = LossScaler(128.0)
    assert s.loss_scale == 128.0 and not s.dynamic
    d = DynamicLossScaler(init_scale=2.0 ** 8, scale_window=1)
    assert d.dynamic
    d2 = d.update(True)  # overflow halves, a clean window doubles
    assert d2.loss_scale == 2.0 ** 7
    d3 = d2.update(False)
    assert d3.loss_scale == 2.0 ** 8
    big = DynamicLossScaler()
    assert big.loss_scale == 2.0 ** 32 and big.scale_window == 1000
    big.scale_window = 1
    assert big.update(False).loss_scale == 2.0 ** 33  # no growth cap


def _w_model():
    return [torch.ones(4, dtype=torch.bfloat16, requires_grad=True)]


def test_fp16_optimizer_step_and_overflow_skip():
    model = _w_model()
    opt = FP16_Optimizer(FusedAdam(lr=0.1), dynamic_loss_scale=True)
    state = opt.init(model)
    assert state.master[0].dtype == torch.float32
    loss = torch.sum(torch.square(model[0].float()))
    opt.scale_loss(loss, state).backward()
    info = opt.step(state, model, [model[0].grad], max_norm=10.0)
    assert not info["overflow"]
    p1 = model[0].detach().clone()
    assert float((p1.float() - 1.0).abs().max()) > 0
    assert p1.dtype == torch.bfloat16
    # inf grads: the step is skipped and the scale halves
    scale1 = state.scaler.loss_scale
    master1 = state.master[0].clone()
    info2 = opt.step(state, model, [torch.full((4,), float("inf"),
                                               dtype=torch.bfloat16)])
    assert info2["overflow"]
    assert torch.equal(model[0].detach(), p1)
    assert torch.equal(state.master[0], master1)
    assert state.scaler.loss_scale == scale1 / 2


def test_fp16_optimizer_static_scale_never_skips():
    """The legacy static scaler has no overflow machinery: the step
    proceeds and the non-finites reach the params (loss_scaler.py:10-45)."""
    model = _w_model()
    opt = FP16_Optimizer(FusedAdam(lr=0.1), static_loss_scale=128.0)
    state = opt.init(model)
    info = opt.step(state, model, [torch.full((4,), float("inf"),
                                              dtype=torch.bfloat16)])
    assert info["overflow"]  # reported...
    assert state.scaler.loss_scale == 128.0  # ...but the scale stays
    assert not bool((model[0].detach().float() == 1.0).all())


def test_fp16_optimizer_clip_master_grads():
    opt = FP16_Optimizer(FusedAdam(lr=0.1))
    g = [torch.full((3,), 4.0), torch.full((4,), 2.0)]
    clipped, norm = opt.clip_master_grads(g, max_norm=1.0)
    assert float(norm) == pytest.approx(np.sqrt(48 + 16), rel=1e-6)
    total = torch.sqrt(sum(torch.sum(c * c) for c in clipped))
    assert float(total) == pytest.approx(1.0, rel=1e-4)


def test_fp16_optimizer_state_dict_roundtrip():
    model = _w_model()
    opt = FP16_Optimizer(FusedAdam(lr=0.1), dynamic_loss_scale=True)
    state = opt.init(model)
    g = [torch.full((4,), 0.5, dtype=torch.bfloat16) * 2.0 ** 16]
    state.scaler.loss_scale = 2.0 ** 16
    opt.step(state, model, g)
    payload = opt.state_dict(state)
    fresh = opt.init(_w_model())
    restored = opt.load_state_dict(fresh, payload)
    assert restored is fresh
    assert torch.equal(restored.master[0], state.master[0])
    assert restored.inner.step == state.inner.step == 1
    assert torch.equal(restored.inner.exp_avg[0], state.inner.exp_avg[0])
    assert restored.scaler.loss_scale == state.scaler.loss_scale


def test_entry_is_the_port_package():
    """The legacy names resolve to the port's amp scaler: one state
    machine for both APIs."""
    from apex_tpu_torch.amp.scaler import LossScaler as AmpScaler

    assert isinstance(LossScaler(), AmpScaler)
    assert isinstance(DynamicLossScaler(), AmpScaler)


@pytest.mark.parametrize("dynamic,max_norm", [(True, None), (True, 0.5),
                                              (False, None)])
def test_fp16_optimizer_matches_jax(dynamic, max_norm):
    """4 steps of ``FP16_Optimizer(FusedAdam)`` beside the JAX one on the
    same bf16 params (an fp32 norm leaf among them) and scaled grads; the
    third step's grads hold an inf (skipped under the dynamic scale; under
    the static one it reaches both sides' masters alike, so that case
    stops before it)."""
    rng = np.random.default_rng(3)
    tree = {"dense": {"kernel": rng.normal(size=(5, 4)).astype(np.float32),
                      "bias": rng.normal(size=(4,)).astype(np.float32)},
            "ln": {"scale": (1 + 0.1 * rng.normal(size=(4,))).astype(
                np.float32)}}
    jparams = jfp.convert_network(jax.tree.map(jnp.asarray, tree))
    tparams = convert_network({a: {b: torch.from_numpy(v) for b, v in
                                   sub.items()} for a, sub in tree.items()})
    names = [("dense", "bias"), ("dense", "kernel"), ("ln", "scale")]
    tlist = [tparams[a][b] for a, b in names]
    assert [t.dtype for t in tlist] == [torch.bfloat16, torch.bfloat16,
                                        torch.float32]
    kw = dict(dynamic_loss_scale=True,
              dynamic_loss_args={"init_scale": 2.0 ** 10}) if dynamic \
        else dict(static_loss_scale=64.0)
    jopt = jfp.FP16_Optimizer(JaxFusedAdam(lr=1e-2, weight_decay=0.01), **kw)
    topt = FP16_Optimizer(FusedAdam(lr=1e-2, weight_decay=0.01), **kw)
    js, ts = jopt.init(jparams), topt.init(tlist)
    steps = 4 if dynamic else 2
    for i in range(steps):
        scale = ts.scaler.loss_scale
        assert scale == float(js.scaler.loss_scale)
        g = {a: {b: (scale * rng.normal(size=v.shape)).astype(np.float32)
                 for b, v in sub.items()} for a, sub in tree.items()}
        if i == 2:
            g["dense"]["kernel"][1, 1] = np.inf
        jg = jax.tree.map(lambda x, p: jnp.asarray(x).astype(p.dtype), g,
                          jparams)
        jparams, js, jinfo = jopt.step(js, jparams, jg, max_norm=max_norm)
        tg = [torch.from_numpy(np.array(jg[a][b].astype(jnp.float32))).to(
            t.dtype) for (a, b), t in zip(names, tlist)]
        tinfo = topt.step(ts, tlist, tg, max_norm=max_norm)
        assert tinfo["overflow"] == bool(jinfo["overflow"]) == (i == 2)
        assert tinfo["loss_scale"] == float(jinfo["loss_scale"])
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-6)
        for got, ref in ((ts.master, js.master),
                         (ts.inner.exp_avg, js.inner.exp_avg),
                         (ts.inner.exp_avg_sq, js.inner.exp_avg_sq)):
            for t, (a, b) in zip(got, names):
                r = np.asarray(ref[a][b], np.float32)
                err = np.abs(t.numpy() - r).max()
                assert err <= 1e-6 * np.abs(r).max(), (a, b, err)
        for t, (a, b) in zip(tlist, names):  # bf16 copies equal
            np.testing.assert_allclose(
                t.float().numpy(), np.asarray(jparams[a][b], np.float32),
                rtol=1e-6 if t.dtype == torch.float32 else 0, atol=0)
    assert ts.inner.step == int(js.inner.step)
