"""apex_tpu_torch.examples.dcgan against the JAX example's modules
(``examples/dcgan/main_amp.py``: ``Generator``, ``Discriminator``,
``bce_logits``) on the CPU: the same flax params (carried by
``params_from_numpy``: SAME padding, the unflipped transposed-convolution
kernel, the NHWC flatten), the same z and real batches, 3 steps of the D and
G updates under O2 with a scaler each. Both losses and both loss scales
agree every step, and the fp32 masters after 3 steps (every element with
fp32 compute, the kernels with the example's bf16 compute). An overflow in
one scaler skips only its own model's step.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.examples.dcgan import main_amp as dcgan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, NZ = 32, 32


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "jax_dcgan_main_amp", os.path.join(ROOT, "examples", "dcgan",
                                           "main_amp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_run(ref, dtype, batches):
    """The JAX example's ``train_step`` on explicit (z, real, z2)."""
    policy = jamp.get_policy("O2")
    G, D = ref.Generator(dtype=dtype), ref.Discriminator(dtype=dtype)
    gp = jamp.cast_params(G.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, NZ)))["params"], policy)
    dp = jamp.cast_params(D.init(jax.random.PRNGKey(1),
                                 jnp.zeros((1, 16, 16, 1)))["params"], policy)
    init = (jax.tree.map(np.asarray, gp), jax.tree.map(np.asarray, dp))
    opt_g = jamp.MixedPrecisionOptimizer(
        JaxFusedAdam(lr=2e-4, betas=(0.5, 0.999)), policy)
    opt_d = jamp.MixedPrecisionOptimizer(
        JaxFusedAdam(lr=2e-4, betas=(0.5, 0.999)), policy)
    gs, ds = opt_g.init(gp), opt_d.init(dp)

    @jax.jit
    def train_step(gp, dp, gs, ds, z, real, z2):
        def d_loss(dpar):
            fake = G.apply({"params": gp}, z)
            l_real = ref.bce_logits(D.apply({"params": dpar}, real), 1.0)
            l_fake = ref.bce_logits(
                D.apply({"params": dpar}, jax.lax.stop_gradient(fake)), 0.0)
            return opt_d.scale_loss(l_real + l_fake, ds)

        sd, d_grads = jax.value_and_grad(d_loss)(dp)
        dp_new, ds_new, _ = opt_d.apply_gradients(ds, dp, d_grads)

        def g_loss(gpar):
            fake = G.apply({"params": gpar}, z2)
            return opt_g.scale_loss(
                ref.bce_logits(D.apply({"params": dp_new}, fake), 1.0), gs)

        sg, g_grads = jax.value_and_grad(g_loss)(gp)
        gp_new, gs_new, _ = opt_g.apply_gradients(gs, gp, g_grads)
        return (gp_new, dp_new, gs_new, ds_new,
                sd / ds.scaler.loss_scale, sg / gs.scaler.loss_scale)

    hist = []
    for z, real, z2 in batches:
        gp, dp, gs, ds, ld, lg = train_step(gp, dp, gs, ds, z, real, z2)
        hist.append((float(ld), float(lg), float(ds.scaler.loss_scale),
                     float(gs.scaler.loss_scale)))
    return init, hist, gs, ds


def _batches(n=3):
    rng = np.random.default_rng(7)
    return [(rng.standard_normal((B, NZ)).astype(np.float32),
             np.tanh(rng.standard_normal((B, 16, 16, 1))).astype(np.float32),
             rng.standard_normal((B, NZ)).astype(np.float32))
            for _ in range(n)]


def _port_masters(trainer, which):
    state = trainer.gs if which == "G" else trainer.ds
    return {n: m.numpy() for (n, _), m in zip(
        getattr(trainer, which).named_parameters(), state.master)}


def _jax_masters(tree, which):
    """The JAX masters under the port's parameter names and layouts."""
    m = jax.tree.map(np.asarray, tree)
    if which == "G":
        out = {"dense_weight": m["Dense_0"]["kernel"].T,
               "dense_bias": m["Dense_0"]["bias"]}
        for i in (0, 1):
            k = m[f"ConvTranspose_{i}"]["kernel"]
            out[f"deconv{i}_weight"] = k[::-1, ::-1].transpose(2, 3, 0, 1)
            out[f"deconv{i}_bias"] = m[f"ConvTranspose_{i}"]["bias"]
        return out
    out = {"dense_weight": m["Dense_0"]["kernel"].T,
           "dense_bias": m["Dense_0"]["bias"]}
    for i in (0, 1):
        out[f"conv{i}_weight"] = m[f"Conv_{i}"]["kernel"].transpose(3, 2, 0, 1)
        out[f"conv{i}_bias"] = m[f"Conv_{i}"]["bias"]
    return out


@pytest.mark.parametrize("compute, loss_tol", [("float32", 1e-5),
                                                ("bfloat16", 2e-2)])
def test_three_steps_match_the_jax_example(ref, compute, loss_tol):
    """The masters after 3 steps: with fp32 compute every element within 1%
    of one step's lr (2e-4) of the JAX master (the grads of the bf16 params
    are bf16 in both, so a grad one bf16 rounding apart moves Adam's step by
    about 0.4% of lr). With the example's bf16 compute the two packages'
    bf16 convolutions round apart; the kernels stay within 1e-2 of their
    leaf's max, while the zero-initialized biases, whose every value is a
    sum of Adam steps of about lr whose signs those roundings decide where a
    grad is near 0, are held by the losses alone."""
    batches = _batches()
    (g_tree, d_tree), hist, gs, ds = _jax_run(
        ref, getattr(jnp, compute), [tuple(map(jnp.asarray, b))
                                     for b in batches])
    tr = dcgan.build(B, NZ, dtype=getattr(torch, compute), device="cpu")
    tr.load_params_(g_tree, d_tree)
    assert all(p.dtype == torch.bfloat16 for p in tr.G.parameters())
    assert all(p.dtype == torch.bfloat16 for p in tr.D.parameters())
    for (z, real, z2), (ld, lg, sd, sg) in zip(batches, hist):
        out = tr.step(*(torch.from_numpy(a) for a in (z, real, z2)))
        assert not out["d"]["found_inf"] and not out["g"]["found_inf"]
        np.testing.assert_allclose(out["loss_d"], ld, rtol=loss_tol)
        np.testing.assert_allclose(out["loss_g"], lg, rtol=loss_tol)
        assert tr.ds.scaler.loss_scale == sd == 2.0 ** 16
        assert tr.gs.scaler.loss_scale == sg == 2.0 ** 16
    for which, state in (("G", gs), ("D", ds)):
        want = _jax_masters(state.master, which)
        got = _port_masters(tr, which)
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            err = float(np.max(np.abs(got[name] - w)))
            if compute == "float32":
                assert err <= 1e-2 * 2e-4, (which, name, err)
            elif name.endswith("_weight"):
                assert err <= 1e-2 * float(np.max(np.abs(w))), (
                    which, name, err)


def test_params_from_numpy_carries_the_flax_layouts(ref):
    """One forward of each model in fp32 on the same params: G's images
    and D's logits against flax's."""
    G, D = ref.Generator(dtype=jnp.float32), ref.Discriminator(
        dtype=jnp.float32)
    gp = G.init(jax.random.PRNGKey(0), jnp.zeros((1, NZ)))["params"]
    dp = D.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 1)))["params"]
    z, real, _ = _batches(1)[0]
    tg = dcgan.Generator(NZ, dtype=torch.float32, device="cpu")
    td = dcgan.Discriminator(dtype=torch.float32, device="cpu")
    tg.params_from_numpy(jax.tree.map(np.asarray, gp))
    td.params_from_numpy(jax.tree.map(np.asarray, dp))
    img = G.apply({"params": gp}, jnp.asarray(z))
    with torch.no_grad():
        got = tg(torch.from_numpy(z))
        assert got.shape == (B, 16, 16, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(img), atol=1e-5)
        np.testing.assert_allclose(
            td(torch.from_numpy(real)).numpy(),
            np.asarray(D.apply({"params": dp}, jnp.asarray(real))),
            atol=1e-5)
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(np.asarray, dp)
        bad["Dense_0"]["kernel"] = bad["Dense_0"]["kernel"][:3]
        td.params_from_numpy(bad)


def test_an_overflow_skips_only_its_own_models_step():
    """D's scale set past fp32's range: D's scaled losses are inf, its step
    is skipped (params, masters, moments and step count untouched) and its
    scale halves; G steps as usual with its scale kept."""
    tr = dcgan.build(B, NZ, device="cpu")
    tr.ds.scaler.loss_scale = 2.0 ** 129
    d_before = [p.detach().clone() for p in tr.D.parameters()]
    dm_before = [m.clone() for m in tr.ds.master]
    g_before = [p.detach().clone() for p in tr.G.parameters()]
    z, real, z2 = (torch.from_numpy(a) for a in _batches(1)[0])
    out = tr.step(z, real, z2)
    assert out["d"]["found_inf"] and not out["g"]["found_inf"]
    assert tr.ds.scaler.loss_scale == 2.0 ** 128
    assert tr.gs.scaler.loss_scale == 2.0 ** 16
    assert all(torch.equal(a, b) for a, b in zip(d_before, tr.D.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(dm_before, tr.ds.master))
    assert tr.ds.inner.step == 0 and tr.gs.inner.step == 1
    assert any(not torch.equal(a, b)
               for a, b in zip(g_before, tr.G.parameters()))
    assert all(p.grad is None for p in tr.D.parameters())


def test_the_example_runs_and_defaults_to_the_card(monkeypatch, capsys):
    out = dcgan.run(["--steps", "2", "--batch", "4", "--device", "cpu"])
    assert len(out["history"]) == 2
    assert all(np.isfinite([h["loss_d"], h["loss_g"]]).all()
               for h in out["history"])
    assert "independent loss scalers" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dcgan.build()
