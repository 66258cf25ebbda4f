"""apex_tpu_torch.amp's O1 function registries and ``amp.initialize`` /
``AmpTrainState`` against apex_tpu.amp on the CPU.

Mirrors ``tests/test_inventory_parity.py::test_half_float_promote_functions``
and ``::test_disable_casts_context`` and ``tests/test_amp.py::
test_initialize_o2_casts_and_bundles``; then two O2 ``AmpTrainState`` steps
of a two-layer model on the same params and inputs in both packages: the
losses, the fp32 masters (1e-6) and the bf16 params (one bf16 rounding) agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from apex_tpu import amp as jamp
from apex_tpu.optimizers import fused_sgd
from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import FusedSGD


@pytest.fixture(autouse=True)
def _no_active_policy():
    amp.set_active_policy(None)
    yield
    amp.set_active_policy(None)


def test_half_float_promote_functions():
    amp.set_active_policy(amp.get_policy("O1"))

    @amp.half_function
    def matmul_like(a, b):
        assert a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16
        return a @ b

    @amp.float_function
    def loss_like(x):
        assert x.dtype == torch.float32
        return torch.mean(x)

    @amp.promote_function
    def add_like(a, b):
        assert a.dtype == b.dtype == torch.float32
        return a + b

    a = torch.ones(4, 4)
    b = torch.ones(4, 4, dtype=torch.bfloat16)
    assert matmul_like(a, a).dtype == torch.bfloat16
    assert loss_like(b).dtype == torch.float32
    assert add_like(a, b).dtype == torch.float32


def test_casts_reach_nested_args_and_leave_the_rest():
    """Nested lists, tuples and dicts in args and kwargs are cast; ints,
    complex tensors and non-tensors pass; a complex arg promotes the real
    floats to complex."""
    amp.set_active_policy(amp.get_policy("O1"))
    seen = {}

    @amp.half_function
    def f(xs, *, opts):
        seen.update(xs=[x.dtype for x in xs], w=opts["w"].dtype,
                    n=opts["n"].dtype, c=opts["c"].dtype, s=opts["s"])
        return xs[0]

    f([torch.ones(2), torch.ones(2, dtype=torch.float64)],
      opts={"w": torch.ones(2), "n": torch.ones(2, dtype=torch.int32),
            "c": torch.ones(2, dtype=torch.complex64), "s": "keep"})
    assert seen == {"xs": [torch.bfloat16, torch.bfloat16],
                    "w": torch.bfloat16, "n": torch.int32,
                    "c": torch.complex64, "s": "keep"}

    @amp.promote_function
    def g(a, b, n):
        return a.dtype, b.dtype, n.dtype

    assert g(torch.ones(2, dtype=torch.bfloat16),
             torch.ones(2, dtype=torch.complex64),
             torch.ones(2, dtype=torch.int64)) == (
        torch.complex64, torch.complex64, torch.int64)


@pytest.mark.parametrize("level", ["O2", "O3"])
def test_half_function_is_a_no_op_under_a_cast_model(level):
    amp.set_active_policy(amp.get_policy(level))

    @amp.half_function
    def f(a):
        return a

    assert f(torch.ones(2)).dtype == torch.float32
    amp.set_active_policy(amp.get_policy("O1", half_dtype=torch.float32))
    assert f(torch.ones(2, dtype=torch.float64)).dtype == torch.float64


def test_functions_noop_without_policy():
    @amp.half_function
    def f(a):
        return a

    assert f(torch.ones(2)).dtype == torch.float32


def test_disable_casts_context():
    amp.set_active_policy(amp.get_policy("O1"))

    @amp.half_function
    def f(a):
        return a

    x = torch.ones(2)
    assert f(x).dtype == torch.bfloat16
    with amp.disable_casts():
        assert f(x).dtype == torch.float32  # casts suspended
    assert f(x).dtype == torch.bfloat16  # restored


class TwoLayer(nn.Module):
    """``tests/test_amp.py``'s model: ``relu(x @ w1) @ w2``, the weights cast
    to the input's dtype."""

    def __init__(self, w1: np.ndarray, w2: np.ndarray):
        super().__init__()
        self.w1 = nn.Parameter(torch.from_numpy(np.array(w1)))
        self.w2 = nn.Parameter(torch.from_numpy(np.array(w2)))


def apply_fn(module, x):
    h = torch.relu(x @ module.w1.to(x.dtype))
    return h @ module.w2.to(x.dtype)


def _jax_model():
    def jax_apply(params, x):
        h = jax.nn.relu(x @ params["w1"].astype(x.dtype))
        return h @ params["w2"].astype(x.dtype)

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"w1": jax.random.normal(k1, (8, 16), jnp.float32) * 0.1,
              "w2": jax.random.normal(k2, (16, 4), jnp.float32) * 0.1}
    return jax_apply, params


def test_initialize_o2_casts_and_bundles():
    _, params = _jax_model()
    ts = amp.initialize(TwoLayer(params["w1"], params["w2"]),
                        FusedSGD(lr=0.1, momentum=0.9), opt_level="O2",
                        apply_fn=apply_fn, verbosity=0)
    assert isinstance(ts, amp.AmpTrainState)
    assert ts.module.w1.dtype == torch.bfloat16
    assert ts.opt_state.master[0].dtype == torch.float32
    assert ts.scaler.dynamic and ts.step == 0


def test_initialize_returns_the_references_three_forms(capsys):
    _, params = _jax_model()
    m = TwoLayer(params["w1"], params["w2"])
    module, policy = amp.initialize(m, opt_level="O3")
    assert module is m and policy.opt_level == "O3"
    assert m.w1.dtype == torch.bfloat16
    assert "opt_level=O3" in capsys.readouterr().out  # the verbosity line
    from apex_tpu_torch.amp import functions

    assert functions._active_policy is policy  # the registries are armed
    m = TwoLayer(params["w1"], params["w2"])
    module, mp_opt = amp.initialize(m, FusedSGD(lr=0.1), opt_level="O2",
                                    min_loss_scale=4.0,
                                    max_loss_scale=2.0 ** 20, verbosity=0)
    assert isinstance(mp_opt, amp.MixedPrecisionOptimizer)
    scaler = mp_opt.init(module).scaler
    assert (scaler.min_loss_scale, scaler.max_loss_scale) == (4.0, 2.0 ** 20)
    with pytest.raises(ValueError, match="apply_fn without an optimizer"):
        amp.initialize(TwoLayer(params["w1"], params["w2"]),
                       apply_fn=apply_fn, verbosity=0)


def test_two_amp_train_state_steps_match_jax():
    """Two O2 steps through both ``AmpTrainState``s (fused SGD, momentum
    0.9, the dynamic scale): fp32 inputs (the weights cast up in
    ``apply_fn``), an MSE loss; the second step uses ``.grad``, the first
    explicit grads."""
    jax_apply, params = _jax_model()
    jts = jamp.initialize(params, fused_sgd(lr=0.05, momentum=0.9),
                          opt_level="O2", apply_fn=jax_apply, verbosity=0)
    ts = amp.initialize(TwoLayer(params["w1"], params["w2"]),
                        FusedSGD(lr=0.05, momentum=0.9), opt_level="O2",
                        apply_fn=apply_fn, verbosity=0)
    rng = np.random.default_rng(3)
    for i in range(2):
        x = rng.standard_normal((32, 8)).astype(np.float32)
        y = rng.standard_normal((32, 4)).astype(np.float32)

        def loss_fn(p, x=x, y=y):
            pred = jts.apply_fn(p, jnp.asarray(x))
            loss = jnp.mean((pred.astype(jnp.float32) - jnp.asarray(y)) ** 2)
            return jts.scale_loss(loss), loss

        grads, jloss = jax.grad(loss_fn, has_aux=True)(jts.params)
        jts, jm = jts.apply_gradients(grads)

        pred = ts.apply_fn(ts.module, torch.from_numpy(x))
        loss = torch.mean((pred.float() - torch.from_numpy(y)) ** 2)
        scaled = ts.scale_loss(loss)
        if i == 0:
            g = torch.autograd.grad(scaled, list(ts.module.parameters()))
            m = ts.apply_gradients(g)
        else:
            scaled.backward()
            m = ts.apply_gradients()
            assert all(p.grad is None for p in ts.module.parameters())
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-6)
        assert m["found_inf"] == bool(jm["found_inf"]) is False
        assert m["loss_scale"] == float(jm["loss_scale"])
    assert ts.step == int(jts.step) == 2
    for i, name in enumerate(("w1", "w2")):
        np.testing.assert_allclose(ts.opt_state.master[i].numpy(),
                                   np.asarray(jts.opt_state.master[name]),
                                   atol=1e-6)
        got = getattr(ts.module, name).detach().float().numpy()
        want = np.asarray(jts.params[name].astype(jnp.float32))
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=2 ** -8)
