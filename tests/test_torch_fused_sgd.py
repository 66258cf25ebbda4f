"""apex_tpu_torch.optimizers.FusedSGD against apex_tpu's ``fused_sgd`` on
the CPU: the same fp32 params and a seeded sequence of grads through both
for 4 steps; params and momentum buffers agree to 1e-6 relative (the same
fp32 arithmetic, fused differently). Cases: plain SGD, momentum (with its
first-step rule: the buffer starts as the grad), dampening, Nesterov, and
weight decay before and after the momentum."""

import numpy as np
import pytest

import jax.numpy as jnp
import optax
import torch

from apex_tpu.optimizers.fused_sgd import fused_sgd
from apex_tpu_torch.optimizers import FusedSGD

SHAPES = [(5, 3), (7,), (2, 3, 4)]
CASES = {
    "plain": dict(lr=0.1),
    "momentum": dict(lr=0.1, momentum=0.9),
    "dampening": dict(lr=0.05, momentum=0.9, dampening=0.3),
    "nesterov_wd": dict(lr=0.1, momentum=0.9, nesterov=True,
                        weight_decay=1e-2),
    "wd_after_momentum": dict(lr=0.1, momentum=0.8, weight_decay=1e-2,
                              wd_after_momentum=True),
    "wd_no_momentum": dict(lr=0.2, weight_decay=5e-2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_and_buffers_match_jax(case):
    kw = CASES[case]
    rng = np.random.default_rng(0)
    p0 = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
             for _ in range(4)]
    tx = fused_sgd(**kw)
    jp = [jnp.asarray(a) for a in p0]
    js = tx.init(jp)
    opt = FusedSGD(**kw)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = opt.update_(tp, [torch.from_numpy(a) for a in g], ts)
    assert ts.step == int(js.step) == 4
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    for a, b in zip(ts.momentum_buf, js.momentum_buf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_lr_override_and_nesterov_rules():
    p = [torch.ones(3)]
    opt = FusedSGD(lr=0.1)
    st = opt.init(p)
    opt.update_(p, [torch.ones(3)], st, lr=0.5)
    assert torch.allclose(p[0], torch.full((3,), 0.5))
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD(nesterov=True)
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD(momentum=0.9, dampening=0.1, nesterov=True)
