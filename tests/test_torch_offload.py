"""The host-offloaded ZeRO optimizer of the port (``apex_tpu_torch.
optimizers.offload.HostOffloadedZero``) on 4 spawned gloo ranks, against
the resident ZeRO step and the JAX package (the two offload cases of
``tests/test_hierarchy.py``, ``:364`` and ``:393``, on the flat zero axis:
the reference's cases run them on its two-tier mesh, whose ``dcn_axis``
comes with ROADMAP Queue 1 item 16).

- Two steps of ZeRO FusedSGD (lr 1/32, momentum 1/2: dyadic, on integer
  grads, so every value is exact) with the state in host memory in 2
  buckets: params, masters and loss scale bit-identical to the resident
  step's, and to the JAX resident ZeRO step's on the same inputs;
- two steps of ZeRO FusedAdam on the int8 grad wire, its error-feedback
  residual offloaded per bucket: bit-identical to the resident step (the
  same per-leaf arithmetic), and within 1e-6 of it as the reference
  holds it; bucket 1's host-to-device copy is issued before bucket 0
  steps (the prefetch order: h2d, h2d, apply, apply).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from torch_dp_workers import offload_cases, start_ranks

N = 4
NAMES = ["b", "v", "w"]


def _int_valued(seed, shape):
    return np.random.default_rng(seed).integers(-8, 9, shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params = {"b": _int_valued(20, (13,)) / 8.0,
              "v": _int_valued(21, (11, 3)) / 4.0,
              "w": _int_valued(22, (7, 5)) / 4.0}
    g1 = [_int_valued(30 + i, (N,) + params[k].shape)
          for i, k in enumerate(NAMES)]
    g2 = [_int_valued(40 + i, (N,) + params[k].shape)
          for i, k in enumerate(NAMES)]
    inp = {"params": [params[k] for k in NAMES], "g1": g1, "g2": g2}
    join = start_ranks(offload_cases, N, tmp_path_factory.mktemp("off"), inp)
    return dict(params=params, g1=g1, g2=g2, jax=_jax_resident(params, g1,
                                                               g2),
                res=join())


def _jax_resident(params, g1, g2):
    m = Mesh(np.array(jax.devices()[:N]), ("data",))
    mp = jamp.MixedPrecisionOptimizer(
        JaxFusedSGD(lr=0.03125, momentum=0.5), jamp.get_policy("O2"),
        zero_axis="data")
    cast = jamp.cast_params({k: jnp.asarray(v) for k, v in params.items()},
                            jamp.get_policy("O2"))
    pspecs = {k: P() for k in params}
    st, sspecs = mp.zero_init(cast, m, pspecs)
    gspec = {k: P("data") for k in params}

    def step(p, s, g):
        g = {k: v[0] * s.scaler.loss_scale for k, v in g.items()}
        return mp.apply_gradients(s, p, g)

    fn = jax.jit(jax.shard_map(step, mesh=m, in_specs=(pspecs, sspecs,
                                                       gspec),
                               out_specs=(pspecs, sspecs, P()),
                               check_vma=False))
    p = cast
    for g in (g1, g2):
        p, st, mt = fn(p, st, {k: jnp.asarray(v) for k, v in zip(NAMES, g)})
    return ({k: np.asarray(p[k], np.float32) for k in NAMES},
            {k: np.asarray(st.master[k]) for k in NAMES},
            float(mt["loss_scale"]))


def test_offloaded_step_bitmatches_resident(ranks):
    jp, jm, js = ranks["jax"]
    for r, res in enumerate(ranks["res"]):
        got = res["sgd"]
        assert got["host"] and len(got["buckets"]) == 2
        res_, off = got["resident"], got["offload"]
        for a, b in zip(res_["params"], off["params"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(res_["masters"], off["masters"]):
            np.testing.assert_array_equal(a, b)
        assert res_["scale"] == off["scale"] == js
        for k, a in zip(NAMES, off["params"]):
            np.testing.assert_array_equal(a, jp[k])
        for k, a in zip(NAMES, off["masters"]):
            n = jm[k].size // N
            np.testing.assert_array_equal(a, jm[k][r * n:(r + 1) * n])


def test_offloaded_adam_int8_wire_tracks_resident(ranks):
    for res in ranks["res"]:
        got = res["adam_int8"]
        res_, off = got["resident"], got["offload"]
        for a, b in zip(res_["params"], off["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(a, b)
        for a, b in zip(res_["masters"], off["masters"]):
            np.testing.assert_array_equal(a, b)
        assert res_["scale"] == off["scale"]
        assert res["events"] == ["h2d", "h2d", "apply", "apply"]
