"""The overflow vote across ranks (``apex_tpu_torch.transformer.amp.
MeshGradScaler`` through ``MixedPrecisionOptimizer.apply_gradients(
found_inf_reducer=...)``) on 4 gloo ranks, mirroring
``tests/test_mesh_grad_scaler.py``: one O2 FusedSGD step on bf16 params
sharded 4 ways over the model or the pipe axis, with an inf only in rank
1's grads. With the vote every rank skips and halves the scale; without it
only rank 1 skips (its flag is its own). The params after the step are
held against the JAX run's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.parallel import mesh as jmesh
from apex_tpu.transformer.amp import MeshGradScaler as JaxMeshGradScaler
from torch_dp_workers import grad_scaler_cases, run_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(grad_scaler_cases, 4, tmp_path_factory.mktemp("vote"))


def _jax_run(reducer, axis):
    kw = ({"tensor_model_parallel_size": 4} if axis == "model"
          else {"pipeline_model_parallel_size": 4})
    mesh = jmesh.make_virtual_mesh(4, **kw)
    try:
        mp_opt = jamp.MixedPrecisionOptimizer(JaxFusedSGD(lr=0.1),
                                              jamp.get_policy("O2"))
        params = {"w": jnp.ones((8,), jnp.bfloat16)}
        grads = {"w": jnp.full((8,), 2.0 ** 15, jnp.bfloat16)
                 .at[3].set(jnp.inf)}
        spec = {"w": P(axis)}

        def step(params, grads):
            state = mp_opt.init(params)
            new, new_state, metrics = mp_opt.apply_gradients(
                state, params, grads, found_inf_reducer=reducer)
            return new, metrics["found_inf"], new_state.scaler.loss_scale

        fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(spec, spec),
                                   out_specs=(spec, P(), P()),
                                   check_vma=False))
        w, _, _ = fn(jax.device_put(
            params, {"w": NamedSharding(mesh, spec["w"])}), grads)
        return np.asarray(w["w"], np.float32)
    finally:
        jmesh.destroy_model_parallel()


@pytest.mark.parametrize("axis", ["model", "pipe"])
def test_one_rank_overflow_skips_all_ranks(ranks, axis):
    got = [r[axis] for r in ranks]
    assert all(r["found_inf"] for r in got)
    w = np.concatenate([r["w"] for r in got])
    np.testing.assert_array_equal(w, np.ones(8, np.float32))
    assert all(r["scale"] == 2.0 ** 15 for r in got)  # halved everywhere
    np.testing.assert_array_equal(
        w, _jax_run(JaxMeshGradScaler(axis).found_inf_reducer, axis))


def test_without_reducer_ranks_diverge(ranks):
    got = [r["none"] for r in ranks]
    assert [r["found_inf"] for r in got] == [False, True, False, False]
    assert [r["scale"] for r in got] == [2.0 ** 16, 2.0 ** 15, 2.0 ** 16,
                                        2.0 ** 16]
    w = np.concatenate([r["w"] for r in got])
    assert np.all(w[2:4] == 1.0)
    assert np.all(w[:2] != 1.0) and np.all(w[4:] != 1.0)
    np.testing.assert_array_equal(w, _jax_run(None, "model"))
