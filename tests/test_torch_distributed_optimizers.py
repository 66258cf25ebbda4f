"""The ZeRO-sharded optimizers of the port (``apex_tpu_torch.optimizers.
distributed``) on 4 spawned gloo ranks against the JAX package
(``tests/test_distributed_optimizers.py``, case by case): the same numpy
params and per-rank grads.

- DistributedFusedAdam / DistributedFusedLAMB over 3 steps of different
  per-rank grads against the unsharded JAX optimizer on the replica-mean
  grads and against the JAX ``shard_map`` run (2e-5, the JAX test's
  tolerance);
- the state holds 1/n of the moments (a 16 x 8 leaf: 32 elements a rank
  of 4);
- a chained inner (Adam, then a decaying trace: ``optax.chain(fused_adam,
  optax.trace(0.9))``) wraps with its nested state sharded and matches the
  unsharded JAX chain (2e-5);
- LAMB's trust ratio from whole-tensor norms: one step matches the
  unsharded JAX FusedLAMB (2e-5).
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.optimizers import (
    DistributedFusedAdam,
    DistributedFusedLAMB,
    FusedAdam,
    FusedLAMB,
    fused_adam,
)
from torch_dp_workers import distopt_cases, start_ranks

N = 4
STEPS = 3


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((13, 7)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32),
            "scale": np.asarray(rng.standard_normal(), np.float32)}


NAMES = ["w", "b", "scale"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params = _params(0)
    grads = [[{k: np.random.default_rng(1000 + 17 * t + r).standard_normal(
        np.shape(v)).astype(np.float32) for k, v in params.items()}
        for r in range(N)] for t in range(STEPS)]
    rng = np.random.default_rng(1)
    chain_params = {"w": rng.standard_normal((13, 7)).astype(np.float32),
                    "b": rng.standard_normal((5,)).astype(np.float32)}
    chain_grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                   for k, v in chain_params.items()}
    inp = {"params": [params[k] for k in NAMES],
           "grads": [[[g[k] for k in NAMES] for g in per] for per in grads],
           "chain_params": [chain_params["w"], chain_params["b"]],
           "chain_grads": [chain_grads["w"], chain_grads["b"]],
           "lamb_w": rng.standard_normal((32, 16)).astype(np.float32),
           "lamb_g": rng.standard_normal((32, 16)).astype(np.float32)}
    join = start_ranks(distopt_cases, N, tmp_path_factory.mktemp("dopt"),
                       inp)
    return dict(params=params, grads=grads, chain_params=chain_params,
                chain_grads=chain_grads, inp=inp, res=join())


def _jax_unsharded(ref, params, grads):
    want = jax.tree.map(jnp.asarray, params)
    state = ref.init(want)
    for t in range(STEPS):
        g_mean = jax.tree.map(lambda *xs: sum(xs) / N, *grads[t])
        upd, state = ref.update(g_mean, state, want)
        want = optax.apply_updates(want, upd)
    return want


def _jax_sharded(dist, params, grads):
    m = Mesh(np.array(jax.devices()[:N]), ("data",))
    stacked = {k: jnp.stack([jnp.stack([grads[t][r][k] for r in range(N)])
                             for t in range(STEPS)]) for k in params}

    def run(p, gs):
        state = dist.init(p)

        def body(carry, g):
            p, s = carry
            g = jax.tree.map(lambda x: x[0], g)
            upd, s = dist.update(g, s, p)
            return (optax.apply_updates(p, upd), s), None

        (p, _), _ = jax.lax.scan(body, (p, state), gs)
        return p

    pspec = jax.tree.map(lambda _: P(), params)
    gspec = jax.tree.map(lambda _: P(None, "data"), stacked)
    return jax.jit(jax.shard_map(run, mesh=m, in_specs=(pspec, gspec),
                                 out_specs=pspec, check_vma=False))(
        jax.tree.map(jnp.asarray, params), stacked)


@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_distributed_matches_unsharded(ranks, opt):
    if opt == "adam":
        dist = DistributedFusedAdam(lr=1e-2, weight_decay=0.01)
        ref = FusedAdam(lr=1e-2, weight_decay=0.01)
    else:
        dist = DistributedFusedLAMB(lr=1e-2, weight_decay=0.01)
        ref = FusedLAMB(lr=1e-2, weight_decay=0.01)
    want = _jax_unsharded(ref, ranks["params"], ranks["grads"])
    jgot = _jax_sharded(dist, ranks["params"], ranks["grads"])
    for res in ranks["res"]:
        for name, got in zip(NAMES, res[opt]):
            for ref_arr in (want[name], jgot[name]):
                np.testing.assert_allclose(
                    got, np.asarray(ref_arr), rtol=2e-5, atol=2e-5,
                    err_msg=f"{opt}:{name}")


def test_state_is_sharded(ranks):
    for res in ranks["res"]:
        # 16 * 8 = 128 elements; each of 4 ranks holds 32
        assert res["state_shapes"] == [(128 // N,)]


def test_chained_transform_wraps_and_shards(ranks):
    for res in ranks["res"]:
        # 91 elements pad to 92 (23 a rank), 5 to 8 (2 a rank)
        assert res["chain_state_shapes"] == [(23,), (2,)]
    params = jax.tree.map(jnp.asarray, ranks["chain_params"])
    g = jax.tree.map(jnp.asarray, ranks["chain_grads"])
    tx = optax.chain(fused_adam(lr=1e-2), optax.trace(decay=0.9))
    want, st = params, tx.init(params)
    for _ in range(2):
        upd, st = tx.update(g, st, want)
        want = optax.apply_updates(want, upd)
    for res in ranks["res"]:
        for name, got in zip(["w", "b"], res["chain"]):
            np.testing.assert_allclose(got, np.asarray(want[name]),
                                       rtol=2e-5, atol=2e-5, err_msg=name)


def test_lamb_trust_ratio_matches_across_sharding(ranks):
    w = {"w": jnp.asarray(ranks["inp"]["lamb_w"])}
    g = {"w": jnp.asarray(ranks["inp"]["lamb_g"])}
    ref = FusedLAMB(lr=0.1, weight_decay=0.05)
    upd, _ = ref.update(g, ref.init(w), w)
    want = optax.apply_updates(w, upd)
    for res in ranks["res"]:
        np.testing.assert_allclose(res["lamb_trust"], np.asarray(want["w"]),
                                   rtol=2e-5, atol=2e-5)
