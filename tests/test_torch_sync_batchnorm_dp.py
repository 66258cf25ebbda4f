"""SyncBatchNorm over a process group, on gloo ranks, against
``tests/test_sync_batchnorm.py:40-139`` and the JAX ImageNet example's
data-parallel step.

On 4 ranks (spawned once): the forward in NCHW and NHWC and the running
statistics against BatchNorm over the whole batch (the JAX test's
reference, and the JAX ``SyncBatchNorm`` under ``shard_map`` on 8
devices); the input grads and the psum of the param grads against
``jax.grad`` of full-batch BN; ``group_size=2`` cutting the 4 ranks into
two groups of 2; ``groupbn.BatchNorm2d_NHWC(bn_group=2)``; and
``convert_syncbn_model`` of a ``torch.nn.BatchNorm2d``. Tolerances as the
JAX test's: 1e-5 (forward, means), 1e-4 (running variance), 2e-4 (grads).

On 2 ranks: ``examples/imagenet/main_amp.build(sync_bn=True)``'s
data-parallel O2 step (tiny basic ResNet, fp32 convs, 8 images of 16x16,
3 steps) against the JAX example's step (``shard_map`` over ``data`` on a
2-device mesh, ``allreduce_gradients`` and the ``pmean``-ed loss) from the
same init: losses 1e-5 relative, masters within 1e-3 of how far they
moved (L2), running statistics 1e-4 of each leaf's max, and the same on
both ranks (sync BN).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.models import resnet as jresnet
from apex_tpu.ops.xentropy import softmax_cross_entropy as jxent
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.parallel import mesh as jmesh
from apex_tpu.parallel.distributed import allreduce_gradients
from apex_tpu.parallel.sync_batchnorm import SyncBatchNorm as JaxSyncBN
from torch_dp_workers import main_amp_dp, run_ranks, syncbn_cases

WORLD = 4


def _reference_bn(x, weight, bias, eps, c_ax):
    dims = tuple(d for d in range(x.ndim) if d != c_ax)
    x32 = np.asarray(x, np.float64)
    mean, var = x32.mean(dims), x32.var(dims)
    shape = [1] * x.ndim
    shape[c_ax] = x.shape[c_ax]
    y = (x32 - mean.reshape(shape)) / np.sqrt(var.reshape(shape) + eps)
    return y * np.reshape(weight, shape) + np.reshape(bias, shape)


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 6, 5, 7)).astype(np.float32)
    inp = {"fwd": x, "fwd_nhwc": np.ascontiguousarray(np.moveaxis(x, 1, -1)),
           "fwd_w": rng.normal(size=(6,)).astype(np.float32),
           "fwd_b": rng.normal(size=(6,)).astype(np.float32)}
    rng = np.random.default_rng(1)
    inp["grad_x"] = rng.normal(size=(16, 4, 3)).astype(np.float32)
    inp["grad_w"] = rng.normal(size=(4,)).astype(np.float32)
    inp["grad_cot"] = rng.normal(size=(16, 4, 3)).astype(np.float32)
    inp["group_x"] = np.random.default_rng(2).normal(
        size=(8, 3)).astype(np.float32)
    inp["groupbn_x"] = np.random.default_rng(3).normal(
        size=(8, 2, 2, 3)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    inp = _inputs()
    return inp, run_ranks(syncbn_cases, WORLD,
                          tmp_path_factory.mktemp("syncbn"), inp)


def _gathered(ranks, key, sub=None):
    return np.concatenate([r[key] if sub is None else r[key][sub]
                           for r in ranks])


@pytest.mark.parametrize("channel_last", [False, True])
def test_forward_matches_full_batch_bn(case, channel_last):
    inp, ranks = case
    x = inp["fwd_nhwc" if channel_last else "fwd"]
    c_ax = 3 if channel_last else 1
    w, b = inp["fwd_w"], inp["fwd_b"]
    got = [r[f"fwd_{channel_last}"] for r in ranks]
    y = np.concatenate([g["y"] for g in got])
    np.testing.assert_allclose(y, _reference_bn(x, w, b, 1e-5, c_ax),
                               atol=1e-5)
    # the JAX module under shard_map over 8 devices gives the same
    bn = JaxSyncBN(axis_name="data", channel_last=channel_last)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
         "batch_stats": v["batch_stats"]}
    mesh = jmesh.make_virtual_mesh(8)
    try:
        jy, upd = jax.shard_map(
            lambda v, xs: bn.apply(v, xs, mutable=["batch_stats"]),
            mesh=mesh, in_specs=(P(), P("data")),
            out_specs=(P("data"), P()), check_vma=False)(v, jnp.asarray(x))
    finally:
        jmesh.destroy_model_parallel()
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-5)
    dims = tuple(d for d in range(4) if d != c_ax)
    n = x.size // x.shape[c_ax]
    for g in got:  # the same running statistics on every rank
        np.testing.assert_allclose(g["mean"], 0.1 * x.mean(dims), atol=1e-5)
        np.testing.assert_allclose(
            g["var"], 0.9 + 0.1 * x.var(dims) * n / (n - 1), atol=1e-4)
        np.testing.assert_allclose(g["mean"], np.asarray(
            upd["batch_stats"]["mean"]), atol=1e-5)
        np.testing.assert_allclose(g["var"], np.asarray(
            upd["batch_stats"]["var"]), atol=1e-4)


def test_gradients_match_full_batch_bn(case):
    inp, ranks = case
    x, w, cot = inp["grad_x"], inp["grad_w"], inp["grad_cot"]
    b = np.zeros(4, np.float32)

    def full_loss(params, xs):
        dims = (0, 2)
        mean = xs.mean(dims, keepdims=True)
        var = xs.var(dims, keepdims=True)
        y = (xs - mean) / jnp.sqrt(var + 1e-5)
        y = y * params["scale"].reshape(1, 4, 1) + params["bias"].reshape(
            1, 4, 1)
        return jnp.sum(y * cot)

    ref = jax.grad(full_loss, argnums=(0, 1))(
        {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x))
    np.testing.assert_allclose(_gathered(ranks, "grads", "x"),
                               np.asarray(ref[1]), atol=2e-4)
    for r in ranks:
        for k in ("scale", "bias"):
            np.testing.assert_allclose(r["grads"][k], np.asarray(ref[0][k]),
                                       atol=2e-4)


def test_group_size_subsets_axis(case):
    """group_size=2 on 4 ranks: rows 0-3 and 4-7 are normalised apart."""
    inp, ranks = case
    x = inp["group_x"]
    y = _gathered(ranks, "group")
    w, b = np.ones(3), np.zeros(3)
    for half in (slice(0, 4), slice(4, 8)):
        np.testing.assert_allclose(y[half], _reference_bn(x[half], w, b,
                                                          1e-5, 1),
                                   atol=1e-5)


def test_groupbn_nhwc_over_bn_group(case):
    inp, ranks = case
    x = inp["groupbn_x"]
    y = _gathered(ranks, "groupbn")
    w, b = np.ones(3), np.zeros(3)
    for g, half in enumerate((slice(0, 4), slice(4, 8))):
        np.testing.assert_allclose(y[half], _reference_bn(x[half], w, b,
                                                          1e-5, 3),
                                   atol=1e-5)
        for r in ranks[2 * g:2 * g + 2]:  # the group's own statistics
            np.testing.assert_allclose(
                r["groupbn_stats"], 0.1 * x[half].mean((0, 1, 2)),
                atol=1e-6)


def test_convert_syncbn_model_of_torch_batchnorm(case):
    inp, ranks = case
    x = inp["fwd"][:, :5]
    y = _gathered(ranks, "converted")
    np.testing.assert_allclose(y, _reference_bn(x, np.ones(5), np.zeros(5),
                                                1e-5, 1), atol=1e-5)
    n = x.size // 5
    for r in ranks:
        assert r["converted_type"] == "SyncBatchNorm"
        np.testing.assert_allclose(
            r["converted_stats"], 0.8 + 0.2 * x.var((0, 2, 3)) * n / (n - 1),
            atol=1e-4)


def _jax_example_steps(variables, images, labels, steps):
    """The JAX example's data-parallel step (``main_amp.py:120-150``) on a
    2-device mesh, sync BN over ``data``, fp32 convs."""
    model = jresnet.ResNet(block_cls=jresnet.BasicBlock, stage_sizes=(1, 1),
                           num_classes=10, width=8, stem_pool=False,
                           axis_name="data", dtype=jnp.float32)
    policy = jamp.get_policy("O2")
    mp_opt = jamp.MixedPrecisionOptimizer(
        JaxFusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4, nesterov=True),
        policy)
    params = jamp.cast_params(variables["params"], policy)
    stats = variables["batch_stats"]
    opt_state = mp_opt.init(params)
    mesh = jmesh.make_virtual_mesh(2)
    try:
        def sharded_step(params, stats, opt_state, images, labels):
            def scaled_loss(p):
                logits, mut = model.apply(
                    {"params": p, "batch_stats": stats}, images,
                    mutable=["batch_stats"])
                loss = jnp.mean(jxent(logits, labels))
                return mp_opt.scale_loss(loss, opt_state), \
                    mut["batch_stats"]

            (scaled, new_stats), grads = jax.value_and_grad(
                scaled_loss, has_aux=True)(params)
            grads = allreduce_gradients(grads, ("data",))
            loss = jax.lax.pmean(scaled, "data") / \
                opt_state.scaler.loss_scale
            new_params, new_opt, _ = mp_opt.apply_gradients(
                opt_state, params, grads)
            return new_params, new_stats, new_opt, loss

        step = jax.jit(jax.shard_map(
            sharded_step, mesh=mesh,
            in_specs=(P(), P(), P(), P("data"), P("data")),
            out_specs=(P(), P(), P(), P()), check_vma=False))
        data = NamedSharding(mesh, P("data"))
        im = jax.device_put(jnp.asarray(images), data)
        lb = jax.device_put(jnp.asarray(labels, jnp.int32), data)
        losses = []
        for _ in range(steps):
            params, stats, opt_state, loss = step(params, stats, opt_state,
                                                  im, lb)
            losses.append(float(loss))
    finally:
        jmesh.destroy_model_parallel()
    np_tree = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
    return losses, np_tree(opt_state.master), np_tree(stats)


def _l2(a, b):
    return float(np.sqrt(sum(np.sum((np.asarray(x, np.float64)
                                     - np.asarray(y, np.float64)) ** 2)
                             for x, y in zip(jax.tree.leaves(a),
                                             jax.tree.leaves(b)))))


def test_main_amp_sync_bn_dp_step_matches_the_jax_example(tmp_path):
    rng = np.random.default_rng(1)
    images = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (8,)).astype(np.int64)
    jm = jresnet.ResNet(block_cls=jresnet.BasicBlock, stage_sizes=(1, 1),
                        num_classes=10, width=8, stem_pool=False)
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float32) if np.asarray(a).dtype
        != np.int32 else np.asarray(a),
        jm.init(jax.random.PRNGKey(0), jnp.asarray(images[:1])))
    jlosses, jmaster, jstats = _jax_example_steps(variables, images, labels,
                                                  3)
    ranks = run_ranks(main_amp_dp, 2, tmp_path, variables, images, labels, 3)
    moved = _l2(jmaster, variables["params"])
    for r in ranks:
        assert r["dp"] == 2 and not any(r["found"])
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
        assert _l2(r["masters"], jmaster) <= 1e-3 * moved
        for a, b in zip(jax.tree.leaves(r["stats"]),
                        jax.tree.leaves(jstats)):
            np.testing.assert_allclose(a, b, atol=1e-4 * max(
                np.abs(b).max(), 1e-30))
    for a, b in zip(jax.tree.leaves(ranks[0]["stats"]),
                    jax.tree.leaves(ranks[1]["stats"])):
        np.testing.assert_array_equal(a, b)
