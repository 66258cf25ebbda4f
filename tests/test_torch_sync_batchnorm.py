"""apex_tpu_torch.parallel.SyncBatchNorm (local path) against
apex_tpu.parallel.SyncBatchNorm with ``axis_name=None`` on the CPU.

The same numpy input, scale/bias and upstream gradient go through
``jax.grad`` of the flax module and through the port's ``BatchNormFn``
(its closed-form backward): forward, input grad, scale/bias grads, and the
running stats after two steps. NHWC and NCHW, ``fuse_relu``,
``momentum=None`` (the cumulative average), eval mode (running stats) and
bf16 input with fp32 stats. Tolerances: fp32 1e-5 (the same fp32 formula;
the backward in closed form against autodiff of it, sums in another
order); bf16 outputs one bf16 ulp (2^-7 relative), bf16 dx 2^-7 of
max |dx|.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.parallel.sync_batchnorm import SyncBatchNorm as JaxBN
from apex_tpu_torch.parallel import SyncBatchNorm
from apex_tpu_torch.parallel import mesh
from apex_tpu_torch.parallel.sync_batchnorm import sync_moments


def _inputs(shape, c_ax, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[c_ax]
    x = (rng.normal(size=shape) * 2 + 0.7).astype(np.float32)
    w = (1 + 0.2 * rng.normal(size=(c,))).astype(np.float32)
    b = (0.3 * rng.normal(size=(c,))).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, w, b, g


def _jax_run(x, w, b, g, steps, **kw):
    """(y, dx, dscale, dbias) of the last of ``steps`` training steps, and
    the running stats after them."""
    bn = JaxBN(**kw)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}
    stats = v["batch_stats"]
    for _ in range(steps):
        def f(xx, p):
            y, new = bn.apply({"params": p, "batch_stats": stats}, xx,
                              mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g)), (y, new)
        (_, (y, new)), (dx, dp) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), params)
        stats = new["batch_stats"]
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return ((f32(y), f32(dx), f32(dp["scale"]), f32(dp["bias"])),
            {k: np.asarray(v) for k, v in stats.items()})


def _port_run(x, w, b, g, steps, dtype=torch.float32, **kw):
    c_ax = x.ndim - 1 if kw.get("channel_last") else 1
    bn = SyncBatchNorm(x.shape[c_ax], device="cpu", **kw)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    for _ in range(steps):
        bn.scale.grad = bn.bias.grad = None
        xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
        y = bn(xt)
        (y.float() * torch.from_numpy(g)).sum().backward()
    f32 = lambda t: t.detach().float().numpy()  # noqa: E731
    return ((f32(y), f32(xt.grad), f32(bn.scale.grad), f32(bn.bias.grad)),
            {"mean": f32(bn.mean), "var": f32(bn.var),
             "num_batches_tracked": bn.num_batches_tracked.numpy()})


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("fuse_relu", [False, True])
@pytest.mark.parametrize("momentum", [0.1, None])
def test_fp32_forward_grads_and_stats_match_jax(layout, fuse_relu,
                                                momentum):
    shape = (4, 5, 3, 6) if layout == "nhwc" else (4, 6, 5, 3)
    c_ax = 3 if layout == "nhwc" else 1
    x, w, b, g = _inputs(shape, c_ax)
    kw = dict(channel_last=layout == "nhwc", fuse_relu=fuse_relu,
              momentum=momentum)
    jout, jstats = _jax_run(x, w, b, g, 2, **kw)
    tout, tstats = _port_run(x, w, b, g, 2, **kw)
    for name, a, r in zip(("y", "dx", "dscale", "dbias"), tout, jout):
        np.testing.assert_allclose(a, r, rtol=1e-5, atol=1e-5, err_msg=name)
    for k in ("mean", "var"):
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert int(tstats["num_batches_tracked"]) == 2 \
        == int(jstats["num_batches_tracked"])


def test_bf16_input_fp32_stats_match_jax():
    x, w, b, g = _inputs((32, 8), 1, seed=3)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    kw = dict(fuse_relu=True)
    jbn = JaxBN(**kw)
    xj = jnp.asarray(xb, jnp.bfloat16)
    v = jbn.init(jax.random.PRNGKey(0), xj)
    params = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}

    def f(xx, p):
        y, new = jbn.apply({"params": p, "batch_stats": v["batch_stats"]},
                           xx, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g)), (y, new)
    (_, (jy, jnew)), (jdx, jdp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(xj, params)
    assert jy.dtype == jnp.bfloat16
    (ty, tdx, tds, tdb), tstats = _port_run(xb, w, b, g, 1,
                                            dtype=torch.bfloat16, **kw)
    jy, jdx = np.asarray(jy, np.float32), np.asarray(jdx, np.float32)
    assert (ty >= 0).all()
    assert (np.abs(ty - jy) <= np.abs(jy) * 2.0 ** -7 + 1e-6).all()
    assert np.abs(tdx - jdx).max() <= 2.0 ** -7 * np.abs(jdx).max()
    np.testing.assert_allclose(tds, np.asarray(jdp["scale"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tdb, np.asarray(jdp["bias"]), rtol=1e-4,
                               atol=1e-4)
    for k in ("mean", "var"):
        np.testing.assert_allclose(tstats[k],
                                   np.asarray(jnew["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6)


def test_eval_mode_uses_running_stats_like_jax():
    x, w, b, _ = _inputs((6, 4, 3, 3), 1, seed=5)
    stats = {"mean": np.linspace(-1, 1, 4).astype(np.float32),
             "var": np.linspace(0.5, 2, 4).astype(np.float32),
             "num_batches_tracked": np.ones((), np.int32)}
    jbn = JaxBN(fuse_relu=True)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jy = jbn.apply({"params": {"scale": jnp.asarray(w),
                               "bias": jnp.asarray(b)},
                    "batch_stats": {k: jnp.asarray(a)
                                    for k, a in stats.items()}},
                   jnp.asarray(x), use_running_average=True)
    bn = SyncBatchNorm(4, fuse_relu=True, device="cpu")
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
        bn.mean.copy_(torch.from_numpy(stats["mean"]))
        bn.var.copy_(torch.from_numpy(stats["var"]))
    bn.eval()
    y = bn(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 0  # eval leaves the stats alone
    # explicit argument wins over the module's mode
    bn.train()
    y2 = bn(torch.from_numpy(x), use_running_average=True)
    assert torch.equal(y, y2)


def test_untracked_stats_and_local_only_surface():
    x, _, _, _ = _inputs((8, 3), 1, seed=6)
    bn = SyncBatchNorm(3, affine=False, track_running_stats=False,
                       device="cpu")
    assert bn.mean is None and bn.scale is None
    y = bn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y.mean(0), 0.0, atol=1e-5)
    mean, var, count = sync_moments(torch.from_numpy(x), [0])
    np.testing.assert_allclose(var.numpy(), x.var(0), rtol=1e-5)
    assert count == 8.0
    # statistics over a mesh axis need an installed mesh
    with pytest.raises(RuntimeError, match="not initialized"):
        sync_moments(torch.from_numpy(x), [0], axis_name="data")
    # one rank with no process group: the group's statistics are the local
    # ones, bit for bit (the data-parallel cases run on gloo ranks,
    # tests/test_torch_sync_batchnorm_dp.py)
    mesh.initialize_model_parallel()
    try:
        synced = SyncBatchNorm(3, axis_name="data", device="cpu")
        local = SyncBatchNorm(3, device="cpu")
        assert torch.equal(synced(torch.from_numpy(x)),
                           local(torch.from_numpy(x)))
        assert torch.equal(synced.var, local.var)
        got = sync_moments(torch.from_numpy(x), [0], axis_name="data")
        for a, b in zip(got, (mean, var, count)):
            assert torch.equal(a, b)
    finally:
        mesh.destroy_model_parallel()
