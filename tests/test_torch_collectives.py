"""The port's named-axis collectives (``apex_tpu_torch.parallel.
collectives``) on 4 gloo ranks against ``tests/test_collectives.py``'s
cases under ``jax.shard_map`` on a 4-device mesh, on the same inputs.

The ranks are spawned once for the file (``tests/torch_dp_workers.py``)
and run every case in turn; each test holds its case against the JAX
shard_map's output (a ``P("model")`` output is the ranks' results
concatenated in rank order, a ``P()`` one every rank's equal result).
Small integers in fp32: every result is exact, so every comparison is
exact. Besides the mirrored seven: stacked (untiled) gathers, the reverse
shift, a two-dtype tree over a tuple naming a size-1 axis, inputs left
unwritten, the identity on one rank without a process group, and the
raises of a virtual mesh and of an uninitialized mesh.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.parallel import collectives as jcc
from apex_tpu_torch.parallel import collectives as cc
from apex_tpu_torch.parallel import mesh
from torch_dp_workers import collectives_cases, run_ranks

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(collectives_cases, WORLD,
                     tmp_path_factory.mktemp("collectives"))


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("model",))


def _smap(jmesh, fn, in_specs, out_specs):
    return jax.shard_map(fn, mesh=jmesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def _sharded(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _replicated(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


def test_psum_pmean(ranks, jmesh):
    s, m = _smap(jmesh, lambda x: (jcc.psum(x, "model"),
                                   jcc.pmean(x, "model")),
                 P("model"), (P(), P()))(jnp.arange(8.0))
    np.testing.assert_array_equal(_replicated(ranks, "psum"), np.asarray(s))
    np.testing.assert_array_equal(_replicated(ranks, "pmean"), np.asarray(m))


def test_all_gather_reduce_scatter_roundtrip(ranks, jmesh):
    x = jnp.arange(16.0).reshape(16, 1)

    def body(x):
        g = jcc.all_gather(x, "model")
        return g, jcc.reduce_scatter(g, "model"), jcc.all_gather(
            x, "model", gather_axis=1, tiled=False)

    g, out, stacked = _smap(jmesh, body, P("model", None),
                            (P(), P("model", None), P()))(x)
    np.testing.assert_array_equal(_replicated(ranks, "all_gather"),
                                  np.asarray(g))
    np.testing.assert_array_equal(_sharded(ranks, "reduce_scatter"),
                                  np.asarray(out))
    np.testing.assert_array_equal(_sharded(ranks, "reduce_scatter"),
                                  4.0 * np.arange(16.0).reshape(16, 1))
    np.testing.assert_array_equal(_replicated(ranks, "all_gather_stacked"),
                                  np.asarray(stacked))


def test_ppermute_ring_shift(ranks, jmesh):
    for shift, key in ((1, "ppermute"), (-1, "ppermute_back")):
        out = _smap(jmesh, lambda x: jcc.ppermute_shift(x, "model", shift),
                    P("model"), P("model"))(jnp.arange(4.0))
        np.testing.assert_array_equal(_sharded(ranks, key), np.asarray(out))
    np.testing.assert_array_equal(_sharded(ranks, "ppermute"),
                                  [3.0, 0.0, 1.0, 2.0])


def test_broadcast_from_src(ranks, jmesh):
    out = _smap(jmesh, lambda x: jcc.broadcast(x, "model", src=2),
                P("model"), P("model"))(jnp.arange(4.0))
    np.testing.assert_array_equal(_sharded(ranks, "broadcast"),
                                  np.asarray(out))


def test_axis_rank_size(ranks, jmesh):
    r, s = _smap(jmesh, lambda: (jcc.axis_rank("model")[None],
                                 jnp.full((1,), jcc.axis_size("model"))),
                 (), (P("model"), P("model")))()
    assert [x["rank"] for x in ranks] == np.asarray(r).tolist()
    assert [x["size"] for x in ranks] == np.asarray(s).tolist()


def test_all_to_all(ranks, jmesh):
    out = _smap(jmesh, lambda x: jcc.all_to_all(
        x, "model", split_axis=0, concat_axis=1),
        P("model", None), P("model", None))(jnp.arange(32.0).reshape(16, 2))
    got = _sharded(ranks, "all_to_all")
    assert got.shape == (4, 8)
    np.testing.assert_array_equal(got, np.asarray(out))


def test_pmax_tree(ranks, jmesh):
    tree = {"a": jnp.arange(4.0), "b": jnp.arange(4.0) * -1}
    out = _smap(jmesh, lambda t: jcc.pmax(t, "model"), P("model"), P())(tree)
    for k in ("a", "b"):
        got = [r["pmax"][k] for r in ranks]
        for g in got:
            np.testing.assert_array_equal(g, np.asarray(out[k]))


def test_mixed_tree_tuple_axes_and_inputs_kept(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["psum_mixed"][0], np.full(3, 10.0))
        assert r["psum_mixed"][1].dtype == np.int64
        np.testing.assert_array_equal(r["psum_mixed"][1], np.full(2, 10))
    np.testing.assert_array_equal(
        _sharded(ranks, "inputs_kept"), np.repeat([1.0, 2.0, 3.0, 4.0], 3))


def test_one_rank_without_a_group_and_the_raises():
    """One rank with no process group: every verb is the identity (a
    one-device mesh). A virtual mesh has no groups: a collective raises;
    and so does any verb before a mesh is installed."""
    mesh.destroy_model_parallel()
    x = torch.arange(4.0)
    with pytest.raises(RuntimeError, match="not initialized"):
        cc.psum(x, "data")
    mesh.initialize_model_parallel()
    try:
        assert torch.equal(cc.psum(x, "data"), x)
        assert torch.equal(cc.all_gather(x, "data"), x)
        assert torch.equal(cc.ppermute_shift(x, "data"), x)
        assert cc.axis_rank("data") == 0 and cc.axis_size("data") == 1
        y = cc.pmean({"x": x}, ("data", "model"))["x"]
        assert torch.equal(y, x) and y is not x
    finally:
        mesh.destroy_model_parallel()
    mesh.make_virtual_mesh(4)
    try:
        with pytest.raises(RuntimeError, match="virtual mesh"):
            cc.psum(x, "data")
        with pytest.raises(NotImplementedError, match="item 16"):
            cc.psum(x, "dcn")
    finally:
        mesh.destroy_model_parallel()
