"""The port's tensor-parallel layers, mappings, vocab-parallel cross entropy
and parallel RNG (``apex_tpu_torch.transformer.tensor_parallel``) on 4
spawned gloo ranks (tp = 4), against the JAX package's ``shard_map`` runs of
the same cases on a 4-device CPU mesh: every case of
``tests/test_tensor_parallel.py``, on the same seeded inputs and the same
full JAX parameter trees (each rank loads its shard through
``shard_params``). Values and each rank's local grads against the JAX
grads' shard of that rank, at the JAX tests' 1e-5. The ranks are spawned
once for the module (``torch_tp_workers.layer_cases``) and run while the
parent computes the JAX side.

The RNG streams cannot give JAX's bits: their rank and stream properties
are held on their own (distinct per rank, the sequence-parallel stream
apart from the model-parallel one, the data-parallel stream the same on
every rank, seeds ``base + 2718 + rank`` and ``base + 1414 + rank``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.parallel import mesh as jmesh
from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu_torch.transformer import tensor_parallel as tp
from torch_dp_workers import start_ranks
from torch_tp_workers import layer_cases

TP = 4
COLUMN = {"kernel": (None, "model"), "bias": ("model",)}
ROW = {"kernel": ("model", None), "bias": (None,)}
EMBED = {"embedding": ("model", None)}
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _shard(tree, specs, rank):
    return tp.shard_params(tree, specs, rank, TP)


def _smap(mesh, fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _inputs():
    key = jax.random.PRNGKey
    up = jtp.ColumnParallelLinear(16, 64, axis=None)
    dn = jtp.RowParallelLinear(64, 16, axis=None)
    normal = lambda k, shape: np.asarray(  # noqa: E731
        jax.random.normal(key(k), shape))
    ints = lambda k, shape, n: np.asarray(  # noqa: E731
        jax.random.randint(key(k), shape, 0, n))

    def pair(k):
        return _np({"up": up.init(key(k)),
                    "dn": dn.init(jax.random.fold_in(key(k), 1))})

    return {
        "column": {"params": _np(jtp.ColumnParallelLinear(
            16, 32, axis=None).init(key(0))), "x": normal(1, (8, 16))},
        "row": {"params": _np(jtp.RowParallelLinear(
            32, 16, axis=None).init(key(2))), "x": normal(3, (8, 32))},
        "mlp": {"params": pair(4), "x": normal(5, (8, 16))},
        "embedding": {"params": _np(jtp.VocabParallelEmbedding(
            64, 16, axis=None).init(key(6))), "ids": ints(7, (4, 12), 64)},
        "ce": {"logits": normal(8, (4, 12, 64)),
               "target": ints(9, (4, 12), 64)},
        "ce_smooth": {"logits": normal(10, (6, 32)),
                      "target": ints(11, (6,), 32)},
        "round_trip": normal(12, (4, 8)),
        "seq_round_trip": normal(13, (2, 8, 4)),
        "sandwich": {"params": pair(14), "x": normal(15, (2, 8, 16))},
        "modes": normal(16, (2, 8, 4)),
    }


@pytest.fixture(scope="module")
def jmesh4():
    m = jmesh.make_virtual_mesh(TP, tensor_model_parallel_size=TP)
    yield m
    jmesh.destroy_model_parallel()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inp = _inputs()
    join = start_ranks(layer_cases, TP, tmp_path_factory.mktemp("tp"), inp)
    return inp, join


@pytest.fixture(scope="module")
def results(ranks, jmesh4):
    """The ranks' results, joined once the first test has its JAX side."""
    return ranks[1]()


def _jax_vg(mesh, par, params, x, loss, x_spec=P()):
    fn = _smap(mesh, jax.value_and_grad(lambda p, x: loss(par, p, x)),
               (par.specs(), x_spec), (P(), par.specs()))
    v, g = fn(jtp.shard_params(params, par.specs(), mesh), x)
    return float(v), _np(g)


def _held_grads(got, ref, specs):
    for r, (v, gs) in enumerate(got):
        for name in specs:
            np.testing.assert_allclose(
                gs[0][name], _shard(ref, specs, r)[name], **TOL,
                err_msg=f"rank {r} {name}")


def test_column_parallel_linear_matches_serial(ranks, jmesh4, results):
    inp = ranks[0]["column"]
    serial = jtp.ColumnParallelLinear(16, 32, axis=None)
    par = jtp.ColumnParallelLinear(16, 32, axis="model")
    sq = lambda m, p, x: jnp.sum(m.apply(p, x) ** 2)  # noqa: E731
    v_s, g_s = jax.value_and_grad(functools.partial(sq, serial))(
        inp["params"], inp["x"])
    v_p, g_p = _jax_vg(jmesh4, par, inp["params"], inp["x"], sq)
    for v, _ in results_of(results, "column"):
        np.testing.assert_allclose(v, v_p, rtol=1e-5)
        np.testing.assert_allclose(v, float(v_s), rtol=1e-5)
    _held_grads(results_of(results, "column"), g_p, COLUMN)
    _held_grads(results_of(results, "column"), _np(g_s), COLUMN)


def results_of(results, name):
    return [r[name] for r in results]


def test_column_no_gather_output_is_sharded(ranks, jmesh4, results):
    par = jtp.ColumnParallelLinear(16, 32, axis="model", gather_output=False)
    params = ranks[0]["column"]["params"]
    fn = _smap(jmesh4, par.apply, (par.specs(), P()), P(None, "model"))
    y = np.asarray(fn(jtp.shard_params(params, par.specs(), jmesh4),
                      jnp.ones((4, 16))))
    for r, got in enumerate(results_of(results, "no_gather")):
        assert got["local"].shape == (4, 32 // TP)
        np.testing.assert_allclose(got["local"], np.split(y, TP, 1)[r],
                                   **TOL)
        np.testing.assert_allclose(got["gathered"], y, **TOL)


def test_row_parallel_linear_matches_serial(ranks, jmesh4, results):
    inp = ranks[0]["row"]
    serial = jtp.RowParallelLinear(32, 16, axis=None)
    par = jtp.RowParallelLinear(32, 16, axis="model", input_is_parallel=True)
    sq = lambda m, p, x: jnp.sum(m.apply(p, x) ** 2)  # noqa: E731
    v_s, g_s = jax.value_and_grad(functools.partial(sq, serial))(
        inp["params"], inp["x"])
    v_p, g_p = _jax_vg(jmesh4, par, inp["params"], inp["x"], sq,
                       P(None, "model"))
    for v, _ in results_of(results, "row"):
        np.testing.assert_allclose(v, v_p, rtol=1e-5)
        np.testing.assert_allclose(v, float(v_s), rtol=1e-5)
    _held_grads(results_of(results, "row"), g_p, ROW)
    _held_grads(results_of(results, "row"), _np(g_s), ROW)


def test_column_into_row_mlp_matches_serial(ranks, jmesh4, results):
    inp = ranks[0]["mlp"]
    p_up = jtp.ColumnParallelLinear(16, 64, axis="model",
                                    gather_output=False)
    p_dn = jtp.RowParallelLinear(64, 16, axis="model",
                                 input_is_parallel=True)
    specs = {"up": p_up.specs(), "dn": p_dn.specs()}

    def par_loss(p, x):
        return jnp.mean(p_dn.apply(p["dn"], jax.nn.gelu(
            p_up.apply(p["up"], x))) ** 2)

    fn = _smap(jmesh4, jax.value_and_grad(par_loss), (specs, P()),
               (P(), specs))
    v_p, g_p = fn(jtp.shard_params(inp["params"], specs, jmesh4), inp["x"])
    g_p = _np(g_p)
    for r, (v, (gu, gd)) in enumerate(results_of(results, "mlp")):
        np.testing.assert_allclose(v, float(v_p), rtol=1e-5)
        for got, ref, spec in ((gu, g_p["up"], COLUMN),
                               (gd, g_p["dn"], ROW)):
            for name in spec:
                np.testing.assert_allclose(got[name],
                                           _shard(ref, spec, r)[name], **TOL)


def test_vocab_parallel_embedding_matches_serial(ranks, jmesh4, results):
    inp = ranks[0]["embedding"]
    par = jtp.VocabParallelEmbedding(64, 16, axis="model")
    sq = lambda m, p, x: jnp.sum(m.apply(p, x) ** 2)  # noqa: E731
    v_p, g_p = _jax_vg(jmesh4, par, inp["params"], jnp.asarray(inp["ids"]),
                       sq)
    for v, _ in results_of(results, "embedding"):
        np.testing.assert_allclose(v, v_p, rtol=1e-5)
    _held_grads(results_of(results, "embedding"), g_p, EMBED)


def test_vocab_parallel_cross_entropy_matches_serial(ranks, jmesh4,
                                                     results):
    inp = ranks[0]["ce"]
    target = jnp.asarray(inp["target"])
    fn = _smap(jmesh4, jax.value_and_grad(lambda lg: jnp.mean(
        jtp.vocab_parallel_cross_entropy(lg, target, axis="model"))),
        (P(None, None, "model"),), (P(), P(None, None, "model")))
    v_p, g_p = fn(jnp.asarray(inp["logits"]))
    v_s = jnp.mean(jtp.vocab_parallel_cross_entropy(
        jnp.asarray(inp["logits"]), target, axis=None))
    for r, (v, g) in enumerate(results_of(results, "ce")):
        np.testing.assert_allclose(v, float(v_p), rtol=1e-5)
        np.testing.assert_allclose(v, float(v_s), rtol=1e-5)
        np.testing.assert_allclose(g, np.split(np.asarray(g_p), TP, -1)[r],
                                   **TOL)


def test_vocab_parallel_cross_entropy_label_smoothing(ranks, jmesh4,
                                                      results):
    inp = ranks[0]["ce_smooth"]
    logits, target = jnp.asarray(inp["logits"]), jnp.asarray(inp["target"])
    fn = _smap(jmesh4, functools.partial(jtp.vocab_parallel_cross_entropy,
                                         axis="model", label_smoothing=0.1),
               (P(None, "model"), P()), P())
    par = np.asarray(fn(logits, target))
    lp = jax.nn.log_softmax(logits)
    onehot = jax.nn.one_hot(target, 32) * 0.9 + 0.1 / 32
    for got in results_of(results, "ce_smooth"):
        np.testing.assert_allclose(got, par, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, -jnp.sum(onehot * lp, -1),
                                   rtol=1e-5, atol=1e-6)


def test_mappings_round_trips(ranks, jmesh4, results):
    x = ranks[0]["round_trip"]
    fn = _smap(jmesh4, lambda x: jtp.scatter_to_tensor_model_parallel_region(
        jtp.gather_from_tensor_model_parallel_region(x, "model"), "model"),
        P(None, "model"), P(None, "model"))
    jy = np.asarray(fn(jnp.asarray(x)))
    for r, (local, back) in enumerate(results_of(results, "round_trip")):
        np.testing.assert_allclose(back, local, rtol=1e-6)
        np.testing.assert_allclose(back, np.split(jy, TP, 1)[r], rtol=1e-6)


def test_sequence_parallel_mappings_round_trip(ranks, jmesh4, results):
    x = ranks[0]["seq_round_trip"]
    for got in results_of(results, "seq_round_trip"):
        assert got["shard_shape"] == (2, 2, 4)  # seq dim 8 / tp 4
        np.testing.assert_allclose(got["restored"], x, rtol=1e-6)
        np.testing.assert_allclose(got["rs_minus_psum_slice"], 0.0,
                                   atol=1e-6)
    fn = _smap(jmesh4, lambda x: (
        jtp.reduce_scatter_to_sequence_parallel_region(x, "model")),
        P(), P(None, "model"))
    jrs = np.asarray(fn(jnp.asarray(x)))
    np.testing.assert_allclose(jrs, TP * x, rtol=1e-6)


def test_sequence_parallel_column_row_sandwich_matches_serial(
        ranks, jmesh4, results):
    inp = ranks[0]["sandwich"]
    p_up = jtp.ColumnParallelLinear(16, 64, axis="model",
                                    gather_output=False,
                                    sequence_parallel=True)
    p_dn = jtp.RowParallelLinear(64, 16, axis="model",
                                 input_is_parallel=True,
                                 sequence_parallel=True)
    s_up = jtp.ColumnParallelLinear(16, 64, axis=None)
    s_dn = jtp.RowParallelLinear(64, 16, axis=None)
    specs = {"up": p_up.specs(), "dn": p_dn.specs()}

    def par_loss(p, x):
        y = p_dn.apply(p["dn"], jax.nn.gelu(p_up.apply(p["up"], x)))
        return jnp.mean(jtp.gather_from_sequence_parallel_region(
            y, "model", False) ** 2)

    def serial_loss(p, x):
        return jnp.mean(s_dn.apply(p["dn"], jax.nn.gelu(
            s_up.apply(p["up"], x))) ** 2)

    fn = _smap(jmesh4, jax.value_and_grad(par_loss),
               (specs, P(None, "model")), (P(), specs))
    v_p, g_p = fn(jtp.shard_params(inp["params"], specs, jmesh4), inp["x"])
    v_s, g_s = jax.value_and_grad(serial_loss)(inp["params"], inp["x"])
    for ref_v, ref_g in ((v_p, _np(g_p)), (v_s, _np(g_s))):
        for r, (v, (gu, gd)) in enumerate(results_of(results, "sandwich")):
            np.testing.assert_allclose(v, float(ref_v), rtol=1e-5)
            for got, ref, spec in ((gu, ref_g["up"], COLUMN),
                                   (gd, ref_g["dn"], ROW)):
                for name in spec:
                    np.testing.assert_allclose(
                        got[name], _shard(ref, spec, r)[name], **TOL)


def test_gather_from_sequence_parallel_backward_modes(ranks, jmesh4,
                                                      results):
    x = jnp.asarray(ranks[0]["modes"])

    def loss_tp_grad(x):
        g = jtp.gather_from_sequence_parallel_region(x, "model", True)
        w = (jax.lax.axis_index("model") + 1).astype(x.dtype)
        return jnp.sum(g * w)

    jg = np.asarray(_smap(jmesh4, jax.grad(loss_tp_grad), P(None, "model"),
                          P(None, "model"))(x))
    for r, got in enumerate(results_of(results, "modes")):
        # each shard's cotangent sums w over the ranks: 1 + 2 + 3 + 4
        np.testing.assert_allclose(got[True], 10.0, rtol=1e-6)
        np.testing.assert_allclose(got[True], np.split(jg, TP, 1)[r],
                                   rtol=1e-6)
        np.testing.assert_allclose(got[False], 1.0, rtol=1e-6)


def test_sequence_parallel_layer_flag_validation():
    for mod in (tp, jtp):
        with pytest.raises(ValueError, match="gather_output"):
            mod.ColumnParallelLinear(8, 8, axis="model", gather_output=True,
                                     sequence_parallel=True)
        with pytest.raises(ValueError, match="input_is_parallel"):
            mod.RowParallelLinear(8, 8, axis="model",
                                  input_is_parallel=False,
                                  sequence_parallel=True)
    with pytest.raises(ValueError, match="comm_dtype only applies"):
        tp.ColumnParallelLinear(8, 8, comm_dtype="int8")
    # the quantized wire is in the port: it constructs, and an unknown
    # wire dtype raises as the reference's canon_wire_dtype does
    assert tp.RowParallelLinear(8, 8, sequence_parallel=True,
                                comm_dtype="int8").comm_dtype == "int8"
    with pytest.raises(ValueError, match="wire dtype"):
        tp.gather_from_sequence_parallel_region(torch.ones(1, 2, 1),
                                                comm_dtype="int4")


def test_sequence_parallel_key_differs_per_rank_and_stream(results):
    sp = [r["rng"]["sp"] for r in results]
    mp = [r["rng"]["mp"] for r in results]
    assert len(set(sp)) == TP
    assert not set(sp) & set(mp)
    for r, got in enumerate(results):
        g = torch.Generator()
        g.manual_seed(1414 + r)
        assert got["rng"]["sp"] == float(torch.rand(1, generator=g)[0])
        assert got["rng"]["tracker_sp"] == got["rng"]["sp"]


def test_model_parallel_key_differs_per_rank(results):
    mp = [r["rng"]["mp"] for r in results]
    assert len(set(mp)) == TP  # distinct randomness per TP rank
    for r, got in enumerate(results):
        g = torch.Generator()
        g.manual_seed(2718 + r)
        assert got["rng"]["mp"] == float(torch.rand(1, generator=g)[0])
        assert got["rng"]["tracker_mp"] == got["rng"]["mp"]
    # the data-parallel stream is the same on every rank
    assert len({r["rng"]["dp"] for r in results}) == 1
    assert all(r["rng"]["tracker_dp"] == r["rng"]["dp"] for r in results)


def test_scatter_indivisible_raises(results):
    for got in results:
        assert got["indivisible"] is not None
        assert "not divisible" in got["indivisible"]


def test_vocab_utility():
    for mod in (tp, jtp):
        assert mod.VocabUtility.vocab_range_from_global_vocab_size(
            64, 1, 4) == (16, 32)
        with pytest.raises(ValueError):
            mod.divide(10, 3)
    parts = tp.split_tensor_along_last_dim(torch.arange(12.0).view(2, 6), 3)
    assert [tuple(p.shape) for p in parts] == [(2, 2)] * 3


def test_broadcast_data_and_checkpoint_recompute(results):
    for got in results:
        np.testing.assert_array_equal(got["broadcast"]["a"], np.zeros(3))
        np.testing.assert_array_equal(got["broadcast"]["b"][0], [0, 1])
        plain, remat = got["checkpoint"]
        np.testing.assert_array_equal(plain, remat)


def test_no_topology_raises_naming_initialize_model_parallel():
    from apex_tpu_torch.parallel import mesh

    mesh.destroy_model_parallel()
    with pytest.raises(ValueError, match="initialize_model_parallel"):
        tp.copy_to_tensor_model_parallel_region(torch.ones(2))
    with pytest.raises(ValueError, match="initialize_model_parallel"):
        tp.VocabParallelEmbedding(8, 4, axis="model")
    tree = {"w": np.arange(8.0).reshape(2, 4), "b": np.ones(2)}
    cut = tp.shard_params(tree, {"w": (None, "model"), "b": ()}, 1, 2)
    np.testing.assert_array_equal(cut["w"], [[2, 3], [6, 7]])
    np.testing.assert_array_equal(cut["b"], [1, 1])
