"""The port's expert-parallel MoE on 4 spawned gloo ranks against the JAX
package (``tests/test_moe.py``'s expert-parallel cases,
``tests/test_moe_parallel.py``, ``tests/test_gpt_moe.py``'s EP and EP x PP
cases).

The ranks are spawned once for the module (``torch_moe_workers.
moe_cases``) and run while the parent computes the JAX side on the same
numpy params and inputs:

- the layer on the data axis of 4 ranks (tokens and experts sharded):
  values against the JAX serial layer at ample capacity (2e-5), the grads
  of the local-mean loss after the spec-aware reduction against the
  serial grads (1e-4), ``num_experts`` that does not divide raising, the
  bounded congestion divergence, the dropped fraction against the JAX
  ``shard_map`` run's, and two congested runs bit for bit equal;
- GPT at ample capacity on 4 data ranks: the loss (rtol 2e-5) and every
  grad (atol 2e-4) against the JAX serial model's, with and without
  checkpointing; the int8 and e5m2 dispatch wires within the reference's
  EF-free bound of the exact wire (the loss within 5e-2, every grad
  within 0.1 of its leaf's max); ZeRO level 2 against the replicated
  optimizer (loss rtol 1e-5, params 2e-2, the bf16 gather wire) and the
  replicated O2 step against the JAX one; ZeRO level 3 refusing the
  expert-sharded leaves; the EP engine's streams equal to the serial
  engines' (port and JAX);
- on dp 2 x tp 2: the EP x TP layer (values 2e-5, grads 1e-4) and GPT
  (loss 2e-5, grads 3e-4); ``pretrain_gpt --moe-experts 4 --tp 2`` in O0:
  its first step's expert grads are the spec-aware ones (the serial
  grads of this rank's experts, 2e-4) and not the reference example's
  all-reduced mix of both data ranks' experts, and its checkpoint holds
  the experts gathered over ``data``;
- on pp 2 x dp 2: EP x PP with the router losses on the ring against
  the serial model run per micro-batch (loss 2e-5, grads 3e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.serve import Engine as JaxEngine
from apex_tpu.serve import Request as JaxRequest
from apex_tpu.serve import ServeConfig as JaxServeConfig
from apex_tpu.transformer.moe import MoEMLP as JaxMoEMLP
from apex_tpu_torch import checkpoint
from apex_tpu_torch._params import module_tree
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.serve import Engine, Request, ServeConfig
from apex_tpu_torch.transformer import tensor_parallel as tp
from torch_dp_workers import start_ranks
from torch_moe_workers import moe_cases

WORLD = 4
TINY = dict(vocab_size=64, hidden_size=16, num_layers=2,
            num_attention_heads=2, max_seq_len=8, hidden_dropout=0.0,
            remat=True, axis=None)
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=16.0)
FP32 = dict(compute_dtype=torch.float32)
GPT_CASES = {"remat": dict(moe_expert_axis="data"),
             "no_remat": dict(moe_expert_axis="data", remat=False),
             "int8": dict(moe_expert_axis="data", moe_dispatch_dtype="int8"),
             "e5m2": dict(moe_expert_axis="data", moe_dispatch_dtype="e5m2")}
PP_TINY = dict(vocab_size=128, hidden_size=32, num_layers=2,
               num_attention_heads=4, max_seq_len=16, hidden_dropout=0.0,
               remat=True, axis=None)
PP_MOE = dict(moe_num_experts=4, moe_top_k=1, moe_capacity_factor=16.0)
PRETRAIN_WIDTH = dict(vocab_size=64, hidden_size=32, num_layers=2,
                      num_attention_heads=4, max_seq_len=16,
                      hidden_dropout=0.0, remat=True, axis=None,
                      moe_num_experts=4, moe_top_k=2,
                      moe_capacity_factor=16.0)
PRETRAIN_ARGV = ["--device", "cpu", "--hidden", "32", "--layers", "2",
                 "--heads", "4", "--vocab", "64", "--seq", "16",
                 "--micro-batch", "2", "--num-microbatches", "1",
                 "--steps", "1", "--opt-level", "O0", "--lr", "1e-3",
                 "--tp", "2", "--moe-experts", "4",
                 "--moe-capacity-factor", "16"]
SCFG = dict(max_batch=2, max_seq=24, block_size=8)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _tuples(jspecs):
    return jax.tree.map(tuple, jspecs, is_leaf=lambda x: isinstance(x, P))


def _pipe_specs(specs):
    """The stacked layer specs named over ``pipe`` (their first dim)."""
    out = dict(specs)
    out["layers"] = jax.tree.map(lambda s: ("pipe",) + tuple(s[1:]),
                                 specs["layers"],
                                 is_leaf=lambda x: isinstance(x, tuple))
    return out


def _cut(tree, specs, coords, axes):
    """This rank's shard of a full tree over ``axes`` (its coordinates)."""
    for a in axes:
        rank, size = coords[a]
        tree = tp.shard_params(tree, specs, rank, size, a)
    return tree


def _held(got, ref, **tol):
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol,
                                   err_msg=str(path))


def _layer(E, k, cf, axis=None, tp_axis=None):
    return JaxMoEMLP(hidden_size=8, ffn_hidden_size=16, num_experts=E,
                     top_k=k, capacity_factor=cf, expert_axis=axis,
                     tp_axis=tp_axis)


def _layer_loss(layer):
    def loss(p, x):
        out, aux = layer.apply(p, x)
        return jnp.mean(out ** 2) + 0.01 * aux["load_balancing_loss"]
    return loss


def _jcfg(**kw):
    return JaxGPTConfig(compute_dtype=jnp.float32, **kw)


def _batch(rows=8, vocab=64, seq=8):
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (rows, seq),
                                         0, vocab))
    return toks, np.roll(toks, -1, axis=-1)


def _requests():
    rng = np.random.default_rng(3)
    return [(list(int(t) for t in rng.integers(0, 64, n)), m)
            for n, m in ((5, 4), (9, 3))]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_parallel")
    keys = {"ep_values": (8, 2, 16.0, 7, 8, 16), "ep_grads": (4, 1, 16.0, 9,
                                                                10, 8),
            "congestion": (4, 1, 0.5, 13, 14, 64),
            "dropped": (4, 2, 1.0, 0, 3, 64),
            "determinism": (4, 1, 0.5, 7, 8, 32)}
    layer_inp = {}
    for name, (E, k, cf, kp, kx, n) in keys.items():
        layer_inp[name] = {
            "tree": _np(_layer(E, k, cf).init(jax.random.PRNGKey(kp))),
            "x": np.asarray(jax.random.normal(jax.random.PRNGKey(kx),
                                              (n, 8)))}
    jgpt = JaxGPTModel(_jcfg(**MOE, **TINY))
    gpt_tree = _np(jgpt.init(jax.random.PRNGKey(0)))
    toks, tgts = _batch()
    base = dict(TINY, **FP32, **MOE)
    serve_cfg = dict(base, max_seq_len=32, remat=False)
    serve_tree = _np(JaxGPTModel(_jcfg(**dict(TINY, max_seq_len=32,
                                              remat=False), **MOE)).init(
        jax.random.PRNGKey(0)))
    ptoks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                                          128))
    pp_tree = _np(JaxGPTModel(_jcfg(**PP_MOE, **PP_TINY)).init(
        jax.random.PRNGKey(0)))
    pre_tree = _np(JaxGPTModel(_jcfg(**PRETRAIN_WIDTH)).init(
        jax.random.PRNGKey(0)))
    tp_layer = JaxMoEMLP(8, 16, num_experts=4, top_k=2, capacity_factor=16.0)
    inp = {
        "layer": layer_inp,
        "gpt": {"tree": gpt_tree, "data": (toks, tgts),
                "cases": {n: dict(base, **c) for n, c in GPT_CASES.items()}},
        "zero": {"cfg": dict(base, moe_expert_axis="data",
                             compute_dtype=torch.bfloat16)},
        "engine": {"cfg": dict(serve_cfg, moe_expert_axis="data"),
                   "tree": serve_tree, "scfg": SCFG,
                   "requests": _requests()},
        "ep_tp": {"tree": _np(tp_layer.init(jax.random.PRNGKey(11))),
                  "x": np.asarray(jax.random.normal(jax.random.PRNGKey(12),
                                                    (8, 8))),
                  "gpt_cfg": dict(base, moe_expert_axis="data",
                                  axis="model")},
        "pretrain": {"argv": PRETRAIN_ARGV, "tree": pre_tree,
                     "save_dir": str(tmp / "ckpt")},
        "ep_pp": {"cfg": dict(PP_TINY, **FP32, **PP_MOE,
                              moe_expert_axis="data", pipeline_axis="pipe"),
                  "tree": pp_tree, "data": (ptoks, np.roll(ptoks, -1, -1)),
                  "M": 2},
    }
    join = start_ranks(moe_cases, WORLD, tmp, inp, deadline=300.0)
    joined = []

    def results():
        if not joined:
            joined.append(join())
        return joined[0]

    return {"inp": inp, "jgpt": jgpt, "results": results}


def _mesh4(names=("data",)):
    return Mesh(np.array(jax.devices()[:4]), names)


def _shard_map_layer(layer, params, x, out_fn):
    mesh = _mesh4()
    specs = layer.specs()
    sharded = jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda v: isinstance(v, P)))
    return jax.jit(jax.shard_map(
        lambda p, xs: out_fn(layer.apply_expert_parallel(p, xs)),
        mesh=mesh, in_specs=(specs, P("data")), out_specs=P(),
        check_vma=False))(sharded, x)


# ---------------------------------------------------------------------------
# the layer (tests/test_moe.py's expert-parallel cases)
# ---------------------------------------------------------------------------


def test_expert_parallel_matches_serial(setup):
    c = setup["inp"]["layer"]["ep_values"]
    layer = _layer(8, 2, 16.0)
    ref, ref_aux = layer.apply(jax.tree.map(jnp.asarray, c["tree"]),
                               jnp.asarray(c["x"]))
    ref = np.asarray(ref)
    for r, res in enumerate(setup["results"]()):
        n = ref.shape[0] // WORLD
        np.testing.assert_allclose(res["ep_values"]["out"],
                                   ref[r * n:(r + 1) * n], atol=2e-5)
        np.testing.assert_allclose(res["ep_values"]["lb"],
                                   float(ref_aux["load_balancing_loss"]),
                                   rtol=1e-5)


def test_expert_parallel_gradients_match_serial(setup):
    c = setup["inp"]["layer"]["ep_grads"]
    layer = _layer(4, 1, 16.0)
    ref = _np(jax.grad(_layer_loss(layer))(
        jax.tree.map(jnp.asarray, c["tree"]), jnp.asarray(c["x"])))
    specs = _tuples(_layer(4, 1, 16.0, "data").specs())
    for res in setup["results"]():
        coords = res["coords"]["dp4"]
        _held(res["ep_grads"], _cut(ref, specs, coords, ("data",)),
              atol=1e-4)


def test_validation_errors(setup):
    """top_k out of range raises at construction (no ranks); experts that
    do not divide by the axis raise on the ranks (at construction in the
    port: the layer is built at its local shapes)."""
    from apex_tpu_torch.transformer.moe import MoEMLP

    with pytest.raises(ValueError, match="top_k"):
        MoEMLP(8, 16, num_experts=2, top_k=3)
    for res in setup["results"]():
        assert res["divide"] is not None and "divide" in res["divide"]


def test_capacity_divergence_under_congestion_is_bounded(setup):
    """Per-rank capacity under congestion (``tests/test_moe.py:294``): the
    slot arithmetic and the kept counts within the reference's bound of
    the serial layer's."""
    import math

    c = setup["inp"]["layer"]["congestion"]
    E, ep, N, cf, k = 4, WORLD, 64, 0.5, 1
    out_s, _ = _layer(E, k, cf).apply(jax.tree.map(jnp.asarray, c["tree"]),
                                      jnp.asarray(c["x"]))
    res = setup["results"]()
    c_local, c_global = (res[0]["congestion"]["c_local"],
                         res[0]["congestion"]["c_global"])
    assert c_global == max(1, math.ceil(k * N * cf / E))
    assert c_local == max(1, math.ceil(k * (N // ep) * cf / E))
    assert c_global <= ep * c_local <= c_global + ep
    out_p = np.concatenate([r["congestion"]["out"] for r in res])
    kept_s = int(np.sum(np.any(np.asarray(out_s) != 0, axis=-1)))
    kept_p = int(np.sum(np.any(out_p != 0, axis=-1)))
    assert kept_s <= E * c_global and kept_p <= E * ep * c_local
    assert kept_s < N and kept_p < N
    assert abs(kept_s - kept_p) <= E * ep


def test_dropped_fraction_expert_parallel_matches_jax(setup):
    """The EP dropped fraction (the pmean of per-rank fractions) equals the
    JAX ``shard_map`` run's and congests as the serial layer does."""
    c = setup["inp"]["layer"]["dropped"]
    params = jax.tree.map(jnp.asarray, c["tree"])
    _, aux_s = _layer(4, 2, 1.0).apply(params, jnp.asarray(c["x"]))
    frac_j = float(_shard_map_layer(_layer(4, 2, 1.0, "data"), params,
                                    jnp.asarray(c["x"]),
                                    lambda o: o[1]["dropped_fraction"]))
    for res in setup["results"]():
        assert 0.0 < res["dropped"] < 1.0
        np.testing.assert_allclose(res["dropped"], frac_j, rtol=1e-6)
    assert 0.0 < float(aux_s["dropped_fraction"]) < 1.0


def test_capacity_overflow_drop_determinism(setup):
    """Two congested EP runs are bit for bit equal, some rows (not all)
    are dropped to exact zeros, and the values equal the JAX
    ``shard_map`` run's."""
    c = setup["inp"]["layer"]["determinism"]
    mesh = _mesh4()
    layer = _layer(4, 1, 0.5, "data")
    specs = layer.specs()
    sharded = jax.device_put(jax.tree.map(jnp.asarray, c["tree"]),
                             jax.tree.map(lambda s: NamedSharding(mesh, s),
                                          specs,
                                          is_leaf=lambda v: isinstance(v, P)))
    ref, _ = jax.jit(jax.shard_map(
        layer.apply_expert_parallel, mesh=mesh,
        in_specs=(specs, P("data")), out_specs=(P("data"), P()),
        check_vma=False))(sharded, jnp.asarray(c["x"]))
    res = setup["results"]()
    outs = [np.concatenate([r["determinism"]["out"][i] for r in res])
            for i in range(2)]
    assert np.array_equal(outs[0], outs[1])
    for r in res:
        d = r["determinism"]["dropped"]
        assert d[0] == d[1] > 0.0
    dropped = np.all(outs[0] == 0.0, axis=-1)
    assert dropped.any() and not dropped.all()
    np.testing.assert_allclose(outs[0], np.asarray(ref), atol=2e-5)


def test_moe_ep_x_tp_matches_serial(setup):
    """EP x TP on dp 2 x tp 2: values and grads (the spec-aware reduction
    over ``data``) against the serial layer."""
    t = setup["inp"]["ep_tp"]
    serial = JaxMoEMLP(8, 16, num_experts=4, top_k=2, capacity_factor=16.0)
    params, x = jax.tree.map(jnp.asarray, t["tree"]), jnp.asarray(t["x"])
    ref, ref_aux = serial.apply(params, x)
    ref_g = _np(jax.grad(_layer_loss(serial))(params, x))
    specs = _tuples(JaxMoEMLP(8, 16, num_experts=4, expert_axis="data",
                              tp_axis="model").specs())
    for res in setup["results"]():
        coords = res["coords"]["dp2_tp2"]
        r, n = coords["data"]
        b = x.shape[0] // n
        got = res["ep_tp_layer"]
        np.testing.assert_allclose(got["out"],
                                   np.asarray(ref)[r * b:(r + 1) * b],
                                   atol=2e-5)
        np.testing.assert_allclose(got["lb"],
                                   float(ref_aux["load_balancing_loss"]),
                                   rtol=1e-5)
        _held(got["grads"], _cut(ref_g, specs, coords, ("data", "model")),
              atol=1e-4)


# ---------------------------------------------------------------------------
# GPT (tests/test_moe_parallel.py, tests/test_gpt_moe.py)
# ---------------------------------------------------------------------------


def _gpt_serial(setup):
    g = setup["inp"]["gpt"]
    params = jax.tree.map(jnp.asarray, g["tree"])
    toks, tgts = (jnp.asarray(a) for a in g["data"])
    jgpt = setup["jgpt"]
    loss, grads = jax.value_and_grad(lambda p: jgpt.loss(p, toks, tgts))(
        params)
    return float(loss), _np(grads)


def _gpt_specs(**over):
    return _tuples(JaxGPTModel(_jcfg(**dict(TINY, **over), **MOE)).specs())


@pytest.mark.parametrize("name", ["remat", "no_remat"])
def test_ep_matches_serial_values_and_grads(setup, name):
    """Serial == expert parallel, loss and every grad (the local-mean loss
    and the spec-aware reduction), with and without checkpointing (the
    JAX test's scan and unrolled drives)."""
    ref, ref_g = _gpt_serial(setup)
    specs = _gpt_specs(moe_expert_axis="data")
    for res in setup["results"]():
        got = res["gpt"][name]
        np.testing.assert_allclose(got["loss"], ref, rtol=2e-5)
        _held(got["grads"], _cut(ref_g, specs, res["coords"]["dp4"],
                                 ("data",)), atol=2e-4)


def _jax_ep_loss_and_grads(setup, wire):
    """The JAX recipe on a 4-device data mesh (``tests/test_moe_parallel.py
    :52-68``): the local-mean loss, the spec-aware reduction."""
    from apex_tpu.parallel import collectives as jcc
    from apex_tpu.parallel.distributed import allreduce_gradients_by_spec

    g = setup["inp"]["gpt"]
    model = JaxGPTModel(_jcfg(moe_expert_axis="data", moe_dispatch_dtype=wire,
                              **MOE, **TINY))
    mesh = _mesh4()
    specs = model.specs()
    sharded = jax.device_put(
        jax.tree.map(jnp.asarray, g["tree"]),
        jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                     is_leaf=lambda v: isinstance(v, P)))

    def fn(p, t, y):
        loss, grads = jax.value_and_grad(lambda q: model.loss(q, t, y))(p)
        grads = allreduce_gradients_by_spec(
            grads, specs, data_axes=("data",), replicated_axes=())
        return jcc.pmean(loss, "data"), grads

    toks, tgts = (jnp.asarray(a) for a in g["data"])
    loss, grads = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(specs, P("data"), P("data")),
        out_specs=(P(), specs), check_vma=False))(sharded, toks, tgts)
    return float(loss), _np(grads)


@pytest.mark.parametrize("wire", ["int8", "e5m2"])
def test_quantized_dispatch_wire_within_tolerance(setup, wire):
    """The 1-byte dispatch wire: the loss within 5e-2 and every grad
    within 0.1 of its leaf's max |exact| of the exact wire, all finite
    (``tests/test_moe_parallel.py:92-115``: int8); e5m2 (a relative step
    of 2**-2, not a step of amax / 127) is held to that bound against the
    JAX package's run on the same wire."""
    ref = None
    if wire == "e5m2":
        ref_loss, ref_g = _jax_ep_loss_and_grads(setup, wire)
        specs = _gpt_specs(moe_expert_axis="data")
    for res in setup["results"]():
        quant = res["gpt"][wire]
        if wire == "e5m2":
            ref = {"loss": ref_loss, "grads": _cut(
                ref_g, specs, res["coords"]["dp4"], ("data",))}
        exact = ref or res["gpt"]["remat"]
        assert abs(quant["loss"] - exact["loss"]) < 5e-2 * max(
            1.0, abs(exact["loss"]))
        for a, b in zip(jax.tree.leaves(quant["grads"]),
                        jax.tree.leaves(exact["grads"])):
            assert np.all(np.isfinite(a))
            scale = max(float(np.max(np.abs(b))), 1e-3)
            assert float(np.max(np.abs(a - b))) < 0.1 * scale


def test_serial_build_ignores_dispatch_dtype():
    """A serial build of an int8-dispatch config runs the exact function."""
    g = JaxGPTModel(_jcfg(**MOE, **TINY))
    tree = _np(g.init(jax.random.PRNGKey(0)))
    toks, tgts = (torch.from_numpy(a[:4]) for a in _batch())
    q = GPTModel(GPTConfig(moe_dispatch_dtype="int8", **FP32, **MOE,
                           **TINY), device="cpu").params_from_numpy(tree)
    plain = GPTModel(GPTConfig(**FP32, **MOE, **TINY),
                     device="cpu").params_from_numpy(tree)
    with torch.no_grad():
        assert float(q.loss(toks, tgts)) == float(plain.loss(toks, tgts))


def test_dispatch_dtype_requires_expert_axis():
    from apex_tpu_torch.transformer.moe import MoEMLP

    with pytest.raises(ValueError, match="dispatch_dtype requires"):
        MoEMLP(8, 16, num_experts=4, dispatch_dtype="int8")


def test_zero_composition_matches_replicated_step(setup):
    """MoE + ZeRO level 2 (``build_zero_train_step(with_aux=True)``, the
    expert leaves' state their local shard) against the replicated
    optimizer after the spec-aware reduction: the same loss (rtol 1e-5),
    the expert leaves exactly (no gather wire touches them), the other
    params within the bf16 gather wire (2e-2); on both sides every leaf
    moved by lr / 2 or more on at least 80% of its elements, so a step
    that skips a leaf fails whatever the tolerances; the replicated step
    against the JAX O2 step on the same cast params: the loss (1e-5), and
    every param within 2.5 lr of JAX's (Adam's first step moves an element
    by about lr whatever its grad, so one whose grad is rounding noise --
    the key bias's, 0 in exact arithmetic, a third of the qkv bias --
    moves by up to lr either way)."""
    g = setup["inp"]["gpt"]
    jgpt = JaxGPTModel(JaxGPTConfig(**MOE, **TINY))  # bf16 compute (O2)
    policy = jamp.get_policy("O2")
    full = jamp.cast_params(jax.tree.map(jnp.asarray, g["tree"]), policy)
    mp = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=1e-2), policy)
    st = mp.init(full)
    toks, tgts = (jnp.asarray(a) for a in g["data"])
    scale = st.scaler.loss_scale
    loss, grads = jax.value_and_grad(
        lambda p: jgpt.loss(p, toks, tgts) * scale)(full)
    new, _, _ = mp.apply_gradients(st, full, grads)
    ref_loss, ref_params = float(loss / scale), _np(new)
    specs = _gpt_specs(moe_expert_axis="data")
    for res in setup["results"]():
        rep, zero = res["zero"]["None"], res["zero"]["2"]
        assert not rep["found_inf"] and not zero["found_inf"]
        np.testing.assert_allclose(zero["loss"], rep["loss"], rtol=1e-5)
        np.testing.assert_allclose(rep["loss"], ref_loss, rtol=1e-5)
        _held(zero["params"], rep["params"], atol=2e-2)
        for (path, r), z, r0 in zip(
                jax.tree_util.tree_flatten_with_path(rep["params"])[0],
                jax.tree.leaves(zero["params"]),
                jax.tree.leaves(rep["params0"])):
            r, z, r0 = (np.asarray(torch.as_tensor(x).float())
                        for x in (r, z, r0))
            name = jax.tree_util.keystr(path)
            if "'moe'" in name and "'router'" not in name:
                np.testing.assert_array_equal(z, r, err_msg=name)
            for after in (r, z):
                assert (np.abs(after - r0) >= 5e-3).mean() >= 0.8, name
        ref = _cut(ref_params, specs, res["coords"]["dp4"], ("data",))
        assert jax.tree.structure(rep["params"]) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(rep["params"]),
                        jax.tree.leaves(ref)):
            assert np.abs(np.asarray(a, np.float32) - b).max() <= 2.5e-2


def test_zero_level3_still_rejects_expert_sharding(setup):
    for res in setup["results"]():
        assert res["zero3"] is not None
        assert "zero_level=3 requires" in res["zero3"]


def test_ep_serving_streams_match_serial(setup):
    """The expert-parallel engine (every data rank routing the same tokens,
    its experts' shares added by one psum) emits the serial engines'
    streams (the port's and the JAX package's) and frees every page."""
    e = setup["inp"]["engine"]
    cfg = dict(e["cfg"], moe_expert_axis=None)
    model = GPTModel(GPTConfig(**cfg), device="cpu").params_from_numpy(
        e["tree"])
    reqs = e["requests"]
    port = Engine(model, ServeConfig(**SCFG), device="cpu").run(
        [Request(prompt=list(p), max_new_tokens=m, request_id=i)
         for i, (p, m) in enumerate(reqs)])
    jm = JaxGPTModel(_jcfg(**dict(TINY, max_seq_len=32, remat=False),
                           **MOE))
    jres = JaxEngine(jm, jax.tree.map(jnp.asarray, e["tree"]),
                     JaxServeConfig(**SCFG)).run(
        [JaxRequest(prompt=list(p), max_new_tokens=m, request_id=i)
         for i, (p, m) in enumerate(reqs)])
    for res in setup["results"]():
        got = res["engine"]
        assert got["used"] == 0
        for rid in port:
            assert got["tokens"][rid] == port[rid].tokens
            assert got["tokens"][rid] == list(map(int, jres[rid].tokens))


def test_ep_engine_requires_mesh():
    from apex_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel()
    try:
        model = GPTModel(GPTConfig(moe_expert_axis="data", **FP32, **MOE,
                                   **dict(TINY, remat=False)), device="cpu")
        with pytest.raises(ValueError, match="needs the mesh"):
            Engine(model, ServeConfig(max_batch=1, max_seq=8, block_size=8),
                   device="cpu")
    finally:
        mesh.destroy_model_parallel()


def test_ep_x_tp_hybrid_matches_serial(setup):
    """GPT with experts over ``data`` and each expert's FFN over ``model``
    (dp 2 x tp 2): loss and grads against the serial model."""
    ref, ref_g = _gpt_serial(setup)
    specs = _gpt_specs(moe_expert_axis="data", axis="model")
    for res in setup["results"]():
        got = res["ep_tp_gpt"]
        np.testing.assert_allclose(got["loss"], ref, rtol=2e-5)
        _held(got["grads"], _cut(ref_g, specs, res["coords"]["dp2_tp2"],
                                 ("data", "model")), atol=3e-4)


def test_pretrain_gpt_moe_dp2_reduces_expert_grads_by_spec(setup):
    """``pretrain_gpt --moe-experts 4 --tp 2`` on 4 ranks (dp 2, the
    experts over ``data``) in O0: the loss is the serial model's on the
    global batch, every reduced grad of the first step is the serial
    grad's shard (2e-4) -- the experts' too: the spec-aware reduction --
    and the expert grads are not the reference example's all-reduce of
    both data ranks' (different) experts. Its checkpoint restores into a
    serial model as the ranks' params gathered."""
    pre = setup["inp"]["pretrain"]
    jm = JaxGPTModel(_jcfg(**PRETRAIN_WIDTH))
    params = jax.tree.map(jnp.asarray, pre["tree"])
    res = setup["results"]()
    batch = res[0]["pretrain"]["batch"]
    assert batch == 4
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 64, (batch, 16))
    tgts = np.roll(toks, -1, axis=-1)
    ref, ref_g = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(toks), jnp.asarray(tgts)))(params)
    ref_g = _np(ref_g)
    specs = _tuples(JaxGPTModel(_jcfg(**dict(
        PRETRAIN_WIDTH, axis="model", moe_expert_axis="data"))).specs())
    model = GPTModel(GPTConfig(**dict(PRETRAIN_WIDTH, **FP32)),
                     device="cpu")
    saved = checkpoint.restore_checkpoint(
        pre["save_dir"], {"params": module_tree(model, device="meta")})
    for r in res:
        got = r["pretrain"]
        coords = r["coords"]["dp2_tp2"]
        assert got["expert_axis"] == "data" and not got["found_inf"]
        np.testing.assert_allclose(got["loss"], float(ref), rtol=2e-5)
        _held(got["grads"], _cut(ref_g, specs, coords, ("data", "model")),
              atol=2e-4)
        # the reference example's reduction: the mean over data of each
        # rank's own experts' grads (each rank's raw grad is dp times its
        # share), here the sum of both ranks' expert blocks
        moe = _cut(ref_g, specs, coords, ("model",))["layers"]["moe"]
        mixed = moe["fc1"]["kernel"][:, :2] + moe["fc1"]["kernel"][:, 2:]
        ours = np.asarray(got["grads"]["layers"]["moe"]["fc1"]["kernel"])
        assert np.abs(ours - mixed).max() > 0.1 * np.abs(mixed).max()
        _held(got["params"], _cut(jax.tree.map(np.asarray, saved["params"]),
                                  specs, coords, ("data", "model")), atol=0)


def test_ep_x_pp_hybrid_matches_serial_microbatched(setup):
    """EP x PP (pp 2 x dp 2): the layer stack on the ring, the experts and
    batch over ``data``, the router losses accumulated per (micro-batch,
    chunk) unit. The reference is the serial model run per micro-batch --
    micro-batch m holding each data rank's m-th rows -- with the losses
    averaged: loss (2e-5) and every grad (3e-4)."""
    p = setup["inp"]["ep_pp"]
    toks, tgts = (jnp.asarray(a) for a in p["data"])
    serial = JaxGPTModel(_jcfg(**PP_MOE, **PP_TINY))
    groups = [np.array([2 * m, 2 * m + 1, 4 + 2 * m, 5 + 2 * m])
              for m in range(p["M"])]

    def ref_loss(q):
        return sum(jnp.mean(serial.apply(q, toks[g], tgts[g]))
                   for g in groups) / p["M"]

    params = jax.tree.map(jnp.asarray, p["tree"])
    ref, ref_g = jax.value_and_grad(ref_loss)(params)
    specs = _pipe_specs(_tuples(JaxGPTModel(_jcfg(
        **PP_MOE, **dict(PP_TINY, moe_expert_axis="data"))).specs()))
    for res in setup["results"]():
        got = res["ep_pp"]
        np.testing.assert_allclose(got["loss"], float(ref), rtol=2e-5)
        _held(got["grads"], _cut(_np(ref_g), specs,
                                 res["coords"]["pp2_dp2"], ("pipe", "data")),
              atol=3e-4)

