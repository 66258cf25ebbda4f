"""Data-parallel gradient reduction of the port
(``apex_tpu_torch.parallel.distributed``) and the examples' data-parallel
branches, on spawned gloo ranks, against the JAX package.

On 4 ranks (``tests/test_ddp_semantics.py``): ``DistributedDataParallel``'s
grads of ``sum(a * b * sum(x))`` against the closed form and the JAX DDP
under ``shard_map`` for the four ``(allreduce_always_fp32,
gradient_predivide_factor)`` cases (1e-5 relative); bf16 grads reduced in
fp32 come back bf16 and exactly ``bf16(259 / 4)``; the parameters
broadcast from rank 0 at construction; micro-batches under ``no_sync``
reduced once; ``Reducer`` over a tree and a module; and
``allreduce_gradients_by_spec`` with a leaf sharded over ``data`` (divided
by the axis size, not summed), exactly.

On 2 ranks, spawned once for the three examples:

- ``examples/simple/distributed_data_parallel``: the 20 losses against the
  JAX example's loop (``DistributedDataParallel.value_and_grad`` under
  ``shard_map`` on a 2-device mesh, FusedSGD(0.05, 0.9)) on the same
  numpy weights and data, 1e-5 relative;
- ``pretrain_gpt``'s DP branch (2 layers, hidden 64, 4 heads, seq 32,
  micro-batch 2 x 2 micro-batches a rank: a global batch of 8; fp32
  compute), O2 against the JAX example's DP step (``:471-514``, a 2-device
  mesh) and O0 and O2 against the port's serial run on the whole batch (4
  micro-batches of 2): losses 1e-5 relative; the first step's reduced
  grads within 1e-5 of each leaf's max |ref| in O0, and within two bf16
  units (2**-6 of the leaf's max) in O2, where each rank rounds its own
  grads to bf16 before the bf16 reduce; the masters after 2 steps as
  ``tests/test_torch_gpt_examples.py`` holds them (at most 0.5% of a
  leaf's elements, or one element of a leaf under 200, further than lr /
  5, none further than 2.5 lr: Adam's first steps move an element by about
  lr whatever the size of its grad, so a grad near 0 rounded the other
  way flips it; against the jitted JAX step, which drops a rounding of
  the bf16 grads (ROADMAP Queue 3, "Facts"), such an element may flip in
  both steps, so there the first bound alone); both ranks' params
  bit-identical;
- the long-context example's ``--dp 2`` (seq 128, hidden 32, 2 layers,
  fp32 compute) against the JAX example's DP step (``:138-153``, cp = 1)
  and the port's serial run at batch 2: losses 1e-5 relative, the first
  step's grads within 2**-6 of each leaf's max.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.parallel import collectives as jcc
from apex_tpu.parallel import mesh as jmesh
from apex_tpu.parallel.distributed import (
    DistributedDataParallel as JaxDDP,
    allreduce_gradients as jallreduce,
    allreduce_gradients_by_spec as jallreduce_by_spec,
)
from apex_tpu.transformer.pipeline_parallel import (
    pipeline_specs,
    pipelined_loss_fn,
)
from apex_tpu_torch.bench import fixed_batch
from apex_tpu_torch.examples.gpt import pretrain_gpt as pg
from apex_tpu_torch.examples.longcontext import train_long_context as lc
from apex_tpu_torch.examples.simple import distributed_data_parallel as simple
from apex_tpu_torch.parallel import mesh
from torch_dp_workers import ddp_cases, examples_dp, run_ranks

COMBOS = [(False, 1.0), (True, 1.0), (False, 2.0), (True, 4.0)]
A = np.arange(1.0, 4.0, dtype=np.float32)
B = np.asarray([2.0, -1.0, 0.5], np.float32)
X = (np.arange(8.0, dtype=np.float32) + 1.0).reshape(8, 1)

PRETRAIN = dict(vocab=64, hidden=64, layers=2, heads=4, seq=32)
LONG = dict(seq=128, hidden=32, layers=2, heads=4, vocab=64)
LR = 1e-3


@pytest.fixture(autouse=True)
def _clean():
    yield
    jmesh.destroy_model_parallel()
    mesh.destroy_model_parallel()


# ---------------------------------------------------------------------------
# DDP semantics, 4 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    return run_ranks(ddp_cases, 4, tmp_path_factory.mktemp("ddp"), A, B, X,
                     COMBOS)


def _jax_ddp_grads(fp32, pre):
    m = jmesh.make_virtual_mesh(4)
    try:
        d = JaxDDP(lambda p, x: jnp.sum(p["a"] * p["b"] * jnp.sum(x)),
                   axes="data", allreduce_always_fp32=fp32,
                   gradient_predivide_factor=pre)
        return jax.jit(jax.shard_map(
            lambda p, x: d.value_and_grad(p, x)[1], mesh=m,
            in_specs=(P(), P("data")), out_specs=P(), check_vma=False))(
            {"a": jnp.asarray(A), "b": jnp.asarray(B)}, jnp.asarray(X))
    finally:
        jmesh.destroy_model_parallel()


@pytest.mark.parametrize("case", range(4), ids=[f"fp32={f}-pre={p}"
                                                for f, p in COMBOS])
def test_grads_match_closed_form(ddp, case):
    mean_sum_x = X.reshape(4, 2).sum(1).mean()
    expect = {"a": B * mean_sum_x, "b": A * mean_sum_x}
    jgrads = _jax_ddp_grads(*COMBOS[case])
    for r in ddp:
        got = r["closed_form"][case]
        for k in ("a", "b"):
            np.testing.assert_allclose(got[k], expect[k], rtol=1e-5)
            np.testing.assert_allclose(got[k], np.asarray(jgrads[k]),
                                       rtol=1e-5)


def test_bf16_grads_reduce_in_fp32_when_asked(ddp):
    exact = np.float32(jnp.bfloat16(259.0 / 4))
    for r in ddp:
        assert r["bf16_dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(r["bf16"], [exact])
    m = jmesh.make_virtual_mesh(4)
    out = jax.jit(jax.shard_map(
        lambda g: jallreduce({"g": g}, "data",
                             allreduce_always_fp32=True)["g"],
        mesh=m, in_specs=P("data"), out_specs=P("data"), check_vma=False))(
        jnp.asarray([256.0, 1.0, 1.0, 1.0], jnp.bfloat16))
    np.testing.assert_array_equal(np.asarray(out, np.float32),
                                  np.concatenate([r["bf16"] for r in ddp]))


def test_ddp_broadcast_no_sync_and_reducer(ddp):
    per_rank = X.reshape(4, 2)
    for r in ddp:
        np.testing.assert_array_equal(r["broadcast"], np.zeros(3))
        np.testing.assert_array_equal(r["reducer_tree"]["w"], np.full(3, 2.5))
        np.testing.assert_allclose(r["reducer_module"],
                                   B * per_rank.sum(1).mean(), rtol=1e-6)
        # the whole rows' grads, averaged: one reduction after no_sync
        np.testing.assert_allclose(r["accumulated"],
                                   B * per_rank.sum(1).mean(), rtol=1e-6)
        np.testing.assert_array_equal(r["pmean_bf16"], [2.5])
    for i, r in enumerate(ddp):  # no_sync's backward stayed local
        np.testing.assert_allclose(r["no_sync_local"], B * per_rank[i, 0],
                                   rtol=1e-6)


def test_allreduce_gradients_by_spec_sharded_leaf(ddp):
    """A leaf whose spec names ``data`` is this rank's own slice: divided
    by the axis size, not summed; a replicated one is averaged; an axis
    of size 1 (``model``) in a spec changes nothing. As the JAX
    function's, which runs on the same per-rank grads."""
    m = jmesh.make_virtual_mesh(4)
    specs = {"rep": P(), "sharded": P("data"), "tp": P(None, "model")}
    grads = {k: jnp.arange(1.0, 5.0).repeat(2) for k in specs}
    jout = jax.jit(jax.shard_map(
        lambda g: jallreduce_by_spec(g, specs), mesh=m,
        in_specs=({k: P("data") for k in specs},),
        out_specs={k: P("data") for k in specs}, check_vma=False))(grads)
    for k in specs:
        np.testing.assert_array_equal(
            np.concatenate([r["by_spec"][k] for r in ddp]),
            np.asarray(jout[k]))
    for i, r in enumerate(ddp):
        np.testing.assert_array_equal(r["by_spec"]["rep"], [2.5, 2.5])
        np.testing.assert_array_equal(r["by_spec"]["sharded"],
                                      np.full(2, (i + 1) / 4))
        np.testing.assert_array_equal(r["by_spec_inputs"],
                                      np.full(2, i + 1.0))


def test_no_fallback_without_a_launcher(monkeypatch):
    """One process: ``initialize_distributed`` is a no-op; a world above
    one without an address raises; ``--dp 2`` and ``--cp 2`` on one rank
    raise, naming the processes to launch."""
    from apex_tpu_torch.parallel import multiproc

    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multiproc.initialize_distributed(device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no coordinator address"):
        multiproc.initialize_distributed(device="cpu")
    with pytest.raises(RuntimeError, match="--dp 2"):
        lc.build(**LONG, batch=2, dp=2, device="cpu")
    with pytest.raises(RuntimeError, match="launch 2 processes"):
        lc.build(**LONG, cp=2, device="cpu")


# ---------------------------------------------------------------------------
# the examples, 2 ranks
# ---------------------------------------------------------------------------


def _jax_simple(inputs, steps=20):
    m = jmesh.make_virtual_mesh(2)

    def loss_fn(p, x, y):
        return jnp.mean(jnp.square(jnp.tanh(x @ p["w1"]) @ p["w2"] - y))

    opt = JaxFusedSGD(lr=0.05, momentum=0.9)
    params = {"w1": jnp.asarray(inputs["w1"]), "w2": jnp.asarray(inputs["w2"])}
    opt_state = opt.init(params)
    d = JaxDDP(loss_fn)

    def sharded_step(params, opt_state, x, y):
        loss, grads = d.value_and_grad(params, x, y)
        updates, opt_state = opt.transform.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, \
            jax.lax.pmean(loss, "data")

    step = jax.jit(jax.shard_map(
        sharded_step, mesh=m, in_specs=(P(), P(), P("data"), P("data")),
        out_specs=(P(), P(), P()), check_vma=False))
    shard = lambda a: jax.device_put(jnp.asarray(a),  # noqa: E731
                                     NamedSharding(m, P("data")))
    x, y = shard(inputs["x"]), shard(inputs["y"])
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(float(loss))
    return losses


def _gpt_cfg(**over):
    return JaxGPTConfig(
        vocab_size=PRETRAIN["vocab"], hidden_size=PRETRAIN["hidden"],
        num_layers=PRETRAIN["layers"],
        num_attention_heads=PRETRAIN["heads"], max_seq_len=PRETRAIN["seq"],
        hidden_dropout=0.0, compute_dtype=jnp.float32, remat=True,
        **dict(dict(axis=None), **over))


def _jax_pretrain_dp(jm, params, batches, level, steps=2):
    """The JAX example's DP step (``pretrain_gpt.py:471-514``, tp = pp = 1)
    on a 2-device mesh: ``(losses, first step's scaled grads, masters)``."""
    m = jmesh.make_virtual_mesh(2)
    mp_opt = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=LR),
                                          jamp.get_policy(level))
    all_specs = jm.specs()
    specs = dict({k: v for k, v in all_specs.items() if k != "layers"},
                 layers=pipeline_specs(all_specs["layers"]))
    rest_specs = {k: v for k, v in all_specs.items() if k != "layers"}
    grad_axes = jmesh.get_gradient_reduction_axes()
    data_spec = P(jmesh.get_data_parallel_axes())
    pipe_loss = pipelined_loss_fn(
        embed=jm.embed, run_layers=lambda lp, h: jm.run_layers(lp, h),
        head_loss=lambda p, h, t: jm.head(p, h, t), num_microbatches=2)

    def sharded_grads(p, toks, tgts, scale):
        rest = {k: v for k, v in p.items() if k != "layers"}
        loss, (rest_g, layer_g) = jax.value_and_grad(
            lambda r, ly: pipe_loss(r, ly, toks, tgts) * scale,
            argnums=(0, 1))(rest, p["layers"])
        rest_g = jallreduce_by_spec(rest_g, rest_specs)
        layer_g = jallreduce(layer_g, grad_axes)
        return jcc.pmean(loss, grad_axes), dict(rest_g, layers=layer_g)

    shard_fn = jax.jit(jax.shard_map(
        sharded_grads, mesh=m, in_specs=(specs, data_spec, data_spec, P()),
        out_specs=(P(), specs), check_vma=False))

    @jax.jit
    def step(params, opt_state, toks, tgts):
        scale = opt_state.scaler.loss_scale
        sl, sg = shard_fn(params, toks, tgts, scale)
        params, opt_state, _ = mp_opt.apply_gradients(opt_state, params, sg)
        return params, opt_state, sl / scale

    opt_state = mp_opt.init(params)
    losses, grads = [], None
    for i in range(steps):
        toks, tgts = (jnp.asarray(t.numpy()) for t in batches[i])
        if i == 0:
            grads = shard_fn(params, toks, tgts,
                             opt_state.scaler.loss_scale)[1]
        params, opt_state, loss = step(params, opt_state, toks, tgts)
        losses.append(float(loss))
    return losses, grads, opt_state.master


def _names(tree, n_layers):
    out = {"embedding.embedding": tree["embedding"]["embedding"],
           "ln_f.scale": tree["ln_f"]["scale"],
           "ln_f.bias": tree["ln_f"]["bias"]}
    if "position" in tree:
        out["position"] = tree["position"]
    for name, sub in tree["layers"].items():
        for leaf, stacked in sub.items():
            for i in range(n_layers):
                out[f"layers.{i}.{name}.{leaf}"] = stacked[i]
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _port_serial(module, build_kw, tree, batches, steps):
    """The port's serial run of ``module.build(**build_kw)`` from ``tree``
    in fp32 compute: losses, the first step's grads, the masters."""
    real = module.GPTConfig
    module.GPTConfig = lambda **c: real(**dict(c, compute_dtype=torch.float32))
    try:
        trainer = module.build(**build_kw, device="cpu")
    finally:
        module.GPTConfig = real
    trainer.load_params_(tree)
    grads = {}
    real_step = trainer.mp_opt.step

    def step(state, model, **kw):
        if not grads:
            grads.update({n: p.grad.float().clone()
                          for n, p in model.named_parameters()})
        return real_step(state, model, **kw)

    trainer.mp_opt.step = step
    losses = [float(trainer.step(*batches[i])[0]) for i in range(steps)]
    masters = {n: m.numpy() for (n, _), m in zip(
        trainer.model.named_parameters(), trainer.opt_state.master)} \
        if trainer.opt_state.master is not None else None
    return losses, {n: g.numpy() for n, g in grads.items()}, masters


def _held(got, ref, share, what):
    assert sorted(got) == sorted(ref), what
    for n in ref:
        tol = share * max(np.abs(ref[n]).max(), 1e-30)
        assert np.abs(got[n] - ref[n]).max() <= tol, (what, n)


def _masters_held(got, ref, what, bulk_only=False):
    for n in ref:
        diff = np.abs(got[n] - ref[n])
        assert np.sum(diff > LR / 5) <= max(1, 5e-3 * diff.size), (what, n)
        assert bulk_only or diff.max() <= 2.5 * LR, (what, n)


@pytest.fixture(scope="module")
def examples(tmp_path_factory):
    simple_inputs = simple.make_inputs(0)
    jm = JaxGPTModel(_gpt_cfg())
    init = jm.init(jax.random.PRNGKey(0))
    trees = {lv: jax.tree.map(lambda a: np.asarray(a, np.float32),
                              jamp.cast_params(init, jamp.get_policy(lv)))
             for lv in ("O0", "O2")}
    lm = JaxGPTModel(JaxGPTConfig(
        vocab_size=LONG["vocab"], hidden_size=LONG["hidden"],
        num_layers=LONG["layers"], num_attention_heads=LONG["heads"],
        max_seq_len=LONG["seq"], hidden_dropout=0.0, axis=None,
        context_axis=jmesh.AXIS_CONTEXT, compute_dtype=jnp.float32,
        remat=True))
    lparams = jamp.cast_params(lm.init(jax.random.PRNGKey(0)),
                               jamp.get_policy("O2"))
    ltree = jax.tree.map(lambda a: np.asarray(a, np.float32), lparams)
    ranks = run_ranks(
        examples_dp, 2, tmp_path_factory.mktemp("examples"), simple_inputs,
        ({lv: (trees[lv], LR) for lv in trees}, PRETRAIN, 2),
        (ltree, LONG, 2))
    return dict(simple_inputs=simple_inputs, jm=jm, trees=trees, lm=lm,
                lparams=lparams, ltree=ltree, ranks=ranks)


def test_simple_example_losses_match_the_jax_example(examples):
    jlosses = _jax_simple(examples["simple_inputs"])
    for r in examples["ranks"]:
        np.testing.assert_allclose(r["simple"], jlosses, rtol=1e-5)
    assert examples["ranks"][0]["simple"] == examples["ranks"][1]["simple"]


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_pretrain_dp_matches_jax_dp_and_the_port_serial(examples, level):
    ranks = [r["pretrain"][level] for r in examples["ranks"]]
    assert ranks[0]["batch"] == 8 and not any(ranks[0]["found"])
    args = pg.parse_args(["--vocab", "64", "--seq", "32", "--device", "cpu"])
    it = pg.batches(args, 8)
    batches = [next(it) for _ in range(2)]
    slosses, sgrads, smasters = _port_serial(
        pg, dict(PRETRAIN, micro_batch=2, num_microbatches=4, lr=LR,
                 opt_level=level), examples["trees"][level], batches, 2)
    grad_share = 1e-5 if level == "O0" else 2 ** -6
    for r in ranks:
        np.testing.assert_allclose(r["losses"], slosses, rtol=1e-5)
        _held(r["grads"], sgrads, grad_share, f"{level} grads vs serial")
        if level == "O2":
            _masters_held(r["masters"], smasters, "masters vs serial")
    for n, p in ranks[0]["params"].items():
        np.testing.assert_array_equal(p, ranks[1]["params"][n], err_msg=n)
    if level == "O2":
        jm = examples["jm"]
        params = jamp.cast_params(jm.init(jax.random.PRNGKey(0)),
                                  jamp.get_policy("O2"))
        try:
            jlosses, jgrads, jmaster = _jax_pretrain_dp(jm, params, batches,
                                                        "O2")
        finally:
            jmesh.destroy_model_parallel()
        for r in ranks:
            np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
            _held(r["grads"], _names(jgrads, 2), 2 ** -6, "grads vs JAX DP")
            _masters_held(r["masters"], _names(jmaster, 2),
                          "masters vs JAX DP", bulk_only=True)


def _jax_long_dp(lm, params, tokens, steps=2):
    """The JAX example's DP step (``train_long_context.py:138-153``) at cp
    = 1, dp = 2: losses and the first step's scaled grads."""
    m = jmesh.make_virtual_mesh(2, context_parallel_size=1)
    mp_opt = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=1e-4),
                                          jamp.get_policy("O2"))
    specs = lm.specs()
    data_spec = P(jmesh.AXIS_DATA, jmesh.AXIS_CONTEXT)
    grad_axes = jmesh.get_gradient_reduction_axes()

    def sharded(p, toks, tgts, scale):
        ls, gs = jax.value_and_grad(
            lambda p: lm.loss(p, toks, tgts) * scale)(p)
        return jcc.pmean(ls, grad_axes), jallreduce_by_spec(gs, specs)

    shard_fn = jax.jit(jax.shard_map(
        sharded, mesh=m, in_specs=(specs, data_spec, data_spec, P()),
        out_specs=(P(), specs), check_vma=False))
    toks = jnp.asarray(tokens)
    tgts = jnp.roll(toks, -1, axis=-1)
    opt_state = mp_opt.init(params)
    losses, grads = [], None
    for i in range(steps):
        ls, gs = shard_fn(params, toks, tgts, opt_state.scaler.loss_scale)
        grads = gs if grads is None else grads
        params, opt_state, _ = mp_opt.apply_gradients(opt_state, params, gs)
        losses.append(float(ls / opt_state.scaler.loss_scale))
    return losses, grads


def test_long_context_dp2_matches_jax_dp_and_the_port_serial(examples):
    ranks = [r["long"] for r in examples["ranks"]]
    tokens = ranks[0]["tokens"]
    np.testing.assert_array_equal(tokens, ranks[1]["tokens"])
    serial = lc.build(**LONG, batch=2, device="cpu")
    toks, tgts = fixed_batch(serial)
    np.testing.assert_array_equal(toks.numpy(), tokens)  # the same rows
    slosses, sgrads, _ = _port_serial(
        lc, dict(LONG, batch=2), examples["ltree"], [(toks, tgts)] * 2, 2)
    try:
        jlosses, jgrads = _jax_long_dp(examples["lm"], examples["lparams"],
                                       tokens)
    finally:
        jmesh.destroy_model_parallel()
    for r in ranks:
        np.testing.assert_allclose(r["losses"], slosses, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
        _held(r["grads"], sgrads, 2 ** -6, "long grads vs serial")
        _held(r["grads"], _names(jgrads, 2), 2 ** -6, "long grads vs JAX")
