"""The port's pipeline parallelism (``apex_tpu_torch.transformer.
pipeline_parallel``, the stage models, ``pretrain_gpt --pp``) on 4 spawned
gloo ranks, against the JAX package on the same seeded inputs and the same
JAX parameter trees (each stage loads its block of the layer stack through
``params_from_numpy``).

The ranks are spawned once for the module (``torch_pp_workers.
pipeline_cases``) and run while the parent computes the JAX side. They run
pp 4, then tp 2 x pp 2, then dp 2 x pp 2 (each data replica the same stage
pair) for the pp 2 cases, mirroring ``tests/test_pipeline_parallel.py``:

- the autograd ring (``pipelined_loss_fn``) at (pp, vpp) = (2, 1), (4, 1),
  (2, 2), pp 4 x vpp 2 at 8 layers, and tp 2 x pp 2: the loss against
  ``jax.value_and_grad`` of the serial JAX model (rtol 1e-5), every grad
  leaf of every rank (its stage's block of the interleaved layer stack,
  its model shard, the non-layer grads summed over the pipe axis) against
  the serial grads (rtol / atol 2e-4);
- the sharded head: the rows the head sees on each stage total the batch
  once (in place of the reference's XLA cost analysis); the masked
  replicated head (6 rows over pp 4) against the serial model on those
  rows; a stage built from a seed holds the serial model's layers;
- the plan executor (``schedule_grads_fn``) for gpipe, 1f1b and
  zero-bubble, the same way, and its ``scale`` seeding loss and grads;
- the O2 step with ``MeshGradScaler`` (bf16 compute): the loss against
  the serial JAX loss run eagerly and the jitted JAX pipelined loss
  (rtol 2e-5), no overflow, the scale kept, the params moved;
- ``pretrain_gpt --pp 2`` (dp 2 x pp 2, O2 policy, fp32 compute, 2 steps)
  against the JAX example's pipelined step (``examples/gpt/
  pretrain_gpt.py:471-514``): losses rtol 2e-5, step 1's reduced grads
  (bf16) within 2**-6 of each leaf's max |ref| (the TP example's O2
  limit, ``tests/test_torch_tp_models.py``), ``--pp-schedule zerobubble``
  the same; ``--zero`` and both against ``--pp 2`` (losses, and params
  by the masters rule of the TP tests); the ``--save-dir`` checkpoint of an
  interleaved run holding the whole stack in the JAX example's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.parallel import collectives as jcc
from apex_tpu.parallel import mesh as jmesh
from apex_tpu.parallel.distributed import (
    allreduce_gradients as jallreduce,
    allreduce_gradients_by_spec as jallreduce_by_spec,
)
from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu.transformer.pipeline_parallel import (
    forward_backward_no_pipelining as jfbnp,
    pipeline_specs,
    pipelined_loss_fn as jpipelined_loss_fn,
)
from apex_tpu.transformer.pipeline_parallel.schedules import (
    interleave_stack as jinterleave,
)
from apex_tpu_torch import checkpoint
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.parallel import mesh
from apex_tpu_torch.transformer import pipeline_parallel as ppl
from apex_tpu_torch.transformer import tensor_parallel as tp
from torch_dp_workers import start_ranks
from torch_pp_workers import hybrid_zero_cases, pipeline_cases

WORLD = 4
TINY = dict(vocab_size=64, hidden_size=32, num_layers=4,
            num_attention_heads=4, max_seq_len=16, hidden_dropout=0.0,
            remat=False)
PRETRAIN = dict(vocab=64, hidden=64, layers=4, heads=4, seq=32, lr=1e-3)
PRE_FLAGS = ["--pp", "2", "--micro-batch", "2", "--num-microbatches", "2"]
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _tuples(jspecs):
    return jax.tree.map(tuple, jspecs, is_leaf=lambda x: isinstance(x, P))


def _jcfg(**over):
    return JaxGPTConfig(**dict(dict(TINY, axis=None,
                                    compute_dtype=jnp.float32), **over))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    j4, j8 = JaxGPTModel(_jcfg()), JaxGPTModel(_jcfg(num_layers=8))
    p4 = jax.jit(j4.init)(jax.random.PRNGKey(0))
    p8 = jax.jit(j8.init)(jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 64)
    tgt = jnp.roll(toks, -1, axis=-1)
    o2 = jamp.cast_params(p4, jamp.get_policy("O2"))
    jpre = JaxGPTModel(JaxGPTConfig(
        vocab_size=64, hidden_size=64, num_layers=4, num_attention_heads=4,
        max_seq_len=32, hidden_dropout=0.0, compute_dtype=jnp.float32,
        remat=True, axis=None))
    pre_params = jamp.cast_params(jax.jit(jpre.init)(jax.random.PRNGKey(0)),
                                  jamp.get_policy("O2"))
    save_dir = str(tmp / "ckpt")
    inp = {
        "tiny": dict(TINY, compute_dtype=torch.float32),
        "tree4": _np(p4), "tree8": _np(p8), "tree4_o2": _np(o2),
        "data": (np.asarray(toks), np.asarray(tgt)),
        "pretrain": {
            "width": PRETRAIN, "tree": _np(pre_params), "steps": 2,
            "runs": {"1f1b": PRE_FLAGS,
                     "zerobubble": PRE_FLAGS + ["--pp-schedule",
                                                "zerobubble"],
                     "zero": PRE_FLAGS + ["--zero"],
                     "zero_zerobubble": PRE_FLAGS + [
                         "--zero", "--pp-schedule", "zerobubble"]},
            "save_argv": ["--device", "cpu", "--vocab", "64", "--hidden",
                          "32", "--layers", "4", "--heads", "4", "--seq",
                          "16", "--steps", "1", "--save-every", "1",
                          "--save-dir", save_dir, "--pp", "2",
                          "--pp-schedule", "interleaved"]},
    }
    join = start_ranks(pipeline_cases, WORLD, tmp, inp, deadline=240.0)
    joined = []

    def results():
        if not joined:
            joined.append(join())
        return joined[0]

    serial = {}

    def serial_of(layers, rows=8):
        """``jax.value_and_grad`` of the serial JAX loss (jitted: fp32) on
        the first ``rows`` rows."""
        if (layers, rows) not in serial:
            jm, params = (j4, p4) if layers == 4 else (j8, p8)
            v, g = jax.jit(jax.value_and_grad(jm.loss))(
                params, toks[:rows], tgt[:rows])
            serial[layers, rows] = (float(v), _np(g))
        return serial[layers, rows]

    return {"inp": inp, "j4": j4, "p4": p4, "toks": toks, "tgt": tgt,
            "o2": o2, "jpre": jpre, "pre_params": pre_params,
            "save_dir": save_dir, "serial": serial_of, "results": results}


def _stage_block(grads, pipe, pp, vpp, specs=None, tp_rank=None):
    """The serial grads as one rank holds them: its stage's block of the
    interleaved layer stack (and its model shard under ``specs``)."""
    layers = grads["layers"]
    if vpp > 1:
        layers = jinterleave(layers, pp, vpp)
    n = jax.tree.leaves(layers)[0].shape[0] // pp
    tree = dict(grads, layers=jax.tree.map(
        lambda x: np.asarray(x)[pipe * n:(pipe + 1) * n], layers))
    if specs is not None:
        tree = tp.shard_params(tree, specs, tp_rank, 2)
    return tree


def _held(got, ref, msg, **tol):
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   err_msg=f"{msg} {jax.tree_util.keystr(path)}",
                                   **(tol or GRAD))


def _check_case(ranks, key, case, loss, grads, pp, vpp, specs=None):
    for r, res in enumerate(ranks):
        coords = res[key]["coords"]
        got = res[key][case]
        np.testing.assert_allclose(got["loss"], loss, **LOSS)
        _held(got["grads"], _stage_block(grads, coords[0], pp, vpp, specs,
                                         coords[3]), f"rank {r} {case}")


@pytest.mark.parametrize("pp,vpp", [(2, 1), (4, 1), (2, 2)])
def test_pipeline_matches_serial(setup, pp, vpp):
    loss, grads = setup["serial"](4)
    key, case = (("pp4", "ring") if pp == 4 else ("pp2", f"ring_vpp{vpp}"))
    _check_case(setup["results"](), key, case, loss, grads, pp, vpp)


def test_pipeline_with_tensor_parallel(setup):
    """tp 2 x pp 2 (the gpt_scaling_test.py hybrids): loss and every local
    grad shard."""
    loss, grads = setup["serial"](4)
    specs = _tuples(JaxGPTModel(_jcfg(axis="model")).specs())
    _check_case(setup["results"](), "tp2pp2", "ring", loss, grads, 2, 1,
                specs)


def test_deep_interleaved_pipeline_matches_serial(setup):
    """pp 4 x vpp 2 at 8 layers (the BASELINE config-5 shape at test
    scale)."""
    loss, grads = setup["serial"](8)
    _check_case(setup["results"](), "pp4", "deep", loss, grads, 4, 2)


def test_sharded_head_rows_total_the_batch(setup):
    """The pipe-sharded head projects 8 / 4 rows a stage: the batch once
    over the ring, as the serial head (the reference's cost-analysis test,
    ``tests/test_pipeline_parallel.py:463``, counted in rows)."""
    rows = [r["pp4"]["head_rows"] for r in setup["results"]()]
    assert rows == [[2]] * 4
    assert sum(sum(r) for r in rows) == 8


def test_masked_head_matches_serial(setup):
    """6 rows over 4 stages (2 micro-batches of 3): the batch does not
    divide by S, so the last stage projects the whole batch and the other
    stages' head losses are masked to zero (``schedules.py:652-681``):
    loss and grads against the serial model on those 6 rows."""
    loss, grads = setup["serial"](4, 6)
    ranks = setup["results"]()
    _check_case(ranks, "pp4", "masked", loss, grads, 4, 1)
    assert [r["pp4"]["masked_rows"] for r in ranks] == [[6]] * 4


def test_stage_draws_the_serial_layers_from_its_seed(setup):
    """A stage built from a seed (pp 4 x vpp 2, 8 layers) holds exactly
    the serial model's layers from that seed, and the same embedding,
    position table and final LN: the layers it does not hold only advance
    the generator."""
    for r, res in enumerate(setup["results"]()):
        diffs = res["pp4"]["seeded"]
        assert len(diffs) == 4 + 2 * 12 and "position" in diffs
        assert max(diffs.values()) == 0.0, (r, diffs)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "zero-bubble"])
def test_plan_executor_matches_serial(setup, schedule):
    loss, grads = setup["serial"](4)
    _check_case(setup["results"](), "pp2", schedule, loss, grads, 2, 1)


def test_plan_executor_loss_scale_seeds_grads(setup):
    for res in setup["results"]():
        one, four = res["pp2"]["scales"]
        np.testing.assert_allclose(four["loss"], 4.0 * one["loss"],
                                   rtol=1e-6)
        for a, b in zip(jax.tree.leaves(four["grads"]),
                        jax.tree.leaves(one["grads"])):
            np.testing.assert_allclose(a, 4.0 * b, rtol=1e-5, atol=1e-6)


def test_pipeline_o2_with_mesh_grad_scaler(setup):
    """bf16 O2: the loss against the serial O2 loss run eagerly (not
    jitted: jit drops a bf16 rounding in the embedding) and the jitted
    JAX pipelined loss (2 stages, 4 micro-batches), the scaler on its
    clean-step schedule, the params moved."""
    cfg = _jcfg(compute_dtype=jnp.bfloat16)
    jm = JaxGPTModel(cfg)
    params, toks, tgt = setup["o2"], setup["toks"], setup["tgt"]
    serial = float(jm.loss(params, toks, tgt))
    m = jmesh.make_virtual_mesh(2, pipeline_model_parallel_size=2)
    try:
        specs = jm.specs()
        all_specs = dict({k: v for k, v in specs.items() if k != "layers"},
                         layers=pipeline_specs(specs["layers"]))
        loss_fn = jpipelined_loss_fn(
            embed=jm.embed, run_layers=lambda lp, h: jm.run_layers(lp, h),
            head_loss=lambda p, h, t: jm.head(p, h, t), num_microbatches=4)
        fn = jax.jit(jax.shard_map(
            lambda p, a, b: loss_fn(
                {k: v for k, v in p.items() if k != "layers"}, p["layers"],
                a, b),
            mesh=m, in_specs=(all_specs, P(), P()), out_specs=P(),
            check_vma=False))
        piped = float(fn(jtp.shard_params(params, all_specs, m), toks, tgt))
    finally:
        jmesh.destroy_model_parallel()
    for res in setup["results"]():
        got = res["pp2"]["o2"]
        np.testing.assert_allclose(got["loss"], serial, rtol=2e-5)
        np.testing.assert_allclose(got["loss"], piped, rtol=2e-5)
        assert not got["found_inf"] and got["scale"] == 2.0 ** 16
        assert got["moved"] > 0


def test_no_pipelining_grad_accumulation_matches_full_batch(setup):
    model = GPTModel(GPTConfig(**setup["inp"]["tiny"]), device="cpu")
    model.params_from_numpy(setup["inp"]["tree4"])
    toks, tgt = (torch.from_numpy(np.array(a)) for a in setup["inp"]["data"])
    params = list(model.parameters())
    loss, grads = ppl.get_forward_backward_func(1)(
        model.loss, params, toks, tgt, 4)
    jloss, jgrads = jfbnp(lambda p, b, t: setup["j4"].loss(p, b, t),
                          setup["p4"], setup["toks"], setup["tgt"], 4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    from apex_tpu_torch._params import module_tree

    _held(module_tree(model, grads), _np(jgrads), "no pipelining",
          rtol=1e-5, atol=1e-6)


def _jax_pretrain_pp(jm, params, batches, steps=2):
    """The JAX example's dp x pp step (``pretrain_gpt.py:471-514``) at
    dp 2 x pp 2, 2 micro-batches: ``(losses, step 1's reduced scaled
    grads)``."""
    m = jmesh.make_virtual_mesh(4, pipeline_model_parallel_size=2)
    mp_opt = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=PRETRAIN["lr"]),
                                          jamp.get_policy("O2"))
    all_specs = jm.specs()
    specs = dict({k: v for k, v in all_specs.items() if k != "layers"},
                 layers=pipeline_specs(all_specs["layers"]))
    rest_specs = {k: v for k, v in all_specs.items() if k != "layers"}
    grad_axes = jmesh.get_gradient_reduction_axes()
    data_spec = P(jmesh.get_data_parallel_axes())
    pipe_loss = jpipelined_loss_fn(
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
        return params, opt_state, sl / scale, sg

    params = jtp.shard_params(params, specs, m)
    opt_state = mp_opt.init(params)
    losses, grads = [], None
    for i in range(steps):
        toks, tgts = (jnp.asarray(t.numpy()) for t in batches[i])
        params, opt_state, loss, sg = step(params, opt_state, toks, tgts)
        if i == 0:
            grads = _np(sg)
        losses.append(float(loss))
    return losses, grads


def _share_held(got, ref, share, what):
    for a, b, path in zip(jax.tree.leaves(got), jax.tree.leaves(ref),
                          jax.tree_util.tree_flatten_with_path(ref)[0]):
        tol = share * max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= tol, (what, str(path[0]))


def _params_held(got, ref, what):
    """Params after Adam steps from grads that round differently: Adam
    moves an element by about lr whatever its grad, so a near-zero grad
    rounded the other way flips a step (``tests/test_torch_tp_models.py``'s
    masters rule): at most 0.5% of a leaf's elements (one of a small leaf)
    further apart than lr / 5, none further than 2.5 lr a step."""
    lr = PRETRAIN["lr"]
    for a, b, path in zip(jax.tree.leaves(got), jax.tree.leaves(ref),
                          jax.tree_util.tree_flatten_with_path(ref)[0]):
        diff = np.abs(np.asarray(a) - np.asarray(b))
        assert np.sum(diff > lr / 5) <= max(1, 5e-3 * diff.size), (
            what, str(path[0]))
        assert diff.max() <= 2 * 2.5 * lr, (what, str(path[0]))


def test_pretrain_pp2_matches_the_jax_example(setup):
    """``pretrain_gpt --pp 2`` on dp 2 x pp 2 against the JAX example's
    pipelined step on the same mesh and batches; zerobubble, ZeRO-2 and
    both against it. Each rank holds its stage's block."""
    from apex_tpu_torch.examples.gpt import pretrain_gpt as pg

    args = pg.parse_args(["--vocab", "64", "--seq", "32", "--device", "cpu"])
    it = pg.batches(args, 8)
    batches = [next(it) for _ in range(2)]
    try:
        jlosses, jgrads = _jax_pretrain_pp(setup["jpre"],
                                           setup["pre_params"], batches)
    finally:
        jmesh.destroy_model_parallel()
    ranks = setup["results"]()
    for r, res in enumerate(ranks):
        pipe = res["pp2"]["coords"][0]
        base = res["pretrain"]["1f1b"]
        assert base["batch"] == 8 and not any(base["found"])
        np.testing.assert_allclose(base["losses"], jlosses, rtol=2e-5)
        _share_held(base["grads"], _stage_block(jgrads, pipe, 2, 1),
                    2 ** -6, f"rank {r} grads vs the JAX example")
        zb = res["pretrain"]["zerobubble"]
        np.testing.assert_allclose(zb["losses"], jlosses, rtol=2e-5)
        _share_held(zb["grads"], _stage_block(jgrads, pipe, 2, 1), 2 ** -6,
                    f"rank {r} zerobubble grads vs the JAX example")
        for name in ("zerobubble", "zero", "zero_zerobubble"):
            other = res["pretrain"][name]
            np.testing.assert_allclose(other["losses"], base["losses"],
                                       rtol=2e-5, err_msg=name)
            _params_held(other["params"], base["params"],
                         f"rank {r} {name} params vs 1f1b")
    # the replicated leaves equal on both stages, all leaves on both
    # data replicas (ranks 0, 1 are stage 0; 2, 3 stage 1)
    got = [res["pretrain"]["1f1b"]["params"] for res in ranks]
    for a, b in ((0, 2), (1, 3)):
        for leaf in ("ln_f", "position", "embedding"):
            _held(got[a][leaf], got[b][leaf], leaf, rtol=0, atol=0)
    for a, b in ((0, 1), (2, 3)):
        _held(got[a], got[b], "data replicas", rtol=0, atol=0)


def test_pretrain_pp_checkpoint_holds_the_interleaved_stack(setup):
    """``--pp 2 --pp-schedule interleaved --save-dir``: the file holds the
    whole layer stack in the interleaved order the JAX example writes
    (``pretrain_gpt.py:430-439``), which a serial port model reads back
    through ``deinterleave_stack``."""
    setup["results"]()
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=4,
                    num_attention_heads=4, max_seq_len=16,
                    hidden_dropout=0.0)
    from apex_tpu_torch._params import module_tree

    serial = GPTModel(cfg, device="cpu", seed=0)
    fresh = module_tree(serial)
    state = checkpoint.restore_checkpoint(
        setup["save_dir"], {"params": module_tree(serial, device="meta")})
    layers = state["params"]["layers"]
    assert checkpoint.latest_step(setup["save_dir"]) == 1
    # a seed's stage models hold the serial model's layers; one step moves
    # each by about lr, so the file's order is the interleaved one
    back = ppl.schedules.deinterleave_stack(layers, 2, 2)
    moved = np.abs(back["qkv"]["kernel"].float().numpy()
                   - fresh["layers"]["qkv"]["kernel"].numpy()).max()
    swapped = np.abs(layers["qkv"]["kernel"].float().numpy()
                     - fresh["layers"]["qkv"]["kernel"].numpy()).max()
    assert moved < 5e-3 < swapped


def test_pipeline_surface_checks():
    """One process: the reference's aux checks raise, and the MoE aux path
    runs: a stage's aux summed over the live ticks over M joins the loss
    (head mean 1 + 24 / 2), and ``prepare_pipelined_model(with_aux=True)``
    gives an MoE model's serial loss (each micro-batch's aux folded into
    its tokens, the mean over micro-batches), as does the default (the
    model's own), where ``with_aux=False`` refuses to drop the router
    losses; the traced timelines (item 21)
    raise; plan_schedule's errors."""
    mesh.initialize_model_parallel()
    try:
        h = torch.ones(4, 2, 3)
        for run, aux_to_loss, err in (
                (lambda c, x: (x, None), lambda a: a, ValueError),
                (lambda c, x: (x, {"z": x.sum()}), None, ValueError),
                (lambda c, x: (x, {"z": x.sum()}), lambda a: a["z"],
                 None)):
            fn = ppl.pipelined_loss_fn(
                embed=lambda b: b, run_layers=run,
                head_loss=lambda x, t: x.mean(-1), num_microbatches=2,
                aux_to_loss=aux_to_loss)
            if err is None:
                assert float(fn([], h, None)) == 13.0
                continue
            with pytest.raises(err):
                fn([], h, None)
        with pytest.raises(NotImplementedError, match="item 21"):
            ppl.traced_pipeline_timeline()
        with pytest.raises(NotImplementedError, match="item 21"):
            ppl.traced_schedule_timeline()
        moe = GPTModel(GPTConfig(**dict(
            TINY, num_layers=2, moe_num_experts=4, moe_top_k=1,
            moe_capacity_factor=16.0, moe_aux_loss_weight=0.5,
            compute_dtype=torch.float32)), device="cpu")
        toks = torch.randint(0, 64, (4, 16),
                             generator=torch.Generator().manual_seed(1))
        tgts = toks.roll(-1, dims=-1)
        _, layers, pipe_loss = ppl.prepare_pipelined_model(
            moe, num_microbatches=2, with_aux=True)
        with torch.no_grad():
            ref = (moe.loss(toks[:2], tgts[:2])
                   + moe.loss(toks[2:], tgts[2:])) / 2
            got = pipe_loss(layers, toks, tgts)
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
        _, layers, pipe_loss = ppl.prepare_pipelined_model(
            moe, num_microbatches=2)
        with torch.no_grad():
            torch.testing.assert_close(pipe_loss(layers, toks, tgts), ref,
                                       rtol=1e-6, atol=0)
        _, layers, pipe_loss = ppl.prepare_pipelined_model(
            moe, num_microbatches=2, with_aux=False)
        with pytest.raises(ValueError, match="return_aux"):
            pipe_loss(layers, toks, tgts)
        with pytest.raises(ValueError, match="pipeline_parallel"):
            GPTModel(GPTConfig(**dict(TINY, pipeline_axis="pipe")),
                     device="cpu").loss(torch.zeros(2, 4).long(),
                                        torch.zeros(2, 4).long())
    finally:
        mesh.destroy_model_parallel()
    with pytest.raises(ValueError, match="unknown schedule"):
        ppl.plan_schedule("mystery", 4, 2)
    with pytest.raises(ValueError, match="divisible"):
        ppl.plan_schedule("interleaved", 3, 2, 2)


@pytest.mark.slow
def test_zero_gpt_hybrid_tp_sp_pp(tmp_path):
    """``tests/test_zero_optimizer.py:458`` on 8 gloo ranks: ZeRO composed
    with tp 2 x sequence parallel x pp 2 x dp 2 — its losses against the
    replicated optimizer's on the same hybrid mesh (rtol 2e-3). Slow-marked
    as the reference marks it."""
    width = ["--vocab", "128", "--hidden", "64", "--layers", "4", "--heads",
             "4", "--seq", "32"]
    ranks = start_ranks(hybrid_zero_cases, 8, tmp_path, width,
                        deadline=300.0)()
    for res in ranks:
        np.testing.assert_allclose(res[True], res[False], rtol=2e-3)
        np.testing.assert_allclose(res[False], ranks[0][False], rtol=0)
