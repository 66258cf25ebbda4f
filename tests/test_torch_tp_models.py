"""The port's tensor- and sequence-parallel models, engine, checkpoint and
examples on 4 spawned gloo ranks, against the JAX package's ``shard_map``
runs of the same cases on a CPU mesh and against the port's serial runs.

The ranks are spawned once for the module (``torch_tp_workers.
model_cases``) and run while the parent computes the JAX side:

- at tp = 4, each rank loading its shard of the same full JAX tree
  (``params_from_numpy``): GPT under plain TP (``tests/test_models.py:86``)
  and under sequence parallelism with learned and with rotary positions
  (``:120``'s two parametrisations; the JAX side of the rotary one drives
  its layers unrolled, as the JAX test does); BERT under TP and under SP
  with tokentype ids (``tests/test_bert.py:88``, ``:119``). Each rank's
  loss against the JAX shard_map loss and the JAX serial loss (rtol
  2e-5), and every local grad leaf against the JAX grads' shard of that
  rank (rtol / atol 2e-4);
- the checkpoint (``tests/test_checkpoint.py:77``): a serial checkpoint the
  JAX package writes, restored at tp = 4 (cut by the specs), gives the
  serial loss; a save at tp = 4 (gathered) restores into the serial port
  model with the serial loss of the same params;
- on a dp 2 x tp 2 mesh: the TP engine, window None and 8, and the
  speculative TP engine with chunked prefill and the prefix cache
  (``tests/test_serve.py:417``, ``:639``): its token streams equal the
  serial port engine's and the JAX TP engine's; ``pretrain_gpt --tp 2``
  (2 layers, hidden 64, 4 heads, seq 32, micro-batch 2 x 2 micro-batches
  a data rank: a global batch of 8; fp32 compute) in O2 and O0 against the
  port's serial run on the whole batch (losses 2e-5 relative; the first
  step's reduced grads within 2e-4 of each leaf's max |ref| in O0 and
  2**-6 in O2, where the grads are bf16; the masters as
  ``tests/test_torch_ddp.py`` holds them) and, in O2, against the JAX
  example's dp x tp step (``examples/gpt/pretrain_gpt.py:471-514``);
  replicated leaves equal on the TP ranks, every leaf equal on the data
  ranks;
- ``generate_gpt --tp 2`` from the seed's random weights (the full init
  cut: the serial model's shards) with the prefix cache and ``--spec-k
  2``: the serial example's tokens on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu import checkpoint as jcheckpoint
from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertModel as JaxBertModel
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.parallel import collectives as jcc
from apex_tpu.parallel import mesh as jmesh
from apex_tpu.parallel.distributed import (
    allreduce_gradients as jallreduce,
    allreduce_gradients_by_spec as jallreduce_by_spec,
)
from apex_tpu.serve import Engine as JaxEngine
from apex_tpu.serve import Request as JaxRequest
from apex_tpu.serve import ServeConfig as JaxServeConfig
from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu.transformer.pipeline_parallel import (
    pipeline_specs,
    pipelined_loss_fn,
)
from apex_tpu_torch import checkpoint
from apex_tpu_torch._params import module_tree
from apex_tpu_torch.examples.gpt import generate_gpt
from apex_tpu_torch.examples.gpt import pretrain_gpt as pg
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.serve import Engine, Request, ServeConfig
from apex_tpu_torch.transformer import tensor_parallel as tp
from torch_dp_workers import start_ranks
from torch_tp_workers import model_cases

TP = 4
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_seq_len=16, hidden_dropout=0.0,
            remat=False)
GPT_CASES = {"tp": dict(axis="model"),
             "sp_learned": dict(axis="model", sequence_parallel=True),
             "sp_rope": dict(axis="model", sequence_parallel=True,
                             position_embedding="rope")}
BERT_CASES = {"tp": dict(axis="model"),
              "sp": dict(axis="model", sequence_parallel=True)}
SERVE = dict(vocab_size=64, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_seq_len=64, hidden_dropout=0.0,
             remat=False)
SCFG = dict(max_batch=2, max_seq=48, block_size=8)
ENGINES = {"window_none": (dict(), dict()),
           "window_8": (dict(attention_window=8), dict()),
           "speculative": (dict(), dict(spec_k=2, prefill_chunk=8,
                                        prefix_cache=True))}
PRETRAIN = dict(vocab=64, hidden=64, layers=2, heads=4, seq=32)
LR = 1e-3
GENERATE = ["--device", "cpu", "--hidden", "32", "--layers", "2", "--heads",
            "4", "--vocab", "64", "--max-seq", "48", "--max-new-tokens",
            "8", "--max-batch", "2", "--block-size", "8", "--seed", "3"]
GENERATE_TP = GENERATE + ["--tp", "2", "--prefix-cache", "--spec-k", "2",
                          "--shared-prefix", "9"]
LOSS = dict(rtol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _tuples(jspecs):
    """A JAX PartitionSpec tree as the port's spec tuples."""
    return jax.tree.map(tuple, jspecs, is_leaf=lambda x: isinstance(x, P))


def _requests(vocab=64, spec=((5, 6), (11, 5), (3, 7))):
    rng = np.random.default_rng(7)
    return [(list(int(t) for t in rng.integers(0, vocab, n)), m)
            for n, m in spec]


def _bert_batch():
    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    toks = jax.random.randint(ks[0], (4, 16), 0, 64)
    attn = jnp.ones((4, 16), jnp.int32).at[:, -3:].set(0)
    lmask = (jax.random.uniform(ks[1], (4, 16)) < 0.15).astype(jnp.int32)
    labels = jax.random.randint(ks[2], (4, 16), 0, 64)
    nsp = jax.random.randint(ks[3], (4,), 0, 2)
    tokentype = jax.random.randint(jax.random.PRNGKey(9), (4, 16), 0, 2)
    return tuple(np.asarray(a) for a in (toks, attn, lmask, labels, nsp,
                                         tokentype))


def _gpt_cfg(**over):
    return JaxGPTConfig(
        vocab_size=PRETRAIN["vocab"], hidden_size=PRETRAIN["hidden"],
        num_layers=PRETRAIN["layers"],
        num_attention_heads=PRETRAIN["heads"], max_seq_len=PRETRAIN["seq"],
        hidden_dropout=0.0, compute_dtype=jnp.float32, remat=True,
        **dict(dict(axis=None), **over))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs and the ranks started on them; ``results()`` joins them
    once, so each test computes its JAX and serial side first while the
    ranks run."""
    tmp = tmp_path_factory.mktemp("tp_models")
    jgpt = JaxGPTModel(JaxGPTConfig(axis=None, compute_dtype=jnp.float32,
                                    **TINY))
    gpt_tree = _np(jgpt.init(jax.random.PRNGKey(0)))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                         64))
    jbert = JaxBertModel(JaxBertConfig(axis=None, compute_dtype=jnp.float32,
                                       **TINY))
    bert_tree = _np(jbert.init(jax.random.PRNGKey(0)))
    serve_tree = _np(JaxGPTModel(JaxGPTConfig(
        axis=None, compute_dtype=jnp.float32, **SERVE)).init(
        jax.random.PRNGKey(0)))
    ck_toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16),
                                            0, 64))
    serial_dir, tp_dir = str(tmp / "serial"), str(tmp / "tp")
    jcheckpoint.save_checkpoint(serial_dir, 0, jax.tree.map(
        jnp.asarray, gpt_tree), backend="npz")
    jm = JaxGPTModel(_gpt_cfg())
    init = jm.init(jax.random.PRNGKey(0))
    trees = {lv: _np(jamp.cast_params(init, jamp.get_policy(lv)))
             for lv in ("O0", "O2")}
    fp32 = dict(compute_dtype=torch.float32)
    inp = {
        "gpt": {k: dict(TINY, **fp32, **v) for k, v in GPT_CASES.items()},
        "gpt_tree": gpt_tree, "gpt_data": (toks, np.roll(toks, -1, -1)),
        "bert": {k: dict(TINY, **fp32, **v) for k, v in BERT_CASES.items()},
        "bert_tree": bert_tree, "bert_batch": _bert_batch(),
        "checkpoint": {"cfg": dict(TINY, **fp32, axis="model"),
                       "serial_dir": serial_dir, "tp_dir": tp_dir,
                       "toks": ck_toks, "tgt": np.roll(ck_toks, -1, -1)},
        "engine": {name: dict(cfg_kw=dict(SERVE, **fp32, axis="model", **c),
                              tree=serve_tree, scfg_kw=dict(SCFG, **s),
                              requests=_requests())
                   for name, (c, s) in ENGINES.items()},
        "pretrain": {"width": PRETRAIN, "trees": trees, "lr": LR,
                     "steps": 2},
        "generate_argv": GENERATE_TP,
    }
    join = start_ranks(model_cases, TP, tmp, inp, deadline=240.0)
    joined = []

    def results():
        if not joined:
            joined.append(join())
        return joined[0]

    return {"inp": inp, "jm": jm, "jgpt": jgpt, "jbert": jbert,
            "results": results}


def _cut(tree, specs, rank, size=TP):
    return tp.shard_params(tree, specs, rank, size)


def _held(got, ref, **tol):
    got_l, ref_l = jax.tree.leaves(got), jax.tree.leaves(ref)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b, path in zip(got_l, ref_l, jax.tree_util.tree_flatten_with_path(
            ref)[0]):
        np.testing.assert_allclose(a, b, **tol, err_msg=str(path[0]))


def _jax_tp(model, params, loss_fn, mesh):
    specs = model.specs()
    fn = jax.jit(jax.shard_map(
        jax.value_and_grad(loss_fn), mesh=mesh, in_specs=(specs,),
        out_specs=(P(), specs), check_vma=False))
    v, g = fn(jtp.shard_params(params, specs, mesh))
    return float(v), _np(g), _tuples(specs)


def _gpt_refs(state, name):
    inp = state["inp"]
    toks, tgt = (jnp.asarray(a) for a in inp["gpt_data"])
    params = jax.tree.map(jnp.asarray, inp["gpt_tree"])
    cfg = dict(TINY, compute_dtype=jnp.float32)
    over = dict(GPT_CASES[name])
    if name == "sp_rope":
        over["unroll_layers"] = True  # the JAX test's combined variant
        params.pop("position")  # rotary positions hold no table
    serial = JaxGPTModel(JaxGPTConfig(
        axis=None, **dict(cfg, position_embedding=over.get(
            "position_embedding", "learned"))))
    par = JaxGPTModel(JaxGPTConfig(**cfg, **over))
    v_s, g_s = jax.value_and_grad(serial.loss)(params, toks, tgt)
    mesh = jmesh.make_virtual_mesh(TP, tensor_model_parallel_size=TP)
    try:
        v_p, g_p, specs = _jax_tp(par, params,
                                  lambda p: par.loss(p, toks, tgt), mesh)
    finally:
        jmesh.destroy_model_parallel()
    return (float(v_s), _np(g_s)), (v_p, g_p), specs


@pytest.mark.parametrize("name", list(GPT_CASES))
def test_gpt_tp_and_sp_match_jax_shard_map_and_serial(setup, name):
    (v_s, g_s), (v_p, g_p), specs = _gpt_refs(setup, name)
    for r, res in enumerate(setup["results"]()):
        got = res["gpt"][name]
        np.testing.assert_allclose(got["loss"], v_p, **LOSS)
        np.testing.assert_allclose(got["loss"], v_s, **LOSS)
        _held(got["grads"], _cut(g_p, specs, r), **GRAD)
        _held(got["grads"], _cut(g_s, specs, r), **GRAD)


@pytest.mark.parametrize("name", list(BERT_CASES))
def test_bert_tp_and_sp_match_jax_shard_map_and_serial(setup, name):
    state = setup
    toks, attn, lmask, labels, nsp, tokentype = (
        jnp.asarray(a) for a in state["inp"]["bert_batch"])
    tt = tokentype if name == "sp" else None
    params = jax.tree.map(jnp.asarray, state["inp"]["bert_tree"])
    cfg = dict(TINY, compute_dtype=jnp.float32)
    par = JaxBertModel(JaxBertConfig(**cfg, **BERT_CASES[name]))
    serial = JaxBertModel(JaxBertConfig(axis=None, **cfg))

    def loss_of(model):
        return lambda p: model.loss(p, toks, attn, lmask, labels, nsp,
                                    tokentype_ids=tt)

    v_s, g_s = jax.value_and_grad(loss_of(serial))(params)
    mesh = jmesh.make_virtual_mesh(TP, tensor_model_parallel_size=TP)
    try:
        v_p, g_p, specs = _jax_tp(par, params, loss_of(par), mesh)
    finally:
        jmesh.destroy_model_parallel()
    for r, res in enumerate(state["results"]()):
        got = res["bert"][name]
        np.testing.assert_allclose(got["loss"], v_p, **LOSS)
        np.testing.assert_allclose(got["loss"], float(v_s), **LOSS)
        _held(got["grads"], _cut(g_p, specs, r), **GRAD)
        _held(got["grads"], _cut(_np(g_s), specs, r), **GRAD)


def test_checkpoint_resumes_across_tp_sizes(setup):
    """A serial checkpoint (the JAX package's) restored at tp = 4 gives the
    serial loss; a save at tp = 4 restores serial with the same params'
    serial loss (``tests/test_checkpoint.py:77``)."""
    state = setup
    ck = state["inp"]["checkpoint"]
    params = jax.tree.map(jnp.asarray, state["inp"]["gpt_tree"])
    jserial = state["jgpt"]
    toks, tgt = jnp.asarray(ck["toks"]), jnp.asarray(ck["tgt"])
    ref = float(jserial.loss(params, toks, tgt))
    for res in state["results"]():
        np.testing.assert_allclose(res["checkpoint"]["loss_from_serial"],
                                   ref, **LOSS)
    half = jax.tree.map(lambda a: a * 0.5, params)
    model = GPTModel(GPTConfig(**dict(TINY, compute_dtype=torch.float32)),
                     device="cpu")
    model.params_from_numpy(checkpoint.restore_checkpoint(
        ck["tp_dir"], module_tree(model, device="meta")))
    with torch.no_grad():
        got = float(model.loss(torch.from_numpy(ck["toks"]),
                               torch.from_numpy(ck["tgt"])))
    np.testing.assert_allclose(got, float(jserial.loss(half, toks, tgt)),
                               **LOSS)
    assert checkpoint.latest_step(ck["tp_dir"]) == 1


def _serial_engine(cfg_kw, tree, requests, **_):
    """The serial port engine, monolithic prefill, no speculation."""
    model = GPTModel(GPTConfig(**dict(cfg_kw, axis=None)), device="cpu")
    model.params_from_numpy(tree)
    res = Engine(model, ServeConfig(**SCFG), device="cpu").run(
        [Request(prompt=list(p), max_new_tokens=m, request_id=i)
         for i, (p, m) in enumerate(requests)])
    return {rid: r.tokens for rid, r in res.items()}


def _jax_tp_engine(cfg_kw, tree, scfg_kw, requests):
    mesh = jmesh.make_virtual_mesh(8, tensor_model_parallel_size=2)
    try:
        cfg = {k: v for k, v in cfg_kw.items() if k != "compute_dtype"}
        model = JaxGPTModel(JaxGPTConfig(compute_dtype=jnp.float32, **cfg))
        eng = JaxEngine(model, jax.tree.map(jnp.asarray, tree),
                        JaxServeConfig(**scfg_kw), mesh=mesh)
        res = eng.run([JaxRequest(prompt=list(p), max_new_tokens=m,
                                  request_id=i)
                       for i, (p, m) in enumerate(requests)])
        return {rid: list(map(int, r.tokens)) for rid, r in res.items()}
    finally:
        jmesh.destroy_model_parallel()


@pytest.mark.parametrize("name", list(ENGINES))
def test_tp2_engine_matches_serial_and_the_jax_tp_engine(setup, name):
    case = setup["inp"]["engine"][name]
    serial = _serial_engine(**case)
    jax_tp = _jax_tp_engine(**case)
    assert serial == jax_tp
    ranks = setup["results"]()
    for res in ranks:
        got = res["engine"][name]
        assert got["tokens"] == serial, name
        assert got["kv_heads"] == SERVE["num_attention_heads"] // 2
        assert got["used"] == 0
    if name == "speculative":
        assert ranks[0]["engine"][name]["stats"]["mean_accepted_len"] > 1.5


def _port_serial(tree, level, batches, steps=2):
    real = pg.GPTConfig
    pg.GPTConfig = lambda **c: real(**dict(c, compute_dtype=torch.float32))
    try:
        trainer = pg.build(**PRETRAIN, micro_batch=2, num_microbatches=4,
                           lr=LR, opt_level=level, device="cpu")
    finally:
        pg.GPTConfig = real
    trainer.load_params_(tree)
    grads = {}
    real_step = trainer.mp_opt.step

    def step(state, model, **kw):
        if not grads:
            grads.update(module_tree(model, [p.grad.float()
                                             for p in model.parameters()]))
        return real_step(state, model, **kw)

    trainer.mp_opt.step = step
    losses = [float(trainer.step(*batches[i])[0]) for i in range(steps)]
    masters = (module_tree(trainer.model, trainer.opt_state.master)
               if trainer.opt_state.master is not None else None)
    return losses, _np(grads), masters and _np(masters)


def _jax_pretrain_tp(jm_tp, params, batches, steps=2):
    """The JAX example's dp x tp step (``pretrain_gpt.py:471-514``) at dp 2,
    tp 2: ``(losses, first step's scaled grads, masters)``."""
    m = jmesh.make_virtual_mesh(4, tensor_model_parallel_size=2)
    mp_opt = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=LR),
                                          jamp.get_policy("O2"))
    all_specs = jm_tp.specs()
    specs = dict({k: v for k, v in all_specs.items() if k != "layers"},
                 layers=pipeline_specs(all_specs["layers"]))
    rest_specs = {k: v for k, v in all_specs.items() if k != "layers"}
    grad_axes = jmesh.get_gradient_reduction_axes()
    data_spec = P(jmesh.get_data_parallel_axes())
    pipe_loss = pipelined_loss_fn(
        embed=jm_tp.embed, run_layers=lambda lp, h: jm_tp.run_layers(lp, h),
        head_loss=lambda p, h, t: jm_tp.head(p, h, t), num_microbatches=2)

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

    params = jtp.shard_params(params, specs, m)
    opt_state = mp_opt.init(params)
    losses, grads = [], None
    for i in range(steps):
        toks, tgts = (jnp.asarray(t.numpy()) for t in batches[i])
        if i == 0:
            grads = shard_fn(params, toks, tgts,
                             opt_state.scaler.loss_scale)[1]
        params, opt_state, loss = step(params, opt_state, toks, tgts)
        losses.append(float(loss))
    return losses, _np(grads), _np(opt_state.master), _tuples(all_specs)


def _share_held(got, ref, share, what):
    for a, b, path in zip(jax.tree.leaves(got), jax.tree.leaves(ref),
                          jax.tree_util.tree_flatten_with_path(ref)[0]):
        tol = share * max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= tol, (what, str(path[0]))


def _masters_held(got, ref, what, bulk_only=False):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        diff = np.abs(a - b)
        assert np.sum(diff > LR / 5) <= max(1, 5e-3 * diff.size), what
        assert bulk_only or diff.max() <= 2.5 * LR, what


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_pretrain_tp2_matches_jax_tp_and_the_port_serial(setup, level):
    state = setup
    tree = state["inp"]["pretrain"]["trees"][level]
    args = pg.parse_args(["--vocab", "64", "--seq", "32", "--device", "cpu"])
    it = pg.batches(args, 8)
    batches = [next(it) for _ in range(2)]
    slosses, sgrads, smasters = _port_serial(tree, level, batches)
    jm_tp = JaxGPTModel(_gpt_cfg(axis="model"))
    specs = _tuples(jm_tp.specs())
    share = 2e-4 if level == "O0" else 2 ** -6
    ranks = state["results"]()
    got = [r["pretrain"][level] for r in ranks]
    for r, res in enumerate(got):
        tp_rank = ranks[r]["coords"][3]
        assert res["batch"] == 8 and not any(res["found"])
        np.testing.assert_allclose(res["losses"], slosses, **LOSS)
        _share_held(res["grads"], _cut(sgrads, specs, tp_rank, 2), share,
                    f"{level} grads")
        if level == "O2":
            _masters_held(res["masters"], _cut(smasters, specs, tp_rank, 2),
                          "masters vs serial")
    # replicated leaves equal on the TP ranks; every leaf on the data ranks
    for a, b in ((0, 1), (2, 3)):
        for leaf in ("ln_f", "position"):
            _held(got[a]["params"][leaf], got[b]["params"][leaf], rtol=0,
                  atol=0)
    for a, b in ((0, 2), (1, 3)):
        _held(got[a]["params"], got[b]["params"], rtol=0, atol=0)
    if level == "O2":
        params = jamp.cast_params(jm_tp.init(jax.random.PRNGKey(0)),
                                  jamp.get_policy("O2"))
        try:
            jlosses, jgrads, jmaster, jspecs = _jax_pretrain_tp(
                jm_tp, params, batches)
        finally:
            jmesh.destroy_model_parallel()
        for r, res in enumerate(got):
            tp_rank = ranks[r]["coords"][3]
            np.testing.assert_allclose(res["losses"], jlosses, **LOSS)
            _share_held(res["grads"], _cut(jgrads, jspecs, tp_rank, 2),
                        share, "grads vs JAX TP")
            _masters_held(res["masters"], _cut(jmaster, jspecs, tp_rank, 2),
                          "masters vs JAX TP", bulk_only=True)


def test_generate_tp2_matches_the_serial_example(setup, capsys):
    serial = generate_gpt.run(GENERATE + ["--prefix-cache", "--spec-k", "2",
                                          "--shared-prefix", "9"])
    want = {rid: r.tokens for rid, r in serial["results"].items()}
    plain = generate_gpt.run(GENERATE + ["--shared-prefix", "9"])
    assert want == {rid: r.tokens for rid, r in plain["results"].items()}
    for res in setup["results"]():
        assert res["generate"] == want


def test_tp_options_need_ranks_and_keep_later_items_raising():
    """One process: ``--tp 2`` raises naming the world size; sequence
    parallelism does not serve; a ``context_axis`` model builds on the
    installed topology and does not serve either (``gpt.py:381-385``)."""
    with pytest.raises(RuntimeError, match="world size"):
        pg.run(["--device", "cpu", "--tp", "2", "--steps", "1",
                "--hidden", "32", "--layers", "1", "--heads", "4",
                "--vocab", "64", "--seq", "16"])
    with pytest.raises(RuntimeError, match="world size"):
        generate_gpt.run(GENERATE + ["--tp", "2"])
    from apex_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel()
    try:
        sp = GPTModel(GPTConfig(**dict(TINY, axis="model",
                                       sequence_parallel=True)),
                      device="cpu")
        with pytest.raises(ValueError, match="sequence_parallel"):
            Engine(sp, ServeConfig(max_seq=16), device="cpu",
                   mesh=mesh.get_mesh())
        tpm = GPTModel(GPTConfig(**dict(TINY, axis="model")), device="cpu")
        with pytest.raises(ValueError, match="needs the mesh"):
            Engine(tpm, ServeConfig(max_seq=16), device="cpu")
        with pytest.raises(ValueError, match="draft model must share"):
            Engine(tpm, ServeConfig(max_seq=16, spec_k=2), device="cpu",
                   mesh=mesh.get_mesh(),
                   draft_model=GPTModel(GPTConfig(**TINY), device="cpu"))
        cpm = GPTModel(GPTConfig(**dict(TINY, axis="model",
                                        context_axis="context")),
                       device="cpu")
        with pytest.raises(ValueError, match="context parallelism"):
            Engine(cpm, ServeConfig(max_seq=16), device="cpu",
                   mesh=mesh.get_mesh())
    finally:
        mesh.destroy_model_parallel()
