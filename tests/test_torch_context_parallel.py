"""The port's context-parallel models and long-context example on 4 spawned
gloo ranks, against the JAX package's context-parallel ``shard_map`` runs
of the same cases on the CPU mesh.

The ranks are spawned once for the module (``torch_cp_workers.
model_cases``) and run while the parent computes the JAX side, each case
from the same JAX init (``params_from_numpy`` / ``load_params_``):

- GPT at cp = 4, every case of ``tests/test_gpt_sequence_parallel.py``:
  ring and Ulysses (the JAX side with and without ``unroll_layers``, which
  the port's one layer loop answers both), the window of 12 across the
  8-token shards (``:92``), RoPE (``:150``); in this process the bad
  ``sequence_parallel_impl`` and the dense bias refused;
- BERT at cp = 2 (``tests/test_bert.py:205``, ``:245``): the maskless
  headless model and the padded one with NSP, ring and Ulysses;
- GPT under sequence parallelism with a context axis, tp 2 x cp 2
  (``tests/test_models.py:160``);
- ``train_long_context --cp 2 --dp 2``, ring and Ulysses, against the JAX
  example's sharded step (``examples/longcontext/train_long_context.py:
  122-153``).

Each model case's loss and grads, averaged over the context axis as the
JAX harness's ``pmean`` does, within rtol 1e-5 (loss) and 2e-4 (grads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertModel as JaxBertModel
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.parallel import collectives as jcc
from apex_tpu.parallel import mesh as jmesh
from apex_tpu.parallel.distributed import (
    allreduce_gradients_by_spec as jallreduce_by_spec,
)
from apex_tpu.transformer import tensor_parallel as jtp
from apex_tpu_torch.models import BertConfig, BertModel, GPTConfig, GPTModel
from apex_tpu_torch.parallel import mesh
from apex_tpu_torch.transformer import tensor_parallel as tp
from torch_cp_workers import model_cases
from torch_dp_workers import start_ranks

CP = 4
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_seq_len=32, hidden_dropout=0.0,
            remat=False)
BERT_TINY = dict(TINY, max_seq_len=16)
SP_TINY = dict(TINY, max_seq_len=16)
GPT_CASES = {
    "ring": dict(sequence_parallel_impl="ring"),
    "ulysses": dict(sequence_parallel_impl="ulysses"),
    "window_ring": dict(sequence_parallel_impl="ring", attention_window=12),
    "window_ulysses": dict(sequence_parallel_impl="ulysses",
                           attention_window=12),
    "rope_ring": dict(sequence_parallel_impl="ring",
                      position_embedding="rope"),
    "rope_ulysses": dict(sequence_parallel_impl="ulysses",
                         position_embedding="rope"),
}
BERT_CASES = {f"{kind}_{impl}": (kind, impl)
              for kind in ("headless", "padded_nsp")
              for impl in ("ring", "ulysses")}
LONG = dict(seq=128, hidden=32, layers=2, heads=4, vocab=64)
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
BERT_GRAD = dict(rtol=2e-4, atol=2e-5)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _bert_batch(kind):
    """tests/test_bert.py's inputs: the headless case's all-valid loss mask
    and no attention mask; the padded case's ``_batch`` with a loss mask
    set on the first 3 tokens, zero on the padding, unequal over the two
    shards."""
    if kind == "headless":
        toks = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, 64)
        labels = jax.random.randint(jax.random.PRNGKey(2), (2, 16), 0, 64)
        lmask = jnp.ones((2, 16), jnp.int32)
        return tuple(None if a is None else np.asarray(a)
                     for a in (toks, None, lmask, labels, None))
    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    toks = jax.random.randint(ks[0], (2, 16), 0, 64)
    attn = jnp.ones((2, 16), jnp.int32).at[:, -3:].set(0)
    lmask = (jax.random.uniform(ks[1], (2, 16)) < 0.15).astype(jnp.int32)
    labels = jax.random.randint(ks[2], (2, 16), 0, 64)
    nsp = jax.random.randint(ks[3], (2,), 0, 2)
    lmask = (lmask.at[:, :3].set(1) * attn).astype(jnp.int32)
    assert int(lmask[:, :8].sum()) != int(lmask[:, 8:].sum())
    return tuple(np.asarray(a) for a in (toks, attn, lmask, labels, nsp))


def _jax_long_cp(impl, params, tokens, steps=2):
    """The JAX example's sharded step (``train_long_context.py:122-153``)
    at cp 2 x dp 2: losses and the first step's scaled grads."""
    lm = JaxGPTModel(_long_cfg(impl))
    m = jmesh.make_virtual_mesh(4, context_parallel_size=2)
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
    for _ in range(steps):
        ls, gs = shard_fn(params, toks, tgts, opt_state.scaler.loss_scale)
        grads = gs if grads is None else grads
        params, opt_state, _ = mp_opt.apply_gradients(opt_state, params, gs)
        losses.append(float(ls / opt_state.scaler.loss_scale))
    return losses, grads


def _long_cfg(impl):
    return JaxGPTConfig(
        vocab_size=LONG["vocab"], hidden_size=LONG["hidden"],
        num_layers=LONG["layers"], num_attention_heads=LONG["heads"],
        max_seq_len=LONG["seq"], hidden_dropout=0.0, axis=None,
        context_axis=jmesh.AXIS_CONTEXT, sequence_parallel_impl=impl,
        compute_dtype=jnp.float32, remat=True)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs and the ranks started on them; ``results()`` joins them
    once, so each test computes its JAX side first while the ranks run."""
    fp32 = dict(compute_dtype=torch.float32)
    gpt_tree = _np(JaxGPTModel(JaxGPTConfig(
        axis=None, compute_dtype=jnp.float32, **TINY)).init(
        jax.random.PRNGKey(0)))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0,
                                         64))
    bert = {}
    bert_tree = {}
    for name, (kind, impl) in BERT_CASES.items():
        cfg = dict(BERT_TINY, add_binary_head=kind == "padded_nsp")
        bert_tree[name] = _np(JaxBertModel(JaxBertConfig(
            axis=None, compute_dtype=jnp.float32, **cfg)).init(
            jax.random.PRNGKey(0)))
        bert[name] = (dict(cfg, **fp32, context_axis="context",
                           sequence_parallel_impl=impl), _bert_batch(kind))
    sp_tree = _np(JaxGPTModel(JaxGPTConfig(
        axis=None, compute_dtype=jnp.float32, **SP_TINY)).init(
        jax.random.PRNGKey(0)))
    sp_toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16),
                                            0, 64))
    long_params = jamp.cast_params(
        JaxGPTModel(_long_cfg("ring")).init(jax.random.PRNGKey(0)),
        jamp.get_policy("O2"))
    inp = {
        "gpt": {k: dict(TINY, **fp32, context_axis="context", **v)
                for k, v in GPT_CASES.items()},
        "gpt_tree": gpt_tree, "gpt_data": (toks, np.roll(toks, -1, -1)),
        "bert": bert, "bert_tree": bert_tree,
        "sp_cfg": dict(SP_TINY, **fp32, axis="model", sequence_parallel=True,
                       context_axis="context"),
        "sp_tree": sp_tree, "sp_data": (sp_toks, np.roll(sp_toks, -1, -1)),
        "long_tree": _np(long_params), "long_width": LONG,
    }
    join = start_ranks(model_cases, CP, tmp_path_factory.mktemp("cp_models"),
                       inp, deadline=240.0)
    joined = []

    def results():
        if not joined:
            joined.append(join())
        return joined[0]

    return {"inp": inp, "long_params": long_params, "results": results}


def _jax_cp(model, params, args, mesh_, param_specs=None):
    """``value_and_grad(model.loss)`` on the mesh, tokens sharded over the
    context axis (dim 1), loss and grads ``pmean``-ed over it."""
    def step(p, *a):
        loss, g = jax.value_and_grad(model.loss)(p, *a)
        return (jax.lax.pmean(loss, jmesh.AXIS_CONTEXT),
                jax.lax.pmean(g, jmesh.AXIS_CONTEXT))

    seq = P(None, jmesh.AXIS_CONTEXT)
    specs = tuple(P() if a is None or a.ndim == 1 else seq for a in args)
    pspec = P() if param_specs is None else param_specs
    fn = jax.jit(jax.shard_map(step, mesh=mesh_, in_specs=(pspec, *specs),
                               out_specs=(P(), pspec), check_vma=False))
    v, g = fn(params, *(None if a is None else jnp.asarray(a)
                        for a in args))
    return float(v), _np(g)


def _held(got, ref, **tol):
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b, path in zip(jax.tree.leaves(got), jax.tree.leaves(ref),
                          jax.tree_util.tree_flatten_with_path(ref)[0]):
        np.testing.assert_allclose(np.asarray(a, np.float32), b, **tol,
                                   err_msg=str(path[0]))


def _gpt_jax(name, unroll=False):
    over = dict(GPT_CASES[name])
    params = dict(_np(JaxGPTModel(JaxGPTConfig(
        axis=None, compute_dtype=jnp.float32, **TINY)).init(
        jax.random.PRNGKey(0))))
    if over.get("position_embedding") == "rope":
        params.pop("position")
    par = JaxGPTModel(JaxGPTConfig(
        axis=None, context_axis=jmesh.AXIS_CONTEXT, unroll_layers=unroll,
        compute_dtype=jnp.float32, **TINY, **over))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0, 64)
    tgt = jnp.roll(toks, -1, axis=-1)
    m = jmesh.make_virtual_mesh(CP, context_parallel_size=CP)
    try:
        return _jax_cp(par, jax.tree.map(jnp.asarray, params),
                       (np.asarray(toks), np.asarray(tgt)), m)
    finally:
        jmesh.destroy_model_parallel()


def _check_gpt(setup, name, unroll=False):
    v, g = _gpt_jax(name, unroll)
    for res in setup["results"]():
        loss, grads = res["gpt"][name]
        np.testing.assert_allclose(loss, v, **LOSS)
        _held(grads, g, **GRAD)


@pytest.mark.parametrize("sp_impl,unroll", [
    ("ring", False), ("ulysses", False), ("ring", True), ("ulysses", True)])
def test_gpt_context_parallel_matches_jax(setup, sp_impl, unroll):
    _check_gpt(setup, sp_impl, unroll)


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_gpt_window_context_parallel_matches_jax(setup, sp_impl):
    """The window of 12 across the 8-token shards: the ring keeps it (its
    no-op check is on the global length) and it changes the function."""
    _check_gpt(setup, f"window_{sp_impl}")
    dense = setup["results"]()[0]["gpt"][sp_impl][0]
    assert abs(setup["results"]()[0]["gpt"][f"window_{sp_impl}"][0]
               - dense) > 1e-6


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_gpt_rope_context_parallel_matches_jax(setup, sp_impl):
    _check_gpt(setup, f"rope_{sp_impl}")


def test_gpt_context_parallel_bad_impl_and_dense_bias_rejected():
    mesh.initialize_model_parallel(context_parallel_size=1)
    try:
        par = GPTModel(GPTConfig(context_axis="context",
                                 sequence_parallel_impl="nope",
                                 compute_dtype=torch.float32, **TINY),
                       device="cpu")
        toks = torch.zeros(2, 32, dtype=torch.long)
        with pytest.raises(ValueError, match="ring.*ulysses|ulysses.*ring"):
            par.loss(toks, toks)
        q = torch.zeros(1, 4, 8, 8)
        with pytest.raises(NotImplementedError, match="SegmentMask"):
            par._attend(q, q, q, torch.zeros(1, 1, 8, 8))
        with pytest.raises(ValueError, match="context parallelism"):
            par.check_servable()
    finally:
        mesh.destroy_model_parallel()


@pytest.mark.parametrize("name", list(BERT_CASES))
def test_bert_context_parallel_matches_jax(setup, name):
    kind, impl = BERT_CASES[name]
    cfg = dict(BERT_TINY, add_binary_head=kind == "padded_nsp")
    par = JaxBertModel(JaxBertConfig(
        axis=None, context_axis=jmesh.AXIS_CONTEXT,
        sequence_parallel_impl=impl, compute_dtype=jnp.float32, **cfg))
    params = jax.tree.map(jnp.asarray, setup["inp"]["bert_tree"][name])
    batch = setup["inp"]["bert"][name][1]
    m = jmesh.make_virtual_mesh(2, context_parallel_size=2)
    try:
        v, g = _jax_cp(par, params, batch, m)
    finally:
        jmesh.destroy_model_parallel()
    for res in setup["results"]():
        loss, grads = res["bert"][name]
        np.testing.assert_allclose(loss, v, **LOSS)
        _held(grads, g, **BERT_GRAD)


def test_gpt_sequence_parallel_with_context_axis_matches_jax(setup):
    """tp 2 x cp 2: each rank's local grads against its tensor-parallel
    shard of the JAX grads (the learned-position offsets compose:
    ``_seq_shard_start``)."""
    inp = setup["inp"]
    par = JaxGPTModel(JaxGPTConfig(
        axis="model", sequence_parallel=True,
        context_axis=jmesh.AXIS_CONTEXT, compute_dtype=jnp.float32,
        **SP_TINY))
    m = jmesh.make_virtual_mesh(4, tensor_model_parallel_size=2,
                                context_parallel_size=2)
    try:
        specs = par.specs()
        params = jtp.shard_params(jax.tree.map(jnp.asarray, inp["sp_tree"]),
                                  specs, m)
        v, g = _jax_cp(par, params, inp["sp_data"], m, specs)
        tspecs = jax.tree.map(tuple, specs,
                              is_leaf=lambda x: isinstance(x, P))
    finally:
        jmesh.destroy_model_parallel()
    for res in setup["results"]():
        loss, grads = res["sp"]
        np.testing.assert_allclose(loss, v, **LOSS)
        tp_rank = res["sp_coords"][3]
        _held(grads, tp.shard_params(g, tspecs, tp_rank, 2), **GRAD)


def _by_name(tree, n_layers):
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


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_long_context_cp2_matches_the_jax_sharded_step(setup, sp_impl):
    """``train_long_context --cp 2 --dp 2`` (O2 weights, fp32 compute, 2
    steps) against the JAX example's sharded step on the same tokens:
    losses within 1e-5, the first step's reduced grads within 2**-6 of
    each leaf's max (bf16 grads, as the DP test holds them)."""
    ranks = [r["long"][sp_impl] for r in setup["results"]()]
    tokens = ranks[0]["tokens"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["tokens"], tokens)
    try:
        jlosses, jgrads = _jax_long_cp(sp_impl, setup["long_params"], tokens)
    finally:
        jmesh.destroy_model_parallel()
    want = _by_name(jgrads, LONG["layers"])
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
        assert sorted(r["grads"]) == sorted(want)
        for n, ref in want.items():
            tol = 2 ** -6 * max(np.abs(ref).max(), 1e-30)
            assert np.abs(np.asarray(r["grads"][n]) - ref).max() <= tol, n


def test_bert_context_axis_builds_only_on_its_topology():
    with pytest.raises(ValueError, match="initialize_model_parallel"):
        BertModel(BertConfig(context_axis="context", **BERT_TINY),
                  device="cpu")
