"""ZeRO-3 of the port (``MixedPrecisionOptimizer.zero3_init``, the layer
drive of ``models/_transformer.py``, ``GPTModel.loss(layer_chunk_meta=)``)
on 4 spawned gloo ranks against the JAX package (``tests/
test_zero3_optimizer.py:54-247`` and ``:395-470``, case by case).

The ranks run ``torch_dp_workers.zero3_cases`` once while the parent
computes the JAX side on a 4-device CPU mesh:

- the 3-step sandwich (normal, an inf added to every grad, normal) of the
  tiny GPT (hidden 32, 2 layers, seq 16, 8 rows, O2), replicated, ZeRO-2
  (bf16 gather) and ZeRO-3 with the gathers just in time and prefetched
  one layer ahead (the reference's "scan" and "unroll" drives: the port
  has one drive, serialized or prefetched): the same found-inf and
  loss-scale trajectory on every path; the losses within 2e-3 of the
  replicated run's and of the JAX ZeRO-3 run's; the final params within
  2e-2 (the JAX test's bands); the skipped step leaves the ZeRO-3 chunks
  bit-identical;
- the chunk layout: every param a 1-D chunk of ``chunk_size(numel, 4)``
  (the reference's per-row layout: layer i's chunk is row i of its
  ``(L, k)`` stack), fp32 masters, the module's own params released; the
  materialized params equal the gathered chunks exactly (the bf16
  round trip of a fresh init in one process);
- the wiring errors of the reference;
- the prefetched drive (1 and 2 layers ahead) gives the serialized
  drive's loss bit for bit and its chunk grads within 1e-4 / 1e-5 (the
  JAX test's tolerance) on a 4-layer fp32 GPT, and the loss within 1e-5
  of the JAX serial loss;
- the prefetch guardrails: ``pretrain_gpt`` refuses ``--zero3-prefetch``
  without level 3 or without ``--unroll``, and the drive refuses an
  attention bias that needs a grad.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers.distributed import gather_chunked_tree as jgather
from apex_tpu.parallel import collectives as jcc
from apex_tpu_torch import amp
from apex_tpu_torch.examples.gpt import pretrain_gpt as pg
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers.distributed import chunk_size
from apex_tpu_torch.parallel import mesh
from torch_dp_workers import start_ranks, zero3_cases

N = 4
POISON_STEP = 1
WIDTH = dict(vocab_size=128, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_seq_len=16, hidden_dropout=0.0)
PF_WIDTH = dict(vocab_size=128, hidden_size=32, num_layers=4,
                num_attention_heads=4, max_seq_len=16, hidden_dropout=0.0)


@pytest.fixture(autouse=True)
def _clean():
    yield
    mesh.destroy_model_parallel()


def _jax_zero3(jm, full, toks):
    """The JAX ZeRO-3 sandwich: unscaled losses and loss scales."""
    m = Mesh(np.array(jax.devices()[:N]), ("data",))
    pspecs = jax.tree.map(lambda _: P(), full)
    mp_opt = jamp.MixedPrecisionOptimizer(
        JaxFusedAdam(lr=1e-3), jamp.get_policy("O2"), zero_axis="data",
        zero_level=3)
    z3 = mp_opt.zero3_init(full, m, pspecs)
    layer_meta = z3.meta.subtree("layers")
    rest_meta = z3.meta.select([k for k in z3.meta.shapes if k != "layers"])

    def zstep(p, s, tk, tg, poison):
        rest_c = {k: v for k, v in p.items() if k != "layers"}

        def scaled(rest_c, layer_c):
            rest = jgather(rest_c, rest_meta)
            return jm.loss(dict(rest, layers=layer_c), tk, tg,
                           layer_chunk_meta=layer_meta) * s.scaler.loss_scale

        loss, (rg, lg) = jax.value_and_grad(scaled, argnums=(0, 1))(
            rest_c, p["layers"])
        g = jax.tree.map(lambda x: x + poison, dict(rg, layers=lg))
        new_p, new_s, mt = mp_opt.apply_gradients(s, p, g)
        return new_p, new_s, jcc.pmean(loss, "data"), mt

    step = jax.jit(jax.shard_map(
        zstep, mesh=m, in_specs=(z3.param_specs, z3.state_specs, P("data"),
                                 P("data"), P()),
        out_specs=(z3.param_specs, z3.state_specs, P(), P()),
        check_vma=False))
    put = lambda a: jax.device_put(a, NamedSharding(m, P("data")))  # noqa
    tk = put(jnp.asarray(toks))
    tg = put(jnp.roll(jnp.asarray(toks), -1, axis=-1))
    p, s, losses, scales = z3.params, z3.opt_state, [], []
    for t in range(3):
        scale = float(s.scaler.loss_scale)
        poison = jnp.float32(jnp.inf if t == POISON_STEP else 0.0)
        p, s, loss, mt = step(p, s, tk, tg, poison)
        losses.append(float(loss) / scale)
        scales.append(float(mt["loss_scale"]))
    return losses, scales


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jm = JaxGPTModel(JaxGPTConfig(**WIDTH, axis=None, remat=False))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jm.init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(1).integers(0, 128, (N * 2, 16))
    pm = JaxGPTModel(JaxGPTConfig(**PF_WIDTH, axis=None,
                                  compute_dtype=jnp.float32))
    pf_tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                           pm.init(jax.random.PRNGKey(0)))
    pf_toks = np.random.default_rng(2).integers(0, 128, (2, 16))
    inp = {"gpt": {"width": dict(WIDTH), "tree": tree, "toks": toks,
                   "poison_step": POISON_STEP},
           "pf": {"width": dict(PF_WIDTH), "tree": pf_tree,
                  "toks": pf_toks}}
    join = start_ranks(zero3_cases, N, tmp_path_factory.mktemp("zero3"),
                       inp, deadline=240.0)
    full = jamp.cast_params(jax.tree.map(jnp.asarray, tree),
                            jamp.get_policy("O2"))
    jax_side = _jax_zero3(jm, full, toks)
    pf_loss = float(pm.loss(jax.tree.map(jnp.asarray, pf_tree),
                            jnp.asarray(pf_toks), jnp.asarray(pf_toks)))
    return dict(jax=jax_side, pf_loss=pf_loss, tree=tree, res=join())


@pytest.mark.parametrize("prefetch", [0, 1], ids=["serialized",
                                                  "prefetched"])
def test_zero3_gpt_matches_replicated_and_zero2(ranks, prefetch):
    jl, jsc = ranks["jax"]
    for res in ranks["res"]:
        ref, z3 = res["repl"], res[f"zero3_{prefetch}"]
        assert ref["founds"] == [False, True, False]
        assert ref["scales"][POISON_STEP] == ref["scales"][0] / 2
        assert ref["scales"] == jsc
        for run in (res["zero2"], z3):
            assert run["founds"] == ref["founds"]
            assert run["scales"] == ref["scales"]
            np.testing.assert_allclose(run["losses"], ref["losses"],
                                       rtol=2e-3)
            for name, a in ref["params"].items():
                np.testing.assert_allclose(run["params"][name], a,
                                           rtol=2e-2, atol=2e-2,
                                           err_msg=name)
        np.testing.assert_allclose(z3["losses"], jl, rtol=2e-3)
        assert z3["skip_bitexact"]
    for r in ranks["res"][1:]:
        for name, a in ranks["res"][0][f"zero3_{prefetch}"][
                "params"].items():
            np.testing.assert_array_equal(
                r[f"zero3_{prefetch}"]["params"][name], a)


def test_zero3_init_shapes_specs_and_materialize_roundtrip(ranks):
    z3 = ranks["res"][0]["zero3_0"]
    model = GPTModel(GPTConfig(**WIDTH, remat=False), device="cpu")
    numel = {n: p.numel() for n, p in model.named_parameters()}
    assert z3["chunk_shapes"] == {n: (chunk_size(k, N),)
                                  for n, k in numel.items()}
    assert z3["master_dtypes"] == ["torch.float32"]
    assert z3["freed"]
    # the exact round trip, in one process (the chunks are pure slices)
    mesh.initialize_model_parallel()
    policy = amp.get_policy("O2")
    amp.cast_params(model, policy)
    want = [p.detach().clone() for p in model.parameters()]
    mp_opt = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-3), policy,
                                         zero_axis="data", zero_level=3)
    setup = mp_opt.zero3_init(model)
    assert all(p.numel() == 0 for p in model.parameters())
    for a, b in zip(want, mp_opt.zero3_materialize(setup)):
        assert torch.equal(a, b)


def test_zero3_wiring_validation():
    policy = amp.get_policy("O2")
    with pytest.raises(ValueError, match="zero_level=3 requires zero_axis"):
        amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-3), policy,
                                    zero_level=3)
    with pytest.raises(ValueError, match="zero_level must be"):
        amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-3), policy,
                                    zero_axis="data", zero_level=4)
    z3 = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-3), policy,
                                     zero_axis="data", zero_level=3)
    with pytest.raises(ValueError, match="zero3_init"):
        z3.zero_init([torch.ones(8, dtype=torch.bfloat16)])
    z2 = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-3), policy,
                                     zero_axis="data")
    with pytest.raises(ValueError, match="requires zero_level=3"):
        z2.zero3_init(torch.nn.Linear(2, 2))


@pytest.mark.parametrize("prefetch", [1, 2])
def test_zero3_prefetch_matches_serialized_drive(ranks, prefetch):
    for res in ranks["res"]:
        a, b = res["prefetch_0"], res[f"prefetch_{prefetch}"]
        assert a["loss"] == b["loss"]
        np.testing.assert_allclose(a["loss"], ranks["pf_loss"], rtol=1e-5)
        for ga, gb in zip(a["grads"], b["grads"]):
            np.testing.assert_allclose(gb, ga, rtol=1e-4, atol=1e-5)


def test_zero3_prefetch_validation():
    for bad in (["--zero-level", "2", "--zero3-prefetch", "1"],
                ["--zero-level", "3", "--zero3-prefetch", "1"]):
        with pytest.raises(SystemExit):
            pg.parse_args(bad)
    assert pg.parse_args(["--zero-level", "3", "--zero3-prefetch", "1",
                          "--unroll"]).zero3_prefetch == 1
    mesh.initialize_model_parallel()
    model = GPTModel(GPTConfig(**WIDTH, zero3_prefetch=1), device="cpu")
    mp_opt = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-3),
                                         amp.get_policy("O0"),
                                         zero_axis="data", zero_level=3)
    setup = mp_opt.zero3_init(model)
    h = torch.zeros(1, 16, 32)
    bias = torch.zeros(1, 1, 16, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="bias"):
        model.run_layers_train(h, bias=bias,
                               chunk_meta=setup.layer_chunk_meta())
