"""ZeRO levels 1/2 of the port (``MixedPrecisionOptimizer(zero_axis=...)``,
``transformer.amp.build_zero_train_step``, ``pretrain_gpt --zero``) on 4
spawned gloo ranks against the JAX package (``tests/test_zero_optimizer.
py:70-297`` and ``:369``, case by case), and the bench's wire variables.

The ranks run ``torch_dp_workers.zero_cases`` once while the parent
computes the JAX side on a 4-device CPU mesh with the same numpy inputs:

- 4 steps of per-rank grads with an inf in rank 3's at step 2, Adam and
  LAMB (``norm_psum_axis``): the port's loss-scale trajectory equals the
  JAX ZeRO run's and the replicated run's (the skip halves the scale);
  every rank holds the same params after every step (bit for bit); the
  params within 1e-2 of the replicated JAX run (the JAX test's band) and
  the masters within 1e-5 of the JAX ZeRO run's chunks; the grad norm
  finite and within 1e-5 relative of JAX's;
- the state is this rank's 1-D chunks (w: 91 elements -> 23 a rank, b: 7
  -> 2, s: 1 -> 1), and an all-inf step leaves masters, moments and
  params bit-identical and halves the scale;
- ``log_group_norms`` from chunks equals the replicated JAX per-group
  norms (1e-5), also on a dp 2 x tp 2 mesh with a leaf sharded over the
  model axis (``grad_norm`` too);
- a param sharded over the zero axis keeps its fp32 local shard as its
  master and an empty residual; level 3 refuses it;
- the tiny GPT (hidden 32, 2 layers, seq 16, 8 rows) trained 3 steps with
  ZeRO and a bf16 gather against the replicated run (losses 2e-3, params
  2e-2: the JAX test's bands) and against the JAX ZeRO run (losses 2e-3);
- ``pretrain_gpt --zero`` saves at step 2 in the JAX layout: the JAX
  package restores the file into its own ZeRO state at dp 4 and its next
  step's loss equals the port's resumed step's (2e-3: bf16 compute, eager
  against jitted); the port resumes from step 2;
- the argument checks of ``pretrain_gpt`` and the bench's
  ``BENCH_QCOMM`` mapping (``tests/test_bench.py:24``).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu import checkpoint as jcheckpoint
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.parallel import collectives as jcc
from apex_tpu_torch import amp
from apex_tpu_torch.examples.gpt import pretrain_gpt as pg
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import mesh
from torch_dp_workers import start_ranks, zero_cases

N = 4
STEPS = 4
OVERFLOW_STEP = 2
NAMES = ["w", "b", "s"]
GPT_WIDTH = dict(vocab_size=128, hidden_size=32, num_layers=2,
                 num_attention_heads=4, max_seq_len=16, hidden_dropout=0.0)
CKPT_ARGV = ["--device", "cpu", "--hidden", "32", "--layers", "2",
             "--heads", "4", "--vocab", "64", "--seq", "16",
             "--micro-batch", "2", "--num-microbatches", "1", "--zero"]


@pytest.fixture(autouse=True)
def _clean():
    yield
    mesh.destroy_model_parallel()


def _params():
    rng = np.random.default_rng(0)
    full = {"w": rng.standard_normal((13, 7)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32),
            "s": np.asarray(rng.standard_normal(), np.float32)}
    return jamp.cast_params(jax.tree.map(jnp.asarray, full),
                            jamp.get_policy("O2"))


def _grads(params):
    out = []
    for t in range(STEPS):
        per = [{k: np.random.default_rng(1000 + 17 * t + r).standard_normal(
            np.shape(v)).astype(np.float32) for k, v in params.items()}
            for r in range(N)]
        if t == OVERFLOW_STEP:
            per[3] = {k: np.full_like(v, np.inf) for k, v in per[3].items()}
        out.append(per)
    return out


def _opt(kind, zero):
    if kind == "adam":
        return JaxFusedAdam(lr=1e-2, weight_decay=0.01)
    return JaxFusedLAMB(lr=1e-2, weight_decay=0.01,
                        norm_psum_axis="data" if zero else None)


def _jax_replicated(kind, params, grads):
    ref = jamp.MixedPrecisionOptimizer(_opt(kind, False),
                                       jamp.get_policy("O2"),
                                       log_grad_norm=True)
    st, p, scales, norms = ref.init(params), params, [], []
    for t in range(STEPS):
        g_mean = jax.tree.map(lambda *xs: sum(xs) / N, *grads[t])
        scaled = jax.tree.map(lambda g: g * st.scaler.loss_scale, g_mean)
        p, st, m = ref.apply_gradients(st, p, scaled)
        scales.append(float(m["loss_scale"]))
        norms.append(float(m["grad_norm"]))
    return p, scales, norms


def _jax_zero(kind, params, grads):
    m = Mesh(np.array(jax.devices()[:N]), ("data",))
    z = jamp.MixedPrecisionOptimizer(_opt(kind, True), jamp.get_policy("O2"),
                                     log_grad_norm=True, zero_axis="data")
    pspecs = jax.tree.map(lambda _: P(), params)
    zstate, sspecs = z.zero_init(params, m, pspecs)
    gspec = jax.tree.map(lambda _: P("data"), params)

    def zstep(p, st, g):
        g = jax.tree.map(lambda x: x[0], g)
        return z.apply_gradients(
            st, p, jax.tree.map(lambda gg: gg * st.scaler.loss_scale, g))

    fn = jax.jit(jax.shard_map(
        zstep, mesh=m, in_specs=(pspecs, sspecs, gspec),
        out_specs=(pspecs, sspecs, P()), check_vma=False))
    p, scales, norms = params, [], []
    for t in range(STEPS):
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *grads[t])
        p, zstate, mt = fn(p, zstate, stacked)
        scales.append(float(mt["loss_scale"]))
        norms.append(float(mt["grad_norm"]))
    return p, zstate, scales, norms


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params = _params()
    grads = _grads(params)
    rng = np.random.default_rng(7)
    same = [rng.standard_normal(np.shape(params[k])).astype(np.float32)
            for k in NAMES]
    hp = [rng.standard_normal((8, 4)).astype(np.float32),
          rng.standard_normal((4,)).astype(np.float32)]
    hg = [rng.standard_normal((8, 4)).astype(np.float32),
          rng.standard_normal((4,)).astype(np.float32)]
    jm = JaxGPTModel(JaxGPTConfig(**GPT_WIDTH, axis=None, remat=False))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jm.init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(1).integers(0, 128, (N * 2, 16))
    ckpt = str(tmp_path_factory.mktemp("zero_ckpt"))
    inp = {"params": [np.asarray(params[k], np.float32) for k in NAMES],
           "names": NAMES,
           "grads": [[[g[k] for k in NAMES] for g in per] for per in grads],
           "same_grads": same, "hybrid_params": hp, "hybrid_grads": hg,
           "gpt": {"width": dict(GPT_WIDTH), "tree": tree, "toks": toks},
           "ckpt_argv": CKPT_ARGV}
    join = start_ranks(zero_cases, N, tmp_path_factory.mktemp("zero"),
                       inp, ckpt, deadline=240.0)
    jax_side = {kind: (_jax_replicated(kind, params, grads),
                       _jax_zero(kind, params, grads))
                for kind in ("adam", "lamb")}
    return dict(params=params, grads=grads, inp=inp, jax=jax_side,
                jm=jm, tree=tree, toks=toks, ckpt=ckpt, res=join())


@pytest.mark.parametrize("kind", ["adam", "lamb"])
def test_zero_matches_replicated_with_overflow_skip(ranks, kind):
    (p_ref, sc_ref, n_ref), (p_z, zstate, sc_z, n_z) = ranks["jax"][kind]
    assert sc_ref[OVERFLOW_STEP] == sc_ref[0] / 2
    assert sc_z == sc_ref
    runs = [res[kind] for res in ranks["res"]]
    for r, run in enumerate(runs):
        scales = [m["loss_scale"] for m in run["metrics"]]
        assert scales == sc_ref, (kind, r)
        assert run["metrics"][OVERFLOW_STEP]["found_inf"]
        for t in range(STEPS):
            for a, b in zip(run["params"][t], runs[0]["params"][t]):
                np.testing.assert_array_equal(a, b)
        for name, got in zip(NAMES, run["params"][-1]):
            np.testing.assert_allclose(
                got, np.asarray(p_ref[name], np.float32), rtol=1e-2,
                atol=1e-2, err_msg=f"{kind}:{name}")
        for name, got in zip(NAMES, run["master"][-1]):
            full = np.asarray(zstate.master[name])
            k = full.size // N
            np.testing.assert_allclose(got, full[r * k:(r + 1) * k],
                                       rtol=0, atol=1e-5, err_msg=name)
        norms = [m["grad_norm"] for m in run["metrics"]]
        assert np.isfinite(norms[-1])
        for t in range(STEPS):
            if t != OVERFLOW_STEP:
                np.testing.assert_allclose(norms[t], n_z[t], rtol=1e-5)


def test_zero_state_is_sharded_and_skip_is_bitexact(ranks):
    for res in ranks["res"]:
        run = res["skip"]
        assert [m.shape for m in run["master"][0]] == [(23,), (2,), (1,)]
        assert run["metrics"][0]["found_inf"]
        for a, b in zip(run["master"][0], run["master"][1]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(run["inner"][0], run["inner"][1]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(run["params"][0], ranks["inp"]["params"]):
            np.testing.assert_array_equal(a, b)
        assert run["metrics"][0]["loss_scale"] == 2.0 ** 15


def test_zero_group_norms_match_replicated(ranks):
    params = ranks["params"]
    g = {k: jnp.asarray(v) for k, v in zip(NAMES, ranks["inp"]["same_grads"])}
    ref = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=1e-2),
                                       jamp.get_policy("O2"),
                                       log_group_norms=True)
    st = ref.init(params)
    _, _, m = ref.apply_gradients(
        st, params, jax.tree.map(lambda x: x * st.scaler.loss_scale, g))
    for res in ranks["res"]:
        for k, v in m["grad_norm_by_group"].items():
            np.testing.assert_allclose(res["groups"][k], float(v),
                                       rtol=1e-5, err_msg=k)


def test_zero_grad_norm_matches_replicated_hybrid_tp(ranks):
    w, b = (jnp.asarray(a) for a in ranks["inp"]["hybrid_params"])
    params = jamp.cast_params({"w": w, "b": b}, jamp.get_policy("O2"))
    gw, gb = (jnp.asarray(a) for a in ranks["inp"]["hybrid_grads"])
    ref = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=1e-2),
                                       jamp.get_policy("O2"),
                                       log_grad_norm=True,
                                       log_group_norms=True)
    st = ref.init(params)
    _, _, m = ref.apply_gradients(st, params, {
        "w": gw * st.scaler.loss_scale, "b": gb * st.scaler.loss_scale})
    for res in ranks["res"]:
        h = res["hybrid"]
        np.testing.assert_allclose(h["grad_norm"], float(m["grad_norm"]),
                                   rtol=1e-5)
        for k, v in m["grad_norm_by_group"].items():
            np.testing.assert_allclose(h["groups"][k], float(v), rtol=1e-5,
                                       err_msg=k)


def test_zero_composes_with_params_sharded_over_zero_axis(ranks):
    for res in ranks["res"]:
        (shape_e, dt_e), (shape_d, _) = res["expert_master"]
        assert shape_e == (1, 4, 4) and dt_e == "torch.float32"
        assert len(shape_d) == 1
        assert res["expert_residual"][0] == (0,)
        assert res["expert_residual"][1][0] > 0
    mesh.initialize_model_parallel()
    z3 = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), amp.get_policy("O2"),
                                     zero_axis="data", zero_level=3)

    class Two(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.experts = torch.nn.Parameter(torch.ones(1, 4, 4))

    with pytest.raises(ValueError, match="zero_level=3 requires"):
        z3.zero3_meta(Two(), [("data", None, None)])


def test_gather_dtype_requires_zero_axis():
    with pytest.raises(ValueError, match="gather_dtype"):
        amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), amp.get_policy("O2"),
                                    gather_dtype="bf16")


def _jax_zero_gpt(jm, full, toks):
    m = Mesh(np.array(jax.devices()[:N]), ("data",))
    policy = jamp.get_policy("O2")
    mp_opt = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=1e-3), policy,
                                          zero_axis="data",
                                          gather_dtype="bf16")
    pspecs = jax.tree.map(lambda _: P(), full)
    state, sspecs = mp_opt.zero_init(full, m, pspecs)

    def zstep(p, s, tk, tg):
        loss, g = jax.value_and_grad(
            lambda p: jm.loss(p, tk, tg) * s.scaler.loss_scale)(p)
        new_p, new_s, _ = mp_opt.apply_gradients(s, p, g)
        return new_p, new_s, jcc.pmean(loss, "data")

    step = jax.jit(jax.shard_map(
        zstep, mesh=m, in_specs=(pspecs, sspecs, P("data"), P("data")),
        out_specs=(pspecs, sspecs, P()), check_vma=False))
    put = lambda a: jax.device_put(a, NamedSharding(m, P("data")))  # noqa
    tk = put(jnp.asarray(toks))
    tg = put(jnp.roll(jnp.asarray(toks), -1, axis=-1))
    p, s, losses = full, state, []
    for _ in range(3):
        scale = float(s.scaler.loss_scale)
        p, s, loss = step(p, s, tk, tg)
        losses.append(float(loss) / scale)
    return losses


def test_zero_gpt_e2e_matches_replicated(ranks):
    jm = ranks["jm"]
    full = jamp.cast_params(jax.tree.map(jnp.asarray, ranks["tree"]),
                            jamp.get_policy("O2"))
    jl = _jax_zero_gpt(jm, full, ranks["toks"])
    for res in ranks["res"]:
        z, r = res["gpt_zero"], res["gpt_repl"]
        np.testing.assert_allclose(z["losses"], r["losses"], rtol=2e-3)
        np.testing.assert_allclose(z["losses"], jl, rtol=2e-3)
        for name, a in r["params"].items():
            np.testing.assert_allclose(z["params"][name], a, rtol=2e-2,
                                       atol=2e-2, err_msg=name)


def test_zero_checkpoint_resumes_in_jax_and_back(ranks):
    res = [r["ckpt"] for r in ranks["res"]]
    assert all(r["start"] == 2 for r in res)
    args = pg.parse_args(CKPT_ARGV)
    m = Mesh(np.array(jax.devices()[:N]), ("data",))
    jm = JaxGPTModel(JaxGPTConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        num_layers=args.layers, num_attention_heads=args.heads,
        max_seq_len=args.seq, hidden_dropout=0.0, axis=None,
        compute_dtype=jnp.bfloat16, remat=True))
    policy = jamp.get_policy("O2")
    full = jamp.cast_params(jm.init(jax.random.PRNGKey(0)), policy)
    mp_opt = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=args.lr), policy,
                                          zero_axis="data")
    pspecs = jax.tree.map(lambda _: P(), full)
    state, sspecs = mp_opt.zero_init(full, m, pspecs)
    restored = jcheckpoint.restore_checkpoint(
        ranks["ckpt"], {"params": full, "opt": state})
    shard = lambda t, s: jax.tree.map(  # noqa: E731
        lambda a, sp: jax.device_put(jnp.asarray(a), NamedSharding(m, sp)),
        t, s)
    p = shard(restored["params"], pspecs)
    s = shard(restored["opt"], sspecs)
    assert int(s.inner.step) == 2

    def zstep(p, s, tk, tg):
        loss, g = jax.value_and_grad(
            lambda p: jm.loss(p, tk, tg) * s.scaler.loss_scale)(p)
        return jcc.pmean(loss, "data") / s.scaler.loss_scale

    fn = jax.jit(jax.shard_map(
        zstep, mesh=m, in_specs=(pspecs, sspecs, P("data"), P("data")),
        out_specs=P(), check_vma=False))
    toks, tgts = next(pg.batches(args, args.micro_batch * N))
    jloss = float(fn(p, s, jnp.asarray(toks.numpy()),
                     jnp.asarray(tgts.numpy())))
    for r in res:
        np.testing.assert_allclose(r["resumed"][0], jloss, rtol=2e-3)


def test_pretrain_zero_arguments_and_raises():
    args = pg.parse_args(["--zero"])
    assert args.zero and args.zero_level == 2
    assert pg.parse_args(["--zero-level", "3"]).zero
    for bad in (["--zero-gather", "bf16"], ["--reduce-dtype", "int8"],
                ["--zero-level", "3", "--offload-optimizer"],
                ["--zero-level", "2", "--zero3-prefetch", "1"],
                ["--zero-level", "3", "--zero3-prefetch", "1"],
                ["--offload-optimizer"],
                ["--zero", "--offload-optimizer", "--save-dir", "d"],
                ["--mesh-islands", "2"]):
        with pytest.raises(SystemExit):
            pg.parse_args(bad)
    pg.check_slice(pg.parse_args(["--zero", "--zero-gather", "bf16",
                                  "--reduce-dtype", "e5m2"]))
    with pytest.raises(NotImplementedError, match="item 16"):
        pg.check_slice(pg.parse_args(["--zero", "--mesh-islands", "2"]))
    with pytest.raises(NotImplementedError, match="item 12"):
        pg.check_slice(pg.parse_args(["--pp", "2"]))


def test_qcomm_env_value_mapping(monkeypatch):
    from apex_tpu_torch import bench

    monkeypatch.delenv("BENCH_QCOMM", raising=False)
    assert bench._qcomm_env() is None
    monkeypatch.setenv("BENCH_QCOMM", "")
    assert bench._qcomm_env() is None
    monkeypatch.setenv("BENCH_QCOMM", "1")
    assert bench._qcomm_env() == "int8"
    monkeypatch.setenv("BENCH_QCOMM", "e5m2")
    assert bench._qcomm_env() == "e5m2"
    monkeypatch.setenv("BENCH_QCOMM", "INT8")
    assert bench._qcomm_env() == "int8"
    for value, want in (("", (False, 0)), ("1", (True, 2)), ("3", (True, 3))):
        monkeypatch.setenv("BENCH_ZERO", value)
        assert bench._zero_env_level() == want
    os.environ.pop("BENCH_ZERO", None)
