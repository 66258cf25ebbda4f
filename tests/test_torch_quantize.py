"""The quantized collectives of the port (``apex_tpu_torch.parallel.
quantize``), the ZeRO grad and param wires of ``MixedPrecisionOptimizer``
and the sequence-parallel activation wire, against the JAX package
(``tests/test_quantized_comm.py``, case by case).

Four gloo ranks are spawned once for the module
(``torch_dp_workers.quantize_cases``) while the parent computes the JAX
side on a 4-device CPU mesh with the same numpy inputs:

- the encode/decode primitives in one process: the port's int8 codes and
  e5m2 bytes equal JAX's bit for bit on the same rows; the int8 error is
  within half a scale; stochastic rounding is zero-mean (statistics, not
  bits: the dither comes from a ``torch.Generator``) and int8-only;
- the quantized reduce-scatter at int8 and e5m2 against the JAX one on the
  same grads (1e-6 of max |ref|) and against the exact scatter (0.02 /
  0.1 of max, the JAX test's bands); error feedback telescopes (the
  cumulative error after 16 rounds within 2x the first rounds' worst,
  and 3x under the no-feedback run's); the int8 param gather equal on
  every rank and within 0.01 of the exact gather, and equal to JAX's
  within 1e-6; the encoded all-to-all, its adjoint, the e5m2
  psum-scatter and the int8 all-gather against the JAX functions (1e-6
  of max |ref|);
- the ZeRO step at the int8 wire tracks the fp32 wire through an
  overflow-skipped step (the same loss scales, params within 5e-2, the
  residual bit-identical through the skip and moving otherwise) and its
  masters equal the JAX int8-wire masters within 1e-5; stochastic
  rounding advances the generator every step, the skip included;
  ``reduce_dtype=None`` keeps ``residual`` None; the int8 param gather
  gives the same params on every rank, within 0.02 of max of the bf16
  gather's;
- the argument checks; the serial twin ignores ``activation_comm_dtype``;
  the SP GPT at tp 2 x dp 2 with the int8 activation wire within 5% of
  the exact wire's loss and 0.15 of each grad leaf's max (the JAX
  test's bands), each wire's loss within 1e-3 of the JAX shard_map loss;
  the paired convergence gate: the int8-wire loss after 6 ZeRO steps
  within 0.1 of the fp32 wire's loss drop (``monitor.report.compare``'s
  ``loss_threshold`` rule).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu import amp as jamp
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers.distributed import chunk_size as jchunk_size
from apex_tpu.optimizers.distributed import scatter_chunk as jscatter
from apex_tpu.parallel import mesh as jmesh
from apex_tpu.parallel import quantize as jq
from apex_tpu_torch import amp
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import mesh
from apex_tpu_torch.parallel import quantize as q
from torch_dp_workers import quantize_cases, start_ranks

N = 4
STEPS = 4
OVERFLOW_STEP = 2
SP_WIDTH = dict(vocab_size=128, hidden_size=64, num_layers=2,
                num_attention_heads=4, max_seq_len=32, hidden_dropout=0.0)
PAIRED_WIDTH = dict(vocab_size=256, hidden_size=64, num_layers=2,
                    num_attention_heads=4, max_seq_len=32,
                    hidden_dropout=0.0)


@pytest.fixture(autouse=True)
def _clean():
    yield
    mesh.destroy_model_parallel()
    jmesh.destroy_model_parallel()


def _params():
    rng = np.random.default_rng(0)
    full = {"w": rng.standard_normal((13, 7)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32),
            "s": np.asarray(rng.standard_normal(), np.float32)}
    cast = jamp.cast_params(jax.tree.map(jnp.asarray, full),
                            jamp.get_policy("O2"))
    return cast


def _per_replica_grads(params):
    grads = []
    for t in range(STEPS):
        per = []
        for r in range(N):
            rng = np.random.default_rng(1000 + 17 * t + r)
            per.append({k: rng.standard_normal(np.shape(v)).astype(
                np.float32) for k, v in params.items()})
        if t == OVERFLOW_STEP:
            per[3] = {k: np.full_like(v, np.inf) for k, v in per[3].items()}
        grads.append(per)
    return grads


def _jax_run_zero(params, grads, reduce_dtype=None, stochastic=False,
                  gather_dtype=None, steps=STEPS):
    m = Mesh(np.array(jax.devices()[:N]), ("data",))
    z = jamp.MixedPrecisionOptimizer(
        JaxFusedAdam(lr=1e-2, weight_decay=0.01), jamp.get_policy("O2"),
        zero_axis="data", reduce_dtype=reduce_dtype,
        stochastic_rounding=stochastic, gather_dtype=gather_dtype)
    pspecs = jax.tree.map(lambda _: P(), params)
    zstate, sspecs = z.zero_init(params, m, pspecs)
    gspec = jax.tree.map(lambda _: P("data"), params)

    def zstep(p, st, g):
        g = jax.tree.map(lambda x: x[0], g)
        scaled = jax.tree.map(lambda gg: gg * st.scaler.loss_scale, g)
        return z.apply_gradients(st, p, scaled)

    fn = jax.jit(jax.shard_map(
        zstep, mesh=m, in_specs=(pspecs, sspecs, gspec),
        out_specs=(pspecs, sspecs, P()), check_vma=False))
    p, states, scales = params, [zstate], []
    for t in range(steps):
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *grads[t])
        p, zstate, mt = fn(p, zstate, stacked)
        states.append(zstate)
        scales.append(float(mt["loss_scale"]))
    return p, states, scales


def _names():
    return ["w", "b", "s"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(5)
    params = _params()
    grads = _per_replica_grads(params)
    # the torch side walks parameters in the order w, b, s
    pl = [np.asarray(params[k], np.float32) for k in _names()]
    gl = [[[g[k] for k in _names()] for g in per] for per in grads]
    jm = JaxGPTModel(JaxGPTConfig(**SP_WIDTH, axis=None, remat=False))
    sp_tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                           jm.init(jax.random.PRNGKey(0)))
    toks = rng.integers(0, 128, (8, 32))
    pm = JaxGPTModel(JaxGPTConfig(**PAIRED_WIDTH, axis=None, remat=False))
    p_tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          pm.init(jax.random.PRNGKey(0)))
    prng = np.random.default_rng(0)
    inp = {
        "rs_grads": rng.standard_normal((N, 533)).astype(np.float32),
        "ef_grads": rng.standard_normal((N, 257)).astype(np.float32),
        "ef_pad": jchunk_size(257, N) * N, "ef_T": 16,
        "gather": rng.standard_normal((N, 64)).astype(np.float32),
        "a2a": rng.standard_normal((N, 8, 6)).astype(np.float32),
        "a2a_w": rng.standard_normal((N, 2, 24)).astype(np.float32),
        "params": pl, "grads": gl,
        "zero_runs": {
            "fp32": dict(zero_axis="data"),
            "int8": dict(zero_axis="data", reduce_dtype="int8"),
            "int8_sr": dict(zero_axis="data", reduce_dtype="int8",
                            stochastic_rounding=True)},
        "gather_runs": {
            "g_int8": dict(zero_axis="data", gather_dtype="int8"),
            "g_bf16": dict(zero_axis="data", gather_dtype="bf16")},
        "sp": {"width": dict(SP_WIDTH), "tree": sp_tree, "toks": toks,
               "tgts": np.roll(toks, -1, axis=-1)},
        "paired": {"width": dict(PAIRED_WIDTH), "tree": p_tree,
                   "batches": [prng.integers(0, 256, (N * 2, 32))
                               for _ in range(6)]},
    }
    join = start_ranks(quantize_cases, N, tmp_path_factory.mktemp("quant"),
                       inp, deadline=240.0)
    jax_side = {"int8": _jax_run_zero(params, grads, "int8"),
                "fp32": _jax_run_zero(params, grads, None)}
    return dict(inp=inp, params=params, grads=grads, jax=jax_side,
                res=join())


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------


def test_canon_wire_dtype():
    assert q.canon_wire_dtype(None) is None
    assert q.canon_wire_dtype("int8") == "int8"
    assert q.canon_wire_dtype(torch.int8) == "int8"
    assert q.canon_wire_dtype("E5M2") == "e5m2"
    assert q.canon_wire_dtype("fp8") == "e5m2"
    assert q.canon_wire_dtype(torch.float8_e5m2) == "e5m2"
    for bad in ("int4", torch.bfloat16):
        with pytest.raises(ValueError):
            q.canon_wire_dtype(bad)
    for name in ("int8", "e5m2", "fp8", None):
        assert q.canon_wire_dtype(name) == jq.canon_wire_dtype(name)


def test_encode_decode_error_bounded_by_scale():
    rng = np.random.default_rng(0)
    rows = np.concatenate([rng.standard_normal((3, 64)).astype(np.float32)
                           * 10.0, np.zeros((1, 64), np.float32)])
    t = torch.from_numpy(rows)
    scales = q.block_scales(t, "int8")
    codes = q.encode(t, scales, "int8")
    jscales = jq.block_scales(jnp.asarray(rows), "int8")
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jq.encode(jnp.asarray(rows), jscales,
                                            "int8")))
    dec = q.decode(codes, scales)
    err = (dec - t).abs()
    assert float((err - 0.5 * scales[:, None]).max()) <= 1e-6
    np.testing.assert_array_equal(dec[-1].numpy(), np.zeros(64))
    es = q.block_scales(t, "e5m2")
    ecodes = q.encode(t, es, "e5m2")
    jes = jq.block_scales(jnp.asarray(rows), "e5m2")
    np.testing.assert_array_equal(
        ecodes.view(torch.uint8).numpy(),
        np.asarray(jq.encode(jnp.asarray(rows), jes, "e5m2")).view(
            np.uint8))
    rel = (q.decode(ecodes, es) - t).abs() / (t.abs() + 1e-9)
    assert float(rel[:3].median()) <= 2.0 ** -3


def test_stochastic_rounding_is_zero_mean_and_int8_only():
    rows = torch.full((1, 256), 0.3)
    scales = q.block_scales(rows, "int8")
    decs = []
    for i in range(64):
        gen = torch.Generator().manual_seed(i)
        codes = q.encode(rows, scales, "int8", generator=gen)
        decs.append(float(q.decode(codes, scales).mean()))
    plain = float(q.decode(q.encode(rows, scales, "int8"), scales).mean())
    assert abs(np.mean(decs) - 0.3) < abs(plain - 0.3) + 1e-3 \
        or abs(np.mean(decs) - 0.3) < 0.002
    with pytest.raises(ValueError):
        q.encode(rows, scales, "e5m2", generator=torch.Generator())


def _jax_vmapped(fn, x):
    return np.asarray(jax.vmap(fn, axis_name="data")(jnp.asarray(x)))


@pytest.mark.parametrize("wire", ["int8", "e5m2"])
def test_quantized_reduce_scatter_matches_exact(ranks, wire):
    g = ranks["inp"]["rs_grads"]
    ref = _jax_vmapped(lambda x: jscatter(x, N, "data"), g)
    jout = _jax_vmapped(
        lambda x: jq.quantized_reduce_scatter(x, N, "data", wire)[0], g)
    for r, res in enumerate(ranks["res"]):
        got = res[f"rs_{wire}"]
        assert got.shape == ref[r].shape
        np.testing.assert_allclose(res["rs_exact"], ref[r], rtol=1e-6,
                                   atol=1e-6)
        assert np.abs(got - jout[r]).max() <= 1e-6 * np.abs(jout).max()
        rel = np.abs(got - ref[r]).max() / np.abs(ref).max()
        assert rel < (0.02 if wire == "int8" else 0.1), (wire, rel)


def test_error_feedback_telescopes_not_accumulates(ranks):
    for res in ranks["res"]:
        ef, no_ef = res["ef_True"], res["ef_False"]
        assert ef[-1] <= 2.0 * max(ef[:4]), ef
        assert no_ef[-1] > 3.0 * ef[-1], (no_ef[-1], ef[-1])


def test_quantized_gather_chunk_identical_across_ranks(ranks):
    chunks = ranks["inp"]["gather"]
    jout = _jax_vmapped(
        lambda c: jq.quantized_gather_chunk(c, "data", "int8"), chunks)
    flat = chunks.reshape(-1)
    outs = [res["gather"] for res in ranks["res"]]
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)
    assert np.abs(outs[0] - flat).max() / np.abs(flat).max() < 0.01
    np.testing.assert_allclose(outs[0], jout[0], rtol=0, atol=1e-6)
    # the encoded all_to_all with its adjoint, the e5m2 psum_scatter and
    # the int8 all_gather against the JAX functions
    x, w = ranks["inp"]["a2a"], ranks["inp"]["a2a_w"]
    m = Mesh(np.array(jax.devices()[:N]), ("data",))

    def fwd(xl, wl):
        y = jq.quantized_all_to_all(xl[0], "data", "int8", split_axis=0,
                                    concat_axis=1)
        return y[None], jnp.sum(y * wl[0])

    def loss(xl, wl):  # this rank's term: the adjoint's exchange sums
        return fwd(xl, wl)[1]

    smap = jax.shard_map(
        lambda xl, wl: (fwd(xl, wl)[0], jax.grad(loss)(xl, wl),
                        jq.quantized_psum_scatter(xl[0], "data", "e5m2",
                                                  scatter_dim=0)[None],
                        jq.quantized_all_gather(xl[0], "data", "int8",
                                                gather_dim=1)[None]),
        mesh=m, in_specs=(P("data"), P("data")),
        out_specs=(P("data"),) * 4, check_vma=False)
    jy, jg, jps, jag = (np.asarray(a) for a in jax.jit(smap)(x, w))
    for r, res in enumerate(ranks["res"]):
        for key, ref in (("a2a", jy[r]), ("a2a_grad", jg[r]),
                         ("psum_scatter", jps[r]), ("all_gather", jag[r])):
            assert res[key].shape == ref.shape, key
            assert np.abs(res[key] - ref).max() \
                <= 1e-6 * np.abs(ref).max(), key


# ---------------------------------------------------------------------------
# the ZeRO wire
# ---------------------------------------------------------------------------


def test_int8_wire_tracks_fp32_wire_through_overflow_skip(ranks):
    params = ranks["params"]
    jp_q, jstates, jscales = ranks["jax"]["int8"]
    for r, res in enumerate(ranks["res"]):
        fp32, int8 = res["fp32"], res["int8"]
        sc_ref = [m["loss_scale"] for m in fp32["metrics"]]
        sc_q = [m["loss_scale"] for m in int8["metrics"]]
        assert sc_q == sc_ref == jscales
        assert sc_ref[OVERFLOW_STEP] == sc_ref[0] / 2
        for name, e in zip(_names(), int8["residual"][-1]):
            n_elems = int(np.prod(np.shape(params[name]))) or 1
            assert e.shape == (jchunk_size(n_elems, N) * N,)
        assert fp32["residual"][-1] is None
        before, after = OVERFLOW_STEP, OVERFLOW_STEP + 1
        for a, b in zip(int8["master"][before], int8["master"][after]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(int8["residual"][before], int8["residual"][after]):
            np.testing.assert_array_equal(a, b)
        assert any(not np.array_equal(a, b) for a, b in zip(
            int8["residual"][0], int8["residual"][1]))
        for a, b in zip(int8["params"][-1], fp32["params"][-1]):
            np.testing.assert_allclose(a, b, rtol=5e-2, atol=5e-2)
        # the masters against the JAX int8 wire's (this rank's chunks)
        for name, got in zip(_names(), int8["master"][-1]):
            full = np.asarray(jstates[-1].master[name])
            k = full.size // N
            np.testing.assert_allclose(got, full[r * k:(r + 1) * k],
                                       rtol=0, atol=1e-5, err_msg=name)


def test_stochastic_rounding_wire_runs_and_advances_key(ranks):
    for res in ranks["res"]:
        sr = res["int8_sr"]
        gens = sr["gen"]
        assert gens[0] is not None
        # the dither stream advances every step, through the skip too
        for a, b in zip(gens[:-1], gens[1:]):
            assert not np.array_equal(a, b)
        for p in sr["params"][-1]:
            assert np.all(np.isfinite(p))


def test_reduce_dtype_none_keeps_legacy_state_shape(ranks):
    for res in ranks["res"]:
        assert all(r is None for r in res["fp32"]["residual"])
    mesh.initialize_model_parallel()
    z = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2),
                                    amp.get_policy("O2"), zero_axis="data")
    ps = [torch.ones(13, 7, dtype=torch.bfloat16)]
    assert z.init(ps).residual is None
    assert z.zero_abstract_state(ps).residual is None


def test_int8_param_gather_end_to_end(ranks):
    ref = [res["g_int8"]["params"][0] for res in ranks["res"]]
    for other in ref[1:]:
        for a, b in zip(ref[0], other):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ref[0], ranks["res"][0]["g_bf16"]["params"][0]):
        assert np.abs(a - b).max() <= 0.02 * (np.abs(b).max() + 1e-6)


def test_reduce_dtype_validation():
    policy = amp.get_policy("O2")
    with pytest.raises(ValueError, match="zero_axis"):
        amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), policy,
                                    reduce_dtype="int8")
    with pytest.raises(ValueError, match="zero_level=3"):
        amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), policy,
                                    zero_axis="data", zero_level=3,
                                    reduce_dtype="int8")
    with pytest.raises(ValueError, match="stochastic_rounding"):
        amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), policy,
                                    zero_axis="data", reduce_dtype="e5m2",
                                    stochastic_rounding=True)
    with pytest.raises(ValueError):
        amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), policy,
                                    zero_axis="data", reduce_dtype="int4")
    with pytest.raises(ValueError, match="zero_level=3"):
        amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), policy,
                                    zero_axis="data", zero_level=3,
                                    gather_dtype="int8")
    from apex_tpu_torch.optimizers.distributed import gather_stacked_leaf

    with pytest.raises(ValueError, match="per-LEAF"):
        gather_stacked_leaf(torch.ones(2, 4), (8,), torch.float32, "data",
                            gather_dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), policy,
                                    zero_axis="data",
                                    gather_dtype=torch.int16)
    # the two-tier ZeRO collectives are a later item
    with pytest.raises(NotImplementedError, match="item 16"):
        amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-2), policy,
                                    zero_axis="data", dcn_axis="dcn")


def test_activation_comm_dtype_serial_twin_ignores_knob():
    cfg = dict(SP_WIDTH, axis=None, sequence_parallel=True, remat=False)
    m = GPTModel(GPTConfig(**cfg, activation_comm_dtype="int8"),
                 device="cpu")
    plain = GPTModel(GPTConfig(**cfg), device="cpu")
    assert m._acd is None
    toks = torch.zeros((2, 32), dtype=torch.long)
    loss = m.loss(toks, toks)
    assert np.isfinite(float(loss))
    assert float(loss) == float(plain.loss(toks, toks))


def test_activation_comm_dtype_requires_sequence_parallel():
    mesh.initialize_model_parallel()
    with pytest.raises(ValueError, match="activation_comm_dtype"):
        GPTModel(GPTConfig(**SP_WIDTH, axis="model",
                           activation_comm_dtype="int8"), device="cpu")
    from apex_tpu_torch.transformer import tensor_parallel as tp

    with pytest.raises(ValueError, match="comm_dtype"):
        tp.RowParallelLinear(8, 8, axis="model", comm_dtype="int8")


def _jax_sp_loss(acd, sp):
    from apex_tpu.parallel import collectives as jcc

    hybrid = jmesh.make_virtual_mesh(N, tensor_model_parallel_size=2)
    cfg = JaxGPTConfig(**SP_WIDTH, axis=jmesh.AXIS_MODEL,
                       sequence_parallel=True, activation_comm_dtype=acd,
                       remat=False)
    model = JaxGPTModel(cfg)
    from apex_tpu.transformer import tensor_parallel as jtp

    specs = model.specs()
    placed = jtp.shard_params(jax.tree.map(jnp.asarray, sp["tree"]), specs,
                              hybrid)

    def step(p, t, tg):
        return jcc.pmean(model.loss(p, t, tg),
                         jmesh.get_gradient_reduction_axes())

    fn = jax.jit(jax.shard_map(
        step, mesh=hybrid, in_specs=(specs, P(jmesh.AXIS_DATA),
                                     P(jmesh.AXIS_DATA)),
        out_specs=P(), check_vma=False))
    try:
        return float(fn(placed, jnp.asarray(sp["toks"]),
                        jnp.asarray(sp["tgts"])))
    finally:
        jmesh.destroy_model_parallel()


def test_sp_quantized_activations_track_exact(ranks):
    jl = {"exact": _jax_sp_loss(None, ranks["inp"]["sp"]),
          "int8": _jax_sp_loss("int8", ranks["inp"]["sp"])}
    for res in ranks["res"]:
        sp = res["sp"]
        le, lq = sp["exact"]["loss"], sp["int8"]["loss"]
        assert abs(lq - le) < 0.05 * abs(le) + 1e-3, (lq, le)
        for label in ("exact", "int8"):
            assert abs(sp[label]["loss"] - jl[label]) \
                <= 1e-3 * abs(jl[label]), label
        for name, a in sp["exact"]["grads"].items():
            b = sp["int8"]["grads"][name]
            denom = np.abs(a).max() + 1e-6
            assert np.abs(a - b).max() / denom < 0.15, name


def test_paired_wire_convergence_gate(ranks):
    for res in ranks["res"]:
        fp32, int8 = res["paired"]["fp32"], res["paired"]["int8"]
        assert len(fp32) == len(int8) == 6
        drop = fp32[0] - fp32[-1]
        if drop <= 0:
            drop = abs(fp32[-1]) or 1.0
        assert int8[-1] <= fp32[-1] + 0.1 * drop, (fp32, int8)
    # every rank reports the same (data-mean) losses
    for res in ranks["res"][1:]:
        assert res["paired"] == ranks["res"][0]["paired"]
