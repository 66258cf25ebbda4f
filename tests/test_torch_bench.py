"""apex_tpu_torch.bench (``python -m apex_tpu_torch.bench``) on the CPU.

- the 15 cases of ``tests/test_bench.py`` that need no ``monitor/`` or
  ``pyprof/`` (the window statistics, the OOM cause chain with a torch OOM,
  the headline, O0 and degraded evidence, the BERT rung ladder);
- ``build("O0")``: two steps against the JAX package's root
  ``bench.build("O0", "xla")`` step on the same params and tokens (the loss
  and every param within 1e-5 of each leaf's max); the plain Adam against
  ``optax.adam`` over 3 steps;
- the window protocol, the ladders and ``gpt_headline``'s fallbacks with
  stub legs; ``main``'s record with stub children and stages;
- ``selftest()`` returns every entry, and an entry that raises is isolated;
- the telemetry variables and ``--gpt-profile`` raise, naming item 21.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu_torch import bench
from apex_tpu_torch._params import module_tree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench as jbench  # noqa: E402  (the JAX package's root bench.py)


def _oom(msg="CUDA out of memory. Tried to allocate 2.00 GiB (simulated)"):
    raise torch.cuda.OutOfMemoryError(msg)


def _stats_of(m):
    return {"median": m, "min": m, "max": m, "windows": 3}


# -- the mirrored cases of tests/test_bench.py ------------------------------


def test_stats_median_min_max():
    s = bench._stats([3.0, 1.0, 2.0])
    assert s == {"median": 2.0, "min": 1.0, "max": 3.0, "windows": 3}
    s = bench._stats([4.0, 1.0, 2.0, 3.0])
    assert s["median"] == 2.5


def test_is_oom_walks_cause_chain():
    assert bench._is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    # the ladder re-raises with the allocator message embedded
    assert bench._is_oom(RuntimeError("O2: OOM even at batch 1; last: x"))
    inner = torch.cuda.OutOfMemoryError("CUDA out of memory. (hbm)")
    outer = RuntimeError("wrapper without the marker")
    outer.__cause__ = inner
    assert bench._is_oom(outer)
    assert not bench._is_oom(ValueError("unrelated failure"))


def test_headline_evidence_full_record(monkeypatch):
    monkeypatch.setattr(bench, "gpt_headline", lambda *a, **k: (
        _stats_of(100.0), _stats_of(40.0), 8, True))
    frag, errs = bench._gpt_headline_evidence(8, 1024, 10)
    assert errs == {}
    assert frag["value"] == 100.0
    assert frag["vs_baseline"] == 2.5
    assert frag["spread"]["interleaved"] is True
    assert "effective_batch" not in frag


def test_headline_evidence_salvages_value_without_baseline(monkeypatch):
    monkeypatch.setattr(bench, "gpt_headline", lambda *a, **k: (
        _stats_of(100.0), None, 4, False))
    frag, errs = bench._gpt_headline_evidence(8, 1024, 10)
    assert frag["value"] == 100.0
    assert "vs_baseline" not in frag
    assert frag["effective_batch"] == 4
    assert "baseline" in errs


def test_headline_evidence_records_total_failure(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("O2: OOM even at batch 1; last: out of memory")

    monkeypatch.setattr(bench, "gpt_headline", boom)
    frag, errs = bench._gpt_headline_evidence(8, 1024, 10)
    assert frag == {}
    assert "headline" in errs


def test_headline_evidence_reraises_non_oom(monkeypatch):
    def boom(*a, **k):
        raise ValueError("a real bug, not memory pressure")

    monkeypatch.setattr(bench, "gpt_headline", boom)
    with pytest.raises(ValueError):
        bench._gpt_headline_evidence(8, 1024, 10)


def test_o0_evidence_success(monkeypatch):
    rung = {"remat": "full", "scan": 1, "unroll": True}
    monkeypatch.setattr(bench, "measure_resilient",
                        lambda *a, **k: ([40.0, 41.0, 42.0], 4, rung))
    frag, errs = bench._gpt_o0_evidence(8, 1024, 10)
    assert errs == {}
    assert frag["o0"]["median"] == 41.0
    assert frag["o0"]["batch"] == 4
    assert frag["o0"]["rung"] == rung


def test_o0_evidence_records_oom(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("O0: OOM even at batch 1; last: out of memory")

    monkeypatch.setattr(bench, "measure_resilient", boom)
    frag, errs = bench._gpt_o0_evidence(8, 1024, 10)
    assert frag == {}
    assert "o0_baseline" in errs


def test_o0_evidence_reraises_non_oom(monkeypatch):
    def boom(*a, **k):
        raise ValueError("a real bug, not memory pressure")

    monkeypatch.setattr(bench, "measure_resilient", boom)
    with pytest.raises(ValueError):
        bench._gpt_o0_evidence(8, 1024, 10)


def test_degraded_evidence_falls_to_smaller_rung(monkeypatch):
    calls = []

    def fake(batch, seq, steps, windows=3, hidden=None, layers=None):
        calls.append((hidden, layers))
        if hidden == 768:
            raise RuntimeError("O2: OOM even at batch 1; last: out of memory")
        return _stats_of(50.0), _stats_of(25.0), 2, True

    monkeypatch.setattr(bench, "gpt_headline", fake)
    frag, errs = bench._gpt_degraded_evidence(4, 1024, 10)
    assert calls == [(768, 12), (512, 4)]
    d = frag["gpt_degraded"]
    assert d["hidden"] == 512 and d["layers"] == 4
    assert d["tokens_per_sec"] == 50.0 and d["vs_baseline"] == 2.0
    assert "gpt_degraded" in errs


def test_degraded_evidence_handles_missing_baseline(monkeypatch):
    monkeypatch.setattr(bench, "gpt_headline", lambda *a, **k: (
        _stats_of(50.0), None, 2, False))
    frag, _ = bench._gpt_degraded_evidence(4, 1024, 10)
    d = frag["gpt_degraded"]
    assert d["tokens_per_sec"] == 50.0
    assert "vs_baseline" not in d and "o0" not in d["spread"]


def test_bert_resilient_flagship_passes_through():
    def measure(batch, steps, windows, hidden=None, layers=None):
        assert hidden is None and layers is None
        return dict(_stats_of(9000.0), batch=8, unroll=True)

    rec = bench.bench_bert_resilient(8, 10, 3, measure=measure)
    assert rec["median"] == 9000.0
    assert "degraded" not in rec


def test_bert_resilient_degrades_with_provenance():
    calls = []

    def measure(batch, steps, windows, hidden=None, layers=None):
        calls.append((hidden, layers))
        if hidden is None:
            _oom("bert: CUDA out of memory even at batch 1")
        return dict(_stats_of(4000.0), batch=4, unroll=True)

    rec = bench.bench_bert_resilient(8, 10, 3, measure=measure)
    assert calls == [(None, None), (768, 12)]
    assert rec["median"] == 4000.0
    assert rec["degraded"]["hidden"] == 768
    assert rec["degraded"]["layers"] == 12
    assert "out of memory" in rec["degraded"]["flagship_oom"]


def test_bert_resilient_exhausted_ladder_raises_oom_marker():
    def measure(batch, steps, windows, hidden=None, layers=None):
        _oom()

    with pytest.raises(RuntimeError, match="smallest degraded rung"):
        bench.bench_bert_resilient(8, 10, 3, measure=measure)


def test_bert_resilient_reraises_non_oom():
    def measure(batch, steps, windows, hidden=None, layers=None):
        raise ValueError("a real bug, not memory pressure")

    with pytest.raises(ValueError):
        bench.bench_bert_resilient(8, 10, 3, measure=measure)


# -- the O0 leg against the JAX package's ------------------------------------


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_o0_build_two_steps_match_the_jax_o0_step(capsys):
    """``build("O0")`` at hidden 64, one layer (vocab 50304 and seq 1024
    are fixed by ``build``) against ``bench.build("O0", "xla")``'s step on
    the JAX ``init`` params, two steps: the losses (1e-5), the Adam moments
    and every param within 1e-5 of each leaf's max |value|. One exception,
    counted: Adam's update lr * g / (|g| + eps) turns the fp32 summation
    noise of a small g into a difference of up to the eps term's share of
    the update, lr * eps / (|g| + eps) a step, which for |g| near eps (1e-8)
    is most of lr; an element may differ by that much over the two steps
    (|g| the smaller of its two gradients, read from optax's nu), and such
    elements must be fewer than 1e-4 of all (63 of 3.3M here)."""
    jstep, jp, js = jbench.build("O0", "xla", hidden=64, layers=1)
    jstep = jax.jit(jstep)
    tb = bench.build("O0", hidden=64, layers=1, batch=1, device="cpu")
    assert "O0 leg: fp32 compute" in capsys.readouterr().err
    tb.load_params_(jax.tree.map(np.asarray, jp))
    assert tb.opt_state.master is None  # O0 keeps no masters
    assert all(p.dtype == torch.float32 for p in tb.model.parameters())
    assert tb.cfg.lm_head_chunks is None and tb.cfg.remat
    tokens = np.random.default_rng(5).integers(0, 50304, (1, 1024)).astype(
        np.int32)
    targets = np.roll(tokens, -1, axis=-1)
    nus = []  # optax's nu after each step: each step's |g| from it
    for _ in range(2):
        jp, js, jloss, _ = jstep(jp, js, jnp.asarray(tokens),
                                 jnp.asarray(targets))
        nus.append(dict(_leaves(jax.tree.map(np.asarray, js.inner[0].nu))))
        loss, m = tb.step(torch.from_numpy(tokens).long(),
                          torch.from_numpy(targets).long())
        assert not m["found_inf"] and m["loss_scale"] == 1.0
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jadam = js.inner[0]
    assert int(jadam.count) == tb.opt_state.inner.step == 2
    inner = tb.opt_state.inner
    pairs = {
        "params": (module_tree(tb.model), jp),
        "mu": (module_tree(tb.model, inner.exp_avg), jadam.mu),
        "nu": (module_tree(tb.model, inner.exp_avg_sq), jadam.nu)}
    # the smaller |g| of an element's two steps
    g_min = {k: np.sqrt(np.minimum(
        v / 1e-3, np.maximum(nus[1][k] - 0.999 * v, 0.0) / 1e-3))
        for k, v in nus[0].items()}
    loose = total = 0
    for what, (port, ref) in pairs.items():
        got = dict(_leaves(port))
        want = dict(_leaves(jax.tree.map(np.asarray, ref)))
        assert sorted(got) == sorted(want), what
        for path, w in want.items():
            d = np.abs(got[path].numpy() - w)
            tight = d <= 1e-5 * float(np.max(np.abs(w)))
            if what == "params":
                eps_term = 2 * 1e-4 * 1e-8 / (g_min[path] + 1e-8)
                assert np.all(tight | (d <= eps_term)), (
                    path, float(d.max()))
                loose += int((~tight).sum())
                total += d.size
            else:
                assert tight.all(), (what, path, float(d.max()))
    print(f"params beyond 1e-5 of the leaf max: {loose} of {total}")
    assert loose <= 1e-4 * total, (loose, total)


def test_o2_build_loads_the_jax_params_and_its_masters():
    _, jp, _ = jbench.build("O2", "xla", hidden=32, layers=1)
    tb = bench.build("O2", hidden=32, layers=1, batch=1, device="cpu")
    tb.load_params_(jax.tree.map(np.asarray, jp))
    assert tb.model.layers[0].qkv.kernel.dtype == torch.bfloat16
    for p, m in zip(tb.model.parameters(), tb.opt_state.master):
        assert m.dtype == torch.float32 and torch.equal(m, p.float())
    np.testing.assert_array_equal(
        tb.model.ln_f.scale.detach().numpy(), np.asarray(jp["ln_f"]["scale"]))


def test_plain_adam_matches_optax_over_three_steps():
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = optax.adam(1e-3)
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    opt = bench.Adam(lr=1e-3)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    state = opt.init(tparams)
    for _ in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) * 1e-2
                 for s in shapes]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        state = opt.update_(tparams, [torch.from_numpy(g) for g in grads],
                            state)
    assert state.step == 3
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-7,
                                   rtol=1e-6)


# -- the window protocol, the ladders and the headline ---------------------


def test_timed_windows_stop_on_a_read_of_the_last_loss():
    box = {"steps": 0}

    def advance():
        box["steps"] += 1

    rates = bench._timed_windows(
        advance, lambda: torch.tensor(float(box["steps"])), steps=4,
        windows=3, per_window_units=100)
    assert box["steps"] == 12 and len(rates) == 3
    assert all(r > 0 for r in rates)
    with pytest.raises(AssertionError, match="non-finite"):
        bench._timed_windows(advance, lambda: torch.tensor(float("nan")),
                             steps=1, windows=1, per_window_units=1)


def test_oom_halving_and_prepare_resilient_ladder(monkeypatch):
    tried = []

    def run(b):
        tried.append(b)
        if b > 2:
            _oom()
        return b

    assert bench._oom_halving(run, 8, min_batch=1, label="t") == 2
    assert tried == [8, 4, 2]
    with pytest.raises(torch.cuda.OutOfMemoryError):
        bench._oom_halving(run, 8, min_batch=4, label="t")

    built = []

    def fake_prepare(level, batch, seq, steps, *, hidden=None, layers=None):
        built.append((level, batch))
        if batch > 2:
            _oom()
        return ("adv", "loss", steps, batch * seq * steps, "bench")

    monkeypatch.setattr(bench, "_prepare", fake_prepare)
    out = bench.prepare_resilient("O0", 8, 16, 3, retries=0)
    assert out[-2] == 2 and out[3] == 2 * 16 * 3
    assert out[-1] == {"remat": "full", "scan": 1, "unroll": True,
                       "zero": False, "zero_level": 0, "reduce_dtype": None}
    assert built == [("O0", 8), ("O0", 4), ("O0", 2)]
    with pytest.raises(RuntimeError, match="OOM even at batch 4"):
        bench.prepare_resilient("O2", 8, 16, 3, min_batch=4, retries=0)
    assert bench._is_oom(RuntimeError("O2: OOM even at batch 4; last: x"))


def _fake_leg(units, fail_after=None):
    """A prepared leg whose loss is its step count; ``fail_after`` steps
    later it runs out of memory."""
    box = {"n": 0}

    def advance():
        box["n"] += 1
        if fail_after is not None and box["n"] > fail_after:
            _oom()

    return advance, lambda: box["n"], 2, units, box


def test_gpt_headline_interleaves_and_falls_back(monkeypatch):
    legs = {}

    def fake(level, batch, seq, steps, *, min_batch=1, **kw):
        if level == "O0" and min_batch == batch and "O0" in legs:
            _oom()  # cannot sit beside O2
        legs[level] = _fake_leg(1000.0)
        return legs[level][:4] + (legs[level][4], batch, {"remat": "full"})

    monkeypatch.setattr(bench, "prepare_resilient", fake)
    fused, base, common, inter = bench.gpt_headline(8, 1024, 2, windows=3)
    assert inter is True and common == 8 and base["windows"] == 3
    # O2 alone (3 windows), then 3 interleaved: 1 warm-up-free leg each
    assert legs["O2"][4]["n"] == 12 and legs["O0"][4]["n"] == 6

    # O0 cannot sit beside O2: sequential legs, interleaved False
    monkeypatch.setattr(bench, "measure_resilient", lambda level, b, *a,
                        **k: ([10.0, 20.0, 30.0], b, {"remat": "full"}))
    fused, base, common, inter = bench.gpt_headline(8, 1024, 2, windows=3)
    assert inter is False and base["median"] == 20.0


def test_gpt_headline_keeps_only_completed_pairs(monkeypatch):
    legs = {}

    def fake(level, batch, seq, steps, *, min_batch=1, **kw):
        # O2: 3 solo windows + 2 paired (2 steps each), then OOM in pair 3
        legs[level] = _fake_leg(1000.0, 10 if level == "O2" else None)
        return legs[level][:4] + (legs[level][4], batch, {"remat": "full"})

    monkeypatch.setattr(bench, "prepare_resilient", fake)
    fused, base, _, inter = bench.gpt_headline(8, 1024, 2, windows=3)
    assert inter is True and fused["windows"] == base["windows"] == 2


# -- main, the command line and the selftest --------------------------------


def test_main_assembles_the_record(monkeypatch, capsys, tmp_path):
    """``main`` with stub GPT children (each prints its fragment and its
    launch counts) and stub stages: one JSON line with the headline, the
    rungs with their canary readings, the selftest and the launches."""
    frag = {"value": 100.0, "vs_baseline": 3.5,
            "spread": {"o2": _stats_of(100.0), "o0": _stats_of(28.6),
                       "interleaved": True},
            "kernel_launches": {"flash_attention_fwd": 7}}
    stub = tmp_path / "child.py"
    stub.write_text(f"import json; print('noise'); "
                    f"print(json.dumps({frag!r}))\n")
    monkeypatch.setattr(bench, "_child_cmd",
                        lambda flag: [sys.executable, "-S", str(stub)])
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setattr(bench, "selftest", lambda: {"all_ok": True})
    monkeypatch.setattr(bench, "_canary", lambda: 123.4)
    monkeypatch.setattr(bench, "bench_resnet50",
                        lambda: dict(_stats_of(900.0), batch=64))

    def bert_fails():
        raise ValueError("stage failure")

    monkeypatch.setattr(bench, "bench_bert_resilient", bert_fails)
    from apex_tpu_torch.benchmarks import optimizer_step

    monkeypatch.setattr(optimizer_step, "gpt2_like_params",
                        lambda device=None: [torch.zeros(4)])
    assert bench.main() == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "gpt2_345m_o2_train_tokens_per_sec"
    assert rec["value"] == 100.0 and rec["vs_baseline"] == 3.5
    assert rec["spread"]["interleaved"] is True
    assert rec["resnet50_o2_imgs_per_sec"]["canary_tf_s"] == {
        "before": 123.4, "after": 123.4}
    assert rec["selftest"] == {"all_ok": True}
    assert rec["fused_opt_step_vs_eager"] > 0
    assert rec["errors"] == {"bert_large_lamb_tokens_per_sec":
                             "stage failure"}
    assert rec["kernel_launches"]["by_stage"]["gpt-headline"] == {
        "flash_attention_fwd": 7}
    assert rec["kernel_launches"]["total"]["flash_attention_fwd"] == 7
    assert "gpt_degraded" not in rec


def test_cli_child_flag_prints_its_fragment(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_CHILDREN", dict(
        bench._CHILDREN, **{"--gpt-o0": lambda b, s, n: (
            {"o0": dict(_stats_of(41.0), batch=b)}, {"x": "y"})}))
    monkeypatch.setenv("BENCH_BATCH", "4")
    assert bench.cli(["--gpt-o0", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["o0"]["batch"] == 4 and rec["errors"] == {"x": "y"}
    assert set(rec["kernel_launches"]) >= {"flash_attention_fwd",
                                           "xentropy_bwd"}


SMALL_SELFTEST = {
    "flash_attention": (1, 2, 40, 16),
    "flash_attention_8k_segments_streamed": (1, 2, 48, 16),
    "norm": (8, 64),
    "scaled_masked_softmax": (1, 2, 16, 16),
    "xentropy": (8, 64),
    "lm_head_loss": (2, 8, 16, 64),
}


def test_selftest_on_the_cpu_returns_every_entry(monkeypatch):
    monkeypatch.setattr(bench, "SELFTEST_SHAPES", SMALL_SELFTEST)
    res = bench.selftest(device="cpu")
    names = {"flash_attention", "flash_attention_8k_segments_streamed",
             "layer_norm", "rms_norm", "scaled_masked_softmax", "xentropy",
             "lm_head_loss"}
    assert names <= set(res) and res["platform"] == "cpu"
    for name in names:
        e = res[name]
        assert e["ok"], (name, e)
        assert e["tol_norm"] == (1e-3 if name == "xentropy" else 2e-2)
        assert {"fwd_max_abs_err", "fwd_norm_err", "bwd_max_abs_err",
                "bwd_norm_err"} <= set(e)
    assert res["all_ok"] is True


def test_selftest_isolates_an_entry_that_raises(monkeypatch):
    from apex_tpu_torch import ops

    def broken(*a, **k):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(bench, "SELFTEST_SHAPES", SMALL_SELFTEST)
    monkeypatch.setattr(ops, "rms_norm", broken)
    res = bench.selftest(device="cpu")
    assert res["rms_norm"] == {"error": "kernel failed to launch"}
    assert res["layer_norm"]["ok"] and res["lm_head_loss"]["ok"]
    assert res["all_ok"] is False


def test_compare_flags_a_wrong_route():
    x = torch.randn(4, 8)
    e = bench._compare(lambda x: x * 1.1, lambda x: x, (x,), 2e-2,
                       grad_argnums=(0,))
    assert not e["ok"] and e["fwd_norm_err"] > 0.05
    assert abs(e["bwd_norm_err"] - 0.1) < 1e-5


@pytest.mark.parametrize("var", bench.MONITOR_VARS)
def test_the_telemetry_variables_raise_naming_item_21(monkeypatch, var):
    monkeypatch.setenv(var, "/tmp/x")
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    for call in (bench.main, lambda: bench.cli([]),
                 lambda: bench.build("O2", hidden=32, layers=1)):
        with pytest.raises(NotImplementedError, match="item 21"):
            call()


def test_gpt_profile_raises_naming_item_21():
    with pytest.raises(NotImplementedError, match="item 21"):
        bench.cli(["--gpt-profile", "--device", "cpu"])


def test_the_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (bench.main, lambda: bench.selftest(),
                 lambda: bench.build("O0", hidden=32, layers=1),
                 lambda: bench.cli(["--gpt-headline"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
