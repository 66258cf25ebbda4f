"""The port's convergence probe (``apex_tpu_torch.benchmarks.
convergence_probe``) and ``utils/io.atomic_write_json`` on the CPU.

``run_probe`` at a tiny width (hidden 64, 2 layers, 4 heads, vocab 256,
seq 32, batch 2, 4 steps, warm-up 2) is held against the same loop built
from the JAX package's ``GPTModel``, ``MixedPrecisionOptimizer`` and
``FusedAdam`` (O2, full remat, the 8-chunk LM head, the per-step warm-up
lr), eager and not jitted (jit drops a bf16 rounding in ``embed``: ROADMAP
Queue 3), on the same weights (``params_from_numpy``) and corpus: with fp32
compute every loss within 1e-4 relative; with bf16 compute within 2e-3
relative, well inside the reference's 0.05 replay band. ``main`` runs its
``--emit-curve`` entry and writes the reference's record keys plus the
port's; a failed CPU replay fails the record.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.benchmarks import convergence_probe as cp
from apex_tpu_torch.utils import io
from apex_tpu_torch.utils.io import atomic_write_json

TINY = dict(hidden=64, layers=2, heads=4, vocab=256)
TINY_ARGS = ["--hidden", "64", "--layers", "2", "--heads", "4", "--vocab",
             "256", "--seq", "32", "--batch", "2", "--warmup", "2"]
#: the record's keys in the reference (convergence_probe.py:134-147)
REFERENCE_KEYS = {"metric", "platform", "steps", "lr", "warmup_steps",
                  "batch", "seq", "loss_first", "loss_final",
                  "loss_max_after_warmup", "overflow_steps",
                  "final_loss_scale", "wall_seconds", "curve_every_10", "ok"}
#: its cpu_check keys (:153-160), the card's curve renamed from tpu_curve
CPU_CHECK_KEYS = {"steps", "device_curve", "cpu_curve",
                  "cpu_curve_max_rel_dev", "band", "ok"}


def _jax_probe(steps, lr, warmup, compute_dtype, seq=32, batch=2):
    """The reference's probe loop (``convergence_probe.py:50-97``) at the
    tiny width, eager; returns (losses, overflows, scale, params tree,
    corpus)."""
    cfg = JaxGPTConfig(vocab_size=TINY["vocab"], hidden_size=TINY["hidden"],
                       num_layers=TINY["layers"],
                       num_attention_heads=TINY["heads"], max_seq_len=seq,
                       hidden_dropout=0.0, axis=None,
                       compute_dtype=compute_dtype, remat=True,
                       lm_head_chunks=8)
    model = JaxGPTModel(cfg)
    policy = jamp.get_policy("O2")
    mp_opt = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=lr), policy)
    init = model.init(jax.random.PRNGKey(0))
    params = jamp.cast_params(init, policy)
    opt_state = mp_opt.init(params)
    corpus = jax.random.randint(jax.random.PRNGKey(1), (2, batch, seq), 0,
                                cfg.vocab_size)
    losses, overflows = [], 0
    for i in range(steps):
        tokens = corpus[i % 2]
        targets = jnp.roll(tokens, -1, axis=-1)

        def scaled(p):
            return mp_opt.scale_loss(model.loss(p, tokens, targets),
                                     opt_state)

        loss_s, grads = jax.value_and_grad(scaled)(params)
        loss = loss_s / opt_state.scaler.loss_scale
        lr_t = jnp.float32(lr * min(1.0, (i + 1) / max(warmup, 1)))
        params, opt_state, metrics = mp_opt.apply_gradients(
            opt_state, params, grads, lr_t=lr_t)
        losses.append(float(loss))
        overflows += int(metrics["found_inf"])
    return (losses, overflows, float(opt_state.scaler.loss_scale),
            jax.tree.map(np.asarray, init), np.asarray(corpus))


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4),
                                        ("bfloat16", 2e-3)])
def test_run_probe_matches_eager_jax(dtype, rtol):
    lr, warmup, steps = 3e-3, 2, 4
    jl, jo, js, tree, corpus = _jax_probe(steps, lr, warmup,
                                          getattr(jnp, dtype))
    tl, to, ts = cp.run_probe(steps, lr=lr, warmup=warmup, batch=2, seq=32,
                              device="cpu",
                              compute_dtype=getattr(torch, dtype),
                              params=tree, corpus=corpus,
                              **TINY)
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert tl[-1] < tl[0]  # it learns
    assert (to, ts) == (jo, js) == (0, 2.0 ** 16)


def test_emit_curve_prints_the_loss_list(capsys):
    assert cp.main(["--emit-curve", "2", "--device", "cpu", *TINY_ARGS]) == 0
    losses = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_record_keys_and_replay(tmp_path, capsys):
    out = tmp_path / "probe.json"
    rc = cp.main(["--device", "cpu", "--steps", "3", "--cpu-check-steps",
                  "2", "--output", str(out), *TINY_ARGS])
    rec = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == rec
    assert set(rec) == REFERENCE_KEYS | set(cp.ADDED_KEYS) | {"cpu_check"}
    assert set(rec["cpu_check"]) == CPU_CHECK_KEYS | {"seconds"}
    assert rec["platform"] == "cpu" and rec["card"] is None
    assert rec["metric"] == "gpt2_345m_o2_convergence"
    # the replay runs the same weights and corpus: the same curve here
    assert rec["cpu_check"]["cpu_curve_max_rel_dev"] == 0.0
    assert rec["cpu_check"]["ok"] is True
    assert rec["ok"] is True and rc == 0  # a tiny model sits below 6.0
    assert rec["loss_max_after_warmup"] == rec["loss_final"]


def test_a_failed_replay_fails_the_record(monkeypatch, tmp_path):
    """The reference keeps ``ok`` on the loss alone when its replay
    raises; here the error is recorded and ``ok`` is false."""

    class Failed:
        returncode, stdout, stderr = 3, "", "boom"

    monkeypatch.setattr(cp.subprocess, "run", lambda *a, **k: Failed())
    out = tmp_path / "probe.json"
    rc = cp.main(["--device", "cpu", "--steps", "2", "--cpu-check-steps",
                  "2", "--output", str(out), *TINY_ARGS])
    rec = json.loads(out.read_text())
    assert rc == 1 and rec["ok"] is False
    assert "exited 3" in rec["cpu_check"]["error"]
    assert "boom" in rec["cpu_check"]["error"]


def test_the_probe_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cp.main(["--steps", "1", *TINY_ARGS])
    args = cp.parse_args([])
    assert (args.steps, args.lr, args.warmup, args.batch, args.seq,
            args.cpu_check_steps, args.cpu_band, args.hidden, args.layers,
            args.heads, args.vocab) == (600, 3e-4, 50, 2, 512, 6, 0.05,
                                        1024, 24, 16, 50304)


def test_atomic_write_json_leaves_no_temp_file(tmp_path):
    path = tmp_path / "sub" / "rec.json"
    assert atomic_write_json(str(path), {"a": [1, 2], "b": 0.5}) == str(path)
    assert json.loads(path.read_text()) == {"a": [1, 2], "b": 0.5}
    assert os.listdir(path.parent) == ["rec.json"]
    # objects JSON lacks go through str, as the reference's default
    atomic_write_json(str(path), {"dtype": torch.float32})
    assert json.loads(path.read_text()) == {"dtype": "torch.float32"}


def test_a_crash_before_the_rename_keeps_the_old_file(tmp_path,
                                                      monkeypatch):
    path = tmp_path / "rec.json"
    atomic_write_json(str(path), {"old": True})

    def crash(src, dst):
        raise OSError("killed before the rename")

    monkeypatch.setattr(io.os, "replace", crash)
    with pytest.raises(OSError, match="before the rename"):
        atomic_write_json(str(path), {"new": True})
    assert json.loads(path.read_text()) == {"old": True}
    assert os.listdir(tmp_path) == ["rec.json"]  # the temp file is gone
