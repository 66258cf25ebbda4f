"""The long-context slice of apex_tpu_torch against the JAX package on the
CPU: a tiny GPT with rotary positions and a sliding window (and one with
learned positions) through the streamed attention's plain versions, the O2
FusedAdam steps of the port's ``examples/longcontext`` ``build`` against the
same steps built from the JAX package as its example builds them, and the
example's ``main``.

Tolerances: fp32 loss 1e-6 relative and every grad 1e-5 absolute (fp32
through 2 layers and the head, summed in another order); the O2 steps in
fp32 compute (bf16 weights, fp32 masters): losses 1e-5 relative, masters
within 1e-3 of how far they moved (L2), the bf16 params equal to their
masters cast down.
"""

import importlib
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu_torch.bench import train_steps
from apex_tpu_torch.models import GPTConfig, GPTModel

tfa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
lc = importlib.import_module(
    "apex_tpu_torch.examples.longcontext.train_long_context")

TINY = dict(vocab_size=64, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_seq_len=128)
SEQ = 128


def _grads_by_name(tree, n_layers):
    """The JAX tree flattened to the port's parameter names."""
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


def _batch(seed, b=2, s=SEQ, vocab=64):
    tokens = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    return tokens, np.roll(tokens, -1, axis=-1)


@pytest.fixture
def streamed(monkeypatch):
    """Route every attention call of the tiny model to the streamed plain
    versions, with one-tile splits in the forward (rows span two) and the
    fp32 backward over whole bands of 64-row tiles, and count them."""
    monkeypatch.setattr(tfa, "STREAM_MIN_SEQ", 64)
    # the fp32 backward's tiles (the resident fp32 pair's): 64 rows kept
    monkeypatch.setattr(tfa, "RES_BWD_F32_OUTER_TILE", 64)
    # the fp32 forward's own tiles: 64-row query and key tiles, one a split
    monkeypatch.setattr(tfa, "FWD_F32_OUTER_TILE", 64)
    monkeypatch.setattr(tfa, "FWD_F32_INNER_TILE", 64)
    monkeypatch.setattr(tfa, "FWD_F32_SPLIT_TILES", 1)
    # the backward's own tiles cut too: 64-row outer, 32-row inner tiles
    monkeypatch.setattr(tfa, "BWD_OUTER_TILE", 64)
    monkeypatch.setattr(tfa, "BWD_INNER_TILE", 32)
    monkeypatch.setattr(tfa, "BWD_SPLIT_TILES", 1)
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for key, name in (("fwd", "flash_attention_fwd_stream_reference"),
                      ("dq", "flash_attention_bwd_dq_stream_reference"),
                      ("dkv", "flash_attention_bwd_dkv_stream_reference")):
        real = getattr(tfa, name)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tfa, name, counted)
    return calls


@pytest.mark.parametrize("pos,window", [("rope", 32), ("learned", None),
                                        ("rope", None)])
def test_loss_and_every_grad_match_jax(streamed, pos, window):
    extra = dict(position_embedding=pos, attention_window=window)
    jm = JaxGPTModel(JaxGPTConfig(axis=None, hidden_dropout=0.0,
                                  compute_dtype=jnp.float32, remat=True,
                                  lm_head_chunks=2, **extra, **TINY))
    jp = jm.init(jax.random.PRNGKey(0))
    assert ("position" in jp) == (pos == "learned")
    tm = GPTModel(GPTConfig(compute_dtype=torch.float32, remat=True,
                            lm_head_chunks=2, hidden_dropout=0.0, **extra,
                            **TINY), device="cpu")
    assert (tm.position is None) == (pos != "learned")
    tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    tokens, targets = _batch(3)
    jloss, jg = jax.value_and_grad(jm.loss)(jp, jnp.asarray(tokens),
                                            jnp.asarray(targets))
    loss = tm.loss(torch.from_numpy(tokens).long(),
                   torch.from_numpy(targets).long())
    loss.backward()
    layers = TINY["num_layers"]
    # forward + the remat recompute, then one backward, per layer
    assert streamed == {"fwd": 2 * layers, "dq": layers, "dkv": layers}
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    ref = _grads_by_name(jg, layers)
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(ref)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], atol=1e-5,
                                   err_msg=name)


def test_rope_model_needs_an_even_head_dim():
    with pytest.raises(ValueError, match="even head_dim"):
        GPTModel(GPTConfig(position_embedding="rope", vocab_size=64,
                           hidden_size=36, num_attention_heads=4),
                 device="cpu")


def _dist(a, b):
    return float(np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in a)))


def test_three_o2_fused_adam_steps_of_the_example_match_jax(monkeypatch,
                                                            streamed):
    """The example's ``build`` (O2: bf16 weights, fp32 norms and masters,
    dynamic loss scale, FusedAdam(lr=1e-4)) against the same three steps
    built from the JAX package's ``amp.get_policy("O2")``,
    ``amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-4))`` and ``model.loss``,
    as its example builds them (``:99-121``), with rope and a window. Both
    compute in fp32 (bf16 matmuls round at other places in XLA and
    PyTorch); the weights, their grads and the update rule are O2's."""
    from apex_tpu import amp as jamp
    from apex_tpu.optimizers import FusedAdam as JaxFusedAdam

    kw = dict(TINY, position_embedding="rope", attention_window=32,
              lm_head_chunks=2)
    real_cfg = lc.GPTConfig
    monkeypatch.setattr(lc, "GPTConfig", lambda **c: real_cfg(
        **dict(c, compute_dtype=torch.float32)))
    trainer = lc.build(seq=SEQ, hidden=64, layers=2, heads=4, vocab=64,
                       batch=2, lm_head_chunks=2, window=32, pos="rope",
                       device="cpu")
    model, st = trainer.model, trainer.opt_state
    assert model.layers[0].qkv.kernel.dtype == torch.bfloat16
    assert model.ln_f.scale.dtype == torch.float32

    jm = JaxGPTModel(JaxGPTConfig(axis=None, hidden_dropout=0.0,
                                  compute_dtype=jnp.float32, remat=True,
                                  **kw))
    policy = jamp.get_policy("O2")
    mp_opt = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=1e-4), policy)
    params = jamp.cast_params(jm.init(jax.random.PRNGKey(0)), policy)
    start = _grads_by_name(params, 2)
    opt_state = mp_opt.init(params)
    # the JAX init, cast, into the port's O2 params; masters upcast from them
    model.params_from_numpy(jax.tree.map(
        lambda a: np.asarray(a, np.float32), params))
    with torch.no_grad():
        for m, p in zip(st.master, model.parameters()):
            m.copy_(p)

    tokens, targets = _batch(4)
    jt, jy = jnp.asarray(tokens), jnp.asarray(targets)
    jlosses = []
    for _ in range(3):
        def scaled(p):
            return mp_opt.scale_loss(jm.loss(p, jt, jy), opt_state)

        ls, gs = jax.value_and_grad(scaled)(params)
        jlosses.append(float(ls / opt_state.scaler.loss_scale))
        params, opt_state, _ = mp_opt.apply_gradients(opt_state, params, gs)
    out = train_steps(trainer, 2, torch.from_numpy(tokens).long(),
                         torch.from_numpy(targets).long())
    assert not any(m["found_inf"] for m in out["metrics"])
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-5)
    assert st.scaler.loss_scale == float(opt_state.scaler.loss_scale)
    jmaster = _grads_by_name(opt_state.master, 2)
    names = [n for n, _ in model.named_parameters()]
    tmaster = {n: m.numpy() for n, m in zip(names, st.master)}
    assert _dist(tmaster, jmaster) <= 1e-3 * _dist(jmaster, start)
    for p, m in zip(model.parameters(), st.master):
        assert torch.equal(p, m.to(p.dtype))


def test_example_main_on_cpu_writes_the_reference_record(tmp_path, capsys):
    out = tmp_path / "rec.json"
    assert lc.main(["--device", "cpu", "--seq", "64", "--hidden", "32",
                    "--layers", "2", "--heads", "4", "--vocab", "64",
                    "--steps", "2", "--pos", "rope", "--window", "16",
                    "--lm-head-chunks", "2", "--output", str(out)]) == 0
    assert "tokens/s at context 64" in capsys.readouterr().out
    rec = json.loads(out.read_text())
    # the keys of the reference's record (train_long_context.py:186-198)
    assert sorted(rec) == sorted([
        "metric", "platform", "seq", "cp", "dp", "mode", "batch", "hidden",
        "layers", "lm_head_chunks", "window", "position_embedding",
        "steps_timed", "tokens_per_sec", "loss_final"])
    assert rec["metric"] == "longcontext_train_tokens_per_sec"
    assert rec["platform"] == "cpu" and rec["mode"] == "serial"
    assert rec["window"] == 16 and rec["position_embedding"] == "rope"
    assert np.isfinite(rec["loss_final"]) and rec["steps_timed"] == 1


@pytest.mark.parametrize("flag", [["--cp", "2"], ["--dp", "2"]])
def test_parallel_modes_raise_naming_their_roadmap_items(flag):
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        lc.main(["--device", "cpu", *flag])


def test_example_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lc.build(seq=64, hidden=32, layers=1, heads=4, vocab=64)
