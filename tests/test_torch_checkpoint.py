"""apex_tpu_torch.checkpoint and the token reader against the JAX package
on the CPU.

- the npz format both ways: a JAX ``save_checkpoint`` of an O2 train state
  restores into the port, and one more O2 step from it equals the JAX
  package's next step; a port checkpoint restores in the JAX package with
  every leaf equal (bf16 leaves bit for bit);
- the mirrored cases of ``tests/test_checkpoint.py``: round trip with bf16
  leaves, ``latest_step``, a missing leaf raises ``KeyError``;
- ``module_tree`` / ``state_tree`` give the JAX trees' keys, shapes and
  dtypes;
- ``TokenLoader``: the cases of ``tests/test_native_runtime.py:47-90``,
  each batch equal to the JAX loader's on the same ``.bin`` files.

Tolerances: the restored state is compared bit for bit; the step after a
restore computes in fp32 on both sides (bf16 matmuls round at other places
in XLA and PyTorch): loss 1e-5 relative, the masters within 1e-3 of how far
the step moved them (L2; Adam scales the near-zero grads of the key bias up
to the learning rate, so elementwise limits would hold rounding noise), the
bf16 params equal to their masters cast down.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from apex_tpu import amp as jamp
from apex_tpu import checkpoint as jckpt
from apex_tpu import csrc as jcsrc
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import amp, checkpoint
from apex_tpu_torch._params import load_tree_, module_tree, tensors_of_tree
from apex_tpu_torch.csrc import TokenLoader
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_seq_len=16)


def _jax_state(seed=0):
    model = JaxGPTModel(JaxGPTConfig(axis=None, hidden_dropout=0.0,
                                     compute_dtype=jnp.float32, remat=False,
                                     **TINY))
    policy = jamp.get_policy("O2")
    mp_opt = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=1e-3), policy)
    params = jamp.cast_params(model.init(jax.random.PRNGKey(seed)), policy)
    return model, mp_opt, params, mp_opt.init(params)


def _jax_step(model, mp_opt, params, opt_state, toks, tgt):
    def scaled(p):
        return mp_opt.scale_loss(model.loss(p, toks, tgt), opt_state)

    scale = float(opt_state.scaler.loss_scale)
    ls, gs = jax.value_and_grad(scaled)(params)
    params, opt_state, _ = mp_opt.apply_gradients(opt_state, params, gs)
    return params, opt_state, float(ls) / scale


def _port_state():
    model = GPTModel(GPTConfig(compute_dtype=torch.float32, **TINY),
                     device="cpu")
    policy = amp.get_policy("O2")
    amp.cast_params(model, policy)
    mp_opt = amp.MixedPrecisionOptimizer(FusedAdam(lr=1e-3), policy)
    return model, mp_opt, mp_opt.init(model)


def _batch(seed=1):
    toks = np.random.default_rng(seed).integers(0, 64, (2, 16))
    return toks, np.roll(toks, -1, axis=-1)


def _port_step(model, mp_opt, state, toks, tgt):
    loss = model.loss(torch.from_numpy(toks), torch.from_numpy(tgt))
    mp_opt.scale_loss(loss, state).backward()
    metrics = mp_opt.step(state, model)
    assert not metrics["found_inf"]
    return float(loss.detach())


def _flat(tree):
    """``{path: numpy array}`` (bf16 as ml_dtypes) of a JAX or port tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jckpt._path_key(path)
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.view(torch.int16).numpy().view(
                    ml_dtypes.bfloat16)
            else:
                leaf = leaf.numpy()
        out[key] = np.asarray(leaf)
    return out


def _dist(a, b):
    return float(np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in a)))


def _bytes(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX O2 state after one step, saved by the JAX package, restores
    into the port bit for bit; one more step on each side agrees."""
    jm, jopt, jp, js = _jax_state()
    toks, tgt = _batch(1)
    jp, js, _ = _jax_step(jm, jopt, jp, js, jnp.asarray(toks),
                          jnp.asarray(tgt))
    jckpt.save_checkpoint(str(tmp_path), 1, {"params": jp, "opt": js},
                          backend="npz")

    model, mp_opt, state = _port_state()
    target = {"params": module_tree(model, device="meta"),
              "opt": amp.state_tree(state, model, device="meta")}
    restored = checkpoint.restore_checkpoint(str(tmp_path), target)
    saved = _flat({"params": jp, "opt": js})
    got = _flat(restored)
    assert sorted(got) == sorted(saved)
    for key, ref in saved.items():
        assert got[key].dtype == ref.dtype, key
        np.testing.assert_array_equal(_bytes(got[key]), _bytes(ref),
                                      err_msg=key)
    load_tree_(model, restored["params"])
    amp.load_state_tree_(state, model, restored["opt"])
    assert state.inner.step == 1
    assert state.scaler.loss_scale == float(js.scaler.loss_scale)
    assert model.layers[0].qkv.kernel.dtype == torch.bfloat16

    toks, tgt = _batch(2)
    jp, js, jloss = _jax_step(jm, jopt, jp, js, jnp.asarray(toks),
                              jnp.asarray(tgt))
    loss = _port_step(model, mp_opt, state, toks, tgt)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    start = _flat({"m": restored["opt"]["master"]})
    jmaster = _flat({"m": js.master})
    tmaster = _flat({"m": module_tree(model, state.master)})
    assert _dist(tmaster, jmaster) <= 1e-3 * _dist(jmaster, start)
    for p, m in zip(model.parameters(), state.master):
        assert torch.equal(p, m.to(p.dtype))


def test_port_checkpoint_restores_in_the_jax_package(tmp_path):
    """The port's O2 state after a step, saved by the port, restores into
    the JAX train state's structure with every leaf equal."""
    model, mp_opt, state = _port_state()
    toks, tgt = _batch(3)
    _port_step(model, mp_opt, state, toks, tgt)
    tree = {"params": module_tree(model),
            "opt": amp.state_tree(state, model)}
    checkpoint.save_checkpoint(str(tmp_path), 7, tree)
    assert checkpoint.latest_step(str(tmp_path)) == 7

    _, _, jp, js = _jax_state(seed=5)
    restored = jckpt.restore_checkpoint(str(tmp_path),
                                        {"params": jp, "opt": js},
                                        backend="npz")
    assert int(restored["opt"].inner.step) == 1
    assert restored["opt"].scaler.loss_scale.dtype == np.float32
    assert restored["opt"].scaler.unskipped.dtype == np.int32
    ref = _flat(tree)
    got = _flat(restored)
    assert sorted(got) == sorted(ref)
    for key, want in ref.items():
        assert got[key].dtype == want.dtype, key
        assert got[key].shape == want.shape, key
        np.testing.assert_array_equal(_bytes(got[key]), _bytes(want),
                                      err_msg=key)


def test_trees_have_the_jax_layout():
    """``module_tree`` / ``state_tree`` of the port's O2 state: the keys,
    shapes and dtypes of the JAX ``{"params", "opt"}`` tree."""
    model, _, state = _port_state()
    _, _, jp, js = _jax_state()
    ref = {k: (v.shape, v.dtype.name)
           for k, v in _flat({"params": jp, "opt": js}).items()}
    got = {k: (v.shape, v.dtype.name)
           for k, v in _flat({"params": module_tree(model),
                              "opt": amp.state_tree(state, model)}).items()}
    assert got == ref
    # the per-parameter lists read back in parameters() order
    back = tensors_of_tree(model, module_tree(model, state.master))
    assert all(torch.equal(a, b) for a, b in zip(back, state.master))


def test_round_trip_with_bf16_leaves_and_latest_step(tmp_path):
    """``tests/test_checkpoint.py``'s round trip and discovery: bf16, fp32,
    int and scalar leaves come back with their dtypes and bits."""
    gen = torch.Generator().manual_seed(0)
    state = {"step": torch.tensor(3, dtype=torch.int32),
             "w": torch.randn(5, 7, generator=gen).to(torch.bfloat16),
             "nested": {"b": torch.randn(4, generator=gen),
                        "ids": np.arange(6, dtype=np.int64).reshape(2, 3)},
             "pair": [torch.ones(2, dtype=torch.bfloat16), np.float32(2.5)]}
    assert checkpoint.latest_step(str(tmp_path)) is None
    for step in (1, 10, 2):
        checkpoint.save_checkpoint(str(tmp_path), step, state)
    assert checkpoint.latest_step(str(tmp_path)) == 10
    back = checkpoint.restore_checkpoint(str(tmp_path), state)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], state["w"])
    assert int(back["step"]) == 3 and back["step"].dtype == torch.int32
    assert torch.equal(back["nested"]["b"], state["nested"]["b"])
    np.testing.assert_array_equal(back["nested"]["ids"].numpy(),
                                  state["nested"]["ids"])
    assert isinstance(back["pair"], list)
    assert torch.equal(back["pair"][0], state["pair"][0])
    assert float(back["pair"][1]) == 2.5
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_path / "none"), state)


def test_missing_leaf_raises(tmp_path):
    checkpoint.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="checkpoint missing leaf 'b'"):
        checkpoint.restore_checkpoint(str(tmp_path), {"a": torch.zeros(2),
                                                      "b": torch.zeros(2)})


# -- TokenLoader (tests/test_native_runtime.py:47-90) ----------------------


def _jax_batches(paths, shape, n=None, loop=False):
    loader = jcsrc.TokenLoader(paths, batch_shape=shape, loop=loop)
    it = iter(loader)
    out = list(it) if n is None else [next(it) for _ in range(n)]
    loader.close()
    return out


def test_token_loader_streams_all_batches(tmp_path):
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 1000, (3 * 64 + 10,)).astype(np.int32)
    (tmp_path / "a.bin").write_bytes(tokens[:100].tobytes())
    (tmp_path / "b.bin").write_bytes(tokens[100:].tobytes())
    paths = [tmp_path / "a.bin", tmp_path / "b.bin"]
    loader = TokenLoader(paths, batch_shape=(4, 16))
    batches = list(loader)
    loader.close()
    assert len(batches) == 3  # 202 tokens -> 3 full 64-token batches
    ref = _jax_batches(paths, (4, 16))
    assert len(ref) == 3
    for got, want in zip(batches, ref):
        assert got.dtype == np.int32 and got.shape == (4, 16)
        np.testing.assert_array_equal(got, want)


def test_token_loader_loop_mode(tmp_path):
    tokens = np.arange(40, dtype=np.int32)
    (tmp_path / "t.bin").write_bytes(tokens.tobytes())
    loader = TokenLoader([tmp_path / "t.bin"], batch_shape=(16,), loop=True)
    it = iter(loader)
    got = [next(it) for _ in range(7)]  # wraps repeatedly
    loader.close()
    ref = _jax_batches([tmp_path / "t.bin"], (16,), n=7, loop=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], np.arange(16))


def test_token_loader_iterators_are_independent_and_restart(tmp_path):
    tokens = np.arange(64, dtype=np.int32)
    (tmp_path / "t.bin").write_bytes(tokens.tobytes())
    loader = TokenLoader([tmp_path / "t.bin"], batch_shape=(16,))
    it1, it2 = iter(loader), iter(loader)
    a1 = next(it1)
    b1 = next(it2)  # a second stream does not disturb the first
    a2 = next(it1)
    np.testing.assert_array_equal(a1, tokens[:16])
    np.testing.assert_array_equal(b1, tokens[:16])
    np.testing.assert_array_equal(a2, tokens[16:32])
    np.testing.assert_array_equal(next(iter(loader)), tokens[:16])
    loader.close()
    assert list(it1) == []  # a closed stream ends


def test_token_loader_missing_file_and_empty_shape(tmp_path):
    with pytest.raises(FileNotFoundError):
        TokenLoader([tmp_path / "absent.bin"], batch_shape=(4,))
    with pytest.raises(ValueError, match="no input files"):
        TokenLoader([], batch_shape=(4,))
    (tmp_path / "t.bin").write_bytes(np.arange(8, dtype=np.int32).tobytes())
    with pytest.raises(ValueError, match="empty batch shape"):
        TokenLoader([tmp_path / "t.bin"], batch_shape=(0,))
