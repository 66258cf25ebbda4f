"""apex_tpu_torch.models.GPTModel against apex_tpu.models.GPTModel on the
CPU, on identical parameters: the JAX ``init`` tree, as numpy arrays, is
loaded with ``params_from_numpy``. fp32 throughout; full-context logits,
the prefill/decode hidden states and the KV pool contents after a decode
tick agree to 1e-4 (fp32 math through 2 layers in another summation order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu_torch.models import GPTConfig, GPTModel

ATOL = 1e-4
SMALL = dict(vocab_size=61, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_seq_len=64)


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPTModel(JaxGPTConfig(axis=None, hidden_dropout=0.0,
                                  compute_dtype=jnp.float32, remat=False,
                                  **SMALL))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = GPTModel(GPTConfig(compute_dtype=torch.float32, **SMALL),
                  device="cpu")
    tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm


def test_params_from_numpy_loads_every_leaf(pair):
    jm, jp, tm = pair
    assert torch.equal(tm.layers[1].qkv.kernel,
                       torch.from_numpy(np.array(jp["layers"]["qkv"]
                                                   ["kernel"][1])))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert n_jax == sum(p.numel() for p in tm.parameters())
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(np.asarray, jp)
        bad["position"] = bad["position"][:3]
        tm.params_from_numpy(bad)


def test_full_context_logits(pair):
    jm, jp, tm = pair
    tokens = np.random.default_rng(0).integers(0, 61, (2, 20)).astype(
        np.int32)
    ref = np.asarray(jm.apply(jp, jnp.asarray(tokens)))
    got = tm.apply(torch.from_numpy(tokens).long())
    assert got.shape == (2, 20, 61)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_prefill_hook_hidden_states_and_kv(pair):
    jm, jp, tm = pair
    tokens = np.random.default_rng(1).integers(0, 61, (1, 24)).astype(
        np.int32)
    pos = np.arange(24, dtype=np.int32)
    jh = jm.embed_at(jp, jnp.asarray(tokens), jnp.asarray(pos)[None])
    jh, jks, jvs = jm.serve_layers_prefill(jp["layers"], jh)
    th = tm.embed_at(torch.from_numpy(tokens).long(),
                     torch.from_numpy(pos).long()[None])
    th, tks, tvs = tm.serve_layers_prefill(th)
    for got, ref in ((th, jh), (tks, jks), (tvs, jvs)):
        assert tuple(got.shape) == tuple(ref.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(tm.serve_head(th).numpy(),
                               np.asarray(jm.serve_head(jp, jh)), atol=ATOL)


def test_decode_hook_hidden_states_and_pool_contents(pair):
    jm, jp, tm = pair
    rng = np.random.default_rng(2)
    L, nb, kh, blk, d = 2, 9, 4, 8, 8
    kp = rng.normal(size=(L, nb, kh, blk, d)).astype(np.float32)
    vp = rng.normal(size=(L, nb, kh, blk, d)).astype(np.float32)
    tables = np.array([[3, 5, 0, 0], [1, 2, 4, 0], [0, 0, 0, 0]], np.int32)
    lengths = np.array([9, 20, 0], np.int32)  # slot 2 idle
    active = lengths > 0
    tokens = rng.integers(0, 61, (3,)).astype(np.int32)
    blk_ids = tables[np.arange(3), lengths // blk]
    write_flat = np.where(active, blk_ids * blk + lengths % blk, 0)
    attend = np.where(active, lengths + 1, 0).astype(np.int32)

    jh = jm.embed_at(jp, jnp.asarray(tokens)[:, None],
                     jnp.asarray(lengths)[:, None])
    jh, jkp, jvp = jm.serve_layers_decode(
        jp["layers"], jh, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(write_flat, jnp.int32),
        jnp.asarray(attend), jnp.asarray(lengths))
    t = torch.from_numpy
    tkp, tvp = t(kp.copy()), t(vp.copy())
    th = tm.embed_at(t(tokens).long()[:, None], t(lengths).long()[:, None])
    th, tkp, tvp = tm.serve_layers_decode(
        th, tkp, tvp, t(tables), t(write_flat).long(), t(attend),
        t(lengths).long())
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), atol=ATOL)
    np.testing.assert_allclose(tvp.numpy(), np.asarray(jvp), atol=ATOL)
    # the new token's k/v landed at its page slot (slot 0: page 5, off 1)
    assert not np.allclose(tkp.numpy()[:, 5, :, 1], kp[:, 5, :, 1])


def test_init_scales_output_layers():
    m = GPTModel(GPTConfig(vocab_size=64, hidden_size=64, num_layers=8,
                           num_attention_heads=4, max_seq_len=32),
                 device="cpu", seed=3)
    std_qkv = float(m.layers[0].qkv.kernel.detach().std())
    std_proj = float(m.layers[0].proj.kernel.detach().std())
    assert abs(std_qkv - 0.02) < 0.002
    assert abs(std_proj - 0.02 / 4.0) < 0.0005  # 1/sqrt(2L), L=8
    assert not m.layers[0].qkv.bias.detach().any()
    assert torch.equal(m.ln_f.scale, torch.ones(64))
    again = GPTModel(m.cfg, device="cpu", seed=3)
    assert torch.equal(again.embedding.embedding, m.embedding.embedding)
