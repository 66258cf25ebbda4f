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


# ---------------------------------------------------------------------------
# training half: loss and every parameter's grad against
# jax.value_and_grad(model.loss), fp32, identical params
# ---------------------------------------------------------------------------

TRAIN = dict(vocab_size=64, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_seq_len=32)
GRAD_ATOL = 1e-5  # fp32 through 2 layers and the head, another sum order


def _train_pair(remat, chunks, seed=0):
    jm = JaxGPTModel(JaxGPTConfig(axis=None, hidden_dropout=0.0,
                                  compute_dtype=jnp.float32, remat=remat,
                                  lm_head_chunks=chunks, **TRAIN))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = GPTModel(GPTConfig(compute_dtype=torch.float32, remat=remat,
                            lm_head_chunks=chunks, hidden_dropout=0.0,
                            **TRAIN), device="cpu")
    tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm


def _jax_grads_by_name(tree, n_layers):
    """The JAX grad tree flattened to the port's parameter names."""
    out = {"embedding.embedding": tree["embedding"]["embedding"],
           "position": tree["position"],
           "ln_f.scale": tree["ln_f"]["scale"],
           "ln_f.bias": tree["ln_f"]["bias"]}
    for name, sub in tree["layers"].items():
        for leaf, stacked in sub.items():
            for i in range(n_layers):
                out[f"layers.{i}.{name}.{leaf}"] = stacked[i]
    return {k: np.asarray(v) for k, v in out.items()}


def _batch(seed, b=2, s=24):
    tokens = np.random.default_rng(seed).integers(0, 64, (b, s)).astype(
        np.int32)
    return tokens, np.roll(tokens, -1, axis=-1)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("chunks", [None, 2])
def test_loss_and_every_grad_match_jax(remat, chunks):
    jm, jp, tm = _train_pair(remat, chunks)
    tokens, targets = _batch(3)
    jloss, jg = jax.value_and_grad(jm.loss)(jp, jnp.asarray(tokens),
                                            jnp.asarray(targets))
    loss = tm.loss(torch.from_numpy(tokens).long(),
                   torch.from_numpy(targets).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    ref = _jax_grads_by_name(jg, TRAIN["num_layers"])
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(ref)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name],
                                   atol=GRAD_ATOL, err_msg=name)


def test_three_o0_fused_adam_steps_match_jax():
    from apex_tpu import amp as jamp
    from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
    from apex_tpu_torch import amp as tamp
    from apex_tpu_torch.optimizers import FusedAdam

    jm, jp, tm = _train_pair(True, 2)
    jmp = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=1e-3),
                                       jamp.get_policy("O0"))
    js = jmp.init(jp)
    tmp = tamp.MixedPrecisionOptimizer(FusedAdam(lr=1e-3),
                                       tamp.get_policy("O0"))
    ts = tmp.init(tm)
    tokens, targets = _batch(4)
    for _ in range(3):
        jloss, jg = jax.value_and_grad(jm.loss)(jp, jnp.asarray(tokens),
                                                jnp.asarray(targets))
        jp, js, _ = jmp.apply_gradients(js, jp, jg)
        loss = tm.loss(torch.from_numpy(tokens).long(),
                       torch.from_numpy(targets).long())
        tmp.scale_loss(loss, ts).backward()
        metrics = tmp.step(ts, tm)
        assert not metrics["found_inf"]
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
    ref = _jax_grads_by_name(jp, TRAIN["num_layers"])  # params, same tree
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=1e-5,
                                   err_msg=name)


def test_dropout_keep_rate_and_mean():
    """Inverted dropout at rate 0.1 on 200k ones: the kept share lies within
    5 binomial standard deviations of 0.9, survivors are exactly 1/0.9, and
    the mean stays 1 within the same bound."""
    from apex_tpu_torch.models._transformer import inverted_dropout

    n, rate = 200_000, 0.1
    gen = torch.Generator().manual_seed(0)
    y = inverted_dropout(torch.ones(n), rate, gen)
    kept = float((y != 0).float().mean())
    sd = ((1 - rate) * rate / n) ** 0.5
    assert abs(kept - (1 - rate)) <= 5 * sd
    assert torch.allclose(y[y != 0], torch.tensor(1 / (1 - rate)))
    assert abs(float(y.mean()) - 1.0) <= 5 * sd / (1 - rate)
    assert torch.equal(inverted_dropout(torch.ones(4), rate, None),
                       torch.ones(4))


def test_dropout_masks_survive_the_remat_recompute():
    """With a dropout generator, a checkpointed layer's recompute draws the
    same masks as its forward: grads with remat on equal grads with it off
    for the same seed, and they differ from the dropout-free grads."""
    grads = {}
    for remat, seed in ((True, 11), (False, 11), (True, None)):
        tm = GPTModel(GPTConfig(compute_dtype=torch.float32, remat=remat,
                                hidden_dropout=0.2, **TRAIN),
                      device="cpu", seed=2)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        tokens, targets = _batch(5)
        tm.loss(torch.from_numpy(tokens).long(),
                torch.from_numpy(targets).long(), gen).backward()
        grads[(remat, seed)] = [p.grad.clone() for p in tm.parameters()]
    for a, b in zip(grads[(True, 11)], grads[(False, 11)]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    assert any(not torch.allclose(a, b) for a, b in
               zip(grads[(True, 11)], grads[(True, None)]))


def test_apply_is_inference_only(pair):
    _, _, tm = pair
    out = tm.apply(torch.zeros(1, 4, dtype=torch.long))
    assert out.grad_fn is None
    logits = tm(torch.zeros(1, 4, dtype=torch.long))
    assert logits.grad_fn is not None and logits.shape == (1, 4, 61)
    torch.testing.assert_close(logits, out)
