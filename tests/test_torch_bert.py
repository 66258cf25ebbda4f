"""apex_tpu_torch BERT against apex_tpu's on the CPU, on the same numpy
parameters (``BertModel.params_from_numpy``) and batches.

- fp32, a padded attention mask: the loss and every parameter's grad of
  ``BertModel.loss`` against ``jax.value_and_grad(BertModel.loss)`` (loss
  1e-5 relative, each grad 1e-4 of its max |ref|: fp32 sums in another
  order through two layers); the attention runs through the
  ``FlashAttention`` Function with the bias, the card's route;
- the padding mask matters (mirrors tests/test_bert.py:73);
- 3 amp-O2 FusedLAMB steps with bf16 compute, built as
  ``test_bert_fused_lamb_o2_trains`` (tests/test_bert.py:155) builds the
  JAX step: each step's loss within 1e-3 relative (6e-5 measured) and the
  masters' whole update within 0.1 of the JAX update's norm (0.056
  measured): bf16 rounds at other places in the two frameworks, and
  LAMB's first steps move each element by about lr whatever the size of
  its grad, so an element whose grad is near 0 can step either way (the
  pooler's bias leaf, nearly all of that 0.056, differs by half its own
  update norm; no other leaf by more than 9%);
- the serial ``vocab_parallel_cross_entropy`` (with label smoothing)
  against JAX's: loss and grad 1e-5;
- the example's ``main`` on the CPU, and its later-slice flags raise.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertModel as JaxBertModel
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy as jax_vpce,
)
from apex_tpu_torch import amp as tamp
from apex_tpu_torch.models import BertConfig, BertModel
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy,
)

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_seq_len=16, hidden_dropout=0.0)


def _batch(seed=1, b=4, s=16, vocab=64):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s))
    attn = np.ones((b, s), np.int32)
    attn[0, 11:] = 0
    attn[1, 5:] = 0
    attn[2, 14:] = 0  # row 3 unpadded
    lmask = (rng.random((b, s)) < 0.3).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s))
    nsp = rng.integers(0, 2, (b,))
    types = rng.integers(0, 2, (b, s))
    return toks, attn, lmask, labels, nsp, types


def _pair(compute):
    jm = JaxBertModel(JaxBertConfig(axis=None, remat=False,
                                    compute_dtype=getattr(jnp, compute),
                                    **TINY))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = BertModel(BertConfig(compute_dtype=getattr(torch, compute), **TINY),
                   device="cpu")
    tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm


def _jax_leaf(tree, name):
    """The JAX leaf of a port parameter name (``layers.1.qkv.kernel`` is
    slice 1 of ``tree["layers"]["qkv"]["kernel"]``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        sub = tree["layers"]
        for p in parts[2:]:
            sub = sub[p]
        return np.asarray(sub[int(parts[1])])
    sub = tree
    for p in parts:
        sub = sub[p]
    return np.asarray(sub)


def test_params_from_numpy_loads_every_leaf():
    _, jp, tm = _pair("float32")
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert n_jax == sum(p.numel() for p in tm.parameters())
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), _jax_leaf(jp, name))


def test_loss_and_every_grad_match_jax():
    jm, jp, tm = _pair("float32")
    batch = _batch()
    jl, jg = jax.value_and_grad(jm.loss)(jp, *map(jnp.asarray, batch))
    tl = tm.loss(*(torch.from_numpy(a) for a in batch))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for name, p in tm.named_parameters():
        ref = _jax_leaf(jg, name)
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * max(np.abs(ref).max(), 1e-12), name


def test_attention_takes_the_flash_function_with_the_bias(monkeypatch):
    """Every layer's attention goes through FlashAttention with the padding
    bias (the route the card takes), not mha_reference."""
    tfa = __import__("importlib").import_module(
        "apex_tpu_torch.ops.flash_attention")
    seen = []
    real = tfa.FlashAttention.apply

    def spy(q, k, v, bias, *rest):
        seen.append(None if bias is None else tuple(bias.shape))
        return real(q, k, v, bias, *rest)

    monkeypatch.setattr(tfa.FlashAttention, "apply", spy)
    _, _, tm = _pair("float32")
    tm.loss(*(torch.from_numpy(a) for a in _batch()))
    assert seen == [(4, 1, 16, 16)] * 2


def test_padding_mask_matters():
    """Changing a padded token's content must not change unpadded
    positions' logits (tests/test_bert.py:73)."""
    _, _, tm = _pair("float32")
    toks, attn, *_ = _batch()
    with torch.no_grad():
        l1, _ = tm.apply(torch.from_numpy(toks), torch.from_numpy(attn))
        toks2 = toks.copy()
        toks2[:3, -1] = (toks2[:3, -1] + 1) % 64  # padded in rows 0-2
        l2, _ = tm.apply(torch.from_numpy(toks2), torch.from_numpy(attn))
    keep = torch.from_numpy(attn[:3, :-1].astype(bool))
    torch.testing.assert_close(l1[:3, :-1][keep], l2[:3, :-1][keep])
    assert not torch.allclose(l1[3], l1[3] + 1)  # sanity: finite logits


def test_o2_fused_lamb_steps_match_jax():
    jm, jp, tm = _pair("bfloat16")
    batch = _batch(seed=2)
    jpol = jamp.get_policy("O2")
    jmp = jamp.MixedPrecisionOptimizer(JaxFusedLAMB(lr=2e-2), jpol)
    jparams = jamp.cast_params(jp, jpol)
    jstate = jmp.init(jparams)
    jb = tuple(jnp.asarray(a) for a in batch)

    @jax.jit
    def jstep(p, s):
        def scaled(p):
            return jmp.scale_loss(jm.loss(p, *jb), s)
        ls, gs = jax.value_and_grad(scaled)(p)
        np_, ns, metrics = jmp.apply_gradients(s, p, gs)
        return np_, ns, ls / s.scaler.loss_scale, metrics

    tpol = tamp.get_policy("O2")
    tamp.cast_params(tm, tpol)
    tmp = tamp.MixedPrecisionOptimizer(FusedLAMB(lr=2e-2), tpol)
    tstate = tmp.init(tm)
    init = [m.clone() for m in tstate.master]
    tb = tuple(torch.from_numpy(a) for a in batch)
    for _ in range(3):
        jparams, jstate, jloss, jmet = jstep(jparams, jstate)
        loss = tm.loss(*tb)
        tmp.scale_loss(loss, tstate).backward()
        met = tmp.step(tstate, tm)
        assert met["found_inf"] == bool(jmet["found_inf"]) is False
        assert met["loss_scale"] == float(jmet["loss_scale"])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    diff = ref_sq = 0.0
    for (name, p), m, m0 in zip(tm.named_parameters(), tstate.master, init):
        ref = _jax_leaf(jstate.master, name) - m0.numpy()
        diff += float(np.sum(((m - m0).numpy() - ref) ** 2))
        ref_sq += float(np.sum(ref ** 2))
        assert torch.equal(p.detach(), m.to(p.dtype))
    assert diff ** 0.5 <= 0.1 * ref_sq ** 0.5
    assert tm.lm_dense.kernel.dtype == torch.bfloat16
    assert tm.ln_emb.scale.dtype == torch.float32


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_serial_cross_entropy_matches_jax(eps):
    rng = np.random.default_rng(9)
    x = (3 * rng.normal(size=(3, 5, 37))).astype(np.float32)
    y = rng.integers(0, 37, (3, 5))
    g = rng.normal(size=(3, 5)).astype(np.float32)
    jl, vjp = jax.vjp(lambda a: jax_vpce(a, jnp.asarray(y), None, eps),
                      jnp.asarray(x))
    jg, = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tl = vocab_parallel_cross_entropy(tx, torch.from_numpy(y),
                                      label_smoothing=eps)
    tl.backward(torch.from_numpy(g))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    # the vocab-sharded form needs the topology installed first
    with pytest.raises(ValueError, match="initialize_model_parallel"):
        vocab_parallel_cross_entropy(tx, torch.from_numpy(y), axis="model")


@pytest.mark.parametrize("field,value", [
    ("axis", "model"), ("sequence_parallel", True),
    ("context_axis", "context"), ("unroll_layers", True),
    ("zero3_prefetch", 1),
])
def test_options_outside_the_slice_raise(field, value):
    cfg = BertConfig(**{field: value}, **TINY)
    if field in ("axis", "context_axis"):  # both need the topology first
        with pytest.raises(ValueError, match="initialize_model_parallel"):
            BertModel(cfg, device="cpu")
    if field == "context_axis":  # which installed, the model builds
        from apex_tpu_torch.parallel import mesh

        mesh.initialize_model_parallel(context_parallel_size=1)
        try:
            assert BertModel(cfg, device="cpu")._ctx == "context"
        finally:
            mesh.destroy_model_parallel()
    elif field == "sequence_parallel":  # ignored serial, as in the JAX model
        assert not BertModel(cfg, device="cpu")._sp
    elif field != "axis":
        with pytest.raises(NotImplementedError,
                           match="ROADMAP|Queue 1 item"):
            BertModel(cfg, device="cpu")


def test_example_main_on_the_cpu(capsys):
    from apex_tpu_torch.examples.bert import pretrain_bert

    assert pretrain_bert.main(["--device", "cpu", "--hidden", "32",
                               "--layers", "2", "--heads", "4", "--seq",
                               "16", "--batch", "2", "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "step    2 mlm+nsp loss" in out and "tokens/s" in out
    for flags in (["--zero"], ["--zero-level", "3"],
                  ["--reduce-dtype", "int8"], ["--mesh-islands", "2"],
                  ["--journal", "j.jsonl"], ["--ledger"], ["--trace", "t"],
                  ["--flight"]):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            pretrain_bert.main(["--device", "cpu", *flags])
