"""The port's serial MoE against the JAX package on the same numpy params
and inputs (``tests/test_moe.py``'s serial cases, ``tests/test_gpt_moe.py``'s
serial cases, ``tests/test_models.py:235``).

- ``MoEMLP``: the reference's unit contract (top-1 combine with the
  unnormalized prob, top-2 convex combination, capacity drops, a dropped
  expert's share lost, the aux losses, the dropped fraction), each output
  also against the JAX layer's (1e-5), and the values, aux and every grad
  of a loss over output and aux against ``jax.grad`` at top-1/2/3 with and
  without congestion (1e-5); ties go to the first index as ``jnp.argmax``;
  ``dcn_axis`` raises naming ROADMAP item 16;
- GPT with MoE FFNs: the layer tree and the logits (1e-5), the aux fold,
  the loss and every grad against ``jax.value_and_grad(model.loss)`` under
  each remat policy and under congestion (1e-5), training, the drives
  refusing to drop aux, SP + MoE refused, a dense drive's ``(h, None)``
  through the pipelined loss, the O2 cast of the router;
- serving: the serial MoE engine's greedy streams equal the JAX engine's;
- the examples: three O2 steps of ``pretrain_gpt --moe-experts`` (fp32
  compute) against the JAX example's serial step with the router losses
  on its pipelined loss (losses 1e-5), and ``pretrain_moe_gpt --ep 1``
  against the JAX example's serial step (losses 1e-5).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.serve import Engine as JaxEngine
from apex_tpu.serve import Request as JaxRequest
from apex_tpu.serve import ServeConfig as JaxServeConfig
from apex_tpu.transformer.moe import MoEMLP as JaxMoEMLP
from apex_tpu_torch import amp
from apex_tpu_torch._params import load_tree_, module_tree
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.serve import Engine, Request, ServeConfig
from apex_tpu_torch.transformer.moe import MoEMLP

pg = importlib.import_module("apex_tpu_torch.examples.gpt.pretrain_gpt")
pm = importlib.import_module("apex_tpu_torch.examples.moe.pretrain_moe_gpt")

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_seq_len=16, hidden_dropout=0.0,
            remat=True, axis=None)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _pair(E=4, top_k=1, cf=8.0, d=8, f=16, key=0, router=None):
    """A JAX layer's init and the port layer loaded with it."""
    jl = JaxMoEMLP(hidden_size=d, ffn_hidden_size=f, num_experts=E,
                   top_k=top_k, capacity_factor=cf)
    params = jl.init(jax.random.PRNGKey(key))
    if router is not None:
        params["router"]["kernel"] = jnp.asarray(router, jnp.float32)
    layer = MoEMLP(d, f, num_experts=E, top_k=top_k, capacity_factor=cf)
    load_tree_(layer, _np(params))
    return jl, params, layer


def _expert_ffn(params, e, x):
    h = x @ np.asarray(params["fc1"]["kernel"][e])
    h = jax.nn.gelu(h + np.asarray(params["fc1"]["bias"][e]))
    return np.asarray(h @ np.asarray(params["fc2"]["kernel"][e])
                      + np.asarray(params["fc2"]["bias"][e]))


def _run(layer, x):
    with torch.no_grad():
        out, aux = layer.apply(torch.from_numpy(np.asarray(x)))
    return out.numpy(), {k: float(v) for k, v in aux.items()}


def _same_as_jax(jl, params, layer, x):
    ref, ref_aux = jl.apply(params, x)
    out, aux = _run(layer, x)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    for k, v in ref_aux.items():
        np.testing.assert_allclose(aux[k], float(v), **TOL)
    return out, aux


# ---------------------------------------------------------------------------
# MoEMLP (tests/test_moe.py)
# ---------------------------------------------------------------------------


def test_top1_matches_per_token_expert():
    jl, params, layer = _pair(top_k=1)
    x = jax.random.normal(jax.random.PRNGKey(1), (10, 8))
    out, _ = _same_as_jax(jl, params, layer, x)
    logits = np.asarray(x) @ np.asarray(params["router"]["kernel"])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    for i, e in enumerate(logits.argmax(-1)):
        ref = probs[i, e] * _expert_ffn(params, int(e), np.asarray(x[i]))
        np.testing.assert_allclose(out[i], ref, atol=1e-5)


def test_top1_router_gets_task_loss_gradient():
    jl, params, layer = _pair(top_k=1)
    x = jax.random.normal(jax.random.PRNGKey(1), (10, 8))
    ref = jax.grad(lambda p: jnp.sum(jl.apply(p, x)[0] ** 2))(params)
    out, _ = layer.apply(torch.from_numpy(np.asarray(x)))
    (out ** 2).sum().backward()
    g = layer.router.kernel.grad.numpy()
    assert np.abs(g).max() > 0.0
    np.testing.assert_allclose(g, np.asarray(ref["router"]["kernel"]), **TOL)


def test_top2_convex_combination():
    jl, params, layer = _pair(top_k=2, key=2)
    x = jax.random.normal(jax.random.PRNGKey(3), (6, 8))
    out, _ = _same_as_jax(jl, params, layer, x)
    logits = np.asarray(x) @ np.asarray(params["router"]["kernel"])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    top2 = np.argsort(-probs, axis=-1)[:, :2]
    for i in range(6):
        e1, e2 = top2[i]
        g = probs[i, [e1, e2]] / probs[i, [e1, e2]].sum()
        ref = (g[0] * _expert_ffn(params, e1, np.asarray(x[i]))
               + g[1] * _expert_ffn(params, e2, np.asarray(x[i])))
        np.testing.assert_allclose(out[i], ref, atol=1e-5)


def test_capacity_drops_overflow_tokens():
    router = np.zeros((8, 2), np.float32)
    router[:, 0] = 1.0
    jl, params, layer = _pair(E=2, top_k=1, cf=0.5, router=router)
    x = jnp.tile(jax.random.normal(jax.random.PRNGKey(4), (1, 8)), (8, 1))
    out, aux = _same_as_jax(jl, params, layer, x)
    # capacity = ceil(1 * 8 * 0.5 / 2) = 2: tokens 0-1 served, 2-7 dropped
    assert not np.allclose(out[0], 0)
    np.testing.assert_allclose(out[2:], 0, atol=1e-7)
    assert aux["dropped_fraction"] == 0.75


def test_dropped_expert_share_is_lost_not_redistributed():
    kernel = np.zeros((8, 4), np.float32)
    kernel[0, 0], kernel[1, 1], kernel[2, 2] = 4.0, 2.0, 2.0
    jl, params, layer = _pair(E=4, top_k=2, cf=1.0, router=kernel)
    tok_a = np.zeros(8, np.float32)
    tok_a[0] = tok_a[1] = 1.0
    tok_b = np.zeros(8, np.float32)
    tok_b[0] = tok_b[2] = 1.0
    tok_a[3:], tok_b[3:] = 0.3, -0.3
    x = np.stack([tok_a] * 5 + [tok_b] * 3)
    out, _ = _same_as_jax(jl, params, layer, jnp.asarray(x))
    probs_b = np.asarray(jax.nn.softmax(jnp.asarray(tok_b @ kernel)))
    w = probs_b[2] / (probs_b[0] + probs_b[2])
    partial = w * _expert_ffn(params, 2, tok_b)
    inflated = _expert_ffn(params, 2, tok_b)
    for i in (5, 6, 7):
        np.testing.assert_allclose(out[i], partial, atol=1e-5)
        assert not np.allclose(out[i], inflated, atol=1e-3)
    probs_a = np.asarray(jax.nn.softmax(jnp.asarray(tok_a @ kernel)))
    full = (probs_a[0] * _expert_ffn(params, 0, tok_a)
            + probs_a[1] * _expert_ffn(params, 1, tok_a)) / (
        probs_a[0] + probs_a[1])
    np.testing.assert_allclose(out[0], full, atol=1e-5)


def test_aux_losses():
    jl, params, layer = _pair(E=4, top_k=1, key=5,
                              router=np.zeros((8, 4), np.float32))
    x = jax.random.normal(jax.random.PRNGKey(6), (32, 8))
    _, aux = _same_as_jax(jl, params, layer, x)
    assert aux["load_balancing_loss"] == pytest.approx(1.0, rel=1e-5)
    assert aux["router_z_loss"] == pytest.approx(np.log(4) ** 2, rel=1e-5)
    skew = np.zeros((8, 4), np.float32)
    skew[:, 0] = 5.0
    jl, params, layer = _pair(E=4, top_k=1, key=5, router=skew)
    _, aux2 = _same_as_jax(jl, params, layer, x)
    assert aux2["load_balancing_loss"] > aux["load_balancing_loss"] + 0.05


def test_dropped_fraction_metric():
    x = jax.random.normal(jax.random.PRNGKey(2), (64, 8))
    jl, params, ample = _pair(E=4, top_k=2, cf=8.0)
    _, aux = _same_as_jax(jl, params, ample, x)
    assert aux["dropped_fraction"] == 0.0
    jl, params, tight = _pair(E=4, top_k=2, cf=0.5)
    _, aux = _same_as_jax(jl, params, tight, x)
    assert 0.25 < aux["dropped_fraction"] < 1.0


def test_ties_go_to_the_first_index():
    """A zero router makes every prob equal: the greedy top-k picks experts
    0 .. k-1, as ``jnp.argmax`` does."""
    jl, params, layer = _pair(E=4, top_k=2,
                              router=np.zeros((8, 4), np.float32))
    x = jax.random.normal(jax.random.PRNGKey(7), (6, 8))
    _same_as_jax(jl, params, layer, x)
    slots, weights, _, C = layer._route(torch.from_numpy(np.asarray(x)))
    assert (slots // C).tolist() == [[0, 1]] * 6
    assert torch.all(weights == 0.5)


@pytest.mark.parametrize("top_k,cf", [(1, 8.0), (2, 8.0), (2, 0.5),
                                      (3, 1.0)])
def test_values_aux_and_grads_match_jax(top_k, cf):
    """The loss over the output and both aux losses: its value, the aux
    (the dropped fraction too) and every grad (the router's included)
    against ``jax.grad``, with ample capacity and under congestion."""
    jl, params, layer = _pair(E=4, top_k=top_k, cf=cf, key=3)
    x = jax.random.normal(jax.random.PRNGKey(4), (20, 8))

    def jloss(p, xx):
        out, aux = jl.apply(p, xx)
        return (jnp.mean(out ** 2) + 0.01 * aux["load_balancing_loss"]
                + 1e-3 * aux["router_z_loss"]), aux

    (ref, ref_aux), (ref_g, ref_gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, x)
    xt = torch.from_numpy(np.asarray(x)).requires_grad_()
    out, aux = layer.apply(xt)
    loss = ((out ** 2).mean() + 0.01 * aux["load_balancing_loss"]
            + 1e-3 * aux["router_z_loss"])
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref), **TOL)
    for k, v in ref_aux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), **TOL)
    got = module_tree(layer, [p.grad for p in layer.parameters()])
    for key, sub in got.items():
        for leaf, g in sub.items():
            np.testing.assert_allclose(g.numpy(),
                                       np.asarray(ref_g[key][leaf]), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_gx), **TOL)


def test_validation_and_the_pod_tier():
    with pytest.raises(ValueError, match="top_k"):
        MoEMLP(8, 16, num_experts=2, top_k=3)
    with pytest.raises(ValueError, match="dispatch_dtype requires"):
        MoEMLP(8, 16, num_experts=4, dispatch_dtype="int8")
    with pytest.raises(ValueError, match="dcn_axis requires expert_axis"):
        MoEMLP(8, 16, num_experts=4, dcn_axis="dcn")
    with pytest.raises(NotImplementedError, match="item 16"):
        MoEMLP(8, 16, num_experts=4, expert_axis="data", dcn_axis="dcn")


# ---------------------------------------------------------------------------
# GPT with MoE FFNs (tests/test_gpt_moe.py, tests/test_models.py:235)
# ---------------------------------------------------------------------------


def _gpt_pair(seed=0, **over):
    cfg = dict(TINY, moe_num_experts=4, **over)
    jm = JaxGPTModel(JaxGPTConfig(compute_dtype=jnp.float32, **cfg))
    params = jm.init(jax.random.PRNGKey(seed))
    model = GPTModel(GPTConfig(compute_dtype=torch.float32, **cfg),
                     device="cpu").params_from_numpy(_np(params))
    return jm, params, model


def _tokens(b=2, seed=1):
    toks = jax.random.randint(jax.random.PRNGKey(seed), (b, 16), 0, 128)
    return toks, jnp.roll(toks, -1, axis=-1)


def test_moe_gpt_params_and_forward():
    jm, params, model = _gpt_pair(moe_top_k=1)
    layer = params["layers"]
    assert "moe" in layer and "fc1" not in layer and "fc2" not in layer
    tree = module_tree(model, device="meta")["layers"]
    assert sorted(tree) == sorted(layer)
    assert tuple(tree["moe"]["fc1"]["kernel"].shape) == (2, 4, 32, 128)
    toks, _ = _tokens()
    logits = model.apply(torch.from_numpy(np.asarray(toks)))
    assert logits.shape == (2, 16, 128)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jm.apply(params, toks)), **TOL)


def test_moe_gpt_loss_includes_aux():
    toks, tgt = _tokens()
    t, y = (torch.from_numpy(np.asarray(a)) for a in (toks, tgt))
    got = {}
    for w in (1.0, 0.0):
        jm, params, model = _gpt_pair(moe_aux_loss_weight=w,
                                      moe_z_loss_weight=0.0)
        with torch.no_grad():
            got[w] = float(model.loss(t, y))
        np.testing.assert_allclose(got[w], float(jm.loss(params, toks, tgt)),
                                   **TOL)
    assert got[1.0] > got[0.0] + 0.1


@pytest.mark.parametrize("case", ["full", "save_attn", "dots", "no_remat",
                                  "top1", "congested"])
def test_loss_and_every_grad_match_jax(case):
    """``loss`` and every grad (the router's and the experts' included)
    against ``jax.value_and_grad(model.loss)``, under each remat policy,
    at top-1 and under congestion (cf 0.5: tokens dropped)."""
    over = {"full": {}, "save_attn": dict(remat_policy="save_attn"),
            "dots": dict(remat_policy="dots"), "no_remat": dict(remat=False),
            "top1": dict(moe_top_k=1),
            "congested": dict(moe_capacity_factor=0.5)}[case]
    jm, params, model = _gpt_pair(**over)
    toks, tgt = _tokens(4)
    ref, ref_g = jax.value_and_grad(lambda p: jm.loss(p, toks, tgt))(params)
    loss = model.loss(torch.from_numpy(np.asarray(toks)),
                      torch.from_numpy(np.asarray(tgt)))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref), **TOL)
    got = module_tree(model, [p.grad for p in model.parameters()])
    ref_g = _np(ref_g)
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(ref_g)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(a), b, **TOL,
                                   err_msg=str(path))


def test_moe_gpt_trains():
    _, _, model = _gpt_pair()
    toks, tgt = (torch.from_numpy(np.asarray(a)) for a in _tokens(4))
    losses = []
    for _ in range(16):
        loss = model.loss(toks, tgt)
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= 0.05 * p.grad
                p.grad = None
        losses.append(float(loss))
    assert losses[-1] < losses[0] and np.isfinite(losses[-1])


def test_moe_run_layers_refuses_to_drop_aux():
    _, _, model = _gpt_pair()
    h = torch.zeros(2, 16, 32)
    with pytest.raises(ValueError, match="return_aux"):
        model.run_layers(h)
    with pytest.raises(ValueError, match="return_aux"):
        model.run_layers_train(h)
    out, aux = model.run_layers(h, return_aux=True)
    assert out.shape == h.shape and sorted(aux) == [
        "dropped_fraction", "load_balancing_loss", "router_z_loss"]


def test_gpt_sequence_parallel_rejects_moe():
    with pytest.raises(ValueError, match="sequence_parallel"):
        GPTModel(GPTConfig(**dict(TINY, axis="model"),
                           sequence_parallel=True, moe_num_experts=4),
                 device="cpu")


def test_dense_model_with_return_aux_true_pipelines_cleanly():
    """A dense model's drive with ``return_aux=True`` gives ``(h, None)``:
    the pipelined loss unwraps it with no ``aux_to_loss`` and gives the
    model's loss (one stage, 2 micro-batches)."""
    from apex_tpu_torch.parallel import mesh
    from apex_tpu_torch.transformer import pipeline_parallel as ppl

    jm = JaxGPTModel(JaxGPTConfig(compute_dtype=jnp.float32, **TINY))
    params = jm.init(jax.random.PRNGKey(0))
    model = GPTModel(GPTConfig(compute_dtype=torch.float32, **TINY),
                     device="cpu").params_from_numpy(_np(params))
    toks, tgt = _tokens(4)
    t, y = (torch.from_numpy(np.asarray(a)) for a in (toks, tgt))
    h, aux = model.run_layers(model.embed(t), return_aux=True)
    assert aux is None
    mesh.initialize_model_parallel()
    try:
        fn = ppl.pipelined_loss_fn(
            embed=model.embed,
            run_layers=lambda c, x: model.run_layers_train(
                x, layers=c, return_aux=True),
            head_loss=model.head, num_microbatches=2)
        with torch.no_grad():
            got = float(fn(model.layers, t, y))
    finally:
        mesh.destroy_model_parallel()
    np.testing.assert_allclose(got, float(jm.loss(params, toks, tgt)),
                               rtol=2e-5)


def test_o2_casts_the_router_like_the_reference():
    """Under O2 the router kernel is cast to bf16 like every non-norm leaf
    (``precision.py:274-288``), as the JAX ``cast_params`` does."""
    jm, params, model = _gpt_pair()
    jcast = jamp.cast_params(params, jamp.get_policy("O2"))
    amp.cast_params(model, amp.get_policy("O2"))
    moe = model.layers[0].moe
    assert jcast["layers"]["moe"]["router"]["kernel"].dtype == jnp.bfloat16
    assert moe.router.kernel.dtype == torch.bfloat16
    assert model.layers[0].ln2.scale.dtype == torch.float32
    np.testing.assert_array_equal(
        moe.router.kernel.detach().float().numpy(),
        np.asarray(jcast["layers"]["moe"]["router"]["kernel"][0],
                   np.float32))


@pytest.mark.parametrize("features", [
    {}, dict(prefill_chunk=8, spec_k=2, prefix_cache=True)],
    ids=["monolithic", "chunked_spec_prefix"])
def test_serial_moe_engine_streams_match_the_jax_engine(features):
    """The serial MoE engine's greedy streams equal the JAX engine's:
    monolithic prefill (``serve_layers_prefill`` and ``_decode``), and
    chunked prefill with speculative decoding and the prefix cache (the
    K-query ``serve_layers_multi``), each routing the same token groups as
    the reference."""
    cfg = dict(TINY, max_seq_len=32, remat=False, moe_num_experts=4)
    jm = JaxGPTModel(JaxGPTConfig(compute_dtype=jnp.float32, **cfg))
    params = jm.init(jax.random.PRNGKey(0))
    model = GPTModel(GPTConfig(compute_dtype=torch.float32, **cfg),
                     device="cpu").params_from_numpy(_np(params))
    rng = np.random.default_rng(3)
    reqs = [(list(int(t) for t in rng.integers(0, 128, n)), m)
            for n, m in ((5, 6), (11, 5), (3, 7))]
    scfg = dict(max_batch=2, max_seq=24, block_size=8, **features)
    eng = Engine(model, ServeConfig(**scfg), device="cpu")
    res = eng.run([Request(prompt=list(p), max_new_tokens=m, request_id=i)
                   for i, (p, m) in enumerate(reqs)])
    jres = JaxEngine(jm, params, JaxServeConfig(**scfg)).run(
        [JaxRequest(prompt=list(p), max_new_tokens=m, request_id=i)
         for i, (p, m) in enumerate(reqs)])
    eng.drop_prefix_cache()
    assert eng.allocator.used == 0
    for rid, r in res.items():
        assert r.tokens == list(map(int, jres[rid].tokens))


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------


def _jax_moe_step(jm, num_microbatches, lr):
    """The JAX example's serial step (``pretrain_gpt.py:470-514`` with
    ``--moe-experts``, one device): the scaled loss of its pipelined loss
    with the router losses -- the mean over the micro-batches of
    ``GPTModel.loss`` -- and its grads, then ``apply_gradients``. The loss
    and grads run eagerly: under ``jit`` the first loss differs from the
    same step run eagerly by 7.3e-5 relative on bf16 params (XLA's fusion
    of the MoE block), where the port agrees with the eager step within
    1e-7."""
    policy = jamp.get_policy("O2")
    mp_opt = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=lr), policy)
    apply = jax.jit(mp_opt.apply_gradients)
    M = num_microbatches

    def step(params, opt_state, toks, tgts):
        scale = opt_state.scaler.loss_scale
        b = toks.shape[0] // M

        def loss(p):
            return sum(jm.loss(p, toks[i * b:(i + 1) * b],
                               tgts[i * b:(i + 1) * b])
                       for i in range(M)) / M * scale

        sl, sg = jax.value_and_grad(loss)(params)
        params, opt_state, _ = apply(opt_state, params, sg)
        return params, opt_state, sl / scale

    return mp_opt, step


def test_three_o2_moe_steps_of_pretrain_gpt_match_the_jax_step(monkeypatch):
    """``pretrain_gpt --moe-experts 4`` (O2, 2 micro-batches of 2, fp32
    compute) from the JAX init against the JAX example's serial step: the
    three losses (rtol 1e-5) and the masters after them (within 2.5 lr:
    Adam's first steps move an element by about lr whatever its grad)."""
    real_cfg = pg.GPTConfig
    monkeypatch.setattr(pg, "GPTConfig", lambda **c: real_cfg(
        **dict(c, compute_dtype=torch.float32)))
    lr = 1e-3
    argv = ["--hidden", "32", "--layers", "2", "--heads", "4", "--vocab",
            "64", "--seq", "16", "--micro-batch", "2", "--num-microbatches",
            "2", "--lr", str(lr), "--moe-experts", "4", "--device", "cpu"]
    args = pg.parse_args(argv)
    pg.check_slice(args)
    trainer = pg.from_args(args)
    assert trainer.model.cfg.moe_expert_axis is None  # dp 1: serial experts
    jm = JaxGPTModel(JaxGPTConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_attention_heads=4,
        max_seq_len=16, axis=None, hidden_dropout=0.0,
        compute_dtype=jnp.float32, remat=True, moe_num_experts=4))
    mp_opt, jstep = _jax_moe_step(jm, 2, lr)
    params = jamp.cast_params(jm.init(jax.random.PRNGKey(0)),
                              jamp.get_policy("O2"))
    opt_state = mp_opt.init(params)
    trainer.load_params_(_np(params))
    batches = pg.batches(args, trainer.batch)
    losses, jlosses = [], []
    for _ in range(3):
        toks, tgts = next(batches)
        loss, metrics = trainer.step(toks, tgts)
        assert not metrics["found_inf"]
        losses.append(float(loss))
        params, opt_state, jl = jstep(params, opt_state,
                                      jnp.asarray(toks.numpy()),
                                      jnp.asarray(tgts.numpy()))
        jlosses.append(float(jl))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    jmaster = jax.tree.leaves(_np(opt_state.master))
    got = jax.tree.leaves(module_tree(trainer.model,
                                      trainer.opt_state.master))
    for m, j in zip(got, jmaster):
        assert np.abs(m.numpy() - j).max() <= 2.5 * lr


def test_pretrain_moe_example_serial_matches_the_jax_example_step(
        monkeypatch):
    """``pretrain_moe_gpt --ep 1`` (O2 FusedAdam on one fixed batch, fp32
    compute) from the JAX init against the JAX example's serial
    ``train_step`` (``examples/moe/pretrain_moe_gpt.py:90-97``), run
    its loss and grads eagerly as above: three losses (rtol 1e-5),
    falling."""
    real_cfg = pm.GPTConfig
    monkeypatch.setattr(pm, "GPTConfig", lambda **c: real_cfg(
        **dict(c, compute_dtype=torch.float32)))
    kw = dict(experts=4, top_k=2, capacity_factor=1.25, hidden=32, layers=2,
              heads=4, vocab=64, seq=16, batch=4, lr=3e-3)
    bench = pm.build(ep=1, device="cpu", **kw)
    jm = JaxGPTModel(JaxGPTConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_attention_heads=4,
        max_seq_len=16, hidden_dropout=0.0, axis=None,
        compute_dtype=jnp.float32, remat=True, moe_num_experts=4,
        moe_top_k=2, moe_capacity_factor=1.25))
    policy = jamp.get_policy("O2")
    mp_opt = jamp.MixedPrecisionOptimizer(JaxFusedAdam(lr=3e-3), policy)
    params = jamp.cast_params(jm.init(jax.random.PRNGKey(0)), policy)
    opt_state = mp_opt.init(params)
    bench.load_params_(_np(params))
    toks, tgts = pm.fixed_batch(64, 4, 16)
    jt, jy = jnp.asarray(toks.numpy()), jnp.asarray(tgts.numpy())

    apply = jax.jit(mp_opt.apply_gradients)

    def train_step(params, opt_state):
        ls, gs = jax.value_and_grad(
            lambda q: mp_opt.scale_loss(jm.loss(q, jt, jy), opt_state))(
            params)
        params, opt_state, _ = apply(opt_state, params, gs)
        return params, opt_state, ls / opt_state.scaler.loss_scale

    losses, jlosses = [], []
    for _ in range(3):
        loss, metrics = bench.step(toks, tgts)
        assert not metrics["found_inf"]
        losses.append(float(loss))
        params, opt_state, jl = train_step(params, opt_state)
        jlosses.append(float(jl))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    out = pm.run(["--device", "cpu", "--ep", "1", "--experts", "4",
                  "--hidden", "32", "--layers", "1", "--heads", "4",
                  "--vocab", "64", "--seq", "16", "--batch", "2",
                  "--steps", "2"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
