"""contrib.sparsity of the port (ASP 2:4 masks, the ASP class workflow,
the channel-permutation search) against the JAX package's, on the CPU.

Masks: ``mn_mask_1d`` / ``compute_sparse_masks`` equal JAX's bit for bit
on the same numpy weights, fp32 and bf16 with ties inside groups of 4 (a
stable sort on both sides), conv kernels and other patterns; a module's
masks follow the JAX layout (a GPT's stacked layers, the ResNet's OIHW
convs) and equal JAX's on the JAX model's tree. The permutation search is
the same numpy code: the same permutation on the same input. The ASP
workflow, with the port's ``FusedAdam`` against the JAX ``FusedAdam``
through both ASP wrappers, and under amp O2. Tolerances: masks and
permutations exact; 20 Adam steps (lr 1e-2) 1e-4 of each leaf's max
(fp32 grads of two frameworks; an Adam step turns a near-zero grad's noise
into up to lr); a permuted network's output 1e-5 (fp32 products summed
in another order). Mirrors ``tests/test_asp.py``,
``tests/test_sparsity_permutation.py`` and the ASP cases of
``tests/test_aux_modules.py``; the JAX case that jits a step with masks
as traced values becomes the ``masks=`` precedence case.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from apex_tpu.contrib import sparsity as jsp
from apex_tpu.contrib.sparsity import ASP as JASP
from apex_tpu.contrib.sparsity import permutation as jplib
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import resnet as jresnet
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu_torch import amp
from apex_tpu_torch import optimizers as opts
from apex_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from apex_tpu_torch.contrib import sparsity
from apex_tpu_torch.contrib.sparsity import ASP, sequential_groups
from apex_tpu_torch.contrib.sparsity import permutation as plib
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.models import resnet as tresnet
from apex_tpu_torch.optimizers import FusedAdam


@pytest.fixture(autouse=True)
def _reset_asp():
    ASP.reset()
    JASP.reset()
    yield
    ASP.reset()
    JASP.reset()


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(jtree):
    return jax.tree.map(lambda a: _t(np.asarray(a)), jtree)


def _by_path(tree):
    none = lambda x: x is None  # noqa: E731
    return {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=none)}


def _same_masks(port, ref):
    """The same mask (or None) at every path of the two trees."""
    pl, rl = _by_path(port), _by_path(ref)
    assert set(pl) == set(rl)
    for path, a in pl.items():
        b = rl[path]
        assert (a is None) == (b is None), path
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), path)


# -- masks against JAX ----------------------------------------------------------

def _bf16_ties(rng, shape):
    """bf16 weights with many equal magnitudes inside groups of 4."""
    return rng.integers(-3, 4, shape).astype(np.float32) * 0.5


@pytest.mark.parametrize("case", ["fp32", "bf16_ties", "conv", "m8n4",
                                  "axis_-1"])
def test_masks_against_jax(case):
    rng = np.random.default_rng(0)
    m, n, axis = 4, 2, -2
    if case == "fp32":
        w = rng.normal(size=(16, 12)).astype(np.float32)
    elif case == "bf16_ties":
        w = _bf16_ties(rng, (32, 8))
    elif case == "conv":
        w = rng.normal(size=(3, 3, 8, 4)).astype(np.float32)
    elif case == "m8n4":
        w, m, n = rng.normal(size=(16, 8)).astype(np.float32), 8, 4
    else:
        w, axis = rng.normal(size=(6, 16)).astype(np.float32), -1
    dt, jdt = ((torch.bfloat16, jnp.bfloat16) if case == "bf16_ties"
               else (torch.float32, jnp.float32))
    got = sparsity.mn_mask_1d(_t(w).to(dt), m, n, axis=axis)
    ref = jsp.mn_mask_1d(jnp.asarray(w).astype(jdt), m, n, axis=axis)
    assert got.dtype == torch.bool and got.shape == w.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if case == "bf16_ties":
        # the ties decide: an unstable sort keeps other survivors
        assert (np.abs(w).reshape(-1, 4, 8) == 0.5).sum() > 0


def test_m4n2_mask_keeps_top2_per_group():
    w = torch.tensor([[1.0, -5.0, 0.1, 3.0, 9.0, -0.2, 0.3, -8.0]])
    m = sparsity.m4n2_mask_1d(w, axis=-1)
    assert m.tolist() == [[False, True, False, True, True, False, False,
                           True]]


def test_m4n2_mask_default_axis_is_contraction_dim():
    w = torch.randn(8, 3, generator=torch.Generator().manual_seed(0))
    kept = sparsity.m4n2_mask_1d(w).reshape(2, 4, 3).sum(1)
    assert (kept == 2).all()


def _gpt_pair():
    small = dict(vocab_size=64, hidden_size=32, num_layers=4,
                 num_attention_heads=4, max_seq_len=16)
    jm = JaxGPTModel(JaxGPTConfig(axis=None, hidden_dropout=0.0,
                                  compute_dtype=jnp.float32, remat=False,
                                  **small))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = GPTModel(GPTConfig(compute_dtype=torch.float32, **small),
                  device="cpu")
    tm.params_from_numpy(jp)
    return jp, tm


def test_module_masks_follow_the_jax_layout_of_a_gpt():
    """The stacked layer tree, as JAX holds it: a (4, 32) stacked bias is
    eligible and masked across layers, as JAX masks it; each layer's
    parameter gets its slice."""
    jp, tm = _gpt_pair()
    tree = sparsity.jax_layout_tree(tm)
    assert tree["layers"]["qkv"]["kernel"].shape == (4, 32, 96)
    got = sparsity.compute_sparse_masks(tree)
    ref = jsp.compute_sparse_masks(jax.tree.map(jnp.asarray, jp))
    _same_masks(got, ref)
    per_param = sparsity.module_masks(tm, got)
    names = [n for n, _ in tm.named_parameters()]
    assert len(per_param) == len(names)
    i = names.index("layers.2.fc1.kernel")
    np.testing.assert_array_equal(
        per_param[i].numpy(),
        np.asarray(ref["layers"]["fc1"]["kernel"][2]))
    i = names.index("layers.1.ln1.scale")
    np.testing.assert_array_equal(per_param[i].numpy(),
                                  np.asarray(ref["layers"]["ln1"]["scale"][1]))


def test_module_masks_of_oihw_convs_follow_hwio():
    kw = dict(num_classes=8, width=4, stem_pool=False)
    jm = jresnet._frozen_resnet((1, 1), **kw)
    x = np.zeros((1, 8, 8, 3), np.float32)
    jv = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), x))
    tm = tresnet._frozen_resnet((1, 1), device="cpu", **kw)
    tm.params_from_numpy(jv)
    ref = jsp.compute_sparse_masks(jax.tree.map(jnp.asarray, jv["params"]))
    got = sparsity.compute_sparse_masks(sparsity.jax_layout_tree(tm))
    _same_masks(got, ref)
    masks = dict(zip([n for n, _ in tm.named_parameters()],
                     sparsity.module_masks(tm, got)))
    w = masks["layer1_0.conv2.weight"]  # OIHW
    np.testing.assert_array_equal(
        w.permute(2, 3, 1, 0).numpy(),
        np.asarray(ref["layer1_0"]["conv2"]["kernel"]))
    assert masks["fc.weight"].shape == tm.fc.weight.shape


def test_asp_workflow_masks_and_remains_sparse():
    params = {"dense": {"kernel": torch.randn(16, 8),
                        "bias": torch.ones(8)},
              "odd": torch.ones(5)}
    masks = sparsity.compute_sparse_masks(params)
    assert masks["odd"] is None and masks["dense"]["bias"] is None
    pruned = sparsity.apply_masks(params, masks)
    assert sparsity.sparsity_ratio(pruned, masks) == pytest.approx(0.5)
    updated = {"dense": {k: v + 0.01 for k, v in pruned["dense"].items()},
               "odd": pruned["odd"] + 0.01}
    remasked = sparsity.apply_masks(updated, masks)
    zeros = remasked["dense"]["kernel"] == 0
    assert zeros.T.reshape(-1, 4).sum(1).min() >= 2


# -- the ASP class workflow -----------------------------------------------------

def _jparams(seed=0):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {
        "fc0": {"kernel": jax.random.normal(k1, (8, 16)),
                "bias": jnp.zeros(16)},
        "fc1": {"kernel": jax.random.normal(k2, (16, 16)),
                "bias": jnp.zeros(16)},
        "head": {"kernel": jax.random.normal(k3, (16, 4)),
                 "bias": jnp.zeros(4)},
    }


def _params(seed=0):
    return _tree(_jparams(seed))


def _sparsity(leaf):
    return float((leaf == 0).float().mean())


def _mlp_loss(p, x, y):
    h = torch.relu(x @ p["fc0"]["kernel"] + p["fc0"]["bias"])
    h = torch.relu(h @ p["fc1"]["kernel"] + p["fc1"]["bias"])
    return ((h @ p["head"]["kernel"] + p["head"]["bias"] - y) ** 2).mean()


def test_full_workflow_against_jax_through_training():
    """ASP-wrapped FusedAdam, 20 steps, against the JAX ASP-wrapped
    FusedAdam on the same params and batch: the pruned slots stay zero on
    both sides and the params agree."""
    jparams = _jparams()
    JASP.init_model_for_pruning(jparams, "m4n2_1d")
    jtx = JASP.init_optimizer_for_pruning(JFusedAdam(lr=1e-2))
    jparams, jmasks = JASP.compute_sparse_masks(jparams)
    params = _params()
    ASP.init_model_for_pruning(params, "m4n2_1d")
    opt = ASP.init_optimizer_for_pruning(FusedAdam(lr=1e-2))
    assert not ASP.is_sparsity_enabled()
    params, masks = ASP.compute_sparse_masks(params)
    assert ASP.is_sparsity_enabled()
    _same_masks(masks, jmasks)
    assert _sparsity(params["fc0"]["kernel"]) == pytest.approx(0.5)

    x = jax.random.normal(jax.random.PRNGKey(9), (4, 8))
    y = jax.random.normal(jax.random.PRNGKey(10), (4, 4))

    def jloss(p):
        h = jax.nn.relu(x @ p["fc0"]["kernel"] + p["fc0"]["bias"])
        h = jax.nn.relu(h @ p["fc1"]["kernel"] + p["fc1"]["bias"])
        return jnp.mean((h @ p["head"]["kernel"] + p["head"]["bias"] - y)
                        ** 2)

    jstate = jtx.init(jparams)
    leaves = sparsity.tree_leaves(params)
    state = opt.init(leaves)
    xt, yt = _t(x), _t(y)
    l0 = float(_mlp_loss(params, xt, yt))
    for _ in range(20):
        updates, jstate = jtx.update(jax.grad(jloss)(jparams), jstate,
                                     jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p in leaves:
            p.requires_grad_(True)
        grads = torch.autograd.grad(_mlp_loss(params, xt, yt), leaves)
        for p in leaves:
            p.requires_grad_(False)
        state = opt.update_(leaves, grads, state)
    assert float(_mlp_loss(params, xt, yt)) < l0
    for name in ("fc0", "fc1", "head"):
        m = masks[name]["kernel"]
        assert not params[name]["kernel"][~m].any()
    for a, b in zip(leaves, jax.tree.leaves(jparams)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()


def test_name_filters():
    params = _params()
    ASP.init_model_for_pruning(params, "m4n2_1d",
                               disallowed_layer_names=["head"])
    _, masks = ASP.compute_sparse_masks(params)
    assert masks["fc0"]["kernel"] is not None
    assert masks["head"]["kernel"] is None
    ASP.reset()
    ASP.init_model_for_pruning(params, allowed_layer_names=["fc1"])
    _, masks = ASP.compute_sparse_masks(params)
    assert masks["fc0"]["kernel"] is None
    assert masks["fc1"]["kernel"] is not None


def test_pattern_string_m8n4():
    params = {"w": {"kernel": torch.randn(16, 8)}}
    ASP.init_model_for_pruning(params, "m8n4_1d")
    pruned, masks = ASP.compute_sparse_masks(params)
    assert _sparsity(pruned["w"]["kernel"]) == pytest.approx(0.5)
    assert (masks["w"]["kernel"].reshape(2, 8, 8).sum(1) == 4).all()


def test_restore_pruned_weights_roundtrip():
    params = _params()
    ASP.init_model_for_pruning(params, allow_recompute_mask=True)
    pruned, _ = ASP.compute_sparse_masks(params)
    dense = ASP.restore_pruned_weights(pruned)
    assert not ASP.is_sparsity_enabled()
    for a, b in zip(sparsity.tree_leaves(dense),
                    sparsity.tree_leaves(params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_prune_trained_model_one_call_with_permutation():
    params = _params(seed=3)
    groups = sequential_groups(["fc0", "fc1", "head"])
    pruned, masks, opt = ASP.prune_trained_model(params, FusedAdam(lr=1e-3),
                                                 permutation_groups=groups)
    jpruned, jmasks, _ = JASP.prune_trained_model(
        _jparams(seed=3), optax.adam(1e-3),
        permutation_groups=jplib.sequential_groups(["fc0", "fc1", "head"]))
    _same_masks(masks, jmasks)
    for a, b in zip(sparsity.tree_leaves(pruned), jax.tree.leaves(jpruned)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ASP.is_sparsity_enabled()
    assert _sparsity(pruned["fc1"]["kernel"]) == pytest.approx(0.5)
    leaves = sparsity.tree_leaves(pruned)
    before = [p.clone() for p in leaves]
    state = opt.init(leaves)
    opt.update_(leaves, [torch.ones_like(p) for p in leaves], state)
    m = masks["fc1"]["kernel"]
    i = [id(p) for p in leaves].index(id(pruned["fc1"]["kernel"]))
    # pruned slots received a zero update: their old values, zero here
    assert torch.equal(leaves[i][~m], before[i][~m])
    assert not leaves[i][~m].any() and leaves[i][m].ne(before[i][m]).all()


def test_explicit_masks_take_precedence_over_the_class_state():
    """``update_(..., masks=...)`` wins over the class state: all-ones
    masks let every slot move, the real ones freeze the pruned slots; a
    pruned slot keeps its old value (here made nonzero), it is not
    re-masked to zero."""
    params = _params()
    ASP.init_model_for_pruning(params)
    opt = ASP.init_optimizer_for_pruning(FusedAdam(lr=1e-1))
    pruned, masks = ASP.compute_sparse_masks(params)
    ones = sparsity._tree_map(
        lambda p, m: None if m is None else torch.ones_like(m), pruned,
        masks)
    m = masks["fc0"]["kernel"]
    i = [id(p) for p in sparsity.tree_leaves(pruned)].index(
        id(pruned["fc0"]["kernel"]))

    def step(mask_arg):
        leaves = [p.clone() for p in sparsity.tree_leaves(pruned)]
        leaves[i][~m] = 0.25
        state = opt.init(leaves)
        opt.update_(leaves, [torch.ones_like(p) for p in leaves], state,
                    masks=mask_arg)
        return leaves[i]

    assert (step(ones)[~m] != 0.25).all()  # updates flowed
    assert (step(masks)[~m] == 0.25).all()  # frozen at their old value
    assert (step(None)[~m] == 0.25).all()  # the class state: frozen too


@pytest.mark.parametrize("make", [
    lambda: FusedAdam(lr=1e-2, weight_decay=0.01),
    lambda: opts.FusedLAMB(lr=1e-2, weight_decay=0.01),
    lambda: opts.FusedSGD(lr=0.1, momentum=0.9, nesterov=True),
    lambda: opts.FusedAdagrad(lr=0.1),
    lambda: opts.FusedNovoGrad(lr=1e-2),
    lambda: opts.LARC(opts.FusedSGD(lr=0.1, momentum=0.9)),
], ids=["adam", "lamb", "sgd", "adagrad", "novograd", "larc"])
def test_the_wrapper_takes_any_port_optimizer(make):
    """A step of the wrapped optimizer equals the inner one's on every
    unpruned slot and leaves every pruned slot as it was; a second step
    (LAMB's and LARC's trust ratios read the whole param, pruned slots
    included, as the reference's do) leaves them as they were too."""
    params = _params(seed=5)
    ASP.init_model_for_pruning(params)
    pruned, masks = ASP.compute_sparse_masks(params)
    masks = sparsity.tree_leaves(masks)
    wrapped, inner = ASP.init_optimizer_for_pruning(make()), make()
    a = [p.clone() + 0.5 for p in sparsity.tree_leaves(pruned)]
    b = [p.clone() for p in a]
    sa, sb = wrapped.init(a), inner.init(b)
    gen = torch.Generator().manual_seed(6)
    grads = [torch.randn(p.shape, generator=gen) for p in a]
    sa = wrapped.update_(a, grads, sa)
    inner.update_(b, grads, sb)
    for p, q, m in zip(a, b, masks):
        if m is None:
            assert torch.equal(p, q)
        else:
            assert torch.equal(p[m], q[m])
            assert (p[~m] == 0.5).all() and (q[~m] != 0.5).all()
    before = [p.clone() for p in a]
    wrapped.update_(a, [torch.randn(p.shape, generator=gen) for p in a], sa)
    for p, q, m in zip(a, before, masks):
        if m is not None:
            assert (p[~m] == 0.5).all() and not torch.equal(p[m], q[m])


def test_eligibility_follows_pattern_group_size():
    params = {"w": {"kernel": torch.randn(12, 8)}}
    ASP.init_model_for_pruning(params, "m8n4_1d")
    _, masks = ASP.compute_sparse_masks(params)
    assert masks["w"]["kernel"] is None
    ASP.reset()
    params = {"w": {"kernel": torch.randn(6, 8)}}
    ASP.init_model_for_pruning(params, "m2n1_1d")
    pruned, masks = ASP.compute_sparse_masks(params)
    assert masks["w"]["kernel"] is not None
    assert _sparsity(pruned["w"]["kernel"]) == pytest.approx(0.5)


def test_degenerate_patterns_rejected():
    for bad in ("m4n6_1d", "m4n4_1d", "m4n0_1d"):
        ASP.reset()
        with pytest.raises(ValueError, match="0 < n < m"):
            ASP.init_model_for_pruning(_params(), bad)
    with pytest.raises(ValueError, match="unsupported"):
        ASP.init_model_for_pruning(_params(), "m4n2_2d")


def test_name_filters_match_path_components_exactly():
    params = {"fc1": {"kernel": torch.randn(8, 8)},
              "fc10": {"kernel": torch.randn(8, 8)}}
    ASP.init_model_for_pruning(params, disallowed_layer_names=["fc1"])
    _, masks = ASP.compute_sparse_masks(params)
    assert masks["fc1"]["kernel"] is None
    assert masks["fc10"]["kernel"] is not None


def test_double_restore_errors():
    params = _params()
    ASP.init_model_for_pruning(params, allow_recompute_mask=True)
    pruned, _ = ASP.compute_sparse_masks(params)
    ASP.restore_pruned_weights(pruned)
    with pytest.raises(RuntimeError):
        ASP.restore_pruned_weights(pruned)


def test_double_init_errors():
    ASP.init_model_for_pruning(_params())
    with pytest.raises(RuntimeError, match="already"):
        ASP.init_model_for_pruning(_params())
    assert ASP.already_init_asp_model()


def test_works_under_mixed_precision_optimizer():
    """ASP inside amp's MixedPrecisionOptimizer on a module pruned in
    place (O2): after each step the fp32 masters and the bf16 params keep
    every pruned slot at zero."""
    tm = GPTModel(GPTConfig(vocab_size=64, hidden_size=32, num_layers=4,
                            num_attention_heads=4, max_seq_len=16,
                            compute_dtype=torch.bfloat16), device="cpu")
    policy = amp.get_policy("O2")
    amp.cast_params(tm, policy)
    ASP.init_model_for_pruning(tm, allowed_layer_names=["kernel"])
    mp = amp.MixedPrecisionOptimizer(
        ASP.init_optimizer_for_pruning(FusedAdam(lr=1e-3)), policy)
    _, masks = ASP.compute_sparse_masks(tm)
    state = mp.init(tm)
    assert sum(m is not None for m in masks) == 4 * 4  # the 4 kernels a layer
    tokens = torch.randint(0, 64, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        loss = tm.loss(tokens, torch.roll(tokens, -1, dims=-1))
        mp.scale_loss(loss, state).backward()
        assert not mp.step(state, tm)["found_inf"]
        for p, master, m in zip(tm.parameters(), state.master, masks):
            if m is not None:
                assert not p[~m].any() and not master[~m].any()
    assert sparsity.sparsity_ratio(list(tm.parameters()), masks) == 0.5


def test_module_restore_in_place():
    tm = GPTModel(GPTConfig(vocab_size=64, hidden_size=32, num_layers=4,
                            num_attention_heads=4, max_seq_len=16,
                            compute_dtype=torch.float32), device="cpu")
    before = [p.detach().clone() for p in tm.parameters()]
    ASP.init_model_for_pruning(tm, allow_recompute_mask=True)
    model, masks = ASP.compute_sparse_masks(tm)
    assert model is tm
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     tm.parameters()))
    with pytest.raises(ValueError, match="flat tree"):
        ASP.compute_sparse_masks(tm, sequential_groups(["a", "b"]))
    ASP.restore_pruned_weights(tm)
    for a, p in zip(before, tm.parameters()):
        torch.testing.assert_close(p.detach(), a, rtol=0, atol=0)


# -- the permutation search -----------------------------------------------------

def _naive_sum_after_2to4(m):
    total = 0.0
    for row in range(m.shape[0]):
        for col in range(0, m.shape[1], 4):
            total += np.sort(np.abs(m[row, col:col + 4]))[2:].sum()
    return total


def test_sum_after_2to4_matches_naive():
    m = np.random.default_rng(0).normal(size=(16, 24))
    assert plib.sum_after_2_to_4(m) == pytest.approx(
        _naive_sum_after_2to4(m))


def test_batched_evaluation_matches_single():
    m = np.random.default_rng(1).normal(size=(8, 8))
    perms = plib.canonical_permutations(8)
    batched = plib._batched_sum_2to4(m.T[perms].swapaxes(-1, -2))
    for i in [0, 3, len(perms) - 1]:
        assert batched[i] == pytest.approx(
            plib.sum_after_2_to_4(m[:, perms[i]]))


def test_canonical_permutation_count_matches_analytic():
    for c, expected in [(4, 1), (8, 35), (12, 5775)]:
        assert plib.predict_unique_combinations(c) == expected
        assert len(plib.canonical_permutations(c)) == expected
    np.testing.assert_array_equal(plib.canonical_permutations(8),
                                  jplib.canonical_permutations(8))


def test_canonical_identity_first():
    np.testing.assert_array_equal(plib.canonical_permutations(8)[0],
                                  np.arange(8))


def _adversarial_matrix(k=32, c=16, seed=0):
    """Three large channels a stripe of 4: pruning must drop one."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(k, c)) * 0.01
    for g in range(c // 4):
        m[:, g * 4: g * 4 + 3] += rng.normal(size=(k, 3)) * 10.0
    return m


def test_exhaustive_search_improves_adversarial():
    m = _adversarial_matrix(c=8)
    perm, improvement = plib.exhaustive_search_matrix(m)
    assert improvement > 0
    assert plib.sum_after_2_to_4(m[:, perm]) == pytest.approx(
        plib.sum_after_2_to_4(m) + improvement)


@pytest.mark.parametrize("kw", [dict(escape_attempts=10),
                                dict(stripe_group_size=12, escape_attempts=2),
                                dict(wide_matrix_threshold=32,
                                     max_swap_attempts=500)])
def test_search_equals_jax(kw):
    c = 16 if kw.get("stripe_group_size") == 12 else 32
    m = _adversarial_matrix(c=c, seed=2)
    perm = plib.search_for_good_permutation(m, **kw)
    np.testing.assert_array_equal(perm,
                                  jplib.search_for_good_permutation(m, **kw))
    np.testing.assert_array_equal(np.sort(perm), np.arange(c))


def test_stripe_window_search_improves_and_is_valid_perm():
    m = _adversarial_matrix(c=32)
    perm = plib.search_for_good_permutation(m, escape_attempts=10)
    np.testing.assert_array_equal(np.sort(perm), np.arange(32))
    assert plib.sum_after_2_to_4(m[:, perm]) > plib.sum_after_2_to_4(m) * 1.02


def test_search_skips_when_pruning_lossless():
    m = np.zeros((8, 16))
    m[:, ::4] = 1.0
    m[:, 1::4] = 2.0
    np.testing.assert_array_equal(plib.search_for_good_permutation(m),
                                  np.arange(16))


def test_progressive_channel_swap_improves_wide():
    m = _adversarial_matrix(k=16, c=64)
    perm = plib.search_for_good_permutation(m, wide_matrix_threshold=32,
                                            max_swap_attempts=4000)
    np.testing.assert_array_equal(np.sort(perm), np.arange(64))
    assert plib.sum_after_2_to_4(m[:, perm]) > plib.sum_after_2_to_4(m)


def _mlp_params(sizes, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(sizes) - 1)
    params = {}
    for i, key in enumerate(keys):
        kk, bk = jax.random.split(key)
        params[f"fc{i}"] = {
            "kernel": jax.random.normal(kk, (sizes[i], sizes[i + 1])) * 0.5,
            "bias": jax.random.normal(bk, (sizes[i + 1],)) * 0.1,
        }
    return params


def _mlp_apply(params, x, n_layers):
    for i in range(n_layers):
        x = x @ params[f"fc{i}"]["kernel"] + params[f"fc{i}"]["bias"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def test_permutation_preserves_function_and_equals_jax():
    jparams = _mlp_params([8, 16, 24, 8])
    params = _tree(jparams)
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(9))
    ref = _mlp_apply(params, x, 3)
    groups = plib.sequential_groups(["fc0", "fc1", "fc2"])
    permuted, perms = plib.search_and_permute(params, groups,
                                              escape_attempts=5)
    jpermuted, jperms = jplib.search_and_permute(
        jparams, jplib.sequential_groups(["fc0", "fc1", "fc2"]),
        escape_attempts=5)
    assert set(perms) == {0, 1}
    for i in perms:
        np.testing.assert_array_equal(perms[i], jperms[i])
    for a, b in zip(sparsity.tree_leaves(permuted),
                    jax.tree.leaves(jpermuted)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    torch.testing.assert_close(_mlp_apply(permuted, x, 3), ref, rtol=1e-5,
                               atol=1e-5)


def test_permuted_masks_preserve_more_magnitude():
    params = _tree(_mlp_params([16, 32, 32, 16], seed=3))
    params["fc1"]["kernel"] = _t(_adversarial_matrix(k=32, c=32, seed=7).T)
    params["fc2"]["kernel"] = _t(_adversarial_matrix(k=16, c=32, seed=8).T)
    groups = plib.sequential_groups(["fc0", "fc1", "fc2"])
    permuted, _ = plib.search_and_permute(params, groups, escape_attempts=10)

    def retained(p):
        return sum(plib.magnitude_after_mask(p[n]["kernel"])
                   for n in ("fc1", "fc2"))

    assert retained(permuted) > retained(params) * 1.01


def test_channelwise_params_follow_k_permutation():
    params = {"fc0": {"kernel": torch.arange(12.0).reshape(3, 4),
                      "bias": torch.arange(4.0),
                      "scale": torch.arange(4.0) + 10},
              "fc1": {"kernel": torch.ones(4, 2)}}
    perm = np.array([2, 0, 3, 1])
    out = plib.apply_channel_permutation(
        params, plib.ChannelGroup(consumers=["fc1"], producers=["fc0"]),
        perm)
    assert out["fc0"]["bias"].tolist() == perm.astype(float).tolist()
    assert out["fc0"]["scale"].tolist() == (perm + 10.0).tolist()
    torch.testing.assert_close(out["fc0"]["kernel"],
                               torch.arange(12.0).reshape(3, 4)[:, perm])
    assert params["fc0"]["bias"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_conv_kernel_permutation():
    rng = np.random.default_rng(0)
    params = {"conv0": {"kernel": _t(rng.normal(size=(3, 3, 4, 8)))},
              "conv1": {"kernel": _t(rng.normal(size=(3, 3, 8, 4)))}}
    permuted, perms = plib.search_and_permute(
        params, [plib.ChannelGroup(consumers=["conv1"],
                                   producers=["conv0"])])
    p = perms[0]
    np.testing.assert_array_equal(np.sort(p), np.arange(8))
    torch.testing.assert_close(permuted["conv1"]["kernel"],
                               params["conv1"]["kernel"][:, :, p, :])


def test_sibling_consumers_share_permutation():
    rng = np.random.default_rng(4)
    params = {"prod": {"kernel": _t(rng.normal(size=(8, 16))),
                       "bias": _t(rng.normal(size=(16,)))},
              "a": {"kernel": _t(_adversarial_matrix(8, 16, seed=5).T)},
              "b": {"kernel": _t(_adversarial_matrix(8, 16, seed=6).T)}}
    group = plib.ChannelGroup(consumers=["a", "b"], producers=["prod"])
    permuted, perms = plib.search_and_permute(params, [group],
                                              escape_attempts=5)
    p = perms[0]
    x = _t(rng.normal(size=(2, 8)))
    h_ref = x @ params["prod"]["kernel"] + params["prod"]["bias"]
    h_new = x @ permuted["prod"]["kernel"] + permuted["prod"]["bias"]
    torch.testing.assert_close(h_new, h_ref[:, p], rtol=0, atol=1e-6)
    for name in ("a", "b"):
        torch.testing.assert_close(permuted[name]["kernel"],
                                   params[name]["kernel"][p, :], rtol=0,
                                   atol=0)


def test_permutation_on_bf16_tensors_keeps_dtype():
    params = {"fc0": {"kernel": torch.randn(4, 8).bfloat16(),
                      "bias": torch.randn(8).bfloat16()},
              "fc1": {"kernel": torch.randn(8, 4).bfloat16()}}
    out, perms = plib.search_and_permute(params, plib.sequential_groups(
        ["fc0", "fc1"]))
    assert out["fc1"]["kernel"].dtype == torch.bfloat16
    torch.testing.assert_close(out["fc1"]["kernel"],
                               params["fc1"]["kernel"][perms[0]])


def test_checkpoint_round_trip_with_permutation(tmp_path):
    params = _tree(_mlp_params([8, 16, 16, 8], seed=11))
    groups = plib.sequential_groups(["fc0", "fc1", "fc2"])
    permuted, _ = plib.search_and_permute(params, groups, escape_attempts=5)
    masks = sparsity.compute_sparse_masks(permuted)
    pruned = sparsity.apply_masks(permuted, masks)
    state = {"params": pruned, "masks": masks}
    save_checkpoint(str(tmp_path), 7, state)
    restored = restore_checkpoint(str(tmp_path), state, 7)
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(_mlp_apply(restored["params"], x, 3),
                               _mlp_apply(pruned, x, 3), rtol=0, atol=1e-6)
    remasked = sparsity.apply_masks(restored["params"], restored["masks"])
    for a, b in zip(sparsity.tree_leaves(remasked),
                    sparsity.tree_leaves(restored["params"])):
        assert torch.equal(a, b)
