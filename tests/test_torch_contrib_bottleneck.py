"""contrib.bottleneck and the frozen ResNets of the port against the JAX
package's, on the CPU.

``fold_batchnorm``, ``FrozenBatchNorm``, ``FastBottleneck`` (against the
JAX block on its own params, output and grads, and against the unfused
conv / scale / bias / ReLU chain), the block frozen even when a live norm
is passed, ``ResNet(norm_cls=...)``'s constructor surface, and
``ResNet50Frozen`` (width 8, 32x32 images): its wiring (no running
statistics anywhere, the ``{"params"}`` tree), logits and every grad
against ``jax.value_and_grad`` of the JAX model on the same params, and
the O2 cast (fp32 frozen-BN params, the epilogue in bf16). Tolerances:
fp32 2e-5 absolute for the block's outputs (the JAX test's bar), logits
1e-5 relative, grads 1e-4 of each grad's max |JAX grad| (fp32 convs summed
in another order, as ``tests/test_torch_resnet.py``). The spatially
parallel block (``SpatialBottleneck``: H split into strips over 4 gloo
ranks, one halo row swapped with each neighbour before the 3x3 conv)
against the serial block on the same weights, atol 2e-5 (the bar of
``tests/test_bottleneck.py:111-131``, where GSPMD splits H). Mirrors
``tests/test_bottleneck.py`` but its two ``assert_epilogues_fused`` cases
(HLO inspection: ROADMAP Queue 1 item 21).
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from apex_tpu.contrib import bottleneck as jbn
from apex_tpu.models import resnet as jresnet
from apex_tpu_torch import amp
from apex_tpu_torch.contrib import (
    FastBottleneck,
    FrozenBatchNorm,
    fold_batchnorm,
)
from apex_tpu_torch.models import ResNet50Frozen, resnet as tresnet
from apex_tpu_torch.parallel import SyncBatchNorm


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _load_block(block, params):
    """A JAX block's tree into a port block: HWIO kernels -> OIHW."""
    for name, mod in block.named_modules():
        if isinstance(mod, tresnet.Conv):
            mod.weight.data.copy_(_t(params[name]["kernel"]).permute(
                3, 2, 0, 1))
        elif isinstance(mod, FrozenBatchNorm):
            mod.scale.data.copy_(_t(params[name]["scale"]))
            mod.bias.data.copy_(_t(params[name]["bias"]))


def test_fold_batchnorm_matches_bn_inference():
    rng = np.random.default_rng(0)
    c = 8
    scale = rng.normal(1, 0.1, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean = rng.normal(0, 1, c).astype(np.float32)
    var = rng.uniform(0.5, 2, c).astype(np.float32)
    x = rng.normal(size=(2, 4, 4, c)).astype(np.float32)
    ref = (x - mean) / np.sqrt(var + 1e-5) * scale + bias
    s, b = fold_batchnorm(*map(_t, (scale, bias, mean, var)))
    np.testing.assert_allclose((_t(x) * s + b).numpy(), ref, rtol=1e-5,
                               atol=1e-6)
    js, jb = jbn.fold_batchnorm(*map(jnp.asarray, (scale, bias, mean, var)))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)


def test_frozen_bn_module_applies_folded_params():
    m = FrozenBatchNorm(4, fuse_relu=True, device="cpu")
    m.scale.data.copy_(torch.tensor([2.0, 2.0, 2.0, 2.0]))
    m.bias.data.copy_(torch.tensor([1.0, -2.0, 0.0, 0.0]))
    x = torch.tensor([[-1.0, 0.5, 2.0, -3.0]])
    np.testing.assert_allclose(m(x).detach().numpy(), [[0.0, 0.0, 4.0, 0.0]])
    jy = jbn.FrozenBatchNorm(fuse_relu=True).apply(
        {"params": {"scale": jnp.asarray(m.scale.detach().numpy()),
                    "bias": jnp.asarray(m.bias.detach().numpy())}},
        jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(m(x).detach().numpy(), np.asarray(jy))


def test_frozen_bn_in_the_input_dtype_and_the_ignored_surface():
    """x * s + b in x's dtype (bf16 stays bf16, unlike the live BN's
    fp32); channel_last picks the channel dim; momentum, axis_name and
    group_size are accepted and change nothing."""
    m = FrozenBatchNorm(3, momentum=0.5, axis_name="data", group_size=2,
                        channel_last=False, device="cpu")
    m.scale.data.copy_(torch.tensor([1.5, -2.0, 0.25]))
    x = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    y = m(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and m.scale.dtype == torch.float32
    want = x.to(torch.bfloat16) * m.scale.to(torch.bfloat16).reshape(
        1, 3, 1, 1)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="channel dim"):
        FrozenBatchNorm(3, device="cpu")(x)  # channel_last: dim -1 is 4


@pytest.fixture(scope="module")
def block_and_inputs():
    jblock = jbn.FastBottleneck(filters=8, strides=2)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 16, 16, 16)))
    params = jax.tree.map(np.asarray,
                          jblock.init(jax.random.PRNGKey(1), x))["params"]
    rng = np.random.default_rng(2)
    params = {k: {n: v + (0.1 * rng.normal(size=v.shape)).astype(np.float32)
                  if k.startswith("bn") else v for n, v in p.items()}
              for k, p in params.items()}
    block = FastBottleneck(16, 8, 2, device="cpu")
    _load_block(block, params)
    return jblock, block, params, x


def test_block_matches_jax_and_its_grads(block_and_inputs):
    jblock, block, params, x = block_and_inputs
    g = np.random.default_rng(3).normal(size=(2, 8, 8, 32)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jblock.apply({"params": p}, xx) * g)

    jout = jblock.apply({"params": params}, x)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, x)
    xt = _t(x).requires_grad_()
    out = block(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5)
    out.backward(_t(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-4)
    for name, mod in block.named_modules():
        if isinstance(mod, tresnet.Conv):
            got = mod.weight.grad.permute(2, 3, 1, 0).numpy()
            ref = np.asarray(jg[name]["kernel"])
        elif isinstance(mod, FrozenBatchNorm):
            got = np.stack([mod.scale.grad.numpy(), mod.bias.grad.numpy()])
            ref = np.stack([jg[name]["scale"], jg[name]["bias"]])
        else:
            continue
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), name


def test_matches_unfused_reference_chain(block_and_inputs):
    """The block against the hand-written conv / scale / bias / ReLU chain
    (the reference's bottleneck/test.py equivalence)."""
    _, block, p, x = block_and_inputs

    def conv(x, kern, stride=1):
        w = _t(kern).permute(3, 2, 0, 1)
        return F.conv2d(x, w, stride=stride,
                        padding=0 if w.shape[-1] == 1 else 1)

    def sb(y, name):
        return (y * _t(p[name]["scale"]).reshape(1, -1, 1, 1)
                + _t(p[name]["bias"]).reshape(1, -1, 1, 1))

    xc = _t(x).permute(0, 3, 1, 2)
    y = torch.relu(sb(conv(xc, p["conv1"]["kernel"]), "bn1"))
    y = torch.relu(sb(conv(y, p["conv2"]["kernel"], 2), "bn2"))
    y = sb(conv(y, p["conv3"]["kernel"]), "bn3")
    r = sb(conv(xc, p["conv_ds"]["kernel"], 2), "bn_ds")
    ref = torch.relu(y + r)
    with torch.no_grad():
        out = block(xc)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)


def test_fastbottleneck_freezes_even_with_live_norm_passed():
    """The ResNet's block wiring always passes a live-norm factory; the
    block ignores it: frozen by construction."""
    block = FastBottleneck(8, 4, norm=partial(SyncBatchNorm,
                                              channel_last=False,
                                              device="cpu"),
                           device="cpu")
    assert not list(block.buffers())  # no running statistics
    norms = [m for m in block.modules() if isinstance(m, FrozenBatchNorm)]
    assert len(norms) == 4  # bn1, bn2, bn3 and the downsample's bn_ds
    assert {n for n, _ in block.bn1.named_parameters()} == {"scale", "bias"}
    assert not any(isinstance(m, SyncBatchNorm) for m in block.modules())


def test_resnet_norm_cls_takes_the_syncbn_surface():
    seen = []

    def norm_cls(n, **kw):
        seen.append(kw)
        return FrozenBatchNorm(n, **kw)

    tresnet.ResNet((1,), tresnet.Bottleneck, num_classes=3, width=4,
                   norm_cls=norm_cls, device="cpu")
    assert seen and all(
        kw.keys() >= {"momentum", "axis_name", "group_size", "channel_last",
                      "device"} for kw in seen)
    assert {kw["momentum"] for kw in seen} == {0.1}
    assert {kw["channel_last"] for kw in seen} == {False}
    assert any(kw.get("fuse_relu") for kw in seen)


def test_resnet_frozen_wiring():
    """ResNet50Frozen is frozen throughout: every bn (the stem's too) is a
    scale/bias pair, no running statistics exist, and forward runs the
    same in train and eval mode."""
    model = ResNet50Frozen(num_classes=10, width=8, stem_pool=False,
                           device="cpu")
    assert not list(model.buffers())
    tree = model.to_numpy()
    assert set(tree) == {"params"}
    blk = tree["params"]["layer1_0"]
    assert set(blk["bn1"]) == {"scale", "bias"}
    assert set(tree["params"]["bn1"]) == {"scale", "bias"}
    assert "conv1" in blk and "conv_ds" in blk
    assert isinstance(model.layer1_0, FastBottleneck)
    x = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = model(x)
        model.eval()
        again = model(x)
    assert logits.shape == (1, 10) and torch.isfinite(logits).all()
    torch.testing.assert_close(logits, again, rtol=0, atol=0)


def test_resnet50_frozen_logits_and_grads_against_jax():
    jm = jresnet.ResNet50Frozen(num_classes=10, width=8, stem_pool=False)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), x))
    assert set(variables) == {"params"}
    tm = ResNet50Frozen(num_classes=10, width=8, stem_pool=False,
                        device="cpu")
    tm.params_from_numpy(variables)
    g = rng.normal(size=(2, 10)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jm.apply({"params": p}, x) * g)

    jlogits = np.asarray(jm.apply(variables, x))
    jgrads = jax.grad(jloss)(variables["params"])
    logits = tm(_t(x))
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=1e-5,
                               atol=1e-5 * np.abs(jlogits).max())
    logits.backward(_t(g))
    with torch.no_grad():  # the grads in the JAX layout, by to_numpy
        for p in tm.parameters():
            p.copy_(p.grad)
    flat_t = jax.tree_util.tree_leaves_with_path(tm.to_numpy()["params"])
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    assert {path for path, _ in flat_t} == set(flat_j)
    for path, got in flat_t:
        ref = np.asarray(flat_j[path])
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)


def test_o2_cast_keeps_frozen_bn_fp32():
    model = ResNet50Frozen(num_classes=10, width=8, stem_pool=False,
                           dtype=torch.bfloat16, device="cpu")
    amp.cast_params(model, amp.get_policy("O2"))
    assert model.conv1.weight.dtype == torch.bfloat16
    assert model.bn1.scale.dtype == torch.float32
    assert model.layer2_0.bn_ds.bias.dtype == torch.float32
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = model.layer1_0.bn1(model.layer1_0.conv1(
        model.bn1(model.conv1(x.to(torch.bfloat16).permute(0, 3, 1, 2)))))
    assert y.dtype == torch.bfloat16
    loss = model(x).float().square().mean()
    loss.backward()
    assert torch.isfinite(loss)
    assert model.bn1.scale.grad.dtype == torch.float32


def test_spatial_parallel_bottleneck_matches_serial(tmp_path):
    """``FastBottleneck(filters=8)`` on (2, 32, 16, 16) NHWC (the JAX
    test's shape; NCHW here) with seeded frozen-BN scales and biases, H
    split over 4 ranks: each rank's strip of the output equals the serial
    block's rows. The block's weights come from its default seed, the same
    on every rank."""
    from torch_dp_workers import run_ranks, spatial_bottleneck

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 32, 16)).astype(np.float32)
    scales = {n: (rng.uniform(0.5, 1.5, c).astype(np.float32),
                  rng.normal(size=c).astype(np.float32))
              for n, c in (("bn1", 8), ("bn2", 8), ("bn3", 32),
                           ("bn_ds", 32))}
    serial = FastBottleneck(16, 8, device="cpu")
    with torch.no_grad():
        for n, (s_, b_) in scales.items():
            getattr(serial, n).scale.copy_(torch.from_numpy(s_))
            getattr(serial, n).bias.copy_(torch.from_numpy(b_))
        ref = serial(torch.from_numpy(x)).numpy()
    strips = run_ranks(spatial_bottleneck, 4, tmp_path, x, scales)
    assert all(s_.shape == (2, 32, 8, 16) for s_ in strips)
    np.testing.assert_allclose(np.concatenate(strips, axis=2), ref,
                               atol=2e-5)
