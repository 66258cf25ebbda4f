"""DCGAN with amp: two models, two optimizers and three backward passes a
step (port of ``examples/dcgan/main_amp.py``).

    python -m apex_tpu_torch.examples.dcgan.main_amp --steps 10
    python -m apex_tpu_torch.examples.dcgan.main_amp --device cpu

The reference exercises amp with TWO models (G, D), TWO optimizers and
THREE losses a step (apex's ``amp.initialize([netD, netG], [optD, optG],
num_losses=3)``). Each (model, optimizer) pair owns a
``MixedPrecisionOptimizer`` state and scaler under the O2 policy, around
``FusedAdam(lr=2e-4, betas=(0.5, 0.999))``: the D step sums its two scaled
losses (real, fake) under one scaler, as two backward passes into the same
grads; G has its own scaler. An overflow in one scaler skips only its own
model's step.

The models are the reference's flax modules on NHWC 16 x 16 x 1 images,
``nz`` 32, batch 32: G is a dense layer to 4 x 4 x 32, a stride-2 transposed
convolution to 16 channels with a ReLU, another to 1 channel, then tanh; D
is two stride-2 4 x 4 convolutions (16 and 32 channels) with leaky ReLU 0.2
and a dense layer to one logit, which runs in fp32 while the rest computes
in bf16. Three things of flax that the port keeps: ``nn.Conv`` and
``nn.ConvTranspose`` pad "SAME" (padding 1 here, for the transposed one the
padding that doubles the size), flax's ``ConvTranspose`` does not flip its
kernel (``transpose_kernel=False``), so ``params_from_numpy`` carries its
kernel to ``conv_transpose2d`` flipped in space with in and out swapped, and
the dense layers see the NHWC order of the 4 x 4 maps. The losses are the
reference's fp32 binary cross-entropy on logits. ``--device cpu`` runs on the
CPU; the default is the card. No kernel of ``csrc/`` is on this path: the
reference's DCGAN reaches no Pallas kernel either.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import amp
from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.optimizers import FusedAdam


def _param(shape, gen, device, fan_in=None) -> nn.Parameter:
    """flax's defaults: lecun-normal kernels (``fan_in``), zero biases."""
    if fan_in is None:
        return nn.Parameter(torch.zeros(shape, device=device))
    w = torch.randn(shape, generator=gen, device=device) / fan_in ** 0.5
    return nn.Parameter(w)


class Generator(nn.Module):
    """``z (B, nz) -> (B, 16, 16, 1)`` NHWC images; parameters in PyTorch's
    layouts (``Linear`` ``(out, in)``, ``conv_transpose2d`` ``(in, out, kh,
    kw)``)."""

    def __init__(self, nz: int = 32, ngf: int = 16,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.ngf, self.dtype = ngf, dtype
        c = 4 * 4 * ngf * 2
        self.dense_weight = _param((c, nz), gen, dev, nz)
        self.dense_bias = _param((c,), gen, dev)
        self.deconv0_weight = _param((ngf * 2, ngf, 4, 4), gen, dev,
                                     16 * ngf * 2)
        self.deconv0_bias = _param((ngf,), gen, dev)
        self.deconv1_weight = _param((ngf, 1, 4, 4), gen, dev, 16 * ngf)
        self.deconv1_bias = _param((1,), gen, dev)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = F.linear(z.to(dt), self.dense_weight.to(dt),
                     self.dense_bias.to(dt))
        x = x.view(z.shape[0], 4, 4, self.ngf * 2).permute(0, 3, 1, 2)
        x = F.relu(F.conv_transpose2d(x, self.deconv0_weight.to(dt),
                                      self.deconv0_bias.to(dt), stride=2,
                                      padding=1))
        x = F.conv_transpose2d(x, self.deconv1_weight.to(dt),
                               self.deconv1_bias.to(dt), stride=2, padding=1)
        return torch.tanh(x).permute(0, 2, 3, 1)

    @torch.no_grad()
    def params_from_numpy(self, tree: Dict[str, Any]) -> "Generator":
        """Load the reference's flax ``Generator`` params (numpy arrays):
        ``Dense_0`` ``(in, out)`` transposed, each ``ConvTranspose_i``
        ``(kh, kw, in, out)`` flipped in space, to ``(in, out, kh, kw)``."""
        _copy(self.dense_weight, np.asarray(tree["Dense_0"]["kernel"]).T)
        _copy(self.dense_bias, tree["Dense_0"]["bias"])
        for i in (0, 1):
            k = np.asarray(tree[f"ConvTranspose_{i}"]["kernel"])
            _copy(getattr(self, f"deconv{i}_weight"),
                  k[::-1, ::-1].transpose(2, 3, 0, 1))
            _copy(getattr(self, f"deconv{i}_bias"),
                  tree[f"ConvTranspose_{i}"]["bias"])
        return self


class Discriminator(nn.Module):
    """``(B, 16, 16, 1)`` NHWC images -> ``(B,)`` logits; the convolutions
    in ``dtype``, the dense layer in fp32."""

    def __init__(self, ndf: int = 16, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, seed: int = 1):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.dtype = dtype
        self.conv0_weight = _param((ndf, 1, 4, 4), gen, dev, 16)
        self.conv0_bias = _param((ndf,), gen, dev)
        self.conv1_weight = _param((ndf * 2, ndf, 4, 4), gen, dev, 16 * ndf)
        self.conv1_bias = _param((ndf * 2,), gen, dev)
        c = 4 * 4 * ndf * 2
        self.dense_weight = _param((1, c), gen, dev, c)
        self.dense_bias = _param((1,), gen, dev)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = img.permute(0, 3, 1, 2).to(dt)
        for i in (0, 1):
            x = F.leaky_relu(F.conv2d(
                x, getattr(self, f"conv{i}_weight").to(dt),
                getattr(self, f"conv{i}_bias").to(dt), stride=2, padding=1),
                0.2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        return F.linear(x.float(), self.dense_weight.float(),
                        self.dense_bias.float())[:, 0]

    @torch.no_grad()
    def params_from_numpy(self, tree: Dict[str, Any]) -> "Discriminator":
        """Load the reference's flax ``Discriminator`` params: each
        ``Conv_i`` ``(kh, kw, in, out)`` to ``(out, in, kh, kw)``,
        ``Dense_0`` transposed."""
        for i in (0, 1):
            k = np.asarray(tree[f"Conv_{i}"]["kernel"])
            _copy(getattr(self, f"conv{i}_weight"), k.transpose(3, 2, 0, 1))
            _copy(getattr(self, f"conv{i}_bias"), tree[f"Conv_{i}"]["bias"])
        _copy(self.dense_weight, np.asarray(tree["Dense_0"]["kernel"]).T)
        _copy(self.dense_bias, tree["Dense_0"]["bias"])
        return self


def _copy(param: torch.Tensor, arr) -> None:
    src = torch.from_numpy(np.array(arr, dtype=np.float32))
    if tuple(src.shape) != tuple(param.shape):
        raise ValueError(f"tree shape {tuple(src.shape)} != parameter shape "
                         f"{tuple(param.shape)}")
    param.copy_(src.to(param.dtype))


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """The reference's fp32 binary cross-entropy on logits (O1 keeps losses
    fp32, lists/functional_overrides.py:29-68)."""
    x = logits.float()
    return torch.mean(torch.clamp_min(x, 0) - x * target
                      + torch.log1p(torch.exp(-x.abs())))


@dataclasses.dataclass
class Trainer:
    """G and D with their optimizers and states (:func:`build`)."""

    G: Generator
    D: Discriminator
    opt_g: amp.MixedPrecisionOptimizer
    opt_d: amp.MixedPrecisionOptimizer
    gs: amp.MPOptState
    ds: amp.MPOptState
    batch: int
    nz: int

    @torch.no_grad()
    def load_params_(self, g_tree, d_tree) -> "Trainer":
        """Before the first step: load the reference's flax params into G
        and D (cast to their dtypes) and copy the masters up from them."""
        for model, tree, state in ((self.G, g_tree, self.gs),
                                   (self.D, d_tree, self.ds)):
            model.params_from_numpy(tree)
            for m, p in zip(state.master, model.parameters()):
                m.copy_(p)
        return self

    def step(self, z: torch.Tensor, real: torch.Tensor,
             z2: torch.Tensor) -> Dict[str, Any]:
        """One iteration (the reference's ``train_step`` on explicit
        noise and data): D on real and ``G(z)`` (two scaled losses, two
        backward passes, one scaler), then G on ``D(G(z2))`` with the
        updated D (its own scaler). Returns both unscaled losses (floats)
        and both optimizers' metrics."""
        G, D = self.G, self.D
        with torch.no_grad():
            fake = G(z)
        D.zero_grad(set_to_none=True)
        l_real = bce_logits(D(real), 1.0)
        self.opt_d.scale_loss(l_real, self.ds).backward()
        l_fake = bce_logits(D(fake), 0.0)
        self.opt_d.scale_loss(l_fake, self.ds).backward()
        d_metrics = self.opt_d.step(self.ds, D)
        G.zero_grad(set_to_none=True)
        l_g = bce_logits(D(G(z2)), 1.0)
        self.opt_g.scale_loss(l_g, self.gs).backward()
        D.zero_grad(set_to_none=True)  # the G loss's grads reach D too
        g_metrics = self.opt_g.step(self.gs, G)
        return {"loss_d": float(l_real.detach() + l_fake.detach()),
                "loss_g": float(l_g.detach()), "d": d_metrics,
                "g": g_metrics}


def build(batch: int = 32, nz: int = 32, *,
          dtype: torch.dtype = torch.bfloat16, seed: int = 0,
          device: DeviceLike = None) -> Trainer:
    """The reference's models, policy and optimizers on one device (the
    card unless ``device="cpu"``), random weights from ``seed``."""
    dev = resolve_device(device)
    policy = amp.get_policy("O2")
    G = Generator(nz, dtype=dtype, device=dev, seed=seed)
    D = Discriminator(dtype=dtype, device=dev, seed=seed + 1)
    amp.cast_params(G, policy)
    amp.cast_params(D, policy)
    opt_g = amp.MixedPrecisionOptimizer(
        FusedAdam(lr=2e-4, betas=(0.5, 0.999)), policy)
    opt_d = amp.MixedPrecisionOptimizer(
        FusedAdam(lr=2e-4, betas=(0.5, 0.999)), policy)
    return Trainer(G, D, opt_g, opt_d, opt_g.init(G), opt_d.init(D), batch,
                   nz)


def run(argv=None) -> Dict[str, Any]:
    """Parse ``argv``, train, and return the trainer and the per-step
    history (losses and both loss scales after each step)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--nz", type=int, default=32)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    trainer = build(args.batch, args.nz, device=args.device)
    dev = trainer.G.dense_weight.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    history: List[Dict[str, Any]] = []
    for i in range(args.steps):
        z = torch.randn(args.batch, args.nz, generator=gen, device=dev)
        # synthetic "data": squashed noise blobs, as the reference's
        real = torch.tanh(torch.randn(args.batch, 16, 16, 1, generator=gen,
                                      device=dev))
        z2 = torch.randn(args.batch, args.nz, generator=gen, device=dev)
        out = trainer.step(z, real, z2)
        history.append({"loss_d": out["loss_d"], "loss_g": out["loss_g"],
                        "scale_d": trainer.ds.scaler.loss_scale,
                        "scale_g": trainer.gs.scaler.loss_scale,
                        "skipped_d": out["d"]["found_inf"],
                        "skipped_g": out["g"]["found_inf"]})
        if i % 2 == 0:
            print(f"step {i:3d} loss_D {out['loss_d']:.4f} loss_G "
                  f"{out['loss_g']:.4f} scales D={history[-1]['scale_d']:.0f}"
                  f" G={history[-1]['scale_g']:.0f}")
    print("done: two models, two optimizers, independent loss scalers")
    return {"trainer": trainer, "history": history}


def main(argv=None) -> Optional[int]:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
