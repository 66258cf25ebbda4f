"""Shared transformer backbone (port of ``apex_tpu/models/_transformer.py``).

The JAX package stacks every layer's parameters on a leading
``num_layers`` dim and scans them; here each layer is a module of an
``nn.ModuleList`` holding the same tree ``{ln1, qkv, proj, ln2, fc1, fc2}``
under the same names, and the helpers take that layer module where the
reference takes its parameter slice. Serial only: context parallelism,
sequence parallelism and MoE FFNs raise.

Rotary positions (``apply_rope`` / ``apply_rope_at``, one shared body
``_rope_rotate``) are ported with the reference's float64 pre-reduction of
the angles, so a rotation at position 1e6 matches it in fp32.

Training: :meth:`TransformerBase.run_layers_train` checkpoints each layer
with ``torch.utils.checkpoint`` when ``cfg.remat`` is set (the reference's
``jax.checkpoint`` of the layer body, ``_transformer.py:634-638``; policy
None/"full" = recompute everything) and applies inverted hidden dropout
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.transformer import tensor_parallel as tp


def remat_policy(name: Optional[str]) -> None:
    """Check a ``remat_policy`` (``_remat_policy``,
    ``_transformer.py:123-142``): None and "full" recompute the whole layer
    and are the only ones ported; the selective policies raise."""
    if name in (None, "full"):
        return None
    if name in ("save_attn", "dots"):
        raise NotImplementedError(
            f"remat_policy={name!r} (selective activation checkpointing) is "
            f"not in this slice of the port; it comes with a later PR "
            f"(ROADMAP Queue 1 item 6). Use None or 'full'.")
    raise ValueError(f"unknown remat_policy {name!r}")


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding (split-half / NeoX convention) on
    ``(b, heads, s, d)`` at GLOBAL ``positions`` of shape ``(s,)``
    (``_transformer.py:64-76``): scores depend on relative distance only,
    and no position table exists."""
    return _rope_rotate(x, positions, theta, batched=False)


def apply_rope_at(x: torch.Tensor, positions: torch.Tensor,
                  theta: float = 10000.0) -> torch.Tensor:
    """:func:`apply_rope` at PER-SEQUENCE positions ``(b, s)`` (the decode
    form, ``_transformer.py:79-87``), through the same body, so a token's
    rotation is the same bit for bit at equal position."""
    return _rope_rotate(x, positions, theta, batched=True)


#: the position split of the angle pre-reduction (``_transformer.py:98-112``)
ROPE_SPLIT = 2048


@functools.lru_cache(maxsize=16)
def _rope_tables(d: int, theta: float, device: torch.device):
    """``(K * inv_freq mod 2 pi, inv_freq)`` in fp32 on ``device``, the
    reduction done in float64 on the host once per (head_dim, theta,
    device): a host-to-device copy per call would make every layer wait for
    the card."""
    inv64 = theta ** (-np.arange(d // 2, dtype=np.float64) * 2.0 / d)
    kmod = np.mod(ROPE_SPLIT * inv64, 2 * np.pi).astype(np.float32)
    return (torch.from_numpy(kmod).to(device),
            torch.from_numpy(inv64.astype(np.float32)).to(device))


def _rope_rotate(x, positions, theta, *, batched):
    """The reference's rope body (``_transformer.py:90-121``). An angle
    ``pos * inv_freq`` in fp32 at pos = 1e6 is off by up to ~0.1 rad, so
    the integer position is split as ``a * K + r`` (K = 2048) and
    ``K * inv_freq`` is reduced modulo 2 pi in float64 on the host: every
    fp32 product stays below ~3e3 rad. Then the split-half rotation in
    fp32, cast back to x's dtype."""
    d = x.shape[-1]
    half = d // 2
    kmod, inv_freq = _rope_tables(d, float(theta), x.device)
    positions = positions.to(x.device)
    a = torch.div(positions, ROPE_SPLIT,
                  rounding_mode="floor").float()[..., None]
    r = torch.remainder(positions, ROPE_SPLIT).float()[..., None]
    ang = a * kmod + r * inv_freq  # (s, half) | (b, s, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if batched:  # broadcast over heads
        cos, sin = cos[:, None], sin[:, None]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def inverted_dropout(x: torch.Tensor, rate: float,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the rest by
    ``1 / (1 - rate)`` (``utils/nn.py:17-26``); identity without a
    generator or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


class LayerNormParams(nn.Module):
    """The ``{scale, bias}`` parameter pair of one LayerNorm (fp32 with the
    default params dtype -- the mixed-dtype LN contract)."""

    def __init__(self, hidden: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(hidden, dtype=dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(hidden, dtype=dtype,
                                             device=device))


class TransformerLayer(nn.Module):
    """One layer's parameter tree (the reference's per-layer slice)."""

    def __init__(self, cfg, device, generator: torch.Generator):
        super().__init__()
        c = cfg
        init = tp.scaled_normal(c.init_method_std)
        # Megatron scales output-layer init by 1/sqrt(2L)
        # (_transformer.py:280-283)
        out_init = tp.scaled_normal(
            c.init_method_std / (2 * c.num_layers) ** 0.5)
        kw = dict(params_dtype=c.params_dtype, device=device,
                  generator=generator)
        self.ln1 = LayerNormParams(c.hidden_size, c.params_dtype, device)
        self.qkv = tp.ColumnParallelLinear(
            c.hidden_size, 3 * c.hidden_size, init_method=init, **kw)
        self.proj = tp.RowParallelLinear(
            c.hidden_size, c.hidden_size, init_method=out_init, **kw)
        self.ln2 = LayerNormParams(c.hidden_size, c.params_dtype, device)
        self.fc1 = tp.ColumnParallelLinear(
            c.hidden_size, c.ffn, init_method=init, **kw)
        self.fc2 = tp.RowParallelLinear(
            c.ffn, c.hidden_size, init_method=out_init, **kw)


class TransformerBase(nn.Module):
    """Serial transformer plumbing shared by the model zoo.

    Subclasses set ``causal``. The config provides hidden_size,
    num_attention_heads, num_layers, ffn, head_dim, params_dtype,
    compute_dtype, init_method_std, vocab_size and attention_window.
    """

    causal: bool = True

    def __init__(self, config, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = c = config
        if c.hidden_size % c.num_attention_heads:
            raise ValueError("hidden_size must divide evenly into heads")
        self.device = device
        self.embedding = tp.VocabParallelEmbedding(
            c.vocab_size, c.hidden_size, params_dtype=c.params_dtype,
            init_method=tp.scaled_normal(c.init_method_std), device=device,
            generator=generator)
        self.layers = nn.ModuleList(
            TransformerLayer(c, device, generator)
            for _ in range(c.num_layers))

    # -- compute helpers ----------------------------------------------------

    def _ln(self, p: LayerNormParams, x: torch.Tensor) -> torch.Tensor:
        # mixed-dtype fused LN: activations in the compute dtype, fp32 γβ
        return layer_norm(x, p.scale, p.bias)

    def _dense(self, p: tp.ColumnParallelLinear,
               x: torch.Tensor) -> torch.Tensor:
        return p(x)

    def _qkv_heads(self, layer: TransformerLayer, h: torch.Tensor):
        """``(q, k, v)`` head tensors ``(b, heads, s, d)`` from the fused
        QKV projection, laid out ``(heads, 3, head_dim)``
        (``_transformer.py:400-430``). They are strided views of one
        product; the kernels take them without a copy. Under rotary
        positions q and k are rotated at :meth:`_token_positions` (serial:
        0 .. s-1)."""
        c = self.cfg
        b = h.shape[0]
        qkv = self._dense(layer.qkv, h)
        s = qkv.shape[1]
        n = qkv.shape[-1] // (3 * c.head_dim)
        qkv = qkv.view(b, s, n, 3, c.head_dim).permute(0, 2, 3, 1, 4)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if c.position_embedding == "rope":
            pos = self._token_positions(s, h.device)
            q, k = (apply_rope(q, pos, c.rope_theta),
                    apply_rope(k, pos, c.rope_theta))
        return q, k, v

    def _token_positions(self, s: int, device) -> torch.Tensor:
        """Global positions of the tokens (``_transformer.py:481-488``):
        serial, so ``0 .. s-1``; the context-parallel offset comes with
        ROADMAP Queue 1 item 15."""
        return torch.arange(s, dtype=torch.int64, device=device)

    def _attn_out(self, layer: TransformerLayer,
                  attn: torch.Tensor) -> torch.Tensor:
        """Head merge + output projection."""
        b, n, s, _ = attn.shape
        attn = attn.transpose(1, 2).reshape(b, s, n * self.cfg.head_dim)
        return self._dense(layer.proj, attn)

    def _attend(self, q, k, v, bias=None) -> torch.Tensor:
        """Core attention on ``(b, heads, s, d)`` (no context axis), with
        the config's sliding window (``_transformer.py:490-507``, serial
        branch); ``stream='auto'`` picks the kernels."""
        return flash_attention(q, k, v, bias, causal=self.causal,
                               window=self.cfg.attention_window)

    def _mlp(self, layer: TransformerLayer, h: torch.Tensor) -> torch.Tensor:
        # jax.nn.gelu is the tanh approximation (_transformer.py:534)
        return self._dense(layer.fc2, F.gelu(self._dense(layer.fc1, h),
                                             approximate="tanh"))

    def _layer(self, layer: TransformerLayer, h: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError

    def run_layers(self, h: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            h = self._layer(layer, h)
        return h

    def _dropout(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        return inverted_dropout(x, self.cfg.hidden_dropout, generator)

    def _layer_seeds(self, generator: Optional[torch.Generator]
                     ) -> List[Optional[int]]:
        """One seed per layer from ``generator`` (the reference splits the
        dropout key per layer, ``_transformer.py:587``). Each layer draws
        its masks from a fresh generator of its own seed, so a checkpointed
        layer's recompute draws the same masks as its forward."""
        n = len(self.layers)
        if generator is None or self.cfg.hidden_dropout == 0.0:
            return [None] * n
        seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                              device=generator.device)
        return [int(s) for s in seeds.tolist()]

    def _train_layer(self, layer: TransformerLayer, seed: Optional[int],
                     h: torch.Tensor) -> torch.Tensor:
        gen = None
        if seed is not None:
            gen = torch.Generator(device=h.device)
            gen.manual_seed(seed)
        return self._layer(layer, h, gen)

    def run_layers_train(self, h: torch.Tensor,
                         dropout_generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        """The differentiable layer drive: each layer checkpointed when
        ``cfg.remat`` is set (recomputed whole in the backward)."""
        remat_policy(self.cfg.remat_policy)
        for layer, seed in zip(self.layers,
                               self._layer_seeds(dropout_generator)):
            fn = functools.partial(self._train_layer, layer, seed)
            if self.cfg.remat and torch.is_grad_enabled():
                h = checkpoint(fn, h, use_reentrant=False)
            else:
                h = fn(h)
        return h
