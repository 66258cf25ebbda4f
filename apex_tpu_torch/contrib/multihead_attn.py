"""Fused self / encoder-decoder multi-head attention (port of
``apex_tpu/contrib/multihead_attn.py``, the counterpart of apex's
``apex.contrib.multihead_attn``).

The modules keep the reference's surface and behaviour
(``multihead_attn.py:49-250``):

- self-attention projects q, k and v with one packed ``in_weight``
  ``(E, 3E)``; encoder-decoder attention projects q from the decoder
  stream (``q_weight``) and packed k, v from the memory (``kv_weight``).
  Kernels keep the JAX layout ``(in, out)`` and are cast to the
  activation's dtype; batch-first ``(batch, seq, embed)`` activations;
- ``key_padding_mask`` (``(b, sk)`` bool, True = masked) becomes an
  additive ``(b, 1, 1, sk)`` fp32 bias of **-10000**, not -inf, so a fully
  padded row attends uniformly and gives no NaN; a bool ``attn_mask`` is
  -10000 where True, a float one is added as it is (``mask_additive``),
  reshaped to rank 4 and added to the padding bias;
- ``include_norm_add``: ``residual + dropout(out_proj(attn(LN(x))))``, the
  LayerNorm through :func:`apex_tpu_torch.ops.layer_norm` (kernels #7/#8 on
  the card);
- ``impl="fast"`` attends through :func:`apex_tpu_torch.ops.flash_attention`
  (kernels #1, #5, #6 on the card; the bias takes the resident route, read
  in place with stride 0 on its broadcast dims), ``impl="default"`` through
  the explicit :func:`apex_tpu_torch.ops.mha_reference`, the reference's
  XLA route. Each is the caller's choice: nothing switches from one to the
  other;
- with a dropout ``generator`` and ``dropout > 0``, attention takes the
  explicit-scores path (``einsum(q * scale, k)`` in q's dtype, then fp32,
  softmax, cast to q's dtype, dropout), as the reference does with a
  ``dropout_key``. The generator stands for the key: :func:`_split` splits
  it into one generator for the attention dropout and one for the output
  dropout, as ``:173`` and ``:226`` split the key.

q, k and v are strided views of the packed projection (``(b, h, s, d)``
with the packed row's stride): the kernels read them in place, the bf16
ones through TMA wherever ``_tma_operands`` finds them aligned (head_dim a
multiple of 8, 16-byte strides), which every 16-byte-aligned projection
of a head_dim that is a multiple of 8 is; otherwise that wrapper makes a
padded copy, as it does for every caller.

Weights are drawn from ``seed`` with the reference's initialisers (xavier
normal, gain 1/sqrt(2) on the packed input projections);
``params_from_numpy`` / ``to_numpy`` carry the JAX ``init`` tree across.
The modules run on the card unless ``device="cpu"``, where the kernels'
plain versions run through the same autograd Functions.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch._params import copy_array_
from apex_tpu_torch.ops.flash_attention import flash_attention, mha_reference
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.utils.nn import inverted_dropout

#: the additive bias of a masked key (``_padding_bias``): finite, so a row
#: with every key masked stays a uniform average and no NaN
MASKED = -10000.0


def _xavier(shape, dtype, gen: torch.Generator, device,
            gain: float = 1.0) -> torch.Tensor:
    """Xavier normal over an ``(in, out)`` kernel (``_xavier``): std
    ``gain * sqrt(2 / (fan_in + fan_out))``, drawn in fp32."""
    std = gain * math.sqrt(2.0 / (shape[0] + shape[-1]))
    w = torch.randn(shape, generator=gen, device=device) * std
    return w.to(dtype)


def _padding_bias(key_padding_mask: torch.Tensor) -> torch.Tensor:
    """``(b, sk)`` bool (True = exclude) -> additive ``(b, 1, 1, sk)``
    fp32 bias."""
    m = key_padding_mask[:, None, None, :]
    return torch.zeros(m.shape, device=m.device).masked_fill_(m, MASKED)


def _mask_bias(attn_mask: torch.Tensor) -> torch.Tensor:
    """``attn_mask`` as an fp32 additive bias of rank 4: bool -> -10000
    where True (torch's convention), float -> added as it is."""
    if attn_mask.dtype == torch.bool:
        extra = torch.zeros(attn_mask.shape, device=attn_mask.device
                            ).masked_fill_(attn_mask, MASKED)
    else:
        extra = attn_mask.float()
    return extra.reshape((1,) * (4 - extra.dim()) + tuple(extra.shape))


def _split(generator: Optional[torch.Generator]
           ) -> Tuple[Optional[torch.Generator], Optional[torch.Generator]]:
    """Two generators on ``generator``'s device, seeded from two draws of
    it (``jax.random.split`` of the dropout key), or ``(None, None)``. On
    a CUDA generator the seeds are read to the host: one wait a call, on
    the dropout path only."""
    if generator is None:
        return None, None
    seeds = torch.randint(0, 2 ** 62, (2,), generator=generator,
                          device=generator.device).tolist()
    return tuple(torch.Generator(device=generator.device).manual_seed(s)
                 for s in seeds)


class _MHABase(nn.Module):
    """What the two modules share (``_MHABase``): the heads, the optional
    pre-LayerNorm, the attention (flash, explicit, or explicit with
    probability dropout) and the output projection with its residual
    epilogue."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast",
                 params_dtype: torch.dtype = torch.float32, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if impl not in ("fast", "default"):
            raise ValueError("impl must be 'fast' (flash kernel) or "
                             "'default' (the explicit attention)")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.bias = bias
        self.include_norm_add = include_norm_add
        self.impl = impl
        self.params_dtype = params_dtype
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._init_params(gen)
        if include_norm_add:
            self._param("ln_scale", torch.ones(
                embed_dim, dtype=params_dtype, device=self.device))
            self._zeros("ln_bias", embed_dim)

    def _init_params(self, gen: torch.Generator) -> None:
        """The projections' parameters (``init``), in the JAX tree's
        order."""
        raise NotImplementedError

    def _param(self, name: str, value: torch.Tensor) -> None:
        self.register_parameter(name, nn.Parameter(value))

    def _kernel(self, name: str, shape, gen: torch.Generator,
                gain: float = 1.0) -> None:
        self._param(name, _xavier(shape, self.params_dtype, gen,
                                  self.device, gain))

    def _zeros(self, name: str, n: int) -> None:
        self._param(name, torch.zeros(n, dtype=self.params_dtype,
                                      device=self.device))

    def _maybe_norm(self, x: torch.Tensor) -> torch.Tensor:
        if not self.include_norm_add:
            return x
        return layer_norm(x, self.ln_scale, self.ln_bias)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """``(b, s, E)`` -> ``(b, h, s, d)``, a view."""
        b, s, _ = x.shape
        return x.view(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def _attend(self, q, k, v, bias, generator):
        """``(b, h, s, d)`` attention; probability dropout takes the
        explicit scores (``_attend``)."""
        if generator is not None and self.dropout > 0.0:
            scale = self.head_dim ** -0.5
            scores = torch.einsum("bhqd,bhkd->bhqk", q * scale, k).float()
            if bias is not None:
                scores = scores + bias
            probs = torch.softmax(scores, dim=-1).to(q.dtype)
            probs = inverted_dropout(probs, self.dropout, generator)
            return torch.einsum("bhqk,bhkd->bhqd", probs, v)
        if self.impl == "fast":
            return flash_attention(q, k, v, bias)
        return mha_reference(q, k, v, bias)

    def _finish(self, attn, residual, generator):
        b, h, s, d = attn.shape
        out = attn.transpose(1, 2).reshape(b, s, h * d)
        out = out @ self.out_weight.to(out.dtype)
        if self.bias:
            out = out + self.out_bias.to(out.dtype)
        if self.include_norm_add:
            out = residual + inverted_dropout(out, self.dropout, generator)
        return out

    # -- parameters ---------------------------------------------------------

    @torch.no_grad()
    def params_from_numpy(self, params: Mapping[str, Any]) -> "_MHABase":
        """Load the JAX ``init`` tree (flat names, ``(in, out)`` kernels)
        given as numpy arrays or tensors; the names and shapes must match
        the module's."""
        mine = dict(self.named_parameters())
        if set(params) != set(mine):
            raise ValueError(f"tree names {sorted(params)} != module names "
                             f"{sorted(mine)}")
        for name, p in mine.items():
            copy_array_(p, params[name], name)
        return self

    @torch.no_grad()
    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The JAX ``init`` tree, as fp32 numpy."""
        return {name: p.detach().float().cpu().numpy()
                for name, p in self.named_parameters()}


class SelfMultiheadAttn(_MHABase):
    """Self-attention (``self_multihead_attn.py``):
    ``forward(x, key_padding_mask=None, attn_mask=None, generator=None)``
    -> ``(b, s, E)``."""

    def _init_params(self, gen):
        e = self.embed_dim
        self._kernel("in_weight", (e, 3 * e), gen, gain=1.0 / math.sqrt(2.0))
        self._kernel("out_weight", (e, e), gen)
        if self.bias:
            self._zeros("in_bias", 3 * e)
            self._zeros("out_bias", e)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        residual = x
        h = self._maybe_norm(x)
        qkv = h @ self.in_weight.to(h.dtype)
        if self.bias:
            qkv = qkv + self.in_bias.to(h.dtype)
        q, k, v = qkv.split(self.embed_dim, dim=-1)
        bias = None
        if key_padding_mask is not None:
            bias = _padding_bias(key_padding_mask)
        if attn_mask is not None:
            extra = _mask_bias(attn_mask)
            bias = extra if bias is None else bias + extra
        g_attn, g_out = _split(generator)
        attn = self._attend(self._heads(q), self._heads(k), self._heads(v),
                            bias, g_attn)
        return self._finish(attn, residual, g_out)


class EncdecMultiheadAttn(_MHABase):
    """Encoder-decoder attention (``encdec_multihead_attn.py``): q from
    the decoder stream, packed k, v from the encoder memory;
    ``forward(query, key, key_padding_mask=None, generator=None)`` ->
    ``(b, sq, E)``."""

    def _init_params(self, gen):
        e = self.embed_dim
        self._kernel("q_weight", (e, e), gen, gain=1.0 / math.sqrt(2.0))
        self._kernel("kv_weight", (e, 2 * e), gen, gain=1.0 / math.sqrt(2.0))
        self._kernel("out_weight", (e, e), gen)
        if self.bias:
            self._zeros("q_bias", e)
            self._zeros("kv_bias", 2 * e)
            self._zeros("out_bias", e)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        residual = query
        hq = self._maybe_norm(query)
        q = hq @ self.q_weight.to(hq.dtype)
        kv = key @ self.kv_weight.to(key.dtype)
        if self.bias:
            q = q + self.q_bias.to(q.dtype)
            kv = kv + self.kv_bias.to(kv.dtype)
        k, v = kv.split(self.embed_dim, dim=-1)
        bias = None
        if key_padding_mask is not None:
            bias = _padding_bias(key_padding_mask)
        g_attn, g_out = _split(generator)
        attn = self._attend(self._heads(q), self._heads(k), self._heads(v),
                            bias, g_attn)
        return self._finish(attn, residual, g_out)


def mha_naive_reference(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                        num_heads: int, bias: bool = False) -> torch.Tensor:
    """Unfused ground truth of self-attention (``mha_naive_reference``) on
    a tree of tensors such as ``dict(module.named_parameters())``."""
    e = x.shape[-1]
    qkv = x @ params["in_weight"]
    if bias:
        qkv = qkv + params["in_bias"]
    b, s, _ = x.shape
    d = e // num_heads
    q, k, v = (t.reshape(b, s, num_heads, d).transpose(1, 2)
               for t in qkv.split(e, dim=-1))
    out = mha_reference(q, k, v, causal=False, scale=d ** -0.5)
    out = out.transpose(1, 2).reshape(b, s, e) @ params["out_weight"]
    if bias:
        out = out + params["out_bias"]
    return out
