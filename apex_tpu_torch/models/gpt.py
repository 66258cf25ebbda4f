"""Megatron-style GPT (port of ``apex_tpu/models/gpt.py``), serial.

Token embedding + learned positions (or rotary positions on q/k, with no
position table), then per layer the pre-LN block
``h + proj(attn(LN(h)))``, ``h + fc2(gelu(fc1(LN(h))))``, then the final LN
and the LM head tied to the embedding. The parameter tree and its names are
the JAX model's, layer by layer; :meth:`GPTModel.params_from_numpy` loads a
JAX tree (as numpy arrays) so both compute the same thing.

Training goes through the differentiable :meth:`GPTModel.forward` (per-token
loss with targets, logits without) and :meth:`GPTModel.loss` (the mean
per-token loss): per-layer activation checkpointing (``remat``), hidden
dropout from an explicit ``torch.Generator``, and the chunked LM-head CE
(``lm_head_chunks``). ``apply`` is inference only (``torch.no_grad``, full-
context logits), and the serving drives ``embed_at`` /
``serve_layers_prefill`` / ``serve_layers_decode`` /
``serve_layers_multi`` / ``serve_head`` thread
the paged KV pool of ``apex_tpu_torch.serve``. The sliding
``attention_window`` runs on both devices (the streamed flash kernels on the
card). Tensor/sequence/context parallelism, MoE FFNs, selective remat
policies and serving a model with rotary positions are later slices and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.models._transformer import (
    LayerNormParams,
    TransformerBase,
    TransformerLayer,
    remat_policy,
)
from apex_tpu_torch.ops.flash_decode import flash_decode, flash_decode_multi
from apex_tpu_torch.ops.lm_head_loss import lm_head_cross_entropy
from apex_tpu_torch.transformer import tensor_parallel as tp


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Model hyperparameters; the defaults are GPT-2 345M (the reference's
    flagship: vocab 50304, hidden 1024, 24 layers, 16 heads, seq 1024)."""

    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_attention_heads: int = 16
    max_seq_len: int = 1024
    ffn_hidden_size: Optional[int] = None  # default 4 * hidden
    axis: Optional[str] = None  # tensor parallelism: a later slice
    sequence_parallel: bool = False
    params_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    init_method_std: float = 0.02
    attention_window: Optional[int] = None
    position_embedding: str = "learned"  # learned | rope | none
    rope_theta: float = 10000.0
    context_axis: Optional[str] = None
    moe_num_experts: Optional[int] = None
    hidden_dropout: float = 0.1  # applied only with a dropout generator
    remat: bool = True  # activation checkpointing per layer (training)
    remat_policy: Optional[str] = None  # None/"full"; selective: later
    # vocab chunks of the fused LM-head CE (None: plain head + per-token CE)
    lm_head_chunks: Optional[int] = None

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _check_slice(c: GPTConfig, device: torch.device) -> None:
    later = {
        "axis": (c.axis is not None, "tensor parallelism (Queue 1 item 10)"),
        "sequence_parallel": (c.sequence_parallel,
                              "sequence parallelism (Queue 1 item 10)"),
        "context_axis": (c.context_axis is not None,
                         "ring/Ulysses context parallelism (Queue 1 item 15)"),
        "moe_num_experts": (c.moe_num_experts is not None,
                            "MoE FFNs (Queue 1 item 16)"),
    }
    remat_policy(c.remat_policy)
    for name, (on, where) in later.items():
        if on:
            raise NotImplementedError(
                f"GPTConfig {name} is not in this slice of the port; it "
                f"comes with {where}")
    if c.position_embedding not in ("learned", "rope", "none"):
        raise ValueError(f"position_embedding must be learned|rope|none, got "
                         f"{c.position_embedding!r}")
    if c.position_embedding == "rope" and c.head_dim % 2:
        raise ValueError(f"rope needs an even head_dim, got {c.head_dim}")


class GPTModel(TransformerBase):
    """Serial GPT whose parameters live on ``device`` (default: the card).

    ``seed`` seeds the ``torch.Generator`` of the random init (std 0.02,
    output layers scaled by 1/sqrt(2L)); the numbers differ from JAX's, so
    parity runs load the JAX tree with :meth:`params_from_numpy`."""

    causal = True

    def __init__(self, config: GPTConfig, device: DeviceLike = None,
                 seed: int = 0):
        dev = resolve_device(device)
        _check_slice(config, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        super().__init__(config, dev, gen)
        c = config
        self.position = None
        if c.position_embedding == "learned":
            self.position = nn.Parameter(torch.empty(
                c.max_seq_len, c.hidden_size, dtype=c.params_dtype,
                device=dev))
            tp.scaled_normal(c.init_method_std)(self.position, gen)
        self.ln_f = LayerNormParams(c.hidden_size, c.params_dtype, dev)

    # -- parameters ---------------------------------------------------------

    @torch.no_grad()
    def params_from_numpy(self, tree: Dict[str, Any]) -> "GPTModel":
        """Load the JAX ``GPTModel.init`` tree given as numpy arrays: layer
        leaves stacked ``(num_layers, ...)``, ``kernel`` in JAX's
        ``(in, out)`` layout (the port keeps it). Shapes must match."""

        def put(param: torch.Tensor, arr, name: str) -> None:
            arr = np.asarray(arr)
            if arr.dtype.name == "bfloat16":  # ml_dtypes: torch reads fp32
                arr = arr.astype(np.float32)
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{name}: tree shape {arr.shape} != model "
                                 f"shape {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(arr)).to(param.dtype))

        put(self.embedding.embedding, tree["embedding"]["embedding"],
            "embedding.embedding")
        if self.position is not None:
            put(self.position, tree["position"], "position")
        for leaf in ("scale", "bias"):
            put(getattr(self.ln_f, leaf), tree["ln_f"][leaf], f"ln_f.{leaf}")
        layers = tree["layers"]
        n = len(self.layers)
        for name, sub in layers.items():
            for leaf, stacked in sub.items():
                stacked = np.asarray(stacked)
                if stacked.shape[0] != n:
                    raise ValueError(f"layers.{name}.{leaf}: {stacked.shape[0]}"
                                     f" layers in the tree, {n} in the model")
                for i, layer in enumerate(self.layers):
                    put(getattr(getattr(layer, name), leaf), stacked[i],
                        f"layers.{i}.{name}.{leaf}")
        return self

    # -- stages -------------------------------------------------------------

    def embed_at(self, tokens: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
        """Token rows plus learned position rows at explicit ``(b, s)``
        positions, added in fp32 BEFORE the cast to the compute dtype
        (``gpt.py:401-404``)."""
        h = self.embedding(tokens)
        if self.position is not None:
            h = h + self.position[positions]
        return h.to(self.cfg.compute_dtype)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        return self.embed_at(tokens, pos[None])

    def _layer(self, layer: TransformerLayer, h: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Pre-LN block: residual + dropout(sublayer(LN(h))), the dropout
        masks drawn from ``generator`` attention first (``_layer_aux``,
        ``gpt.py:286-301``)."""
        q, k, v = self._qkv_heads(layer, self._ln(layer.ln1, h))
        h = h + self._dropout(self._attn_out(layer, self._attend(q, k, v)),
                              generator)
        return h + self._dropout(self._mlp(layer, self._ln(layer.ln2, h)),
                                 generator)

    def head(self, h: torch.Tensor,
             targets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Final LN + tied LM head (``gpt.py:303-332``): logits in the
        compute dtype without targets; with targets the fp32 per-token loss,
        through the chunked LM-head CE when ``lm_head_chunks`` is set, else
        the plain head and a per-token cross entropy."""
        c = self.cfg
        x = self._ln(self.ln_f, h)
        wte = self.embedding.embedding
        if targets is not None and c.lm_head_chunks:
            return lm_head_cross_entropy(x, wte, targets, c.lm_head_chunks)
        logits = x @ tp.cast_param(wte, x.dtype).t()
        if targets is None:
            return logits
        return F.cross_entropy(logits.float().flatten(0, -2),
                               targets.flatten().long(),
                               reduction="none").view(targets.shape)

    def forward(self, tokens: torch.Tensor,
                targets: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Differentiable forward (the reference's ``apply``): per-token
        fp32 loss ``(b, s)`` with ``targets``, logits without. Hidden
        dropout runs only with a ``dropout_generator``."""
        tokens = tokens.to(self.device)
        if targets is not None:
            targets = targets.to(self.device)
        h = self.run_layers_train(self.embed(tokens), dropout_generator)
        return self.head(h, targets)

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor,
             dropout_generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """Mean per-token loss (``gpt.py:537-542``)."""
        return self.forward(tokens, targets, dropout_generator).mean()

    @torch.no_grad()
    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-context forward: ``(b, s)`` token ids -> ``(b, s, vocab)``
        logits in the compute dtype (the reference's ``apply`` without
        targets). Inference only: it runs under ``no_grad``; training goes
        through :meth:`forward` / :meth:`loss`."""
        tokens = tokens.to(self.device)
        return self.serve_head(self.run_layers(self.embed(tokens)))

    # -- serving drives (apex_tpu_torch/serve/engine.py) --------------------

    def check_servable(self) -> None:
        """Raise for what the serving hooks cannot run: rotary positions
        (``apply_rope_at`` at each slot's position in the hooks comes with
        ROADMAP Queue 1 item 6). The modes that reshape the sequence
        (context and sequence parallelism) are refused at construction."""
        if self.cfg.position_embedding == "rope":
            raise NotImplementedError(
                "serving a model with position_embedding='rope' is not in "
                "this slice of the port: the serving hooks rotate q/k at "
                "each slot's position (apply_rope_at) with ROADMAP Queue 1 "
                "item 6")

    @torch.no_grad()
    def serve_layers_prefill(self, h: torch.Tensor):
        """Run the layers over a (padded) prompt, collecting every layer's
        k/v heads for the cache fill: ``(h, k, v)`` with k/v
        ``(num_layers, b, heads, s, head_dim)``."""
        self.check_servable()
        ks, vs = [], []
        for layer in self.layers:
            x = self._ln(layer.ln1, h)
            q, k, v = self._qkv_heads(layer, x)
            h = h + self._attn_out(layer, self._attend(q, k, v))
            h = h + self._mlp(layer, self._ln(layer.ln2, h))
            ks.append(k)
            vs.append(v)
        return h, torch.stack(ks), torch.stack(vs)

    @torch.no_grad()
    def serve_layers_decode(self, h: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor,
                            block_tables: torch.Tensor,
                            write_flat: torch.Tensor,
                            attend_lengths: torch.Tensor,
                            positions: Optional[torch.Tensor] = None):
        """One decode tick through the layers. Per layer the new token's
        k/v heads are written into the pool at ``write_flat`` (flat page
        position ``block_id * block + offset``; idle slots point at the null
        page) BEFORE its query attends the pages (``gpt.py:466-470``).
        ``h`` is ``(b, 1, hidden)``; the pools ``(L, num_blocks, kv_heads,
        block, head_dim)`` are updated IN PLACE (the reference rebuilds them
        functionally) and returned. ``attend_lengths`` includes the token
        just written (0 = idle slot, output exactly 0). ``positions`` only
        matter for rotary positions, which are a later slice."""
        self.check_servable()
        blk = k_pages.shape[3]
        bi, off = write_flat // blk, write_flat % blk
        for i, layer in enumerate(self.layers):
            kp, vp = k_pages[i], v_pages[i]
            x = self._ln(layer.ln1, h)
            q, k, v = self._qkv_heads(layer, x)
            # kp[bi, :, off] is (b, kv_heads, d): advanced indices split by
            # the head slice land in front, as in numpy and JAX
            kp[bi, :, off] = k[:, :, 0, :].to(kp.dtype)
            vp[bi, :, off] = v[:, :, 0, :].to(vp.dtype)
            attn = flash_decode(q[:, :, 0, :], kp, vp, block_tables,
                                attend_lengths,
                                window=self.cfg.attention_window)
            h = h + self._attn_out(layer, attn[:, :, None, :])
            h = h + self._mlp(layer, self._ln(layer.ln2, h))
        return h, k_pages, v_pages

    @torch.no_grad()
    def serve_layers_multi(self, h: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           write_flat: torch.Tensor,
                           attend_lengths: torch.Tensor,
                           positions: Optional[torch.Tensor] = None):
        """K-token sibling of :meth:`serve_layers_decode`
        (``gpt.py:478-517``): per layer the K new tokens' k/v heads of each
        slot are written into the pool at ``write_flat`` ``(b, K)`` (masked
        columns point at the null page), then the K queries attend the pages
        through :func:`flash_decode_multi` with trailing-query semantics
        (``attend_lengths[b]`` keys for the LAST query, query ``j`` sees
        ``attend_lengths[b] - (K-1-j)``: in-chunk causality by length).
        ``h`` is ``(b, K, hidden)``. The pools are updated IN PLACE (the
        reference rebuilds them functionally) and returned. Drives chunked
        prefill (one slot, K = chunk) and speculative verify (every slot,
        K = drafts + 1). ``positions`` ``(b, K)`` only matter for rotary
        positions, a later slice."""
        self.check_servable()
        blk = k_pages.shape[3]
        bi, off = write_flat // blk, write_flat % blk
        for i, layer in enumerate(self.layers):
            kp, vp = k_pages[i], v_pages[i]
            x = self._ln(layer.ln1, h)
            q, k, v = self._qkv_heads(layer, x)
            # kp[bi, :, off] is (b, K, kv_heads, d): the (b, K) advanced
            # indices land in front, so the heads go (b, K, heads, d)
            kp[bi, :, off] = k.transpose(1, 2).to(kp.dtype)
            vp[bi, :, off] = v.transpose(1, 2).to(vp.dtype)
            attn = flash_decode_multi(q, kp, vp, block_tables,
                                      attend_lengths,
                                      window=self.cfg.attention_window)
            h = h + self._attn_out(layer, attn)
            h = h + self._mlp(layer, self._ln(layer.ln2, h))
        return h, k_pages, v_pages

    @torch.no_grad()
    def serve_head(self, h: torch.Tensor) -> torch.Tensor:
        """Final LN + LM head tied to the embedding: full-vocab logits
        ``(b, s, vocab)`` in the compute dtype."""
        x = self._ln(self.ln_f, h)
        wte = tp.cast_param(self.embedding.embedding, x.dtype)  # (V, H)
        return x @ wte.t()
