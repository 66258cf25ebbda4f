"""Megatron-style BERT (port of ``apex_tpu/models/bert.py``).

Word + learned-position + tokentype embeddings, then the embedding LN; per
layer the **post-LN** block ``LN(h + attn(h, bias))``, ``LN(h +
fc2(gelu(fc1(h))))`` with the additive padding bias of
:func:`extended_attention_mask` (-10000 on padded keys), which the resident
flash kernels take on the card; then the head: the pooler and the binary
(NSP) head on the fp32 pooled [CLS], and the MLM decode (dense, tanh-GELU,
LN, the tied embedding plus ``lm_bias``). :meth:`BertModel.loss` is the
masked mean of the per-token vocab cross entropy plus the NSP cross
entropy (``bert.py:337-378``). The parameter tree and its names are the JAX
model's; :meth:`BertModel.params_from_numpy` loads a JAX tree.

Tensor parallelism (``axis="model"``) shards the embedding, the layers
and ``lm_bias`` over the model axis (:meth:`BertModel.specs`), and the MLM
decode is the vocab-sharded head with ``vocab_parallel_cross_entropy``
behind a ``copy_to`` (``bert.py:247-255``). ``sequence_parallel=True``
runs the embedding LN, the layers' LNs, dropout and residuals on sequence
shards: the tokentype ids are this shard's (``bert.py:189``) and the head
first all-gathers the sequence with ``tensor_parallel_output_grad=False``
(``bert.py:222``: everything downstream is replicated). Context
parallelism (``context_axis``, after ``initialize_model_parallel(
context_parallel_size=N)``; ``bert.py:227-241``, ``:270-279``,
``:307-327``): each rank takes its ``s / N`` tokens (and tokentype ids),
the padding mask becomes ``SegmentMask(seg, seg, pad_id=0)``, whose kv ids
ride the ring, the global [CLS] is rank 0's row, replicated by a sum over
the axis of the rank-0-masked slice (:class:`_PsumBoth`: psum forward and
backward, ``lax.psum``'s transpose under ``check_vma=False``, so rank 0's
[CLS] grad arrives n times and the caller's mean over the axis cancels
it), and :meth:`BertModel.loss` normalises the local masked sum by the
global weight, times n, for that mean to recover. The ZeRO-3 drives
(``unroll_layers``, ``zero3_prefetch``) are later slices and raise
``NotImplementedError``, naming their ROADMAP items. Hidden dropout runs
only with a dropout generator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import DeviceLike, resolve_device
from apex_tpu_torch.models._transformer import (
    LayerNormParams,
    SegmentMask,
    TransformerBase,
    TransformerLayer,
)
from apex_tpu_torch.parallel import collectives
from apex_tpu_torch.transformer import tensor_parallel as tp


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BERT hyperparameters; the defaults are BERT-large (``bert.py:43-98``:
    vocab 30592, hidden 1024, 24 layers, 16 heads, seq 512, 2 token
    types)."""

    vocab_size: int = 30592  # 30522 padded to a TP-friendly multiple
    hidden_size: int = 1024
    num_layers: int = 24
    num_attention_heads: int = 16
    max_seq_len: int = 512
    type_vocab_size: int = 2
    ffn_hidden_size: Optional[int] = None
    axis: Optional[str] = None  # tensor-parallel mesh axis (None: serial)
    sequence_parallel: bool = False  # on the model axis; ignored serial
    params_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    hidden_dropout: float = 0.1  # applied only with a dropout generator
    init_method_std: float = 0.02
    remat: bool = True
    add_binary_head: bool = True
    attention_window: Optional[int] = None
    unroll_layers: bool = False
    zero3_prefetch: int = 0
    context_axis: Optional[str] = None
    sequence_parallel_impl: str = "ring"  # 'ring' | 'ulysses'

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _check_slice(c: BertConfig) -> None:
    later = {
        "unroll_layers": (c.unroll_layers,
                          "BERT under ZeRO (Queue 1 item 24; the port's "
                          "layer loop is a Python loop already)"),
        "zero3_prefetch": (bool(c.zero3_prefetch),
                           "BERT's ZeRO-3 drive (Queue 1 item 24)"),
    }
    for name, (on, where) in later.items():
        if on:
            raise NotImplementedError(
                f"BertConfig {name} is not in this slice of the port; it "
                f"comes with {where}")


class _PsumBoth(torch.autograd.Function):
    """The sum over ``axis`` whose backward is the sum of the cotangents:
    ``lax.psum`` and its transpose under ``check_vma=False``, not
    Megatron's reduce (identity backward)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return collectives.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return collectives.psum(g, ctx.axis), None


def extended_attention_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(b, s) 1/0 padding mask -> additive fp32 (b, 1, 1, s) bias, -10000
    on padded keys (``bert.py:101-105``)."""
    bias = (1.0 - attention_mask.float()) * -10000.0
    return bias[:, None, None, :]


class BertModel(TransformerBase):
    """BERT whose parameters live on ``device`` (default: the card), serial
    or tensor parallel over ``config.axis``.

    ``seed`` seeds the ``torch.Generator`` of the random init (std 0.02,
    output layers scaled by 1/sqrt(2L)); parity runs load the JAX tree with
    :meth:`params_from_numpy`."""

    causal = False

    def __init__(self, config: BertConfig, device: DeviceLike = None,
                 seed: int = 0):
        dev = resolve_device(device)
        _check_slice(config)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        super().__init__(config, dev, gen)
        c = config
        init = tp.scaled_normal(c.init_method_std)
        kw = dict(params_dtype=c.params_dtype, device=dev, generator=gen,
                  init_method=init)
        self.position = nn.Parameter(torch.empty(
            c.max_seq_len, c.hidden_size, dtype=c.params_dtype, device=dev))
        init(self.position, gen)
        self.tokentype = nn.Parameter(torch.empty(
            c.type_vocab_size, c.hidden_size, dtype=c.params_dtype,
            device=dev))
        init(self.tokentype, gen)
        self.ln_emb = LayerNormParams(c.hidden_size, c.params_dtype, dev)
        # BertLMHead (standalone_bert.py:46-74): dense + gelu + LN, then the
        # tied decode plus a vocab bias
        self.lm_dense = tp.ColumnParallelLinear(c.hidden_size, c.hidden_size,
                                                **kw)
        self.lm_ln = LayerNormParams(c.hidden_size, c.params_dtype, dev)
        # vocab-sharded over the model axis, as the decode's logits
        self.lm_bias = nn.Parameter(torch.zeros(
            self.embedding.embedding.shape[0], dtype=c.params_dtype,
            device=dev))
        if c.add_binary_head:
            self.pooler = tp.ColumnParallelLinear(c.hidden_size,
                                                  c.hidden_size, **kw)
            self.binary_head = tp.ColumnParallelLinear(c.hidden_size, 2, **kw)

    def specs(self) -> Dict[str, Any]:
        """Each leaf's split over the model axis in the JAX tree's layout
        (``bert.py:139-162``)."""
        c = self.cfg
        ln = {"scale": (), "bias": ()}
        dense = {"kernel": (), "bias": ()}
        tree = {"embedding": self.embedding.specs(), "position": (),
                "tokentype": (), "ln_emb": ln,
                "layers": self.layer_stack_specs(), "lm_dense": dense,
                "lm_ln": dict(ln), "lm_bias": (c.axis,)}
        if c.add_binary_head:
            tree["pooler"] = dict(dense)
            tree["binary_head"] = dict(dense)
        return tree

    # -- stages -------------------------------------------------------------

    def embed(self, tokens: torch.Tensor,
              tokentype_ids: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Word + position (+ tokentype) rows, the embedding LN in the
        compute dtype, dropout (``bert.py:166-190``). Under SP the
        embedding's reduce-scatter leaves this rank's sequence shard; its
        positions and tokentype ids are the shard's, and the replicated
        tables ride ``_sp_param``."""
        c = self.cfg
        h = self.embedding(tokens)
        s_local = h.shape[1]
        h = h + self._positions(self.position, s_local)
        if tokentype_ids is not None:
            # the context slice arrives with the tokens: only SP's is taken
            start = self._sp_shard_start(s_local)
            ids = tokentype_ids[:, start:start + s_local]
            h = h + self._sp_param(self.tokentype)[ids]
        h = self._ln(self.ln_emb, h.to(c.compute_dtype))
        if generator is not None and self._sp:
            # a sequence-sharded region: this rank's stream of a seed drawn
            # alike on every rank
            seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                                     device=generator.device))
            generator = self._dropout_generator(seed, h.device)
        return self._dropout(h, generator).to(c.compute_dtype)

    def _layer(self, layer: TransformerLayer, h: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               bias: Optional[torch.Tensor] = None):
        """Post-LN block: LN(residual + dropout(sublayer(h)))
        (``bert.py:192-197``); ``(h, None)``: BERT's layers emit no aux."""
        h = self._ln(layer.ln1, h + self._dropout(
            self._attention(layer, h, bias), generator))
        return self._ln(layer.ln2, h + self._dropout(self._mlp(layer, h),
                                                     generator)), None

    def head(self, h: torch.Tensor,
             masked_lm_labels: Optional[torch.Tensor] = None):
        """``(lm, binary_logits)``: the MLM decode's logits in the compute
        dtype, or with labels the fp32 per-token vocab cross entropy; the
        binary logits (fp32) from the pooled [CLS], or None without the
        binary head (``bert.py:199-253``)."""
        c = self.cfg
        if self._sp:
            # close the sequence-sharded region; downstream is replicated,
            # so the gather's adjoint is a slice (bert.py:212-222)
            h = tp.gather_from_sequence_parallel_region(
                h, c.axis, tensor_parallel_output_grad=False)
        binary_logits = None
        if c.add_binary_head:
            cls = h[:, 0]
            if self._ctx is not None:
                # the global [CLS] is rank 0's row (bert.py:227-241)
                rank, _ = tp.mappings.axis_world(self._ctx)
                cls = _PsumBoth.apply(cls if rank == 0 else cls * 0,
                                      self._ctx)
            pooled = torch.tanh(self._dense(self.pooler, cls))
            binary_logits = self._dense(self.binary_head, pooled.float())
        g = F.gelu(self._dense(self.lm_dense, h), approximate="tanh")
        g = self._ln(self.lm_ln, g, sequence_region=False)
        if c.axis is not None:
            g = tp.copy_to_tensor_model_parallel_region(g, c.axis)
        wte = tp.cast_param(self.embedding.embedding, g.dtype)  # (V/tp, H)
        logits = g @ wte.t() + tp.cast_param(self.lm_bias, g.dtype)
        if masked_lm_labels is None:
            return logits, binary_logits
        return (tp.vocab_parallel_cross_entropy(logits, masked_lm_labels,
                                                c.axis),
                binary_logits)

    def apply(self, tokens: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None,
              tokentype_ids: Optional[torch.Tensor] = None,
              masked_lm_labels: Optional[torch.Tensor] = None,
              dropout_generator: Optional[torch.Generator] = None):
        """Differentiable forward (``bert.py:255-293``): the padding mask
        becomes the additive bias of every layer's attention, or under
        ``context_axis`` a :class:`SegmentMask` (valid 1, pad 0, ``pad_id``
        0: padded keys are never attended either way, and the padded query
        rows, 0 here, are the rows the loss mask drops); returns
        :meth:`head`'s pair. Each layer is checkpointed under ``remat``
        where a gradient is tracked."""
        dev = self.device
        tokens = tokens.to(dev)
        bias = None
        if attention_mask is not None and self._ctx is not None:
            seg = attention_mask.to(dev).to(torch.int32)
            bias = SegmentMask(seg, seg, pad_id=0)
        elif attention_mask is not None:
            bias = extended_attention_mask(attention_mask.to(dev))
        if tokentype_ids is not None:
            tokentype_ids = tokentype_ids.to(dev)
        if masked_lm_labels is not None:
            masked_lm_labels = masked_lm_labels.to(dev)
        h = self.embed(tokens, tokentype_ids, dropout_generator)
        h = self.run_layers_train(h, dropout_generator, bias)
        return self.head(h, masked_lm_labels)

    forward = apply

    def loss(self, tokens: torch.Tensor, attention_mask: torch.Tensor,
             loss_mask: torch.Tensor, masked_lm_labels: torch.Tensor,
             nsp_labels: Optional[torch.Tensor] = None,
             tokentype_ids: Optional[torch.Tensor] = None,
             dropout_generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """The MLM loss averaged over the masked positions, plus the NSP
        cross entropy (``bert.py:295-378``). Under ``context_axis`` the
        local term whose mean over the axis is the global loss: the local
        masked sum over the GLOBAL weight (no gradient through it), times
        the axis size (``bert.py:307-327``)."""
        lm_loss, binary_logits = self.apply(
            tokens, attention_mask, tokentype_ids, masked_lm_labels,
            dropout_generator)
        w = loss_mask.to(self.device).float()
        if self._ctx is not None:
            _, n = tp.mappings.axis_world(self._ctx)
            total = collectives.psum(w.sum().detach(), self._ctx)
            loss = (lm_loss * w).sum() * n / total.clamp_min(1.0)
        else:
            loss = (lm_loss * w).sum() / w.sum().clamp_min(1.0)
        if nsp_labels is not None and binary_logits is not None:
            logp = F.log_softmax(binary_logits.float(), dim=-1)
            nsp = nsp_labels.to(self.device).long()[:, None]
            loss = loss - logp.gather(1, nsp).mean()
        return loss
