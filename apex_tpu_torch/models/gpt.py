"""Megatron-style GPT (port of ``apex_tpu/models/gpt.py``).

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
the paged KV pool of ``apex_tpu_torch.serve``, rotating q/k at each
slot's own positions under rotary positions. The sliding
``attention_window`` runs on both devices (the streamed flash kernels on the
card). ``remat_policy`` takes the reference's None/"full", "save_attn" and
"dots" (``models/_transformer.py``).

Tensor parallelism (``axis="model"``, after ``initialize_model_parallel(
tensor_model_parallel_size=N)``): every rank holds its shard of the tree
(:meth:`GPTModel.specs`; :meth:`GPTModel.params_from_numpy` takes the FULL
JAX tree and loads this rank's shard), the layers run at ``heads / N``
local heads, and the train head is the vocab-sharded LM head with
``vocab_parallel_cross_entropy`` (``gpt.py:302-332``; the chunked LM-head
CE is serial only, as in the reference). ``sequence_parallel=True`` runs
the LN/dropout/residual regions on sequence shards (``models/
_transformer.py``). The serving drives run at local heads and
:meth:`GPTModel.serve_head` all-gathers the vocab-sharded logits, so every
rank sees the same full-vocab logits (``gpt.py:522-535``); serving refuses
sequence parallelism as the reference does. Under ZeRO-3
:meth:`GPTModel.loss` takes ``layer_chunk_meta`` and drives the layers from
this rank's chunks, each gathered just in time (``GPTConfig.
zero3_prefetch`` layers ahead; ``models/_transformer.py``), and
``activation_comm_dtype`` quantizes the sequence-parallel conjugates'
wire. Pipeline parallelism (``pipeline_axis="pipe"``, after
``initialize_model_parallel(pipeline_model_parallel_size=S)``): the model
is one stage, holding its ``num_layers / S`` layers (the serial model's
from the same seed, in the interleaved order of ``virtual_pipeline_size``
chunks), its layer specs named over the pipe axis; it trains through
``transformer.pipeline_parallel`` and :meth:`GPTModel.forward` refuses to
run it alone. Context parallelism (``context_axis="context"``, after
``initialize_model_parallel(context_parallel_size=N)``): each rank takes
its ``s / N`` tokens and targets, attention runs as the ring or Ulysses
(``sequence_parallel_impl``), positions are global (``models/
_transformer.py``), :meth:`GPTModel.loss` is the local mean and the caller
reduces loss and grads over the context axis; serving refuses it.

Mixture of experts (``moe_num_experts=E``, ``gpt.py:128-231``): every
layer's FFN is a top-k routed :class:`~apex_tpu_torch.transformer.moe.
MoEMLP` (layer tree ``{ln1, qkv, proj, ln2, moe}``). The router losses
summed over the layers fold into every token's loss through
:meth:`GPTModel.aux_to_loss` (``gpt.py:334-363``).
``moe_expert_axis="data"`` shards the experts over the data axis (after
``initialize_model_parallel``): each rank feeds its own rows, the dispatch
and combine are all-to-alls (at the 1-byte ``moe_dispatch_dtype`` wire
when set), :meth:`GPTModel.loss` is the local mean and the caller reduces
the grads by their specs (``parallel.distributed.
allreduce_gradients_by_spec``: expert grads only divided by the axis
size). Serving routes the same way on every rank and adds the local
experts' shares with one ``psum`` (``_serve_ffn``). MoE does not compose
with sequence parallelism (``ValueError``, as in the reference).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
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
    axis: Optional[str] = None  # tensor-parallel mesh axis (None: serial)
    # pipeline mesh axis (None: every layer here): a model on "pipe" holds
    # its stage's num_layers / pp layers, in the interleaved order of
    # virtual_pipeline_size chunks a stage
    pipeline_axis: Optional[str] = None
    virtual_pipeline_size: int = 1
    # Megatron-style sequence parallelism on the model axis (ignored
    # serial); needs max_seq_len divisible by the tp size
    sequence_parallel: bool = False
    # the quantized wire ("int8" | "e5m2") of the sequence-parallel
    # conjugates (needs sequence_parallel; ignored serial)
    activation_comm_dtype: Optional[str] = None
    params_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    init_method_std: float = 0.02
    attention_window: Optional[int] = None
    position_embedding: str = "learned"  # learned | rope | none
    rope_theta: float = 10000.0
    # ring/Ulysses context parallelism over this mesh axis (the topology
    # installed first: initialize_model_parallel(context_parallel_size=N))
    context_axis: Optional[str] = None
    sequence_parallel_impl: str = "ring"  # 'ring' | 'ulysses'
    # routed-expert FFNs (gpt.py:128-146): E experts a layer, top-k routing
    # at capacity factor cf; the experts shard over moe_expert_axis (the
    # data axis: tokens and experts shard together); the router losses'
    # weights; the 1-byte dispatch wire (ignored on a serial build)
    moe_num_experts: Optional[int] = None
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_expert_axis: Optional[str] = None
    moe_aux_loss_weight: float = 0.01
    moe_z_loss_weight: float = 1e-3
    moe_dispatch_dtype: Optional[str] = None
    hidden_dropout: float = 0.1  # applied only with a dropout generator
    remat: bool = True  # activation checkpointing per layer (training)
    remat_policy: Optional[str] = None  # None/"full" | "save_attn" | "dots"
    # vocab chunks of the fused LM-head CE (None: plain head + per-token CE)
    lm_head_chunks: Optional[int] = None
    # ZeRO-3 gather prefetch depth: layer i + N's gather is issued before
    # layer i computes, forward and backward (0: gather just in time)
    zero3_prefetch: int = 0

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _check_slice(c: GPTConfig, device: torch.device) -> None:
    remat_policy(c.remat_policy)
    if c.sequence_parallel and c.moe_num_experts is not None:
        raise ValueError(
            "sequence_parallel does not compose with MoE FFNs yet: the "
            "router must see gathered tokens (the dense fc1/fc2 gather/"
            "reduce-scatter pair has no MoE counterpart here)")
    if c.position_embedding not in ("learned", "rope", "none"):
        raise ValueError(f"position_embedding must be learned|rope|none, got "
                         f"{c.position_embedding!r}")
    if c.position_embedding == "rope" and c.head_dim % 2:
        raise ValueError(f"rope needs an even head_dim, got {c.head_dim}")


class GPTModel(TransformerBase):
    """GPT whose parameters live on ``device`` (default: the card), serial
    or tensor parallel over ``config.axis``.

    ``seed`` seeds the ``torch.Generator`` of the random init (std 0.02,
    output layers scaled by 1/sqrt(2L)); a tensor-parallel model from a
    seed holds the shards of the serial model from that seed. The numbers
    differ from JAX's, so parity runs load the JAX tree with
    :meth:`params_from_numpy`."""

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

    def specs(self) -> Dict[str, Any]:
        """Each leaf's split over the model axis in the JAX tree's layout
        (``gpt.py:230-238``): a tuple a leaf, one entry a dim."""
        ln = {"scale": (), "bias": ()}
        tree = {"embedding": self.embedding.specs(),
                "layers": self.layer_stack_specs(), "ln_f": ln}
        if self.position is not None:
            tree["position"] = ()
        return tree

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
        """Token rows plus the position rows of ``0 .. s-1``, in fp32, then
        the cast (``gpt.py:240-253``). Under SP the embedding's
        reduce-scatter leaves this rank's sequence shard, and the positions
        added are its own."""
        h = self.embedding(tokens)
        if self.position is not None:
            h = h + self._positions(self.position, h.shape[1])
        return h.to(self.cfg.compute_dtype)

    def _layer(self, layer: TransformerLayer, h: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               bias: Optional[torch.Tensor] = None):
        """Pre-LN block: residual + dropout(sublayer(LN(h))), the dropout
        masks drawn from ``generator`` attention first; ``(h, aux)``, aux
        the FFN's router losses (``gpt.py:286-301``)."""
        q, k, v = self._pre_attention(layer, h)
        return self._post_attention(layer, h, self._attend(q, k, v, bias),
                                    generator)

    def _pre_attention(self, layer: TransformerLayer, h: torch.Tensor):
        """LN and the QKV heads: the layer up to its attention call."""
        return self._qkv_heads(layer, self._ln(layer.ln1, h))

    def _post_attention(self, layer: TransformerLayer, h: torch.Tensor,
                        attn: torch.Tensor,
                        generator: Optional[torch.Generator]):
        """The layer after its attention call: the output projection and
        the FFN half, each a residual with dropout; ``(h, aux)``, aux None
        for the dense MLP and the router's for an MoE layer."""
        h = h + self._dropout(self._attn_out(layer, attn), generator)
        out, aux = self._ffn(layer, self._ln(layer.ln2, h))
        return h + self._dropout(out, generator), aux

    def _ffn(self, layer, x: torch.Tensor):
        """``(out, aux)`` of the FFN half: the dense MLP (aux None), or the
        routed experts, expert-parallel over ``moe_expert_axis`` when set."""
        if self.cfg.moe_num_experts is None:
            return self._mlp(layer, x), None
        if self.cfg.moe_expert_axis is not None:
            return layer.moe.apply_expert_parallel(x)
        return layer.moe.apply(x)

    def _serve_ffn(self, layer, x: torch.Tensor) -> torch.Tensor:
        """The FFN half of a serving layer (``gpt.py:406-419``): the dense
        MLP, or the routed experts at inference (aux dropped); an
        expert-parallel build routes every token on every rank and adds
        the local experts' shares (``MoEMLP.apply_expert_sharded``), the
        serial function."""
        c = self.cfg
        if c.moe_num_experts is None:
            return self._mlp(layer, x)
        if c.moe_expert_axis is not None:
            return layer.moe.apply_expert_sharded(x)
        return layer.moe.apply(x)[0]

    def aux_to_loss(self, aux) -> torch.Tensor:
        """The linear fold of the layers' summed router losses into one
        scalar (``gpt.py:334-340``), shared by :meth:`forward` and the
        pipelined loss."""
        c = self.cfg
        return (c.moe_aux_loss_weight * aux["load_balancing_loss"]
                + c.moe_z_loss_weight * aux["router_z_loss"]) / c.num_layers

    def head(self, h: torch.Tensor,
             targets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Final LN + tied LM head (``gpt.py:303-332``): logits in the
        compute dtype without targets (vocab-sharded under tensor
        parallelism); with targets the fp32 per-token loss, through the
        chunked LM-head CE when ``lm_head_chunks`` is set (serial only),
        else the plain head and ``vocab_parallel_cross_entropy`` (over the
        axis under tensor parallelism, whose head input is the ``copy_to``
        of the LN output; under SP the sequence all-gather, whose backward
        reduce-scatter sums the per-vocab-shard partial cotangents)."""
        c = self.cfg
        x = self._ln(self.ln_f, h)
        wte = self.embedding.embedding
        if targets is not None and c.lm_head_chunks and c.axis is None:
            return lm_head_cross_entropy(x, wte, targets, c.lm_head_chunks)
        if c.axis is not None:
            if self._sp:
                x = tp.gather_from_sequence_parallel_region(
                    x, c.axis, True, self._acd)
            else:
                x = tp.copy_to_tensor_model_parallel_region(x, c.axis)
        logits = x @ tp.cast_param(wte, x.dtype).t()
        if targets is None:
            return logits
        return tp.vocab_parallel_cross_entropy(logits, targets, c.axis)

    def forward(self, tokens: torch.Tensor,
                targets: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None,
                layer_chunk_meta=None) -> torch.Tensor:
        """Differentiable forward (the reference's ``apply``): per-token
        fp32 loss ``(b, s)`` with ``targets``, logits without. Hidden
        dropout runs only with a ``dropout_generator``.
        ``layer_chunk_meta`` (``Zero3Setup.layer_chunk_meta()``) drives the
        ZeRO-3 path: the layers run from their chunks, each gathered just
        in time; the other params must be in place (gathered: the step
        builder's job, ``transformer.amp.build_zero_train_step``)."""
        tokens = tokens.to(self.device)
        if targets is not None:
            targets = targets.to(self.device)
        if self._pipe is not None:
            raise ValueError(
                "a pipeline stage model (pipeline_axis set) runs through "
                "apex_tpu_torch.transformer.pipeline_parallel "
                "(prepare_pipelined_model / pipelined_loss_fn)")
        h, aux = self.run_layers_train(self.embed(tokens), dropout_generator,
                                       chunk_meta=layer_chunk_meta,
                                       return_aux=True)
        out = self.head(h, targets)
        if aux is not None and targets is not None:
            # the per-layer-averaged router losses added to every token's
            # loss: a scalar added uniformly keeps the mean-loss contract
            out = out + self.aux_to_loss(aux).to(out.dtype)
        return out

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor,
             dropout_generator: Optional[torch.Generator] = None,
             layer_chunk_meta=None) -> torch.Tensor:
        """Mean per-token loss (``gpt.py:537-542``)."""
        return self.forward(tokens, targets, dropout_generator,
                            layer_chunk_meta).mean()

    @torch.no_grad()
    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full-context forward: ``(b, s)`` token ids -> ``(b, s, vocab)``
        logits in the compute dtype (the reference's ``apply`` without
        targets). Inference only: it runs under ``no_grad``; training goes
        through :meth:`forward` / :meth:`loss`. Under SP the sequence
        shards are gathered before the head."""
        tokens = tokens.to(self.device)
        h, _ = self.run_layers(self.embed(tokens), return_aux=True)
        if self._sp:
            h = tp.gather_from_sequence_parallel_region(h, self.cfg.axis)
        return self.serve_head(h)

    def check_servable(self) -> None:
        """Serving takes tensor parallelism (local kv heads, gathered
        logits) and refuses context parallelism (the paged cache is per
        slot, not ring-sharded) and sequence parallelism (a decode step's
        one token cannot shard ``s / tp`` ways), ``gpt.py:380-398``."""
        if self._ctx is not None:
            raise ValueError(
                "serving does not support context parallelism: the paged "
                "cache is per-slot, not ring-sharded -- run decode with "
                "context_axis=None")
        if self._sp:
            raise ValueError(
                "serving does not support sequence_parallel=True: decode "
                "works on single-token sequences that cannot shard s/tp "
                "ways; build the serve model with sequence_parallel=False")

    # -- serving drives (apex_tpu_torch/serve/engine.py) --------------------

    @torch.no_grad()
    def serve_layers_prefill(self, h: torch.Tensor):
        """Run the layers over a (padded) prompt, collecting every layer's
        k/v heads for the cache fill: ``(h, k, v)`` with k/v
        ``(num_layers, b, heads, s, head_dim)``. Rotary positions are the
        training forward's, 0 .. s-1."""
        ks, vs = [], []
        for layer in self.layers:
            x = self._ln(layer.ln1, h)
            q, k, v = self._qkv_heads(layer, x)
            h = h + self._attn_out(layer, self._attend(q, k, v))
            h = h + self._serve_ffn(layer, self._ln(layer.ln2, h))
            ks.append(k)
            vs.append(v)
        return h, torch.stack(ks), torch.stack(vs)

    def _rope_positions(self, positions: Optional[torch.Tensor]):
        """``positions`` where rotary positions need them (None else); a
        rotary model's serving step without them raises."""
        if self.cfg.position_embedding != "rope":
            return None
        if positions is None:
            raise ValueError("a rotary-position model's serving step needs "
                             "each token's positions")
        return positions.to(self.device)

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
        just written (0 = idle slot, output exactly 0). ``positions``
        ``(b,)``: each slot's new token's position, where rotary positions
        rotate its q and k (``gpt.py:453-456``)."""
        rope = self._rope_positions(positions)
        blk = k_pages.shape[3]
        bi, off = write_flat // blk, write_flat % blk
        for i, layer in enumerate(self.layers):
            kp, vp = k_pages[i], v_pages[i]
            x = self._ln(layer.ln1, h)
            q, k, v = self._qkv_heads(
                layer, x, None if rope is None else rope[:, None])
            # kp[bi, :, off] is (b, kv_heads, d): advanced indices split by
            # the head slice land in front, as in numpy and JAX
            kp[bi, :, off] = k[:, :, 0, :].to(kp.dtype)
            vp[bi, :, off] = v[:, :, 0, :].to(vp.dtype)
            attn = flash_decode(q[:, :, 0, :], kp, vp, block_tables,
                                attend_lengths,
                                window=self.cfg.attention_window)
            h = h + self._attn_out(layer, attn[:, :, None, :])
            h = h + self._serve_ffn(layer, self._ln(layer.ln2, h))
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
        K = drafts + 1). ``positions`` ``(b, K)``: the tokens' positions,
        where rotary positions rotate their q and k (``gpt.py:496-498``)."""
        rope = self._rope_positions(positions)
        blk = k_pages.shape[3]
        bi, off = write_flat // blk, write_flat % blk
        for i, layer in enumerate(self.layers):
            kp, vp = k_pages[i], v_pages[i]
            x = self._ln(layer.ln1, h)
            q, k, v = self._qkv_heads(layer, x, rope)
            # kp[bi, :, off] is (b, K, kv_heads, d): the (b, K) advanced
            # indices land in front, so the heads go (b, K, heads, d)
            kp[bi, :, off] = k.transpose(1, 2).to(kp.dtype)
            vp[bi, :, off] = v.transpose(1, 2).to(vp.dtype)
            attn = flash_decode_multi(q, kp, vp, block_tables,
                                      attend_lengths,
                                      window=self.cfg.attention_window)
            h = h + self._attn_out(layer, attn)
            h = h + self._serve_ffn(layer, self._ln(layer.ln2, h))
        return h, k_pages, v_pages

    @torch.no_grad()
    def serve_head(self, h: torch.Tensor) -> torch.Tensor:
        """Final LN + LM head tied to the embedding: full-vocab logits
        ``(b, s, vocab)`` in the compute dtype. Under tensor parallelism
        the vocab-sharded logits are all-gathered over the axis
        (``gpt.py:522-535``), bit-identical on every rank, so greedy picks
        and a seeded sampler agree across the ranks."""
        c = self.cfg
        x = self._ln(self.ln_f, h, sequence_region=False)
        wte = tp.cast_param(self.embedding.embedding, x.dtype)  # (V/tp, H)
        logits = x @ wte.t()
        if c.axis is not None:
            logits = tp.gather_from_tensor_model_parallel_region(logits,
                                                                 c.axis)
        return logits
