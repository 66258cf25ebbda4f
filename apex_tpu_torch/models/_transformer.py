"""Shared transformer backbone (port of ``apex_tpu/models/_transformer.py``).

The JAX package stacks every layer's parameters on a leading
``num_layers`` dim and scans them; here each layer is a module of an
``nn.ModuleList`` holding the same tree ``{ln1, qkv, proj, ln2, fc1, fc2}``
under the same names, and the helpers take that layer module where the
reference takes its parameter slice. A model with routed-expert FFNs
(``cfg.moe_num_experts``) holds :class:`MoETransformerLayer` modules, ``{ln1,
qkv, proj, ln2, moe}``, whose layers emit aux losses (the router's): the
drives sum them over the layers in fp32 and hand them back with
``return_aux=True``, and refuse to drop them without it
(``_transformer.py:588-595``); under checkpointing the layer body returns
``(h, *aux)``.

Context parallelism (``cfg.context_axis``, the mesh's ``"context"``; the
topology installed first, ``initialize_model_parallel(
context_parallel_size=N)``): tokens arrive sliced, rank r holding global
positions ``[r s, (r + 1) s)`` of its ``s`` tokens, and attention runs as
the ring or Ulysses (``cfg.sequence_parallel_impl``,
``apex_tpu_torch.transformer.ring``) with the causal mask and the window
in global positions (``_transformer.py:490-530``). The learned position
table is sliced at the shard's start (:meth:`TransformerBase.
_seq_shard_start`: the context offset plus, under SP, the tp offset) and
RoPE rotates at the global positions (:meth:`TransformerBase.
_token_positions`). Masks travel as a :class:`SegmentMask` (a dense bias
under a context axis raises). Grads are each rank's partial sums: the
caller reduces them over the context axis
(``mesh.get_gradient_reduction_axes()``), as the reference's harness
does.

Tensor parallelism (``cfg.axis``, the mesh's ``"model"``): the embedding is
vocab-parallel, QKV and fc1 column-parallel with no gather, proj and fc2
row-parallel, each layer built at its local shapes; the fused QKV output is
laid out ``(heads, 3, head_dim)``, so a column shard holds whole heads and
the flash kernels see ``heads / tp`` of them. Sequence parallelism
(``cfg.sequence_parallel`` with an ``axis``; ignored serial, as in the
reference) swaps each row-parallel all-reduce for a reduce-scatter onto the
sequence and each column-parallel ``copy_to`` for an all-gather of it
(``_transformer.py:225-310``): LN, dropout and the residuals run on ``(b,
s / tp, h)`` shards, the replicated parameters consumed there (the LNs'
gamma and beta, the position table) ride :meth:`TransformerBase._sp_param`
so their grads are whole on every rank, and hidden dropout draws from the
sequence-parallel generator (seed + 1414 + the tp rank).

Rotary positions (``apply_rope`` / ``apply_rope_at``, one shared body
``_rope_rotate``) are ported with the reference's float64 pre-reduction of
the angles, so a rotation at position 1e6 matches it in fp32.

Training: :meth:`TransformerBase.run_layers_train` checkpoints each layer
with ``torch.utils.checkpoint`` when ``cfg.remat`` is set (the reference's
``jax.checkpoint`` of the layer body, ``_transformer.py:634-638``), under
the reference's policies (``_remat_policy``, ``:123-142``): None/"full"
recomputes the whole layer; "save_attn" keeps the flash attention's
outputs, so the backward does not run the attention forward again (the
layer is checkpointed in two parts around the attention call, whose
autograd Function keeps q, k, v, o and lse: the reference keeps only o and
lse and recomputes q, k, v); "dots" keeps the outputs of the matrix
products with no batch dims (the linear layers: ``aten.mm`` /
``aten.addmm``, a selective-checkpoint policy) and recomputes the rest,
the attention forward included. The attention bias is an input of the
checkpointed layer, and inverted hidden dropout draws from an explicit
``torch.Generator``. Both drives thread an additive attention bias (BERT's
padding mask) through ``_layer``, ``_attention`` and ``_attend`` to
``flash_attention``, as the reference's ``run_layers`` does.

ZeRO-3 (``run_layers_train(chunk_meta=...)``, ``_transformer.py:558-626``
and ``_prefetched_zero3_drive``, ``:145-200``): the layers' parameters are
this rank's chunks, and :class:`_Zero3Drive`, one autograd Function over
the whole stack, all-gathers each layer's weights just in time, runs the
layer with them swapped into its module (:func:`swap_params`) and frees
them. Its backward gathers each layer again, recomputes the layer under
autograd (always: the reference's level-3 body is rematerialized whatever
``cfg.remat``) and reduce-scatters the layer's weight grads into chunk
grads on the spot, so gathered weights are never saved. With
``cfg.zero3_prefetch`` = N > 0 the gather of layer i + N is issued
(``async_op=True``) before layer i computes, forward and backward. The
flash kernels launch through ctypes inside the layer body like any other
op; the attention's Function is simply part of the recomputed layer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.parallel.pipeline_layout import (
    interleave_stack,
    stage_layer_ids,
)
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.utils.nn import inverted_dropout


#: the remat policies (``_remat_policy``, ``_transformer.py:123-142``)
REMAT_POLICIES = tp.checkpoint_policies

#: the context-parallel attention schemes (``sequence_parallel_impl``)
SEQUENCE_PARALLEL_IMPLS = ("ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class SegmentMask:
    """Attention masking by segment ids instead of an additive bias
    (``_transformer.py:40-60``): it rides the ``bias`` channel of
    ``run_layers`` -> ``_layer`` -> ``_attention`` -> ``_attend`` to the
    flash kernels' segment path, which, unlike a dense bias, works under
    context parallelism: the kv-id shards rotate with their K/V shard.
    BERT's padding mask takes this form under ``context_axis``.

    ``q_seg`` / ``kv_seg``: ``(b, s)`` int tensors (local shards under
    context parallelism); keys of id ``pad_id`` are never attended, and a
    query that sees no key outputs exactly 0."""

    q_seg: torch.Tensor
    kv_seg: torch.Tensor
    pad_id: Optional[int] = None


def remat_policy(name: Optional[str]) -> str:
    """The policy ``name`` stands for: None is "full"; an unknown name
    raises ``ValueError``."""
    name = name or "full"
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}")
    return name


def _dots_context():
    """Selective checkpointing that saves the outputs of the matrix
    products with no batch dims (``dots_with_no_batch_dims_saveable``): the
    linear layers' ``aten.mm`` / ``aten.addmm``. A batched product and every
    other op is recomputed; the kernels launched through ctypes run again in
    the recompute, writing into tensors it allocates anew."""
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )

    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


@contextlib.contextmanager
def swap_params(module: nn.Module, tensors: Dict[str, torch.Tensor]):
    """Within the block, each named parameter of ``module`` (``"qkv.kernel"``
    style names) reads as the given tensor: a gathered ZeRO-3 weight, with
    its own autograd history. The parameters are put back after."""
    saved = []
    try:
        for name, t in tensors.items():
            owner_name, _, attr = name.rpartition(".")
            owner = module.get_submodule(owner_name) if owner_name \
                else module
            saved.append((owner, attr, owner._parameters[attr]))
            owner._parameters[attr] = t
        yield
    finally:
        for owner, attr, p in reversed(saved):
            owner._parameters[attr] = p


class _Zero3Drive(torch.autograd.Function):
    """The ZeRO-3 layer drive (module docstring): ``forward(ctx, model,
    meta, seeds, bias, h, *chunks)`` with the chunks flattened layer by
    layer in ``meta.shapes`` order."""

    @staticmethod
    def forward(ctx, model, meta, seeds, bias, h, *chunks):
        names = [list(row) for row in meta.shapes]
        ctx.model, ctx.meta, ctx.seeds, ctx.bias = model, meta, seeds, bias
        ctx.names = names
        pf = max(int(getattr(model.cfg, "zero3_prefetch", 0) or 0), 0)
        ctx.prefetch = pf
        rows = _rows(names, chunks)
        n = len(names)
        window = [_gather_row(rows[j], meta, j)
                  for j in range(min(pf, n))]
        hs = []
        for i in range(n):
            if i + pf < n:  # layer i + pf's gather goes out first
                window.append(_gather_row(rows[i + pf], meta, i + pf))
            full = window.pop(0).wait()
            hs.append(h)
            with swap_params(model.layers[i], full):
                h = model._train_layer(model.layers[i], seeds[i], h, bias)
            del full
        # the layers' inputs: the input itself, then intermediates
        ctx.hs = hs[1:]
        ctx.save_for_backward(hs[0], *chunks)
        return h

    @staticmethod
    def backward(ctx, g):
        from apex_tpu_torch.optimizers.distributed import scatter_grad

        model, meta, names = ctx.model, ctx.meta, ctx.names
        n = len(names)
        saved = ctx.saved_tensors
        hs, chunks = [saved[0], *ctx.hs], saved[1:]
        rows = _rows(names, chunks)
        order = list(reversed(range(n)))
        pf = ctx.prefetch
        window = [_gather_row(rows[j], meta, j)
                  for j in order[:min(pf, n)]]
        grads: List[Optional[torch.Tensor]] = [None] * len(chunks)
        offsets = _row_offsets(names)
        for pos, i in enumerate(order):
            if pos + pf < n:  # the re-gather pf layers ahead of the sweep
                window.append(_gather_row(rows[order[pos + pf]], meta,
                                          order[pos + pf]))
            full = {k: v.detach().requires_grad_(True)
                    for k, v in window.pop(0).wait().items()}
            x = hs[i].detach().requires_grad_(True)
            with torch.enable_grad(), swap_params(model.layers[i], full):
                out = model._train_layer(model.layers[i], ctx.seeds[i], x,
                                         ctx.bias)
            got = torch.autograd.grad(out, [x, *full.values()], g,
                                      allow_unused=True)
            g, got = got[0], got[1:]
            for j, (key, gp) in enumerate(zip(full, got)):
                c = rows[i][key]
                shape = meta.shapes[i][key]
                if gp is None:
                    gp = torch.zeros(shape.shape, dtype=shape.dtype,
                                     device=c.device)
                grads[offsets[i] + j] = scatter_grad(
                    gp, c.numel(), c.dtype, meta.axis,
                    meta.gather_dtype or shape.dtype)
            del full, out
        return (None, None, None, None, g, *grads)


def _rows(names, chunks):
    out, k = [], 0
    for row in names:
        out.append({key: chunks[k + j] for j, key in enumerate(row)})
        k += len(row)
    return out


def _row_offsets(names):
    out, k = [], 0
    for row in names:
        out.append(k)
        k += len(row)
    return out


def _gather_row(row, meta, i):
    """Issue the gathers of layer ``i``'s chunks (``.wait()`` for them)."""
    from apex_tpu_torch.optimizers.distributed import gather_leaves_async

    return gather_leaves_async(
        {k: (c, meta.shapes[i][k]) for k, c in row.items()}, meta.axis,
        meta.gather_dtype)


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

    def __init__(self, cfg, device, generator: torch.Generator,
                 sequence_parallel: bool = False,
                 comm_dtype: Optional[str] = None):
        super().__init__()
        c = cfg
        init = tp.scaled_normal(c.init_method_std)
        # Megatron scales output-layer init by 1/sqrt(2L)
        # (_transformer.py:280-283)
        out_init = tp.scaled_normal(
            c.init_method_std / (2 * c.num_layers) ** 0.5)
        kw = dict(params_dtype=c.params_dtype, device=device,
                  generator=generator, axis=c.axis,
                  sequence_parallel=sequence_parallel, comm_dtype=comm_dtype)
        self.ln1 = LayerNormParams(c.hidden_size, c.params_dtype, device)
        self.qkv = tp.ColumnParallelLinear(
            c.hidden_size, 3 * c.hidden_size, gather_output=False,
            init_method=init, **kw)
        self.proj = tp.RowParallelLinear(
            c.hidden_size, c.hidden_size, input_is_parallel=True,
            init_method=out_init, **kw)
        self.ln2 = LayerNormParams(c.hidden_size, c.params_dtype, device)
        self._build_ffn(c, init, out_init, kw)

    def _build_ffn(self, c, init, out_init, kw) -> None:
        self.fc1 = tp.ColumnParallelLinear(
            c.hidden_size, c.ffn, gather_output=False, init_method=init,
            **kw)
        self.fc2 = tp.RowParallelLinear(
            c.ffn, c.hidden_size, input_is_parallel=True,
            init_method=out_init, **kw)

    @classmethod
    def skip_draws(cls, cfg, device, generator: torch.Generator) -> None:
        """Advance ``generator`` past one layer's draws without building
        it: the same normal fills as ``__init__`` (the full qkv, proj, fc1
        and fc2 kernels, in that order; the biases and LN params draw
        nothing), into one scratch buffer."""
        c = cfg
        h = c.hidden_size
        shapes = ((h, 3 * h), (h, h)) + cls._ffn_shapes(c)
        buf = torch.empty(max(a * b for a, b in shapes),
                          dtype=c.params_dtype, device=device)
        with torch.no_grad():
            for a, b in shapes:
                buf[:a * b].view(a, b).normal_(generator=generator)

    @staticmethod
    def _ffn_shapes(c):
        return ((c.hidden_size, c.ffn), (c.ffn, c.hidden_size))

    def specs(self):
        """Each leaf's split over the model axis, in the JAX tree's layout
        (``layer_stack_specs`` without the stacked dim)."""
        ln = {"scale": (), "bias": ()}
        return {"ln1": ln, "qkv": self.qkv.specs(),
                "proj": self.proj.specs(), "ln2": dict(ln),
                **self._ffn_specs()}

    def _ffn_specs(self):
        return {"fc1": self.fc1.specs(), "fc2": self.fc2.specs()}


class MoETransformerLayer(TransformerLayer):
    """One MoE layer's parameter tree ``{ln1, qkv, proj, ln2, moe}``
    (``gpt.py:205-231``): the attention half of :class:`TransformerLayer`
    and a :class:`~apex_tpu_torch.transformer.moe.MoEMLP` for the FFN, its
    experts sharded over ``cfg.moe_expert_axis`` and each expert's FFN over
    ``cfg.axis`` (EP x TP). The experts draw from the generator after the
    attention half: the router, fc1 and fc2 kernels, each whole."""

    def _build_ffn(self, c, init, out_init, kw) -> None:
        from apex_tpu_torch.transformer.moe import MoEMLP

        ep = c.moe_expert_axis
        self.moe = MoEMLP(
            c.hidden_size, c.ffn, num_experts=c.moe_num_experts,
            top_k=c.moe_top_k, capacity_factor=c.moe_capacity_factor,
            expert_axis=ep, tp_axis=c.axis, params_dtype=c.params_dtype,
            init_method=init,
            # a serial build of an expert-parallel config runs: it has no
            # dispatch wire to quantize (gpt.py:196-200)
            dispatch_dtype=c.moe_dispatch_dtype if ep is not None else None,
            device=kw["device"], generator=kw["generator"])

    @staticmethod
    def _ffn_shapes(c):
        h, f, E = c.hidden_size, c.ffn, c.moe_num_experts
        return ((h, E), (E * h, f), (E * f, h))

    def _ffn_specs(self):
        return {"moe": self.moe.specs()}


def _layer_class(cfg):
    """:class:`MoETransformerLayer` for a config with routed experts, else
    :class:`TransformerLayer`."""
    if getattr(cfg, "moe_num_experts", None) is not None:
        return MoETransformerLayer
    return TransformerLayer


def _flat(h: torch.Tensor, aux):
    """A layer's ``(h, aux)`` as the checkpointed body returns it: ``h``
    alone, or ``(h, *aux values)`` in ``AUX_KEYS`` order."""
    if aux is None:
        return h
    from apex_tpu_torch.transformer.moe import AUX_KEYS

    return (h,) + tuple(aux[k] for k in AUX_KEYS)


def _unflat(out):
    if not isinstance(out, tuple):
        return out, None
    from apex_tpu_torch.transformer.moe import AUX_KEYS

    return out[0], dict(zip(AUX_KEYS, out[1:]))


def _add_aux(acc, aux):
    """The running fp32 sum of the layers' aux trees
    (``_transformer.py:627-631``)."""
    if aux is None:
        return acc
    aux = {k: v.float() for k, v in aux.items()}
    if acc is None:
        return aux
    return {k: acc[k] + aux[k] for k in acc}


#: the refusal of a drive that would drop the layers' aux losses
#: (``_transformer.py:588-595``)
DROPPED_AUX = (
    "this model's layers emit aux losses (MoE router); call "
    "run_layers(..., return_aux=True) and fold them into the "
    "loss -- dropping them silently disables load balancing. "
    "Under the pipeline schedules, pass run_layers with "
    "return_aux=True plus aux_to_loss to pipelined_loss_fn.")


class TransformerBase(nn.Module):
    """Transformer plumbing shared by the model zoo, serial or tensor
    parallel over ``cfg.axis``.

    Subclasses set ``causal``. The config provides hidden_size,
    num_attention_heads, num_layers, ffn, head_dim, params_dtype,
    compute_dtype, init_method_std, vocab_size, attention_window, axis and
    sequence_parallel. A tensor-parallel model needs the topology installed
    (:func:`apex_tpu_torch.parallel.initialize_model_parallel`) before it
    is built: its layers are built at the local shapes.
    """

    causal: bool = True

    def __init__(self, config, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = c = config
        if c.hidden_size % c.num_attention_heads:
            raise ValueError("hidden_size must divide evenly into heads")
        self.device = device
        # sequence parallelism rides the model axis; serial ignores it
        self._sp = bool(c.sequence_parallel) and c.axis is not None
        # the quantized wire of the sequence-parallel conjugates
        # (activation_comm_dtype, _transformer.py:243-263): ignored serial
        # (the serial twin of a sharded config runs), and it needs SP
        self._acd = getattr(c, "activation_comm_dtype", None)
        if self._acd is not None:
            from apex_tpu_torch.parallel.quantize import canon_wire_dtype

            self._acd = canon_wire_dtype(self._acd)
            if c.axis is None:
                self._acd = None
            elif not self._sp:
                raise ValueError(
                    "activation_comm_dtype requires sequence_parallel=True: "
                    "the quantized wire dtype rides the sequence-parallel "
                    "scatter/gather conjugates -- plain-TP all-reduces have "
                    "no encode/decode seam")
        self._ctx = getattr(c, "context_axis", None)
        if self._ctx is not None:
            from apex_tpu_torch.parallel import mesh as _mesh

            if not _mesh.model_parallel_is_initialized():
                raise ValueError(
                    f"context parallelism over axis {self._ctx!r} needs the "
                    f"topology: call apex_tpu_torch.parallel."
                    f"initialize_model_parallel(context_parallel_size=N) "
                    f"first (or build with context_axis=None)")
        if c.axis is not None:
            _, tp_size = tp.mappings.axis_world(c.axis)
            tp.divide(c.num_attention_heads, tp_size)
            if self._sp and c.max_seq_len % tp_size:
                raise ValueError(
                    f"sequence_parallel=True needs max_seq_len "
                    f"({c.max_seq_len}) divisible by the tensor-parallel "
                    f"size ({tp_size}): the embedding reduce-scatter shards "
                    f"the sequence tp ways")
        self.embedding = tp.VocabParallelEmbedding(
            c.vocab_size, c.hidden_size, axis=c.axis,
            sequence_parallel=self._sp, comm_dtype=self._acd,
            params_dtype=c.params_dtype,
            init_method=tp.scaled_normal(c.init_method_std), device=device,
            generator=generator)
        # every layer is drawn from the generator, so a stage holds the
        # serial model's layers from the same seed: it builds its own and
        # only advances the generator past each other one
        self._pipe = getattr(c, "pipeline_axis", None)
        ids = list(range(c.num_layers))
        if self._pipe is not None:
            rank, size = tp.mappings.axis_world(self._pipe)
            ids = stage_layer_ids(c.num_layers, size,
                                  c.virtual_pipeline_size, rank)
        drawn = {}
        layer_cls = _layer_class(c)
        for i in range(c.num_layers):
            if i in ids:
                drawn[i] = layer_cls(c, device, generator, self._sp,
                                     self._acd)
            else:
                layer_cls.skip_draws(c, device, generator)
        self.layers = nn.ModuleList(drawn[i] for i in ids)

    def layer_stack_specs(self):
        """The layers' specs with the stacked ``num_layers`` dim first
        (``stack_specs``), named over the pipeline axis on a stage."""

        def stack(t):
            if isinstance(t, dict):
                return {k: stack(v) for k, v in t.items()}
            return (self._pipe, *t)

        return stack(self.layers[0].specs())

    def params_from_numpy(self, tree):
        """Load the JAX ``init`` tree given as numpy arrays (layer leaves
        stacked ``(num_layers, ...)``, ``kernel`` in JAX's ``(in, out)``
        layout, which the port keeps): the FULL tree, of which a pipeline
        stage loads its block of the interleaved layer stack, a
        tensor-parallel model this rank's shard and an expert-parallel one
        its experts
        (:func:`apex_tpu_torch.transformer.tensor_parallel.shard_params`
        by :meth:`specs`). Shapes must match
        (:func:`apex_tpu_torch._params.load_tree_`)."""
        from apex_tpu_torch._params import load_tree_

        c = self.cfg
        if self._pipe is not None:
            rank, size = tp.mappings.axis_world(self._pipe)
            tree = dict(tree, layers=interleave_stack(
                tree["layers"], size, c.virtual_pipeline_size))
            tree = tp.shard_params(tree, self.specs(), rank, size,
                                   self._pipe)
        for axis in (c.axis, getattr(c, "moe_expert_axis", None)):
            if axis is not None:
                rank, size = tp.mappings.axis_world(axis)
                tree = tp.shard_params(tree, self.specs(), rank, size, axis)
        return load_tree_(self, tree)

    def sharded_flags(self) -> List[bool]:
        """Per parameter (``parameters()`` order): whether it is this rank's
        shard of a tensor split over the model axis -- the ``sharded``
        flags of ``FusedLAMB.update_``, whose norms are then the whole
        tensors'."""
        from apex_tpu_torch._params import _tree_path

        specs, axis = self.specs(), self.cfg.axis
        out = []
        for name, _ in self.named_parameters():
            leaf = specs
            for key in _tree_path(name)[0]:
                leaf = leaf[key]
            out.append(axis is not None and axis in leaf)
        return out

    # -- sequence-parallel helpers -------------------------------------------

    def _sp_param(self, x: torch.Tensor) -> torch.Tensor:
        """A REPLICATED parameter consumed in a sequence-sharded region: each
        rank sees only its tokens, so its grad there is partial; the
        identity-forward / psum-backward ``copy_to`` makes it whole on every
        rank (``_transformer.py:356-368``). Identity outside SP."""
        if not self._sp:
            return x
        return tp.copy_to_tensor_model_parallel_region(x, self.cfg.axis)

    def _sp_shard_start(self, s_local: int) -> int:
        """The sequence-parallel part of :meth:`_seq_shard_start`: this
        tp rank's offset in the context-local sequence (0 outside SP)."""
        if not self._sp:
            return 0
        rank, _ = tp.mappings.axis_world(self.cfg.axis)
        return rank * s_local

    def _seq_shard_start(self, s_local: int) -> int:
        """Global position of this rank's first token for a sequence-sharded
        activation of ``s_local`` tokens (``_transformer.py:449-462``): the
        context-parallel offset (tokens arrive sliced over the context
        axis) plus the sequence-parallel one (the embedding's
        reduce-scatter slices the context-local sequence tp ways more); 0
        when neither shards the sequence."""
        start = 0
        if self._ctx is not None:
            rank, _ = tp.mappings.axis_world(self._ctx)
            tp_size = tp.mappings.axis_world(self.cfg.axis)[1] \
                if self._sp else 1
            start = rank * s_local * tp_size
        return start + self._sp_shard_start(s_local)

    def _positions(self, pos_table: torch.Tensor,
                   s_local: int) -> torch.Tensor:
        """The learned position rows of this shard's tokens, from
        :meth:`_seq_shard_start`; under SP the table rides
        :meth:`_sp_param` (``_transformer.py:466-479``). The context slice
        needs no such wrap: the caller's reduction of the grads over the
        context axis sums the disjoint rows."""
        start = self._seq_shard_start(s_local)
        return self._sp_param(pos_table)[start:start + s_local]

    # -- compute helpers ----------------------------------------------------

    def _ln(self, p: LayerNormParams, x: torch.Tensor,
            sequence_region: bool = True) -> torch.Tensor:
        # mixed-dtype fused LN: activations in the compute dtype, fp32 γβ;
        # an LN in the sequence-sharded region takes γβ through _sp_param
        # (head LNs past the sequence gather pass sequence_region=False)
        scale, bias = p.scale, p.bias
        if sequence_region:
            scale, bias = self._sp_param(scale), self._sp_param(bias)
        return layer_norm(x, scale, bias)

    def _dense(self, p: tp.ColumnParallelLinear,
               x: torch.Tensor) -> torch.Tensor:
        return p(x)

    def _qkv_heads(self, layer: TransformerLayer, h: torch.Tensor,
                   positions: Optional[torch.Tensor] = None):
        """``(q, k, v)`` head tensors ``(b, heads, s, d)`` from the fused
        QKV projection, laid out ``(heads, 3, head_dim)``
        (``_transformer.py:400-430``): ``heads / tp`` local heads under
        tensor parallelism, on the gathered sequence under SP. They are
        strided views of one product; the kernels take them without a
        copy. Under rotary
        positions q and k are rotated at :meth:`_token_positions` (serial:
        0 .. s-1), or at ``positions`` ``(b, s)``, each sequence's own (the
        serving hooks: each slot sits at its own context position)."""
        c = self.cfg
        b = h.shape[0]
        qkv = self._dense(layer.qkv, h)
        s = qkv.shape[1]
        n = qkv.shape[-1] // (3 * c.head_dim)
        qkv = qkv.view(b, s, n, 3, c.head_dim).permute(0, 2, 3, 1, 4)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if getattr(c, "position_embedding", "learned") == "rope":
            if positions is None:
                pos = self._token_positions(s, h.device)
                q, k = (apply_rope(q, pos, c.rope_theta),
                        apply_rope(k, pos, c.rope_theta))
            else:
                q, k = (apply_rope_at(q, positions, c.rope_theta),
                        apply_rope_at(k, positions, c.rope_theta))
        return q, k, v

    def _token_positions(self, s: int, device) -> torch.Tensor:
        """Global positions of the ``s`` tokens attention sees, for RoPE
        (``_transformer.py:481-488``): on the gathered sequence, where only
        the context axis still shards it, so the context offset and never
        the sequence-parallel one."""
        start = 0
        if self._ctx is not None:
            start = tp.mappings.axis_world(self._ctx)[0] * s
        return start + torch.arange(s, dtype=torch.int64, device=device)

    def _attn_out(self, layer: TransformerLayer,
                  attn: torch.Tensor) -> torch.Tensor:
        """Head merge + output projection."""
        b, n, s, _ = attn.shape
        attn = attn.transpose(1, 2).reshape(b, s, n * self.cfg.head_dim)
        return self._dense(layer.proj, attn)

    def _attend(self, q, k, v, bias=None) -> torch.Tensor:
        """Core attention on ``(b, heads, s, d)`` with the additive ``bias``
        or a :class:`SegmentMask` and the config's sliding window
        (``_transformer.py:490-530``): serial, ``flash_attention``
        (``stream='auto'`` picks the kernels); under ``context_axis`` the
        ring or Ulysses of ``cfg.sequence_parallel_impl``, which take
        segment masks and no dense bias."""
        c = self.cfg
        win = c.attention_window
        seg = bias if isinstance(bias, SegmentMask) else None
        seg_kw = {} if seg is None else dict(
            segment_ids=(seg.q_seg, seg.kv_seg), pad_id=seg.pad_id)
        if self._ctx is None:
            if seg is not None:
                return flash_attention(q, k, v, causal=self.causal,
                                       window=win, **seg_kw)
            return flash_attention(q, k, v, bias, causal=self.causal,
                                   window=win)
        from apex_tpu_torch.transformer import ring

        if bias is not None and seg is None:
            raise NotImplementedError(
                "a dense attention bias is not supported under sequence "
                "parallelism (it would have to be materialized (sq, SK) per "
                "shard); express masking as a SegmentMask -- padding masks "
                "map directly (models/bert.py) -- or run with "
                "context_axis=None")
        impl = getattr(c, "sequence_parallel_impl", "ring")
        if impl not in SEQUENCE_PARALLEL_IMPLS:
            raise ValueError(
                f"sequence_parallel_impl must be 'ring' or 'ulysses', "
                f"got {impl!r}")
        fn = ring.ring_attention if impl == "ring" else ring.ulysses_attention
        return fn(q, k, v, axis=self._ctx, causal=self.causal, window=win,
                  **seg_kw)

    def _attention(self, layer: TransformerLayer, h: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """QKV heads, attention, head merge and output projection
        (``_transformer.py:440-445``)."""
        q, k, v = self._qkv_heads(layer, h)
        return self._attn_out(layer, self._attend(q, k, v, bias))

    def _mlp(self, layer: TransformerLayer, h: torch.Tensor) -> torch.Tensor:
        # jax.nn.gelu is the tanh approximation (_transformer.py:534)
        return self._dense(layer.fc2, F.gelu(self._dense(layer.fc1, h),
                                             approximate="tanh"))

    def _layer(self, layer: TransformerLayer, h: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               bias: Optional[torch.Tensor] = None):
        """``(h, aux)`` of one layer: aux the layer's router losses, None
        for a dense layer."""
        raise NotImplementedError

    def _emits_aux(self) -> bool:
        """Whether the layers emit aux losses (``_aux_init`` not None)."""
        return getattr(self.cfg, "moe_num_experts", None) is not None

    def run_layers(self, h: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   return_aux: bool = False):
        """The layers with no dropout; ``(h, aux)`` with ``return_aux`` (aux
        None for dense layers). Aux-emitting layers without ``return_aux``
        raise ``ValueError``."""
        if self._emits_aux() and not return_aux:
            raise ValueError(DROPPED_AUX)
        acc = None
        for layer in self.layers:
            h, aux = self._layer(layer, h, None, bias)
            acc = _add_aux(acc, aux)
        return (h, acc) if return_aux else h

    def _dropout(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        return inverted_dropout(x, self.cfg.hidden_dropout, generator)

    def _dropout_generator(self, seed: Optional[int],
                           device) -> Optional[torch.Generator]:
        """The generator of one layer's hidden dropout: ``seed``'s, the
        same on every tensor-parallel rank (the replicated regions), or
        under SP the sequence-parallel stream of ``seed`` (each rank holds
        different tokens there, ``_transformer.py:370-381``)."""
        if seed is None:
            return None
        if self._sp:
            return tp.sequence_parallel_generator(seed, self.cfg.axis,
                                                  device)
        return tp.data_parallel_generator(seed, device)

    def _layer_seeds(self, generator: Optional[torch.Generator],
                     n: Optional[int] = None) -> List[Optional[int]]:
        """One seed per layer (of ``n``, default all) from ``generator``
        (the reference splits the dropout key per layer,
        ``_transformer.py:587``). Each layer draws its masks from a fresh
        generator of its own seed, so a checkpointed layer's recompute
        draws the same masks as its forward."""
        n = len(self.layers) if n is None else n
        if generator is None or self.cfg.hidden_dropout == 0.0:
            return [None] * n
        seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                              device=generator.device)
        return [int(s) for s in seeds.tolist()]

    def _train_layer(self, layer: TransformerLayer, seed: Optional[int],
                     h: torch.Tensor, bias: Optional[torch.Tensor] = None):
        """One layer with its dropout masks drawn from ``seed``: ``h``, or
        ``(h, *aux)`` for an aux-emitting layer (:func:`_flat`), the
        checkpointed body."""
        return _flat(*self._layer(
            layer, h, self._dropout_generator(seed, h.device), bias))

    def _save_attn_layer(self, layer: TransformerLayer,
                         seed: Optional[int], h: torch.Tensor,
                         bias: Optional[torch.Tensor]) -> torch.Tensor:
        """One layer under "save_attn": the part before the attention
        and the part after it (the subclass's ``_pre_attention`` and
        ``_post_attention``, GPT's) are checkpointed, the attention call
        between them is not, so its Function keeps its inputs and outputs
        and the backward runs only its backward kernels."""
        q, k, v = checkpoint(self._pre_attention, layer, h,
                             use_reentrant=False)
        attn = self._attend(q, k, v, bias)
        return checkpoint(self._train_post_attention, layer, seed, h, attn,
                          use_reentrant=False)

    def _train_post_attention(self, layer: TransformerLayer,
                              seed: Optional[int], h: torch.Tensor,
                              attn: torch.Tensor):
        return _flat(*self._post_attention(
            layer, h, attn, self._dropout_generator(seed, h.device)))

    def run_layers_train(self, h: torch.Tensor,
                         dropout_generator: Optional[torch.Generator] = None,
                         bias: Optional[torch.Tensor] = None,
                         chunk_meta=None, layers=None,
                         return_aux: bool = False):
        """The differentiable layer drive: each layer checkpointed when
        ``cfg.remat`` is set, under ``cfg.remat_policy`` (the bias one of
        the checkpointed inputs). ``layers``: the layer modules to run (a
        pipeline chunk; default all of them). ``chunk_meta`` (a ZeRO-3
        :class:`~apex_tpu_torch.optimizers.distributed.ChunkedMeta` of the
        layer stack, with its ``chunks``) drives the layers from this
        rank's chunks through :class:`_Zero3Drive`. ``return_aux``: return
        ``(h, aux)``, the layers' aux losses summed in fp32 (None for dense
        layers); aux-emitting layers without it raise ``ValueError``, and
        under the ZeRO-3 drive ``NotImplementedError``."""
        emits = self._emits_aux()
        if emits and not return_aux:
            raise ValueError(DROPPED_AUX)
        if chunk_meta is not None and emits:
            raise NotImplementedError(
                "the ZeRO-3 chunk drive does not take aux-emitting layers "
                "(MoE routers): train MoE models at ZeRO levels 1/2")
        if chunk_meta is not None:
            if bias is not None and bias.requires_grad:
                raise NotImplementedError(
                    "the ZeRO-3 drive takes an attention bias that needs no "
                    "grad (a padding mask)")
            chunks = [c for row in chunk_meta.chunks for c in row.values()]
            h = _Zero3Drive.apply(
                self, chunk_meta, self._layer_seeds(dropout_generator),
                bias, h, *chunks)
            return (h, None) if return_aux else h
        policy = remat_policy(getattr(self.cfg, "remat_policy", None))
        remat = self.cfg.remat and torch.is_grad_enabled()
        layers = self.layers if layers is None else layers
        acc = None
        for layer, seed in zip(layers, self._layer_seeds(dropout_generator,
                                                         len(layers))):
            fn = functools.partial(self._train_layer, layer, seed)
            if not remat:
                out = fn(h, bias)
            elif policy == "save_attn":
                out = self._save_attn_layer(layer, seed, h, bias)
            elif policy == "dots":
                out = checkpoint(fn, h, bias, use_reentrant=False,
                                 context_fn=_dots_context)
            else:
                out = checkpoint(fn, h, bias, use_reentrant=False)
            h, aux = _unflat(out)
            acc = _add_aux(acc, aux)
        return (h, acc) if return_aux else h
